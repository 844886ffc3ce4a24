"""Time the redesigned kernels of one checkout of the port on the card —
K1 (seed_diagonals), K3 (prefix_mismatches, with and without an alt
genome), K4
(solve_indels), K13 (lane_features), K5 (solve_splices), K6
(select_triples, beside its library sort), K7 (solve_doublesplices), K15
(qpos_ranges), K16 (select_pairs, beside its library sort), K12
(bridge_traceback), K11 (banded_gotoh), K8 (pair_grid, beside its
ranking's library sort), K9 (seed_segments), K10 (chain) and K17
(pack_queries) — so that two versions can be compared within one call
(run it for each tree in turns: old, new, new, old).

The inputs are those of an -N 1 batch: planted RNA reads (2048, both
strands: 4096 rows) over a synthetic genome, seeded, voted and verified
by the plain stages, at NC=32 (the -N 1 runner's seed budget) and at
W=4096, NC=128; K1 on those reads with the k=12 index and with a k=15
one (a 4.3 GB offsets table, as the main path's), at W=384 (the -N 0
runner's grid) and W=4096; K3 on their diagonals (the alt genome: the genome's
words reversed); K4 on 16 indel pairs a read (max_ins 9, max_del 30,
min_end 4, the seed-order gate); K13 on K3's mask at both, L=100, k=12,
interval 3, trim score -3; K5 on 16 splice pairs a read and K7 on 8
triples, without and with known-site masks (sparse and dense random bits, novel on and, with
dense bits, off); K15 on the seed grids and selected diagonals at W=384,
NC=32 (the -N 0 runner's seed budget) and W=4096, NC=128; K16 under
both rules with 16 pairs, and on
synth.diag_pair_rows' edge rows (1024 rows, NC 3 to 128, maxpairs 16 and
1024); K12, K8, K9, K10 and K17 on the inputs the PE -N 1 runner gives
them (pe_inputs: 4096 planted RNA pairs in batches of 2048; K12 also on
128 random junction windows, its plain version profiled over one call;
K9 also at the H and S of one and two overflow retries, with its shared
memory and the CTAs an SM holds; K10's largest last valid segment; K17
at 2048 reads and at the largest call).
Times are torch.profiler device time per call over 50 calls after 50 ms
of the kernel (the card's clocks up), as chip_smoke.py
takes them (its _timed), and every kernel is checked against its plain
version first.  K6's library sort is also timed on keys of the same
shape that are all equal, and between CUDA events.  "cascade" times
align_batch_gapped whole (-N 0 and -N 1) on the 2048 reads: the host's
wall per call to torch.cuda.synchronize(), the median of 20 after two
warm-up calls.  Prints one JSON line.

    python tools/time_kernels.py [--root DIR] [--mbp 16] [--reads 2048]
        [--only seed_diagonals prefix_mismatches solve_indels ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PE_BATCH = 2048   # pairs a runner batch, as chip_smoke.py runs PE -N 1
REPS = 50         # calls a profile (the plain K11 and K12: one)
KERNELS = ("seed_diagonals", "prefix_mismatches", "solve_indels",
           "lane_features", "solve_splices", "select_triples",
           "solve_doublesplices", "select_pairs", "qpos_ranges",
           "banded_gotoh", "bridge_traceback", "pair_grid", "seed_segments",
           "chain", "pack_queries", "cascade")
PE_LANE = ("banded_gotoh", "bridge_traceback", "pair_grid", "seed_segments",
           "chain", "pack_queries")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose gmap_gsnap_tpu_torch is timed")
    ap.add_argument("--mbp", type=float, default=16.0)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels to time")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(os.path.dirname(HERE),
                                          "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from gmap_gsnap_tpu_torch import convert
    from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.align import runner as trun
    from gmap_gsnap_tpu_torch.ops import mismatch as mmo
    from gmap_gsnap_tpu_torch.utils import synth

    assert gg.__file__.startswith(root), gg.__file__
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    n = int(args.mbp * 1e6)
    g = synth.make_genome(rng, [n // 2, n // 3, n - n // 2 - n // 3])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_spliced_reads(rng, g, args.reads)
    tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, dev)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, dev)
    c, f, ln = (torch.from_numpy(x).to(dev)
                for x in trun.encode_batch(recs, 100))
    reads = (c, f, ln)
    crc, frc = se._revcomp_batch_plain(c, f, ln)
    c, f, ln = torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])
    q = se._pack_device_plain(c, f, ln, 100)
    budget = se.auto_budget(ln, 12, 3, -1)
    nwords = (tg.length + 31) // 32 + 2
    masks = {
        density: tuple(torch.from_numpy(
            ((rng.random((nwords, 32)) < density).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
            .view(np.int32)).to(dev) for _ in range(4))
        for density in (0.002, 0.15)}
    variants = (("no masks", True, None), ("masks 0.002", True, masks[0.002]),
                ("masks 0.15", True, masks[0.15]),
                ("masks 0.15 novel=0", False, masks[0.15]))
    times = {}

    def timed(name, fk, fp, cost, lib=None, plain_reps=None):
        """Check fk against fp, then time both (and lib) over REPS calls a
        profile (the plain version over plain_reps, where given) after 50
        ms of fk; cost maps the plain output to (bytes, operations),
        chip_smoke's bound.  Returns the name's entry of the JSON line."""
        got, want = fk(), fp()
        if smoke._max_abs_err(got, want) != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version")
        bound = smoke._bound(*cost(want))
        # the card's clocks up first: 50 ms of the kernel
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.05:
            fk()
            torch.cuda.synchronize()
        if plain_reps is None:
            ms, clock, _ = smoke._timed(fk, fp, *([lib] if lib else []),
                                        reps=REPS)
        else:
            ms, clock, _ = smoke._timed(fk, *([lib] if lib else []),
                                        reps=REPS)
            pms, pclock, _ = smoke._timed(fp, reps=plain_reps)
            ms = [ms[0], pms[0], *ms[1:]]
            clock = clock if pclock == clock else f"{clock} / plain {pclock}"
        times[name] = {"ms": ms[0], "plain_ms": ms[1], "clock": clock,
                       "library_ms": ms[2] if lib else None,
                       "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"{name}: {times[name]}", flush=True)
        return times[name]

    rules = (("indel", (0, 30, 9), gg._indel_pairs_eligible(30, 9)),
             ("splice", (1, 200_000, 0), gg._splice_pairs_eligible(200_000)))

    def pairs(label, t, v, npairs):
        for rule, kargs, fn in rules:
            timed(f"select_pairs {rule} {label}",
                  lambda kargs=kargs: gg._select_pairs_cuda(t, v, npairs,
                                                            *kargs),
                  lambda fn=fn: gg._select_pairs_plain(t, v, fn, npairs),
                  lambda out: (smoke._nbytes(t, v, out),
                               8 * t.numel() * t.shape[1]),
                  smoke._pair_sort(torch, se, t, v, fn))

    def solver(name, keys, label, a, cost):
        timed(f"{name} {label}",
              lambda: smoke._fields(getattr(gg, f"_{name}_cuda"), a, keys),
              lambda: smoke._fields(getattr(gg, f"_{name}_plain"), a, keys),
              cost)

    lf_keys = ("cand_mm",) + gg._LANE_FEATURE_KEYS
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    for st, nc in ((512, 32), (4096, 128)):
        p = se.GsnapParams(seed_total=st, ncand=nc)
        diag, qgrid = se._seed_diagonals_plain(ti, c, f, ln, p, True)[:2]
        top_d, votes, _ = se._top_diagonals_plain(diag, nc)
        mm, pref = mmo._prefix_mismatches_plain(tg, q, top_d, ln, None, None)
        shape = f"W={st} NC={nc}"
        if "prefix_mismatches" in args.only:
            for label, a in (("", None), (" alt", alt)):
                timed(f"prefix_mismatches{label} {shape}",
                      lambda a=a: mmo._prefix_mismatches_cuda(
                          tg, q, top_d, ln, None, a),
                      lambda a=a: mmo._prefix_mismatches_plain(
                          tg, q, top_d, ln, None, a),
                      smoke._prefix_cost(q, top_d, ln, 100, a))
        if "solve_indels" in args.only:
            ii, jj, pv = gg._select_pairs_plain(
                top_d, votes, gg._indel_pairs_eligible(30, 9), 16)
            qp5, qp3 = se._qpos_ranges_plain(diag, qgrid, top_d)
            kargs = (top_d, mm, pref, ii, jj, pv, ln, budget, 100, qp5, qp3,
                     9, 30, 4)
            solver("solve_indels", gg._INDEL_KEYS, shape, kargs,
                   smoke._indel_cost(torch, kargs))
        if "lane_features" in args.only:
            largs = (mm, ln, 12, 3, -3)
            timed(f"lane_features {shape}",
                  lambda: smoke._fields(gg._lane_features_cuda, largs,
                                        lf_keys),
                  lambda: smoke._fields(
                      lambda *a: {"cand_mm": gg._bitpack_mask(mm),
                                  **gg._lane_features_plain(mm, pref, *a)},
                      (ln, 12, 3, -3), lf_keys),
                  lambda out: (smoke._nbytes(mm, ln, out), 0))
        if "select_pairs" in args.only:
            pairs(shape, top_d, votes, 16)
        if "select_triples" in args.only:
            lib = smoke._triple_sort(torch, se, top_d, votes, 200_000)
            timed(f"select_triples {shape}",
                  lambda: gg._select_triples_cuda(top_d, votes, 200_000, 8),
                  lambda: gg._select_triples_plain(top_d, votes, 200_000, 8),
                  lambda out: smoke._triple_cost(top_d, votes, 200_000, 8),
                  lib)
            # the same sort on keys that are all equal, and between events
            same = torch.ones_like(lib()[0])
            flat = lambda: torch.sort(same, dim=1, stable=True)
            times[f"select_triples library {shape}"] = {
                "sums_ms": smoke._device_ms(lib),
                "sums_events_ms": smoke._call_ms(lib, 20),
                "equal_keys_ms": smoke._device_ms(flat),
                "equal_keys_events_ms": smoke._call_ms(flat, 20)}
            print(f"select_triples library {shape}: "
                  f"{times[f'select_triples library {shape}']}", flush=True)
        sp = gg._select_pairs_plain(top_d, votes,
                                    gg._splice_pairs_eligible(200_000), 16)
        tr = gg._select_triples_plain(top_d, votes, 200_000, 8)
        for label, novel, kn in variants:
            if "solve_splices" in args.only:
                a = (tg, top_d, pref, *sp, ln, budget, 100, novel, kn)
                solver("solve_splices", gg._SPLICE_KEYS, f"{label} {shape}",
                       a, smoke._splice_cost(torch, a))
            if "solve_doublesplices" in args.only:
                a = (tg, top_d, pref, *tr, ln, budget, 100, novel, kn)
                solver("solve_doublesplices", gg._SHORTEXON_KEYS,
                       f"{label} {shape}", a,
                       smoke._doublesplice_cost(torch, a))
    if "seed_diagonals" in args.only:
        for k, idx in ((12, ti), (15, None)):
            if idx is None:    # the main path's k: a 4.3 GB offsets table
                db15 = synth.genome_db(g, k, 3)
                idx = convert.index_from_arrays(db15.offsets, db15.positions,
                                                k, 3, dev)
                del db15
            for st in (384, 4096):
                p = se.GsnapParams(
                    seed_total=st, size_threshold=se.dynamic_size_threshold(
                        idx.positions.shape[0], k, "standard"))
                a = (idx, c, f, ln, p, True)
                timed(f"seed_diagonals k={k} W={st}",
                      lambda a=a: se._seed_diagonals_cuda(*a),
                      lambda a=a: se._seed_diagonals_plain(*a),
                      smoke._seed_cost(se, c, f, ln, k))
            del idx
            torch.cuda.empty_cache()
    if "qpos_ranges" in args.only:
        for st, nc in ((384, 32), (4096, 128)):
            p = se.GsnapParams(seed_total=st, ncand=nc)
            diag, qgrid = se._seed_diagonals_plain(ti, c, f, ln, p, True)[:2]
            top_d = se._top_diagonals_plain(diag, nc)[0]
            a = (diag, qgrid, top_d)
            timed(f"qpos_ranges W={st} NC={nc}",
                  lambda a=a: se._qpos_ranges_cuda(*a),
                  lambda a=a: se._qpos_ranges_plain(*a),
                  lambda out, a=a: (smoke._nbytes(a, out), a[0].numel()))
    if "cascade" in args.only:
        for label, novel, st in (("-N 0", False, 384), ("-N 1", True, 512)):
            p = se.GsnapParams(seed_total=st)
            gp = gg.GappedParams(base=p, novelsplicing=novel)
            call = lambda gp=gp: gg.align_batch_gapped(tg, ti, *reads, gp)
            for _ in range(2):
                call()
            walls = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            walls.sort()
            times[f"cascade {label}"] = {
                "median_ms": walls[len(walls) // 2], "min_ms": walls[0],
                "max_ms": walls[-1], "reads": len(recs)}
            print(f"cascade {label}: {times[f'cascade {label}']}",
                  flush=True)
    # K16 on synth.diag_pair_rows (1024 rows): NC off 32, maxpairs 16
    # and NC^2, both rules
    if "select_pairs" in args.only:
        for nc, npairs in ((3, 16), (24, 16), (32, 16), (32, 1024),
                           (128, 16)):
            pt, pv = (torch.from_numpy(x).to(dev)
                      for x in synth.diag_pair_rows(rng, 1024, nc))
            pairs(f"edges NC={nc} P={npairs}", pt, pv, npairs)
    if set(PE_LANE) & set(args.only):
        pe_inputs(torch, smoke, db, g, dev, args, timed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "times": times}))
    return 0


def lane_inputs(torch, db, g, dev, seed: int) -> tuple:
    """The inputs the PE -N 1 runner (default GMAP lanes) gives K8, K9,
    K10, K11, K12 and K17 over 2 PE_BATCH planted RNA pairs (3% messy
    junctions) in batches of PE_BATCH, as chip_smoke runs it: the largest
    call of K9 ("seg"), K10 ("chain"), K11 ("bm"), K12 ("bt") and K17
    ("pack"), every K8 call ("grid"), and each K9 call's (rows, Q, H, S)
    in order ("seg_calls"); and the generator the pairs were planted
    from."""
    from gmap_gsnap_tpu_torch.align import gmap_engine as eng
    from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
    from gmap_gsnap_tpu_torch.align import gsnap_pe as pe
    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.align import runner as trun
    from gmap_gsnap_tpu_torch.ops import dynprog as dp
    from gmap_gsnap_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    p1, p2, _ = synth.plant_pairs(
        rng, g, 2 * PE_BATCH,
        weights={**synth.RNA_PAIR_MIX, "messy_junction": 0.03})
    params = se.GsnapParams(size_threshold=se.dynamic_size_threshold(
        int(db.offsets[-1]), db.k, "standard"))
    runner = trun.GsnapRunner(db, params, lmax=100, novelsplicing=True,
                              device=dev)
    captured = {"seg_calls": []}
    largest = {"bm": (dp, "banded_matrices", lambda a: a[0].shape[0]),
               "bt": (dp, "bridge_traceback", lambda a: a[1].shape[0]),
               "seg": (eng, "seed_segments", lambda a: a[2].shape[0]),
               "chain": (eng, "chain", lambda a: a[0].shape[0]),
               "pack": (gg, "pack_batch", lambda a: a[0].shape[0])}
    saved = {key: getattr(mod, name) for key, (mod, name, _) in
             largest.items()}
    real_grid = pe.pair_grid

    def spy(*a, key, size):
        if key not in captured or size(a) > size(captured[key]):
            captured[key] = a
        if key == "seg":
            captured["seg_calls"].append((a[2].shape[0], a[2].shape[1],
                                          a[5], a[6]))
        return saved[key](*a)

    def spy_grid(*a):
        gate = a[8] if len(a) > 8 else None
        captured.setdefault("grid", []).append(a[:8] + (
            None if gate is None else (dict(gate[0]), dict(gate[1]),
                                       *gate[2:]),))
        return real_grid(*a)

    for key, (mod, name, size) in largest.items():
        setattr(mod, name, lambda *a, key=key, size=size: spy(
            *a, key=key, size=size))
    pe.pair_grid = spy_grid
    try:
        runner.run_pe(p1, p2, io.StringIO(), batch_size=PE_BATCH)
    finally:
        for key, (mod, name, _) in largest.items():
            setattr(mod, name, saved[key])
        pe.pair_grid = real_grid
    return captured, rng


def seed_layout(eng, kbuild, Q: int, H: int, S: int) -> str:
    """K9's shared memory a CTA and the CTAs an SM holds at (Q, H, S), for
    the checkout timed: the design of PRs 4-14 (a work area of 8 H + 12
    pow2(min(S, H)) bytes, in shared memory up to SEED_SMEM_BYTES) or
    the register design (kernels/limits.py seed_segments_bytes)."""
    from gmap_gsnap_tpu_torch.kernels import limits as klimits

    lib = kbuild.library()
    occ = getattr(getattr(lib, "lib", lib), "gmap_seed_segments_occupancy",
                  None)
    if hasattr(eng, "SEED_SMEM_BYTES"):
        ws = eng.seed_workspace_bytes(H, S)
        shared = ws <= eng.SEED_SMEM_BYTES
        where = (f"work area {ws} B in "
                 f"{'shared memory' if shared else 'global scratch'}")
        ctas = occ(H, S, ws, int(shared)) if occ else "not measured"
    else:
        where = (f"shared memory {klimits.seed_segments_bytes(Q, H, S)} B, "
                 f"scratch {'yes' if H > klimits.seed_segments_register_hits() else 'no'}")
        ctas = occ(Q, H, S) if occ else "not measured"
    return f"{where}, CTAs an SM {ctas}"


def pe_inputs(torch, smoke, db, g, dev, args, timed) -> None:
    """K11, K12, K8, K9, K10 and K17 on the inputs the PE -N 1 runner
    gives them (lane_inputs): K11 and K12 on their largest call's
    junction windows and on 128 random windows (chip_smoke's
    _junction_windows), K8 on the ranked end hits of one batch and of the
    batches stacked (4,096 pairs), with its gate epilogue and without,
    beside its ranking's library sort, and that sort's width: a stable
    torch.sort of random [2048, 256] keys as int32 and as int64; K9 on
    its largest call (and at the H and S that one and two overflow
    retries give, which align/gmap.py keeps for the rest of the process),
    K10 on its largest call, K17 on its first PE_BATCH reads, its largest
    call and 256 reads of 513-4,096 nt, each beside an empty kernel on its
    grid (the launch floor)."""
    from gmap_gsnap_tpu_torch.align import gmap_engine as eng
    from gmap_gsnap_tpu_torch.align import gmap as tgmap
    from gmap_gsnap_tpu_torch.align import gsnap_pe as pe
    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.kernels import build as kbuild
    from gmap_gsnap_tpu_torch.ops import dynprog as dp

    captured, rng = lane_inputs(torch, db, g, dev, args.seed + 1)
    print(f"GMAP lane: K9 calls (rows, Q, H, S) {captured['seg_calls']}; "
          f"sticky (H, S) by Q after the run {tgmap._HS_STICKY}", flush=True)
    if {"banded_gotoh", "bridge_traceback"} & set(args.only):
        if "bt" not in captured:
            raise SystemExit("the PE -N 1 runner's GMAP lane ran no junction "
                             "dynprog")
        w = smoke._junction_windows(torch, dp, rng, 128, dev)
        margs = (w["q"], w["g"], w["len1"], w["len2"], w["lb"], w["rb"],
                 dp.pair_matrix(dp.MISMATCH_HIGHQ), w["late"], 64, 23,
                 dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
        mats = dp._banded_matrices_plain(*margs)
    if "banded_gotoh" in args.only:
        for label, a in ((f"PE -N 1 lane nb={captured['bm'][0].shape[0] // 2}",
                          captured["bm"]), ("random nb=128", margs)):
            timed(f"banded_gotoh {label}",
                  lambda a=a: dp._banded_matrices_cuda(*a),
                  lambda a=a: dp._banded_matrices_plain(*a),
                  smoke._gotoh_cost(a), plain_reps=1)
    if "bridge_traceback" in args.only:
        lane = captured["bt"]
        rand = (mats, w["len1"][:128], w["len2"][:128], w["len2"][128:],
                w["lb"][:128], w["lb"][128:], w["g"][:128], w["g"][128:],
                w["known"], w["known"], w["loff"], w["roff"], 64, 23, 138,
                dp.PAIRED_OPEN, dp.PAIRED_EXTEND, 30, 1, True, False, False)
        for label, a in ((f"PE -N 1 lane nb={lane[1].shape[0]}", lane),
                         ("random nb=128", rand)):
            print(f"bridge_traceback {label}: M={a[12]} W={a[13]} T={a[14]}",
                  flush=True)
            timed(f"bridge_traceback {label}",
                  lambda a=a: dp._bridge_traceback_cuda(*a),
                  lambda a=a: dp._bridge_traceback_plain(*a),
                  smoke._bridge_cost(a), plain_reps=1)
    if "pair_grid" in args.only:
        # the batches' K8 inputs, stacked
        calls = [c for c in captured["grid"] if c[2].shape[0] == PE_BATCH]
        if not calls or any(c[8] is None for c in calls):
            raise SystemExit(f"the PE -N 1 runner made no gated K8 call of "
                             f"{PE_BATCH} pairs")
        cat = lambda ds: {k: torch.cat([d[k] for d in ds]) for k in ds[0]}
        h5, h3 = cat([c[0] for c in calls]), cat([c[1] for c in calls])
        l5 = torch.cat([c[2] for c in calls])
        l3 = torch.cat([c[3] for c in calls])
        offs, pairmax, subopt, maxpairs = calls[0][4:8]
        c5, c3 = cat([c[8][0] for c in calls]), cat([c[8][1] for c in calls])
        ipm, novel = calls[0][8][2:]
        print(f"pair_grid: {len(calls)} runner batches of {PE_BATCH} "
              f"pairs, NP={h5['left'].shape[1]}, maxpairs={maxpairs}",
              flush=True)
        for n in sorted({PE_BATCH, l5.shape[0]}):
            cut = lambda d: {k: v[:n] for k, v in d.items()}
            a = (cut(h5), cut(h3), l5[:n], l3[:n], offs, pairmax, subopt,
                 maxpairs)
            g5, g3 = cut(c5), cut(c3)
            lib = (smoke._grid_sort(torch, pe, a)
                   if hasattr(pe, "_pair_cells_plain") else None)
            timed(f"pair_grid {n} pairs + gate",
                  lambda a=a, g5=g5, g3=g3: smoke._grid_gate(
                      pe, True, a, g5, g3, ipm, novel),
                  lambda a=a, g5=g5, g3=g3: smoke._grid_gate(
                      pe, False, a, g5, g3, ipm, novel),
                  lambda out, a=a, g5=g5, g3=g3: (
                      smoke._grid_reads(pe, a, (g5, g3))
                      + smoke._nbytes(out), 0),
                  lib)
            timed(f"pair_grid {n} pairs",
                  lambda a=a: smoke._fields(pe._pair_grid_cuda, a,
                                            pe.PAIR_GRID_KEYS),
                  lambda a=a: smoke._fields(pe._pair_grid_plain, a,
                                            pe.PAIR_GRID_KEYS),
                  lambda out, a=a: (smoke._grid_reads(pe, a)
                                    + smoke._nbytes(out), 0))
        # the library sort by key width: one stable torch.sort of the
        # same [B, 256] random keys as int32 and as int64
        k32 = torch.randint(0, 2**31 - 1, (PE_BATCH, 256),
                            dtype=torch.int32, device=dev)
        k64 = k32.long()
        ms, clock, _ = smoke._timed(lambda: torch.sort(k32, stable=True),
                                    lambda: torch.sort(k64, stable=True),
                                    reps=REPS)
        print(f"torch.sort [{PE_BATCH}, 256] stable: int32 {ms[0]} ms, "
              f"int64 {ms[1]} ms ({clock})", flush=True)
    if "seed_segments" in args.only:
        offs, pos, oligos, valid, k, H, S, thr = captured["seg"]
        want = eng._seed_segments_plain(*captured["seg"])
        nv = want["nhits"].clamp(max=H).float()
        for h, s_ in ((H, S), (4 * H, 4 * S), (16 * H, 16 * S)):
            a = (offs, pos, oligos, valid, k, h, s_, thr)
            print(f"seed_segments rows={oligos.shape[0]} Q={oligos.shape[1]} "
                  f"H={h} S={s_}: {seed_layout(eng, kbuild, oligos.shape[1], h, s_)}"
                  f"; min(nhits, H) most {int(nv.max())}, median "
                  f"{float(nv.median())}", flush=True)
            timed(f"seed_segments H={h} S={s_}",
                  lambda a=a: smoke._fields(eng._seed_segments_cuda, a,
                                            eng.SEG_KEYS),
                  lambda a=a: smoke._fields(eng._seed_segments_plain, a,
                                            eng.SEG_KEYS),
                  smoke._segment_cost(torch, a))
    if "chain" in args.only:
        ch = captured["chain"]
        lv = smoke._chain_lv(torch, ch[3]).float()
        print(f"chain rows={ch[0].shape[0]} S={ch[0].shape[1]} "
              f"max_intronlen={ch[5]}: last valid segment most "
              f"{int(lv.max())}, median {float(lv.median())}", flush=True)
        timed(f"chain S={ch[0].shape[1]}",
              lambda: smoke._fields(eng._chain_cuda, ch, eng.CHAIN_KEYS),
              lambda: smoke._fields(eng._chain_plain, ch, eng.CHAIN_KEYS),
              smoke._chain_cost(torch, ch), plain_reps=1)
    if "pack_queries" in args.only:
        from gmap_gsnap_tpu_torch.align import runner as trun
        from gmap_gsnap_tpu_torch.utils import synth

        c, f, ln, uni = (captured["pack"] + (False,))[:4]
        print(f"pack_queries: largest call {c.shape[0]} reads, L="
              f"{c.shape[1]}, uniform {uni}", flush=True)
        # and 256 reads of 513-4,096 nt, as chip_smoke's long reads
        lrng = np.random.default_rng(args.seed + 2)
        recs, _ = synth.plant_spliced_reads(lrng, g, 256, L=4096,
                                            prefix="long")
        recs = [dataclasses.replace(r, seq=r.seq[:n], quality=r.quality[:n])
                for r, n in zip(recs, lrng.integers(513, 4097, 256))]
        long_batch = tuple(torch.from_numpy(x).to(dev)
                           for x in trun.encode_batch(recs, 4096))
        for label, a in ((f"{PE_BATCH} reads",
                          (c[:PE_BATCH], f[:PE_BATCH], ln[:PE_BATCH], uni)),
                         (f"{c.shape[0]} reads", (c, f, ln, uni)),
                         ("256 long reads L=4096", long_batch + (False,))):
            name = f"pack_queries {label}"
            entry = timed(
                name, lambda a=a: smoke._packed(se._pack_batch_cuda, *a),
                lambda a=a: smoke._packed(se._pack_batch_plain, *a),
                lambda out, a=a: (smoke._nbytes(a[:3], out), 0))
            # the launch floor: an empty kernel on the kernel's grid, timed
            # in turns with the kernel on one clock (a checkout from before
            # the floor's entry point has none)
            if "gsnap_pack_queries_floor" in kbuild._SIGNATURES:
                b_, L_ = a[0].shape
                ms, clock, _ = smoke._timed(
                    lambda a=a: se._pack_batch_cuda(*a),
                    lambda: kbuild.launch("gsnap_pack_queries_floor", dev,
                                          b_, L_), reps=REPS)
                entry.update(beside_floor_ms=ms[0], floor_ms=ms[1],
                             floor_clock=clock)
                print(f"{name}: kernel {ms[0]} ms, empty kernel on its grid "
                      f"{ms[1]} ms ({clock})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
