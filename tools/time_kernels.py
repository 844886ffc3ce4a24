"""Time the redesigned kernels of one checkout of the port on the card —
K3 (prefix_mismatches, with and without an alt genome), K4
(solve_indels), K13 (lane_features), K5 (solve_splices), K6
(select_triples, beside its library sort), K7 (solve_doublesplices), K15
(qpos_ranges) and K16 (select_pairs, beside its library sort) — so that
two versions can
be compared within one call (run it for each tree in turns: old, new,
new, old).

The inputs are those of an -N 1 batch: planted RNA reads (2048, both
strands: 4096 rows) over a synthetic genome, seeded, voted and verified
by the plain stages, at NC=32 (the -N 1 runner's seed budget) and at
W=4096, NC=128; K3 on their diagonals (the alt genome: the genome's
words reversed); K4 on 16 indel pairs a read (max_ins 9, max_del 30,
min_end 4, the seed-order gate); K13 on K3's mask at both, L=100, k=12,
interval 3, trim score -3; K5 on 16 splice pairs a read and K7 on 8
triples, without and with known-site masks (sparse and dense random bits, novel on and, with
dense bits, off); K15 on the seed grids and selected diagonals at W=384,
NC=32 (the -N 0 runner's seed budget) and W=4096, NC=128; K16 under
both rules with 16 pairs, and on
synth.diag_pair_rows' edge rows (1024 rows, NC 3 to 128, maxpairs 16 and
1024).  Times are torch.profiler device time per call, as chip_smoke.py
takes them (its _timed), and every kernel is checked against its plain
version first.  K6's library sort is also timed on keys of the same
shape that are all equal, and between CUDA events.  "cascade" times
align_batch_gapped whole (-N 0 and -N 1) on the 2048 reads: the host's
wall per call to torch.cuda.synchronize(), the median of 20 after two
warm-up calls.  Prints one JSON line.

    python tools/time_kernels.py [--root DIR] [--mbp 16] [--reads 2048]
        [--only prefix_mismatches solve_indels ...]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("prefix_mismatches", "solve_indels", "lane_features",
           "solve_splices", "select_triples", "solve_doublesplices",
           "select_pairs", "qpos_ranges", "cascade")


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

    def timed(name, fk, fp, cost, lib=None):
        """Check fk against fp, then time both (and lib); cost maps the
        plain output to (bytes, operations), chip_smoke's bound."""
        got, want = fk(), fp()
        if smoke._max_abs_err(got, want) != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version")
        bound = smoke._bound(*cost(want))
        ms, clock, _ = smoke._timed(fk, fp, *([lib] if lib else []))
        times[name] = {"ms": ms[0], "plain_ms": ms[1], "clock": clock,
                       "library_ms": ms[2] if lib else None,
                       "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"{name}: {times[name]}", flush=True)

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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
