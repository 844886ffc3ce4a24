"""Time kernels K16 (select_pairs) and K7 (solve_doublesplices) of one
checkout of the port on the card, beside K16's library sort, so that two
versions can be compared within one call (run it for each tree in turns:
old, new, new, old).

The inputs are those of an -N 1 batch: planted RNA reads (2048, both
strands: 4096 rows) over a synthetic genome, seeded, voted and verified
by the plain stages, at NC=32 (the -N 1 runner's seed budget) and at
W=4096, NC=128; K16 under both rules with 16 pairs, K7 on 8 triples a
read, L=100, without and with known-site masks (sparse and dense random
bits); K16 also on synth.diag_pair_rows' edge rows (1024 rows, NC 3 to
128, maxpairs 16 and 1024).  Times are torch.profiler device time per
call, as chip_smoke.py takes them (its _timed), and every kernel is
checked against its plain version first.  Prints one JSON line.

    python tools/time_pair_splice.py [--root DIR] [--mbp 16] [--reads 2048]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="checkout whose gmap_gsnap_tpu_torch is timed")
    ap.add_argument("--mbp", type=float, default=16.0)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=11)
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
    times = {}

    def timed(name, fk, fp, lib=None):
        got, want = fk(), fp()
        if smoke._max_abs_err(got, want) != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version")
        ms, clock, _ = smoke._timed(fk, fp, *([lib] if lib else []))
        times[name] = {"ms": ms[0], "plain_ms": ms[1], "clock": clock,
                       "library_ms": ms[2] if lib else None}
        print(f"{name}: {times[name]}", flush=True)

    rules = (("indel", (0, 30, 9), gg._indel_pairs_eligible(30, 9)),
             ("splice", (1, 200_000, 0), gg._splice_pairs_eligible(200_000)))

    def pairs(label, t, v, npairs):
        for rule, kargs, fn in rules:
            timed(f"select_pairs {rule} {label}",
                  lambda kargs=kargs: gg._select_pairs_cuda(t, v, npairs,
                                                            *kargs),
                  lambda fn=fn: gg._select_pairs_plain(t, v, fn, npairs),
                  smoke._pair_sort(torch, se, t, v, fn))

    for st, nc in ((512, 32), (4096, 128)):
        p = se.GsnapParams(seed_total=st, ncand=nc)
        top_d, votes, _ = se._top_diagonals_plain(
            se._seed_diagonals_plain(ti, c, f, ln, p, True)[0], nc)
        pairs(f"NC={nc}", top_d, votes, 16)
        _, pref = mmo._prefix_mismatches_plain(tg, q, top_d, ln, None, None)
        tr = gg._select_triples_plain(top_d, votes, 200_000, 8)
        for label, novel, kn in (("no masks", True, None),
                                 ("masks 0.002", True, masks[0.002]),
                                 ("masks 0.15", True, masks[0.15]),
                                 ("masks 0.15 novel=0", False, masks[0.15])):
            dargs = (tg, top_d, pref, *tr, ln, budget, 100, novel, kn)
            timed(f"solve_doublesplices {label} NC={nc}",
                  lambda a=dargs: smoke._fields(gg._solve_doublesplices_cuda,
                                                a, gg._SHORTEXON_KEYS),
                  lambda a=dargs: smoke._fields(gg._solve_doublesplices_plain,
                                                a, gg._SHORTEXON_KEYS))
    # K16 on synth.diag_pair_rows (1024 rows): NC off 32, maxpairs 16
    # and NC^2, both rules (a checkout older than that generator: none)
    edges = (((3, 16), (24, 16), (32, 16), (32, 1024), (128, 16))
             if hasattr(synth, "diag_pair_rows") else ())
    for nc, npairs in edges:
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
