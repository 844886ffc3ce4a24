"""K13 (lane_features) and K5 (solve_splices) in the CPU emulation,
through the port's _lane_features_cuda / _solve_splices_cuda, against
their plain versions: K13 on synth.mismatch_edge_rows at L 75, 100 and
150 (a warp's rows cut short at the end, unaligned rows) and on K3's
output for planted reads, under two k-mer samplings and five trim
scores (two beyond the read length, which the kernel's C entry clamps);
K5 on synth.splice_pair_cases (NC 32 and 128, novel on and off, with
and without known sites) and on planted spliced reads' pairs with dense
random known-site masks.  (K7, whose helpers K5 shares, is
rehearsed by rehearse_pair_splice.py.)

    python tools/cuda_emu/rehearse_lane_splice.py OUTDIR
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emu_build  # noqa: E402

emu_build.use(emu_build.build(["lane_features", "solve_splices"],
                              sys.argv[1]))

from gmap_gsnap_tpu_torch import convert  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_se as se  # noqa: E402
from gmap_gsnap_tpu_torch.align import runner as trun  # noqa: E402
from gmap_gsnap_tpu_torch.ops import mismatch as mmo  # noqa: E402
from gmap_gsnap_tpu_torch.utils import synth  # noqa: E402


def equal(a, b, what):
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert x.dtype == y.dtype and torch.equal(x, y), what


def lane(mm, pref, ln, k, interval, score, what):
    got = gg._lane_features_cuda(mm, ln, k, interval, score)
    want = gg.lane_features(mm, pref, ln, k, interval, score)
    keys = sorted(want)
    equal([got[x] for x in keys], [want[x] for x in keys], what)


def splices(args, what):
    equal([gg._solve_splices_cuda(*args)[k] for k in gg._SPLICE_KEYS],
          [gg._solve_splices_plain(*args)[k] for k in gg._SPLICE_KEYS], what)


rng = np.random.default_rng(9)
for L in (75, 100, 150):
    # 23 rows of 7 candidates: the last warp holds 1 row
    mm, pref, ln = (torch.from_numpy(x)
                    for x in synth.mismatch_edge_rows(rng, 23, 7, L))
    for k, interval in ((12, 3), (15, 3)):
        # -200 and 1000: beyond the read length, clamped by the C entry
        for score in (-3, -1, 0, -200, 1000):
            lane(mm, pref, ln, k, interval, score,
                 f"K13 edges L={L} k={k} score={score}")
print("K13: every edge equal", flush=True)

for nc in (32, 128):
    case = synth.splice_pair_cases(np.random.default_rng(nc), 24, nc)
    codes = case["codes"]
    tg = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                  [len(codes)], "cpu")
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "known"}
    kn = tuple(torch.from_numpy(k.view(np.int32).copy())
               for k in case["known"])
    for novel, known in ((True, None), (True, kn), (False, kn)):
        splices((tg, t["top_d"], t["pref"], t["ii"], t["jj"], t["pvalid"],
                 t["lengths"], t["budget"], 100, novel, known),
                f"K5 edges NC={nc} novel={novel}")
print("K5: every edge equal", flush=True)

g = synth.make_genome(rng, [150_000, 100_000])
db = synth.genome_db(g, 12, 3)
recs, _ = synth.plant_spliced_reads(rng, g, 16)
c, f, ln = (torch.from_numpy(x) for x in trun.encode_batch(recs, 100))
ln[::5] = 71
tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, "cpu")
ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
crc, frc = se._revcomp_batch_plain(c, f, ln)
c, f, ln = torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])
q = se._pack_device_plain(c, f, ln, 100)
budget = se.auto_budget(ln, 12, 3, -1)
nwords = (tg.length + 31) // 32 + 2
known = tuple(torch.from_numpy(
    ((rng.random((nwords, 32)) < 0.15).astype(np.uint64)
     << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    .view(np.int32)) for _ in range(4))
for st, nc in ((512, 32), (4096, 128)):
    p = se.GsnapParams(seed_total=st, ncand=nc)
    top_d, votes, _ = se._top_diagonals_plain(
        se._seed_diagonals_plain(ti, c, f, ln, p, True)[0], nc)
    top_d[0::4, 5] &= ~31
    top_d[1::4, 6] = tg.length - 40 - torch.arange(top_d[1::4].shape[0]) % 30
    top_d[2::4, 7] = se.INVALID_DIAG
    mm, pref = mmo._prefix_mismatches_plain(tg, q, top_d, ln, None, None)
    for score in (-3, -1):
        lane(mm, pref, ln, 12, 3, score, f"K13 planted NC={nc}")
    pairs = gg._select_pairs_plain(top_d, votes,
                                   gg._splice_pairs_eligible(200_000), 16)
    for novel, kn in ((True, None), (True, known), (False, known)):
        splices((tg, top_d, pref, *pairs, ln, budget, 100, novel, kn),
                f"K5 planted NC={nc} novel={novel}")
print("K13 and K5 on planted reads: equal", flush=True)
