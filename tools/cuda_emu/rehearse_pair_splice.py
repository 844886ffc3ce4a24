"""K16 (select_pairs) and K7 (solve_doublesplices) in the CPU emulation,
through the port's _select_pairs_cuda / _solve_doublesplices_cuda,
against their plain versions: K16 on synth.diag_pair_rows and
diag_pair_cases (NC 3 to 128, maxpairs 1 to NC^2, both rules), K7 on
synth.doublesplice_cases (NC 32 and 128, novel on and off, with and
without known sites) and on planted spliced reads' triples with dense
random known-site masks.

    python tools/cuda_emu/rehearse_pair_splice.py OUTDIR
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emu_build  # noqa: E402

emu_build.use(emu_build.build(["select_pairs", "solve_doublesplices"],
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


def doublesplices(args, what):
    equal([gg._solve_doublesplices_cuda(*args)[k] for k in gg._SHORTEXON_KEYS],
          [gg._solve_doublesplices_plain(*args)[k]
           for k in gg._SHORTEXON_KEYS], what)


rng = np.random.default_rng(9)
rules = ((0, 30, 9, gg._indel_pairs_eligible(30, 9)),
         (1, 200_000, 0, gg._splice_pairs_eligible(200_000)),
         (1, 2**31 + 5, 0, gg._splice_pairs_eligible(2**31 + 5)))
for nc in (3, 24, 32, 50, 128):
    for gen in (synth.diag_pair_rows, synth.diag_pair_cases):
        top, votes = (torch.from_numpy(x)
                      for x in gen(rng, 8 if nc <= 32 else 4, nc))
        for p in sorted({1, 16, nc * nc, nc * nc + 7}):
            for rule, a, b_, fn in rules:
                equal(gg._select_pairs_cuda(top, votes, p, rule, a, b_),
                      gg._select_pairs_plain(top, votes, fn, p),
                      f"K16 NC={nc} P={p} rule={rule}")
print("K16: every shape equal", flush=True)

for nc in (32, 128):
    case = synth.doublesplice_cases(np.random.default_rng(nc), 24, nc)
    codes = case["codes"]
    tg = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                  [len(codes)], "cpu")
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "known"}
    kn = tuple(torch.from_numpy(k.view(np.int32).copy())
               for k in case["known"])
    for novel, known in ((True, None), (True, kn), (False, kn)):
        doublesplices((tg, t["top_d"], t["pref"], t["ti"], t["tm"], t["tj"],
                       t["tvalid"], t["lengths"], t["budget"], 100, novel,
                       known), f"K7 edges NC={nc} novel={novel}")
print("K7: every edge equal", flush=True)

g = synth.make_genome(rng, [150_000, 100_000])
db = synth.genome_db(g, 12, 3)
recs, _ = synth.plant_spliced_reads(rng, g, 48)
c, f, ln = (torch.from_numpy(x) for x in trun.encode_batch(recs, 100))
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
    _, pref = mmo._prefix_mismatches_plain(tg, q, top_d, ln, None, None)
    t3 = list(gg._select_triples_plain(top_d, votes, 200_000, 8))
    t3[0][:, 4:] = torch.from_numpy(rng.integers(0, 8, (len(ln), 4)))
    for novel, kn in ((True, None), (True, known), (False, known)):
        doublesplices((tg, top_d, pref, *t3, ln, budget, 100, novel, kn),
                      f"K7 planted NC={nc} novel={novel}")
print("K7 on planted reads: equal", flush=True)
