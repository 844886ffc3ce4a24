"""K3 (prefix_mismatches) and K4 (solve_indels) in the CPU emulation,
through the port's _prefix_mismatches_cuda / _solve_indels_cuda, against
their plain versions: K3 on synth.prefix_mismatch_cases at L 75, 100,
150 and 1024 (B x NC not a multiple of the kernel's tile; INVALID
diagonals and diagonals at and past the genome end; genome and query
Ns; reads of 1, 15, 16 and 17 nt) under all four conversions and none,
with and without an alt genome, under both N rules; K4 on
synth.indel_pair_cases at the same lengths (insertions of every shift,
deletions, differences that wrap, rows named by several pairs, a
candidate only at s = L, ties) at min_end 0, 4 and past half the read,
with and without the seed-order gate; then both on planted reads (NC 32
and 128, L = 100, and reads of 513 to 1024 nt).

    python tools/cuda_emu/rehearse_prefix_indels.py OUTDIR
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emu_build  # noqa: E402

emu_build.use(emu_build.build(["prefix_mismatches", "solve_indels"],
                              sys.argv[1]))

from gmap_gsnap_tpu_torch import convert  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_se as se  # noqa: E402
from gmap_gsnap_tpu_torch.align import runner as trun  # noqa: E402
from gmap_gsnap_tpu_torch.ops import mismatch as mmo  # noqa: E402
from gmap_gsnap_tpu_torch.utils import synth  # noqa: E402


def equal(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def prefix(tg, q, diags, ln, what):
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    try:
        for qunk, gunk in ((False, True), (True, False)):
            mmo.QUERY_UNK_MISMATCH, mmo.GENOME_UNK_MISMATCH = qunk, gunk
            for conv in (None, "ct", "ga", "ag", "tc"):
                for a in (None, alt):
                    equal(mmo._prefix_mismatches_cuda(tg, q, diags, ln, conv,
                                                      a),
                          mmo._prefix_mismatches_plain(tg, q, diags, ln,
                                                       conv, a),
                          f"K3 {what} conv={conv} alt={a is not None} "
                          f"qunk={qunk}")
    finally:
        mmo.QUERY_UNK_MISMATCH, mmo.GENOME_UNK_MISMATCH = False, True


def indels(top_d, mm, pref, ii, jj, pv, ln, budget, L, qp5, qp3, what):
    for min_end in (0, 4, L // 2 + 1):
        for gate in (True, False):
            args = (top_d, mm, pref, ii, jj, pv, ln, budget, L,
                    qp5 if gate else None, qp3 if gate else None, 9, 30,
                    min_end)
            got, want = gg._solve_indels_cuda(*args), gg._solve_indels_plain(
                *args)
            equal([got[k] for k in gg._INDEL_KEYS],
                  [want[k] for k in gg._INDEL_KEYS],
                  f"K4 {what} min_end={min_end} gate={gate}")


for L in (75, 100, 150, 1024):
    rng = np.random.default_rng(L)
    case = synth.prefix_mismatch_cases(rng, 37, 24, L)
    tg = convert.genome_from_host(case["gcodes"], case["gflags"],
                                  [len(case["gcodes"])], "cpu")
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    q = se._pack_device_plain(t["codes"], t["nflags"], t["lengths"], L)
    prefix(tg, q, t["diags"], t["lengths"], f"edges L={L}")
    d = {k: torch.from_numpy(v)
         for k, v in synth.indel_pair_cases(rng, 40, 32, 16, L).items()}
    indels(d["top_d"], d["mm"], d["pref"], d["ii"], d["jj"], d["pvalid"],
           d["lengths"], d["budget"], L, d["qp5"], d["qp3"],
           f"edges L={L}")
    print(f"K3 and K4 edges at L={L}: equal", flush=True)

rng = np.random.default_rng(13)
g = synth.make_genome(rng, [150_000, 100_000])
db = synth.genome_db(g, 12, 3)
tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, "cpu")
ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
recs, _ = synth.plant_reads(rng, g, 24, weights=dict(
    sub=3, n=1, mid_indel=2, end_indel=1, terminal=1, repeat=1, junk=0.5))
long_recs, _ = synth.plant_spliced_reads(rng, g, 8, L=1024)
long_recs = [dataclasses.replace(r, seq=r.seq[:n], quality=r.quality[:n])
             for r, n in zip(long_recs, rng.integers(513, 1025, 8))]
for label, rr, L, shapes in (("L=100", recs, 100, ((384, 32), (4096, 128))),
                             ("L=513-1024", long_recs, 1024, ((512, 32),))):
    c, f, ln = (torch.from_numpy(x) for x in trun.encode_batch(rr, L))
    crc, frc = se._revcomp_batch_plain(c, f, ln)
    c, f, ln = torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])
    q = se._pack_device_plain(c, f, ln, L)
    budget = se.auto_budget(ln, 12, 3, -1)
    for st, nc in shapes:
        p = se.GsnapParams(seed_total=st, ncand=nc)
        diag, qgrid = se._seed_diagonals_plain(ti, c, f, ln, p, True)[:2]
        top_d, votes, _ = se._top_diagonals_plain(diag, nc)
        top_d[:, -1] = tg.length - 60            # runs past the genome end
        prefix(tg, q, top_d, ln, f"planted {label} NC={nc}")
        mm, pref = mmo._prefix_mismatches_plain(tg, q, top_d, ln, None, None)
        ii, jj, pv = gg._select_pairs_plain(
            top_d, votes, gg._indel_pairs_eligible(30, 9), 16)
        qp5, qp3 = se._qpos_ranges_plain(diag, qgrid, top_d)
        indels(top_d, mm, pref, ii, jj, pv, ln, budget, L, qp5, qp3,
               f"planted {label} NC={nc}")
        print(f"K3 and K4 on planted reads, {label} NC={nc}: equal",
              flush=True)
