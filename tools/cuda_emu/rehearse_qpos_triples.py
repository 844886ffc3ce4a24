"""K15 (qpos_ranges) and K6 (select_triples) in the CPU emulation,
through the port's _qpos_ranges_cuda / _select_triples_cuda, against
their plain versions: K15 on synth.qpos_range_cases (selected diagonals
repeated and INVALID, all-INVALID rows, diagonals 0 and 0xFFFFFFFE, qpos
not monotone) at W 1, 31, 33, 384 and 4096 and P 1, 32 and 128, then on
the seed grids of planted reads (W=384, NC=32 and W=4096, NC=128); K6
on synth.triple_cases (clusters, wrapping differences, equal and zero
votes, all-INVALID rows, sums at the key's width) at NC 2, 3, 31, 32,
33, 64 and 128, maxdist 0, 1, 200,000 and 2^32 - 1, T 1, 8 and 4 NC,
then on the planted reads' top diagonals.

    python tools/cuda_emu/rehearse_qpos_triples.py OUTDIR
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emu_build  # noqa: E402

emu_build.use(emu_build.build(["qpos_ranges", "select_triples"],
                              sys.argv[1]))

from gmap_gsnap_tpu_torch import convert  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_se as se  # noqa: E402
from gmap_gsnap_tpu_torch.align import runner as trun  # noqa: E402
from gmap_gsnap_tpu_torch.utils import synth  # noqa: E402


def equal(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def ranges(diag, qgrid, dsel, what):
    equal(se._qpos_ranges_cuda(diag, qgrid, dsel),
          se._qpos_ranges_plain(diag, qgrid, dsel), f"K15 {what}")


def triples(top, votes, what):
    nc = top.shape[1]
    for maxdist in (0, 1, 200_000, 2**32 - 1):
        for t in sorted({1, 8, 4 * nc}):
            equal(gg._select_triples_cuda(top, votes, maxdist, t),
                  gg._select_triples_plain(top, votes, maxdist, t),
                  f"K6 {what} maxdist={maxdist} T={t}")


rng = np.random.default_rng(17)
for w in (1, 31, 33, 384, 4096):
    for p in (1, 32, 128):
        ranges(*(torch.from_numpy(x)
                 for x in synth.qpos_range_cases(rng, 9, w, p)),
               f"edges W={w} P={p}")
print("K15: every edge equal", flush=True)
for nc in (2, 3, 31, 32, 33, 64, 128):
    triples(*(torch.from_numpy(x) for x in synth.triple_cases(rng, 13, nc)),
            f"edges NC={nc}")
print("K6: every edge equal", flush=True)

g = synth.make_genome(rng, [150_000, 100_000])
db = synth.genome_db(g, 12, 3)
ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
recs, _ = synth.plant_spliced_reads(rng, g, 24)
c, f, ln = (torch.from_numpy(x) for x in trun.encode_batch(recs, 100))
crc, frc = se._revcomp_batch_plain(c, f, ln)
c, f, ln = torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])
for st, nc in ((384, 32), (4096, 128)):
    p = se.GsnapParams(seed_total=st, ncand=nc)
    diag, qgrid = se._seed_diagonals_plain(ti, c, f, ln, p, True)[:2]
    top_d, votes, _ = se._top_diagonals_plain(diag, nc)
    top_d[:, -3:] = se.INVALID_DIAG
    ranges(diag, qgrid, top_d, f"planted W={st} NC={nc}")
    triples(top_d, votes, f"planted NC={nc}")
    print(f"K15 and K6 on planted reads, W={st} NC={nc}: equal", flush=True)
