"""K2 (top_diagonals) and K14 (rank_hits) in the CPU emulation, through
the port's _top_diagonals_cuda / _rank_hits_cuda / _rank_gate_se_cuda,
against their plain versions on synth's edge rows (every row kind,
W off a power of two and up to 32768, 1 to 512 candidates) and on
gather_candidates' output with the SE gates.

    python tools/cuda_emu/rehearse_rank_select.py OUTDIR
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import emu_build  # noqa: E402

emu_build.use(emu_build.build(["rank_hits", "top_diagonals"], sys.argv[1]))

from gmap_gsnap_tpu_torch import convert  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg  # noqa: E402
from gmap_gsnap_tpu_torch.align import gsnap_se as se  # noqa: E402
from gmap_gsnap_tpu_torch.align import runner as trun  # noqa: E402
from gmap_gsnap_tpu_torch.utils import synth  # noqa: E402


def equal(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            equal(a[k], b[k], f"{what} {k}")
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            equal(x, y, what)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


rng = np.random.default_rng(5)
for w, nc in ((384, 32), (383, 32), (385, 32), (17, 5), (64, 64),
              (4096, 128), (4096, 4096), (8192, 256), (20000, 128),
              (32768, 16384)):
    d = torch.from_numpy(synth.diag_vote_rows(rng, 6, w, nc))
    equal(se._top_diagonals_cuda(d, nc), se._top_diagonals_plain(d, nc),
          f"K2 W={w} NC={nc}")
print("K2: every shape equal", flush=True)
base = se.GsnapParams(subopt_levels=1)
for edge in synth.RANK_EDGE_KINDS:
    for n in (1, 33, 144, 336, 512):
        out = {k: torch.from_numpy(v)
               for k, v in synth.rank_hit_edges(rng, 6, n, edge).items()}
        out["plusp"] = (torch.arange(n) < n // 2).expand(6, n)
        for opt, maxout in ((True, None), (False, 16), (True, n + 9)):
            equal(gg._rank_hits_cuda(out, base, opt, maxout)[0],
                  gg._rank_hits_plain(out, base, opt, maxout),
                  f"K14 {edge} n={n}")
print("K14: every edge equal", flush=True)
g = synth.make_genome(rng, [200_000, 100_000])
db = synth.genome_db(g, 12, 3)
tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, "cpu")
ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
for spliced in (False, True):
    recs, _ = (synth.plant_spliced_reads(rng, g, 96) if spliced else
               synth.plant_reads(rng, g, 96))
    c, f, ln = (torch.from_numpy(x) for x in trun.encode_batch(recs, 100))
    for st, nc in ((384, 32), (4096, 128)):
        gp = gg.GappedParams(base=se.GsnapParams(seed_total=st, ncand=nc),
                             novelsplicing=spliced)
        out, cands = gg.gather_candidates(tg, ti, None, c, f, ln, gp)
        for gate in (True, False):
            args = (out, cands, ln.int(), 12, 3, gp, gate)
            equal(gg._rank_gate_se_cuda(*args),
                  gg._rank_gate_se_plain(*args), f"SE gates W={st}")
print("K14 with the SE gates: equal", flush=True)
