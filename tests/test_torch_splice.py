"""Port parity for novel splicing (-N 1): the splice solvers (kernels
K5, K6, K7 through their plain paths), align_batch_gapped with
novelsplicing — every output key — and GsnapRunner and both gsnap CLIs
(SAM byte-equal, with spliced, short-exon and distant records), against
the JAX package on a synthetic genome and planted spliced reads.
Exact everywhere: float32 outputs are compared as their bits."""

import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import jax_db

KINDS = dict(unspliced=3, junction=4, shortexon=3, distant=2.5, n_indel=1)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    recs, truth = synth.plant_spliced_reads(rng, g, 96, weights=KINDS)
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(ji.offsets, ji.positions, 12, 3, "cpu")
    return g, db, recs, truth, jg, ji, tg, ti


def _same(a, b) -> bool:
    """JAX array vs torch tensor: same shape and values, float32 by bits."""
    a = np.asarray(a)
    b = b.numpy()
    if a.shape != b.shape:
        return False
    if a.dtype == np.float32 or b.dtype == np.float32:
        return (a.dtype == b.dtype
                and np.array_equal(a.view(np.uint32), b.view(np.uint32)))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _cascade(world, ncand=32, seed_total=512):
    """Both strands' candidate diagonals, votes and prefix sums from the
    port's plain path, plus invalid diagonals and diagonals below 64 (the
    span start wraps in uint32)."""
    _, _, recs, _, _, _, tg, ti = world
    c, f, l = trun.encode_batch(recs, 100)
    tc, tf, tl = (torch.from_numpy(x) for x in (c, f, l))
    crc, frc = tse._revcomp_batch(tc, tf, tl)
    c2, f2, l2 = torch.cat([tc, crc]), torch.cat([tf, frc]), torch.cat([tl, tl])
    p = tse.GsnapParams(seed_total=seed_total, ncand=ncand)
    diag = tse.seed_diagonals(ti, c2, f2, l2, p)[0]
    top_d, votes, _ = tse.top_diagonals(diag, ncand)
    top_d[:, 3] = 0xFFFFFFFF
    top_d[:, 4] = 2
    _, pref = tgg._prefix_mm(tg, tse._pack_device(c2, f2, l2, 100), top_d, l2,
                             None, None)
    return top_d, votes, pref, l2, tse.auto_budget(l2, 12, 3, -1)


def _j(x, dt=None):
    a = x.numpy()
    return jnp.asarray(a if dt is None else a.astype(dt))


@pytest.mark.parametrize("ncand", [32, 128])
def test_solve_splices_direct(world, ncand):
    jg, tg = world[4], world[6]
    top_d, votes, pref, l2, budget = _cascade(world, ncand)
    ii, jj, pv = tgg._select_pairs_plain(top_d, votes,
                                   tgg._splice_pairs_eligible(200_000), 16)
    rng = np.random.default_rng(0)
    ii[:, 10:] = torch.from_numpy(rng.integers(0, ncand, (len(l2), 6)))
    jj[:, 10:] = torch.from_numpy(rng.integers(0, ncand, (len(l2), 6)))
    ii[:, 15], jj[:, 15] = 4, 0
    pv[:, 12:] = torch.from_numpy(rng.random((len(l2), 4)) < 0.7)
    jres = jgg._solve_splices(
        jg, _j(top_d, np.uint32), _j(pref), _j(ii, np.int32), _j(jj, np.int32),
        _j(pv), _j(l2), _j(budget), 100)
    tres = tgg.solve_splices(tg, top_d, pref, ii, jj, pv, l2, budget, 100)
    assert set(jres) == set(tres) == set(tgg._SPLICE_KEYS)
    for k in jres:
        assert _same(jres[k], tres[k]), k
    v = tres["valid"]
    assert v.any() and tres["sense"][v].any() and (~tres["sense"][v]).any()


@pytest.mark.parametrize("ncand,equal_votes", [(32, False), (32, True),
                                               (128, False)])
def test_select_triples(world, ncand, equal_votes):
    top_d, votes, _, _, _ = _cascade(world, ncand)
    if equal_votes:
        votes = torch.ones_like(votes)      # every tie goes to the lower index
    j = jgg._select_triples(_j(top_d, np.uint32), _j(votes), 200_000, 8)
    t = tgg.select_triples(top_d, votes, 200_000, 8)
    for a, b in zip(j, t):
        assert _same(a, b)
    assert t[3].any() and (~t[3]).any()


def test_solve_doublesplices_direct(world):
    jg, tg = world[4], world[6]
    top_d, votes, pref, l2, budget = _cascade(world, 32)
    ti, tm, tj, tv = tgg.select_triples(top_d, votes, 200_000, 8)
    rng = np.random.default_rng(1)
    ti[:, 6:] = torch.from_numpy(rng.integers(0, 32, (len(l2), 2)))
    tj[:, 6:] = torch.from_numpy(rng.integers(0, 32, (len(l2), 2)))
    ti[:, 7] = 4
    jres = jgg._solve_doublesplices(
        jg, _j(top_d, np.uint32), _j(pref), _j(ti, np.int32), _j(tm, np.int32),
        _j(tj, np.int32), _j(tv), _j(l2), _j(budget), 100)
    tres = tgg.solve_doublesplices(tg, top_d, pref, ti, tm, tj, tv, l2,
                                   budget, 100)
    assert set(jres) == set(tres) == set(tgg._SHORTEXON_KEYS)
    for k in jres:
        assert _same(jres[k], tres[k]), k
    assert tres["valid"].any()


@pytest.mark.parametrize("seed_total,ncand,mm", [
    (512, 32, -1), (4096, 128, -1), (0, 128, -1), (64, 8, 3)])
def test_align_batch_gapped_splicing_every_key(world, seed_total, ncand, mm):
    _, _, recs, _, jg, ji, tg, ti = world
    c, f, l = trun.encode_batch(recs, 100)
    base = dict(seed_total=seed_total, ncand=ncand, max_mismatches=mm)
    jout = jgg.align_batch_gapped(
        jg, ji, jnp.asarray(c), jnp.asarray(f), jnp.asarray(l),
        jgg.GappedParams(base=jse.GsnapParams(**base), novelsplicing=True))
    tout = tgg.align_batch_gapped(
        tg, ti, torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(l),
        tgg.GappedParams(base=tse.GsnapParams(**base), novelsplicing=True))
    assert set(jout) == set(tout)
    for k in sorted(jout):
        assert _same(jout[k], tout[k]), k
    ok = tout["score"] < 10**6
    kinds = tout["kind"][ok]
    assert (kinds == tgg.KIND_SPLICE).any() and (kinds == tgg.KIND_SHORTEXON).any()
    spliced = ok & (tout["kind"] >= tgg.KIND_SPLICE)
    assert tout["sense"][spliced].any() and (~tout["sense"][spliced]).any()


def _records(sam_text):
    return [l.split("\t") for l in sam_text.splitlines() if not l.startswith("@")]


def test_runner_splicing_sam_byte_equal(world, monkeypatch):
    g, db, recs, truth, *_ = world
    # reads in repeat copies overflow the candidate budget: the wide lane
    # re-runs them with -N 1 too
    recs = recs + synth.plant_reads(np.random.default_rng(3), g, 8,
                                    weights=dict(repeat=1), prefix="p")[0]
    jr = jrun.GsnapRunner(jax_db(db), params=jse.GsnapParams(gmap_mode=""),
                          novelsplicing=True)
    jout = io.StringIO()
    jr.run(recs, jout, batch_size=48)
    tr = trun.GsnapRunner(db, params=tse.GsnapParams(gmap_mode=""),
                          novelsplicing=True, device="cpu")
    assert tr.params.seed_total == 512
    wide = []
    dispatch_wide = tr._dispatch_wide
    monkeypatch.setattr(tr, "_dispatch_wide",
                        lambda *a, **k: wide.append(1) or dispatch_wide(*a, **k))
    tout = io.StringIO()
    assert tr.run(recs, tout, batch_size=48) == len(recs)
    assert wide
    assert tout.getvalue() == jout.getvalue()
    assert tr.category_counts == jr.category_counts
    assert tr.category_counts["unpaired_transloc"] > 0
    cigars = [f[5] for f in _records(tout.getvalue())]
    assert any(c.count("N") == 1 for c in cigars)
    assert any(c.count("N") == 2 for c in cigars)
    assert any("H" in c for c in cigars)
    assert "XT:Z:" in tout.getvalue() and "XS:A:-" in tout.getvalue()
    # planted easy junctions come out at their junction (chip_smoke's bar;
    # pieces in a copy of the repeat family map elsewhere as well)
    placed = {}
    for f in _records(tout.getvalue()):
        placed.setdefault(f[0], []).append(f)
    starts = dict(zip(db.chr_names, db.chr_starts.tolist()))

    def unique(t):
        (s, e), = t.junctions
        return not any(r < b and a < r + g.repeat_unit for r in g.repeats
                       for a, b in ((t.left, s), (e, e + t.flanks[1])))

    easy = [(i, t) for i, t in enumerate(truth) if t.kind == "junction"
            and min(t.flanks) >= 30 and t.nsub <= 1 and unique(t)]
    good = sum(len(placed[f"s{i}"]) == 1
               and _introns(placed[f"s{i}"][0], starts) == list(t.junctions)
               for i, t in easy)
    assert easy and good >= 0.9 * len(easy), (good, len(easy))


def _introns(f, starts):
    """[(start, end)) introns of a SAM record's N operations."""
    pos = starts[f[2]] + int(f[3]) - 1
    out = []
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]):
        if op == "N":
            out.append((pos, pos + int(n)))
        if op in "MDN=X":
            pos += int(n)
    return out


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    g, _, recs, *_ = world
    d = tmp_path_factory.mktemp("db")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), recs[:80])
    return d


@pytest.mark.parametrize("extra", [[], ["-w", "5000", "-E", "2"]])
def test_cli_splicing_byte_equal(disk_db, capsys, extra):
    args = ["-D", str(disk_db), "-d", "syn", "--gmap-mode", "none", "-N", "1",
            "--batch-size", "48", *extra, str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    cigars = [f[5] for f in _records(port_sam)]
    assert any(c.count("N") == 2 for c in cigars) and "XT:Z:" in port_sam
