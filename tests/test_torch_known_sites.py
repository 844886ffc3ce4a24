"""Port parity for known splice sites (gsnap -s), against the JAX package
on a synthetic genome: the IIT writer and the splicesites loader (both
map formats), fetch_span_bits, the splice solvers with known-site masks
(kernels K5 and K7 through their plain paths) at novel on and off,
align_batch_gapped / align_batch_pe with known sites, GsnapRunner.run
and run_pe (SAM byte-equal, with short-end reads, ambiguous splices
with and without --ambig-splice-noclip, known non-canonical introns and
inside-ambiguous pairs resolved against the mate) at -N 0 and -N 1, and
both gsnap CLIs with -s/--splicingdir/--ambig-splice-noclip.  Exact
everywhere: float32 outputs are compared as their bits."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu.db import iit as jiit
from gmap_gsnap_tpu.db import iit_text as jiit_text
from gmap_gsnap_tpu.db import splicesites as jss
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.db import iit as tiit
from gmap_gsnap_tpu_torch.db import iit_text as tiit_text
from gmap_gsnap_tpu_torch.db import splicesites as tss
from gmap_gsnap_tpu_torch.ops import genome as tgen
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (align_batch_as_runners, fresh_jax_caches, jax_db,
                          jax_runner_one_device, one_torch_thread,
                          runner_params, site_snp_world)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = site_snp_world(tmp_path_factory.mktemp("sites"))
    db = w["db"]
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    w["jax"] = (jg, ji)
    w["torch"] = (convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                             jg.chr_offsets, "cpu"),
                  convert.index_from_arrays(ji.offsets, ji.positions, 12, 3,
                                            "cpu"))
    sites = jss.load_splicesites(jiit.IIT.read(os.path.join(w["dir"],
                                                            "sites.iit")),
                                 db.chr_names, db.chr_starts)
    w["jknown"] = sites.device_bitmasks(len(db.codes))
    w["tknown"] = tuple(torch.from_numpy(np.asarray(k).view(np.int32).copy())
                        for k in w["jknown"])
    return w


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


def _j(x, dt=None):
    a = x.numpy()
    return jnp.asarray(a if dt is None else a.astype(dt))


def _introns_text(world) -> str:
    """An introns-format map (no donor/acceptor tags: each entry is an
    intron span, X > Y on the minus strand) of the world's sense and
    antisense introns."""
    g = world["genome"]
    starts = np.concatenate([[0], g.chr_ends[:-1]])
    out = []
    for i, t in enumerate(synth.random_introns(np.random.default_rng(2), g,
                                               60)):
        c = int(np.searchsorted(g.chr_ends, t.donor, side="right"))
        lo, hi = t.donor - starts[c] + 1, t.acceptor - starts[c]
        x, y = (lo, hi) if t.sense else (hi, lo)
        out.append(f">n{i} {g.names[c]}:{x}..{y}\n")
    return "".join(out)


@pytest.mark.parametrize("which", ["sites", "introns", "snps"])
def test_iit_writers_byte_equal(world, tmp_path, which):
    text = {"sites": world["sites_text"], "snps": world["snps_text"],
            "introns": _introns_text(world)}[which]
    jiit_text.iit_from_text(text).write(str(tmp_path / "j.iit"))
    tiit_text.iit_from_text(text).write(str(tmp_path / "t.iit"))
    assert (tmp_path / "t.iit").read_bytes() == (tmp_path / "j.iit").read_bytes()
    back = tiit.IIT.read(str(tmp_path / "t.iit"))
    assert sum(map(len, back.intervals.values())) == text.count(">")


@pytest.mark.parametrize("which", ["sites", "introns"])
def test_load_splicesites_and_bitmasks(world, tmp_path, which):
    db = world["db"]
    text = world["sites_text"] if which == "sites" else _introns_text(world)
    path = str(tmp_path / "m.iit")
    tiit_text.iit_from_text(text).write(path)
    j = jss.load_splicesites(jiit.IIT.read(path), db.chr_names, db.chr_starts)
    t = tss.load_splicesites(tiit.IIT.read(path), db.chr_names, db.chr_starts)
    for f in ("donors", "acceptors", "antidonors", "antiacceptors",
              "donor_dists", "acceptor_dists", "antidonor_dists",
              "antiacceptor_dists"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (t.max_dist, t.labels, t.distances_observed, t.introns_only) == (
        j.max_dist, j.labels, j.distances_observed, j.introns_only)
    assert t.introns_only == (which == "introns") and t.nsites > 100
    for a, b in zip(j.device_bitmasks(len(db.codes)),
                    t.device_bitmasks(len(db.codes), "cpu")):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy().view(np.uint32))


def test_fetch_span_bits(world):
    """Starts on and next to word boundaries, next to the genome end (the
    word index clips to the last word), 0 and 0xFFFFFFFF (an INVALID
    diagonal), at span lengths that end on, before and past a word."""
    jbits = world["jknown"]
    rng = np.random.default_rng(3)
    nbits = len(np.asarray(jbits[0])) * 32
    dense = rng.integers(0, 2**32, len(np.asarray(jbits[0])), dtype=np.uint64)
    dense = dense.astype(np.uint32)
    starts = np.concatenate([
        np.arange(0, 200, 31), np.array([32, 64, 96, 1024, 1025, 1055]),
        rng.integers(0, nbits, 40), nbits - 1 - np.arange(0, 120, 7),
        [0xFFFFFFFF, 0xFFFFFFE0, 2**31]]).astype(np.int64)
    for words in (np.asarray(jbits[1]), dense):
        tw = torch.from_numpy(words.view(np.int32).copy())
        for n in (101, 33, 32, 1):
            a = jgen.fetch_span_bits(jnp.asarray(words),
                                     jnp.asarray(starts.astype(np.uint32)), n)
            b = tgen.fetch_span_bits(tw, torch.from_numpy(starts), n)
            assert _same(a, b), n
    assert np.asarray(a).any()


def _cascade(world, recs, ncand=32):
    """Both strands' candidate diagonals, votes and prefix sums from the
    port's plain path, with word-aligned, genome-end and INVALID
    diagonals planted."""
    tg, ti = world["torch"]
    c, f, l = trun.encode_batch(recs, 100)
    tc, tf, tl = (torch.from_numpy(x) for x in (c, f, l))
    crc, frc = tse._revcomp_batch_plain(tc, tf, tl)
    c2, f2, l2 = torch.cat([tc, crc]), torch.cat([tf, frc]), torch.cat([tl, tl])
    p = tse.GsnapParams(seed_total=512, ncand=ncand)
    diag = tse.seed_diagonals(ti, c2, f2, l2, p)[0]
    top_d, votes, _ = tse.top_diagonals(diag, ncand)
    top_d[0::3, 5] &= ~31
    top_d[1::3, 6] = tg.length - 45
    top_d[2::3, 7] = 0xFFFFFFFF
    _, pref = tgg._prefix_mm(tg, tse._pack_device_plain(c2, f2, l2, 100), top_d, l2,
                             None, None)
    return top_d, votes, pref, l2, tse.auto_budget(l2, 12, 3, -1)


@pytest.mark.parametrize("novel", [True, False])
def test_solve_splices_known(world, novel):
    (jg, _), (tg, _) = world["jax"], world["torch"]
    top_d, votes, pref, l2, budget = _cascade(world, world["reads"][::6])
    ii, jj, pv = tgg._select_pairs_plain(top_d, votes,
                                   tgg._splice_pairs_eligible(200_000), 16)
    ii[:, 12], jj[:, 13], ii[:, 14] = 5, 6, 7
    jres = jgg._solve_splices(
        jg, _j(top_d, np.uint32), _j(pref), _j(ii, np.int32), _j(jj, np.int32),
        _j(pv), _j(l2), _j(budget), 100, novel=novel, known=world["jknown"])
    tres = tgg.solve_splices(tg, top_d, pref, ii, jj, pv, l2, budget, 100,
                             novel=novel, known=world["tknown"])
    for k in tgg._SPLICE_KEYS:
        assert _same(jres[k], tres[k]), k
    v = tres["valid"]
    assert v.any() and (tres["prob_d"][v] == 1.0).any()
    if not novel:   # known sites only: every splice side is a known site
        assert bool(((tres["prob_d"] == 1.0) & (tres["prob_a"] == 1.0))[v].all())


@pytest.mark.parametrize("novel", [True, False])
def test_solve_doublesplices_known(world, novel):
    (jg, _), (tg, _) = world["jax"], world["torch"]
    top_d, votes, pref, l2, budget = _cascade(world, world["reads"][::6])
    t3 = list(tgg.select_triples(top_d, votes, 200_000, 8))
    t3[0][:, 5], t3[1][:, 6], t3[2][:, 7] = 5, 6, 7
    jres = jgg._solve_doublesplices(
        jg, _j(top_d, np.uint32), _j(pref), *(_j(x, np.int32) for x in t3[:3]),
        _j(t3[3]), _j(l2), _j(budget), 100, novel=novel, known=world["jknown"])
    tres = tgg.solve_doublesplices(tg, top_d, pref, *t3, l2, budget, 100,
                                   novel=novel, known=world["tknown"])
    for k in tgg._SHORTEXON_KEYS:
        assert _same(jres[k], tres[k]), k


def _same_tree(j, t, path=""):
    """JAX result tree vs the port's: same keys, and _same leaves."""
    if isinstance(j, dict):
        assert set(j) == set(t), (path, set(j) ^ set(t))
        for k in j:
            _same_tree(j[k], t[k], f"{path}.{k}")
        return
    assert _same(j, t), path


def _runners(world, novel, **changes):
    db = world["db"]
    sites = os.path.join(world["dir"], "sites.iit")
    return (jrun.GsnapRunner(jax_db(db), runner_params(jse, db, **changes),
                             novelsplicing=novel, splicesdb=sites),
            trun.GsnapRunner(db, runner_params(tse, db, **changes),
                             novelsplicing=novel, splicesdb=sites,
                             device="cpu"))


@pytest.mark.parametrize("novel", [False, True])
def test_align_batch_known(world, novel):
    """align_batch_gapped and align_batch_pe with known sites (and -N 1,
    or with novel sites off): every output key, on the batches and with
    the parameters of test_run_sam_known_sites' runners."""
    j, t = align_batch_as_runners(*_runners(world, novel), world["reads"])
    _same_tree(j, t)
    assert bool((t["kind"][:, 0] == tgg.KIND_SPLICE).any())
    p1, p2 = world["pairs"]
    j, t = align_batch_as_runners(*_runners(world, novel, gmap_mode=""),
                                  p1, p2)
    _same_tree(j, t)


@pytest.mark.parametrize("novel", [False, True])
def test_run_sam_known_sites(world, novel):
    """-s alone at -N 0 (known sites only) and -N 1: SE SAM (default GMAP
    lanes, which -s gates off) and PE SAM (no GMAP lanes) byte-equal,
    with and without --ambig-splice-noclip; the short-end lane spliced
    reads and left ambiguous ones clipped, and the PE rescue resolved
    inside-ambiguous pairs against their mates.  One batch each, so the
    JAX package compiles each configuration once."""
    p1, p2 = world["pairs"]
    outs = {}
    for what in ("se", "pe"):
        kw = {} if what == "se" else dict(gmap_mode="")
        jr, tr = _runners(world, novel, **kw)
        for amb_clip in (True, False):
            jr.amb_clip = tr.amb_clip = amb_clip
            tr.ambi_resolved = 0
            jo, to = io.StringIO(), io.StringIO()
            if what == "se":
                jr.run(world["reads"], jo, batch_size=256)
                tr.run(world["reads"], to, batch_size=256)
            else:
                jr.run_pe(p1, p2, jo, batch_size=128)
                tr.run_pe(p1, p2, to, batch_size=128)
                assert (tr.ambi_resolved > 0) == amb_clip
            assert to.getvalue() == jo.getvalue(), (what, amb_clip)
            outs[what, amb_clip] = to.getvalue()
    se = outs["se", True]
    recs = [l.split("\t") for l in se.splitlines() if l[0] != "@"]
    # short-end reads (k*) and non-canonical ones (c*) spliced, and some
    # clipped ambiguous ones that --ambig-splice-noclip drops
    assert any(f[0][0] == "k" and "N" in f[5] for f in recs)
    assert any(f[0][0] == "c" and "N" in f[5] for f in recs)
    assert outs["se", False] != se


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    d = tmp_path_factory.mktemp("db")
    world["genome"].write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), world["reads"])
    return d


def test_cli_known_sites(world, disk_db, capsys):
    args = ["-D", str(disk_db), "-d", "syn", "-N", "1", "-s", "sites",
            "--splicingdir", world["dir"], "--ambig-splice-noclip",
            "--batch-size", "256", str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert any("N" in l.split("\t")[5] for l in port_sam.splitlines()
               if l[0] != "@")
