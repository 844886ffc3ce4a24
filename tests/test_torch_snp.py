"""Port parity for SNP-tolerant alignment (gsnap -v), against the JAX
package on a synthetic genome: the alt genome, the SNP k-mers and the
SNP index files (flat and Elias-gamma offsets), the runner's mismatch
masks (selection honours the alt allele, NM stays ref-relative),
align_batch_gapped / align_batch_pe with the alt genome on the SNP
index, and GsnapRunner.run / run_pe with -v at -N 0 and -N 1 (SAM
byte-equal; reads with 5-8 alt alleles are placed only with -v)."""

import io
import os

import numpy as np
import pytest

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.db import iit_text as jiit_text
from gmap_gsnap_tpu.db import transforms as jtr
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.db import iit_text as tiit_text
from gmap_gsnap_tpu_torch.db import transforms as ttr
from gmap_gsnap_tpu_torch.utils import dna
from torch_parity import (align_batch_as_runners, fresh_jax_caches, jax_db,
                          jax_runner_one_device, one_torch_thread,
                          runner_params, site_snp_world)
from torch_parity import same_tree as _same_tree


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return site_snp_world(tmp_path_factory.mktemp("snps"))


@pytest.mark.parametrize("k,basesize", [(12, 12), (8, 6)])
def test_write_snp_index_byte_equal(world, tmp_path, k, basesize):
    """The alt genome, the SNP k-mer pairs and every file of the SNP
    index equal the JAX package's, with flat offsets and with
    Elias-gamma ones (basesize < k)."""
    g, db = world["genome"], world["db"]
    codes, flags = g.codes_flags
    jalt = jtr.alt_genome_from_snps(codes, jiit_text.iit_from_text(
        world["snps_text"]), db.chr_names, db.chr_starts)
    talt = ttr.alt_genome_from_snps(codes, tiit_text.iit_from_text(
        world["snps_text"]), db.chr_names, db.chr_starts)
    assert np.array_equal(jalt, talt) and (talt != codes).sum() > 900
    pos = np.flatnonzero(talt != codes)
    assert (jtr.snp_kmer_pairs(codes, flags, db.chr_ends, pos, talt[pos], k, 3)
            == ttr.snp_kmer_pairs(codes, flags, db.chr_ends, pos, talt[pos],
                                  k, 3))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jtr.write_snp_index(str(tmp_path / "j"), "syn", "snps", codes, flags,
                        db.chr_ends, jalt, k=k, basesize=basesize)
    ttr.write_snp_index(str(tmp_path / "t"), "syn", "snps", codes, flags,
                        db.chr_ends, talt, k=k, basesize=basesize)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert any("gammaptrs" in n for n in names) == (basesize < k)
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n


@pytest.fixture(scope="module")
def runners(world):
    db, d = world["db"], world["dir"]
    return (jrun.GsnapRunner(jax_db(db), snpsdb="snps", snps_dir=d),
            trun.GsnapRunner(db, snpsdb="snps", snps_dir=d, device="cpu"))


def test_mismatch_masks_nm_ref_relative(world, runners):
    """Under -v the selection mask takes the alt allele as a match and
    the MD/NM mask stays ref-relative (a new array, not an in-place
    AND of the shared one): equal to the JAX runner's, in the scalar and
    the batched forms, and a SNP-heavy read's SAM NM counts its alt
    alleles."""
    jr, tr = runners
    for rec, t in zip(world["snp_reads"][:10], world["snp_truth"][:10]):
        q = rec.seq if t.plusp else dna.revcomp_str(rec.seq)
        jm, jref = jr._mismatch_masks(q, t.left, None)
        tm, tref = tr._mismatch_masks(q, t.left)
        assert np.array_equal(jm, tm) and np.array_equal(jref, tref)
        assert tm.sum() <= 1 < 5 <= tref.sum()
        sub = tr._sub_batch([rec.seq], np.array([t.left]),
                            np.array([t.plusp]))
        jsub = jr._sub_batch([rec.seq], np.array([t.left]),
                             np.array([t.plusp]))
        for key in ("nm", "trim5", "trim3"):
            assert np.array_equal(np.asarray(sub[key]), np.asarray(jsub[key]))
        t5, t3 = int(sub["trim5"][0]), int(sub["trim3"][0])
        assert int(sub["nm"][0]) == int(tref[t5 : len(q) - t3].sum())
    out = io.StringIO()
    tr.run(world["snp_reads"], out, batch_size=64)
    nms = [int(f.split(":")[-1]) for l in out.getvalue().splitlines()
           if l[0] != "@" for f in l.split("\t") if f.startswith("NM:i:")]
    assert len(nms) >= len(world["snp_reads"]) > 30
    assert sum(n >= 5 for n in nms) >= 0.9 * len(nms)


def _runners(world, novel, **changes):
    db, d = world["db"], world["dir"]
    return (jrun.GsnapRunner(jax_db(db), runner_params(jse, db, **changes),
                             novelsplicing=novel, snpsdb="snps", snps_dir=d),
            trun.GsnapRunner(db, runner_params(tse, db, **changes),
                             novelsplicing=novel, snpsdb="snps", snps_dir=d,
                             device="cpu"))


@pytest.mark.parametrize("novel", [False, True])
def test_align_batch_alt(world, novel):
    """align_batch_gapped and align_batch_pe on the SNP index with the alt
    genome: every output key, on the batches and with the parameters of
    test_run_sam_snps' runners; the SNP-heavy reads (5-8 alt alleles)
    are placed with <= 1 mismatch."""
    j, t = align_batch_as_runners(*_runners(world, novel), world["reads"])
    _same_tree(j, t)
    n = len(world["snp_reads"])
    assert world["reads"][-n:] == world["snp_reads"]
    assert int((t["npaths"][-n:] > 0).sum()) >= n - 1
    assert int((t["nmm"][-n:, 0] <= 1).sum()) >= n - 1
    p1, p2 = world["pairs"]
    j, t = align_batch_as_runners(*_runners(world, novel, gmap_mode=""),
                                  p1, p2)
    _same_tree(j, t)


@pytest.mark.parametrize("novel", [False, True])
def test_run_sam_snps(world, novel):
    """-v alone at -N 0 and -N 1: SE SAM (default GMAP lanes, which -v
    gates off) and PE SAM (no GMAP lanes) byte-equal, one batch each;
    every SNP-heavy read is placed (not all are without -v)."""
    p1, p2 = world["pairs"]
    for what in ("se", "pe"):
        jr, tr = _runners(world, novel,
                          **({} if what == "se" else dict(gmap_mode="")))
        jo, to = io.StringIO(), io.StringIO()
        if what == "se":
            jr.run(world["reads"], jo, batch_size=256)
            tr.run(world["reads"], to, batch_size=256)
        else:
            jr.run_pe(p1, p2, jo, batch_size=128)
            tr.run_pe(p1, p2, to, batch_size=128)
        assert to.getvalue() == jo.getvalue(), what
    se = io.StringIO()
    tr.run(world["snp_reads"], se, batch_size=64)
    plain = io.StringIO()
    trun.GsnapRunner(world["db"], novelsplicing=novel, device="cpu").run(
        world["snp_reads"], plain, batch_size=64)
    mapped = lambda s: sum(1 for l in s.getvalue().splitlines()
                           if l[0] != "@" and l.split("\t")[2] != "*"
                           and not int(l.split("\t")[1]) & 0x100)
    assert mapped(se) == len(world["snp_reads"]) > mapped(plain)
