"""Port parity: align_batch and align_batch_gapped (-N 0) — every output
key — and the indel solver (kernel K4, plain path) against the JAX
package on the same synthetic genome, index and reads.  Exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.ops import genome as tgen
from gmap_gsnap_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(9)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(ji.offsets, ji.positions, 12, 3, "cpu")
    recs, _ = synth.plant_reads(
        rng, g, 64, weights=dict(sub=3, n=1, mid_indel=2, end_indel=1.5,
                                 terminal=1, repeat=1.5, junk=0.5))
    recs = [r if i % 5 else dataclasses.replace(
        r, seq=r.seq[: 60 + i % 40], quality=r.quality[: 60 + i % 40])
        for i, r in enumerate(recs)]
    c, f, l = trun.encode_batch(recs, 100)
    return jg, ji, tg, ti, c, f, l


def _cmp_trees(jout, tout):
    assert set(jout) == set(tout)
    for k in sorted(jout):
        a = np.asarray(jout[k])
        b = tout[k].numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), k


def _args(world):
    jg, ji, tg, ti, c, f, l = world
    return ((jg, ji, jnp.asarray(c), jnp.asarray(f), jnp.asarray(l)),
            (tg, ti, torch.from_numpy(c), torch.from_numpy(f),
             torch.from_numpy(l)))


@pytest.mark.parametrize("seed_total,ncand,mm", [
    (384, 32, -1), (4096, 128, -1), (0, 128, -1), (64, 8, 3)])
def test_align_batch_gapped_every_key(world, seed_total, ncand, mm):
    ja, ta = _args(world)
    base = dict(seed_total=seed_total, ncand=ncand, max_mismatches=mm)
    jout = jgg.align_batch_gapped(
        *ja, jgg.GappedParams(base=jse.GsnapParams(**base)))
    tout = tgg.align_batch_gapped(
        *ta, tgg.GappedParams(base=tse.GsnapParams(**base)))
    _cmp_trees(jout, tout)
    kinds = set(tout["kind"][tout["score"] < 10**6].tolist())
    assert {tgg.KIND_SUB, tgg.KIND_INS, tgg.KIND_DEL} <= kinds
    if seed_total == 384:
        assert tout["overflow"].any() and tout["lane_noop"].any()
        assert tout["lane_ind"].any() and tout["lane_term"].any()


@pytest.mark.parametrize("mode", ["cmet-stranded", "atoi-stranded", "snp"])
def test_align_batch_gapped_modes(world, mode):
    """The per-strand branch (conversions) and the alt-genome path."""
    jg, ji, tg, ti, c, f, l = world
    ja, ta = _args(world)
    jalt = talt = None
    if mode == "snp":
        rng = np.random.default_rng(4)
        ref = np.asarray(jg.ref16).copy()
        flip = rng.random(len(ref)) < 0.05
        ref[flip] ^= np.uint32(0x30)           # one changed base per word
        jalt = (jnp.asarray(ref), jg.flag16)
        talt = (tgen.words_to_device(ref, "cpu"), tg.flag16)
        mode = "standard"
    jout = jgg.align_batch_gapped(
        *ja, jgg.GappedParams(base=jse.GsnapParams(mode=mode)), alt=jalt)
    tout = tgg.align_batch_gapped(
        *ta, tgg.GappedParams(base=tse.GsnapParams(mode=mode)), alt=talt)
    _cmp_trees(jout, tout)


def test_align_batch_gapped_trim_score(world):
    """A non-default trim score turns the device lane gate off."""
    ja, ta = _args(world)
    jout = jgg.align_batch_gapped(
        *ja, jgg.GappedParams(base=jse.GsnapParams(trim_mismatch_score=-2)))
    tout = tgg.align_batch_gapped(
        *ta, tgg.GappedParams(base=tse.GsnapParams(trim_mismatch_score=-2)))
    _cmp_trees(jout, tout)


@pytest.mark.parametrize("subopt", [0, 2])
def test_align_batch(world, subopt):
    ja, ta = _args(world)
    jout = jse.align_batch(*ja, jse.GsnapParams(subopt_levels=subopt))
    tout = tse.align_batch(*ta, tse.GsnapParams(subopt_levels=subopt))
    _cmp_trees(jout, tout)


def test_solve_indels_direct(world):
    """K4's plain path on hand-made pairs, including invalid pairs and
    uint32 wraparound of the diagonal differences."""
    jg, ji, tg, ti, c, f, l = world
    tc, tf, tl = torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(l)
    q = tse._pack_device_plain(tc, tf, tl, 100)
    diag, qg = tse.seed_diagonals(ti, tc, tf, tl, tse.GsnapParams())[:2]
    top_d, votes, _ = tse.top_diagonals(diag, 32)
    top_d[:, 3] = 0xFFFFFFFF
    top_d[:, 4] = 2                          # far-apart / wrapping pairs
    mm, pref = tgg._prefix_mm(tg, q, top_d, tl, None, None)
    # the selector's pairs, with random pairs in the second half
    ii, jj, pv = tgg._select_pairs_plain(
        top_d, votes, tgg._indel_pairs_eligible(30, 9), 16)
    rng = np.random.default_rng(0)
    ii[:, 8:] = torch.from_numpy(rng.integers(0, 32, (len(c), 8)))
    jj[:, 8:] = torch.from_numpy(rng.integers(0, 32, (len(c), 8)))
    ii[:, 15], jj[:, 15] = 4, 3
    pv[:, 8:] = torch.from_numpy(rng.random((len(c), 8)) < 0.8)
    qp5, qp3 = tse._qpos_ranges_plain(diag, qg, top_d)
    budget = tse.auto_budget(tl, 12, 3, -1)
    jres = jgg._solve_indels(
        jnp.asarray(top_d.numpy().astype(np.uint32)), jnp.asarray(mm.numpy()),
        jnp.asarray(pref.numpy()), jnp.asarray(ii.numpy().astype(np.int32)),
        jnp.asarray(jj.numpy().astype(np.int32)), jnp.asarray(pv.numpy()),
        jnp.asarray(l), jnp.asarray(budget.numpy()), 100,
        qp5=jnp.asarray(qp5.numpy()), qp3=jnp.asarray(qp3.numpy()))
    tres = tgg.solve_indels(top_d, mm, pref, ii, jj, pv, tl, budget, 100,
                            qp5=qp5, qp3=qp3)
    assert set(jres) == set(tres) == set(tgg._INDEL_KEYS)
    for k in jres:
        assert np.array_equal(np.asarray(jres[k]).astype(np.int64),
                              tres[k].numpy().astype(np.int64)), k
    assert tres["valid"].any()


def test_trim_ends_device_matches_host(world):
    rng = np.random.default_rng(1)
    mm = rng.random((40, 3, 100)) < 0.06
    mm[:5] = rng.random((5, 3, 100)) < 0.3
    lengths = rng.integers(30, 101, 40).astype(np.int32)
    mm &= np.arange(100)[None, None, :] < lengths[:, None, None]
    t5, t3 = tgg._trim_ends_device(torch.from_numpy(mm),
                                   torch.from_numpy(lengths), -3)
    for b in range(40):
        h5, h3 = trun.trim_ends_batch(mm[b, :, : lengths[b]], -3)
        assert t5[b].tolist() == h5.tolist()
        assert t3[b].tolist() == h3.tolist()


def test_gapped_params_copy():
    jf = [(x.name, x.default) for x in dataclasses.fields(jgg.GappedParams)]
    tf = [(x.name, x.default) for x in dataclasses.fields(tgg.GappedParams)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        if n == "base":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, n


def test_known_sites_not_ported(world):
    """Known sites (-s) were refused here until they were ported; now
    ``known`` runs: with empty masks and novel splicing off, the splice
    solvers run with no candidate and the overflow gate stays open, as
    in the JAX package (every key equal); four None vectors raise."""
    ja, ta = _args(world)
    jg, tg = ja[0], ta[0]
    nwords = (int(tg.length) + 31) // 32 + 2
    jknown = tuple(jnp.zeros(nwords, jnp.uint32) for _ in range(4))
    tknown = tuple(torch.zeros(nwords, dtype=torch.int32) for _ in range(4))
    jout = jgg.align_batch_gapped(*ja, jgg.GappedParams(), known=jknown)
    tout = tgg.align_batch_gapped(*ta, tgg.GappedParams(), known=tknown)
    assert set(jout) == set(tout)
    for k in jout:
        assert np.array_equal(np.asarray(jout[k]).astype(np.int64),
                              tout[k].numpy().astype(np.int64)), k
    with pytest.raises(ValueError, match="known"):
        tgg.align_batch_gapped(*ta, known=(None,) * 4)
