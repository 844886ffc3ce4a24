"""Port parity for the two device stages this slice moved into kernels,
through their plain versions: the read packing and per-read reverse
complement (kernel K17; the JAX package's gsnap_se._pack_device and
_revcomp_batch) at lengths 1, 15, 16, 17 and lmax, with N runs, mixed
and uniform, and on synth.pack_query_cases; and the pair overflow gate
(K8's epilogue; JAX gsnap_pe.py :241-283) against JAX's align_batch_pe
overflow outputs on hand-built rows in which each of the gate's terms
flips, at -N 0 and -N 1, and with known sites (no gate)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_pe as jpe
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_pe as tpe
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread, same_tree)

EDGE_LENGTHS = (1, 15, 16, 17)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


def pack_cases(rng, b: int, lmax: int):
    """codes uint8 [b, lmax] (2-bit codes; the bytes past a read's length
    hold random codes, as a reused buffer may), N flags with runs, and
    lengths: the edge lengths, lmax and random ones."""
    codes = rng.integers(0, 4, (b, lmax)).astype(np.uint8)
    nflags = rng.random((b, lmax)) < 0.03
    for r in range(0, b, 5):
        a = int(rng.integers(0, lmax))
        nflags[r, a : a + int(rng.integers(1, 12))] = True
    lengths = rng.integers(1, lmax + 1, b).astype(np.int32)
    edges = [x for x in EDGE_LENGTHS if x <= lmax] + [lmax]
    lengths[: len(edges)] = edges
    return codes, nflags, lengths


def _pack_equal_jax(c, f, ln, uniform):
    """The plain pack_batch against JAX _revcomp_batch + _pack_device on
    one batch (numpy inputs), every output."""
    lmax = c.shape[1]
    jc, jf, jl = (jnp.asarray(x) for x in (c, f, ln))
    fwd, trc, trf, rev = tse.pack_batch(*(torch.from_numpy(x)
                                          for x in (c, f, ln)), uniform)
    jrc, jrf = jse._revcomp_batch(jc, jf, jl, uniform)
    assert np.array_equal(np.asarray(jrc), trc.numpy())
    assert np.array_equal(np.asarray(jrf), trf.numpy())
    assert trc.dtype == torch.uint8 and trf.dtype == torch.bool
    for jq, tq in ((jse._pack_device(jc, jf, jl, lmax), fwd),
                   (jse._pack_device(jrc, jrf, jl, lmax), rev)):
        assert np.array_equal(np.asarray(jq.codes16).astype(np.int64),
                              tq.codes16.numpy())
        assert np.array_equal(np.asarray(jq.nflags16).astype(np.int64),
                              tq.nflags16.numpy())
        assert tq.lmax == lmax
        assert tq.codes16.shape == (c.shape[0], -(-lmax // 16))


@pytest.mark.parametrize("lmax", [100, 17, 16, 151])
def test_pack_and_revcomp_match_jax(lmax):
    rng = np.random.default_rng(lmax)
    c, f, ln = pack_cases(rng, 64, lmax)
    _pack_equal_jax(c, f, ln, False)
    full = ln == lmax
    assert full.sum() >= 1
    _pack_equal_jax(c[full], f[full], ln[full], True)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("b,lmax", synth.PACK_QUERY_SHAPES)
def test_pack_query_cases_match_jax(b, lmax, uniform):
    """synth.pack_query_cases: lengths 0, 1, 15, 16, 17, 31, 32, 33 and
    lmax, all-N reads, N runs, lengths past lmax (the source clipped);
    rows off a 4-byte boundary (lmax 17, 151), the card's longest read,
    B of 61, 37, 1 and 0; the flip where every length is lmax."""
    c, f, ln = synth.pack_query_cases(np.random.default_rng(b + lmax), b,
                                      lmax, uniform)
    if b > len(synth.PACK_EDGE_LENGTHS) + 1 and not uniform:
        edges = {x for x in synth.PACK_EDGE_LENGTHS if x < lmax} | {lmax}
        assert edges < set(ln.tolist())
        assert f.all(1).any() and (ln > lmax).any()
    _pack_equal_jax(c, f, ln, uniform)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(61)
    g = synth.make_genome(rng, [60_000, 40_000])
    db = synth.genome_db(g, 12, 3)
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(ji.offsets, ji.positions, 12, 3, "cpu")
    return db, jg, ji, tg, ti


def _fake_gather(out2, cands2):
    def gather(*args, **kwargs):
        return dict(out2), dict(cands2)
    return gather


def _gate_terms(res, cands, b, so, ipm, novel):
    """conc_ok, sub_ok and ind_ok of each row, in int32 as JAX has them
    (to show that each term decides some rows)."""
    w = lambda x: ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31
    pbest = res["pscore"][:, 0].numpy().astype(np.int64)
    s5 = res["end5_pairing"]["score"][:, 0].numpy().astype(np.int64)
    s3 = res["end3_pairing"]["score"][:, 0].numpy().astype(np.int64)
    b5, b3 = cands["ovf_bound"][:b], cands["ovf_bound"][b:]
    h5, h3 = cands["hbound"][:b], cands["hbound"][b:]
    top = w(pbest + so)
    conc = res["pair_concordant"].numpy() & (res["npairs"].numpy() > 0)
    sub = (w(b5 + s3) > top) & (w(b3 + s5) > top) & (w(b5 + b3) > top)
    a5, a3 = w(top - s3), w(top - s5)
    ind = ((a5 < ipm) | (h5 > a5)) & ((a3 < ipm) | (h3 > a3))
    if novel:
        ind &= (h5 > a5) & (h3 > a3)
    return conc, sub, ind


@pytest.mark.parametrize("novel,known", [(False, False), (True, False),
                                         (True, True)])
def test_pair_gate_matches_jax(arrays, monkeypatch, novel, known):
    """The pair overflow gate on hand-built end hits and candidate-budget
    states (synth.pair_hit_cases + pair_gate_cases) through both
    packages' align_batch_pe, their gather_candidates replaced: the gated
    overflow flags, and every other output, are equal; each term of the
    gate (concordance, the SUB bound, the indel / splice bound, the
    truncation) decides some rows; with known sites nothing is cleared."""
    db, jg, ji, tg, ti = arrays
    rng = np.random.default_rng(62 + novel)
    b = 128
    out, len5, len3 = synth.pair_hit_cases(rng, b, db.chr_ends)
    cands = synth.pair_gate_cases(rng, b)
    # a third of the pairs score 3-5 a end: their score budgets reach the
    # indel penalty, where the indel / splice term decides
    lift = np.zeros(2 * b, bool)
    lift[3:b:3] = lift[b + 3 :: 3] = True
    valid = out["score"] < 10**6
    out["score"] = np.where(lift[:, None] & valid, out["score"] + 3,
                            out["score"]).astype(np.int32)
    kw = dict(seed_total=512 if novel else 384)
    pairmax = jpe.PAIRMAX_RNA if novel else jpe.PAIRMAX_DNA
    jp = jpe.PEParams(gapped=jgg.GappedParams(
        base=jse.GsnapParams(**kw), novelsplicing=novel), pairmax=pairmax)
    tp = tpe.PEParams(gapped=tgg.GappedParams(
        base=tse.GsnapParams(**kw), novelsplicing=novel), pairmax=pairmax)
    monkeypatch.setattr(jgg, "gather_candidates", _fake_gather(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in cands.items()}))
    tout = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in out.items()}
    monkeypatch.setattr(tgg, "gather_candidates", _fake_gather(
        tout, {k: torch.from_numpy(v) for k, v in cands.items()}))
    codes = np.zeros((b, 100), np.uint8)
    enc = (codes, codes.astype(bool), len5, codes, codes.astype(bool), len3)
    jknown = tknown = None
    if known:
        words = np.zeros(4, np.int32)
        jknown = tuple(jnp.asarray(words) for _ in range(4))
        tknown = tuple(torch.from_numpy(words) for _ in range(4))
    # eagerly, so that no earlier trace of the jitted function is reused
    jres = jpe.align_batch_pe.__wrapped__(
        jg, ji, *(jnp.asarray(x) for x in enc), jp, known=jknown)
    tres = tpe.align_batch_pe(tg, ti, *(torch.from_numpy(x) for x in enc), tp,
                              known=tknown)
    same_tree(jres, tres)

    ovf = np.concatenate([tres["cands5"]["overflow"].numpy(),
                          tres["cands3"]["overflow"].numpy()])
    cleared = cands["overflow"] & ~ovf
    if known:
        assert not cleared.any()
        return
    assert cleared.any() and ovf.any()
    base = tp.gapped.base
    conc, sub, ind = _gate_terms(tres, cands, b, base.subopt_levels,
                                 base.indel_penalty_middle, novel)
    trunc = cands["overflow_trunc"]
    safe = conc & sub & ind
    # each term alone keeps some row's flags (the other two hold there)
    assert (~conc & sub & ind).any()
    assert (conc & ~sub & ind).any()
    assert (conc & sub & ~ind).any()
    # and truncation keeps a safe row's flag
    assert (np.concatenate([safe, safe]) & trunc & cands["overflow"]
            & ovf).any()
    # the wrapped sums reach the decision: a bound of 2^31 - 2 on a safe
    # or unsafe row
    big = cands["ovf_bound"] == 2**31 - 2
    assert big.any()
