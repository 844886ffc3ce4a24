"""The plain versions of K16 (select_pairs) and K7 (solve_doublesplices),
which their kernels are held to, against the JAX package's _select_pairs
and _solve_doublesplices on the edges the kernels' designs turn on.
K16 (synth.diag_pair_rows): no eligible pair and fewer eligible pairs
than maxpairs (the -1 entries in flat order), equal vote sums, vote sums
at the kernel key's width limit, NC = 3, 24, 32 and 128, maxpairs above
NC^2, under both eligibility rules.  K7 (synth.doublesplice_cases): more
than 8 candidate sites per junction, sites at s = 2 and s = len - 2,
diagonals 63 and 64, at the genome end and INVALID, reads shorter than
L, a short exon of equal keys on both strands (sense wins), known sites
with and without novel splicing.  Seeded numpy inputs, exact equality
(float32 by its bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _eq(port, jax_value):
    """A port tensor equals a JAX array: uint32 JAX values compare with
    the int64 the port carries, float32 by its bits."""
    j = np.asarray(jax_value)
    p = port.numpy()
    assert p.shape == j.shape
    if p.dtype == np.float32:
        assert j.dtype == np.float32
        np.testing.assert_array_equal(p.view(np.uint32), j.view(np.uint32))
    else:
        np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))


def _rule(rule):
    """(JAX eligibility, port eligibility) of a K16 rule."""
    if rule == "indel":
        return ((lambda di, dj: (((dj - di).astype(jnp.int32) >= 1)
                                 & ((dj - di).astype(jnp.int32) <= 30))
                 | (((di - dj).astype(jnp.int32) >= 1)
                    & ((di - dj).astype(jnp.int32) <= 9))),
                tgg._indel_pairs_eligible(30, 9))
    dist = 200_000 if rule == "splice" else 2**31 + 5
    return ((lambda di, dj: ((dj - di) >= jnp.uint32(1))
             & ((dj - di) <= jnp.uint32(dist))),
            tgg._splice_pairs_eligible(dist))


@pytest.mark.parametrize("rule", ["indel", "splice", "splice 2^31+5"])
@pytest.mark.parametrize("nc,maxpairs", [(3, 16), (24, 16), (32, 16),
                                         (128, 16), (32, 1024)])
def test_select_pairs_edges(rule, nc, maxpairs):
    """Every row kind of synth.diag_pair_rows, four times over."""
    top, votes = synth.diag_pair_rows(np.random.default_rng(nc + maxpairs),
                                      4 * len(synth.PAIR_ROW_KINDS), nc)
    jfn, tfn = _rule(rule)
    want = jgg._select_pairs(jnp.asarray(top.astype(np.uint32)),
                             jnp.asarray(votes), jfn, maxpairs)
    got = tgg._select_pairs_plain(torch.from_numpy(top),
                                  torch.from_numpy(votes), tfn, maxpairs)
    for g, w in zip(got, want):
        _eq(g, w)
    ii, jj, valid = got
    p = min(maxpairs, nc * nc)
    assert valid.shape == (len(top), p)
    # the edges are there: rows without a pair give the flat order
    assert not valid[0].any()
    assert (ii[0] * nc + jj[0] == torch.arange(p)).all()
    if nc > 3 and rule != "splice 2^31+5":   # that one takes wide steps
        assert 0 < valid[1].sum() < p          # fewer eligible than P
    if nc > 3 and rule != "indel":
        # a pair of two 2^17 - 1 votes: the widest sum the key holds
        top_votes = votes[3][ii[3][valid[3]]] + votes[3][jj[3][valid[3]]]
        assert top_votes.max() == 2**18 - 2


def _doublesplice_inputs(nc):
    case = synth.doublesplice_cases(np.random.default_rng(nc), 48, nc)
    codes = case["codes"]
    flags = np.zeros(len(codes), np.uint8)
    jg = jgen.GenomeArrays.from_codes(codes, flags, [len(codes)])
    tg = convert.genome_from_host(codes, flags, [len(codes)], "cpu")
    return case, jg, tg


@pytest.mark.parametrize("nc,novel,with_known", [
    (32, True, False), (32, True, True), (32, False, True),
    (128, True, True)])
def test_solve_doublesplices_edges(nc, novel, with_known):
    case, jg, tg = _doublesplice_inputs(nc)
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "known"}
    jknown = tuple(jnp.asarray(k) for k in case["known"])
    tknown = tuple(torch.from_numpy(k.view(np.int32).copy())
                   for k in case["known"])
    j = lambda k, dt=None: jnp.asarray(case[k] if dt is None
                                       else case[k].astype(dt))
    want = jgg._solve_doublesplices(
        jg, j("top_d", np.uint32), j("pref"), j("ti", np.int32),
        j("tm", np.int32), j("tj", np.int32), j("tvalid"), j("lengths"),
        j("budget"), 100, novel=novel,
        known=jknown if with_known else None)
    got = tgg._solve_doublesplices_plain(
        tg, t["top_d"], t["pref"], t["ti"], t["tm"], t["tj"], t["tvalid"],
        t["lengths"], t["budget"], 100, novel=novel,
        known=tknown if with_known else None)
    assert set(want) == set(got) == set(tgg._SHORTEXON_KEYS)
    for k in tgg._SHORTEXON_KEYS:
        _eq(got[k], want[k])
    v = got["valid"]
    assert v.any()
    if novel:
        # the dense stretches give more than 8 candidates per junction:
        # sense junction 1 of the dense triples (columns 1-3)
        di = torch.gather(t["top_d"], 1, t["ti"][:, 1:4])
        dm = torch.gather(t["top_d"], 1, t["tm"][:, 1:4])
        span_i, span_m = (tgg._fetch_span(tg, d, 100) for d in (di, dm))
        cand = (tgg._sites(span_i, "donor", 101)
                & tgg._sites(span_m, "acceptor", 101))
        assert (cand[..., 2:99].sum(-1) > 8).any()
        assert (~got["sense"][v]).any()
    if with_known:
        # the first triple's known short exon of probability 1.0 at s = 2
        # and s = len - 2 on both strands: equal keys, sense wins
        ex = (v[:, 0] & (got["split"][:, 0] == 2)
              & (got["split2"][:, 0] == t["lengths"] - 2))
        assert ex.any() and got["sense"][:, 0][ex].all()
        assert (got["prob_d"][:, 0][ex] == 1.0).all()
