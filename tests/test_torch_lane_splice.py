"""The plain versions of K13 (lane_features) and K5 (solve_splices),
which their kernels are held to, against the JAX package's
_trim_ends_device, _lane_features, _bitpack_mask and _solve_splices on
the edges the kernels' designs turn on.  K13 (synth.mismatch_edge_rows):
trims where the untrimmed end ties the best (the '>=' rule), several
equal maxima (first for t5, last for t3), mismatches only past the
read's length, all- and no-mismatch rows, at L 75, 100 and 150, and
trim scores beyond the read length (which K13's C entry clamps).  K5
(synth.splice_pair_cases): more than 16 candidates a class, where the
first-16 rule decides; diagonals 63 and 64, at the genome end, near
2^32 and INVALID; equal sums, antisense equal to sense; known bits at
word boundaries with novel splicing on and off; pairs that are not
valid, budgets 0-6.  Seeded numpy inputs, exact equality (float32 by its
bits)."""

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


def _edge_rows(L):
    return synth.mismatch_edge_rows(np.random.default_rng(L), 36, 32, L)


def _trim_scores(mask, la, score):
    """(sig5 at each active mismatch, sfin5, sig3 likewise, sfin3) of one
    row, straight from the definitions in _trim_ends_device."""
    L = len(mask)
    v = [(score if mask[j] else 1) if j < la else 0 for j in range(L)]
    P = np.concatenate([[0], np.cumsum(v)])
    T = [max(P[i:]) for i in range(L + 1)] + [-(2**30)]
    mis = [j for j in range(L) if mask[j] and j < la]
    sig5 = [max(T[j + 2] - P[j + 1], 0) for j in mis]
    sig3 = [max(P[j] - (min(P[:j]) if j else 2**30), 0) for j in mis]
    return sig5, max(T[1], 0), sig3, max(P[L] - min(P[:L]), 0)


@pytest.mark.parametrize("L", [75, 100, 150])
@pytest.mark.parametrize("score", [-3, -1, 0])
def test_trim_ends_edges(L, score):
    mm, _, lengths = _edge_rows(L)
    want = jgg._trim_ends_device(jnp.asarray(mm), jnp.asarray(lengths), score)
    got = tgg._trim_ends_device(torch.from_numpy(mm),
                                torch.from_numpy(lengths), score)
    for g, w in zip(got, want):
        _eq(g, w)
    # the edges are there: candidate c has period 1 + c % 4, which at
    # this score is c = -score (mod 4)
    kinds = synth.MISMATCH_EDGE_KINDS
    t5, t3 = (x.numpy() for x in got)
    c = -score
    for i in range(4, len(mm)):
        kind = kinds[(i - 4) % 4]
        sig5, sfin5, sig3, sfin3 = _trim_scores(mm[i, c], lengths[i], score)
        if kind == "tie" and score < 0:
            # the untrimmed ends tie the best trims: no trim
            assert max(sig5) == sfin5 and t5[i, c] == 0
            assert max(sig3) == sfin3 and t3[i, c] == 0
        elif kind == "equal maxima" and score < 0:
            assert sig5.count(max(sig5)) > 1 and sig3.count(max(sig3)) > 1
            assert t5[i, c] == 1 and t3[i, c] == 1
        elif kind == "past the length":
            assert not sig5 and t5[i, c] == 0 and t3[i, c] == 0


@pytest.mark.parametrize("L", [75, 150])
@pytest.mark.parametrize("score", [-200, -100_000, 1_000])
def test_trim_score_clamp(L, score):
    """K13's C entry clamps the trim score to [-(L + 1), L + 1], where a
    trim's comparisons of span sums m + score c (m, c <= L) are decided
    by c first and m second: JAX's trims at the score itself equal the
    plain trims at the clamped score."""
    mm, _, lengths = _edge_rows(L)
    want = jgg._trim_ends_device(jnp.asarray(mm), jnp.asarray(lengths), score)
    got = tgg._trim_ends_device(torch.from_numpy(mm),
                                torch.from_numpy(lengths),
                                max(-(L + 1), min(L + 1, score)))
    for g, w in zip(got, want):
        _eq(g, w)
    # a negative score trims some rows; a positive one never trims
    assert ((got[0].numpy() > 0).any() and (got[1].numpy() > 0).any()
            if score < 0 else not (got[0].any() or got[1].any()))


@pytest.mark.parametrize("L", [75, 100, 150])
@pytest.mark.parametrize("k,interval,score", [(12, 3, -3), (15, 3, -3),
                                              (12, 3, -1)])
def test_lane_features_edges(L, k, interval, score):
    """lane_features on the CPU (the plain K13) against JAX's
    _lane_features and _bitpack_mask."""
    mm, pref, lengths = _edge_rows(L)
    want = jgg._lane_features(jnp.asarray(mm), jnp.asarray(pref),
                              jnp.asarray(pref[:, :, -1]),
                              jnp.asarray(lengths), k, interval, score)
    got = tgg.lane_features(torch.from_numpy(mm), torch.from_numpy(pref),
                            torch.from_numpy(lengths), k, interval, score)
    assert set(got) == set(want) | {"cand_mm"}
    for key in want:
        _eq(got[key], want[key])
    _eq(got["cand_mm"], jgg._bitpack_mask(jnp.asarray(mm)))
    # mismatches past the length count in npos but in no trimmed span
    past = (np.arange(len(mm)) - 4) % 4 == 3
    past[:4] = False
    assert (got["lane_npos"].numpy()[past] > 0).any()
    assert (got["lane_nmm_0t3"].numpy()[past] == 0).all()


def _splice_inputs(nc):
    case = synth.splice_pair_cases(np.random.default_rng(nc), 48, nc)
    codes = case["codes"]
    flags = np.zeros(len(codes), np.uint8)
    jg = jgen.GenomeArrays.from_codes(codes, flags, [len(codes)])
    tg = convert.genome_from_host(codes, flags, [len(codes)], "cpu")
    return case, jg, tg


@pytest.mark.parametrize("nc,novel,with_known", [
    (32, True, False), (32, True, True), (32, False, True),
    (128, True, True)])
def test_solve_splices_edges(nc, novel, with_known):
    case, jg, tg = _splice_inputs(nc)
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "known"}
    jknown = tuple(jnp.asarray(k) for k in case["known"])
    tknown = tuple(torch.from_numpy(k.view(np.int32).copy())
                   for k in case["known"])
    j = lambda k, dt=None: jnp.asarray(case[k] if dt is None
                                       else case[k].astype(dt))
    want = jgg._solve_splices(
        jg, j("top_d", np.uint32), j("pref"), j("ii", np.int32),
        j("jj", np.int32), j("pvalid"), j("lengths"), j("budget"), 100,
        novel=novel, known=jknown if with_known else None)
    got = tgg._solve_splices_plain(
        tg, t["top_d"], t["pref"], t["ii"], t["jj"], t["pvalid"],
        t["lengths"], t["budget"], 100, novel=novel,
        known=tknown if with_known else None)
    assert set(want) == set(got) == set(tgg._SPLICE_KEYS)
    for k in tgg._SPLICE_KEYS:
        _eq(got[k], want[k])
    v, split, sense = got["valid"], got["split"], got["sense"]
    assert v.any() and not v[:, 3].any()          # diagonal 63: none
    if novel:
        assert (v[:, 7] & sense[:, 7]).any()      # dense sense repeat
        assert (v[:, 8] & ~sense[:, 8]).any()     # dense antisense repeat
    if with_known:
        # pair 1: a known split of each class, equal sums (both splits
        # inside reads of 24 nt or more): sense wins
        tie = (v[:, 1] & (got["prob_d"][:, 1] == 1.0)
               & (got["prob_a"][:, 1] == 1.0) & (t["lengths"] >= 24))
        assert tie.any() and sense[:, 1][tie].all()
    if novel and with_known:
        # pairs 9-12: 19 candidates of equal sums against known sites; a
        # known donor (antidonor) of 1.0 at s = 53 wins, one at s = 88
        # does not (after the 16th candidate) but would with more kept
        full = v & (t["lengths"] == 100)[:, None]
        for p, s in ((9, 53), (10, 53), (11, 5), (12, 5)):
            assert full[:, p].any()
            assert (split[:, p][full[:, p]] == s).all()
            assert (sense[:, p][full[:, p]] == (p % 2 == 1)).all()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgg, "SPLICE_CANDS", 32)
            more = tgg._solve_splices_plain(
                tg, t["top_d"], t["pref"], t["ii"], t["jj"], t["pvalid"],
                t["lengths"], t["budget"], 100, novel=novel, known=tknown)
        for p in (11, 12):
            assert (more["split"][:, p][full[:, p]] == 88).all()
