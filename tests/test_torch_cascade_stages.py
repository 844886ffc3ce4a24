"""The plain versions of kernels K13-K16 against the JAX package's
device stages they replace, on seeded numpy inputs with the edge rows
the kernels must get right: _trim_ends_device, _lane_features and
_bitpack_mask (K13), rank_hits and _lane_noop_device (K14 and its SE
epilogue), _qpos_ranges (K15) and _select_pairs under both eligibility
rules (K16).  Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.ops import mismatch as tmm
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, one_torch_thread

U32 = 2**32


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _eq(port, jax_value):
    """A port tensor equals a JAX array (uint32 JAX values compare with
    the int64 the port carries)."""
    j = np.asarray(jax_value)
    if j.dtype == np.uint32:
        j = j.astype(np.int64)
    p = port.numpy()
    assert p.shape == j.shape
    np.testing.assert_array_equal(p, j)


@pytest.fixture(scope="module")
def rows():
    mm, pref, lengths = synth.mismatch_rows(np.random.default_rng(3), 96, 32)
    return mm, pref, lengths


@pytest.mark.parametrize("score", [-3, -1, 0])
def test_trim_ends_device(rows, score):
    mm, _, lengths = rows
    want = jgg._trim_ends_device(jnp.asarray(mm), jnp.asarray(lengths), score)
    got = tgg._trim_ends_device(torch.from_numpy(mm),
                                torch.from_numpy(lengths), score)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("k,interval,score", [(12, 3, -3), (15, 3, -3),
                                              (12, 3, -1)])
def test_lane_features_and_bitpack(rows, k, interval, score):
    """lane_features on the CPU (the plain K13 stages) against JAX's
    _lane_features and _bitpack_mask: reads shorter than the padded
    width, all- and no-mismatch rows, lastbound below 0."""
    mm, pref, lengths = rows
    nmm_raw = pref[:, :, -1]
    want = jgg._lane_features(jnp.asarray(mm), jnp.asarray(pref),
                              jnp.asarray(nmm_raw), jnp.asarray(lengths), k,
                              interval, score)
    got = tgg.lane_features(torch.from_numpy(mm), torch.from_numpy(pref),
                            torch.from_numpy(lengths), k, interval, score)
    assert set(got) == set(want) | {"cand_mm"}
    for key in want:
        _eq(got[key], want[key])
    _eq(got["cand_mm"], jgg._bitpack_mask(jnp.asarray(mm)))


def test_pref_is_cumsum_of_mm():
    """K13 counts the mask itself: K3's prefix counts must be
    cat(0, cumsum(mm)) at every position, past each read's length too
    (reads of mixed length, N-carrying reads, both query-N rules)."""
    rng = np.random.default_rng(13)
    g = synth.make_genome(rng, [200_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_reads(rng, g, 128, weights=dict(sub=2, n=1,
                                                          terminal=1))
    c, f, l = trun.encode_batch(recs, 100)
    l[::3] = 61
    tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, "cpu")
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
    ct, ft, lt = (torch.from_numpy(x) for x in (c, f, l))
    diag = tse._seed_diagonals_plain(ti, ct, ft, lt, tse.GsnapParams(),
                                     True)[0]
    top_d = tse._top_diagonals_plain(diag, 32)[0]
    q = tse._pack_device(ct, ft, lt, 100)
    saved = tmm.QUERY_UNK_MISMATCH
    try:
        for unk in (False, True):
            tmm.QUERY_UNK_MISMATCH = unk
            for conv in (None, "ct", "ag"):
                mm, pref = tmm._prefix_mismatches_plain(tg, q, top_d, lt,
                                                        conv, None)
                cs = torch.cat([torch.zeros_like(pref[:, :, :1]),
                                torch.cumsum(mm, 2, dtype=torch.int32)], 2)
                assert torch.equal(pref, cs)
    finally:
        tmm.QUERY_UNK_MISMATCH = saved


def _jax_out(out):
    """A rank_hit_cases dict as the JAX package carries it (coordinates
    uint32)."""
    return {k: jnp.asarray(v.astype(np.uint32) if k in ("left", "right",
                                                        "mid") else v)
            for k, v in out.items()}


@pytest.mark.parametrize("apply_optimal,maxout", [(True, None), (False, 16),
                                                  (True, 151), (False, 400)])
def test_rank_hits(apply_optimal, maxout):
    """Exact duplicates, equal (score, left) on both strands, BIG scores,
    lefts above 2^31; maxout below and above the 144 candidates."""
    out = synth.rank_hit_cases(np.random.default_rng(17), 64, 144)
    base_j = jse.GsnapParams(subopt_levels=1)
    base_t = tse.GsnapParams(subopt_levels=1)
    want = jgg.rank_hits(_jax_out(out), base_j, apply_optimal, maxout)
    got = tgg._rank_hits_plain({k: torch.from_numpy(v)
                                for k, v in out.items()}, base_t,
                               apply_optimal, maxout)
    assert set(got) == set(want)
    for key in want:
        _eq(got[key], want[key])


def test_lane_noop_device(rows):
    """The SE lane gate (K14's epilogue) on ranked hand-built hits and
    the candidates' lane features, against JAX's _lane_noop_device."""
    mm, pref, lengths = rows
    b = mm.shape[0]
    rng = np.random.default_rng(19)
    out = synth.rank_hit_cases(rng, b, 144)
    out["score"][::4, :] = np.where(np.arange(144) == 7, 1, 10**6)
    out["kind"][::4, 7] = 0
    base = dict(indel_penalty_end=2, terminal_threshold=2)
    final_t = tgg._rank_hits_plain({k: torch.from_numpy(v)
                                    for k, v in out.items()},
                                   tse.GsnapParams(**base))
    final_j = jgg.rank_hits(_jax_out(out), jse.GsnapParams(**base))
    nmm = np.where(rng.random((b, 32)) < 0.1, 10**6, pref[:, :, -1])
    feats_t = tgg._lane_features_plain(torch.from_numpy(mm),
                                       torch.from_numpy(pref),
                                       torch.from_numpy(lengths), 12, 3, -3)
    feats_j = jgg._lane_features(jnp.asarray(mm), jnp.asarray(pref),
                                 jnp.asarray(nmm), jnp.asarray(lengths), 12,
                                 3, -3)
    cands_t = {**feats_t, "cand_nmm": torch.from_numpy(nmm)}
    cands_j = {**feats_j, "cand_nmm": jnp.asarray(nmm),
               "cand_left": jnp.zeros((b, 32), jnp.uint32),
               "cand_plusp": jnp.ones((b, 32), bool)}
    got = tgg._lane_noop_device(final_t, cands_t, torch.from_numpy(lengths),
                                12, 3, tse.GsnapParams(**base))
    want = jgg._lane_noop_device(final_j, cands_j, jnp.asarray(lengths), 12,
                                 3, jse.GsnapParams(**base), jgg.KIND_SUB)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].any() and not got[0].all()


def test_qpos_ranges():
    """Seed grids whose empty slots repeat the last usable qpos, and
    selected diagonals that are INVALID or absent from the grid."""
    rng = np.random.default_rng(23)
    vals = np.array([5, 9, 2**31 + 1, U32 - 2, 0xFFFFFFFF], np.int64)
    diag = rng.choice(vals, (48, 384))
    qpos = np.sort(rng.integers(0, 86, (48, 384)), axis=1).astype(np.int32)
    d_sel = rng.choice(np.append(vals, 77), (48, 32))
    want = jse._qpos_ranges(jnp.asarray(diag.astype(np.uint32)),
                            jnp.asarray(qpos),
                            jnp.asarray(d_sel.astype(np.uint32)))
    got = tse._qpos_ranges_plain(torch.from_numpy(diag),
                                 torch.from_numpy(qpos),
                                 torch.from_numpy(d_sel))
    for g, w in zip(got, want):
        _eq(g, w)


def _jax_indel(max_del, max_ins):
    return lambda di, dj: ((((dj - di).astype(jnp.int32) >= 1)
                            & ((dj - di).astype(jnp.int32) <= max_del))
                           | (((di - dj).astype(jnp.int32) >= 1)
                              & ((di - dj).astype(jnp.int32) <= max_ins)))


def _jax_splice(maxdist):
    return lambda di, dj: (((dj - di) >= jnp.uint32(1))
                           & ((dj - di) <= jnp.uint32(maxdist)))


@pytest.mark.parametrize("rule", ["indel", "splice", "splice_wide"])
@pytest.mark.parametrize("nc,maxpairs", [(32, 16), (3, 16)])
def test_select_pairs(rule, nc, maxpairs):
    """Diagonals near 0, 2^24, 2^31 and 2^32 (int32 and uint32 wraps),
    INVALID ones, equal vote sums; maxpairs above NC^2 for NC = 3."""
    top, votes = synth.diag_pair_cases(np.random.default_rng(29), 128, nc)
    if rule == "indel":
        jfn, tfn = _jax_indel(30, 9), tgg._indel_pairs_eligible(30, 9)
    else:
        dist = 200_000 if rule == "splice" else 2**31 + 5
        jfn, tfn = _jax_splice(dist), tgg._splice_pairs_eligible(dist)
    want = jgg._select_pairs(jnp.asarray(top.astype(np.uint32)),
                             jnp.asarray(votes), jfn, maxpairs)
    got = tgg._select_pairs_plain(torch.from_numpy(top),
                                  torch.from_numpy(votes), tfn, maxpairs)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[2].any()
