"""The plain versions of K2 (top_diagonals) and K14 (rank_hits), which
their kernels are held to, against the JAX package's _top_diagonals and
rank_hits on the edges the kernels' sorting designs turn on: votes tied
across the ncand cut, fewer heads than ncand, all-INVALID rows, one
diagonal W times, W off a power of two, W=4096 with ncand 128 and ncand
equal to W (K2); one and 512 candidates, near duplicates equal in six
of the seven dedup fields, lefts 0 and 2^32 - 1 on both strands, scores
BIG - 1, BIG and 0 in one row, maxout above the candidate count, the
optimal filter on and off (K14).  Seeded numpy inputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _eq(port, jax_value):
    j = np.asarray(jax_value)
    if j.dtype == np.uint32:
        j = j.astype(np.int64)
    p = port.numpy()
    assert p.shape == j.shape
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("w,ncand", [(384, 32), (383, 32), (385, 32),
                                     (4096, 128), (4096, 4096), (64, 64)])
def test_top_diagonals(w, ncand):
    """Every row kind of synth.diag_vote_rows, twice over."""
    rng = np.random.default_rng(w * 7 + ncand)
    diag = synth.diag_vote_rows(rng, 2 * len(synth.DIAG_ROW_KINDS), w,
                                ncand)
    want = jse._top_diagonals(jnp.asarray(diag.astype(np.uint32)), ncand)
    got = tse._top_diagonals_plain(torch.from_numpy(diag), ncand)
    for g, x in zip(got, want):
        _eq(g, x)
    top_d, votes, nd = got
    # the edges are there: a tie across the cut (where the row holds
    # its 7 ncand diagonals), a short row, empty rows
    if 7 * ncand <= w:
        assert votes[0, -1] == 3 and (votes[0] == 3).sum() < 3 * ncand // 2
    assert nd[1] < ncand and (votes[1, nd[1]:] == 0).all()
    assert nd[2] == 0 and (top_d[2] == 0xFFFFFFFF).all()
    assert nd[3] == 1 and votes[3, 0] == w


def _jax_out(out):
    """A hit table as the JAX package carries it (coordinates uint32)."""
    return {k: jnp.asarray(v.astype(np.uint32) if k in ("left", "right",
                                                        "mid") else v)
            for k, v in out.items()}


def _rank_case(edge, n, apply_optimal, maxout):
    out = synth.rank_hit_edges(np.random.default_rng(n + 3), 16, n, edge)
    base_j = jse.GsnapParams(subopt_levels=1)
    base_t = tse.GsnapParams(subopt_levels=1)
    want = jgg.rank_hits(_jax_out(out), base_j, apply_optimal, maxout)
    got = tgg._rank_hits_plain({k: torch.from_numpy(v)
                                for k, v in out.items()}, base_t,
                               apply_optimal, maxout)
    assert set(got) == set(want)
    for key in want:
        _eq(got[key], want[key])
    return out, got


@pytest.mark.parametrize("edge", synth.RANK_EDGE_KINDS)
@pytest.mark.parametrize("apply_optimal,maxout", [(True, None),
                                                  (False, 16)])
def test_rank_hits_edges(edge, apply_optimal, maxout):
    out, got = _rank_case(edge, 144, apply_optimal, maxout)
    if edge == "BIG-1, BIG, 0":
        assert (got["score"][:, 0] == 0).all()
    if edge == "left 0 and 2^32-1":
        assert ((got["left"] == 0) & (got["score"] < 10**6)).any()


@pytest.mark.parametrize("n,apply_optimal,maxout", [(1, True, None),
                                                    (1, False, 16),
                                                    (512, True, 600),
                                                    (512, False, 100),
                                                    (336, True, None)])
def test_rank_hits_widths(n, apply_optimal, maxout):
    """One candidate, the kernel's widest row and the wide lane's, with
    maxout above the candidate count."""
    _, got = _rank_case("near duplicates", n, apply_optimal, maxout)
    assert got["score"].shape[1] == min(maxout or 100, n)
