"""Port parity: ops/maxent (float32 device half bit-equal, float64 host
half equal), the genome code fetches it reads through, and the tables
carried across by convert — against the JAX package on a synthetic
genome.  Exact everywhere: float32 results are compared as uint32 bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu.ops import maxent as jmax
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.ops import genome as tgen
from gmap_gsnap_tpu_torch.ops import maxent as tmax
from gmap_gsnap_tpu_torch.utils import synth

KINDS = ("donor", "acceptor", "antidonor", "antiacceptor")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    g = synth.make_genome(rng, [120_000, 80_000])
    codes, flags = g.codes_flags
    jg = jgen.GenomeArrays.from_codes(codes, flags, g.chr_ends)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    return rng, codes, jg, tg


def _bits(x) -> np.ndarray:
    """float32 values (JAX array or torch tensor) as their uint32 bits."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.float32
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    assert a.dtype == np.float32
    return a.view(np.uint32)


def _starts(rng, glen, n):
    """Span starts: random, near 0, just below and past the genome end,
    and uint32 values that wrapped below 0."""
    s = rng.integers(0, glen, n).astype(np.int64)
    s[:8] = np.arange(8)
    s[8:16] = glen - 50 + np.arange(8) * 9
    s[16:20] = glen + np.array([0, 15, 200, 10_000])
    s[20:24] = 2**32 - np.array([1, 5, 20, 40])
    return s


def test_tables_from_convert():
    t = convert.maxent_tables_from_arrays(jmax._tables_np(), "cpu")
    j = jmax._tables_jnp()
    assert set(t) == set(j) == {n for k in KINDS for n, _ in tmax._MODELS[k]}
    for k in j:
        assert np.array_equal(_bits(j[k]), _bits(t[k])), k
        assert np.array_equal(_bits(tmax.device_tables("cpu")[k]), _bits(t[k]))
    flat = tmax.flat_tables("cpu")
    assert flat.numel() == 12 * 16384 + 4 * 16


def test_fetch_span_codes(world):
    rng, codes, jg, tg = world
    starts = _starts(rng, jg.length, 200)
    n = 141
    j = jgen.fetch_span_codes(jg.ref16, jnp.asarray(starts.astype(np.uint32)), n)
    t = tgen.fetch_span_codes(tg.ref16, torch.from_numpy(starts), n)
    assert t.dtype == torch.uint8
    assert np.array_equal(np.asarray(j), t.numpy())
    # inside the genome it is the genome
    ok = starts + n <= jg.length
    assert np.array_equal(
        t.numpy()[ok], codes[starts[ok][:, None] + np.arange(n)[None, :]])
    pos = np.concatenate([starts[:24], rng.integers(0, jg.length, 100)])
    pos = pos % 2**32
    j = jgen.fetch_codes(jg.ref16, jnp.asarray(pos.astype(np.uint32)))
    t = tgen.fetch_codes(tg.ref16, torch.from_numpy(pos))
    assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_span_window_and_positions_bit_equal(world, kind):
    rng, codes, jg, tg = world
    npos = 101
    starts = _starts(rng, jg.length, 300)
    jspan = jgen.fetch_span_codes(jg.ref16, jnp.asarray(starts.astype(np.uint32)),
                                  npos + 40)
    tspan = tgen.fetch_span_codes(tg.ref16, torch.from_numpy(starts), npos + 40)
    # splice_prob_span and splice_idx_span
    jp = jmax.splice_prob_span(jspan, kind, npos)
    tp = tmax.splice_prob_span(tspan, kind, npos)
    assert tp.shape == (300, npos)
    assert np.array_equal(_bits(jp), _bits(tp))
    jidx = jmax.splice_idx_span(jspan, kind, npos)
    tidx = tmax.splice_idx_span(tspan, kind, npos)
    assert [n for n, _ in jidx] == [n for n, _ in tidx]
    for (_, a), (_, b) in zip(jidx, tidx):
        assert np.array_equal(np.asarray(a), b.numpy())
    # splice_prob_window on the windows the span holds
    m, w = tmax.window_margin_width(kind)
    jwin = jspan[:, 20 - m : 20 - m + w]
    twin = tspan[:, 20 - m : 20 - m + w]
    assert np.array_equal(_bits(jmax.splice_prob_window(jwin, kind)),
                          _bits(tmax.splice_prob_window(twin, kind)))
    # splice_prob at positions (near 0 returns 0; past the end reads T)
    pos = np.concatenate([np.arange(25), rng.integers(0, jg.length, 500),
                          jg.length - np.arange(1, 30)])
    jv = jmax.splice_prob(jg, jnp.asarray(pos.astype(np.uint32)), kind)
    tv = tmax.splice_prob(tg, torch.from_numpy(pos), kind)
    assert np.array_equal(_bits(jv), _bits(tv))
    assert (tv[:m] == 0).all() and (tv > 0.9).any()
    # the host float64 half
    hp = np.concatenate([pos, [jg.length + 5]])
    assert np.array_equal(jmax.splice_prob_np(codes, hp, kind),
                          tmax.splice_prob_np(codes, hp, kind))


def test_host_string_helpers():
    rng = np.random.default_rng(2)
    acgt = np.array(list("ACGT"))
    for _ in range(20):
        d = "".join(acgt[rng.integers(0, 4, 9)])
        a = "".join(acgt[rng.integers(0, 4, 23)])
        assert jmax.donor_prob(d) == tmax.donor_prob(d)
        assert jmax.acceptor_prob(a) == tmax.acceptor_prob(a)
        assert jmax.donor_prob_revcomp(d) == tmax.donor_prob_revcomp(d)
        assert jmax.acceptor_prob_revcomp(a) == tmax.acceptor_prob_revcomp(a)
    with pytest.raises(ValueError):
        tmax.prob_from_str("ACGT", "donor")
