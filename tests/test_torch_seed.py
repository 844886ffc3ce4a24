"""Port parity: seeding and voting (kernels K1 and K2, plain path)
against gmap_gsnap_tpu.align.gsnap_se on the same synthetic genome,
index and reads.  Every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align.runner import encode_batch
from gmap_gsnap_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
    recs, truth = synth.plant_reads(
        rng, g, 96, weights=dict(sub=3, n=1, mid_indel=1, terminal=1,
                                 repeat=2, junk=0.5))
    # reads with 4 and 5 substitutions
    for i in range(0, 12):
        s = bytearray(recs[i].seq.encode())
        for p in rng.choice(100, 4 + i % 2, replace=False):
            s[p] = b"ACGT"[(b"ACGT".index(s[p]) + 1) % 4]
        recs[i] = dataclasses.replace(recs[i], seq=s.decode())
    # mixed read lengths
    recs = [r if i % 4 else dataclasses.replace(
        r, seq=r.seq[: 50 + i % 50], quality=r.quality[: 50 + i % 50])
        for i, r in enumerate(recs)]
    c, f, l = encode_batch(recs, 100)
    return ji, ti, c, f, l


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _jax_index(ji, startcnt: bool):
    return ji if startcnt else dataclasses.replace(ji, startcnt=None)


@pytest.mark.parametrize("startcnt", [True, False])
@pytest.mark.parametrize("seed_total", [384, 64, 0])
def test_seed_diagonals(world, startcnt, seed_total):
    ji, ti, c, f, l = world
    jidx = _jax_index(ji, startcnt)
    if startcnt:
        assert jidx.startcnt is not None
    p = jse.GsnapParams(seed_total=seed_total)
    tp = tse.GsnapParams(seed_total=seed_total)
    jo, jv = jse._extract_oligos(jnp.asarray(c), jnp.asarray(f),
                                 jnp.asarray(l), 12)
    to, tv = tse._extract_oligos(torch.from_numpy(c), torch.from_numpy(f),
                                 torch.from_numpy(l), 12)
    _eq(jo, to)
    _eq(jv, tv)
    jres = jse._seed_diagonals(jidx, jo, jv, p, jnp.asarray(l))
    tres = tse.seed_diagonals(ti, torch.from_numpy(c), torch.from_numpy(f),
                              torch.from_numpy(l), tp, half=True)
    for a, b in zip(jres, tres):     # diag, qpos (incl. empty slots), ...
        _eq(a, b)
    jres0 = jse._seed_diagonals(jidx, jo, jv, p)
    tres0 = tse.seed_diagonals(ti, torch.from_numpy(c), torch.from_numpy(f),
                               torch.from_numpy(l), tp, half=False)
    _eq(jres0[4], tres0[4])
    if seed_total == 64:
        assert tres[2].any()          # the repeat reads truncate


@pytest.mark.parametrize("ncand", [32, 8])
def test_top_diagonals(world, ncand):
    ji, ti, c, f, l = world
    diag = tse.seed_diagonals(ti, torch.from_numpy(c), torch.from_numpy(f),
                              torch.from_numpy(l), tse.GsnapParams())[0]
    jres = jse._top_diagonals(jnp.asarray(diag.numpy().astype(np.uint32)),
                              ncand)
    tres = tse.top_diagonals(diag, ncand)
    for a, b in zip(jres, tres):
        _eq(a, b)
    assert (tres[2] > ncand).any()    # ndistinct > ncand occurs


def test_top_diagonals_ties():
    """Equal votes keep the lower diagonal first (lax.top_k's rule,
    which torch.topk does not follow)."""
    inv = 0xFFFFFFFF
    rows = np.array([
        [5, 3, 5, 9, 3, 9, inv, 7, 7, 1],
        [inv] * 10,
        [4, 4, 4, 2, 2, 2, 8, 8, 8, 0],
        [0xFFFFFFFE, 0, 0xFFFFFFFE, inv, 1, 1, 0, inv, 3, 3],
    ], np.int64)
    jres = jse._top_diagonals(jnp.asarray(rows.astype(np.uint32)), 4)
    tres = tse.top_diagonals(torch.from_numpy(rows), 4)
    for a, b in zip(jres, tres):
        _eq(a, b)
    assert tres[0][0].tolist() == [3, 5, 7, 9]


def test_revcomp_and_pack(world):
    ji, ti, c, f, l = world
    jc, jf = jse._revcomp_batch(jnp.asarray(c), jnp.asarray(f), jnp.asarray(l))
    tc, tf = tse._revcomp_batch(torch.from_numpy(c), torch.from_numpy(f),
                                torch.from_numpy(l))
    _eq(jc, tc)
    _eq(jf, tf)
    full = l == 100
    ju = jse._revcomp_batch(jnp.asarray(c[full]), jnp.asarray(f[full]),
                            jnp.asarray(l[full]), True)
    tu = tse._revcomp_batch(torch.from_numpy(c[full]), torch.from_numpy(f[full]),
                            torch.from_numpy(l[full]), True)
    _eq(ju[0], tu[0])
    jq = jse._pack_device(jnp.asarray(c), jnp.asarray(f), jnp.asarray(l), 100)
    tq = tse._pack_device(torch.from_numpy(c), torch.from_numpy(f),
                          torch.from_numpy(l), 100)
    _eq(jq.codes16, tq.codes16)
    _eq(jq.nflags16, tq.nflags16)


def test_qpos_ranges(world):
    ji, ti, c, f, l = world
    diag, qgrid = tse.seed_diagonals(ti, torch.from_numpy(c), torch.from_numpy(f),
                                     torch.from_numpy(l), tse.GsnapParams())[:2]
    top_d = tse.top_diagonals(diag, 32)[0]
    jres = jse._qpos_ranges(jnp.asarray(diag.numpy().astype(np.uint32)),
                            jnp.asarray(qgrid.numpy()),
                            jnp.asarray(top_d.numpy().astype(np.uint32)))
    tres = tse._qpos_ranges_plain(diag, qgrid, top_d)
    for a, b in zip(jres, tres):
        _eq(a, b)


def test_params_copy():
    """GsnapParams is a field-for-field copy (names, order, defaults)."""
    jf = [(x.name, x.default) for x in dataclasses.fields(jse.GsnapParams)]
    tf = [(x.name, x.default) for x in dataclasses.fields(tse.GsnapParams)]
    assert sorted(jf) == sorted(tf)
    assert jse.dynamic_size_threshold(10**7, 12, "standard") == \
        tse.dynamic_size_threshold(10**7, 12, "standard")
