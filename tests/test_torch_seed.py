"""Port parity: seeding and voting (kernels K1 and K2, plain path)
against gmap_gsnap_tpu.align.gsnap_se on the same synthetic genome,
index and reads, and on synth.seed_row_cases (K1's edges); where g++ is
present, K1's CUDA source built through tools/cuda_emu (a CPU emulation
of the CUDA subset it uses) and run by its own wrapper against the plain
version.  Every comparison is exact."""

import dataclasses
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align.runner import encode_batch
from gmap_gsnap_tpu_torch.kernels import build as kbuild
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
    tc, tf = tse._revcomp_batch_plain(torch.from_numpy(c), torch.from_numpy(f),
                                torch.from_numpy(l))
    _eq(jc, tc)
    _eq(jf, tf)
    full = l == 100
    ju = jse._revcomp_batch(jnp.asarray(c[full]), jnp.asarray(f[full]),
                            jnp.asarray(l[full]), True)
    tu = tse._revcomp_batch_plain(torch.from_numpy(c[full]), torch.from_numpy(f[full]),
                            torch.from_numpy(l[full]), True)
    _eq(ju[0], tu[0])
    jq = jse._pack_device(jnp.asarray(c), jnp.asarray(f), jnp.asarray(l), 100)
    tq = tse._pack_device_plain(torch.from_numpy(c), torch.from_numpy(f),
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


# ------------------------------------ K1 on its edges, and emulated

# (S, interval): the warp's chunk edge (31, 32, 33 k-mers), one phase and
# 32 phases, and four chunks under 7 phases (a chunk's phases rotate);
# K = 4, so that every oligo's count is set by hand
SEED_EDGES = [(31, 1), (32, 32), (33, 3), (100, 7)]
SEED_K, SEED_THRESHOLD = 4, 5


def _seed_rows(S, b=20):
    """synth.seed_row_cases at S k-mers: the port's index, reads as
    tensors, and the JAX index (positions padded as its loader does)."""
    case = synth.seed_row_cases(np.random.default_rng(S), b,
                                S + SEED_K - 1, SEED_K, SEED_THRESHOLD)
    return case, (torch.from_numpy(case[k]) for k in ("codes", "nflags",
                                                      "lengths"))


def _seed_index(case, q):
    return tse.IndexArrays(torch.from_numpy(case["offsets"]),
                           torch.from_numpy(case["positions"]), SEED_K, q)


@pytest.mark.parametrize("S,q", SEED_EDGES)
def test_seed_row_cases_match_jax(S, q):
    """The plain seed diagonals against JAX's on seed_row_cases: counts of
    0, the threshold and one above it, N runs, reads shorter than L and
    than k, positions below their query position, a grid of 24 slots that
    the repeat reads overflow and the exact grid, half on and off, JAX's
    index with and without its packed start/count table."""
    case, (c, f, l) = _seed_rows(S)
    ti = _seed_index(case, q)
    ji = jse.IndexArrays.from_host(case["offsets"].view(np.uint32),
                                   case["positions"].view(np.uint32),
                                   SEED_K, q)
    jo, jv = jse._extract_oligos(jnp.asarray(case["codes"]),
                                 jnp.asarray(case["nflags"]),
                                 jnp.asarray(case["lengths"]), SEED_K)
    for seed_total in (24, 0):
        p = jse.GsnapParams(seed_total=seed_total,
                            size_threshold=SEED_THRESHOLD)
        tp = tse.GsnapParams(seed_total=seed_total,
                             size_threshold=SEED_THRESHOLD)
        for startcnt in (True, False):
            jidx = _jax_index(ji, startcnt)
            jres = jse._seed_diagonals(jidx, jo, jv, p,
                                       jnp.asarray(case["lengths"]))
            tres = tse.seed_diagonals(ti, c, f, l, tp, half=True)
            for a, b in zip(jres, tres):
                _eq(a, b)
        jres0 = jse._seed_diagonals(jidx, jo, jv, p)
        tres0 = tse.seed_diagonals(ti, c, f, l, tp, half=False)
        _eq(jres0[4], tres0[4])
        if seed_total == 24:
            assert tres[2].any() and not tres[2].all()
    diag = tres[0]
    assert (diag == tse.INVALID_DIAG).all(1).any()      # no usable k-mer
    assert ((diag != tse.INVALID_DIAG) & (tres[1] > 8)).any()
    assert (tres[3] == 0).any() and (tres[3] > 0).any()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K1 built by tools/cuda_emu
    (restored after), so that _seed_diagonals_cuda runs the CUDA source
    on CPU tensors."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["seed_diagonals"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield
    kbuild.launch = launch


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("S,q", SEED_EDGES + [(1, 32)])
def test_seed_diagonals_emulated_kernel(emulated, S, q):
    """K1's CUDA source against the plain version on seed_row_cases (a
    grid of 24 slots, the repeat reads' overflow; 100 slots, 128 and more
    filled in two windows; the exact grid), half on and off; a launch is
    counted for each call."""
    case, (c, f, l) = _seed_rows(S)
    ti = _seed_index(case, q)
    before = kbuild.LAUNCHES["gsnap_seed_diagonals"]
    n = 0
    for seed_total in (24, 100, 0):
        p = tse.GsnapParams(seed_total=seed_total,
                            size_threshold=SEED_THRESHOLD)
        for half in (True, False):
            _same(tse._seed_diagonals_cuda(ti, c, f, l, p, half),
                  tse._seed_diagonals_plain(ti, c, f, l, p, half))
            n += 1
    assert kbuild.LAUNCHES["gsnap_seed_diagonals"] == before + n


@pytest.mark.parametrize("seed_total", [384, 64, 0])
def test_seed_diagonals_emulated_kernel_planted(emulated, world, seed_total):
    """K1's CUDA source against the plain version on the planted reads
    (k = 12, interval 3, a quarter of them 50-99 nt): the main path's
    grid, a truncating one and the exact one."""
    ji, ti, c, f, l = world
    p = tse.GsnapParams(seed_total=seed_total)
    args = (ti, torch.from_numpy(c), torch.from_numpy(f),
            torch.from_numpy(l), p, True)
    _same(tse._seed_diagonals_cuda(*args), tse._seed_diagonals_plain(*args))
