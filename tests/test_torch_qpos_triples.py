"""The plain versions of K15 (qpos_ranges) and K6 (select_triples),
which their kernels are held to, against the JAX package's _qpos_ranges
and _select_triples on the edges the kernels' designs turn on, and the
card's read-length limit (the shared memory of K1, K3, K4, K5, K7 and
K13).

K15 (synth.qpos_range_cases): selected diagonals repeated and INVALID,
rows whose every slot is INVALID, diagonals 0 and 0xFFFFFFFE, qpos not
monotone; W = 1, 31, 33 and 4096, P = 1, 32 and 128.  K6
(synth.triple_cases): NC = 2, 3, 31, 32, 33, 64 and 128; maxdist 0, 1 and
2^32 - 1; differences that wrap uint32; equal and zero votes, all-INVALID
rows, sums at the key's width 2^23 - 2; T = 1, 8 and 4 NC.  Where g++ is
present, both kernels, K2's path for rows past 32,768 slots, K13's
wide-key path and the entry points' size checks are built through
tools/cuda_emu and run on the CPU.  The long
reads: the port's plain align_batch_gapped -N 1 against JAX's on reads of
1,025 to 1,536 nt.  Seeded numpy inputs, exact equality."""

import ctypes
import dataclasses
import os
import shutil
import sys

import jax
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
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.kernels import limits as klimits
from gmap_gsnap_tpu_torch.ops import mismatch as tmm
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, one_torch_thread

NCS = [2, 3, 31, 32, 33, 64, 128]
MAXDISTS = [0, 1, 2**32 - 1]
# JAX's _select_triples compiled once a shape (maxdist traced, as a
# uint32): op by op, each NC's first call took ~2 s of eager compiles
_JAX_TRIPLES = jax.jit(jgg._select_triples, static_argnums=(3,))


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _eq(port, jax_value):
    j = np.asarray(jax_value)
    p = port.numpy()
    assert p.shape == j.shape
    np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))


def _k15_case(w, p):
    return synth.qpos_range_cases(np.random.default_rng(w * 1000 + p), 8, w,
                                  p)


def _k6_case(nc):
    return synth.triple_cases(np.random.default_rng(nc), 12, nc)


def _triple_counts(nc):
    return sorted({1, 8, 4 * nc} & set(range(1, 4 * nc + 1)))


@pytest.mark.parametrize("w", [1, 31, 33, 4096])
@pytest.mark.parametrize("p", [1, 32, 128])
def test_qpos_ranges_edges(w, p):
    diag, qpos, dsel = _k15_case(w, p)
    want = jse._qpos_ranges(jnp.asarray(diag.astype(np.uint32)),
                            jnp.asarray(qpos),
                            jnp.asarray(dsel.astype(np.uint32)))
    got = tse._qpos_ranges_plain(*(torch.from_numpy(x)
                                   for x in (diag, qpos, dsel)))
    for g, j in zip(got, want):
        _eq(g, j)
    if w > 1:  # some selected diagonal is found, some is not
        assert (got[1] >= 0).any() and (got[1] < 0).any()


@pytest.mark.parametrize("nc", NCS)
@pytest.mark.parametrize("maxdist", MAXDISTS)
def test_select_triples_edges(nc, maxdist):
    top, votes = _k6_case(nc)
    # JAX ranks all 4 NC entries once: its first T are its result for T
    full = _JAX_TRIPLES(jnp.asarray(top.astype(np.uint32)),
                        jnp.asarray(votes), jnp.uint32(maxdist), 4 * nc)
    for t in _triple_counts(nc):
        got = tgg.select_triples(torch.from_numpy(top),
                                 torch.from_numpy(votes), maxdist, t)
        for g, j in zip(got, full):
            _eq(g, np.asarray(j)[:, :t])
        if maxdist == 0:
            assert not got[3].any()
        elif maxdist > 1 and nc >= 3:  # any 3 valid diagonals are a triple
            assert got[3].any()


# --------------------------------------- the kernels, emulated on the CPU

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K15, K6, K13 and the other kernels
    whose shared memory grows with the read, built by tools/cuda_emu
    (restored after), so that the _X_cuda wrappers run the CUDA sources
    on CPU tensors; yields the emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["qpos_ranges", "select_triples", "top_diagonals",
                          "lane_features",
                          "seed_diagonals", "prefix_mismatches",
                          "solve_indels", "solve_splices",
                          "solve_doublesplices"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield ctypes.CDLL(so)
    kbuild.launch = launch


@pytest.mark.parametrize("w,p", [(1, 1), (33, 32), (384, 32), (4096, 128)])
def test_qpos_ranges_emulated_kernel(emulated, w, p):
    args = [torch.from_numpy(x) for x in _k15_case(w, p)]
    got = tse._qpos_ranges_cuda(*args)
    want = tse._qpos_ranges_plain(*args)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.parametrize("nc", [3, 32, 33, 128])
def test_select_triples_emulated_kernel(emulated, nc):
    top, votes = (torch.from_numpy(x) for x in _k6_case(nc))
    for maxdist in MAXDISTS:
        for t in _triple_counts(nc):
            got = tgg._select_triples_cuda(top, votes, maxdist, t)
            want = tgg._select_triples_plain(top, votes, maxdist, t)
            for g, x in zip(got, want):
                assert g.dtype == x.dtype and torch.equal(g, x)


def test_top_diagonals_wide_rows_emulated_kernel(emulated):
    """K2's path for rows wider than 32,768 slots (the runner's exact seed
    grid of a long read): ties across the ncand cut, one diagonal W times
    (votes past 2^12, the histogram's second level), every vote 1."""
    rows = synth.diag_vote_rows(np.random.default_rng(6), 6, 32769, 16)
    d = torch.from_numpy(rows[[0, 3, 5]])
    got = tse._top_diagonals_cuda(d, 16)
    want = tse._top_diagonals_plain(d, 16)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.parametrize("L", [1025, 4096])
def test_lane_features_wide_keys_emulated_kernel(emulated, L):
    """K13 past 1,024 bases (64-bit trim keys, the rows staged 1,024
    bytes at a time), with trim scores the C entry clamps to -(L + 1) and
    L + 1, against the plain trims at the scores themselves."""
    mm, pref, ln = (torch.from_numpy(x) for x in
                    synth.mismatch_edge_rows(np.random.default_rng(L), 5, 7,
                                             L))
    for k, score in ((12, -1), (15, -3 * L), (15, 10 * L), (12, 0)):
        got = tgg._lane_features_cuda(mm, ln, k, 3, score)
        want = tgg.lane_features(mm, pref, ln, k, 3, score)
        for key in sorted(want):
            assert torch.equal(got[key], want[key]), (key, score)


def test_kernel_limits_match_entry_points(emulated):
    """Each entry point accepts reads of its longest_fitting length (an
    empty batch) and refuses one base more; the card's limit is their
    minimum, at least 8,192 bases."""
    lib = emulated
    p = ctypes.c_void_p
    null = [None] * 40

    def entry(name, L):
        sig = kbuild._SIGNATURES[name]
        fn = getattr(lib, name)
        fn.argtypes = [{"p": p, "h": p, "i": ctypes.c_int32,
                        "l": ctypes.c_int64}[c] for c in sig] + [p]
        np_ = sig.count("p")
        if name == "gsnap_seed_diagonals":   # B L k q thr W half noff npos
            ints = [0, L, 1, 3, 100, 384, 1, 2, 1, 0, 1]   # + pos_lo pos_len
        elif name == "gsnap_prefix_mismatches":  # nwords glen B NC L NW ...
            ints = [1, 1, 0, 32, L, -(-L // 16), 0, 0, 1]
        elif name == "gsnap_solve_indels":   # B P NC L max_ins max_del ...
            ints = [0, 16, 128, L, 9, 30, 0, L + 1]
        elif name in ("gsnap_solve_splices", "gsnap_solve_doublesplices"):
            ints = [1, 0, 0, 16, 32, L, 1]   # nwords kwords B P|T NC L nov
        else:                                # R K L k interval score
            ints = [0, 32, L, 15, 3, -1]
        return fn(*null[:np_], *ints, None)

    names = {"K1 seed_diagonals": "gsnap_seed_diagonals",
             "K3 prefix_mismatches": "gsnap_prefix_mismatches",
             "K4 solve_indels": "gsnap_solve_indels",
             "K5 solve_splices": "gsnap_solve_splices",
             "K7 solve_doublesplices": "gsnap_solve_doublesplices",
             "K13 lane_features": "gsnap_lane_features"}
    for kernel, top in klimits.LONGEST.items():
        assert entry(names[kernel], top) == 0, kernel
        assert entry(names[kernel], top + 1) != 0, kernel
    assert tmm.CUDA_MAX_READ_LENGTH == min(klimits.LONGEST.values())
    assert tmm.CUDA_MAX_READ_LENGTH >= 8192


# ------------------------------------------------------ reads past 1,024 nt

def test_align_batch_gapped_long_reads():
    """The port's plain align_batch_gapped at -N 1 against JAX's on 8
    spliced reads cut to 1,025-1,536 nt: every output key equal."""
    rng = np.random.default_rng(41)
    g = synth.make_genome(rng, [120_000, 80_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_spliced_reads(rng, g, 8, L=1536)
    cut = rng.integers(1025, 1537, len(recs))
    recs = [dataclasses.replace(r, seq=r.seq[:n], quality=r.quality[:n])
            for r, n in zip(recs, cut)]
    c, f, ln = trun.encode_batch(recs, 1536)
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    # without the packed small-genome table, whose seed path takes reads
    # of fewer than 128 k-mers: the JAX package's path for large genomes
    ji = dataclasses.replace(
        jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3),
        startcnt=None)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(ji.offsets, ji.positions, 12, 3, "cpu")
    base = dict(seed_total=512)
    jout = jgg.align_batch_gapped(
        jg, ji, jnp.asarray(c), jnp.asarray(f), jnp.asarray(ln),
        jgg.GappedParams(base=jse.GsnapParams(**base), novelsplicing=True))
    tout = tgg.align_batch_gapped(
        tg, ti, torch.from_numpy(c), torch.from_numpy(f),
        torch.from_numpy(ln),
        tgg.GappedParams(base=tse.GsnapParams(**base), novelsplicing=True))
    assert set(jout) == set(tout)
    for k in sorted(jout):
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), k
    assert int((tout["npaths"] > 0).sum()) > len(recs) // 2
