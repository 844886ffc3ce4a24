"""The plain versions of K11 (banded_matrices: the band sweep), K12
(bridge_traceback: the junction search and both tracebacks) and K8
(pair_grid: the pairing grid, the pair ranking and the pair overflow
gate), which their kernels are held to, against the JAX package on the
edges the kernels' designs turn on, and, where g++ is present, the three
CUDA sources built through tools/cuda_emu (a CPU emulation of the CUDA
subset they use) and run by their own wrappers against the plain
versions.

K11 (synth.band_sweep_cases): W = 1, 23 and 32; M = 1, 33, 64 and 100;
lband 0, a band of W cells and one past W; len2 below W and len2 = N;
codes 4 and 5; jump late and early; both gap tiers.

K12 (synth.junction_traceback_cases and random windows through the band
sweep): W = 23 and 32; len1 = 2 and 64; ties of gap1 == nogap and gap2
== max(nogap, gap1) under jump early (left side) and jump late (right
side); walks that leave the band past k = 0 and past k = W - 1, where
every cell reads NEG_INF; walks that end at DONE early, and walks cut at
T = 6 steps; every cdna_direction table, halfp, nosplicing and known-site
rewards.  K8 (synth.pair_grid_edges + pair_gate_cases): 16, 7 and 1 hits
an end, K = 1 and K = NP^2; rows whose every cell is BIG; rows of equal
pair scores, where the ranks of left5 and left3 and the cell index
decide; lefts above 2^24 and near 2^31; 1,000 chromosome offsets; the
gate on and off.  Seeded numpy inputs, exact equality."""

import ctypes
import dataclasses
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_pe as jpe
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.ops import dynprog as jdp
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_pe as tpe
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.kernels import limits as klimits
from gmap_gsnap_tpu_torch.ops import dynprog as tdp
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread, same_tree)

M, NL = 64, 72
T_FULL = M + NL + 2
# (cdna_direction, halfp, nosplicing, known-site rewards on)
TABLES = ((1, False, False, False), (-1, True, False, True),
          (0, False, False, False), (1, False, True, True))


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


# ------------------------------------------------------------------- K11

# (W, M): one band cell, the GMAP path's 23 and a full warp; one query
# row, the path's 64, and 33 and 100 (a pass of 32 rows cut short, and
# rows past the kernel's ring of 64)
SWEEP_EDGES = [(1, 1), (1, 64), (23, 64), (32, 64), (32, 1), (23, 100),
               (32, 33)]
TIERS = ((tdp.PAIRED_OPEN, tdp.PAIRED_EXTEND),
         (tdp.SINGLE_OPEN, tdp.SINGLE_EXTEND))


def _sweep_args(W, M, tier, nb=20):
    case = synth.band_sweep_cases(np.random.default_rng(10 * W + M), nb, M,
                                  W)
    t = lambda k: torch.from_numpy(case[k])
    return (t("q"), t("g"), t("len1"), t("len2"), t("lband"), t("rband"),
            tdp.pair_matrix(tdp.MISMATCH_HIGHQ), t("late"), M, W, *tier)


@pytest.mark.parametrize("W,M", SWEEP_EDGES)
def test_band_sweep_cases_match_jax(W, M):
    """The plain band sweep against JAX's banded_matrices on
    band_sweep_cases (lband 0, a full band, a band past W, len2 below W
    and len2 = N, codes 4 and 5 in both sequences, jump late and early),
    both gap tiers."""
    for tier in TIERS:
        a = _sweep_args(W, M, tier)
        got = tdp.banded_matrices(*a)
        want = jdp.banded_matrices(
            *(jnp.asarray(x.numpy()) for x in a[:6]), jnp.asarray(a[6]),
            jnp.asarray(a[7].numpy()), M=M, W=W, open_=tier[0],
            extend=tier[1])
        for g, j in zip(got, want):
            assert g.shape == np.asarray(j).shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # the band reaches past the genome and the walls hold scores
    assert (got[0] == tdp.NEG_INF).any() and (got[0] > tdp.NEG_INF).any()


# ------------------------------------------------------------------- K12

def _hand_case(W, nb=24):
    return synth.junction_traceback_cases(np.random.default_rng(W), nb, M, W,
                                          NL)


def _window_case(W, nb=24):
    """Random junction windows through the plain band sweep (code-5
    padding, both sides), in junction_traceback_cases' layout; len1 2 and
    64 among them."""
    rng = np.random.default_rng(100 + W)
    q = rng.integers(0, 5, (2 * nb, M)).astype(np.int32)
    g = rng.integers(0, 5, (2 * nb, NL)).astype(np.int32)
    g[:, :M] = np.where(rng.random((2 * nb, M)) < 0.8, q, g[:, :M])
    len1 = rng.integers(2, M + 1, nb).astype(np.int32)
    len1[:2] = (2, M)
    len1 = np.tile(len1, 2)
    q[np.arange(M)[None, :] >= len1[:, None]] = 5
    len2 = len1 + 8
    lb, rb = tdp.compute_bands(len1, len2, 7)
    t = torch.from_numpy
    mats = tdp.banded_matrices(t(q), t(g), t(len1), t(len2), t(lb), t(rb),
                               tdp.pair_matrix(tdp.MISMATCH_HIGHQ),
                               t(np.arange(2 * nb) >= nb), M, W,
                               tdp.PAIRED_OPEN, tdp.PAIRED_EXTEND)
    loff = rng.integers(0, 1000, nb)
    return dict(nogap=mats[0].numpy(), gap1=mats[1].numpy(),
                gap2=mats[2].numpy(), ndiag=mats[3].numpy(), len1=len1[:nb],
                len2L=len2[:nb], len2R=len2[nb:], lbandL=lb[:nb],
                lbandR=lb[nb:], gl=g[:nb], grv=g[nb:],
                known=(rng.integers(0, 2, (nb, NL + 1)) * 20).astype(np.int32),
                loff=loff, roff=loff + rng.integers(0, 200, nb))


def _bargs(case, W, T, table, open_=tdp.PAIRED_OPEN, ext=tdp.PAIRED_EXTEND):
    cd, halfp, nospl, known = table
    t = lambda k: torch.from_numpy(np.ascontiguousarray(case[k]))
    kn = t("known") if known else torch.zeros_like(t("known"))
    mats = tuple(t(k) for k in ("nogap", "gap1", "gap2", "ndiag"))
    return (mats, t("len1"), t("len2L"), t("len2R"), t("lbandL"),
            t("lbandR"), t("gl"), t("grv"), kn, kn, t("loff"), t("roff"), M,
            W, T, open_, ext, 30, cd, True, halfp, nospl)


def _jax_bridge_traceback(case, W, T, table, open_=tdp.PAIRED_OPEN,
                          ext=tdp.PAIRED_EXTEND):
    """JAX bridge_intron, then traceback on the left side (jump early)
    and the right side (jump late): the plain version's outputs."""
    cd, halfp, nospl, known = table
    nb = len(case["len1"])
    j = lambda k: jnp.asarray(case[k])
    kn = j("known") if known else jnp.zeros_like(j("known"))
    L, R = slice(0, nb), slice(nb, 2 * nb)
    i32 = lambda k: jnp.asarray(np.asarray(case[k], np.int32))
    jb = jdp.bridge_intron(
        j("nogap")[L], j("ndiag")[L], j("nogap")[R], j("ndiag")[R],
        j("len1"), j("len2L"), j("len2R"), j("lbandL"), j("lbandR"),
        jdp.dinucl_codes_left(j("gl"), NL), jdp.dinucl_codes_right(j("grv"),
                                                                    NL),
        kn, kn, i32("loff"), i32("roff"), M=M, W=W, open_=open_, extend=ext,
        canonical_reward=30, cdna_direction=cd, finalp=True, halfp=halfp,
        nosplicing=nospl)
    out = [jb[0], jb[5]]
    for side, r0, c0, lb, late in ((L, 1, 3, "lbandL", False),
                                   (R, 2, 4, "lbandR", True)):
        out += jdp.traceback(j("nogap")[side], j("gap1")[side],
                             j("gap2")[side], jb[r0].astype(jnp.int32),
                             jb[c0].astype(jnp.int32), j(lb),
                             jnp.full(nb, late), T=T, W=W, open_=open_,
                             extend=ext)
    return out


def _walk_shape(out, case, W):
    """Per side: (steps off the band to the left, to the right, walks
    that reached DONE, walks still going at their last step)."""
    res = []
    for ops, opr, opc, lb in ((out[2], out[3], out[4], case["lbandL"]),
                              (out[5], out[6], out[7], case["lbandR"])):
        ops, opr, opc = (x.numpy().astype(np.int64) for x in (ops, opr, opc))
        lb = np.asarray(lb, np.int64)[:, None]
        # the position each step was taken from: GAP1 (r, opc + 1), GAP2
        # (opr + 1, c)
        k_h = opc + 1 - opr + lb
        k_v = opc - (opr + 1) + lb
        left = ((ops == tdp.OP_HORIZ) & (k_h < 0)).any(1)
        right = ((ops == tdp.OP_VERT) & (k_v >= W)).any(1)
        done = (ops == tdp.OP_NONE).any(1)
        going = ops[:, -1] != tdp.OP_NONE
        res.append((left, right, done, going))
    return res


@pytest.mark.parametrize("W", [23, 32])
@pytest.mark.parametrize("T", [T_FULL, 6])
def test_bridge_traceback_edges_match_jax(W, T):
    """The plain junction search and tracebacks against JAX's on the
    hand-built edges (both gap tiers) and on band-sweep windows, every
    table; at T = 138 the edge walks leave the band on both sides and
    walks end early at DONE, at T = 6 walks run all T steps."""
    seen = np.zeros(4, int)
    for case, tiers in ((_hand_case(W), ((tdp.PAIRED_OPEN, tdp.PAIRED_EXTEND),
                                         (tdp.SINGLE_OPEN,
                                          tdp.SINGLE_EXTEND))),
                        (_window_case(W), ((tdp.PAIRED_OPEN,
                                            tdp.PAIRED_EXTEND),))):
        for open_, ext in tiers:
            for table in TABLES:
                got = tdp.bridge_traceback(*_bargs(case, W, T, table, open_,
                                                   ext))
                want = _jax_bridge_traceback(case, W, T, table, open_, ext)
                for g, j in zip(got, want):
                    assert g.shape == np.asarray(j).shape
                    np.testing.assert_array_equal(
                        g.numpy().astype(np.int64),
                        np.asarray(j).astype(np.int64))
                for left, right, done, going in _walk_shape(got, case, W):
                    seen += [left.sum(), right.sum(), done.sum(),
                             going.sum()]
    if T == T_FULL:
        assert seen[0] > 0 and seen[1] > 0 and seen[2] > 0, seen
    else:
        assert seen[3] > 0, seen


def test_junction_edge_kinds():
    """junction_traceback_cases' walks: the "past k = 0" kind's leave the
    band past its first column, the "past k = W" kind's past its last."""
    case = _hand_case(23)
    out = tdp.bridge_traceback(*_bargs(case, 23, T_FULL, TABLES[0]))
    (lleft, lright, _, _), (rleft, rright, _, _) = _walk_shape(out, case, 23)
    kind = np.arange(24) % 3
    assert (lleft | rleft)[kind == 1].any()
    assert (lright | rright)[kind == 2].any()


# ------------------------------------------------------------------- K8

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
    return jg, ji, tg, ti


def _k8_case(b=64):
    rng = np.random.default_rng(7)
    hits, len5, len3, offsets = synth.pair_grid_edges(rng, b)
    return hits, len5, len3, offsets, synth.pair_gate_cases(rng, b)


def _fake_gather(out2, cands2):
    def gather(*args, **kwargs):
        return dict(out2), dict(cands2)
    return gather


# (hits an end, pairs kept, gate)
K8_CASES = [(1, 1, True), (7, 49, False), (7, 1, True), (16, 256, True),
            (16, 1, False)]


@pytest.mark.parametrize("np_,K,gate", K8_CASES)
def test_pair_grid_edges_match_jax(arrays, monkeypatch, np_, K, gate):
    """Both packages' align_batch_pe on pair_grid_edges' hits (their
    gather_candidates replaced), over 1,000 chromosome offsets, NP hits
    an end and K pairs kept, with the pair overflow gate (no known sites)
    or without it (known sites): every output equal; some rows have no
    pair (every cell BIG) and rows 1 and 2 fill all K slots at one
    score."""
    jg, ji, tg, ti = arrays
    hits, len5, len3, offsets, cands = _k8_case()
    b = len(len5)
    jg = dataclasses.replace(jg, chr_offsets=jnp.asarray(
        offsets.astype(np.uint32)))
    tg = dataclasses.replace(tg, chr_offsets=torch.from_numpy(offsets))
    kw = dict(seed_total=512)
    jp = jpe.PEParams(gapped=jgg.GappedParams(
        base=jse.GsnapParams(**kw), novelsplicing=True),
        pairmax=jpe.PAIRMAX_RNA, npair_end=np_, maxpairs=K)
    tp = tpe.PEParams(gapped=tgg.GappedParams(
        base=tse.GsnapParams(**kw), novelsplicing=True),
        pairmax=tpe.PAIRMAX_RNA, npair_end=np_, maxpairs=K)
    monkeypatch.setattr(jgg, "gather_candidates", _fake_gather(
        {k: jnp.asarray(v) for k, v in hits.items()},
        {k: jnp.asarray(v) for k, v in cands.items()}))
    tout = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in hits.items()}
    monkeypatch.setattr(tgg, "gather_candidates", _fake_gather(
        tout, {k: torch.from_numpy(v) for k, v in cands.items()}))
    codes = np.zeros((b, 100), np.uint8)
    enc = (codes, codes.astype(bool), len5, codes, codes.astype(bool), len3)
    jknown = tknown = None
    if not gate:
        words = np.zeros(4, np.int32)
        jknown = tuple(jnp.asarray(words) for _ in range(4))
        tknown = tuple(torch.from_numpy(words) for _ in range(4))
    jres = jpe.align_batch_pe.__wrapped__(
        jg, ji, *(jnp.asarray(x) for x in enc), jp, known=jknown)
    tres = tpe.align_batch_pe(tg, ti, *(torch.from_numpy(x) for x in enc),
                              tp, known=tknown)
    same_tree(jres, tres)
    npairs = tres["npairs"].numpy()
    assert tres["i5"].shape == (b, min(K, np_ * np_))
    assert (npairs[3::5] == 0).all() and (npairs[4::5] == 0).all()
    assert (npairs[1:3] == min(K, np_ * np_)).all()
    assert (tres["pscore"][1:3] == tres["pscore"][1:3, :1]).all()


# --------------------------------------- the kernels, emulated on the CPU

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K11, K12 and K8 built by tools/cuda_emu
    (restored after), so that the _X_cuda wrappers run the CUDA sources
    on CPU tensors; yields the emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["banded_gotoh", "bridge_traceback", "pair_grid"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield ctypes.CDLL(so)
    kbuild.launch = launch


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("W,M", SWEEP_EDGES)
def test_banded_gotoh_emulated_kernel(emulated, W, M):
    """K11's CUDA source against the plain band sweep on band_sweep_cases,
    both gap tiers; a launch is counted for each call."""
    before = kbuild.LAUNCHES["gmap_banded_gotoh"]
    for tier in TIERS:
        a = _sweep_args(W, M, tier)
        _same(tdp._banded_matrices_cuda(*a), tdp._banded_matrices_plain(*a))
    assert kbuild.LAUNCHES["gmap_banded_gotoh"] == before + len(TIERS)


@pytest.mark.parametrize("W", [23, 32])
@pytest.mark.parametrize("T", [T_FULL, 6])
def test_bridge_traceback_emulated_kernel(emulated, W, T):
    """K12's CUDA source against the plain version on the hand-built
    edges (every table, both gap tiers) and band-sweep windows; a launch
    is counted for each call."""
    paired = (tdp.PAIRED_OPEN, tdp.PAIRED_EXTEND)
    single = (tdp.SINGLE_OPEN, tdp.SINGLE_EXTEND)
    # (a CTA is 1024 emulated threads: fewer junctions than the plain
    # tests take)
    runs = [(_hand_case(W, 12), tier, table)
            for tier, table in zip((paired, single) * 2, TABLES)]
    runs += [(_window_case(W, 8), paired, table) for table in TABLES[::3]]
    before = kbuild.LAUNCHES["gmap_bridge_traceback"]
    for case, tier, table in runs:
        a = _bargs(case, W, T, table, *tier)
        _same(tdp._bridge_traceback_cuda(*a),
              tdp._bridge_traceback_plain(*a))
    assert kbuild.LAUNCHES["gmap_bridge_traceback"] == before + len(runs)


def test_bridge_traceback_limit_matches_entry_point(emulated):
    """K12's entry point takes the largest M whose shared memory
    kernels/limits.py admits (W = 32, NL = NR = M + 8, T = M + NL + 2, no
    junction) and refuses M + 1; the wrapper refuses it before a
    launch."""
    def fits(m):
        return klimits.bridge_traceback_bytes(m, 32, m + 8, m + 8,
                                              2 * m + 10) <= klimits.SMEM_MAX

    top = max(m for m in range(64, 1024) if fits(m))
    fn = emulated.gmap_bridge_traceback
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int32] * 8 + [
        ctypes.c_void_p]
    for m, rc in ((top, 0), (top + 1, None)):
        got = fn(*[None] * 21, 0, m, 32, m + 8, m + 8, 2 * m + 10, -18, 0,
                 None)
        assert (got == 0) if rc == 0 else (got != 0), m
    m = top + 1
    mats = tuple(torch.zeros((2, m + 1, 32), dtype=dt)
                 for dt in (torch.int32,) * 3 + (torch.bool,))
    one = torch.zeros(1, dtype=torch.int32)
    win = torch.zeros((1, m + 8), dtype=torch.int32)
    kn = torch.zeros((1, m + 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        tdp._bridge_traceback_cuda(mats, one, one, one, one, one, win, win,
                                   kn, kn, one, one, m, 32, 2 * m + 10, -18,
                                   -3, 30, 1, True, False, False)


@pytest.mark.parametrize("np_", [1, 7, 16])
def test_pair_grid_emulated_kernel(emulated, np_):
    """K8's CUDA source against the plain grid (and plain gate) on
    pair_grid_edges' rows, K = 1, NP^2 and 100, gate on and off, DNA and
    RNA pairmax."""
    hits, len5, len3, offsets, cands = _k8_case()
    b = len(len5)
    t = lambda v: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                   else v)
    base = tse.GsnapParams()
    h5 = tgg.rank_hits({k: t(v[:b]) for k, v in hits.items()}, base,
                       apply_optimal=False, maxout=np_)
    h3 = tgg.rank_hits({k: t(v[b:]) for k, v in hits.items()}, base,
                       apply_optimal=False, maxout=np_)
    for K in sorted({1, np_ * np_, min(100, np_ * np_)}):
        for pairmax, subopt, gate in ((tpe.PAIRMAX_RNA, 2, True),
                                      (tpe.PAIRMAX_DNA, 0, False)):
            args = (h5, h3, t(len5), t(len3), t(offsets), pairmax, subopt, K)
            ends = [({k: t(v[s]) for k, v in cands.items()}) for s in
                    (slice(0, b), slice(b, None)) for _ in range(2)]
            g = lambda c5, c3: (c5, c3, 1, True) if gate else None
            got = tpe._pair_grid_cuda(*args, g(ends[0], ends[2]))
            want = tpe.pair_grid(*args, g(ends[1], ends[3]))
            _same([got[k] for k in tpe.PAIR_GRID_KEYS],
                  [want[k] for k in tpe.PAIR_GRID_KEYS])
            _same([ends[0]["overflow"], ends[2]["overflow"]],
                  [ends[1]["overflow"], ends[3]["overflow"]])
