"""Port parity for K9 (GMAP seed segments) and K10 (GMAP chain DP) on
their edges: the JAX package's ``seed_segments_device`` and
``chain_scores_device`` + ``chain_backtrack_device`` against the port's
plain versions on ``synth.seed_segment_cases`` / ``synth.chain_cases``,
and, where g++ is present, K9 and K10's CUDA sources run through
``tools/cuda_emu`` (a CPU emulation) against the plain versions on the
same edges and on planted reads.  The rest of the GMAP engine's parity
tests are in ``test_torch_gmap.py``."""

import ctypes
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gmap_gsnap_tpu.align import gmap_engine as jeng
from gmap_gsnap_tpu_torch.align import gmap_engine as teng
from gmap_gsnap_tpu_torch.db import datadir
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.kernels import limits as klimits
from gmap_gsnap_tpu_torch.utils import dna, synth
from torch_parity import jax_db


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(j, t):
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    return rng, g, db, jax_db(db)


def _oligos(db, seqs, Q):
    k = db.k
    oligos = np.zeros((len(seqs), Q), np.int64)
    valid = np.zeros((len(seqs), Q), bool)
    for i, s in enumerate(seqs):
        c, f = dna.encode(s)
        n = len(c) - k + 1
        oligos[i, :n] = dna.pack_kmers(c, k)
        valid[i, :n] = ~(np.convolve(f.astype(int), np.ones(k, int),
                                     "valid") > 0)
    return oligos.astype(np.int32), valid


# ------------------------------------------------ K9 and K10 on their edges

SEGMENT_CASES = synth.SEED_SEGMENT_CASES
SEGMENT_IDS = ["Q1", "Q33", "Q128-k15", "Q128-edge"]


def _segment_case(Q, k, thr, H, S, nhits):
    case = synth.seed_segment_cases(np.random.default_rng(Q + k + H), Q, k,
                                    thr, H, S, nhits)
    return case, (_t(case["offsets"]), _t(case["positions"]),
                  _t(case["oligos"]), _t(case["valid"]))


@pytest.mark.parametrize("Q,k,thr,H,S,nhits", SEGMENT_CASES, ids=SEGMENT_IDS)
def test_seed_segment_cases_match_jax(Q, k, thr, H, S, nhits):
    """seed_segments_device against the port's plain seed_segments on
    synth.seed_segment_cases (counts 0, 1, threshold and one above it; no
    valid k-mer; nhits = H and H + 1; nsegs = S and S + 1; a segment of
    exactly MIN_SEGLEN and one a base shorter; query gaps of 2k and 2k +
    1; diagonals that wrap uint32), every output."""
    case, (offs, pos, oligos, valid) = _segment_case(Q, k, thr, H, S, nhits)
    js = jeng.seed_segments_device(
        jnp.asarray(case["offsets"].view(np.uint32)),
        jnp.asarray(case["positions"].view(np.uint32)),
        jnp.asarray(case["oligos"]), jnp.asarray(case["valid"]), k=k, H=H,
        S=S, threshold=thr)
    ts = teng.seed_segments(offs, pos, oligos, valid, k, H, S, thr)
    _same([js[x] for x in teng.SEG_KEYS], [ts[x] for x in teng.SEG_KEYS])
    kinds = case["kinds"]
    if "nhits = H + 1" in kinds:
        assert int(ts["nhits"][kinds.index("nhits = H + 1")]) == H + 1
        assert int(ts["nhits"][kinds.index("nhits = H")]) == H
    if "nsegs = S + 1" in kinds and S + 1 <= H:
        assert int(ts["nsegs"][kinds.index("nsegs = S + 1")]) == S + 1
        assert int(ts["nsegs"][kinds.index("nsegs = S")]) == S
    if "edges" in kinds:
        # kept: the MIN_SEGLEN one, the 2k gap's, the 2k + 1 gap's second
        # half and both wrapping ones; dropped at k = 12 (a hit spans 12)
        # the short one and the 2k + 1 gap's one-hit first half
        assert int(ts["nsegs"][kinds.index("edges")]) == (5 if k < 15 else 6)


CHAIN_CASES = synth.CHAIN_CASE_SHAPES


@pytest.mark.parametrize("S,lvs", CHAIN_CASES)
def test_chain_cases_match_jax(S, lvs):
    """chain_scores_device + chain_backtrack_device against the port's
    plain chain on synth.chain_cases (last valid segments 0, 31, 32, 33
    and S - 1; ties; rows without a valid segment; diagonals wrapping
    uint32), both intron limits, backtracks of 192 steps and of one."""
    case = synth.chain_cases(np.random.default_rng(S), 8, S, lvs)
    a = [_t(case[x]) for x in ("qstart", "qend", "diag", "valid")]
    ja = [jnp.asarray(case["qstart"]), jnp.asarray(case["qend"]),
          jnp.asarray(case["diag"].astype(np.uint32)),
          jnp.asarray(case["valid"])]
    for il, C in ((30, 192), (200_000, 192), (200_000, 1)):
        jsc, jpr = jeng.chain_scores_device(*ja, k=12, max_intronlen=il)
        jb = jeng.chain_backtrack_device(*ja, jsc, jpr, C=C)
        tc = teng.chain(*a, 12, il, C)
        _same((jsc, jpr, *jb), [tc[x] for x in teng.CHAIN_KEYS])


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K9 and K10 built by tools/cuda_emu
    (restored after), so that the _X_cuda wrappers run the CUDA sources
    on CPU tensors; yields the emulated library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["gmap_seed_segments", "gmap_chain"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield ctypes.CDLL(so)
    kbuild.launch = launch


def _equal(got, want):
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        assert g_.dtype == w.dtype and torch.equal(g_, w)


@pytest.mark.parametrize("Q,k,thr,H,S,nhits", SEGMENT_CASES, ids=SEGMENT_IDS)
def test_seed_segments_emulated_kernel(emulated, Q, k, thr, H, S, nhits):
    """K9's CUDA source against the plain version on
    synth.seed_segment_cases, at the case's H and S, at H / 2 (at the
    edge case, a row of 2,048 hits in registers with no scratch row) and
    at H / 4, S / 2 (overflowing rows); a launch is counted for each
    call."""
    _, a = _segment_case(Q, k, thr, H, S, nhits)
    before = kbuild.LAUNCHES["gmap_seed_segments"]
    sizes = [(H, S), (max(H // 2, 1), S), (max(H // 4, 1), max(S // 2, 1))]
    for h, s_ in sizes:
        args = (*a, k, h, s_, thr)
        got = teng._seed_segments_cuda(*args)
        want = teng._seed_segments_plain(*args)
        _equal([got[x] for x in teng.SEG_KEYS],
               [want[x] for x in teng.SEG_KEYS])
    assert kbuild.LAUNCHES["gmap_seed_segments"] == before + len(sizes)


def test_seed_segments_emulated_kernel_planted(emulated, world):
    """K9's CUDA source against the plain version on planted reads and
    their reverse complements (repeat copies, indels, junctions) at the
    runner's first H and S, an overflowing pair and the sizes two retries
    leave."""
    rng, g, db, _ = world
    recs, _ = synth.plant_reads(rng, g, 8, weights=dict(
        sub=2, repeat=2, mid_indel=1, junk=0.5))
    srecs, _ = synth.plant_spliced_reads(rng, g, 4)
    seqs = [r.seq for r in recs + srecs]
    seqs += [dna.revcomp_str(x) for x in seqs]
    oligos, valid = _oligos(db, seqs, 128)
    ti = datadir.device_index(db, "cpu")
    for H, S in ((1024, 192), (64, 8), (16384, 3072)):
        args = (ti.offsets, ti.positions, _t(oligos), _t(valid), 12, H, S,
                100)
        got = teng._seed_segments_cuda(*args)
        want = teng._seed_segments_plain(*args)
        _equal([got[x] for x in teng.SEG_KEYS],
               [want[x] for x in teng.SEG_KEYS])


def test_seed_segments_register_edge_matches_entry_point(emulated):
    """K9's entry point takes H up to kernels/limits.py
    seed_segments_register_hits() without a scratch row and refuses the
    next power of two without one (the wrapper passes one there); the
    shared memory it asks for is limits.seed_segments_bytes, the same at
    every H past the edge."""
    lib = emulated
    edge = klimits.seed_segments_register_hits()
    assert lib.gmap_seed_register_hits() == edge
    assert synth.SEED_SEGMENT_CASES[-1][5] == (edge, edge + 1)
    fn = lib.gmap_seed_segments
    p = ctypes.c_void_p
    sig = kbuild._SIGNATURES["gmap_seed_segments"]
    fn.argtypes = [{"p": p, "i": ctypes.c_int32, "l": ctypes.c_int64}[c]
                   for c in sig] + [p]
    # B = 0: the checks alone; Q k H S threshold, noffsets npositions, ws
    call = lambda H, scratch: fn(*[None] * 4, scratch, *[None] * 6, 0, 128,
                                 12, H, 192, 100, 2, 1,
                                 teng.seed_workspace_bytes(H, 192), None)
    assert call(edge, None) == 0
    assert call(2 * edge, None) != 0
    assert call(2 * edge, 1) == 0
    for Q, H, S in ((128, 1024, 192), (128, edge, 192), (128, 16384, 3072),
                    (1, 16, 4), (4096, 65536, 1024)):
        assert (lib.gmap_seed_smem_bytes(Q, H, S)
                == klimits.seed_segments_bytes(Q, H, S))
    assert (klimits.seed_segments_bytes(128, 4 * edge, 192)
            == klimits.seed_segments_bytes(128, 64 * edge, 192))


@pytest.mark.parametrize("S,lvs", CHAIN_CASES)
def test_chain_emulated_kernel(emulated, S, lvs):
    """K10's CUDA source against the plain version on synth.chain_cases
    (lv 0, 31, 32, 33, S - 1; past 1,024 segments the row is read in
    place, not staged), both intron limits, C 192 and 1; a launch is
    counted for each call."""
    case = synth.chain_cases(np.random.default_rng(S + 1), 8, S, lvs)
    a = [_t(case[x]) for x in ("qstart", "qend", "diag", "valid")]
    before = kbuild.LAUNCHES["gmap_chain"]
    runs = ((30, 192), (200_000, 192), (200_000, 1))
    for il, C in runs:
        got = teng._chain_cuda(*a, 12, il, C)
        want = teng._chain_plain(*a, 12, il, C)
        _equal([got[x] for x in teng.CHAIN_KEYS],
               [want[x] for x in teng.CHAIN_KEYS])
    assert kbuild.LAUNCHES["gmap_chain"] == before + len(runs)


def test_gmap_wrappers_refuse_a_non_bool_valid(emulated):
    """K9 and K10 pass ``valid`` as a uint8 view of its bytes: a valid of
    another dtype raises before a launch."""
    case, (offs, pos, oligos, valid) = _segment_case(33, 12, 5, 64, 8, ())
    with pytest.raises(TypeError):
        teng._seed_segments_cuda(offs, pos, oligos, valid.to(torch.uint8),
                                 12, 64, 8, 5)
    seg = teng._seed_segments_plain(offs, pos, oligos, valid, 12, 64, 8, 5)
    with pytest.raises(TypeError):
        teng._chain_cuda(seg["qstart"], seg["qend"], seg["diag"],
                         seg["valid"].int(), 12, 30)
