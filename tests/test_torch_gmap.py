"""Port parity for the GMAP engine (plain-torch paths on the CPU) against
the JAX package, exact: the junction dynprog (``ops/dynprog``: the band
sweep, the junction search, the traceback, and
``solve_junctions_batch`` on requests cut from a synthetic genome), the
seeding/segment and chain stages (``align/gmap_engine``, forced
overflow, repeat rows, a chain longer than the backtrack, and the edge
rows of ``synth.seed_segment_cases`` / ``synth.chain_cases``), and
``align_cdna_batch`` end to end (same exons, direction and intron
types).  Where g++ is present, K9 and K10's CUDA sources run through
``tools/cuda_emu`` (a CPU emulation) against the plain versions on the
same edges."""

import ctypes
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gmap_gsnap_tpu.align import gmap as jgmap
from gmap_gsnap_tpu.align import gmap_engine as jeng
from gmap_gsnap_tpu.ops import dynprog as jdp
from gmap_gsnap_tpu_torch.align import gmap as tgmap
from gmap_gsnap_tpu_torch.align import gmap_engine as teng
from gmap_gsnap_tpu_torch.db import datadir
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.kernels import limits as klimits
from gmap_gsnap_tpu_torch.ops import dynprog as tdp
from gmap_gsnap_tpu_torch.utils import dna, synth
from torch_parity import jax_db

M, W = 64, 23
NL = M + 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(j, t):
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())


def _problems(rng, nb, pad_code5):
    """Random junction-window problems: queries copy the genome with
    noise, some with code-5 padding past their length."""
    q = rng.integers(0, 5, (nb, M)).astype(np.int32)
    g = rng.integers(0, 5 if pad_code5 else 4, (nb, NL)).astype(np.int32)
    g[:, :M] = np.where(rng.random((nb, M)) < 0.8, q, g[:, :M])
    len1 = rng.integers(2, M + 1, nb).astype(np.int32)
    if pad_code5:
        q[np.arange(M)[None, :] >= len1[:, None]] = 5
        g[:, -3:] = 5
    return q, g, len1, (len1 + 8).astype(np.int32)


@pytest.mark.parametrize("tier", ["paired", "single"])
@pytest.mark.parametrize("pad_code5", [False, True])
def test_dynprog_matches_jax(tier, pad_code5):
    """banded_matrices, bridge_intron (all cdna_direction tables, halfp,
    nosplicing, known-site rewards) and traceback, jump_late both ways."""
    rng = np.random.default_rng(3 + pad_code5)
    nb = 24
    q, g, len1, len2 = _problems(rng, nb, pad_code5)
    lband, rband = jdp.compute_bands(len1, len2, 7)
    pm = jdp.pair_matrix(jdp.MISMATCH_HIGHQ)
    late = rng.random(nb) < 0.5
    open_, ext = ((jdp.PAIRED_OPEN, jdp.PAIRED_EXTEND) if tier == "paired"
                  else (jdp.SINGLE_OPEN, jdp.SINGLE_EXTEND))
    jm = jdp.banded_matrices(jnp.asarray(q), jnp.asarray(g), len1, len2, lband,
                             rband, pm, late, M=M, W=W, open_=open_,
                             extend=ext)
    tm = tdp.banded_matrices(_t(q), _t(g), _t(len1), _t(len2), _t(lband),
                             _t(rband), pm, _t(late), M, W, open_, ext)
    _same(jm, tm)

    h = nb // 2                    # problems [:h] left, [h:] right sides
    jl, jr = jdp.dinucl_codes_left(jnp.asarray(g[:h]), NL), \
        jdp.dinucl_codes_right(jnp.asarray(g[h:]), NL)
    tl, tr = tdp.dinucl_codes_left(_t(g[:h])), tdp.dinucl_codes_right(_t(g[h:]))
    _same((jl, jr), (tl, tr))
    known = (rng.integers(0, 2, (h, NL + 1)) * 20).astype(np.int32)
    zero = np.zeros((h, NL + 1), np.int32)
    loff = rng.integers(0, 1000, h).astype(np.int32)
    roff = (loff + rng.integers(0, 200, h)).astype(np.int32)
    for cd, halfp, nospl, lk in ((1, False, False, zero), (-1, True, False,
                                                             known),
                                 (0, False, False, zero), (1, False, True,
                                                           zero)):
        jb = jdp.bridge_intron(
            jm[0][:h], jm[3][:h], jm[0][h:], jm[3][h:], jnp.asarray(len1[:h]),
            jnp.asarray(len2[:h]), jnp.asarray(len2[h:]),
            jnp.asarray(lband[:h]), jnp.asarray(lband[h:]), jl, jr,
            jnp.asarray(lk), jnp.asarray(lk),
            jnp.asarray(loff), jnp.asarray(roff), M=M, W=W, open_=open_,
            extend=ext, canonical_reward=30, cdna_direction=cd, finalp=True,
            halfp=halfp, nosplicing=nospl)
        tb = tdp.bridge_intron(
            tm[0][:h], tm[3][:h], tm[0][h:], tm[3][h:], _t(len1[:h]),
            _t(len2[:h]), _t(len2[h:]), _t(lband[:h]), _t(lband[h:]), tl, tr,
            _t(lk), _t(lk), _t(loff), _t(roff), M, W, 30, cd, True,
            halfp, nospl)
        _same(jb, tb)
        T = M + NL + 2
        for side, r0, c0 in ((slice(0, h), 1, 3), (slice(h, nb), 2, 4)):
            jt = jdp.traceback(jm[0][side], jm[1][side], jm[2][side],
                               jb[r0].astype(jnp.int32),
                               jb[c0].astype(jnp.int32),
                               jnp.asarray(lband[side]), late[side], T=T, W=W,
                               open_=open_, extend=ext)
            tt = tdp.traceback(tm[0][side], tm[1][side], tm[2][side], tb[r0],
                               tb[c0], _t(lband[side]), _t(late[side]), T, W,
                               open_, ext)
            _same(jt, tt)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    return rng, g, db, jax_db(db)


def test_solve_junctions_batch_matches_jax(world):
    """Junction windows cut from the genome around planted introns, with
    mismatches and small indels inside the window; both gap tiers (the
    batch's widest window picks them) and all three directions."""
    rng, g, db, _ = world
    gcodes = db.codes
    reqs = []
    for _ in range(40):
        dL = int(rng.integers(1000, len(gcodes) - 30_000))
        dR = dL + int(rng.integers(9, 20_000))
        qlen = 100
        split = int(rng.integers(30, 70))
        q = np.concatenate([gcodes[dL : dL + split],
                            gcodes[dR + split : dR + qlen]]).copy()
        for p in rng.integers(split - 8, split + 8, int(rng.integers(0, 4))):
            q[p] = (q[p] + 1) % 4
        if rng.random() < 0.3:
            at = int(rng.integers(split - 6, split + 6))
            q = np.delete(q, at) if rng.random() < 0.5 else np.insert(q, at, 2)
        lo = max(0, split - 11 - int(rng.integers(0, 3)))
        reqs.append((q.astype(np.uint8), lo, split + 11, dL, dR))
    wide = reqs[:5] + [(reqs[5][0], 10, 70, reqs[5][3], reqs[5][4])]
    for batch in (reqs, wide):
        for direction in (1, -1, 0):
            j = jeng.solve_junctions_batch(gcodes, batch, direction)
            t = teng.solve_junctions_batch(gcodes, batch, direction,
                                            device="cpu")
            assert t == j
            assert sum(x is not None for x in t) > 0


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


@pytest.mark.parametrize("H,S", [(1024, 192), (64, 8), (128, 512)])
def test_seed_and_chain_match_jax(world, H, S):
    """seed_segments_device, chain_scores_device and
    chain_backtrack_device against the port's seed_segments and chain,
    every output; (64, 8) overflows hits and segments, (128, 512) gives
    segment arrays narrower than S; rows include repeat copies."""
    rng, g, db, jdb = world
    recs, _ = synth.plant_reads(rng, g, 24, weights=dict(
        sub=2, repeat=2, mid_indel=1, junk=0.5))
    srecs, _ = synth.plant_spliced_reads(rng, g, 8)
    seqs = [r.seq for r in recs + srecs]
    seqs += [dna.revcomp_str(s) for s in seqs]
    Q = 128
    oligos, valid = _oligos(db, seqs, Q)
    ji = jdb.device_index
    js = jeng.seed_segments_device(ji.offsets, ji.positions,
                                   jnp.asarray(oligos), jnp.asarray(valid),
                                   k=12, H=H, S=S, threshold=100)
    ti = datadir.device_index(db, "cpu")
    ts = teng.seed_segments(ti.offsets, ti.positions, _t(oligos), _t(valid),
                            12, H, S, 100)
    _same([js[k] for k in teng.SEG_KEYS], [ts[k] for k in teng.SEG_KEYS])
    if H == 64:
        assert (ts["nhits"] > H).any() and (ts["nsegs"] > S).any()
    for il in (30, 200_000):
        jsc, jpr = jeng.chain_scores_device(js["qstart"], js["qend"],
                                            js["diag"], js["valid"], k=12,
                                            max_intronlen=il)
        jb = jeng.chain_backtrack_device(js["qstart"], js["qend"], js["diag"],
                                         js["valid"], jsc, jpr)
        tc = teng.chain(ts["qstart"], ts["qend"], ts["diag"], ts["valid"], 12,
                        il)
        _same((jsc, jpr, *jb), [tc[k] for k in teng.CHAIN_KEYS])


def _deep_query(rng, g, pieces=222, piece=18):
    """A cDNA-like query of ``pieces`` genome pieces, each followed by a
    1 nt deletion: one chain of more than the backtrack's 192 members."""
    p = int(rng.integers(10_000, 100_000))
    out = []
    for _ in range(pieces):
        out.append(g.ascii[p : p + piece])
        p += piece + 1
    return np.concatenate(out).tobytes().decode()


def test_align_cdna_batch_matches_jax(world):
    """align_cdna_batch Paths (exons with their match counts, strand,
    cDNA direction, intron types) equal JAX's on spliced reads (with
    messy junctions, so the junction dynprog runs), end indels, junk
    ends, random reads, repeat reads and a query whose chain is deeper
    than the device backtrack; then again from a forced overflow."""
    rng, g, db, jdb = world
    srecs, _ = synth.plant_spliced_reads(rng, g, 60, weights=dict(
        junction=1, messy_junction=2, shortexon=0.5, unspliced=0.5))
    recs, _ = synth.plant_reads(rng, g, 30, weights=dict(
        end_indel=1, terminal=1, junk=1, repeat=1))
    queries = [r.seq for r in srecs + recs]
    seen = {"dynprog": 0, "deep": 0}
    finish, cfd = teng.solve_junctions_finish, teng.chains_from_device

    def spy_finish(d):
        out = finish(d)
        seen["dynprog"] += sum(x is not None for x in out)
        return out

    def spy_cfd(*a):
        seen["deep"] += 1
        return cfd(*a)

    teng.solve_junctions_finish, teng.chains_from_device = spy_finish, spy_cfd
    try:
        for il, qs in ((200_000, queries), (30, queries[:40]),
                       (200_000, [_deep_query(rng, g)])):
            jp = jgmap.align_cdna_batch(jdb, qs, max_intronlen=il,
                                        extend_ends=True)
            tp = tgmap.align_cdna_batch(db, qs, max_intronlen=il,
                                        extend_ends=True, device="cpu")
            assert [_path(p) for p in tp] == [_path(p) for p in jp]
        assert seen["dynprog"] > 0 and seen["deep"] > 0, seen
        # a forced hit/segment overflow re-runs the seeding, same paths
        jgmap._HS_STICKY.clear()
        tgmap._HS_STICKY.clear()
        jgmap._HS_STICKY[(128, 32)] = (64, 8)
        tgmap._HS_STICKY[128] = (64, 8)
        jp = jgmap.align_cdna_batch(jdb, queries[:12], max_intronlen=200_000,
                                    extend_ends=True)
        tp = tgmap.align_cdna_batch(db, queries[:12], max_intronlen=200_000,
                                    extend_ends=True, device="cpu")
        assert [_path(p) for p in tp] == [_path(p) for p in jp]
        assert tgmap._HS_STICKY[128] != (64, 8)
    finally:
        teng.solve_junctions_finish, teng.chains_from_device = finish, cfd
        jgmap._HS_STICKY.clear()
        tgmap._HS_STICKY.clear()


def _path(p):
    if p is None:
        return None
    return (p.watsonp, p.cdna_direction, tuple(p.intron_types),
            p.querylength,
            tuple((e.qstart, e.qend, e.gstart, e.gend, e.matches,
                   e.mismatches) for e in p.exons))


class _Asked(Exception):
    """Raised by a stand-in for the device index: carries the device the
    entry point asked for."""


def _junction_requests(rng, gcodes, n=6):
    reqs = []
    for _ in range(n):
        dL = int(rng.integers(1000, len(gcodes) - 30_000))
        dR = dL + int(rng.integers(9, 20_000))
        split = int(rng.integers(30, 70))
        q = np.concatenate([gcodes[dL : dL + split],
                            gcodes[dR + split : dR + 100]])
        reqs.append((q.astype(np.uint8), split - 11, split + 11, dL, dR))
    return reqs


@pytest.mark.parametrize("entry", ["align_cdna", "align_cdna_batch",
                                   "solve_junctions_batch",
                                   "solve_junctions_dispatch"])
def test_gmap_entry_points_default_to_the_card(world, monkeypatch, entry):
    """Called without ``device``, each GMAP engine entry point asks for
    CUDA (here, without a card, the request raises; with
    device="cpu" the same call runs)."""
    rng, g, db, _ = world
    if entry.startswith("align_cdna"):
        def stand_in(db_, device):
            raise _Asked(device)

        monkeypatch.setattr(tgmap.datadir, "device_index", stand_in)
        query = synth.plant_reads(rng, g, 1)[0][0].seq
        fn = getattr(tgmap, entry)
        arg = query if entry == "align_cdna" else [query]
        with pytest.raises(_Asked) as asked:
            fn(db, arg, max_intronlen=200_000, extend_ends=True)
        assert torch.device(asked.value.args[0]).type == "cuda"
        with pytest.raises(_Asked) as asked:
            fn(db, arg, max_intronlen=200_000, extend_ends=True, device="cpu")
        assert torch.device(asked.value.args[0]).type == "cpu"
        return
    reqs = _junction_requests(rng, db.codes)
    fn = getattr(teng, entry)
    if torch.cuda.is_available():
        before = teng.dp.kbuild.LAUNCHES["gmap_bridge_traceback"]
        fn(db.codes, reqs, 1)
        assert teng.dp.kbuild.LAUNCHES["gmap_bridge_traceback"] == before + 1
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            fn(db.codes, reqs, 1)
    out = fn(db.codes, reqs, 1, device="cpu")
    if entry == "solve_junctions_dispatch":
        out = teng.solve_junctions_finish(out)
    assert sum(x is not None for x in out) > 0


# --------------------------------------- K9 and K10 on their edges, emulated

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
