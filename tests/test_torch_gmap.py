"""Port parity for the GMAP engine (plain-torch paths on the CPU) against
the JAX package, exact: the junction dynprog (``ops/dynprog``: the band
sweep, the junction search, the traceback, and
``solve_junctions_batch`` on requests cut from a synthetic genome), the
seeding/segment and chain stages (``align/gmap_engine``, forced
overflow, repeat rows, a chain longer than the backtrack), and
``align_cdna_batch`` end to end (same exons, direction and intron
types)."""

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
            t = teng.solve_junctions_batch(gcodes, batch, direction)
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
                                        extend_ends=True)
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
                                    extend_ends=True)
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
