"""Batched banded affine-gap dynamic programming for GMAP's junctions
(counterpart of gmap_gsnap_tpu/ops/dynprog.py).

The constants, ``pair_matrix``, ``compute_bands`` and
``intron_score_table`` are copied.  The device stages are plain torch
here, computing exactly what the JAX stages compute (integers
throughout, so equal to the bit), with the hand-written CUDA kernels
beside them:

  * K11 ``csrc/banded_gotoh.cu`` — ``banded_matrices`` (:107): the
    band-packed 3-state Gotoh sweep, score[b, r, k] with
    k = c - r + lband;
  * K12 ``csrc/bridge_traceback.cu`` — ``bridge_intron`` (:328, with
    ``dinucl_codes_left/right`` :270/:284) followed by ``traceback``
    (:194) on both sides of the junction, fused: ``bridge_traceback``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``best_endpoint`` (:453) and ``best_endpoint_queryend``
(:487) are not ported: no ported path calls them yet.

Scoring semantics (src/dynprog.c:141-300,1045-1240): FULLMATCH 3;
mismatch by tier; N (code 4) vs ACGT = -1 but N vs N = FULLMATCH; code 5
(past-chromosome '*') scores 0 against everything; gap = open + extend *
length; ties broken by jump_late as the reference's sequential compares
(src/dynprog.c:1520-1557).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build as kbuild

NEG_INF = -1000000  # dynprog.c NEG_INFINITY

# scoring constants (dynprog.c:141-248)
FULLMATCH = 3
MISMATCH_HIGHQ, MISMATCH_MEDQ, MISMATCH_LOWQ, MISMATCH_ENDQ = -3, -2, -1, -5
SINGLE_OPEN, SINGLE_EXTEND = -10, -3
PAIRED_OPEN, PAIRED_EXTEND = -18, -3
END_OPEN, END_EXTEND = -12, -1
CDNA_OPEN, CDNA_EXTEND = -10, -7
CANONICAL_INTRON_HIGHQ = 10
FINAL_CANONICAL_INTRON_HIGHQ = 30
GCAG_INTRON, FINAL_GCAG_INTRON = 15, 20
ATAC_INTRON, FINAL_ATAC_INTRON = 12, 12
KNOWN_SPLICESITE_REWARD = 20
MICROINTRON_LENGTH = 9

# intron dinucleotide bit codes (src/intron.h:10-28)
LEFT_GT, LEFT_GC, LEFT_AT, LEFT_CT = 0x21, 0x10, 0x08, 0x06
RIGHT_AG, RIGHT_AC, RIGHT_GC, RIGHT_AT = 0x30, 0x0C, 0x02, 0x01
GTAG_FWD, GCAG_FWD, ATAC_FWD = 0x20, 0x10, 0x08
GTAG_REV, GCAG_REV, ATAC_REV = 0x04, 0x02, 0x01
NONINTRON = 0x00

# traceback op kinds
OP_NONE, OP_DIAG, OP_HORIZ, OP_VERT = 0, 1, 2, 3

# sequence codes: 0..3 = ACGT, 4 = N, 5 = '*' past-chromosome padding
NCODES = 6

I32 = torch.int32


def pair_matrix(mismatch: int, cmet: bool = False) -> np.ndarray:
    """pairdistance_array semantics for coded sequences
    (dynprog.c:1127-1240 pairdistance_init).  Row = query code, col =
    genome code (the oneway cmet permutes are query-side only)."""
    p = np.full((NCODES, NCODES), mismatch, np.int32)
    for i in range(4):
        p[i, i] = FULLMATCH
    p[4, :5] = -1  # N vs ACGT: AMBIGUOUS
    p[:5, 4] = -1
    p[4, 4] = FULLMATCH  # permute_cases(c,c) includes N==N
    p[5, :] = 0  # '*' never entered pairdistance_array (CALLOC zeros)
    p[:, 5] = 0
    if cmet:
        p[3, 1] = FULLMATCH  # query T matches genome C (oneway)
        p[0, 2] = FULLMATCH  # query A matches genome G
    return p


def compute_bands(len1, len2, extraband: int, widebandp: bool = True):
    """Band widths per problem (compute_scores_lookup_fwd:1442-1454)."""
    len1 = np.asarray(len1, np.int32)
    len2 = np.asarray(len2, np.int32)
    if not widebandp:
        lband = np.full_like(len1, extraband)
        rband = np.full_like(len1, extraband)
    else:
        rband = np.where(len2 >= len1, len2 - len1 + extraband, extraband)
        lband = np.where(len2 >= len1, extraband, len1 - len2 + extraband)
    return lband.astype(np.int32), rband.astype(np.int32)


def intron_score_table(cdna_direction, canonical_reward, finalp,
                       nosplicing: bool = False):
    """(scores int32[64], types int32[64]) tables: introntype bitmask
    -> score and normalized introntype (dynprog.c:3152-3210
    intron_score; types outside the direction's table collapse to
    NONINTRON).  nosplicing (gmap --nosplicing) zeroes every reward."""
    t = np.zeros(64, np.int32)
    ty = np.zeros(64, np.int32)
    if nosplicing:
        return t, ty
    gcag = FINAL_GCAG_INTRON if finalp else GCAG_INTRON
    atac = FINAL_ATAC_INTRON if finalp else ATAC_INTRON
    fwd = {GTAG_FWD: canonical_reward, GCAG_FWD: gcag, ATAC_FWD: atac}
    rev = {GTAG_REV: canonical_reward, GCAG_REV: gcag, ATAC_REV: atac}
    if cdna_direction > 0:
        table = fwd
    elif cdna_direction < 0:
        table = rev
    else:
        table = {**fwd, **rev}
    for typ, sc in table.items():
        t[typ] = sc
        ty[typ] = typ
    return t, ty


def _neg(shape, device) -> torch.Tensor:
    return torch.full(shape, NEG_INF, dtype=torch.int64, device=device)


# ------------------------------------------------------- K11 banded Gotoh

def _banded_matrices_plain(q, g, len1, len2, lband, rband, pairmat,
                           jump_late, M: int, W: int, open_: int,
                           extend: int):
    B, N = g.shape
    dev = q.device
    q, g = q.long(), g.long()
    len1, len2 = len1.long(), len2.long()
    lband, rband = lband.long()[:, None], rband.long()[:, None]
    pm = torch.as_tensor(pairmat, device=dev).long()
    kk = torch.arange(W, device=dev)[None, :]
    bandw = lband + rband
    negc = _neg((B, 1), dev)

    c0 = kk - lband
    nogap = torch.where(c0 == 0, 0, NEG_INF)
    in0 = (c0 >= 1) & (c0 <= torch.minimum(rband, len2[:, None]))
    gap1 = torch.where(in0, open_ + extend * c0, NEG_INF)
    gap2 = _neg((B, W), dev)
    ext_k = extend * kk
    late = jump_late.bool()[:, None]
    outs = [(nogap, gap1, gap2, torch.zeros((B, W), dtype=torch.bool,
                                            device=dev))]
    for r in range(1, M + 1):
        c = r + kk - lband
        incol = (c >= 1) & (c <= len2[:, None])
        valid = incol & (kk <= bandw)
        # vertical: (r-1, c) is band k+1 of the previous row
        nogap_up = torch.cat([nogap[:, 1:], negc], 1)
        gap2_up = torch.cat([gap2[:, 1:], negc], 1)
        g2 = torch.maximum(nogap_up + open_, gap2_up) + extend
        g2 = torch.where(c == 0, open_ + extend * r, g2)
        g2 = torch.where(valid | (c == 0), g2, NEG_INF)
        # diagonal: (r-1, c-1) is band k of the previous row
        best12 = torch.maximum(gap1, gap2)
        diag = torch.maximum(nogap, best12)
        ndiag = torch.where(late, best12 >= nogap, best12 > nogap)
        gc = torch.gather(g, 1, (c - 1).clamp(0, N - 1))
        gc = torch.where(incol, gc, 5)
        ng = torch.where(valid, diag + pm[q[:, r - 1][:, None], gc], NEG_INF)
        # horizontal: exclusive running max within the row
        run = torch.cummax(ng + open_ - ext_k, 1).values
        g1 = torch.where(valid, torch.cat([negc, run[:, :-1]], 1) + ext_k,
                         NEG_INF)
        nogap, gap1, gap2 = ng, g1, g2
        outs.append((ng, g1, g2, ndiag & valid))
    return tuple(torch.stack([o[i] for o in outs], 1).to(I32 if i < 3 else
                                                          torch.bool)
                 for i in range(4))


def _banded_matrices_cuda(q, g, len1, len2, lband, rband, pairmat,
                          jump_late, M: int, W: int, open_: int,
                          extend: int):
    B, N = g.shape
    if W > 32 or q.shape != (B, M):
        raise ValueError(f"banded_gotoh kernel: W={W} must be <= 32 and q "
                         f"{tuple(q.shape)} must be [{B}, {M}]")
    dev = q.device
    i32 = lambda t: t.to(device=dev, dtype=I32).contiguous()
    pm = torch.as_tensor(np.asarray(pairmat, np.int32)).reshape(-1).to(dev)
    nogap, gap1, gap2 = (torch.empty((B, M + 1, W), dtype=I32, device=dev)
                         for _ in range(3))
    ndiag = torch.empty((B, M + 1, W), dtype=torch.bool, device=dev)
    kbuild.launch("gmap_banded_gotoh", dev, i32(q), i32(g), i32(len1),
                  i32(len2), i32(lband), i32(rband), pm,
                  jump_late.to(device=dev, dtype=torch.uint8).contiguous(),
                  nogap, gap1, gap2, ndiag, B, M, N, W, open_, extend)
    return nogap, gap1, gap2, ndiag


def banded_matrices(q, g, len1, len2, lband, rband, pairmat, jump_late,
                    M: int, W: int, open_: int, extend: int):
    """The banded 3-state Gotoh sweep (compute_scores_lookup_fwd
    semantics, src/dynprog.c:1424-1570; kernel K11).

    q int[B, M] query codes (rows); g int[B, N] genome codes (cols);
    len1/len2/lband/rband int[B]; pairmat int[6, 6]; jump_late bool[B].
    Returns (nogap, gap1, gap2) int32[B, M+1, W] band-packed with
    k = c - r + lband, and ndiag bool[B, M+1, W] (nogap direction is
    HORIZ or VERT).  Cells outside the band / sequence are NEG_INF."""
    if q.device.type == "cpu":
        return _banded_matrices_plain(q, g, len1, len2, lband, rband,
                                      pairmat, jump_late, M, W, open_, extend)
    if q.device.type == "cuda":
        return _banded_matrices_cuda(q, g, len1, len2, lband, rband,
                                     pairmat, jump_late, M, W, open_, extend)
    raise ValueError(f"unsupported device {q.device}")


# -------------------------------------------- K12 bridge + traceback

def _cell(arr, r, k, W: int):
    """arr[b, r, k] with out-of-band k -> NEG_INF."""
    B, M1, _ = arr.shape
    flat = arr.reshape(B, M1 * W).long()
    idx = r.clamp(0, M1 - 1) * W + k.clamp(0, W - 1)
    v = torch.gather(flat, 1, idx[:, None])[:, 0]
    return torch.where((k >= 0) & (k < W) & (r >= 0) & (r < M1), v, NEG_INF)


def traceback(nogap, gap1, gap2, r0, c0, lband, jump_late,
              T: int, W: int, open_: int, extend: int):
    """Batched traceback state machine (src/dynprog.c:2612-2715), plain
    torch.  Starts at (r0, c0) in state nogap; emits up to T ops in
    reverse (end -> start) order.  Returns ops int8[B, T] (OP_*),
    opr/opc int32[B, T]: for OP_DIAG the (query row-1, genome col-1)
    pair, for OP_HORIZ the skipped genome col-1, for OP_VERT the skipped
    query row-1.  Directions are recomputed from the matrices with the
    reference's sequential tie rules."""
    late = jump_late.bool()
    S_NOGAP, S_GAP1, S_GAP2, S_DONE = 0, 1, 2, 3
    r, c = r0.long(), c0.long()
    lband = lband.long()
    state = torch.zeros_like(r)

    def ge(a, b):
        return torch.where(late, a >= b, a > b)

    ops, oprs, opcs = [], [], []
    for _ in range(T):
        k = c - r + lband
        at_origin = (r <= 0) & (c <= 0)
        done = (state == S_DONE) | ((state == S_NOGAP) & ((r <= 0) | (c <= 0)))
        ng = _cell(nogap, r - 1, k, W)
        g1 = _cell(gap1, r - 1, k, W)
        g2 = _cell(gap2, r - 1, k, W)
        takeh = ge(g1, ng)
        takev = ge(g2, torch.maximum(ng, g1))
        ng_next = torch.where(takev, S_GAP2, torch.where(takeh, S_GAP1,
                                                         S_NOGAP))
        h_horiz = ge(_cell(gap1, r, k - 1, W),
                     _cell(nogap, r, k - 1, W) + open_) & (r > 0) & (c > 1)
        h_horiz = torch.where(r == 0, c > 1, h_horiz)
        g1_next = torch.where(h_horiz, S_GAP1, S_NOGAP)
        v_vert = ge(_cell(gap2, r - 1, k + 1, W),
                    _cell(nogap, r - 1, k + 1, W) + open_) & (c > 0) & (r > 1)
        v_vert = torch.where(c == 0, r > 1, v_vert)
        g2_next = torch.where(v_vert, S_GAP2, S_NOGAP)
        ops.append(torch.where(
            done, OP_NONE,
            torch.where(state == S_NOGAP, OP_DIAG,
                        torch.where(state == S_GAP1, OP_HORIZ, OP_VERT))))
        oprs.append(torch.where(state == S_GAP1, r, r - 1))
        opcs.append(torch.where(state == S_GAP2, c, c - 1))
        nr = torch.where(done | (state == S_GAP1), r, r - 1)
        nc = torch.where(done | (state == S_GAP2), c, c - 1)
        state = torch.where(
            done | at_origin, S_DONE,
            torch.where(state == S_NOGAP, ng_next,
                        torch.where(state == S_GAP1, g1_next, g2_next)))
        r, c = nr, nc
    return (torch.stack(ops, 1).to(torch.int8), torch.stack(oprs, 1).to(I32),
            torch.stack(opcs, 1).to(I32))


def dinucl_codes_left(gseq):
    """leftdi per column cL (0-based genome index): dinucleotide at
    (cL, cL+1) -> LEFT_* bitmask (bridge_intron_gap:3330-3350).
    gseq int[B, N] -> int32[B, N+1] indexed by cL in 0..N."""
    a = gseq.long()
    b = torch.cat([a[:, 1:], torch.full_like(a[:, :1], 5)], 1)
    code = torch.zeros_like(a)
    code = torch.where((a == 2) & (b == 3), LEFT_GT, code)   # GT
    code = torch.where((a == 2) & (b == 1), LEFT_GC, code)   # GC
    code = torch.where((a == 0) & (b == 3), LEFT_AT, code)   # AT
    code = torch.where((a == 1) & (b == 3), LEFT_CT, code)   # CT
    return torch.cat([code, torch.zeros_like(code[:, :1])], 1).to(I32)


def dinucl_codes_right(grev):
    """rightdi per column cR of the REVERSED right genome region:
    right2 = g[revoffset - cR - 1], right1 = g[revoffset - cR], i.e.
    in the reversed array: right1 = grev[cR], right2 = grev[cR + 1]."""
    r1 = grev.long()
    r2 = torch.cat([r1[:, 1:], torch.full_like(r1[:, :1], 5)], 1)
    code = torch.zeros_like(r1)
    code = torch.where((r2 == 0) & (r1 == 2), RIGHT_AG, code)  # AG
    code = torch.where((r2 == 0) & (r1 == 1), RIGHT_AC, code)  # AC
    code = torch.where((r2 == 2) & (r1 == 1), RIGHT_GC, code)  # GC
    code = torch.where((r2 == 0) & (r1 == 3), RIGHT_AT, code)  # AT
    return torch.cat([code, torch.zeros_like(code[:, :1])], 1).to(I32)


def bridge_intron(nogapL, ndiagL, nogapR, ndiagR, len1, len2L, len2R,
                  lbandL, lbandR, leftdi, rightdi, left_known, right_known,
                  leftoffset, rightoffset, M: int, W: int,
                  canonical_reward: int, cdna_direction: int, finalp: bool,
                  halfp: bool, nosplicing: bool = False):
    """bridge_intron_gap, novel-splicing branch (dynprog.c:3701-3830),
    plain torch.

    For each rL in 1..len1-1 (rR = len1-rL) score
      scoreL(rL,cL) + intron(leftdi[cL] & rightdi[cR]) + scoreR(rR,cR)
    over two candidate families — cL in band with cR = rR pinned, then
    cR in band with cL = rL pinned — and take the best with the
    reference's strict-'>' first-wins order.  left/right_known are
    KNOWN_SPLICESITE_REWARD vectors indexed by genome column.

    Returns (finalscore, bestrL, bestrR, bestcL, bestcR, introntype)."""
    B = nogapL.shape[0]
    dev = nogapL.device
    itab_np, ttab_np = intron_score_table(
        cdna_direction, canonical_reward, finalp, nosplicing)
    itab = torch.from_numpy(itab_np).long().to(dev)
    ttab = torch.from_numpy(ttab_np).long().to(dev)
    len1, len2L, len2R = len1.long(), len2L.long(), len2R.long()
    lbandL, lbandR = lbandL.long(), lbandR.long()

    rL = torch.arange(1, M + 1, device=dev)[None, :].expand(B, M)
    rR = len1[:, None] - rL
    rok = (rL >= 1) & (rL <= len1[:, None] - 1)
    kk = torch.arange(W, device=dev)[None, None, :]

    def rows(tab, r):   # tab[b, r[b, m], :] -> [B, M, W]
        rc = r.clamp(0, tab.shape[1] - 1)
        return torch.gather(tab, 1, rc[:, :, None].expand(B, M, W)).long()

    def cols(tab, c):   # tab[b, c[b, ...]] with c clipped to the table
        tab = tab.long()
        cc = c.clamp(0, tab.shape[1] - 1)
        flat = torch.gather(tab, 1, cc.reshape(B, -1))
        return flat.reshape(cc.shape)

    ngL, ndL = rows(nogapL, rL), rows(ndiagL, rL)
    ngR, ndR = rows(nogapR, rR), rows(ndiagR, rR)
    cL_band = rL[:, :, None] + kk - lbandL[:, None, None]
    cR_band = rR[:, :, None] + kk - lbandR[:, None, None]
    okL = (cL_band >= 1) & (cL_band <= len2L[:, None, None] - 1)
    okR = (cR_band >= 1) & (cR_band <= len2R[:, None, None] - 1)
    # dinucleotides past len2-2 are zeroed (bridge_intron_gap:3352)
    ldi_band = torch.where(cL_band <= len2L[:, None, None] - 2,
                           cols(leftdi, cL_band), 0)
    rdi_band = torch.where(cR_band <= len2R[:, None, None] - 2,
                           cols(rightdi, cR_band), 0)
    lkn_band = cols(left_known, cL_band)
    rkn_band = cols(right_known, cR_band)

    def pin(ng, lb):
        return torch.gather(ng, 2, lb[:, None, None].expand(B, M, 1))[:, :, 0]

    sep = (rightoffset.long() - leftoffset.long())[:, None, None]
    # family A: cL varies ("indel on left"), cR pinned at rR.  The -1
    # gap-avoidance applies to the varying side only (dynprog.c:3727)
    rdi_pin = torch.where(rR <= len2R[:, None] - 2, cols(rightdi, rR), 0)
    scR_pin = pin(ngR, lbandR) + cols(right_known, rR)
    okR_pin = (rR >= 1) & (rR <= len2R[:, None] - 1)
    okA = (okL & okR_pin[:, :, None] & rok[:, :, None]
           & (rR[:, :, None] < sep - cL_band))
    itypA = ldi_band & rdi_pin[:, :, None]
    scoreA = torch.where(okA, ngL + lkn_band - ndL + itab[itypA]
                         + scR_pin[:, :, None], NEG_INF)
    # family B: cR varies ("indel on right"), cL pinned at rL
    ldi_pin = torch.where(rL <= len2L[:, None] - 2, cols(leftdi, rL), 0)
    scL_pin = pin(ngL, lbandL) + cols(left_known, rL)
    okL_pin = (rL >= 1) & (rL <= len2L[:, None] - 1)
    okB = (okR & okL_pin[:, :, None] & rok[:, :, None]
           & (rL[:, :, None] < sep - cR_band))
    itypB = ldi_pin[:, :, None] & rdi_band
    scoreB = torch.where(okB, scL_pin[:, :, None] + itab[itypB] + ngR
                         + rkn_band - ndR, NEG_INF)

    # linear order per rL: family A block then family B block ->
    # first-max argmax replicates the reference's strict '>' updates
    candf = torch.cat([scoreA, scoreB], 2).reshape(B, -1)
    ityp = torch.cat([itypA, itypB], 2).reshape(B, -1)
    bestscore = candf.max(1).values
    best = torch.argmax((candf == bestscore[:, None]).to(torch.uint8), 1)
    brow = best // (2 * W)
    bcol = best % (2 * W)
    in_b = bcol >= W
    bk = torch.where(in_b, bcol - W, bcol)
    bestrL = brow + 1
    bestrR = len1 - bestrL
    bestcL = torch.where(in_b, bestrL, bestrL + bk - lbandL)
    bestcR = torch.where(in_b, bestrR + bk - lbandR, bestrR)
    ityp_best = torch.gather(ityp, 1, best[:, None])[:, 0]
    besti = itab[ityp_best]
    finalscore = bestscore - torch.div(besti, 2, rounding_mode="floor") \
        if halfp else bestscore
    return tuple(x.to(I32) for x in (finalscore, bestrL, bestrR, bestcL,
                                     bestcR, ttab[ityp_best]))


def _bridge_traceback_plain(mats, len1, len2L, len2R, lbandL, lbandR, gl,
                            grv, left_known, right_known, leftoffset,
                            rightoffset, M, W, T, open_, extend,
                            canonical_reward, cdna_direction, finalp, halfp,
                            nosplicing):
    nogap, gap1, gap2, ndiag = mats
    nb = len1.shape[0]
    L, R = slice(0, nb), slice(nb, 2 * nb)
    fs, brL, brR, bcL, bcR, ityp = bridge_intron(
        nogap[L], ndiag[L], nogap[R], ndiag[R], len1, len2L, len2R, lbandL,
        lbandR, dinucl_codes_left(gl), dinucl_codes_right(grv), left_known,
        right_known, leftoffset, rightoffset, M, W, canonical_reward,
        cdna_direction, finalp, halfp, nosplicing)
    dev = nogap.device
    early = torch.zeros(nb, dtype=torch.bool, device=dev)
    tbL = traceback(nogap[L], gap1[L], gap2[L], brL, bcL, lbandL, early,
                    T, W, open_, extend)
    tbR = traceback(nogap[R], gap1[R], gap2[R], brR, bcR, lbandR, ~early,
                    T, W, open_, extend)
    return (fs, ityp, *tbL, *tbR)


def _bridge_traceback_cuda(mats, len1, len2L, len2R, lbandL, lbandR, gl,
                           grv, left_known, right_known, leftoffset,
                           rightoffset, M, W, T, open_, extend,
                           canonical_reward, cdna_direction, finalp, halfp,
                           nosplicing):
    nogap, gap1, gap2, ndiag = mats
    nb = len1.shape[0]
    NL, NR = gl.shape[1], grv.shape[1]
    if nogap.shape != (2 * nb, M + 1, W) or W > 32:
        raise ValueError(f"bridge_traceback kernel: matrices "
                         f"{tuple(nogap.shape)} must be [{2 * nb}, {M + 1}, "
                         f"{W}] with W <= 32")
    if left_known.shape != (nb, NL + 1) or right_known.shape != (nb, NR + 1):
        raise ValueError("bridge_traceback kernel: known-site tables must be "
                         "[nb, N + 1]")
    dev = nogap.device
    i32 = lambda t: t.to(device=dev, dtype=I32).contiguous()
    itab, ttab = intron_score_table(cdna_direction, canonical_reward, finalp,
                                    nosplicing)
    tabs = torch.from_numpy(np.concatenate([itab, ttab])).to(dev)
    fs = torch.empty(nb, dtype=I32, device=dev)
    ityp = torch.empty(nb, dtype=I32, device=dev)
    ops = torch.empty((2, nb, T), dtype=torch.int8, device=dev)
    opr = torch.empty((2, nb, T), dtype=I32, device=dev)
    opc = torch.empty((2, nb, T), dtype=I32, device=dev)
    kbuild.launch("gmap_bridge_traceback", dev, nogap.contiguous(),
                  gap1.contiguous(), gap2.contiguous(), ndiag.contiguous(),
                  i32(len1), i32(len2L), i32(len2R), i32(lbandL), i32(lbandR),
                  i32(gl), i32(grv), i32(left_known), i32(right_known),
                  i32(leftoffset), i32(rightoffset), tabs, fs, ityp, ops, opr,
                  opc, nb, M, W, NL, NR, T, open_, int(halfp))
    return fs, ityp, ops[0], opr[0], opc[0], ops[1], opr[1], opc[1]


def bridge_traceback(mats, len1, len2L, len2R, lbandL, lbandR, gl, grv,
                     left_known, right_known, leftoffset, rightoffset,
                     M: int, W: int, T: int, open_: int, extend: int,
                     canonical_reward: int, cdna_direction: int,
                     finalp: bool, halfp: bool, nosplicing: bool = False):
    """The junction search and both tracebacks (kernel K12): ``mats`` is
    banded_matrices over 2*nb stacked problems (the nb left sides, then
    the nb reversed right sides, which jump late); ``gl``/``grv`` are the
    left and reversed right genome codes int[nb, N], whose dinucleotide
    codes the junction search reads.  Equal to bridge_intron followed by
    traceback from (bestrL, bestcL) on the left (jump early) and from
    (bestrR, bestcR) on the right (jump late).

    Returns (finalscore, introntype) int32[nb] and, per side, ops
    int8[nb, T], opr/opc int32[nb, T]."""
    args = (mats, len1, len2L, len2R, lbandL, lbandR, gl, grv, left_known,
            right_known, leftoffset, rightoffset, M, W, T, open_, extend,
            canonical_reward, cdna_direction, finalp, halfp, nosplicing)
    dev = mats[0].device
    if dev.type == "cpu":
        return _bridge_traceback_plain(*args)
    if dev.type == "cuda":
        return _bridge_traceback_cuda(*args)
    raise ValueError(f"unsupported device {dev}")
