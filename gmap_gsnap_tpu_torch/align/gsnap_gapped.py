"""GSNAP gapped single-end pipeline (counterpart of
gmap_gsnap_tpu/align/gsnap_gapped.py): substitutions, middle indels and,
with ``novelsplicing`` (``-N 1``), novel local splices and short-exon
doublesplices; end trims, the lane-noop gate and ranking.

Holds eight kernels, each with its plain torch version beside it:
K4 :func:`solve_indels` (the JAX package's _solve_indels), K5
:func:`solve_splices` (_solve_splices), K6 :func:`select_triples`
(_select_triples), K7 :func:`solve_doublesplices`
(_solve_doublesplices), K13 :func:`lane_features` (_trim_ends_device,
_lane_features and _bitpack_mask), K14 :func:`rank_hits` (rank_hits,
with the SE overflow gate and _lane_noop_device as an epilogue in
:func:`align_batch_gapped`) and K16 :func:`select_pairs`
(_select_pairs); K15 (_qpos_ranges) is in gsnap_se.  The candidate
assembly between them is plain torch on the device.  Known splice
sites (``known``, gsnap ``-s``: four
genome-length bitvectors from db/splicesites.device_bitmasks) are
candidates of K5 and K7 whatever their dinucleotides and score
probability 1.0; with ``-s`` and without ``-N 1`` the solvers run with
``novel=False``, where only known sites are candidates.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import build as kbuild
from ..kernels import limits as klimits
from ..ops import genome as genome_ops
from ..ops import maxent
from ..ops import mismatch as mm_ops
from ..ops.genome import MASK32
from .gsnap_se import (
    BIG_NMM,
    INVALID_DIAG,
    GsnapParams,
    IndexArrays,
    _MODE_CONV,
    _convert_codes,
    auto_budget,
    pack_batch,
    qpos_ranges,
    seed_diagonals,
    top_diagonals,
)

KIND_SUB = 0
KIND_INS = 1
KIND_DEL = 2
KIND_SPLICE = 3
KIND_SHORTEXON = 4

BIG_SCORE = 10**6

@dataclass(frozen=True)
class GappedParams:
    """Field-for-field copy of gmap_gsnap_tpu.align.gsnap_gapped.GappedParams."""

    base: GsnapParams = GsnapParams()
    indel_pairs: int = 16
    splice_pairs: int = 16
    shortexon_triples: int = 8
    novelsplicing: bool = False


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 difference of uint32 values -> the int32 JAX gets from
    ``(a - b).astype(int32)`` on uint32 (wraparound included)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).int()


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, NC, ...] at idx [B, P] -> [B, P, ...]."""
    if a.dim() == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def _at(a: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """a [B, K, M] at per-(b, k) column col [B, K] -> [B, K]."""
    return torch.gather(a, 2, col.long()[:, :, None])[:, :, 0]


# ------------------------------------------------------------- mismatch scans

def _prefix_mm(genome, queries, diags, lengths, conversion, alt):
    """(mm bool[B, NC, L], pref int32[B, NC, L+1]) — kernel K3."""
    return mm_ops.prefix_mismatches(genome, queries, diags, lengths,
                                    conversion, alt)


def _trim_ends_device(mm, lengths, trim_mm_score: int):
    """trim_left_end + trim_right_end (substring.c) over [B, K, L]
    mismatch matrices, in the closed form of the JAX package (a
    zero-clamped Kadane state from one cumsum and running max/min).
    Returns (t5, t3) int32[B, K]."""
    B, K, L = mm.shape
    dev = mm.device
    La = lengths.long()[:, None]                          # [B, 1]
    active = torch.arange(L, device=dev)[None, None, :] < La[:, :, None]
    v = torch.where(active, torch.where(mm, trim_mm_score, 1), 0)
    P = torch.cat([torch.zeros((B, K, 1), dtype=torch.int64, device=dev),
                   torch.cumsum(v, 2)], 2)                # [B, K, L+1]
    NEG = -(2**30)
    T = torch.cummax(P.flip(2), 2).values.flip(2)         # suffix max
    Tpad = torch.cat([T, torch.full((B, K, 1), NEG, device=dev)], 2)
    sig5 = (Tpad[:, :, 2:] - P[:, :, 1:]).clamp(min=0)
    cand5 = torch.where(mm & active, sig5, NEG)
    best5 = cand5.max(2).values
    p5 = torch.argmax(cand5, 2)                           # first max
    sfin5 = T[:, :, 1].clamp(min=0)
    t5 = torch.where(sfin5 >= best5, 0, p5 + 1)

    Cm = torch.cummin(P, 2).values
    Cpad = torch.cat([torch.full((B, K, 1), 2**30, device=dev), Cm], 2)
    sig3 = (P[:, :, :L] - Cpad[:, :, :L]).clamp(min=0)
    cand3 = torch.where(mm & active, sig3, NEG)
    best3 = cand3.max(2).values
    p3 = (L - 1) - torch.argmax(cand3.flip(2), 2)         # last max
    sfin3 = (P[:, :, L] - Cm[:, :, L - 1]).clamp(min=0)
    t3 = torch.where(sfin3 >= best3, 0, La - p3)
    return t5.int(), t3.int()


def _lane_features_plain(mm, pref, lengths, k: int, interval: int,
                         trim_mm_score: int):
    """Per-candidate features for the device lane-noop gate (the host
    rescue lanes' entry/acceptance tests).  The JAX package's mask
    matmuls are prefix-sum lookups here: #mismatches below a position
    is pref at that position."""
    B, K, L = mm.shape
    dev = mm.device
    La = lengths.long()
    spansize = -(-k // interval) * interval
    firstbound = interval + (interval - 1) + k
    lastpos = La - k                                      # [B]
    lastbound = lastpos - interval - 1
    mtl = torch.clamp(La // 2, max=spansize + interval - 1)

    def below(idx):                                       # idx [B] or [B, K]
        if idx.dim() == 1:
            idx = idx[:, None].expand(B, K)
        return _at(pref, idx.clamp(0, L))

    lbc = below(lastbound.clamp(min=0))
    cle = below(mtl + 1)
    clt = below(La - mtl)
    lp_hi = below(lastpos + k)
    lp_lo = below(lastpos)
    npos = pref[:, :, -1]
    lowc = pref[:, :, min(firstbound + 1, L)]

    smax = max(1, (L - k) // interval + 1)
    sps = [s * interval for s in range(smax)]
    clean = torch.stack(
        [(pref[:, :, min(s + k, L)] - pref[:, :, s]) == 0 for s in sps], 2)
    sp = torch.tensor(sps, device=dev)
    clean = clean & (sp[None, :] <= lastpos[:, None])[:, None, :]
    clean_last = (lp_hi - lp_lo == 0) & (lastpos > 0)[:, None]
    BIGP = 2**30
    pfirst = torch.where(clean, sp, BIGP).min(2).values
    plast = torch.where(clean, sp, -1).max(2).values
    pfirst = torch.where(clean_last,
                         torch.minimum(pfirst, lastpos[:, None]), pfirst)
    plast = torch.where(clean_last,
                        torch.maximum(plast, lastpos[:, None]), plast)

    t5, t3 = _trim_ends_device(mm, lengths, trim_mm_score)
    nmm_0t3 = below(La[:, None] - t3)
    cb_t5 = below(t5)
    i32 = lambda x: x.int()
    return dict(lane_npos=i32(npos), lane_t5=t5, lane_t3=t3,
                lane_lowc=i32(lowc), lane_lbc=i32(lbc),
                lane_cle=i32(cle), lane_clt=i32(clt),
                lane_pfirst=i32(pfirst), lane_plast=i32(plast),
                lane_present=pfirst < BIGP,
                lane_nmm_tt=i32(nmm_0t3 - cb_t5), lane_nmm_0t3=i32(nmm_0t3),
                lane_nmm_t50=i32(npos - cb_t5))


_LANE_FEATURE_KEYS = (
    "lane_npos", "lane_t5", "lane_t3", "lane_lowc", "lane_lbc",
    "lane_cle", "lane_clt", "lane_pfirst", "lane_plast", "lane_present",
    "lane_nmm_tt", "lane_nmm_0t3", "lane_nmm_t50")


def _lane_features_cuda(mm, lengths, k: int, interval: int,
                        trim_mm_score: int):
    r, kc, L = mm.shape
    if k > 32 or L > klimits.LANE_FEATURES_MAX_L:
        raise ValueError(f"the lane_features kernel takes k <= 32 and reads "
                         f"of at most {klimits.LANE_FEATURES_MAX_L} bases, "
                         f"got k={k}, L={L}")
    dev = mm.device
    feats = {key: torch.empty((r, kc), dtype=torch.bool
                              if key == "lane_present" else torch.int32,
                              device=dev) for key in _LANE_FEATURE_KEYS}
    packed = torch.empty((r, kc, (L + 7) // 8), dtype=torch.uint8,
                         device=dev)
    kbuild.launch("gsnap_lane_features", dev, mm.contiguous(),
                  lengths.int().contiguous(),
                  *(feats[key] for key in _LANE_FEATURE_KEYS), packed,
                  r, kc, L, k, interval, trim_mm_score)
    return {"cand_mm": packed, **feats}


def lane_features(mm, pref, lengths, k: int, interval: int,
                  trim_mm_score: int):
    """End trims, lane features and the bit-packed mask of every
    candidate (kernel K13; the JAX package's _trim_ends_device,
    _lane_features and _bitpack_mask): from mm bool[R, K, L] and pref
    int32[R, K, L+1] (K3's output, pref = cat(0, cumsum(mm)); the kernel
    counts the mask itself), the _LANE_FEATURE_KEYS [R, K] int32 (bool
    lane_present) and "cand_mm" uint8[R, K, ceil(L/8)]."""
    if mm.device.type == "cpu":
        return {"cand_mm": _bitpack_mask(mm),
                **_lane_features_plain(mm, pref, lengths, k, interval,
                                       trim_mm_score)}
    if mm.device.type == "cuda":
        return _lane_features_cuda(mm, lengths, k, interval, trim_mm_score)
    raise ValueError(f"unsupported device {mm.device}")


def _lane_noop_device(final, cands, lengths, k: int, interval: int,
                      base: GsnapParams):
    """(noop bool[B], ind_fires bool[B, K], term_fires bool[B, K]): noop
    is True where the SE host rescue lanes (end indels + terminals)
    provably produce nothing; ind/term_fires flag the candidate slots
    each lane must examine.  Mirrors runner._se_lane_noop."""
    La = lengths.long()
    spansize = -(-k // interval) * interval
    budget = torch.clamp((La + interval - 1) // spansize - 2, min=0)
    np_ = final["npaths"]
    done = torch.minimum(budget, torch.where(np_ > 0, final["score"][:, 0],
                                             10**6))
    lastpos = La - k
    minlength = torch.clamp(La // 3, max=40)

    cn = cands["cand_nmm"]
    valid = cn < BIG_NMM
    d = done[:, None]
    mmi = d - base.indel_penalty_end
    npos = cands["lane_npos"]
    lowc = cands["lane_lowc"]
    lbc = cands["lane_lbc"]
    ind_entry = ((npos > 0)
                 & (((lowc >= 1) & (npos - lowc <= mmi))
                    | ((npos - lbc >= 1) & (lbc <= mmi))))
    ind_fires = (done >= base.indel_penalty_end)[:, None] & valid & ind_entry

    t5 = cands["lane_t5"]
    t3 = cands["lane_t3"]
    pfirst = cands["lane_pfirst"]
    plast = cands["lane_plast"]
    longb = cands["lane_present"] & (plast - pfirst > k)
    start_term = pfirst >= interval
    end_term = plast < (lastpos - interval)[:, None]

    def accept(t5v, t3v, nmm_trim):
        span = La[:, None] - t5v - t3v
        ok = span > minlength[:, None]
        ok &= (span - nmm_trim) - 3 * nmm_trim >= 0
        ok &= nmm_trim <= d
        ok &= ~((t5v == 0) & (t3v == 0) & (cn <= d))
        return ok

    z = torch.zeros_like(t5)
    lt5 = torch.where(start_term, t5, z)
    lt3 = torch.where(end_term, t3, z)
    nmm_long = torch.where(
        start_term & end_term, cands["lane_nmm_tt"],
        torch.where(start_term, cands["lane_nmm_t50"],
                    torch.where(end_term, cands["lane_nmm_0t3"], npos)))
    v_long = longb & accept(lt5, lt3, nmm_long)
    c1 = (npos <= d) | (cands["lane_cle"] <= d)
    c2 = (npos <= d) | (cands["lane_clt"] >= npos - d)
    v1 = ~longb & c1 & accept(z, t3, cands["lane_nmm_0t3"])
    v2 = ~longb & c2 & accept(t5, z, cands["lane_nmm_t50"])
    term_exists = valid & (v_long | v1 | v2)
    term_fires = (done >= base.terminal_threshold)[:, None] & term_exists

    gated = (np_ == 1) & (final["kind"][:, 0] == KIND_SUB)
    noop = gated & ~(ind_fires | term_fires).any(1)
    return noop, ind_fires, term_fires


# ------------------------------------------------------------- pair selection

def _select_pairs_plain(top_d, votes, eligible_fn, maxpairs: int):
    """Up to ``maxpairs`` ordered diagonal pairs (i -> left part, j ->
    right part) per read, ranked by vote sum (stable, so ties keep the
    JAX order).  Returns (ii, jj int64[B, P], valid bool[B, P])."""
    b, nc = top_d.shape
    okd = top_d != INVALID_DIAG
    eligible = (eligible_fn(top_d[:, :, None], top_d[:, None, :])
                & okd[:, :, None] & okd[:, None, :])
    score = votes[:, :, None] + votes[:, None, :]
    score = torch.where(eligible, score, -1).reshape(b, nc * nc)
    order = torch.argsort(-score, dim=1, stable=True)[:, :maxpairs]
    valid = torch.gather(score, 1, order) >= 0
    return order // nc, order % nc, valid


def _indel_pairs_eligible(max_del: int, max_ins: int):
    def fn(di, dj):
        ndel = _i32(dj - di)
        nins = _i32(di - dj)
        return (((ndel >= 1) & (ndel <= max_del))
                | ((nins >= 1) & (nins <= max_ins)))
    return fn


def _splice_pairs_eligible(maxdist: int):
    """Splice pairs: dj - di in [1, maxdist] as uint32 (wraps below 0)."""
    def fn(di, dj):
        d = (dj - di) & MASK32
        return (d >= 1) & (d <= maxdist)
    return fn


def _select_pairs_cuda(top_d, votes, maxpairs, rule, a, b_):
    b, nc = top_d.shape
    dev = top_d.device
    p = min(maxpairs, nc * nc)
    ii = torch.empty((b, p), dtype=torch.int64, device=dev)
    jj = torch.empty((b, p), dtype=torch.int64, device=dev)
    valid = torch.empty((b, p), dtype=torch.bool, device=dev)
    kbuild.launch("gsnap_select_pairs", dev, top_d.contiguous(),
                  votes.int().contiguous(), ii, jj, valid, b, nc, p, rule,
                  a, b_)
    return ii, jj, valid


def select_pairs(top_d, votes, maxpairs: int, max_del: int | None = None,
                 max_ins: int | None = None, maxdist: int | None = None):
    """Up to ``maxpairs`` ordered diagonal pairs (i -> left part, j ->
    right part) per read, ranked by vote sum, ties in flat (i, j) order
    (kernel K16; the JAX package's _select_pairs).  The middle-indel rule
    (``max_del``, ``max_ins``: int32(dj - di) in [1, max_del] or
    int32(di - dj) in [1, max_ins], the uint32 difference wrapping) or,
    with ``maxdist``, the local-splice rule (dj - di as uint32 in [1,
    maxdist]).  Returns (ii, jj int64[B, P], valid bool[B, P])."""
    if maxdist is not None:
        rule, a, b_ = 1, maxdist, 0
        fn = _splice_pairs_eligible(maxdist)
    else:
        rule, a, b_ = 0, max_del, max_ins
        fn = _indel_pairs_eligible(max_del, max_ins)
    if top_d.device.type == "cpu":
        return _select_pairs_plain(top_d, votes, fn, maxpairs)
    if top_d.device.type == "cuda":
        return _select_pairs_cuda(top_d, votes, maxpairs, rule, a, b_)
    raise ValueError(f"unsupported device {top_d.device}")


# ----------------------------------------------------------------- indel solve

_INDEL_KEYS = ("valid", "is_del", "nindels", "split", "nmm1", "nmm2",
               "left", "right")


def _solve_indels_plain(top_d, mm, pref, ii, jj, pvalid, lengths, budget,
                        lmax, qp5, qp3, max_ins, max_del, min_end):
    b, p = ii.shape
    dev = mm.device
    di = _gather_rows(top_d, ii)
    dj = _gather_rows(top_d, jj)
    mm_i = _gather_rows(mm, ii)                           # [B, P, L]
    mm_j = _gather_rows(mm, jj)
    pref_i = _gather_rows(pref, ii)                       # [B, P, L+1]
    pref_j = _gather_rows(pref, jj)
    L = lengths.int()[:, None]                            # [B, 1]
    tot_j = _at(pref_j, L.expand(b, p))[:, :, None]

    ndel = _i32(dj - di)
    nins = _i32(di - dj)
    is_del = (ndel >= 1) & (ndel <= max_del)
    is_ins = (nins >= 1) & (nins <= max_ins)
    n = torch.where(is_del, ndel, nins)[:, :, None]       # int32

    s = torch.arange(lmax + 1, dtype=torch.int32, device=dev)[None, None, :]
    # suffix mismatches of query[s + shift:] at dj, shift = 0 (deletion)
    # or n (insertion); the JAX edge-pad makes s + shift past lmax read
    # pref_j[lmax]
    shift = torch.where(is_del, 0, nins.clamp(0, max_ins))[:, :, None]
    x = s + shift
    pref_j_at = torch.gather(pref_j, 2, x.clamp(max=lmax).long())
    total = pref_i + (tot_j - pref_j_at)                  # [B, P, L+1]

    # candidate splits: s = mm_i position, or mm_j position - shift + 1
    pad_i = torch.cat([mm_i, torch.zeros((b, p, 1), dtype=torch.bool,
                                         device=dev)], 2)
    mmj_at = ((x >= 1) & (x <= lmax)
              & torch.gather(mm_j, 2, (x - 1).clamp(0, lmax - 1).long()))
    cand = pad_i | mmj_at

    hi = torch.where(is_del[:, :, None], L[:, :, None], L[:, :, None] - n)
    inb = (s >= min_end) & (s <= hi - min_end)
    radix = 1 << (lmax + 1).bit_length()
    key = torch.where(cand & inb, total * radix + s, BIG_SCORE)
    bestkey = key.min(2).values
    split = bestkey % radix
    best_sum = bestkey // radix

    valid = (pvalid & (is_del | is_ins) & (bestkey < BIG_SCORE)
             & (best_sum <= budget[:, None]))
    if qp5 is not None:
        valid = valid & (_gather_rows(qp3, ii) < _gather_rows(qp5, jj))
    nmm1 = _at(pref_i, split.clamp(max=lmax))
    return {
        "valid": valid,
        "is_del": is_del,
        "nindels": torch.where(valid, n[:, :, 0], 0),
        "split": torch.where(valid, split, 0),
        "nmm1": nmm1,
        "nmm2": torch.where(valid, best_sum - nmm1, 0),
        "left": di,
        "right": dj,
    }


def _solve_indels_cuda(top_d, mm, pref, ii, jj, pvalid, lengths, budget,
                       lmax, qp5, qp3, max_ins, max_del, min_end):
    b, p = ii.shape
    nc = top_d.shape[1]
    dev = mm.device
    out = {
        "valid": torch.empty((b, p), dtype=torch.bool, device=dev),
        "is_del": torch.empty((b, p), dtype=torch.bool, device=dev),
        "nindels": torch.empty((b, p), dtype=torch.int32, device=dev),
        "split": torch.empty((b, p), dtype=torch.int32, device=dev),
        "nmm1": torch.empty((b, p), dtype=torch.int32, device=dev),
        "nmm2": torch.empty((b, p), dtype=torch.int32, device=dev),
        "left": torch.empty((b, p), dtype=torch.int64, device=dev),
        "right": torch.empty((b, p), dtype=torch.int64, device=dev),
    }
    qp = qp5 is not None
    # pref is not read: the kernel counts mismatches on mm's bits; mm's
    # rows are read in 16-byte chunks from a 16-byte aligned start
    mm = mm.contiguous()
    if mm.data_ptr() % 16:
        raise ValueError("solve_indels: mm not 16-byte aligned")
    kbuild.launch(
        "gsnap_solve_indels", dev,
        top_d.contiguous(), mm,
        ii.contiguous(), jj.contiguous(), pvalid.contiguous(),
        lengths.int().contiguous(), budget.int().contiguous(),
        qp5.int().contiguous() if qp else None,
        qp3.int().contiguous() if qp else None,
        *(out[k] for k in _INDEL_KEYS),
        b, p, nc, lmax, max_ins, max_del, min_end,
        1 << (lmax + 1).bit_length())
    return out


def solve_indels(top_d, mm, pref, ii, jj, pvalid, lengths, budget, lmax: int,
                 qp5=None, qp3=None, max_ins: int = 9, max_del: int = 30,
                 min_end: int = 4):
    """Middle insertions/deletions between diagonal pairs (kernel K4;
    solve_middle_insertion / solve_middle_deletion, stage1hr.c:4180,
    4330).

    For pair (i, j) and split s the mismatch sum is pref_i[s] +
    (tot_j - pref_j[s + shift]); splits are candidates only at mismatch
    positions and at least ``min_end`` from either end; the winner is
    the smallest (sum, s).  qp5/qp3 [B, NC] gate pairs whose left
    piece's seeds end before the right piece's begin.

    Returns a dict of [B, P] tensors: valid, is_del, nindels, split,
    nmm1, nmm2, left (di), right (dj)."""
    args = (top_d, mm, pref, ii, jj, pvalid, lengths, budget, lmax, qp5, qp3,
            max_ins, max_del, min_end)
    if mm.device.type == "cpu":
        return _solve_indels_plain(*args)
    if mm.device.type == "cuda":
        return _solve_indels_cuda(*args)
    raise ValueError(f"unsupported device {mm.device}")


# ---------------------------------------------------------------- splice solve

def _suff_local(support, nmm, prob):
    """sufficient_splice_prob_local (stage1hr.c:6093); thresholds are
    float32, as in the JAX package."""
    s = support - 3 * nmm
    thr = torch.where(s < 14, 0.95, torch.where(
        s < 20, 0.90, torch.where(s < 26, 0.85, 0.70))).float()
    return prob > thr


def _fetch_span(genome, d, lmax: int):
    """Codes at genome positions d + (-20 .. lmax + 20) -> uint8[..., L+41].
    The start d - 20 wraps in uint32 as in the JAX package (pairs with a
    diagonal below 64 are masked by the solvers)."""
    return genome_ops.fetch_span_codes(genome.ref16, (d - 20) & MASK32,
                                       lmax + 41)


SPLICE_CANDS = 16    # splice positions scored per pair per sense class
SHORTEXON_CANDS = 8  # junction positions kept per junction per sense


def _sites(span, kind: str, npos: int):
    """Splice dinucleotides at scan positions s = 0..npos-1 of a span
    (origin 20): donor GT and antiacceptor CT at [s, s+1], acceptor AG
    and antidonor AC at [s-2, s-1]."""
    at = lambda rel: span[..., 20 + rel : 20 + rel + npos]
    if kind == "donor":
        return (at(0) == 2) & (at(1) == 3)
    if kind == "acceptor":
        return (at(-2) == 0) & (at(-1) == 2)
    if kind == "antiacceptor":
        return (at(0) == 1) & (at(1) == 3)
    return (at(-2) == 0) & (at(-1) == 1)                  # antidonor


# index of each site class in the ``known`` bitvector tuple (donor,
# acceptor, antidonor, antiacceptor), the order of csrc/maxent.cuh's Kind
_KNOWN_INDEX = {"donor": 0, "acceptor": 1, "antidonor": 2, "antiacceptor": 3}


def _class_sites(span, d, kind: str, npos: int, novel: bool, known):
    """(candidate, known) bool[B, P, npos] of one site class on a
    segment: the dinucleotide test when ``novel``, OR the known-site bit
    at d + s (ops/genome.fetch_span_bits)."""
    if novel:
        cand = _sites(span, kind, npos)
    else:
        cand = torch.zeros(span.shape[:2] + (npos,), dtype=torch.bool,
                           device=span.device)
    if known is None:
        return cand, torch.zeros_like(cand)
    kn = genome_ops.fetch_span_bits(known[_KNOWN_INDEX[kind]], d, npos)
    return cand | kn, kn


def _first_cands(cand, k: int):
    """The k smallest candidate positions, ascending (JAX: top_k of the
    negated key, whose non-candidates all carry npos + 7).  Returns
    (sel clipped to [0, npos - 1], ok)."""
    npos = cand.shape[-1]
    s = torch.arange(npos, device=cand.device)
    key = torch.where(cand, s, npos + 7)
    sel = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    return sel.clamp(0, npos - 1), sel < npos


def _prob_at(span, kind: str, sel):
    """float32 maxent probability at scan positions sel [..., K] of a
    span: the table factors at the selected indices, multiplied in
    _MODELS order (ops/maxent)."""
    tables = maxent.device_tables(span.device)
    odds = None
    for name, idx in maxent.splice_idx_span(span, kind, span.shape[-1] - 40):
        factor = tables[name][torch.gather(idx, -1, sel)]
        odds = factor if odds is None else odds * factor
    return odds / (1.0 + odds)


def _site_prob(span, kind: str, sel, kn):
    """_prob_at, with 1.0 where the selected position is a known site
    (stage1hr.c:6330-6339)."""
    return torch.where(torch.gather(kn, 2, sel), 1.0,
                       _prob_at(span, kind, sel))


_SPLICE_KEYS = ("valid", "split", "sense", "prob_d", "prob_a", "nmm1",
                "nmm2", "left", "right")


def _solve_splices_plain(genome, top_d, pref, ii, jj, pvalid, lengths,
                         budget, lmax, novel=True, known=None):
    b, p = ii.shape
    dev = pref.device
    di = _gather_rows(top_d, ii)
    dj = _gather_rows(top_d, jj)
    pref_i = _gather_rows(pref, ii)                       # [B, P, L+1]
    pref_j = _gather_rows(pref, jj)
    L = lengths.long()[:, None]                           # [B, 1]
    tot_j = _at(pref_j, L.expand(b, p))[:, :, None]
    span_i = _fetch_span(genome, di, lmax)
    span_j = _fetch_span(genome, dj, lmax)
    npos = lmax + 1
    s = torch.arange(npos, device=dev)[None, None, :]

    inb = ((s >= 2) & (s <= L[:, :, None] - 2)
           & (di[:, :, None] >= 64) & (dj[:, :, None] >= 64))
    nmm_i = pref_i[:, :, :npos]
    nmm_j = tot_j - pref_j[:, :, :npos]
    under = (nmm_i + nmm_j) <= budget[:, None, None]

    def solve_class(kind_i, kind_j):
        c_i, kn_i = _class_sites(span_i, di, kind_i, npos, novel, known)
        c_j, kn_j = _class_sites(span_j, dj, kind_j, npos, novel, known)
        sel, sel_ok = _first_cands(c_i & c_j & inb & under, SPLICE_CANDS)
        p_i = _site_prob(span_i, kind_i, sel, kn_i)
        p_j = _site_prob(span_j, kind_j, sel, kn_j)
        mi = torch.gather(nmm_i, 2, sel)
        mj = torch.gather(nmm_j, 2, sel)
        ok = (sel_ok & _suff_local(sel, mi, p_i)
              & _suff_local(L[:, :, None] - sel, mj, p_j))
        prob = torch.where(ok, p_i + p_j, -1.0)
        bi = torch.argmax(prob, 2, keepdim=True)          # first maximum
        take = lambda x: torch.gather(x, 2, bi)[:, :, 0]
        return take(prob), take(sel), take(p_i), take(p_j)

    prob_s, split_s, pd_s, pa_s = solve_class("donor", "acceptor")
    prob_a_, split_a, pa_i, pd_j = solve_class("antiacceptor", "antidonor")

    use_anti = prob_a_ > prob_s           # antisense must strictly beat sense
    split = torch.where(use_anti, split_a, split_s)
    prob = torch.where(use_anti, prob_a_, prob_s)
    valid = pvalid & (prob > 0.0)
    sp = split[:, :, None]
    nmm1 = torch.gather(nmm_i, 2, sp)[:, :, 0]
    nmm2 = torch.gather(nmm_j, 2, sp)[:, :, 0]
    prob_d = torch.where(use_anti, pd_j, pd_s)
    prob_a = torch.where(use_anti, pa_i, pa_s)
    return {
        "valid": valid,
        "split": torch.where(valid, split, 0).int(),
        "sense": ~use_anti,
        "prob_d": torch.where(valid, prob_d, 0.0),
        "prob_a": torch.where(valid, prob_a, 0.0),
        "nmm1": torch.where(valid, nmm1, 0).int(),
        "nmm2": torch.where(valid, nmm2, 0).int(),
        "left": di,
        "right": dj,
    }


def _splice_dtype(key: str) -> torch.dtype:
    """dtype of a splice / short-exon solver output."""
    if key in ("valid", "sense"):
        return torch.bool
    if key in ("left", "mid", "right"):
        return torch.int64
    return torch.float32 if key.startswith("prob") else torch.int32


def _splice_outputs(keys, shape, dev):
    """Empty output tensors of a splice kernel, by key."""
    return {k: torch.empty(shape, dtype=_splice_dtype(k), device=dev)
            for k in keys}


def _check_known(known):
    """``known`` as the solvers take it: None, or four int32 word vectors
    of one length on one device (db/splicesites.device_bitmasks)."""
    if known is None:
        return None
    if (len(known) != 4 or not all(isinstance(k, torch.Tensor)
                                   for k in known)
            or any(k.dtype != torch.int32 or k.shape != known[0].shape
                   or k.dim() != 1 or k.device != known[0].device
                   for k in known)):
        raise ValueError("known: four int32 word vectors of one length")
    return tuple(known)


def _known_args(known):
    """(kd, ka, kad, kaa, words): the four known-site word tensors (None
    each without known sites) and their word count, as the kernels take
    them (the count after the genome's word count)."""
    if known is None:
        return (None,) * 4 + (0,)
    return tuple(k.contiguous() for k in known) + (known[0].shape[0],)


def _solve_splices_cuda(genome, top_d, pref, ii, jj, pvalid, lengths,
                        budget, lmax, novel=True, known=None):
    b, p = ii.shape
    dev = pref.device
    out = _splice_outputs(_SPLICE_KEYS, (b, p), dev)
    *kn_words, kn_len = _known_args(known)
    kbuild.launch(
        "gsnap_solve_splices", dev,
        genome.ref16, maxent.flat_tables(dev), top_d.contiguous(),
        pref.contiguous(), ii.contiguous(), jj.contiguous(),
        pvalid.contiguous(), lengths.int().contiguous(),
        budget.int().contiguous(), *(out[k] for k in _SPLICE_KEYS),
        *kn_words, genome.ref16.shape[0], kn_len, b, p, top_d.shape[1],
        lmax, int(novel))
    return out


def solve_splices(genome, top_d, pref, ii, jj, pvalid, lengths, budget,
                  lmax: int, novel: bool = True, known=None):
    """Local splices between diagonal pairs (kernel K5;
    solve_singlesplice, stage1hr.c:6195, over the pairs of
    find_singlesplices_plus, stage1hr.c:7235).

    For pair (i -> left piece, j -> right piece) the scan positions s in
    [2, len - 2] whose mismatch sum fits the budget are candidates where
    segment i carries a donor GT at s and segment j an acceptor AG at
    s - 2 (sense), or an antiacceptor CT and an antidonor AC
    (antisense); the dinucleotide tests only when ``novel``.  With
    ``known`` (four int32 bitvectors: donor, acceptor, antidonor,
    antiacceptor), a set bit at d + s makes that side a candidate of its
    class whatever its dinucleotides, with probability 1.0 in place of
    its maxent score.  The first SPLICE_CANDS candidates of each class are
    scored with float32 maxent and the sufficiency gate; the class's best
    is its first maximum of prob_i + prob_j, and antisense wins only if
    strictly better.  Pairs with a diagonal below 64 have no candidates.

    Returns a dict of [B, P] tensors: valid, split, sense (``~(anti >
    sense)`` also where invalid), prob_d, prob_a (float32), nmm1, nmm2,
    left (di), right (dj)."""
    args = (genome, top_d, pref, ii, jj, pvalid, lengths, budget, lmax,
            novel, known)
    if pref.device.type == "cpu":
        return _solve_splices_plain(*args)
    if pref.device.type == "cuda":
        return _solve_splices_cuda(*args)
    raise ValueError(f"unsupported device {pref.device}")


def _top2_stable(x):
    """The two largest entries along the last axis, ties to the lower
    index (lax.top_k's rule): (values, indices)."""
    o = torch.argsort(-x, dim=-1, stable=True)[..., :2]
    return torch.gather(x, -1, o), o


def _select_triples_plain(top_d, votes, maxdist, ntriples):
    b, nc = top_d.shape
    okd = top_d != INVALID_DIAG
    step = (top_d[:, None, :] - top_d[:, :, None]) & MASK32   # [b, i, j]
    elig = ((step >= 1) & (step <= maxdist)
            & okd[:, :, None] & okd[:, None, :])             # edge i -> j
    v = votes.long()
    vi = torch.where(elig, v[:, :, None], -1)
    v2i, i2 = _top2_stable(vi.transpose(1, 2))    # per middle m: best i
    vj = torch.where(elig, v[:, None, :], -1)
    v2j, j2 = _top2_stable(vj)                    # per middle m: best j
    vsum = (v[:, :, None, None] + v2i[:, :, :, None]
            + v2j[:, :, None, :])                 # [b, m, 2, 2]
    okc = ((v2i[:, :, :, None] >= 0) & (v2j[:, :, None, :] >= 0)
           & okd[:, :, None, None])
    vsum = torch.where(okc, vsum, -1).reshape(b, nc * 4)
    order = torch.argsort(-vsum, dim=1, stable=True)[:, :ntriples]
    valid = torch.gather(vsum, 1, order) >= 0
    m_sel = order // 4
    ti = torch.gather(i2.reshape(b, nc * 2), 1, m_sel * 2 + (order // 2) % 2)
    tj = torch.gather(j2.reshape(b, nc * 2), 1, m_sel * 2 + order % 2)
    return ti, m_sel, tj, valid


def _select_triples_cuda(top_d, votes, maxdist, ntriples):
    b, nc = top_d.shape
    dev = top_d.device
    ti, tm, tj = (torch.empty((b, ntriples), dtype=torch.int64, device=dev)
                  for _ in range(3))
    valid = torch.empty((b, ntriples), dtype=torch.bool, device=dev)
    kbuild.launch("gsnap_select_triples", dev, top_d.contiguous(),
                  votes.int().contiguous(), ti, tm, tj, valid, b, nc,
                  ntriples, maxdist)
    return ti, tm, tj, valid


def select_triples(top_d, votes, maxdist: int, ntriples: int):
    """Up to ``ntriples`` diagonal triples i -> m -> j per read, each step
    in [1, maxdist] (uint32 differences), ranked by vote sum (kernel K6;
    the candidate set of find_doublesplices, stage1hr.c:7698-7742).

    Per middle m the two best predecessors and successors by (votes
    desc, index asc; ineligible = -1, as lax.top_k ranks them) give 4
    combinations; the NC * 4 sums (-1 unless both exist) are ranked by a
    stable descending sort and the first ``ntriples`` kept.  Returns (ti,
    tm, tj int64[B, T], valid bool[B, T]).  The kernel takes votes in
    [0, 2^23 - 2] summed (K2's are): a negative vote of a valid diagonal
    or a larger sum stops it with a trap."""
    ntriples = min(ntriples, 4 * top_d.shape[1])
    if top_d.device.type == "cpu":
        return _select_triples_plain(top_d, votes, maxdist, ntriples)
    if top_d.device.type == "cuda":
        return _select_triples_cuda(top_d, votes, maxdist, ntriples)
    raise ValueError(f"unsupported device {top_d.device}")


_SHORTEXON_KEYS = ("valid", "split", "split2", "sense", "prob_d", "prob_a",
                   "prob_d2", "prob_a2", "nmm1", "nmm2", "nmm3", "left",
                   "mid", "right")


def _solve_doublesplices_plain(genome, top_d, pref, ti, tm, tj, tvalid,
                               lengths, budget, lmax, novel=True,
                               known=None):
    b, t = ti.shape
    dev = pref.device
    di = _gather_rows(top_d, ti)
    dm = _gather_rows(top_d, tm)
    dj = _gather_rows(top_d, tj)
    pref_i = _gather_rows(pref, ti)
    pref_m = _gather_rows(pref, tm)
    pref_j = _gather_rows(pref, tj)
    L = lengths.long()[:, None]
    tot_j = _at(pref_j, L.expand(b, t))[:, :, None]
    span_i = _fetch_span(genome, di, lmax)
    span_m = _fetch_span(genome, dm, lmax)
    span_j = _fetch_span(genome, dj, lmax)
    npos = lmax + 1
    s = torch.arange(npos, device=dev)[None, None, :]
    inb = ((s >= 2) & (s <= L[:, :, None] - 2) & (di[:, :, None] >= 64)
           & (dm[:, :, None] >= 64) & (dj[:, :, None] >= 64))
    nmm_i = pref_i[:, :, :npos]                  # nmm[0:s) on i
    cum_m = pref_m[:, :, :npos]
    nmm_j_suf = tot_j - pref_j[:, :, :npos]      # nmm[s:L) on j
    K = SHORTEXON_CANDS
    pick = lambda x, sel: torch.gather(x, 2, sel)

    def solve_sense(kind_i, kind_m, kind2_m, kind_j):
        c1i, k1i = _class_sites(span_i, di, kind_i, npos, novel, known)
        c1m, k1m = _class_sites(span_m, dm, kind_m, npos, novel, known)
        c2m, k2m = _class_sites(span_m, dm, kind2_m, npos, novel, known)
        c2j, k2j = _class_sites(span_j, dj, kind_j, npos, novel, known)
        sel1, ok1 = _first_cands(c1i & c1m & inb, K)
        sel2, ok2 = _first_cands(c2m & c2j & inb, K)
        p1i = _site_prob(span_i, kind_i, sel1, k1i)
        p1m = _site_prob(span_m, kind_m, sel1, k1m)
        p2m = _site_prob(span_m, kind2_m, sel2, k2m)
        p2j = _site_prob(span_j, kind_j, sel2, k2j)
        mi1, cm1 = pick(nmm_i, sel1), pick(cum_m, sel1)
        cm2, mj2 = pick(cum_m, sel2), pick(nmm_j_suf, sel2)
        # joint [B, T, K1, K2]
        sp1 = sel1[:, :, :, None]
        sp2 = sel2[:, :, None, :]
        nmm1 = mi1[:, :, :, None]
        nmm2 = cm2[:, :, None, :] - cm1[:, :, :, None]
        nmm3 = mj2[:, :, None, :]
        total = nmm1 + nmm2 + nmm3
        okp = (ok1[:, :, :, None] & ok2[:, :, None, :] & (sp2 > sp1)
               & (total <= budget[:, None, None, None]) & (nmm2 >= 0))
        okp = (okp & _suff_local(sp1, nmm1, p1i[:, :, :, None])
               & _suff_local(sp2 - sp1, nmm2, p1m[:, :, :, None])
               & _suff_local(sp2 - sp1, nmm2, p2m[:, :, None, :])
               & _suff_local(L[:, :, None, None] - sp2, nmm3,
                             p2j[:, :, None, :]))
        prob = (p1i[:, :, :, None] + p1m[:, :, :, None]
                + p2m[:, :, None, :] + p2j[:, :, None, :])
        key = torch.where(okp, -total.float() * 8.0 + prob, -1e9)
        kf = key.reshape(b, t, K * K)
        best = torch.argmax(kf, 2, keepdim=True)          # first maximum
        b1, b2 = best // K, best % K
        take1 = lambda x: torch.gather(x, 2, b1)[:, :, 0]
        take2 = lambda x: torch.gather(x, 2, b2)[:, :, 0]
        return dict(score=torch.gather(kf, 2, best)[:, :, 0],
                    sp1=take1(sel1), sp2=take2(sel2),
                    p1i=take1(p1i), p1m=take1(p1m),
                    p2m=take2(p2m), p2j=take2(p2j),
                    nmm1=take1(mi1), nmm2=take2(cm2) - take1(cm1),
                    nmm3=take2(mj2))

    sense = solve_sense("donor", "acceptor", "donor", "acceptor")
    anti = solve_sense("antiacceptor", "antidonor", "antiacceptor",
                       "antidonor")
    use_anti = anti["score"] > sense["score"]
    pickd = lambda k: torch.where(use_anti, anti[k], sense[k])
    valid = tvalid & (pickd("score") > -1e8)
    z = lambda x: torch.where(valid, x, 0)
    zf = lambda a, s_: torch.where(valid, torch.where(use_anti, a, s_), 0.0)
    return {
        "valid": valid,
        "split": z(pickd("sp1")).int(),
        "split2": z(pickd("sp2")).int(),
        "sense": ~use_anti,
        # junction probs in donor/acceptor display order per junction
        "prob_d": zf(anti["p2j"], sense["p1i"]),
        "prob_a": zf(anti["p2m"], sense["p1m"]),
        "prob_d2": zf(anti["p1m"], sense["p2m"]),
        "prob_a2": zf(anti["p1i"], sense["p2j"]),
        "nmm1": z(pickd("nmm1")).int(),
        "nmm2": z(pickd("nmm2")).int(),
        "nmm3": z(pickd("nmm3")).int(),
        "left": di,
        "mid": dm,
        "right": dj,
    }


def _solve_doublesplices_cuda(genome, top_d, pref, ti, tm, tj, tvalid,
                              lengths, budget, lmax, novel=True, known=None):
    b, t = ti.shape
    dev = pref.device
    out = _splice_outputs(_SHORTEXON_KEYS, (b, t), dev)
    *kn_words, kn_len = _known_args(known)
    kbuild.launch(
        "gsnap_solve_doublesplices", dev,
        genome.ref16, maxent.flat_tables(dev), top_d.contiguous(),
        pref.contiguous(), ti.contiguous(), tm.contiguous(), tj.contiguous(),
        tvalid.contiguous(), lengths.int().contiguous(),
        budget.int().contiguous(), *(out[k] for k in _SHORTEXON_KEYS),
        *kn_words, genome.ref16.shape[0], kn_len, b, t, top_d.shape[1],
        lmax, int(novel))
    return out


def solve_doublesplices(genome, top_d, pref, ti, tm, tj, tvalid, lengths,
                        budget, lmax: int, novel: bool = True, known=None):
    """Short middle exons between two local introns (kernel K7;
    solve_doublesplice, stage1hr.c:6612).

    For triple (i, m, j): junction 1 at s1 needs a donor on i and an
    acceptor on m, junction 2 at s2 > s1 a donor on m and an acceptor on
    j (sense; antisense uses antiacceptor/antidonor); dinucleotides count
    only when ``novel``, and known sites (``known``, as for
    :func:`solve_splices`) are candidates with probability 1.0.  The first
    SHORTEXON_CANDS positions of each junction are joined in an 8 x 8
    grid keyed by -total_mismatches * 8 + (((p1i + p1m) + p2m) + p2j) in
    float32, each of the four probabilities gated by the sufficiency
    test; the first maximum in s1-major order wins, and antisense only
    if strictly better.

    Returns a dict of [B, T] tensors: valid, split, split2, sense,
    prob_d, prob_a, prob_d2, prob_a2 (float32), nmm1, nmm2, nmm3, left,
    mid, right (the triple's diagonals)."""
    args = (genome, top_d, pref, ti, tm, tj, tvalid, lengths, budget, lmax,
            novel, known)
    if pref.device.type == "cpu":
        return _solve_doublesplices_plain(*args)
    if pref.device.type == "cuda":
        return _solve_doublesplices_cuda(*args)
    raise ValueError(f"unsupported device {pref.device}")


# -------------------------------------------------------------- full pipeline

def _bitpack_mask(mm: torch.Tensor) -> torch.Tensor:
    """bool[B, K, L] -> uint8[B, K, ceil(L/8)], little-endian bits."""
    b, k, L = mm.shape
    nby = (L + 7) // 8
    mmp = torch.nn.functional.pad(mm, (0, nby * 8 - L)).reshape(b, k, nby, 8)
    sh = torch.arange(8, dtype=torch.uint8, device=mm.device)
    return (mmp.to(torch.uint8) << sh).sum(-1, dtype=torch.uint8)


def _strand_hits(genome, index, queries, codes, nflags, lengths, conv, alt,
                 budget, params: GappedParams, known=None):
    """seed -> vote -> verify -> middle indels for one strand batch.
    Returns (hits, cands): dicts of [B, K] candidate arrays."""
    base = params.base
    b = codes.shape[0]
    dev = codes.device
    diag, qpos_grid, trunc, nphase_min, nph_half = seed_diagonals(
        index, _convert_codes(codes, conv), nflags, lengths, base, half=True)
    top_d, votes, ndistinct = top_diagonals(diag, base.ncand)
    overflow = trunc | (ndistinct > base.ncand)

    mm, pref = _prefix_mm(genome, queries, top_d, lengths, conv, alt)
    ok, _ = mm_ops._placements(genome, top_d, lengths)
    nmm_raw = torch.where(ok, pref[:, :, -1], BIG_NMM)
    nmm_sub = torch.where(nmm_raw <= budget[:, None], nmm_raw, BIG_NMM)

    ii, jj, pv = select_pairs(top_d, votes, params.indel_pairs,
                              max_del=base.max_middle_deletions,
                              max_ins=base.max_middle_insertions)
    qp5, qp3 = qpos_ranges(diag, qpos_grid, top_d)
    ind = solve_indels(top_d, mm, pref, ii, jj, pv, lengths, budget,
                       queries.lmax, qp5=qp5, qp3=qp3,
                       max_ins=base.max_middle_insertions,
                       max_del=base.max_middle_deletions,
                       min_end=base.min_indel_end_matches)

    nc = top_d.shape[1]
    nsp, ntr = params.splice_pairs, params.shortexon_triples
    z = lambda n, dt=torch.int32: torch.zeros((b, n), dtype=dt, device=dev)
    if params.novelsplicing or known is not None:
        si, sj, sv = select_pairs(top_d, votes, nsp,
                                  maxdist=base.shortsplicedist)
        spl = solve_splices(genome, top_d, pref, si, sj, sv, lengths, budget,
                            queries.lmax, novel=params.novelsplicing,
                            known=known)
        ti, tm, tj, tv = select_triples(top_d, votes, base.shortsplicedist,
                                        ntr)
        shx = solve_doublesplices(genome, top_d, pref, ti, tm, tj, tv,
                                  lengths, budget, queries.lmax,
                                  novel=params.novelsplicing, known=known)
        ntr = ti.shape[1]
    else:
        # splicing off: empty splice / shortexon blocks keep the JAX
        # package's candidate layout (and so its ranking ties)
        spl = {k: z(nsp, _splice_dtype(k)) for k in _SPLICE_KEYS}
        shx = {k: z(ntr, _splice_dtype(k)) for k in _SHORTEXON_KEYS}

    def cat(*xs):
        return torch.cat(xs, 1)

    full = lambda n, v: torch.full((b, n), v, dtype=torch.int32, device=dev)
    ind_nmm = ind["nmm1"] + ind["nmm2"]
    spl_nmm = spl["nmm1"] + spl["nmm2"]
    shx_nmm = shx["nmm1"] + shx["nmm2"] + shx["nmm3"]
    lsp = base.localsplicing_penalty
    npi = ii.shape[1]
    hits = {
        "kind": cat(full(nc, KIND_SUB),
                    torch.where(ind["is_del"], KIND_DEL, KIND_INS).int(),
                    full(nsp, KIND_SPLICE), full(ntr, KIND_SHORTEXON)),
        "score": cat(nmm_sub,
                     torch.where(ind["valid"],
                                 ind_nmm + base.indel_penalty_middle,
                                 BIG_NMM).int(),
                     torch.where(spl["valid"], spl_nmm + lsp, BIG_NMM).int(),
                     torch.where(shx["valid"], shx_nmm + 2 * lsp,
                                 BIG_NMM).int()),
        "nmm": cat(torch.where(nmm_sub < BIG_NMM, nmm_sub, 0), ind_nmm,
                   spl_nmm, shx_nmm),
        "left": cat(top_d, ind["left"], spl["left"], shx["left"]),
        "right": cat(top_d, ind["right"], spl["right"], shx["right"]),
        "split": cat(z(nc), ind["split"], spl["split"], shx["split"]),
        "split2": cat(z(nc + npi + nsp), shx["split2"]),
        "mid": cat(top_d, ind["left"], spl["left"], shx["mid"]),
        "nindels": cat(z(nc), ind["nindels"], z(nsp + ntr)),
        "sense": cat(z(nc + npi, torch.bool), spl["sense"], shx["sense"]),
    }
    zf = z(nc + npi, torch.float32)
    hits["prob_d"] = cat(zf, spl["prob_d"], shx["prob_d"])
    hits["prob_a"] = cat(zf, spl["prob_a"], shx["prob_a"])
    hits["prob_d2"] = cat(zf, z(nsp, torch.float32), shx["prob_d2"])
    hits["prob_a2"] = cat(zf, z(nsp, torch.float32), shx["prob_a2"])

    cdiv = -(-index.k // index.interval)

    def floor_bound(nph):
        return torch.where(
            ndistinct > base.ncand,
            torch.clamp(-(-(nph - votes[:, -1]) // cdiv), min=0),
            BIG_NMM).int()

    cands = {
        "cand_left": top_d, "cand_votes": votes, "cand_nmm": nmm_raw,
        "overflow": overflow,
        **lane_features(mm, pref, lengths, index.k, index.interval,
                        base.trim_mismatch_score),
        "overflow_trunc": trunc,
        "ovf_bound": floor_bound(nphase_min),
        "hbound": floor_bound(nph_half),
    }
    return hits, cands


def gather_candidates(genome, index, index_minus, codes, nflags, lengths,
                      params: GappedParams, alt=None, known=None):
    """Both-strand candidate gathering; returns (unranked hits [B, K],
    cands)."""
    base = params.base
    b, lmax = codes.shape
    lengths = lengths.int()
    conv_plus, conv_minus = _MODE_CONV[base.mode]
    queries_fwd, codes_rc, nflags_rc, queries_rev = pack_batch(
        codes, nflags, lengths, base.uniform_len)
    budget = auto_budget(lengths, index.k, index.interval,
                         base.max_mismatches)

    if conv_plus is None and conv_minus is None and index_minus is None:
        # standard mode: both strands share conversion and index — run
        # them as one [2B] batch, as the JAX package does
        q2 = mm_ops.PackedQueries(
            torch.cat([queries_fwd.codes16, queries_rev.codes16]),
            torch.cat([queries_fwd.nflags16, queries_rev.nflags16]),
            torch.cat([lengths, lengths]), lmax)
        h2, c2 = _strand_hits(
            genome, index, q2, torch.cat([codes, codes_rc]),
            torch.cat([nflags, nflags_rc]), torch.cat([lengths, lengths]),
            None, alt, torch.cat([budget, budget]), params, known)
        hf = {k: v[:b] for k, v in h2.items()}
        hr = {k: v[b:] for k, v in h2.items()}
        cf = {k: v[:b] for k, v in c2.items()}
        cr = {k: v[b:] for k, v in c2.items()}
    else:
        hf, cf = _strand_hits(genome, index, queries_fwd, codes, nflags,
                              lengths, conv_plus, alt, budget, params, known)
        hr, cr = _strand_hits(genome, index if index_minus is None else index_minus,
                              queries_rev,
                              codes_rc, nflags_rc, lengths, conv_minus, alt,
                              budget, params, known)

    out = {k: torch.cat([hf[k], hr[k]], 1) for k in hf}
    nplus = hf["kind"].shape[1]
    out["plusp"] = torch.arange(2 * nplus, device=codes.device).expand(
        b, -1) < nplus
    merged = ("overflow", "overflow_trunc", "ovf_bound", "hbound")
    cands = {k: torch.cat([cf[k], cr[k]], 1) for k in cf if k not in merged}
    cands["overflow"] = cf["overflow"] | cr["overflow"]
    cands["overflow_trunc"] = cf["overflow_trunc"] | cr["overflow_trunc"]
    cands["ovf_bound"] = torch.minimum(cf["ovf_bound"], cr["ovf_bound"])
    cands["hbound"] = torch.minimum(cf["hbound"], cr["hbound"])
    nc = cf["cand_left"].shape[1]
    cands["cand_plusp"] = torch.arange(2 * nc, device=codes.device).expand(
        b, -1) < nc
    return out, cands


def _rank_hits_plain(out, base: GsnapParams, apply_optimal: bool = True,
                     maxout: int | None = None):
    """Dedup + optimal-score filter + ranking by (score, left, plus
    first), all through stable argsorts.  Returns dict of [B, maxout]
    tensors plus npaths."""
    take = lambda a, idx: torch.gather(a, 1, idx)
    score = out["score"]
    b, ncand = score.shape
    maxout = base.maxpaths if maxout is None else maxout
    ival = lambda f: f.int() if f.dtype == torch.bool else f
    # dedup identical (kind, split, split2, mid, right, plusp, left)
    fields = ["kind", "split", "split2", "mid", "right", "plusp", "left"]
    ordl = torch.arange(ncand, device=score.device).expand(b, ncand)
    for k in fields:
        o = torch.argsort(ival(take(out[k], ordl)), dim=1, stable=True)
        ordl = take(ordl, o)
    score_s = take(score, ordl)
    same = torch.ones_like(score_s, dtype=torch.bool)
    for k in fields:
        f = ival(take(out[k], ordl))
        same = same & torch.cat([torch.zeros_like(f[:, :1], dtype=torch.bool),
                                 f[:, 1:] == f[:, :-1]], 1)
    score_s = torch.where(same & (score_s < BIG_NMM), BIG_NMM, score_s)
    score = take(score_s, torch.argsort(ordl, dim=1, stable=True))

    if apply_optimal:
        best = score.min(1, keepdim=True).values
        score = torch.where(score > best + base.subopt_levels, BIG_NMM, score)

    ordp = torch.argsort((~out["plusp"]).int(), dim=1, stable=True)
    ordl2 = torch.argsort(take(out["left"], ordp), dim=1, stable=True)
    perm2 = take(ordp, ordl2)
    ords = torch.argsort(take(score, perm2), dim=1, stable=True)[:, :maxout]
    perm3 = take(perm2, ords)
    final = {k: take(v, perm3) for k, v in out.items()}
    final_score = take(score, perm3)

    ok = final_score < BIG_NMM
    final["score"] = torch.where(ok, final_score, BIG_NMM)
    final["npaths"] = ok.sum(1).int()
    for k in ("left", "right", "mid", "kind", "split", "split2", "nindels",
              "nmm"):
        final[k] = torch.where(ok, final[k], 0)
    return final


# K14's dedup and ranking keys, in the kernel's order
_RANK_KEYS = ("kind", "split", "split2", "mid", "right", "plusp", "left",
              "score")
# fields that are 0 where a rank holds no hit (score not below BIG_NMM)
_RANK_ZEROED = ("left", "right", "mid", "kind", "split", "split2",
                "nindels", "nmm")
RANK_MAX_CAND = 512


def _rank_desc(t: torch.Tensor, dev, dst=None, mode: int = 0) -> list:
    """K14's descriptor of one [B, n] column of the hit table: source
    and destination pointers, the source's strides (a broadcast row has
    stride 0), element size and mode (0 copy, 1 copy or 0 where no hit,
    2 the ranked score)."""
    if t.device != dev or t.dim() != 2 or t.element_size() not in (1, 4, 8):
        raise ValueError(f"rank_hits kernel: a [B, n] field of 1, 4 or 8 "
                         f"byte elements on {dev}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")
    return [t.data_ptr(), 0 if dst is None else dst.data_ptr(), t.stride(0),
            t.stride(1), t.element_size(), mode]


def _rank_hits_cuda(out, base: GsnapParams, apply_optimal: bool = True,
                    maxout: int | None = None, se=None):
    """K14 on ``out``, one launch that also writes every ranked field;
    with ``se`` (a dict of the SE epilogue's inputs, see
    :func:`_rank_gate_se_cuda`) also the overflow gate and the lane
    gate.  Returns (final, epilogue outputs or None)."""
    score = out["score"]
    b, ncand = score.shape
    dev = score.device
    if ncand > RANK_MAX_CAND:
        raise ValueError(f"rank_hits kernel: {ncand} candidates, at most "
                         f"{RANK_MAX_CAND}")
    if any(out[k].is_floating_point() for k in _RANK_KEYS):
        raise ValueError("rank_hits kernel: the key fields are integers")
    nout = min(base.maxpaths if maxout is None else maxout, ncand)
    final = {k: torch.empty((b, nout), dtype=v.dtype, device=dev)
             for k, v in out.items()}
    npaths = torch.empty(b, dtype=torch.int32, device=dev)
    keys = [x for k in _RANK_KEYS for x in _rank_desc(out[k], dev)]
    fields = [x for k, v in out.items() for x in _rank_desc(
        v, dev, final[k], 2 if k == "score" else int(k in _RANK_ZEROED))]
    ep = None
    if se is None:
        ep_args = [None] * 23
        ep_ints = [0, 0, 0, 0, 0, 0, 1, 1, 0, 0]
    else:
        ep = {"overflow": torch.empty(b, dtype=torch.bool, device=dev)
              if se["gate"] else se["overflow"],
              "lane_noop": torch.empty(b, dtype=torch.bool, device=dev)}
        cands = se["cands"]
        nc2 = cands["cand_nmm"].shape[1]
        if se["noop"]:
            ep["lane_ind"] = torch.empty((b, nc2), dtype=torch.bool,
                                         device=dev)
            ep["lane_term"] = torch.empty((b, nc2), dtype=torch.bool,
                                          device=dev)
        ep_args = [se["lengths"].contiguous(), se["overflow"].contiguous(),
                   cands["overflow_trunc"].contiguous(),
                   cands["ovf_bound"].contiguous(),
                   cands["hbound"].contiguous(),
                   ep["overflow"] if se["gate"] else None,
                   cands["cand_nmm"].contiguous(),
                   *(cands[k].contiguous() for k in _LANE_FEATURE_KEYS),
                   ep["lane_noop"], ep.get("lane_ind"), ep.get("lane_term")]
        ep_ints = [1, int(se["gate"]), se["lane_gate"], base.max_mismatches,
                   int(se["noop"]), nc2, se["k"], se["interval"],
                   base.indel_penalty_end, base.terminal_threshold]
    kbuild.launch("gsnap_rank_hits", dev, keys, fields, len(out), npaths,
                  *ep_args, b, ncand, nout, base.subopt_levels,
                  int(apply_optimal), *ep_ints)
    final["npaths"] = npaths
    return final, ep


def rank_hits(out, base: GsnapParams, apply_optimal: bool = True,
              maxout: int | None = None):
    """Dedup identical (kind, split, split2, mid, right, plusp, left)
    candidates, apply the optimal-score filter (``apply_optimal``: scores
    above the best + subopt_levels drop) and rank by (score, left, plus
    first, candidate order), keeping min(maxout, ncand) (kernel K14; the
    JAX package's rank_hits).  Returns a dict of [B, maxout] tensors
    (every field of ``out`` gathered; score BIG_NMM and left, right, mid,
    kind, split, split2, nindels, nmm 0 where no hit) plus npaths."""
    dev = out["score"].device
    if dev.type == "cpu":
        return _rank_hits_plain(out, base, apply_optimal, maxout)
    if dev.type == "cuda":
        return _rank_hits_cuda(out, base, apply_optimal, maxout)[0]
    raise ValueError(f"unsupported device {dev}")


def _lane_gate(params: GappedParams) -> int:
    """The lowest score at which a rescue lane could admit a dropped
    diagonal (the SE overflow gate's lane_gate)."""
    base = params.base
    lane_gate = min(base.indel_penalty_middle, base.indel_penalty_end,
                    base.terminal_threshold)
    if params.novelsplicing:
        # the splice solvers admit dropped diagonals at
        # localsplicing_penalty: only the floor-bound branch clears
        lane_gate = min(lane_gate, base.localsplicing_penalty)
    return lane_gate


def _rank_gate_se_plain(out, cands, lengths_i, k, interval,
                        params: GappedParams, gate: bool):
    base = params.base
    final = _rank_hits_plain(out, base)
    final.update(cands)
    if gate:
        # candidate-budget overflow gate (see the JAX function): rows
        # whose done level sits below every lane gate, or that have a hit
        # the dropped diagonals provably cannot reach, clear the flag;
        # with known sites every overflow row takes the wide lane
        budget = auto_budget(lengths_i, k, interval, base.max_mismatches)
        done = torch.minimum(budget, torch.where(
            final["npaths"] > 0, final["score"][:, 0], BIG_NMM))
        lane_gate = _lane_gate(params)
        so = base.subopt_levels
        safe = (((done + so < lane_gate)
                 | ((final["npaths"] > 0) & (final["hbound"] > done + so)))
                & (final["ovf_bound"] > done + so)
                & ~final["overflow_trunc"])
        final["overflow"] = final["overflow"] & ~safe
    final.pop("ovf_bound")
    final.pop("hbound")
    if base.trim_mismatch_score == -3:
        noop, ind_f, term_f = _lane_noop_device(
            final, final, lengths_i, k, interval, base)
        final["lane_noop"] = noop
        final["lane_ind"] = ind_f
        final["lane_term"] = term_f
    else:
        final["lane_noop"] = torch.zeros(lengths_i.shape[0],
                                         dtype=torch.bool,
                                         device=lengths_i.device)
    for key in _LANE_FEATURE_KEYS:
        final.pop(key)
    return final


def _rank_gate_se_cuda(out, cands, lengths_i, k, interval,
                       params: GappedParams, gate: bool):
    base = params.base
    se = dict(cands=cands, lengths=lengths_i, overflow=cands["overflow"],
              gate=gate, noop=base.trim_mismatch_score == -3,
              lane_gate=_lane_gate(params), k=k, interval=interval)
    final, ep = _rank_hits_cuda(out, base, se=se)
    final.update(cands)
    final.update(ep)
    for key in ("ovf_bound", "hbound", *_LANE_FEATURE_KEYS):
        final.pop(key)
    return final


def align_batch_gapped(genome, index: IndexArrays, codes, nflags, lengths,
                       params: GappedParams = GappedParams(),
                       index_minus: IndexArrays | None = None, alt=None,
                       known=None):
    """Single-end pipeline: substitutions + middle indels, plus local
    splices and short-exon doublesplices when ``params.novelsplicing``
    (novel sites) or ``known`` is given (known sites).  ``alt`` is the
    SNP-tolerant alt genome (ref16, flag16) that K3 also accepts as a
    match.  Returns the same keys as the JAX function:
    ranked [B, maxpaths] hit fields (kind, score, nmm, left, right,
    split, split2, mid, nindels, sense, prob_*, plusp), npaths, the
    unranked cand_* arrays, overflow / overflow_trunc and the lane-noop
    gate (lane_noop, lane_ind, lane_term)."""
    known = _check_known(known)
    out, cands = gather_candidates(genome, index, index_minus, codes, nflags,
                                   lengths, params, alt, known)
    # ranking (K14) and, as its epilogue on the card, the candidate-budget
    # overflow gate (off with known sites: every overflow row then takes
    # the wide lane) and the lane-noop gate
    args = (out, cands, lengths.int(), index.k, index.interval, params,
            known is None)
    if codes.device.type == "cpu":
        return _rank_gate_se_plain(*args)
    if codes.device.type == "cuda":
        return _rank_gate_se_cuda(*args)
    raise ValueError(f"unsupported device {codes.device}")
