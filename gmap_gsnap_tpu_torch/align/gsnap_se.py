"""GSNAP single-end seed -> vote -> verify (counterpart of
gmap_gsnap_tpu/align/gsnap_se.py).

Holds kernels K1 (:func:`seed_diagonals`, the JAX package's
_extract_oligos + _seed_rank_map + _seed_diagonals), K2
(:func:`top_diagonals`, its _top_diagonals), K15
(:func:`qpos_ranges`, its _qpos_ranges) and K17 (:func:`pack_batch`, its
_pack_device + _revcomp_batch), each with its plain torch version beside
it.  CPU tensors take the plain version; CUDA tensors
launch the kernel in ``csrc/`` or raise.

Coordinates and diagonals are int64 tensors holding uint32 values
(torch's uint32 lacks shifts, compares and arithmetic on the CPU);
INVALID_DIAG = 0xFFFFFFFF stays the largest value, so it still sorts
last.  Orderings that JAX builds from ``lax.top_k`` (ties to the lower
index) and stable argsorts are stable sorts here too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import limits as klimits
from ..ops import genome as genome_ops
from ..ops import mismatch as mm_ops
from ..ops.genome import u32
from ..ops.mismatch import INVALID_DIAG
from ..utils.device import resolve_device

BIG_NMM = 10**6


@dataclass
class IndexArrays:
    """K-mer positional index on one device.

    offsets int32[4^k + 1] and positions int32[N] hold the uint32 bits
    of the index files (4.3 GB of offsets at k=15 stay 32-bit).  The
    JAX package's ``startcnt`` packing and positions padding are TPU
    gather workarounds and are not carried over."""

    offsets: torch.Tensor
    positions: torch.Tensor
    k: int
    interval: int

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @classmethod
    def from_host(cls, offsets: np.ndarray, positions: np.ndarray, k: int,
                  interval: int, device) -> "IndexArrays":
        dev = resolve_device(device)
        return cls(genome_ops.words_to_device(offsets, dev),
                   genome_ops.words_to_device(positions, dev),
                   int(k), int(interval))


def dynamic_size_threshold(npositions: int, k: int, mode: str) -> int:
    """The reference's overabundance policy (gsnap.c:2094-2098), as in
    gmap_gsnap_tpu/align/gsnap_se.py."""
    n = 3 ** k if mode != "standard" else 4 ** k
    return max(int(10.0 * npositions / n), 100)


@dataclass(frozen=True)
class GsnapParams:
    """Pipeline configuration; a field-for-field copy of
    gmap_gsnap_tpu.align.gsnap_se.GsnapParams (same names and defaults,
    see that class for each field's reference citation)."""

    seed_total: int = 384
    size_threshold: int = 100
    ncand: int = 32
    maxpaths: int = 100
    max_mismatches: int = -1
    subopt_levels: int = 0
    mode: str = "standard"
    snp_tolerant: bool = False
    indel_penalty_middle: int = 2
    indel_penalty_end: int = 2
    min_indel_end_matches: int = 4
    max_middle_insertions: int = 9
    max_middle_deletions: int = 30
    max_end_insertions: int = 3
    max_end_deletions: int = 6
    localsplicing_penalty: int = 0
    distantsplicing_penalty: int = 1
    min_distant_end_matches: int = 16
    min_shortend: int = 2
    shortsplicedist: int = 200_000
    pairmax_dna: int = 1_000
    pairmax_rna: int = 200_000
    terminal_threshold: int = 2
    trim_mismatch_score: int = -3
    trim_indel_score: int = -4
    gmap_mode: str = "pairsearch,indel_knownsplice,terminal,improvement"
    trigger_score_for_gmap: int = 5
    max_gmap_pairsearch: int = 10
    max_gmap_terminal: int = 50
    max_gmap_improvement: int = 5
    gmap_min_coverage: float = 0.5
    microexon_spliceprob: float = 0.95
    uniform_len: bool = False
    antistranded_penalty: int = 0
    expected_pairlength: int = 200
    pairlength_deviation: int = 25


def _extract_oligos(codes: torch.Tensor, nflags: torch.Tensor,
                    lengths: torch.Tensor, k: int):
    """Every k-mer of each read packed MSB-first.  codes uint8[B, L] ->
    (oligos int64[B, S], valid bool[B, S]) with S = L - k + 1."""
    b, lmax = codes.shape
    s = lmax - k + 1
    c = codes.long()
    oligo = torch.zeros((b, s), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((b, s), dtype=torch.int32, device=codes.device)
    for i in range(k):
        oligo = (oligo << 2) | c[:, i : i + s]
        bad = bad + nflags[:, i : i + s].int()
    qpos = torch.arange(s, device=codes.device)[None, :]
    valid = (bad == 0) & (qpos + k <= lengths[:, None])
    return oligo, valid


def _seed_grid_width(s: int, params: GsnapParams) -> int:
    """Compact-grid width for S oligos: seed_total slots, or the exact
    maximum (S * size_threshold) when seed_total == 0."""
    wmax = s * params.size_threshold
    return wmax if params.seed_total == 0 else min(params.seed_total, wmax)


def _phase_min(ok: torch.Tensor, q: int) -> torch.Tensor:
    """min over the q sampling phases of the per-phase count of ``ok``
    oligos, capped at their total."""
    ph = torch.arange(ok.shape[1], device=ok.device) % q
    counts = torch.stack([(ok & (ph == c)).sum(1) for c in range(q)], 1)
    return torch.minimum(counts.min(1).values, ok.sum(1)).int()


def _seed_diagonals_plain(index: IndexArrays, codes, nflags, lengths,
                          params: GsnapParams, half: bool, pos_lo: int = 0,
                          pos_len: int | None = None):
    oligos, valid = _extract_oligos(codes, nflags, lengths, index.k)
    b, s = oligos.shape
    dev = codes.device
    off = index.offsets
    start = u32(off[oligos])
    end = u32(off[(oligos + 1).clamp(max=off.shape[0] - 1)])
    count = end - start
    usable = valid & (count > 0) & (count <= params.size_threshold)
    ccap = torch.where(usable, count, 0)
    cum = torch.cumsum(ccap, 1)
    total = cum[:, -1]
    w = _seed_grid_width(s, params)
    trunc = total > w
    cum_ex = cum - ccap
    # slot t belongs to the last usable oligo whose first slot is <= t
    # (JAX: scatter at each oligo's first slot, drop slots >= w, then a
    # running max); past the read's total, to its last usable oligo
    o_iota = torch.arange(s, device=dev).expand(b, s)
    slot = torch.where(usable & (cum_ex < w), cum_ex, w)
    o_mark = torch.full((b, w + 1), -1, dtype=torch.int64, device=dev)
    o_mark = o_mark.scatter_reduce(1, slot, torch.where(usable, o_iota, -1),
                                   "amax")[:, :w]
    o_idx = torch.cummax(o_mark, 1).values.clamp(0, s - 1)
    t = torch.arange(w, device=dev)[None, :]
    valid_slot = t < total.clamp(max=w)[:, None]
    delta = start - cum_ex
    gpos = torch.where(valid_slot, t + torch.gather(delta, 1, o_idx), 0)
    npos = index.positions.shape[0]
    if pos_len is None:
        pos_len = npos
    # a shard resolves the slots whose global element it holds
    own = valid_slot & (gpos >= pos_lo) & (gpos < pos_lo + pos_len)
    pos = u32(index.positions[(gpos - pos_lo).clamp(0, npos - 1)])
    ok = own & (pos >= o_idx)
    diag = torch.where(ok, pos - o_idx, INVALID_DIAG)

    q = index.interval
    bound_ok = valid & (count <= params.size_threshold)
    nphase_min = _phase_min(bound_ok, q)
    if half:
        qp = torch.arange(s, device=dev)[None, :]
        half_l = lengths.long()[:, None] // 2
        left = bound_ok & (qp + index.k <= half_l)
        right = bound_ok & (qp >= half_l)
        nph_half = torch.minimum(_phase_min(left, q), _phase_min(right, q))
    else:
        nph_half = torch.zeros(b, dtype=torch.int32, device=dev)
    return diag, o_idx.int(), trunc, nphase_min, nph_half


def _seed_diagonals_cuda(index: IndexArrays, codes, nflags, lengths,
                         params: GsnapParams, half: bool, pos_lo: int = 0,
                         pos_len: int | None = None):
    b, lmax = codes.shape
    s = lmax - index.k + 1
    if (s < 1 or s > klimits.SEED_MAX_S or index.interval > 32
            or index.k > 16):
        raise ValueError(f"seed kernel: S={s} (1..{klimits.SEED_MAX_S}), "
                         f"interval={index.interval} (<= 32), k={index.k} "
                         f"(<= 16)")
    w = _seed_grid_width(s, params)
    dev = codes.device
    diag = torch.empty((b, w), dtype=torch.int64, device=dev)
    qpos = torch.empty((b, w), dtype=torch.int32, device=dev)
    trunc = torch.empty(b, dtype=torch.bool, device=dev)
    nphase_min = torch.empty(b, dtype=torch.int32, device=dev)
    nph_half = torch.empty(b, dtype=torch.int32, device=dev)
    kbuild.launch(
        "gsnap_seed_diagonals", dev,
        codes.to(torch.uint8).contiguous(), nflags.contiguous(),
        lengths.int().contiguous(), index.offsets, index.positions,
        diag, qpos, trunc, nphase_min, nph_half,
        b, lmax, index.k, index.interval, params.size_threshold, w,
        int(half), index.offsets.shape[0], index.positions.shape[0],
        pos_lo, index.positions.shape[0] if pos_len is None else pos_len)
    return diag, qpos, trunc, nphase_min, nph_half


def seed_diagonals(index: IndexArrays, codes, nflags, lengths,
                   params: GsnapParams, half: bool = True, pos_lo: int = 0,
                   pos_len: int | None = None):
    """Candidate diagonals on the compact seed grid (kernel K1).

    codes uint8[B, L] (2-bit codes 0..3), nflags bool[B, L], lengths
    int32[B] ->
    ``(diag int64[B, W], qpos int32[B, W], trunc bool[B],
    nphase_min int32[B], nph_half int32[B])`` with W =
    _seed_grid_width(S, params):

    * every k-mer (no N, inside the read) whose position count is in
      (0, size_threshold] lays its full position list into the read's W
      shared slots, in query-position order; ``trunc`` = the lists
      overflowed W;
    * diag = position - query position (INVALID_DIAG in empty slots or
      below genome start); qpos = the owning oligo;
    * nphase_min / nph_half: the pigeonhole inputs (min per-phase count
      of in-threshold k-mers, over the read / over its weaker half;
      nph_half is 0 when ``half`` is False).

    ``index.positions`` may be one shard of the positions array, holding
    global elements [pos_lo, pos_lo + pos_len) (default: the whole array):
    a slot whose global element lies outside them is INVALID_DIAG, so the
    MIN over the shards is the whole array's diag.  A
    parallel.shard.ShardedIndexArrays index takes that route
    (parallel.shard.sharded_seed_diagonals, as JAX's _seed_diagonals
    :333)."""
    from ..parallel import shard

    if isinstance(index, shard.ShardedIndexArrays):
        return shard.sharded_seed_diagonals(index, codes, nflags, lengths,
                                            params, half)
    args = (index, codes, nflags, lengths, params, half, pos_lo, pos_len)
    if codes.device.type == "cpu":
        return _seed_diagonals_plain(*args)
    if codes.device.type == "cuda":
        return _seed_diagonals_cuda(*args)
    raise ValueError(f"unsupported device {codes.device}")


def _top_diagonals_plain(diag: torch.Tensor, ncand: int):
    d = torch.sort(diag, dim=1).values     # INVALID sorts last
    b, n = d.shape
    dev = d.device
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       d[:, 1:] != d[:, :-1]], 1)
    idx = torch.arange(n, device=dev).expand(b, n)
    start = torch.cummax(torch.where(first, idx, -1), 1).values
    is_last = torch.cat([first[:, 1:],
                         torch.ones((b, 1), dtype=torch.bool, device=dev)], 1)
    last = torch.cummin(torch.where(is_last, idx, 2**30).flip(1),
                        1).values.flip(1)
    is_head = first & (d != INVALID_DIAG)
    votes = torch.where(is_head, last - start + 1, 0)
    # (votes desc, index asc) == lax.top_k's lower-index tie rule
    order = torch.argsort(-votes, dim=1, stable=True)[:, :ncand]
    top_v = torch.gather(votes, 1, order)
    top_d = torch.where(top_v > 0, torch.gather(d, 1, order), INVALID_DIAG)
    return top_d, top_v.int(), is_head.sum(1).int()


TOP_DIAG_MAX_W = 32768
# the kernel's shared memory holds the sorted row and the selected keys
TOP_DIAG_MAX_NC = 16384
# wider rows (the runner's exact seed grid for long reads) take the
# kernel's wide path: votes and positions in 24 bits, the selected keys
# sorted in shared memory, two scratch rows of uint32 a row
TOP_DIAG_WIDE_MAX_W = (1 << 24) - 1
TOP_DIAG_WIDE_MAX_NC = 1024
TOP_DIAG_WIDE_SCRATCH = 1 << 28    # bytes of scratch a launch, at most


def _top_diagonals_cuda(diag: torch.Tensor, ncand: int):
    b, w = diag.shape
    wide = w > TOP_DIAG_MAX_W
    if (w > TOP_DIAG_WIDE_MAX_W or ncand > w
            or ncand > (TOP_DIAG_WIDE_MAX_NC if wide else TOP_DIAG_MAX_NC)):
        raise ValueError(f"top_diagonals kernel: W={w} must be <= "
                         f"{TOP_DIAG_WIDE_MAX_W} and >= ncand={ncand}, and "
                         f"ncand <= {TOP_DIAG_MAX_NC} "
                         f"({TOP_DIAG_WIDE_MAX_NC} past W={TOP_DIAG_MAX_W})")
    dev = diag.device
    top_d = torch.empty((b, ncand), dtype=torch.int64, device=dev)
    votes = torch.empty((b, ncand), dtype=torch.int32, device=dev)
    ndistinct = torch.empty(b, dtype=torch.int32, device=dev)
    diag = diag.contiguous()
    if not wide:
        kbuild.launch("gsnap_top_diagonals", dev, diag, top_d, votes,
                      ndistinct, b, w, ncand)
        return top_d, votes, ndistinct
    # a launch a slice of rows, so that the scratch stays bounded
    rows = max(1, TOP_DIAG_WIDE_SCRATCH // (8 * w))
    scratch = torch.empty((min(rows, b), 2, w), dtype=torch.int32,
                          device=dev)
    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        kbuild.launch("gsnap_top_diagonals_wide", dev, diag[r0:r1],
                      top_d[r0:r1], votes[r0:r1], ndistinct[r0:r1], scratch,
                      r1 - r0, w, ncand)
    return top_d, votes, ndistinct


def top_diagonals(diag: torch.Tensor, ncand: int):
    """Sort each read's diagonals, count votes by run length and keep
    the top ``ncand`` distinct diagonals by (votes desc, diag asc)
    (kernel K2).  diag int64[B, W] -> (top_d int64[B, ncand] with
    INVALID_DIAG where the read has fewer, votes int32[B, ncand],
    ndistinct int32[B])."""
    if diag.device.type == "cpu":
        return _top_diagonals_plain(diag, ncand)
    if diag.device.type == "cuda":
        return _top_diagonals_cuda(diag, ncand)
    raise ValueError(f"unsupported device {diag.device}")


def _qpos_ranges_plain(diag_grid, qpos_grid, d_sel):
    """First/last seed query position per selected diagonal (reference
    Segment querypos5/querypos3, stage1hr.c:9000), from the unsorted
    seed grid.  Row chunks bound the [rows, P, W] compare's memory."""
    b, p = d_sel.shape
    w = diag_grid.shape[1]
    rows = max(1, (1 << 26) // max(p * w, 1))
    qp5, qp3 = [], []
    for r0 in range(0, b, rows):
        eq = diag_grid[r0 : r0 + rows, None, :] == d_sel[r0 : r0 + rows, :, None]
        qpos = qpos_grid[r0 : r0 + rows, None, :]
        qp5.append(torch.where(eq, qpos, 2**30).min(2).values)
        qp3.append(torch.where(eq, qpos, -1).max(2).values)
    return torch.cat(qp5), torch.cat(qp3)


# the kernel sorts a read's selected diagonals in one warp's registers
QPOS_RANGES_MAX_P = 1024


def _qpos_ranges_cuda(diag_grid, qpos_grid, d_sel):
    b, p = d_sel.shape
    if p > QPOS_RANGES_MAX_P:
        raise ValueError(f"qpos_ranges kernel: {p} selected diagonals, at "
                         f"most {QPOS_RANGES_MAX_P}")
    dev = d_sel.device
    qp5 = torch.empty((b, p), dtype=torch.int32, device=dev)
    qp3 = torch.empty((b, p), dtype=torch.int32, device=dev)
    kbuild.launch("gsnap_qpos_ranges", dev, diag_grid.contiguous(),
                  qpos_grid.int().contiguous(), d_sel.contiguous(), qp5, qp3,
                  b, diag_grid.shape[1], p)
    return qp5, qp3


def qpos_ranges(diag_grid, qpos_grid, d_sel):
    """First/last seed query position per selected diagonal (kernel K15;
    reference Segment querypos5/querypos3, stage1hr.c:9000): for diag_grid
    int64[B, W] and qpos_grid int32[B, W] (the unsorted seed grid of
    :func:`seed_diagonals`) and d_sel int64[B, P], (qp5, qp3) int32[B, P]:
    the min and max qpos of the slots whose diagonal equals d_sel (2^30
    and -1 where none does).  The kernel compares diagonals on 32 bits:
    one outside [0, 2^32) (K1 and K2 make none) stops it with a trap."""
    if d_sel.device.type == "cpu":
        return _qpos_ranges_plain(diag_grid, qpos_grid, d_sel)
    if d_sel.device.type == "cuda":
        return _qpos_ranges_cuda(diag_grid, qpos_grid, d_sel)
    raise ValueError(f"unsupported device {d_sel.device}")


def _verify(genome, queries, diags, lengths, conversion=None, alt=None):
    """Exact mismatch counts of candidate diagonals: int32[B, NC]
    (BIG_NMM where unplaceable) — the K3 prefix sums at each read's
    length."""
    _, pref = mm_ops.prefix_mismatches(genome, queries, diags, lengths,
                                       conversion, alt)
    ok, _ = mm_ops._placements(genome, diags, lengths)
    nmm = torch.gather(pref, 2, lengths.long()[:, None, None].expand(
        -1, diags.shape[1], 1))[:, :, 0]
    return torch.where(ok, nmm, BIG_NMM)


_MODE_CONV = {
    # (plus-strand conversion, minus-strand conversion)
    "standard": (None, None),
    "cmet-stranded": ("ct", "ga"),
    "atoi-stranded": ("ag", "tc"),
}


def _convert_codes(codes, conversion):
    """cmet/atoi nucleotide conversion of unpacked codes."""
    if conversion is None:
        return codes
    src, dst = {"ct": (1, 3), "ga": (2, 0), "ag": (0, 2), "tc": (3, 1)}[conversion]
    return torch.where(codes == src, dst, codes).to(codes.dtype)


def auto_budget(lengths: torch.Tensor, k: int, interval: int,
                max_mismatches: int) -> torch.Tensor:
    """Per-read mismatch budget: -m, or gsnap's auto level
    (stage1hr.c:11900) (L + interval - 1)/spansize - 2, clamped >= 0."""
    if max_mismatches >= 0:
        return torch.full_like(lengths, max_mismatches, dtype=torch.int32)
    spansize = -(-k // interval) * interval
    return torch.clamp((lengths + interval - 1) // spansize - 2, min=0).int()


def align_batch(genome, index: IndexArrays, codes, nflags, lengths,
                params: GsnapParams = GsnapParams(),
                index_minus: IndexArrays | None = None, alt=None):
    """Mismatch-only single-end alignment (no indels / splicing).

    Returns dict of [B, maxpaths] arrays: left int64 (plus-strand start
    of the alignment), plusp bool, nmm int32 (BIG_NMM = empty slot);
    plus npaths int32[B] and best_nmm int32[B]."""
    b, lmax = codes.shape
    lengths = lengths.int()
    conv_plus, conv_minus = _MODE_CONV[params.mode]
    if index_minus is None:
        index_minus = index

    queries_fwd, codes_rc, nflags_rc, queries_rev = pack_batch(
        codes, nflags, lengths, params.uniform_len)

    diag_f = seed_diagonals(index, _convert_codes(codes, conv_plus), nflags,
                            lengths, params, half=False)[0]
    diag_r = seed_diagonals(index_minus, _convert_codes(codes_rc, conv_minus),
                            nflags_rc, lengths, params, half=False)[0]
    top_f = top_diagonals(diag_f, params.ncand)[0]
    top_r = top_diagonals(diag_r, params.ncand)[0]
    nmm_f = _verify(genome, queries_fwd, top_f, lengths, conv_plus, alt)
    nmm_r = _verify(genome, queries_rev, top_r, lengths, conv_minus, alt)
    budget = auto_budget(lengths, index.k, index.interval,
                         params.max_mismatches)

    all_left = torch.cat([top_f, top_r], 1)
    all_nmm = torch.cat([nmm_f, nmm_r], 1)
    all_plus = torch.cat([torch.ones_like(nmm_f, dtype=torch.bool),
                          torch.zeros_like(nmm_r, dtype=torch.bool)], 1)
    all_nmm = torch.where(all_nmm <= budget[:, None], all_nmm, BIG_NMM)

    # rank by (nmm asc, left asc, plus before minus) via stable passes
    take = torch.gather
    ord1 = torch.argsort((~all_plus).int(), dim=1, stable=True)
    ord2 = torch.argsort(take(all_left, 1, ord1), dim=1, stable=True)
    perm2 = take(ord1, 1, ord2)
    left2 = take(all_left, 1, perm2)
    nmm2 = take(all_nmm, 1, perm2)
    plus2 = take(all_plus, 1, perm2)

    # drop duplicates of the same (left, strand) before the final sort
    key = left2 * 2 + (~plus2).long()
    dup = torch.cat([torch.zeros_like(plus2[:, :1]),
                     key[:, 1:] == key[:, :-1]], 1) & (nmm2 < BIG_NMM)
    nmm2 = torch.where(dup, BIG_NMM, nmm2)
    best = nmm2.min(1, keepdim=True).values
    nmm2 = torch.where(nmm2 > best + params.subopt_levels, BIG_NMM, nmm2)

    ord3 = torch.argsort(nmm2, dim=1, stable=True)[:, : params.maxpaths]
    left = take(left2, 1, ord3)
    nmm = take(nmm2, 1, ord3)
    plusp = take(plus2, 1, ord3)
    valid_hit = nmm < BIG_NMM
    return {
        "left": torch.where(valid_hit, left, 0),
        "plusp": plusp,
        "nmm": nmm,
        "npaths": valid_hit.sum(1).int(),
        "best_nmm": nmm.min(1).values,
    }


def _pack_device_plain(codes, nflags, lengths,
                      lmax: int) -> mm_ops.PackedQueries:
    """Device-side pack_queries (JAX gsnap_se.py:547)."""
    b = codes.shape[0]
    w = (lmax + 15) // 16
    pad = w * 16 - lmax
    idx = torch.arange(lmax, device=codes.device)[None, :]
    nf = nflags | (idx >= lengths[:, None])
    c = codes.long()
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
        nf = torch.nn.functional.pad(nf, (0, pad), value=True)
    sh = torch.arange(16, device=codes.device)
    codes16 = (c.reshape(b, w, 16) << (2 * sh)).sum(2)
    nflags16 = (nf.long().reshape(b, w, 16) << sh).sum(2)
    return mm_ops.PackedQueries(codes16, nflags16, lengths, lmax)


def _revcomp_batch_plain(codes, nflags, lengths, uniform: bool = False):
    """Per-read reverse complement honoring individual lengths (JAX
    gsnap_se.py:565); with ``uniform`` (every length == lmax) a flip."""
    if uniform:
        return codes.flip(1) ^ 3, nflags.flip(1)
    b, lmax = codes.shape
    idx = torch.arange(lmax, device=codes.device)[None, :]
    src = lengths.long()[:, None] - 1 - idx
    ok = src >= 0
    src = src.clamp(0, lmax - 1)
    rc = torch.gather(codes, 1, src) ^ 3
    rn = torch.gather(nflags, 1, src)
    return torch.where(ok, rc, 0).to(codes.dtype), rn | ~ok


def _pack_batch_plain(codes, nflags, lengths, uniform: bool = False):
    lmax = codes.shape[1]
    codes_rc, nflags_rc = _revcomp_batch_plain(codes, nflags, lengths,
                                               uniform)
    return (_pack_device_plain(codes, nflags, lengths, lmax), codes_rc,
            nflags_rc, _pack_device_plain(codes_rc, nflags_rc, lengths, lmax))


def _pack_batch_cuda(codes, nflags, lengths, uniform: bool = False):
    """K17 (``csrc/pack_queries.cu``): one launch, no other device op
    where lengths is already int32 and the inputs contiguous, as on every
    path.  Raises on inputs the kernel does not take (kbuild.launch on a
    tensor of another device)."""
    if codes.dtype != torch.uint8 or nflags.dtype != torch.bool:
        raise TypeError(f"pack_batch: codes {codes.dtype} / nflags "
                        f"{nflags.dtype}, expected uint8 / bool")
    if (codes.dim() != 2 or nflags.shape != codes.shape
            or lengths.shape != codes.shape[:1]):
        raise ValueError(f"pack_batch: codes {tuple(codes.shape)}, nflags "
                         f"{tuple(nflags.shape)}, lengths "
                         f"{tuple(lengths.shape)}; expected [B, L], [B, L], "
                         f"[B]")
    b, lmax = codes.shape
    dev = codes.device
    w = (lmax + 15) // 16
    words = [torch.empty((b, w), dtype=torch.int64, device=dev)
             for _ in range(4)]
    codes_rc = torch.empty_like(codes)
    nflags_rc = torch.empty_like(nflags)
    lengths = lengths.int().contiguous()
    kbuild.launch("gsnap_pack_queries", dev, codes.contiguous(),
                  nflags.contiguous(), lengths, words[0], words[1], codes_rc,
                  nflags_rc, words[2], words[3], b, lmax, w, int(uniform))
    return (mm_ops.PackedQueries(words[0], words[1], lengths, lmax),
            codes_rc, nflags_rc,
            mm_ops.PackedQueries(words[2], words[3], lengths, lmax))


def pack_batch(codes, nflags, lengths, uniform: bool = False):
    """A read batch packed 16 bases a word, its per-read reverse
    complement and that packed too (kernel K17; JAX _pack_device :547 and
    _revcomp_batch :565): codes uint8 [B, L], nflags bool [B, L], lengths
    int32 [B] -> (queries_fwd, codes_rc, nflags_rc, queries_rev).
    ``uniform`` asserts every length == L: the reverse complement is then
    a flip."""
    if codes.device.type == "cpu":
        return _pack_batch_plain(codes, nflags, lengths, uniform)
    if codes.device.type == "cuda":
        return _pack_batch_cuda(codes, nflags, lengths, uniform)
    raise ValueError(f"unsupported device {codes.device}")
