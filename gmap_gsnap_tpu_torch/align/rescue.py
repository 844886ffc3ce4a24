"""Terminal hits + GMAP rescue + final hit selection (host side).

A copy of gmap_gsnap_tpu/align/rescue.py; ``trim_term`` calls the
port runner's ``trim_ends``.

Implements the tail of the reference's align_end (stage1hr.c:12400-12530):

  * find_terminals (stage1hr.c:9012): one-sided partial alignments on
    seeded diagonals, gated by done_level >= terminal_threshold (2),
    trimmed with the TERM end policy and accepted when the trimmed
    region has <= done_level mismatches and covers > min(L/3, 40) nt;
  * GMAP terminal/improvement passes (stage1hr.c:12437-12521 +
    align_singleend_with_gmap :11767): each terminal (and each kept
    terminal with total trim >= 8) is re-aligned with the GMAP stack;
    the GMAP hit survives when it has strictly more matches;
  * Stage3end_optimal_score (stage3hr.c) "eventrim" selection: hits are
    compared on mismatches inside a COMMON trimmed region derived from
    the minimum trims of non-terminal hits, so trimmed/untrimmed/GMAP
    alignments rank consistently; terminals are exempt until the final
    pass.

Hits here are host-side wrappers around the printable PostHit details;
the device pipeline supplies both the ranked hits and the unfiltered
candidate diagonals (cand_* arrays) that seed the terminal lane.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TERMINAL_THRESHOLD = 2     # gsnap.c:182
TERMINAL_MINLENGTH = 40    # stage3hr.c:39
GMAP_IMPROVEMENT_TRIM = 8  # align_singleend_with_gmap trim trigger
MAX_GMAP_TERMINAL = 50     # gsnap.c max_gmap_terminal
PENALTY = {"sub": 0, "ins": 2, "del": 2, "splice": 0,
           "shortexon": 0, "terminal": 0, "gmap": 0}


@dataclass
class HostHit:
    d: object                 # PostHit (printable details)
    hittype: str
    nmatches: int             # reference whole-region nmatches
    mm_positions: np.ndarray  # selection-mismatch positions (aligned coords)
    loglik: float = 0.0
    keep: bool = True

    @property
    def penalties(self) -> int:
        if self.hittype == "distant":
            return self.d.distant["penalty"]
        return PENALTY[self.hittype]


def trim_term(mm: np.ndarray, side: str) -> int:
    """TERM-end trimming (substring.c trim_left_end / trim_right_end with
    trim_mismatch_score -3); mm is the mismatch vector of the candidate
    span.  Returns the trim amount for the requested side."""
    from .runner import trim_ends

    t5, t3 = trim_ends(mm, trim_mismatch_score=-3)
    return t5 if side == "left" else t3


def make_terminals(mm_fn, cand_left, cand_plusp, cand_nmm, L: int,
                   max_mm: int, max_terminal_length: int, used=(),
                   k: int = 12, interval: int = 3, trims_of=None):
    """Build terminal candidates from unfiltered diagonals
    (find_terminals, stage1hr.c:9012).

    Two branches like the reference: segments whose SEED span exceeds
    index1part create a terminal outright (trimming only TERM-typed
    ends); short-seed segments need a clean-enough prefix/suffix.  The
    acceptance gates are Substring_new's: trimmed length strictly over
    min(L/3, 40) and the goodness test matches - 3*mismatches >= 0 —
    there is NO done-level cap on trimmed mismatches.

    used: diagonals consumed by sub/indel/splice hits — marked usedp in
    the reference and skipped.
    Returns list of (left, plusp, trim5, trim3, nmm_trim, positions)."""
    minlength = min(L // 3, TERMINAL_MINLENGTH)
    mtl = min(max_terminal_length, L // 2)
    lastpos = L - k
    seedpos = list(range(0, max(lastpos, 0) + 1, interval))
    if lastpos > 0 and lastpos not in seedpos:
        seedpos.append(lastpos)
    out = []
    seen = set(used)
    for left, plusp, nmm_full in zip(cand_left, cand_plusp, cand_nmm):
        left = int(left)
        plusp = bool(plusp)
        if nmm_full >= 10**6 or (left, plusp) in seen:
            continue
        seen.add((left, plusp))
        mm = mm_fn(left, plusp)
        pos = np.flatnonzero(mm)
        npos = len(pos)
        trims = trims_of(left, plusp) if trims_of is not None else None
        if trims is None:
            trims = (None, None)

        def trim_side(side):
            t = trims[0 if side == "left" else 1]
            return t if t is not None else trim_term(mm, side)

        variants = []
        # clean k-window test for all seed positions at once
        cs = np.concatenate([[0], np.cumsum(mm.astype(np.int32))])
        sp = np.asarray(seedpos)
        clean = cs[np.minimum(sp + k, len(mm))] - cs[sp] == 0
        present = sp[clean].tolist()
        if present and present[-1] - present[0] > k:
            # long seed span: liberal terminal, trim TERM-typed ends
            start_term = present[0] >= interval
            end_term = present[-1] < lastpos - interval
            t5 = trim_side("left") if start_term else 0
            t3 = trim_side("right") if end_term else 0
            variants.append((t5, t3))
        else:
            # short seed span: need a clean-enough end run
            if npos <= max_mm or pos[max_mm] > mtl:
                variants.append((0, trim_side("right")))
            if npos <= max_mm or pos[npos - 1 - max_mm] < L - mtl:
                variants.append((trim_side("left"), 0))
        for t5, t3 in variants:
            span = L - t5 - t3
            nmm_trim = int(mm[t5 : L - t3].sum())
            if span <= minlength:
                continue
            if (span - nmm_trim) - 3 * nmm_trim < 0:
                continue  # Substring_new general goodness test
            if nmm_trim > max_mm:
                continue  # Stage3end_new_terminal recompute gate
            if t5 == 0 and t3 == 0 and nmm_full <= max_mm:
                continue  # indistinguishable from a sub hit
            out.append((left, plusp, t5, t3, nmm_trim, pos))
    return out


def _read_trims(h: HostHit) -> tuple[int, int]:
    """Trims in READ orientation (Substring trim_left/trim_right are
    query-coordinate trims; minus-strand aligned trims swap)."""
    if h.d.plusp:
        return h.d.trim5, h.d.trim3
    return h.d.trim3, h.d.trim5


def _read_mmpos(h: HostHit, L: int) -> np.ndarray:
    p = np.asarray(h.mm_positions, int)
    return p if h.d.plusp else (L - 1 - p)


def common_region(hits: list[HostHit], L: int, finalp: bool):
    """Stage3end_optimal_score_aux trim computation (READ coords)."""
    min_tl = min_tr = 10**6
    max_tl_term = max_tr_term = 0
    for h in hits:
        tl, tr = _read_trims(h)
        if not finalp and h.hittype == "terminal":
            max_tl_term = max(max_tl_term, tl)
            max_tr_term = max(max_tr_term, tr)
        else:
            min_tl = min(min_tl, tl)
            min_tr = min(min_tr, tr)
    tl = max_tl_term if min_tl == 10**6 else max(max_tl_term, min_tl)
    tr = max_tr_term if min_tr == 10**6 else max(max_tr_term, min_tr)
    return tl, tr


def eventrim_score(h: HostHit, tl: int, tr: int, L: int) -> int:
    """Mismatches of this hit inside READ region [tl, L - tr) +
    penalties; GMAP hits additionally pay for their own uncovered ends
    beyond the region."""
    mmp = _read_mmpos(h, L)
    inregion = int(((mmp >= tl) & (mmp < L - tr)).sum())
    score = inregion + h.penalties
    htl, htr = _read_trims(h)
    if h.hittype == "gmap":
        if htl > tl:
            score += htl - tl
        if htr > tr:
            score += htr - tr
    return score


def optimal_pass(hits: list[HostHit], L: int, finalp: bool,
                 keep_gmap: bool, subopt: int = 0,
                 cutoff: int | None = None) -> list[HostHit]:
    if len(hits) <= 1 and cutoff is None:
        return hits
    if not hits:
        return hits
    tl, tr = common_region(hits, L, finalp)
    scores = {id(h): eventrim_score(h, tl, tr, L) for h in hits}
    contenders = [h for h in hits if finalp or h.hittype != "terminal"]
    if not contenders:
        return hits
    minscore = min(scores[id(h)] for h in contenders) + subopt
    out = []
    for h in hits:
        if not finalp and h.hittype == "terminal":
            out.append(h)
        elif keep_gmap and h.hittype == "gmap":
            out.append(h)
        elif cutoff is not None and scores[id(h)] > cutoff:
            # Stage3end_optimal_score cutoff_level elimination
            pass
        elif scores[id(h)] <= minscore:
            out.append(h)
    return out


# Hittype_T enum order (stage3hr.h:21-24): ties in overlap resolution go
# to the LOWER hittype
HITTYPE_ORDER = {"sub": 1, "ins": 2, "del": 3, "splice": 6, "distant": 6,
                 "shortexon": 7, "gmap": 12, "terminal": 13}


def remove_overlaps(hits: list[HostHit], finalp: bool) -> list[HostHit]:
    """Keep the best hit per overlapping genomic locus (same strand).

    Simplified Stage3end_remove_overlaps with hit_goodness_cmp's key
    order (stage3hr.c:4385): nmatches_posttrim first, then lower
    hittype; terminals neither win nor lose before the final pass."""
    hits = sorted(
        hits, key=lambda h: (-h.d.nmatches, HITTYPE_ORDER[h.hittype])
    )
    kept: list[HostHit] = []
    for h in hits:
        lo = h.d.left
        hi = h.d.left + h.d.trim5 + h.d.ref_consumed + h.d.trim3
        dup = False
        for k in kept:
            if k.d.plusp != h.d.plusp:
                continue
            if not finalp and (k.hittype == "terminal" or h.hittype == "terminal"):
                continue  # terminals tie pre-final (hit_goodness_cmp)
            klo = k.d.left
            khi = k.d.left + k.d.trim5 + k.d.ref_consumed + k.d.trim3
            if lo < khi and klo < hi:  # overlap
                dup = True
                break
        if not dup:
            kept.append(h)
    return kept


def select_final(hits: list[HostHit], L: int, improvement_fn=None,
                 subopt: int = 0, cutoff: int | None = None) -> list[HostHit]:
    """The reference's post-cascade selection ladder (align_end tail).

    cutoff: the per-read cutoff_level (user_maxlevel); final passes
    eliminate hits whose eventrim score exceeds it (Stage3end_
    optimal_score).  Pass None for paired-end PRE-pairing selection,
    where per-end cutoffs do not apply."""
    if not hits:
        return hits
    hits = optimal_pass(hits, L, finalp=False, keep_gmap=True, subopt=subopt)
    hits = remove_overlaps(hits, finalp=False)
    hits = optimal_pass(hits, L, finalp=False, keep_gmap=False, subopt=subopt)
    if improvement_fn is not None:
        # good GMAP hits JOIN the pool; the terminals stay and the
        # final eventrim passes adjudicate (stage1hr.c:12497 List_append
        # of good_gmap_hits AND terminals).  improvement_fn receives
        # the anchor hit so the caller can window the GMAP alignment
        # around it (align_singleend_with_gmap genomic bounds).
        extra = None
        for h in hits:
            if (h.hittype == "terminal"
                    and h.d.trim5 + h.d.trim3 >= GMAP_IMPROVEMENT_TRIM):
                g = improvement_fn(h)
                if g is not None and g.nmatches > h.nmatches:
                    extra = g
        if extra is not None:
            hits = hits + [extra]
    hits = optimal_pass(hits, L, finalp=True, keep_gmap=True, subopt=subopt,
                        cutoff=cutoff)
    hits = remove_overlaps(hits, finalp=True)
    hits = optimal_pass(hits, L, finalp=True, keep_gmap=False, subopt=subopt,
                        cutoff=cutoff)
    hits.sort(key=lambda h: (-h.d.nmatches, -h.loglik))
    return hits


import math as _math

_L99 = _math.log(0.99)
_L01 = _math.log(0.01)
_L75 = _math.log(0.75)
_L25 = _math.log(0.25)


def bad_stretch_p(events) -> bool:
    """Stage3_bad_stretch_p (stage3.c): 2-state Viterbi over aligned
    columns; True when the GOOD state's best path would come through
    BAD (a stretch of closely spaced mismatches/indels)."""
    vg, vb = _L99, _L01
    for mm in events:
        if mm:
            if vg + _L01 + _L99 > vb + _L01 + _L01:
                ng = vg + _L01 + _L99
            else:
                return True
            nb = max(vg + _L75 + _L01, vb + _L75 + _L99)
        else:
            if vg + _L99 + _L99 > vb + _L99 + _L01:
                ng = vg + _L99 + _L99
            else:
                return True
            nb = max(vg + _L25 + _L01, vb + _L25 + _L99)
        vg, vb = ng, nb
    return False


# --------------------------------------------------- end indels (stage 6)
# solve_end_indel_low/high + compute_end_indels_left/right
# (stage1hr.c:5692/5848/5259/4819), gsnap.c defaults
MIN_INDEL_END_MATCHES = 4
MAX_END_INSERTIONS = 3
MAX_END_DELETIONS = 6
INDEL_PENALTY_END = 2


def compute_end_indels_left(long_desc, shift_of, breakpoint: int, L: int,
                            max_mm_short: int,
                            min_end: int = MIN_INDEL_END_MATCHES,
                            max_end_ins: int = MAX_END_INSERTIONS,
                            max_end_del: int = MAX_END_DELETIONS):
    """compute_end_indels_left (stage1hr.c:5259, non-OLD branch).

    long_desc: DESCENDING mismatch positions of the full read at the
    main diagonal.  shift_of(delta) -> ASCENDING mismatch positions at
    diagonal left+delta.  Insertions are tried first with sep
    descending and ties overridden (<=), so deletions and smaller seps
    win ties (genomic-low preference).  Returns (indel_pos, indels,
    nmm_longcont, nmm_shift) or None."""
    max_ins = max_end_ins
    max_del = max_end_del
    if max_ins > breakpoint - min_end:
        max_ins = breakpoint - min_end
    best = [None, 250]  # (result, best_sum)
    n_long = len(long_desc)
    longx = list(long_desc) + [-1]

    def walk(sep, indels, ipc_off):
        shift = list(shift_of(indels))[: max_mm_short + 1]
        n_shift = len(shift)
        if n_shift == 0:
            return
        shiftx = shift + [L]
        deln = indels < 0
        shifti = n_shift - 1
        conti = 0
        while conti < n_long and longx[conti] > shiftx[shifti]:
            conti += 1
        ipc = longx[conti] + ipc_off
        ips = shiftx[shifti]

        def try_cand(ip, s, nshift):
            if s <= best[1] and ip >= min_end and (not deln or ip >= sep):
                nm = ip - nshift
                if nm - 3 * nshift - 4 >= 0:
                    best[0] = (ip, indels, conti, nshift)
                    best[1] = s

        while conti < n_long and shifti >= 0:
            if ipc > ips:
                try_cand(ipc, conti + shifti + 1, shifti + 1)
                conti += 1
                ipc = longx[conti] + ipc_off
            elif ips > ipc:
                try_cand(ips, conti + shifti, shifti)
                shifti -= 1
                ips = shiftx[shifti]
            else:
                try_cand(ips, conti + shifti, shifti)
                conti += 1
                shifti -= 1
                ipc = longx[conti] + ipc_off
                ips = shiftx[shifti]
        if shifti < 0:
            s = conti
            if (s <= best[1] and ipc >= min_end
                    and (not deln or ipc >= sep) and ipc >= 4):
                best[0] = (ipc, indels, conti, 0)
                best[1] = s

    if max_ins > 0:
        for sep in range(max_ins, 0, -1):
            walk(sep, +sep, -sep + 1)
    if max_del > 0:
        for sep in range(max_del, 0, -1):
            walk(sep, -sep, +1)
    return best[0]


def compute_end_indels_right(long_asc, shift_of, breakpoint: int, L: int,
                             max_mm_short: int,
                             min_end: int = MIN_INDEL_END_MATCHES,
                             max_end_ins: int = MAX_END_INSERTIONS,
                             max_end_del: int = MAX_END_DELETIONS):
    """compute_end_indels_right (stage1hr.c:4819, non-OLD branch).

    long_asc: ASCENDING mismatch positions at the main diagonal.
    shift_of(delta) -> DESCENDING mismatch positions at left+delta.
    Deletions first with sep ascending and strict (<) comparisons, so
    the FIRST best wins (genomic-low preference on the high side)."""
    max_ins = max_end_ins
    max_del = max_end_del
    length1 = L - breakpoint
    if max_del > length1 - min_end:
        max_del = length1 - min_end
    if max_ins > length1 - min_end:
        max_ins = length1 - min_end
    best = [None, 250]
    n_long = len(long_asc)
    longx = list(long_asc) + [L]

    def walk(sep, indels, ips_off, end_sub, sep_gate):
        shift = list(shift_of(indels))[: max_mm_short + 1]
        n_shift = len(shift)
        if n_shift == 0:
            return
        shiftx = shift + [-1]
        shifti = n_shift - 1
        conti = 0
        while conti < n_long and longx[conti] < shiftx[shifti]:
            conti += 1
        ipc = longx[conti]
        ips = shiftx[shifti] + ips_off

        def try_cand(ip, s, nshift):
            if s < best[1]:
                endlength = L - ip - end_sub
                if endlength >= min_end and (not sep_gate or endlength >= sep):
                    nm = endlength - nshift
                    if nm - 3 * nshift - 4 >= 0:
                        best[0] = (ip, indels, conti, nshift)
                        best[1] = s

        while conti < n_long and shifti >= 0:
            if ipc < ips:
                try_cand(ipc, conti + shifti + 1, shifti + 1)
                conti += 1
                ipc = longx[conti]
            elif ips < ipc:
                try_cand(ips, conti + shifti, shifti)
                shifti -= 1
                ips = shiftx[shifti] + ips_off
            else:
                try_cand(ips, conti + shifti, shifti)
                conti += 1
                shifti -= 1
                ipc = longx[conti]
                ips = shiftx[shifti] + ips_off
        if shifti < 0:
            s = conti
            if s < best[1]:
                endlength = L - ipc - end_sub
                if (endlength >= min_end
                        and (not sep_gate or endlength >= sep)
                        and endlength >= 4):
                    best[0] = (ipc, indels, conti, 0)
                    best[1] = s

    for sep in range(1, max_del + 1):
        walk(sep, -sep, +1, 0, True)
    for sep in range(1, max_ins + 1):
        walk(sep, +sep, -sep + 1, sep, False)
    return best[0]
