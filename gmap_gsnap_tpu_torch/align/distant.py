"""Distant / translocation splicing (stage1hr.c step 9).

A copy of gmap_gsnap_tpu/align/distant.py (numpy host code; its output
feeds SAM bytes), whose ``from ..ops import maxent`` now names the
port's host maxent (float64 numpy, no JAX).

Re-derives find_spliceends_distant (stage1hr.c:8552) and
find_splicepairs_distant (stage1hr.c:9429): half-read alignments that
end at a splice site pair up across arbitrary genomic distance on the
SAME aligned strand — consistent-order pairs beyond shortsplicedist,
wrong-order "scramble" pairs at any distance, and (with a multi-
chromosome genome) cross-chromosome translocations.  Each end must
clear sufficient_splice_prob_distant (stage1hr.c:6112) and the
identity/end-matches gates (min_distantsplicing_end_matches=16,
min_distantsplicing_identity=0.95, gsnap.c); at most MAXCHIMERAPATHS
pairs are formed, and the first mismatch level that yields pairs ends
the search (found_score update, stage1hr.c:12300-12315).

Mixed-strand inversion pairs (sections 2/3/6/7 of
find_splicepairs_distant) pair a plus-scan end with a minus-scan end
covering the complementary READ region (an aligned split of L - s on
the opposite strand covers read [0, s) or [s, L)); they are never
shortdistance and print splice_type:inversion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_SPLICE_SUPPORT_DISTANT = 25  # stage1hr.c:6107
MAXCHIMERAPATHS = 3              # stage1hr.c:119
MIN_END_MATCHES = 16             # gsnap.c min_distantsplicing_end_matches
MIN_IDENTITY = 0.95              # gsnap.c min_distantsplicing_identity
DISTANT_PENALTY = 1              # gsnap.c distantsplicing_penalty
LOCAL_PENALTY = 0                # gsnap.c localsplicing_penalty


def sufficient_prob_distant(support: int, nmm: int, prob: float) -> bool:
    """sufficient_splice_prob_distant (stage1hr.c:6112)."""
    support -= 3 * nmm
    if support < MIN_SPLICE_SUPPORT_DISTANT:
        return False
    if support < 30:
        return prob > 0.95
    if support < 35:
        return prob > 0.90
    if support < 40:
        return prob > 0.85
    return prob > 0.70


def _sufficient_prob_distant_vec(support, nmm, prob):
    """Vectorized sufficient_splice_prob_distant (stage1hr.c:6112)."""
    s = support - 3 * nmm
    thr = np.where(s < 30, 0.95,
                   np.where(s < 35, 0.90, np.where(s < 40, 0.85, 0.70)))
    return (s >= MIN_SPLICE_SUPPORT_DISTANT) & (prob > thr)


@dataclass(frozen=True)
class SpliceEnd:
    split: int     # chimera_pos: query split in ALIGNED coords
    nmm: int       # mismatches on the supporting side
    prob: float
    left: int      # diagonal left (projection of aligned q0)
    plusp: bool
    site: int      # genomic splice-site coordinate (= left + split)


def find_spliceends(diags, mm_fn, L: int, genome_str: str, codes,
                    max_mm: int, k_index: int):
    """Scan candidate diagonals for half-read splice ends.

    Returns a dict keyed (kind, plusp) -> list[SpliceEnd], kind in
    donor/acceptor (sense) and antidonor/antiacceptor (antisense).
    Left parts (aligned q0..split) end at donor (GT) or antiacceptor
    (CT) sites; right parts (split..L) start after acceptor (AG) or
    antidonor (AC) sites (find_spliceends_distant scan structure)."""
    from ..ops import maxent

    ends: dict = {}
    for kind in ("donor", "acceptor", "antidonor", "antiacceptor"):
        for plusp in (True, False):
            ends[(kind, plusp)] = []

    glen = len(genome_str)
    for left, plusp in diags:
        mm = mm_fn(left, plusp)
        mmpos = np.flatnonzero(mm)

        # left-part ends: splits in [index1part, bound]; the scan stops
        # at the (max_mm+1)-th mismatch (stage1hr.c:8633-8641)
        lbound = L - 1 if len(mmpos) <= max_mm else int(mmpos[max_mm])
        # right-part ends: splits must lie beyond the (max_mm+1)-th
        # mismatch counted from the right
        rbound = 1 if len(mmpos) <= max_mm else int(mmpos[-1 - max_mm]) + 1

        # one genome-window byte fetch covers both scans; dinucleotide
        # detection, per-split mismatch counts (prefix sums of mmpos via
        # searchsorted) and the sufficiency gate are all vectorized —
        # the per-base Python loop this replaces dominated the PE
        # novel-splicing rescue profile
        lo_g = left + min(k_index, max(rbound, 1)) - 2
        hi_g = left + max(min(lbound, L - 1) + 1, L - k_index + 1) + 2
        lo_g = max(lo_g, 0)
        hi_g = min(hi_g, glen)
        if hi_g <= lo_g:
            continue
        win = np.frombuffer(
            genome_str[lo_g:hi_g].encode("latin-1"), np.uint8)

        def scan(s_arr, leftp):
            if not len(s_arr):
                return
            g = left + s_arr
            ok = (g >= 20) & (g + 20 <= glen)
            if leftp:
                ok &= (g >= lo_g) & (g + 2 <= hi_g)
            else:
                ok &= (g - 2 >= lo_g) & (g <= hi_g)
            s_arr = s_arr[ok]
            if not len(s_arr):
                return
            g = left + s_arr
            if leftp:
                c0, c1 = win[g - lo_g], win[g - lo_g + 1]
                nmm_arr = np.searchsorted(mmpos, s_arr, side="left")
                kinds = (("donor", (c0 == ord("G")) & (c1 == ord("T"))),
                         ("antiacceptor",
                          (c0 == ord("C")) & (c1 == ord("T"))))
                support = s_arr
            else:
                c0, c1 = win[g - lo_g - 2], win[g - lo_g - 1]
                nmm_arr = (len(mmpos)
                           - np.searchsorted(mmpos, s_arr, side="left"))
                kinds = (("acceptor", (c0 == ord("A")) & (c1 == ord("G"))),
                         ("antidonor", (c0 == ord("A")) & (c1 == ord("C"))))
                support = L - s_arr
            for k, sel in kinds:
                idx = np.flatnonzero(sel)
                if not len(idx):
                    continue
                probs = maxent.splice_prob_np(codes, g[idx], k)
                keep = _sufficient_prob_distant_vec(
                    support[idx], nmm_arr[idx], probs)
                lst = ends[(k, plusp)]
                for i, p in zip(idx[keep], probs[keep]):
                    lst.append(SpliceEnd(
                        int(s_arr[i]), int(nmm_arr[i]), float(p), left,
                        plusp, int(g[i])))

        scan(np.arange(k_index, min(lbound, L - 1) + 1), True)
        scan(np.arange(max(rbound, 1), L - k_index + 1), False)
    return ends


@dataclass
class DistantPair:
    split: int
    plusp: bool
    sensep: bool           # sensedir: SENSE_FORWARD vs SENSE_ANTI
    left_end: SpliceEnd    # substring covering aligned q0..split
    right_end: SpliceEnd   # substring covering aligned split..L
    donor_left: bool       # True when the donor is the LEFT part
    splice_type: str       # consistent / scramble / inversion
    distance: int
    shortdistancep: bool
    penalty: int
    nmm_total: int
    inversion: bool = False  # mixed strands; split/ends in READ coords
    donor_kind: str = ""     # scan kind of the donor end (dinucl form)
    acceptor_kind: str = ""

    @property
    def donor(self) -> SpliceEnd:
        return self.left_end if self.donor_left else self.right_end

    @property
    def acceptor(self) -> SpliceEnd:
        return self.right_end if self.donor_left else self.left_end


def _min_endlength(nmm: int, min_end: int = MIN_END_MATCHES) -> int:
    nonid = 1.0 - MIN_IDENTITY
    return max(min_end, int(round(nmm / nonid)))


def find_pairs(ends, L: int, max_mm_total: int, shortsplicedist: int,
               chrnum_of=None, distant_penalty: int = DISTANT_PENALTY,
               local_penalty: int = LOCAL_PENALTY,
               min_end_matches: int = MIN_END_MATCHES):
    """Pair splice ends level-by-level; the first mismatch level with
    pairs sets found_score and ends the search (subopt_levels=0).

    Pairing combos in ALIGNED coordinates (left-scan x right-scan on the
    same aligned strand); the reference's eight per-strand lists reduce
    to these because its minus-segment scan swaps the sense of every
    list (stage1hr.c:12253 argument order).  sensedir: (donor,acceptor)
    scans are SENSE_FORWARD on plus / SENSE_ANTI on minus (sections
    1/8); (antiacceptor,antidonor) the reverse (sections 5/4).  The
    pair's donor substring follows the SCAN kind: donor scan = left
    part, antidonor scan = right part.  Genomic order: same-strand
    genomicstart comparisons reduce to aligned order — consistent iff
    the right part sits at the higher diagonal."""
    pairs: list[DistantPair] = []
    count = 0
    for total in range(0, max_mm_total + 1):
        level: list[DistantPair] = []
        for lkind, rkind, donor_left in (
            ("donor", "acceptor", True),
            ("antiacceptor", "antidonor", False),
        ):
            for plusp in (True, False):
                sensep = donor_left if plusp else not donor_left
                for el in ends[(lkind, plusp)]:
                    for er in ends[(rkind, plusp)]:
                        if count > MAXCHIMERAPATHS:
                            break
                        if el.split != er.split:
                            continue
                        if el.nmm + er.nmm != total:
                            continue
                        if el.left == er.left:
                            continue  # really a continuous match
                        s = el.split
                        if s < _min_endlength(el.nmm, min_end_matches):
                            continue
                        if L - s < _min_endlength(er.nmm, min_end_matches):
                            continue
                        if (chrnum_of is not None
                                and chrnum_of(el.left) != chrnum_of(er.left)):
                            # cross-chromosome translocation: distance 0
                            stype, dist, shortp = "translocation", 0, False
                        elif er.left > el.left:
                            stype = "consistent"
                            dist = er.left - el.left
                            shortp = dist <= shortsplicedist
                        else:
                            stype = "scramble"
                            dist = el.left - er.left
                            shortp = False
                        dk = lkind if donor_left else rkind
                        ak = rkind if donor_left else lkind
                        level.append(DistantPair(
                            s, plusp, sensep, el, er, donor_left,
                            stype, dist, shortp,
                            local_penalty if shortp else distant_penalty,
                            total, donor_kind=dk, acceptor_kind=ak))
                        count += 1

        # inversion sections 2/3/6/7 (mixed strands, READ coordinates).
        # The minus-scan end covering read [s, L) or [0, s) appears in
        # our aligned lists at split L - s with the complementary scan
        # kind (e.g. a minus-strand acceptor shows plus-text CT -> the
        # aligned antiacceptor list).  Genomicstart of a minus end =
        # left + L; distance formulas follow each C section.
        for (lk, lp, rk, rp, donor_left, sensep, dkind, akind) in (
            # 2. donor+ x acceptor-   (read-left donor on plus)
            ("donor", True, "antiacceptor", False, True, True,
             "donor", "antiacceptor"),
            # 3. donor- x acceptor+   (read-left donor on minus)
            ("antidonor", False, "acceptor", True, True, True,
             "antidonor", "acceptor"),
            # 6. antiacceptor- x antidonor+ (read-left acceptor, minus)
            ("acceptor", False, "antidonor", True, False, False,
             "antidonor", "acceptor"),
            # 7. antiacceptor+ x antidonor- (read-left acceptor, plus)
            ("antiacceptor", True, "donor", False, False, False,
             "donor", "antiacceptor"),
        ):
            for el in ends[(lk, lp)]:
                # read-coords split of the READ-LEFT piece
                s = el.split if lp else L - el.split
                for er in ends[(rk, rp)]:
                    if count > MAXCHIMERAPATHS:
                        break
                    s_r = er.split if rp else L - er.split
                    if s != s_r:
                        continue
                    if el.nmm + er.nmm != total:
                        continue
                    if s < _min_endlength(
                            el.nmm if donor_left else er.nmm,
                            min_end_matches):
                        continue
                    if L - s < _min_endlength(er.nmm if donor_left
                                              else el.nmm,
                                              min_end_matches):
                        continue
                    gs_l = el.left if lp else el.left + L
                    gs_r = er.left if rp else er.left + L
                    if (chrnum_of is not None
                            and chrnum_of(el.left) != chrnum_of(er.left)):
                        stype, dist = "translocation", 0
                    else:
                        # donor/acceptor genomicstart +- pos per section
                        if donor_left:
                            gd, ga = gs_l, gs_r
                        else:
                            ga, gd = gs_l, gs_r
                        if lp:   # sections 2 / 7: +pos on plus side
                            dist = abs((ga - s) - (gd + s)) if donor_left                                 else abs((ga + s) - (gd - s))
                        else:    # sections 3 / 6
                            dist = abs((ga + s) - (gd - s)) if donor_left                                 else abs((ga - s) - (gd + s))
                        stype = "inversion"
                    level.append(DistantPair(
                        s, lp, sensep, el, er, donor_left,
                        stype, dist, False, distant_penalty, total,
                        inversion=True, donor_kind=dkind,
                        acceptor_kind=akind))
                    count += 1
        if level:
            # per-level optimal-score filter: shortdistance (penalty 0)
            # pairs dominate distant ones at the same mismatch level
            best = min(p.nmm_total + p.penalty for p in level)
            pairs.extend(p for p in level
                         if p.nmm_total + p.penalty == best)
            break
    if count > MAXCHIMERAPATHS:
        # too many candidate translocations: the reference discards ALL
        # distant pairs (stage1hr.c:10035-10038 stage3list_gc on
        # nsplicepairs > MAXCHIMERAPATHS) rather than keeping a subset
        return []
    return pairs
