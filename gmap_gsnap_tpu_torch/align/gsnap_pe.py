"""GSNAP paired-end alignment (counterpart of
gmap_gsnap_tpu/align/gsnap_pe.py): both ends through one [2B] candidate
gathering, the [B, NP, NP] pairing grid with Stage3_determine_pairtype's
rules, concordant-dominates selection, the pair optimal-score filter and
the (score, left5, left3) pair ranking.

Holds kernel K8 (:func:`pair_grid`, the JAX function's :119-239) with
its plain torch version beside it; CPU tensors take the plain version,
CUDA tensors launch ``csrc/pair_grid.cu`` or raise.  The per-end ranking
(``rank_hits``) and the pair form of the candidate-budget overflow gate
are plain torch on the device.  The JAX package's ``compact_pe`` is a
TPU transfer workaround and is not ported: the runner copies the whole
result tree to the host once.

Two JAX quirks are reproduced on purpose:

  * coordinates are cast to int32 and added in int32 (:119-122,
    :163-166), so ends and pairmax sums wrap for lefts near 2^31;
  * the left5 ranking pass and the ``insert`` output go through
    ``ops/select.take_cols``, whose one-hot float32 product rounds int32
    values above 2^24 (to nearest even, saturating at INT32_MAX): pairs
    of equal score are ordered by the ROUNDED left5, then the exact
    left3, then the cell index.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import build as kbuild
from . import gsnap_gapped
from .gsnap_gapped import (BIG_NMM, KIND_DEL, KIND_INS, KIND_SHORTEXON,
                           KIND_SPLICE, GappedParams)

# pairtypes (stage3hr.h Pairtype_T order)
PT_CONCORDANT = 0
PT_INVERSION = 1
PT_SCRAMBLE = 2
PT_TOOLONG = 3
PT_UNPAIRED = 4

PAIRMAX_DNA = 1_000        # gsnap.c:95 pairmax_dna
PAIRMAX_RNA = 200_000      # gsnap.c:96 pairmax_rna
EXPECTED_PAIRLENGTH = 200  # gsnap.c:97

BIG = 10**6

# the per-end hit fields SAM emission reads through _end_hit
PAIR_EMIT_FIELDS = ("kind", "left", "right", "split", "nindels",
                    "sense", "plusp", "mid", "split2")

# outputs of the pairing grid (K8), each [B, maxpairs] but the last two [B]
PAIR_GRID_KEYS = ("i5", "i3", "pairtype", "insert", "pscore", "npairs",
                  "pair_concordant")


@dataclass(frozen=True)
class PEParams:
    """Field-for-field copy of gmap_gsnap_tpu.align.gsnap_pe.PEParams."""

    gapped: GappedParams = GappedParams()
    pairmax: int = PAIRMAX_DNA
    npair_end: int = 16    # per-end hits entering the pairing grid
    maxpairs: int = 100    # pairs reported


def _w32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32 (the
    wraparound of JAX's int32 arithmetic, kept in int64 for the next
    operation)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _f32_int(x: torch.Tensor) -> torch.Tensor:
    """int32 values -> int32 through float32, as ``take_cols`` returns
    them: rounded to nearest even, saturating at INT32_MAX like XLA's
    float-to-int conversion."""
    return x.int().float().long().clamp(max=2**31 - 1).int()


def _refspan(h, lengths):
    """Genome bases consumed by each hit (untrimmed), int32 wraparound
    included; ``lengths`` int64 [B, 1].  Short exons count only L (as in
    the JAX function)."""
    L = lengths
    intron = _w32(h["right"].long() - h["left"].long())
    nind = h["nindels"].long()
    kind = h["kind"]
    return _w32(torch.where(
        kind == KIND_DEL, L + nind,
        torch.where(kind == KIND_INS, L - nind,
                    torch.where(kind == KIND_SPLICE, L + intron, L))))


def _part_ivs(h, lengths):
    """Aligned-part intervals of each hit, in wrapped int32 coordinates:
    (lo, hi, ok) each [B, NP, 3] (part 1 always; part 2 for gapped hits;
    part 3 for short exons).  ``lengths`` int64 [B, 1]."""
    L = lengths
    kind = h["kind"]
    left = _w32(h["left"].long())
    right = _w32(h["right"].long())
    mid = _w32(h["mid"].long())
    split = h["split"].long()
    split2 = h["split2"].long()
    nind = h["nindels"].long()
    multi = ((kind == KIND_SPLICE) | (kind == KIND_DEL)
             | (kind == KIND_INS) | (kind == KIND_SHORTEXON))
    lo1 = left
    hi1 = left + torch.where(multi, split, L)
    lo2 = torch.where(kind == KIND_SHORTEXON, mid + split,
                      torch.where(kind == KIND_INS,
                                  right + split + nind, right + split))
    hi2 = torch.where(kind == KIND_SHORTEXON, mid + split2, right + L)
    lo3 = right + split2
    hi3 = right + L
    los = _w32(torch.stack([lo1, lo2, lo3], -1))
    his = _w32(torch.stack([hi1, hi2, hi3], -1))
    oks = torch.stack([torch.ones_like(multi), multi,
                       kind == KIND_SHORTEXON], -1)
    return los, his, oks


def _pair_grid_plain(h5, h3, lengths5, lengths3, chr_offsets, pairmax: int,
                     subopt: int, maxpairs: int):
    b, np_ = h5["left"].shape
    L5 = lengths5.long()[:, None]
    L3 = lengths3.long()[:, None]
    l5 = _w32(h5["left"].long())[:, :, None]             # [B, NP, 1]
    l3 = _w32(h3["left"].long())[:, None, :]             # [B, 1, NP]
    e5 = _w32(l5 + _refspan(h5, L5)[:, :, None])
    e3 = _w32(l3 + _refspan(h3, L3)[:, None, :])
    p5 = h5["plusp"][:, :, None]
    p3 = h3["plusp"][:, None, :]
    v5 = (h5["score"] < BIG_NMM)[:, :, None]
    v3 = (h3["score"] < BIG_NMM)[:, None, :]
    chr5 = torch.searchsorted(chr_offsets, h5["left"].long().contiguous(),
                              right=True)[:, :, None]
    chr3 = torch.searchsorted(chr_offsets, h3["left"].long().contiguous(),
                              right=True)[:, None, :]

    # Stage3_determine_pairtype (stage3hr.c:5074); for plus hits
    # genomicstart = left, genomicend = left + span; minus hits reverse
    plus_scr = e3 < l5
    plus_long = l3 > _w32(e5 + pairmax)
    minus_scr = l3 > e5
    minus_long = _w32(e3 + pairmax) < l5
    pairtype = torch.where(
        chr5 != chr3, PT_UNPAIRED,
        torch.where(p5 != p3, PT_INVERSION,
                    torch.where(p5,
                                torch.where(plus_scr, PT_SCRAMBLE,
                                            torch.where(plus_long, PT_TOOLONG,
                                                        PT_CONCORDANT)),
                                torch.where(minus_scr, PT_SCRAMBLE,
                                            torch.where(minus_long, PT_TOOLONG,
                                                        PT_CONCORDANT)))))
    valid = v5 & v3
    insert_conc = _w32(torch.where(p5, e3 - l5, e5 - l3))
    insert_outer = _w32(torch.maximum(e5, e3) - torch.minimum(l5, l3))
    insert = torch.where(pairtype == PT_CONCORDANT, insert_conc, insert_outer)
    pscore = (h5["score"].long()[:, :, None] + h3["score"].long()[:, None, :])

    # Stage3pair_new rejects "concordant" pairs whose insertlength is 0
    # (stage3hr.c:7557): no aligned-part overlap AND the hit5 end beyond
    # the mate's start by more than both read lengths
    lo5, hi5, ok5 = _part_ivs(h5, L5)
    lo3, hi3, ok3 = _part_ivs(h3, L3)
    a_lo, a_hi, a_ok = (x[:, :, None, :, None] for x in (lo5, hi5, ok5))
    b_lo, b_hi, b_ok = (x[:, None, :, None, :] for x in (lo3, hi3, ok3))
    part_overlap = (a_ok & b_ok & ~((b_hi < a_lo) | (b_lo > a_hi))).flatten(3).any(3)
    q = (L5 + L3)[:, :, None]
    insert0 = ~part_overlap & torch.where(p5, e5 > _w32(l3 + q),
                                          e3 > _w32(l5 + q))

    conc = valid & (pairtype == PT_CONCORDANT) & ~insert0
    paired = valid & ((pairtype == PT_INVERSION) | (pairtype == PT_SCRAMBLE)
                      | (pairtype == PT_TOOLONG))
    have_conc = conc.flatten(1).any(1)
    chosen = torch.where(have_conc[:, None, None], conc, paired)
    n = np_ * np_
    eff = torch.where(chosen, pscore, BIG).reshape(b, n)
    # pair-level optimal-score filter (Stage3pair_optimal_score,
    # stage3hr.c:9719)
    best = eff.min(1, keepdim=True).values
    eff = torch.where(eff > best + subopt, BIG, eff)

    take = lambda x, i: torch.gather(x, 1, i)
    left5f = l5.expand(b, np_, np_).reshape(b, n)
    left3f = l3.expand(b, np_, np_).reshape(b, n)
    # rank by (score, rounded left5, left3): three stable passes
    o1 = torch.argsort(left3f, dim=1, stable=True)
    o2 = torch.argsort(take(left5f, o1).int().float(), dim=1, stable=True)
    perm = take(o1, o2)
    o3 = torch.argsort(take(eff, perm), dim=1, stable=True)[:, :maxpairs]
    idx = take(perm, o3)
    eff2 = take(eff, idx)
    ok = eff2 < BIG
    ptf = take(pairtype.reshape(b, n), idx)
    insf = _f32_int(take(insert.reshape(b, n), idx))
    zero = torch.zeros_like(idx)
    return {
        "i5": torch.where(ok, idx // np_, zero).int(),
        "i3": torch.where(ok, idx % np_, zero).int(),
        "pairtype": torch.where(ok, ptf, PT_UNPAIRED).int(),
        "insert": torch.where(ok, insf, 0).int(),
        "pscore": torch.where(ok, eff2, BIG).int(),
        "npairs": ok.sum(1).int(),
        "pair_concordant": have_conc,
    }


_HIT_FIELDS = (("left", torch.int64), ("right", torch.int64),
               ("mid", torch.int64), ("kind", torch.int32),
               ("split", torch.int32), ("split2", torch.int32),
               ("nindels", torch.int32), ("score", torch.int32),
               ("plusp", torch.bool))


def _pair_grid_cuda(h5, h3, lengths5, lengths3, chr_offsets, pairmax: int,
                    subopt: int, maxpairs: int):
    b, np_ = h5["left"].shape
    if h3["left"].shape != (b, np_) or not 1 <= np_ <= 16:
        raise ValueError(f"pair_grid: end hit shapes {tuple(h5['left'].shape)}"
                         f" / {tuple(h3['left'].shape)}: at most 16 per end")
    dev = h5["left"].device
    k = min(maxpairs, np_ * np_)
    out = {key: torch.empty((b, k), dtype=torch.int32, device=dev)
           for key in PAIR_GRID_KEYS[:5]}
    out["npairs"] = torch.empty(b, dtype=torch.int32, device=dev)
    out["pair_concordant"] = torch.empty(b, dtype=torch.bool, device=dev)
    ends = [h[f].to(dt).contiguous() for h in (h5, h3) for f, dt in _HIT_FIELDS]
    offs = chr_offsets.long().contiguous()
    kbuild.launch("gsnap_pair_grid", dev, *ends,
                  lengths5.int().contiguous(), lengths3.int().contiguous(),
                  offs, *(out[key] for key in PAIR_GRID_KEYS),
                  b, np_, k, offs.shape[0], pairmax, subopt)
    return out


def pair_grid(h5, h3, lengths5, lengths3, chr_offsets, pairmax: int,
              subopt: int, maxpairs: int):
    """The pairing grid and pair ranking (kernel K8; Stage3_pair_up_
    concordant + Stage3_determine_pairtype + Stage3pair_optimal_score).

    h5 / h3: the ends' ranked pairing hits (``rank_hits`` with
    apply_optimal=False), dicts of [B, NP] tensors; lengths int32 [B];
    chr_offsets int64 [nchrs + 1].  Every (h5 hit i5, h3 hit i3) cell is
    classified (UNPAIRED across chromosomes, INVERSION across strands,
    else SCRAMBLE / TOOLONG / CONCORDANT by genomic order and pairmax);
    concordant cells whose insert length computes to 0 are dropped;
    concordant cells dominate the paired (inversion / scramble /
    toolong) ones; cells above the best pair score + ``subopt`` drop;
    the rest are ranked by (pair score, left5 rounded through float32,
    left3, cell index) and cut to ``maxpairs``.

    Returns PAIR_GRID_KEYS: i5, i3, pairtype, insert, pscore int32
    [B, min(maxpairs, NP^2)] (unfilled slots 0, 0, PT_UNPAIRED, 0, BIG),
    npairs int32 [B] and pair_concordant bool [B]."""
    args = (h5, h3, lengths5, lengths3, chr_offsets, pairmax, subopt,
            maxpairs)
    dev = h5["left"].device
    if dev.type == "cpu":
        return _pair_grid_plain(*args)
    if dev.type == "cuda":
        return _pair_grid_cuda(*args)
    raise ValueError(f"unsupported device {dev}")


def align_batch_pe(genome, index, codes5, nflags5, lengths5,
                   codes3, nflags3, lengths3,   # read 2 ALREADY inverted
                   params: PEParams = PEParams(), index_minus=None, alt=None,
                   known=None):
    """Returns the JAX function's keys: per-pair [B, maxpairs] i5 / i3
    (indices into end5_pairing / end3_pairing), pairtype, insert,
    pscore; npairs and pair_concordant [B]; the ranked per-end hits
    "end5" / "end3" (per-end optimal filter, for halfmapping / unpaired
    emission) and "end5_pairing" / "end3_pairing" (unfiltered, NP per
    end); and the per-end candidate arrays "cands5" / "cands3" with the
    gated overflow flags."""
    gp = params.gapped
    base = gp.base
    np_ = params.npair_end
    known = gsnap_gapped._check_known(known)

    # both ends ride ONE [2B] candidate gathering (and, in standard
    # mode, one [4B] strand-stacked core inside)
    b_ = codes5.shape[0]
    out2, cands2 = gsnap_gapped.gather_candidates(
        genome, index, index_minus, torch.cat([codes5, codes3]),
        torch.cat([nflags5, nflags3]), torch.cat([lengths5, lengths3]), gp,
        alt, known)
    out5 = {k: v[:b_] for k, v in out2.items()}
    out3 = {k: v[b_:] for k, v in out2.items()}
    cands5 = {k: v[:b_] for k, v in cands2.items()}
    cands3 = {k: v[b_:] for k, v in cands2.items()}

    # pairing uses per-end hits WITHOUT the per-end optimal filter: a
    # suboptimal end can form the optimal pair
    h5 = gsnap_gapped.rank_hits(out5, base, apply_optimal=False, maxout=np_)
    h3 = gsnap_gapped.rank_hits(out3, base, apply_optimal=False, maxout=np_)
    grid = pair_grid(h5, h3, lengths5, lengths3, genome.chr_offsets,
                     params.pairmax, base.subopt_levels, params.maxpairs)

    # candidate-budget overflow gate, pair form (see the JAX function):
    # a concordant row clears its ends' flags when no dropped diagonal
    # can reach the best pair score, as a SUB end or as an indel (or,
    # with -N 1, splice) piece.  pscore[:, 0] is the best pair score
    # (BIG when there is no pair: end scores are < BIG_NMM).  Known-site
    # runs keep the rescue unconditionally.
    if known is None:
        npairs = grid["npairs"]
        conc_ok = grid["pair_concordant"] & (npairs > 0)
        so = base.subopt_levels
        pbest = grid["pscore"][:, 0]
        s5b = h5["score"][:, 0]
        s3b = h3["score"][:, 0]
        b5 = cands5["ovf_bound"]
        b3 = cands3["ovf_bound"]
        sub_ok = ((b5 + s3b > pbest + so) & (b3 + s5b > pbest + so)
                  & (b5 + b3 > pbest + so))
        alloc5 = pbest + so - s3b
        alloc3 = pbest + so - s5b
        hb5 = cands5["hbound"]
        hb3 = cands3["hbound"]
        ind_ok = (((alloc5 < base.indel_penalty_middle) | (hb5 > alloc5))
                  & ((alloc3 < base.indel_penalty_middle)
                     | (hb3 > alloc3)))
        if gp.novelsplicing:
            ind_ok = ind_ok & (hb5 > alloc5) & (hb3 > alloc3)
        safe = conc_ok & sub_ok & ind_ok
        for c in (cands5, cands3):
            # the floor bound covers top-ncand drops only, not truncation
            c["overflow"] = c["overflow"] & ~(safe & ~c["overflow_trunc"])
    for c in (cands5, cands3):
        c.pop("ovf_bound")
        c.pop("hbound")

    return {
        **grid,
        "end5": gsnap_gapped.rank_hits(out5, base),
        "end3": gsnap_gapped.rank_hits(out3, base),
        "end5_pairing": h5,
        "end3_pairing": h3,
        "cands5": cands5,
        "cands3": cands3,
    }
