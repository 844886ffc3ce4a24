"""GMAP: cDNA-to-genome spliced alignment, the part GSNAP's GMAP rescue
lanes reach (counterpart of gmap_gsnap_tpu/align/gmap.py).

``align_cdna_batch`` and what it calls are copied from the JAX module;
its device calls go to the port's engine (``gmap_engine.seed_segments``,
kernel K9; ``gmap_engine.chain``, K10; the junction dynprog, K11 + K12)
on the database's device arrays, with one copy of the results to the
host.  The JAX module's x4 row bucket (``_bucket``) only saved XLA
compiles and is not carried over; the query-length ladder is, since Q
biases the diagonals.  The pipeline:

  1. SEED   — query k-mers against the global positional index; hits
              sorted into diagonal segments (one per exon piece);
  2. CHAIN  — segments chained with intron-aware gap penalties (the
              sparse DP of stage2.c:2921 align_compute_scores);
  3. BRIDGE — each inter-segment junction resolved like
              dynprog.c:3291 bridge_intron_gap (GT-AG/GC-AG/AT-AC by
              cDNA direction, constants from dynprog.c:142-300), messy
              ones re-solved by the banded affine DP;
  4. ENDS   — extend to the query ends and trim like stage3.c end
              refinement.

The result is a Path: aligned exon list.  Not ported yet (the ``gmap``
CLI slice, ROADMAP.md): multiple paths per query, chimeras, the genomic
range restriction and the output formats.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..db import datadir
from ..db.datadir import GenomeDB
from ..utils import dna

# dynprog.c:142-300 scoring constants (HIGHQ tier; defect_rate < 0.003)
FULLMATCH = 3
MISMATCH_HIGHQ = -3
SINGLE_OPEN = -10
SINGLE_EXTEND = -3
CANONICAL_INTRON_HIGHQ = 10
FINAL_CANONICAL_INTRON_HIGHQ = 30
GCAG_INTRON = 15
FINAL_GCAG_INTRON = 20
ATAC_INTRON = 12
FINAL_ATAC_INTRON = 12
MIN_INTRONLENGTH = 9
MAX_INSERTLEN = 30  # largest query insertion the chainer bridges

# intron dinucleotide codes (dinucleotide pairs as (left, right) strings)
_CANONICAL = {
    # cdna_direction > 0 (sense): left=donor start, right=acceptor end
    +1: {("GT", "AG"): "canonical", ("GC", "AG"): "gcag", ("AT", "AC"): "atac"},
    # cdna_direction < 0 (antisense on plus genome)
    -1: {("CT", "AC"): "canonical", ("CT", "GC"): "gcag", ("GT", "AT"): "atac"},
}


def intron_score(left_dinucl: str, right_dinucl: str, cdna_direction: int,
                 canonical_reward: int, finalp: bool) -> tuple[int, str]:
    """dynprog.c intron_score: bonus for canonical intron dinucleotides."""
    from . import gmap_config

    if gmap_config.NOSPLICING:
        return 0, "noncanonical"
    finalp = gmap_config.finalp_allowed(finalp)
    for direction in ([cdna_direction] if cdna_direction else [+1, -1]):
        kind = _CANONICAL.get(direction, {}).get((left_dinucl, right_dinucl))
        if kind == "canonical":
            return canonical_reward, "canonical"
        if kind == "gcag":
            return (FINAL_GCAG_INTRON if finalp else GCAG_INTRON), "gcag"
        if kind == "atac":
            return (FINAL_ATAC_INTRON if finalp else ATAC_INTRON), "atac"
    return 0, "noncanonical"


@dataclass
class Exon:
    qstart: int   # query coords [qstart, qend) 0-based
    qend: int
    gstart: int   # universal genome coords [gstart, gend) of plus strand
    gend: int
    matches: int = 0
    mismatches: int = 0


@dataclass
class Path:
    watsonp: bool               # query aligns to plus strand of genome
    cdna_direction: int         # +1 sense (GT-AG), -1 antisense, 0 unknown
    exons: list[Exon] = field(default_factory=list)
    # per-junction info between consecutive exons
    intron_types: list[str] = field(default_factory=list)
    querylength: int = 0
    indels: int = 0
    chrnum: int = 0

    @property
    def matches(self):
        return sum(e.matches for e in self.exons)

    @property
    def mismatches(self):
        return sum(e.mismatches for e in self.exons)

    @property
    def qstart(self):
        return self.exons[0].qstart if self.exons else 0

    @property
    def qend(self):
        return self.exons[-1].qend if self.exons else 0

    @property
    def gstart(self):
        return self.exons[0].gstart if self.exons else 0

    @property
    def gend(self):
        return self.exons[-1].gend if self.exons else 0

    def coverage(self) -> float:
        return 100.0 * (self.qend - self.qstart) / max(1, self.querylength)

    def identity(self) -> float:
        aligned = self.matches + self.mismatches + self.indels
        return 100.0 * self.matches / max(1, aligned)


def _match_vec(gstr_a: np.ndarray, qstr_a: np.ndarray, qs: int, qe: int,
               diag: int) -> np.ndarray:
    """bool[qe-qs]: query position q in [qs, qe) matches genome at
    diag+q (out-of-genome positions are mismatches)."""
    n = qe - qs
    if n <= 0:
        return np.zeros(0, bool)
    gs, ge = diag + qs, diag + qe
    G = len(gstr_a)
    eq = np.zeros(n, bool)
    glo, ghi = max(gs, 0), min(ge, G)
    if glo < ghi:
        off = glo - gs
        eq[off : off + (ghi - glo)] = (
            qstr_a[qs + off : qs + off + (ghi - glo)] == gstr_a[glo:ghi]
        )
    return eq


def _bridge_intron(gstr, qstr, qL_end, qR_start, diagL, diagR,
                   cdna_direction, finalp=True):
    """Choose the splice point between two exon segments.

    Left exon currently covers query ..qL_end (exclusive) on diagonal
    diagL; right exon covers qR_start.. on diagR (diagR > diagL).
    Scans candidate split points r (query coordinate where the intron
    sits) over a peeled window, scoring exact matches on both sides +
    intron dinucleotide bonus, like bridge_intron_gap
    (dynprog.c:3291-3600, use_probabilities_p false); the split scan is
    vectorized into prefix/suffix sums over the window.

    Returns (r, score, introntype).
    """
    peel = 11  # maxpeelback (gsnap.c:96, gmap.c default 11)
    lo = max(0, min(qL_end, qR_start) - peel)
    hi = min(len(qstr), max(qL_end, qR_start) + peel)
    from . import gmap_config

    canonical_reward = (
        FINAL_CANONICAL_INTRON_HIGHQ
        if gmap_config.finalp_allowed(finalp) else CANONICAL_INTRON_HIGHQ
    )
    gstr_a = _as_bytes(gstr)
    qstr_a = _as_bytes(qstr)
    n = hi - lo
    eqL = _match_vec(gstr_a, qstr_a, lo, hi, diagL)
    eqR = _match_vec(gstr_a, qstr_a, lo, hi, diagR)
    sL = np.where(eqL, FULLMATCH, MISMATCH_HIGHQ).astype(np.int64)
    sR = np.where(eqR, FULLMATCH, MISMATCH_HIGHQ).astype(np.int64)
    # scoreL(r) = sum sL[lo:r]; scoreR(r) = sum sR[r:hi]
    prefL = np.concatenate([[0], np.cumsum(sL)])           # [n+1]
    sufR = np.concatenate([np.cumsum(sR[::-1])[::-1], [0]])

    # intron bonus per split point r (r in lo..hi inclusive)
    rr = np.arange(lo, hi + 1)
    gl = diagL + rr                   # first intron base (donor side)
    gr = diagR + rr - 1               # last intron base (acceptor side)
    ld = _dinucl_at(gstr_a, gl)       # (gstr[gl], gstr[gl+1])
    rd = _dinucl_at(gstr_a, gr - 1)
    scoreI, itypes = _intron_score_vec(ld, rd, cdna_direction,
                                       canonical_reward, finalp)
    total = prefL + scoreI + sufR
    best = int(np.argmax(total))      # first max, like the scan's '>'
    return lo + best, int(total[best]), itypes[best]


_ITYPE_NAMES = np.array(["noncanonical", "canonical", "gcag", "atac"])


def _as_bytes(s) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return s
    if hasattr(s, "ascii"):  # LazyGenomeStr
        return s.ascii
    return np.frombuffer(s.encode("latin-1"), np.uint8)


def _dinucl_at(gstr_a: np.ndarray, pos: np.ndarray):
    """(first, second) byte arrays at genome positions pos, pos+1 (0
    outside the genome)."""
    G = len(gstr_a)
    p0 = np.clip(pos, 0, G - 1)
    p1 = np.clip(pos + 1, 0, G - 1)
    a = np.where((pos >= 0) & (pos < G), gstr_a[p0], 0)
    b = np.where((pos + 1 >= 0) & (pos + 1 < G), gstr_a[p1], 0)
    return a, b


def _intron_score_vec(ld, rd, cdna_direction, canonical_reward, finalp):
    """Vectorized intron_score over candidate split points: ld/rd are
    (byte, byte) tuples for the left/right dinucleotides."""
    from . import gmap_config

    la, lb = ld
    ra, rb = rd
    G, T, A, C = ord("G"), ord("T"), ord("A"), ord("C")
    score = np.zeros(len(la), np.int64)
    kind = np.zeros(len(la), np.int64)  # index into _ITYPE_NAMES
    if gmap_config.NOSPLICING:
        return score, _ITYPE_NAMES[kind]
    finalp = gmap_config.finalp_allowed(finalp)
    gcag = FINAL_GCAG_INTRON if finalp else GCAG_INTRON
    atac = FINAL_ATAC_INTRON if finalp else ATAC_INTRON
    for direction in ([cdna_direction] if cdna_direction else [+1, -1]):
        if direction > 0:
            combos = [((G, T, A, G), canonical_reward, 1),
                      ((G, C, A, G), gcag, 2), ((A, T, A, C), atac, 3)]
        else:
            combos = [((C, T, A, C), canonical_reward, 1),
                      ((C, T, G, C), gcag, 2), ((G, T, A, T), atac, 3)]
        for (x1, x2, y1, y2), sc, ki in combos:
            m = (la == x1) & (lb == x2) & (ra == y1) & (rb == y2) & (kind == 0)
            score[m] = sc
            kind[m] = ki
    return score, _ITYPE_NAMES[kind]


def _solve_indel_junction(gstr, qstr, qL_end, qR_start, diagL, diagR):
    """Small genomic/cDNA indel between segments: pick the split point r
    maximizing exact matches on both diagonals (banded-DP equivalent for
    a single indel; dynprog.c Dynprog_single_gap semantics).  For
    insertions (diagR < diagL) the nins query bases [r, r+nins) are
    unaligned and the right side resumes at r + nins."""
    peel = 11
    nins = max(0, diagL - diagR)
    lo = max(0, min(qL_end, qR_start) - peel)
    hi = min(len(qstr) - nins, max(qL_end, qR_start) + peel)
    if hi < lo:
        return lo
    gstr_a = _as_bytes(gstr)
    qstr_a = _as_bytes(qstr)
    eqL = _match_vec(gstr_a, qstr_a, lo, hi, diagL)
    eqR = _match_vec(gstr_a, qstr_a, lo + nins, hi + nins, diagR)
    sL = np.where(eqL, FULLMATCH, MISMATCH_HIGHQ).astype(np.int64)
    sR = np.where(eqR, FULLMATCH, MISMATCH_HIGHQ).astype(np.int64)
    prefL = np.concatenate([[0], np.cumsum(sL)])
    sufR = np.concatenate([np.cumsum(sR[::-1])[::-1], [0]])
    total = prefL + sufR
    return lo + int(np.argmax(total))


def _count_matches(gstr, qstr, qs, qe, diag):
    eq = _match_vec(_as_bytes(gstr), _as_bytes(qstr), qs, qe, diag)
    m = int(eq.sum())
    return m, (qe - qs) - m


def _extend_end(gstr, qstr, qpos, diag, direction, trim_mismatch_score=-3,
                ties_extend: bool = True):
    """Extend from qpos to the query end (direction=+1) or start (-1),
    then trim by match/mismatch score (changepoint-like end trimming).
    ties_extend=False keeps the SHORTER extension on score ties (the
    dynprog end BEST_LOCAL behavior)."""
    L = len(qstr)
    gstr_a = _as_bytes(gstr)
    qstr_a = _as_bytes(qstr)
    if direction > 0:
        if qpos >= L:
            return qpos
        eq = _match_vec(gstr_a, qstr_a, qpos, L, diag)
    else:
        if qpos < 0:
            return qpos
        eq = _match_vec(gstr_a, qstr_a, 0, qpos + 1, diag)[::-1]
    contrib = np.where(eq, 1, trim_mismatch_score).astype(np.int64)
    score = np.cumsum(contrib)
    if len(score) == 0:
        return qpos
    # ties_extend: '>=' updates -> LAST maximum; else '>' -> FIRST, and
    # only strictly positive improvements move the endpoint
    if ties_extend:
        best = len(score) - 1 - int(np.argmax(score[::-1]))
        take = score[best] >= 0
    else:
        best = int(np.argmax(score))
        take = score[best] > 0
    if not take:
        return qpos
    if direction > 0:
        return qpos + best + 1
    return qpos - best


def align_cdna(db: GenomeDB, query: str, max_intronlen: int = 1_000_000,
               extend_ends: bool = False, device="cpu"):
    """Align a cDNA query; returns the best Path or None.

    extend_ends: extend the outer exons to the query bounds without
    trimming (the QUERYEND_NOGAPS end policy used when GSNAP invokes
    GMAP for rescue, stage1hr.c align_single_hit_with_gmap)."""
    paths = align_cdna_batch(db, [query], max_intronlen=max_intronlen,
                             extend_ends=extend_ends, device=device)
    return paths[0]


# sticky per-Q seeding budgets: retries prove the size once (the sizes
# change how often the seeding re-runs, never its result)
_HS_STICKY: dict = {}


# query-length (Q = oligo count) ladder: a 128 rung so the GSNAP
# GMAP-rescue lane (100 bp reads, Q=89) doesn't pad to 256
_Q_LADDER = (128, 256, 1024, 4096, 16384, 65536)


def _bucket_q(n: int) -> int:
    for b in _Q_LADDER:
        if n <= b:
            return b
    return _Q_LADDER[-1]


def align_cdna_batch(db: GenomeDB, queries: list[str],
                     max_intronlen: int = 1_000_000,
                     extend_ends: bool = False, device="cpu"):
    """Batched cDNA alignment: seeding, segment extraction, chaining and
    the chain backtrack for BOTH strands of EVERY query run as one pass
    on ``device`` over the database's device index (kernels K9, K10);
    host work is O(segments) per query.  Returns one best Path (or None)
    per query."""
    from . import gmap_engine

    genome_str = db.genome_str
    B = len(queries)
    qstrs = []
    for query in queries:
        qu = query.upper()
        qstrs.append(qu)
        qstrs.append(dna.revcomp_str(qu))

    k = db.k
    maxq = max((len(q) - k + 1 for q in qstrs), default=0)
    if maxq <= 0:
        return [None] * B
    Q = _bucket_q(maxq)
    rows = len(qstrs)
    oligos = np.zeros((rows, Q), np.int64)
    valid = np.zeros((rows, Q), bool)
    for i, qs in enumerate(qstrs):
        qcodes, qflags = dna.encode(qs)
        n = len(qcodes) - k + 1
        if n <= 0:
            continue
        oligos[i, :n] = dna.pack_kmers(qcodes, k)
        bad = np.convolve(qflags.astype(int), np.ones(k, int), "valid") > 0
        valid[i, :n] = ~bad

    index = datadir.device_index(db, device)
    dev = index.device
    oligos_d = torch.from_numpy(oligos.astype(np.int32)).to(dev)
    valid_d = torch.from_numpy(valid).to(dev)
    # repeat-dense genomes yield hundreds of >=MIN_SEGLEN segments for
    # kb-scale queries — start long queries at S=1024 so the overflow
    # retry stays rare
    H, S = _HS_STICKY.get(Q, (8 * Q, 192 if Q <= 256 else 1024))
    while True:
        segs_d = gmap_engine.seed_segments(
            index.offsets, index.positions, oligos_d, valid_d, k, H, S, 100)
        ch_d = gmap_engine.chain(segs_d["qstart"], segs_d["qend"],
                                 segs_d["diag"], segs_d["valid"], k,
                                 max_intronlen)
        qspan, cdg, deep, nhits_a, nsegs_a = (
            x.cpu().numpy() for x in (ch_d["qspan"], ch_d["dg"],
                                      ch_d["deep"], segs_d["nhits"],
                                      segs_d["nsegs"]))
        nhits = int(nhits_a.max())
        nsegs = int(nsegs_a.max())
        if nhits <= H and nsegs <= S and not deep.any():
            chains = []
            for b in range(rows):
                m = qspan[b] >= 0
                if not m.any():
                    chains.append([])
                    continue
                idx = np.flatnonzero(m)[::-1]   # end-first -> start
                d = cdg[b].astype(np.int64) - Q
                qs_b = qspan[b] >> 16
                qe_b = qspan[b] & 0xFFFF
                chains.append([[
                    (int(qs_b[t]), int(qe_b[t]),
                     int(d[t] + qs_b[t]), int(d[t]))
                    for t in idx]])
            break
        if nhits <= H and nsegs <= S:
            # a chain used every backtrack step: back to the host with
            # the full segment arrays and the DP (no truncation)
            chains = gmap_engine.chains_from_device(
                {kk: segs_d[kk].cpu().numpy() for kk in gmap_engine.SEG_KEYS},
                rows, Q, ch_d["score"].cpu().numpy(),
                ch_d["prev"].cpu().numpy())
            break
        # overflow: re-run at larger hit/segment budgets (the S
        # truncation keeps the LOWEST diagonals, silently dropping
        # high-coordinate loci — never accept a truncated segment set)
        if nhits > H:
            H *= 4
        if nsegs > S:
            S *= 4
        _HS_STICKY[Q] = (H, S)

    # nonjoinable transitions (genomic jumps the reference could never
    # bridge) split chains into separate candidate paths
    for row in range(rows):
        if any(nxt[3] - prev[3] > MERGELENGTH
               for ch in chains[row] for prev, nxt in zip(ch, ch[1:])):
            chains[row] = _split_nonjoinable(
                db, genome_str, qstrs[row], chains[row])

    gcodes = _codes_of(genome_str)

    def build_one(row, ci, jx):
        chain = chains[row][ci]
        qstr = qstrs[row]
        path = _build_path(genome_str, qstr, chain, row % 2 == 0, db, jx)
        if path is not None and extend_ends:
            _extend_path_to_ends(genome_str, qstr, path)
        return path

    # pass 1 collects dynprog junction-rescue requests; they solve in
    # ONE batched device pass per direction bucket, then affected rows
    # rebuild with the solutions
    coll = {"mode": "collect", "requests": {}, "solutions": {},
            "rows": set()}
    row_paths = {
        (row, ci): build_one(row, ci, (coll, (row, ci)))
        for row in range(rows) for ci in range(len(chains[row]))}
    if coll["requests"]:
        # queue every direction bucket's device work before copying any
        # result back
        handles = {
            direction: gmap_engine.solve_junctions_dispatch(
                gcodes, [r for _, r in reqs], direction, device=dev)
            for direction, reqs in coll["requests"].items()}
        for direction, reqs in coll["requests"].items():
            keys = [k for k, _ in reqs]
            sols = gmap_engine.solve_junctions_finish(handles[direction])
            for k, sol in zip(keys, sols):
                if sol is not None:
                    coll["solutions"][k] = sol
        coll["mode"] = "solve"
        for row, ci in coll["rows"]:
            row_paths[row, ci] = build_one(row, ci, (coll, (row, ci)))

    out = []
    for b in range(B):
        paths = [p for (row, _), p in row_paths.items()
                 if row // 2 == b and p is not None]
        paths.sort(key=lambda p: -(p.matches - 3 * p.mismatches))
        out.append(paths[0] if paths else None)
    return out


_CODE_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE_LUT[_c] = _i


def _codes_of(s) -> np.ndarray:
    if hasattr(s, "ascii"):
        return _CODE_LUT[s.ascii]
    return _CODE_LUT[np.frombuffer(s.encode("latin-1"), np.uint8)]


def chop_path_ends(gstr: str, qstr: str, path: Path) -> None:
    """GMAP's changepoint end trimming (chop_ends_by_changepoint,
    stage3.c:2130): chop alignment ends whose match rate drops sharply
    below the interior rate."""
    from .changepoint import chop_ends

    gstr_a = _as_bytes(gstr)
    qstr_a = _as_bytes(qstr)
    cols = []  # (exon_index, qpos, match)
    for ei, e in enumerate(path.exons):
        diag = e.gstart - e.qstart
        eq = _match_vec(gstr_a, qstr_a, e.qstart, e.qend, diag)
        cols.extend(zip([ei] * (e.qend - e.qstart),
                        range(e.qstart, e.qend), eq.astype(int)))
    if not cols:
        return
    chop_l, chop_r = chop_ends([c[2] for c in cols])
    if chop_l == 0 and chop_r == 0:
        return
    kept = cols[chop_l : len(cols) - chop_r if chop_r else len(cols)]
    if not kept:
        return
    new_exons = []
    for ei, e in enumerate(path.exons):
        qs = [q for (i, q, _) in kept if i == ei]
        if not qs:
            continue
        diag = e.gstart - e.qstart
        lo, hi = qs[0], qs[-1] + 1
        m, mm = _count_matches(gstr, qstr, lo, hi, diag)
        new_exons.append(Exon(lo, hi, diag + lo, diag + hi, m, mm))
    path.exons = new_exons


def _extend_path_to_ends(gstr: str, qstr: str, path: Path) -> None:
    """Re-extend the outer exons with the GMAP end-dynprog scoring
    (BEST_LOCAL, FULLMATCH +3 / MISMATCH -3, dynprog.c:140-150): a
    mismatch followed by a match still extends, unlike the GSNAP
    +1/-3 trim policy."""
    first = path.exons[0]
    diag = first.gstart - first.qstart
    newq = _extend_end(gstr, qstr, first.qstart, diag, -1,
                       trim_mismatch_score=-1, ties_extend=False)
    if newq < first.qstart:
        m, mm = _count_matches(gstr, qstr, newq, first.qstart, diag)
        first.qstart = newq
        first.gstart = diag + newq
        first.matches += m
        first.mismatches += mm
    last = path.exons[-1]
    diag = last.gstart - last.qstart
    newq = _extend_end(gstr, qstr, last.qend, diag, +1,
                       trim_mismatch_score=-1, ties_extend=False)
    if newq > last.qend:
        m, mm = _count_matches(gstr, qstr, last.qend, newq, diag)
        last.qend = newq
        last.gend = diag + newq
        last.matches += m
        last.mismatches += mm


def _microexon_int(gstr_a, qstr_a, lo, hi, dL, dR, cdna_direction, db,
                   nindels, nmm, pvalue=0.01):
    """Dynprog_microexon_int (dynprog.c:7131): when the intron bridge is
    poor, look for a 3-12 bp exon between two canonical introns inside
    the junction window.  The reference's Boyer-Moore scan of the middle
    query segment (boyer-moore.c) becomes one vectorized sliding-window
    compare.  Acceptance (stage3.c:5942-5958): both flank probs >= 0.95
    when the rejected bridge was clean-ish (nindels == 0, nmm < 4),
    else either >= 0.90.  Returns (qstart, middlelength, genome_start,
    introntype) or None."""
    import math

    from ..ops import maxent as maxent_mod

    L1 = hi - lo
    span = (dR + hi - 1) - (dL + lo)
    if L1 <= 0 or span <= 0:
        return None
    min_len = math.ceil(
        -math.log(1.0 - (1.0 - pvalue) ** (1.0 / span)) / math.log(4.0)) - 8
    if min_len > 12:           # MAX_MICROEXON_LENGTH (dynprog.c:137)
        return None
    min_len = max(min_len, 3)  # MIN_MICROEXON_LENGTH
    if cdna_direction > 0:
        i1, i2, i3, i4 = ord("G"), ord("T"), ord("A"), ord("G")
        kinds = ("acceptor", "donor")
        itype = "canonical"
    else:
        i1, i2, i3, i4 = ord("C"), ord("T"), ord("A"), ord("C")
        kinds = ("antidonor", "antiacceptor")
        itype = "canonical"
    G = len(gstr_a)
    eqL = _match_vec(gstr_a, qstr_a, lo, hi, dL)
    eqR = _match_vec(gstr_a, qstr_a, lo, hi, dR)

    def bound_scan(eq):
        nmis, b = 0, 0
        while b < L1 - 1 and nmis <= 1:
            if not eq[b]:
                nmis += 1
            b += 1
        return b - 1

    leftbound = bound_scan(eqL)
    rightbound = bound_scan(eqR[::-1])
    best, bestprob = None, 0.0
    for cL in range(1, leftbound + 1):
        gl = dL + lo + cL
        if gl + 1 >= G or gstr_a[gl] != i1 or gstr_a[gl + 1] != i2:
            continue
        mincR = max(1, L1 - 12 - cL)
        maxcR = min(rightbound, L1 - min_len - cL)
        for cR in range(mincR, maxcR + 1):
            gr = dR + hi - 1 - cR
            if gr - 1 < 0 or gr >= G or gstr_a[gr - 1] != i3 \
                    or gstr_a[gr] != i4:
                continue
            mlen = L1 - cL - cR
            textleft = gl + 9      # MICROINTRON_LENGTH
            textright = gr - 9
            nw = textright - textleft - mlen
            if nw < 0 or textleft < 2 or textright + mlen + 2 > G:
                continue
            pat = qstr_a[lo + cL : lo + cL + mlen]
            win = gstr_a[textleft:textright]
            idx = np.flatnonzero(
                (win[np.arange(nw + 1)[:, None]
                     + np.arange(mlen)[None, :]] == pat).all(1))
            for c0 in idx:
                c = textleft + int(c0)
                if (gstr_a[c - 2] == i3 and gstr_a[c - 1] == i4
                        and gstr_a[c + mlen] == i1
                        and gstr_a[c + mlen + 1] == i2):
                    p2 = float(maxent_mod.splice_prob_np(
                        db.codes, np.array([c]), kinds[0])[0])
                    p3 = float(maxent_mod.splice_prob_np(
                        db.codes, np.array([c + mlen]), kinds[1])[0])
                    if p2 + p3 > bestprob:
                        bestprob = p2 + p3
                        best = (cL, mlen, c, p2, p3)
    if best is None:
        return None
    cL, mlen, c, p2, p3 = best
    if nindels == 0 and nmm < 4:
        if not (p2 >= 0.95 and p3 >= 0.95):
            return None
    elif not (p2 >= 0.90 or p3 >= 0.90):
        return None
    return lo + cL, mlen, c, itype
MERGELENGTH = 100_000        # stage3.c:62 + stage1.c:59 HIGHINTRONLENGTH
LONG_MERGELENGTH = 500_000   # stage3.c:63 (strong donor/acceptor only)
MERGE_DONOR_THR = 0.90       # stage3.c:64
MERGE_ACCEPTOR_THR = 0.90    # stage3.c:65


def _split_nonjoinable(db, gstr, qstr, chains_row):
    """Split chains at nonjoinable transitions.

    The reference cannot produce a single path across a genomic jump
    over MERGELENGTH unless a strong splice junction joins the parts:
    stage1's exon-chaining DP links segments only within
    HIGHINTRONLENGTH = 100 kb (stage1.c:2887,2945), and the post-stage3
    merge (Stage3_mergeable, stage3.c:10343-10366) reconnects parts
    under MERGELENGTH, or under LONG_MERGELENGTH when donor/acceptor
    probs clear 0.90.  Our chain DP allows transitions up to
    max_intronlen, so chains spanning unrelated loci (the chimera
    cases) are split here; gmap.c's chimera logic pairs the pieces."""
    from ..ops import maxent as maxent_mod

    def strong_junction(prev, nxt):
        qL_end, qR_start = prev[1], nxt[0]
        dL, dR = prev[3], nxt[3]
        for direction, dk, ak in ((+1, "donor", "acceptor"),
                                  (-1, "antiacceptor", "antidonor")):
            r, _, _ = _bridge_intron(gstr, qstr, qL_end, qR_start,
                                     dL, dR, direction)
            gl = dL + r
            gr = dR + r
            dp = float(maxent_mod.splice_prob_np(
                db.codes, np.array([gl - 1, gl, gl + 1]), dk).max())
            ap = float(maxent_mod.splice_prob_np(
                db.codes, np.array([gr - 1, gr, gr + 1]), ak).max())
            if dp > MERGE_DONOR_THR and ap >= MERGE_ACCEPTOR_THR:
                return True
        return False

    out = []
    for chain in chains_row:
        if not chain:
            continue
        cur = [chain[0]]
        for prev, nxt in zip(chain, chain[1:]):
            gd = nxt[3] - prev[3]
            join = gd <= MERGELENGTH or (
                gd <= LONG_MERGELENGTH and strong_junction(prev, nxt))
            if join:
                cur.append(nxt)
            else:
                out.append(cur)
                cur = [nxt]
        out.append(cur)
    return out


def _exon_prob(exonlen: int, intronlen: int, indexsize: int) -> float:
    """compute_prob (smooth.c:170-187): probability that an exon of
    exonlen matches arises by chance within intronlen positions."""
    if exonlen < indexsize:
        return 1.0
    return 1.0 - (1.0 - 4.0 ** (-exonlen)) ** max(intronlen, 0)
_ZERONETGAP = 9            # smooth.c:20
_SHORTEXONLEN_NETGAP = 15  # smooth.c:21
_DELETE_THRESHOLD = 0.1    # smooth.c:24
_SHORTEXONLEN_END = 10     # smooth.c:28
_SHORTEXONPROB_END = 0.05  # smooth.c:34 (indexsize-on build)
_STAGE2_INDEXSIZE = 8      # oligoindex major size (oligoindex.c:67)


def _smooth_merged(gstr_a, qstr_a, merged):
    """Smooth improbable short exons over the chained diagonal
    segments (Smooth_pairs_by_netgap smooth.c:475 +
    find_internal_shorts_by_size :295 DELETE branch + trim_ends :325):

      * runs of internal segments under SHORTEXONLEN_NETGAP matches
        whose intron lengths nearly cancel (|net gap| <= ZERONETGAP)
        are deleted — the flanking junction re-solves as an indel;
      * internal segments whose match count is probable by chance
        within the surrounding introns (prob > DELETE_THRESHOLD) are
        deleted — the junction re-bridges as one intron;
      * terminal short exons probable by chance across their adjacent
        intron are chopped (trim_ends).

    The reference re-solves deleted regions with dual genome gaps
    (stage3.c traverse_dual_genome_gap); here deletion simply hands
    the combined gap to the junction/dynprog/microexon ladder below.
    """
    n = len(merged)
    if n < 2:
        return merged
    matches = [int(_match_vec(gstr_a, qstr_a, qs, qe, d).sum())
               for qs, qe, gs, d in merged]
    intron = [int(merged[i + 1][3] - merged[i][3]) for i in range(n - 1)]
    status = [0] * n     # 0 KEEP, 1 MARK, 2 DELETE

    # by_netgap: mark internal shorts, delete zero-net-gap runs
    for i in range(1, n - 1):
        if matches[i] < _SHORTEXONLEN_NETGAP:
            status[i] = 1
    i = 0
    while i < n:
        if status[i] == 1:
            j = i
            while j < n and status[j] == 1:
                j += 1
            adji = i - 1 if i > 0 else 0
            best, bi, bj = 10**6, -1, -1
            for k2 in range(adji, j):
                netgap = 0
                for l2 in range(k2, j):
                    netgap += intron[l2] if l2 < n - 1 else 0
                    if l2 > k2 and abs(netgap) < best:
                        best, bi, bj = abs(netgap), k2 + 1, l2
            if bi >= 0 and best <= _ZERONETGAP:
                for t in range(bi, bj + 1):
                    status[t] = 2
            i = j
        else:
            i += 1

    # by_size: internal exons probable by chance get deleted
    for i in range(1, n - 1):
        if status[i] == 2:
            continue
        il = intron[i - 1] + intron[i]
        if _exon_prob(matches[i] + 4, il, _STAGE2_INDEXSIZE) > _DELETE_THRESHOLD:
            status[i] = 2

    # trim_ends: chop improbable terminal short exons
    i = 0
    while i < n - 1:
        if (matches[i] < _SHORTEXONLEN_END
                and _exon_prob(matches[i], intron[i], 0)
                >= _SHORTEXONPROB_END):
            status[i] = 2
            i += 1
        else:
            break
    i = n - 1
    while i > 0:
        if (matches[i] < _SHORTEXONLEN_END
                and _exon_prob(matches[i], intron[i - 1], 0)
                >= _SHORTEXONPROB_END):
            status[i] = 2
            i -= 1
        else:
            break

    out = [m for m, s in zip(merged, status) if s != 2]
    return out if out else merged


def _build_path(gstr, qstr, chain, watsonp, db, jx) -> Path | None:
    """One chain -> Path; ``jx`` = (collector, row key) gathers the
    junctions the dynprog must re-solve (align_cdna_batch pass 1) and
    hands back their solutions (pass 2)."""
    L = len(qstr)
    # merge chained segments into exons, resolving junctions
    # first: collapse segments on the same diagonal
    merged = []
    for qs, qe, gs, d in chain:
        if merged and merged[-1][3] == d:
            merged[-1] = (merged[-1][0], qe, merged[-1][2], d)
        else:
            merged.append((qs, qe, gs, d))
    if len(merged) > 1:
        merged = _smooth_merged(_as_bytes(gstr), _as_bytes(qstr), merged)

    # direction vote: count canonical GT-AG vs CT-AC across junctions
    def junction_dinucls(r, diagL, diagR):
        gl = diagL + r
        gr = diagR + r - 1
        return gstr[gl : gl + 2], gstr[gr - 1 : gr + 1]

    # try both directions, pick the one with more canonical introns
    best_path = None
    for cdna_direction in (+1, -1):
        exon_bounds = []  # (qstart, qend, diag)
        ok = True
        prev_split = _extend_end(gstr, qstr, merged[0][0], merged[0][3], -1)
        for i in range(len(merged) - 1):
            qsL, qeL, gsL, dL = merged[i]
            qsR, qeR, gsR, dR = merged[i + 1]
            gap = dR - dL
            if gap >= MIN_INTRONLENGTH:
                r, scan_score, introntype = _bridge_intron(
                    gstr, qstr, qeL, qsR, dL, dR, cdna_direction
                )
                # dynprog rescue (traverse_genome_gap): when the exact
                # split leaves mismatches in the peel window, the
                # banded affine DP kernels can place indels INSIDE the
                # window; take its solution when it scores higher
                lo = max(0, min(qeL, qsR) - 11)
                hi = min(L, max(qeL, qsR) + 11)
                gstr_a = _as_bytes(gstr)
                qstr_a = _as_bytes(qstr)
                nmmL = int((~_match_vec(gstr_a, qstr_a, lo, r, dL)).sum())
                nmmR = int((~_match_vec(gstr_a, qstr_a, r, hi, dR)).sum())
                if (nmmL + nmmR >= 2 and hi - lo >= 4
                        and lo >= prev_split):
                    sol = None
                    coll, rowkey = jx
                    key = (rowkey, cdna_direction, i)
                    if coll["mode"] == "collect":
                        coll["requests"].setdefault(
                            cdna_direction, []).append(
                            (key, (_codes_of(qstr), lo, hi, dL, dR)))
                        coll["rows"].add(rowkey)
                    else:
                        sol = coll["solutions"].get(key)
                    sol_ok = (sol is not None and sol[0] > scan_score
                              and sol[1])
                    # microexon trigger (traverse_genome_gap,
                    # stage3.c:5903): bridge noncanonical, or too many
                    # mismatches/opens/indels in the junction window
                    if sol_ok:
                        pieces = sol[1]
                        diffs = [pieces[k + 1][2] - pieces[k][2]
                                 for k in range(len(pieces) - 1)]
                        small = [abs(dd) for dd in diffs
                                 if abs(dd) < MIN_INTRONLENGTH]
                        nind_j, nopen_j = sum(small), len(small)
                        nmm_j = sum(
                            int((~_match_vec(gstr_a, qstr_a, pqs, pqe,
                                             pd)).sum())
                            for pqs, pqe, pd in pieces)
                        poor = (introntype == "noncanonical"
                                or nmm_j > 2 or nopen_j > 1 or nind_j > 3)
                    else:
                        nind_j, nmm_j = 0, nmmL + nmmR
                        poor = (introntype == "noncanonical" or nmm_j > 2)
                    if poor and lo >= prev_split:
                        micro = _microexon_int(
                            gstr_a, qstr_a, lo, hi, dL, dR,
                            cdna_direction, db, nind_j, nmm_j)
                        if micro is not None:
                            mqs, mlen, mc, mitype = micro
                            exon_bounds.append(
                                (prev_split, mqs, dL, mitype))
                            exon_bounds.append(
                                (mqs, mqs + mlen, mc - mqs, mitype))
                            prev_split = mqs + mlen
                            continue
                    if sol_ok:
                        # emit the DP pieces as bounds; neighbors merge
                        # on equal diagonals downstream
                        fs, pieces, _ = sol
                        exon_bounds.append(
                            (prev_split, pieces[0][0], dL, None))
                        for pi, (pqs, pqe, pd) in enumerate(pieces):
                            exon_bounds.append(
                                (pqs, pqe, pd,
                                 introntype if pi + 1 < len(pieces)
                                 else None))
                        prev_split = pieces[-1][1]
                        continue
                if (introntype == "noncanonical" and nmmL + nmmR < 2
                        and lo >= prev_split):
                    # clean split but no canonical intron: the reference
                    # still tries a microexon (introntype == NONINTRON
                    # alone triggers stage3.c:5903)
                    micro = _microexon_int(gstr_a, qstr_a, lo, hi, dL, dR,
                                           cdna_direction, db, 0,
                                           nmmL + nmmR)
                    if micro is not None:
                        mqs, mlen, mc, mitype = micro
                        exon_bounds.append((prev_split, mqs, dL, mitype))
                        exon_bounds.append(
                            (mqs, mqs + mlen, mc - mqs, mitype))
                        prev_split = mqs + mlen
                        continue
            else:
                r = _solve_indel_junction(gstr, qstr, qeL, qsR, dL, dR)
                introntype = "indel"
            exon_bounds.append((prev_split, r, dL, introntype))
            # insertion (dR < dL): the inserted query bases [r, r+nins)
            # are unaligned; the right exon resumes at r + nins so the
            # genome stays contiguous
            prev_split = r + (dL - dR) if gap < 0 else r
        last_end = _extend_end(gstr, qstr, merged[-1][1], merged[-1][3], +1)
        exon_bounds.append((prev_split, last_end, merged[-1][3], None))

        exons = []
        intron_types = []
        indels = 0
        prev = None
        for qs, qe, d, itype in exon_bounds:
            if qe <= qs:
                ok = False
                break
            m, mm = _count_matches(gstr, qstr, qs, qe, d)
            if prev is not None and prev[1] == d and itype is None:
                pass
            if exons and exons[-1].gend - exons[-1].gstart >= 0 and d == (
                exons[-1].gstart - exons[-1].qstart
            ):
                # same diagonal continuation (indel junction resolved to 0)
                exons[-1].qend = qe
                exons[-1].gend = d + qe
                exons[-1].matches += m
                exons[-1].mismatches += mm
                if intron_types and intron_types[-1] == "indel":
                    intron_types.pop()
            else:
                exons.append(Exon(qs, qe, d + qs, d + qe, m, mm))
                if itype is not None and len(exons) > 1:
                    pass
            prev = (qs, d)
        if not ok or not exons:
            continue
        # record junction types between final exons
        intron_types = []
        for i in range(len(exons) - 1):
            gl = exons[i].gend
            gr = exons[i + 1].gstart - 1
            left_dinucl = gstr[gl : gl + 2]
            right_dinucl = gstr[gr - 1 : gr + 1]
            _, itype = intron_score(left_dinucl, right_dinucl, cdna_direction, 1, True)
            intron_types.append(itype)

        ncanonical = sum(1 for t in intron_types if t == "canonical")
        # no canonical-family intron -> cDNA direction indeterminate
        # (pick_cdna_direction, stage3.c:3694)
        direction = (cdna_direction if any(
            t in ("canonical", "gcag", "atac") for t in intron_types)
            else 0)
        path = Path(
            watsonp=watsonp,
            cdna_direction=direction,
            exons=exons,
            intron_types=intron_types,
            querylength=L,
        )
        key = (ncanonical, path.matches)
        if best_path is None or key > best_path[0]:
            best_path = (key, path)

    return best_path[1] if best_path else None
