"""Host-side GSNAP runner for the port: FASTQ records -> device -> SAM.

Single-end (``run``) and paired-end (``run_pe``), standard,
cmet-stranded or atoi-stranded mode (``--mode``), ``-N 0`` or ``-N 1``
(novel splicing), with the GMAP rescue lanes of
``--gmap-mode`` (terminal, improvement, PE pairsearch; the default runs
them all).  The device half is one call per batch of
``gsnap_gapped.align_batch_gapped`` (SE) or ``gsnap_pe.align_batch_pe``
(PE: both ends through the seed/vote/verify/indel/splice kernels, then
the pairing grid kernel) and the plain-torch ranking around them; the
full result tree comes to the host in one copy.  The reads the GMAP
lanes take are aligned once per batch by ``gmap.align_cdna_batch``
(kernels K9-K12).  The host half — end trimming, MD/NM, the end indel,
terminal, GMAP, (with known splice sites, ``-s``) short-end and (with
``-N 1``) distant splice rescue lanes, pair rescue with its inside-pair
ambiguous-splice resolution, MAPQ and SAM emission — is the numpy code
of gmap_gsnap_tpu/align/runner.py, copied (not rewritten) because that
module imports JAX.  SNP-tolerant runs (``-v``) seed on the SNP index
and accept the alt genome's alleles as matches; cmet/atoi runs seed each
strand on its converted index (db/transforms.write_converted_indexes)
and tolerate the conversion in selection, and only its own direction in
MD/NM.  What this module leaves out of it: native output,
gene/tally/runlength multimapping resolution (the identity without
those databases), output routing
(--split-output), ``warmup`` (XLA compiles) and the TPU transfer
slimming (compact views, row-subset fetches, pad buckets); see
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys as _sys
import time as _time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import native as native_mod
from ..db import datadir, splicesites
from ..db.datadir import GenomeDB
from ..db.iit import IIT
from ..io import sam
from ..io.fasta import Record
from ..io.gsnap_native import _align_score
from ..utils import dna
from ..utils.device import resolve_device
from . import distant as distant_mod
from . import gsnap_gapped, gsnap_pe, gsnap_se, rescue
from .gsnap_gapped import (KIND_DEL, KIND_INS, KIND_SHORTEXON, KIND_SPLICE,
                           KIND_SUB)

MAX_QUALITY_SCORE = 40
MAPQ_MAXIMUM_SCORE = 40
QUALITY_ADJ = 33

# log(1/3 * 10^(-Q/10)) for Q = 0..40 (mapq.c:36-46)
MISMATCH_LOGPROB = np.array(
    [-math.log(3.0) - q * math.log(10.0) / 10.0 for q in range(MAX_QUALITY_SCORE + 1)]
)

TRIM_MATCH_SCORE = 1

# gsnap -0/--noexceptions: lets the raw traceback propagate
EXCEPTION_GUARD = True

# rows with more hits than this take the full emission path
PAIR_KTOP = 2

# genome base and read base of each cmet/atoi conversion: the read
# shows the second where the genome has the first
_CONV_BASES = {"ct": "CT", "ga": "GA", "ag": "AG", "tc": "TC"}


def _offending_read(*recs) -> None:
    """Crash guard: report the read being processed when emission
    raises (src/gsnap.c:699-739,934-961)."""
    if not EXCEPTION_GUARD:
        return
    for r in recs:
        print(f"Problem sequence: {r.label} ({len(r.seq)} bp)",
              file=_sys.stderr)
        print(r.seq, file=_sys.stderr)


def chop_primers(seq1: str, seq2_inv: str) -> int:
    """Shortread_chop_primers (shortread.c:1402-1460): detect paired-end
    adapter readthrough by sliding read 1 against the INVERTED read 2;
    the best full-overlap offset with <= 1 mismatch is the chop length
    (applied to read 1's tail and inverted read 2's head).  Positions
    past the end of read 2 count as mismatches (the reference compares
    against the NUL terminator)."""
    s1 = seq1.upper()
    s2 = seq2_inv.upper()
    L1, L2 = len(s1), len(s2)
    MINLEN, ALLOWED = 20, 1
    best_score, chop = 0, 0
    for jstart in range(0, min(L2 - MINLEN, L1 - MINLEN)):
        nmm = 0
        i, j = 0, jstart
        while nmm <= ALLOWED and i < L1 - jstart:
            if j >= L2 or s1[i] != s2[j]:
                nmm += 1
            i += 1
            j += 1
        if nmm <= ALLOWED:
            nmatches = j - nmm
            score = nmatches * 3 - nmm
            if score > best_score:
                best_score = score
                chop = jstart
    return chop


def trim_ends(mm: np.ndarray, trim_mismatch_score: int = -3) -> tuple[int, int]:
    """Exact reimplementation of trim_left_end + trim_right_end
    (substring.c) for a full-length gapless alignment.

    mm: bool[L] mismatch vector in query coordinates.
    Returns (trim5, trim3)."""
    L = len(mm)
    positions = np.flatnonzero(mm)

    # trim_left_end: scan mismatches right-to-left
    bestscore = score = 0
    trim5 = 0
    prevpos = L
    for p in positions[::-1]:
        pos = p + 1
        score += (prevpos - pos) * TRIM_MATCH_SCORE
        if score >= bestscore:
            bestscore = score
            trim5 = pos
        score += trim_mismatch_score
        if score < 0:
            score = 0
        prevpos = pos - 1
    score += prevpos * TRIM_MATCH_SCORE
    if score >= bestscore:
        trim5 = 0

    # trim_right_end: scan mismatches left-to-right
    bestscore = score = 0
    trim3 = 0
    prevpos = -1
    for p in positions:
        pos = p - 1
        score += (pos - prevpos) * TRIM_MATCH_SCORE
        if score >= bestscore:
            bestscore = score
            trim3 = L - pos - 1
        score += trim_mismatch_score
        if score < 0:
            score = 0
        prevpos = pos + 1
    score += (L - 1 - prevpos) * TRIM_MATCH_SCORE
    if score >= bestscore:
        trim3 = 0

    return trim5, trim3


def trim_ends_batch(mm: np.ndarray, trim_mismatch_score: int = -3):
    """Vectorized trim_ends over a [F, L] mismatch matrix.

    Same per-row semantics as trim_ends (substring.c trim_left_end +
    trim_right_end); the sequential scan over mismatch positions runs
    over the mismatch ORDINAL (max per-row count iterations, typically
    <= ~6), each step vectorized across all F rows.
    Returns (trim5[F], trim3[F]) int64 arrays."""
    F, L = mm.shape
    counts = mm.sum(1).astype(np.int64)
    K = int(counts.max()) if F else 0
    P = np.zeros((F, max(K, 1)), np.int64)
    r, c = np.nonzero(mm)
    if len(r):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ordinal = np.arange(len(r)) - np.repeat(starts, counts)
        P[r, ordinal] = c
    rowsel = np.arange(F)

    # trim_left_end: mismatch positions right-to-left
    score = np.zeros(F, np.int64)
    best = np.zeros(F, np.int64)
    trim5 = np.zeros(F, np.int64)
    prevpos = np.full(F, L, np.int64)
    for t in range(K):
        idx = counts - 1 - t
        act = idx >= 0
        pos = P[rowsel, np.clip(idx, 0, None)] + 1
        s2 = score + (prevpos - pos) * TRIM_MATCH_SCORE
        upd = act & (s2 >= best)
        best = np.where(upd, s2, best)
        trim5 = np.where(upd, pos, trim5)
        score = np.where(act, np.maximum(s2 + trim_mismatch_score, 0), score)
        prevpos = np.where(act, pos - 1, prevpos)
    fin = score + prevpos * TRIM_MATCH_SCORE
    trim5 = np.where(fin >= best, 0, trim5)

    # trim_right_end: mismatch positions left-to-right
    score = np.zeros(F, np.int64)
    best = np.zeros(F, np.int64)
    trim3 = np.zeros(F, np.int64)
    prevpos = np.full(F, -1, np.int64)
    for t in range(K):
        act = t < counts
        pos = P[:, t] - 1
        s2 = score + (pos - prevpos) * TRIM_MATCH_SCORE
        upd = act & (s2 >= best)
        best = np.where(upd, s2, best)
        trim3 = np.where(upd, L - pos - 1, trim3)
        score = np.where(act, np.maximum(s2 + trim_mismatch_score, 0), score)
        prevpos = np.where(act, pos + 1, prevpos)
    fin = score + (L - 1 - prevpos) * TRIM_MATCH_SCORE
    trim3 = np.where(fin >= best, 0, trim3)
    return trim5, trim3


def _md_from_positions(pos, refch: str, span_len: int) -> str:
    """MD string from ascending span-relative mismatch positions and the
    genome chars at them — exact sam.md_gapped single-part formatting
    (leading 0 printed, interior zero runs omitted, trailing run > 0)."""
    if len(pos) == 0:
        return str(span_len)
    out = [str(pos[0]), refch[0]]
    for k in range(1, len(pos)):
        gap = pos[k] - pos[k - 1] - 1
        if gap > 0:
            out.append(str(gap))
        out.append(refch[k])
    rem = span_len - 1 - pos[-1]
    if rem > 0:
        out.append(str(rem))
    return "".join(out)


_COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP_LUT[_a] = _b
del _a, _b


def _substring_bounds(d: "PostHit", L: int):
    """Per-substring (proj_start, proj_end) whole-read projections in
    query direction (Substring genomicstart/genomicend), in the
    reference's substring order (query order of the ORIGINAL read =
    reversed aligned order for minus hits)."""
    out = []
    for qs, qe, g0 in d.parts:
        diag = g0 - qs
        if d.plusp:
            out.append((diag, diag + L))
        else:
            out.append((diag + L, diag))
    return out[::-1] if not d.plusp else out


def substring_spans(d: "PostHit", L: int):
    """Trimmed aligned genomic intervals per substring, in the
    reference's substring order (Substring alignstart/alignend).  Falls
    back to the whole trimmed span for hits without parts."""
    if not d.parts:
        span = d.trim5 + d.ref_consumed + d.trim3
        if d.plusp:
            return [(d.left + d.trim5, d.left + span - d.trim3)]
        return [(d.left + d.trim3, d.left + span - d.trim5)]
    out = []
    n = len(d.parts)
    for k, (qs, qe, g0) in enumerate(d.parts):
        lo = d.trim5 if k == 0 else 0
        hi = d.trim3 if k == n - 1 else 0
        out.append((g0 + lo, g0 + (qe - qs) - hi))
    return out[::-1] if not d.plusp else out


def reference_pairlength(d5: "PostHit", d3: "PostHit", L5: int, L3: int) -> int:
    """Exact Stage3pair insertlength (stage3hr.c:7469-7560 +
    pair_insert_length :6108) for non-GMAP hits on one chromosome."""
    qadj5 = L5 + d5.ndel
    qadj3 = L3 + d3.ndel
    span5 = d5.trim5 + d5.ref_consumed + d5.trim3
    span3 = d3.trim5 + d3.ref_consumed + d3.trim3
    gs5, ge5 = (d5.left, d5.left + span5) if d5.plusp else (d5.left + span5, d5.left)
    gs3, ge3 = (d3.left, d3.left + span3) if d3.plusp else (d3.left + span3, d3.left)

    if d5.plusp and not d3.plusp:
        if ge5 < ge3:
            return (ge3 - ge5) + qadj5 + qadj3
        if gs3 < gs5:
            return (gs5 - gs3) + qadj5 + qadj3
        return 0
    if not d5.plusp and d3.plusp:
        if gs5 < gs3:
            return (gs3 - gs5) + qadj5 + qadj3
        if ge3 < ge5:
            return (ge5 - ge3) + qadj5 + qadj3
        return 0

    # same strand
    if d5.plusp:
        if ge5 < gs3:
            return (gs3 - ge5) + qadj5 + qadj3
    else:
        if gs3 < ge5:
            return (ge5 - gs3) + qadj5 + qadj3

    # pair_insert_length: first substring pair that overlaps genomically
    sp5 = substring_spans(d5, L5)
    sp3 = substring_spans(d3, L3)
    pr5 = _substring_bounds(d5, L5)
    pr3 = _substring_bounds(d3, L3)
    for j in range(len(sp3)):
        for i in range(len(sp5)):
            lo5, hi5 = sp5[i]
            lo3, hi3 = sp3[j]
            if not (hi3 < lo5 or lo3 > hi5):
                return abs(pr5[i][0] - pr3[j][1])
    # no overlap between any substrings
    if d5.plusp:
        if ge5 > gs3 + qadj5 + qadj3:
            return 0
        return (gs3 - ge5) + qadj5 + qadj3
    else:
        if gs3 > ge5 + qadj5 + qadj3:
            return 0
        return (ge5 - gs3) + qadj5 + qadj3


@dataclass
class PostHit:
    left: int          # untrimmed alignment start (part 1 diagonal)
    plusp: bool
    trim5: int
    trim3: int
    nmm_trimmed: int   # NM tag value (ref mismatches + indel length)
    nmatches: int
    loglik: float
    md: str
    cigar_core: str    # CIGAR without the soft clips
    ref_consumed: int  # genome bases consumed by cigar_core
    xs: str | None = None
    intron: int = 0    # N-gap length (splice hits)
    ndel: int = 0      # deletion length (querylength_adj = L + ndel)
    parts: tuple = ()  # aligned parts (qstart, qend, genome_start)
    mmpos: tuple = ()  # selection-mismatch query positions (untrimmed)
    nmatches_whole: int = 0  # reference nmatches (whole region incl trims)
    term_ends: tuple | None = None  # terminal endtypes (aligned order)
    distant: dict | None = None  # distant-splice info (sense, type,
    # dist, sites, probs, per-part MD/NM, penalty, dinucl) for the
    # translocation SAM records (XT tag)
    ambi: dict | None = None  # ambiguous shortend-splice alternatives
    # (side, sp, sense, sites, nmm, long_left) for inside-pair
    # resolution (resolve_inside_ambiguous_splice, stage3hr.c:6329)


def invert_records(recs: list[Record]) -> list[Record]:
    """Records reverse-complemented, qualities reversed: how run_pe hands
    read 2 (or, with -o RF, read 1) to dispatch_pairs."""
    return [
        Record(r.label, r.header, dna.revcomp_str(r.seq.upper()),
               r.quality[::-1] if r.quality else r.quality)
        for r in recs
    ]


def encode_batch(records: list[Record], lmax: int):
    """Batch 2-bit encode: ONE table lookup over the concatenated
    reads instead of a per-record loop."""
    b = len(records)
    seqs = [r.seq[:lmax] for r in records]
    lengths = np.fromiter((len(s) for s in seqs), np.int32, b)
    buf = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
    call = dna.CODE_TABLE[buf]
    fall = dna.FLAG_TABLE[buf]
    if b and int(lengths[0]) == lmax and (lengths == lmax).all():
        return (np.ascontiguousarray(call.reshape(b, lmax)),
                fall.reshape(b, lmax), lengths)
    codes = np.zeros((b, lmax), np.uint8)
    nflags = np.zeros((b, lmax), bool)
    mask = np.arange(lmax)[None, :] < lengths[:, None]
    codes[mask] = call
    nflags[mask] = fall
    return codes, nflags, lengths


def _tree_host(tree: dict, b: int) -> dict:
    """Rows [:b] of a nested dict of [B, ...] tensors, as numpy arrays,
    in ONE device -> host transfer: the leaves' bytes are packed into one
    buffer on the device (widest types first, so every leaf stays
    aligned), copied, and cut back into arrays."""
    leaves = []

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), v[:b].contiguous()))

    walk(tree, ())
    leaves.sort(key=lambda kv: -kv[1].element_size())
    buf = torch.cat([v.reshape(-1).view(torch.uint8) for _, v in leaves])
    buf = buf.cpu().numpy()
    out: dict = {}
    off = 0
    for path, v in leaves:
        n = v.numel() * v.element_size()
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        arr = buf[off : off + n].view(dt).reshape(tuple(v.shape))
        off += n
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = arr
    return out


class GsnapRunner:
    """SE and PE GSNAP runner on one device (``device`` defaults to
    "cuda", which raises where there is no CUDA device).

    ``params`` defaults to GsnapParams() with the dynamic size threshold,
    like the JAX runner (so the default GMAP lanes run).
    ``novelsplicing`` is gsnap -N 1: local splices and short exons on the
    device, the distant lane on the host.  ``splicesdb`` is gsnap -s: a
    splicesites (or introns) map IIT, a path or a name looked up in
    ``splicing_dir`` and ``<db>.maps``; it turns splicing on even without
    -N 1.  ``snpsdb`` is gsnap -v: the SNP-tolerant index and alt genome
    that db/transforms.write_snp_index wrote into ``snps_dir`` (default:
    the database directory).  ``params.mode`` cmet-stranded or
    atoi-stranded loads the converted index pair (metct/metga or
    a2iag/a2itc, written by cli/cmetindex or cli/atoiindex) from
    ``cmet_dir`` / ``atoi_dir`` or the database directory; with ``snpsdb``
    the SNP index serves both strands instead, as in the JAX runner."""

    def __init__(self, db: GenomeDB, params: gsnap_se.GsnapParams | None = None,
                 lmax: int = 100, snpsdb: str | None = None,
                 novelsplicing: bool = False, splicesdb: str | None = None,
                 snps_dir: str | None = None,
                 splicing_dir: str | None = None,
                 cmet_dir: str | None = None, atoi_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.cmet_dir = cmet_dir
        self.atoi_dir = atoi_dir
        if params is None:
            params = gsnap_se.GsnapParams()
            if db.offsets is not None:
                params = dataclasses.replace(
                    params,
                    size_threshold=gsnap_se.dynamic_size_threshold(
                        int(db.offsets[-1]), db.k, params.mode))
        if novelsplicing and params.seed_total:
            # RNA workloads sit on junction/repeat windows more often; a
            # larger shared seed budget keeps the fullwide rescue lane rare
            params = dataclasses.replace(
                params, seed_total=max(params.seed_total, 512))
        self.db = db
        self.lmax = lmax
        self.params = params
        self.gapped_params = gsnap_gapped.GappedParams(
            base=params, novelsplicing=novelsplicing)
        # --gmap-mode lane list (gsnap.c:1188-1214 add_gmap_mode)
        self.gmap_modes = {m.strip() for m in
                           self.params.gmap_mode.split(",") if m.strip()}
        self.splicing_on = novelsplicing
        self.merge_samechr = False  # gsnap --merge-distant-samechr
        self.device = resolve_device(device)
        self.known = None
        self._known_sites = None
        self._splice_labels = None
        if splicesdb is not None:
            path = splicesdb
            if splicing_dir and not os.path.exists(path):
                path = os.path.join(splicing_dir, f"{splicesdb}.iit")
            if not os.path.exists(path):
                path = os.path.join(db.dbdir, f"{db.dbname}.maps",
                                    f"{splicesdb}.iit")
            if not os.path.exists(path):
                raise FileNotFoundError(f"no splicesites map {splicesdb}")
            sites = splicesites.load_splicesites(
                IIT.read(path), db.chr_names, db.chr_starts)
            self.known = sites.device_bitmasks(len(db.codes), self.device)
            self._known_sites = sites  # host arrays for the shortend lane
            self._splice_labels = sites.labels
            self.splicing_on = True
        self.genome = datadir.device_genome(db, self.device)
        # lazy genome view: slices decode on demand, vectorized host
        # compares use the shared ASCII array (no whole-genome str)
        self._genome_str = db.genome_str
        self._genome_bytes = self._genome_str.ascii
        self.alt = None
        self._alt_str = None
        self._alt_bytes = None
        self._snpsdb = snpsdb
        self.index_minus = None
        mode = self.params.mode
        if snpsdb is not None:
            # SNP-tolerant: the SNP index replaces the standard one, and
            # the alt genome's alleles count as matches.  As in the JAX
            # runner (runner.py:551-589) this branch comes first: under
            # --mode the SNP index serves both strands and the host keeps
            # no conversion, while the device cascade still converts
            # each strand by params.mode
            self.index, self.alt, self._alt_str = datadir.device_snps(
                db, snpsdb, snps_dir, self.device)
            self._alt_bytes = self._alt_str.ascii
            self._conv_plus = self._conv_minus = None
        else:
            if mode == "standard":
                self.index = datadir.device_index(db, self.device)
            else:
                # cmet/atoi: the converted index pair (--cmetdir /
                # --atoidir override, gsnap.c:257-263)
                self.index, self.index_minus = datadir.device_converted(
                    db, mode, cmet_dir if mode.startswith("cmet")
                    else atoi_dir, self.device)
            # conversion names for host-side MD/trim computation
            self._conv_plus, self._conv_minus = gsnap_se._MODE_CONV[mode]
        # gsnap --ambig-splice-noclip sets this False (amb_clip_p,
        # gsnap.c:1247 / splicetrie.c:1945,2099): ambiguous known
        # splicing at a read end is then DROPPED instead of emitted as
        # a soft-clipped ambiguous hit, and short ends below
        # min_shortend never splice
        self.amb_clip = True
        self.ambi_resolved = 0  # ambiguous ends _resolve_inside_ambi resolved
        self._gmap_cache: dict = {}
        self._lane_masks: dict = {}   # (id(rec), left, plusp) -> (sel, ref)
        self._lane_trims: dict = {}   # same key -> (t5, t3) at params score
        self._gmap_collect = None
        self._gmap_rows: set = set()
        self._gmap_row = -1
        self.gmap_seconds = 0.0       # host wall spent in prefetch_gmap
        self.quiet_if_excessive = False  # gsnap -Q (quiet_if_excessive_p)
        self.pe_fast = True  # vectorized PE SAM fast path (tests may disable)
        self.clip_overlap = False  # gsnap --clip-overlap (clip_overlap_p)
        self.chop_primers = False  # gsnap -a (chop_primers_p)
        # gsnap -o/--orientation (FR default: invert read 2 at input)
        self.invert_first = False
        self.invert_second = True
        self.category_counts = Counter()  # resulttype histogram
        self._categories: dict = {}
        self._catkey = None
        self.batch_times: list = []

    # ---------------------------------------------------------------- device
    def _gp_uniform(self, gp, *length_arrays):
        """Set the uniform_len hint (flip revcomp) when every read in
        the batch (both ends of a PE batch) is exactly lmax long."""
        uni = all(len(a) > 0 and int(a.min()) == self.lmax
                  for a in length_arrays)
        if gp.base.uniform_len == uni:
            return gp
        return dataclasses.replace(
            gp, base=dataclasses.replace(gp.base, uniform_len=uni))

    def _dispatch(self, records: list[Record], gp):
        codes, nflags, lengths = encode_batch(records, self.lmax)
        dev = self.device
        res = gsnap_gapped.align_batch_gapped(
            self.genome, self.index,
            torch.from_numpy(codes).to(dev), torch.from_numpy(nflags).to(dev),
            torch.from_numpy(lengths).to(dev), self._gp_uniform(gp, lengths),
            index_minus=self.index_minus, alt=self.alt, known=self.known)
        return res, len(records)

    def dispatch_records(self, records: list[Record]):
        """Queue the device SE pipeline for a chunk (CUDA runs it
        asynchronously; fetch_records waits for it)."""
        return self._dispatch(records, self.gapped_params)

    @staticmethod
    def fetch_records(dispatched):
        """Device -> host copy of the whole result tree."""
        res, b = dispatched
        return {k: v[:b].cpu().numpy() for k, v in res.items()}

    def align_records(self, records: list[Record]):
        """Full-tree SE alignment of one chunk, on the host."""
        return self.fetch_records(self.dispatch_records(records))

    # fullwide tier seed budget; rows STILL truncating re-run once more
    # at the exact grid (seed_total=0)
    _WIDE_SEED_TOTAL = 4096

    def _wide_base(self, widen_seeds: bool, exact: bool = False):
        """Wide-lane params: the candidate budget x4 (<= 128), and the
        seed budget raised to _WIDE_SEED_TOTAL (widen_seeds) or removed
        (exact) for reads whose seed grid truncated."""
        seed_total = self.params.seed_total
        if exact:
            seed_total = 0
        elif widen_seeds:
            seed_total = self._WIDE_SEED_TOTAL
        return dataclasses.replace(
            self.params,
            seed_total=seed_total,
            ncand=min(4 * self.params.ncand, 128))

    def _dispatch_wide(self, records: list[Record],
                       widen_seeds: bool = True, exact: bool = False):
        """Queue the SE overflow rescue for a subset of a chunk."""
        gp = dataclasses.replace(self.gapped_params,
                                 base=self._wide_base(widen_seeds, exact))
        return self._dispatch(records, gp)

    # ------------------------------------------------------- paired-end device
    def _dispatch_pe(self, recs5: list[Record], recs3_inv: list[Record], gp):
        c5, f5, l5 = encode_batch(recs5, self.lmax)
        c3, f3, l3 = encode_batch(recs3_inv, self.lmax)
        dev = self.device
        t = lambda x: torch.from_numpy(x).to(dev)
        # RNA pairmax when any splicing is enabled (gsnap.c pairmax_rna)
        params = gsnap_pe.PEParams(gapped=self._gp_uniform(gp, l5, l3),
                                   pairmax=self._pairmax())
        res = gsnap_pe.align_batch_pe(self.genome, self.index, t(c5), t(f5),
                                      t(l5), t(c3), t(f3), t(l3), params,
                                      index_minus=self.index_minus,
                                      alt=self.alt, known=self.known)
        return res, len(recs5)

    def dispatch_pairs(self, recs5: list[Record], recs3_inv: list[Record]):
        """Queue the device PE pipeline for a chunk (CUDA runs it
        asynchronously; fetch_pairs waits for it)."""
        return self._dispatch_pe(recs5, recs3_inv, self.gapped_params)

    @staticmethod
    def fetch_pairs(dispatched):
        """Device -> host copy of the whole PE result tree (one
        transfer).  Each end's candidate arrays (cand_*, overflow) join
        its ranked hits under "end5" / "end3", where the rescue lanes
        read them."""
        res, b = dispatched
        host = _tree_host(res, b)
        for ek, ck in (("end5", "cands5"), ("end3", "cands3")):
            host[ek].update(host.pop(ck))
        return host

    def align_pairs(self, recs5: list[Record], recs3_inv: list[Record]):
        """recs3_inv: read-2 records already reverse-complemented
        (invert_second_p, gsnap.c)."""
        return self.fetch_pairs(self.dispatch_pairs(recs5, recs3_inv))

    def _dispatch_wide_pe(self, recs5, recs3_inv, widen_seeds: bool = True,
                          exact: bool = False):
        """Queue the PE overflow rescue for a subset of a chunk (fetch
        with fetch_pairs)."""
        gp = dataclasses.replace(self.gapped_params,
                                 base=self._wide_base(widen_seeds, exact))
        return self._dispatch_pe(recs5, recs3_inv, gp)

    def _pairmax(self) -> int:
        """pairmax_rna when splicing is on, else pairmax_dna
        (gsnap.c:2105-2110)."""
        return (self.params.pairmax_rna if self.splicing_on
                else self.params.pairmax_dna)

    # ------------------------------------------------------------------ host
    @staticmethod
    @functools.lru_cache(maxsize=8)
    def _conv_lut(conv) -> np.ndarray:
        """uint8[256] byte-translation table for a cmet/atoi conversion."""
        lut = np.arange(256, dtype=np.uint8)
        if conv is not None:
            a, b = _CONV_BASES[conv]
            lut[ord(a)] = ord(b)
        return lut

    _ACGT_SET = np.zeros(256, bool)
    for _c in b"ACGT":
        _ACGT_SET[_c] = True
    del _c

    def _mismatch_masks(self, q: str, g0: int,
                        conv=None) -> tuple[np.ndarray, np.ndarray]:
        """(selection mask, ref-relative mask) for query part ``q``
        aligned at genome position g0.  Selection honors the strand's
        cmet/atoi conversion ``conv`` (both directions) and SNP tolerance
        (a base equal to the alt allele matches); MD/NM stay
        ref-relative."""
        n = len(q)
        qb = np.frombuffer(q.encode("latin-1"), np.uint8)
        gb = self._genome_bytes[g0 : g0 + n]
        if len(gb) < n:  # past end of genome: mismatch
            gb = np.concatenate([gb, np.zeros(n - len(gb), np.uint8)])
        lut = self._conv_lut(conv)
        qn = qb == ord("N")
        mm = ~qn & (~self._ACGT_SET[gb] | (lut[qb] != lut[gb]))
        if conv is None:
            mm_ref = mm
        else:
            # display (MD/NM) tolerance is ONE-directional: only the
            # genuine conversion direction (genome C -> read T for ct,
            # genome G -> read A for ga, ...) counts as a match; the
            # reverse (read C vs genome T) aligns under the two-sided
            # selection conversion but is REPORTED as a mismatch
            # (reference cmet MD/NM, e.g. MD:Z:72C7T19 on a read-C/
            # genome-T site)
            ga, rb = _CONV_BASES[conv]
            tol = (gb == ord(ga)) & (qb == ord(rb))
            mm_ref = ~qn & (~self._ACGT_SET[gb] | ((qb != gb) & ~tol))
        if self._alt_bytes is not None:
            ab = self._alt_bytes[g0 : g0 + n]
            if len(ab) < n:
                ab = np.concatenate([ab, np.zeros(n - len(ab), np.uint8)])
            # a new array: mm_ref must keep the ref-relative mismatches
            mm = mm & (qb != ab)
        return mm, mm_ref

    def _prime_lane_masks(self, jobs, shifts=None) -> None:
        """Vectorize the host rescue lanes' mismatch-mask computation.

        jobs: list of (rec, lefts, plusps) — candidate diagonals per
        record.  For every unique (rec, left+shift, plusp) the selection
        and ref-relative masks are computed as ONE [P, L] byte compare;
        the lanes consult `self._lane_masks` / `self._lane_trims` first.
        shifts covers the end-indel lane's shifted diagonals
        (±max_end_del / ±max_end_ins)."""
        if shifts is None:
            shifts = range(-self.params.max_end_deletions,
                           self.params.max_end_insertions + 1)
        shifts_a = np.asarray(list(shifts), np.int64)
        nsh = len(shifts_a)
        sh0 = int(np.flatnonzero(shifts_a == 0)[0]) if (shifts_a == 0).any() else -1
        groups = []          # (rec, L, plusp, uniq_lefts)
        for rec, lefts, plusps in jobs:
            la = np.asarray(lefts, np.int64)
            pa = np.asarray(plusps, bool)
            for plusp in (True, False):
                sel = la[pa == plusp]
                if not len(sel):
                    continue
                groups.append((rec, len(rec.seq), bool(plusp),
                               np.unique(sel)))
        if not groups:
            return
        gb_all = self._genome_bytes
        G = len(gb_all)
        std = self._conv_plus is None and self._conv_minus is None
        by_len: dict[int, list] = {}
        for gi, (rec, L, plusp, uls) in enumerate(groups):
            by_len.setdefault(L, []).append(gi)
        for L, gidxs in by_len.items():
            qmat_g, g0_list, ginfo = [], [], []
            for gi in gidxs:
                rec, _, plusp, uls = groups[gi]
                q = (rec.seq.upper() if plusp
                     else dna.revcomp_str(rec.seq.upper()))
                qb = np.frombuffer(q.encode("latin-1"), np.uint8)
                conv = self._conv_plus if plusp else self._conv_minus
                g0s = (uls[:, None] + shifts_a[None, :]).ravel()
                g0_list.append(g0s)
                ginfo.append((rec, plusp, uls, len(g0s)))
                qmat_g.append((self._conv_lut(conv)[qb], qb, qb == ord("N"),
                               conv, len(g0s)))
            g0_all = np.concatenate(g0_list)
            gidx = g0_all[:, None] + np.arange(L)[None, :]
            okm = (gidx >= 0) & (gidx < G)
            gmat = np.where(okm, gb_all[np.clip(gidx, 0, G - 1)], 0)
            qmat = np.concatenate(
                [np.broadcast_to(qc, (n, L)) for qc, _, _, _, n in qmat_g])
            qn = np.concatenate(
                [np.broadcast_to(qnn, (n, L)) for _, _, qnn, _, n in qmat_g])
            qraw = np.concatenate(
                [np.broadcast_to(qb_, (n, L)) for _, qb_, _, _, n in qmat_g])
            if std:
                mm = ~qn & (~self._ACGT_SET[gmat] | (qmat != gmat))
                mm_ref = mm
            else:
                gconv = gmat.copy()
                tol = np.zeros(gmat.shape, bool)
                off = 0
                for _, _, _, conv, n in qmat_g:
                    gconv[off : off + n] = self._conv_lut(conv)[
                        gmat[off : off + n]]
                    if conv is not None:
                        gc_, rc_ = _CONV_BASES[conv]
                        tol[off : off + n] = (
                            (gmat[off : off + n] == ord(gc_))
                            & (qraw[off : off + n] == ord(rc_)))
                    off += n
                # selection tolerates both conversion directions (the
                # two-sided LUT); display tolerates only the genuine
                # one (see _mismatch_masks)
                mm = ~qn & (~self._ACGT_SET[gmat] | (qmat != gconv))
                mm_ref = ~qn & (~self._ACGT_SET[gmat]
                                | ((qraw != gmat) & ~tol))
            if self._alt_bytes is not None:
                amat = np.where(okm, self._alt_bytes[np.clip(gidx, 0, G - 1)],
                                0)
                mm = mm & (qraw != amat)
            # trims are consulted only for the UNSHIFTED diagonals
            t5s = t3s = None
            if sh0 >= 0:
                base_rows = np.concatenate(
                    [off0 + np.arange(len(uls)) * nsh + sh0
                     for off0, (_, _, uls, _) in zip(
                         np.cumsum([0] + [n for _, _, _, n in ginfo])[:-1],
                         ginfo)])
                t5s, t3s = trim_ends_batch(
                    mm[base_rows], self.params.trim_mismatch_score)
            off = 0
            bpos = 0
            for rec, plusp, uls, n in ginfo:
                rid = id(rec)
                for ui, left in enumerate(uls):
                    for si in range(nsh):
                        row = off + ui * nsh + si
                        key = (rid, int(left + shifts_a[si]), plusp)
                        if key not in self._lane_masks:
                            self._lane_masks[key] = (mm[row], mm_ref[row])
                    if sh0 >= 0:
                        bkey = (rid, int(left), plusp)
                        if bkey not in self._lane_trims:
                            self._lane_trims[bkey] = (
                                int(t5s[bpos]), int(t3s[bpos]))
                        bpos += 1
                off += n

    def _lane_mask(self, rec: Record, left: int, plusp: bool):
        """(mm_sel, mm_ref) with lane-cache consult."""
        v = self._lane_masks.get((id(rec), int(left), bool(plusp)))
        if v is not None:
            return v
        q = rec.seq.upper() if plusp else dna.revcomp_str(rec.seq.upper())
        conv = self._conv_plus if plusp else self._conv_minus
        return self._mismatch_masks(q, left, conv)

    def _prime_rows(self, triples) -> None:
        """Prime the lane-mask cache for result rows.

        triples: iterable of (rec, tree, tree_row) — the candidate
        diagonals (cand_*) and ranked-hit diagonals of each row are
        collected and the whole set is mask-computed in one batch."""
        jobs = []          # full shift range (end-indel lane)
        jobs_zero = []     # shift 0 only (trims + hit/terminal masks)
        for rec, tree, si in triples:
            cl = np.asarray(tree["cand_left"][si]).astype(np.int64)
            cp = np.asarray(tree["cand_plusp"][si]).astype(bool)
            cn = np.asarray(tree["cand_nmm"][si])
            keep = cn < 10**6
            flagged = "lane_ind" in tree and "lane_term" in tree
            if flagged:
                # device per-candidate verdicts: the lanes only touch
                # flagged slots, so only those need primed masks
                ind = np.asarray(tree["lane_ind"][si], bool) & keep
                term = np.asarray(tree["lane_term"][si], bool) & keep
                if ind.any():
                    jobs.append((rec, list(cl[ind]), list(cp[ind])))
                zsel = term & ~ind
            else:
                zsel = np.zeros(len(cl), bool)
                jobs.append((rec, list(cl[keep]), list(cp[keep])))
            lefts = list(cl[zsel])
            plusps = list(cp[zsel])
            n = min(int(tree["npaths"][si]), 8)
            if n > 0:
                lefts += list(np.asarray(
                    tree["left"][si][:n]).astype(np.int64))
                plusps += list(np.asarray(
                    tree["plusp"][si][:n]).astype(bool))
            if lefts:
                jobs_zero.append((rec, lefts, plusps))
        if jobs:
            self._prime_lane_masks(jobs)
        if jobs_zero:
            self._prime_lane_masks(jobs_zero, shifts=(0,))

    def _hit_details(self, rec: Record, kind: int, left: int, right: int,
                     split: int, nind: int, sense: bool, plusp: bool,
                     mid: int = 0, split2: int = 0) -> PostHit:
        """Printable details of a SUB / INS / DEL / SPLICE / SHORTEXON
        hit."""
        L = len(rec.seq)
        q = rec.seq.upper() if plusp else dna.revcomp_str(rec.seq.upper())
        conv = self._conv_plus if plusp else self._conv_minus
        # aligned parts in printed-SEQ order: (qstart, qend, genome start)
        if kind == KIND_SUB:
            parts = [(0, L, left)]
        elif kind == KIND_SHORTEXON:
            # two introns around a short middle exon (Stage3end_new_
            # shortexon, stage3hr.c:2577): query [0,split) on the left
            # diagonal, [split,split2) on the middle, [split2,L) right
            parts = [(0, split, left), (split, split2, mid + split),
                     (split2, L, right + split2)]
        elif kind in (KIND_DEL, KIND_SPLICE):
            parts = [(0, split, left), (split, L, right + split)]
        else:  # insertion: nind query bases at [split, split+nind) unaligned
            parts = [(0, split, left), (split + nind, L, right + split + nind)]

        masks, masks_ref, refs = [], [], []
        for qs, qe, g0 in parts:
            if qs == 0 and qe == L:
                mm_sel, mm_ref = self._lane_mask(rec, g0, plusp)
            else:
                mm_sel, mm_ref = self._mismatch_masks(q[qs:qe], g0, conv)
            masks.append(mm_sel)
            masks_ref.append(mm_ref)
            refs.append(self._genome_str[g0 : g0 + (qe - qs)])

        # end trimming: outer ends only (substring.c trim_left_p /
        # trim_right_p are false at indel/splice inner ends)
        if kind == KIND_SUB:
            cached = self._lane_trims.get((id(rec), left, plusp))
            if cached is not None:
                trim5, trim3 = cached
            else:
                trim5, trim3 = trim_ends(masks[0],
                                         self.params.trim_mismatch_score)
        else:
            trim5 = trim_ends(masks[0], self.params.trim_mismatch_score)[0]
            trim3 = trim_ends(masks[-1], self.params.trim_mismatch_score)[1]
            trim5 = min(trim5, len(masks[0]) - 1)
            trim3 = min(trim3, len(masks[-1]) - 1)

        # spans after trimming, per part
        spans = []
        for i, mask in enumerate(masks):
            lo = trim5 if i == 0 else 0
            hi = len(mask) - (trim3 if i == len(masks) - 1 else 0)
            spans.append(slice(lo, hi))

        md_parts = [
            (masks_ref[i][spans[i]], refs[i][spans[i]]) for i in range(len(parts))
        ]
        if kind == KIND_DEL:
            delseq = self._genome_str[left + split : right + split]
            md, nm = sam.md_gapped(md_parts, [delseq])
            nm += nind
        elif kind == KIND_SUB:
            md, nm = sam.md_gapped(md_parts, [])
        elif kind == KIND_SHORTEXON:
            md, nm = sam.md_gapped(md_parts, [None, None])
        else:
            md, nm = sam.md_gapped(md_parts, [None])
            if kind == KIND_INS:
                nm += nind

        qv = self._quality_values(rec, plusp)
        loglik = 0.0
        nmatches = 0
        mmpos_all = []
        nmm_whole = 0
        aligned_len = 0
        for (qs, qe, _), mask, span in zip(parts, masks, spans):
            sel = mask[span]
            qpos = np.arange(qs + span.start, qs + span.stop)
            loglik += float(MISMATCH_LOGPROB[qv[qpos[sel]]].sum())
            nmatches += len(sel) - int(sel.sum())
            mmpos_all.extend((qs + p) for p in np.flatnonzero(mask))
            nmm_whole += int(mask.sum())
            aligned_len += len(mask)

        # CIGAR core (no clips) + genome consumption
        a = len(masks[0]) - trim5
        if kind == KIND_SUB:
            cigar_core = f"{a - trim3}M"
            ref_consumed = a - trim3
        else:
            b = len(masks[-1]) - trim3
            if kind == KIND_DEL:
                cigar_core = f"{a}M{nind}D{b}M"
                ref_consumed = a + nind + b
            elif kind == KIND_SPLICE:
                gap = right - left
                cigar_core = f"{a}M{gap}N{b}M"
                ref_consumed = a + gap + b
                xs = "+" if sense else "-"
                return PostHit(left, plusp, trim5, trim3, nm, nmatches,
                               loglik, md, cigar_core, ref_consumed, xs, gap,
                               0, tuple(parts), tuple(mmpos_all),
                               aligned_len - nmm_whole)
            elif kind == KIND_SHORTEXON:
                gap1 = mid - left
                gap2 = right - mid
                mexon = split2 - split
                cigar_core = f"{a}M{gap1}N{mexon}M{gap2}N{b}M"
                ref_consumed = a + gap1 + mexon + gap2 + b
                xs = "+" if sense else "-"
                return PostHit(left, plusp, trim5, trim3, nm, nmatches,
                               loglik, md, cigar_core, ref_consumed, xs,
                               gap1 + gap2, 0, tuple(parts),
                               tuple(mmpos_all), aligned_len - nmm_whole)
            else:
                cigar_core = f"{a}M{nind}I{b}M"
                ref_consumed = a + b
        ndel = nind if kind == KIND_DEL else 0
        return PostHit(left, plusp, trim5, trim3, nm, nmatches, loglik, md,
                       cigar_core, ref_consumed, None, 0, ndel, tuple(parts),
                       tuple(mmpos_all), aligned_len - nmm_whole)

    @staticmethod
    def _quality_values(rec: Record, plusp: bool) -> np.ndarray:
        """Per-position quality scores in aligned orientation."""
        L = len(rec.seq)
        qual = rec.quality if rec.quality else None
        if qual is None:
            return np.full(L, MAX_QUALITY_SCORE, int)
        qq = qual if plusp else qual[::-1]
        return np.clip(np.frombuffer(qq.encode(), np.uint8).astype(int)
                       - QUALITY_ADJ, 0, MAX_QUALITY_SCORE)

    def _terminal_hit(self, rec: Record, left: int, plusp: bool,
                      t5: int, t3: int) -> PostHit:
        """Terminal (one-sided) hit details: forced trims, sub-style."""
        L = len(rec.seq)
        mm_sel, mm_ref = self._lane_mask(rec, left, plusp)
        span = slice(t5, L - t3)
        md, nm = sam.md_gapped([(mm_ref[span], self._genome_str[left + t5 : left + L - t3])], [])
        qv = self._quality_values(rec, plusp)
        sel = mm_sel[span]
        qpos = np.arange(t5, L - t3)
        loglik = float(MISMATCH_LOGPROB[qv[qpos[sel]]].sum())
        nmatches = (L - t5 - t3) - int(sel.sum())
        # endtypes from spanning-seed querypos (stage1hr.c:9078): END
        # only if a clean seed lies within index1interval of the end
        kk, iv = self.db.k, self.db.interval
        lastpos = L - kk
        seedpos = list(range(0, max(lastpos, 0) + 1, iv))
        if lastpos > 0 and lastpos not in seedpos:
            seedpos.append(lastpos)
        present = [p for p in seedpos
                   if not mm_sel[p : p + kk].any()]
        if present:
            term_ends = (present[0] >= iv, present[-1] < lastpos - iv)
        else:
            term_ends = (True, True)
        return PostHit(left, plusp, t5, t3, nm, nmatches, loglik, md,
                       f"{L - t5 - t3}M", L - t5 - t3, None, 0, 0,
                       ((0, L, left),), tuple(np.flatnonzero(mm_sel)),
                       nmatches, term_ends=term_ends)

    def _end_indel_hits(self, rec: Record, hits, row: int, done: int):
        """Stage 6 end indels (find_end_indels, stage1hr.c:6001):
        indels near the read ends on candidate diagonals, solved with
        the exact compute_end_indels_left/right merges."""
        L = len(rec.seq)
        max_mm = done - self.params.indel_penalty_end
        if max_mm < 0:
            return []
        k, iv = self.db.k, self.db.interval
        firstbound = iv + (iv - 1) + k          # find_12mer_bounds
        lastbound = (L - k) - iv - 1
        out = []
        seen = set()
        cl = hits["cand_left"][row]
        cp = hits["cand_plusp"][row]
        cn = hits["cand_nmm"][row]
        if "lane_ind" in hits:
            # device per-candidate verdicts: only flagged slots can
            # pass the entry tests below (superset)
            fl = np.flatnonzero(np.asarray(hits["lane_ind"][row]))
            cl, cp, cn = cl[fl], cp[fl], cn[fl]
        for left, plusp, nmm_full in zip(cl, cp, cn):
            left = int(left)
            plusp = bool(plusp)
            if int(nmm_full) >= 10**6 or (left, plusp) in seen:
                continue
            seen.add((left, plusp))

            def mask(lft):
                return self._lane_mask(rec, lft, plusp)[0]

            asc = list(np.flatnonzero(mask(left)))
            if not asc:
                continue
            desc = asc[::-1]

            # LOW end (solve_end_indel_low): need a mismatch at or
            # below firstbound
            long_desc = desc[: max_mm + 1]
            i = 0
            while i < len(long_desc) and long_desc[i] > firstbound:
                i += 1
            if i < len(long_desc):
                breakpoint = long_desc[i] + 1
                r = rescue.compute_end_indels_left(
                    long_desc,
                    lambda d: list(np.flatnonzero(mask(left + d))),
                    breakpoint, L, max_mm - i + 1,
                    min_end=self.params.min_indel_end_matches,
                    max_end_ins=self.params.max_end_insertions,
                    max_end_del=self.params.max_end_deletions)
                if r is not None:
                    pos, indels, nmm_lc, nmm_sh = r
                    score = nmm_lc + nmm_sh + self.params.indel_penalty_end
                    if indels > 0:
                        d = self._hit_details(
                            rec, KIND_INS, left + indels, left, pos,
                            indels, False, plusp)
                        h = rescue.HostHit(d, "ins", d.nmatches_whole,
                                           np.array(d.mmpos, int), d.loglik)
                    else:
                        d = self._hit_details(
                            rec, KIND_DEL, left + indels, left, pos,
                            -indels, False, plusp)
                        h = rescue.HostHit(d, "del", d.nmatches_whole,
                                           np.array(d.mmpos, int), d.loglik)
                    out.append((h, score, (left, plusp)))

            # HIGH end (solve_end_indel_high): need a mismatch at or
            # above lastbound
            long_asc = asc[: max_mm + 1]
            i = 0
            while i < len(long_asc) and long_asc[i] < lastbound:
                i += 1
            if i < len(long_asc):
                breakpoint = long_asc[i] - 1
                r = rescue.compute_end_indels_right(
                    long_asc,
                    lambda d: list(np.flatnonzero(mask(left - d))[::-1]),
                    breakpoint, L, max_mm - i + 1,
                    min_end=self.params.min_indel_end_matches,
                    max_end_ins=self.params.max_end_insertions,
                    max_end_del=self.params.max_end_deletions)
                if r is not None:
                    pos, indels, nmm_lc, nmm_sh = r
                    score = nmm_lc + nmm_sh + self.params.indel_penalty_end
                    if indels > 0:
                        d = self._hit_details(
                            rec, KIND_INS, left, left - indels, pos,
                            indels, False, plusp)
                        h = rescue.HostHit(d, "ins", d.nmatches_whole,
                                           np.array(d.mmpos, int), d.loglik)
                    else:
                        d = self._hit_details(
                            rec, KIND_DEL, left, left - indels, pos,
                            -indels, False, plusp)
                        h = rescue.HostHit(d, "del", d.nmatches_whole,
                                           np.array(d.mmpos, int), d.loglik)
                    out.append((h, score, (left, plusp)))
        return out

    def _shortend_hits(self, rec: Record, hits, row: int, done: int):
        """Stage 8 short-end known-site splicing (find_spliceends_
        shortend stage1hr.c:8330 + find_splicepairs_shortend :10045):
        a known splice site inside a candidate diagonal lets the read
        splice even when the far side is too short to seed (down to
        1 bp).  Partner sites of the opposite class within
        shortsplicedist stand in for the reference's splicetrie: the
        short end is matched after each partner; a unique best partner
        with endlength >= min_shortend(2) gives a clean spliced hit,
        otherwise an ambiguous one (long side only, soft-clipped but
        XS-tagged, nmatches credited with amb_nmatches)."""
        sites = self._known_sites
        if sites is None:
            return []
        L = len(rec.seq)
        max_mm = done  # localsplicing_penalty = 0 (gsnap.c:196)
        if max_mm < 0:
            return []
        G = len(self._genome_bytes)
        cl = np.asarray(hits["cand_left"][row]).astype(np.int64)
        cp = np.asarray(hits["cand_plusp"][row])
        valid = cl < np.iinfo(np.uint32).max
        seen_diag = set()
        out = []
        seen_hit = set()
        # (boundary class, partner class, long side, sense) configs:
        # long-left pairs donor->acceptor / antiacceptor->antidonor to
        # the right; long-right pairs acceptor<-donor / antidonor<-
        # antiacceptor to the left (plus-text sense; both read strands
        # use the same plus-genome class arrays, like the device scan)
        configs = [
            (sites.donors, sites.acceptors, "L", True),
            (sites.antiacceptors, sites.antidonors, "L", False),
            (sites.acceptors, sites.donors, "R", True),
            (sites.antidonors, sites.antiacceptors, "R", False),
        ]
        # End 8 (antiacceptors_minus, stage1hr.c:10553) walks an
        # acceptor site's donor trie with minus-query coordinates that
        # never match, so (minus read, acceptor boundary, long-right)
        # yields no splice in the reference — verified empirically
        # (short-left minus reads over a sense intron stay soft-clipped)
        minus_skip = {(id(sites.acceptors), "R", True)}
        for ci in range(len(cl)):
            if not valid[ci]:
                continue
            left, plusp = int(cl[ci]), bool(cp[ci])
            if (left, plusp) in seen_diag:
                continue
            seen_diag.add((left, plusp))
            if left < 0 or left + L > G:
                continue
            q = (rec.seq.upper() if plusp
                 else dna.revcomp_str(rec.seq.upper()))
            conv = self._conv_plus if plusp else self._conv_minus
            mm_sel, _ = self._mismatch_masks(q, left, conv)
            pref = np.concatenate([[0], np.cumsum(mm_sel)])
            for bnd, partners, side, sense in configs:
                if not len(bnd) or not len(partners):
                    continue
                if not plusp and (id(bnd), side, sense) in minus_skip:
                    continue
                # per-site observed intron distances (splicedists):
                # partners within the boundary site's observed distance
                # pay no penalty; partners beyond it (but within
                # shortsplicedist) pay OBSMAX_PENALTY=1 — the
                # obs/max trie pair of Splicetrie_find_left/right
                # (splicetrie.c:1910,2002-2050)
                bnd_dists = (sites.dists_for(bnd)
                             if sites.distances_observed else None)
                ssd = self.params.shortsplicedist
                j0 = int(np.searchsorted(bnd, left + 1))
                j1 = int(np.searchsorted(bnd, left + L))
                for jsite in range(j0, j1):
                    c = int(bnd[jsite])
                    sp = c - left
                    if side == "L":
                        endlength, support = L - sp, sp
                        nmm_long = int(pref[sp])
                    else:
                        endlength, support = sp, L - sp
                        nmm_long = int(pref[L] - pref[sp])
                    if endlength > support or nmm_long > max_mm:
                        continue
                    if (not self.amb_clip
                            and endlength < self.params.min_shortend):
                        # --ambig-splice-noclip: Splicetrie_find_left/
                        # right return NULL for ends below min_shortend
                        # (splicetrie.c:1945,2142)
                        continue
                    allowed = max_mm - nmm_long
                    if side == "L":
                        p0 = int(np.searchsorted(partners, c + 1))
                        p1 = int(np.searchsorted(
                            partners, c + ssd, "right"))
                        cand = partners[p0:p1]
                    else:
                        p0 = int(np.searchsorted(partners, c - ssd))
                        p1 = int(np.searchsorted(partners, c))
                        cand = partners[p0:p1]
                    obs_win = None
                    if bnd_dists is not None:
                        D = int(bnd_dists[jsite])
                        # splicetrie_build.c:506-510 cap/extra
                        obs_win = ssd if D > ssd else D + 10
                        # obsmax penalty applies only when the site HAS
                        # obs-window partners (trieoffsets_obs[i] set)
                        if side == "L":
                            has_obs = bool(np.any(
                                (cand > c) & (cand < c + obs_win)))
                        else:
                            has_obs = bool(np.any(cand > c - obs_win))
                    else:
                        has_obs = False
                    if sites.introns_only and not has_obs:
                        # introns-format maps build no max trie
                        # (gsnap.c:2214): sites without obs-window
                        # partners have none at all
                        continue
                    best_obs_mm, obs_list = None, []
                    best_max_mm, max_list = None, []
                    for a in cand:
                        a = int(a)
                        left2 = a - sp
                        if left2 < 0 or left2 + L > G:
                            continue
                        mm2, _ = self._mismatch_masks(q, left2, conv)
                        nmm_s = int(mm2[sp:].sum() if side == "L"
                                    else mm2[:sp].sum())
                        if nmm_s > allowed:
                            continue
                        in_obs = (not has_obs) or (
                            (a - c < obs_win) if side == "L"
                            else (c - a < obs_win))
                        if sites.introns_only and not in_obs:
                            continue
                        if in_obs:
                            if best_obs_mm is None or nmm_s < best_obs_mm:
                                best_obs_mm, obs_list = nmm_s, [a]
                            elif nmm_s == best_obs_mm:
                                obs_list.append(a)
                        else:
                            if best_max_mm is None or nmm_s < best_max_mm:
                                best_max_mm, max_list = nmm_s, [a]
                            elif nmm_s == best_max_mm:
                                max_list.append(a)
                    # obs partners win unless a beyond-obs partner beats
                    # them by MORE than OBSMAX_PENALTY=1 (the two-trie
                    # search of Splicetrie_find_left, splicetrie.c:2002-
                    # 2050: max-trie bound = best_obs - penalty, winner
                    # only when best_max + penalty < best_obs)
                    obs_nm = (best_obs_mm if best_obs_mm is not None
                              else allowed)
                    if (best_max_mm is not None
                            and best_max_mm + 1 < obs_nm):
                        best_mm, best = best_max_mm, max_list
                    elif best_obs_mm is not None:
                        best_mm, best = best_obs_mm, obs_list
                    else:
                        best_mm, best = None, []
                    if best_mm is None:
                        continue
                    if (endlength >= self.params.min_shortend
                            and len(best) == 1):
                        a = best[0]
                        if side == "L":
                            l1, rdiag = left, a - sp
                        else:
                            l1, rdiag = a - sp, left
                        if rdiag <= l1:
                            continue
                        key = (l1, rdiag, sp, plusp)
                        if key in seen_hit:
                            continue
                        seen_hit.add(key)
                        d = self._hit_details(
                            rec, KIND_SPLICE, l1, rdiag, sp, 0, sense,
                            plusp)
                        out.append((rescue.HostHit(
                            d, "splice", d.nmatches_whole,
                            np.array(d.mmpos, int), d.loglik),
                            nmm_long + best_mm))
                    elif not self.amb_clip:
                        # --ambig-splice-noclip: multiple tied partner
                        # sites are dropped outright instead of
                        # soft-clipped (splicetrie.c:2099,2296) — the
                        # plain substring alignment extends into the
                        # intron
                        continue
                    else:
                        # ambiguous: long side only, junction side
                        # soft-clipped, amb_nmatches credited
                        amb = endlength - best_mm
                        if side == "L":
                            t5, _ = trim_ends(mm_sel[:sp], self.params.trim_mismatch_score)
                            t3 = endlength
                        else:
                            t5 = endlength
                            _, t3 = trim_ends(mm_sel[sp:], self.params.trim_mismatch_score)
                        key = (left, sp, side, plusp, "amb")
                        if key in seen_hit:
                            continue
                        seen_hit.add(key)
                        d = self._terminal_hit(rec, left, plusp, t5, t3)
                        # amb_nmatches counts toward nmatches (Stage3end
                        # _new_splice, stage3hr.c: ambiguous end credit)
                        # so the splice outranks the equivalent sub/
                        # terminal in hit_goodness_cmp.  The tied
                        # partner sites ride along for inside-pair
                        # resolution (resolve_inside_ambiguous_splice,
                        # stage3hr.c:6329/6811).
                        d = dataclasses.replace(
                            d, xs="+" if sense else "-",
                            nmatches=d.nmatches + amb,
                            nmatches_whole=d.nmatches_whole + amb,
                            term_ends=None,
                            ambi={"side": side, "sp": sp, "sense": sense,
                                  "sites": [int(a) for a in best],
                                  "nmm": best_mm, "long_left": left})
                        out.append((rescue.HostHit(
                            d, "splice", d.nmatches + amb,
                            np.array(d.mmpos, int), d.loglik),
                            nmm_long + best_mm))
        return out

    def _resolve_inside_ambi(self, rec5, rec3_inv, h5, h3):
        """resolve_inside_ambiguous_splice_plus/minus (stage3hr.c:6329,
        6811): an ambiguous shortend splice whose junction faces INSIDE
        a candidate pair resolves to the unique partner site bounded by
        the mate's span; unresolved (0 or >1 bounded) keeps the
        soft-clipped ambiguous form."""
        a5 = h5.d.ambi
        a3 = h3.d.ambi
        if a5 is None and a3 is None:
            return h5, h3
        if h5.d.plusp != h3.d.plusp:
            return h5, h3
        plusp = h5.d.plusp
        L5, L3 = len(rec5.seq), len(rec3_inv.seq)
        in5 = a5 is not None and a5["side"] == ("L" if plusp else "R")
        in3 = a3 is not None and a3["side"] == ("R" if plusp else "L")
        if not (in5 or in3):
            return h5, h3
        span5 = h5.d.trim5 + h5.d.ref_consumed + h5.d.trim3
        span3 = h3.d.trim5 + h3.d.ref_consumed + h3.d.trim3
        gs3 = h3.d.left if plusp else h3.d.left + span3
        ge5 = h5.d.left + span5 if plusp else h5.d.left
        pick5 = pick3 = None
        if in5 and in3:
            combos = [(s5, s3) for s5 in a5["sites"] for s3 in a3["sites"]
                      if (s5 < s3 if plusp else s3 < s5)]
            if len(combos) == 1:
                pick5, pick3 = combos[0]
        elif in5:
            b = [s for s in a5["sites"]
                 if (s < gs3 + L3 if plusp else gs3 < s + L3)]
            if len(b) == 1:
                pick5 = b[0]
        else:
            b = [s for s in a3["sites"]
                 if (ge5 < s + L5 if plusp else s < ge5 + L5)]
            if len(b) == 1:
                pick3 = b[0]

        def build(rec, a, site, plusp):
            sp = a["sp"]
            if a["side"] == "L":
                l1, rdiag = a["long_left"], site - sp
            else:
                l1, rdiag = site - sp, a["long_left"]
            if rdiag <= l1:
                return None
            d = self._hit_details(rec, KIND_SPLICE, l1, rdiag, sp, 0,
                                  a["sense"], plusp)
            return rescue.HostHit(d, "splice", d.nmatches_whole,
                                  np.array(d.mmpos, int), d.loglik)

        if pick5 is not None:
            r = build(rec5, a5, pick5, plusp)
            if r is not None:
                h5 = r
                self.ambi_resolved += 1
        if pick3 is not None:
            r = build(rec3_inv, a3, pick3, plusp)
            if r is not None:
                h3 = r
                self.ambi_resolved += 1
        return h5, h3

    def _distant_hits(self, rec: Record, hits, row: int, done: int):
        """Step 9 distant/translocation splicing (stage1hr.c:12218):
        runs only when the cascade found nothing and splicing is on."""
        L = len(rec.seq)
        diags = []
        seen = set()
        for left, plusp, nmm in zip(hits["cand_left"][row],
                                    hits["cand_plusp"][row],
                                    hits["cand_nmm"][row]):
            if int(nmm) >= 10**6:
                continue
            key = (int(left), bool(plusp))
            if key not in seen:
                seen.add(key)
                diags.append(key)

        mm_sel = self._cand_mm_fn(rec, hits, row, L)

        max_mm = done - self.params.distantsplicing_penalty
        ends = distant_mod.find_spliceends(
            diags, mm_sel, L, self._genome_str,
            self.db.codes, max_mm, self.db.k)
        pairs = distant_mod.find_pairs(
            ends, L, max_mm, self.params.shortsplicedist,
            chrnum_of=lambda left: int(np.searchsorted(
                self.db.chr_ends, left, side="right")),
            distant_penalty=self.params.distantsplicing_penalty,
            local_penalty=self.params.localsplicing_penalty,
            min_end_matches=self.params.min_distant_end_matches)

        qual = rec.quality if rec.quality else None
        g = self._genome_str
        out = []

        def dn_text(kind, site):
            # splice dinucleotide in SENSE display form per scan kind
            if kind == "donor":
                return g[site : site + 2]
            if kind == "acceptor":
                return g[site - 2 : site]
            if kind == "antidonor":
                return dna.revcomp_str(g[site - 2 : site])
            return dna.revcomp_str(g[site : site + 2])  # antiacceptor

        def mm_fn(left, plusp):
            q = (rec.seq.upper() if plusp
                 else dna.revcomp_str(rec.seq.upper()))
            conv = self._conv_plus if plusp else self._conv_minus
            return self._mismatch_masks(q, left, conv)

        for p in pairs:
            el, er = p.left_end, p.right_end
            s = p.split
            dsite, asite = p.donor.site, p.acceptor.site
            dinucl = f"{dn_text(p.donor_kind, dsite)}-" \
                     f"{dn_text(p.acceptor_kind, asite)}".upper()

            if p.inversion:
                # mixed strands; p.split and both pieces in READ coords
                def half(e, a, b):
                    sel, ref = mm_fn(e.left, e.plusp)
                    if e.plusp:
                        sl = slice(a, b)
                        span = (e.left + a, e.left + b)
                        rp = np.flatnonzero(sel[sl]) + a
                    else:
                        sl = slice(L - b, L - a)
                        span = (e.left + L - b, e.left + L - a)
                        rp = (L - 1) - (np.flatnonzero(sel[sl]) + (L - b))
                    md, nm = sam.md_gapped(
                        [(ref[sl], g[span[0] : span[1]])], [])
                    return span, np.sort(rp), md, nm

                spanL, mmL, md1, nm1 = half(el, 0, s)
                spanR, mmR, md2, nm2 = half(er, s, L)
                mmpos = np.concatenate([mmL, mmR]).astype(int)
                if qual is None:
                    qv = np.full(L, MAX_QUALITY_SCORE, int)
                else:
                    qv = np.clip(
                        np.frombuffer(qual.encode(), np.uint8).astype(int)
                        - QUALITY_ADJ, 0, MAX_QUALITY_SCORE)
                loglik = (float(MISMATCH_LOGPROB[qv[mmpos]].sum())
                          if len(mmpos) else 0.0)
                xs1 = "+" if p.sensep == el.plusp else "-"
                xs2 = "+" if p.sensep == er.plusp else "-"
                info = dict(sense=p.sensep, type=p.splice_type,
                            dist=p.distance, dsite=dsite, asite=asite,
                            dprob=p.donor.prob, aprob=p.acceptor.prob,
                            penalty=p.penalty, shortp=False, dinucl=dinucl,
                            md1=md1, nm1=nm1, md2=md2, nm2=nm2,
                            md_merged=md1, nm_merged=nm1 + nm2,
                            plusps=(el.plusp, er.plusp), xs1=xs1, xs2=xs2,
                            donor_left=p.donor_left)
                total = p.nmm_total
                d = PostHit(spanL[0], el.plusp, 0, 0, total, L - total,
                            loglik, md1, "", s, xs1, p.distance, 0,
                            ((0, s, spanL[0]), (s, L, spanR[0])),
                            tuple(int(x) for x in mmpos), L - total,
                            distant=info)
                out.append(rescue.HostHit(d, "distant", L - total, mmpos,
                                          loglik))
                continue

            selL, refL = mm_fn(el.left, p.plusp)
            selR, refR = mm_fn(er.left, p.plusp)
            posL = np.flatnonzero(selL)
            posR = np.flatnonzero(selR)
            mmpos = np.concatenate([posL[posL < s], posR[posR >= s]])
            if qual is None:
                qv = np.full(L, MAX_QUALITY_SCORE, int)
            else:
                qq = qual if p.plusp else qual[::-1]
                qv = np.clip(np.frombuffer(qq.encode(), np.uint8).astype(int)
                             - QUALITY_ADJ, 0, MAX_QUALITY_SCORE)
            loglik = float(MISMATCH_LOGPROB[qv[mmpos]].sum()) if len(mmpos) else 0.0
            parts_md = [(refL[:s], g[el.left : el.left + s]),
                        (refR[s:], g[er.left + s : er.left + L])]
            md1, nm1 = sam.md_gapped(parts_md[:1], [])
            md2, nm2 = sam.md_gapped(parts_md[1:], [])
            mdm, nmm_md = sam.md_gapped(parts_md, [None])
            xs = "+" if p.sensep == p.plusp else "-"
            info = dict(sense=p.sensep, type=p.splice_type, dist=p.distance,
                        dsite=dsite, asite=asite, dprob=p.donor.prob,
                        aprob=p.acceptor.prob, penalty=p.penalty,
                        shortp=p.shortdistancep, dinucl=dinucl,
                        md1=md1, nm1=nm1, md2=md2, nm2=nm2,
                        md_merged=mdm, nm_merged=nmm_md)
            total = p.nmm_total
            mergeable = (p.splice_type == "consistent"
                         and self.merge_samechr)
            if p.shortdistancep or mergeable:
                # consistent pair within shortsplicedist — or any
                # same-chromosome consistent pair under
                # --merge-distant-samechr (SAMECHR_SPLICE printed as one
                # record, samprint.c:2777) — an ordinary SPLICE hit
                # (one N-cigar record)
                gap = p.distance
                cigar = f"{s}M{gap}N{L - s}M"
                ref_cons = L + gap
            else:
                cigar = ""
                ref_cons = s
            d = PostHit(el.left, p.plusp, 0, 0, total, L - total, loglik,
                        mdm, cigar, ref_cons, xs, p.distance, 0,
                        ((0, s, el.left), (s, L, er.left + s)),
                        tuple(int(x) for x in mmpos), L - total,
                        distant=info)
            out.append(rescue.HostHit(d, "distant", L - total, mmpos, loglik))
        return out

    def _cand_mm_fn(self, rec: Record, hits, row: int, L: int):
        """Selection-mismatch-mask lookup for candidate diagonals: serves
        the matrices the device verify stage already computed (cand_mm,
        bitpacked); other diagonals fall back to the host mask."""
        cache = {}
        cand_mm = hits.get("cand_mm")
        if cand_mm is not None:
            cl = hits["cand_left"][row]
            cp = hits["cand_plusp"][row]
            # bitpacked uint8[K, ceil(L/8)] (gsnap_gapped._bitpack_mask)
            bits = np.unpackbits(
                np.asarray(cand_mm[row], np.uint8), axis=-1,
                bitorder="little")[:, :L].astype(bool)
            for i in range(len(cl)):
                cache.setdefault((int(cl[i]), bool(cp[i])), bits[i])

        def mm_fn(left, plusp):
            v = cache.get((left, plusp))
            if v is not None:
                return v
            return self._lane_mask(rec, left, plusp)[0]

        return mm_fn

    def _gmap_hosthit(self, rec: Record):
        """GMAP rescue: align the read with the GMAP stack; returns a
        HostHit or None (align_single_hit_with_gmap, stage1hr.c:11009).

        Results are cached by sequence; when ``self._gmap_collect`` is a
        list (batch prefetch pass 1), the request is recorded and None
        returned — the caller re-runs after prefetch_gmap() fills the
        cache with ONE batched device call for the whole chunk."""
        from . import gmap as gmap_mod

        key = rec.seq
        if key in self._gmap_cache:
            return self._gmap_cache[key]
        if self._gmap_collect is not None:
            self._gmap_collect.append(rec)
            self._gmap_rows.add(self._gmap_row)
            return None
        max_il = self.params.shortsplicedist if self.splicing_on else 30
        path = gmap_mod.align_cdna(self.db, rec.seq, max_intronlen=max_il,
                                   extend_ends=True, device=self.device)
        hit = self._gmap_path_to_hit(rec, path)
        self._gmap_cache[key] = hit
        return hit

    def prefetch_gmap(self, recs: list[Record]) -> None:
        """Batch-resolve GMAP rescue for many reads in one device pass
        (its host wall time adds up in ``gmap_seconds``)."""
        from . import gmap as gmap_mod

        t0 = _time.time()
        todo = []
        seen = set()
        for r in recs:
            if r.seq not in self._gmap_cache and r.seq not in seen:
                seen.add(r.seq)
                todo.append(r)
        if todo:
            max_il = self.params.shortsplicedist if self.splicing_on else 30
            paths = gmap_mod.align_cdna_batch(
                self.db, [r.seq for r in todo], max_intronlen=max_il,
                extend_ends=True, device=self.device)
            for r, path in zip(todo, paths):
                self._gmap_cache[r.seq] = self._gmap_path_to_hit(r, path)
        self.gmap_seconds += _time.time() - t0

    def _gmap_path_to_hit(self, rec: Record, path):
        """Convert a GMAP Path into a rescue HostHit, applying the
        reference acceptance gates (end chop, stage2 coverage, bad
        stretch); vectorized over exon match masks."""
        from ..io import gmap_out
        from . import gmap as gmap_mod

        if path is None or not path.exons:
            return None
        L = len(rec.seq)
        qstr = rec.seq.upper() if path.watsonp else dna.revcomp_str(rec.seq.upper())
        gstr = self._genome_str
        gmap_mod.chop_path_ends(gstr, qstr, path)
        if not path.exons:
            return None
        qb = np.frombuffer(qstr.encode("latin-1"), np.uint8)
        gb = self._genome_bytes

        def exon_eq(e):
            return gmap_mod._match_vec(gb, qb, e.qstart, e.qend,
                                       e.gstart - e.qstart)

        # stage2 oligo-chain viability (Stage2_compute
        # proceed_pctcoverage=0.5, stage1hr.c:11257): exact runs >= the
        # oligoindex size must cover half the read or the rescue fails
        cov = 0
        for e in path.exons:
            eq = exon_eq(e)
            # run lengths of consecutive matches
            d = np.diff(np.concatenate([[0], eq.astype(np.int8), [0]]))
            starts = np.flatnonzero(d == 1)
            ends = np.flatnonzero(d == -1)
            runs = ends - starts
            cov += int(runs[runs >= 8].sum())
        if cov * 2 < L:
            return None
        core, md, nm, has_intron = gmap_out.path_cigar_md(
            path, qstr, gstr, sam_mode="gsnap"
        )
        mmpos = []
        for e in path.exons:
            eq = exon_eq(e)
            qn = qb[e.qstart : e.qend] == ord("N")
            mmpos.extend((np.flatnonzero(~eq & ~qn) + e.qstart).tolist())
        mmpos.sort()

        # Stage3end_bad_stretch_p: reject GMAP hits whose aligned
        # columns contain a Viterbi-detected bad stretch or too many
        # indel breaks (stage3hr.c:882)
        nindelbreaks = 0
        events = []
        prev = None
        for e in path.exons:
            if prev is not None:
                dq = e.qstart - prev.qend
                dg = e.gstart - prev.gend
                if dq > 0 or (0 < dg < 9):
                    nindelbreaks += 1
                    events.append(
                        np.ones(dq + (dg if dg < 9 else 0), bool))
            eq = exon_eq(e)
            qn = qb[e.qstart : e.qend] == ord("N")
            events.append(~eq & ~qn)
            prev = e
        events = np.concatenate(events) if events else np.zeros(0, bool)
        if nindelbreaks > 3 or rescue.bad_stretch_p(events.tolist()):
            return None
        qual = rec.quality if rec.quality else None
        if qual is None:
            qv = np.full(L, MAX_QUALITY_SCORE, int)
        else:
            qq = qual if path.watsonp else qual[::-1]
            qv = np.clip(np.frombuffer(qq.encode(), np.uint8).astype(int)
                         - QUALITY_ADJ, 0, MAX_QUALITY_SCORE)
        loglik = float(MISMATCH_LOGPROB[qv[np.array(mmpos, int)]].sum()) if mmpos else 0.0
        intron = sum(
            (b.gstart - a.gend)
            for a, b in zip(path.exons, path.exons[1:])
            if b.gstart - a.gend >= 9
        )
        ndel = sum(
            (b.gstart - a.gend)
            for a, b in zip(path.exons, path.exons[1:])
            if 0 < b.gstart - a.gend < 9
        )
        xs = None
        if has_intron and path.cdna_direction:
            xs = "+" if path.cdna_direction > 0 else "-"
        t5, t3 = path.qstart, L - path.qend
        covered = sum(e.qend - e.qstart for e in path.exons)
        nmatches = covered - len(mmpos)
        # comparison nmatches = nmatches_posttrim: for GMAP hits the
        # reference's Pair_nmatches_posttrim (pair.c:5250, fed into
        # Stage3end_new_gmap) simply counts MATCH columns of the
        # pairarray inside the ambig-clipped range — NO GSNAP-trim-
        # policy re-trim — which is why an untrimmed full-length GMAP
        # rescue outranks a trimmed sub of the same locus (t18 case)
        post = nmatches
        d = PostHit(path.gstart - path.qstart, path.watsonp, t5, t3, nm,
                    nmatches, loglik, md, core,
                    path.gend - path.gstart, xs, intron, ndel,
                    tuple((e.qstart, e.qend, e.gstart) for e in path.exons),
                    tuple(mmpos), nmatches)
        return rescue.HostHit(d, "gmap", post, np.array(mmpos, int), loglik)

    def _rescued_hits(self, rec: Record, hits, row: int, npaths: int,
                      maxpaths: int):
        """Device hits + end-indel, short-end, distant, terminal and GMAP
        lanes -> final ordered HostHit list (align_end tail,
        stage1hr.c:12400-12530)."""
        L = len(rec.seq)
        kindname = {KIND_SUB: "sub", KIND_INS: "ins", KIND_DEL: "del",
                    KIND_SPLICE: "splice", KIND_SHORTEXON: "shortexon"}
        hhits = []
        n = min(int(npaths), maxpaths)
        for i in range(n):
            d = self._end_hit(rec, hits, row, i)
            hhits.append(rescue.HostHit(
                d, kindname[int(hits["kind"][row, i])], d.nmatches_whole,
                np.array(d.mmpos, int), d.loglik,
            ))

        spansize = -(-self.db.k // self.db.interval) * self.db.interval
        budget = max((L + self.db.interval - 1) // spansize - 2, 0)
        best = int(hits["score"][row, 0]) if n > 0 else 10**6
        done = min(budget, best)

        # device lane-noop gate: the end-indel and terminal lanes (and
        # the GMAP improvement pass that only fires on terminals) are
        # provably empty for this row — skip them
        lane_clear = ("lane_noop" in hits
                      and bool(np.asarray(hits["lane_noop"])[row]))

        # 6. end indels (host lane; the device covers middle indels)
        end_used = set()
        end_found = False
        if done >= self.params.indel_penalty_end and not lane_clear:
            for h, score, anchor in self._end_indel_hits(rec, hits, row, done):
                if score > done:
                    continue
                hhits.append(h)
                end_used.add(anchor)
                end_found = True
                done = min(done, score + self.params.subopt_levels)

        # 8. short-end known-site splicing (stage1hr.c:12134 gating:
        # knownsplicingp && done_level >= localsplicing_penalty)
        if self._known_sites is not None and done >= 0:
            sh = self._shortend_hits(rec, hits, row, done)
            for h, score in sh:
                if score > done:
                    continue
                hhits.append(h)
                done = min(done, score + self.params.subopt_levels)

        # 9. distant splicing: only when the cascade found nothing
        # (stage1hr.c:12207 gating) and distant can beat alternatives
        if (n == 0 and not end_found and self.splicing_on
                and done > self.params.distantsplicing_penalty):
            dh = self._distant_hits(rec, hits, row, done)
            if dh:
                hhits.extend(dh)
                found = min(h.d.nmm_trimmed + h.d.distant["penalty"]
                            for h in dh)
                done = min(done, found)  # opt_level update, gates stage 10+

        gmap_cache = [False, None]

        def gmap_once():
            if not gmap_cache[0]:
                gmap_cache[0] = True
                gmap_cache[1] = self._gmap_hosthit(rec)
            return gmap_cache[1]

        def gmap_beats_sub(g) -> bool:
            """Does the full-length GMAP rescue replace a trimmed SUB of
            the same locus?  Empirical boundary of the reference's
            path_trim end policy (Pair_trim_ends + end-dynprog
            re-extension, stage3.c:9712-9741), fit to a 25-probe sweep
            vs the oracle:

              * GMAP must be STRICTLY better than the sub's posttrim
                matches (ties go to the lower hittype = sub);
              * a genome-LEFT trim is recovered only when it holds
                <= 1 mismatch and NO interior mismatch sits within
                24 bp (maxpeelback_distalmedial) of the kept boundary;
              * a genome-RIGHT trim is recovered only when the NEAREST
                interior mismatch (if any) sits within 24 bp of the
                kept boundary — the left/right asymmetry matches the
                end dynprogs' jump_late split.

            Observed only in STANDARD runs: with a SNP-tolerant index
            or known splice sites loaded the reference keeps the
            trimmed sub even in winning geometries, so those modes stay
            conservative."""
            if self._snpsdb is not None or self._known_sites is not None \
                    or self.params.mode != "standard":
                return False
            for i in range(n):
                if int(hits["kind"][row, i]) != KIND_SUB:
                    continue
                d0 = self._end_hit(rec, hits, row, i)
                if abs(int(g.d.left) - int(d0.left)) > 2 * L:
                    continue
                mmp = np.asarray(d0.mmpos, int)
                t5, t3 = d0.trim5, d0.trim3
                inner = mmp[(mmp >= t5) & (mmp < L - t3)]
                post = (L - t5 - t3) - len(inner)
                if g.nmatches <= post:
                    return False
                if not end_policy_ok(t5, t3, mmp):
                    return False
            return True

        def end_policy_ok(t5, t3, mmp) -> bool:
            """Shared trim-geometry half of gmap_beats_sub, also applied
            to the terminals a GMAP rescue would displace (a terminal
            whose left trim holds 2 mismatches survives)."""
            mmp = np.asarray(mmp, int)
            inner = mmp[(mmp >= t5) & (mmp < L - t3)]
            if t5 > 0:
                if int((mmp < t5).sum()) >= 2:
                    return False
                if len(inner) and int(inner.min()) - t5 < 24:
                    return False
            if t3 > 0:
                if len(inner) and (L - t3) - int(inner.max()) > 24:
                    return False
            return True

        if done >= self.params.terminal_threshold and not lane_clear:
            mm_fn = self._cand_mm_fn(rec, hits, row, L)
            # indel/splice solvers mark their diagonal pairs usedp as
            # they go (stage1hr.c:4318,6566), but SUB diagonals are only
            # marked by find_complete_mm — which is SKIPPED when
            # done_level <= fast_level (stage1hr.c:10789), i.e. for
            # almost every read under default settings.  Such reads' sub
            # diagonals stay unused and feed the terminal lane: a
            # trimmed sub's own locus becomes a terminal, anchors GMAP,
            # and the untrimmed GMAP rescue can replace the trimmed sub.
            used = set(end_used)
            for i in range(n):
                if int(hits["kind"][row, i]) == KIND_SUB:
                    continue
                pp = bool(hits["plusp"][row, i])
                used.add((int(hits["left"][row, i]), pp))
                used.add((int(hits["right"][row, i]), pp))
            trims_of = None
            if self.params.trim_mismatch_score == -3:
                def trims_of(left, plusp):
                    return self._lane_trims.get(
                        (id(rec), int(left), bool(plusp)))
            tcl = np.asarray(hits["cand_left"][row])
            tcp = np.asarray(hits["cand_plusp"][row])
            tcn = np.asarray(hits["cand_nmm"][row])
            if "lane_term" in hits:
                # device per-candidate verdicts (superset at the
                # original done level; acceptance is re-checked below)
                fl = np.flatnonzero(np.asarray(hits["lane_term"][row]))
                tcl, tcp, tcn = tcl[fl], tcp[fl], tcn[fl]
            terms = rescue.make_terminals(
                mm_fn, tcl, tcp, tcn, L, done,
                spansize + self.db.interval - 1, used=used,
                k=self.db.k, interval=self.db.interval, trims_of=trims_of,
            )
            term_hits = []
            for left, plusp, t5, t3, nmm_trim, pos in terms:
                d = self._terminal_hit(rec, left, plusp, t5, t3)
                # HostHit.nmatches is the TRIMMED-region matches: the
                # reference recomputes terminal nmismatches over the
                # trimmed span (Stage3end_new_terminal), and the
                # GMAP-on-terminals acceptance compares against that
                term_hits.append(rescue.HostHit(
                    d, "terminal", d.nmatches, pos, d.loglik))
            hhits.extend(term_hits)
            # early skip: when the acceptance gates below are provably
            # unsatisfiable, don't run the (expensive) GMAP engine at
            # all.  SNP and known-site runs always reject the
            # replacement (gmap_beats_sub); otherwise a geometry-failing
            # SUB blocks it (a different-locus GMAP with more matches
            # would have been a better sub the complete seed set had
            # found), and so does every beatable terminal failing
            # geometry
            gmap_possible = (self._snpsdb is None
                             and self._known_sites is None
                             and self.params.mode == "standard")
            if gmap_possible:
                for h in hhits[:n]:
                    if h.hittype == "sub" and not end_policy_ok(
                            h.d.trim5, h.d.trim3, h.d.mmpos):
                        gmap_possible = False
                        break
            if gmap_possible and term_hits and not any(
                    end_policy_ok(t.d.trim5, t.d.trim3, t.mm_positions)
                    for t in term_hits):
                gmap_possible = False
            if (term_hits and gmap_possible
                    and "terminal" in self.gmap_modes
                    and len(term_hits) <= self.params.max_gmap_terminal):
                g = gmap_once()
                # GMAP is anchored near each terminal: align_single_hit_
                # with_gmap extends a TERM end by shortsplicedist +
                # querylength UNCONDITIONALLY (stage1hr.c:11060-11066);
                # a global alignment outside every anchor window would
                # not have been found
                win = self.params.shortsplicedist + 2 * L
                if (g is not None and any(
                        g.nmatches > t.nmatches
                        and abs(int(g.d.left) - int(t.d.left)) <= win
                        for t in term_hits)
                        and gmap_beats_sub(g)
                        and all(end_policy_ok(t.d.trim5, t.d.trim3,
                                              t.mm_positions)
                                for t in term_hits
                                if g.nmatches > t.nmatches)):
                    hhits.append(g)

        if not hhits:
            return []

        win = self.params.shortsplicedist + 2 * L

        def gmap_for_anchor(anchor):
            if (self._snpsdb is not None or self._known_sites is not None
                    or self.params.mode != "standard"):
                return None  # gmap_beats_sub always rejects: skip call
            g = gmap_once()
            if g is None:
                return None
            if abs(int(g.d.left) - int(anchor.d.left)) > win:
                return None  # outside the anchor's genomic window
            if not gmap_beats_sub(g):
                return None  # reference path_trim would chop it back
            return g

        final = rescue.select_final(
            hhits, L,
            improvement_fn=(gmap_for_anchor
                            if "improvement" in self.gmap_modes else None),
            subopt=self.params.subopt_levels,
        )
        # Stage3end_resolve_multimapping is the identity without genes /
        # tally / runlength maps (not ported)
        return final[:maxpaths]

    def _se_category(self, final) -> str:
        """Resulttype classification (resulthr.h:7-12 SINGLEEND_*)."""
        if not final:
            return "nomapping"
        if final[0].hittype == "distant":
            return "unpaired_transloc"
        return "unpaired_uniq" if len(final) == 1 else "unpaired_mult"

    @staticmethod
    def _end_mapqs(details, qual):
        """MAPQ, XQ and X2 per hit (stage3hr.c:3443-3545)."""
        n = len(details)
        if n == 1:
            if qual is None:
                mapqs = [MAX_QUALITY_SCORE]
            else:
                mapqs = [max(1, min(MAX_QUALITY_SCORE,
                                    max(ord(c) - QUALITY_ADJ for c in qual)))]
            return mapqs, [MAPQ_MAXIMUM_SCORE], 0
        logliks = np.array([d.loglik for d in details])
        # enforce monotonicity in rank order
        for i in range(n - 1, 0, -1):
            if logliks[i - 1] < logliks[i]:
                logliks[i - 1] = logliks[i]
        logliks = logliks - logliks.max()
        absmqs = [int(round(max(0.0, ll + MAPQ_MAXIMUM_SCORE))) for ll in logliks]
        probs = np.exp(logliks)
        probs = probs / probs.sum()
        mapqs = [
            96 if 1.0 - p < 2.5e-10 else int(round(-10.0 * math.log10(1.0 - p)))
            for p in probs
        ]
        return mapqs, absmqs, absmqs[1]

    def sam_records(self, rec: Record, hits, row: int, npaths,
                    maxpaths: int = 100) -> str:
        qual = rec.quality if rec.quality else None
        key = row if self._catkey is None else self._catkey
        if self.quiet_if_excessive and int(npaths) > maxpaths:
            # -Q: excessive multimappers print as nomapping
            self._categories[key] = "nomapping"
            return sam.se_record(rec.label, rec.seq.upper(), qual, None)
        final = self._rescued_hits(rec, hits, row, npaths, maxpaths)
        self._categories[key] = self._se_category(final)
        if not final:
            return sam.se_record(rec.label, rec.seq.upper(), qual, None)
        details = [h.d for h in final]
        n = len(details)
        mapqs, absmqs, second_absmq = self._end_mapqs(details, qual)
        out = []
        for hi, d in enumerate(details):
            if d.distant is not None:
                out.append(self._sam_distant(
                    rec, d, qual, mapqs[hi], absmqs[hi], second_absmq, n, hi))
                continue
            chrnum = int(np.searchsorted(self.db.chr_ends, d.left, side="right"))
            chrpos = d.left - int(self.db.chr_starts[chrnum]) + 1
            pos = chrpos + d.trim5
            cigar = (
                (f"{d.trim5}S" if d.trim5 else "")
                + d.cigar_core
                + (f"{d.trim3}S" if d.trim3 else "")
            )
            hit = sam.SEHit(
                chrname=self.db.chr_names[chrnum],
                chrpos=pos,
                plusp=d.plusp,
                cigar=cigar,
                md=d.md,
                nm=d.nmm_trimmed,
                mapq=mapqs[hi],
                absmq=absmqs[hi],
                second_absmq=second_absmq,
                xs=d.xs,
            )
            out.append(
                sam.se_record(
                    rec.label,
                    rec.seq.upper(),
                    qual,
                    hit,
                    nh=n,
                    hi=hi + 1,
                    secondary=hi > 0,
                )
            )
        return "".join(out)

    def _sam_distant(self, rec: Record, d: PostHit, qual, mapq: int,
                     absmq: int, second_absmq: int, nh: int, hi: int) -> str:
        """Distant-splice SAM: one hard-clipped record per half with the
        XT junction tag (samprint.c splice halves)."""
        L = len(rec.seq)
        (q1, q2, g1), (q3, q4, g2) = d.parts
        info = d.distant
        if info["shortp"] or (self.merge_samechr
                              and info["type"] == "consistent"):
            # consistent within shortsplicedist: single N-cigar record.
            # Merged DISTANT records keep the reference's POS quirk:
            # for non-short distances substring_low is redefined to the
            # substring holding the ORIGINAL query end (stage3hr.c:2378-
            # 2435), so POS comes from the query-LAST part even though
            # the CIGAR starts at the query-first part.
            if info["shortp"]:
                ref_left = d.left
            else:
                ref_left = g2 if d.plusp else g1
            chrnum = int(np.searchsorted(self.db.chr_ends, ref_left,
                                         side="right"))
            pos = ref_left - int(self.db.chr_starts[chrnum]) + 1
            hit = sam.SEHit(
                chrname=self.db.chr_names[chrnum], chrpos=pos,
                plusp=d.plusp, cigar=d.cigar_core, md=info["md_merged"],
                nm=info["nm_merged"], mapq=mapq, absmq=absmq,
                second_absmq=second_absmq, xs=d.xs,
            )
            return sam.se_record(rec.label, rec.seq.upper(), qual, hit,
                                 nh=nh, hi=hi + 1, secondary=hi > 0)
        xt = (f"XT:Z:{info['dinucl']},{info['dprob']:.2f},"
              f"{info['aprob']:.2f}")
        out = []
        if info.get("plusps") is not None:
            # inversion: the two halves align to OPPOSITE strands; each
            # prints genome-forward with its own flag/XS, hard-clipping
            # the other half (samprint.c halfdonor/halfacceptor)
            for (qs, qe, g0), md, nm, hplus, hxs in (
                ((q1, q2, g1), info["md1"], info["nm1"],
                 info["plusps"][0], info["xs1"]),
                ((q3, q4, g2), info["md2"], info["nm2"],
                 info["plusps"][1], info["xs2"]),
            ):
                chrnum = int(np.searchsorted(self.db.chr_ends, g0,
                                             side="right"))
                pos = g0 - int(self.db.chr_starts[chrnum]) + 1
                seg = qe - qs
                if hplus:
                    cigar = (f"{qs}H" if qs else "") + f"{seg}M" + (
                        f"{L - qe}H" if qe < L else "")
                    sseq = rec.seq.upper()[qs:qe]
                    squal = qual[qs:qe] if qual else None
                else:
                    cigar = (f"{L - qe}H" if qe < L else "") + f"{seg}M" + (
                        f"{qs}H" if qs else "")
                    sseq = dna.revcomp_str(rec.seq.upper()[qs:qe])
                    squal = qual[qs:qe][::-1] if qual else None
                hit = sam.SEHit(
                    chrname=self.db.chr_names[chrnum], chrpos=pos,
                    plusp=True, cigar=cigar, md=md, nm=nm, mapq=mapq,
                    absmq=absmq, second_absmq=second_absmq, xs=hxs,
                )
                rec_out = sam.se_record(
                    rec.label, sseq, squal, hit, nh=nh, hi=hi + 1,
                    secondary=hi > 0, extra=[xt])
                if not hplus:
                    # strand flag comes from the half, not the SEHit
                    fields = rec_out.split("\t")
                    fields[1] = str(int(fields[1]) | sam.FLAG_REVCOMP)
                    rec_out = "\t".join(fields)
                out.append(rec_out)
            return "".join(out)
        halves = [
            (q1, q2, g1, info["md1"], info["nm1"], True),
            (q3, q4, g2, info["md2"], info["nm2"], False),
        ]
        if not d.plusp:
            halves.reverse()  # records print in READ order
        for (qs, qe, g0, md, nm, first) in halves:
            chrnum = int(np.searchsorted(self.db.chr_ends, g0, side="right"))
            pos = g0 - int(self.db.chr_starts[chrnum]) + 1
            seg = qe - qs
            cigar = (f"{qs}H" if qs else "") + f"{seg}M" + (
                f"{L - qe}H" if qe < L else "")
            # SEQ carries only the aligned half (hard clips); pass the
            # READ-orientation slice so minus-strand revcomp applies
            if d.plusp:
                sseq = rec.seq.upper()[qs:qe]
                squal = qual[qs:qe] if qual else None
            else:
                sseq = rec.seq.upper()[L - qe : L - qs]
                squal = qual[L - qe : L - qs] if qual else None
            hit = sam.SEHit(
                chrname=self.db.chr_names[chrnum], chrpos=pos,
                plusp=d.plusp, cigar=cigar, md=md, nm=nm, mapq=mapq,
                absmq=absmq, second_absmq=second_absmq, xs=d.xs,
            )
            out.append(sam.se_record(
                rec.label, sseq, squal, hit, nh=nh, hi=hi + 1,
                secondary=hi > 0, extra=[xt]))
        return "".join(out)

    def _end_hit(self, rec: Record, hits, row: int, col: int) -> PostHit:
        return self._hit_details(
            rec,
            int(hits["kind"][row, col]),
            int(hits["left"][row, col]),
            int(hits["right"][row, col]),
            int(hits["split"][row, col]),
            int(hits["nindels"][row, col]),
            bool(hits["sense"][row, col]),
            bool(hits["plusp"][row, col]),
            mid=int(hits["mid"][row, col]),
            split2=int(hits["split2"][row, col]),
        )

    def _sub_batch(self, seqs, lefts, plusps, want_md: bool = True,
                   splits=None, rights=None):
        """Vectorized KIND_SUB hit details for a group of same-length
        oriented reads: mismatch masks, trims, NM, MD (the scalar
        _mismatch_masks -> trim_ends -> sam.md_gapped chain of
        _hit_details for one full-length part).  md is returned only
        when want_md — the native emitter consumes the raw
        mdpos/mdoff/mdch runs instead; qb is the aligned-orientation
        byte matrix, which is the SAM print orientation.

        splits/rights (optional int64 arrays) extend the batch to
        KIND_SPLICE rows: query [0, split) aligns at ``left``,
        [split, L) at ``right + split`` (the two-part composite of
        _hit_details); rows with split == L are plain subs.  Trims
        then follow the scalar splice policy: outer-end Kadane per
        PART, capped inside the part (SAM MD runs straight across the
        N gap, so the composite machinery below needs no other
        change)."""
        n = len(seqs)
        L = len(seqs[0])
        qb = np.frombuffer("".join(s.upper() for s in seqs)
                           .encode("latin-1"), np.uint8).reshape(n, L)
        minus = ~plusps
        if minus.any():
            qb = qb.copy()
            qb[minus] = _COMP_LUT[qb[minus, ::-1]]
        ar = np.arange(L)[None, :]
        if splits is None:
            gidx = lefts[:, None] + ar
        else:
            gidx = np.where(ar < splits[:, None],
                            lefts[:, None] + ar, rights[:, None] + ar)
        gb = self._genome_bytes[gidx]
        qn = qb == ord("N")
        if self._conv_plus is None and self._conv_minus is None:
            mm_sel = mm_ref = ~qn & (~self._ACGT_SET[gb] | (qb != gb))
        else:
            lut_p = self._conv_lut(self._conv_plus)
            lut_m = self._conv_lut(self._conv_minus)
            diff = np.where(plusps[:, None], lut_p[qb] != lut_p[gb],
                            lut_m[qb] != lut_m[gb])
            mm_sel = ~qn & (~self._ACGT_SET[gb] | diff)
            # display tolerance is one-directional (see _mismatch_masks)
            gp_, rp_ = _CONV_BASES.get(self._conv_plus, ("\0", "\0"))
            gm_, rm_ = _CONV_BASES.get(self._conv_minus, ("\0", "\0"))
            tol = np.where(plusps[:, None],
                           (gb == ord(gp_)) & (qb == ord(rp_)),
                           (gb == ord(gm_)) & (qb == ord(rm_)))
            mm_ref = ~qn & (~self._ACGT_SET[gb] | ((qb != gb) & ~tol))
        if self._alt_bytes is not None:
            # the alt allele counts for selection and trims, not MD/NM;
            # read at ``lefts`` even for spliced rows, as the JAX runner
            # does (runner.py:3244-3246)
            ab = self._alt_bytes[lefts[:, None] + ar]
            mm_sel = mm_sel & (qb != ab)
        if splits is None:
            trim5, trim3 = trim_ends_batch(
                mm_sel, self.params.trim_mismatch_score)
        else:
            # per-part outer trims (substring.c: no trimming at splice
            # inner ends).  Appending/prepending matches outside the
            # part leaves the Kadane argmax unchanged, so the part
            # restriction is just a mask.
            t5f, t3f = trim_ends_batch(
                mm_sel, self.params.trim_mismatch_score)
            t5l = trim_ends_batch(mm_sel & (ar < splits[:, None]),
                                  self.params.trim_mismatch_score)[0]
            t3r = trim_ends_batch(mm_sel & (ar >= splits[:, None]),
                                  self.params.trim_mismatch_score)[1]
            spl = splits < L
            trim5 = np.where(spl, np.minimum(t5l, splits - 1), t5f)
            trim3 = np.where(spl, np.minimum(t3r, L - splits - 1), t3f)
        span = (ar >= trim5[:, None]) & (ar < (L - trim3)[:, None])
        mm_span = mm_ref & span
        nm = mm_span.sum(1).astype(np.int64)
        r, c = np.nonzero(mm_span)
        out = {"trim5": trim5, "trim3": trim3, "nm": nm, "qb": qb,
               "mdpos": (c - trim5[r]).astype(np.int32),
               "mdoff": np.concatenate(
                   [[0], np.cumsum(nm)]).astype(np.uint32),
               "mdch": gb[r, c].tobytes()}
        if not want_md:
            return out
        starts = out["mdoff"]
        chars = out["mdch"].decode("latin-1")
        mds = []
        for i in range(n):
            lo, hi = int(starts[i]), int(starts[i + 1])
            mds.append(_md_from_positions(
                (c[lo:hi] - trim5[i]).tolist(), chars[lo:hi],
                int(L - trim5[i] - trim3[i])))
        out["md"] = mds
        return out

    def _chr_blob(self):
        """(blob, offsets) of chromosome names for the native emitter."""
        if getattr(self, "_chrblob_c", None) is None:
            names = [str(n) for n in self.db.chr_names]
            blob = "".join(names).encode("latin-1")
            off = np.zeros(len(names) + 1, np.uint32)
            off[1:] = np.cumsum([len(n) for n in names])
            self._chrblob_c = (blob, off)
        return self._chrblob_c

    def _se_done_level(self, recs, res, rows=None):
        """Per-row done level = min(budget, best score) — the gate the
        SE rescue lanes key on (_rescued_hits; stage1hr.c done_level).
        rows maps recs[i] -> res row (default: identity)."""
        spansize = -(-self.db.k // self.db.interval) * self.db.interval
        L = np.array([len(r.seq) for r in recs], np.int64)
        budget = np.maximum((L + self.db.interval - 1) // spansize - 2, 0)
        np_all = np.asarray(res["npaths"])
        sc_all = np.asarray(res["score"])[:, 0]
        if rows is None:
            npaths, score0 = np_all[:len(recs)], sc_all[:len(recs)]
        else:
            r = np.asarray(rows, np.int64)
            npaths, score0 = np_all[r], sc_all[r]
        best = np.where(npaths > 0, score0.astype(np.int64), 10**6)
        return np.minimum(budget, best)

    def _se_sam_fast(self, recs, res, rows) -> dict:
        """Batched SAM emission for the dominant SE success shape:
        npaths == 1, KIND_SUB, rescue lanes gated off (the caller
        checks).  recs[i] corresponds to res row rows[i].  Returns
        {row: text}; declined rows fall through to sam_records."""
        if not len(rows):
            return {}
        rows_a = np.asarray(rows, np.int64)
        kind = np.asarray(res["kind"])[rows_a, 0]
        left = np.asarray(res["left"])[rows_a, 0].astype(np.int64)
        plusp = np.asarray(res["plusp"])[rows_a, 0].astype(bool)
        L_a = np.array([len(r.seq) for r in recs], np.int64)
        G = len(self._genome_bytes)
        elig = ((kind == KIND_SUB) & (left >= 0) & (left + L_a <= G))
        idx = np.flatnonzero(elig)
        if not len(idx):
            return {}

        native_ok = (not sam.INSERT_0M
                     and native_mod.get_lib() is not None)
        t5a = np.zeros(len(idx), np.int64)
        t3a = np.zeros(len(idx), np.int64)
        nma = np.zeros(len(idx), np.int64)
        mda = [None] * len(idx)
        groups = []
        jobs = {}
        for k, i in enumerate(idx):
            jobs.setdefault(int(L_a[i]), []).append(
                (k, recs[i], left[i], plusp[i]))
        for L, grp in jobs.items():
            slots = [g[0] for g in grp]
            d = self._sub_batch([g[1].seq for g in grp],
                                np.array([g[2] for g in grp], np.int64),
                                np.array([g[3] for g in grp], bool),
                                want_md=not native_ok)
            t5a[slots] = d["trim5"]
            t3a[slots] = d["trim3"]
            nma[slots] = d["nm"]
            if native_ok:
                groups.append((L, slots, grp, d))
            else:
                for s, m in zip(slots, d["md"]):
                    mda[s] = m

        le, pl, rl = left[idx], plusp[idx], L_a[idx]
        chrn = np.searchsorted(self.db.chr_ends, le, side="right")
        pos = le - self.db.chr_starts[chrn] + 1 + t5a
        if native_ok:
            out = self._emit_se_native(recs, rows, idx, groups, chrn, pos, pl)
            if out is not None:
                return out
            for L, slots, grp, d in groups:
                starts = d["mdoff"]
                chars = d["mdch"].decode("latin-1")
                relpos = d["mdpos"]
                for t, s in enumerate(slots):
                    lo, hi = int(starts[t]), int(starts[t + 1])
                    mda[s] = _md_from_positions(
                        relpos[lo:hi].tolist(), chars[lo:hi],
                        int(L - d["trim5"][t] - d["trim3"][t]))
        names = self.db.chr_names
        out = {}
        for k, i in enumerate(idx):
            rec = recs[i]
            qual = rec.quality or None
            if qual is None:
                mq = MAX_QUALITY_SCORE
            else:
                mq = max(1, min(MAX_QUALITY_SCORE,
                                ord(max(qual)) - QUALITY_ADJ))
            cig = ((f"{t5a[k]}S" if t5a[k] else "")
                   + f"{rl[k] - t5a[k] - t3a[k]}M"
                   + (f"{t3a[k]}S" if t3a[k] else ""))
            hit = sam.SEHit(chrname=names[chrn[k]], chrpos=int(pos[k]),
                            plusp=bool(pl[k]), cigar=cig, md=mda[k],
                            nm=int(nma[k]), mapq=mq,
                            absmq=MAPQ_MAXIMUM_SCORE, second_absmq=0)
            out[int(rows[i])] = sam.se_record(
                rec.label, rec.seq.upper(), qual, hit, nh=1, hi=1)
        return out

    def _emit_se_native(self, recs, rows, idx, groups, chrn, pos, pl):
        """Native (C) SAM assembly for the SE SUB fast path: one
        sam_sub_lines call per read-length group builds every line.
        Returns {row: text} or None when the emitter declines."""
        nidx = len(idx)
        maxq = np.full(nidx, -1, np.int64)
        gq = []
        for L, slots, grp, d in groups:
            quals = [(g[1].quality or "") for g in grp]
            has = np.array([len(q) == L for q in quals], bool)
            qs = "".join(q if len(q) == L else "!" * L for q in quals)
            qm = np.frombuffer(qs.encode("latin-1"),
                               np.uint8).reshape(len(grp), L)
            maxq[slots] = np.where(has, qm.max(1), -1)
            minus = ~np.array([bool(g[3]) for g in grp], bool)
            qp = qm.copy()
            qp[minus] = qp[minus, ::-1]
            gq.append((qp, has))
        mqs = np.where(
            maxq < 0, MAX_QUALITY_SCORE,
            np.clip(maxq - QUALITY_ADJ, 1, MAX_QUALITY_SCORE))
        flags = np.where(pl, 0, sam.FLAG_REVCOMP).astype(np.int64)
        labs = [recs[i].label for i in idx]
        lablens = np.array([len(l) for l in labs], np.int64)
        laboff = np.zeros(nidx + 1, np.int64)
        laboff[1:] = np.cumsum(lablens)
        labblob = "".join(labs).encode("latin-1")
        blob, choff = self._chr_blob()

        slot_line = [None] * nidx
        for (L, slots, grp, d), (qp, has) in zip(groups, gq):
            sl = np.asarray(slots, np.int64)
            ns = len(sl)
            res = native_mod.sam_sub_lines(
                labblob, laboff[:-1][sl], lablens[sl],
                d["qb"], qp, np.full(ns, L, np.int32),
                has.astype(np.uint8),
                blob, choff, chrn[sl], pos[sl], flags[sl], mqs[sl],
                np.full(ns, -2, np.int64), np.zeros(ns, np.int64),
                np.zeros(ns, np.int64),
                d["trim5"], d["trim3"], d["nm"],
                np.ones(ns, np.int32), np.ones(ns, np.int32),
                np.full(ns, MAPQ_MAXIMUM_SCORE, np.int32),
                np.zeros(ns, np.int32),
                d["mdpos"], d["mdoff"], d["mdch"])
            if res is None:
                return None
            text, offs = res
            for t, s in enumerate(slots):
                slot_line[s] = text[offs[t]:offs[t + 1]]
        return {int(rows[i]): slot_line[k] for k, i in enumerate(idx)}

    # ------------------------------------------------------- paired-end host
    def _cat_row(self, j: int) -> None:
        """Record the GLOBAL chunk row about to emit — resulttype
        categories and the GMAP collection pass key on it, not on the
        res-local row (which differs inside the wide/overflow lane)."""
        self._gmap_row = j
        self._catkey = j

    def _cat_key(self, row: int) -> int:
        k = getattr(self, "_catkey", None)
        return row if k is None else k

    def _chrpos(self, d: PostHit) -> tuple[str, int]:
        chrnum = int(np.searchsorted(self.db.chr_ends, d.left, side="right"))
        return self.db.chr_names[chrnum], d.left - int(self.db.chr_starts[chrnum]) + 1 + d.trim5

    def _pair_flag(self, plusp, mate_plusp, firstp, inverted, mate_inverted,
                   proper, mate_mapped=True, mapped=True):
        flag = sam.FLAG_PAIRED | (sam.FLAG_FIRST if firstp else sam.FLAG_SECOND)
        if not mapped:
            flag |= sam.FLAG_UNMAPPED
        elif plusp == inverted:
            flag |= sam.FLAG_REVCOMP
        if not mate_mapped:
            flag |= sam.FLAG_MATE_UNMAPPED
        elif mate_plusp == mate_inverted:
            flag |= sam.FLAG_MATE_REVCOMP
        if proper and mapped and mate_mapped:
            flag |= sam.FLAG_PROPER
        return flag

    def _host_pairtype(self, d5: PostHit, d3: PostHit, pairmax: int) -> int:
        """Stage3_determine_pairtype (stage3hr.c:5074) on host hits;
        mirrors the device grid rules in gsnap_pe.pair_grid."""
        chr5 = int(np.searchsorted(self.db.chr_ends, d5.left, side="right"))
        chr3 = int(np.searchsorted(self.db.chr_ends, d3.left, side="right"))
        if chr5 != chr3:
            return gsnap_pe.PT_UNPAIRED
        if d5.plusp != d3.plusp:
            return gsnap_pe.PT_INVERSION
        l5 = d5.left
        e5 = d5.left + d5.trim5 + d5.ref_consumed + d5.trim3
        l3 = d3.left
        e3 = d3.left + d3.trim5 + d3.ref_consumed + d3.trim3
        if d5.plusp:
            if e3 < l5:
                return gsnap_pe.PT_SCRAMBLE
            if l3 > e5 + pairmax:
                return gsnap_pe.PT_TOOLONG
        else:
            if l3 > e5:
                return gsnap_pe.PT_SCRAMBLE
            if e3 + pairmax < l5:
                return gsnap_pe.PT_TOOLONG
        return gsnap_pe.PT_CONCORDANT

    def _pe_rescue(self, rec5: Record, rec3_inv: Record, res, row: int):
        """Terminal + GMAP lanes feeding the pairing stage when the
        device grid found no concordant pair (stage1hr.c:13520/14556/
        15138 GMAP pairsearch/halfmapping/terminal + Stage3pair_new),
        with each candidate pair's inside-facing ambiguous short-end
        splices resolved against the mate (``_resolve_inside_ambi``).

        Returns (pairs, concordant_p, final5, final3) where pairs is a
        ranked list of (hit5, hit3, pairtype, pair_score, insertlen)."""
        maxp = self.params.maxpaths
        e5, e3 = res["end5"], res["end3"]
        f5 = self._rescued_hits(rec5, e5, row, int(e5["npaths"][row]), maxp)
        f3 = self._rescued_hits(rec3_inv, e3, row, int(e3["npaths"][row]),
                                maxp)
        pairmax = self._pairmax()
        window = pairmax + self.params.shortsplicedist

        def gmap_for(rec, anchors, is5):
            # pairsearch/halfmapping GMAP anchored near the mate's hits
            # (stage1hr.c:14556/14625); reject short alignments
            # (Stage3_short_alignment_p, stage3.c:8362) and alignments
            # outside mate +- (pairmax + shortsplicedist)
            g = self._gmap_hosthit(rec)
            if g is None:
                return None
            d = g.d
            L = len(rec.seq)
            if (L - d.trim3) - d.trim5 < L // 2:
                return None
            for a in anchors:
                pt = (self._host_pairtype(d, a.d, pairmax) if is5
                      else self._host_pairtype(a.d, d, pairmax))
                if pt != gsnap_pe.PT_UNPAIRED and abs(d.left - a.d.left) <= window + L:
                    return g
            return None

        # GMAP hits never serve as anchors: the reference's pairsearch
        # iterates hits5/hits3 before any GMAP hit joins those lists
        # (stage1hr.c:14552, 15133), and its own products go straight
        # into pair lists
        anch5 = [h for h in f5 if h.hittype != "gmap"]
        anch3 = [h for h in f3 if h.hittype != "gmap"]
        # pairsearch tries at most max_gmap_pairsearch anchors
        # (stage1hr.c:14552 "i < max_gmap_pairsearch")
        cap = self.params.max_gmap_pairsearch
        psearch = "pairsearch" in self.gmap_modes
        g3 = (gmap_for(rec3_inv, anch5[:cap], is5=False)
              if anch5 and psearch else None)
        g5 = (gmap_for(rec5, anch3[:cap], is5=True)
              if anch3 and psearch else None)

        def hkey(h):
            return (h.hittype, h.d.left, h.d.plusp, h.d.trim5, h.d.trim3,
                    h.d.cigar_core)

        seen = set()
        pairs = []

        def addpair(h5, h3):
            h5, h3 = self._resolve_inside_ambi(rec5, rec3_inv, h5, h3)
            k = (hkey(h5), hkey(h3))
            if k in seen:
                return
            pt = self._host_pairtype(h5.d, h3.d, pairmax)
            if pt == gsnap_pe.PT_UNPAIRED:
                return
            seen.add(k)
            ps = _align_score(h5) + _align_score(h3)
            ins = reference_pairlength(
                h5.d, h3.d, len(rec5.seq), len(rec3_inv.seq))
            if pt == gsnap_pe.PT_CONCORDANT and ins <= 0:
                # Stage3pair_new rejects concordant pairs whose
                # insertlength computes to 0 (stage3hr.c:7557)
                return
            term = h5.hittype == "terminal" or h3.hittype == "terminal"
            pairs.append((h5, h3, pt, ps, ins, term))

        for h5 in f5:
            for h3 in f3:
                addpair(h5, h3)
        # pairsearch GMAP hits pair ONLY with their anchor hits, not
        # cross-product (stage1hr.c:14556/14625 Stage3pair_new per
        # anchor); the pair class follows the anchor's hittype
        if g3 is not None:
            for h5 in anch5:
                addpair(h5, g3)
        if g5 is not None:
            for h3 in anch3:
                addpair(g5, h3)

        # Stage3pair_remove_overlaps: pairs at the same genomic
        # positions collapse to the better one (nmatches, then the
        # Hittype enum order as in hit_goodness_cmp)
        def prank(p):
            # posttrim nmatches (hit_goodness_cmp), then Hittype order
            return (p[0].d.nmatches + p[1].d.nmatches,
                    -(rescue.HITTYPE_ORDER.get(p[0].hittype, 99)
                      + rescue.HITTYPE_ORDER.get(p[1].hittype, 99)))

        bypos = {}
        for p in pairs:
            k = (p[0].d.left, p[0].d.plusp, p[1].d.left, p[1].d.plusp)
            cur = bypos.get(k)
            if cur is None or prank(p) > prank(cur):
                bypos[k] = p
        pairs = list(bypos.values())

        conc = [p for p in pairs if p[2] == gsnap_pe.PT_CONCORDANT]
        if conc:
            # choose_among_paired ladder (stage1hr.c:15223): concordant
            # non-terminal pairs dominate pairs involving a terminal
            nonterm = [p for p in conc if not p[5]]
            chosen = nonterm or conc
        else:
            chosen = pairs
        chosen = [p[:5] for p in chosen]
        if chosen:
            best = min(p[3] for p in chosen)
            chosen = [p for p in chosen if p[3] <= best + self.params.subopt_levels]
            chosen.sort(key=lambda p: (p[3], p[0].d.left, p[1].d.left))
        # Stage3pair_resolve_multimapping (stage1hr.c:15459) is the
        # identity without genes / tally / runlength maps (not ported)
        return chosen, bool(conc), f5, f3

    @staticmethod
    def _pairlength_sub_batch(l5, p5, L5, t55, t35, l3, p3, L3, t53, t33):
        """Vectorized reference_pairlength for SUB/SUB pairs (single
        full-length part, ndel=0, span == read length)."""
        q = L5 + L3
        gs5 = np.where(p5, l5, l5 + L5)
        ge5 = np.where(p5, l5 + L5, l5)
        gs3 = np.where(p3, l3, l3 + L3)
        ge3 = np.where(p3, l3 + L3, l3)
        # trimmed aligned spans (strand-independent intervals)
        lo5, hi5 = l5 + t55, l5 + L5 - t35
        lo3, hi3 = l3 + t53, l3 + L3 - t33
        overlap = ~((hi3 < lo5) | (lo3 > hi5))
        # pair_insert_length projection distance on overlap
        pr50 = np.where(p5, l5, l5 + L5)
        pr31 = np.where(p3, l3 + L3, l3)
        ov = np.abs(pr50 - pr31)

        opp1 = p5 & ~p3
        t_opp1 = np.where(ge5 < ge3, ge3 - ge5 + q,
                          np.where(gs3 < gs5, gs5 - gs3 + q, 0))
        opp2 = ~p5 & p3
        t_opp2 = np.where(gs5 < gs3, gs3 - gs5 + q,
                          np.where(ge3 < ge5, ge5 - ge3 + q, 0))
        # same strand: gapped -> span distance; overlapping -> projection;
        # else the no-overlap fallback
        t_pp = np.where(ge5 < gs3, gs3 - ge5 + q,
                        np.where(overlap, ov,
                                 np.where(ge5 > gs3 + q, 0, gs3 - ge5 + q)))
        t_mm_ = np.where(gs3 < ge5, ge5 - gs3 + q,
                         np.where(overlap, ov,
                                  np.where(gs3 > ge5 + q, 0, ge5 - gs3 + q)))
        return np.where(opp1, t_opp1,
                        np.where(opp2, t_opp2,
                                 np.where(p5, t_pp, t_mm_)))

    def _pe_sam_fast(self, recs5, recs3_inv, res, rows) -> dict:
        """Batched SAM emission for the dominant PE success shape:
        concordant, npairs == 1, both ends KIND_SUB or a single local
        SPLICE.  recs5[i] / recs3_inv[i] correspond to res row rows[i].
        Returns {row: sam_text}; rows it declines (other hit kinds,
        genome-edge overruns) are omitted and must go through
        sam_pe_records, whose output it equals byte for byte."""
        if not len(rows):
            return {}
        h5, h3 = res["end5_pairing"], res["end3_pairing"]
        rows_a = np.asarray(rows, np.int64)
        i5 = np.asarray(res["i5"])[rows_a, 0].astype(np.int64)
        i3 = np.asarray(res["i3"])[rows_a, 0].astype(np.int64)
        f5 = {k: np.asarray(h5[k])[rows_a, i5]
              for k in gsnap_pe.PAIR_EMIT_FIELDS}
        f3 = {k: np.asarray(h3[k])[rows_a, i3]
              for k in gsnap_pe.PAIR_EMIT_FIELDS}
        l5 = f5["left"].astype(np.int64)
        l3 = f3["left"].astype(np.int64)
        p5 = f5["plusp"].astype(bool)
        p3 = f3["plusp"].astype(bool)
        L5 = np.array([len(r.seq) for r in recs5], np.int64)
        L3 = np.array([len(r.seq) for r in recs3_inv], np.int64)
        G = len(self._genome_bytes)
        r5a = f5["right"].astype(np.int64)
        r3a = f3["right"].astype(np.int64)
        sp5a = f5["split"].astype(np.int64)
        sp3a = f3["split"].astype(np.int64)

        def end_ok(kind, l, L_, r, sp):
            sub = (kind == KIND_SUB) & (l >= 0) & (l + L_ <= G)
            spl = ((kind == KIND_SPLICE) & (l >= 0) & (r > l)
                   & (sp >= 1) & (sp <= L_ - 1) & (r + L_ <= G))
            return sub | spl

        elig = (end_ok(f5["kind"], l5, L5, r5a, sp5a)
                & end_ok(f3["kind"], l3, L3, r3a, sp3a))
        splice_pair = elig & ((f5["kind"] == KIND_SPLICE)
                              | (f3["kind"] == KIND_SPLICE))
        out_spl = {}
        if splice_pair.any():
            out_spl = self._pe_sam_fast_spliced(
                recs5, recs3_inv, rows, np.flatnonzero(splice_pair),
                f5, f3, L5, L3)
        idx = np.flatnonzero(elig & ~splice_pair)
        if not len(idx):
            return out_spl

        # per-end detail jobs, grouped by read length
        njobs = 2 * len(idx)
        native_ok = (not sam.INSERT_0M
                     and native_mod.get_lib() is not None)
        t5a = np.zeros(njobs, np.int64)
        t3a = np.zeros(njobs, np.int64)
        nma = np.zeros(njobs, np.int64)
        mda = [None] * njobs
        groups = []
        jobs = {}
        for k, i in enumerate(idx):
            jobs.setdefault(int(L5[i]), []).append(
                (2 * k, recs5[i], l5[i], p5[i]))
            jobs.setdefault(int(L3[i]), []).append(
                (2 * k + 1, recs3_inv[i], l3[i], p3[i]))
        for L, grp in jobs.items():
            slots = [g[0] for g in grp]
            d = self._sub_batch([g[1].seq for g in grp],
                                np.array([g[2] for g in grp], np.int64),
                                np.array([g[3] for g in grp], bool),
                                want_md=not native_ok)
            t5a[slots] = d["trim5"]
            t3a[slots] = d["trim3"]
            nma[slots] = d["nm"]
            if native_ok:
                groups.append((L, slots, grp, d))
            else:
                for s, m in zip(slots, d["md"]):
                    mda[s] = m

        ev = np.arange(len(idx)) * 2
        t55, t35, nm5 = t5a[ev], t3a[ev], nma[ev]
        t53, t33, nm3 = t5a[ev + 1], t3a[ev + 1], nma[ev + 1]
        le5, le3 = l5[idx], l3[idx]
        pl5, pl3 = p5[idx], p3[idx]
        rl5, rl3 = L5[idx], L3[idx]

        chr5 = np.searchsorted(self.db.chr_ends, le5, side="right")
        chr3 = np.searchsorted(self.db.chr_ends, le3, side="right")
        pos5 = le5 - self.db.chr_starts[chr5] + 1 + t55
        pos3 = le3 - self.db.chr_starts[chr3] + 1 + t53
        tlen = self._pairlength_sub_batch(le5, pl5, rl5, t55, t35,
                                          le3, pl3, rl3, t53, t33)
        # TLEN sign by POS; ties -> first read + (samprint.c:754-762)
        t5sgn = np.where(pos5 > pos3, -tlen, tlen)
        t3sgn = np.where(pos5 > pos3, tlen, -tlen)
        # _pair_flag: REVCOMP when plusp == inverted (0x10 semantics
        # for inverted reads); inversion flags follow -o/--orientation
        inv1, inv2 = self.invert_first, self.invert_second
        flag5 = (0x43 | sam.FLAG_PROPER
                 | np.where(pl5 == inv1, sam.FLAG_REVCOMP, 0)
                 | np.where(pl3 == inv2, sam.FLAG_MATE_REVCOMP, 0))
        flag3 = (0x83 | sam.FLAG_PROPER
                 | np.where(pl3 == inv2, sam.FLAG_REVCOMP, 0)
                 | np.where(pl5 == inv1, sam.FLAG_MATE_REVCOMP, 0))

        if native_ok:
            out = self._emit_pe_native(
                recs5, recs3_inv, rows, idx, groups, chr5, chr3, pos5, pos3,
                flag5, flag3, t5sgn, t3sgn)
            if out is not None:
                out.update(out_spl)
                return out
            # native emit declined (buffer sizing): fall back to the
            # Python path — rebuild the MD strings it skipped
            for L, slots, grp, d in groups:
                starts = d["mdoff"]
                chars = d["mdch"].decode("latin-1")
                relpos = d["mdpos"]
                for t, s in enumerate(slots):
                    lo, hi = int(starts[t]), int(starts[t + 1])
                    mda[s] = _md_from_positions(
                        relpos[lo:hi].tolist(), chars[lo:hi],
                        int(L - d["trim5"][t] - d["trim3"][t]))

        names = self.db.chr_names
        out = {}
        for k, i in enumerate(idx):
            rec5, rec3 = recs5[i], recs3_inv[i]
            qual5 = rec5.quality or None
            qual3i = rec3.quality or None
            if qual5 or qual3i:
                both = (qual5 or "") + (qual3i or "")
                mq = max(1, min(MAX_QUALITY_SCORE,
                                ord(max(both)) - QUALITY_ADJ))
            else:
                mq = MAX_QUALITY_SCORE
            cn5, cn3 = names[chr5[k]], names[chr3[k]]
            same = cn5 == cn3
            c5 = ((f"{t55[k]}S" if t55[k] else "")
                  + f"{rl5[k] - t55[k] - t35[k]}M"
                  + (f"{t35[k]}S" if t35[k] else ""))
            c3 = ((f"{t53[k]}S" if t53[k] else "")
                  + f"{rl3[k] - t53[k] - t33[k]}M"
                  + (f"{t33[k]}S" if t33[k] else ""))
            hit5 = sam.SEHit(chrname=cn5, chrpos=int(pos5[k]),
                             plusp=bool(pl5[k]), cigar=c5, md=mda[2 * k],
                             nm=int(nm5[k]), mapq=mq,
                             absmq=MAPQ_MAXIMUM_SCORE, second_absmq=0)
            hit3 = sam.SEHit(chrname=cn3, chrpos=int(pos3[k]),
                             plusp=bool(pl3[k]), cigar=c3,
                             md=mda[2 * k + 1], nm=int(nm3[k]), mapq=mq,
                             absmq=MAPQ_MAXIMUM_SCORE, second_absmq=0)
            out[int(rows[i])] = (
                sam.pe_record(rec5.label, rec5.seq.upper(), qual5,
                              int(flag5[k]), hit5,
                              rnext="=" if same else cn3,
                              pnext=int(pos3[k]), tlen=int(t5sgn[k]),
                              nh=1, hi=1)
                + sam.pe_record(rec3.label, rec3.seq.upper(), qual3i,
                                int(flag3[k]), hit3,
                                rnext="=" if same else cn5,
                                pnext=int(pos5[k]), tlen=int(t3sgn[k]),
                                nh=1, hi=1))
        out.update(out_spl)
        return out

    def _pe_sam_fast_spliced(self, recs5, recs3_inv, rows, idx, f5, f3,
                             L5, L3) -> dict:
        """Vectorized SAM emission for unique concordant pairs where at
        least one end is a single local SPLICE (the dominant RNA-seq
        shape under -N 1).  Uses the composite-span _sub_batch for
        masks/trims/MD; CIGAR gains the N segment, the XS strand tag
        follows the device sense bit, and the insert length falls back
        to the scalar reference_pairlength over lightweight stubs.
        Byte-identical to sam_pe_records."""
        from types import SimpleNamespace

        n_i = len(idx)
        jobs = {}
        for k, i in enumerate(idx):
            for s, (recs, f, Ls) in enumerate(
                    ((recs5, f5, L5), (recs3_inv, f3, L3))):
                L = int(Ls[i])
                kind = int(f["kind"][i])
                left = int(f["left"][i])
                if kind == KIND_SPLICE:
                    split = int(f["split"][i])
                    right = int(f["right"][i])
                else:
                    split, right = L, left
                jobs.setdefault(L, []).append(
                    (2 * k + s, recs[i], left, bool(f["plusp"][i]),
                     split, right))
        njobs = 2 * n_i
        t5a = np.zeros(njobs, np.int64)
        t3a = np.zeros(njobs, np.int64)
        nma = np.zeros(njobs, np.int64)
        mda = [None] * njobs
        for L, grp in jobs.items():
            slots = [g[0] for g in grp]
            d = self._sub_batch(
                [g[1].seq for g in grp],
                np.array([g[2] for g in grp], np.int64),
                np.array([g[3] for g in grp], bool),
                want_md=True,
                splits=np.array([g[4] for g in grp], np.int64),
                rights=np.array([g[5] for g in grp], np.int64))
            t5a[slots] = d["trim5"]
            t3a[slots] = d["trim3"]
            nma[slots] = d["nm"]
            for s, m in zip(slots, d["md"]):
                mda[s] = m

        names = self.db.chr_names
        out = {}
        for k, i in enumerate(idx):
            rec5, rec3 = recs5[i], recs3_inv[i]
            qual5 = rec5.quality or None
            qual3i = rec3.quality or None
            if qual5 or qual3i:
                both = (qual5 or "") + (qual3i or "")
                mq = max(1, min(MAX_QUALITY_SCORE,
                                ord(max(both)) - QUALITY_ADJ))
            else:
                mq = MAX_QUALITY_SCORE

            def mk(s, rec, f, Ls):
                L = int(Ls[i])
                kind = int(f["kind"][i])
                left = int(f["left"][i])
                plusp = bool(f["plusp"][i])
                t5, t3 = int(t5a[2 * k + s]), int(t3a[2 * k + s])
                if kind == KIND_SPLICE:
                    split = int(f["split"][i])
                    right = int(f["right"][i])
                    gap = right - left
                    a = split - t5
                    b = L - split - t3
                    cig = ((f"{t5}S" if t5 else "") + f"{a}M{gap}N{b}M"
                           + (f"{t3}S" if t3 else ""))
                    xs = "+" if bool(f["sense"][i]) else "-"
                    rc = a + gap + b
                    parts = ((0, split, left), (split, L, right + split))
                else:
                    cig = ((f"{t5}S" if t5 else "")
                           + f"{L - t5 - t3}M" + (f"{t3}S" if t3 else ""))
                    xs = None
                    rc = L - t5 - t3
                    parts = ((0, L, left),)
                chrn = int(np.searchsorted(self.db.chr_ends, left,
                                           side="right"))
                pos = left - int(self.db.chr_starts[chrn]) + 1 + t5
                stub = SimpleNamespace(
                    left=left, plusp=plusp, trim5=t5, trim3=t3,
                    ref_consumed=rc, ndel=0, parts=parts)
                return (names[chrn], pos, plusp, cig, xs,
                        int(nma[2 * k + s]), stub, L)

            cn5, pos5, pl5, c5, xs5, nm5, st5, l5len = mk(0, rec5, f5, L5)
            cn3, pos3, pl3, c3, xs3, nm3, st3, l3len = mk(1, rec3, f3, L3)
            same = cn5 == cn3
            tlen = reference_pairlength(st5, st3, l5len, l3len)
            t5sgn = -tlen if pos5 > pos3 else tlen
            t3sgn = tlen if pos5 > pos3 else -tlen
            inv1, inv2 = self.invert_first, self.invert_second
            flag5 = (0x43 | sam.FLAG_PROPER
                     | (sam.FLAG_REVCOMP if pl5 == inv1 else 0)
                     | (sam.FLAG_MATE_REVCOMP if pl3 == inv2 else 0))
            flag3 = (0x83 | sam.FLAG_PROPER
                     | (sam.FLAG_REVCOMP if pl3 == inv2 else 0)
                     | (sam.FLAG_MATE_REVCOMP if pl5 == inv1 else 0))
            hit5 = sam.SEHit(chrname=cn5, chrpos=pos5, plusp=pl5,
                             cigar=c5, md=mda[2 * k], nm=nm5, mapq=mq,
                             absmq=MAPQ_MAXIMUM_SCORE, second_absmq=0,
                             xs=xs5)
            hit3 = sam.SEHit(chrname=cn3, chrpos=pos3, plusp=pl3,
                             cigar=c3, md=mda[2 * k + 1], nm=nm3, mapq=mq,
                             absmq=MAPQ_MAXIMUM_SCORE, second_absmq=0,
                             xs=xs3)
            out[int(rows[i])] = (
                sam.pe_record(rec5.label, rec5.seq.upper(), qual5,
                              int(flag5), hit5,
                              rnext="=" if same else cn3,
                              pnext=pos3, tlen=int(t5sgn), nh=1, hi=1)
                + sam.pe_record(rec3.label, rec3.seq.upper(), qual3i,
                                int(flag3), hit3,
                                rnext="=" if same else cn5,
                                pnext=pos5, tlen=int(t3sgn), nh=1, hi=1))
        return out

    def _emit_pe_native(self, recs5, recs3_inv, rows, idx, groups,
                        chr5, chr3, pos5, pos3, flag5, flag3,
                        t5sgn, t3sgn):
        """Native (C) SAM assembly for the PE SUB/SUB fast path: one
        sam_sub_lines call per read-length group builds every line;
        Python only slices the result per pair.  Returns {row: text}
        or None when the emitter declines (caller falls back)."""
        nidx = len(idx)
        njobs = 2 * nidx
        maxq = np.full(njobs, -1, np.int64)
        gq = []
        for L, slots, grp, d in groups:
            quals = [(g[1].quality or "") for g in grp]
            has = np.array([len(q) == L for q in quals], bool)
            qs = "".join(q if len(q) == L else "!" * L for q in quals)
            qm = np.frombuffer(qs.encode("latin-1"),
                               np.uint8).reshape(len(grp), L)
            maxq[slots] = np.where(has, qm.max(1), -1)
            minus = ~np.array([bool(g[3]) for g in grp], bool)
            qp = qm.copy()
            qp[minus] = qp[minus, ::-1]
            gq.append((qp, has))
        ev = np.arange(nidx) * 2
        mq_pair = np.maximum(maxq[ev], maxq[ev + 1])
        mq_pair = np.where(
            mq_pair < 0, MAX_QUALITY_SCORE,
            np.clip(mq_pair - QUALITY_ADJ, 1, MAX_QUALITY_SCORE))

        chrs = np.empty(njobs, np.int64)
        poss = np.empty(njobs, np.int64)
        flags = np.empty(njobs, np.int64)
        tlens = np.empty(njobs, np.int64)
        pnexts = np.empty(njobs, np.int64)
        rnexts = np.empty(njobs, np.int64)
        chrs[ev], chrs[ev + 1] = chr5, chr3
        poss[ev], poss[ev + 1] = pos5, pos3
        flags[ev], flags[ev + 1] = flag5, flag3
        tlens[ev], tlens[ev + 1] = t5sgn, t3sgn
        pnexts[ev], pnexts[ev + 1] = pos3, pos5
        same = chr5 == chr3
        rnexts[ev] = np.where(same, -1, chr3)
        rnexts[ev + 1] = np.where(same, -1, chr5)
        labs = [recs5[i].label for i in idx]
        lablens = np.array([len(l) for l in labs], np.int64)
        laboff = np.zeros(nidx + 1, np.int64)
        laboff[1:] = np.cumsum(lablens)
        labblob = "".join(labs).encode("latin-1")
        lab_start = np.repeat(laboff[:-1], 2)
        lab_len = np.repeat(lablens, 2)
        mqs = np.repeat(mq_pair, 2)
        blob, choff = self._chr_blob()

        slot_line = [None] * njobs
        for (L, slots, grp, d), (qp, has) in zip(groups, gq):
            sl = np.asarray(slots, np.int64)
            ns = len(sl)
            res = native_mod.sam_sub_lines(
                labblob, lab_start[sl], lab_len[sl],
                d["qb"], qp, np.full(ns, L, np.int32),
                has.astype(np.uint8),
                blob, choff, chrs[sl], poss[sl], flags[sl], mqs[sl],
                rnexts[sl], pnexts[sl], tlens[sl],
                d["trim5"], d["trim3"], d["nm"],
                np.ones(ns, np.int32), np.ones(ns, np.int32),
                np.full(ns, MAPQ_MAXIMUM_SCORE, np.int32),
                np.zeros(ns, np.int32),
                d["mdpos"], d["mdoff"], d["mdch"])
            if res is None:
                return None
            text, offs = res
            for t, s in enumerate(slots):
                slot_line[s] = text[offs[t]:offs[t + 1]]
        out = {}
        for k, i in enumerate(idx):
            out[int(rows[i])] = slot_line[2 * k] + slot_line[2 * k + 1]
        return out

    def _clip_sub(self, rec: Record, d: PostHit, h_low: int, h_high: int):
        """Hard-clip a single-M-span hit at query coords [0, h_low) and
        [L - h_high, L) — the --clip-overlap application (samprint.c:
        2949 Stage3pair_overlap + print_cigar/print_md_string hardclip
        handling).  Returns (cigar, chrpos, md, nm, seq, qual) or None
        when the clip consumes the aligned span."""
        L = len(rec.seq)
        cl_l = h_low if d.plusp else h_high   # aligned-left clip
        cl_r = h_high if d.plusp else h_low
        t5n = max(d.trim5, cl_l)
        t3n = max(d.trim3, cl_r)
        m = L - t5n - t3n
        if m <= 0:
            return None
        q = rec.seq.upper() if d.plusp else dna.revcomp_str(rec.seq.upper())
        conv = self._conv_plus if d.plusp else self._conv_minus
        _, mm_ref = self._mismatch_masks(q, d.left, conv)
        span = mm_ref[t5n : L - t3n]
        refs = self._genome_str[d.left + t5n : d.left + L - t3n]
        md, nm = sam.md_gapped([(span, refs)], [])
        cigar = ((f"{cl_l}H" if cl_l else "")
                 + (f"{t5n - cl_l}S" if t5n > cl_l else "")
                 + f"{m}M"
                 + (f"{t3n - cl_r}S" if t3n > cl_r else "")
                 + (f"{cl_r}H" if cl_r else ""))
        chrnum = int(np.searchsorted(self.db.chr_ends, d.left, side="right"))
        pos = d.left - int(self.db.chr_starts[chrnum]) + 1 + t5n
        seq = rec.seq.upper()[h_low : L - h_high]
        qual = rec.quality[h_low : L - h_high] if rec.quality else None
        return cigar, pos, md, nm, seq, qual

    @staticmethod
    def _single_m(d: PostHit) -> bool:
        c = d.cigar_core
        return c.endswith("M") and c[:-1].isdigit()

    # ------------------------------------------------------------------ main
    def _emit(self, rec: Record, res, row: int, j: int) -> str:
        self._cat_row(j)
        try:
            return self.sam_records(rec, res, row, int(res["npaths"][row]),
                                    self.params.maxpaths)
        except Exception:
            _offending_read(rec)
            raise

    def _need_full(self, recs, res, rows=None) -> np.ndarray:
        """Rows whose emission takes the rescue lanes (or has more than
        one hit): no hit, more than PAIR_KTOP hits, a done level that
        opens the lanes without a device lane-noop verdict, or any row
        when known sites open the short-end lane."""
        r = np.arange(len(recs)) if rows is None else np.asarray(rows, np.int64)
        np_a = np.asarray(res["npaths"])[r]
        done = self._se_done_level(recs, res, rows)
        noop = np.asarray(res["lane_noop"])[r]
        return ((np_a == 0) | (np_a > PAIR_KTOP)
                | ((done >= self.params.indel_penalty_end) & ~noop)
                | (self._known_sites is not None))

    def run(self, records: list[Record], out, batch_size: int = 256,
            emit_header: bool = True) -> int:
        """Align ``records`` and write SAM to ``out``; returns the count.
        Chunk i+1's device work is queued before chunk i's host
        emission, so the two overlap."""
        if emit_header:
            out.write(sam.header(
                self.db.chr_names,
                (self.db.chr_ends - self.db.chr_starts).tolist()))
        total = 0
        chunks = [records[i : i + batch_size]
                  for i in range(0, len(records), batch_size)]
        disp = self.dispatch_records(chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            nxt = (self.dispatch_records(chunks[ci + 1])
                   if ci + 1 < len(chunks) else None)
            res = self.fetch_records(disp)
            disp = nxt
            t_batch = _time.time()
            # overflow rescue lane: reads whose oligo position lists
            # truncated or whose distinct diagonals exceeded ncand re-run
            # at wider caps (widecand when only the candidate budget
            # overflowed, fullwide when the seed grid truncated)
            ovf = np.flatnonzero(res["overflow"])
            trunc_a = np.asarray(res["overflow_trunc"], bool)
            wide_lanes, wide_row = [], set()
            for widen in (False, True):
                rows_sel = [int(j) for j in ovf if trunc_a[j] == widen]
                if rows_sel:
                    wide_lanes.append(
                        (self._dispatch_wide([chunk[j] for j in rows_sel],
                                             widen_seeds=widen),
                         {j: wi for wi, j in enumerate(rows_sel)},
                         not widen))
                    wide_row.update(rows_sel)
            # pass 1: GMAP-rescue requests are collected, not solved
            self._gmap_collect = []
            self._gmap_rows = set()
            self._categories = {}
            texts = [None] * len(chunk)
            need_full = self._need_full(chunk, res)
            self._lane_masks.clear()
            self._lane_trims.clear()
            self._prime_rows((chunk[j], res, j) for j in np.flatnonzero(need_full)
                             if j not in wide_row)
            np_a = np.asarray(res["npaths"])
            if self.params.maxpaths >= 1:
                fast = [j for j in range(len(chunk))
                        if np_a[j] == 1 and not need_full[j]
                        and j not in wide_row]
                for j, t in self._se_sam_fast(
                        [chunk[j] for j in fast], res, fast).items():
                    texts[j] = t
                    self._categories[j] = "unpaired_uniq"
            for j, rec in enumerate(chunk):
                if j not in wide_row and texts[j] is None:
                    texts[j] = self._emit(rec, res, j, j)
            wide_ctx = {}   # chunk row -> (tree, row) for re-emission
            for wdisp, lane_rows, is_final in wide_lanes:
                wide_res = self.fetch_records(wdisp)
                if not is_final:
                    # fullwide grid still truncated -> exact-grid retry
                    wov = np.asarray(wide_res["overflow"], bool)
                    wtr = np.asarray(wide_res["overflow_trunc"], bool)
                    still = [j for j, wi in lane_rows.items()
                             if wov[wi] and wtr[wi]]
                    if still:
                        wide_lanes.append(
                            (self._dispatch_wide([chunk[j] for j in still],
                                                 widen_seeds=True, exact=True),
                             {j: wi for wi, j in enumerate(still)}, True))
                        for j in still:
                            del lane_rows[j]
                wjs = list(lane_rows)
                wrows = [lane_rows[j] for j in wjs]
                wn = np.asarray(wide_res["npaths"])
                wneed = self._need_full([chunk[j] for j in wjs], wide_res,
                                        wrows)
                self._prime_rows((chunk[j], wide_res, lane_rows[j])
                                 for t, j in enumerate(wjs) if wneed[t])
                if self.params.maxpaths >= 1:
                    w_fast = [(j, lane_rows[j]) for t, j in enumerate(wjs)
                              if wn[lane_rows[j]] == 1 and not wneed[t]]
                    if w_fast:
                        ft = self._se_sam_fast(
                            [chunk[j] for j, _ in w_fast],
                            wide_res, [wi for _, wi in w_fast])
                        for j, wi in w_fast:
                            if wi in ft:
                                texts[j] = ft[wi]
                                self._categories[j] = "unpaired_uniq"
                for j, wi in lane_rows.items():
                    wide_ctx[j] = (wide_res, wi)
                    if texts[j] is None:
                        texts[j] = self._emit(chunk[j], wide_res, wi, j)
            pending = self._gmap_collect
            rows = self._gmap_rows
            self._gmap_collect = None
            if pending:
                # one batched device pass resolves every rescue, then
                # only the affected reads re-emit (pass 2)
                self.prefetch_gmap(pending)
                for j in sorted(rows):
                    rres, rrow = wide_ctx.get(j, (res, j))
                    texts[j] = self._emit(chunk[j], rres, rrow, j)
            for j in range(len(chunk)):
                self.category_counts[
                    self._categories.get(j, "unpaired_uniq")] += 1
            for t in texts:
                out.write(t)
            total += len(chunk)
            self._gmap_cache.clear()
            self.batch_times.append((_time.time() - t_batch, len(chunk)))
        return total

    def sam_pe_records(self, rec5: Record, rec3_inv: Record, rec3_orig: Record,
                       res, row: int) -> str:
        """SAM lines for one read pair (both ends)."""
        npairs = int(res["npairs"][row])
        qual5 = rec5.quality or None
        qual3i = rec3_inv.quality or None
        out = []
        if self.quiet_if_excessive and npairs > self.params.maxpaths:
            self._categories[self._cat_key(row)] = "nomapping"
            q3o = rec3_orig.quality or None
            flag5 = self._pair_flag(True, True, True, self.invert_first,
                                    self.invert_second,
                                    proper=False, mate_mapped=False,
                                    mapped=False)
            flag3 = self._pair_flag(True, True, False, self.invert_second,
                                    self.invert_first,
                                    proper=False, mate_mapped=False,
                                    mapped=False)
            return (sam.pe_record(rec5.label, rec5.seq.upper(), qual5,
                                  flag5, None)
                    + sam.pe_record(rec3_orig.label, rec3_orig.seq.upper(),
                                    q3o, flag3, None))

        conc_dev = bool(res["pair_concordant"][row])
        rpairs = rconc = f5 = f3 = None
        if npairs == 0 or not conc_dev:
            rpairs, rconc, f5, f3 = self._pe_rescue(rec5, rec3_inv, res, row)
        use_rescue = bool(rpairs) and (rconc or npairs == 0)

        if use_rescue or npairs > 0:
            if use_rescue:
                n = min(len(rpairs), self.params.maxpaths)
                pairs = [(p[0].d, p[1].d) for p in rpairs[:n]]
                proper = True
            else:
                n = min(npairs, self.params.maxpaths)
                h5p, h3p = res["end5_pairing"], res["end3_pairing"]
                pairs = []
                for k in range(n):
                    i5 = int(res["i5"][row, k])
                    i3 = int(res["i3"][row, k])
                    d5 = self._end_hit(rec5, h5p, row, i5)
                    d3 = self._end_hit(rec3_inv, h3p, row, i3)
                    pairs.append((d5, d3))
                proper = conc_dev or int(res["pairtype"][row, 0]) in (1, 2, 3)
            # rank pairs by summed nmatches desc then loglik desc
            order = sorted(
                range(n),
                key=lambda k: (
                    -(pairs[k][0].nmatches + pairs[k][1].nmatches),
                    -(pairs[k][0].loglik + pairs[k][1].loglik),
                ),
            )
            pairs = [pairs[k] for k in order]

            # resulttype (resulthr.h:7-12)
            if conc_dev or (use_rescue and rconc):
                cat = "concordant_uniq" if n == 1 else "concordant_mult"
            elif n > 1:
                cat = "paired_mult"
            else:
                pt = int(res["pairtype"][row, 0])
                cat = {1: "paired_uniq_inv", 2: "paired_uniq_scr",
                       3: "paired_uniq_long"}.get(pt, "concordant_uniq")
            self._categories[self._cat_key(row)] = cat

            # pair MAPQ (stage3hr.c Stage3pair_eval_and_sort)
            if n == 1:
                mq = MAX_QUALITY_SCORE
                if qual5 or qual3i:
                    both = (qual5 or "") + (qual3i or "")
                    mq = int(np.frombuffer(both.encode(), np.uint8).max()) - QUALITY_ADJ
                    mq = max(1, min(MAX_QUALITY_SCORE, mq))
                mapqs = [mq]
                absmqs = [MAPQ_MAXIMUM_SCORE]
                second_absmq = 0
            else:
                logliks = np.array([d5.loglik + d3.loglik for d5, d3 in pairs])
                for i in range(n - 1, 0, -1):
                    if logliks[i - 1] < logliks[i]:
                        logliks[i - 1] = logliks[i]
                logliks = logliks - logliks.max()
                absmqs = [int(round(max(0.0, ll + MAPQ_MAXIMUM_SCORE))) for ll in logliks]
                second_absmq = absmqs[1]
                probs = np.exp(logliks)
                probs = probs / probs.sum()
                mapqs = [
                    96 if 1.0 - p < 2.5e-10 else int(round(-10.0 * math.log10(1.0 - p)))
                    for p in probs
                ]

            for k, (d5, d3) in enumerate(pairs):
                chr5, pos5 = self._chrpos(d5)
                chr3, pos3 = self._chrpos(d3)
                tlen = reference_pairlength(
                    d5, d3, len(rec5.seq), len(rec3_inv.seq)
                )
                # --clip-overlap: hard-clip the inside halves of an
                # overlapping proper pair (Stage3pair_overlap,
                # stage3hr.c:1177: overlap = L5 + L3 - insertlength)
                clip5 = clip3 = None
                if (self.clip_overlap and proper
                        and self._single_m(d5) and self._single_m(d3)):
                    L5c, L3c = len(rec5.seq), len(rec3_inv.seq)
                    if (tlen > L5c and tlen > L3c and tlen < L5c + L3c):
                        ov = L5c + L3c - tlen
                        h5c = ov // 2
                        h3c = ov - h5c
                        clip5 = self._clip_sub(rec5, d5, 0, h5c)
                        clip3 = self._clip_sub(rec3_inv, d3, h3c, 0)
                        if clip5 is None or clip3 is None:
                            clip5 = clip3 = None
                if clip5 is not None:
                    pos5c, pos3c = clip5[1], clip3[1]
                else:
                    pos5c, pos3c = pos5, pos3
                # sign: by POS; ties -> first read +, second - (samprint.c:754-762)
                if pos5c < pos3c:
                    t5, t3 = tlen, -tlen
                elif pos5c > pos3c:
                    t5, t3 = -tlen, tlen
                else:
                    t5, t3 = tlen, -tlen
                mapq = mapqs[k] if k < len(mapqs) else 0
                absmq = absmqs[k] if k < len(absmqs) else 0
                for (rec, qual, d, dm, first, inv, minv, chrn, pos, mchr,
                     mpos, tl, clip) in (
                    (rec5, qual5, d5, d3, True, self.invert_first,
                     self.invert_second, chr5, pos5c,
                     chr3, pos3c, t5, clip5),
                    (rec3_inv, qual3i, d3, d5, False, self.invert_second,
                     self.invert_first, chr3,
                     pos3c, chr5, pos5c, t3, clip3),
                ):
                    flag = self._pair_flag(d.plusp, dm.plusp, first, inv, minv, proper)
                    if k > 0 and not sam.MULTIPLE_PRIMARIES:
                        # non-primary pairs print 0x100 on both ends
                        # (samprint.c SAM_print first_absmq gating)
                        flag |= sam.FLAG_SECONDARY
                    if clip is not None:
                        cigar, pos, md, nm, seqout, qualout = clip
                    else:
                        cigar = (
                            (f"{d.trim5}S" if d.trim5 else "")
                            + d.cigar_core
                            + (f"{d.trim3}S" if d.trim3 else "")
                        )
                        md, nm = d.md, d.nmm_trimmed
                        seqout, qualout = rec.seq.upper(), qual
                    hit = sam.SEHit(
                        chrname=chrn, chrpos=pos, plusp=d.plusp, cigar=cigar,
                        md=md, nm=nm, mapq=mapq, absmq=absmq,
                        second_absmq=second_absmq, xs=d.xs,
                    )
                    out.append(sam.pe_record(
                        rec.label, seqout, qualout, flag, hit,
                        rnext="=" if mchr == chrn else mchr, pnext=mpos,
                        tlen=tl, nh=n, hi=k + 1,
                    ))
            return "".join(out)

        # no pairs: halfmapping / unpaired / nomapping (rescued lanes)
        n5 = len(f5) if f5 else 0
        n3 = len(f3) if f3 else 0
        if n5 == 0 and n3 == 0:
            self._categories[self._cat_key(row)] = "nomapping"
        elif n5 > 0 and n3 > 0:
            if f5[0].hittype == "distant" or f3[0].hittype == "distant":
                self._categories[self._cat_key(row)] = "unpaired_transloc"
            elif n5 == 1 and n3 == 1:
                self._categories[self._cat_key(row)] = "unpaired_uniq"
            else:
                self._categories[self._cat_key(row)] = "unpaired_mult"
        else:
            mapped = f5 if n5 > 0 else f3
            if mapped[0].hittype == "distant":
                self._categories[self._cat_key(row)] = "halfmapping_transloc"
            elif len(mapped) == 1:
                self._categories[self._cat_key(row)] = "halfmapping_uniq"
            else:
                self._categories[self._cat_key(row)] = "halfmapping_mult"
        for (rec, qual, fh, other_f, first, inv, minv, rec_orig) in (
            (rec5, qual5, f5, f3, True, self.invert_first,
             self.invert_second,
             Record(rec5.label, rec5.header,
                    dna.revcomp_str(rec5.seq.upper()),
                    rec5.quality[::-1] if rec5.quality else rec5.quality)
             if self.invert_first else rec5),
            (rec3_inv, qual3i, f3, f5, False, self.invert_second,
             self.invert_first, rec3_orig),
        ):
            npaths = len(fh)
            if npaths > 0:
                n = min(npaths, self.params.maxpaths)
                details = [h.d for h in fh[:n]]
                mapqs, absmqs, second_absmq = self._end_mapqs(details, qual)
                mate_mapped = len(other_f) > 0
                if mate_mapped:
                    dm = other_f[0].d
                    mchr, mpos = self._chrpos(dm)
                    mplus = dm.plusp
                else:
                    mchr, mpos, mplus = "*", 0, True
                for hi_, d in enumerate(details):
                    chrn, pos = self._chrpos(d)
                    flag = self._pair_flag(
                        d.plusp, mplus, first, inv, minv, proper=False,
                        mate_mapped=mate_mapped,
                    ) | (sam.FLAG_SECONDARY if hi_ > 0
                        and not sam.MULTIPLE_PRIMARIES else 0)
                    cigar = (
                        (f"{d.trim5}S" if d.trim5 else "")
                        + d.cigar_core
                        + (f"{d.trim3}S" if d.trim3 else "")
                    )
                    hit = sam.SEHit(
                        chrname=chrn, chrpos=pos, plusp=d.plusp, cigar=cigar,
                        md=d.md, nm=d.nmm_trimmed,
                        mapq=mapqs[hi_] if hi_ < len(mapqs) else 0,
                        absmq=absmqs[hi_] if hi_ < len(absmqs) else 0,
                        second_absmq=second_absmq, xs=d.xs,
                    )
                    # mate unmapped -> RNEXT "*", PNEXT 0 (observed
                    # reference behavior for halfmapping)
                    rn = ("=" if mchr == chrn else mchr) if mate_mapped else "*"
                    out.append(sam.pe_record(
                        rec.label, rec.seq.upper(), qual, flag, hit,
                        rnext=rn, pnext=mpos if mate_mapped else 0,
                        tlen=0, nh=n, hi=hi_ + 1,
                    ))
            else:
                # unmapped end: print the ORIGINAL read, point at the mate
                mate_mapped = len(other_f) > 0
                if mate_mapped:
                    dm = other_f[0].d
                    mchr, mpos = self._chrpos(dm)
                    mplus = dm.plusp
                else:
                    mchr, mpos, mplus = "*", 0, True
                flag = self._pair_flag(
                    True, mplus, first, inv, minv, proper=False,
                    mate_mapped=mate_mapped, mapped=False,
                )
                q_orig = rec_orig.quality or None
                out.append(sam.pe_record(
                    rec_orig.label, rec_orig.seq.upper(), q_orig, flag, None,
                    rnext=mchr, pnext=mpos,
                ))
        return "".join(out)

    def _emit_pe(self, recs, res, row: int, j: int) -> str:
        """sam_pe_records for chunk row j (recs: rec5, rec3_inv,
        rec3_orig) at ``row`` of ``res``, under the crash guard."""
        self._cat_row(j)
        try:
            return self.sam_pe_records(*recs, res, row)
        except Exception:
            _offending_read(recs[0], recs[2])
            raise

    def run_pe(self, records5: list[Record], records3: list[Record], out,
               batch_size: int = 256, emit_header: bool = True) -> int:
        """Paired-end alignment: read 2 is reverse-complemented at input
        (invert_second_p) so concordant mates share a strand.  Chunk
        i+1's device work is queued before chunk i's host emission."""
        if emit_header:
            out.write(sam.header(
                self.db.chr_names,
                (self.db.chr_ends - self.db.chr_starts).tolist()))
        total = 0

        def mk_inv(chunk3):
            return (invert_records(chunk3) if self.invert_second
                    else list(chunk3))

        def mk_first(chunk5):
            # -o RF inverts read 1 at input instead (gsnap.c:1472-1477)
            return (invert_records(chunk5) if self.invert_first
                    else list(chunk5))

        pairs_in = [
            (records5[i : i + batch_size], records3[i : i + batch_size])
            for i in range(0, len(records5), batch_size)
        ]
        invs = [None] * len(pairs_in)
        procs5 = [None] * len(pairs_in)
        disp = None
        if pairs_in:
            invs[0] = mk_inv(pairs_in[0][1])
            procs5[0] = mk_first(pairs_in[0][0])
            disp = self.dispatch_pairs(procs5[0], invs[0])
        fast_ok = (self.params.maxpaths >= 1 and self.pe_fast
                   and not self.clip_overlap)
        for ci, (_, chunk3) in enumerate(pairs_in):
            chunk3_inv = invs[ci]
            chunk5 = procs5[ci]
            if ci + 1 < len(pairs_in):
                invs[ci + 1] = mk_inv(pairs_in[ci + 1][1])
                procs5[ci + 1] = mk_first(pairs_in[ci + 1][0])
                nxt = self.dispatch_pairs(procs5[ci + 1], invs[ci + 1])
            else:
                nxt = None
            res = self.fetch_pairs(disp)
            disp = nxt
            recs_of = lambda j: (chunk5[j], chunk3_inv[j], chunk3[j])
            # PE overflow rescue lane: pairs where EITHER end truncated
            # its seed lists / candidate set re-run at wide caps; the
            # wide batch is dispatched first and fetched only after the
            # other rows emit, so its device work overlaps host emission
            o5 = np.asarray(res["end5"]["overflow"], bool)
            o3 = np.asarray(res["end3"]["overflow"], bool)
            ovf = np.flatnonzero(o5 | o3)
            trunc_any = (np.asarray(res["end5"]["overflow_trunc"], bool)
                         | np.asarray(res["end3"]["overflow_trunc"], bool))
            wide_lanes, wide_row = [], set()
            # candidate-budget rows ride the widecand config, truncated
            # rows the widened seed grid
            tr_rows = [int(j) for j in ovf if trunc_any[j]]
            wc_rows = [int(j) for j in ovf if not trunc_any[j]]
            for rows_sel, widen in ((wc_rows, False), (tr_rows, True)):
                if rows_sel:
                    wide_lanes.append(
                        (self._dispatch_wide_pe(
                            [chunk5[j] for j in rows_sel],
                            [chunk3_inv[j] for j in rows_sel],
                            widen_seeds=widen),
                         {j: wi for wi, j in enumerate(rows_sel)},
                         not widen))
                    wide_row.update(rows_sel)
            t_batch = _time.time()
            # pass 1 collects GMAP-rescue requests; one batched device
            # pass resolves them; affected pairs re-emit (pass 2)
            self._gmap_collect = []
            self._gmap_rows = set()
            self._categories = {}
            self._catkey = None
            texts = [None] * len(chunk5)
            # rows whose emission may need the rescue lanes: prime their
            # candidate masks in one batch
            npair_a = np.asarray(res["npairs"])
            conc_a = np.asarray(res["pair_concordant"], bool)
            need_full = (npair_a == 0) | ~conc_a | (npair_a > PAIR_KTOP)
            self._lane_masks.clear()
            self._lane_trims.clear()
            self._prime_rows(
                (r, res[end], j) for j in np.flatnonzero(need_full)
                if int(j) not in wide_row
                for r, end in ((chunk5[j], "end5"), (chunk3_inv[j], "end3")))

            # vectorized emission for the dominant success shape
            if fast_ok:
                fast_cand = [j for j in range(len(chunk5))
                             if npair_a[j] == 1 and conc_a[j]
                             and not need_full[j] and j not in wide_row]
                for j, t in self._pe_sam_fast(
                        [chunk5[j] for j in fast_cand],
                        [chunk3_inv[j] for j in fast_cand],
                        res, fast_cand).items():
                    texts[j] = t
                    self._categories[j] = "concordant_uniq"

            for j in range(len(chunk5)):
                if j not in wide_row and texts[j] is None:
                    texts[j] = self._emit_pe(recs_of(j), res, j, j)
            wide_ctx = {}   # chunk row -> (tree, row) for re-emission
            for wdisp, lane_rows, is_final in wide_lanes:
                wide_res = self.fetch_pairs(wdisp)
                if not is_final and lane_rows:
                    # rows whose widened seed grid still truncated re-run
                    # once more at the exact grid
                    still = [j for j, wi in lane_rows.items()
                             if any(wide_res[e]["overflow"][wi]
                                    and wide_res[e]["overflow_trunc"][wi]
                                    for e in ("end5", "end3"))]
                    if still:
                        wide_lanes.append(
                            (self._dispatch_wide_pe(
                                [chunk5[j] for j in still],
                                [chunk3_inv[j] for j in still],
                                widen_seeds=True, exact=True),
                             {j: wi for wi, j in enumerate(still)}, True))
                        for j in still:
                            del lane_rows[j]
                wn = np.asarray(wide_res["npairs"])
                wc = np.asarray(wide_res["pair_concordant"], bool)
                wneed = (wn == 0) | ~wc | (wn > PAIR_KTOP)
                self._prime_rows(
                    (r, wide_res[end], wi)
                    for j, wi in lane_rows.items() if wneed[wi]
                    for r, end in ((chunk5[j], "end5"),
                                   (chunk3_inv[j], "end3")))
                if fast_ok:
                    w_fast = [(j, wi) for j, wi in lane_rows.items()
                              if wn[wi] == 1 and wc[wi] and not wneed[wi]]
                    if w_fast:
                        ft = self._pe_sam_fast(
                            [chunk5[j] for j, _ in w_fast],
                            [chunk3_inv[j] for j, _ in w_fast],
                            wide_res, [wi for _, wi in w_fast])
                        for j, wi in w_fast:
                            if wi in ft:
                                texts[j] = ft[wi]
                                self._categories[j] = "concordant_uniq"
                for j, wi in lane_rows.items():
                    wide_ctx[j] = (wide_res, wi)
                    if texts[j] is None:
                        texts[j] = self._emit_pe(recs_of(j), wide_res, wi, j)
            pending = self._gmap_collect
            rows = self._gmap_rows
            self._gmap_collect = None
            if pending:
                self.prefetch_gmap(pending)
                for j in sorted(rows):
                    rres, rrow = wide_ctx.get(j, (res, j))
                    texts[j] = self._emit_pe(recs_of(j), rres, rrow, j)
            # -a/--adapter-strip: pairs with no concordant/paired
            # result retry with detected primer readthrough chopped
            # (gsnap.c:621-665 + Shortread_chop_primers); both the
            # retried alignment AND the printed SEQ use the chopped
            # reads, whether or not the retry pairs
            if self.chop_primers:
                failset = ("unpaired_uniq", "unpaired_mult", "nomapping",
                           "halfmapping_uniq", "halfmapping_mult",
                           "unpaired_transloc", "halfmapping_transloc")
                retries = []
                for j in range(len(chunk5)):
                    if self._categories.get(j) not in failset:
                        continue
                    ch = chop_primers(chunk5[j].seq, chunk3_inv[j].seq)
                    if ch > 0:
                        retries.append((j, ch))
                if retries:
                    c5c, c3ic, c3c = [], [], []
                    for j, ch in retries:
                        r5, r3i, r3 = chunk5[j], chunk3_inv[j], chunk3[j]
                        c5c.append(Record(
                            r5.label, r5.header, r5.seq[: len(r5.seq) - ch],
                            r5.quality[: len(r5.seq) - ch]
                            if r5.quality else r5.quality))
                        c3ic.append(Record(
                            r3i.label, r3i.header, r3i.seq[ch:],
                            r3i.quality[ch:] if r3i.quality
                            else r3i.quality))
                        c3c.append(Record(
                            r3.label, r3.header, r3.seq[: len(r3.seq) - ch],
                            r3.quality[: len(r3.seq) - ch]
                            if r3.quality else r3.quality))
                    rres = self.align_pairs(c5c, c3ic)
                    for t, (j, ch) in enumerate(retries):
                        texts[j] = self._emit_pe((c5c[t], c3ic[t], c3c[t]),
                                                 rres, t, j)
            for j in range(len(chunk5)):
                self.category_counts[
                    self._categories.get(j, "concordant_uniq")] += 1
            for t in texts:
                out.write(t)
            total += len(chunk5)
            self._gmap_cache.clear()
            self.batch_times.append((_time.time() - t_batch, len(chunk5)))
        return total
