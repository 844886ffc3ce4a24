"""Multimapping resolution maps (gsnap -g/--genes, --favor-multiexon,
--use-tally, --use-runlength).

Replicates the reference's three-step Stage3end_resolve_multimapping
(stage3hr.c:4955-5060) and its map primitives:

  * IIT_gene_overlap               (iit-read.c:5304-5420)
  * Substring_gene_overlap         (substring.c:3725-3742)
  * Stage3end_gene_overlap         (stage3hr.c:794-842)
  * Stage3pair_gene_overlap        (stage3hr.c:1245-1279)
  * Substring_tally                (substring.c:3784-3852)
  * Substring_runlength_p          (substring.c:3856-3876)

Among multimapping hits, only the hits in the best known-gene overlap
class survive (NO_KNOWN_GENE < KNOWN_GENE < KNOWN_GENE_MULTIEXON).
The map is a genes-format IIT (one record per transcript, annotation =
gene-name line followed by one "start end" pair per exon, minus-strand
rows printed "end start" -- util/gtf_genes.pl.in format, produced here
by cli/gtf_genes, cli/gff3_genes, cli/psl_genes).

A copy of gmap_gsnap_tpu/align/genes.py; it reads the maps with the
port's db/iit.IIT.
"""

from __future__ import annotations

import os
import re

import numpy as np

NO_KNOWN_GENE, KNOWN_GENE, KNOWN_GENE_MULTIEXON = 0, 1, 2

_EXON_RE = re.compile(r"\s*(\d+)\s+(\d+)")


class _ChromMap:
    """A map IIT plus the chromosome table needed to turn universal
    coordinates into per-chromosome 1-based IIT queries."""

    def __init__(self, iit, chr_names, chr_starts, chr_ends):
        self.iit = iit
        self.chr_names = list(chr_names)
        self.chr_starts = np.asarray(chr_starts)
        self.chr_ends = np.asarray(chr_ends)

    @classmethod
    def open(cls, name: str, db, mapdir: str | None = None, **kw):
        """Resolve like the reference (gsnap.c:2099-2121): a path as
        given (or under the user's map dir), else
        <db>.maps/<name>.iit."""
        from ..db.iit import IIT

        cands = []
        if mapdir is not None:
            cands += [os.path.join(mapdir, name),
                      os.path.join(mapdir, f"{name}.iit")]
        cands += [name,
                  os.path.join(db.dbdir, f"{db.dbname}.maps", f"{name}.iit")]
        if not name.endswith(".iit"):
            cands.append(name + ".iit")
        for path in cands:
            if os.path.exists(path):
                return cls(IIT.read(path), db.chr_names, db.chr_starts,
                           db.chr_ends, **kw)
        raise FileNotFoundError(f"no map {name}")

    def _chrcoords(self, a: int, b: int):
        """Universal [a, b) span -> (div, 1-based inclusive coords)
        as alignstart/alignend convert (substring.c:3731-3738)."""
        lo, hi = (a, b) if a <= b else (b, a)
        c = int(np.searchsorted(self.chr_ends, lo, side="right"))
        off = int(self.chr_starts[c])
        return self.chr_names[c], lo - off + 1, hi - off

    def _annotation_body(self, div: str, i: int) -> str:
        text = self.iit.annotations[div][i].decode("ascii", "replace")
        if self.iit.version >= 5:
            # v5 annotations carry the rest-of-header as their first
            # line (IIT_annotation, iit-read.c:421)
            text = text.split("\n", 1)[1] if "\n" in text else ""
        return text


class GenesMap(_ChromMap):
    """Genes-format map IIT (gsnap -g/--genes)."""

    def __init__(self, iit, chr_names, chr_starts, chr_ends,
                 favor_multiexon: bool = False):
        super().__init__(iit, chr_names, chr_starts, chr_ends)
        self.favor_multiexon = favor_multiexon

    # ------------------------------------------------------------- internals
    def _exon_lines(self, div: str, i: int) -> list[str]:
        text = self._annotation_body(div, i)
        # IIT_gene_overlap then skips one more line: the gene-name row
        text = text.split("\n", 1)[1] if "\n" in text else ""
        return [ln for ln in text.split("\n") if ln.strip()]

    def gene_overlap(self, div: str, x: int, y: int) -> int:
        """IIT_gene_overlap (iit-read.c:5304) for [x, y], 1-based
        inclusive chromosome coordinates."""
        ivs = self.iit.intervals.get(div)
        if not ivs:
            return NO_KNOWN_GENE
        foundp = False
        for i in self.iit.get(div, x, y, sortp=False):
            sign = ivs[i].sign
            body = self._exon_lines(div, i)
            multiexon = False
            for j, ln in enumerate(body):
                m = _EXON_RE.match(ln)
                if not m:
                    raise ValueError(f"can't parse exon coordinates in {ln!r}")
                es, ee = int(m.group(1)), int(m.group(2))
                if j + 1 < len(body):
                    multiexon = True
                if sign > 0:
                    if ee < x or es > y:
                        continue  # no overlap
                else:
                    # minus-strand exon rows are "end start"
                    if es < x or ee > y:
                        continue  # no overlap
                if self.favor_multiexon:
                    if multiexon:
                        return KNOWN_GENE_MULTIEXON
                    foundp = True  # keep searching for a multi-exon gene
                else:
                    return KNOWN_GENE
        return KNOWN_GENE if foundp else NO_KNOWN_GENE

    # ------------------------------------------------------------ public API
    def segments_overlap(self, segments) -> int:
        """Stage3end_gene_overlap (stage3hr.c:794): combine per-substring
        overlap over trimmed genomic segments [(lo, hi)) in universal
        coordinates."""
        foundp = False
        for a, b in segments:
            if max(a, b) <= min(a, b):
                continue
            div, x, y = self._chrcoords(a, b)
            ov = self.gene_overlap(div, x, y)
            if ov == KNOWN_GENE_MULTIEXON:
                return KNOWN_GENE_MULTIEXON
            if ov == KNOWN_GENE:
                if not self.favor_multiexon:
                    return KNOWN_GENE
                foundp = True
        return KNOWN_GENE if foundp else NO_KNOWN_GENE


class TallyMap(_ChromMap):
    """Tally map IIT (gsnap --use-tally): per-position read-depth
    counts, one annotation line per genomic position."""

    def segments_tally(self, segments) -> int:
        """Stage3end_compute_tally (stage3hr.c:919) over trimmed
        genomic segments: summed per-position tallies."""
        total = 0
        for a, b in segments:
            if max(a, b) <= min(a, b):
                continue
            div, x, y = self._chrcoords(a, b)
            ivs = self.iit.intervals.get(div)
            if not ivs:
                continue
            for i in self.iit.get(div, x, y, sortp=False):
                iv = ivs[i]
                lines = self._annotation_body(div, i).split("\n")
                # one line per position starting at interval low
                # (Substring_tally, substring.c:3820-3838)
                for pos in range(max(iv.low, x), min(iv.high, y) + 1):
                    j = pos - iv.low
                    if j < len(lines):
                        total += _line_tally(lines[j])
        return total


class RunlengthMap(_ChromMap):
    """Runlength map IIT (gsnap --use-runlength): presence of any
    interval marks the region as covered."""

    def segments_runlength_p(self, segments) -> bool:
        """Substring_runlength_p (substring.c:3856): any interval
        overlapping any trimmed segment."""
        for a, b in segments:
            if max(a, b) <= min(a, b):
                continue
            div, x, y = self._chrcoords(a, b)
            if self.iit.get(div, x, y, sortp=False):
                return True
        return False


def _line_tally(line: str) -> int:
    """get_total_tally (substring.c:3751): sum the leading digit run
    of every whitespace token on the line."""
    total = 0
    for tok in line.split():
        m = re.search(r"\d+", tok)
        if m:
            total += int(m.group())
    return total


def resolve_multimapping(items: list, overlap_of=None, tally_of=None,
                         runlength_of=None) -> list:
    """Stage3end/Stage3pair_resolve_multimapping (stage3hr.c:4955-5060):
    (1) when any hit overlaps a known gene, keep only the best overlap
    class; (2) when any hit has tally coverage, drop zero-tally hits;
    (3) when any hit touches a runlength interval, keep only those."""
    if len(items) <= 1:
        return items
    if overlap_of is not None:
        ovs = [overlap_of(it) for it in items]
        best = max(ovs)
        if best > NO_KNOWN_GENE:
            items = [it for it, o in zip(items, ovs) if o >= best]
    if len(items) <= 1:
        return items
    if tally_of is not None:
        tallies = [tally_of(it) for it in items]
        if max(tallies) > 0:
            # tally_threshold = 1.0 (stage3hr.c:5017, no USE_TALLY_RATIO)
            items = [it for it, t in zip(items, tallies) if t >= 1]
    if len(items) <= 1:
        return items
    if runlength_of is not None:
        rls = [runlength_of(it) for it in items]
        if any(rls):
            items = [it for it, r in zip(items, rls) if r]
    return items
