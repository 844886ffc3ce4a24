"""Annotation parsing for the splicesites/introns extraction utilities.

Python equivalents of the reference Perl tools (util/gtf_splicesites.pl.in,
gff3_splicesites.pl.in, psl_splicesites.pl.in and the *_introns variants):
parse exon structures per transcript from GTF / GFF3 / PSL and emit the
map-IIT text formats (README:848-888):

  >label.exonN/M chr:X..Y donor|acceptor D     (splicesites)
  >label.intronN/M chr:X..Y                    (introns)

Coordinates are 1-based; X..Y ascending = plus strand, descending =
minus; D = intron length.

A copy of gmap_gsnap_tpu/utils/annot.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Transcript:
    label: str            # gene.transcript (gtf) or ID (gff3) or qname (psl)
    chrom: str
    strand: str
    exons: list[tuple[int, int]] = field(default_factory=list)  # 1-based lo, hi
    tid: str = ""         # bare transcript id (genes map headers)
    gene: str = ""        # gene name/id (genes map second line)

    def ordered_exons(self) -> list[tuple[int, int]]:
        """Exons in transcript order (5' -> 3')."""
        exons = sorted(self.exons)
        return exons[::-1] if self.strand == "-" else exons


def _gtf_attr(attrs: str, key: str) -> str | None:
    m = re.search(rf'{key} "([^"]*)"', attrs)
    return m.group(1) if m else None


def parse_gtf(lines) -> list[Transcript]:
    out: dict[str, Transcript] = {}
    order: list[str] = []
    for line in lines:
        if line.startswith("#"):
            continue
        f = line.rstrip("\r\n").split("\t")
        if len(f) < 9 or f[2] != "exon":
            continue
        tid = _gtf_attr(f[8], "transcript_id") or ""
        gid = _gtf_attr(f[8], "gene_id") or tid
        gname = _gtf_attr(f[8], "gene_name") or gid
        key = tid
        if key not in out:
            out[key] = Transcript(f"{gname}.{tid}", f[0], f[6],
                                  tid=tid, gene=gname)
            order.append(key)
        out[key].exons.append((int(f[3]), int(f[4])))
    return [out[k] for k in order]


def parse_gff3(lines) -> list[Transcript]:
    """Label = <gene Parent ID>.<mRNA ID> like gff3_splicesites.pl."""
    out: dict[str, Transcript] = {}
    order: list[str] = []
    mrna_gene: dict[str, str] = {}

    def attr(attrs, key):
        m = re.search(rf"{key}=([^;]+)", attrs)
        return m.group(1) if m else None

    for line in lines:
        if line.startswith("#"):
            continue
        f = line.rstrip("\r\n").split("\t")
        if len(f) < 9:
            continue
        typ = f[2].lower()
        if typ in ("mrna", "transcript"):
            tid = attr(f[8], "ID")
            if tid:
                mrna_gene[tid] = attr(f[8], "Parent") or ""
        elif typ == "exon":
            m = re.search(r"Parent=([^;]+)", f[8])
            if not m:
                continue
            for parent in m.group(1).split(","):
                if parent not in out:
                    gene = mrna_gene.get(parent, "")
                    label = f"{gene}.{parent}" if gene else parent
                    out[parent] = Transcript(label, f[0], f[6],
                                             tid=parent, gene=gene)
                    order.append(parent)
                out[parent].exons.append((int(f[3]), int(f[4])))
    return [out[k] for k in order]


def parse_psl(lines, start_col: int = 0) -> list[Transcript]:
    """UCSC alignment-track rows (refGene.txt style, what the reference's
    psl_splicesites.pl actually reads): acc, chr, strand, txStart, txEnd,
    cdsStart, cdsEnd, exonCount, exonStarts (0-based), exonEnds."""
    out = []
    for line in lines:
        f = line.rstrip("\r\n").split("\t")[start_col:]
        if len(f) < 10:
            continue
        starts = [int(x) for x in f[8].rstrip(",").split(",") if x]
        ends = [int(x) for x in f[9].rstrip(",").split(",") if x]
        if len(starts) != int(f[7]) or len(starts) != len(ends):
            continue
        exons = [(s + 1, e) for s, e in zip(starts, ends)]  # plus order
        strand = f[2]
        if strand == "-":
            exons = exons[::-1]  # transcript order
        out.append(Transcript(f[0], f[1], strand, exons,
                              tid=f[0], gene=f[0]))
    return out


def splicesites_text(transcripts: list[Transcript]) -> str:
    out = []
    for t in transcripts:
        exons = t.ordered_exons()
        n = len(exons)
        for i in range(n - 1):
            if t.strand == "-":
                lo_i = exons[i][0]
                hi_n = exons[i + 1][1]
                d = lo_i - hi_n - 1
                out.append(f">{t.label}.exon{i+1}/{n} {t.chrom}:{lo_i}..{lo_i-1} donor {d}")
                out.append(f">{t.label}.exon{i+2}/{n} {t.chrom}:{hi_n+1}..{hi_n} acceptor {d}")
            else:
                hi_i = exons[i][1]
                lo_n = exons[i + 1][0]
                d = lo_n - hi_i - 1
                out.append(f">{t.label}.exon{i+1}/{n} {t.chrom}:{hi_i}..{hi_i+1} donor {d}")
                out.append(f">{t.label}.exon{i+2}/{n} {t.chrom}:{lo_n-1}..{lo_n} acceptor {d}")
    return "\n".join(out) + ("\n" if out else "")


def genes_text(transcripts: list[Transcript], min_exons: int = 1) -> str:
    """Genes map format (util/gtf_genes.pl.in, gff3_genes.pl.in,
    psl_genes.pl.in):

      >transcript_id chr:start..end     (minus: descending)
      gene_name
      s1 e1                             (per exon, transcript order;
      ...                                minus exons print "end start")

    min_exons: gff3_genes skips single-exon transcripts (its
    '$#exons > 0' gate); the gtf/psl variants print everything."""
    out = []
    for t in transcripts:
        if not t.exons or len(t.exons) < min_exons:
            continue
        ex = sorted(t.exons)
        name = t.tid or t.label
        gene = t.gene or t.label
        if t.strand == "+":
            out.append(f">{name} {t.chrom}:{ex[0][0]}..{ex[-1][1]}")
            out.append(gene)
            out.extend(f"{a} {b}" for a, b in ex)
        elif t.strand == "-":
            out.append(f">{name} {t.chrom}:{ex[-1][1]}..{ex[0][0]}")
            out.append(gene)
            out.extend(f"{b} {a}" for a, b in reversed(ex))
    return "\n".join(out) + ("\n" if out else "")


def introns_text(transcripts: list[Transcript]) -> str:
    out = []
    for t in transcripts:
        exons = t.ordered_exons()
        n = len(exons)
        for i in range(n - 1):
            if t.strand == "-":
                out.append(
                    f">{t.label}.intron{i+1}/{n-1} {t.chrom}:{exons[i][0]}..{exons[i+1][1]}"
                )
            else:
                out.append(
                    f">{t.label}.intron{i+1}/{n-1} {t.chrom}:{exons[i][1]}..{exons[i+1][0]}"
                )
    return "\n".join(out) + ("\n" if out else "")


def dbsnp_text(lines, desired_chr: str | None = None, max_weight: int = 1) -> str:
    """dbsnp_iit equivalent (util/dbsnp_iit.pl.in): UCSC dbSNP dump ->
    '>rsid chr:pos AB strand' for single-class biallelic SNPs, alleles
    normalized to the plus strand and sorted."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = []
    for line in lines:
        f = line.rstrip("\r\n").split("\t")
        if len(f) < 18 or f[11] != "single":
            continue
        chrom = f[1]
        if desired_chr and chrom != desired_chr:
            continue
        try:
            if int(f[17]) > max_weight:
                continue
        except ValueError:
            continue
        if len(f) > 18 and f[18].strip():
            continue  # any exception type excludes (all mapped to 0)
        m = re.fullmatch(r"(.)/(.)", f[9])
        if not m:
            continue
        a, b = m.group(1), m.group(2)
        if a not in comp or b not in comp:
            continue
        strand = f[6]
        if strand == "-":
            a, b = comp[a], comp[b]
        snp_type = a + b if a <= b else b + a
        out.append(f">{f[4]} {chrom}:{int(f[2]) + 1} {snp_type} {strand}")
    return "\n".join(out) + ("\n" if out else "")
