"""ORF finding and translation over aligned columns.

Replicates translation.c semantics: translate the genomic side of the
alignment in 3 frames (aa recorded at the first nt of each codon,
frame = genomic-column-index % 3), find the best ORF per frame
(find_bounds_forward, translation.c:190-340: the first ORF may start
anywhere, later ORFs require an M after a stop; ORF length counts the
stop codon), pick the longest (highest frame wins ties).

A copy of gmap_gsnap_tpu/align/translation.py; the port's modules stand behind its
relative imports.
"""

from __future__ import annotations

CODON_TABLE = {}
_BASES = "TCAG"
_AAS = (
    "FFLLSSSSYY**CC*W"
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            CODON_TABLE[_b1 + _b2 + _b3] = _AAS[16 * _i + 4 * _j + _k]


def get_codon(nt0: str, nt1: str, nt2: str) -> str:
    return CODON_TABLE.get(nt0 + nt1 + nt2, "X")


def translate_forward(genome_cols: str) -> list[str]:
    """aa at the first nt of each complete codon; ' ' elsewhere."""
    n = len(genome_cols)
    aa = [" "] * n
    for i in range(n - 2):
        c = get_codon(genome_cols[i], genome_cols[i + 1], genome_cols[i + 2])
        aa[i] = c
    return aa


# gmap -F (fulllengthp): module-level config like the reference's
# static (gmap.c:315); set by the CLI, read as the default below
FULLLENGTH_P = False

# gmap -a/--cdsstart (gmap.c:485 cds_startpos, 1-based; 0 = off):
# translation starts at the given query nucleotide instead of ORF
# search (translation.c:503 find_bounds_forward_fromstart)
CDS_STARTPOS = 0


def find_bounds_forward_fromstart(aa: list[str], cds_startpos: int):
    """translation.c:500-567: frame fixed by (cds_startpos-1) % 3; the
    ORF starts at the first codon at/after cds_startpos-1 and ends at
    the first stop (the scan terminates on it)."""
    n = len(aa)
    frame = (cds_startpos - 1) % 3
    orf = 0
    start = 0
    best = (0, 0, max(0, n - 1), False)
    for i in range(n):
        if i % 3 != frame or aa[i] == " " or i < cds_startpos - 1:
            continue
        if orf == 0:
            start = i
        orf += 1
        if aa[i] == "*":
            best = (orf, start, i, True)
            break
    if not best[3] and orf > best[0]:
        best = (orf, start, n - 1, False)
    return frame, best[1], best[2], best[0], best[3]


def find_bounds_forward(aa: list[str], fulllengthp: bool | None = None):
    """Returns (frame, starti, endi, length_aa, endstopp) over column
    indices; aa[i]==' ' columns are skipped.  Mirrors
    find_bounds_forward (translation.c:190-340)."""
    if CDS_STARTPOS > 0:
        return find_bounds_forward_fromstart(aa, CDS_STARTPOS)
    if fulllengthp is None:
        fulllengthp = FULLLENGTH_P
    n = len(aa)
    best = {}
    for f in range(3):
        needmet = fulllengthp
        orf = 0
        start = None
        bestorf, beststart, bestend, endstop = 0, 0, max(0, n - 1), False
        for i in range(f, n, 3):
            codon = aa[i] if i < n else " "
            if codon == " ":
                continue
            if needmet:
                if codon == "M":
                    orf = 1
                    start = i
                    needmet = False
            elif codon == "*":
                orf += 1
                if orf > bestorf:
                    bestorf, beststart, bestend, endstop = orf, start, i, True
                needmet = True
                orf = 0
            else:
                if start is None:
                    start = i
                orf += 1
        if orf > bestorf:
            bestorf, beststart, bestend, endstop = orf, start, n - 1, False
        best[f] = (bestorf, beststart if beststart is not None else 0, bestend, endstop)

    # pick longest; higher frame wins ties (translation.c:313-330)
    length = max(best[f][0] for f in range(3))
    if length == 0 and fulllengthp:
        # no full-length gene found: assume partial length
        # (translation.c:1508-1513)
        return find_bounds_forward(aa, fulllengthp=False)
    for f in (2, 1, 0):
        if best[f][0] == length:
            return f, best[f][1], best[f][2], length, best[f][3]
    return 0, 0, 0, 0, False
