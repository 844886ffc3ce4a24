"""GMAP output: the part GSNAP's GMAP rescue lanes need.

Only ``path_cigar_md`` of gmap_gsnap_tpu/io/gmap_out.py, copied (the
CIGAR, MD and NM of a GMAP hit printed by gsnap).  The ``gmap`` CLI's
output formats are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from ..align.gmap import MIN_INTRONLENGTH, Path


def path_cigar_md(path: Path, qstr: str, gstr: str, sam_mode: str = "gmap"):
    """CIGAR core (no clips) + MD + NM + intron presence for a GMAP
    path.  Exon blocks emit M, junctions emit N (genomic gap >=
    min_intronlength with canonical-ish dinucleotides, or > 50 nt =
    max_deletionlength), D (other genomic gaps), or I (query gaps).

    sam_mode: "gmap" = the gmap binary's printer (deletions in MD with
    '^', counted in NM); "gsnap" = gsnap's GMAP-method printer
    (samprint.c print_gmap: deletions absent from MD/NM)."""
    from ..align.gmap import intron_score

    cigar = []
    md = []
    run = 0
    nm = 0
    has_intron = False
    prev = None
    for e in path.exons:
        if prev is not None:
            dq = e.qstart - prev.qend
            dg = e.gstart - prev.gend
            if dq > 0:
                cigar.append(f"{dq}I")
                nm += dq
            intronp = False
            if dg >= MIN_INTRONLENGTH:
                gl = gstr[prev.gend : prev.gend + 2]
                gr = gstr[e.gstart - 2 : e.gstart]
                _, itype = intron_score(gl, gr, path.cdna_direction, 1, True)
                intronp = itype != "noncanonical" or dg > 50
            if intronp:
                cigar.append(f"{dg}N")
                has_intron = True
            elif dg > 0:
                cigar.append(f"{dg}D")
                if sam_mode == "gmap":
                    nm += dg
                    if run > 0:
                        md.append(str(run))
                    md.append("^" + gstr[prev.gend : e.gstart])
                    run = 0
                # gsnap mode: deletion invisible in MD/NM; runs merge
        if cigar and cigar[-1].endswith("M"):
            # merge adjacent M blocks (pure insertion junction)
            m = int(cigar.pop()[:-1]) + (e.qend - e.qstart)
            cigar.append(f"{m}M")
        else:
            cigar.append(f"{e.qend - e.qstart}M")
        boundary = prev is not None and md and md[-1].startswith("^")
        for q in range(e.qstart, e.qend):
            g = e.gstart + (q - e.qstart)
            qc = qstr[q]
            gc = gstr[g]
            if qc == gc or qc == "N":
                run += 1
            else:
                if run > 0 or (q == e.qstart and boundary) or not md:
                    md.append(str(run))
                md.append(gc)
                nm += 1
                run = 0
        prev = e
    if run > 0:
        md.append(str(run))
    if not md:
        md.append("0")
    return "".join(cigar), "".join(md), nm, has_intron
