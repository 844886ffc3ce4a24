"""GMAP output formats: Paths summary (default), GFF3 gene format, SAM.

Field layouts replicate the reference printers (gmap.c print_npaths /
Stage3_print_pathsummary, pair.c Pair_print_gff3) byte-for-byte on the
golden fixtures (tests/map.test.ok, gmap -f gff3_gene).

A copy of gmap_gsnap_tpu/io/gmap_out.py: every writer of the ``gmap``
CLI (``paths_output``, ``sam_record``, ``compressed_output``,
``psl_output``, the gff3, splice-site, intron, map and coords
writers, ``map_hits`` / ``map_hits_exons`` for -m) and
``path_cigar_md``, which gsnap's GMAP lanes print with; the port's
modules stand behind its relative imports.
"""

from __future__ import annotations

from ..align.gmap import Path, MIN_INTRONLENGTH
from ..align import translation as tr
from ..utils import dna


def _commafmt(n: int) -> str:
    return f"{n:,}"


def _translation_bounds(path: Path, qstr: str, gstr: str):
    """Translate the genomic side of the alignment columns; returns
    (leftpos, rightpos, aa_length) in 0-based query coords (forward
    cDNA direction), or None."""
    # genomic columns of the alignment in query order
    cols = []
    qpos_of_col = []
    for e in path.exons:
        seg = gstr[e.gstart : e.gend]
        if not path.watsonp:
            pass  # gstart..gend already in plus coords; see caller
        cols.append(seg)
        qpos_of_col.extend(range(e.qstart, e.qend))
    genome_cols = "".join(cols)
    # translate along the cDNA SENSE: plus-text direction >= 0 reads the
    # ascending columns, < 0 their reverse complement
    # (Translation_via_genomic forward/backward)
    n = len(genome_cols)
    if path.cdna_direction >= 0:
        aa_text = genome_cols
    else:
        aa_text = dna.revcomp_str(genome_cols)
    aa = tr.translate_forward(aa_text)
    frame, starti, endi, length, endstopp = tr.find_bounds_forward(aa)
    if length == 0:
        return None
    stop = endstopp and aa[endi] == "*"
    if stop:
        length -= 1
        e2 = min(starti + 3 * (length + 1) - 1, n - 1)
    else:
        # truncated ORFs: a 2-base trailing partial codon emits iff it
        # resolves WITHOUT the third base, i.e. a 4-fold codon family
        # (Translation_get_codon with c='X' — translate_pairs_* roll an
        # 'X' through the missing base and suppress 'X' codons at the
        # boundary); 1-base leftovers never emit
        leftover = n - starti - 3 * length
        pair2 = aa_text[starti + 3 * length : starti + 3 * length + 2]
        fourfold = {"CT", "GT", "TC", "CC", "AC", "GC", "CG", "GG"}
        if leftover == 2 and pair2 in fourfold:
            length += 1
            e2 = n - 1
        else:
            e2 = min(starti + 3 * length - 1, n - 1)
    if path.cdna_direction >= 0:
        col_s, col_e = starti, e2
    else:
        col_s, col_e = n - 1 - starti, n - 1 - e2
    L = path.querylength

    def readpos(col):
        qp = qpos_of_col[col]
        return qp if path.watsonp else L - 1 - qp

    return readpos(col_s), readpos(col_e), length


def _chimera_translation(paths, gstr):
    """Translate the merged chimeric cDNA (genomic columns of both
    parts in read order) and return (part_index, read_left, read_right,
    aa_len) of the longest ORF; truncated ORFs count the trailing
    partial codon (Translation_via_genomic chimera handling)."""
    from ..utils import dna as _dna

    txt = []
    readpos = []
    spans = []
    for pi, p in enumerate(paths):
        L = p.querylength
        seg = []
        qpos = []
        for e in p.exons:
            seg.append(gstr[e.gstart : e.gend])
            qpos.extend(range(e.qstart, e.qend))
        seg = "".join(seg)
        if not p.watsonp:
            seg = _dna.revcomp_str(seg)
            qpos = [L - 1 - q for q in reversed(qpos)]
        start = len(readpos)
        txt.append(seg)
        readpos.extend(qpos)
        spans.append((start, len(readpos), pi))
    text = "".join(txt)
    n = len(text)
    aa = tr.translate_forward(text)
    frame, starti, endi, length, endstopp = tr.find_bounds_forward(aa)
    if length == 0:
        return None, 0, 0, 0
    stop = endstopp and endi < len(aa) and aa[endi] == "*"
    if stop:
        length -= 1
        e2 = min(starti + 3 * (length + 1) - 1, n - 1)
    else:
        # truncated at the cDNA end: count the partial codon
        # (chimera merged translation keeps it, unlike the single-path
        # Translation_via_genomic rightpos)
        length = -(-(n - starti) // 3)
        e2 = n - 1
    part_i = next((pi for (a, b, pi) in spans if a <= starti < b), 0)
    return part_i, readpos[starti], readpos[e2], length


def chimera_aa_maps(paths, gstr):
    """Per-part ALIGNED-coordinate {qpos: aa-letter}/{qpos: ordinal}
    maps from the merged chimeric translation: the -A display continues
    ONE ORF across both parts with continuous numbering
    (Stage3_translate_chimera + Pair_print_alignment aa rows)."""
    from ..utils import dna as _dna

    txt = []
    readpos = []
    spans = []
    for pi, p in enumerate(paths):
        L = p.querylength
        seg = []
        qpos = []
        for e in p.exons:
            seg.append(gstr[e.gstart : e.gend])
            qpos.extend(range(e.qstart, e.qend))
        seg = "".join(seg)
        if not p.watsonp:
            seg = _dna.revcomp_str(seg)
            qpos = [L - 1 - q for q in reversed(qpos)]
        start = len(readpos)
        txt.append(seg)
        readpos.extend(qpos)
        spans.append((start, len(readpos), pi))
    text = "".join(txt)
    aa = tr.translate_forward(text)
    frame, starti, endi, length, endstopp = tr.find_bounds_forward(aa)
    maps = [({}, {}) for _ in paths]
    if length == 0:
        return maps
    num = 1
    for i in range(starti, endi + 1, 3):
        pi = next(p for (a, b, p) in spans if a <= i < b)
        p = paths[pi]
        q = (readpos[i] if p.watsonp
             else p.querylength - 1 - readpos[i])
        maps[pi][0][q] = aa[i]
        maps[pi][1][q] = num
        num += 1
    return maps


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


def sam_record(path: Path | None, qname: str, seq: str, qual: str | None,
               chrname: str, chr_start: int, qstr: str, gstr: str,
               nh: int = 1, hi: int = 1, mapq: int = 40,
               hardclip: bool = False, sm: int | None = None,
               extra: list | None = None,
               xq: int = 40, x2: int = 0) -> str:
    """One SAM line for a GMAP path (gmap -f samse; Pair_print_sam,
    pair.c).  Query ends outside the path soft-clip.  Tag set matches
    gsnap: MD/NH/HI/NM/SM/XQ/X2 (+XS splice strand when introns
    exist)."""
    if path is None:
        q = qual if qual else "*"
        return "\t".join([qname, "4", "*", "0", "0", "*", "*", "0", "0",
                          seq.upper(), q]) + "\n"

    L = path.querylength
    flag = 0 if path.watsonp else 16
    out_seq = qstr  # aligned-orientation sequence
    out_qual = (qual if path.watsonp else qual[::-1]) if qual else "*"

    core, mds, nm, has_intron = path_cigar_md(path, qstr, gstr)
    clip = "H" if hardclip else "S"
    cigar = []
    if path.qstart:
        cigar.append(f"{path.qstart}{clip}")
    cigar.append(core)
    if path.qend < L:
        cigar.append(f"{L - path.qend}{clip}")
    md = [mds]
    if hardclip:
        # hard-clipped halves (chimera parts) carry only the aligned
        # slice of SEQ/QUAL (Pair_print_sam with hardclips)
        out_seq = out_seq[path.qstart : path.qend]
        if out_qual != "*":
            out_qual = out_qual[path.qstart : path.qend]

    pos = path.gstart - chr_start + 1
    fields = [
        qname, str(flag), chrname, str(pos), str(mapq), "".join(cigar),
        "*", "0", "0", out_seq, out_qual,
        "MD:Z:" + "".join(md),
        f"NH:i:{nh}", f"HI:i:{hi}", f"NM:i:{nm}",
        f"SM:i:{mapq if sm is None else sm}", f"XQ:i:{xq}", f"X2:i:{x2}",
    ]
    if has_intron:
        # cdna_direction is in aligned space: +1 <=> GT-AG on plus
        # genome; indeterminate direction prints '?' (Pair_print_sam)
        xs = ("?" if path.cdna_direction == 0
              else ("+" if path.cdna_direction > 0 else "-"))
        fields.append(f"XS:A:{xs}")
    if extra:
        fields.extend(extra)
    return "\t".join(fields) + "\n"


def _transcript_exons(path: Path):
    """Exons in transcript order with 1-based (start, end) coordinate
    pairs oriented by strand (descending for minus paths)."""
    if path.watsonp:
        return [(e.gstart + 1, e.gend) for e in path.exons]
    return [(e.gend, e.gstart + 1) for e in reversed(path.exons)]


def splicesites_output(path: Path, label: str, chrname: str) -> str:
    """gmap -f splicesites (Pair_print_splicesites, pair.c)."""
    exons = _transcript_exons(path)
    n = len(exons)
    out = []
    for i in range(n - 1):
        if path.watsonp:
            hi = exons[i][1]
            lo_next = exons[i + 1][0]
            d = lo_next - hi - 1
            out.append(f">{label}.exon{i+1}/{n} {chrname}:{hi}..{hi+1} donor {d}")
            out.append(f">{label}.exon{i+2}/{n} {chrname}:{lo_next-1}..{lo_next} acceptor {d}")
        else:
            lo = exons[i][1]
            hi_next = exons[i + 1][0]
            d = lo - hi_next - 1
            out.append(f">{label}.exon{i+1}/{n} {chrname}:{lo}..{lo-1} donor {d}")
            out.append(f">{label}.exon{i+2}/{n} {chrname}:{hi_next+1}..{hi_next} acceptor {d}")
    return "".join(l + "\n" for l in out)


def introns_output(path: Path, label: str, chrname: str) -> str:
    """gmap -f introns."""
    exons = _transcript_exons(path)
    n = len(exons)
    out = []
    for i in range(n - 1):
        out.append(
            f">{label}.intron{i+1}/{n-1} {chrname}:{exons[i][1]}..{exons[i+1][0]}"
        )
    return "".join(l + "\n" for l in out)


def map_output(path: Path, label: str, header: str, chrname: str,
               with_exons: bool, chr_start: int = 0) -> str:
    """gmap -f map_genes / map_exons (IIT FASTA map format);
    chromosome-relative coordinates."""
    exons = [(a - chr_start, b - chr_start)
             for a, b in _transcript_exons(path)]
    lo, hi = exons[0][0], exons[-1][1]
    out = [f">{label} {chrname}:{lo}..{hi}", header]
    if with_exons:
        for a, b in exons:
            out.append(f"{a} {b}")
    return "".join(l + "\n" for l in out)


def psl_output(path: Path, label: str, chrname: str, chr_start: int,
               chrlength: int) -> str:
    """gmap -f psl (Pair_print_pslformat_nt, pair.c)."""
    matches = path.matches
    mismatches = path.mismatches
    qinserts = sum(
        max(0, b.qstart - a.qend) for a, b in zip(path.exons, path.exons[1:])
    )
    nq = sum(
        1 for a, b in zip(path.exons, path.exons[1:]) if b.qstart > a.qend
    )
    tgaps = [
        b.gstart - a.gend for a, b in zip(path.exons, path.exons[1:])
        if b.gstart > a.gend
    ]
    L = path.querylength
    strand = "+" if path.watsonp else "-"
    qstart, qend = path.qstart, path.qend
    if not path.watsonp:
        qstart, qend = L - path.qend, L - path.qstart
    fields = [
        matches, mismatches, 0, 0, nq, qinserts, len(tgaps), sum(tgaps),
        strand, label, L, qstart, qend,
        chrname, chrlength,
        path.gstart - chr_start, path.gend - chr_start,
        len(path.exons),
        ",".join(str(e.qend - e.qstart) for e in path.exons) + ",",
        ",".join(str(e.qstart) for e in path.exons) + ",",
        ",".join(str(e.gstart - chr_start) for e in path.exons) + ",",
    ]
    return "\t".join(str(f) for f in fields) + "\n"


_INTRON_CHAR = {"canonical": ">", "gcag": ")", "atac": "]", "noncanonical": "="}
_INTRON_CHAR_REV = {"canonical": "<", "gcag": "(", "atac": "[", "noncanonical": "="}


def compressed_output(path: Path, label: str, pathnum: int, npaths: int,
                      chrname: str, chr_start: int, qstr: str = "",
                      gstr: str = "", dbname: str | None = None) -> str:
    """gmap -Z compressed format (Pair_print_compressed, pair.c:6203).

    Exon blocks are intron-delimited; mismatches ({run}x{base}),
    insertions ({run}^{base}) and deletions ({run}v) break the match
    runlength into tokens, identical consecutive tokens collapse as
    token!count, and each block ends {run}{intron_char} or {run}*.
    Non-GT-AG introns append their dinucleotides; the header identity
    counts indels in the denominator (Stage3_fracidentity)."""
    L = path.querylength
    cov = path.coverage()
    g1 = path.gstart - chr_start + 1
    g2 = path.gend - chr_start
    ug1, ug2 = path.gstart + 1, path.gend
    dbn = dbname or chrname
    fwd_disp = (path.cdna_direction >= 0) == path.watsonp
    has_intron = False

    exons = path.exons if path.watsonp else list(reversed(path.exons))
    itypes = list(path.intron_types or ())
    if not path.watsonp:
        itypes = list(reversed(itypes))

    # classify display junctions
    juncs = []
    for i in range(len(exons) - 1):
        e, nxt = exons[i], exons[i + 1]
        if path.watsonp:
            dq = nxt.qstart - e.qend
            dg = nxt.gstart - e.gend
            istart, iend = e.gend, nxt.gstart
        else:
            dq = e.qstart - nxt.qend
            dg = e.gstart - nxt.gend
            istart, iend = nxt.gend, e.gstart
        it = itypes[i] if i < len(itypes) else "noncanonical"
        intronp = dg >= MIN_INTRONLENGTH and (it != "noncanonical" or dg > 50)
        juncs.append((dq, dg, intronp, it, istart, iend))
    if any(j[2] for j in juncs):
        has_intron = True

    # header identity counts indel bases in the denominator
    # (Stage3_fracidentity)
    nindel = sum(j[0] + (0 if j[2] else j[1]) for j in juncs)
    den = path.matches + path.mismatches + nindel
    pct = 100.0 * path.matches / max(1, den)

    sense = ("sense" if path.cdna_direction > 0 else "antisense"
             ) if has_intron and path.cdna_direction else "indet"
    if not path.watsonp and sense != "indet":
        sense = "antisense" if sense == "sense" else "sense"
    if path.watsonp:
        hdr = (f">{label} {dbn} {pathnum}/{npaths} {L} ")
        qh = f"{path.qstart+1}..{path.qend}"
        gh = f"{g1}..{g2}"
        ugh = f"{ug1}..{ug2}"
        strand = "+"
    else:
        hdr = (f">{label} {dbn} {pathnum}/{npaths} {L} ")
        qh = f"{L-path.qend+1}..{L-path.qstart}"
        gh = f"{g2}..{g1}"
        ugh = f"{ug2}..{ug1}"
        strand = "-"

    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}

    def qdisp(qp):
        c = qstr[qp] if qstr else "N"
        return c if path.watsonp else comp.get(c, "N")

    # regions split at intron junctions
    regions = []
    cur = [0]
    for i, j in enumerate(juncs):
        if j[2]:
            regions.append(cur)
            cur = []
        cur.append(i + 1)
    regions.append(cur)

    nexons_hdr = len(regions)
    hdr += (f"{nexons_hdr} {cov:.1f} {pct:.1f} {qh} {ugh} "
            f"{chrname}:{gh} {strand} dir:{sense}")
    out = [hdr]

    table = _INTRON_CHAR if fwd_disp else _INTRON_CHAR_REV
    for rno, idxs in enumerate(regions):
        tokens = []
        run = 0
        num = rden = 0
        for k, i in enumerate(idxs):
            e = exons[i]
            if k > 0:
                dq, dg, _, _, _, _ = juncs[idxs[k - 1]]
                # indel junction inside the region, display order
                ins_span = (range(exons[i].qstart - dq, exons[i].qstart)
                            if path.watsonp else
                            range(exons[i].qend, exons[i].qend + dq))
                if path.watsonp:
                    for qp in ins_span:
                        tokens.append(f"{run}^{qdisp(qp)}")
                        run = 0
                    for _ in range(dg):
                        tokens.append(f"{run}v")
                        run = 0
                else:
                    for qp in reversed(list(ins_span)):
                        tokens.append(f"{run}^{qdisp(qp)}")
                        run = 0
                    for _ in range(dg):
                        tokens.append(f"{run}v")
                        run = 0
            # exon columns in display order
            cols = range(e.qstart, e.qend)
            if not path.watsonp:
                cols = reversed(list(cols))
            for qp in cols:
                g = e.gstart + (qp - e.qstart)
                qc = qstr[qp] if qstr else "N"
                gc = gstr[g] if gstr else "N"
                rden += 1
                if qc == gc or qc == "N":
                    num += 1
                    run += 1
                else:
                    tokens.append(f"{run}x{qdisp(qp)}")
                    run = 0
        # region coordinates
        res = [exons[i] for i in idxs]
        if path.watsonp:
            ga = res[0].gstart - chr_start + 1
            gb = res[-1].gend - chr_start
            qa = res[0].qstart + 1
            qb = res[-1].qend
        else:
            ga = res[0].gend - chr_start
            gb = res[-1].gstart - chr_start + 1
            qa = L - res[0].qend + 1
            qb = L - res[-1].qstart
        epct = int(100.0 * num / max(1, rden))
        last_intron = ""
        if rno < len(regions) - 1:
            dq, dg, _, it, istart, iend = juncs[idxs[-1]]
            ch = table.get(it, "=")
            tokens.append(f"{run}{ch}")
            last_intron = f"\t{dg}"
            if it != "canonical":
                dd = (gstr[istart : istart + 2] if gstr else "NN").upper()
                aa = (gstr[iend - 2 : iend] if gstr else "NN").upper()
                if not fwd_disp:
                    dd, aa = (dna.revcomp_str(aa), dna.revcomp_str(dd))
                if not (dd == "GT" and aa == "AG"):
                    last_intron += f"\t{dd}-{aa}"
        else:
            tokens.append(f"{run}*")
        # collapse identical consecutive tokens
        parts = []
        lastt, count = None, 0
        for t in tokens:
            if t == lastt:
                count += 1
            else:
                if lastt is not None:
                    parts.append(lastt + (f"!{count}" if count > 1 else ""))
                lastt, count = t, 1
        if lastt is not None:
            parts.append(lastt + (f"!{count}" if count > 1 else ""))
        out.append(f"\t{ga} {gb} {qa} {qb} {epct}\t"
                   + " ".join(parts) + f"\t{qb - qa + 1}" + last_intron)
    return "".join(l + "\n" for l in out)


def path_summary(
    path: Path,
    pathnum: int,
    chrname: str,
    chrlength: int,
    qstr: str,
    gstr: str,
    dbmode: bool = True,
    translate: bool = True,
    trans_override: "tuple | None" = None,
    dbname: str | None = None,
    chr_start: int = 0,
) -> str:
    """One 'Path N:' block (gmap default output).  'Path N:' and
    'Accessions:' print CHROMOSOME-relative coordinates; 'Genomic pos:'
    prints the DB name with UNIVERSAL coordinates
    (Stage3_print_pathsummary); dbname defaults to chrname."""
    out = []
    ugs, uge = path.gstart + 1, path.gend
    gs, ge = ugs - chr_start, uge - chr_start
    if not path.watsonp:
        gs, ge = ge, gs
        ugs, uge = uge, ugs
    # genomiclength prints signed: minus-strand displays descend
    span = ge - gs + (1 if path.watsonp else -1)
    chrpfx = f"{chrname}:" if dbmode else ""
    out.append(
        f"  Path {pathnum}: query {path.qstart + 1}..{path.qend} "
        f"({path.qend - path.qstart} bp) => genome {chrpfx}"
        f"{_commafmt(gs)}..{_commafmt(ge)} ({span} bp)\n"
    )
    # Path.cdna_direction is plus-text relative (GT..AG on plus = +1);
    # the cDNA's own sense flips on the minus strand
    ddir = path.cdna_direction if path.watsonp else -path.cdna_direction
    sense = "sense" if ddir > 0 else (
        "antisense" if ddir < 0 else "indeterminate")
    out.append(f"    cDNA direction: {sense}\n")
    strand = "+" if path.watsonp else "-"
    dbpfx = f"{dbname}:" if dbname else chrpfx
    out.append(
        f"    Genomic pos: {dbpfx}{_commafmt(ugs)}..{_commafmt(uge)} ({strand} strand)\n"
    )
    if dbmode:
        alo, ahi = min(gs, ge), max(gs, ge)
        out.append(
            f"    Accessions: {chrpfx}{_commafmt(alo)}..{_commafmt(ahi)} "
            f"(out of {chrlength} bp)\n"
        )
    out.append(f"    Number of exons: {len(path.exons)}\n")
    out.append(
        f"    Coverage: {path.coverage():.1f} (query length: {path.querylength} bp)\n"
    )
    out.append(
        f"    Trimmed coverage: {path.coverage():.1f} "
        f"(trimmed length: {path.querylength} bp, trimmed region: 1..{path.querylength})\n"
    )
    unknowns = 0
    out.append(
        f"    Percent identity: {path.identity():.1f} "
        f"({path.matches} matches, {path.mismatches} mismatches, "
        f"{path.indels} indels, {unknowns} unknowns)\n"
    )
    tb = _translation_bounds(path, qstr, gstr) if translate else None
    if trans_override is not None:
        tb = trans_override
    if tb is not None:
        left, right, aalen = tb
        out.append(f"    Translation: {left + 1}..{right + 1} "
                   f"({aalen} aa)\n")
    out.append("    Amino acid changes: \n")
    return "".join(out)


def paths_output(
    header: str,
    paths: list[Path],
    chrname: str,
    chrlength: int,
    qstr: str,
    gstr: str,
    dbmode: bool = True,
    chimera_pos: int | None = None,
    read: str | None = None,
    maxpaths: int | None = None,
    chrinfo: "list[tuple] | None" = None,
    dbname: str | None = None,
    chr_start: int = 0,
    chrsubset_label: str | None = None,
) -> str:
    """maxpaths limits the printed 'Path N:' blocks while the header
    still reports the true path count (gmap -n; observed: -n 1 on a
    2-path query prints 'Paths (2):' with one block).  chrinfo gives
    per-path (chrname, chrlength) for multi-chromosome path lists."""
    out = [f">{header}\n"]
    sub = (f"  [chrsubset: {chrsubset_label}]"
           if chrsubset_label else "")
    if chimera_pos is not None:
        out.append(f"Paths ({len(paths)}):{sub} *** Possible chimera "
                   f"with breakpoint at {chimera_pos + 1}\n")
    else:
        out.append(f"Paths ({len(paths)}):{sub}\n")
    # chimeras translate the FULL cDNA once (Stage3_translate_chimera)
    # and assign the ORF to the part containing its start, printing
    # PART-relative coordinates
    overrides = [None] * len(paths)
    if chimera_pos is not None and len(paths) > 1:
        part_i, l, r, aalen = _chimera_translation(paths, gstr)
        if part_i is not None:
            p = paths[part_i]
            toff = p.qstart if p.watsonp else p.querylength - p.qend
            overrides[part_i] = (l - toff, r - toff, aalen)
    shown = paths if maxpaths is None else paths[:maxpaths]
    for i, p in enumerate(shown):
        pq = qstr
        if read is not None:
            from ..utils import dna as _dna
            pq = read if p.watsonp else _dna.revcomp_str(read)
        if i > 0:
            out.append("\n")
        if chrinfo is None:
            cn, cl, cs = chrname, chrlength, chr_start
        else:
            cn, cl = chrinfo[i][0], chrinfo[i][1]
            cs = chrinfo[i][2] if len(chrinfo[i]) > 2 else 0
        out.append(path_summary(
            p, i + 1, cn, cl, pq, gstr, dbmode,
            translate=False if chimera_pos is not None else True,
            trans_override=overrides[i], dbname=dbname, chr_start=cs))
    out.append("\n")
    return "".join(out)


# ------------------------------------------------------------------- GFF3

def gff3_gene(
    path: Path,
    pathnum: int,
    accession: str,
    chrname: str,
    dbname: str,
    qstr: str,
    gstr: str,
    chr_start: int = 0,
) -> str:
    """gff3_gene format (pair.c Pair_print_gff3 gene/mRNA/exon/CDS);
    coordinates are chromosome-relative."""
    out = []
    strand = "+" if path.watsonp else "-"
    gs, ge = path.gstart - chr_start + 1, path.gend - chr_start
    gene_id = f"{accession}.path{pathnum}"
    mrna_id = f"{accession}.mrna{pathnum}"
    out.append(
        f"{chrname}\t{dbname}\tgene\t{gs}\t{ge}\t.\t{strand}\t.\t"
        f"ID={gene_id};Name={accession}\n"
    )
    out.append(
        f"{chrname}\t{dbname}\tmRNA\t{gs}\t{ge}\t.\t{strand}\t.\t"
        f"ID={mrna_id};Name={accession};Parent={gene_id};"
        f"Coverage={path.coverage():.1f};Identity={path.identity():.1f}\n"
    )
    qstrand = "+"  # query target strand always + in gff3 Target
    # minus-strand paths list exons in query order (descending genomic)
    exon_order = path.exons if path.watsonp else list(reversed(path.exons))
    for i, e in enumerate(exon_order):
        pct = round(100.0 * e.matches / max(1, e.matches + e.mismatches))
        if path.watsonp:
            tq1, tq2 = e.qstart + 1, e.qend
        else:
            tq1, tq2 = path.querylength - e.qend + 1, path.querylength - e.qstart
        out.append(
            f"{chrname}\t{dbname}\texon\t{e.gstart - chr_start + 1}\t"
            f"{e.gend - chr_start}\t{pct}\t{strand}\t.\t"
            f"ID={mrna_id}.exon{i + 1};Name={accession};Parent={mrna_id};"
            f"Target={accession} {tq1} {tq2} {qstrand}\n"
        )
    # CDS from translation bounds
    tb = _translation_bounds(path, qstr, gstr)
    if tb is not None:
        left, right, _ = tb
        cdsnum = 0
        cum = 0
        for i, e in enumerate(exon_order):
            lo = max(e.qstart, left)
            hi = min(e.qend, right + 1)
            if lo >= hi:
                continue
            cdsnum += 1
            g1 = e.gstart - chr_start + (lo - e.qstart) + 1
            g2 = e.gstart - chr_start + (hi - e.qstart)
            pct = round(100.0 * e.matches / max(1, e.matches + e.mismatches))
            # the reference prints the codon carry (cds_phase), not the
            # GFF3-spec "bases to remove" phase
            phase = cum % 3
            cum += hi - lo
            if path.watsonp:
                tq1, tq2 = lo + 1, hi
            else:
                tq1, tq2 = path.querylength - hi + 1, path.querylength - lo
            out.append(
                f"{chrname}\t{dbname}\tCDS\t{g1}\t{g2}\t{pct}\t{strand}\t{phase}\t"
                f"ID={mrna_id}.cds{cdsnum};Name={accession};Parent={mrna_id};"
                f"Target={accession} {tq1} {tq2} {qstrand}\n"
            )
    return "".join(out)


def _junction_runs(path: Path, qstr: str, gstr: str):
    """Classify aligned-order junctions like path_cigar_md: returns a
    list (len = nexons-1) of run lists, e.g. [("I", 5)], [("N", 6678)],
    [("D", 5)] (a junction can carry both an I and a D run)."""
    from ..align.gmap import intron_score

    runs = []
    prev = None
    for e in path.exons:
        if prev is not None:
            j = []
            dq = e.qstart - prev.qend
            dg = e.gstart - prev.gend
            if dq > 0:
                j.append(("I", dq))
            intronp = False
            if dg >= MIN_INTRONLENGTH:
                gl = gstr[prev.gend : prev.gend + 2]
                gr = gstr[e.gstart - 2 : e.gstart]
                _, itype = intron_score(gl, gr, path.cdna_direction, 1, True)
                intronp = itype != "noncanonical" or dg > 50
            if intronp:
                j.append(("N", dg))
            elif dg > 0:
                j.append(("D", dg))
            runs.append(j)
        prev = e
    return runs


def gff3_match(path: Path, pathnum: int, accession: str, chrname: str,
               dbname: str, qstr: str, gstr: str, est: bool,
               chr_start: int = 0) -> str:
    """gff3_match_cdna / gff3_match_est (Pair_print_gff3 cDNA_match /
    EST_match): match regions with CIGAR-style Gap attributes.

    cDNA_match: one line per intron-delimited region in READ order,
    indels inside a region folded into the Gap.  EST_match: a single
    line spanning the whole path with N runs, genomic-ascending Gap,
    query strand in Target, Coverage/Identity attributes."""
    out = []
    gid = f"{accession}.path{pathnum}"
    L = path.querylength
    runs = _junction_runs(path, qstr, gstr)

    def pct(matches, mismatches, extra):
        den = matches + mismatches + extra
        return int(100.0 * matches / max(1, den))

    if est:
        gap = []
        extra = 0
        for i, e in enumerate(path.exons):
            if i > 0:
                for kind, n in runs[i - 1]:
                    gap.append(f"{kind}{n}")
                    if kind != "N":
                        extra += n
            gap.append(f"M{e.qend - e.qstart}")
        # merge adjacent M runs (pure-I junctions leave two M entries)
        merged = []
        for r in gap:
            if merged and r[0] == "M" and merged[-1][0] == "M":
                merged[-1] = f"M{int(merged[-1][1:]) + int(r[1:])}"
            else:
                merged.append(r)
        glo = path.exons[0].gstart - chr_start + 1
        ghi = path.exons[-1].gend - chr_start
        tstrand = "+" if path.watsonp else "-"
        sc = pct(path.matches, path.mismatches, extra)
        # strand column carries the cDNA direction sign (plus-text
        # convention); intron-less paths are indeterminate ('?')
        if not any(r[0] == "N" for r in merged):
            gstrand = "?"
        else:
            gstrand = ("+" if path.cdna_direction > 0
                       else "-" if path.cdna_direction < 0 else "?")
        den = max(1, path.matches + path.mismatches + extra)
        identity = 100.0 * path.matches / den
        out.append(
            f"{chrname}\t{dbname}\tEST_match\t{glo}\t{ghi}\t{sc}\t{gstrand}\t.\t"
            f"ID={gid};Name={accession};Target={accession} 1 {L} {tstrand};"
            f"Gap={' '.join(merged)};Coverage={path.coverage():.1f};"
            f"Identity={identity:.1f}\n")
        return "".join(out)

    # cDNA_match: display (read) order, split at N junctions
    exons = list(path.exons)
    druns = list(runs)
    if not path.watsonp:
        exons = list(reversed(exons))
        druns = list(reversed(druns))
    strand = "+" if path.watsonp else "-"
    region = []  # list of (exon, following_runs)
    regions = []
    for i, e in enumerate(exons):
        region.append(e)
        j = druns[i] if i < len(druns) else [("N", 0)]
        if i == len(exons) - 1 or any(k == "N" for k, _ in j):
            regions.append((region, ))
            region = []
    for (res,) in regions:
        gap = []
        matches = mism = extra = 0
        for i, e in enumerate(res):
            if i > 0:
                # junction runs between res[i-1] and res[i] in read order
                idx = exons.index(res[i - 1])
                j = druns[idx]
                for kind, n in (j if path.watsonp else reversed(j)):
                    gap.append(f"{kind}{n}")
                    extra += n
            gap.append(f"M{e.qend - e.qstart}")
            matches += e.matches
            mism += e.mismatches
        merged = []
        for r in gap:
            if merged and r[0] == "M" and merged[-1][0] == "M":
                merged[-1] = f"M{int(merged[-1][1:]) + int(r[1:])}"
            else:
                merged.append(r)
        glo = min(e.gstart for e in res) - chr_start + 1
        ghi = max(e.gend for e in res) - chr_start
        if path.watsonp:
            q1 = res[0].qstart + 1
            q2 = res[-1].qend
        else:
            q1 = L - res[0].qend + 1
            q2 = L - res[-1].qstart
        sc = pct(matches, mism, extra)
        out.append(
            f"{chrname}\t{dbname}\tcDNA_match\t{glo}\t{ghi}\t{sc}\t{strand}\t.\t"
            f"ID={gid};Name={accession};Target={accession} {q1} {q2};"
            f"Gap={' '.join(merged)}\n")
    return "".join(out)


def coords_output(path: Path, header: str, qstr: str, gstr: str,
                  chrname: str, chr_start: int) -> str:
    """gmap -f coords (Pair_print_coordinates, pair.c:1055): one row
    per aligned pair in READ order.  Translation bookkeeping follows
    the reference's dual phases: aapos and the genome-side letter
    (aaphase_g) advance with GENOME bases, the query-side letter
    (aaphase_e) with QUERY bases, so indels desynchronize the frames.
    Insertion rows freeze the genome position, deletion rows print a
    blank cDNA char at the frozen query position."""
    out = [f">{header}\n"]
    L = path.querylength
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}

    # column stream in ALIGNED order: (kind, qp, gp)
    cols = []
    prev = None
    for e in path.exons:
        if prev is not None:
            for k in range(prev.qend, e.qstart):        # insertion
                cols.append(("I", k, e.gstart))
            if 0 < e.gstart - prev.gend < MIN_INTRONLENGTH:
                for g in range(prev.gend, e.gstart):    # deletion
                    cols.append(("D", e.qstart, g))
        for k in range(e.qend - e.qstart):
            cols.append(("M", e.qstart + k, e.gstart + k))
        prev = e

    # sense order (translation direction over the plus text)
    fwd = path.cdna_direction >= 0
    sense_cols = cols if fwd else list(reversed(cols))
    qseq_parts = []
    gseq_parts = []
    iq_of = [None] * len(sense_cols)
    ig_of = [None] * len(sense_cols)
    for i, (kind, qp, gp) in enumerate(sense_cols):
        qc = qstr[qp] if fwd else comp.get(qstr[qp], "N")
        gc = gstr[gp] if fwd else comp.get(gstr[gp], "N")
        if kind != "D":
            iq_of[i] = len(qseq_parts)
            qseq_parts.append(qc)
        if kind != "I":
            ig_of[i] = len(gseq_parts)
            gseq_parts.append(gc)
    qseq_s = "".join(qseq_parts)
    gseq_s = "".join(gseq_parts)

    tb = _translation_bounds(path, qstr, gstr)
    s_q = s_g = None
    ncod = 0
    if tb is not None:
        a0, b0, naa = tb
        span = abs(b0 - a0) + 1
        ncod = naa + (1 if span > 3 * naa else 0)  # stop codon included
        for i, (kind, qp, gp) in enumerate(sense_cols):
            if kind == "D":
                continue
            rp = qp if path.watsonp else L - 1 - qp
            if rp == a0:
                s_q = iq_of[i]
                s_g = ig_of[i]
                break
    have_orf = s_q is not None and s_g is not None

    def aa_of(seq, i):
        c = seq[i : i + 3]
        if len(c) < 3:
            return "X"
        return tr.get_codon(c[0], c[1], c[2])

    # query-side letters (aa_e): assigned codon-by-codon from each
    # genomic codon start while frames stay in sync; an out-of-frame
    # indel assigns one stretched run of codons, then stops aa_e
    # assignment for the rest of the alignment (translation.c
    # mark_cdna_forward irregular branches)
    qletter_cols = set()
    if have_orf:
        gstarts = [i for i, (kind, qp, gp) in enumerate(sense_cols)
                   if kind == "M" and ig_of[i] is not None
                   and 0 <= ig_of[i] - s_g < 3 * ncod
                   and (ig_of[i] - s_g) % 3 == 0]
        qcols = [i for i, (kind, _, _) in enumerate(sense_cols)
                 if kind != "D"]
        qindex = {i: n for n, i in enumerate(qcols)}
        sync = True
        for a, b in zip(gstarts, gstarts[1:] + [None]):
            if not sync:
                break
            qa = qindex[a]
            count = (qindex[b] - qa) if b is not None else 3
            if count == 3:
                qletter_cols.add(a)
            elif count % 3 == 0:
                for off in range(0, count, 3):
                    qletter_cols.add(qcols[qa + off])
            else:
                for off in range(0, ((count + 2) // 3) * 3, 3):
                    if qa + off < len(qcols):
                        qletter_cols.add(qcols[qa + off])
                sync = False

    # annotate each SENSE column with (f1num, f1letter, f4letter)
    ann = {}
    prev_g = -1
    for i, (kind, qp, gp) in enumerate(sense_cols):
        ig = ig_of[i] if ig_of[i] is not None else prev_g
        if ig_of[i] is not None:
            prev_g = ig
        f1num, f1letter, f4 = 0, "", ""
        if have_orf:
            off_g = (ig - s_g) if kind != "I" else (prev_g - s_g)
            if off_g < 0:
                f1num = 0
            elif off_g >= 3 * ncod:
                f1num = ncod
            else:
                f1num = off_g // 3 + 1
                if i in qletter_cols or (
                    kind == "I" and i in qletter_cols):
                    f1letter = aa_of(qseq_s, iq_of[i])
                if kind != "I" and off_g % 3 == 0:
                    f4 = aa_of(gseq_s, ig)
        ann[(kind, qp, gp)] = (f1num, f1letter, f4)

    # emit in DISPLAY (read) order
    sign = "+" if path.watsonp else "-"
    disp = cols if path.watsonp else list(reversed(cols))
    for kind, qp, gp in disp:
        f1num, f1letter, f4 = ann[(kind, qp, gp)]
        if path.watsonp:
            qdisp = qstr[qp] if kind != "D" else " "
            gdisp = gstr[gp] if kind != "I" else " "
        else:
            qdisp = comp.get(qstr[qp], "N") if kind != "D" else " "
            gdisp = comp.get(gstr[gp], "N") if kind != "I" else " "
        rp = (qp + 1) if path.watsonp else (L - qp)
        glocal = gp - chr_start + 1
        gabs = gp + 1
        f1 = f"{f1num} {f1letter}" if f1letter else str(f1num)
        out.append(f"{f1}\t{rp} {qdisp}\t{sign}{chrname}:{glocal} "
                   f"{gabs} {gdisp}\t{f4}\n")
    return "".join(out)


def map_hits_exons(path, pathnum: int, iit, mapname: str, chrname: str,
                   chr_start: int, bothstrands: bool = False,
                   print_comment: bool = False) -> str:
    """gmap -e/--mapexons: one 'Map hits for path N, exon E' block per
    exon in display order (stage3.c:4674 print_exon_map; exon bounds
    from Pair_exonbounds, minus-strand paths iterate descending)."""
    if chrname not in iit.intervals and "" not in iit.intervals:
        return f"  *Map hits for path {pathnum} (0):\n\n"
    div = chrname if chrname in iit.intervals else ""
    ivs = iit.intervals.get(div, [])
    labels = iit.labels.get(div, [])
    anns = iit.annotations.get(div, [])
    sign = 1 if path.watsonp else -1

    def hit_line(i):
        iv = ivs[i]
        lo, hi = (iv.low, iv.high) if iv.sign >= 0 else (iv.high, iv.low)
        out = f"\t{mapname}\t{chrname}:{lo}..{hi}\t{labels[i]}"
        if print_comment:
            ann = anns[i].decode("ascii", "replace") if i < len(anns) else ""
            if iit.version >= 5:
                ann = ann.split("\n", 1)[1] if "\n" in ann else ""
            out += "\t" + ann.split("\n", 1)[0]
        return out + "\n"

    exons = path.exons if path.watsonp else list(reversed(path.exons))
    out = []
    for en, e in enumerate(exons):
        chrlow = e.gstart - chr_start + 1
        chrhigh = e.gend - chr_start
        if bothstrands:
            matches = [i for i, iv in enumerate(ivs)
                       if iv.low <= chrhigh and iv.high >= chrlow]
        else:
            matches = sorted(
                (i for i, iv in enumerate(ivs)
                 if iv.low <= chrhigh and iv.high >= chrlow
                 and (iv.sign == 0 or iv.sign == sign)),
                key=lambda i: (ivs[i].low, ivs[i].high))
        out.append(f"  Map hits for path {pathnum}, exon {en + 1} "
                   f"({len(matches)}):\n")
        out.extend(hit_line(i) for i in matches)
        out.append("\n")
    return "".join(out)


def map_hits(path, pathnum: int, iit, mapname: str, chrname: str,
             chr_start: int, bothstrands: bool = False,
             nflanking: int = 0, print_comment: bool = False) -> str:
    """gmap -m map annotation: 'Map hits for path N' section
    (stage3.c:4580-4665 print_map + iit-read.c:5208-5300 print_header).

    Signed queries (default) keep only intervals matching the path's
    strand, sorted by position; -b keeps both strands in record order;
    -u prints the nearest flanking entries on each side."""
    div = chrname if chrname in iit.intervals else ""
    ivs = iit.intervals.get(div, [])
    if chrname not in iit.intervals and "" not in iit.intervals:
        return f"  *Map hits for path {pathnum} (0):\n\n"
    labels = iit.labels.get(div, [])
    anns = iit.annotations.get(div, [])
    chrlow = path.gstart - chr_start + 1
    chrhigh = path.gend - chr_start
    sign = 1 if path.watsonp else -1

    def hit_line(i):
        iv = ivs[i]
        lo, hi = (iv.low, iv.high) if iv.sign >= 0 else (iv.high, iv.low)
        out = f"\t{mapname}\t{chrname}:{lo}..{hi}\t{labels[i]}"
        if print_comment:
            ann = anns[i].decode("ascii", "replace") if i < len(anns) else ""
            if iit.version >= 5:
                # v5 annotations carry the rest-of-header as their first
                # line; the printed comment is the CONTENT after it
                # (IIT_annotation, iit-read.c)
                ann = ann.split("\n", 1)[1] if "\n" in ann else ""
            out += "\t" + ann.split("\n", 1)[0]
        return out + "\n"

    if bothstrands:
        matches = [i for i, iv in enumerate(ivs)
                   if iv.low <= chrhigh and iv.high >= chrlow]
    else:
        matches = sorted(
            (i for i, iv in enumerate(ivs)
             if iv.low <= chrhigh and iv.high >= chrlow
             and (iv.sign == 0 or iv.sign == sign)),
            key=lambda i: (ivs[i].low, ivs[i].high))
    left = right = []
    if nflanking > 0:
        fsign = 0 if bothstrands else sign
        left = sorted(
            (i for i, iv in enumerate(ivs)
             if iv.high < chrlow and (fsign == 0 or iv.sign == fsign)),
            key=lambda i: -ivs[i].high)[:nflanking]
        right = sorted(
            (i for i, iv in enumerate(ivs)
             if iv.low > chrhigh and (fsign == 0 or iv.sign == fsign)),
            key=lambda i: ivs[i].low)[:nflanking]
        head = (f"  Map hits for path {pathnum} "
                f"({len(left)}|{len(matches)}|{len(right)}):\n")
    else:
        head = f"  Map hits for path {pathnum} ({len(matches)}):\n"
    out = [head]
    if nflanking > 0:
        out.extend(hit_line(i) for i in reversed(left))
        out.append("    ====================\n")
    out.extend(hit_line(i) for i in matches)
    if nflanking > 0:
        out.append("    ====================\n")
        out.extend(hit_line(i) for i in right)
    out.append("\n")
    return "".join(out)
