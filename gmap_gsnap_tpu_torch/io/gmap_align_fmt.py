"""GMAP -A ALIGNMENT output (Pair_print_alignment, pair.c): per-path
exon table plus 50-column alignment blocks with amino-acid rows,
genomic/query coordinates, match bars, and 9-column intron inserts.
Golden: tests/align.test.ok (gmap -A -g chr17test ss.her2).

A copy of gmap_gsnap_tpu/io/gmap_align_fmt.py; the port's modules stand behind its
relative imports.
"""

from __future__ import annotations

from ..align.gmap import Path
from ..align import translation as tr
from ..utils import dna

_BAR = {"canonical": ">", "gcag": ")", "atac": "]", "noncanonical": "="}
_BAR_REV = {"canonical": "<", "gcag": "(", "atac": "[", "noncanonical": "="}


_ARROW_FWD = {"canonical": "->", "gcag": "-)", "atac": "-]",
              "noncanonical": "=="}
_ARROW_REV = {"canonical": "<-", "gcag": "(-", "atac": "[-",
              "noncanonical": "=="}


def exon_table(path: Path, chr_start: int, chrname: str | None,
               codes=None, invertmode: int = 0) -> str:
    """Pair_print_exonsummary (pair.c:1524): per-exon summary lines
    with percent identity, direction arrows, intron lengths, and (with
    a genome) donor/acceptor site probabilities.  chrname mode prints
    the signed chromosome once (Chrnum_to_string_signed); user-segment
    mode (-g) prints bare offsets.  invertmode 1/2 (gmap -I) lists
    genomic (-) strand alignments in ascending genome order; mode 2
    drops the strand sign (pair.c:1057-1080)."""
    out = []
    L = path.querylength
    inverted = not path.watsonp and invertmode in (1, 2)
    exons = (path.exons if path.watsonp or inverted
             else list(reversed(path.exons)))
    itypes = list(getattr(path, "intron_types", ()) or ())
    if not path.watsonp and not inverted:
        itypes = list(reversed(itypes))
    if not path.watsonp and invertmode == 2:
        sign = "+"  # Chrnum_to_string_signed(watsonp=true), pair.c:1084
    else:
        sign = "+" if path.watsonp else "-"
    # display direction: Path.cdna_direction is plus-text relative;
    # inversion complements the comp chars (invert_path), flipping it
    fwd = (path.cdna_direction >= 0) == (path.watsonp or inverted)
    for i, e in enumerate(exons):
        ln = e.qend - e.qstart
        pct = int(100.0 * e.matches / max(1, ln))  # floor, pair.c:1594
        if path.watsonp:
            g1, g2 = e.gstart - chr_start + 1, e.gend - chr_start
            q1, q2 = e.qstart + 1, e.qend
        elif inverted:
            g1, g2 = e.gstart - chr_start + 1, e.gend - chr_start
            q1, q2 = L - e.qstart, L - e.qend + 1
        else:
            g1, g2 = e.gend - chr_start, e.gstart - chr_start + 1
            q1, q2 = L - e.qend + 1, L - e.qstart
        if chrname:
            line = f"    {sign}{chrname}:{g1}-{g2}  ({q1}-{q2})   {pct}%"
        else:
            line = f"    {g1}-{g2}  ({q1}-{q2})   {pct}%"
        if i < len(exons) - 1:
            nxt = exons[i + 1]
            gap = ((nxt.gstart - e.gend) if path.watsonp or inverted
                   else (e.gstart - nxt.gend))
            if inverted:
                # pair.c:1629-1637: with inverted display watsonp stays
                # false, so intron_start/intron_end keep the minus-
                # strand +/-1 conventions against ascending coords —
                # the reference prints the physical gap + 4
                gap += 4
            it = itypes[i] if i < len(itypes) else "noncanonical"
            arrow = (_ARROW_FWD if fwd else _ARROW_REV)[it]
            line += f" {arrow}   ...{gap}..."
            if codes is not None:
                line += "  {:.3f}, {:.3f}".format(
                    *_junction_probs(path, e, nxt, codes,
                                     inverted=inverted))
        out.append(line)
    return "".join(l + "\n" for l in out)


def _junction_probs(path: Path, e, nxt, codes, inverted: bool = False):
    """Splice-site probabilities at a DISPLAYED junction — the exact
    Pair_print_exonsummary formula (pair.c:1645-1656 with donor_score/
    acceptor_score pair.c:1433-1500): positional args are the boundary
    bases of the displayed exons, rev flags follow watsonp, and the
    reference's read-relative cdna_direction picks the branch.  With
    inverted display (gmap -I 1/2) the exons arrive in ascending
    genome order while watsonp stays false, which reproduces the
    reference's (wrong-site, near-zero) probabilities byte-for-byte."""
    import numpy as np

    from ..ops import maxent

    def _p(kind, pos):
        return float(maxent.splice_prob_np(codes, np.array([pos]), kind)[0])

    def donor_score(pos, rev):
        return _p("antidonor", pos) if rev else _p("donor", pos + 1)

    def acceptor_score(pos, rev):
        return _p("antiacceptor", pos + 1) if rev else _p("acceptor", pos)

    wat = path.watsonp
    # displayed-exon boundary bases (universal 0-based):
    # chroffset + exon_genomeend - 1 / + exon_genomestart - 1
    if wat or inverted:
        arg_end, arg_start = e.gend - 1, nxt.gstart
    else:
        arg_end, arg_start = e.gstart, nxt.gend - 1
    # Path.cdna_direction is plus-text relative; the reference's is
    # read-relative
    ref_dir = path.cdna_direction if wat else -path.cdna_direction
    if ref_dir >= 0:
        return (donor_score(arg_end, not wat),
                acceptor_score(arg_start, not wat))
    return (acceptor_score(arg_end, wat), donor_score(arg_start, wat))


def _columns(path: Path, qstr: str, gstr: str, ngap: int = 3,
             nolengths: bool = False):
    """Aligned-order column stream: list of dicts with g, q, bar, gpos
    (0-based genome), qpos (0-based aligned query).

    ngap: flanking genome chars shown on each side of an intron gap
    (gmap -i, pair.c ngap; the ellipsis stays 3 dots);
    nolengths: omit intron lengths (gmap -N nointronlenp)."""
    gw = 2 * ngap + 3  # ngap genome chars each side + 3 dots
    cols = []
    exons = path.exons
    itypes = path.intron_types
    for k, e in enumerate(exons):
        diag = e.gstart - e.qstart
        for q in range(e.qstart, e.qend):
            g = diag + q
            gc = gstr[g] if 0 <= g < len(gstr) else "N"
            qc = qstr[q]
            cols.append({"g": gc, "q": qc, "bar": "|" if gc == qc else " ",
                         "gpos": g, "qpos": q})
        if k < len(exons) - 1:
            nxt = exons[k + 1]
            dq = nxt.qstart - e.qend
            gap = nxt.gstart - e.gend
            if dq > 0:  # insertion columns
                for q in range(e.qend, nxt.qstart):
                    cols.append({"g": "-", "q": qstr[q], "bar": " ",
                                 "gpos": None, "qpos": q})
            if gap >= 9:
                itype = itypes[k] if k < len(itypes) else "noncanonical"
                bar = (_BAR if path.cdna_direction >= 0 else _BAR_REV).get(
                    itype, "=")
                s = "" if nolengths else str(gap)
                left = (gw - len(s)) // 2
                text = " " * left + s + " " * (gw - left - len(s))
                # inverted-display (gmap -I 1/2) row labels: gap pairs
                # carry the BUILD-order "right" coords (stage3.c:1632
                # gapgenomepos/rightquerypos), which for minus paths is
                # the genomically-lower exon's boundary
                inv = {"inv_g1": e.gend + ngap, "inv_q1_off": e.qend}
                for i in range(ngap):
                    cols.append({"g": gstr[e.gend + i], "q": text[i],
                                 "bar": bar, "gpos": e.gend + i,
                                 "qpos": None, "intron": True, **inv})
                for i in range(3):
                    cols.append({"g": ".", "q": text[ngap + i], "bar": ".",
                                 "gpos": None, "qpos": None, "intron": True,
                                 **inv})
                for i in range(ngap):
                    cols.append({"g": gstr[nxt.gstart - ngap + i],
                                 "q": text[ngap + 3 + i], "bar": bar,
                                 "gpos": nxt.gstart - ngap + i, "qpos": None,
                                 "intron": True, **inv})
            elif gap > 0:  # deletion columns
                for g in range(e.gend, nxt.gstart):
                    cols.append({"g": gstr[g], "q": "-", "bar": " ",
                                 "gpos": g, "qpos": None})
    return cols


def _aa_by_qpos(qstr: str):
    """letter + ordinal per query position (letter at codon middle)."""
    aa = tr.translate_forward(qstr)
    frame, starti, endi, length, endstopp = tr.find_bounds_forward(aa)
    letters = {}
    nums = {}
    if length == 0:
        return letters, nums
    num = 1
    for i in range(starti, endi + 1, 3):
        if aa[i] == " ":
            # incomplete trailing codon: no residue, no aa number
            # (translate_pairs_* only record complete codons)
            continue
        letters[i] = aa[i]
        nums[i] = num
        num += 1
    return letters, nums


def _wrap50(s: str) -> str:
    return "".join(s[i : i + 50] + "\n" for i in range(0, len(s), 50))


def exons_output(path: Path, header: str, qstr: str, gstr: str,
                 genomic: bool) -> str:
    """gmap -E cdna|genomic (Pair_print_exons, pair.c): per-exon
    sequence dumps; genomic mode annotates the translation phase."""
    from .gmap_out import _translation_bounds

    tb = _translation_bounds(path, qstr, gstr)
    t0 = tb[0] if tb else 0
    length = tb[2] if tb else 0
    # translation display direction: descending when the cDNA sense
    # opposes the displayed strand
    desc = (path.cdna_direction >= 0) != path.watsonp
    out = [f">{header}", "<path 1>"]
    exons = path.exons if path.watsonp else list(reversed(path.exons))
    L = path.querylength
    for i, e in enumerate(exons):
        if path.watsonp:
            qs = e.qstart
            seq = gstr[e.gstart : e.gend] if genomic else qstr[e.qstart : e.qend]
        else:
            qs = L - e.qend
            seq = (dna.revcomp_str(gstr[e.gstart : e.gend]) if genomic
                   else dna.revcomp_str(qstr[e.qstart : e.qend]))
        # phase omitted outside the translation: aaphase is assigned
        # over the ORF's frame run, which begins up to 2 positions
        # before the first full codon (find_bounds_* start), so exons
        # starting within that fringe still annotate (HER2 exon 1,
        # phase 2) while exons well before the ORF do not
        a0, b0 = (tb[0], tb[1]) if tb else (0, -1)
        fringe = 2 if genomic else 0  # aaphase_e is strict (mark_cdna_*)
        if desc:
            beyond_end = qs < b0
            outside = qs > a0 + fringe or beyond_end
        else:
            beyond_end = qs > b0
            outside = qs < a0 - fringe or beyond_end
        omit = outside or not length
        if omit:
            out.append(f"<exon {i+1}>")
        else:
            phase = ((t0 - qs) if desc else (qs - t0)) % 3
            out.append(f"<exon {i+1}, phase {phase}>")
        out.append(_wrap50(seq).rstrip("\n"))
        out.append("</exon>")
    out.append("</path>")
    return "".join(l + "\n" for l in out)


def protein_output(path: Path, header: str, qstr: str, gstr: str,
                   genomic: bool) -> str:
    """gmap -P / -Q: translated protein, 50 aa per line."""
    # both modes translate in the ALIGNED orientation (the sense strand
    # for minus-path alignments): cDNA = the aligned query, genomic =
    # the exon concatenation on the plus genome
    if genomic:
        src = "".join(gstr[e.gstart : e.gend] for e in path.exons)
    else:
        src = qstr
    aa = tr.translate_forward(src)
    frame, starti, endi, length, _ = tr.find_bounds_forward(aa)
    if length == 0:
        return f">{header}\n"
    prot = "".join(aa[i] for i in range(starti, endi + 1, 3))
    # neither the trailing stop codon nor a partial-codon blank prints
    prot = prot.rstrip(" *")
    return f">{header}\n" + _wrap50(prot)


def _read_order_cols(path: Path, cols):
    """Columns in READ display order: minus paths reverse and
    complement (intron length texts rebuilt)."""
    if path.watsonp:
        return cols
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    barflip = str.maketrans("><)(][", "<>()[]")
    rev = []
    for c in reversed(cols):
        c = dict(c)
        if c["g"] not in ".-" and not c.get("intron") or (
                c.get("intron") and c["g"] != "."):
            c["g"] = c["g"].translate(comp)
        if c["q"] not in ".-" and c.get("qpos") is not None:
            c["q"] = c["q"].translate(comp)
        if c.get("intron"):
            c["bar"] = c["bar"].translate(barflip)
        rev.append(c)
    cols = rev
    i = 0
    while i < len(cols):
        if cols[i].get("intron"):
            j = i
            while j < len(cols) and cols[j].get("intron"):
                j += 1
            # re-derive gap length from genomic coords
            gp = [c["gpos"] for c in cols[i:j] if c["gpos"] is not None]
            gap = max(gp) - min(gp) + 1 if gp else 0
            s = str(gap)
            # centred in 9 columns, or in the run's own 2 ngap + 3 when
            # -i makes it wider, as _columns centres it for a plus path
            w = max(9, j - i)
            left = (w - len(s)) // 2
            text = " " * left + s + " " * (w - left - len(s))
            for k in range(i, j):
                cols[k]["q"] = text[k - i]
            i = j
        else:
            i += 1
    return cols


def _display_cols(path: Path, cols, invertmode: int = 0):
    """Column stream per gmap -I/--invertmode (pair.c:806-825) for
    genomic (-) strand alignments:
      0 = as stored (read-orientation cDNA, minus-strand genome,
          descending coordinates) — invert nothing;
      1 = invert_path: ascending genome order, chars as stored
          (minus-strand genome, given cDNA);
      2 = invert_and_revcomp_path: ascending genome order with both
          sequences complemented (plus-strand genome, revcomp cDNA)."""
    if path.watsonp or invertmode == 0:
        return _read_order_cols(path, cols)
    if invertmode == 2:
        return cols
    # mode 1 == aligned order with stored (read-orientation) chars:
    # complement both rows of the aligned columns; bar symbols and the
    # intron-length texts stay in aligned order (add_intronlengths runs
    # after inversion in the reference)
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    out = []
    for c in cols:
        c = dict(c)
        if c["g"] not in ".-":
            c["g"] = c["g"].translate(comp)
        if c.get("qpos") is not None:
            c["q"] = c["q"].translate(comp)
        out.append(c)
    return out


def alignment_body(path: Path, qstr: str, gstr: str, chr_start: int,
                   chrname: str | None,
                   aa_override: "tuple | None" = None,
                   wraplength: int = 50, ngap: int = 3,
                   nolengths: bool = False, invertmode: int = 0) -> str:
    """aa_override=(letters, nums): aligned-qpos aa maps to use instead
    of translating this path standalone — chimera parts continue one
    merged ORF with continuous numbering (gmap_out.chimera_aa_maps)."""
    acols = _columns(path, qstr, gstr, ngap=ngap, nolengths=nolengths)
    cols = _display_cols(path, acols, invertmode)

    L = path.querylength
    if aa_override is not None:
        aac, aac_num = aa_override
        aag, aag_num = aa_override
    else:
        aac, aac_num = _aa_by_qpos(qstr)
        # genomic-side translation over exon columns in ALIGNED
        # orientation (the ORF direction; display transforms only
        # reorder/complement the letters' columns).  Same coords for
        # clean alignments; mismatches translate the genome letters.
        gcols = "".join(
            c["g"] for c in acols if c["qpos"] is not None or
            (c["gpos"] is not None and not c.get("intron") and c["q"] == "-"))
        aag, aag_num = (_aa_by_qpos(gcols) if gcols != qstr
                        else (aac, aac_num))

    # map aa letters onto display columns
    disp_q = lambda c: (L - 1 - c["qpos"]) if not path.watsonp else c["qpos"]
    # dbmode genome rows label the signed chromosome (Pair_print_
    # alignment via Chrnum_to_string_signed); usersegment rows are
    # bare; invertmode 2 prints the UNSIGNED name (pair.c:831-836)
    sign = "+" if path.watsonp else "-"
    if not path.watsonp and invertmode == 2:
        pre = f"{chrname}:" if chrname else ""
    else:
        pre = f"{sign}{chrname}:" if chrname else ""

    # gutter width from the first/last pair's label (compute_margin,
    # pair.c:434-459: max(DEFAULT_MARGIN=14, len(label)+1))
    gps = [c["gpos"] for c in cols if c["gpos"] is not None]
    margin = 14
    if gps:
        for gp in (gps[0], gps[-1]):
            margin = max(margin, len(f"{pre}{gp - chr_start + 1}") + 1)

    # the reference ruler is a FIXED 50-char string printed whole for
    # full blocks (even when wraplength != 50) and truncated to the
    # remaining pair count on the last block (pair.c:260-270)
    RULER = "    .    :" * 5
    out = []
    ncols = len(cols)
    for b0 in range(0, ncols, wraplength):
        block = cols[b0 : b0 + wraplength]
        ruler = (RULER if b0 + wraplength < ncols
                 else RULER[: ncols - b0])
        out.append(f"{b0:>{margin}} {ruler}")

        def aa_row(label, letters, nums):
            chars = []
            first_num = None
            for c in block:
                q = c["qpos"]
                key = None
                if q is not None:
                    key = q if path.watsonp else q
                if key is not None and key in letters:
                    chars.append(letters[key])
                    if first_num is None:
                        first_num = nums[key]
                else:
                    chars.append(" ")
            if first_num is None:
                # no residues in this block: unlabeled blank row
                return " " * (margin + 1 + len(block))
            return f"{label}{first_num:>{margin - 4}} " + "".join(chars)

        out.append(aa_row("aa.g", aag, aag_num))

        inverted = not path.watsonp and invertmode in (1, 2)
        gpos0 = next((c["gpos"] for c in block if c["gpos"] is not None), None)
        if (inverted and block and block[0]["gpos"] is None
                and "inv_g1" in block[0]):
            # block opens on a dot pair: its stored genomepos is the
            # gap's build-order gapgenomepos (stage3.c:1632)
            gpos0 = block[0]["inv_g1"] - 1
        gdisp = "" if gpos0 is None else f"{pre}{gpos0 - chr_start + 1}"
        out.append(f"{gdisp:>{margin}} " + "".join(c["g"] for c in block))
        out.append(" " * (margin + 1) + "".join(c["bar"] for c in block))
        qpos0 = next((c["qpos"] for c in block if c["qpos"] is not None), None)
        qdisp = "" if qpos0 is None else str(
            (qpos0 + 1) if path.watsonp else (L - qpos0))
        if (inverted and block and block[0]["qpos"] is None
                and "inv_q1_off" in block[0]):
            # gap pairs carry rightquerypos = the genomically-lower
            # exon's read boundary
            qdisp = str(L - block[0]["inv_q1_off"] + 1)
        out.append(f"{qdisp:>{margin}} " + "".join(c["q"] for c in block))
        out.append(aa_row("aa.c", aac, aac_num))
        out.append("")
    return "".join(l + "\n" for l in out)


def continuous_body(path: Path, qstr: str, gstr: str,
                    invertmode: int = 0) -> str:
    """gmap -3 / --continuous (Printtype CONTINUOUS, Pair_print_
    continuous pair.c): the whole alignment as three unwrapped rows —
    genome, bars, query — with introns as 9-column blocks (3 intron
    bases, '...', 3 intron bases; centered intron length in the query
    row)."""
    cols = _display_cols(path, _columns(path, qstr, gstr), invertmode)
    g = "".join(c["g"] for c in cols)
    b = "".join(c["bar"] for c in cols)
    q = "".join(c["q"] for c in cols)
    return f"{g}\n{b}\n{q}\n"


def continuous_by_exon_body(path: Path, qstr: str, gstr: str,
                            invertmode: int = 0) -> str:
    """gmap -4 / --continuous-by-exon (CONTINUOUS_BY_EXON): one
    unwrapped three-row block per exon, blank line between blocks."""
    cols = _display_cols(path, _columns(path, qstr, gstr), invertmode)
    blocks = []
    cur = []
    for c in cols:
        if c.get("intron"):
            if cur:
                blocks.append(cur)
                cur = []
        else:
            cur.append(c)
    if cur:
        blocks.append(cur)
    out = []
    for blk in blocks:
        out.append("".join(c["g"] for c in blk))
        out.append("".join(c["bar"] for c in blk))
        out.append("".join(c["q"] for c in blk))
        out.append("")
    return "".join(l + "\n" for l in out)
