"""GSNAP native (default) output format.

Replicates the reference's `>read  npaths  quality  label` blocks with
per-segment alignment rows (README:700-787; printers in substring.c /
stage3hr.c print_one_paired_end):

  * segment text = genomic sequence in READ orientation, mismatches in
    lowercase; multi-segment hits pad with dashes into a common column
    space of width L + (deleted/intron display columns);
  * deleted genome bases and splice dinucleotides render lowercase in
    the junction columns;
  * per-segment fields: query range (1-based, read coords), signed
    chr range, end labels (start:/end: trims, term:, del:, ins:,
    donor:/acceptor: probs), matches, sub, and on the first segment
    segs:/align_score:/mapq: (+method:gmap, pair_score/insert_length).

Single-end records; hits arrive as the ranked HostHit list shared with
the SAM path.

A copy of gmap_gsnap_tpu/io/gsnap_native.py; the splice probabilities
come from the port's host maxent (ops/maxent.splice_prob_np, float64).
"""

from __future__ import annotations


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTacgtn", "TGCAtgcan"))[::-1]


class SnpDisplay:
    """SNP-tolerant (-v) native display state (substring.c:1842-1930
    genomic_bothdiff/genomic_refdiff + print_snp_labels):

      * lowercase marks positions mismatching BOTH ref and alt
        (bothdiff); --show-refdiff lowercases every ref mismatch;
      * sub fields print bothdiff+extra=refdiff (print_nsnpdiffs_p);
      * --print-snps appends ,snps:qpos@label for alt-matched SNPs.
    """

    def __init__(self, alt_str, labels: dict | None = None,
                 show_refdiff: bool = False, print_labels: bool = False):
        self.alt = alt_str          # alt genome view (same slicing API)
        self.labels = labels or {}  # universal 0-based pos -> snp label
        self.show_refdiff = show_refdiff
        self.print_labels = print_labels


def _seg_text(gseq: str, query: str, aseq: str | None = None,
              refdiff: bool = False) -> str:
    """Genomic text with lowercase where it mismatches the query
    (bothdiff: alt-genome matches stay uppercase unless refdiff)."""
    out = []
    for i, (g, q) in enumerate(zip(gseq, query)):
        m = g == q or q == "N"
        if (not m and not refdiff and aseq is not None
                and i < len(aseq) and aseq[i] == q):
            m = True
        out.append(g if m else g.lower())
    return "".join(out)


def _sub_counts(gseq: str, query: str, aseq: str | None):
    """(nmismatches_bothdiff, nmismatches_refdiff) over the span."""
    both = ref = 0
    for i, (g, q) in enumerate(zip(gseq, query)):
        if g != q and q != "N":
            ref += 1
            if aseq is None or i >= len(aseq) or aseq[i] != q:
                both += 1
    return both, ref


def _sub_field(sub: int, subref: int, snp) -> str:
    """sub display: 'sub:X' or SNP-mode 'sub:X+Y=Z' (print_nsnpdiffs_p,
    substring.c:3174)."""
    if snp is None:
        return f"sub:{sub}"
    return f"sub:{sub}+{subref - sub}={subref}"


def _fmt_prob(p: float) -> str:
    return f"{p:.2f}"


def _inversion_lines(h, rec, genome_str, chrname, chr_start, mapq,
                     pair_suffix, chr_lookup, snp=None):
    """Mixed-strand distant pair (splice_type:inversion): two segments
    printed in READ order, each with its own strand sign; the minus
    segment shows the read text against the reverse-complemented
    genomic span with descending coordinates."""
    d = h.d
    info = d.distant
    L = len(rec.seq)
    read = rec.seq.upper()
    (q1, q2, g1), (q3, q4, g2) = d.parts
    p1, p2 = info["plusps"]
    sense = "sense" if info["sense"] else "antisense"
    dist = info["dist"]

    def span_of(qs, qe, g0):
        return g0, g0 + (qe - qs)

    segs = []
    for idx, ((qs, qe, g0), hplus) in enumerate(
            (((q1, q2, g1), p1), ((q3, q4, g2), p2))):
        lo, hi = span_of(qs, qe, g0)
        gseq = genome_str[lo:hi]
        aseq = snp.alt[lo:hi] if snp is not None else None
        if not hplus:
            gseq = _revcomp(gseq)
            aseq = _revcomp(aseq) if aseq is not None else None
        text = _seg_text(gseq, read[qs:qe], aseq,
                         refdiff=snp.show_refdiff if snp else False)
        sub, subref = _sub_counts(gseq, read[qs:qe], aseq)
        cn, cs = (chrname, chr_start)
        if chr_lookup is not None:
            cn, cs = chr_lookup(lo)
        if hplus:
            rng = f"+{cn}:{lo - cs + 1}..{hi - cs}"
        else:
            rng = f"-{cn}:{hi - cs}..{lo - cs + 1}"
        segs.append((qs, qe, lo, hi, hplus, text, sub, subref, rng))

    # adjacent intron dinucleotides in READ orientation
    (qs1, qe1, lo1, hi1, hp1, text1, sub1, subref1, rng1) = segs[0]
    (qs2, qe2, lo2, hi2, hp2, text2, sub2, subref2, rng2) = segs[1]
    dn1 = (genome_str[hi1 : hi1 + 2] if hp1
           else _revcomp(genome_str[lo1 - 2 : lo1])).lower()
    dn2 = (genome_str[lo2 - 2 : lo2] if hp2
           else _revcomp(genome_str[hi2 : hi2 + 2])).lower()
    row1 = text1 + dn1 + "-" * (L - qe1 - 2)
    row2 = "-" * (qs2 - 2) + dn2 + text2

    dprob = _fmt_prob(info["dprob"])
    aprob = _fmt_prob(info["aprob"])
    if info.get("donor_left", True):
        lab1, lab2 = f"donor:{dprob}", f"acceptor:{aprob}"
    else:
        lab1, lab2 = f"acceptor:{aprob}", f"donor:{dprob}"

    stype = info["type"]
    f1 = (f"start:0..{lab1},matches:{(qe1 - qs1) - sub1},"
          f"{_sub_field(sub1, subref1, snp)},"
          f"dir:{sense},splice_type:{stype}")
    f2 = (f"{lab2}..end:0,matches:{(qe2 - qs2) - sub2},"
          f"{_sub_field(sub2, subref2, snp)},"
          f"dir:{sense},splice_type:{stype}")
    if dist > 0:
        f1 += f",splice_dist_2:{dist}"
        f2 += f",splice_dist_1:{dist}"
    line1 = (f"{row1}\t{qs1 + 1}..{qe1}\t{rng1}\t{f1}"
             f"\tsegs:2,align_score:{_align_score(h)},mapq:{mapq}")
    if pair_suffix is not None:
        line1 += f"\t{pair_suffix}"
    line2 = f"{row2}\t{qs2 + 1}..{qe2}\t{rng2}\t{f2}"
    return [line1, line2]


def hit_lines(h, rec, genome_str: str, codes, chrname: str, chr_start: int,
              mapq: int, pair_suffix: str | None = None,
              splice_labels=None, chr_lookup=None,
              snp: SnpDisplay | None = None) -> list[str]:
    """Render one hit (HostHit) as native segment lines (no leading
    space/comma markers)."""
    d = h.d
    L = len(rec.seq)
    read = rec.seq.upper()

    if (h.hittype == "distant" and d.distant is not None
            and d.distant.get("plusps") is not None):
        return _inversion_lines(h, rec, genome_str, chrname, chr_start,
                                mapq, pair_suffix, chr_lookup, snp=snp)

    # aligned-space segments: (qs, qe, g0) plus junction info
    parts = list(d.parts) if d.parts else [(0, L, d.left)]
    # aligned-space trims -> per-part spans; GMAP parts already exclude
    # the trimmed ends (exon bounds), device parts span the whole read
    gmapp = h.hittype == "gmap"
    spans = []
    for k, (qs, qe, g0) in enumerate(parts):
        if gmapp:
            spans.append((qs, qe, g0))
        else:
            lo = qs + (d.trim5 if k == 0 else 0)
            hi = qe - (d.trim3 if k == len(parts) - 1 else 0)
            spans.append((lo, hi, g0))

    # junction descriptors between consecutive parts (aligned order)
    juncs = []
    if h.hittype == "distant" and len(parts) == 2:
        # distant splice: one junction, distance from the pair (the
        # genomic gap may be negative for scrambles/translocations)
        (qs1, qe1, g1), (_, _, g2) = parts
        juncs.append(("intron", d.distant["dist"], g1 + (qe1 - qs1), g2))
    else:
        for (qs1, qe1, g1), (qs2, qe2, g2) in zip(parts, parts[1:]):
            dq = qs2 - qe1                  # query gap (insertion)
            gend1 = g1 + (qe1 - qs1)        # genome end of part 1
            gap = g2 - gend1                # genomic gap (deletion / intron)
            if dq > 0:
                juncs.append(("ins", dq, gend1, g2))
            elif "N" in d.cigar_core and h.hittype in ("splice", "gmap") and gap >= 9:
                juncs.append(("intron", gap, gend1, g2))
            else:
                juncs.append(("del", gap, gend1, g2))

    # display rows share the read's column space (width L): deleted
    # bases / splice dinucleotides overprint into the dash region
    width = L

    from ..ops import maxent as maxent_mod
    import numpy as np

    lines = []
    nsegs = len(parts)
    seg_infos = []
    q_aln = read if d.plusp else _revcomp(read)
    seg_subref = []
    seg_snps = []
    for k, ((lo, hi, g0), (qs, qe, _)) in enumerate(zip(spans, parts)):
        # segment TEXT spans the whole part (trimmed bases still shown);
        # ranges/labels/sub reflect the trimmed span [lo, hi).  GMAP
        # hits extend the outer parts with pure-lowercase GENOMIC
        # context over the trimmed regions (Pair_print_gsnap)
        gseq = genome_str[g0 : g0 + (qe - qs)]
        aseq = snp.alt[g0 : g0 + (qe - qs)] if snp is not None else None
        text = _seg_text(gseq, q_aln[qs:qe], aseq,
                         refdiff=snp.show_refdiff if snp else False)
        t0, t1 = lo - qs, hi - qs
        sub, subref = _sub_counts(
            gseq[t0:t1], q_aln[lo:hi],
            aseq[t0:t1] if aseq is not None else None)
        seg_subref.append(subref)
        snps = []
        if snp is not None and snp.print_labels and snp.labels:
            # print_snp_labels (substring.c:3712): alt-matched SNPs in
            # the trimmed span, 1-based READ coordinates
            for i in range(t0, t1):
                q = q_aln[qs + i]
                if (gseq[i] != q and i < len(aseq) and aseq[i] == q
                        and (g0 + i) in snp.labels):
                    rp = (qs + i) if d.plusp else (L - 1 - (qs + i))
                    snps.append((rp, snp.labels[g0 + i]))
            snps.sort()
        seg_snps.append(snps)
        ext5 = d.trim5 if (gmapp and k == 0) else 0
        ext3 = d.trim3 if (gmapp and k == len(parts) - 1) else 0
        if ext5:
            text = genome_str[g0 - ext5 : g0].lower() + text
        if ext3:
            gend = g0 + (qe - qs)
            text = text + genome_str[gend : gend + ext3].lower()
        seg_infos.append((lo, hi, g0 + (lo - qs), qs - ext5, qe + ext3,
                          text, sub))

    # build display rows in ALIGNED order first
    rows = []
    for k, (lo, hi, gstart, qs, qe, text, sub) in enumerate(seg_infos):
        row = "-" * qs + text
        # junction decoration after this segment; deleted genome bases
        # print after the READ-order-first segment, which for minus
        # hits is the FOLLOWING aligned segment (handled below)
        if k < len(juncs):
            kind, n, gend1, g2 = juncs[k]
            if kind == "del" and d.plusp:
                # deleted genome bases extend the row; trailing dashes
                # count L - qe, except single-base deletions which the
                # reference prints one dash short (observed quirk)
                row += genome_str[gend1 : gend1 + n].lower() + "-" * (
                    L - qe - (1 if n == 1 else 0))
            elif kind == "intron":
                row += genome_str[gend1 : gend1 + 2].lower() + "-" * (L - qe - 2)
            else:
                row += "-" * (L - qe)
        elif len(row) < width:
            row = row + "-" * (width - len(row))
        # junction decoration before this segment (acceptor dinucl /
        # minus-strand deletion overprint)
        if k > 0:
            kindp, n, gend1, g2 = juncs[k - 1]
            if kindp == "intron" and qs >= 2:
                row = row[: qs - 2] + genome_str[g2 - 2 : g2].lower() + row[qs:]
            elif kindp == "del" and not d.plusp:
                # deleted genome bases INSERT before the segment text
                # (the display row grows by n)
                row = (row[:qs] + genome_str[gend1 : g2].lower()
                       + row[qs:])
        rows.append(row)

    # read-order: minus hits print segments reversed with flipped coords
    order = range(nsegs) if d.plusp else range(nsegs - 1, -1, -1)

    # splice annotations
    sense = None
    if (h.hittype in ("splice", "gmap", "distant")
            and any(j[0] == "intron" for j in juncs)):
        sense = "sense" if (d.xs == "+") == d.plusp else "antisense"

    out = []
    for print_i, k in enumerate(order):
        lo, hi, gstart, qs, qe, text, sub = seg_infos[k]
        row = rows[k]
        if chr_lookup is not None:
            # translocation segments live on different chromosomes
            chrname, chr_start = chr_lookup(gstart)
        if d.plusp:
            q1, q2 = lo + 1, hi
            gg1, gg2 = gstart - chr_start + 1, gstart + (hi - lo) - chr_start
            rng = f"+{chrname}:{gg1}..{gg2}"
        else:
            q1, q2 = L - hi + 1, L - lo
            gg1 = gstart + (hi - lo) - chr_start
            gg2 = gstart + 1 - chr_start
            rng = f"-{chrname}:{gg1}..{gg2}"
            row = _revcomp(row)

        # end labels in read order; outer ends use read-oriented trims
        def outer_label(read_start: bool):
            aligned_start = d.plusp == read_start
            val = d.trim5 if aligned_start else d.trim3
            if h.hittype == "terminal":
                te = getattr(d, "term_ends", None)
                if te is not None:
                    is_term = te[0] if aligned_start else te[1]
                else:
                    is_term = val > 0
                name = "term" if is_term else (
                    "start" if read_start else "end")
            else:
                name = "start" if read_start else "end"
            return f"{name}:{val}"

        def junc_label(j: int, left_side_of_junction: bool):
            kind, n, gend1, g2 = juncs[j]
            if kind == "ins":
                return f"ins:{n}"
            if kind == "del":
                return f"del:{n}"
            # intron boundary labels carry the ROLE of that side, set
            # by the genomic sense strand (xs '+' = GT..AG on plus =
            # donor on the aligned-left boundary); the maxent model
            # kind already follows xs inside _model_prob
            donor_left = d.xs == "+"
            if left_side_of_junction:
                name = "donor" if donor_left else "acceptor"
                prob = _donor_prob(codes, gend1, d)
            else:
                name = "acceptor" if donor_left else "donor"
                prob = _acceptor_prob(codes, g2, d)
            return f"{name}:{_fmt_prob(prob)}"

        lab_lo = outer_label(d.plusp) if k == 0 else junc_label(k - 1, False)
        lab_hi = (outer_label(not d.plusp) if k == nsegs - 1
                  else junc_label(k, True))
        first_lab, second_lab = (lab_lo, lab_hi) if d.plusp else (lab_hi, lab_lo)
        # single-segment hits print the hit-level nmatches (whole region
        # for subs, trimmed for terminals); multi-segment hits print
        # per-segment matches
        if nsegs == 1:
            # terminals display TRIMMED matches (h.nmatches carries the
            # whole-region count for gmap-acceptance comparisons)
            nmatches_seg = d.nmatches if h.hittype == "terminal" else h.nmatches
        else:
            nmatches_seg = (hi - lo) - sub
        fields = (f"{first_lab}..{second_lab},matches:{nmatches_seg},"
                  f"{_sub_field(sub, seg_subref[k], snp)}")
        if snp is not None and snp.print_labels and seg_subref[k] > sub:
            fields += ",snps:" + "|".join(
                f"{rp + 1}@{lab}" for rp, lab in seg_snps[k])
        if sense is not None:
            dists = []
            if k > 0 and juncs[k - 1][0] == "intron":
                dists.append(("1" if d.plusp else "2", juncs[k - 1][1],
                              juncs[k - 1][3]))  # acceptor coord
            if k < len(juncs) and juncs[k][0] == "intron":
                dists.append(("2" if d.plusp else "1", juncs[k][1],
                              juncs[k][2]))      # donor coord
            stype = (d.distant["type"] if h.hittype == "distant"
                     else "consistent")
            for which, dist, sitepos in dists:
                fields += f",dir:{sense},splice_type:{stype}"
                if dist > 0:  # translocations print no distance
                    fields += f",splice_dist_{which}:{dist}"
                if splice_labels and sitepos in splice_labels:
                    fields += f",label_{which}:{splice_labels[sitepos]}"

        line = f"{row}\t{q1}..{q2}\t{rng}\t{fields}"
        if print_i == 0:
            tail = f"segs:{nsegs},align_score:{_align_score(h)},mapq:{mapq}"
            if h.hittype == "gmap":
                tail += ",method:gmap"
            line += f"\t{tail}"
            if pair_suffix is not None:
                line += f"\t{pair_suffix}"
            elif h.hittype == "gmap":
                line += "\tpair_score:0,insert_length:0"
        out.append(line)
    return out


def _align_score(h) -> int:
    d = h.d
    if h.hittype == "sub":
        return len(d.mmpos)
    if h.hittype == "terminal":
        return d.nmm_trimmed
    if h.hittype in ("ins", "del"):
        return len(d.mmpos) + 2
    if h.hittype == "splice":
        return len(d.mmpos)
    if h.hittype == "distant":
        return len(d.mmpos) + d.distant["penalty"]
    # gmap: mismatches + indel/intron penalties (stage3hr.c:3179)
    njunc_indel = max(0, d.cigar_core.count("D") + d.cigar_core.count("I"))
    return len(d.mmpos) + 2 * njunc_indel


def _donor_prob(codes, pos, d) -> float:
    return _model_prob(codes, pos, d, "donor")


def _acceptor_prob(codes, pos, d) -> float:
    return _model_prob(codes, pos, d, "acceptor")


def _model_prob(codes, pos, d, side: str) -> float:
    import numpy as np

    from ..ops import maxent as maxent_mod

    # sense on plus genome: donor at intron start, acceptor at intron end
    sense_plus = d.xs != "-"
    if side == "donor":
        kind = "donor" if sense_plus else "antiacceptor"
    else:
        kind = "acceptor" if sense_plus else "antidonor"
    return float(maxent_mod.splice_prob_np(codes, np.array([pos]), kind)[0])


def read_block(rec, final_hits, genome_str, codes, chr_lookup, mapqs,
               splice_labels=None, snp: SnpDisplay | None = None) -> str:
    """One read's native output block (header + hit lines + blank);
    nomapping reads print the header with 0 paths."""
    qual = rec.quality if rec.quality else ""
    if not final_hits:
        return f">{rec.seq.upper()}\t0\t{qual}\t{rec.label}\n\n"
    # UNPAIRED_TRANSLOC result marking (outbuffer.c:1031)
    transloc = " (transloc)" if any(
        h.hittype == "distant" and not h.d.distant["shortp"]
        for h in final_hits) else ""
    header = (f">{rec.seq.upper()}\t{len(final_hits)}{transloc}"
              f"\t{qual}\t{rec.label}")
    lines = [header]
    for i, h in enumerate(final_hits):
        chrname, chr_start = chr_lookup(h.d.left)
        segs = hit_lines(h, rec, genome_str, codes, chrname, chr_start,
                         mapqs[i] if i < len(mapqs) else 0,
                         splice_labels=splice_labels,
                         chr_lookup=(chr_lookup if h.hittype == "distant"
                                     else None), snp=snp)
        for j, s in enumerate(segs):
            lines.append((" " if j == 0 else ",") + s)
    return "\n".join(lines) + "\n\n"
