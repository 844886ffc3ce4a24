"""SAM output formatting for GSNAP-style hits.

A copy of gmap_gsnap_tpu/io/sam.py.

Replicates the reference samprint.c conventions for single-end reads:
header (@SQ lines only, samprint.c), flag computation (samflags.h:5-16),
1-based POS, soft-clip CIGAR from end trimming, MD string, and the
gsnap tag set MD / NH / HI / NM / SM / XQ / X2 (README:646-668).
"""

from __future__ import annotations

from dataclasses import dataclass

# samflags.h
FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVCOMP = 0x10
FLAG_MATE_REVCOMP = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100

_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")

# output-option globals, mirroring the reference's static config
# (gsnap.c sam_insert_0M_p / sam_multiple_primaries_p)
INSERT_0M = False           # --sam-use-0M
MULTIPLE_PRIMARIES = False  # --sam-multiple-primaries


def insert_0M(cigar: str) -> str:
    """Insert a 0M token between adjacent gap-type CIGAR ops (I/D/N),
    which some downstream tools (Picard) require — samprint.c
    print_cigar with sam_insert_0M_p."""
    import re as _re

    ops = _re.findall(r"(\d+)([MIDNSH])", cigar)
    out = []
    for i, (n, op) in enumerate(ops):
        if i and ops[i - 1][1] in "IDN" and op in "IDN":
            out.append("0M")
        out.append(n + op)
    return "".join(out)


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def header(chr_names, chr_lengths, read_group=None) -> str:
    lines = []
    for name, ln in zip(chr_names, chr_lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{ln}\n")
    if read_group:
        lines.append(f"@RG\tID:{read_group}\n")
    return "".join(lines)


def md_gapped(parts, deletions) -> tuple[str, int]:
    """MD tag + ref-mismatch count across alignment parts.

    parts: list of (mask, ref) — mismatch mask + genome slice per aligned
    part, in printed-SEQ order.  deletions: list of len(parts)-1 entries,
    each the deleted genome string ("^" emitted) or None (splice /
    insertion junction: match runs merge across, samprint.c:2171-2183).

    Replicates print_md_string (samprint.c:530-656): a run of 0 IS
    printed before a mismatch at a part boundary (hardclip_end_p), the
    run before "^" is printed only when > 0 (lastp=true), and runs carry
    across non-deletion junctions.
    """
    out = []
    run = 0
    nm = 0
    for i, (mask, ref) in enumerate(parts):
        boundary = True  # hardclip_end_p at each print_md_string call
        for is_mm, r in zip(mask, ref):
            if not is_mm:
                run += 1
            else:
                if run > 0 or boundary:
                    out.append(str(run))
                out.append(r)
                nm += 1
                run = 0
            boundary = False if is_mm else boundary
        if i < len(deletions) and deletions[i] is not None:
            if run > 0:
                out.append(str(run))
            out.append("^" + deletions[i])
            run = 0
    if run > 0:
        out.append(str(run))
    if not out:
        out.append("0")
    return "".join(out), nm


@dataclass
class SEHit:
    chrname: str
    chrpos: int        # 1-based within chromosome (of leftmost aligned base)
    plusp: bool
    cigar: str         # full CIGAR in printed-SEQ orientation (incl. clips)
    md: str
    nm: int
    mapq: int
    absmq: int         # XQ
    second_absmq: int  # X2
    xs: str | None = None  # splice strand tag (XS:A:+/-)


def pe_record(
    qname: str,
    seq: str,
    qual: str | None,
    flag: int,
    hit: SEHit | None,
    rnext: str = "*",
    pnext: int = 0,
    tlen: int = 0,
    nh: int = 1,
    hi: int = 1,
) -> str:
    """One paired-end SAM line.  ``seq`` is the stored read (read 2
    already inverted at input, like the reference's invert_second_p);
    SEQ prints revcomped when the hit is minus, while FLAG bits are the
    caller's responsibility (0x10 semantics differ for inverted
    reads)."""
    if hit is None:
        fields = [
            qname, str(flag), "*", "0", "0", "*",
            rnext, str(pnext), "0",
            seq, qual if qual else "*",
        ]
        return "\t".join(fields) + "\n"

    out_seq = seq
    out_qual = qual if qual else "*"
    if not hit.plusp:
        out_seq = revcomp(seq)
        out_qual = out_qual[::-1] if qual else "*"

    fields = [
        qname,
        str(flag),
        hit.chrname,
        str(hit.chrpos),
        str(hit.mapq),
        insert_0M(hit.cigar) if INSERT_0M else hit.cigar,
        rnext, str(pnext), str(tlen),
        out_seq,
        out_qual,
        f"MD:Z:{hit.md}",
        f"NH:i:{nh}",
        f"HI:i:{hi}",
        f"NM:i:{hit.nm}",
        f"SM:i:{hit.mapq}",
        f"XQ:i:{hit.absmq}",
        f"X2:i:{hit.second_absmq}",
    ]
    if hit.xs:
        fields.append(f"XS:A:{hit.xs}")
    return "\t".join(fields) + "\n"


def se_record(
    qname: str,
    seq: str,
    qual: str | None,
    hit: SEHit | None,
    nh: int = 1,
    hi: int = 1,
    secondary: bool = False,
    extra: list[str] | None = None,
) -> str:
    if hit is None:
        fields = [
            qname, "4", "*", "0", "0", "*", "*", "0", "0",
            seq, qual if qual else "*",
        ]
        return "\t".join(fields) + "\n"

    flag = 0
    out_seq = seq
    out_qual = qual if qual else "*"
    if not hit.plusp:
        flag |= FLAG_REVCOMP
        out_seq = revcomp(seq)
        out_qual = out_qual[::-1] if qual else "*"
    if secondary and not MULTIPLE_PRIMARIES:
        flag |= FLAG_SECONDARY

    fields = [
        qname,
        str(flag),
        hit.chrname,
        str(hit.chrpos),
        str(hit.mapq),
        insert_0M(hit.cigar) if INSERT_0M else hit.cigar,
        "*", "0", "0",
        out_seq,
        out_qual,
        f"MD:Z:{hit.md}",
        f"NH:i:{nh}",
        f"HI:i:{hi}",
        f"NM:i:{hit.nm}",
        f"SM:i:{hit.mapq}",
        f"XQ:i:{hit.absmq}",
        f"X2:i:{hit.second_absmq}",
    ]
    if hit.xs:
        fields.append(f"XS:A:{hit.xs}")
    if extra:
        fields.extend(extra)
    return "\t".join(fields) + "\n"
