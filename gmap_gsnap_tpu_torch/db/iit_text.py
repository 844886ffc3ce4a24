"""Text -> IIT conversion: the iit_store input format.

A copy of gmap_gsnap_tpu/db/iit_text.py without ``iit_get_text`` (the
port queries no IIT).  Replicates the reference iit_store FASTA-like
parser (src/iit_store.c: scan_header_div, parse_fasta).

Input format (one record):

    >label [div:]start..end [type] [rest of header]
    annotation lines...

Stored annotation (version 5 semantics): rest-of-header is the first line
of the annotation; if there is no rest-of-header the annotation begins
with a bare newline (iit_store.c:487-516).
"""

from __future__ import annotations

from .iit import IIT, Interval, CHROM_SORT


def parse_coords(token: str) -> tuple[str, int, int]:
    """Parse '[div:]start[..end]' into (div, start, end)."""
    div = ""
    if ":" in token:
        div, token = token.split(":", 1)
    if ".." in token:
        s, e = token.split("..", 1)
        return div, int(s), int(e)
    v = int(token)
    return div, v, v


def iit_from_text(text: str, divsort: int = CHROM_SORT, version: int = 5) -> IIT:
    """Build an IIT from iit_store input text (new format, non-GFF3)."""
    iit = IIT(version=version, divsort=divsort)
    label = None
    div = ""
    start = end = 0
    typ = 0
    restofheader: str | None = None
    lines: list[str] = []

    def flush():
        if label is None:
            return
        content = "".join(lines)
        if restofheader is not None:
            # restofheader keeps its trailing newline in the stored annotation
            annot = restofheader + "\n" + content
        elif content:
            annot = "\n" + content
        else:
            annot = ""
        iit.add(div, label, Interval.new(start, end, typ), annot.encode())

    for raw in text.splitlines(keepends=True):
        if raw.startswith(">"):
            flush()
            parts = raw[1:].split()
            if len(parts) < 2:
                raise ValueError(f"bad IIT header: {raw!r}")
            label = parts[0]
            div, start, end = parse_coords(parts[1])
            if div and div not in iit.divs:
                iit.divs.append(div)
            if len(parts) >= 3:
                typ = iit.type_index(parts[2])
                # rest of header after the tag token
                idx = raw.find(parts[2], raw.find(parts[1]) + len(parts[1]))
                rest = raw[idx + len(parts[2]):].strip()
                restofheader = rest if rest else None
            else:
                typ = 0
                restofheader = None
            lines = []
        else:
            lines.append(raw)
    flush()
    return iit
