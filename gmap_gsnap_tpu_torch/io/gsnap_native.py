"""GSNAP native (default) output format: the part the SAM path needs.

Only ``_align_score`` of gmap_gsnap_tpu/io/gsnap_native.py, copied: the
pair score of a HostHit, which paired-end rescue ranks pairs by.  The
rest of that module (the ``-A gsnap`` printers) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations


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
