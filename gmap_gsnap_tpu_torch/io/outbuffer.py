"""Output routing: 7-way --split-output files, --fails-as-input,
--failsonly/--nofails, read groups, and quality-shift transforms.

Replaces the reference's Outbuffer output thread + sevenway file
machinery (src/outbuffer.c:279-470 sevenway_open_single/paired,
src/samprint.h:41-52 category -> file mapping).  Ordering is free in
this design: results are emitted in input order by the batched caller,
so no reordering thread is needed (Outbuffer_thread_ordered,
src/outbuffer.c:1949).

A copy of gmap_gsnap_tpu/io/outbuffer.py; the port's modules stand behind its
relative imports.
"""

from __future__ import annotations

import os

# category -> filename suffix (src/outbuffer.c:283-470)
SE_CATEGORIES = ("nomapping", "unpaired_uniq", "unpaired_transloc",
                 "unpaired_mult")
PE_CATEGORIES = ("nomapping", "unpaired_uniq", "unpaired_transloc",
                 "unpaired_mult",
                 "halfmapping_uniq", "halfmapping_transloc",
                 "halfmapping_mult",
                 "paired_uniq_inv", "paired_uniq_scr", "paired_uniq_long",
                 "paired_mult",
                 "concordant_uniq", "concordant_transloc", "concordant_mult")


class SamTransform:
    """Per-record SAM text transform: RG:Z tag + quality shift
    (--read-group-id, src/samprint.c read_group printing;
    --quality-protocol / -j shift, src/gsnap.c:286-292)."""

    def __init__(self, read_group_id: str | None = None,
                 quality_shift: int = 0,
                 barcodes: "dict | None" = None):
        self.read_group_id = read_group_id
        self.quality_shift = quality_shift
        # (label, end) -> stripped barcode; end 0 = SE, 1/2 = PE mates
        # (samprint.c XB:Z tag, printed right after QUAL on every line
        # incl. nomapping)
        self.barcodes = barcodes

    @property
    def identity(self) -> bool:
        return (self.read_group_id is None and self.quality_shift == 0
                and not self.barcodes)

    def apply(self, text: str) -> str:
        if self.identity or not text:
            return text
        out = []
        for line in text.splitlines(keepends=True):
            if line.startswith("@"):
                out.append(line)
                continue
            nl = line.endswith("\n")
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= 11:
                if self.quality_shift and fields[10] != "*":
                    fields[10] = "".join(
                        chr(max(33, min(126, ord(c) + self.quality_shift)))
                        for c in fields[10])
                if self.barcodes is not None:
                    flag = int(fields[1])
                    end = 1 if flag & 0x40 else (2 if flag & 0x80 else 0)
                    bc = self.barcodes.get((fields[0], end))
                    if bc:
                        fields.insert(11, f"XB:Z:{bc}")
                if self.read_group_id is not None:
                    fields.append(f"RG:Z:{self.read_group_id}")
            out.append("\t".join(fields) + ("\n" if nl else ""))
        return "".join(out)


def read_group_header(rg_id, rg_name=None, rg_library=None,
                      rg_platform=None) -> str:
    parts = [f"@RG\tID:{rg_id}"]
    if rg_name:
        parts.append(f"SM:{rg_name}")
    if rg_library:
        parts.append(f"LB:{rg_library}")
    if rg_platform:
        parts.append(f"PL:{rg_platform}")
    return "\t".join(parts) + "\n"


def _fastq_text(rec) -> str:
    if rec.quality:
        return f"@{rec.header}\n{rec.seq}\n+\n{rec.quality}\n"
    return f">{rec.header}\n{rec.seq}\n"


class OutputRouter:
    """Routes per-read output text to one stream or to per-category
    split files (opened lazily, like sevenway_open_*)."""

    def __init__(self, out=None, split_root: str | None = None,
                 fmt: str = "sam", header: str = "",
                 fails_as_input: bool = False, failsonly: bool = False,
                 nofails: bool = False, transform: SamTransform | None = None,
                 input_suffix: str = "fq"):
        self.out = out
        self.split_root = split_root
        self.fmt = fmt
        self.header = header
        self.fails_as_input = fails_as_input
        self.failsonly = failsonly
        self.nofails = nofails
        self.input_suffix = input_suffix  # gmap uses .fa (outbuffer.c:565)
        self.transform = transform or SamTransform()
        self._files: dict[str, object] = {}
        if (split_root is None and out is not None and header
                and not failsonly and fmt == "sam"):
            out.write(self.transform.apply(header))

    def _file(self, suffix: str, plain: bool = False):
        f = self._files.get(suffix)
        if f is None:
            f = open(f"{self.split_root}.{suffix}", "w")
            if self.fmt == "sam" and self.header and not plain:
                f.write(self.transform.apply(self.header))
            self._files[suffix] = f
        return f

    def write(self, category: str, text: str, recs=()) -> None:
        """recs: the input Record(s), used by --fails-as-input."""
        failed = category == "nomapping"
        if failed and self.nofails:
            return
        if not failed and self.failsonly:
            return
        if failed and self.fails_as_input:
            # reference: .nomapping.fq (single) or .nomapping.{1,2}.fq
            # (paired), reads re-emitted in input format
            # (src/outbuffer.c:283-291,349-365)
            if self.split_root is None:
                for r in recs:
                    self.out.write(_fastq_text(r))
            elif len(recs) == 2:
                self._file(f"nomapping.1.{self.input_suffix}",
                           plain=True).write(_fastq_text(recs[0]))
                self._file(f"nomapping.2.{self.input_suffix}",
                           plain=True).write(_fastq_text(recs[1]))
            else:
                for r in recs:
                    self._file(f"nomapping.{self.input_suffix}",
                               plain=True).write(_fastq_text(r))
            return
        if self.fmt == "sam":
            text = self.transform.apply(text)
        if self.split_root is not None:
            self._file(category).write(text)
        else:
            self.out.write(text)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
