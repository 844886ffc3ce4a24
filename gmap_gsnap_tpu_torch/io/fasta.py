"""FASTA / FASTQ input parsing (host side).

A copy of gmap_gsnap_tpu/io/fasta.py.

Replaces the reference's shortread.c / sequence.c readers (FASTA headers,
FASTQ 4-line records, gzip transparently).  Sequences keep only alphabetic
characters, matching the reference parsers which skip whitespace/digits.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class Record:
    label: str            # first word of the header
    header: str           # full header line without '>' or '@', stripped
    seq: str              # uppercase-preserved sequence (as read)
    quality: str | None = None  # FASTQ quality string, if any


def _open(path: str):
    if path == "-":
        import sys

        return sys.stdin.buffer
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


def read_fasta(path: str) -> Iterator[Record]:
    """Yield records from a FASTA file (gzip ok)."""
    label = None
    header = ""
    chunks: list[str] = []
    with _open(path) as f:
        for raw in f:
            line = raw.decode("ascii", errors="replace")
            if line.startswith(">"):
                if label is not None:
                    yield Record(label, header, "".join(chunks))
                header = line[1:].rstrip("\n")
                label = header.split()[0] if header.split() else ""
                chunks = []
            else:
                chunks.append("".join(ch for ch in line if ch.isalpha()))
        if label is not None:
            yield Record(label, header, "".join(chunks))


def read_fastq(path: str) -> Iterator[Record]:
    """Yield records from a FASTQ file (gzip ok)."""
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.decode("ascii").rstrip("\n")
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"bad FASTQ header: {h!r}")
            seq = f.readline().decode("ascii").strip()
            plus = f.readline()
            qual = f.readline().decode("ascii").rstrip("\n")
            header = h[1:]
            label = header.split()[0] if header.split() else ""
            yield Record(label, header, seq, qual)


def read_seqfile(path: str) -> Iterator[Record]:
    """Sniff FASTA vs FASTQ from the first byte."""
    with _open(path) as f:
        first = f.read(1)
    if first == b"@":
        return read_fastq(path)
    return read_fasta(path)


def read_fasta_paired(path: str):
    """GSNAP's extended paired FASTA: a record whose header is followed
    by TWO sequence lines is a read pair (Shortread_read_fasta_
    shortreads, shortread.c: input_oneline per end).  Returns
    (records5, records3) where records3 entries are None for
    single-end records."""
    recs5, recs3 = [], []
    label = header = None
    seqs: list[str] = []

    def flush():
        if header is None:
            return
        r1 = Record(label, header, seqs[0] if seqs else "")
        r2 = (Record(label, header, seqs[1]) if len(seqs) > 1 else None)
        recs5.append(r1)
        recs3.append(r2)

    with _open(path) as f:
        for raw in f:
            line = raw.decode("latin-1").rstrip("\r\n")
            if line.startswith(">"):
                flush()
                header = line[1:].strip()
                label = header.split()[0] if header else ""
                seqs = []
            elif line.strip() and header is not None:
                seqs.append("".join(
                    c for c in line.strip() if c.isalpha()))
        flush()
    return recs5, recs3
