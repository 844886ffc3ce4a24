"""Database construction: the gmap_build / gmap_setup / fa_coords /
gmap_process / gmapindex pipeline as one host-side function.

Produces a database directory laid out like the reference
(README:105-134, util/gmap_build.pl.in:117-188, src/gmapindex.c):

    <dir>/<db>/<db>.version           text: db name
    <dir>/<db>/<db>.chromosome        text: name \t start..end \t length
    <dir>/<db>/<db>.chromosome.iit    IIT v1, universal 0-based coords
    <dir>/<db>/<db>.chrsubset
    <dir>/<db>/<db>.contig            text
    <dir>/<db>/<db>.contig.iit        IIT v1
    <dir>/<db>/<db>.genomecomp        2-bit packed genome
    <dir>/<db>/<db>.ref<BB><KK><Q>offsetscomp [+ gammaptrs if BB<KK]
    <dir>/<db>/<db>.ref<KK><Q>positions
    <dir>/<db>/<db>.maps/             user map IITs

A copy of gmap_gsnap_tpu/db/build.py (JAX-free host code).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io import fasta
from ..utils import dna
from . import genomecomp, indexdb
from .iit import IIT, Interval, NO_SORT

FA_COORDS_HEADER = (
    "# To rename a chromosome, edit each occurrence of that chromosome in the gmap_coordinates\n"
    "# The strain column has information copied from NCBI md files, but is not otherwise used by gmap_setup\n"
    "# To exclude a contig, place a '#' sign at the beginning of the line\n"
    "#contig\tgmap_coordinates\tstrain\n"
)


def fa_coords_text(fasta_paths: list[str]) -> str:
    """Equivalent of util/fa_coords.pl: map each FASTA entry to
    chromosomal coordinates (parity target: tests/coords1.test.ok)."""
    out = [FA_COORDS_HEADER]
    for path in fasta_paths:
        for rec in fasta.read_fasta(path):
            out.append(f"{rec.label}\t{rec.label}:1..{len(rec.seq)}\n")
    return "".join(out)


@dataclass
class BuiltGenome:
    codes: np.ndarray       # uint8 2-bit codes, concatenated genome
    flags: np.ndarray       # bool N/X flags
    chr_names: list[str]
    chr_ends: np.ndarray    # int64 exclusive universal end coords


def load_genome_fasta(fasta_paths: list[str]) -> BuiltGenome:
    names: list[str] = []
    parts_c: list[np.ndarray] = []
    parts_f: list[np.ndarray] = []
    ends: list[int] = []
    total = 0
    for path in fasta_paths:
        for rec in fasta.read_fasta(path):
            codes, flags = dna.encode(rec.seq)
            names.append(rec.label)
            parts_c.append(codes)
            parts_f.append(flags)
            total += len(codes)
            ends.append(total)
    return BuiltGenome(
        codes=np.concatenate(parts_c) if parts_c else np.zeros(0, np.uint8),
        flags=np.concatenate(parts_f) if parts_f else np.zeros(0, bool),
        chr_names=names,
        chr_ends=np.asarray(ends, dtype=np.int64),
    )


def build_db(
    fasta_paths: list[str],
    dbname: str,
    destdir: str,
    k: int = 12,
    basesize: int | None = None,
    interval: int = 3,
    sort: int = NO_SORT,
) -> str:
    """Build a complete database directory; returns its path."""
    g = load_genome_fasta(fasta_paths)
    dbdir = os.path.join(destdir, dbname)
    os.makedirs(dbdir, exist_ok=True)
    os.makedirs(os.path.join(dbdir, f"{dbname}.maps"), exist_ok=True)
    base = os.path.join(dbdir, dbname)

    if basesize is None:
        basesize = min(12, k)

    with open(f"{base}.version", "w") as f:
        f.write(f"{dbname}\n")

    # chromosome text + IIT (gmapindex.c:408-485); universal 0-based coords
    chr_starts = np.concatenate([[0], g.chr_ends[:-1]])
    with open(f"{base}.chromosome", "w") as f:
        for name, s, e in zip(g.chr_names, chr_starts, g.chr_ends):
            f.write(f"{name}\t{s + 1}..{e}\t{e - s}\n")
    with open(f"{base}.chrsubset", "w") as f:
        f.write(">all\n\n")
        if len(g.chr_names) <= 100:
            for name in g.chr_names:
                f.write(f">{name}\n+{name}\n")

    chr_iit = IIT(version=1, divsort=sort)
    for name, s, e in zip(g.chr_names, chr_starts, g.chr_ends):
        chr_iit.add("", name, Interval(int(s), int(e) - 1, 0, 0))
    chr_iit.write(f"{base}.chromosome.iit", version=1)

    # contig text + IIT (gmapindex.c:560-705): one contig per chromosome here
    with open(f"{base}.contig", "w") as f:
        for name, s, e in zip(g.chr_names, chr_starts, g.chr_ends):
            f.write(f"{name}\t{s + 1}..{e}\t{name}:1..{e - s}\t{e - s}\n")
    contig_iit = IIT(version=1, divsort=sort)
    for name, s, e in zip(g.chr_names, chr_starts, g.chr_ends):
        contig_iit.add("", name, Interval(int(s), int(e) - 1, 0, 0))
    contig_iit.write(f"{base}.contig.iit", version=1)

    genomecomp.write(f"{base}.genomecomp", g.codes, g.flags)

    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, k, interval)
    if basesize == k:
        indexdb.write_offsets_flat(f"{base}.ref{basesize:02d}{k:02d}{interval}offsetscomp", offsets)
    else:
        indexdb.write_offsets_gamma(
            f"{base}.ref{basesize:02d}{k:02d}{interval}gammaptrs",
            f"{base}.ref{basesize:02d}{k:02d}{interval}offsetscomp",
            offsets,
            basesize,
            k,
        )
    indexdb.write_positions(f"{base}.ref{k:02d}{interval}positions", positions)
    return dbdir
