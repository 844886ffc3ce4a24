"""Index transforms: bisulfite (cmet), RNA-editing (atoi), SNP-tolerant.

gmap_gsnap_tpu/db/transforms.py, copied (replaces cmetindex.c /
atoiindex.c / snpindex.c).  Where the reference transforms the stored
oligos of an existing index (converting each oligo and re-sorting
positions, cmetindex.c:196-243), the index is rebuilt over the
nucleotide-converted genome — identical results (the converted oligo at
position p equals the oligo at p of the converted genome).

Conversions (cmet.c / atoi.c semantics):
    metct: C -> T      metga: G -> A
    a2iag: A -> G      a2itc: T -> C
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import dna
from . import genomecomp, indexdb
from .iit import IIT

CONVERSIONS = {
    "metct": (dna.C, dna.T),
    "metga": (dna.G, dna.A),
    "a2iag": (dna.A, dna.G),
    "a2itc": (dna.T, dna.C),
}


def convert_codes(codes: np.ndarray, conversion: str) -> np.ndarray:
    src, dst = CONVERSIONS[conversion]
    out = codes.copy()
    out[codes == src] = dst
    return out


def build_converted_index(
    codes: np.ndarray,
    flags: np.ndarray,
    chr_ends,
    conversion: str,
    k: int = 12,
    interval: int = 3,
):
    conv = convert_codes(codes, conversion)
    return indexdb.build_index(conv, flags, chr_ends, k, interval)


def write_converted_indexes(
    dbdir: str, dbname: str, codes, flags, chr_ends,
    kind: str, k: int = 12, basesize: int | None = None, interval: int = 3,
) -> None:
    """kind 'cmet' writes metct+metga; 'atoi' writes a2iag+a2itc
    (cmetindex.c:641-652 / atoiindex.c naming)."""
    if basesize is None:
        basesize = min(12, k)
    base = os.path.join(dbdir, dbname)
    names = ("metct", "metga") if kind == "cmet" else ("a2iag", "a2itc")
    for prefix in names:
        offsets, positions = build_converted_index(
            codes, flags, chr_ends, prefix, k, interval
        )
        if basesize == k:
            indexdb.write_offsets_flat(
                f"{base}.{prefix}{basesize:02d}{k:02d}{interval}offsetscomp", offsets
            )
        else:
            indexdb.write_offsets_gamma(
                f"{base}.{prefix}{basesize:02d}{k:02d}{interval}gammaptrs",
                f"{base}.{prefix}{basesize:02d}{k:02d}{interval}offsetscomp",
                offsets, basesize, k,
            )
        indexdb.write_positions(f"{base}.{prefix}{k:02d}{interval}positions", positions)


# ------------------------------------------------------------------ snpindex

def alt_genome_from_snps(codes: np.ndarray, snps_iit: IIT, chr_names, chr_starts):
    """Substitute minor alleles into a copy of the genome.

    SNP convention (snpindex.c:296-345): the IIT *type* string holds the
    two alleles (e.g. type "CG"); whichever matches the reference base
    is the major allele, the other is substituted.  IIT coords 1-based.
    """
    alt = codes.copy()
    name_to_idx = {n: i for i, n in enumerate(chr_names)}
    code_of = {"A": dna.A, "C": dna.C, "G": dna.G, "T": dna.T}
    for div in snps_iit.divs_in_file_order():
        if div == "":
            continue
        ci = name_to_idx.get(div)
        if ci is None:
            continue
        off = int(chr_starts[ci])
        for iv in snps_iit.intervals[div]:
            snptype = snps_iit.types[iv.type] if iv.type < len(snps_iit.types) else ""
            if len(snptype) != 2:
                continue
            pos = off + iv.low - 1
            if pos < 0 or pos >= len(alt):
                continue
            a0, a1 = snptype[0], snptype[1]
            if a0 in code_of and a1 in code_of:
                if alt[pos] == code_of[a0]:
                    alt[pos] = code_of[a1]
                elif alt[pos] == code_of[a1]:
                    alt[pos] = code_of[a0]
    return alt


def snp_kmer_pairs(codes, flags, chr_ends, snp_pos, snp_alt, k, interval):
    """Enumerate (oligo, position) pairs of SNP-substituted k-mers.

    Mirrors snpindex.c process_snp_block: SNPs within k of each other
    form a block; every allele combination except all-reference yields
    oligomers for each sampled window start covering >= 1 SNP.
    snp_pos: absolute 0-based positions; snp_alt: alt codes (or -1 = N,
    skipped since N never appears in an oligo).
    """
    import itertools

    chr_ends = np.asarray(chr_ends, dtype=np.int64)
    chr_starts = np.concatenate([[0], chr_ends[:-1]])
    order = np.argsort(snp_pos)
    snp_pos = np.asarray(snp_pos)[order]
    snp_alt = np.asarray(snp_alt)[order]
    n = len(codes)
    pairs = set()
    i = 0
    while i < len(snp_pos):
        j = i + 1
        while j < len(snp_pos) and snp_pos[j] < snp_pos[j - 1] + k:
            j += 1
        block = [(int(snp_pos[t]), int(snp_alt[t])) for t in range(i, j)
                 if snp_alt[t] >= 0]
        i = j
        if not block:
            continue
        ci = np.searchsorted(chr_ends, block[0][0], side="right")
        cs, ce = int(chr_starts[ci]), int(chr_ends[ci])
        lo = max(cs, block[0][0] - k + 1)
        hi = min(ce - k, block[-1][0])
        for s in range(lo, hi + 1):
            if (s - cs) % interval != 0:
                continue
            window = codes[s : s + k]
            if flags[s : s + k].any():
                continue
            inwin = [(p - s, a) for p, a in block if s <= p < s + k]
            if not inwin:
                continue
            # every non-empty subset substituted
            for r in range(1, len(inwin) + 1):
                for combo in itertools.combinations(inwin, r):
                    w = window.copy()
                    for off, a in combo:
                        w[off] = a
                    oligo = 0
                    for c in w:
                        oligo = (oligo << 2) | int(c)
                    pairs.add((oligo, s))
    return pairs


def write_snp_index(
    dbdir: str, dbname: str, snpsname: str,
    codes, flags, chr_ends, alt_codes,
    snp_pos=None, snp_alt=None,
    k: int = 12, basesize: int | None = None, interval: int = 3,
    ref_index=None,
) -> None:
    """Write the SNP-tolerant index (snpindex.c): ref positions merged
    with SNP-substituted k-mer positions.  File naming appends the snps
    name: <db>.genomecomp.<snps>, <db>.ref<BB><KK><Q>offsetscomp.<snps>
    (+ gammaptrs when BB<KK), <db>.ref<KK><Q>positions.<snps>.

    ``ref_index`` is the reference index (offsets, positions) when the
    caller has it already (else it is built).  The files equal the JAX
    function's; the merge differs from its code only in never expanding
    an array over the whole 4^k oligo space (at k = 15 that is 8.6 GB of
    int64 per array): each reference position finds its oligo by a
    search in the offsets, the SNP oligos' counts are added to the
    offsets, and one stable sort of (oligo, position) keys merges both."""
    if basesize is None:
        basesize = min(12, k)
    base = os.path.join(dbdir, dbname)
    # the alt genomecomp marks every substituted position with the flag
    # bit (SNP marker, not an N) — snpindex.c behavior
    alt_flags = flags | (alt_codes != codes)
    genomecomp.write(f"{base}.genomecomp.{snpsname}", alt_codes, alt_flags)

    if ref_index is None:
        ref_index = indexdb.build_index(codes, flags, chr_ends, k, interval)
    off_r, pos_r = ref_index

    if snp_pos is None:
        snp_pos = np.flatnonzero(alt_codes != codes)
        snp_alt = alt_codes[snp_pos]
    extra = snp_kmer_pairs(codes, flags, chr_ends, snp_pos, snp_alt, k, interval)

    offsets = np.asarray(off_r, np.uint32).copy()
    positions = np.asarray(pos_r, np.uint32)
    if extra:
        e = np.array(sorted(extra), dtype=np.int64)
        cnt = np.zeros(len(offsets), np.uint32)
        np.add.at(cnt, e[:, 0] + 1, 1)
        np.cumsum(cnt, out=cnt)
        offsets += cnt
        o_r = np.searchsorted(off_r,
                              np.arange(len(pos_r)), side="right") - 1
        key = np.concatenate([(o_r.astype(np.int64) << 32) | pos_r,
                              (e[:, 0] << 32) | e[:, 1]])
        key = np.sort(key, kind="stable")
        positions = (key & 0xFFFFFFFF).astype(np.uint32)

    if basesize == k:
        indexdb.write_offsets_flat(
            f"{base}.ref{basesize:02d}{k:02d}{interval}offsetscomp.{snpsname}", offsets
        )
    else:
        indexdb.write_offsets_gamma(
            f"{base}.ref{basesize:02d}{k:02d}{interval}gammaptrs.{snpsname}",
            f"{base}.ref{basesize:02d}{k:02d}{interval}offsetscomp.{snpsname}",
            offsets, basesize, k,
        )
    indexdb.write_positions(
        f"{base}.ref{k:02d}{interval}positions.{snpsname}", positions
    )
