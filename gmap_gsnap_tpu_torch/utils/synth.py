"""Synthetic genomes and planted single-end reads, made from a seed.

Used by the tests (a few hundred kbp) and by ``chip_smoke.py`` (about
100 Mbp).  A genome has N runs and one family of near-identical repeat
copies, so reads from it overflow the seed grid (``trunc``) and the
candidate budget (``ndistinct > ncand``).  Reads carry their planted
truth, so a run can check where each one should map.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gmap_gsnap_tpu.db import indexdb
from gmap_gsnap_tpu.db.datadir import GenomeDB
from gmap_gsnap_tpu.io.fasta import Record
from gmap_gsnap_tpu.utils import dna

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


@dataclass
class Genome:
    names: list[str]
    ascii: np.ndarray     # uint8[G] concatenated chromosomes (A/C/G/T/N)
    chr_ends: np.ndarray  # int64[nchrs] exclusive universal ends
    repeats: np.ndarray   # int64[ncopies] starts of the repeat copies
    repeat_unit: int

    @property
    def codes_flags(self) -> tuple[np.ndarray, np.ndarray]:
        return dna.CODE_TABLE[self.ascii], dna.FLAG_TABLE[self.ascii]

    def write_fasta(self, path: str) -> None:
        starts = np.concatenate([[0], self.chr_ends[:-1]])
        with open(path, "w") as f:
            for name, s, e in zip(self.names, starts, self.chr_ends):
                f.write(f">{name}\n")
                seq = self.ascii[s:e].tobytes().decode()
                for i in range(0, len(seq), 80):
                    f.write(seq[i : i + 80] + "\n")


def make_genome(rng: np.random.Generator, chr_lengths, n_runs: int = 4,
                repeat_unit: int = 400, repeat_copies: int = 48) -> Genome:
    """Random chromosomes with ``n_runs`` N runs (20-300 nt) each and
    ``repeat_copies`` copies (1% diverged) of one ``repeat_unit``-nt
    sequence scattered over the genome."""
    total = int(sum(chr_lengths))
    g = _ACGT[rng.integers(0, 4, total)]
    unit = _ACGT[rng.integers(0, 4, repeat_unit)]
    copies = np.sort(rng.integers(0, total - repeat_unit, repeat_copies))
    for p in copies:
        copy = unit.copy()
        mut = rng.random(repeat_unit) < 0.01
        copy[mut] = _ACGT[rng.integers(0, 4, int(mut.sum()))]
        g[p : p + repeat_unit] = copy
    ends = np.cumsum(np.asarray(chr_lengths, np.int64))
    starts = np.concatenate([[0], ends[:-1]])
    for s, e in zip(starts, ends):
        for _ in range(n_runs):
            ln = int(rng.integers(20, 300))
            p = int(rng.integers(s, e - ln))
            g[p : p + ln] = ord("N")
    return Genome([f"chr{i + 1}" for i in range(len(chr_lengths))], g, ends,
                  copies.astype(np.int64), repeat_unit)


@dataclass
class Truth:
    left: int      # universal start of the planted placement (plus strand)
    plusp: bool
    kind: str
    nsub: int      # substitutions planted


READ_KINDS = ("sub", "n", "mid_indel", "end_indel", "terminal", "repeat",
              "junk")


def plant_reads(rng: np.random.Generator, genome: Genome, n: int,
                L: int = 100, weights=None, prefix: str = "r"):
    """``n`` reads of length L with their truth.  ``weights`` gives the
    share of each kind in READ_KINDS (default: substitutions only):

    sub: 0-3 substitutions; n: 1-2 query Ns; mid_indel: a 1-3 nt
    insertion or deletion 30-70 nt in; end_indel: the same 5-9 nt from
    an end; terminal: the last 15-25 nt random; repeat: a read inside a
    repeat copy; junk: random sequence.  Half the reads are reverse
    complemented.  Placements avoid N runs and chromosome ends."""
    w = np.zeros(len(READ_KINDS)) if weights is None else None
    if weights is None:
        w[0] = 1.0
    else:
        w = np.asarray([weights.get(k, 0.0) for k in READ_KINDS], float)
    kinds = rng.choice(len(READ_KINDS), size=n, p=w / w.sum())
    g = genome.ascii
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    nmask = g == ord("N")
    ncum = np.concatenate([[0], np.cumsum(nmask)])
    records, truth = [], []
    for i in range(n):
        kind = READ_KINDS[int(kinds[i])]
        span = L + 3
        while True:
            c = int(rng.integers(0, len(starts)))
            lo, hi = int(starts[c]), int(genome.chr_ends[c]) - span
            p = int(rng.integers(lo, hi))
            if kind == "repeat":
                p = int(rng.choice(genome.repeats)) + int(
                    rng.integers(0, genome.repeat_unit - span))
                if not lo <= p < hi:
                    continue
            if ncum[p + span] - ncum[p] == 0:
                break
        seq = g[p : p + span].copy()
        nsub = 0
        if kind == "mid_indel" or kind == "end_indel":
            size = int(rng.integers(1, 4))
            at = (int(rng.integers(30, 71)) if kind == "mid_indel"
                  else int(rng.choice([rng.integers(5, 10),
                                       L - int(rng.integers(5, 10))])))
            if rng.random() < 0.5:   # deletion from the read
                seq = np.concatenate([seq[:at], seq[at + size :]])
            else:                    # insertion into the read
                ins = _ACGT[rng.integers(0, 4, size)]
                seq = np.concatenate([seq[:at], ins, seq[at:]])
        seq = seq[:L]
        if kind in ("sub", "n", "repeat"):
            nsub = int(rng.integers(0, 4))
            for q in rng.choice(L, nsub, replace=False):
                seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                                + rng.integers(1, 4)) % 4]
        if kind == "n":
            seq[rng.choice(L, int(rng.integers(1, 3)), replace=False)] = ord("N")
        if kind == "terminal":
            t = int(rng.integers(15, 26))
            seq[L - t :] = _ACGT[rng.integers(0, 4, t)]
        if kind == "junk":
            seq = _ACGT[rng.integers(0, 4, L)]
        plusp = bool(rng.random() < 0.5)
        if not plusp:
            seq = _COMP[seq[::-1]]
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        name = f"{prefix}{i}"
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        truth.append(Truth(p, plusp, kind, nsub))
    return records, truth


@dataclass
class SplicedTruth:
    left: int          # universal start of the read's first piece (plus strand)
    plusp: bool
    kind: str          # one of SPLICED_KINDS
    junctions: tuple   # ((donor, acceptor), ...): introns [donor, acceptor)
    flanks: tuple      # aligned piece lengths in genome order
    nsub: int          # substitutions planted


SPLICED_KINDS = ("unspliced", "junction", "shortexon", "distant", "n_indel")
MIN_SITE_PROB = 0.90


def _good_sites(genome: Genome, codes: np.ndarray, lo: int, hi: int,
                kind: str, min_prob: float = MIN_SITE_PROB) -> np.ndarray:
    """Splice sites in [lo, hi) whose maxent probability (the port's
    host splice_prob_np) is >= min_prob, in plus-strand coordinates: a
    donor (GT) or antiacceptor (CT) site is the first base of the
    dinucleotide, where an intron starts; an acceptor (AG) or antidonor
    (AC) site is the base after it, where the next exon starts."""
    from ..ops import maxent

    g = genome.ascii
    lo, hi = max(int(lo), 25), min(int(hi), len(g) - 25)
    if hi <= lo:
        return np.zeros(0, np.int64)
    w = g[lo - 2 : hi + 2]
    a, b = {"donor": b"GT", "antiacceptor": b"CT", "acceptor": b"AG",
            "antidonor": b"AC"}[kind]
    if kind in ("donor", "antiacceptor"):
        pos = np.flatnonzero((w[2:-1] == a) & (w[3:] == b)) + lo
    else:
        pos = np.flatnonzero((w[:-3] == a) & (w[1:-2] == b)) + lo
    pos = pos[pos < hi]
    if not len(pos):
        return pos
    return pos[maxent.splice_prob_np(codes, pos, kind) >= min_prob]


def plant_spliced_reads(rng: np.random.Generator, genome: Genome, n: int,
                        weights=None, L: int = 100, prefix: str = "s"):
    """``n`` RNA-seq-like reads of length L with their truth
    (SplicedTruth).  ``weights`` gives the share of each kind in
    SPLICED_KINDS (default 50/30/10/5/5%):

    unspliced: a genomic read with 0-3 substitutions; junction: two
    exon pieces (each >= 12 nt) around one GT..AG intron of 80-20,000 nt
    whose donor and acceptor maxent probabilities are both >= 0.90;
    shortexon: three pieces around two such introns, the middle exon
    20-45 nt; distant: halves of 40-60 nt ending at a donor and starting
    after an acceptor on another chromosome, or > 200 kb away on the same
    one; n_indel: plant_reads' "n" or "mid_indel" reads.  A spliced
    read's gene lies on either strand: on the minus strand its introns
    read CT..AC on the plus strand (antiacceptor, antidonor sites).
    Spliced reads carry 0-2 substitutions (distant 0-1).  Half the reads
    are reverse complemented.  Pieces avoid N runs and chromosome ends."""
    if weights is None:
        weights = dict(unspliced=0.5, junction=0.3, shortexon=0.1,
                       distant=0.05, n_indel=0.05)
    w = np.asarray([weights.get(k, 0.0) for k in SPLICED_KINDS], float)
    kinds = rng.choice(len(SPLICED_KINDS), size=n, p=w / w.sum())
    g = genome.ascii
    codes = genome.codes_flags[0]
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    ncum = np.concatenate([[0], np.cumsum(g == ord("N"))])
    clen = genome.chr_ends - starts

    def chrom_of(p):
        return int(np.searchsorted(genome.chr_ends, p, side="right"))

    def clean(a, b):      # [a, b) free of N and inside one chromosome
        return (0 <= a < b <= len(g) and ncum[b] - ncum[a] == 0
                and chrom_of(a) == chrom_of(b - 1))

    def rand_site(kind, c=None):
        while True:
            cc = int(rng.choice(len(starts), p=clen / clen.sum())) if c is None else c
            p = int(rng.integers(starts[cc] + 200, genome.chr_ends[cc] - 2200))
            sites = _good_sites(genome, codes, p, p + 2000, kind)
            if len(sites):
                return int(rng.choice(sites))

    def pick(sites):
        return int(rng.choice(sites)) if len(sites) else None

    n_indel = plant_reads(
        rng, genome, int((kinds == SPLICED_KINDS.index("n_indel")).sum()), L,
        weights=dict(n=1, mid_indel=1))
    n_indel = iter(zip(*n_indel))
    records, truth = [], []
    for i in range(n):
        kind = SPLICED_KINDS[int(kinds[i])]
        name = f"{prefix}{i}"
        if kind == "n_indel":
            r, t = next(n_indel)
            records.append(Record(name, name, r.seq, r.quality))
            truth.append(SplicedTruth(t.left, t.plusp, kind, (), (L,), t.nsub))
            continue
        # intron start / end site kinds of the read's gene strand
        ks, ke = (("donor", "acceptor") if rng.random() < 0.5
                  else ("antiacceptor", "antidonor"))
        while True:
            if kind == "unspliced":
                p = int(rng.integers(0, len(g) - L))
                pieces, juncs = [(p, p + L)], ()
            elif kind == "junction":
                s = rand_site(ks)
                e = pick(_good_sites(genome, codes, s + 80, s + 20_001, ke))
                if e is None:
                    continue
                a = int(rng.integers(12, L - 11))
                pieces, juncs = [(s - a, s), (e, e + L - a)], ((s, e),)
            elif kind == "shortexon":
                e1 = rand_site(ke)
                s2 = pick(_good_sites(genome, codes, e1 + 20, e1 + 46, ks))
                if s2 is None:
                    continue
                s1 = pick(_good_sites(genome, codes, e1 - 20_000, e1 - 79, ks))
                e2 = pick(_good_sites(genome, codes, s2 + 80, s2 + 20_001, ke))
                m = s2 - e1
                if s1 is None or e2 is None or L - m < 24:
                    continue
                a = int(rng.integers(12, L - m - 11))
                pieces = [(s1 - a, s1), (e1, s2), (e2, e2 + L - a - m)]
                juncs = ((s1, e1), (s2, e2))
            else:  # distant
                s = rand_site(ks)
                c = chrom_of(s)
                far = [cc for cc in range(len(starts))
                       if cc != c or clen[cc] > 450_000]
                cc = int(rng.choice(far))
                e = rand_site(ke, cc)
                if abs(e - s) <= 200_000:
                    continue
                a = int(rng.integers(40, 61))
                pieces, juncs = [(s - a, s), (e, e + L - a)], ((s, e),)
            if all(clean(x, y) for x, y in pieces):
                break
        seq = np.concatenate([g[x:y] for x, y in pieces])
        nmax = {"unspliced": 3, "distant": 1}.get(kind, 2)
        nsub = int(rng.integers(0, nmax + 1))
        for q in rng.choice(L, nsub, replace=False):
            seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                            + rng.integers(1, 4)) % 4]
        plusp = bool(rng.random() < 0.5)
        if not plusp:
            seq = _COMP[seq[::-1]]
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        truth.append(SplicedTruth(pieces[0][0], plusp, kind, juncs,
                                  tuple(y - x for x, y in pieces), nsub))
    return records, truth


def genome_db(genome: Genome, k: int, interval: int,
              dbname: str = "synthetic") -> GenomeDB:
    """An in-memory GenomeDB of ``genome`` with a k-mer index from
    db.indexdb.build_index — what GenomeDB.open returns after
    gmap_build, without the files."""
    codes, flags = genome.codes_flags
    ends = np.asarray(genome.chr_ends, np.int64)
    db = GenomeDB(dbdir="", dbname=dbname, codes=codes, flags=flags,
                  chr_names=list(genome.names),
                  chr_starts=np.concatenate([[0], ends[:-1]]),
                  chr_ends=ends, k=k, interval=interval, basesize=k)
    # fill the lazily read index properties directly
    db.offsets, db.positions = indexdb.build_index(codes, flags, ends, k,
                                                   interval)
    return db


def write_fastq(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f"@{r.header}\n{r.seq}\n+\n{r.quality}\n")
