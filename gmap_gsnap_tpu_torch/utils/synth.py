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

from ..db import indexdb
from ..db.datadir import GenomeDB
from ..io.fasta import Record
from . import dna

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


SPLICED_KINDS = ("unspliced", "junction", "shortexon", "distant", "n_indel",
                 "messy_junction")
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
    one; n_indel: plant_reads' "n" or "mid_indel" reads; messy_junction:
    a junction read (pieces >= 20 nt) with a 1-3 nt insertion or
    deletion, or 2-3 substitutions, within 11 nt of its junction — the
    reads GSNAP's cascade leaves to the GMAP lanes, whose junction
    dynprog re-solves them.  A spliced
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
            elif kind in ("junction", "messy_junction"):
                s = rand_site(ks)
                e = pick(_good_sites(genome, codes, s + 80, s + 20_001, ke))
                if e is None:
                    continue
                edge = 12 if kind == "junction" else 20
                a = int(rng.integers(edge, L - edge + 1))
                # a messy read takes 3 nt more, for a deletion to eat
                extra = 3 if kind == "messy_junction" else 0
                pieces, juncs = [(s - a, s), (e, e + L - a + extra)], ((s, e),)
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
        subs = rng.choice(L, nsub, replace=False)
        if kind == "messy_junction":
            nsub = 0
            at = a + int(rng.integers(-11, 12))
            if rng.random() < 0.5:
                size = int(rng.integers(1, 4))
                if rng.random() < 0.5:   # deletion from the read
                    seq = np.concatenate([seq[:at], seq[at + size :]])
                else:                    # insertion into the read
                    seq = np.concatenate([seq[:at], _ACGT[rng.integers(
                        0, 4, size)], seq[at:]])
            else:
                nsub = int(rng.integers(2, 4))
                subs = np.clip(a + rng.choice(np.arange(-11, 12), nsub,
                                              replace=False), 0, L - 1)
            seq = seq[:L]
        for q in subs:
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


@dataclass
class PairTruth:
    kind: str          # one of PAIR_KINDS
    lefts: tuple       # per read (read 1, read 2): universal start of its
    #                    aligned placement (plus strand), -1 if random
    insert: int        # fragment length for concordant kinds, else 0
    nsub: tuple        # substitutions planted per read
    introns: tuple     # per read: introns [donor, acceptor) it spans
    flanks: tuple      # per read: aligned piece lengths in genome order


SPLICED_PAIR_KINDS = ("junction", "across", "shortexon", "messy_junction")
PAIR_KINDS = ("concordant", "indel", "halfmapping", "random", "toolong",
              "inversion", "scramble", "transloc", "repeat",
              *SPLICED_PAIR_KINDS)
DNA_PAIR_MIX = dict(concordant=0.80, indel=0.04, halfmapping=0.03,
                    random=0.02, toolong=0.03, inversion=0.02, scramble=0.02,
                    transloc=0.02, repeat=0.02)
RNA_PAIR_MIX = dict(junction=0.30, across=0.10, shortexon=0.05,
                    **{k: 0.55 * v for k, v in DNA_PAIR_MIX.items()})


def plant_pairs(rng: np.random.Generator, genome: Genome, n: int,
                L: int = 100, weights=None, rna: bool = False,
                prefix: str = "q"):
    """``n`` read pairs (records of read 1, records of read 2, truth
    PairTruth per pair), both reads length L, read 2 written as the
    reverse complement of the fragment's end (gsnap's default FR
    orientation).  ``weights`` gives the share of each kind in
    PAIR_KINDS; the default is DNA_PAIR_MIX, or RNA_PAIR_MIX with
    ``rna``:

    concordant: a 200-600 nt fragment, 0-3 substitutions per read;
    indel: the same with a 1-3 nt insertion or deletion 30-70 nt into
    one read; halfmapping: one read random; random: both; toolong: read
    2 2-50 kb downstream; inversion: read 2 on the fragment's strand;
    scramble: read 2 50-500 nt upstream of read 1; transloc: read 2 on
    another chromosome; repeat: the fragment inside one repeat copy (its
    reads overflow the candidate budget); junction: one read across a
    GT-AG or CT-AC intron (80-20,000 nt, maxent >= 0.90 at both sites),
    the other on one exon; across: the two reads on the two sides of
    such an intron; shortexon: one read across a 20-45 nt middle exon;
    messy_junction (in no default mix): a junction pair whose spliced read
    (pieces >= 20 nt) carries a 1-3 nt insertion or deletion, or 2-3
    substitutions, within 11 nt of the junction — reads the GSNAP cascade
    leaves to the GMAP lanes.  Spliced reads carry 0-2 substitutions.  30% of the pairs are written
    mate first (read 1 from the fragment's other end), so both strands
    occur.  Placements avoid N runs and chromosome ends."""
    if weights is None:
        weights = RNA_PAIR_MIX if rna else DNA_PAIR_MIX
    w = np.asarray([weights.get(k, 0.0) for k in PAIR_KINDS], float)
    kinds = rng.choice(len(PAIR_KINDS), size=n, p=w / w.sum())
    g = genome.ascii
    codes = genome.codes_flags[0]
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    clen = genome.chr_ends - starts
    ncum = np.concatenate([[0], np.cumsum(g == ord("N"))])

    def chrom_of(p):
        return int(np.searchsorted(genome.chr_ends, p, side="right"))

    def clean(a, b):      # [a, b) free of N and inside one chromosome
        return (0 <= a < b <= len(g) and ncum[b] - ncum[a] == 0
                and chrom_of(a) == chrom_of(b - 1))

    def rand_chrom():
        return int(rng.choice(len(starts), p=clen / clen.sum()))

    def rand_pos(span, c=None):
        c = rand_chrom() if c is None else c
        return int(rng.integers(starts[c] + 100, genome.chr_ends[c] - span - 100))

    def rand_site(kind):
        while True:
            p = rand_pos(2400)
            sites = _good_sites(genome, codes, p, p + 2000, kind)
            if len(sites):
                return int(rng.choice(sites))

    def pick(sites):
        return int(rng.choice(sites)) if len(sites) else None

    def tx_slice(exons, t0, t1):
        """Genomic pieces of transcript positions [t0, t1)."""
        out, t = [], 0
        for x, y in exons:
            a, b = max(t0, t), min(t1, t + (y - x))
            if a < b:
                out.append((x + a - t, x + b - t))
            t += y - x
        return out

    def spliced(kind):
        """(pieces of read 1, pieces of read 2, fragment length, introns)
        of one RNA kind; None to retry."""
        ks, ke = (("donor", "acceptor") if rng.random() < 0.5
                  else ("antiacceptor", "antidonor"))
        ins = int(rng.integers(200, 601))
        if kind == "shortexon":
            e1 = rand_site(ke)
            s2 = pick(_good_sites(genome, codes, e1 + 20, e1 + 46, ks))
            if s2 is None:
                return None
            s1 = pick(_good_sites(genome, codes, e1 - 20_000, e1 - 79, ks))
            e2 = pick(_good_sites(genome, codes, s2 + 80, s2 + 20_001, ke))
            if s1 is None or e2 is None or L - (s2 - e1) < 24:
                return None
            exons = [(s1 - 700, s1), (e1, s2), (e2, e2 + 700)]
            a = int(rng.integers(12, L - (s2 - e1) - 11))
            t0 = 700 - a
            introns = ((s1, e1), (s2, e2))
        else:
            s = rand_site(ks)
            e = pick(_good_sites(genome, codes, s + 80, s + 20_001, ke))
            if e is None:
                return None
            exons = [(s - 700, s), (e, e + 700)]
            introns = ((s, e),)
            if kind == "across":
                t0 = int(rng.integers(700 - ins + L, 700 - L + 1))
            else:
                edge = 20 if kind == "messy_junction" else 12
                mate2 = rng.random() >= 0.5    # read 2 across the junction
                t0 = 700 - int(rng.integers(edge, L - edge + 1))
                if mate2:
                    t0 += L - ins
        if not all(clean(x, y) for x, y in exons):
            return None
        p1 = tx_slice(exons, t0, t0 + L)
        p2 = tx_slice(exons, t0 + ins - L, t0 + ins)
        inside = lambda p: tuple(iv for iv in introns
                                 if p[0][0] < iv[0] and iv[1] < p[-1][1])
        return p1, p2, ins, (inside(p1), inside(p2))

    def dna(kind):
        """(pieces of read 1, pieces of read 2 or None for random, read 2
        on the fragment's strand, fragment length) of one DNA kind."""
        ins = int(rng.integers(200, 601))
        if kind == "repeat":
            ins = min(ins, genome.repeat_unit)
            p = int(rng.choice(genome.repeats)) + int(
                rng.integers(0, genome.repeat_unit - ins + 1))
        else:
            p = rand_pos(ins)
        p1, p2 = [(p, p + L)], [(p + ins - L, p + ins)]
        if kind == "toolong":
            d = int(rng.integers(2_000, 50_001))
            p2 = [(p + L + d, p + 2 * L + d)]
        elif kind == "scramble":
            d = int(rng.integers(50, 501))
            p2 = [(p - d - L, p - d)]
        elif kind == "transloc":
            others = [c for c in range(len(starts)) if c != chrom_of(p)]
            q = rand_pos(L, int(rng.choice(others)))
            p2 = [(q, q + L)]
        if not all(clean(x, y) for x, y in p1 + p2):
            return None
        concordant = kind in ("concordant", "indel", "halfmapping", "repeat")
        return p1, p2, kind == "inversion", ins if concordant else 0

    def mutate(seq, nsub):
        for q in rng.choice(len(seq), nsub, replace=False):
            seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                            + rng.integers(1, 4)) % 4]

    r1s, r2s, truth = [], [], []
    for i in range(n):
        kind = PAIR_KINDS[int(kinds[i])]
        while True:
            made = spliced(kind) if kind in SPLICED_PAIR_KINDS else dna(kind)
            if made is not None:
                break
        if kind in SPLICED_PAIR_KINDS:
            p1, p2, ins, introns = made
            same_strand = False
        else:
            p1, p2, same_strand, ins = made
            introns = ((), ())
        seqs = [np.concatenate([g[x:y] for x, y in p]) for p in (p1, p2)]
        lefts = [p1[0][0], p2[0][0]]
        nmax = 2 if kind in SPLICED_PAIR_KINDS else 3
        nsub = [int(rng.integers(0, nmax + 1)) for _ in range(2)]
        if kind == "indel":
            m = int(rng.integers(0, 2))
            size, at = int(rng.integers(1, 4)), int(rng.integers(30, 71))
            x, y = (p1, p2)[m][0]
            w_ = g[x : y + 3] if m == 0 else g[x - 3 : y][::-1]
            if rng.random() < 0.5:             # deletion from the read
                w_ = np.concatenate([w_[:at], w_[at + size :]])
                span = L + size
            else:                              # insertion into the read
                w_ = np.concatenate([w_[:at], _ACGT[rng.integers(0, 4, size)],
                                     w_[at:]])
                span = L - size
            seqs[m] = w_[:L] if m == 0 else w_[:L][::-1]
            lefts[m] = x if m == 0 else y - span
        messy = None
        if kind == "messy_junction":
            messy = m = 0 if introns[0] else 1
            nsub[m] = 0
            (x, y), (_, y2) = (p1, p2)[m][:2]
            at = (y - x) + int(rng.integers(-11, 12))
            if rng.random() < 0.5:
                size = int(rng.integers(1, 4))
                w_ = np.concatenate([seqs[m], g[y2 : y2 + size]])
                if rng.random() < 0.5:         # deletion from the read
                    w_ = np.concatenate([w_[:at], w_[at + size :]])
                else:                          # insertion into the read
                    w_ = np.concatenate([w_[:at], _ACGT[rng.integers(
                        0, 4, size)], w_[at:]])
                seqs[m] = w_[:L]
            else:
                nsub[m] = int(rng.integers(2, 4))
                for q in at + rng.choice(np.arange(-11, 12), nsub[m],
                                         replace=False):
                    q = min(max(int(q), 0), L - 1)
                    seqs[m][q] = _ACGT[(np.flatnonzero(_ACGT == seqs[m][q])[0]
                                        + rng.integers(1, 4)) % 4]
        for m in range(2):
            if m != messy:
                mutate(seqs[m], nsub[m])
        if not same_strand:
            seqs[1] = _COMP[seqs[1][::-1]]
        for m in range(2):
            if (kind == "halfmapping" and m == 1) or kind == "random":
                seqs[m] = _ACGT[rng.integers(0, 4, L)]
                lefts[m], nsub[m] = -1, 0
        flanks = tuple(tuple(y - x for x, y in p) for p in (p1, p2))
        order = (1, 0) if rng.random() < 0.3 else (0, 1)   # mate first
        name = f"{prefix}{i}"
        quals = [(rng.integers(20, 41, L) + 33).astype(np.uint8)
                 for _ in range(2)]
        recs = [Record(name, name, seqs[m].tobytes().decode(),
                       quals[m].tobytes().decode()) for m in order]
        r1s.append(recs[0])
        r2s.append(recs[1])
        truth.append(PairTruth(kind, tuple(lefts[m] for m in order), ins,
                               tuple(nsub[m] for m in order),
                               tuple(introns[m] for m in order),
                               tuple(flanks[m] for m in order)))
    return r1s, r2s, truth


PAIR_HIT_BASES = (16_777_216 - 2_000, 100_000_000, 2**31 - 2_000,
                  2**32 - 8_000)


def pair_hit_cases(rng: np.random.Generator, b: int, chr_ends, nc: int = 24,
                   L: int = 100):
    """Hand-built candidate hits of ``b`` read pairs for the pairing grid,
    in ``gather_candidates``' layout: a dict of numpy [2b, nc] fields
    (rows :b read 1, b: read 2; left / right / mid uint32, kind, score,
    nmm, split, split2, nindels int32, sense, plusp bool, prob_* float32)
    and the read lengths int32 [b] of read 1 (all ``L``) and of read 2
    (``L`` on rows 0-2, ``L - 40 .. L`` on the others, so that the mates'
    own lengths enter refspans and the insert-0 rule).

    Each row clusters its hits near one base: a chromosome boundary
    (``chr_ends[0]``), just below 2^24, 10^8 (float32 spacing 8), just
    below 2^31 (int32 ends and pairmax sums wrap) or near 2^32.  Read-1
    lefts differ by 0-63, so above 2^24 many round to one float32; read-2
    lefts sit -3000..+3000 away (every pair type); kinds are mixed (sub,
    insertion, deletion, splice with an 80-5000 nt intron, short exon);
    scores 0-2 with ties, 10% invalid.  Row 0 holds a concordant cell
    whose insert length computes to 0 (read 2 inside read 1's intron),
    rows 1 and 2 have all 16 x 16 cells concordant at one score near
    10^8 and 2^31 (more than 100 chosen cells)."""
    n2 = 2 * b
    bases = np.asarray((int(chr_ends[0]) - 300,) + PAIR_HIT_BASES, np.int64)
    base = bases[rng.integers(0, len(bases), b)]
    off = np.where(rng.random((b, nc)) < 0.7,
                   rng.integers(100, 700, (b, nc)),
                   rng.integers(-3000, 3001, (b, nc)))
    left = np.concatenate([base[:, None] + rng.integers(0, 64, (b, nc)),
                           base[:, None] + off])
    kind = rng.choice(5, (n2, nc), p=[0.6, 0.1, 0.1, 0.1, 0.1])
    split = rng.integers(10, 60, (n2, nc))
    split2 = split + rng.integers(20, 40, (n2, nc))
    nind = np.where((kind == 1) | (kind == 2), rng.integers(1, 4, (n2, nc)), 0)
    intron = rng.integers(80, 5001, (n2, nc))
    right = np.select([kind == 1, kind == 2, kind >= 3],
                      [left - nind, left + nind, left + intron], left)
    mid = np.where(kind == 4, left + intron // 2, left)
    score = np.where(rng.random((n2, nc)) < 0.1, 10**6,
                     rng.integers(0, 3, (n2, nc)))
    plusp = rng.random((n2, nc)) < np.where(rng.random((n2, 1)) < 0.5,
                                            0.9, 0.1)
    for r, row_base in ((1, 100_000_000), (2, 2**31 - 150)):
        if r < b:                      # 16 x 16 concordant cells
            for rr, start in ((r, row_base), (b + r, row_base + 300)):
                left[rr] = start + 3 * np.arange(nc)
                kind[rr], nind[rr], score[rr] = 0, 0, 1
                right[rr] = mid[rr] = left[rr]
                plusp[rr] = True
    if b > 0:                          # insert-0 rejection: read 2 in an intron
        x = int(chr_ends[0]) // 2
        for rr, lft, k in ((0, x, 3), (b, x + 1_000, 0)):
            left[rr], kind[rr], score[rr], plusp[rr] = lft, k, 0, True
            nind[rr] = 0
            right[rr] = lft + (5_000 if k == 3 else 0)
            mid[rr] = lft
            split[rr] = 50
            score[rr, 1:] = 10**6
    u32 = lambda a: (a % 2**32).astype(np.uint32)
    z = np.zeros((n2, nc), np.float32)
    out = dict(kind=kind.astype(np.int32), score=score.astype(np.int32),
               nmm=np.where(score < 10**6, score, 0).astype(np.int32),
               left=u32(left), right=u32(right), mid=u32(mid),
               split=np.where(kind == 0, 0, split).astype(np.int32),
               split2=np.where(kind == 4, split2, 0).astype(np.int32),
               nindels=nind.astype(np.int32), sense=kind >= 3, plusp=plusp,
               prob_d=z, prob_a=z, prob_d2=z, prob_a2=z)
    lengths5 = np.full(b, L, np.int32)
    lengths3 = (L - rng.integers(0, 41, b)).astype(np.int32)
    lengths3[:3] = L
    return out, lengths5, lengths3


def pair_gate_cases(rng: np.random.Generator, b: int):
    """The candidate-budget state of ``b`` read pairs for the pair
    overflow gate, in ``gather_candidates``' layout ([2b] rows: :b read 1,
    b: read 2): overflow (80%) and overflow_trunc (25%) bool, and the
    floor bounds ovf_bound / hbound int32 from 0-8 (around the best pair
    score + subopt of ``pair_hit_cases``' scores 0-2), BIG_NMM, and 2^31 -
    2 (whose sum with an end score wraps in int32), so that each of the
    gate's terms flips across the rows; plus cand_left, which the gate
    passes through."""
    n2 = 2 * b
    vals = np.asarray([0, 1, 2, 3, 4, 5, 6, 8, 10**6, 2**31 - 2], np.int64)
    return {
        "overflow": rng.random(n2) < 0.8,
        "overflow_trunc": rng.random(n2) < 0.25,
        "ovf_bound": rng.choice(vals, n2).astype(np.int32),
        "hbound": rng.choice(vals, n2).astype(np.int32),
        "cand_left": rng.integers(0, 2**31, (n2, 4)).astype(np.int64),
    }


# ------------------------------------------------ known sites (-s) and SNPs (-v)

@dataclass
class Intron:
    donor: int         # first intron base (plus strand, universal)
    acceptor: int      # first base after the intron
    sense: bool        # gene on the plus strand (GT..AG-style sites)


def _ncum(genome: Genome) -> np.ndarray:
    """Cumulative N counts of the genome (computed once per genome)."""
    if getattr(genome, "_ncum_cache", None) is None:
        genome._ncum_cache = np.concatenate(
            [[0], np.cumsum(genome.ascii == ord("N"))])
    return genome._ncum_cache


def random_introns(rng: np.random.Generator, genome: Genome, n: int,
                   canonical: bool = True, lo: int = 80,
                   hi: int = 20_000) -> list[Intron]:
    """``n`` introns of ``lo``..``hi`` nt inside one chromosome, free of
    N, half on each strand.  Canonical ones read GT..AG (sense) or CT..AC
    (antisense) on the plus strand; non-canonical ones neither (they are
    found only through a known-site map)."""
    g = genome.ascii
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    ncum = _ncum(genome)
    # dinucleotide codes of g[a : b + 1]
    dn = lambda a, b: g[a:b].astype(np.int32) * 256 + g[a + 1 : b + 1]
    code = lambda s: s[0] * 256 + s[1]
    canon_don = {True: code(b"GT"), False: code(b"CT")}
    canon_acc = {True: code(b"AG"), False: code(b"AC")}
    out = []
    while len(out) < n:
        m = max(2 * (n - len(out)), 64)
        s = rng.integers(200, len(g) - hi - 400, m)
        e = s + rng.integers(lo, hi + 1, m)
        sense = rng.random(m) < 0.5
        chrom = np.searchsorted(genome.chr_ends, s, side="right")
        same = np.searchsorted(genome.chr_ends, e + 200, side="right") == chrom
        ok = same & (s - starts[np.minimum(chrom, len(starts) - 1)] > 200)
        ok &= (ncum[e + 200] - ncum[s - 200]) == 0
        for i in np.flatnonzero(ok):
            sd, ea = int(dn(s[i], s[i] + 1)[0]), int(dn(e[i] - 2, e[i] - 1)[0])
            if canonical:
                # move the sites onto the nearest canonical dinucleotides
                cd, ca = canon_don[bool(sense[i])], canon_acc[bool(sense[i])]
                sp = np.flatnonzero(dn(s[i], s[i] + 400) == cd)
                ep = np.flatnonzero(dn(e[i] - 2, e[i] + 398) == ca)
                if not len(sp) or not len(ep):
                    continue
                ss, ee = int(s[i] + sp[0]), int(e[i] + ep[0])
                if ee - ss < lo or ncum[ee + 200] - ncum[ss - 200]:
                    continue
                out.append(Intron(ss, ee, bool(sense[i])))
            else:
                if sd in (code(b"GT"), code(b"CT")) or \
                        ea in (code(b"AG"), code(b"AC")):
                    continue
                out.append(Intron(int(s[i]), int(e[i]), bool(sense[i])))
            if len(out) == n:
                break
    return out


def splicesites_text(genome: Genome, introns, decoys=()) -> str:
    """A splicesites map in iit_store input form (GMAP README "known
    splice sites"): per intron a donor and an acceptor entry ``>label
    chr:X..Y donor|acceptor dist`` with X on the donor (acceptor: intron)
    side and Y on the intron (exon) side, 1-based, so X > Y on the minus
    strand.  db/splicesites.load_splicesites maps each entry to the
    universal position synth uses (the intron's first base for a donor
    or antiacceptor, the base after it for an acceptor or antidonor).
    ``decoys`` are (position, kind) sites with no intron (kind one of
    donor, acceptor, antidonor, antiacceptor); their distance is 0."""
    starts = np.concatenate([[0], genome.chr_ends[:-1]])

    def loc(p):
        c = int(np.searchsorted(genome.chr_ends, p, side="right"))
        return genome.names[c], p - int(starts[c])

    lines = []

    def entry(label, p, kind, dist):
        name, r = loc(p)        # r = 0-based chromosome position
        plus = kind in ("donor", "acceptor")
        x, y = (r, r + 1) if plus else (r + 1, r)
        typ = "donor" if kind in ("donor", "antidonor") else "acceptor"
        lines.append(f">{label} {name}:{x}..{y} {typ} {dist}\n")

    for i, t in enumerate(introns):
        dist = t.acceptor - t.donor
        if t.sense:
            entry(f"i{i}.d", t.donor, "donor", dist)
            entry(f"i{i}.a", t.acceptor, "acceptor", dist)
        else:
            entry(f"i{i}.a", t.donor, "antiacceptor", dist)
            entry(f"i{i}.d", t.acceptor, "antidonor", dist)
    for i, (p, kind) in enumerate(decoys):
        entry(f"x{i}", int(p), kind, 0)
    return "".join(lines)


def random_decoys(rng: np.random.Generator, genome: Genome, n: int):
    """``n`` known sites of random kinds at random N-free positions."""
    kinds = ("donor", "acceptor", "antidonor", "antiacceptor")
    g = genome.ascii
    pos = rng.integers(300, len(g) - 300, 2 * n)
    pos = pos[g[pos] != ord("N")][:n]
    return [(int(p), kinds[int(k)])
            for p, k in zip(pos, rng.integers(0, 4, len(pos)))]


@dataclass
class SiteTruth:
    left: int          # universal start of the read's first piece
    plusp: bool        # read aligns on the plus strand
    intron: Intron
    flanks: tuple      # aligned piece lengths in genome order
    short_side: str    # "R": the short end is the right piece; "L": left


def plant_site_reads(rng: np.random.Generator, genome: Genome, introns,
                     n: int, L: int = 100, short_end: bool = False,
                     prefix: str = "k"):
    """``n`` reads across introns drawn from ``introns`` (no
    substitutions), with their truth (SiteTruth).  Without ``short_end``
    both pieces are >= 20 nt (the device's splice solver sees two
    diagonals); with it one piece is 1-12 nt, too short to seed, which
    only the host short-end lane over known sites splices.  Half the
    reads are reverse complemented."""
    g = genome.ascii
    ncum = _ncum(genome)
    records, truth = [], []
    i = 0
    while len(records) < n:
        t = introns[int(rng.integers(0, len(introns)))]
        if short_end:
            m = int(rng.integers(1, 13))
            a = L - m if rng.random() < 0.5 else m
        else:
            a = int(rng.integers(20, L - 19))
        x0, x1 = t.donor - a, t.acceptor + L - a
        if x0 < 0 or x1 > len(g) or ncum[t.donor] - ncum[x0] \
                or ncum[x1] - ncum[t.acceptor]:
            continue
        seq = np.concatenate([g[x0 : t.donor], g[t.acceptor : x1]])
        plusp = bool(rng.random() < 0.5)
        if not plusp:
            seq = _COMP[seq[::-1]]
        name = f"{prefix}{i}"
        i += 1
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        truth.append(SiteTruth(x0, plusp, t, (a, L - a),
                               "R" if a > L // 2 else "L"))
    return records, truth


def site_arrays(introns, decoys=()) -> dict:
    """Sorted universal positions of each known-site class (donor,
    acceptor, antidonor, antiacceptor) of a map's introns and decoys."""
    out = {k: [] for k in ("donor", "acceptor", "antidonor", "antiacceptor")}
    for t in introns:
        if t.sense:
            out["donor"].append(t.donor)
            out["acceptor"].append(t.acceptor)
        else:
            out["antiacceptor"].append(t.donor)
            out["antidonor"].append(t.acceptor)
    for p, kind in decoys:
        out[kind].append(p)
    return {k: np.unique(np.asarray(v, np.int64)) for k, v in out.items()}


def shortend_unique(genome: Genome, sites: dict, tr: SiteTruth,
                    shortsplicedist: int = 200_000) -> bool:
    """Does the short end of ``tr`` match its planted partner site and no
    other known partner site of the class (``sites``: site_arrays of the
    map) within ``shortsplicedist``, exactly (the reads carry no
    substitutions)?  The short-end lane splices only such reads; ties
    make it an ambiguous, clipped hit."""
    g = genome.ascii
    t = tr.intron
    m = min(tr.flanks)
    kind = {(True, "R"): "acceptor", (True, "L"): "donor",
            (False, "R"): "antidonor", (False, "L"): "antiacceptor"}[
        (t.sense, tr.short_side)]
    pos = sites[kind]
    if tr.short_side == "R":
        c = t.donor
        pos = pos[(pos > c) & (pos <= c + shortsplicedist)]
        want = g[t.acceptor : t.acceptor + m].tobytes()
        got = [g[p : p + m].tobytes() for p in pos]
    else:
        c = t.acceptor
        pos = pos[(pos >= c - shortsplicedist) & (pos < c)]
        want = g[t.donor - m : t.donor].tobytes()
        got = [g[p - m : p].tobytes() for p in pos]
    return sum(x == want for x in got) == 1


def mates_for(rng: np.random.Generator, genome: Genome, records, spans,
              L: int = 100):
    """Read-2 records making each of ``records`` (read 1, aligned on the
    plus strand when spans[i] = (x0, x1, plusp) says so, over genomic
    extent [x0, x1)) a concordant FR pair: the mate lies 20-300 nt
    beyond the read's 3' end, on the other strand.  Mates running into
    N or off the chromosome are shifted until they do not."""
    g = genome.ascii
    ncum = _ncum(genome)
    out = []
    for rec, (x0, x1, plusp) in zip(records, spans):
        gap = int(rng.integers(20, 301))
        while True:
            a = x1 + gap if plusp else x0 - gap - L
            if 0 <= a and a + L <= len(g) and not ncum[a + L] - ncum[a] \
                    and np.searchsorted(genome.chr_ends, a, side="right") \
                    == np.searchsorted(genome.chr_ends, a + L - 1,
                                       side="right"):
                break
            gap += 97
        seq = g[a : a + L]
        if plusp:
            seq = _COMP[seq[::-1]]
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        out.append(Record(rec.label, rec.header, seq.tobytes().decode(),
                          qual.tobytes().decode()))
    return out


def inside_ambiguous_pairs(rng: np.random.Generator, genome: Genome,
                           n: int, L: int = 100, prefix: str = "a"):
    """``n`` read pairs whose read 1 ends 5-8 nt into the next exon of a
    sense intron (s, e), with read 2 downstream in that exon, and for
    each a second known intron (s, e2) from the same donor whose acceptor
    e2 lies past read 2 and starts with the same 5-8 nt.  The short end
    mismatches the intron enough that the device places no read 1, so
    the pair goes to the host rescue, where read 1's short end ties
    between e and e2 (an ambiguous splice facing inside the pair) and the
    mate's span resolves it to e.  Returns (read 1 records, read 2
    records, truth as SiteTruth of read 1, the introns to put in the
    map)."""
    g = genome.ascii
    ncum = _ncum(genome)
    r1s, r2s, truth, introns = [], [], [], []
    while len(r1s) < n:
        (t,) = random_introns(rng, genome, 1, lo=150, hi=2_000)
        if not t.sense:
            continue
        s, e = t.donor, t.acceptor
        m = int(rng.integers(5, 9))
        if sum(a != b for a, b in zip(g[s : s + m], g[e : e + m])) < 5:
            continue
        gap = int(rng.integers(50, 300))
        r2 = e + m + gap
        # a second acceptor past read 2 with the same first m nt
        lo, hi = r2 + L + 50, s + 20_000
        if hi + m > len(g):
            continue
        w = g[lo : hi + m]
        win = np.lib.stride_tricks.sliding_window_view(w, m)
        hit = np.flatnonzero((win == g[e : e + m]).all(1))
        if not len(hit):
            continue
        e2 = int(lo + hit[0])
        if ncum[r2 + L] - ncum[s - L] or ncum[e2 + m] - ncum[e2]:
            continue
        seq1 = np.concatenate([g[s - (L - m) : s], g[e : e + m]])
        seq2 = _COMP[g[r2 : r2 + L][::-1]]
        name = f"{prefix}{len(r1s)}"
        qual = lambda: (rng.integers(20, 41, L) + 33).astype(
            np.uint8).tobytes().decode()
        r1s.append(Record(name, name, seq1.tobytes().decode(), qual()))
        r2s.append(Record(name, name, seq2.tobytes().decode(), qual()))
        truth.append(SiteTruth(s - (L - m), True, t, (L - m, m), "R"))
        introns += [t, Intron(s, e2, True)]
    return r1s, r2s, truth, introns


def random_snps(rng: np.random.Generator, genome: Genome, density: float,
                avoid=None):
    """SNPs at about ``density`` per nt: (positions int64, alt codes
    uint8), positions sorted, N-free and outside the boolean mask
    ``avoid``; each alt allele differs from the reference base."""
    g = genome.ascii
    n = int(len(g) * density)
    pos = np.unique(rng.integers(0, len(g), n))
    ok = g[pos] != ord("N")
    if avoid is not None:
        ok &= ~avoid[pos]
    pos = pos[ok]
    ref = dna.CODE_TABLE[g[pos]]
    alt = ((ref + rng.integers(1, 4, len(pos))) % 4).astype(np.uint8)
    return pos.astype(np.int64), alt


def plant_snp_reads(rng: np.random.Generator, genome: Genome, n: int,
                    L: int = 100, prefix: str = "v"):
    """``n`` reads carrying 5-8 alternative alleles of SNPs planted
    inside them (each 15-mer of the read holds at most 3 of them) and 0-1
    true substitution, with their truth (Truth, nsub counting only the
    true substitution), and the SNPs they need: (positions, alt codes).
    With 5-8 mismatches against the reference such a read exceeds the
    4-mismatch budget of a 100 nt read at k=15 / interval 3, so only a
    SNP-tolerant run (-v) places it."""
    g = genome.ascii
    ncum = _ncum(genome)
    records, truth, spos, salt = [], [], [], []
    while len(records) < n:
        p = int(rng.integers(100, len(g) - L - 100))
        if ncum[p + L] - ncum[p] or np.searchsorted(
                genome.chr_ends, p, side="right") != np.searchsorted(
                genome.chr_ends, p + L, side="right"):
            continue
        k = int(rng.integers(5, 9))
        # spread: one SNP per L/k-nt slot
        slots = np.linspace(2, L - 3, k + 1).astype(int)
        offs = np.array([int(rng.integers(a, max(a + 1, b - 1)))
                         for a, b in zip(slots[:-1], slots[1:])])
        seq = g[p : p + L].copy()
        ref = dna.CODE_TABLE[seq[offs]]
        alt = ((ref + rng.integers(1, 4, k)) % 4).astype(np.uint8)
        seq[offs] = _ACGT[alt]
        nsub = int(rng.integers(0, 2))
        if nsub:
            q = int(rng.choice(np.setdiff1d(np.arange(L), offs)))
            seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                            + rng.integers(1, 4)) % 4]
        plusp = bool(rng.random() < 0.5)
        if not plusp:
            seq = _COMP[seq[::-1]]
        name = f"{prefix}{len(records)}"
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        truth.append(Truth(p, plusp, "snp", nsub))
        spos.append(p + offs)
        salt.append(alt)
    return records, truth, (np.concatenate(spos).astype(np.int64),
                            np.concatenate(salt).astype(np.uint8))


def snps_text(genome: Genome, positions, alt_codes) -> str:
    """A SNP map in iit_store input form (snpindex's input): ``>label
    chr:pos XY`` with pos 1-based and XY the reference and the alternative
    allele (db/transforms.alt_genome_from_snps puts in whichever of the
    two is not the reference base)."""
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    chrom = np.searchsorted(genome.chr_ends, positions, side="right")
    ref = genome.ascii[positions]
    out = []
    for i, (p, c, r, a) in enumerate(zip(positions, chrom, ref, alt_codes)):
        out.append(f">snp{i} {genome.names[c]}:{int(p - starts[c]) + 1} "
                   f"{chr(r)}{'ACGT'[a]}\n")
    return "".join(out)


# ------------------------------------------------ cmet / atoi (--mode) reads

@dataclass
class BisulfiteTruth:
    left: int      # universal start of the planted placement (plus strand)
    plusp: bool
    kind: str      # "bisulfite", "ct_site" or "repeat"
    nsub: int      # extra substitutions planted
    site: int      # read-space position of the read-C / genome-T site, or -1


def plant_bisulfite_reads(rng: np.random.Generator, genome: Genome, n: int,
                          L: int = 100, ct_sites: float = 0.05,
                          repeats: float = 0.01, methylated: float = 0.75,
                          prefix: str = "b"):
    """``n`` bisulfite reads for ``--mode cmet-stranded``: read 1 of a
    stranded protocol, a fragment of either genome strand in which every
    C not followed by G turns into T in read space and each CpG C stays C
    (methylated) with probability ``methylated``; then 0-2 extra
    substitutions (the model of bench_workloads.make_cmet_workload).  A
    share ``ct_sites`` of the reads carry one read-C / genome-T site 20-79
    nt in (a T of the fragment read as C), which aligns under the
    two-sided conversion and must show as a mismatch in MD; a share
    ``repeats`` lie inside a repeat copy.  Returns (records,
    BisulfiteTruth per read)."""
    g = genome.ascii
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    ncum = np.concatenate([[0], np.cumsum(g == ord("N"))])
    records, truth = [], []
    for i in range(n):
        u = rng.random()
        kind = ("repeat" if u < repeats else
                "ct_site" if u < repeats + ct_sites else "bisulfite")
        while True:
            c = int(rng.integers(0, len(starts)))
            lo, hi = int(starts[c]), int(genome.chr_ends[c]) - L - 1
            p = int(rng.integers(lo, hi))
            if kind == "repeat":
                p = int(rng.choice(genome.repeats)) + int(
                    rng.integers(0, genome.repeat_unit - L))
                if not lo <= p < hi:
                    continue
            if ncum[p + L] - ncum[p] == 0:
                break
        plusp = bool(rng.random() < 0.5)
        # the fragment in read orientation, one base of context past its end
        frag = (g[p : p + L + 1].copy() if plusp
                else _COMP[g[p - 1 : p + L][::-1]])
        seq = frag[:L].copy()
        site = -1
        if kind == "ct_site":
            ts = np.flatnonzero(seq[20:80] == ord("T")) + 20
            if len(ts):
                site = int(rng.choice(ts))
        isc = seq == ord("C")
        cpg = isc & (frag[1:] == ord("G"))
        keep = cpg & (rng.random(L) < methylated)
        seq[isc & ~keep] = ord("T")
        nsub = int(rng.integers(0, 3))
        for q in rng.choice(L, nsub, replace=False):
            if q != site:
                seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                                + rng.integers(1, 4)) % 4]
        if site >= 0:
            seq[site] = ord("C")
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        name = f"{prefix}{i}"
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        truth.append(BisulfiteTruth(p, plusp, kind, nsub, site))
    return records, truth


def plant_bisulfite_pairs(rng: np.random.Generator, genome: Genome, n: int,
                          L: int = 100, methylated: float = 0.75,
                          prefix: str = "f"):
    """``n`` directional bisulfite read pairs for ``--mode cmet-stranded``:
    a 200-600 nt fragment of either genome strand, each C not followed by
    G turned into T (CpG Cs kept with probability ``methylated``), read 1
    its first L nt and read 2 the reverse complement of its last L nt
    (gsnap's FR orientation), 0-2 substitutions per read.  Returns
    (records of read 1, records of read 2, (universal start, plusp) of
    each fragment)."""
    g = genome.ascii
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    ncum = np.concatenate([[0], np.cumsum(g == ord("N"))])
    r1s, r2s, where = [], [], []
    for i in range(n):
        ins = int(rng.integers(200, 601))
        while True:
            c = int(rng.integers(0, len(starts)))
            p = int(rng.integers(starts[c] + 1, genome.chr_ends[c] - ins - 1))
            if ncum[p + ins] - ncum[p] == 0:
                break
        plusp = bool(rng.random() < 0.5)
        frag = (g[p : p + ins + 1].copy() if plusp
                else _COMP[g[p - 1 : p + ins][::-1]])
        isc = frag[:ins] == ord("C")
        keep = isc & (frag[1:] == ord("G")) & (rng.random(ins) < methylated)
        seq = frag[:ins].copy()
        seq[isc & ~keep] = ord("T")
        reads = [seq[:L].copy(), _COMP[seq[ins - L :][::-1]]]
        for r in reads:
            for q in rng.choice(L, int(rng.integers(0, 3)), replace=False):
                r[q] = _ACGT[(np.flatnonzero(_ACGT == r[q])[0]
                              + rng.integers(1, 4)) % 4]
        name = f"{prefix}{i}"
        for out, r in zip((r1s, r2s), reads):
            qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
            out.append(Record(name, name, r.tobytes().decode(),
                              qual.tobytes().decode()))
        where.append((p, plusp))
    return r1s, r2s, where


def plant_edited_pairs(rng: np.random.Generator, genome: Genome, n: int,
                       L: int = 100, edited: float = 0.30,
                       prefix: str = "e"):
    """``n`` RNA read pairs for ``--mode atoi-stranded``: the mix of
    :func:`plant_pairs` with ``rna`` (junctions, short exons, the DNA
    kinds), with A-to-I (read A -> G) edits in a share ``edited`` of the
    pairs: 2-10 sites within one 50-nt window of each mate that has
    enough As, in that mate's own conversion direction.  atoi-stranded
    converts read 1 A -> G (plus strand) and the runner inverts read 2
    at input (gsnap's FR orientation), so read 1 shows G where its
    sequence had A and read 2 shows C where it had T (A -> G on its
    reverse complement).  Returns (records of read 1, records of read 2,
    PairTruth per pair, edited bool per pair)."""
    r1s, r2s, truth = plant_pairs(rng, genome, n, L, rna=True,
                                  prefix=prefix)
    flags = rng.random(n) < edited

    def edit(rec, src, dst):
        seq = np.frombuffer(rec.seq.encode(), np.uint8).copy()
        w0 = int(rng.integers(0, len(seq) - 50 + 1))
        at = np.flatnonzero(seq[w0 : w0 + 50] == ord(src)) + w0
        if len(at) >= 2:
            k = int(rng.integers(2, min(10, len(at)) + 1))
            seq[rng.choice(at, k, replace=False)] = ord(dst)
        return Record(rec.label, rec.header, seq.tobytes().decode(),
                      rec.quality)

    for i in np.flatnonzero(flags):
        r1s[i] = edit(r1s[i], "A", "G")
        r2s[i] = edit(r2s[i], "T", "C")
    return r1s, r2s, truth, flags


# ------------------------------------- hand-built inputs of the cascade stages

def mismatch_rows(rng: np.random.Generator, r: int, k: int, L: int = 100):
    """(mm bool[r, k, L], pref int32[r, k, L+1], lengths int32[r]) for
    the trim and lane-feature stages: random masks at densities 0-60%,
    with all-mismatch and no-mismatch rows, a clean read end, reads
    shorter than L (down to 20 nt; the mask runs on past the length, as
    K3's may under query-N rules) and one read of length L."""
    dens = rng.choice([0.0, 0.02, 0.05, 0.1, 0.3, 0.6], size=(r, k, 1))
    mm = rng.random((r, k, L)) < dens
    mm[0] = True
    mm[1] = False
    mm[2, :, : L // 2] = False
    lengths = rng.integers(20, L + 1, r).astype(np.int32)
    lengths[:3] = L
    lengths[3] = L - 1
    pref = np.concatenate([np.zeros((r, k, 1), np.int32),
                           np.cumsum(mm, 2, dtype=np.int32)], 2)
    return mm, pref, lengths


MISMATCH_EDGE_KINDS = ("random", "tie", "equal maxima", "past the length")


def mismatch_edge_rows(rng: np.random.Generator, r: int, k: int,
                       L: int = 100):
    """mismatch_rows with the trims' edges: after its four special rows,
    row i has kind MISMATCH_EDGE_KINDS[(i - 4) % 4].  With period p = 1 +
    c % 4 for candidate c, so that a mismatch brings P back to where it
    was p positions before at trim score 1 - p:
    "tie": one mismatch after p - 1 matches and one p positions before
    the read's end, where the untrimmed ends score as much as the trims
    (the '>=' rule);
    "equal maxima": mismatches every p positions over the read's first
    and last 4 p (the last at its end), several equal maxima for each
    trim (first for t5, last for t3);
    "past the length": a read of at most L - 5 nt whose mismatches all lie
    past its length, densely."""
    mm, _, lengths = mismatch_rows(rng, r, k, L)
    for i in range(4, r):
        kind = MISMATCH_EDGE_KINDS[(i - 4) % 4]
        if kind == "random":
            continue
        if kind == "past the length":
            lengths[i] = rng.integers(20, L - 4)
        la = int(lengths[i])
        mm[i] = False
        for c in range(k):
            p = 1 + c % 4
            if kind == "tie":
                mm[i, c, [p - 1, la - p]] = True
            elif kind == "equal maxima":
                mm[i, c, np.arange(0, 4 * p, p)] = True
                mm[i, c, la - 1 - np.arange(0, 4 * p, p)] = True
            else:
                mm[i, c, la:] = rng.random(L - la) < 0.6
    pref = np.concatenate([np.zeros((r, k, 1), np.int32),
                           np.cumsum(mm, 2, dtype=np.int32)], 2)
    return mm, pref, lengths


def diag_pair_cases(rng: np.random.Generator, b: int, nc: int):
    """(top_d int64[b, nc] holding uint32, votes int32[b, nc]) for the
    pair selectors: diagonals in clusters within 40 of bases near 0,
    2^24, 2^31 and 2^32 (so dj - di wraps in int32 and in uint32), some
    INVALID (0xFFFFFFFF), and many equal votes."""
    bases = np.array([30, 2**24, 2**31 - 20, 2**32 - 60], np.int64)
    top = (rng.choice(bases, (b, 1)) + rng.integers(-20, 40, (b, nc)))
    top = np.where(rng.random((b, nc)) < 0.1, 0xFFFFFFFF, top % 2**32)
    votes = rng.integers(0, 6, (b, nc)).astype(np.int32)
    return top.astype(np.int64), votes


def rank_hit_cases(rng: np.random.Generator, b: int, n: int):
    """A gather_candidates-layout dict of [b, n] hit fields for the
    ranking stage: few distinct values, so exact duplicate candidates
    (all seven dedup fields equal), equal score and left on both strands,
    and BIG_NMM scores occur in every row; plusp marks the first half."""
    big = 10**6
    pick = lambda vals: rng.choice(np.asarray(vals), (b, n))
    left = pick([5, 7, 2**31 + 3, 2**32 - 2]).astype(np.int64)
    out = {
        "kind": pick([0, 0, 1, 3]).astype(np.int32),
        "score": pick([0, 1, 1, 2, 5, big]).astype(np.int32),
        "nmm": rng.integers(0, 4, (b, n)).astype(np.int32),
        "left": left,
        "right": (left + pick([0, 0, 3])) % 2**32,
        "split": pick([0, 0, 40]).astype(np.int32),
        "split2": np.zeros((b, n), np.int32),
        "mid": left.copy(),
        "nindels": pick([0, 0, 2]).astype(np.int32),
        "sense": rng.random((b, n)) < 0.5,
        "prob_d": rng.random((b, n)).astype(np.float32),
        "prob_a": rng.random((b, n)).astype(np.float32),
        "prob_d2": np.zeros((b, n), np.float32),
        "prob_a2": np.zeros((b, n), np.float32),
        "plusp": np.broadcast_to(np.arange(n) < n // 2, (b, n)).copy(),
    }
    return out


RANK_EDGE_KINDS = ("near duplicates", "left 0 and 2^32-1", "BIG-1, BIG, 0")


def rank_hit_edges(rng: np.random.Generator, b: int, n: int, edge: str):
    """rank_hit_cases rows with one of RANK_EDGE_KINDS in every row:
    "near duplicates": pairs of candidates equal in six of the seven
    dedup fields (which one differs cycles over the seven) beside exact
    duplicates; "left 0 and 2^32-1": candidates at left 0 and 2^32 - 1 on
    both strands with equal scores; "BIG-1, BIG, 0": those three scores
    in one row."""
    out = rank_hit_cases(rng, b, n)
    big = 10**6
    fields = ("kind", "split", "split2", "mid", "right", "plusp", "left")
    for row in range(b):
        if edge == "near duplicates":
            for c in range(0, n - 1, 3):
                j = int(rng.integers(c + 1, n))
                for k in fields + ("score",):
                    out[k][row, j] = out[k][row, c]
                f = fields[(row + c) % len(fields)]
                if f == "plusp":
                    out[f][row, j] = ~out[f][row, c]
                else:
                    v = int(out[f][row, c]) + 1
                    out[f][row, j] = v % 2**32 if f in ("mid", "right",
                                                        "left") else v
        elif edge == "left 0 and 2^32-1":
            for c in rng.choice(n, min(n, 8), replace=False):
                edge_left = 0 if c % 2 else 2**32 - 1
                out["left"][row, c] = out["mid"][row, c] = edge_left
                out["right"][row, c] = edge_left
                out["score"][row, c] = 1
        elif edge == "BIG-1, BIG, 0":
            cols = rng.choice(n, min(n, 3), replace=False)
            out["score"][row, cols] = [big - 1, big, 0][:len(cols)]
        else:
            raise ValueError(f"unknown rank edge {edge!r}")
    return out


DIAG_ROW_KINDS = ("ties at the cut", "fewer heads than ncand", "all INVALID",
                  "one diagonal", "few values", "all distinct")


def diag_vote_rows(rng: np.random.Generator, b: int, w: int, nc: int):
    """int64[b, w] seed diagonals (uint32 values, 0xFFFFFFFF INVALID) for
    top_diagonals, the rows cycling over DIAG_ROW_KINDS: "ties at the
    cut": nc / 2 diagonals with 5 votes and 3 nc / 2 with 3, so the
    ncand-th vote is tied across the cut, the rest INVALID; "fewer heads
    than ncand": nc / 2 diagonals; "all INVALID"; "one diagonal": one
    value w times; "few values": a dozen values and some INVALID; "all
    distinct": every vote 1.  Values include 0 and 2^32 - 2, and each
    row is shuffled."""
    out = np.full((b, w), 0xFFFFFFFF, np.int64)
    for row in range(b):
        kind = DIAG_ROW_KINDS[row % len(DIAG_ROW_KINDS)]
        vals = rng.choice(2**32 - 3, max(2 * nc, 16), replace=False) + 1
        vals[:2] = (0, 2**32 - 2)
        if kind == "ties at the cut":
            hi, lo = max(nc // 2, 1), max(3 * nc // 2, 1)
            seq = np.concatenate([np.repeat(vals[:hi], 5),
                                  np.repeat(vals[hi:hi + lo], 3)])[:w]
        elif kind == "fewer heads than ncand":
            h = max(nc // 2, 1)
            seq = np.repeat(vals[:h], rng.integers(1, 4, h))[:w]
        elif kind == "all INVALID":
            seq = np.zeros(0, np.int64)
        elif kind == "one diagonal":
            seq = np.full(w, vals[1])
        elif kind == "few values":
            seq = rng.choice(vals[:12], w)
            seq = np.where(rng.random(w) < 0.2, 0xFFFFFFFF, seq)
        else:
            seq = rng.choice(2**32 - 1, w, replace=False)
        out[row, :len(seq)] = seq
        rng.shuffle(out[row])
    return out


PAIR_ROW_KINDS = ("none eligible", "few eligible", "equal sums",
                  "width limit")


def diag_pair_rows(rng: np.random.Generator, b: int, nc: int):
    """(top_d int64[b, nc] holding uint32, votes int32[b, nc]) for the
    pair selector (K16), the rows cycling over PAIR_ROW_KINDS: "none
    eligible": one value repeated (a difference of 0 is no pair) or
    INVALID; "few eligible": diagonals 2^32 / nc apart but for two or three
    close ones, so fewer pairs than maxpairs are eligible and the -1
    entries fill the rest in flat order; "equal sums": a cluster within
    20 of one base, every vote 4; "width limit": a cluster with votes of
    2^17 - 1, whose sum 2^18 - 2 is the largest the kernel's key
    holds, beside small ones.  Bases near 2^31 and 2^32 make the
    differences wrap."""
    top = np.zeros((b, nc), np.int64)
    votes = np.zeros((b, nc), np.int32)
    for row in range(b):
        kind = PAIR_ROW_KINDS[row % len(PAIR_ROW_KINDS)]
        base = int(rng.choice([100, 2**31 - 20, 2**32 - 60]))
        if kind == "none eligible":
            top[row] = base if row % 8 < 4 else 0xFFFFFFFF
            votes[row] = rng.integers(0, 50, nc)
        elif kind == "few eligible":
            top[row] = (base + np.arange(nc) * (2**32 // nc)) % 2**32
            close = rng.choice(nc, min(nc, 3), replace=False)
            top[row, close] = (base + np.arange(len(close)) * 7) % 2**32
            votes[row] = rng.integers(1, 50, nc)
        elif kind == "equal sums":
            top[row] = (base + rng.integers(0, 20, nc)) % 2**32
            votes[row] = 4
        else:
            top[row] = (base + rng.integers(0, 40, nc)) % 2**32
            votes[row] = np.where(rng.random(nc) < 0.5, 2**17 - 1,
                                  rng.integers(0, 9, nc))
        top[row, rng.random(nc) < 0.05] = 0xFFFFFFFF
    return top, votes


def doublesplice_cases(rng: np.random.Generator, b: int, nc: int = 32,
                       nt: int = 8, L: int = 100, genome_len: int = 40_000):
    """Inputs of the short-exon solver (K7) with its edges, as numpy
    arrays in a dict: ``codes`` (uint8[genome_len] 2-bit codes; no N),
    ``top_d`` int64[b, nc] (uint32 values), ``pref`` int32[b, nc, L+1],
    ``ti`` / ``tm`` / ``tj`` int64[b, nt], ``tvalid`` bool[b, nt],
    ``lengths`` and ``budget`` int32[b] and ``known``, four uint32
    bitvectors (donor, acceptor, antidonor, antiacceptor) of
    device_bitmasks' length.

    The genome's first 400 bp and [4000, 12000) repeat CCAGGTGCTT (an
    AG|GT of maxent probabilities 0.945 / 0.966 at every p = 4 mod 10)
    and [12000, 16000) its reverse complement (the antisense pair), so a
    triple of diagonals of one phase there has about ten candidates per
    junction, many of them sufficient, and the first-8 rule decides;
    mismatches are sparse (budget 2-6).  Every row holds diagonals 63
    and 64 (near the dense start), diagonals at the genome's end and
    INVALID ones, and its triples mix those with dense ones.  Reads are
    L long but for some of 30-99 nt and of 3-5 nt.  The known sites are
    sparse random bits plus, per row, sites of both classes at s = 2 on
    i and m and at s = len - 2 on m and j of the row's first triple (a
    short exon of probability 1.0 on both strands: equal keys, sense
    wins), with that triple's i, m and j outside the dense stretches.
    nc >= 12."""
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    unit = np.array([1, 1, 0, 2, 2, 3, 2, 1, 3, 3], np.uint8)  # CCAGGTGCTT
    g[:400] = np.tile(unit, 40)
    g[4000:12000] = np.tile(unit, 800)
    g[12000:16000] = np.tile(3 - unit[::-1], 400)
    lengths = np.full(b, L, np.int32)
    short = rng.random(b) < 0.2
    lengths[short] = rng.integers(30, L, int(short.sum()))
    lengths[5::17] = rng.integers(3, 6, len(lengths[5::17]))
    budget = rng.integers(2, 7, b).astype(np.int32)
    top = np.zeros((b, nc), np.int64)
    for row in range(b):
        sense_dense = rng.random() < 0.5
        lo, hi = (4100, 11800) if sense_dense else (12100, 15800)
        phase = int(rng.integers(0, 10))
        top[row] = rng.integers(lo // 10, hi // 10, nc) * 10 + phase
        top[row, 1:4] = rng.integers(20_000, genome_len - 300, 3)
        top[row, 4], top[row, 5] = 63, 64
        top[row, 6] = genome_len - int(rng.integers(1, 60))
        top[row, 7] = 0xFFFFFFFF
        top[row, 8] = genome_len + 200
    mm = rng.random((b, nc, L)) < 0.02
    pref = np.concatenate([np.zeros((b, nc, 1), np.int32),
                           np.cumsum(mm, 2, dtype=np.int32)], 2)
    ti = rng.integers(0, nc, (b, nt))
    tm = rng.integers(0, nc, (b, nt))
    tj = rng.integers(0, nc, (b, nt))
    dense = np.arange(9, nc) if nc > 12 else np.arange(nc)
    ti[:, 1:4] = rng.choice(dense, (b, 3))
    tm[:, 1:4] = rng.choice(dense, (b, 3))
    tj[:, 1:4] = rng.choice(dense, (b, 3))
    ti[:, 0], tm[:, 0], tj[:, 0] = 1, 2, 3
    ti[:, 4], tm[:, 4], tj[:, 4] = 5, 5, 5           # diagonal 64, thrice
    tm[:, 5] = 4                                     # diagonal 63 in the middle
    tj[:, 6] = 6                                     # at the genome end
    ti[:, 7 % nt] = 7                                # INVALID
    tvalid = rng.random((b, nt)) < 0.85
    nwords = (genome_len + 31) // 32 + 2
    known = [np.zeros(nwords, np.uint32) for _ in range(4)]
    for k in range(4):
        pos = rng.choice(genome_len, genome_len // 200, replace=False)
        np.bitwise_or.at(known[k], pos >> 5, np.uint32(1) << (pos & 31))
    for row in range(b):
        di, dm, dj = (int(top[row, x]) for x in (ti[row, 0], tm[row, 0],
                                                 tj[row, 0]))
        s2 = int(lengths[row]) - 2
        # (kind, position): donor 0, acceptor 1, antidonor 2, antiacceptor 3
        for kind, pos in ((0, di + 2), (1, dm + 2), (0, dm + s2),
                          (1, dj + s2), (3, di + 2), (2, dm + 2),
                          (3, dm + s2), (2, dj + s2)):
            if 0 <= pos < genome_len:
                known[kind][pos >> 5] |= np.uint32(1) << np.uint32(pos & 31)
    return {"codes": g, "top_d": top, "pref": pref, "ti": ti, "tm": tm,
            "tj": tj, "tvalid": tvalid, "lengths": lengths, "budget": budget,
            "known": tuple(known)}


def splice_pair_cases(rng: np.random.Generator, b: int, nc: int = 32,
                      npairs: int = 16, L: int = 100,
                      genome_len: int = 40_000):
    """Inputs of the local splice solver (K5) with its edges, as numpy
    arrays in a dict: ``codes`` (uint8[genome_len] 2-bit codes; no N),
    ``top_d`` int64[b, nc] (uint32 values), ``pref`` int32[b, nc, L+1],
    ``ii`` / ``jj`` int64[b, npairs], ``pvalid`` bool[b, npairs],
    ``lengths`` and ``budget`` int32[b] and ``known``, four uint32
    bitvectors (donor, acceptor, antidonor, antiacceptor) of
    device_bitmasks' length.

    The genome is random but for repeats: the first 400 bp and [4000,
    12000) repeat CCAGGTGCTT (an AG|GT of maxent probabilities 0.945 /
    0.966 at every p = 4 mod 10) and [12000, 16000) its reverse
    complement; [16000, 20000) repeats AGGTA (a donor of probability
    0.9993 at every p = 2 mod 5) and [20000, 24000) its reverse
    complement TACCT (the antidonors).  The known acceptor bits are set
    over all of [24000, 28000) and the known antiacceptor bits over
    [28000, 32000), so a pair from the donor repeat to there (or from
    there to the antidonor repeat) has 19 candidates of equal
    probability sums in a read of 100 nt, and the first-16 rule decides
    whether a known donor (antidonor) of probability 1.0 wins: pairs 9
    and 10 (sense, antisense) have it at s = 53, the 11th candidate,
    pairs 11 and 12 at s = 88, after the 16th; their diagonals are the
    same in every row and carry no mismatches.  Every row
    holds diagonals 63 and 64 (at the dense start), at the genome's end,
    near 2^32, INVALID and at words' first and last bits (d & 31 of 0
    and 31, with known bits at such positions), and its pairs mix those
    with dense ones; its second pair carries known sites of both classes
    at one split each (equal sums: sense wins) and its first pair two
    known pairs of equal sums in one class, on diagonals without
    mismatches.  The known vectors' last
    words (past the genome, where INVALID diagonals and those near 2^32
    read) hold random bits.  Reads are L long but for some of 30-99 nt
    and of 3-5 nt; budgets are 0-6 over sparse mismatches, and some
    pairs are not valid.  nc >= 24."""
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    unit = np.array([1, 1, 0, 2, 2, 3, 2, 1, 3, 3], np.uint8)  # CCAGGTGCTT
    donor = np.array([0, 2, 2, 3, 0], np.uint8)                 # AGGTA
    g[:400] = np.tile(unit, 40)
    g[4000:12000] = np.tile(unit, 800)
    g[12000:16000] = np.tile(3 - unit[::-1], 400)
    g[16000:20000] = np.tile(donor, 800)
    g[20000:24000] = np.tile(3 - donor[::-1], 800)
    lengths = np.full(b, L, np.int32)
    short = rng.random(b) < 0.2
    lengths[short] = rng.integers(30, L, int(short.sum()))
    lengths[5::17] = rng.integers(3, 6, len(lengths[5::17]))
    budget = rng.integers(0, 7, b).astype(np.int32)
    nwords = (genome_len + 31) // 32 + 2
    known = [np.zeros(nwords, np.uint32) for _ in range(4)]

    def set_known(kind, pos):
        if 0 <= pos < 32 * nwords:
            known[kind][pos >> 5] |= np.uint32(1) << np.uint32(pos & 31)

    for kind in range(4):
        pos = rng.choice(genome_len, genome_len // 200, replace=False)
        np.bitwise_or.at(known[kind], pos >> 5, np.uint32(1) << (pos & 31))
        known[kind][-2:] = rng.integers(0, 2**32, 2, dtype=np.uint64)
    known[1][24000 // 32 : 28000 // 32] = 0xFFFFFFFF
    known[3][28000 // 32 : 32000 // 32] = 0xFFFFFFFF
    known[0][16000 // 32 : 20000 // 32] = 0     # no stray known donors
    known[2][20000 // 32 : 24000 // 32] = 0     # nor antidonors
    # a known donor (antidonor) of 1.0 among the first 16 candidates of
    # the donor -> known-acceptor pairs (antisense alike) and after them
    donors, antidonors = (17_002, 18_002), (21_003, 22_003)
    for x, late in zip(donors, (53, 88)):
        set_known(0, x + late)
    for x, late in zip(antidonors, (53, 88)):
        set_known(2, x + late)
    top = np.zeros((b, nc), np.int64)
    ii = rng.integers(0, nc, (b, npairs))
    jj = rng.integers(0, nc, (b, npairs))
    for row in range(b):
        t = top[row]
        t[0:4] = rng.integers(32_000, genome_len - 300, 4)
        t[4], t[5] = 63, 64
        t[6] = genome_len - int(rng.integers(1, 60))
        t[7] = 2**32 - 2 - int(rng.integers(0, 200))
        t[8] = 0xFFFFFFFF
        t[9] = 4096 + 32 * int(rng.integers(0, 200))   # d & 31 == 0
        t[10] = t[9] + 31 + 32 * int(rng.integers(0, 10))
        phase = int(rng.integers(0, 10))
        t[11:14] = rng.integers(410, 1180, 3) * 10 + phase      # sense
        t[14:16] = rng.integers(1210, 1580, 2) * 10 + phase     # antisense
        t[16:18] = donors
        t[18:20] = rng.integers(4810, 5580, 2) * 5              # known acc
        t[20:22] = rng.integers(5610, 6380, 2) * 5              # known aacc
        t[22:24] = antidonors
        t[24:] = rng.integers(410, 1180, nc - 24) * 10 + phase
        la = int(lengths[row])
        # pair 0: two known splits of equal sums in the sense class;
        # pair 1: a known split of each class (sense wins the tie)
        di, dj = int(t[0]), int(t[1])
        s1, s2 = 2 + int(rng.integers(0, 20)), max(2, la - 2)
        for s in (s1, s2):
            set_known(0, di + s)
            set_known(1, int(t[2]) + s)
        set_known(1, dj + s1)
        set_known(3, di + s2)
        set_known(2, dj + s2)
        # known bits at the word boundaries of diagonals 9 and 10
        for x in (9, 10):
            for s in (2, 31, 32, 63, 64):
                set_known(int(rng.integers(0, 4)), int(t[x]) + s)
    ii[:, 0], jj[:, 0] = 0, 2
    ii[:, 1], jj[:, 1] = 0, 1
    ii[:, 2], jj[:, 2] = 5, 11               # 64 -> dense
    ii[:, 3], jj[:, 3] = 4, 12               # 63 -> dense
    ii[:, 4], jj[:, 4] = 11, 6               # -> the genome end
    ii[:, 5], jj[:, 5] = 7, 8                # near 2^32 -> INVALID
    ii[:, 6], jj[:, 6] = 9, 10               # word boundaries
    ii[:, 7], jj[:, 7] = 11, 12              # sense, equal sums
    ii[:, 8], jj[:, 8] = 14, 15              # antisense
    ii[:, 9], jj[:, 9] = 16, 18              # donors -> known acceptors
    ii[:, 10], jj[:, 10] = 20, 22            # known antiacc. -> antidonors
    ii[:, 11], jj[:, 11] = 17, 19
    ii[:, 12], jj[:, 12] = 21, 23
    mm = rng.random((b, nc, L)) < 0.02
    mm[:, :3] = False                        # pairs 0, 1 and 9-12
    mm[:, 16:24] = False                     # within any budget
    pref = np.concatenate([np.zeros((b, nc, 1), np.int32),
                           np.cumsum(mm, 2, dtype=np.int32)], 2)
    pvalid = rng.random((b, npairs)) < 0.85
    return {"codes": g, "top_d": top, "pref": pref, "ii": ii, "jj": jj,
            "pvalid": pvalid, "lengths": lengths, "budget": budget,
            "known": tuple(known)}


def prefix_mismatch_cases(rng: np.random.Generator, b: int, nc: int,
                          L: int = 100, genome_len: int = 40_000):
    """Inputs of the mismatch stage (K3) with its edges, as numpy arrays
    in a dict: the genome's ``gcodes`` (uint8[genome_len] 2-bit codes)
    and ``gflags`` (uint8, 1 at an N), reads ``codes`` uint8[b, L],
    ``nflags`` bool[b, L] and ``lengths`` int32[b], and ``diags``
    int64[b, nc] (uint32 values).

    The genome carries five N runs of 20-200 nt.  Each read is copied
    from the genome (a tenth from an N run's edge) with 0-6 substitutions
    and, in a fifth of the reads, 1-3 query Ns; lengths are L, some
    shorter, and 1, 15, 16 and 17 in four reads.  Every row holds its
    read's own diagonal and that diagonal shifted by 1-3 (indels), the
    diagonals 0, 15 and 16, INVALID (0xFFFFFFFF), one where the read ends
    at the genome's end, one running past it by 1-20 and one past it
    altogether; the rest are random."""
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    nflag = np.zeros(genome_len, np.uint8)
    runs = rng.integers(L + 50, genome_len - 300, 5)
    for s, n in zip(runs, rng.integers(20, 201, 5)):
        nflag[s : s + n] = 1
    lengths = np.full(b, L, np.int32)
    short = rng.random(b) < 0.25
    lengths[short] = rng.integers(max(1, L // 3), L, int(short.sum()))
    lengths[1:5] = np.minimum([1, 15, 16, 17], L)
    codes = np.zeros((b, L), np.uint8)
    nflags = np.zeros((b, L), bool)
    diags = np.zeros((b, nc), np.int64)
    for row in range(b):
        la = int(lengths[row])
        d = (int(runs[row % 5]) - la // 2 if row % 10 == 3
             else int(rng.integers(0, genome_len - L)))
        read = g[d : d + la].copy()
        sub = rng.choice(la, int(rng.integers(0, min(6, la) + 1)),
                         replace=False)
        read[sub] = (read[sub] + rng.integers(1, 4, len(sub))) % 4
        codes[row, :la] = read
        if row % 5 == 2:
            nflags[row, rng.choice(la, min(la, int(rng.integers(1, 4))),
                                   replace=False)] = True
        t = diags[row]
        t[:] = rng.integers(0, genome_len - L, nc)
        t[:10] = [d, d + 1, d - 2 if d >= 2 else d + 3, d + 3, 0, 15, 16,
                  0xFFFFFFFF, genome_len - la,
                  genome_len - la + int(rng.integers(1, 21))]
        if nc > 10:
            t[10] = genome_len + int(rng.integers(0, 50))
    return {"gcodes": g, "gflags": nflag, "codes": codes, "nflags": nflags,
            "lengths": lengths, "diags": diags}


def indel_pair_cases(rng: np.random.Generator, b: int, nc: int = 32,
                     npairs: int = 16, L: int = 100, max_ins: int = 9,
                     max_del: int = 30):
    """Inputs of the middle indel solver (K4) with its edges, as numpy
    arrays in a dict: ``top_d`` int64[b, nc] (uint32 values), ``mm``
    bool[b, nc, L] and ``pref`` int32[b, nc, L+1] as K3 writes them (no
    mismatch past a read's length), ``ii`` / ``jj`` int64[b, npairs],
    ``pvalid`` bool[b, npairs], ``lengths`` and ``budget`` int32[b] and
    ``qp5`` / ``qp3`` int32[b, nc].  nc >= max_ins + 9.

    Each row's diagonal 0 is a base D (within 8 of 2^32 in every eighth
    row, so that D + k wraps in uint32); diagonals 1..max_ins lie 1 to
    max_ins below it (insertions of every shift), then deletions of 1, 2,
    max_del and max_del + 1, an insertion of max_ins + 1, D itself again,
    INVALID and D + 2^31 (differences of -2^31 in int32); the rest are
    random within 40 of D.  Mismatch rows are sparse (0-6 inside the
    read), but row 0 has none except one in every third read, row 1 none
    at all, and row max_ins + 1 (the deletion of 1) one at the read's
    last position: the pair (0, max_ins + 1) then has its only candidate
    at s = L (for min_end 0 and a read of L), or with row 0's mismatch at
    a, totals that tie at s = a and s = L.  Most pairs are (0, k) for
    each k above, (0, 0) among them, rotated by the row; the last four
    are random (some naming one row twice).  Lengths are L but for some
    of L / 3 to L - 1; budgets 0-6; a seventh of the pairs are not
    valid; qp5 / qp3 random, so the seed-order gate falls either way."""
    assert nc >= max_ins + 9
    lengths = np.full(b, L, np.int32)
    short = rng.random(b) < 0.3
    lengths[short] = rng.integers(max(1, L // 3), L, int(short.sum()))
    lengths[0] = L
    mm = np.zeros((b, nc, L), bool)
    top = np.zeros((b, nc), np.int64)
    ii = rng.integers(0, nc, (b, npairs))
    jj = rng.integers(0, nc, (b, npairs))
    fixed = [(0, k) for k in range(max_ins + 9)]
    for row in range(b):
        la = int(lengths[row])
        d = (2**32 - 1 - int(rng.integers(1, 9)) if row % 8 == 7
             else int(rng.integers(2**20, 2**30)))
        t = top[row]
        t[: max_ins + 1] = d - np.arange(max_ins + 1)
        t[max_ins + 1 : max_ins + 9] = [
            d + 1, d + 2, d + max_del, d + max_del + 1, d - max_ins - 1, d,
            0xFFFFFFFF, d + 2**31]
        t[max_ins + 9 :] = d + rng.integers(-40, 41, nc - max_ins - 9)
        t[:] &= 0xFFFFFFFF
        dens = rng.integers(0, 7, nc)
        for c in range(nc):
            mm[row, c, rng.choice(la, min(la, int(dens[c])),
                                  replace=False)] = True
        mm[row, :2] = False
        mm[row, 0, min(la - 1, 5 * (1 + row % 7))] = row % 3 == 0
        mm[row, max_ins + 1] = False
        mm[row, max_ins + 1, la - 1] = True
        for p in range(max(0, npairs - 4)):
            ii[row, p], jj[row, p] = fixed[(p + row) % len(fixed)]
    pref = np.concatenate([np.zeros((b, nc, 1), np.int32),
                           np.cumsum(mm, 2, dtype=np.int32)], 2)
    budget = rng.integers(0, 7, b).astype(np.int32)
    pvalid = rng.random((b, npairs)) < 6 / 7
    qp5 = rng.integers(0, L, (b, nc)).astype(np.int32)
    qp3 = rng.integers(0, L, (b, nc)).astype(np.int32)
    return {"top_d": top, "mm": mm, "pref": pref, "ii": ii, "jj": jj,
            "pvalid": pvalid, "lengths": lengths, "budget": budget,
            "qp5": qp5, "qp3": qp3}


QPOS_RANGE_KINDS = ("repeats", "all invalid", "absent", "one diagonal")


def qpos_range_cases(rng: np.random.Generator, b: int, w: int, p: int):
    """(diag int64[b, w] holding uint32, qpos int32[b, w], d_sel int64[b,
    p]) for the qpos range kernel (K15), the rows cycling over
    QPOS_RANGE_KINDS: "repeats": slots and selected diagonals drawn from a
    pool smaller than p that holds 0, 0xFFFFFFFE and INVALID (0xFFFFFFFF),
    so that d_sel repeats values and names INVALID, which matches the
    INVALID slots; "all invalid": every slot INVALID, d_sel half INVALID;
    "absent": d_sel values the grid lacks beside ones it has; "one
    diagonal": every slot on one diagonal, d_sel naming it at several
    places.  qpos is not monotone along the slots."""
    diag = np.zeros((b, w), np.int64)
    dsel = np.zeros((b, p), np.int64)
    qpos = rng.integers(0, 1 << 14, (b, w)).astype(np.int32)
    for row in range(b):
        kind = QPOS_RANGE_KINDS[row % len(QPOS_RANGE_KINDS)]
        pool = np.concatenate([
            [0, 0xFFFFFFFE, 0xFFFFFFFF, 2**31],
            rng.integers(0, 2**32, max(1, p // 2))]).astype(np.int64)
        if kind == "repeats":
            diag[row] = rng.choice(pool, w)
            dsel[row] = rng.choice(pool, p)
        elif kind == "all invalid":
            diag[row] = 0xFFFFFFFF
            dsel[row] = np.where(rng.random(p) < 0.5, 0xFFFFFFFF,
                                 rng.choice(pool, p))
        elif kind == "absent":
            diag[row] = rng.choice(pool[: 2 + len(pool) // 2], w)
            dsel[row] = rng.choice(pool, p)
        else:
            diag[row] = pool[row % len(pool)]
            dsel[row] = np.where(rng.random(p) < 0.5, pool[row % len(pool)],
                                 rng.choice(pool, p))
    return diag, qpos, dsel


TRIPLE_ROW_KINDS = ("close", "wrap", "equal votes", "zero votes",
                    "all invalid", "width limit")


def triple_cases(rng: np.random.Generator, b: int, nc: int):
    """(top_d int64[b, nc] holding uint32, votes int32[b, nc]) for the
    triple selector (K6), the rows cycling over TRIPLE_ROW_KINDS:
    "close": a cluster with steps of 0-3 (many eligible edges at maxdist
    1, none at 0, ties of the difference 0); "wrap": diagonals on both
    sides of 2^32, so that differences wrap uint32; "equal votes": every
    vote 4 (the lower index wins every tie); "zero votes": every vote 0
    (the sums tie at 0 with the invalid ones at -1 below them); "all
    invalid": every diagonal INVALID; "width limit": votes of (2^23 - 2)
    / 3, whose sum 2^23 - 2 is the largest the kernel's key holds.  One
    diagonal in 10 is INVALID in the rows that are not all INVALID."""
    top = np.zeros((b, nc), np.int64)
    votes = rng.integers(0, 40, (b, nc)).astype(np.int32)
    for row in range(b):
        kind = TRIPLE_ROW_KINDS[row % len(TRIPLE_ROW_KINDS)]
        base = int(rng.choice([50, 2**31 - 40, 2**32 - 2 * nc]))
        if kind == "wrap":
            top[row] = (2**32 - nc + rng.integers(0, 2 * nc, nc)) % 2**32
        elif kind == "all invalid":
            top[row] = 0xFFFFFFFF
        else:
            top[row] = (base + np.cumsum(rng.integers(0, 4, nc))) % 2**32
        if kind == "equal votes":
            votes[row] = 4
        elif kind == "zero votes":
            votes[row] = 0
        elif kind == "width limit":
            votes[row] = np.where(rng.random(nc) < 0.5, (2**23 - 2) // 3,
                                  rng.integers(0, 9, nc))
        if kind != "all invalid":
            top[row, rng.random(nc) < 0.1] = 0xFFFFFFFF
        rng.shuffle(top[row])
    return top, votes


# ------------------------- the junction dynprog (K12) and pairing grid (K8)

JUNCTION_EDGE_KINDS = ("ties", "past k = 0", "past k = W")
JUNCTION_NEG_INF = -1000000   # dynprog's NEG_INF


def junction_traceback_cases(rng: np.random.Generator, nb: int, M: int = 64,
                             W: int = 23, NL: int = 72):
    """Hand-built inputs of the junction search and both tracebacks
    (``ops/dynprog.bridge_traceback``) for ``nb`` junctions: band
    matrices ``nogap`` / ``gap1`` / ``gap2`` int32 and ``ndiag`` bool
    [2 nb, M + 1, W] (rows :nb the left sides, nb: the reversed right
    sides, as the banded sweep lays them out), and per junction ``len1``,
    ``len2L``, ``len2R``, ``lbandL``, ``lbandR`` int32 [nb], genome
    windows ``gl`` / ``grv`` int32 [nb, NL], known-site rewards ``known``
    int32 [nb, NL + 1] (0 or 20) and offsets ``loff`` / ``roff`` int64
    [nb].  Junction i's matrices are of kind
    JUNCTION_EDGE_KINDS[i % 3], on both sides:

    "ties": every cell from -2..2, so that gap1 == nogap and gap2 ==
    max(nogap, gap1) hold often, 10% NEG_INF;
    "past k = 0": gap1 = nogap + 2 and gap2 NEG_INF, so that a walk turns
    GAP1 at once and goes on left past the band's first column (out of
    the band every cell reads NEG_INF, and NEG_INF >= or > NEG_INF + open
    holds) while its column is above 1;
    "past k = W": gap2 = nogap + 2 and gap1 NEG_INF: a GAP2 walk past the
    last column while its row is above 1.

    len1 runs 2..M (junction 0 has 2, junction 1 has M), len2 = len1 + 8
    (at most NL with NL = M + 8), bands 0-3 (an edge walk crosses the band
    edge only where its column exceeds band + 1 there); the windows hold
    codes 0-4 with GT, GC, AT / AG, AC planted; two junctions in 5 have
    offsets at both ends of int32, so that the separation test's
    differences wrap as JAX's int32 arithmetic does."""
    neg = JUNCTION_NEG_INF
    shape = (2 * nb, M + 1, W)
    nogap = rng.integers(-20, 21, shape)
    kind = np.tile(np.arange(nb) % 3, 2)[:, None, None]
    small = rng.integers(-2, 3, shape)
    gap1 = np.select([kind == 0, kind == 1], [rng.integers(-2, 3, shape),
                                              nogap + 2], neg)
    gap2 = np.select([kind == 0, kind == 2], [rng.integers(-2, 3, shape),
                                              nogap + 2], neg)
    nogap = np.where(kind == 0, small, nogap)
    holes = (kind == 0) & (rng.random((3,) + shape) < 0.1)
    nogap, gap1, gap2 = (np.where(h, neg, a)
                         for h, a in zip(holes, (nogap, gap1, gap2)))
    len1 = rng.integers(2, M + 1, nb)
    len1[:2] = (2, M)[: min(nb, 2)]
    gl = rng.integers(0, 5, (nb, NL))
    grv = rng.integers(0, 5, (nb, NL))
    for row in range(nb):   # dinucleotides: GT/GC/AT left, AG/AC right
        for c in rng.choice(NL - 1, 6, replace=False):
            gl[row, c : c + 2] = ((2, 3), (2, 1), (0, 3))[c % 3]
            grv[row, c : c + 2] = ((2, 0), (1, 0))[c % 2]
    loff = rng.integers(0, 1000, nb)
    roff = loff + rng.integers(0, 200, nb)
    # offsets at both ends of int32 (a genome past 2^31 bases): every 5th
    # junction's difference wraps to a small negative one, every 5th
    # other's to just above INT32_MIN, so that it less a column wraps too
    loff[4::5] = -2**31 + rng.integers(0, 1000, len(loff[4::5]))
    roff[4::5] = 2**31 - 1 - rng.integers(0, 1000, len(roff[4::5]))
    loff[3::5] = 2**31 - 1 - rng.integers(0, 30, len(loff[3::5]))
    roff[3::5] = rng.integers(0, 30, len(roff[3::5]))
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return dict(
        nogap=i32(nogap), gap1=i32(gap1), gap2=i32(gap2),
        ndiag=rng.random(shape) < 0.3, len1=i32(len1), len2L=i32(len1 + 8),
        len2R=i32(len1 + 8), lbandL=i32(rng.integers(0, 4, nb)),
        lbandR=i32(rng.integers(0, 4, nb)), gl=i32(gl), grv=i32(grv),
        known=i32(rng.integers(0, 2, (nb, NL + 1)) * 20),
        loff=loff.astype(np.int64), roff=roff.astype(np.int64))


BAND_SWEEP_KINDS = ("full band", "lband 0", "short genome", "full genome",
                    "band past W")


def band_sweep_cases(rng: np.random.Generator, nb: int, M: int = 64,
                     W: int = 23, N: int | None = None) -> dict:
    """Inputs of the banded Gotoh sweep (``ops/dynprog.banded_matrices``,
    kernel K11) for ``nb`` problems, problem i of kind
    BAND_SWEEP_KINDS[i % 5]: "full band": lband + rband = W - 1 (the band
    fills the W cells), lband random; "lband 0": the band starts at the
    diagonal; "short genome": len2 below W, so that cells of the band lie
    past the genome's end; "full genome": len2 = N; "band past W": lband
    + rband = W + 3.  Query and genome codes run 0-5 (N and the
    past-chromosome '*' among them), the genome copying the query 70% of
    the time; the query rows past len1 hold 5 (the GMAP path's padding)
    in even problems and random codes in odd ones; len1 runs 1..M
    (problem 0 has 1, problem 1 has M), N defaults to M + 8; jump_late
    is random, problems 0 and 1 jump early and late.  Returns q int32[nb,
    M], g int32[nb, N], len1 / len2 / lband / rband int32[nb] and late
    bool[nb]."""
    N = M + 8 if N is None else N
    q = rng.integers(0, 6, (nb, M))
    g = rng.integers(0, 6, (nb, N))
    n = min(M, N)
    g[:, :n] = np.where(rng.random((nb, n)) < 0.7, q[:, :n], g[:, :n])
    len1 = rng.integers(1, M + 1, nb)
    len1[:2] = (1, M)[: min(nb, 2)]
    pad = ((np.arange(nb) % 2 == 0)[:, None]
           & (np.arange(M)[None, :] >= len1[:, None]))
    q = np.where(pad, 5, q)
    len2 = rng.integers(1, N + 1, nb)
    lband = np.zeros(nb, np.int64)
    rband = np.zeros(nb, np.int64)
    for i in range(nb):
        kind = BAND_SWEEP_KINDS[i % len(BAND_SWEEP_KINDS)]
        lband[i] = rng.integers(0, W) if kind != "lband 0" else 0
        if kind == "full band":
            rband[i] = W - 1 - lband[i]
        elif kind == "band past W":
            rband[i] = W + 3 - lband[i]
        else:
            rband[i] = rng.integers(0, W - lband[i])
        if kind == "short genome":
            len2[i] = rng.integers(0, W) if W > 1 else 0
        elif kind == "full genome":
            len2[i] = N
    late = rng.random(nb) < 0.5
    late[:2] = (False, True)[: min(nb, 2)]
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return dict(q=i32(q), g=i32(g), len1=i32(len1), len2=i32(len2),
                lband=i32(lband), rband=i32(rband), late=late)


SEED_ROW_KINDS = ("random", "ns", "short", "poly-A", "poly-T", "poly-C",
                  "poly-G", "all N", "low positions", "repeat")


def seed_row_cases(rng: np.random.Generator, b: int, L: int, k: int,
                   threshold: int) -> dict:
    """Reads and a k-mer index of their own for the seed-diagonal stage
    (``align/gsnap_se.seed_diagonals``, kernel K1), read i of kind
    SEED_ROW_KINDS[i % 10] over 4^k oligos with hand-set counts: "random";
    "ns": N flags at random places and an N run; "short": a length below
    L (below k in every third such read, so that no k-mer is inside it);
    "poly-A": every k-mer the all-A oligo, whose count is threshold + 1
    (valid, never usable); "poly-T": the all-T oligo, count 0 (in
    threshold, not usable); "poly-C": the all-C oligo, count exactly
    threshold; "poly-G": the all-G oligo, count 1; "all N": no valid
    k-mer; "low positions": oligos whose positions lie below their query
    positions (diag INVALID), and "repeat": a repeated 3-base unit whose
    three oligos hold threshold positions each, so that a small grid
    truncates.  Other oligos' counts run 0..threshold + 2; a third of all
    positions lie below 64, a tenth near 2^32.  Returns codes uint8[b, L]
    (0..3), nflags bool[b, L], lengths int32[b], offsets int32[4^k + 1]
    and positions int32[P] holding uint32 bits."""
    n_oligo = 4 ** k
    counts = rng.integers(0, threshold + 3, n_oligo)
    poly = lambda c: sum(c << (2 * i) for i in range(k))
    counts[poly(0)] = threshold + 1
    counts[poly(3)] = 0
    counts[poly(1)] = threshold
    counts[poly(2)] = 1
    unit = np.array([0, 1, 3])
    rep = [int(sum(int(unit[(j + i) % 3]) << (2 * (k - 1 - i))
                   for i in range(k))) for j in range(3)]
    counts[rep] = threshold
    total = int(counts.sum())
    pos = rng.integers(64, 2**31, max(total, 1)).astype(np.int64)
    r = rng.random(len(pos))
    pos = np.where(r < 0.33, rng.integers(0, 64, len(pos)), pos)
    pos = np.where(r > 0.9, 2**32 - 1 - rng.integers(0, 1 << 20, len(pos)),
                   pos)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    low = [o for o in range(n_oligo) if counts[o] > 0][:64]
    for o in low:   # "low positions" reads draw from these oligos
        pos[offsets[o] : offsets[o + 1]] = rng.integers(
            0, 8, counts[o])
    codes = rng.integers(0, 4, (b, L))
    nflags = np.zeros((b, L), bool)
    lengths = np.full(b, L)
    for i in range(b):
        kind = SEED_ROW_KINDS[i % len(SEED_ROW_KINDS)]
        if kind == "ns":
            nflags[i, rng.choice(L, max(1, L // 10), replace=False)] = True
            at = rng.integers(0, L)
            nflags[i, at : at + k // 2 + 1] = True
        elif kind == "short":
            lengths[i] = (rng.integers(0, k) if i % 3 == 0 or L <= k
                          else rng.integers(k, L))
        elif kind.startswith("poly-"):
            codes[i] = "ACGT".index(kind[-1])
        elif kind == "all N":
            nflags[i] = True
        elif kind == "low positions":
            # k-mers of the low oligos, laid end to end
            picks = rng.choice(low, -(-L // k))
            seq = np.concatenate([[(o >> (2 * (k - 1 - j))) & 3
                                   for j in range(k)] for o in picks])
            codes[i] = seq[:L]
        elif kind == "repeat":
            codes[i] = unit[np.arange(L) % 3]
    # codes past a read's length are random, as a batch's padding may be
    return dict(codes=codes.astype(np.uint8), nflags=nflags,
                lengths=lengths.astype(np.int32),
                offsets=offsets.astype(np.uint32).view(np.int32),
                positions=pos.astype(np.uint32).view(np.int32))


def pair_grid_edges(rng: np.random.Generator, b: int, nchr: int = 1000,
                    nc: int = 24, L: int = 100):
    """``pair_hit_cases``' hits for ``b`` read pairs beside ``nchr``
    chromosomes: their offsets int64 [nchr + 1] (0 first, 2^32 - 1 last:
    the JAX package keeps them as uint32) are random, and three in each of
    pair_hit_cases' clusters, so that hits and mates straddle chromosome
    ends.  Rows where every cell of the grid is BIG: pair 3 and every 5th
    after it have every read-1 hit BIG, pair 4 and every 5th after it
    every read-2 hit.  Rows 1 and 2 keep pair_hit_cases' grid of equal
    scores, where the ranks of left5 and left3 and the cell index decide
    (no chromosome ends inside them).
    Returns (hits, lengths5, lengths3, chr_offsets)."""
    near = np.asarray(PAIR_HIT_BASES, np.int64)[:, None] + rng.integers(
        -3000, 3000, (len(PAIR_HIT_BASES), 3))
    rest = rng.choice(2**32 - 2, nchr - 1 - near.size, replace=False) + 1
    ends = np.unique(np.concatenate([near.ravel() % (2**32 - 1), rest]))
    keep = (ends > 0) & (ends < 2**32 - 1)
    for start in (100_000_000, 2**31 - 150):   # rows 1 and 2 stay whole
        keep &= (ends <= start) | (ends > start + 2_000)
    ends = ends[keep][: nchr - 1]
    offsets = np.concatenate([[0], ends, [2**32 - 1]]).astype(np.int64)
    hits, len5, len3 = pair_hit_cases(rng, b, offsets[1:], nc, L)
    big = hits["score"]
    big[3:b:5] = 10**6
    big[b + 4 :: 5] = 10**6
    hits["nmm"] = np.where(big < 10**6, hits["nmm"], 0).astype(np.int32)
    return hits, len5, len3, offsets


# (Q, k, threshold, H, S, rows of exactly n hits) of seed_segment_cases
# that the tests and chip_smoke.py run: Q 1, 33 and 128; k 12 (a kept
# segment is two hits) and 15 (one hit); H and S small enough that rows
# reach them, and H 4,096 with rows either side of K9's register /
# scratch edge (kernels/limits.py seed_segments_register_hits)
# (B, L) of the read packing kernel's edge batches (K17): the main L,
# rows that start off a 4-byte boundary (L 17, 151), a word of 16 and
# lengths past one and two words, the longest read the card takes
# (ops/mismatch.CUDA_MAX_READ_LENGTH), B off a multiple of the reads in a
# CTA, and B of 1 and 0
PACK_QUERY_SHAPES = ((61, 100), (61, 17), (61, 151), (37, 16), (37, 33),
                     (3, 14432), (1, 100), (0, 100))
PACK_QUERY_KINDS = ("random", "all N", "N runs", "longer than L")
PACK_EDGE_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33)


def pack_query_cases(rng: np.random.Generator, b: int, L: int,
                     uniform: bool = False):
    """(codes uint8[b, L], nflags bool[b, L], lengths int32[b]) for the
    read packing and reverse complement (K17).  codes are 2-bit and the
    bytes past a read's length hold random codes, as a reused buffer may;
    3% of the flags are set.  The first rows take the lengths of
    PACK_EDGE_LENGTHS below L and then L; the others a random length in
    [1, L] and, cycling over PACK_QUERY_KINDS, every flag set ("all N"),
    a run of up to 40 flags ("N runs") or a length 1-3 past L, which the
    reverse complement's source clips to L - 1 ("longer than L").  With
    ``uniform`` every length is L (the flip's contract)."""
    codes = rng.integers(0, 4, (b, L)).astype(np.uint8)
    nflags = rng.random((b, L)) < 0.03
    lengths = rng.integers(1, L + 1, b).astype(np.int32)
    edges = [x for x in PACK_EDGE_LENGTHS if x < L] + [L]
    for row in range(b):
        kind = PACK_QUERY_KINDS[row % len(PACK_QUERY_KINDS)]
        if kind == "all N":
            nflags[row] = True
        elif kind == "N runs":
            a = int(rng.integers(0, L))
            nflags[row, a : a + int(rng.integers(1, 41))] = True
        elif kind == "longer than L":
            lengths[row] = L + int(rng.integers(1, 4))
        if row < len(edges):
            lengths[row] = edges[row]
    if uniform:
        lengths[:] = L
    return codes, nflags, lengths


SEED_SEGMENT_CASES = ((1, 12, 5, 16, 4, ()), (33, 12, 5, 64, 8, ()),
                      (128, 15, 10, 256, 16, ()),
                      (128, 12, 100, 4096, 192, (2048, 2049)))
# (S, last valid segments) of chain_cases that they run: lv 0, 31, 32,
# 33 and S - 1; S 1,100 past the 1,024 segments K10 stages
CHAIN_CASE_SHAPES = ((64, (0, 31, 32, 33)), (48, (47, 1, 2)),
                     (1100, (1099, 5)))
SEGMENT_ROW_KINDS = ("random", "count 0", "count 1", "count threshold",
                     "count threshold + 1", "no valid k-mer", "nhits = H",
                     "nhits = H + 1", "nsegs = S", "nsegs = S + 1", "edges")
SEGMENT_MIN_SEGLEN = 15   # gmap_engine.MIN_SEGLEN


def seed_segment_cases(rng: np.random.Generator, Q: int, k: int,
                       threshold: int, H: int, S: int,
                       nhits=()) -> dict:
    """Oligo rows and an index of their own for GMAP's seeding and
    segment stage (``align/gmap_engine.seed_segments``, kernel K9): one
    row of each SEGMENT_ROW_KINDS that fits Q k-mers and the threshold,
    then one row of exactly n hits for each n in ``nhits``.  Each k-mer of
    each row is its own oligo; a hit is placed by its diagonal (position
    = diag + qpos - Q, as uint32).  "count c": one k-mer holding c hits;
    "no valid k-mer": hits, every k-mer flagged invalid; "nhits = H" /
    "H + 1": k-mers filled to that many hits; "nsegs = S" / "S + 1": that
    many kept segments on distinct diagonals (two hits MIN_SEGLEN - k
    apart, or one hit where k >= MIN_SEGLEN); "edges": a segment exactly
    MIN_SEGLEN long and one a base shorter, query gaps of 2k (one
    segment) and 2k + 1 (two), diagonals that wrap uint32 and a hit whose
    diagonal is 0xFFFFFFFF.  Returns offsets int32[R Q + 1], positions
    int32[P] holding uint32 bits, oligos int32[R, Q], valid bool[R, Q]
    and kinds (one name a row)."""
    U = 2**32
    d = max(SEGMENT_MIN_SEGLEN - k, 0)     # qpos span of a shortest kept
    rows, kinds = [], []

    def new_row(kind):
        rows.append(({}, np.ones(Q, bool)))
        kinds.append(kind)
        return rows[-1]

    def hit(row, q, diag):
        row[0].setdefault(q, set()).add(int(diag) % U)

    def spread(row, q, n):   # n hits of k-mer q on distinct diagonals
        for diag in rng.choice(1 << 30, n, replace=False) + (1 << 20):
            hit(row, q, diag)

    row = new_row("random")
    diags = rng.integers(1 << 20, 1 << 30, 6)
    for q in range(Q):
        if rng.random() < 0.5:
            spread(row, q, int(rng.integers(1, 4)))
        if rng.random() < 0.6:     # runs on a few shared diagonals
            hit(row, q, diags[rng.integers(0, len(diags))])
    for c in (0, 1, threshold, threshold + 1):
        row = new_row(f"count {c if c < threshold else 'threshold'}"
                      + (" + 1" if c > threshold else ""))
        spread(row, Q // 2, c)
        if Q > 1:
            spread(row, 0, 1)
    row = new_row("no valid k-mer")
    for q in range(Q):
        spread(row, q, 2)
    row[1][:] = False
    for n, kind in ((H, "nhits = H"), (H + 1, "nhits = H + 1"),
                    *((n, f"nhits = {n}") for n in nhits)):
        if n > Q * threshold:
            continue
        row = new_row(kind)
        left = n
        for q in range(Q):
            c = min(threshold, left)
            spread(row, q, c)
            left -= c
    for n, kind in ((S, "nsegs = S"), (S + 1, "nsegs = S + 1")):
        pairs = [(q, q + d) for q in range(0, Q - d, d + 1 if d else 1)]
        if n > len(pairs) * threshold:
            continue
        row = new_row(kind)
        sdiags = rng.choice(1 << 30, n, replace=False) + (1 << 20)
        for i, diag in enumerate(sdiags):
            for q in set(pairs[i % len(pairs)]):
                hit(row, q, diag)
    if Q > 2 * k + 2 + d:
        row = new_row("edges")
        base = int(rng.integers(1 << 20, 1 << 29))
        for q in (0, d):                  # exactly MIN_SEGLEN: kept
            hit(row, q, base)
        if d >= 1:
            for q in (0, d - 1):          # a base shorter: dropped
                hit(row, q, base + 1)
        for q in (0, 2 * k, 2 * k + d):   # gap 2k: one segment
            hit(row, q, base + 2)
        for q in (0, 2 * k + 1, 2 * k + 1 + d):   # 2k + 1: two
            hit(row, q, base + 3)
        for q in (1, 1 + d):              # positions near 2^32: wrap
            hit(row, q, Q - 2)
            hit(row, q, U - 1)            # the padding's diagonal
    R = len(rows)
    counts = np.zeros(R * Q, np.int64)
    pos = []
    for r, (hits, _) in enumerate(rows):
        for q in range(Q):
            diags = sorted(hits.get(q, ()))
            counts[r * Q + q] = len(diags)
            pos += [(dg + q - Q) % U for dg in diags]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return dict(offsets=offsets.astype(np.uint32).view(np.int32),
                positions=np.array(pos or [0], np.uint32).view(np.int32),
                oligos=np.arange(R * Q, dtype=np.int32).reshape(R, Q),
                valid=np.stack([v for _, v in rows]), kinds=kinds)


CHAIN_ROW_KINDS = ("random", "ties", "no valid segment", "lv at the end")


def chain_cases(rng: np.random.Generator, b: int, S: int,
                lvs=(0, 31, 32, 33)) -> dict:
    """Segment rows for GMAP's chain DP (``align/gmap_engine.chain``,
    kernel K10), ordered by (qstart, diag) as K9 leaves them: row i's
    last valid segment is lvs[i % len(lvs)] (clipped to S - 1), with
    invalid segments before it in every third row; every fourth row is of
    kind CHAIN_ROW_KINDS[(i // 4) % 4]: "ties" (up to 40 segments alike
    and one that chains onto each equally, so that equal candidates name
    predecessors 32 apart), "no valid segment",
    "lv at the end" (lv = S - 1).  Diagonals step by indels (|gd| <= 30),
    introns (9 to 300,000) and wrap uint32 near 0.  Returns qstart, qend
    int32[b, S], diag int64[b, S] (uint32 values), valid bool[b, S]."""
    qstart = np.zeros((b, S), np.int64)
    qend = np.zeros((b, S), np.int64)
    diag = np.zeros((b, S), np.int64)
    valid = np.zeros((b, S), bool)
    for i in range(b):
        lv = min(lvs[i % len(lvs)], S - 1)
        kind = CHAIN_ROW_KINDS[(i // 4) % 4] if i % 4 == 3 else "random"
        if kind == "lv at the end":
            lv = S - 1
        n = lv + 1
        qs = np.sort(rng.integers(0, 4 * n + 20, n))
        qe = qs + rng.integers(12, 40, n)
        step = rng.choice([0, 1, 2], n, p=[0.5, 0.3, 0.2])
        jump = np.where(step == 0, rng.integers(-30, 31, n),
                        np.where(step == 1, rng.integers(9, 300_000, n),
                                 rng.integers(-2_000_000, 2_000_000, n)))
        dg = (int(rng.integers(0, 2**32)) + np.cumsum(jump)) % 2**32
        if i % 5 == 0:                       # wrap near 0
            dg = (dg - dg[0] + 50) % 2**32
        if kind == "ties":
            # segments 0 .. n - 2 alike and segment n - 1 chaining onto each
            # of them equally: candidates tie at j and j + 32 in a lane
            n = lv + 1 if lv >= 33 else min(S, 40)
            qs = np.full(n, qs[0])
            qe = qs + 12
            qs[-1], qe[-1] = qe[0], qe[0] + 20
            dg = np.full(n, dg[0])
        order = np.lexsort((dg, qs))
        qstart[i, :n], qend[i, :n], diag[i, :n] = qs[order], qe[order], dg[order]
        valid[i, :n] = kind != "no valid segment"
        if i % 3 == 0 and n > 2 and kind != "ties":
            valid[i, rng.choice(n - 1, max(1, n // 5), replace=False)] = False
        qstart[i, n:] = qstart[i, n - 1]
        qend[i, n:] = qend[i, n - 1]
        diag[i, n:] = 0xFFFFFFFF
    return dict(qstart=qstart.astype(np.int32), qend=qend.astype(np.int32),
                diag=diag, valid=valid)


# ------------------------------------------------------ gmap cDNA queries

@dataclass
class GmapTruth:
    """Where a cDNA query was cut from: its exons as universal [start,
    end) plus-strand spans in genome order, on chromosome ``chrom``;
    ``plusp`` is False when the query is their reverse complement.  A
    chimera's ``parts`` hold one GmapTruth per part in query order, and
    ``breakpoint`` is the 0-based query position where part 1 ends."""
    chrom: str
    plusp: bool
    exons: list
    parts: list | None = None
    breakpoint: int | None = None

    @property
    def introns(self) -> list:
        """[(first intron base, last intron base + 1)] in genome order."""
        return [(a[1], b[0]) for a, b in zip(self.exons, self.exons[1:])]


def _chrom_of(genome: Genome, pos: int) -> int:
    return int(np.searchsorted(genome.chr_ends, pos, side="right"))


def _clean_span(genome: Genome, ncum, p: int, span: int) -> bool:
    """[p, p + span) lies inside one chromosome and holds no N."""
    c = _chrom_of(genome, p)
    return (p + span <= int(genome.chr_ends[c])
            and ncum[p + span] - ncum[p] == 0)


def _cdna(genome: Genome, exons, plusp: bool, subs=()) -> str:
    """The exons' bases joined, with substitutions [(query position,
    base)] (base None: one that differs from the genome's), reverse
    complemented unless plusp."""
    seq = np.concatenate([genome.ascii[s:e] for s, e in exons])
    for q, b in subs:
        seq[q] = (_ACGT[(np.flatnonzero(_ACGT == seq[q])[0] + 1) % 4]
                  if b is None else b)
    if not plusp:
        seq = _COMP[seq[::-1]]
    return seq.tobytes().decode()


def gmap_queries(rng: np.random.Generator, genome: Genome, n: int,
                 sites: bool = True, messy: float = 0.0,
                 prefix: str = "c"):
    """``n`` three-exon cDNA queries shaped as bench.py make_gmap_workload
    makes them (bench.py:86-101; the port cannot import bench.py): exons
    of 200-800 nt, introns of 500-8,000 nt, 0-4 random base draws (a draw
    may keep the base).  With ``sites`` each intron runs between a donor
    and an acceptor site of maxent probability >= 0.90 (GT..AG, or CT..AC
    for a gene on the minus strand), drawn uniformly among such sites
    within those lengths; without, the draws are bench.py's own and the
    junctions fall anywhere (on a random genome their placement is often
    ambiguous by a base or more).  A share ``messy`` of the queries also
    carries 2 substitutions within 11 nt of one junction, where the GMAP
    engine re-solves the junction with its dynprog (kernels K11, K12).
    Unlike bench.py, a placement that crosses a chromosome end or an N
    is drawn again, and half the queries are reverse complemented.
    Returns (records, [GmapTruth])."""
    g = genome.ascii
    codes = genome.codes_flags[0]
    ncum = _ncum(genome)

    def pick(lo, hi, kind):
        got = _good_sites(genome, codes, lo, hi, kind)
        return int(rng.choice(got)) if len(got) else None

    records, truth = [], []
    for i in range(n):
        while True:
            p = int(rng.integers(0, len(g) - 30000))
            exlens = rng.integers(200, 800, 3)
            gaps = rng.integers(500, 8000, 2)
            if not sites:
                exons, gp = [], p
                for j, el in enumerate(exlens):
                    exons.append((gp, gp + int(el)))
                    gp += int(el) + (int(gaps[j]) if j < 2 else 0)
            else:
                ks, ke = (("donor", "acceptor") if rng.random() < 0.5
                          else ("antiacceptor", "antidonor"))
                s1 = pick(p + 200, p + 800, ks)
                e1 = None if s1 is None else pick(s1 + 500, s1 + 8000, ke)
                s2 = None if e1 is None else pick(e1 + 200, e1 + 800, ks)
                e2 = None if s2 is None else pick(s2 + 500, s2 + 8000, ke)
                if e2 is None:
                    continue
                exons = [(p, s1), (e1, s2), (e2, e2 + int(exlens[2]))]
            if _clean_span(genome, ncum, p, exons[-1][1] - p):
                break
        L = sum(e - s for s, e in exons)
        subs = [(int(rng.integers(0, L)), _ACGT[int(rng.integers(0, 4))])
                for _ in range(int(rng.integers(0, 5)))]
        if rng.random() < messy:
            at = sum(e - s for s, e in exons[: int(rng.integers(1, 3))])
            for q in at + rng.choice(np.arange(-11, 11), 2, replace=False):
                subs.append((int(q), None))
        plusp = bool(rng.random() < 0.5)
        name = f"{prefix}{i}"
        records.append(Record(name, name, _cdna(genome, exons, plusp, subs)))
        truth.append(GmapTruth(genome.names[_chrom_of(genome, p)], plusp,
                               exons))
    return records, truth


def gmap_chimeras(rng: np.random.Generator, genome: Genome, n: int,
                  prefix: str = "x"):
    """``n`` chimeric queries: a 200-600 nt piece of one chromosome's plus
    strand joined to the reverse complement of a 200-600 nt piece of
    another chromosome.  Needs two chromosomes or more.  Returns (records,
    [GmapTruth]) with each query's two parts and its breakpoint."""
    assert len(genome.names) >= 2
    ncum = _ncum(genome)
    starts = np.concatenate([[0], genome.chr_ends[:-1]])
    records, truth = [], []
    for i in range(n):
        c1, c2 = rng.choice(len(genome.names), 2, replace=False)
        parts = []
        for c, plusp in ((int(c1), True), (int(c2), False)):
            ln = int(rng.integers(200, 601))
            while True:
                p = int(rng.integers(int(starts[c]),
                                     int(genome.chr_ends[c]) - ln))
                if _clean_span(genome, ncum, p, ln):
                    break
            parts.append(GmapTruth(genome.names[c], plusp, [(p, p + ln)]))
        seq = "".join(_cdna(genome, t.exons, t.plusp) for t in parts)
        name = f"{prefix}{i}"
        records.append(Record(name, name, seq))
        n1 = parts[0].exons[0][1] - parts[0].exons[0][0]
        truth.append(GmapTruth(parts[0].chrom, True, parts[0].exons,
                               parts=parts, breakpoint=n1 - 1))
    return records, truth


def gmap_long_queries(rng: np.random.Generator, genome: Genome, n: int,
                      prefix: str = "long"):
    """``n`` long cDNA queries of 20-60 kb in 20-40 exons (each at least
    100 nt) with introns of 200-3,000 nt and no substitutions: past
    16,398 bases the GMAP engine takes its largest Q rung, 65,536.
    Returns (records, [GmapTruth])."""
    g = genome.ascii
    ncum = _ncum(genome)
    records, truth = [], []
    for i in range(n):
        L = int(rng.integers(20_000, 60_001))
        E = int(rng.integers(20, 41))
        cuts = np.sort(rng.choice(np.arange(1, L // 100), E - 1,
                                  replace=False)) * 100
        exlens = np.diff(np.concatenate([[0], cuts, [L]]))
        gaps = rng.integers(200, 3001, E - 1)
        span = int(exlens.sum() + gaps.sum())
        while True:
            p = int(rng.integers(0, len(g) - span))
            if _clean_span(genome, ncum, p, span):
                break
        exons, gp = [], p
        for j, el in enumerate(exlens):
            exons.append((gp, gp + int(el)))
            gp += int(el) + (int(gaps[j]) if j < E - 1 else 0)
        plusp = bool(rng.random() < 0.5)
        name = f"{prefix}{i}"
        records.append(Record(name, name, _cdna(genome, exons, plusp)))
        truth.append(GmapTruth(genome.names[_chrom_of(genome, p)], plusp,
                               exons))
    return records, truth


def gmap_repeat_queries(rng: np.random.Generator, genome: Genome, n: int,
                        L: int = 300, prefix: str = "dup"):
    """``n`` queries on duplicated segments, as tests/test_gmap_multipath.py
    builds its genome: an L-nt segment is copied over two other places of
    ``genome`` (changed in place, so call this before the genome is
    written or indexed), once with 2 mismatches (at 50 and 150, A or G)
    and once exact; the query is the segment, on either strand.  Returns
    (records, [GmapTruth] of the original, [(the 2-mismatch copy's start,
    the exact copy's start)])."""
    g = genome.ascii
    ncum = _ncum(genome)   # copies of N-free spans keep the N counts
    records, truth, copies = [], [], []
    taken: list = []
    for i in range(n):
        starts = []
        while len(starts) < 3:
            p = int(rng.integers(0, len(g) - L))
            if (_clean_span(genome, ncum, p, L)
                    and all(abs(p - q) > 2 * L for q in taken + starts)):
                starts.append(p)
        taken += starts
        p0, p1, p2 = starts
        seg = g[p0 : p0 + L].copy()
        mm = seg.copy()
        for q in (50, 150):
            mm[q] = ord("A") if mm[q] != ord("A") else ord("G")
        g[p1 : p1 + L] = mm
        g[p2 : p2 + L] = seg
        plusp = bool(rng.random() < 0.5)
        name = f"{prefix}{i}"
        records.append(Record(name, name,
                              _cdna(genome, [(p0, p0 + L)], plusp)))
        truth.append(GmapTruth(genome.names[_chrom_of(genome, p0)], plusp,
                               [(p0, p0 + L)]))
        copies.append((p1, p2))
    return records, truth, copies


def write_fasta_records(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.header}\n{r.seq}\n")


# ---------------------------------------------------------------------------
# multimapping: exact copies of blocks, reads and pairs from copies, and the
# maps that resolve them (gsnap -g / --favor-multiexon, --use-tally,
# --use-runlength), taken from the planted copies


def duplicate_blocks(rng: np.random.Generator, genome: Genome, n: int,
                     L: int = 400, copies: int = 3) -> np.ndarray:
    """Copy ``n`` random L-nt blocks of ``genome`` exactly over ``copies``
    - 1 other places each (the genome is changed in place, so call this
    before it is written or indexed).  Every copy lies inside one
    chromosome, free of N, away from the repeat family and more than 2 L
    from any other copy.  Returns int64 [n, copies]: each block's copy
    starts, its own place first."""
    g = genome.ascii
    ncum = _ncum(genome)   # copies of N-free spans keep the N counts
    rep = genome.repeats
    taken: list = []
    out = np.zeros((n, copies), np.int64)
    for i in range(n):
        starts: list = []
        while len(starts) < copies:
            p = int(rng.integers(0, len(g) - L))
            if (_clean_span(genome, ncum, p, L)
                    and all(abs(p - q) > 2 * L for q in taken + starts)
                    and not np.any(np.abs(rep - p) < L + genome.repeat_unit)):
                starts.append(p)
        taken += starts
        for q in starts[1:]:
            g[q : q + L] = g[starts[0] : starts[0] + L]
        out[i] = starts
    return out


def _mutate(rng: np.random.Generator, seq: np.ndarray, nsub: int) -> None:
    for q in rng.choice(len(seq), nsub, replace=False):
        seq[q] = _ACGT[(np.flatnonzero(_ACGT == seq[q])[0]
                        + rng.integers(1, 4)) % 4]


def plant_copy_reads(rng: np.random.Generator, genome: Genome, groups,
                     unit: int, n: int, L: int = 100, prefix: str = "u"):
    """``n`` reads of length L inside a random copy of a random group of
    ``groups`` (int [ngroups, ncopies] copy starts, each copy ``unit``
    nt; duplicate_blocks' output, or ``genome.repeats[None]`` for the
    repeat family), 0-1 substitutions, either strand.  Returns (records,
    [(group, copy)])."""
    groups = np.asarray(groups)
    records, where = [], []
    for i in range(n):
        gi = int(rng.integers(0, groups.shape[0]))
        ci = int(rng.integers(0, groups.shape[1]))
        p = int(groups[gi, ci]) + int(rng.integers(0, unit - L + 1))
        seq = genome.ascii[p : p + L].copy()
        _mutate(rng, seq, int(rng.integers(0, 2)))
        if rng.random() < 0.5:
            seq = _COMP[seq[::-1]]
        qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
        name = f"{prefix}{i}"
        records.append(Record(name, name, seq.tobytes().decode(),
                              qual.tobytes().decode()))
        where.append((gi, ci))
    return records, where


def plant_copy_pairs(rng: np.random.Generator, genome: Genome, groups,
                     unit: int, n: int, L: int = 100, far: float = 0.0,
                     prefix: str = "v"):
    """``n`` read pairs (read 1 records, read 2 records, [(group, copy)])
    whose fragment of 150..``unit`` nt lies inside a random copy, so that
    the pair is concordant at every copy of its group; read 2 is the
    reverse complement of the fragment's end (FR), and half the pairs
    are written mate first.  A share ``far`` of them takes read 2 from
    3-8 kbp past the copy instead (a pair too long for -N 0's pairmax,
    unique at that end).  0-1 substitutions per read."""
    groups = np.asarray(groups)
    ncum = _ncum(genome)
    r1, r2, where = [], [], []
    i = 0
    while len(r1) < n:
        gi = int(rng.integers(0, groups.shape[0]))
        ci = int(rng.integers(0, groups.shape[1]))
        s = int(groups[gi, ci])
        if rng.random() < far:
            a = s + int(rng.integers(0, unit - L + 1))
            b = s + unit + int(rng.integers(3000, 8001))
            if (b > len(genome.ascii)
                    or not _clean_span(genome, ncum, b - L, L)
                    or _chrom_of(genome, b - L) != _chrom_of(genome, a)):
                continue
        else:
            ins = int(rng.integers(150, unit + 1))
            a = s + int(rng.integers(0, unit - ins + 1))
            b = a + ins
        m1 = genome.ascii[a : a + L].copy()
        m2 = _COMP[genome.ascii[b - L : b][::-1]]
        _mutate(rng, m1, int(rng.integers(0, 2)))
        _mutate(rng, m2, int(rng.integers(0, 2)))
        if rng.random() < 0.5:
            m1, m2 = m2, m1
        name = f"{prefix}{i}"
        for out, m in ((r1, m1), (r2, m2)):
            qual = (rng.integers(20, 41, L) + 33).astype(np.uint8)
            out.append(Record(name, name, m.tobytes().decode(),
                              qual.tobytes().decode()))
        where.append((gi, ci))
        i += 1
    return r1, r2, where


def _chr_place(genome: Genome, p: int) -> tuple[str, int]:
    """(chromosome name, 1-based chromosome position) of universal p."""
    c = _chrom_of(genome, p)
    start = int(genome.chr_ends[c - 1]) if c else 0
    return genome.names[c], p - start + 1


def copy_genes_gtf(genome: Genome, groups, unit: int) -> str:
    """GTF exon lines (cli/gtf_genes' input) of genes over chosen copies:
    copy j of group gi carries a one-exon gene over the copy when j % 4
    == 0, a two-exon gene (the copy, then 200 nt from 300 nt past it)
    when j % 4 == 1 and gi is even, and none otherwise; the genes of
    every other group (and every other four copies) lie on the minus
    strand.  With three copies, -g keeps copies 0 and 1 of an even
    group's three and --favor-multiexon copy 1 alone; of an odd group's,
    both keep copy 0."""
    lines = []
    for gi, row in enumerate(np.asarray(groups)):
        for j, s in enumerate(int(x) for x in row):
            if j % 4 > 1 or (j % 4 == 1 and gi % 2):
                continue
            exons = [(s, s + unit)]
            if j % 4 == 1:
                exons.append((s + unit + 300, s + unit + 500))
                if _chrom_of(genome, exons[1][1] - 1) != _chrom_of(genome, s):
                    exons.pop()
            strand = "-" if (gi + j // 4) % 2 else "+"
            tid = f"T{gi}.{j}"
            attrs = (f'gene_id "G{gi}.{j}"; transcript_id "{tid}"; '
                     f'gene_name "gene{gi}.{j}";')
            for a, b in exons:
                name, x = _chr_place(genome, a)
                lines.append(f"{name}\tsynth\texon\t{x}\t{x + b - a - 1}\t.\t"
                             f"{strand}\t.\t{attrs}\n")
    return "".join(lines)


def copy_tally_text(rng: np.random.Generator, genome: Genome, groups,
                    unit: int) -> str:
    """A tally map in iit_store input form: one interval a copy over
    copies j % 3 == 2 (a line a position, "A<n> C<m>" with n + m in
    1..40) and copies j % 3 == 0 (zero counts, which resolve nothing)."""
    out = []
    for gi, row in enumerate(np.asarray(groups)):
        for j, s in enumerate(int(x) for x in row):
            if j % 3 == 1:
                continue
            name, x = _chr_place(genome, s)
            out.append(f">t{gi}.{j} {name}:{x}..{x + unit - 1}\n")
            if j % 3 == 2:
                n = rng.integers(1, 21, unit)
                m = rng.integers(0, 21, unit)
            else:
                n = m = np.zeros(unit, np.int64)
            out.extend(f"A{a} C{b}\n" for a, b in zip(n, m))
    return "".join(out)


def copy_runlength_text(genome: Genome, groups, unit: int) -> str:
    """A runlength map in iit_store input form: one interval a copy (the
    copy's middle half) over copies j % 3 == 0 of each group, and j % 3
    == 2 of its even groups."""
    out = []
    for gi, row in enumerate(np.asarray(groups)):
        for j, s in enumerate(int(x) for x in row):
            if j % 3 == 1 or (j % 3 == 2 and gi % 2):
                continue
            name, x = _chr_place(genome, s + unit // 4)
            out.append(f">rl{gi}.{j} {name}:{x}..{x + unit // 2 - 1}\n")
    return "".join(out)
