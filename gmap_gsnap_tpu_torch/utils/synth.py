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
