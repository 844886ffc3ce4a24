"""Database directory loader and device containers.

``GenomeDB`` loads a GMAP/GSNAP database directory — one built by
gmap_build or by the reference tools (identical formats) — into host
arrays.  It is the host half of gmap_gsnap_tpu/db/datadir.py's
``GenomeDB``, copied; that class's ``device_genome`` / ``device_index``
cached properties build JAX arrays, and the two functions at the end of
this module stand in for them.  Like those properties they cache their
result on the database, here per device, so runners over one database
share one copy (at k=15 the offsets alone are 4.3 GB); ``device_snps``
does the same for a SNP-tolerant index and its alt genome, and
``device_converted`` for the cmet/atoi converted index pair.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .. import convert
from ..ops import genome as genome_ops
from ..utils.device import resolve_device
from . import genomecomp, indexdb
from .iit import IIT


@dataclass
class GenomeDB:
    dbdir: str
    dbname: str
    codes: np.ndarray          # uint8[G]
    flags: np.ndarray          # bool[G]
    chr_names: list[str]
    chr_starts: np.ndarray     # int64[nchrs] universal starts
    chr_ends: np.ndarray       # int64[nchrs] universal exclusive ends
    index_files: dict | None = None
    k: int = 0
    interval: int = 0
    basesize: int = 0

    @cached_property
    def genome_str(self) -> "LazyGenomeStr":
        return LazyGenomeStr(self.codes, self.flags)

    @cached_property
    def offsets(self) -> np.ndarray | None:
        """uint32[4^k+1]; loaded lazily (gamma expansion can be slow)."""
        if self.index_files is None:
            return None
        return indexdb.read_offsets(self.index_files)

    @cached_property
    def positions(self) -> np.ndarray | None:
        if self.index_files is None:
            return None
        return indexdb.read_positions(self.index_files["positions"])

    @classmethod
    def open(cls, dbdir: str, dbname: str | None = None, idx_prefix: str = "ref",
             required_k: int = 0, required_interval: int = 0,
             required_basesize: int = 0) -> "GenomeDB":
        if dbname is None:
            dbname = os.path.basename(dbdir.rstrip("/"))
        # allow -D dir -d db layout where files live in dir/db/db.*
        base = os.path.join(dbdir, f"{dbname}.genomecomp")
        if not os.path.exists(base):
            sub = os.path.join(dbdir, dbname)
            if os.path.exists(os.path.join(sub, f"{dbname}.genomecomp")):
                dbdir = sub
                base = os.path.join(dbdir, f"{dbname}.genomecomp")
            else:
                raise FileNotFoundError(f"no {dbname}.genomecomp under {dbdir}")

        chr_iit = IIT.read(os.path.join(dbdir, f"{dbname}.chromosome.iit"))
        names = chr_iit.labels[""]
        ivs = chr_iit.intervals[""]
        starts = np.array([iv.low for iv in ivs], dtype=np.int64)
        ends = np.array([iv.high + 1 for iv in ivs], dtype=np.int64)
        genome_len = int(ends.max()) if len(ends) else 0

        codes, flags = genomecomp.read(base, genome_len)

        files = indexdb.index_filenames(
            dbdir, dbname, idx_prefix, required_k=required_k,
            required_interval=required_interval,
            required_basesize=required_basesize)
        k = interval = basesize = 0
        if files is not None:
            k, interval, basesize = files["k"], files["interval"], files["basesize"]

        return cls(
            dbdir=dbdir,
            dbname=dbname,
            codes=codes,
            flags=flags,
            chr_names=names,
            chr_starts=starts,
            chr_ends=ends,
            index_files=files,
            k=k,
            interval=interval,
            basesize=basesize,
        )


class LazyGenomeStr:
    """String-like windowed view over the genome code arrays.

    Post-processing consumes small genomic windows; materializing the
    whole genome as a Python str costs ~1 byte/nt ON TOP of the code
    arrays and collapses at 3 Gbp.  This view keeps one lazily-built
    ASCII uint8 array (vectorized host compares index it directly via
    .ascii) and decodes only the requested slices to str.
    """

    _LUT = np.frombuffer(b"ACGT", np.uint8)

    def __init__(self, codes: np.ndarray, flags: np.ndarray):
        self._codes = codes
        self._flags = flags
        self._ascii: np.ndarray | None = None
        self._codes4: np.ndarray | None = None

    @property
    def ascii(self) -> np.ndarray:
        if self._ascii is None:
            a = self._LUT[self._codes]
            if self._flags is not None and self._flags.any():
                a = a.copy()
                a[self._flags] = ord("N")
            self._ascii = a
        return self._ascii

    @property
    def codes4(self) -> np.ndarray:
        """uint8 codes with N as 4 (A C G T 0-3), which the GMAP engine's
        junction windows index: the code array itself on a genome
        without N, else one more array of 1 byte/nt, built once."""
        if self._codes4 is None:
            if self._flags is None or not self._flags.any():
                self._codes4 = self._codes
            else:
                self._codes4 = np.where(self._flags, np.uint8(4),
                                        self._codes).astype(np.uint8)
        return self._codes4

    def __len__(self) -> int:
        return len(self._codes)

    def __getitem__(self, i) -> str:
        if isinstance(i, slice):
            return self.ascii[i].tobytes().decode("latin-1")
        return chr(self.ascii[int(i)])


def _cached(db, what: str, device, make):
    cache = db.__dict__.setdefault("_port_device_arrays", {})
    key = (what, resolve_device(device))
    if key not in cache:
        cache[key] = make(key[1])
    return cache[key]


def device_genome(db, device):
    """The packed genome of ``db`` on ``device``."""
    return _cached(db, "genome", device, lambda dev: convert.genome_from_host(
        db.codes, db.flags, db.chr_ends, dev))


def device_snps(db, snpsdb: str, snps_dir: str | None, device):
    """The SNP-tolerant index ``snpsdb`` of ``db`` (written by
    db/transforms.write_snp_index into ``snps_dir``, default the database
    directory) on ``device``, with its alt genome: (IndexArrays, (alt
    ref16, flag16) as ops/mismatch takes it, LazyGenomeStr of the alt
    codes).  The alt genome's flags mark SNPs, so the reference N flags
    serve for matching, as in the JAX runner (runner.py:551-587)."""
    snp_base = snps_dir or db.dbdir

    def make(dev):
        files = indexdb.index_filenames(snp_base, db.dbname, "ref",
                                        snps_suffix=snpsdb)
        if files is None:
            raise FileNotFoundError(f"no SNP index {snpsdb} in {snp_base}")
        index = convert.index_from_arrays(
            indexdb.read_offsets(files),
            indexdb.read_positions(files["positions"]), files["k"],
            files["interval"], dev)
        alt_codes, _ = genomecomp.read(
            os.path.join(snp_base, f"{db.dbname}.genomecomp.{snpsdb}"),
            len(db.codes))
        alt16, _ = genome_ops.pack16(alt_codes, db.flags)
        alt16 = genome_ops.words_to_device(
            genome_ops._pad_rows(alt16, 0xFFFFFFFF), dev)
        return (index, (alt16, device_genome(db, dev).flag16),
                LazyGenomeStr(alt_codes, db.flags))

    return _cached(db, ("snps", snp_base, snpsdb), device, make)


# converted index pair of each mode (plus strand, minus strand), as
# cmetindex / atoiindex name them
CONVERTED_PREFIXES = {"cmet-stranded": ("metct", "metga"),
                      "atoi-stranded": ("a2iag", "a2itc")}


def device_converted(db, mode: str, conv_dir: str | None, device):
    """The cmet/atoi converted index pair of ``db`` for ``mode`` on
    ``device``: (IndexArrays of the plus-strand conversion, IndexArrays
    of the minus-strand one), read from ``conv_dir`` (gsnap --cmetdir /
    --atoidir) or else the database directory, as the JAX runner does
    (runner.py:590-620).  Each converted k=15 index is ~4.4 GB on the
    card; :func:`release` frees a pair."""

    def make(dev):
        pair = []
        for prefix in CONVERTED_PREFIXES[mode]:
            files = (indexdb.index_filenames(conv_dir, db.dbname, prefix)
                     if conv_dir else None)
            if files is None:
                files = indexdb.index_filenames(db.dbdir, db.dbname, prefix)
            if files is None:
                tool = "cmetindex" if prefix.startswith("met") else "atoiindex"
                raise FileNotFoundError(
                    f"no {prefix} index in {db.dbdir}; run {tool}")
            pair.append(convert.index_from_arrays(
                indexdb.read_offsets(files),
                indexdb.read_positions(files["positions"]), files["k"],
                files["interval"], dev))
        return tuple(pair)

    return _cached(db, ("converted", mode, conv_dir), device, make)


def release(db, kind: str) -> None:
    """Drop ``db``'s cached device arrays of one kind ("genome", "index",
    "snps" or "converted") on every device, so that their memory can be
    reused once no runner holds them."""
    cache = db.__dict__.get("_port_device_arrays", {})
    for key in [k for k in cache
                if (k[0] if isinstance(k[0], str) else k[0][0]) == kind]:
        del cache[key]


def device_index(db, device):
    """The k-mer index of ``db`` on ``device``."""
    if db.offsets is None:
        raise ValueError("database has no k-mer index")
    return _cached(db, "index", device, lambda dev: convert.index_from_arrays(
        db.offsets, db.positions, db.k, db.interval, dev))
