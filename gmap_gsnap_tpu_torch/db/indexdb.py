"""K-mer positional index ("indexdb"): in-memory build and file reading.

A copy of gmap_gsnap_tpu/db/indexdb.py.  Its writers serve the port's
database construction (db/build.py) and index transforms (db/transforms.py).
The Elias-gamma offsets are coded in C (native/hostops.c, as the JAX
module does when its native library is built); the Python loops stay as
the plain versions the C coder is held to, and run alone only on toy
oligospaces: beyond 4^12 oligos they would take hours, so a missing
native library raises there.

Semantics match the reference builder (src/indexdb.c:2041-2310
Indexdb_write_offsets, :2527-2741 compute_positions_in_memory):

  * oligos are packed MSB-first (first nt in the top 2 bits),
  * a k-mer starting at chromosome-relative position ``s`` is indexed iff
    ``s % interval == 0`` and its window contains no N/X and does not cross
    a chromosome boundary,
  * the positions file is the concatenation, over oligos in numeric order,
    of the ascending absolute (universal) genome start coordinates, as
    little-endian uint32,
  * the offsets array (length 4^k + 1) holds the cumulative counts.

On-disk formats:
  * ``<db>.ref<KK><Q>positions`` — flat uint32 coords.  Byte-parity with
    the reference (tests/setup.ref123positions.ok).
  * ``<db>.ref<BB><KK><Q>gammaptrs`` + ``.offsetscomp`` — blocked
    Elias-gamma compressed offsets, identical to the reference writer
    (src/indexdb.c:1979-2039 Indexdb_write_gammaptrs, write_gamma) so
    reference binaries can read our databases and vice versa.

The offsets are kept *expanded* as a flat uint32 array; lookup is a
two-gather: offsets[oligo] -> positions[span].
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..utils import dna


def build_index(
    codes: np.ndarray,
    flags: np.ndarray,
    chr_ends: np.ndarray,
    k: int = 12,
    interval: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """Build (offsets uint32[4^k+1], positions uint32[N]).

    ``chr_ends`` holds the exclusive end coordinate of each chromosome in
    the universal coordinate space (ascending).  ``codes``/``flags`` cover
    the whole concatenated genome (no padding).
    """
    n = len(codes)
    oligospace = 4 ** k
    if n < k:
        return np.zeros(oligospace + 1, dtype=np.uint32), np.zeros(0, dtype=np.uint32)

    oligos = dna.pack_kmers(codes, k)  # int64, len n-k+1

    # valid = no N/X in window
    bad = flags.astype(np.int32)
    cum = np.concatenate([[0], np.cumsum(bad)])
    window_bad = cum[k:] - cum[:-k]  # per start position
    valid = window_bad == 0

    starts = np.arange(n - k + 1, dtype=np.int64)
    # chromosome of each start; windows must not cross chromosome ends
    chr_ends = np.asarray(chr_ends, dtype=np.int64)
    chr_idx = np.searchsorted(chr_ends, starts, side="right")
    chr_starts = np.concatenate([[0], chr_ends])[chr_idx]
    valid &= starts + k <= chr_ends[chr_idx]
    # sampling on chromosome-relative start position
    valid &= (starts - chr_starts) % interval == 0

    sel_oligos = oligos[valid]
    sel_pos = starts[valid].astype(np.uint32)

    counts = np.bincount(sel_oligos, minlength=oligospace).astype(np.uint32)
    offsets = np.zeros(oligospace + 1, dtype=np.uint32)
    np.cumsum(counts, out=offsets[1:])
    # stable sort by oligo keeps ascending positions within each oligo
    order = np.argsort(sel_oligos, kind="stable")
    positions = sel_pos[order]
    return offsets, positions


# --------------------------------------------------------------- positions IO

def write_positions(path: str, positions: np.ndarray) -> None:
    positions.astype("<u4").tofile(path)


def read_positions(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u4").astype(np.uint32)


# ------------------------------------------------------------ gamma offsets IO

# above this oligospace the Python loops take minutes to hours
PLAIN_GAMMA_MAX_OLIGOS = 4 ** 12


def _native_gamma_lib(oligospace: int):
    from ..native import get_lib

    lib = get_lib()
    if lib is None and oligospace > PLAIN_GAMMA_MAX_OLIGOS:
        raise RuntimeError(
            f"the native gamma offset coder (native/hostops.c) could not be "
            f"built, and the Python loop over {oligospace} oligos would take "
            f"hours: install a C compiler (cc)")
    return lib


def _write_offsets_gamma_plain(offsets: np.ndarray, blocksize: int):
    """(gammaptrs, words) uint32 arrays, the reference writer's bit layout
    (src/indexdb.c:1979-2039), as one Python loop."""
    oligospace = len(offsets) - 1
    gammaptrs = []
    words: list[int] = []
    off = offsets.astype(np.uint64)
    for blk in range(0, oligospace, blocksize):
        gammaptrs.append(len(words))
        words.append(int(off[blk]))
        buffer = 0
        ctr = 32
        for j in range(1, blocksize):
            gamma = int(off[blk + j] - off[blk + j - 1]) + 1
            length = 2 * (gamma.bit_length() - 1) + 1
            while length > ctr:
                if length - ctr < 32:
                    buffer |= gamma >> (length - ctr)
                words.append(buffer & 0xFFFFFFFF)
                length -= ctr
                ctr = 32
                buffer = 0
            buffer |= (gamma << (ctr - length)) & 0xFFFFFFFF
            ctr -= length
        words.append(buffer & 0xFFFFFFFF)
    gammaptrs.append(len(words))
    words.append(int(off[oligospace]))
    return np.asarray(gammaptrs, np.uint32), np.asarray(words, np.uint32)


def _write_offsets_gamma_native(lib, offsets: np.ndarray, blocksize: int):
    """The same (gammaptrs, words) from native/hostops.c
    gamma_pack_offsets."""
    import ctypes

    oligospace = len(offsets) - 1
    off32 = np.ascontiguousarray(offsets, dtype=np.uint32)
    nblocks = oligospace // blocksize
    gp = np.empty(nblocks + 1, np.uint32)
    cap = nblocks * (2 + ((blocksize - 1) * 65 + 31) // 32) + 2
    words = np.empty(cap, np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    nw = lib.gamma_pack_offsets(
        off32.ctypes.data_as(u32p), ctypes.c_uint64(oligospace),
        ctypes.c_uint32(blocksize), gp.ctypes.data_as(u32p),
        words.ctypes.data_as(u32p))
    return gp, words[:nw]


def write_offsets_gamma(
    gammaptrs_path: str, offsetscomp_path: str, offsets: np.ndarray, basesize: int, k: int
) -> None:
    """Write blocked Elias-gamma offsets, byte-identical to the reference
    writer (src/indexdb.c:1979-2039)."""
    blocksize = 4 ** (k - basesize)
    if blocksize == 1:
        offsets.astype("<u4").tofile(offsetscomp_path)
        return
    lib = _native_gamma_lib(len(offsets) - 1)
    if lib is not None:
        gp, words = _write_offsets_gamma_native(lib, offsets, blocksize)
    else:
        gp, words = _write_offsets_gamma_plain(offsets, blocksize)
    gp.astype("<u4").tofile(gammaptrs_path)
    words.astype("<u4").tofile(offsetscomp_path)


def _read_offsets_gamma_plain(gammaptrs: np.ndarray, comp: np.ndarray,
                              oligospace: int, blocksize: int) -> np.ndarray:
    """The flat offsets of blocked Elias-gamma (gammaptrs, comp), as one
    Python loop."""
    comp = comp.astype(np.uint64)
    offsets = np.empty(oligospace + 1, dtype=np.uint32)
    oligok = 0
    for p, blk in enumerate(range(0, oligospace, blocksize)):
        ptr = int(gammaptrs[p])
        cum = int(comp[ptr])
        ptr += 1
        offsets[oligok] = cum
        oligok += 1
        bitpos = 0
        word = int(comp[ptr]) if ptr < len(comp) else 0
        for _ in range(blocksize - 1):
            # count leading zeros of the gamma code
            zeros = 0
            while not (word >> (31 - bitpos)) & 1:
                zeros += 1
                bitpos += 1
                if bitpos == 32:
                    ptr += 1
                    word = int(comp[ptr])
                    bitpos = 0
            value = 0
            for _b in range(zeros + 1):
                value = (value << 1) | ((word >> (31 - bitpos)) & 1)
                bitpos += 1
                if bitpos == 32:
                    ptr += 1
                    word = int(comp[ptr]) if ptr < len(comp) else 0
                    bitpos = 0
            cum += value - 1
            offsets[oligok] = cum
            oligok += 1
    offsets[oligok] = int(comp[int(gammaptrs[-1])])
    return offsets


def _read_offsets_gamma_native(lib, gammaptrs: np.ndarray, comp: np.ndarray,
                               oligospace: int, blocksize: int) -> np.ndarray:
    """The same flat offsets from native/hostops.c gamma_expand_offsets."""
    import ctypes

    gp = np.ascontiguousarray(gammaptrs, dtype=np.uint32)
    cp = np.ascontiguousarray(comp, dtype=np.uint32)
    out = np.empty(oligospace + 1, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.gamma_expand_offsets(
        gp.ctypes.data_as(u32p), cp.ctypes.data_as(u32p),
        out.ctypes.data_as(u32p),
        ctypes.c_uint64(oligospace), ctypes.c_uint32(blocksize),
    )
    if rc != 0:
        raise RuntimeError(f"gamma_expand_offsets failed ({rc})")
    return out


def read_offsets_gamma(
    gammaptrs_path: str, offsetscomp_path: str, basesize: int, k: int
) -> np.ndarray:
    """Expand blocked Elias-gamma offsets to a flat uint32 array
    (replaces the missing-genome_hr Genome_offsetptr_from_gammas decode;
    contract per src/genome_hr.h:22-29 and Indexdb_offsets_from_gammas,
    src/indexdb.c:1327-1445), with the native decoder."""
    blocksize = 4 ** (k - basesize)
    comp = np.fromfile(offsetscomp_path, dtype="<u4")
    oligospace = 4 ** k
    if blocksize == 1:
        return comp.astype(np.uint32)
    gammaptrs = np.fromfile(gammaptrs_path, dtype="<u4")
    lib = _native_gamma_lib(oligospace)
    if lib is not None:
        return _read_offsets_gamma_native(lib, gammaptrs, comp, oligospace,
                                          blocksize)
    return _read_offsets_gamma_plain(gammaptrs, comp, oligospace, blocksize)


def write_offsets_flat(path: str, offsets: np.ndarray) -> None:
    offsets.astype("<u4").tofile(path)


def read_offsets_flat(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u4").astype(np.uint32)


# ----------------------------------------------------------------- file names

def index_filenames(dbdir: str, dbname: str, idx_prefix: str = "ref",
                    snps_suffix: str = "", required_k: int = 0,
                    required_interval: int = 0, required_basesize: int = 0):
    """Discover index files like Indexdb_get_filenames (src/indexdb.c:255-
    440).  Naming (gmapindex.c:1028-1127): offsets are
    ``<db>.<prefix><BB><KK><Q>{gammaptrs,offsetscomp}`` (gammaptrs absent
    when BB == KK, i.e. blocksize 1) and positions are
    ``<db>.<prefix><KK><Q>positions``; BB/KK two digits, Q one char.
    SNP-tolerant indexes append ``.<snps>`` to each filename."""
    sfx = f".{snps_suffix}" if snps_suffix else ""
    pat = re.compile(
        re.escape(dbname) + r"\." + re.escape(idx_prefix)
        + r"(\d\d)(\d\d)(\d)offsetscomp" + re.escape(sfx) + "$"
    )
    best = None
    for fn in os.listdir(dbdir):
        m = pat.match(fn)
        if m:
            bb, kk, q = int(m.group(1)), int(m.group(2)), int(m.group(3))
            if required_k and kk != required_k:
                continue
            if required_interval and q != required_interval:
                continue
            if required_basesize and bb != required_basesize:
                continue
            if best is None or kk > best[1]:
                best = (bb, kk, q)
    if best is None:
        return None
    bb, kk, q = best
    base = os.path.join(dbdir, dbname)
    gammaptrs = f"{base}.{idx_prefix}{bb:02d}{kk:02d}{q}gammaptrs{sfx}"
    return {
        "basesize": bb,
        "k": kk,
        "interval": q,
        "gammaptrs": gammaptrs if os.path.exists(gammaptrs) else None,
        "offsetscomp": f"{base}.{idx_prefix}{bb:02d}{kk:02d}{q}offsetscomp{sfx}",
        "positions": f"{base}.{idx_prefix}{kk:02d}{q}positions{sfx}",
    }


def read_offsets(files: dict) -> np.ndarray:
    """Read offsets from discovered index files (flat or gamma-compressed)."""
    if files["gammaptrs"] is None:
        return read_offsets_flat(files["offsetscomp"])
    return read_offsets_gamma(
        files["gammaptrs"], files["offsetscomp"], files["basesize"], files["k"]
    )
