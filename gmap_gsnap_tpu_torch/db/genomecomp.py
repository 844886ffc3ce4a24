"""2-bit packed genome store ("genomecomp" format), vectorized NumPy.

A copy of gmap_gsnap_tpu/db/genomecomp.py without ``read_words``; the
port writes genomecomp files only for SNP-tolerant databases
(db/transforms.write_snp_index).

Byte-compatible with the reference on-disk format (reference
src/compress.c:118-220, src/genome-write.c): the genome is stored as
interleaved little-endian uint32 triplets per 32-nt block, written in the
order ``high``, ``low``, ``flags``:

  * ``low``  holds nucleotides 0..15 of the block, 2 bits each, LSB-first
    (``low & 3`` is the first nt of the block),
  * ``high`` holds nucleotides 16..31 likewise,
  * bit *i* of ``flags`` set means nucleotide *i* is N (stored as A) or
    X (stored as T).

A trailing partial block is padded with X (T code + flag), matching
Compress_compress (src/compress.c:196-216).

Parity target: tests/setup.genomecomp.ok of the reference test suite.
"""

from __future__ import annotations

import numpy as np

from ..utils import dna

BLOCK = 32  # nucleotides per 3-word block


def pack(codes: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes + flags into the interleaved [high, low, flags]
    uint32 array (ravelled, length 3 * nblocks)."""
    n = len(codes)
    nblocks = (n + BLOCK - 1) // BLOCK
    pad = nblocks * BLOCK - n
    if pad:
        codes = np.concatenate([codes, np.full(pad, dna.T, dtype=codes.dtype)])
        flags = np.concatenate([flags, np.ones(pad, dtype=bool)])
    c = codes.astype(np.uint32).reshape(nblocks, BLOCK)
    f = flags.astype(np.uint32).reshape(nblocks, BLOCK)
    shifts2 = np.arange(16, dtype=np.uint32) * 2
    low = (c[:, :16] << shifts2).astype(np.uint32)
    high = (c[:, 16:] << shifts2).astype(np.uint32)
    low = np.bitwise_or.reduce(low, axis=1)
    high = np.bitwise_or.reduce(high, axis=1)
    fl = np.bitwise_or.reduce(f << np.arange(BLOCK, dtype=np.uint32), axis=1)
    out = np.empty((nblocks, 3), dtype=np.uint32)
    out[:, 0] = high
    out[:, 1] = low
    out[:, 2] = fl
    return out.reshape(-1)


def unpack(words: np.ndarray, length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the interleaved [high, low, flags] words into (codes uint8,
    flags bool) truncated to ``length`` nucleotides (default: all,
    including X padding)."""
    w = words.reshape(-1, 3)
    nblocks = w.shape[0]
    shifts2 = np.arange(16, dtype=np.uint32) * 2
    low = (w[:, 1:2] >> shifts2) & 3
    high = (w[:, 0:1] >> shifts2) & 3
    codes = np.concatenate([low, high], axis=1).astype(np.uint8).reshape(-1)
    flags = ((w[:, 2:3] >> np.arange(BLOCK, dtype=np.uint32)) & 1).astype(bool).reshape(-1)
    if length is None:
        length = nblocks * BLOCK
    return codes[:length], flags[:length]


def write(path: str, codes: np.ndarray, flags: np.ndarray) -> None:
    pack(codes, flags).astype("<u4").tofile(path)


def read(path: str, length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    words = np.fromfile(path, dtype="<u4")
    return unpack(words, length)
