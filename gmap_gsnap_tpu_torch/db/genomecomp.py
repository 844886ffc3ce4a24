"""2-bit packed genome store ("genomecomp" format), vectorized NumPy.

The reading half of gmap_gsnap_tpu/db/genomecomp.py (the port opens
databases; it writes none).

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

BLOCK = 32  # nucleotides per 3-word block


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


def read(path: str, length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    words = np.fromfile(path, dtype="<u4")
    return unpack(words, length)
