"""DNA nucleotide coding helpers (host-side, NumPy).

A copy of gmap_gsnap_tpu/utils/dna.py.

Coding convention (identical to the reference genome-vendor/gmap-gsnap,
src/compress.c:138-144):

    A = 00   C = 01   G = 10   T = 11
    N stored as A (00) with flag bit set
    X stored as T (11) with flag bit set
    any other letter -> N (00 + flag)

Case-insensitive; 'U' is treated as 'T' (reference UPPERCASE_U2T table,
src/complement.h).
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# code table: byte -> 2-bit code; flag table: byte -> is-N/X flag
CODE_TABLE = np.zeros(256, dtype=np.uint8)
FLAG_TABLE = np.ones(256, dtype=bool)  # default: non-ACGT -> flagged (N)
for _b, _code in ((b"Aa", A), (b"Cc", C), (b"Gg", G), (b"TtUu", T)):
    for _ch in _b:
        CODE_TABLE[_ch] = _code
        FLAG_TABLE[_ch] = False
for _ch in b"Xx":
    CODE_TABLE[_ch] = T  # X stored as T + flag
    FLAG_TABLE[_ch] = True
# N keeps code 0 + flag (defaults)


def encode(seq: bytes | str) -> tuple[np.ndarray, np.ndarray]:
    """Encode an ASCII nucleotide string into (codes uint8, flags bool)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return CODE_TABLE[raw], FLAG_TABLE[raw]


def revcomp_str(seq: str) -> str:
    comp = str.maketrans("ACGTNacgtn", "TGCANtgcan")
    return seq.translate(comp)[::-1]


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Pack every k-mer start into an MSB-first 2k-bit integer.

    Matches the reference oligo convention (indexdb.c:2160-2175:
    ``oligo = (oligo << 2) | code``): the k-mer's FIRST nucleotide occupies
    the most-significant 2 bits.  Returns an int64 array of length
    ``len(codes) - k + 1`` (empty if the sequence is shorter than k).
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    c = codes.astype(np.int64)
    for i in range(k):
        out |= c[i : i + n] << (2 * (k - 1 - i))
    return out
