"""Device-resident genome (counterpart of gmap_gsnap_tpu/ops/genome.py).

Same layout as the JAX package: ``ref16`` holds 16 nucleotides per
32-bit word, 2-bit codes LSB-first; ``flag16`` holds 16 N/X flag bits
per word in the low half.  Both are padded exactly like the JAX arrays
(``_pad_rows``): reads past the genome's end see 0xFFFFFFFF / 0xFFFF,
which decode as T plus the N flag.

Words are kept as ``torch.int32`` tensors holding the uint32 bits (half
the memory of int64); kernels read them as ``uint32_t*`` and the plain
torch code widens gathered words with :func:`u32`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device

NT_PER_WORD = 16
ROW_WORDS = 8
MASK32 = 0xFFFFFFFF


def _pad_rows(arr16: np.ndarray, fill: int) -> np.ndarray:
    """Pad a word array to a multiple of ROW_WORDS plus one full guard
    row of ``fill`` (copy of gmap_gsnap_tpu/ops/genome.py:_pad_rows)."""
    pad = (-len(arr16)) % ROW_WORDS + ROW_WORDS
    return np.concatenate([arr16, np.full(pad, fill, np.uint32)])


def pack16(codes: np.ndarray, flags: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing of 2-bit codes/flags into the 16-per-word layout
    (copy of gmap_gsnap_tpu/ops/genome.py:pack16).  Pads the tail with X
    (T + flag) like the disk format."""
    n = len(codes)
    nwords = (n + NT_PER_WORD - 1) // NT_PER_WORD
    pad = nwords * NT_PER_WORD - n
    if pad:
        codes = np.concatenate([codes, np.full(pad, 3, dtype=codes.dtype)])
        flags = np.concatenate([flags, np.ones(pad, dtype=bool)])
    c = codes.astype(np.uint32).reshape(nwords, NT_PER_WORD)
    f = flags.astype(np.uint32).reshape(nwords, NT_PER_WORD)
    shifts = np.arange(NT_PER_WORD, dtype=np.uint32)
    ref16 = np.bitwise_or.reduce(c << (2 * shifts), axis=1)
    flag16 = np.bitwise_or.reduce(f << shifts, axis=1)
    return ref16, flag16


def words_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits on device."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    if not a.flags.writeable:   # e.g. np.asarray of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits -> int64 tensor of the values."""
    return x.long() & MASK32


@dataclass
class GenomeArrays:
    """Genome + chromosome table on one device."""

    ref16: torch.Tensor        # int32[nwords] (uint32 bits), row-padded
    flag16: torch.Tensor       # int32[nwords] (uint32 bits), row-padded
    length: int                # genome length in nt
    chr_offsets: torch.Tensor  # int64[nchrs+1] universal starts (+ total)

    @property
    def device(self) -> torch.device:
        return self.ref16.device

    @classmethod
    def from_words(cls, ref16: np.ndarray, flag16: np.ndarray, length: int,
                   chr_offsets, device) -> "GenomeArrays":
        """From already packed and padded words (e.g. a JAX
        GenomeArrays' arrays)."""
        dev = resolve_device(device)
        return cls(words_to_device(ref16, dev), words_to_device(flag16, dev),
                   int(length),
                   torch.as_tensor(np.asarray(chr_offsets, np.int64),
                                   device=dev))

    @classmethod
    def from_codes(cls, codes: np.ndarray, flags: np.ndarray, chr_ends,
                   device) -> "GenomeArrays":
        ref16, flag16 = pack16(codes, flags)
        chr_offsets = np.concatenate([[0], np.asarray(chr_ends, np.int64)])
        return cls.from_words(_pad_rows(ref16, 0xFFFFFFFF),
                              _pad_rows(flag16, 0xFFFF), len(codes),
                              chr_offsets, device)


def fetch_span_words(ref16: torch.Tensor, flag16: torch.Tensor,
                     start: torch.Tensor, nwords: int):
    """Plain torch fetch_span_words: ``nwords`` words per start position
    (int64[B]) such that word j holds positions start+16j .. +15.
    Returns (codes, flags) int64[B, nwords] (uint32 values; flags in the
    low 16 bits)."""
    w0 = start >> 4
    sh = (start & 15)[:, None]
    idx = w0[:, None] + torch.arange(nwords + 1, device=start.device)
    idx = idx.clamp(max=ref16.shape[0] - 1)
    raw_c = u32(ref16[idx])
    raw_f = u32(flag16[idx])
    # out[j] = raw[j] >> 2sh | raw[j+1] << (32 - 2sh); a 32-bit shift of
    # an int64 leaves only bits above 32, which the mask clears
    c = ((raw_c[:, :-1] >> (2 * sh)) | (raw_c[:, 1:] << (32 - 2 * sh))) & MASK32
    f = ((raw_f[:, :-1] >> sh) | (raw_f[:, 1:] << (16 - sh))) & 0xFFFF
    return c, f


def fetch_codes(ref16: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """2-bit codes at genome positions (int64, any shape, values >= 0)
    -> uint8.  A position past the padded word array reads its last
    word, the guard of fill (0xFFFFFFFF), so it decodes as T (code 3),
    as the JAX package's clamped row gathers read it."""
    w = (positions >> 4).clamp(max=ref16.shape[0] - 1)
    return ((u32(ref16[w]) >> (2 * (positions & 15))) & 3).to(torch.uint8)


def fetch_span_codes(ref16: torch.Tensor, start: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Codes of genome[start : start + n] for start positions (int64[...]
    holding uint32 values) -> uint8[..., n]: direct indexing in place of
    the JAX package's 8-word row gathers, with their results past the
    genome end (T).  A start that wrapped below 0 in uint32 lies far past
    the end and reads T throughout, as in JAX."""
    pos = (start & MASK32)[..., None] + torch.arange(n, device=start.device)
    return fetch_codes(ref16, pos)


def fetch_span_bits(bits32: torch.Tensor, start: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Bits of a genome-length bitvector (int32 words holding uint32
    bits) over [start, start + n) for start positions (int64[...]
    holding uint32 values) -> bool[..., n]; plain torch
    gmap_gsnap_tpu/ops/genome.py:fetch_span_bits.  As there, the word
    index is clipped to the last word (INVALID diagonals and starts at
    the genome end read it) and a word shifted by 32 contributes 0
    (JAX's _shl32)."""
    nwords = (n + 31) // 32
    start = start & MASK32
    w0 = start >> 5
    sh = (start & 31)[..., None]
    idx = w0[..., None] + torch.arange(nwords + 1, device=start.device)
    idx = idx.clamp(0, bits32.shape[0] - 1)
    raw = u32(bits32[idx])
    # raw[j + 1] << 32 of an int64 leaves only bits above 32: the mask
    # clears them, which is _shl32's 0
    al = ((raw[..., :-1] >> sh) | (raw[..., 1:] << (32 - sh))) & MASK32
    b = ((al[..., None] >> torch.arange(32, device=start.device)) & 1).bool()
    return b.reshape(al.shape[:-1] + (nwords * 32,))[..., :n]
