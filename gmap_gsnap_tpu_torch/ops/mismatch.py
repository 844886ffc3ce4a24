"""Bit-parallel mismatch counting (counterpart of gmap_gsnap_tpu/ops/mismatch.py).

Holds kernel K3, :func:`prefix_mismatches`: for each candidate diagonal
of each read, the mismatch matrix bool[B, NC, L] and its prefix sums
int32[B, NC, L+1] (gsnap_gapped._prefix_mm in the JAX package, built
there from fetch_span_words + mismatch_words + mismatch_matrix).  The
CUDA kernel is ``csrc/prefix_mismatches.cu``; the plain torch version
beside it is built from the functions below, which follow the JAX
package line by line on int64 tensors holding uint32 values.

N rules (gsnap.c:142-143 defaults): a genome N always mismatches, a
query N never does; positions outside [pos5, pos3) never count.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import limits as klimits
from . import genome as genome_ops
from .genome import MASK32

NT_PER_WORD = 16
INVALID_DIAG = 0xFFFFFFFF
LANE_LO = 0x55555555

# gsnap --query-unk-mismatch / --genome-unk-mismatch (gsnap.c:142-143).
# The CLI sets these once at startup, before any alignment.
QUERY_UNK_MISMATCH = False
GENOME_UNK_MISMATCH = True

_CONVERSIONS = (None, "ct", "ga", "ag", "tc")


@dataclass
class PackedQueries:
    """A batch of reads packed 16 nt/word (plus N flags), fixed width.

    codes16: int64[B, W] 2-bit codes LSB-first (uint32 values);
             positions >= length hold code 0 and are flagged as N.
    nflags16: int64[B, W] query-N flag bits (low 16 bits per word).
    length: int32[B] read lengths.
    lmax: max read length (W = ceil(lmax/16)).
    """

    codes16: torch.Tensor
    nflags16: torch.Tensor
    length: torch.Tensor
    lmax: int


def pack_queries(codes: np.ndarray, nflags: np.ndarray, lengths: np.ndarray,
                 device) -> PackedQueries:
    """Host-side packing (as gmap_gsnap_tpu/ops/mismatch.py:pack_queries)."""
    b, lmax = codes.shape
    w = (lmax + NT_PER_WORD - 1) // NT_PER_WORD
    pad = w * NT_PER_WORD - lmax
    idx = np.arange(lmax)
    nflags = nflags | (idx[None, :] >= lengths[:, None])
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
        nflags = np.pad(nflags, ((0, 0), (0, pad)), constant_values=True)
    c = codes.astype(np.int64).reshape(b, w, NT_PER_WORD)
    f = nflags.astype(np.int64).reshape(b, w, NT_PER_WORD)
    shifts = np.arange(NT_PER_WORD, dtype=np.int64)
    codes16 = np.bitwise_or.reduce(c << (2 * shifts), axis=2)
    nflags16 = np.bitwise_or.reduce(f << shifts, axis=2)
    return PackedQueries(
        codes16=torch.as_tensor(codes16, device=device),
        nflags16=torch.as_tensor(nflags16, device=device),
        length=torch.as_tensor(lengths.astype(np.int32), device=device),
        lmax=int(lmax))


def convert_words(codes16: torch.Tensor, conversion: str | None) -> torch.Tensor:
    """cmet/atoi nucleotide conversion on 2-bit packed words.  Each
    lane: lo bit at 2i, hi bit at 2i+1.  A=00 C=01 G=10 T=11."""
    if conversion is None:
        return codes16
    lo = codes16 & LANE_LO
    hi = (codes16 >> 1) & LANE_LO
    if conversion == "ct":      # C -> T: set hi where lane == 01
        return codes16 | ((lo & ~hi) << 1)
    if conversion == "ga":      # G -> A: clear hi where lane == 10
        return codes16 & ~((hi & ~lo) << 1)
    if conversion == "ag":      # A -> G: set hi where lane == 00
        return codes16 | ((~hi & ~lo & LANE_LO) << 1)
    if conversion == "tc":      # T -> C: clear hi where lane == 11
        return codes16 & ~((hi & lo) << 1)
    raise ValueError(conversion)


def _expand2(mask16: torch.Tensor) -> torch.Tensor:
    """Spread a 16-bit-per-word mask to 2-bit lanes: bit i -> 2i, 2i+1."""
    x = mask16
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x | (x << 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding uint32 values (torch has
    no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def mismatch_words(genome, queries: PackedQueries, left: torch.Tensor,
                   conversion: str | None = None, alt=None) -> torch.Tensor:
    """int64[B, W]: bit 2i of word j set iff query position 16j+i is a
    mismatch under the N rules at genome placement ``left`` (int64[B]).
    alt: optional (alt_ref16, alt_flag16) SNP genome — a position
    matching either genome is not a mismatch."""
    nwords = queries.codes16.shape[1]
    qcodes = convert_words(queries.codes16, conversion)
    qn = _expand2(queries.nflags16) & LANE_LO

    def one(ref16, flag16):
        gcodes, gflags = genome_ops.fetch_span_words(ref16, flag16, left, nwords)
        gcodes = convert_words(gcodes, conversion)
        diff = gcodes ^ qcodes
        neq = (diff | (diff >> 1)) & LANE_LO
        gn = _expand2(gflags) & LANE_LO
        m = (neq | gn) if GENOME_UNK_MISMATCH else (neq & ~gn)
        return (m | qn) if QUERY_UNK_MISMATCH else (m & ~qn)

    mm = one(genome.ref16, genome.flag16)
    if alt is not None:
        mm = mm & one(alt[0], alt[1])
    return mm


def _range_mask_words(pos5, pos3, nwords: int) -> torch.Tensor:
    """int64[B, W] with even-bit lanes set for query positions in
    [pos5, pos3)."""
    dev = pos5.device
    lane = torch.arange(NT_PER_WORD, device=dev)
    pos = (torch.arange(nwords, device=dev)[:, None] * NT_PER_WORD
           + lane)[None]                                    # [1, W, 16]
    inrange = (pos >= pos5[:, None, None]) & (pos < pos3[:, None, None])
    return (inrange.long() << (2 * lane)).sum(2)


def count_mismatches(genome, queries, left, pos5, pos3, conversion=None,
                     alt=None) -> torch.Tensor:
    """Genome_count_mismatches_substring: mismatches of query[pos5:pos3]
    placed at genome position left+pos5 -> int32[B]."""
    mm = mismatch_words(genome, queries, left, conversion, alt)
    mask = _range_mask_words(pos5, pos3, mm.shape[1])
    return popcount32(mm & mask).sum(1).int()


def mismatch_matrix(genome, queries, left, conversion=None, alt=None):
    """Unpacked bool[B, Lmax] mismatch matrix."""
    mm = mismatch_words(genome, queries, left, conversion, alt)
    b, w = mm.shape
    lane = torch.arange(NT_PER_WORD, device=mm.device)
    bits = (mm[:, :, None] >> (2 * lane)) & 1
    return bits.reshape(b, w * NT_PER_WORD)[:, : queries.lmax].bool()


def _placements(genome, diags, lengths):
    """(ok, lefts): which diagonals are placeable, and their starts."""
    ok = (diags != INVALID_DIAG) & (
        diags + lengths.long()[:, None] <= genome.length)
    return ok, torch.where(ok, diags, 0)


def _prefix_mismatches_plain(genome, queries, diags, lengths, conversion, alt):
    b, nc = diags.shape
    lmax = queries.lmax
    ok, lefts = _placements(genome, diags, lengths)
    rep = lambda x: x.repeat_interleave(nc, dim=0)
    q = PackedQueries(rep(queries.codes16), rep(queries.nflags16),
                      rep(queries.length), lmax)
    mm = mismatch_matrix(genome, q, lefts.reshape(-1), conversion,
                         alt).reshape(b, nc, lmax)
    idx = torch.arange(lmax, device=diags.device)
    inlen = idx[None, None, :] < lengths[:, None, None]
    mm = (mm & inlen) | (~ok[:, :, None] & inlen)
    pref = torch.cat([torch.zeros((b, nc, 1), dtype=torch.int32,
                                  device=diags.device),
                      torch.cumsum(mm, dim=2, dtype=torch.int32)], dim=2)
    return mm, pref


# the longest read every CUDA path takes: the shared memory of the kernels
# that grow with the read (K1, K3, K4, K5, K7, K13), computed from their
# formulas (kernels/limits.py; K3's tile sets it, at 14,432 bases)
CUDA_MAX_READ_LENGTH = klimits.MAX_READ_LENGTH


def _prefix_mismatches_cuda(genome, queries, diags, lengths, conversion, alt):
    b, nc = diags.shape
    lmax = queries.lmax
    nw = queries.codes16.shape[1]
    dev = diags.device
    mm = torch.empty((b, nc, lmax), dtype=torch.bool, device=dev)
    pref = torch.empty((b, nc, lmax + 1), dtype=torch.int32, device=dev)
    # the kernel reads the query words as int64 and writes its tiles with
    # 16-byte stores
    if queries.codes16.dtype != torch.int64 or (
            queries.nflags16.dtype != torch.int64):
        raise ValueError("prefix_mismatches: query words must be int64")
    if mm.data_ptr() % 16 or pref.data_ptr() % 16:
        raise ValueError("prefix_mismatches: outputs not 16-byte aligned")
    kbuild.launch(
        "gsnap_prefix_mismatches", dev,
        genome.ref16, genome.flag16,
        None if alt is None else alt[0], None if alt is None else alt[1],
        queries.codes16.contiguous(), queries.nflags16.contiguous(),
        diags.contiguous(), lengths.int().contiguous(), mm, pref,
        genome.ref16.shape[0], genome.length,
        b, nc, lmax, nw, _CONVERSIONS.index(conversion),
        int(QUERY_UNK_MISMATCH), int(GENOME_UNK_MISMATCH))
    return mm, pref


def prefix_mismatches(genome, queries: PackedQueries, diags: torch.Tensor,
                      lengths: torch.Tensor, conversion: str | None = None,
                      alt=None):
    """Mismatch matrices + prefix sums for candidate diagonals (kernel K3).

    diags int64[B, NC] (uint32 values, INVALID_DIAG = none) ->
    (mm bool[B, NC, L], pref int32[B, NC, L+1]) where pref[..., s] =
    mismatches of query[0:s].  Positions past a read's length never
    mismatch; an unplaceable diagonal (invalid, or running past the
    genome end) mismatches everywhere inside the read.

    CPU tensors take the plain torch version; CUDA tensors launch
    ``csrc/prefix_mismatches.cu`` (which raises if it cannot)."""
    if diags.device.type == "cpu":
        return _prefix_mismatches_plain(genome, queries, diags, lengths,
                                        conversion, alt)
    if diags.device.type == "cuda":
        return _prefix_mismatches_cuda(genome, queries, diags, lengths,
                                       conversion, alt)
    raise ValueError(f"unsupported device {diags.device}")
