"""Carry the JAX package's state across to the port.

The JAX package's genome and index live in ``GenomeArrays`` /
``IndexArrays`` pytrees (or as host arrays in a ``db.datadir.GenomeDB``).
These functions take their contents as numpy arrays (``np.asarray`` of
the JAX arrays works; no JAX import is needed here) and build the
port's containers on a given device, so both packages compute over the
same genome and index.

uint32 arrays stay 32-bit on the device (``torch.int32`` holding the
same bits): at k=15 the offsets table alone is (4^15+1) x 4 B = 4.3 GB.
"""

from __future__ import annotations

import numpy as np

from .align.gsnap_se import IndexArrays
from .ops import maxent
from .ops.genome import GenomeArrays


def genome_from_arrays(ref16, flag16, length: int, chr_offsets,
                       device) -> GenomeArrays:
    """From a JAX GenomeArrays' fields: packed, row-padded uint32 words
    (``ref16``, ``flag16``), the genome length and ``chr_offsets``."""
    return GenomeArrays.from_words(np.asarray(ref16), np.asarray(flag16),
                                   int(length), np.asarray(chr_offsets),
                                   device)


def genome_from_host(codes: np.ndarray, flags: np.ndarray, chr_ends,
                     device) -> GenomeArrays:
    """From 2-bit codes, N flags and chromosome ends (a GenomeDB's or a
    db.build.load_genome_fasta result's host arrays)."""
    return GenomeArrays.from_codes(np.asarray(codes), np.asarray(flags),
                                   chr_ends, device)


def maxent_tables_from_arrays(tables: dict, device) -> dict:
    """The port's maxent tables (float32 tensors on ``device``) from the
    JAX package's float64 arrays (``maxent._tables_np()``), cast as its
    ``_tables_jnp`` casts them."""
    return maxent.tables_f32({k: np.asarray(v) for k, v in tables.items()},
                             device)


def index_from_arrays(offsets, positions, k: int, interval: int,
                      device) -> IndexArrays:
    """From a k-mer index's offsets (uint32[4^k+1]) and positions
    (uint32[N]).  A JAX IndexArrays' positions are padded to a multiple
    of 8 with zeros; the padding is never addressed and may stay."""
    return IndexArrays.from_host(np.asarray(offsets), np.asarray(positions),
                                 k, interval, device)
