"""Shared-memory sizes of the kernels that grow with the read length, as
their C entry points compute them (``csrc/*.cu``), and the longest read
that the card's GSNAP path takes.

Each ``*_bytes(L)`` is the shared memory of the kernel's smallest launch
for reads of L bases: one CTA of one warp where the entry point fits
fewer warps to a CTA (K1, K5, K7, K13), one read a CTA (K4), one tile
(K3), static shared memory included.  A launch that needs more than
:data:`SMEM_MAX` is refused (``cudaErrorInvalidValue``), so
:data:`MAX_READ_LENGTH` is the longest read every one of them takes; the
CLI and ``GsnapRunner`` refuse longer reads on the card before the index
loads.  Reads longer than that align on the CPU (``--device cpu``).
"""

from __future__ import annotations

SMEM_MAX = 232448     # a CTA's opt-in shared memory on the H100 (kSmemMax)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def seed_diagonals_bytes(S: int) -> int:
    """K1, one warp (one read): each of its S k-mers' start and usable
    count, its codes packed 16 to a word and its N flags 32 to a word
    (sized for the longest read of S k-mers, k = 16, with a word of
    padding each), and a window of 128 slots' owners and starts
    (``seed_diagonals.cu`` warp_words)."""
    code_words = (S + 15 + 15) // 16 + 1
    nflag_words = (S + 15 + 31) // 32 + 1
    return 4 * ((2 * S + code_words + nflag_words + 2 * 128 + 3) // 4 * 4)


def prefix_mismatches_bytes(L: int) -> int:
    """K3: a tile of 64 rows' words and counts over ceil(L / 16) query
    words, and the tile's static rows (``prefix_mismatches.cu``)."""
    nw = _cdiv(L, 16)
    return 2 * 64 * ((nw + 1) // 2 + 1) * 4 + 64 * (8 + 4 + 4)


def solve_indels_bytes(L: int, ncand: int = 128, indel_pairs: int = 16) -> int:
    """K4, one read a CTA: each row's slot and each slot's row, the rows
    its pairs name (at most 2 pairs) staged as bits with their counts
    (``solve_indels.cu`` cta_words)."""
    rows = min(ncand, 2 * indel_pairs)
    return 4 * (ncand + rows + 1 + 2 * indel_pairs
                + rows * (3 * _cdiv(L, 32) + 4))


def solve_splices_bytes(L: int) -> int:
    """K5, one warp: two genome spans, the range mask and per class the
    candidate and two known masks (``solve_splices.cu`` warp_words)."""
    mw = (L + 32) // 32
    return 4 * (2 * (2 * mw + 4) + 7 * mw)


def solve_doublesplices_bytes(L: int) -> int:
    """K7, one warp: three genome spans, the known and the site masks
    (``solve_doublesplices.cu`` warp_words)."""
    mw = (L + 32) // 32
    return 4 * (3 * (2 * mw + 4) + 16 * mw)


def lane_features_bytes(L: int) -> int:
    """K13, one warp: the sampled starts, the staging area (the whole row,
    or 1024 bytes of it past 1024 bases) and the 32 rows' words and counts
    (``lane_features.cu``)."""
    nw = _cdiv(L, 32)
    samp = (nw + 1 + 3) // 4 * 4
    stage = (32 * min(L, 1024) + 15) // 16 * 16 + 48
    return 4 * samp + stage + 4 * 2 * 32 * (nw + 1)


def bridge_traceback_bytes(M: int, W: int, NL: int, NR: int, T: int) -> int:
    """K12, one junction a CTA: both sides' nogap, gap1, gap2 and ndiag
    ([M + 1, W] each), the known-site rewards and the score and type
    tables, each as the 16-byte chunks that cover it; both walks' T steps;
    the decision table of both sides and the dinucleotide codes; and a
    bound on the static shared memory (``bridge_traceback.cu``
    bridge_smem_bytes + kStaticSmem).  The GMAP path's M = 64, W = 23,
    NL = NR = 72, T = 138 take 46,340 bytes."""
    mat = (M + 1) * W

    def chunks(n):      # chunk_words
        return (n + 15) // 16 * 4 + 4

    return (4 * (6 * chunks(4 * mat) + 2 * chunks(mat) + chunks(4 * (NL + 1))
                 + chunks(4 * (NR + 1)) + chunks(4 * 128) + 4 * T)
            + (2 * mat + (NL + 1) + (NR + 1) + 2 * T) + 512)


def seed_segments_register_hits() -> int:
    """K9: the hits a row sorts in registers, a CTA of 256 threads
    holding 8 keys each (``gmap_seed_segments.cu`` kRegHits); a row with
    more, which only H above it admits, works in a global scratch row
    (``gmap_engine.seed_workspace_bytes``)."""
    return 256 * 8


def seed_segments_bytes(Q: int, H: int, S: int) -> int:
    """K9, one query row a CTA: min(H, seed_segments_register_hits())
    hit keys, min(pow2(min(S, H)), that) segment keys and ends, and a
    chunk of up to 1,024 k-mers' starts and first slots
    (``gmap_seed_segments.cu`` smem_layout); no larger for any H."""
    nk = min(H, seed_segments_register_hits())
    ns = min(1 << max(min(S, H) - 1, 0).bit_length(), nk)
    cq = min(Q, 1024)
    return (8 * nk + 12 * ns + 8 * cq + 7) // 8 * 8


KERNEL_BYTES = {
    "K1 seed_diagonals": seed_diagonals_bytes,
    "K3 prefix_mismatches": prefix_mismatches_bytes,
    "K4 solve_indels": solve_indels_bytes,
    "K5 solve_splices": solve_splices_bytes,
    "K7 solve_doublesplices": solve_doublesplices_bytes,
    "K13 lane_features": lane_features_bytes,
}


def longest_fitting(fn, hi: int = 1 << 20) -> int:
    """The longest L in [1, hi) with fn(L) <= SMEM_MAX (every fn here
    grows with L)."""
    lo = 1
    while lo < hi - 1:
        mid = (lo + hi) // 2
        if fn(mid) <= SMEM_MAX:
            lo = mid
        else:
            hi = mid
    return lo


# the longest read (K1: the most k-mers) each kernel takes, and the
# longest that every one of them takes; computed once, at import
LONGEST = {kernel: longest_fitting(fn) for kernel, fn in KERNEL_BYTES.items()}
SEED_MAX_S = LONGEST["K1 seed_diagonals"]
LANE_FEATURES_MAX_L = LONGEST["K13 lane_features"]
MAX_READ_LENGTH = min(LONGEST.values())
