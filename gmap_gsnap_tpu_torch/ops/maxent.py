"""MaxEnt splice-site probability models (counterpart of
gmap_gsnap_tpu/ops/maxent.py).

The host half (``_MODELS``, ``_tables_np``, ``_prob_from_window``,
``splice_prob_np``, ``prob_from_str`` and the donor/acceptor helpers) is
copied from the JAX package: float64 numpy over the tables in the
port's copy of its data file, ``gmap_gsnap_tpu_torch/data/
maxent_hr_tables.npz`` (read with numpy).

The device half is plain torch.  Tables are float32, cast from the
float64 npz as the JAX package's ``_tables_jnp`` casts them, and the
probability is the float32 product of the table factors taken left to
right in ``_MODELS`` order, then ``odds / (1 + odds)`` — the order of
operations that makes the results bit-equal to the JAX package's.  The
splice kernels (K5, K7 in ``align/gsnap_gapped.py``) compute the same
product on the card (``csrc/maxent.cuh``).

Window decompositions (nt offsets into the model window, each a 2-bit
code, LSB-first packing):

  donor  (window at pos-3, 9 nt;  GT at offsets 3,4):
      score7 = nt[0,1,2,5,6,7,8]          discore = nt[3,4]
  acceptor (window at pos-20, 23 nt; AG at offsets 18,19):
      score1 = nt[0..6]   score2 = nt[7..13]  score467 = nt[4..10]
      score589 = nt[11..17]
      score3 = nt[14,15,16,17,20,21,22]   discore = nt[18,19]
  antidonor (window at pos-6, 9 nt; minus-strand donor read forward):
      score7 = nt[0,1,2,3,6,7,8]          discore = nt[4,5]
  antiacceptor (window at pos-3, 23 nt):
      score1 = nt[16..22]  score2 = nt[9..15]  score467 = nt[12..18]
      score589 = nt[5..11]
      score3 = nt[0,1,2,5,6,7,8]          discore = nt[3,4]
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import genome as genome_ops

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "maxent_hr_tables.npz")

# (table_name, nt offsets) per model; offsets are LSB-first digit order
_MODELS = {
    "donor": [
        ("donor_score_plus", (0, 1, 2, 5, 6, 7, 8)),
        ("donor_discore_plus", (3, 4)),
    ],
    "acceptor": [
        ("acc_score1_plus", tuple(range(0, 7))),
        ("acc_score2_plus", tuple(range(7, 14))),
        ("acc_score3_plus", (14, 15, 16, 17, 20, 21, 22)),
        ("acc_discore_plus", (18, 19)),
        ("acc_score467_plus", tuple(range(4, 11))),
        ("acc_score589_plus", tuple(range(11, 18))),
    ],
    "antidonor": [
        ("donor_score_minus", (0, 1, 2, 3, 6, 7, 8)),
        ("donor_discore_minus", (4, 5)),
    ],
    "antiacceptor": [
        ("acc_score1_minus", tuple(range(16, 23))),
        ("acc_score2_minus", tuple(range(9, 16))),
        ("acc_score3_minus", (0, 1, 2, 5, 6, 7, 8)),
        ("acc_discore_minus", (3, 4)),
        ("acc_score467_minus", tuple(range(12, 19))),
        ("acc_score589_minus", tuple(range(5, 12))),
    ],
}

_MARGIN = {"donor": 3, "acceptor": 20, "antidonor": 6, "antiacceptor": 3}
_WIDTH = {"donor": 9, "acceptor": 23, "antidonor": 9, "antiacceptor": 23}

# the four kinds in the order the CUDA kernels number them (maxent.cuh)
KINDS = ("donor", "acceptor", "antidonor", "antiacceptor")


@lru_cache(maxsize=1)
def _tables_np() -> dict[str, np.ndarray]:
    return {k: v for k, v in np.load(_DATA).items()}


def tables_f32(tables_np: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """float32 tensors of the float64 tables on ``device`` (the cast of
    the JAX package's ``_tables_jnp``: round to nearest)."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(device)
            for k, v in tables_np.items()}


@lru_cache(maxsize=None)
def device_tables(device) -> dict[str, torch.Tensor]:
    """The 16 tables as float32 tensors on ``device``, cached per device."""
    return tables_f32(_tables_np(), device)


@lru_cache(maxsize=None)
def flat_tables(device) -> torch.Tensor:
    """All 16 tables concatenated in ``KINDS`` x ``_MODELS`` order, as one
    float32 tensor — the layout csrc/maxent.cuh reads (12 tables of 16384
    entries and 4 of 16)."""
    t = device_tables(device)
    return torch.cat([t[name] for kind in KINDS
                      for name, _ in _MODELS[kind]]).contiguous()


def _index(window, offsets):
    """Pack window[..., offsets] 2-bit codes LSB-first into an index."""
    if isinstance(window, np.ndarray):
        idx = window[..., offsets[0]].astype(np.int64)
    else:
        idx = window[..., offsets[0]].long()
    for j, o in enumerate(offsets[1:], start=1):
        w = window[..., o]
        idx = idx + ((w.astype(idx.dtype) if isinstance(w, np.ndarray)
                      else w.long()) << (2 * j))
    return idx


def _prob_from_window(window, kind: str, tables):
    odds = None
    for name, offsets in _MODELS[kind]:
        factor = tables[name][_index(window, offsets)]
        odds = factor if odds is None else odds * factor
    return odds / (1.0 + odds)


# --------------------------------------------------------------- device path

def splice_prob(genome: genome_ops.GenomeArrays, positions: torch.Tensor,
                kind: str) -> torch.Tensor:
    """Splice probability at genome positions (int64[B] holding uint32
    values) on the plus-strand genome.  float32[B]; positions closer than
    the window margin to coordinate 0 return 0."""
    margin = _MARGIN[kind]
    width = _WIDTH[kind]
    positions = positions.long() & genome_ops.MASK32
    ok = positions >= margin
    start = torch.where(ok, positions - margin, 0)
    offs = torch.arange(width, device=positions.device)[None, :]
    window = genome_ops.fetch_codes(genome.ref16, start[:, None] + offs)
    p = _prob_from_window(window, kind, device_tables(positions.device))
    return torch.where(ok, p, 0.0)


def splice_prob_span(span: torch.Tensor, kind: str, npos: int,
                     origin: int = 20) -> torch.Tensor:
    """Splice probabilities for a run of candidate positions from a
    fetched local code span: position s (0..npos-1) is genome coordinate
    span[..., origin + s].  Needs origin >= 20 and W >= origin + npos +
    19.  float32[..., npos]."""
    tables = device_tables(span.device)
    odds = None
    for name, idx in splice_idx_span(span, kind, npos, origin):
        factor = tables[name][idx]
        odds = factor if odds is None else odds * factor
    return odds / (1.0 + odds)


def splice_idx_span(span: torch.Tensor, kind: str, npos: int,
                    origin: int = 20):
    """Per-position table indices of a splice scan: a list of
    (table_name, idx int64[..., npos]) in ``_MODELS`` order."""
    margin = _MARGIN[kind]
    out = []
    for name, offsets in _MODELS[kind]:
        idx = None
        for j, off in enumerate(offsets):
            base = origin - margin + off
            piece = span[..., base : base + npos].long() << (2 * j)
            idx = piece if idx is None else idx + piece
        out.append((name, idx))
    return out


def splice_prob_window(window: torch.Tensor, kind: str) -> torch.Tensor:
    """Splice probability from model windows: window[..., 0] is the base
    at coordinate - margin, W = _WIDTH[kind].  float32[...]."""
    return _prob_from_window(window, kind, device_tables(window.device))


def window_margin_width(kind: str) -> tuple[int, int]:
    return _MARGIN[kind], _WIDTH[kind]


# ----------------------------------------------------------------- host path

_CODE_OF = np.full(256, 0, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE_OF[_c] = _i


def prob_from_str(window: str, kind: str) -> float:
    """String-form maxent probability (Maxent_donor/acceptor_prob,
    maxent.h:12-32): ``window`` is the model window itself (donor:
    3 exonic + GT + 4 intronic = 9 nt; acceptor: 20 intronic incl AG +
    3 exonic = 23 nt)."""
    w = np.frombuffer(window.upper().encode("latin-1"), np.uint8)
    if len(w) != _WIDTH[kind]:
        raise ValueError(f"{kind} window must be {_WIDTH[kind]} nt")
    codes = _CODE_OF[w][None, :]
    return float(_prob_from_window(codes, kind, _tables_np())[0])


def donor_prob(window: str) -> float:
    return prob_from_str(window, "donor")


def acceptor_prob(window: str) -> float:
    return prob_from_str(window, "acceptor")


def donor_prob_revcomp(window: str) -> float:
    """Maxent_donor_prob_revcomp: the window read on the other strand."""
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return donor_prob(window.translate(comp)[::-1])


def acceptor_prob_revcomp(window: str) -> float:
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return acceptor_prob(window.translate(comp)[::-1])


def splice_prob_np(codes: np.ndarray, positions: np.ndarray, kind: str) -> np.ndarray:
    """Host float64 implementation over an unpacked 2-bit code array
    (exact double-precision parity with the reference)."""
    margin = _MARGIN[kind]
    width = _WIDTH[kind]
    positions = np.asarray(positions, dtype=np.int64)
    ok = (positions >= margin) & (positions - margin + width <= len(codes))
    start = np.where(ok, positions - margin, 0)
    window = codes[start[:, None] + np.arange(width)[None, :]]
    p = _prob_from_window(window, kind, _tables_np())
    return np.where(ok, p, 0.0)
