"""Multi-device scale-out for the alignment pipelines (counterpart of
gmap_gsnap_tpu/parallel/shard.py).

Two forms, as in the JAX module:

* data parallel over reads: one process per rank under
  ``torch.distributed``; every rank holds the whole database on its own
  device, aligns its contiguous block of each batch (:func:`block_bounds`)
  and rank 0 writes the blocks' output in rank order, which is input
  order (``align/runner.py``);
* a sharded positions index (:class:`ShardedIndexArrays`): the offsets
  are replicated and the positions array is cut into shards; a shard
  resolves the seed slots whose global element it owns and the per-slot
  diagonals combine by MIN (INVALID_DIAG = 0xFFFFFFFF is the identity and
  exactly one shard owns each element).  In one process the index may
  hold every shard; in a group of n ranks each rank holds its own and an
  all-reduce MIN combines them.

The JAX package's mesh becomes PyTorch's process model: ``torchrun``
sets RANK / WORLD_SIZE / LOCAL_RANK and :func:`init_from_env` joins the
group.  nccl serves ranks that each own a card, gloo ranks that share a
card or run on the CPU (NCCL refuses two ranks on one device); the choice
is made from the topology and printed, never by trying one and falling
back to the other.  A world of one rank, or no process group, runs the
single-process code unchanged.
"""

from __future__ import annotations

import datetime
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..align import gsnap_se
from ..kernels import build as kbuild
from ..ops import genome as genome_ops
from ..ops.mismatch import INVALID_DIAG
from ..utils.device import resolve_device

# every collective fails after this long instead of hanging
TIMEOUT_S = 600


def world(group=None) -> tuple:
    """(rank, size, group) of ``group`` (the default group when None);
    (0, 1, None) where no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, None
    return dist.get_rank(group), dist.get_world_size(group), group


def init_from_env(device: str, backend: str | None = None,
                  share_card: bool = False) -> torch.device:
    """Join the process group that ``torchrun`` describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT)
    and return this rank's device.

    ``device`` "cpu" gives gloo; "cuda" gives rank ``cuda:LOCAL_RANK``
    and nccl.  Where the host has fewer cards than local ranks, ranks
    share the cards (``cuda:LOCAL_RANK % count``) only with
    ``share_card``, and then take gloo, whose collectives run on host
    copies (:func:`all_reduce_min`).  ``backend`` overrides the choice.
    The choice is printed on stderr."""
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    dev = resolve_device(device)
    shared = False
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        shared = count < local_size
        if shared and not share_card:
            raise RuntimeError(f"{local_size} ranks on this host and "
                               f"{count} CUDA devices: ranks would share a "
                               f"card (allowed only with share_card)")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank == 0:
        print(f"gsnap: {size} ranks, backend {backend}, rank 0 on {dev}"
              + (" (ranks share cards)" if shared else ""), file=sys.stderr)
    return dev


def all_reduce_min(t: torch.Tensor, group=None) -> torch.Tensor:
    """Element-wise MIN of ``t`` over the ranks of ``group``, in place;
    ``t`` unchanged in a world of one rank."""
    _, size, group = world(group)
    if size == 1:
        return t
    if t.is_cuda and dist.get_backend(group) == "gloo":
        # gloo's all-reduce is run on a host copy: its CUDA path is not
        # relied on for int64 MIN.  The kernels still ran on the card
        h = t.cpu()
        dist.all_reduce(h, op=dist.ReduceOp.MIN, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def gather_to_first(obj, group=None) -> list | None:
    """Every rank's ``obj`` on the group's rank 0, in rank order (None on
    the other ranks; ``[obj]`` in a world of one rank)."""
    rank, size, group = world(group)
    if size == 1:
        return [obj]
    out = [None] * size if rank == 0 else None
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    dist.gather_object(obj, out, dst=dst, group=group)
    return out


def pad_batch(n_devices: int, codes, nflags, lengths):
    """Pad a read batch to a multiple of ``n_devices`` with empty reads
    (length 0, all-N): they produce no hits (numpy; JAX's :61)."""
    b = codes.shape[0]
    pad = (-b) % n_devices
    if pad == 0:
        return codes, nflags, lengths, b
    codes = np.concatenate([codes, np.zeros((pad,) + codes.shape[1:],
                                            codes.dtype)])
    nflags = np.concatenate([nflags, np.ones((pad,) + nflags.shape[1:],
                                             nflags.dtype)])
    lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    return codes, nflags, lengths, b


def part_indices(i: int, n: int, total: int) -> np.ndarray:
    """gsnap --part=i/n input sharding: record ids i, i + n, ...
    (gsnap.c:999-1028)."""
    return np.arange(i, total, n)


def block_bounds(rank: int, size: int, b: int) -> tuple[int, int]:
    """[lo, hi) of rank ``rank``'s contiguous block of ``b`` items; the
    blocks follow rank order and differ by at most one item (the first
    b % size ranks take one more).  A block may be empty."""
    q, r = divmod(b, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


# ------------------------------------------------------- sharded k-mer index

def _shard_index_lookup_plain(rows, starts, counts, cap: int, nshards: int,
                              row0: int):
    shard_len = rows.shape[1]
    s = starts.long()
    owner = torch.div(s, shard_len, rounding_mode="floor")
    local = s - owner * shard_len
    j = torch.arange(cap, device=rows.device)[None, :]
    idx = (local[:, None] + j).clamp(0, shard_len - 1)
    own = owner.clamp(0, nshards - 1)
    held = (own >= row0) & (own < row0 + rows.shape[0])
    r = (own - row0).clamp(0, rows.shape[0] - 1)
    vals = genome_ops.u32(rows[r[:, None], idx])
    ok = (j < counts.long()[:, None]) & held[:, None]
    return torch.where(ok, vals, INVALID_DIAG)


def _shard_index_lookup_cuda(rows, starts, counts, cap: int, nshards: int,
                             row0: int):
    n = starts.shape[0]
    out = torch.empty((n, cap), dtype=torch.int64, device=rows.device)
    kbuild.launch("gsnap_shard_index_lookup", rows.device, rows,
                  starts.int().contiguous(), counts.int().contiguous(), out,
                  n, cap, rows.shape[1], nshards, row0, rows.shape[0])
    return out


def shard_index_lookup(positions_sharded, starts, counts, cap: int,
                       nshards: int, row0: int = 0):
    """Candidate lists from a sharded positions array (kernel K18; JAX's
    shard_index_lookup :83, the blueprint for index sharding).

    positions_sharded int32[nrows, shard_len] (uint32 bits) holds shards
    [row0, row0 + nrows) of ``nshards``; starts / counts int32[R] are
    global element indices and list lengths.  Entry (r, j) is element
    starts[r] + j read WITHIN its owner shard (owner = starts // shard_len
    clipped to [0, nshards - 1], the index clipped to the shard's end, as
    JAX clips), or 0xFFFFFFFF where j >= counts[r] or the owner shard is
    not held: the MIN over ranks that each hold their own shard is the
    lookup of the whole array.  Returns int64[R, cap] holding uint32."""
    if not (1 <= positions_sharded.shape[0] and row0 >= 0
            and row0 + positions_sharded.shape[0] <= nshards):
        raise ValueError(f"shard_index_lookup: rows [{row0}, "
                         f"{row0 + positions_sharded.shape[0]}) of "
                         f"{nshards} shards")
    args = (positions_sharded, starts, counts, cap, nshards, row0)
    if positions_sharded.device.type == "cpu":
        return _shard_index_lookup_plain(*args)
    if positions_sharded.device.type == "cuda":
        return _shard_index_lookup_cuda(*args)
    raise ValueError(f"unsupported device {positions_sharded.device}")


def shard_len_of(npositions: int, nshards: int) -> int:
    """Elements a shard: JAX's rule (:134-136) on its positions padded to
    a multiple of 8 (gsnap_se.IndexArrays.from_host), so that the shard
    boundaries are JAX's: ceil(N8 / n) rounded up to 8."""
    n8 = -(-npositions // 8) * 8
    s = -(-n8 // nshards)
    return s + (-s) % 8


@dataclass
class ShardedIndexArrays:
    """K-mer index whose positions array is cut into ``nshards`` shards
    of ``shard_len`` elements (shard s owns global elements [s * shard_len,
    (s + 1) * shard_len), the last one zero-padded); the offsets stay
    replicated.  ``rows`` int32[nrows, shard_len] holds shards [row0,
    row0 + nrows): every shard in one process, or a rank's own one in a
    group of ``nshards`` ranks, whose seeding then ends in an all-reduce
    MIN over ``group``."""

    offsets: torch.Tensor
    rows: torch.Tensor
    k: int
    interval: int
    nshards: int
    row0: int = 0
    group: object = None

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def shard_len(self) -> int:
        return self.rows.shape[1]

    @classmethod
    def from_index(cls, index: gsnap_se.IndexArrays, nshards: int,
                   rank: int | None = None, group=None
                   ) -> "ShardedIndexArrays":
        """Shard a replicated index.  With ``group`` (of ``nshards``
        ranks) the index holds its rank's shard, with ``rank`` that shard,
        else every shard."""
        if group is not None:
            grank, gsize, _ = world(group)
            if gsize != nshards:
                raise ValueError(f"{nshards} shards over a group of {gsize}")
            rank = grank if rank is None else rank
        pos = index.positions
        shard_len = shard_len_of(pos.shape[0], nshards)
        padded = torch.zeros(nshards * shard_len, dtype=pos.dtype,
                             device=pos.device)
        padded[: pos.shape[0]] = pos
        rows = padded.view(nshards, shard_len)
        row0 = 0
        if rank is not None:
            rows, row0 = rows[rank : rank + 1].clone(), rank
        return cls(index.offsets, rows, index.k, index.interval, nshards,
                   row0, group)

    def lookup(self, starts, counts, cap: int):
        """shard_index_lookup over the held shards, combined over the
        group by MIN: the candidate lists of the whole array."""
        out = shard_index_lookup(self.rows, starts, counts, cap,
                                 self.nshards, self.row0)
        return all_reduce_min(out, self.group)


def sharded_seed_diagonals(index: ShardedIndexArrays, codes, nflags,
                           lengths, params, half: bool = True):
    """gsnap_se.seed_diagonals against a sharded positions array (JAX's
    sharded_seed_diagonals :147): K1 once a held shard with that shard's
    bounds, the diagonals' MIN over the shards on the device, then over
    the group's ranks.  qpos, trunc and the phase floors come from the
    replicated offsets, the same from every shard."""
    out = None
    for r in range(index.rows.shape[0]):
        view = gsnap_se.IndexArrays(index.offsets, index.rows[r], index.k,
                                    index.interval)
        res = gsnap_se.seed_diagonals(
            view, codes, nflags, lengths, params, half,
            pos_lo=(index.row0 + r) * index.shard_len,
            pos_len=index.shard_len)
        if out is None:
            out = list(res)
        else:
            torch.minimum(out[0], res[0], out=out[0])
    all_reduce_min(out[0], index.group)
    return tuple(out)
