"""Port parity: the multi-device layer's in-process forms
(gmap_gsnap_tpu_torch/parallel/shard.py) against gmap_gsnap_tpu's
parallel/shard.py on the conftest's eight virtual CPU devices —
pad_batch / part_indices, the shard rows of ShardedIndexArrays, the
plain shard_index_lookup (kernel K18), seeding against a sharded index
(K1 with shard bounds, MIN over the shards) and align_batch_gapped on a
sharded index.  Where g++ is present, K1's and K18's CUDA sources built
through tools/cuda_emu run by their own wrappers against the plain
versions.  Every comparison is exact."""

import dataclasses
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu.parallel import shard as jshard
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.parallel import shard as tshard
from gmap_gsnap_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def world():
    """A 300 kbp genome at k = 12 (N not a multiple of 8, so the last
    shard holds padding) and 61 planted reads, a fifth of them 55-99 nt."""
    rng = np.random.default_rng(19)
    g = synth.make_genome(rng, [170_001, 130_000])
    db = synth.genome_db(g, 12, 3)
    if len(db.positions) % 8 == 0:     # keep JAX's 8-padding in play
        raise AssertionError("choose a genome whose N is not a multiple of 8")
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, "cpu")
    recs, _ = synth.plant_reads(
        rng, g, 61, weights=dict(sub=3, n=1, mid_indel=1.5, end_indel=1,
                                 terminal=1, repeat=1.5, junk=0.5))
    recs = [r if i % 5 else dataclasses.replace(
        r, seq=r.seq[: 55 + i % 45], quality=r.quality[: 55 + i % 45])
        for i, r in enumerate(recs)]
    c, f, l = trun.encode_batch(recs, 100)
    return dict(jg=jg, ji=ji, tg=tg, ti=ti, c=c, f=f, l=l,
                n=len(db.positions))


def _eq(a, b):
    a, b = np.asarray(a), b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("n,b", [(8, 13), (3, 9), (4, 1), (2, 0)])
def test_pad_batch_and_part_match_jax(n, b):
    rng = np.random.default_rng(b)
    codes = rng.integers(0, 4, (b, 30)).astype(np.uint8)
    nflags = rng.random((b, 30)) < 0.05
    lengths = rng.integers(1, 31, b).astype(np.int32)
    want = jshard.pad_batch(n, codes, nflags, lengths)
    got = tshard.pad_batch(n, codes, nflags, lengths)
    for a, g in zip(want[:3], got[:3]):
        assert a.dtype == g.dtype and np.array_equal(a, g)
    assert want[3] == got[3] == b
    for i in range(n):
        assert np.array_equal(jshard.part_indices(i, n, b),
                              tshard.part_indices(i, n, b))


@pytest.mark.parametrize("size", [1, 2, 3, 8])
@pytest.mark.parametrize("b", [0, 1, 2, 37, 256])
def test_block_bounds_cover_in_rank_order(size, b):
    """Contiguous blocks in rank order that cover the batch once and
    differ by at most one item; a rank past the items gets an empty one."""
    bounds = [tshard.block_bounds(r, size, b) for r in range(size)]
    assert bounds[0][0] == 0 and bounds[-1][1] == b
    assert all(bounds[r][1] == bounds[r + 1][0] for r in range(size - 1))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_index_rows_match_jax(world, n):
    """The shard rows equal JAX's positions2d on reads_mesh(n) (its rule on
    its 8-padded positions); a rank's index holds its own row alone."""
    want = np.asarray(jshard.ShardedIndexArrays.from_index(
        jshard.reads_mesh(n), world["ji"]).positions2d)
    sh = tshard.ShardedIndexArrays.from_index(world["ti"], n)
    assert sh.nshards == n and sh.row0 == 0 and sh.shard_len == want.shape[1]
    _eq(want.view(np.int32), sh.rows)
    for r in range(n):
        one = tshard.ShardedIndexArrays.from_index(world["ti"], n, rank=r)
        assert one.row0 == r and one.rows.shape == (1, want.shape[1])
        _eq(want[r : r + 1].view(np.int32), one.rows)


def _lookup_cases(n_elems: int, shard_len: int, nshards: int, cap: int):
    """starts inside shards, a cap short of a shard's end (the list
    crosses into the next shard: JAX clips within the owner), in the last
    shard's padding and past it; counts 0, 1, cap - 1, cap and above."""
    rng = np.random.default_rng(nshards * 1000 + cap)
    ends = [s * shard_len for s in range(1, nshards + 1)]
    starts = [0, 1, shard_len - 1, shard_len - cap // 2, n_elems - 1,
              n_elems, nshards * shard_len - 1, nshards * shard_len + 3]
    starts += [e - 1 for e in ends] + [e - cap + 1 for e in ends]
    starts += rng.integers(0, n_elems, 40).tolist()
    starts = np.clip(np.array(starts), 0, 2**31 - 1).astype(np.int32)
    counts = np.array([(0, 1, cap - 1, cap, cap + 5)[i % 5]
                       for i in range(len(starts))], np.int32)
    return starts, counts


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cap", [8, 32])
def test_shard_index_lookup_matches_jax(world, n, cap):
    """The plain K18 equals JAX's shard_index_lookup; a rank's lookup over
    its own shard, MIN-combined over the ranks, equals the lookup over
    every shard."""
    sh = tshard.ShardedIndexArrays.from_index(world["ti"], n)
    starts, counts = _lookup_cases(world["n"], sh.shard_len, n, cap)
    want = jshard.shard_index_lookup(
        jnp.asarray(sh.rows.numpy().view(np.uint32)), jnp.asarray(starts),
        jnp.asarray(counts), cap=cap, nshards=n)
    got = tshard.shard_index_lookup(sh.rows, torch.from_numpy(starts),
                                    torch.from_numpy(counts), cap, n)
    assert got.dtype == torch.int64
    _eq(want, got)
    parts = [tshard.shard_index_lookup(sh.rows[r : r + 1],
                                       torch.from_numpy(starts),
                                       torch.from_numpy(counts), cap, n,
                                       row0=r) for r in range(n)]
    assert torch.equal(torch.stack(parts).min(0).values, got)
    assert (got == tshard.INVALID_DIAG).any() and (got < 2**32 - 1).any()


def _seed_inputs(world):
    return (torch.from_numpy(world["c"]), torch.from_numpy(world["f"]),
            torch.from_numpy(world["l"]))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("seed_total", [384, 48])
def test_sharded_seed_diagonals_match(world, n, seed_total):
    """Seeding on a sharded index (every shard in one process) equals the
    replicated port and JAX's _seed_diagonals on its sharded index (pmin
    over a mesh of n devices), every output; each shard's own qpos,
    trunc and phase floors are the same."""
    c, f, l = _seed_inputs(world)
    tp = tse.GsnapParams(seed_total=seed_total)
    sh = tshard.ShardedIndexArrays.from_index(world["ti"], n)
    rep = tse.seed_diagonals(world["ti"], c, f, l, tp, half=True)
    got = tse.seed_diagonals(sh, c, f, l, tp, half=True)
    for a, b in zip(rep, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jsh = jshard.ShardedIndexArrays.from_index(jshard.reads_mesh(n),
                                               world["ji"])
    jo, jv = jse._extract_oligos(jnp.asarray(world["c"]),
                                 jnp.asarray(world["f"]),
                                 jnp.asarray(world["l"]), 12)
    jres = jse._seed_diagonals(jsh, jo, jv,
                               jse.GsnapParams(seed_total=seed_total),
                               jnp.asarray(world["l"]))
    for a, b in zip(jres, got):
        _eq(a, b)
    if seed_total == 48:
        assert got[2].any()          # the repeat reads truncate
    per = [tse.seed_diagonals(
        tse.IndexArrays(sh.offsets, sh.rows[r], 12, 3), c, f, l, tp,
        half=True, pos_lo=r * sh.shard_len, pos_len=sh.shard_len)
        for r in range(n)]
    for p in per:
        for a, b in zip(p[1:], got[1:]):
            assert torch.equal(a, b)
    if n > 1:   # each shard resolved some slots and left others
        assert all((p[0] != tse.INVALID_DIAG).any() for p in per)
        assert all((p[0] != got[0]).any() for p in per)


@pytest.mark.parametrize("n", [2, 8])
def test_align_batch_gapped_sharded(world, n):
    """align_batch_gapped (-N 1) on a sharded index equals JAX's sharded
    run on npaths, left, kind, score and nmm (the fields JAX's own
    sharded-index test holds), and the replicated port on every key."""
    c, f, l = _seed_inputs(world)
    tp = tgg.GappedParams(novelsplicing=True)
    sh = tshard.ShardedIndexArrays.from_index(world["ti"], n)
    rep = tgg.align_batch_gapped(world["tg"], world["ti"], c, f, l, tp)
    got = tgg.align_batch_gapped(world["tg"], sh, c, f, l, tp)
    assert set(rep) == set(got)
    for k in rep:
        assert torch.equal(rep[k], got[k]), k
    jsh = jshard.ShardedIndexArrays.from_index(jshard.reads_mesh(n),
                                               world["ji"])
    jout = jgg.align_batch_gapped(
        world["jg"], jsh, jnp.asarray(world["c"]), jnp.asarray(world["f"]),
        jnp.asarray(world["l"]), jgg.GappedParams(novelsplicing=True))
    for k in ("npaths", "left", "kind", "score", "nmm"):
        _eq(jout[k], got[k])
    assert (got["npaths"] > 0).sum() > len(world["l"]) // 2


def test_gmap_seed_segments_refuse_a_sharded_index(world):
    """The GMAP lanes read positions whole (JAX never runs them on a
    sharded index): K9's entry raises TypeError for one."""
    from gmap_gsnap_tpu_torch.align import gmap_engine as teng

    sh = tshard.ShardedIndexArrays.from_index(world["ti"], 2)
    oligos = torch.zeros((1, 8), dtype=torch.int32)
    valid = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="sharded"):
        teng.seed_segments(sh.offsets, sh.rows, oligos, valid, 12, 64, 16,
                           100)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kernels.build.launch pointed at K1 and K18 built by tools/cuda_emu
    (restored after)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "cuda_emu"))
    import emu_build

    launch = kbuild.launch
    so = emu_build.build(["seed_diagonals", "shard_index_lookup"],
                         str(tmp_path_factory.mktemp("emu")))
    emu_build.use(so)
    yield
    kbuild.launch = launch


@pytest.mark.parametrize("n", [1, 3])
def test_sharded_kernels_emulated(emulated, world, n):
    """K1 with shard bounds and K18 from their CUDA sources against the
    plain versions, shard by shard; a launch is counted for each call."""
    c, f, l = _seed_inputs(world)
    tp = tse.GsnapParams(seed_total=384)
    sh = tshard.ShardedIndexArrays.from_index(world["ti"], n)
    before = dict(kbuild.LAUNCHES)
    for r in range(n):
        view = tse.IndexArrays(sh.offsets, sh.rows[r], 12, 3)
        args = (view, c, f, l, tp, True, r * sh.shard_len, sh.shard_len)
        for a, b in zip(tse._seed_diagonals_cuda(*args),
                        tse._seed_diagonals_plain(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    starts, counts = _lookup_cases(world["n"], sh.shard_len, n, 32)
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    for rows, row0 in [(sh.rows, 0)] + [(sh.rows[r : r + 1], r)
                                        for r in range(n)]:
        want = tshard._shard_index_lookup_plain(rows, st, ct, 32, n, row0)
        got = tshard._shard_index_lookup_cuda(rows, st, ct, 32, n, row0)
        assert torch.equal(got, want)
    assert (kbuild.LAUNCHES["gsnap_seed_diagonals"]
            == before.get("gsnap_seed_diagonals", 0) + n)
    assert (kbuild.LAUNCHES["gsnap_shard_index_lookup"]
            == before.get("gsnap_shard_index_lookup", 0) + n + 1)
