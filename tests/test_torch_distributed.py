"""Port parity for the multi-device layer across processes: ranks spawned
with torch.multiprocessing.spawn join a gloo group on the CPU
(tests/torch_dist_worker.py, which imports torch and the port alone)
and their output is held to one process's.

* the sharded index: K1's plain path on a rank's shard of the positions
  plus the all-reduce MIN, and K18's lookup likewise, on 2 ranks, equal
  one process on the whole index;
* GsnapRunner.run / run_pe at -N 1 with the default GMAP lanes on 2 and
  3 ranks, in chunks of 37 reads or pairs of mixed lengths (uneven
  blocks) and a last chunk smaller than the world: rank 0's SAM is
  byte-equal to one process's (for PE also to the JAX runner on the
  conftest's 8-device mesh), the other ranks write nothing, and every
  rank returns the whole count;
* the gsnap CLI under a torchrun-style environment on 2 ranks writes
  the bytes one process writes.

Every rank's join has a time limit: a rank still running after it is
killed and the test fails."""

import dataclasses
import io
import json
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as worker
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.db.datadir import GenomeDB
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, jax_db, one_torch_thread

JOIN_S = 180
CHUNK = 37
NREADS = 2 * CHUNK + 1    # the last chunk of one item: smaller than a world


@pytest.fixture(scope="module", autouse=True)
def _reference_settings():
    with fresh_jax_caches(), one_torch_thread():
        yield


def _mixed(recs, rng):
    """A third of the records cut to 60-99 nt."""
    out = []
    for i, r in enumerate(recs):
        if i % 3 == 1:
            n = int(rng.integers(60, 100))
            r = dataclasses.replace(r, seq=r.seq[:n],
                                    quality=r.quality[:n] if r.quality
                                    else r.quality)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A 250 kbp genome written by the port's gmap_build at k = 12, and
    NREADS DNA, spliced and messy-junction reads and RNA pairs of mixed
    lengths, as FASTQ."""
    rng = np.random.default_rng(29)
    g = synth.make_genome(rng, [150_000, 100_000])
    d = tmp_path_factory.mktemp("dist")
    g.write_fasta(str(d / "g.fa"))
    assert tgmap_build.main(["-d", "syn", "--dir", str(d), "-k", "12",
                             str(d / "g.fa")]) == 0
    recs, _ = synth.plant_reads(rng, g, NREADS - 25, weights=dict(
        sub=3, n=0.5, mid_indel=1, end_indel=1, terminal=1, junk=0.5))
    srecs, _ = synth.plant_spliced_reads(rng, g, 25, weights=dict(
        unspliced=0.2, junction=0.4, messy_junction=0.4))
    reads = _mixed(recs + srecs, rng)
    reads = [reads[i] for i in rng.permutation(len(reads))]
    p1, p2, _ = synth.plant_pairs(rng, g, NREADS, rna=True)
    p1, p2 = _mixed(p1, rng), _mixed(p2, np.random.default_rng(3))
    synth.write_fastq(str(d / "se.fq"), reads)
    synth.write_fastq(str(d / "p_1.fq"), p1)
    synth.write_fastq(str(d / "p_2.fq"), p2)
    return d


def _spawn(fn, size: int, *args) -> None:
    """Run fn(rank, size, *args) on ``size`` spawned ranks; fail (after
    killing them) if they are not done within JOIN_S seconds."""
    ctx = mp.spawn(fn, args=(size, *args), nprocs=size, join=False)
    deadline = time.time() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{size} ranks of {fn.__name__} still running "
                        f"after {JOIN_S} s")


def test_sharded_seeding_across_ranks(tmp_path):
    """Two ranks, a shard of the positions each: K1's plain path with the
    shard's bounds and the all-reduce MIN equal one process's seeding on
    the whole index, every output; K18's lookup likewise."""
    rng = np.random.default_rng(41)
    g = synth.make_genome(rng, [120_001, 60_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_reads(rng, g, 40, weights=dict(sub=3, repeat=1))
    codes, nflags, lengths = trun.encode_batch(_mixed(recs, rng), 100)
    n = len(db.positions)
    starts = rng.integers(0, n, 64).astype(np.int32)
    starts[:4] = [0, n // 2 - 3, n - 1, n + 2]   # across the shard bound
    counts = rng.integers(0, 40, 64).astype(np.int32)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, offsets=db.offsets.view(np.int32),
             positions=db.positions.view(np.int32), k=12, interval=3,
             seed_total=64, codes=codes, nflags=nflags, lengths=lengths,
             starts=starts, counts=counts, cap=32)
    _spawn(worker.seed_rank, 2, f"file://{tmp_path}/init", inputs,
           str(tmp_path))
    index = tse.IndexArrays(torch.from_numpy(db.offsets.view(np.int32)),
                            torch.from_numpy(db.positions.view(np.int32)),
                            12, 3)
    want = tse.seed_diagonals(index, torch.from_numpy(codes),
                              torch.from_numpy(nflags),
                              torch.from_numpy(lengths),
                              tse.GsnapParams(seed_total=64), half=True)
    from gmap_gsnap_tpu_torch.parallel import shard

    full = shard.ShardedIndexArrays.from_index(index, 2)
    look = full.lookup(torch.from_numpy(starts), torch.from_numpy(counts), 32)
    for rank in range(2):
        got = np.load(tmp_path / f"seed{rank}.npz")
        for i, w in enumerate(want):
            assert np.array_equal(got[f"arr_{i}"], w.numpy()), (rank, i)
        assert np.array_equal(got["arr_5"], look.numpy()), rank
    assert want[2].any()                     # repeat reads truncate
    assert (look != tse.INVALID_DIAG).any()


def _runner_sam(db, recs, batch: int) -> tuple:
    r = trun.GsnapRunner(db, novelsplicing=True, device="cpu")
    out = io.StringIO()
    n = (r.run_pe(*recs, out, batch_size=batch) if len(recs) == 2
         else r.run(recs[0], out, batch_size=batch))
    return out.getvalue(), n


@pytest.fixture(scope="module")
def single(disk):
    """One process's SAM of the reads and of the pairs, and the JAX
    runner's SAM of the pairs on its 8-device mesh."""
    from gmap_gsnap_tpu_torch.io import fasta

    db = GenomeDB.open(str(disk / "syn"), "syn")
    reads = list(fasta.read_seqfile(str(disk / "se.fq")))
    pairs = [list(fasta.read_seqfile(str(disk / f"p_{i}.fq")))
             for i in (1, 2)]
    out = dict(se=_runner_sam(db, [reads], CHUNK),
               pe=_runner_sam(db, pairs, CHUNK))
    jr = jrun.GsnapRunner(jax_db(db), novelsplicing=True)
    assert jr.mesh is not None and jr._ndev == 8
    jout = io.StringIO()
    # chunks of 40 and 35, both padded to 40 over the mesh: one batch
    # shape for XLA to compile (a pair's output is its own, whatever the
    # chunk: the ranks' runs show it)
    jr.run_pe(*pairs, jout, batch_size=40)
    out["pe_jax_mesh"] = jout.getvalue()
    return out


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("kind", ["se", "pe"])
def test_runner_across_ranks(disk, single, tmp_path, size, kind):
    reads = ([str(disk / "se.fq")] if kind == "se"
             else [str(disk / "p_1.fq"), str(disk / "p_2.fq")])
    spec = json.dumps(dict(dbdir=str(disk / "syn"), db="syn", reads=reads,
                           batch=CHUNK))
    _spawn(worker.runner_rank, size, f"file://{tmp_path}/init", spec,
           str(tmp_path))
    want, n = single[kind]
    assert n == NREADS
    assert (tmp_path / "rank0.sam").read_text() == want
    for rank in range(size):
        assert (tmp_path / f"rank{rank}.n").read_text() == str(NREADS)
        if rank:
            assert (tmp_path / f"rank{rank}.sam").read_text() == ""
    if kind == "pe":
        assert want == single["pe_jax_mesh"]
    # one record a read at least, some of them spliced
    cigars = [x.split("\t")[5] for x in want.splitlines()
              if not x.startswith("@")]
    assert len(cigars) >= NREADS * len(reads)
    assert any("N" in c for c in cigars)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_torchrun_two_ranks(disk, tmp_path, capsys):
    """python -m ...cli.gsnap -N 1 --device cpu on two ranks (torchrun's
    environment) writes one process's bytes; rank 1 writes nothing."""
    argv = ["-D", str(disk), "-d", "syn", "-N", "1", "--device", "cpu",
            "--batch-size", str(CHUNK), str(disk / "p_1.fq"),
            str(disk / "p_2.fq")]
    assert tcli.main(argv) == 0
    want = capsys.readouterr().out
    _spawn(worker.cli_rank, 2, _free_port(), argv, str(tmp_path))
    assert (tmp_path / "cli0.rc").read_text() == "0"
    assert (tmp_path / "cli1.rc").read_text() == "0"
    assert (tmp_path / "cli0.out").read_text() == want
    assert (tmp_path / "cli1.out").read_text() == ""
    assert want.startswith("@SQ") or want.startswith("@HD")
