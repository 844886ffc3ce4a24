"""Rank bodies for tests/test_torch_distributed.py, started with
torch.multiprocessing.spawn.  This module imports torch and the port
alone: the spawned ranks must not import the test module, which imports
JAX.  Each rank joins a gloo group through ``init_method`` (a file), runs
its part and writes what it produced under ``out_dir`` for the test to
compare with one process's result."""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120


def _join(rank: int, size: int, init_method: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def seed_rank(rank: int, size: int, init_method: str, inputs: str,
              out_dir: str) -> None:
    """Seed the reads of ``inputs`` (an npz: offsets, positions, k,
    interval, seed_total, codes, nflags, lengths, and starts / counts /
    cap for the lookup) against this rank's shard of the positions, with
    the all-reduce MIN, and look the candidate lists up likewise."""
    from gmap_gsnap_tpu_torch.align import gsnap_se
    from gmap_gsnap_tpu_torch.parallel import shard

    _join(rank, size, init_method)
    z = np.load(inputs)
    t = lambda a: torch.from_numpy(z[a])
    index = gsnap_se.IndexArrays(t("offsets"), t("positions"), int(z["k"]),
                                 int(z["interval"]))
    sh = shard.ShardedIndexArrays.from_index(index, size,
                                             group=dist.group.WORLD)
    assert sh.rows.shape[0] == 1 and sh.row0 == rank
    params = gsnap_se.GsnapParams(seed_total=int(z["seed_total"]))
    res = gsnap_se.seed_diagonals(sh, t("codes"), t("nflags"), t("lengths"),
                                  params, half=True)
    look = sh.lookup(t("starts"), t("counts"), int(z["cap"]))
    np.savez(os.path.join(out_dir, f"seed{rank}.npz"),
             *[x.numpy() for x in res], look.numpy())
    dist.destroy_process_group()


def runner_rank(rank: int, size: int, init_method: str, spec: str,
                out_dir: str) -> None:
    """GsnapRunner.run (one reads file) or run_pe (two) on the CPU at
    -N 1 with the default GMAP lanes, over the world's ranks; writes the
    rank's output and returned count."""
    from gmap_gsnap_tpu_torch.align import runner
    from gmap_gsnap_tpu_torch.db.datadir import GenomeDB
    from gmap_gsnap_tpu_torch.io import fasta

    _join(rank, size, init_method)
    sp = json.loads(spec)
    db = GenomeDB.open(sp["dbdir"], sp["db"])
    r = runner.GsnapRunner(db, novelsplicing=True, device="cpu")
    recs = [list(fasta.read_seqfile(p)) for p in sp["reads"]]
    with open(os.path.join(out_dir, f"rank{rank}.sam"), "w") as out:
        if len(recs) == 2:
            n = r.run_pe(recs[0], recs[1], out, batch_size=sp["batch"])
        else:
            n = r.run(recs[0], out, batch_size=sp["batch"])
    with open(os.path.join(out_dir, f"rank{rank}.n"), "w") as f:
        f.write(str(n))
    dist.destroy_process_group()


def cli_rank(rank: int, size: int, port: int, argv: list,
             out_dir: str) -> None:
    """python -m gmap_gsnap_tpu_torch.cli.gsnap as torchrun starts it on
    one host (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT), standard output into a file a rank."""
    from gmap_gsnap_tpu_torch.cli import gsnap

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    with open(os.path.join(out_dir, f"cli{rank}.out"), "w") as out:
        sys.stdout = out
        try:
            rc = gsnap.main(argv)
        finally:
            sys.stdout = sys.__stdout__
    with open(os.path.join(out_dir, f"cli{rank}.rc"), "w") as f:
        f.write(str(rc))
