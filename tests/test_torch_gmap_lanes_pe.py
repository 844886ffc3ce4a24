"""Port parity for the GMAP rescue lanes as a whole, paired end:
GsnapRunner.run_pe with the DEFAULT GsnapParams() (--gmap-mode
pairsearch,indel_knownsplice,terminal,improvement) at -N 0 and -N 1
against the JAX package — SAM byte-equal, with a counter on the port's
runner proving that pairsearch paired a GMAP mate with its anchor.  The
single-end half is test_torch_gmap_lanes_se.py."""

import io

import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu_torch.align import runner as trun
from torch_parity import (count_lanes, fresh_jax_caches, gmap_lanes_world,
                          jax_runner_one_device, one_torch_thread)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world():
    return gmap_lanes_world()


@pytest.mark.parametrize("novel", [False, True])
def test_run_pe_default_lanes_byte_equal(world, monkeypatch, novel):
    g, db, jdb, _, (p1, p2) = world
    jout = io.StringIO()
    jrun.GsnapRunner(jdb, novelsplicing=novel).run_pe(p1, p2, jout,
                                                      batch_size=64)
    runner = trun.GsnapRunner(db, novelsplicing=novel, device="cpu")
    seen = count_lanes(monkeypatch, runner)
    tout = io.StringIO()
    assert runner.run_pe(p1, p2, tout, batch_size=64) == len(p1)
    assert tout.getvalue() == jout.getvalue()
    assert seen["prefetch"] > 0 and seen["pairsearch"] > 0, seen
