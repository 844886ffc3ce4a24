"""Port parity for the cmet/atoi modes (gsnap --mode cmet-stranded /
atoi-stranded, BASELINE config 5), paired end, against the JAX package:
GsnapRunner.run_pe SAM at -N 0 and -N 1 in both modes (directional
bisulfite pairs under cmet; A-to-I edited RNA pairs under atoi, read 2
inverted at input, so its edits show as T -> C), and the paired gsnap
CLI under --mode.  The single-end half is
test_torch_modes_se.py."""

import io
import os

import pytest

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from torch_parity import (align_batch_as_runners, fresh_jax_caches, jax_db,
                          jax_runner_one_device, mode_params, modes_world,
                          one_torch_thread, same_tree)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return modes_world(tmp_path_factory.mktemp("modes_pe"))


@pytest.mark.parametrize("novel", [False, True])
@pytest.mark.parametrize("mode", ["cmet-stranded", "atoi-stranded"])
def test_run_pe_sam_byte_equal(world, mode, novel):
    """PE SAM byte-equal at -N 0 and -N 1 (with the default GMAP lanes,
    which the modes gate off on the host), most pairs proper."""
    db = world["db"]
    p1, p2 = world["pairs"][mode]
    jr = jrun.GsnapRunner(jax_db(db), mode_params(jse, db, mode),
                          novelsplicing=novel)
    tr = trun.GsnapRunner(db, mode_params(tse, db, mode),
                          novelsplicing=novel, device="cpu")
    jo, to = io.StringIO(), io.StringIO()
    jr.run_pe(p1, p2, jo, batch_size=256)
    assert tr.run_pe(p1, p2, to, batch_size=256) == len(p1)
    assert to.getvalue() == jo.getvalue()
    recs = [l.split("\t") for l in to.getvalue().splitlines() if l[0] != "@"]
    proper = {f[0] for f in recs if int(f[1]) & 0x2}
    assert len(proper) > 0.6 * len(p1)


@pytest.mark.parametrize("mode", ["cmet-stranded", "atoi-stranded"])
def test_align_batch_pe_under_mode(world, mode):
    """align_batch_pe with the runner's converted index pair (index_minus)
    and params equals the JAX package's whole result tree."""
    db = world["db"]
    runners = (jrun.GsnapRunner(jax_db(db), mode_params(jse, db, mode),
                                novelsplicing=True),
               trun.GsnapRunner(db, mode_params(tse, db, mode),
                                novelsplicing=True, device="cpu"))
    j, t = align_batch_as_runners(*runners, *world["pairs"][mode])
    same_tree(j, t)


@pytest.mark.parametrize("extra", [["--mode", "atoi-stranded", "-N", "1"],
                                   ["--mode", "cmet-stranded", "--cmetdir",
                                    "CONV"]])
def test_cli_pe_modes_byte_equal(world, capsys, extra):
    extra = [world["conv"] if e == "CONV" else e for e in extra]
    d = world["dir"]
    stem = "f" if "cmet-stranded" in extra else "e"
    args = ["-D", d, "-d", "syn", *extra, os.path.join(d, f"{stem}_1.fq"),
            os.path.join(d, f"{stem}_2.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    mode = extra[extra.index("--mode") + 1]
    assert port_sam.count("\n") > 2 * len(world["pairs"][mode][0])
