"""Port parity for the GMAP rescue lanes as a whole, single end:
GsnapRunner.run with the DEFAULT GsnapParams() (--gmap-mode pairsearch,
indel_knownsplice,terminal,improvement) at -N 0 and -N 1, and the gsnap
CLI with no --gmap-mode and with terminal,improvement, against the JAX
package — SAM byte-equal.  Counters installed on the port's runner prove
that each lane fired: the terminal lane's and the improvement pass's
GMAP hits were accepted, and at -N 1 the junction dynprog's solutions
were used.  The paired-end half is test_torch_gmap_lanes_pe.py."""

import io

import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth
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
def test_run_default_lanes_byte_equal(world, monkeypatch, novel):
    g, db, jdb, recs, _ = world
    jout = io.StringIO()
    jrun.GsnapRunner(jdb, novelsplicing=novel).run(recs, jout, batch_size=64)
    runner = trun.GsnapRunner(db, novelsplicing=novel, device="cpu")
    assert runner.gmap_modes == {"pairsearch", "indel_knownsplice",
                                 "terminal", "improvement"}
    seen = count_lanes(monkeypatch, runner)
    tout = io.StringIO()
    assert runner.run(recs, tout, batch_size=64) == len(recs)
    assert tout.getvalue() == jout.getvalue()
    assert seen["prefetch"] > 0 and seen["prefetched_reads"] > 0, seen
    assert seen["terminal"] > 0 and seen["improvement"] > 0, seen
    if novel:
        assert seen["dynprog"] > 0, seen
    assert runner.gmap_seconds > 0


def test_lane_choice_changes_output(world):
    """--gmap-mode none, terminal,improvement and the default give three
    runs; dropping a lane the reads need changes the SAM (the lanes are
    not no-ops), and indel_knownsplice alone is none without -s."""
    g, db, _, recs, (p1, p2) = world

    def se(mode):
        out = io.StringIO()
        trun.GsnapRunner(db, tse.GsnapParams(gmap_mode=mode),
                         device="cpu").run(recs, out, batch_size=64)
        return out.getvalue()

    default = se(tse.GsnapParams().gmap_mode)
    assert se("terminal,improvement") == default
    assert se("") != default and se("terminal") != default
    assert se("indel_knownsplice") == se("")


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    g, _, _, recs, _ = world
    d = tmp_path_factory.mktemp("db")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), recs[:120])
    return d


@pytest.mark.parametrize("extra", [[], ["--gmap-mode", "terminal,improvement"],
                                   ["-N", "1"]])
def test_cli_gmap_modes_byte_equal(disk_db, capsys, extra):
    args = ["-D", str(disk_db), "-d", "syn", "--batch-size", "64", *extra,
            str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert port_sam.count("\n") > 120


@pytest.mark.parametrize("mode", [
    "none", "all", "improve", "terminal,improvement", "pairsearch,none,terminal",
    " terminal , pairsearch ", "indel_knownsplice", "", "bogus",
    "terminal,bogus"])
def test_expand_gmap_mode_matches_jax(capsys, mode):
    def run(f):
        try:
            return f(mode), None
        except SystemExit as e:
            return None, (e.code, capsys.readouterr().err)

    assert run(tcli._expand_gmap_mode) == run(jcli._expand_gmap_mode)
