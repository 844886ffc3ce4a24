"""Port parity for the gmap CLI's alignment, input and routing flags:
the port's gmap CLI with --device cpu prints the same bytes as the JAX
package's, in-process, on a database the port's gmap_build wrote (the
world of tests/torch_parity.gmap_world): user segments (-g, --cmdline,
-1, -2), -p 3, map lookups (-m with -e, -b, -u 1, --print-comment, on a
map the port's iit_store wrote), output routing (--split-output files,
--failsonly, --nofails, --fails-as-input), the alignment knobs (-z,
--suboptimal-score, -o, -x, -T, -F, -a, --nosplicing), and
--quiet-if-excessive, -c with a subset file, -5 and -q."""

import os

import pytest

from gmap_gsnap_tpu.cli import gmap as jcli
from gmap_gsnap_tpu_torch.cli import gmap as tcli
from torch_parity import (fresh_jax_caches, gmap_cli_outputs, gmap_world,
                          one_torch_thread, restore_gmap_globals)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    restore_gmap_globals(monkeypatch)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return gmap_world(str(tmp_path_factory.mktemp("gmapopts")))


def db_args(world, queries="core"):
    return ["-D", world["d"], "-d", "syn", world[queries]]


@pytest.mark.parametrize("flags", [
    ["-z", "sense_filter"], ["--suboptimal-score", "0"], ["-o", "5"],
    ["-x", "30"], ["-T"], ["-F"], ["-a", "1"], ["--nosplicing"],
    ["--nosplicing", "-A"], ["-p", "3"], ["--quiet-if-excessive", "-n", "1"],
    ["-5"], ["-q", "1/2"], ["-S", "-q", "0/2"], ["-f", "samse", "-T"]])
def test_gmap_cli_alignment_flags(world, capsys, flags):
    jax, port = gmap_cli_outputs(capsys, flags + db_args(world))
    assert port == jax
    assert port.count("\n") > 8


def test_gmap_cli_chrsubset(world, capsys):
    """-c with a subset file labels every Paths line (the reference's
    label-only subset); an unknown subset exits 9."""
    subset = ["-C", world["subsets"], *db_args(world)]
    jax, port = gmap_cli_outputs(capsys, ["-c", "first", *subset])
    assert port == jax and "[chrsubset: first]" in port
    jax, port = gmap_cli_outputs(capsys, ["-c", "none", *subset])
    assert port == jax == ""


@pytest.mark.parametrize("flags", [
    ["-e"], ["-b"], ["-u", "1"], ["--print-comment"],
    ["-e", "-b", "--print-comment"]])
def test_gmap_cli_map_hits(world, capsys, flags):
    jax, port = gmap_cli_outputs(capsys,
                                 ["-m", "genes", *flags, *db_args(world)])
    assert port == jax
    assert "Map hits for path 1" in port and "\tgenes\t" in port


@pytest.mark.parametrize("user", ["-g", "--cmdline", "-1", "-2"])
def test_gmap_cli_user_segments(world, capsys, user):
    """Each side builds its user segment's database with its own
    db/build.build_db (k = 12)."""
    args = {"-g": ["-g", world["gseg"], world["core"]],
            "--cmdline": ["--cmdline", world["cmdline"]],
            "-1": ["-1", world["pair"]],
            "-2": ["-2", world["pair"]]}[user]
    jax, port = gmap_cli_outputs(capsys, args)
    assert port == jax
    assert "Path 1:" in port


@pytest.mark.parametrize("flags", [
    [], ["--fails-as-input"], ["-f", "samse"]])
def test_gmap_cli_split_output(world, capsys, tmp_path, flags):
    """--split-output writes the same files with the same bytes."""
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        os.makedirs(tmp_path / name)
        root = str(tmp_path / name / "out")
        assert cli.main(["--split-output", root] + flags
                        + db_args(world) + extra) == 0
        assert capsys.readouterr().out == ""
        out[name] = {f: (tmp_path / name / f).read_text()
                     for f in sorted(os.listdir(tmp_path / name))}
    assert out["port"] == out["jax"]
    assert {"out.uniq", "out.mult", "out.transloc"} <= set(out["port"])


@pytest.mark.parametrize("flags", [
    ["--failsonly"], ["--nofails"], ["--fails-as-input", "--failsonly"]])
def test_gmap_cli_fails(world, capsys, flags):
    jax, port = gmap_cli_outputs(capsys, flags + db_args(world))
    assert port == jax
    assert port
