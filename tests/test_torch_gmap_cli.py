"""Port parity for the gmap CLI's output formats: the port's
``python -m gmap_gsnap_tpu_torch.cli.gmap --device cpu`` prints the same
bytes on standard output as the JAX package's gmap CLI, in-process, on
a database the port's gmap_build wrote: the default Paths format, -f
samse and sampe, -n 0 and 1, -S, -A, -Z, -3, -4, every other -f format,
and --version, which names the port.  The alignment and routing flags
are in tests/test_torch_gmap_cli_options.py."""

import pytest
import torch

from gmap_gsnap_tpu.cli import gmap as jcli
from gmap_gsnap_tpu_torch.cli import gmap as tcli
from gmap_gsnap_tpu_torch.utils import synth
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
    return gmap_world(str(tmp_path_factory.mktemp("gmapcli")))


def db_args(world, queries="core"):
    return ["-D", world["d"], "-d", "syn", world[queries]]


@pytest.mark.parametrize("flags", [[], ["-f", "samse"], ["-A"]])
def test_gmap_cli_every_query_kind(world, capsys, flags):
    """All queries (both strands, bench-style, chimeras, duplicated
    segments, N-rich, random, poly-A, low complexity) under the default
    Paths format, -f samse and -A."""
    jax, port = gmap_cli_outputs(capsys, flags + db_args(world, "q"))
    assert port == jax
    assert port.count("\n") > len(world["records"])
    if not flags:
        assert "Paths (2):" in port and "chimera" in port
    if flags == ["-f", "samse"]:
        assert "XT:Z:NN-NN" in port and "NH:i:2\tHI:i:2" in port


@pytest.mark.parametrize("flags", [
    ["-f", "sampe"], ["-n", "0"], ["-n", "1"], ["-S"], ["-Z"], ["-3"],
    ["-4"], ["-A", "-n", "1"]])
def test_gmap_cli_output_flags(world, capsys, flags):
    jax, port = gmap_cli_outputs(capsys, flags + db_args(world))
    assert port == jax
    assert port.count("\n") > 8


@pytest.mark.parametrize("fmt", [
    "gff3_gene", "gff3_match_cdna", "gff3_match_est", "summary", "psl",
    "splicesites", "introns", "map_genes", "map_exons", "coords"])
def test_gmap_cli_formats(world, capsys, fmt):
    jax, port = gmap_cli_outputs(capsys, ["-f", fmt] + db_args(world))
    assert port == jax
    assert port.count("\n") >= 4


@pytest.mark.parametrize("flags", [[], ["-A"], ["-f", "samse"],
                                   ["-f", "psl"]])
def test_gmap_cli_short_query(world, capsys, tmp_path, flags):
    """A query shorter than k, then a planted one: "Short sequence" in the
    Paths format, as the JAX CLI prints it.  Under any other format the
    port prints the format's nomapping record (samse: an unmapped SAM
    line; psl: nothing) and then the planted query's bytes as the JAX CLI
    prints them alone (the JAX CLI raises TypeError past the short query
    there, ROADMAP C9)."""
    args = flags + db_args(world, "short")
    if "-f" not in flags:
        jax, port = gmap_cli_outputs(capsys, args)
        assert port == jax and "Short sequence < index oligo size" in port
        return
    one = str(tmp_path / "one.fa")
    synth.write_fasta_records(one, [world["records"][0]])
    assert jcli.main(flags + ["-D", world["d"], "-d", "syn", one]) == 0
    jax = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    lines = jax.splitlines(keepends=True)
    head = sum(ln.startswith("@") for ln in lines)
    nomap = ("short\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTAC\t*\n"
             if flags == ["-f", "samse"] else "")
    assert port == "".join(lines[:head]) + nomap + "".join(lines[head:])
    assert world["records"][0].label in port


def test_gmap_cli_version(capsys):
    assert tcli.main(["--version"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("GMAP: ") and "gmap_gsnap_tpu_torch" in out


def test_gmap_cli_refusals(world, capsys, monkeypatch, tmp_path):
    """The port's CLI exits 2 naming the cause, before any output, for a
    query longer than the GMAP engine aligns (65,536 + k - 1 bases; the
    card refuses it too, tests/test_torch_kernels.py) and for a CUDA
    device this process does not have."""
    q = tmp_path / "long.fa"
    q.write_text(f">ok\n{world['records'][0].seq}\n>long\n"
                 + "ACGT" * (65_547 // 4 + 1) + "\n")
    assert tcli.main(["-D", world["d"], "-d", "syn", str(q),
                      "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "query long of 65548 bases" in out.err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(db_args(world)) == 2
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err
