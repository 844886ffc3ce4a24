"""Port parity for the gsnap CLI's input and output handling: every flag
of the JAX CLI that the port's parser once lacked (-q/--part,
--sam-headers-batch, --fastq-id-start/-end, --barcode-length,
--filter-chastity, --split-output, --fails-as-input, --failsonly,
--nofails, the read-group flags, --quality-protocol, -j, and the flags
accepted with no effect), single-end and paired-end: standard output and
every --split-output file byte-equal to the JAX CLI's, the same exit
codes on the two conflicts (exit 9), and every option string of the JAX
CLI accepted by the port's parser."""

import argparse
import dataclasses
import os

import numpy as np
import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread)

KINDS = dict(sub=4, mid_indel=1, end_indel=1, terminal=1, junk=1.5)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    """The CLIs set QUALITY_ADJ (-J, --quality-protocol); put it back."""
    for mod in (jrun, trun):
        monkeypatch.setattr(mod, "QUALITY_ADJ", mod.QUALITY_ADJ)


def _headers(recs, tag):
    """Casava-style headers: '<name> <read>:<Y|N>:0:<index> lane<i>', a
    quarter of them chastity-flagged (Y)."""
    return [dataclasses.replace(
        r, header=f"{r.label} {tag}:{'Y' if i % 4 == 1 else 'N'}:0:ACGT "
                  f"lane{i % 3}")
        for i, r in enumerate(recs)]


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    rng = np.random.default_rng(83)
    g = synth.make_genome(rng, [120_000, 80_000], repeat_copies=2)
    d = tmp_path_factory.mktemp("cli_io")
    g.write_fasta(str(d / "g.fa"))
    assert tgmap_build.main(["-d", "syn", "--dir", str(d), "-k", "12",
                             str(d / "g.fa")]) == 0
    recs, _ = synth.plant_reads(rng, g, 48, weights=KINDS)
    synth.write_fastq(str(d / "se.fq"), _headers(recs, 1))
    p1, p2, _ = synth.plant_pairs(rng, g, 32, weights=dict(
        concordant=0.7, random=0.15, halfmapping=0.15))
    q1, q2 = _headers(p1, 1), _headers(p2, 2)
    # the second read of every eighth pair flagged alone: "either" drops
    # the pair, "both" keeps it
    q2 = [dataclasses.replace(r, header=r.header.replace(":N:", ":Y:"))
          if i % 8 == 3 else r for i, r in enumerate(q2)]
    synth.write_fastq(str(d / "p_1.fq"), q1)
    synth.write_fastq(str(d / "p_2.fq"), q2)
    return d


def _split_files(root) -> dict:
    """{suffix: text} of the files written under --split-output root."""
    head, base = os.path.split(str(root))
    return {f[len(base) + 1:]: open(os.path.join(head, f)).read()
            for f in sorted(os.listdir(head)) if f.startswith(base + ".")}


CASES = {
    "part": ["-q", "1/3"],
    "headers batch on its part": ["-q", "0/2", "--sam-headers-batch", "0"],
    "headers batch off its part": ["-q", "1/2", "--sam-headers-batch", "0"],
    "fastq id fields": ["--fastq-id-start", "2", "--fastq-id-end", "3"],
    "fastq id start": ["--fastq-id-start", "1"],
    "barcode": ["--barcode-length", "4"],
    "chastity either": ["--filter-chastity", "either"],
    "chastity both": ["--filter-chastity", "both"],
    "split": ["--split-output", "ROOT"],
    "split fails as input": ["--split-output", "ROOT", "--fails-as-input"],
    "fails as input alone": ["--fails-as-input"],
    "failsonly": ["--failsonly"],
    "failsonly as input": ["--failsonly", "--fails-as-input"],
    "nofails": ["--nofails"],
    "read group": ["--read-group-id", "RG7", "--read-group-name", "S1",
                   "--read-group-library", "L2", "--read-group-platform",
                   "ILLUMINA"],
    "read group split": ["--read-group-id", "RG7", "--split-output",
                         "ROOT", "-j", "2"],
    "illumina": ["--quality-protocol", "illumina"],
    "sanger": ["--quality-protocol", "sanger"],
    "print shift": ["-j", "5"],
    "negative print shift": ["-j", "-3", "--barcode-length", "4"],
    "no effect": ["-B", "5", "-G", "--output-buffer-size", "10", "--unload",
                  "-t", "4", "--gunzip", "-O", "--input-buffer-size", "7"],
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ends", ["se", "pe"])
def test_cli_io_byte_equal(disk, tmp_path, capsys, case, ends):
    inputs = ([str(disk / "se.fq")] if ends == "se"
              else [str(disk / "p_1.fq"), str(disk / "p_2.fq")])
    outs = []
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        os.makedirs(tmp_path / who)
        root = str(tmp_path / who / "out")
        extra = [root if a == "ROOT" else a for a in CASES[case]]
        args = ["-D", str(disk), "-d", "syn", "--gmap-mode", "none",
                "--batch-size", "8", *extra, *inputs]
        if who == "port":
            args += ["--device", "cpu"]
        assert main(args) == 0
        got = capsys.readouterr()
        outs.append((got.out, _split_files(root), got.err))
    (jout, jfiles, jerr), (tout, tfiles, terr) = outs
    assert tout == jout
    assert tfiles == jfiles
    assert ("turning it off" in terr) == ("turning it off" in jerr)
    if "--split-output" in CASES[case]:
        assert len(tfiles) >= 2 and not tout
        if "--fails-as-input" in CASES[case]:
            assert any(k.startswith("nomapping") and k.endswith("fq")
                       for k in tfiles)
    else:
        assert tout
    if case.startswith("read group"):
        text = tout + "".join(tfiles.values())
        assert "@RG\tID:RG7" in text and "\tRG:Z:RG7" in text


@pytest.mark.parametrize("args,ends", [
    (["--fastq-id-start", "3", "--fastq-id-end", "2"], "se"),
    (["-J", "33", "--quality-protocol", "illumina"], "se"),
    (["-J", "64", "--quality-protocol", "sanger"], "pe")])
def test_cli_conflicts_exit_9(disk, capsys, args, ends):
    """--fastq-id-end below --fastq-id-start, and -J beside
    --quality-protocol: exit 9 in both packages, with nothing on standard
    output."""
    inputs = ([str(disk / "se.fq")] if ends == "se"
              else [str(disk / "p_1.fq"), str(disk / "p_2.fq")])
    full = ["-D", str(disk), "-d", "syn", "--gmap-mode", "none", *args,
            *inputs]
    assert jcli.main(full) == 9
    jax = capsys.readouterr()
    assert tcli.main(full + ["--device", "cpu"]) == 9
    port = capsys.readouterr()
    assert port.out == jax.out == ""
    assert port.err.splitlines()[0] == jax.err.splitlines()[0]


def _jax_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser, taken as its main() builds it."""
    class Got(Exception):
        pass

    def grab(self, *a, **k):
        raise Got(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jcli.main([])
    except Got as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real


def test_every_jax_option_accepted():
    """Every option string of the JAX CLI is an option of the port's
    parser, with the same destination, default, choices, type and
    argument count; the port adds --device alone.  Each parses with a
    value of its kind, and --version exits 0."""
    jp, tp = _jax_parser(), tcli._parser()
    jopts = {o: a for a in jp._actions for o in a.option_strings}
    topts = {o: a for a in tp._actions for o in a.option_strings}
    assert set(topts) - set(jopts) == {"--device"}
    assert len(jopts) > 100
    for opt, ja in jopts.items():
        ta = topts[opt]
        assert (ta.dest, ta.default, ta.choices, ta.type, ta.nargs,
                type(ta)) == (ja.dest, ja.default, ja.choices, ja.type,
                              ja.nargs, type(ja)), opt
        if isinstance(ja, (argparse._HelpAction, argparse._VersionAction)):
            with pytest.raises(SystemExit) as e:
                tp.parse_args([opt])
            assert e.value.code == 0
            continue
        base = ["-D", "x", "-d", "y"]
        if ja.nargs == 0:
            value = []
        elif ja.choices:
            value = [str(list(ja.choices)[-1])]
        elif ja.type in (int, float):
            value = ["-3" if opt in ("-j", "--trim-mismatch-score") else "3"]
        else:
            value = ["v"]
        args = tp.parse_args(base + [opt, *value, "in.fq"])
        ja_args = jp.parse_args(base + [opt, *value, "in.fq"])
        assert getattr(args, ta.dest) == getattr(ja_args, ja.dest), opt
