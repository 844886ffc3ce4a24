"""Port parity for the slice as a whole: GsnapRunner.run and the gsnap
CLI (single-end, -N 0, --gmap-mode none; three input files read as one
stream) against the JAX package on synthetic reads — SAM and native
output byte-equal — plus the port's refusal of a missing card, its own
database loader against the JAX package's, and a run in a process where neither
JAX nor the JAX package can be imported (SE -N 0, SE -N 1 and PE -N 1,
with the default GMAP lanes)."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu.db import datadir as jdatadir
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.db import datadir as tdatadir
from gmap_gsnap_tpu_torch.utils import device as tdevice
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import jax_db, jax_runner_one_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = dict(sub=4, n=1, mid_indel=1.5, end_indel=1.5, terminal=1.5,
             repeat=1.5, junk=0.5)


def _reads(rng, genome, n):
    recs, _ = synth.plant_reads(rng, genome, n, weights=KINDS)
    return [r if i % 7 else dataclasses.replace(
        r, seq=r.seq[: 60 + i % 40], quality=r.quality[: 60 + i % 40])
        for i, r in enumerate(recs)]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)     # the no-JAX subprocess rebuilds g
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    return g, synth.genome_db(g, 12, 3), _reads(rng, g, 200)


def test_runner_sam_byte_equal(world, monkeypatch):
    g, db, recs = world
    jout = io.StringIO()
    jrun.GsnapRunner(jax_db(db), params=jse.GsnapParams(gmap_mode="")).run(
        recs, jout, batch_size=64)

    seen = {"wide": 0, "end_indel": 0, "terminal": 0}
    runner = trun.GsnapRunner(db, params=tse.GsnapParams(gmap_mode=""),
                              device="cpu")
    wide, ends, terms = (runner._dispatch_wide, runner._end_indel_hits,
                         trun.rescue.make_terminals)

    def spy_wide(*a, **k):
        seen["wide"] += 1
        return wide(*a, **k)

    def spy_ends(*a, **k):
        out = ends(*a, **k)
        seen["end_indel"] += len(out)
        return out

    def spy_terms(*a, **k):
        out = terms(*a, **k)
        seen["terminal"] += len(out)
        return out

    monkeypatch.setattr(runner, "_dispatch_wide", spy_wide)
    monkeypatch.setattr(runner, "_end_indel_hits", spy_ends)
    monkeypatch.setattr(trun.rescue, "make_terminals", spy_terms)
    tout = io.StringIO()
    assert runner.run(recs, tout, batch_size=64) == len(recs)
    assert tout.getvalue() == jout.getvalue()
    # the wide (overflow), end-indel and terminal lanes all ran
    assert min(seen.values()) > 0, seen
    cigars = [l.split("\t")[5] for l in tout.getvalue().splitlines()
              if not l.startswith("@")]
    assert any("I" in c for c in cigars) and any("D" in c for c in cigars)
    assert any("S" in c for c in cigars) and "*" in cigars


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    g, _, recs = world
    d = tmp_path_factory.mktemp("db")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), recs[:120])
    return d


def test_cli_byte_equal(disk_db, capsys):
    args = ["-D", str(disk_db), "-d", "syn", "--gmap-mode", "none",
            "--batch-size", "64", str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert port_sam.count("\n") > 120


@pytest.mark.parametrize("flag,value,field", [
    ("--trigger-score-for-gmap", "3", "trigger_score_for_gmap"),
    ("--max-gmap-improvement", "2", "max_gmap_improvement"),
    ("--gmap-min-coverage", "0.8", "gmap_min_coverage"),
    ("--microexon-spliceprob", "0.5", "microexon_spliceprob"),
    ("--antistranded-penalty", "2", "antistranded_penalty")])
def test_cli_gmap_tuning_flags_byte_equal(disk_db, capsys, monkeypatch, flag,
                                          value, field):
    """The five GMAP tuning flags of the JAX CLI, at values other than
    their defaults: the port's CLI takes them into GsnapParams, and its
    output (SAM, or -A gsnap for the last) equals the JAX CLI's."""
    native = ["-A", "gsnap"] if field == "antistranded_penalty" else []
    args = ["-D", str(disk_db), "-d", "syn", "--gmap-mode", "none",
            "--batch-size", "64", flag, value, *native,
            str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_out = capsys.readouterr().out
    seen = []

    class Spy(trun.GsnapRunner):
        def __init__(self, db, params, **kw):
            seen.append(params)
            super().__init__(db, params, **kw)

    monkeypatch.setattr(trun, "GsnapRunner", Spy)
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    assert jax_out.count("\n") > 120
    assert getattr(seen[0], field) == type(getattr(seen[0], field))(value)


@pytest.mark.parametrize("extra", [
    ["-A", "gsnap", "SECOND_FILE", "SECOND_FILE"],
    ["SECOND_FILE", "SECOND_FILE"]])
def test_cli_rejects_unported(disk_db, capsys, extra):
    """Three input files, which the port once refused, are read as one
    single-end stream, as the JAX CLI reads them: its output, SAM or
    native, byte-equal to the JAX CLI's."""
    fq = str(disk_db / "reads.fq")
    args = ["-D", str(disk_db), "-d", "syn", "--gmap-mode", "none",
            "--batch-size", "64"]
    files = [fq] + [fq for e in extra if e == "SECOND_FILE"]
    args += [e for e in extra if e != "SECOND_FILE"] + files
    # the JAX runner on one device: on the conftest's 8-device mesh, its
    # SAM path aborted in compact_se on these 360 reads
    with jax_runner_one_device():
        assert jcli.main(args) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    blocks = (jax_out.count("\n>") + jax_out.startswith(">") if "-A" in extra
              else sum(not l.startswith("@") and int(l.split("\t")[1]) & 0x900
                       == 0 for l in jax_out.splitlines()))
    assert blocks == 3 * 120


def test_runner_rejects_unported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")


def test_loaders_agree(disk_db):
    """One database directory opened by the JAX package's GenomeDB and
    by the port's copy gives the same arrays."""
    j = jdatadir.GenomeDB.open(str(disk_db), "syn")
    t = tdatadir.GenomeDB.open(str(disk_db), "syn")
    for name in ("codes", "flags", "chr_starts", "chr_ends", "offsets",
                 "positions"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (t.chr_names, t.k, t.interval, t.basesize) == (
        j.chr_names, j.k, j.interval, j.basesize)
    assert t.genome_str[5:60] == j.genome_str[5:60]


_NO_JAX = textwrap.dedent("""
    import io, json, sys
    sys.modules["jax"] = None            # any import of jax now fails,
    sys.modules["gmap_gsnap_tpu"] = None  # and of the JAX package
    sys.path.insert(0, {repo!r})
    import numpy as np
    from gmap_gsnap_tpu_torch.align import gsnap_se, runner
    from gmap_gsnap_tpu_torch.cli import gsnap as cli
    from gmap_gsnap_tpu_torch.io.fasta import Record
    from gmap_gsnap_tpu_torch.utils import synth

    seen = {{"terminal": 0, "fallback_trims": 0, "gmap": 0}}
    make_terminals, trim_ends = runner.rescue.make_terminals, runner.trim_ends
    def spy_terms(*a, **k):
        out = make_terminals(*a, **k)
        seen["terminal"] += len(out)
        return out
    def spy_trims(mm, trim_mismatch_score=-3):
        seen["fallback_trims"] += 1
        return trim_ends(mm, trim_mismatch_score)
    runner.rescue.make_terminals = spy_terms
    runner.trim_ends = spy_trims
    path_to_hit = runner.GsnapRunner._gmap_path_to_hit
    def spy_gmap(self, rec, path):
        h = path_to_hit(self, rec, path)
        seen["gmap"] += h is not None
        return h
    runner.GsnapRunner._gmap_path_to_hit = spy_gmap
    recs = [Record(*l.split("\\t")) for l in open({reads!r}).read().splitlines()]
    g = synth.make_genome(np.random.default_rng(11), [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    out = io.StringIO()
    p = gsnap_se.GsnapParams(trim_mismatch_score=-2)
    runner.GsnapRunner(db, p, device="cpu").run(recs, out, batch_size=64)
    open({sam!r}, "w").write(out.getvalue())
    srecs, _ = synth.plant_spliced_reads(np.random.default_rng(5), g, 48)
    out = io.StringIO()
    runner.GsnapRunner(db, novelsplicing=True, device="cpu").run(
        srecs, out, batch_size=48)
    open({sam_n1!r}, "w").write(out.getvalue())
    p1, p2, _ = synth.plant_pairs(np.random.default_rng(9), g, 40, rna=True)
    out = io.StringIO()
    runner.GsnapRunner(db, novelsplicing=True, device="cpu").run_pe(
        p1, p2, out, batch_size=40)
    open({sam_pe!r}, "w").write(out.getvalue())
    assert cli.main(["-D", {dbdir!r}, "-d", "syn", "--device", "cpu",
                     {fastq!r}]) == 0
    leaked = [m for m in sys.modules if m == "jaxlib" or m.startswith(
        ("jax.", "jaxlib.", "gmap_gsnap_tpu."))]
    assert sys.modules["jax"] is None and not leaked, leaked
    assert sys.modules["gmap_gsnap_tpu"] is None
    print(json.dumps(seen), file=sys.stderr)
""")


def test_runs_without_jax(world, disk_db, tmp_path):
    """The port imports no JAX and nothing of the JAX package, even
    transitively; the terminal lane runs, here with a non-default trim
    score so the lane's trims come from make_terminals' fallback (the
    port runner's trim_ends); the GMAP lanes run (default --gmap-mode);
    and an -N 1 batch of spliced reads and a PE -N 1 batch of read pairs
    run too."""
    g, db, recs = world
    sub = recs[:100]
    (tmp_path / "reads.tsv").write_text("".join(
        f"{r.label}\t{r.header}\t{r.seq}\t{r.quality}\n" for r in sub))
    script = _NO_JAX.format(repo=REPO, reads=str(tmp_path / "reads.tsv"),
                            sam=str(tmp_path / "port.sam"),
                            sam_n1=str(tmp_path / "port_n1.sam"),
                            sam_pe=str(tmp_path / "port_pe.sam"),
                            dbdir=str(disk_db), fastq=str(disk_db / "reads.fq"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stderr.strip().splitlines()[-1])
    assert min(seen.values()) > 0, seen
    assert proc.stdout.startswith("@SQ")

    jout = io.StringIO()
    jrun.GsnapRunner(jax_db(db), params=jse.GsnapParams(
        trim_mismatch_score=-2)).run(sub, jout, batch_size=64)
    assert (tmp_path / "port.sam").read_text() == jout.getvalue()

    srecs, _ = synth.plant_spliced_reads(np.random.default_rng(5), g, 48)
    jout = io.StringIO()
    jrun.GsnapRunner(jax_db(db), novelsplicing=True).run(srecs, jout,
                                                         batch_size=48)
    n1 = (tmp_path / "port_n1.sam").read_text()
    cigars = [l.split("\t")[5] for l in n1.splitlines() if l[0] != "@"]
    assert n1 == jout.getvalue() and any("N" in c for c in cigars)

    p1, p2, _ = synth.plant_pairs(np.random.default_rng(9), g, 40, rna=True)
    jout = io.StringIO()
    jrun.GsnapRunner(jax_db(db), novelsplicing=True).run_pe(p1, p2, jout,
                                                            batch_size=40)
    pe = (tmp_path / "port_pe.sam").read_text()
    flags = [int(l.split("\t")[1]) for l in pe.splitlines() if l[0] != "@"]
    assert pe == jout.getvalue() and any(f & 0x2 for f in flags)
