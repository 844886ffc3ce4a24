"""Port parity for BASELINE config 4, known splice sites together with
SNP-tolerant alignment (gsnap -s ... -v ...), against the JAX package on
a synthetic genome: GsnapRunner.run / run_pe at -N 0 and -N 1 (the -N 1
pairs with gsnap's default GMAP lanes), both gsnap CLIs with -s,
--splicingdir, -v and -V, and a -s -v -N 1 run in a process where
neither JAX nor the JAX package can be imported."""

import io
import os
import subprocess
import sys
import textwrap

import pytest

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_db, jax_runner_one_device,
                          one_torch_thread, runner_params, site_snp_world)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return site_snp_world(tmp_path_factory.mktemp("sites_snps"))


def _runners(world, novel, **changes):
    db, d = world["db"], world["dir"]
    kw = dict(novelsplicing=novel, splicesdb=os.path.join(d, "sites.iit"),
              snpsdb="snps", snps_dir=d)
    return (jrun.GsnapRunner(jax_db(db), runner_params(jse, db, **changes),
                             **kw),
            trun.GsnapRunner(db, runner_params(tse, db, **changes),
                             device="cpu", **kw))


@pytest.mark.parametrize("novel", [False, True])
def test_run_sam_sites_and_snps(world, novel):
    """SE and PE SAM byte-equal under -s -v at -N 0 and -N 1, with and
    without --ambig-splice-noclip (PE at -N 1 with the default GMAP
    lanes: pairsearch still runs under -s/-v); SNP-heavy reads placed,
    short-end reads spliced, inside-ambiguous pairs resolved."""
    p1, p2 = world["pairs"]
    jr, tr = _runners(world, novel)
    for amb_clip in (True, False):
        jr.amb_clip = tr.amb_clip = amb_clip
        jo, to = io.StringIO(), io.StringIO()
        jr.run(world["reads"], jo, batch_size=256)
        tr.run(world["reads"], to, batch_size=256)
        assert to.getvalue() == jo.getvalue(), amb_clip
    recs = [l.split("\t") for l in to.getvalue().splitlines() if l[0] != "@"]
    snp = [f for f in recs if f[0][0] == "v" and not int(f[1]) & 0x100]
    assert len(snp) == len(world["snp_reads"]) and all(f[2] != "*"
                                                       for f in snp)
    assert any(f[0][0] == "k" and "N" in f[5] for f in recs)
    if not novel:
        jr, tr = _runners(world, novel, gmap_mode="")
    for amb_clip in (True, False):
        jr.amb_clip = tr.amb_clip = amb_clip
        tr.ambi_resolved = 0
        jo, to = io.StringIO(), io.StringIO()
        jr.run_pe(p1, p2, jo, batch_size=128)
        tr.run_pe(p1, p2, to, batch_size=128)
        assert to.getvalue() == jo.getvalue(), amb_clip
        assert (tr.ambi_resolved > 0) == amb_clip


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    d = tmp_path_factory.mktemp("db")
    world["genome"].write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), world["reads"])
    return d


def test_cli_sites_and_snps(world, disk_db, capsys):
    """The CLIs with -s <name> --splicingdir D -v <name> -V D, -N 1:
    byte-equal SAM."""
    args = ["-D", str(disk_db), "-d", "syn", "-N", "1", "-s", "sites",
            "--splicingdir", world["dir"], "-v", "snps", "-V", world["dir"],
            "--gmap-mode", "none", "--batch-size", "256",
            str(disk_db / "reads.fq")]
    # the SNP index files carry the database name of their directory
    for f in os.listdir(world["dir"]):
        if f.startswith("synthetic.") and f.endswith(".snps"):
            target = os.path.join(world["dir"], "syn" + f[len("synthetic"):])
            if not os.path.exists(target):
                os.symlink(os.path.join(world["dir"], f), target)
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert any("N" in l.split("\t")[5] for l in port_sam.splitlines()
               if l[0] != "@")


_NO_JAX = textwrap.dedent("""
    import io, sys
    sys.modules["jax"] = None            # any import of jax now fails,
    sys.modules["gmap_gsnap_tpu"] = None  # and of the JAX package
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(1)
    from gmap_gsnap_tpu_torch.align import runner
    from torch_parity import site_snp_world
    w = site_snp_world({d!r})
    r = runner.GsnapRunner(w["db"], novelsplicing=True,
                           splicesdb={d!r} + "/sites.iit", snpsdb="snps",
                           snps_dir={d!r}, device="cpu")
    out = io.StringIO()
    r.run(w["reads"], out, batch_size=256)
    p1, p2 = w["pairs"]
    r.run_pe(p1, p2, out, batch_size=128)
    open({sam!r}, "w").write(out.getvalue())
    leaked = [m for m in sys.modules if m == "jaxlib" or m.startswith(
        ("jax.", "jaxlib.", "gmap_gsnap_tpu."))]
    assert sys.modules["jax"] is None and not leaked, leaked
    assert sys.modules["gmap_gsnap_tpu"] is None
    print(r.ambi_resolved, file=sys.stderr)
""")


def test_sites_and_snps_run_without_jax(world, tmp_path):
    """-s -v -N 1 (SE, then PE with the default GMAP lanes) in a process
    that cannot import JAX or the JAX package (the test world is rebuilt
    there from its seed): the SAM equals the JAX runner's."""
    d = tmp_path / "w"
    d.mkdir()
    script = _NO_JAX.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                            d=str(d), sam=str(tmp_path / "port.sam"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stderr.strip().splitlines()[-1]) > 0
    jr, _ = _runners(world, True)
    out = io.StringIO()
    jr.run(world["reads"], out, batch_size=256)
    p1, p2 = world["pairs"]
    jr.run_pe(p1, p2, out, batch_size=128)
    assert (tmp_path / "port.sam").read_text() == out.getvalue()
