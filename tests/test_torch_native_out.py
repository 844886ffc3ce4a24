"""Port parity for GSNAP's native output (gsnap -A gsnap): single-end and
paired-end, -N 0 and -N 1, and under -v with --print-snps and
--show-refdiff, byte-equal to the JAX package's CLI on a database
directory that the port's own tools wrote (gmap_build, iit_store,
snpindex)."""

import os

import numpy as np
import pytest

from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.cli import iit_store as tiit_store
from gmap_gsnap_tpu_torch.cli import snpindex as tsnpindex
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, jax_runner_one_device, one_torch_thread

# read kinds of synth.plant_reads without repeat copies: reads that
# overflow a candidate budget would make the JAX runner compile its wide
# lanes for every configuration
SE_MIX = {"sub": 0.4, "n": 0.1, "mid_indel": 0.15, "end_indel": 0.1,
          "terminal": 0.1, "junk": 0.15}


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    rng = np.random.default_rng(53)
    g = synth.make_genome(rng, [160_000, 90_000, 50_000], repeat_copies=2)
    d = tmp_path_factory.mktemp("native")
    g.write_fasta(str(d / "g.fa"))
    assert tgmap_build.main(["-d", "syn", "--dir", str(d), "-k", "12",
                             str(d / "g.fa")]) == 0
    reads, _ = synth.plant_reads(rng, g, 48, weights=SE_MIX)
    sreads, _ = synth.plant_spliced_reads(rng, g, 24)
    vreads, _, (sp, sa) = synth.plant_snp_reads(rng, g, 16)
    synth.write_fastq(str(d / "se.fq"), reads + sreads + vreads)
    p1, p2, _ = synth.plant_pairs(rng, g, 40, rna=True)
    synth.write_fastq(str(d / "r_1.fq"), p1)
    synth.write_fastq(str(d / "r_2.fq"), p2)
    bp, ba = synth.random_snps(rng, g, 1 / 800)
    pos, first = np.unique(np.concatenate([sp, bp]), return_index=True)
    alt = np.concatenate([sa, ba])[first]
    (d / "snps.txt").write_text(synth.snps_text(g, pos, alt))
    # the map goes where gsnap looks for it: the database's maps folder
    maps = d / "syn" / "syn.maps"
    assert tiit_store.main(["-o", str(maps / "snps"),
                            str(d / "snps.txt")]) == 0
    assert tsnpindex.main(["-D", str(d), "-d", "syn", "-v", "snps",
                           str(maps / "snps.iit")]) == 0
    return d


@pytest.mark.parametrize("ends,extra", [
    ("se", ["-N", "0"]), ("se", ["-N", "1"]),
    ("pe", ["-N", "0"]), ("pe", ["-N", "1"]),
    ("se", ["-v", "snps", "--print-snps"]),
    ("pe", ["-v", "snps", "--print-snps"]),
    ("se", ["-v", "snps", "--show-refdiff"]),
    ("se", ["-v", "snps", "-N", "1", "--print-snps", "--show-refdiff"])])
def test_cli_native_byte_equal(disk, capsys, ends, extra):
    inputs = ([str(disk / "se.fq")] if ends == "se"
              else [str(disk / "r_1.fq"), str(disk / "r_2.fq")])
    args = ["-D", str(disk), "-d", "syn", "-A", "gsnap", "--gmap-mode",
            "none", "--batch-size", "48", *extra, *inputs]
    if "--show-refdiff" in extra:
        args[4:4] = ["-V", str(disk / "syn")]
    assert jcli.main(args) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    heads = [l for l in port_out.splitlines() if l[:1] in (">", "<")]
    assert len(heads) == (88 if ends == "se" else 80)
    assert not port_out.startswith("@")       # no SAM header
    if ends == "pe":
        assert " concordant\t" in port_out
    if "-N" in extra and extra[extra.index("-N") + 1] == "1":
        assert "donor:" in port_out and "acceptor:" in port_out
    if "--print-snps" in extra and ends == "se":   # the SNP-heavy reads
        assert "snps:" in port_out


def test_cli_native_gmap_lanes(disk, capsys):
    """-A gsnap with gsnap's default GMAP lanes (-N 1): rescued hits
    print with method:gmap where a lane converts one."""
    args = ["-D", str(disk), "-d", "syn", "-A", "gsnap", "-N", "1",
            "--batch-size", "96", str(disk / "se.fq")]
    assert jcli.main(args) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    assert jax_out.count("\n>") + 1 == 88
