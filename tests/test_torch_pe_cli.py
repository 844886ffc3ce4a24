"""Port parity for the paired-end gsnap CLI: both input forms (two FASTQ
files, one paired FASTA) and the PE flags (-N 1, -o RF, --clip-overlap,
-a) byte-equal to the JAX package's CLI."""

import numpy as np
import pytest

from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu.io.fasta import Record
from gmap_gsnap_tpu.utils import dna
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth

# Illumina TruSeq adapters, read into when a fragment is shorter than a read
ADAPTER1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCACATCACGATCTCGTATGCCGTCTTCTGCTTG"
ADAPTER2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATTAAAAAA"


def _short_fragments(rng, g, n, lo, hi, L=100, prefix="a"):
    """Pairs of fragments of lo-hi nt: below L each read runs into its
    adapter (what -a detects and chops); between L and 2L the reads
    overlap (what --clip-overlap clips)."""
    r1, r2 = [], []
    for i in range(n):
        m = int(rng.integers(lo, hi + 1))
        p = int(rng.integers(1_000, int(g.chr_ends[0]) - 1_000))
        frag = g.ascii[p : p + m].tobytes().decode()
        name = f"{prefix}{i}"
        qual = "I" * L
        r1.append(Record(name, name, (frag + ADAPTER1)[:L], qual))
        r2.append(Record(name, name,
                         (dna.revcomp_str(frag) + ADAPTER2)[:L], qual))
    return r1, r2


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    rng = np.random.default_rng(43)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    d = tmp_path_factory.mktemp("pe")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    r1, r2, _ = synth.plant_pairs(rng, g, 72, rna=True)
    a1, a2 = _short_fragments(rng, g, 8, 24, 36)
    o1, o2 = _short_fragments(rng, g, 8, 120, 190, prefix="o")
    r1, r2 = r1 + a1 + o1, r2 + a2 + o2
    synth.write_fastq(str(d / "r_1.fq"), r1)
    synth.write_fastq(str(d / "r_2.fq"), r2)
    with open(d / "r.fa", "w") as f:
        for a, b in zip(r1, r2):
            f.write(f">{a.header}\n{a.seq}\n{b.seq}\n")
    return d


@pytest.mark.parametrize("form,extra", [
    ("fastq", []), ("fasta", []), ("fastq", ["-N", "1"]),
    ("fastq", ["-o", "RF"]), ("fastq", ["--clip-overlap"]),
    ("fastq", ["-a", "paired"])])
def test_cli_pe_byte_equal(disk, capsys, monkeypatch, form, extra):
    inputs = ([str(disk / "r_1.fq"), str(disk / "r_2.fq")] if form == "fastq"
              else [str(disk / "r.fa")])
    args = ["-D", str(disk), "-d", "syn", "--gmap-mode", "none",
            "--batch-size", "48", *extra, *inputs]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    chops = []
    chop = trun.chop_primers
    monkeypatch.setattr(trun, "chop_primers",
                        lambda *a: chops.append(chop(*a)) or chops[-1])
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    recs = [l.split("\t") for l in port_sam.splitlines() if l[0] != "@"]
    assert len({f[0] for f in recs}) == 88
    flags = [int(f[1]) for f in recs]
    assert all(f & 0x1 for f in flags) and any(f & 0x2 for f in flags)
    if "-a" in extra:
        assert sum(c > 0 for c in chops) >= 4, chops
    if "--clip-overlap" in extra:
        assert any("H" in f[5] for f in recs)
    if form == "fasta":
        assert {f[10] for f in recs} == {"*"}
