"""Port parity for the tools around the aligner: the nine annotation
extractors (gtf / gff3 / psl x genes / introns / splicesites) and
dbsnp_iit on annotation text written here, iit_get and iit_dump on maps
the port's iit_store wrote, get_genome at -f 1, 2 and 3 over a SNP
database the port's snpindex wrote, uniqscan (prefixes and -3 suffixes,
--device cpu) and utils/stats, each byte-equal (or, for stats,
bit-equal) to the JAX package's on the same inputs."""

import io

import numpy as np
import pytest

from gmap_gsnap_tpu.cli import uniqscan as juniqscan
from gmap_gsnap_tpu.utils import stats as jstats
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import iit_store as tiit_store
from gmap_gsnap_tpu_torch.cli import snpindex as tsnpindex
from gmap_gsnap_tpu_torch.cli import uniqscan as tuniqscan
from gmap_gsnap_tpu_torch.utils import stats as tstats
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread)

EXTRACTORS = [f"{a}_{b}" for a in ("gtf", "gff3", "psl")
              for b in ("genes", "introns", "splicesites")]

GTF = """\
# a comment line
chr1\tsrc\tgene\t100\t900\t.\t+\t.\tgene_id "g1";
chr1\tsrc\texon\t100\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1"; gene_name "ALPHA";
chr1\tsrc\texon\t400\t500\t.\t+\t.\tgene_id "g1"; transcript_id "t1"; gene_name "ALPHA";
chr1\tsrc\texon\t800\t900\t.\t+\t.\tgene_id "g1"; transcript_id "t1"; gene_name "ALPHA";
chr1\tsrc\texon\t100\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t2";
chr1\tsrc\texon\t800\t950\t.\t+\t.\tgene_id "g1"; transcript_id "t2";
chr1\tsrc\tCDS\t150\t200\t.\t+\t0\tgene_id "g1"; transcript_id "t1";
chr2\tsrc\texon\t5000\t5100\t.\t-\t.\tgene_id "g2"; transcript_id "t3"; gene_name "BETA";
chr2\tsrc\texon\t3000\t3200\t.\t-\t.\tgene_id "g2"; transcript_id "t3"; gene_name "BETA";
chr2\tsrc\texon\t1000\t1300\t.\t-\t.\tgene_id "g2"; transcript_id "t3"; gene_name "BETA";
chr2\tsrc\texon\t7000\t7100\t.\t+\t.\tgene_id "g3"; transcript_id "t4";
short\tline
"""

GFF3 = """\
##gff-version 3
chr1\tsrc\tgene\t100\t900\t.\t+\t.\tID=gene1;Name=ALPHA
chr1\tsrc\tmRNA\t100\t900\t.\t+\t.\tID=rna1;Parent=gene1
chr1\tsrc\texon\t100\t200\t.\t+\t.\tID=e1;Parent=rna1
chr1\tsrc\texon\t400\t500\t.\t+\t.\tID=e2;Parent=rna1,rna2
chr1\tsrc\texon\t800\t900\t.\t+\t.\tID=e3;Parent=rna1
chr1\tsrc\ttranscript\t400\t950\t.\t+\t.\tID=rna2;Parent=gene1
chr1\tsrc\texon\t850\t950\t.\t+\t.\tParent=rna2
chr2\tsrc\tmRNA\t1000\t5100\t.\t-\t.\tID=rna3;Parent=gene2
chr2\tsrc\texon\t5000\t5100\t.\t-\t.\tParent=rna3
chr2\tsrc\texon\t1000\t1300\t.\t-\t.\tParent=rna3
chr2\tsrc\texon\t7000\t7100\t.\t+\t.\tParent=orphan
chr2\tsrc\texon\t7300\t7400\t.\t+\t.\tID=noparent
"""

PSL = """\
NM_1\tchr1\t+\t99\t900\t150\t850\t3\t99,399,799,\t200,500,900,
NM_2\tchr2\t-\t999\t5100\t1100\t5000\t3\t999,2999,4999,\t1300,3200,5100,
NM_3\tchr2\t+\t6999\t7100\t6999\t7100\t1\t6999,\t7100,
NM_4\tchr2\t+\t10\t20\t10\t20\t2\t10,\t20,
bad\tline
"""

DBSNP = "\n".join("\t".join(row) for row in [
    # bin chrom start end name score strand refNCBI refUCSC observed
    # molType class valid avHet avHetSE func locType weight [exceptions]
    ["0", "chr1", "99", "100", "rs1", "0", "+", "A", "A", "A/G", "genomic",
     "single", "x", "0", "0", "x", "exact", "1"],
    ["0", "chr1", "199", "200", "rs2", "0", "-", "C", "C", "C/T", "genomic",
     "single", "x", "0", "0", "x", "exact", "1"],
    ["0", "chr1", "299", "300", "rs3", "0", "+", "G", "G", "G/T", "genomic",
     "single", "x", "0", "0", "x", "exact", "3"],
    ["0", "chr2", "49", "50", "rs4", "0", "+", "T", "T", "T/C", "genomic",
     "single", "x", "0", "0", "x", "exact", "2"],
    ["0", "chr2", "59", "60", "rs5", "0", "+", "T", "T", "T/CA", "genomic",
     "single", "x", "0", "0", "x", "exact", "1"],
    ["0", "chr2", "69", "70", "rs6", "0", "+", "T", "T", "T/G", "genomic",
     "mnp", "x", "0", "0", "x", "exact", "1"],
    ["0", "chr2", "79", "80", "rs7", "0", "+", "T", "T", "A/G", "genomic",
     "single", "x", "0", "0", "x", "exact", "1", "SingleClassZeroSpan"],
    ["0", "chr2", "89", "90", "rs8", "0", "+", "T", "T", "N/G", "genomic",
     "single", "x", "0", "0", "x", "exact", "1"],
    ["0", "chr2", "99", "100", "rs9", "0", "+", "T", "T", "G/A", "genomic",
     "single", "x", "0", "0", "x", "exact", "x"],
    ["short", "row"]]) + "\n"


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    d = tmp_path_factory.mktemp("annot")
    for name, text in (("a.gtf", GTF), ("a.gff3", GFF3), ("a.psl", PSL),
                       ("snp.txt", DBSNP)):
        (d / name).write_text(text)
    return d


def _both(capsys, name, args, stdin=None, monkeypatch=None):
    """(JAX tool's standard output, the port's) for cli.<name> args."""
    import importlib

    outs = []
    for pkg in ("gmap_gsnap_tpu", "gmap_gsnap_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.cli.{name}")
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        assert mod.main(list(args)) == 0
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("name", EXTRACTORS)
def test_extractors_byte_equal(texts, capsys, name):
    kind = name.split("_")[0]
    j, t = _both(capsys, name, [str(texts / f"a.{kind}")])
    assert t == j and t.startswith(">")


@pytest.mark.parametrize("name", ["gtf_genes", "gff3_splicesites",
                                  "psl_introns"])
def test_extractors_stdin_byte_equal(texts, capsys, monkeypatch, name):
    kind = name.split("_")[0]
    text = (texts / f"a.{kind}").read_text()
    j, t = _both(capsys, name, [], stdin=text, monkeypatch=monkeypatch)
    assert t == j and t.startswith(">")


@pytest.mark.parametrize("args", [[], ["-w", "3"], ["-c", "chr2", "-w", "2"]])
def test_dbsnp_iit_byte_equal(texts, capsys, args):
    j, t = _both(capsys, "dbsnp_iit", args + [str(texts / "snp.txt")])
    assert t == j and t.startswith(">")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 200 kbp genome (four repeat copies) built by the port's
    gmap_build, and a SNP map and its SNP database (iit_store,
    snpindex)."""
    rng = np.random.default_rng(97)
    d = tmp_path_factory.mktemp("tools")
    g = synth.make_genome(rng, [120_000, 80_000], repeat_copies=4)
    g.write_fasta(str(d / "g.fa"))
    assert tgmap_build.main(["-d", "syn", "--dir", str(d), "-k", "12",
                             str(d / "g.fa")]) == 0
    pos, alt = synth.random_snps(rng, g, 1 / 200)
    (d / "snps.txt").write_text(synth.snps_text(g, pos, alt))
    maps = d / "syn" / "syn.maps"
    assert tiit_store.main(["-o", str(maps / "snps"),
                            str(d / "snps.txt")]) == 0
    assert tsnpindex.main(["-D", str(d), "-d", "syn", "-v", "snps",
                           str(maps / "snps.iit")]) == 0
    return dict(d=d, g=g, maps=maps)


def test_iit_tools_byte_equal(world, capsys):
    """iit_get over coordinates, a range, a division range and a label-less
    point, and iit_dump, on the SNP map and a map with two divisions."""
    d, maps = world["d"], world["maps"]
    (d / "ann.txt").write_text(
        ">a1 chr1:100..200 exon\nline one\n>a2 chr1:500..300\n"
        ">a3 chr2:10..20 tag rest of header\nx\ny\n>a4 chr2:15..15\n")
    assert tiit_store.main(["-o", str(d / "ann"), str(d / "ann.txt")]) == 0
    for path, queries in (
            (maps / "snps.iit", [["chr1:1..5000"], ["chr2:100..90000"],
                                 ["chr1:1..120000"]]),
            (d / "ann.iit", [["chr1:150..350"], ["chr2:12..16"],
                             ["chr2:16..30"], ["chr1:250..260"]])):
        for q in queries:
            j, t = _both(capsys, "iit_get", [str(path), *q])
            assert t == j, q
        j, t = _both(capsys, "iit_dump", [str(path)])
        assert t == j and t.count(">") >= 4


@pytest.mark.parametrize("args", [
    ["chr1:1001..1250"], ["chr2:3000..2500"], ["1..130"],
    ["-v", "snps", "-f", "1", "chr1:2001..2600"],
    ["-v", "snps", "-f", "2", "chr1:2001..2600"],
    ["-v", "snps", "-f", "3", "chr2:9000..8001"],
    ["-v", "snps", "-f", "3", "chr1:50001..50123"],
    ["-v", "snps", "-f", "0", "chr1:10..100"]])
def test_get_genome_byte_equal(world, capsys, args):
    j, t = _both(capsys, "get_genome",
                 ["-D", str(world["d"]), "-d", "syn", *args])
    assert t == j and t.startswith(">")
    if "-f" in args and args[args.index("-f") + 1] == "3":
        assert "\nalt\t" in t


@pytest.mark.parametrize("suffix", [False, True])
def test_uniqscan_byte_equal(world, capsys, suffix):
    """uniqscan on a 130 nt sequence that starts (or, with -3, ends) on a
    repeat copy: its short prefixes (suffixes) align to several copies,
    longer ones to one; the port's --device cpu prints the JAX tool's
    lines.  (Past ~138 nt the JAX package's small-genome seed path fails
    its slot assertion on this 200 kbp genome.)"""
    g = world["g"]
    p = int(g.repeats[1])
    seq = g.ascii[p - 50 : p + 80] if suffix else g.ascii[p + 300 : p + 430]
    seq = seq.tobytes().decode()
    args = ["-D", str(world["d"]), "-d", "syn", *(["-3"] if suffix else []),
            seq]
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        assert juniqscan.main(args) == 0
        j = capsys.readouterr().out
        assert tuniqscan.main(args + ["--device", "cpu"]) == 0
        t = capsys.readouterr().out
    assert t == j
    counts = [int(l.split(": ")[1]) for l in t.splitlines()]
    assert counts[0] > 1 and counts[-1] <= 1 and len(counts) >= 2


def test_uniqscan_short_and_no_card(world, capsys, monkeypatch):
    """A sequence shorter than k + 2 prints nothing; without a card the
    default device exits 2 naming it."""
    args = ["-D", str(world["d"]), "-d", "syn", "ACGTACGTAC"]
    assert tuniqscan.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert tuniqscan.main(args) == 2
    assert "cuda" in capsys.readouterr().err


def test_stats_bit_equal():
    """pbinom, betainc and orderstat_pct of the port bit-equal to the JAX
    package's over random arguments, edges included."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        n = int(rng.integers(1, 400))
        k = int(rng.integers(-2, n + 3))
        th = float(rng.random())
        assert tstats.pbinom(k, n, th) == jstats.pbinom(k, n, th)
        a, b = float(rng.random() * 50 + 0.1), float(rng.random() * 50 + 0.1)
        x = float(rng.choice([0.0, 1.0, rng.random()]))
        assert tstats.betainc(a, b, x) == jstats.betainc(a, b, x)
    for n in (1, 2, 7, 100):
        v = rng.integers(0, 1000, n)
        for pct in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert tstats.orderstat_pct(v, pct) == jstats.orderstat_pct(
                v, pct)
    with pytest.raises(ValueError):
        tstats.orderstat_pct([], 0.5)
