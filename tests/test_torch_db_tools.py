"""Port parity for the database tools: gmap_build, gmapindex (build, -C
compress, -U uncompress), fa_coords, gmap_process, iit_store and snpindex
write the same bytes as the JAX package's tools on synthetic multi-record
FASTA (N runs, lowercase, several chromosomes), flat (k=12) and gamma
(k=8, basesize 6); the C Elias-gamma coder equals the Python loops."""

import io
import os
import pathlib
import sys

import numpy as np
import pytest

from gmap_gsnap_tpu.cli import fa_coords as jfa_coords
from gmap_gsnap_tpu.cli import gmap_build as jgmap_build
from gmap_gsnap_tpu.cli import gmap_process as jgmap_process
from gmap_gsnap_tpu.cli import gmapindex as jgmapindex
from gmap_gsnap_tpu.cli import iit_store as jiit_store
from gmap_gsnap_tpu.cli import snpindex as jsnpindex
from gmap_gsnap_tpu_torch import native
from gmap_gsnap_tpu_torch.cli import fa_coords as tfa_coords
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import gmap_process as tgmap_process
from gmap_gsnap_tpu_torch.cli import gmapindex as tgmapindex
from gmap_gsnap_tpu_torch.cli import iit_store as tiit_store
from gmap_gsnap_tpu_torch.cli import snpindex as tsnpindex
from gmap_gsnap_tpu_torch.db import build as tbuild
from gmap_gsnap_tpu_torch.db import datadir as tdatadir
from gmap_gsnap_tpu_torch.db import indexdb as tindexdb
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import fresh_jax_caches, jax_runner_one_device, one_torch_thread

SETTINGS = [("12", None), ("8", "6")]   # (k, basesize): flat, gamma


def _fasta_text(rng) -> str:
    """Three records of 9-31 kbp: random bases with lowercase stretches,
    N runs (one at a record's start) and an IUPAC letter, 60 or 70 a
    line."""
    out = []
    for ci, n in enumerate((31_000, 17_500, 9_001)):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        for _ in range(3):
            a = int(rng.integers(0, n - 500))
            seq[a : a + int(rng.integers(20, 400))] += 32   # lowercase
        for a in (0, int(rng.integers(100, n - 200))) if ci == 1 else (
                int(rng.integers(100, n - 200)),):
            seq[a : a + int(rng.integers(5, 120))] = ord("N")
        seq[int(rng.integers(0, n))] = ord("R")
        text = seq.tobytes().decode()
        w = 60 if ci % 2 == 0 else 70
        out.append(f">chr{ci + 1} a description\n")
        out += [text[i : i + w] + "\n" for i in range(0, n, w)]
    return "".join(out)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("fa")
    p = d / "g.fa"
    p.write_text(_fasta_text(np.random.default_rng(71)))
    return str(p)


def _tree(d):
    return {os.path.relpath(os.path.join(r, f), d):
            pathlib.Path(r, f).read_bytes()
            for r, _, fs in os.walk(d) for f in fs}


def _same_dirs(a, b, nfiles):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert len(ta) == nfiles, sorted(ta)
    for name in ta:
        assert ta[name] == tb[name], name


@pytest.mark.parametrize("k,basesize", SETTINGS)
@pytest.mark.parametrize("tool", ["gmap_build", "gmapindex"])
def test_build_byte_equal(tmp_path, fasta, tool, k, basesize):
    """The whole database directory, flat and gamma offsets."""
    mods = {"gmap_build": (jgmap_build, tgmap_build),
            "gmapindex": (jgmapindex, tgmapindex)}[tool]
    for sub, mod in zip(("jax", "port"), mods):
        dest = str(tmp_path / sub)
        os.makedirs(dest)
        args = (["-d", "syn", "-D" if tool == "gmapindex" else "--dir", dest,
                 "-k", k] + (["-b", basesize] if basesize else []))
        if tool == "gmapindex":
            args += ["--sort", "alpha"]
        assert mod.main(args + [fasta]) == 0
    # version, chromosome (+ .iit), chrsubset, contig (+ .iit),
    # genomecomp, positions and offsets (+ gammaptrs)
    _same_dirs(tmp_path / "jax", tmp_path / "port",
               10 if basesize else 9)
    db = tdatadir.GenomeDB.open(str(tmp_path / "port" / "syn"), "syn")
    assert db.chr_names == ["chr1", "chr2", "chr3"]
    assert (db.k, db.basesize) == (int(k), int(basesize or k))


def test_gmapindex_compress_uncompress(tmp_path, fasta, capsysbinary):
    """-C packs nucleotide text (N, X, lowercase, other letters) into
    genomecomp blocks; -U prints them back, wrapped with -w."""
    text = tmp_path / "seq.txt"
    body = pathlib.Path(fasta).read_text().split("\n", 1)[1][:5_000]
    text.write_text(body + "XXnnACGTU-uzq\n")
    out = {}
    for sub, mod in (("jax", jgmapindex), ("port", tgmapindex)):
        assert mod.main(["-C", str(text)]) == 0
        out[sub] = capsysbinary.readouterr().out
        (tmp_path / f"{sub}.comp").write_bytes(out[sub])
    assert out["port"] == out["jax"] and len(out["port"]) > 1_000
    for wrap in ("0", "60"):
        got = {}
        for sub, mod in (("jax", jgmapindex), ("port", tgmapindex)):
            assert mod.main(["-U", "-w", wrap,
                             str(tmp_path / "port.comp")]) == 0
            got[sub] = capsysbinary.readouterr().out
        assert got["port"] == got["jax"] and b"X" in got["port"]


def test_fa_coords_and_gmap_process(tmp_path, fasta, capsys):
    for sub, mod in (("jax", jfa_coords), ("port", tfa_coords)):
        assert mod.main(["-o", str(tmp_path / f"{sub}.coords"), fasta]) == 0
    coords = (tmp_path / "port.coords").read_bytes()
    assert coords == (tmp_path / "jax.coords").read_bytes()
    assert coords.count(b"chr") >= 6
    # a '#' line excludes a contig, as gmap_setup's users do
    lines = coords.decode().splitlines(keepends=True)
    edited = tmp_path / "edited.coords"
    edited.write_text("".join(
        "#" + l if l.startswith("chr2\t") else l for l in lines))
    outs = []
    for mod in (jgmap_process, tgmap_process):
        assert mod.main(["-c", str(edited), fasta]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert ">chr1\tchr1:1..31000\t0\n" in outs[1] and ">chr2" not in outs[1]


@pytest.mark.parametrize("sort,version", [("chrom", "5"), ("alpha", "5"),
                                          ("none", "1"),
                                          ("numeric-alpha", "3")])
def test_iit_store_byte_equal(tmp_path, sort, version):
    """Sites and SNP maps from text, both formats, each sort."""
    rng = np.random.default_rng(73)
    g = synth.make_genome(rng, [40_000, 30_000, 20_000])
    texts = {"sites": synth.splicesites_text(
                 g, synth.random_introns(rng, g, 40),
                 synth.random_decoys(rng, g, 10)),
             "snps": synth.snps_text(g, *synth.random_snps(rng, g, 1 / 500))}
    for name, text in texts.items():
        (tmp_path / f"{name}.txt").write_text(text)
        for sub, mod in (("jax", jiit_store), ("port", tiit_store)):
            assert mod.main(["-o", str(tmp_path / f"{sub}_{name}"),
                             "-s", sort, "-v", version,
                             str(tmp_path / f"{name}.txt")]) == 0
        port = (tmp_path / f"port_{name}.iit").read_bytes()
        assert port == (tmp_path / f"jax_{name}.iit").read_bytes(), name
        assert len(port) > 1_000


def test_iit_store_reads_stdin(tmp_path, monkeypatch):
    rng = np.random.default_rng(74)
    g = synth.make_genome(rng, [20_000, 10_000])
    text = synth.snps_text(g, *synth.random_snps(rng, g, 1 / 300))
    for sub, mod in (("jax", jiit_store), ("port", tiit_store)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        assert mod.main(["-o", str(tmp_path / f"{sub}.iit")]) == 0
    assert ((tmp_path / "port.iit").read_bytes()
            == (tmp_path / "jax.iit").read_bytes())


@pytest.mark.parametrize("k,basesize", SETTINGS)
def test_snpindex_byte_equal(tmp_path, fasta, k, basesize):
    """snpindex on a port-built directory: the alt genome and the SNP
    index files, flat and gamma, from the port's iit_store map."""
    rng = np.random.default_rng(75)
    dest = tmp_path / "db"
    os.makedirs(dest)
    assert tgmap_build.main(["-d", "syn", "--dir", str(dest), "-k", k]
                            + (["-b", basesize] if basesize else [])
                            + [fasta]) == 0
    db = tdatadir.GenomeDB.open(str(dest / "syn"), "syn")
    n = len(db.codes)
    pos = np.unique(rng.integers(0, n, n // 400))
    pos = pos[~db.flags[pos]]
    alt = (db.codes[pos] + rng.integers(1, 4, len(pos))) % 4
    text = "".join(
        f">rs{i} {db.chr_names[c]}:{p - db.chr_starts[c] + 1} "
        f"{'ACGT'[db.codes[p]]}{'ACGT'[a]}\n"
        for i, (p, a) in enumerate(zip(pos, alt))
        for c in [int(np.searchsorted(db.chr_ends, p, side="right"))])
    (tmp_path / "snps.txt").write_text(text)
    assert tiit_store.main(["-o", str(tmp_path / "snps"),
                            str(tmp_path / "snps.txt")]) == 0
    before = set(os.listdir(dest / "syn"))
    trees = {}
    for sub, mod in (("jax", jsnpindex), ("port", tsnpindex)):
        assert mod.main(["-D", str(dest), "-d", "syn", "-v", "snps",
                         str(tmp_path / "snps.iit")]) == 0
        new = set(os.listdir(dest / "syn")) - before
        trees[sub] = {f: (dest / "syn" / f).read_bytes() for f in new}
        for f in new:
            os.remove(dest / "syn" / f)
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) == (4 if basesize else 3)


def _offsets_cases():
    """Offsets arrays of a few shapes: a planted index, one with long
    empty runs (whole empty blocks), a one-oligo genome and big gaps."""
    rng = np.random.default_rng(77)
    g = synth.make_genome(rng, [20_000, 7_000])
    codes, flags = g.codes_flags
    yield "planted", tindexdb.build_index(codes, flags, g.chr_ends, 8, 3)[0]
    sparse = np.zeros(4 ** 8 + 1, np.uint32)
    hot = np.sort(rng.choice(4 ** 8, 40, replace=False))
    sparse[hot + 1] = rng.integers(1, 5_000, 40)
    yield "sparse", np.cumsum(sparse).astype(np.uint32)
    one = np.zeros(200, np.uint8)
    yield "one_oligo", tindexdb.build_index(
        one, np.zeros(200, bool), np.array([200]), 8, 3)[0]
    big = np.cumsum(rng.integers(0, 2 ** 14, 4 ** 8 + 1)).astype(np.uint32)
    big[0] = 0
    yield "big_gaps", big


@pytest.mark.parametrize("basesize", [4, 6, 7])
def test_gamma_coder_matches_plain(basesize):
    """native/hostops.c's gamma_pack_offsets writes the Python loop's
    words, and gamma_expand_offsets reads them back like the Python
    decoder: empty blocks and one-oligo genomes included."""
    lib = native.get_lib()
    assert lib is not None
    blocksize = 4 ** (8 - basesize)
    for name, off in _offsets_cases():
        gp, words = tindexdb._write_offsets_gamma_plain(off, blocksize)
        gp_c, words_c = tindexdb._write_offsets_gamma_native(lib, off,
                                                             blocksize)
        assert np.array_equal(gp_c, gp) and np.array_equal(words_c, words), name
        back = tindexdb._read_offsets_gamma_native(lib, gp, words,
                                                   len(off) - 1, blocksize)
        plain = tindexdb._read_offsets_gamma_plain(gp, words, len(off) - 1,
                                                   blocksize)
        assert np.array_equal(back, off) and np.array_equal(plain, off), name


def test_gamma_without_native_library(tmp_path, monkeypatch):
    """Without the native library the Python loops serve toy
    oligospaces and refuse beyond 4^12 oligos instead of running for
    hours."""
    off = dict(_offsets_cases())["planted"]
    gp, comp = tmp_path / "gp", tmp_path / "comp"
    gp_path, comp_path = str(gp), str(comp)
    tindexdb.write_offsets_gamma(gp_path, comp_path, off, 6, 8)
    want = (gp.read_bytes(), comp.read_bytes())
    monkeypatch.setattr(native, "get_lib", lambda: None)
    tindexdb.write_offsets_gamma(gp_path, comp_path, off, 6, 8)
    assert (gp.read_bytes(), comp.read_bytes()) == want
    assert np.array_equal(
        tindexdb.read_offsets_gamma(gp_path, comp_path, 6, 8), off)
    huge = np.zeros(4 ** 13 + 1, np.uint32)
    with pytest.raises(RuntimeError, match="native gamma"):
        tindexdb.write_offsets_gamma(gp_path, comp_path, huge, 12, 13)
    with pytest.raises(RuntimeError, match="native gamma"):
        tindexdb.read_offsets_gamma(gp_path, comp_path, 12, 13)


def test_build_db_function_matches_cli(tmp_path, fasta):
    """db/build.build_db is what the CLIs call; fa_coords_text and
    load_genome_fasta agree with the directory it wrote."""
    d = tbuild.build_db([fasta], "syn", str(tmp_path), k=8, basesize=6)
    g = tbuild.load_genome_fasta([fasta])
    db = tdatadir.GenomeDB.open(d, "syn")
    assert np.array_equal(db.codes, g.codes)
    assert np.array_equal(db.flags, g.flags)
    assert np.array_equal(db.chr_ends, g.chr_ends)
    assert tbuild.fa_coords_text([fasta]).count("\n") == 4 + 3
