"""Port parity for gsnap's multimapping maps (-g/--genes,
--favor-multiexon, --use-tally/--tallydir, --use-runlength/
--runlengthdir): SAM and native output of the runner and of the CLI,
single-end and paired-end, byte-equal to the JAX package's on a genome
with exactly duplicated blocks (synth.duplicate_blocks), whose maps the
port's own tools wrote (gtf_genes and iit_store); the resolution reaches
its four call sites and lowers the count of multimapping reads."""

import collections
import contextlib
import dataclasses
import inspect
import io

import numpy as np
import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import datadir as jdatadir
from gmap_gsnap_tpu.db import iit as jiit
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gmap_build as tgmap_build
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.cli import gtf_genes as tgtf_genes
from gmap_gsnap_tpu_torch.cli import iit_store as tiit_store
from gmap_gsnap_tpu_torch.db import datadir as tdatadir
from gmap_gsnap_tpu_torch.db import iit as tiit
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread, runner_params)

UNIT = 400   # the duplicated blocks' length
# planted read kinds without repeat copies (no wide lanes to compile)
SE_MIX = {"sub": 0.5, "mid_indel": 0.2, "end_indel": 0.15, "junk": 0.15}
PE_MIX = {"concordant": 0.7, "halfmapping": 0.1, "toolong": 0.1,
          "random": 0.1}
MAPS = {
    "genes": ["-g", "genes"],
    "multiexon": ["-g", "genes", "--favor-multiexon"],
    "tally": ["--use-tally", "tally", "--tallydir", "DIR"],
    "runlength": ["--use-runlength", "rl", "--runlengthdir", "DIR"],
    "all three": ["-g", "genes", "--use-tally", "tally", "--tallydir",
                  "DIR", "--use-runlength", "rl", "--runlengthdir", "DIR"],
}


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


def _tool(main, args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 250 kbp genome with 8 blocks of 400 nt copied to 3 places each,
    built by the port's gmap_build; reads and pairs from the copies
    (a third of the pairs with read 2 3-8 kbp past its copy) and planted
    ordinary ones; the genes map (gtf_genes, iit_store) in the database's
    maps folder, the tally and runlength maps in the world's directory."""
    rng = np.random.default_rng(71)
    d = tmp_path_factory.mktemp("multimap")
    g = synth.make_genome(rng, [150_000, 100_000], repeat_copies=2)
    blocks = synth.duplicate_blocks(rng, g, 8, L=UNIT)
    g.write_fasta(str(d / "g.fa"))
    assert tgmap_build.main(["-d", "syn", "--dir", str(d), "-k", "12",
                             str(d / "g.fa")]) == 0
    reads, _ = synth.plant_copy_reads(rng, g, blocks, UNIT, 48)
    reads += synth.plant_reads(rng, g, 16, weights=SE_MIX)[0]
    synth.write_fastq(str(d / "se.fq"), reads)
    p1, p2, _ = synth.plant_copy_pairs(rng, g, blocks, UNIT, 32, far=0.3)
    q1, q2, _ = synth.plant_pairs(rng, g, 8, weights=PE_MIX)
    synth.write_fastq(str(d / "p_1.fq"), p1 + q1)
    synth.write_fastq(str(d / "p_2.fq"), p2 + q2)
    maps = d / "syn" / "syn.maps"
    (d / "genes.gtf").write_text(synth.copy_genes_gtf(g, blocks, UNIT))
    (d / "genes.txt").write_text(_tool(tgtf_genes.main,
                                       [str(d / "genes.gtf")]))
    (d / "tally.txt").write_text(synth.copy_tally_text(rng, g, blocks, UNIT))
    (d / "rl.txt").write_text(synth.copy_runlength_text(g, blocks, UNIT))
    for out, txt in ((maps / "genes", "genes"), (d / "tally", "tally"),
                     (d / "rl", "rl")):
        assert tiit_store.main(["-o", str(out), str(d / f"{txt}.txt")]) == 0
    tdb = tdatadir.GenomeDB.open(str(d / "syn"), "syn")
    jdb = jdatadir.GenomeDB.open(str(d / "syn"), "syn")
    return dict(d=d, blocks=blocks, tdb=tdb, jdb=jdb, reads=reads,
                pairs=(p1 + q1, p2 + q2))


def _args(world, maps):
    return [str(world["d"]) if a == "DIR" else a for a in MAPS[maps]]


def _kwargs(args) -> dict:
    """The runner's keyword arguments for CLI map flags."""
    names = {"-g": "genesdb", "--use-tally": "tallydb",
             "--tallydir": "tally_dir", "--use-runlength": "runlengthdb",
             "--runlengthdir": "runlength_dir"}
    kw = {}
    for i, a in enumerate(args):
        if a == "--favor-multiexon":
            kw["favor_multiexon"] = True
        elif a in names:
            kw[names[a]] = args[i + 1]
    return kw


def _multimapped(sam: str) -> tuple:
    """(reads or pairs whose SAM says NH > 1, their NH summed); a pair
    counts by read 1's lines."""
    nhs = {}
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        nh = [x for x in f[11:] if x.startswith("NH:i:")]
        if not int(f[1]) & 0x80 and nh and int(nh[0][5:]) > 1:
            nhs[f[0]] = int(nh[0][5:])
    return len(nhs), sum(nhs.values())


def test_map_files_read_equal(world):
    """Each map file, written once by the port's iit_store, opened by both
    packages' IIT.read gives equal records, and dumps to equal text."""
    d = world["d"]
    for path in (d / "syn" / "syn.maps" / "genes.iit", d / "tally.iit",
                 d / "rl.iit"):
        j, t = jiit.IIT.read(str(path)), tiit.IIT.read(str(path))
        for f in ("version", "divsort", "divs", "types", "fields", "labels",
                  "annotations"):
            assert getattr(t, f) == getattr(j, f), (path, f)
        assert {k: [dataclasses.astuple(iv) for iv in v]
                for k, v in t.intervals.items()} == {
            k: [dataclasses.astuple(iv) for iv in v]
            for k, v in j.intervals.items()}
        assert t.dump() == j.dump() and t.dump(sortp=True) == j.dump(
            sortp=True)
        assert t.total_nintervals() == j.total_nintervals() > 0
        assert t.total_length() == j.total_length()


@pytest.mark.parametrize("maps", list(MAPS))
@pytest.mark.parametrize("ends", ["se", "pe"])
def test_runner_multimap_byte_equal(world, maps, ends):
    """run / run_pe with the maps: SAM and native output byte-equal to the
    JAX runner's, with the GMAP lanes off."""
    kw = _kwargs(_args(world, maps))
    jr = jrun.GsnapRunner(world["jdb"], runner_params(
        jrun.gsnap_se, world["jdb"], gmap_mode=""), **kw)
    tr = trun.GsnapRunner(world["tdb"], runner_params(
        trun.gsnap_se, world["tdb"], gmap_mode=""), device="cpu", **kw)
    for fmt in ("sam", "gsnap"):
        outs = []
        for r in (jr, tr):
            out = io.StringIO()
            if ends == "se":
                r.run(world["reads"], out, batch_size=64, fmt=fmt)
            else:
                r.run_pe(*world["pairs"], out, batch_size=64, fmt=fmt)
            outs.append(out.getvalue())
        assert outs[1] == outs[0], (maps, ends, fmt)


@pytest.mark.parametrize("maps", list(MAPS))
@pytest.mark.parametrize("ends", ["se", "pe"])
@pytest.mark.parametrize("fmt", ["sam", "gsnap"])
def test_cli_multimap_byte_equal(world, capsys, maps, ends, fmt):
    """The CLI with the map flags, with gsnap's default GMAP lanes at SAM:
    byte-equal to the JAX CLI."""
    d = world["d"]
    inputs = ([str(d / "se.fq")] if ends == "se"
              else [str(d / "p_1.fq"), str(d / "p_2.fq")])
    lanes = [] if fmt == "sam" else ["--gmap-mode", "none"]
    args = ["-D", str(d), "-d", "syn", "-A", fmt, "--batch-size", "64",
            *lanes, *_args(world, maps), *inputs]
    assert jcli.main(args) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    assert jax_out.count("\n") >= 64


def test_resolution_sites_and_drops(world, monkeypatch):
    """The port's resolution runs at its four call sites (SE _rescued_hits;
    PE _pe_rescue, sam_pe_records and native_pe_records) on more than one
    hit or pair, and with each map fewer reads and pairs multimap (NH > 1),
    to fewer places, than without one; --favor-multiexon fewer than -g
    alone."""
    seen = collections.Counter()
    resolve = trun.GsnapRunner._resolve_multimapping

    def spy(self, items, ends_of):
        out = resolve(self, items, ends_of)
        if len(items) > 1 and (self.genes or self.tally or self.runlength):
            seen[inspect.stack()[1].function] += 1
        return out

    monkeypatch.setattr(trun.GsnapRunner, "_resolve_multimapping", spy)
    counts = {}
    for maps in [None, *MAPS]:
        kw = _kwargs(_args(world, maps)) if maps else {}
        r = trun.GsnapRunner(world["tdb"], runner_params(
            trun.gsnap_se, world["tdb"], gmap_mode=""), device="cpu", **kw)
        sam = []
        for call in (lambda o: r.run(world["reads"], o, batch_size=64),
                     lambda o: r.run_pe(*world["pairs"], o, batch_size=64)):
            out = io.StringIO()
            call(out)
            sam.append(_multimapped(out.getvalue()))
        native = io.StringIO()
        r.run_pe(*world["pairs"], native, batch_size=64, fmt="gsnap")
        counts[maps] = tuple(sam)
    assert {"_rescued_hits", "_pe_rescue", "sam_pe_records",
            "native_pe_records"} <= set(seen), seen
    (se0, se_nh), (pe0, pe_nh) = counts[None]
    assert se0 >= 40 and pe0 >= 20, counts
    for maps in MAPS:
        (se, se_h), (pe, pe_h) = counts[maps]
        assert se < se0 and pe < pe0 and se_h < se_nh and pe_h < pe_nh, (
            maps, counts)
    for end in (0, 1):
        assert counts["multiexon"][end] < counts["genes"][end], counts


def test_maps_resolve_as_planted(world):
    """The genes map sends a read of a block's copy to the gene-bearing
    copies it was planted over (copies 0 and 1 of an even block, copy 1
    alone under --favor-multiexon; copy 0 of an odd block), read through the JAX package's GenesMap and the
    port's on the same file."""
    from gmap_gsnap_tpu.align import genes as jgenes
    from gmap_gsnap_tpu_torch.align import genes as tgenes

    for fav in (False, True):
        maps = [m.GenesMap.open("genes", db, favor_multiexon=fav)
                for m, db in ((jgenes, world["jdb"]),
                              (tgenes, world["tdb"]))]
        # KNOWN_GENE 1, KNOWN_GENE_MULTIEXON 2, by block parity
        want = {False: ([1, 1, 0], [1, 0, 0]), True: ([1, 2, 0], [1, 0, 0])}
        for i, row in enumerate(world["blocks"]):
            ovs = [[m.segments_overlap([(int(s) + 150, int(s) + 250)])
                    for s in row] for m in maps]
            assert ovs[0] == ovs[1]
            assert ovs[1] == want[fav][i % 2], (i, row, ovs)

