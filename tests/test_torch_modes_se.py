"""Port parity for the cmet/atoi modes (gsnap --mode cmet-stranded /
atoi-stranded, BASELINE config 5), single end, against the JAX package:
the converted index files (flat and gamma), GsnapRunner.run SAM at -N 0
and -N 1 in both modes, MD on reads with a read-C / genome-T site, and
the gsnap CLI with --mode, --cmetdir / --atoidir and -v / -s beside
--mode.  The paired-end half is test_torch_modes_pe.py."""

import io
import os
import re

import numpy as np
import pytest

from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import transforms as jtransforms
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.db import transforms as ttransforms
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (align_batch_as_runners, fresh_jax_caches, jax_db,
                          jax_runner_one_device, mode_params, modes_world,
                          one_torch_thread, same_tree)

MODES = ("cmet-stranded", "atoi-stranded")


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return modes_world(tmp_path_factory.mktemp("modes_se"))


@pytest.mark.parametrize("kind", ["cmet", "atoi"])
@pytest.mark.parametrize("k,basesize", [(8, 8), (8, 6)])
def test_converted_index_files_byte_equal(tmp_path, kind, k, basesize):
    """write_converted_indexes: the same files, byte for byte, flat
    (basesize = k) and gamma-compressed (basesize < k)."""
    rng = np.random.default_rng(41)
    g = synth.make_genome(rng, [30_000, 20_000], n_runs=2,
                          repeat_copies=4)
    codes, flags = g.codes_flags
    for sub, mod in (("jax", jtransforms), ("port", ttransforms)):
        os.makedirs(tmp_path / sub)
        mod.write_converted_indexes(str(tmp_path / sub), "syn", codes, flags,
                                    g.chr_ends, kind, k=k, basesize=basesize)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == (4 if basesize == k else 6)
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


def _runners(world, mode, novel):
    db = world["db"]
    return (jrun.GsnapRunner(jax_db(db), mode_params(jse, db, mode),
                             novelsplicing=novel),
            trun.GsnapRunner(db, mode_params(tse, db, mode),
                             novelsplicing=novel, device="cpu"))


def _reads(world, mode):
    return (world["reads"] if mode == MODES[0]
            else world["pairs"]["atoi-stranded"][0])


@pytest.mark.parametrize("novel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_run_sam_byte_equal(world, mode, novel):
    """SE SAM byte-equal at -N 0 and -N 1: bisulfite reads under cmet,
    A-to-I edited read 1s under atoi."""
    jr, tr = _runners(world, mode, novel)
    reads = _reads(world, mode)
    jo, to = io.StringIO(), io.StringIO()
    jr.run(reads, jo, batch_size=256)
    assert tr.run(reads, to, batch_size=256) == len(reads)
    assert to.getvalue() == jo.getvalue()
    recs = [l.split("\t") for l in to.getvalue().splitlines() if l[0] != "@"]
    mapped = [f for f in recs if f[2] != "*"]
    assert len(mapped) > 0.9 * len(reads)


@pytest.mark.parametrize("mode", MODES)
def test_align_batch_gapped_under_mode(world, mode):
    """align_batch_gapped with the runner's converted index pair and
    params: each strand seeds on its own index under its own conversion
    (gather_candidates' two-strand branch); the whole result tree equals
    the JAX package's."""
    j, t = align_batch_as_runners(*_runners(world, mode, True),
                                  _reads(world, mode))
    same_tree(j, t)
    assert int((t["npaths"] > 0).sum()) > 0.9 * len(_reads(world, mode))


def _md_mismatches(md: str) -> list[int]:
    """Aligned-span positions of the mismatches an MD string shows."""
    out, pos, num = [], 0, ""
    i = 0
    while i < len(md):
        ch = md[i]
        if ch.isdigit():
            num += ch
        elif ch == "^":
            pos += int(num or 0)
            num = ""
            i += 1
            while i < len(md) and md[i].isalpha():
                i += 1
            continue
        else:
            pos += int(num or 0)
            num = ""
            out.append(pos)
            pos += 1
        i += 1
    return out


def test_ct_site_shown_in_md(world):
    """A read-C / genome-T site aligns under cmet's two-sided selection
    but is reported as a mismatch in MD (the reference's MD:Z:72C7T19),
    on both strands."""
    _, tr = _runners(world, MODES[0], False)
    to = io.StringIO()
    tr.run(world["reads"], to, batch_size=256)
    truth = {r.label: t for r, t in zip(world["reads"], world["truth"])}
    checked = 0
    for line in to.getvalue().splitlines():
        f = line.split("\t")
        if line[0] == "@" or f[2] == "*" or int(f[1]) & 0x100:
            continue
        t = truth[f[0]]
        if t.site < 0:
            continue
        md = next(x[5:] for x in f[11:] if x.startswith("MD:Z:"))
        lead = re.match(r"(\d+)S", f[5])
        clip = int(lead.group(1)) if lead else 0
        L = len(f[9])
        at = t.site if not int(f[1]) & 16 else L - 1 - t.site
        assert at - clip in _md_mismatches(md), (f[0], md, f[5])
        checked += 1
    assert checked >= 10


@pytest.mark.parametrize("extra", [
    ["--mode", "atoi-stranded"], ["-v", "snps", "--mode", "cmet-stranded"],
    ["-s", "sites", "-v", "snps", "--mode", "atoi-stranded"],
    ["--mode", "cmet-stranded"],
    ["--mode", "cmet-stranded", "--cmetdir", "CONV", "-N", "1"],
    ["--mode", "atoi-stranded", "--atoidir", "CONV"]])
def test_cli_modes_byte_equal(world, capsys, extra):
    """The gsnap CLI under --mode, byte-equal to the JAX CLI: the
    command lines the port refused before it ran the modes, and
    --cmetdir / --atoidir pointing at a directory of converted
    indexes."""
    extra = [world["conv"] if e == "CONV" else e for e in extra]
    cmet = "cmet-stranded" in extra
    reads = os.path.join(world["dir"], "b.fq" if cmet else "e_1.fq")
    nreads = len(_reads(world, MODES[0] if cmet else MODES[1]))
    args = ["-D", world["dir"], "-d", "syn", *extra, reads]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert port_sam.count("\n") > nreads
