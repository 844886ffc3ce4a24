"""Port parity for gsnap CLI flags that act on code the port already
runs: -l/--shortend-splice-endlength (the short-end lane under -s),
--sam-use-0M, --sam-multiple-primaries, -J/--quality-zero-score,
-0/--noexceptions and --time, each byte-equal to the JAX package's CLI
on standard output (--time's per-batch lines on standard error carry
wall times)."""

import numpy as np
import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu.io import sam as jsam
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.db import iit_text
from gmap_gsnap_tpu_torch.io import sam as tsam
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import (fresh_jax_caches, jax_runner_one_device,
                          one_torch_thread)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference():
    with fresh_jax_caches(), jax_runner_one_device(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    """The CLIs set module globals (QUALITY_ADJ, EXCEPTION_GUARD,
    INSERT_0M, MULTIPLE_PRIMARIES); put them back after each test."""
    for mod, names in ((jrun, ("QUALITY_ADJ", "EXCEPTION_GUARD")),
                       (trun, ("QUALITY_ADJ", "EXCEPTION_GUARD")),
                       (jsam, ("INSERT_0M", "MULTIPLE_PRIMARIES")),
                       (tsam, ("INSERT_0M", "MULTIPLE_PRIMARIES"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    rng = np.random.default_rng(47)
    g = synth.make_genome(rng, [200_000, 100_000])
    d = tmp_path_factory.mktemp("flags")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    introns = synth.random_introns(rng, g, 60)
    iit_text.iit_from_text(synth.splicesites_text(g, introns)).write(
        str(d / "sites.iit"))
    kr, _ = synth.plant_site_reads(rng, g, introns, 40, short_end=True)
    recs, _ = synth.plant_reads(rng, g, 120, weights=dict(
        sub=3, mid_indel=1, end_indel=1, terminal=1, repeat=1.5))
    srecs, _ = synth.plant_spliced_reads(rng, g, 40)
    synth.write_fastq(str(d / "reads.fq"), kr + recs + srecs)
    return d


@pytest.mark.parametrize("extra", [
    ["-s", "SITES", "-l", "5"], ["--sam-use-0M", "-N", "1"],
    ["--sam-multiple-primaries"], ["-J", "40"], ["-0"], ["--time"]])
def test_cli_flag_byte_equal(disk, capsys, extra):
    extra = [str(disk / "sites.iit") if e == "SITES" else e for e in extra]
    args = ["-D", str(disk), "-d", "syn", *extra, str(disk / "reads.fq")]
    assert jcli.main(args) == 0
    jax = capsys.readouterr()
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert port.out == jax.out
    assert port.out.count("\n") > 200
    if "--time" in extra:
        for err in (jax.err, port.err):
            assert "batch 0: " in err and "ms/read" in err
