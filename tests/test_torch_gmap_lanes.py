"""Port parity for the GMAP rescue lanes as a whole: GsnapRunner.run and
run_pe with the DEFAULT GsnapParams() (--gmap-mode pairsearch,
indel_knownsplice,terminal,improvement) at -N 0 and -N 1, and the gsnap
CLI with no --gmap-mode and with terminal,improvement, against the JAX
package — SAM byte-equal.  Counters installed on the port's runner prove
that each lane fired: the terminal lane's and the improvement pass's
GMAP hits were accepted, pairsearch paired a GMAP mate with its anchor,
and at -N 1 the junction dynprog's solutions were used."""

import io

import numpy as np
import pytest

from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.cli import gsnap as jcli
from gmap_gsnap_tpu.db import build
from gmap_gsnap_tpu_torch.align import gmap_engine as teng
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import rescue as trescue
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.cli import gsnap as tcli
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import jax_db

KINDS = dict(sub=4, n=1, mid_indel=1.5, end_indel=1.5, terminal=1.5,
             repeat=1.5, junk=0.5)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_reads(rng, g, 150, weights=KINDS)
    srecs, _ = synth.plant_spliced_reads(
        np.random.default_rng(5), g, 60,
        weights=dict(unspliced=0.3, junction=0.3, messy_junction=0.4))
    p1, p2, _ = synth.plant_pairs(np.random.default_rng(9), g, 100, rna=True)
    return g, db, jax_db(db), recs + srecs, (p1, p2)


def _counted(monkeypatch, runner):
    """Install the lane counters on ``runner`` (and the port's
    select_final, solve_junctions_finish and prefetch_gmap)."""
    seen = dict(prefetch=0, prefetched_reads=0, terminal=0, improvement=0,
                pairsearch=0, dynprog=0)
    select_final, finish = trescue.select_final, teng.solve_junctions_finish
    prefetch, pe_rescue = runner.prefetch_gmap, runner._pe_rescue

    def spy_select(hits, L, improvement_fn=None, **kw):
        # in _rescued_hits only the terminal lane puts GMAP hits into
        # the pool before select_final
        seen["terminal"] += any(h.hittype == "gmap" for h in hits)

        def improvement(anchor):
            g = improvement_fn(anchor)
            seen["improvement"] += g is not None and g.nmatches > anchor.nmatches
            return g

        return select_final(hits, L, improvement_fn=improvement
                            if improvement_fn else None, **kw)

    def spy_pe_rescue(*a):
        out = pe_rescue(*a)
        chosen, _, f5, f3 = out
        own = {id(h) for h in f5 + f3}
        # a GMAP hit the ends' own lanes did not produce: pairsearch's
        seen["pairsearch"] += any(h.hittype == "gmap" and id(h) not in own
                                  for p in chosen for h in p[:2])
        return out

    def spy_prefetch(recs):
        seen["prefetch"] += 1
        seen["prefetched_reads"] += len(recs)
        return prefetch(recs)

    def spy_finish(d):
        out = finish(d)
        seen["dynprog"] += sum(x is not None for x in out)
        return out

    monkeypatch.setattr(trescue, "select_final", spy_select)
    monkeypatch.setattr(teng, "solve_junctions_finish", spy_finish)
    monkeypatch.setattr(runner, "prefetch_gmap", spy_prefetch)
    monkeypatch.setattr(runner, "_pe_rescue", spy_pe_rescue)
    return seen


@pytest.mark.parametrize("novel", [False, True])
def test_run_default_lanes_byte_equal(world, monkeypatch, novel):
    g, db, jdb, recs, _ = world
    jout = io.StringIO()
    jrun.GsnapRunner(jdb, novelsplicing=novel).run(recs, jout, batch_size=64)
    runner = trun.GsnapRunner(db, novelsplicing=novel, device="cpu")
    assert runner.gmap_modes == {"pairsearch", "indel_knownsplice",
                                 "terminal", "improvement"}
    seen = _counted(monkeypatch, runner)
    tout = io.StringIO()
    assert runner.run(recs, tout, batch_size=64) == len(recs)
    assert tout.getvalue() == jout.getvalue()
    assert seen["prefetch"] > 0 and seen["prefetched_reads"] > 0, seen
    assert seen["terminal"] > 0 and seen["improvement"] > 0, seen
    if novel:
        assert seen["dynprog"] > 0, seen
    assert runner.gmap_seconds > 0


@pytest.mark.parametrize("novel", [False, True])
def test_run_pe_default_lanes_byte_equal(world, monkeypatch, novel):
    g, db, jdb, _, (p1, p2) = world
    jout = io.StringIO()
    jrun.GsnapRunner(jdb, novelsplicing=novel).run_pe(p1, p2, jout,
                                                      batch_size=64)
    runner = trun.GsnapRunner(db, novelsplicing=novel, device="cpu")
    seen = _counted(monkeypatch, runner)
    tout = io.StringIO()
    assert runner.run_pe(p1, p2, tout, batch_size=64) == len(p1)
    assert tout.getvalue() == jout.getvalue()
    assert seen["prefetch"] > 0 and seen["pairsearch"] > 0, seen


def test_lane_choice_changes_output(world):
    """--gmap-mode none, terminal,improvement and the default give three
    runs; dropping a lane the reads need changes the SAM (the lanes are
    not no-ops), and indel_knownsplice alone is none without -s."""
    g, db, _, recs, (p1, p2) = world

    def se(mode):
        out = io.StringIO()
        trun.GsnapRunner(db, tse.GsnapParams(gmap_mode=mode),
                         device="cpu").run(recs, out, batch_size=64)
        return out.getvalue()

    default = se(tse.GsnapParams().gmap_mode)
    assert se("terminal,improvement") == default
    assert se("") != default and se("terminal") != default
    assert se("indel_knownsplice") == se("")


@pytest.fixture(scope="module")
def disk_db(tmp_path_factory, world):
    g, _, _, recs, _ = world
    d = tmp_path_factory.mktemp("db")
    g.write_fasta(str(d / "g.fa"))
    build.build_db([str(d / "g.fa")], "syn", str(d), k=12)
    synth.write_fastq(str(d / "reads.fq"), recs[:120])
    return d


@pytest.mark.parametrize("extra", [[], ["--gmap-mode", "terminal,improvement"],
                                   ["-N", "1"]])
def test_cli_gmap_modes_byte_equal(disk_db, capsys, extra):
    args = ["-D", str(disk_db), "-d", "syn", "--batch-size", "64", *extra,
            str(disk_db / "reads.fq")]
    assert jcli.main(args) == 0
    jax_sam = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    port_sam = capsys.readouterr().out
    assert port_sam == jax_sam
    assert port_sam.count("\n") > 120


@pytest.mark.parametrize("mode", [
    "none", "all", "improve", "terminal,improvement", "pairsearch,none,terminal",
    " terminal , pairsearch ", "indel_knownsplice", "", "bogus",
    "terminal,bogus"])
def test_expand_gmap_mode_matches_jax(capsys, mode):
    def run(f):
        try:
            return f(mode), None
        except SystemExit as e:
            return None, (e.code, capsys.readouterr().err)

    assert run(tcli._expand_gmap_mode) == run(jcli._expand_gmap_mode)
