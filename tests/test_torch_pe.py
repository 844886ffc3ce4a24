"""Port parity for paired-end alignment: align_batch_pe (the pairing grid,
kernel K8 through its plain path, and the pair overflow gate) on planted
pairs and on hand-built hits, and GsnapRunner.run_pe (SAM byte-equal, all
lanes and result types), against the JAX package, at -N 0 and -N 1."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmap_gsnap_tpu.align import gsnap_gapped as jgg
from gmap_gsnap_tpu.align import gsnap_pe as jpe
from gmap_gsnap_tpu.align import gsnap_se as jse
from gmap_gsnap_tpu.align import runner as jrun
from gmap_gsnap_tpu.io.fasta import Record
from gmap_gsnap_tpu.ops import genome as jgen
from gmap_gsnap_tpu.utils import dna
from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gsnap_gapped as tgg
from gmap_gsnap_tpu_torch.align import gsnap_pe as tpe
from gmap_gsnap_tpu_torch.align import gsnap_se as tse
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.utils import synth
from torch_parity import jax_db


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(29)
    g = synth.make_genome(rng, [150_000, 100_000, 50_000])
    db = synth.genome_db(g, 12, 3)
    jg = jgen.GenomeArrays.from_codes(db.codes, db.flags, db.chr_ends)
    ji = jse.IndexArrays.from_host(db.offsets, db.positions, 12, 3)
    tg = convert.genome_from_arrays(jg.ref16, jg.flag16, jg.length,
                                    jg.chr_offsets, "cpu")
    ti = convert.index_from_arrays(ji.offsets, ji.positions, 12, 3, "cpu")
    return rng, g, db, jg, ji, tg, ti


def _same_tree(j, t, path=""):
    """JAX result tree vs the port's: same keys, shapes and values
    (float32 by their bits)."""
    if isinstance(j, dict):
        assert set(j) == set(t), (path, set(j) ^ set(t))
        for k in j:
            _same_tree(j[k], t[k], f"{path}.{k}")
        return
    a, b = np.asarray(j), t.numpy()
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == np.float32:
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), path


def _params(novel: bool):
    kw = dict(seed_total=512 if novel else 384)
    pairmax = jpe.PAIRMAX_RNA if novel else jpe.PAIRMAX_DNA
    jp = jpe.PEParams(gapped=jgg.GappedParams(
        base=jse.GsnapParams(**kw), novelsplicing=novel), pairmax=pairmax)
    tp = tpe.PEParams(gapped=tgg.GappedParams(
        base=tse.GsnapParams(**kw), novelsplicing=novel), pairmax=pairmax)
    return jp, tp


@pytest.mark.parametrize("novel", [False, True])
def test_align_batch_pe_planted(world, novel):
    """Every output of align_batch_pe, end5/end3_pairing and the gated
    overflow flags included, on planted pairs (read 2 inverted, as
    run_pe hands it over)."""
    rng, g, db, jg, ji, tg, ti = world
    r1, r2, _ = synth.plant_pairs(rng, g, 96, rna=novel)
    r2 = [Record(r.label, r.header, dna.revcomp_str(r.seq), r.quality[::-1])
          for r in r2]
    enc = trun.encode_batch(r1, 100) + trun.encode_batch(r2, 100)
    jp, tp = _params(novel)
    jres = jpe.align_batch_pe(jg, ji, *(jnp.asarray(x) for x in enc), jp)
    tres = tpe.align_batch_pe(tg, ti, *(torch.from_numpy(x) for x in enc), tp)
    _same_tree(jres, tres)
    pt = tres["pairtype"][tres["pscore"] < tpe.BIG]
    assert (pt == tpe.PT_CONCORDANT).any() and (pt != tpe.PT_CONCORDANT).any()
    assert tres["cands5"]["overflow"].any() or tres["cands3"]["overflow"].any()
    assert tres["npairs"].max() > 1


def _fake_gather(out2, cands2):
    def gather(*args, **kwargs):
        return dict(out2), dict(cands2)
    return gather


@pytest.mark.parametrize("novel", [False, True])
def test_align_batch_pe_hand_built(world, monkeypatch, novel):
    """Hand-built end hits through both packages' align_batch_pe (their
    gather_candidates replaced): lefts above 2^24 whose equal-score pairs
    differ by less than the float32 spacing, lefts near 2^31 (int32
    wraparound), every pair type, the insert-0 rejection and rows with
    256 chosen cells cut to maxpairs."""
    rng, g, db, jg, ji, tg, ti = world
    b = 64
    out, len5, len3 = synth.pair_hit_cases(rng, b, db.chr_ends)
    n2 = 2 * b
    cands = dict(overflow=rng.random(n2) < 0.5,
                 overflow_trunc=rng.random(n2) < 0.2,
                 ovf_bound=rng.integers(0, 6, n2).astype(np.int32),
                 hbound=rng.integers(0, 6, n2).astype(np.int32))
    jp, tp = _params(novel)
    monkeypatch.setattr(jgg, "gather_candidates", _fake_gather(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in cands.items()}))
    tout = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in out.items()}
    monkeypatch.setattr(tgg, "gather_candidates", _fake_gather(
        tout, {k: torch.from_numpy(v) for k, v in cands.items()}))
    codes = np.zeros((b, 100), np.uint8)
    enc = (codes, codes.astype(bool), len5, codes, codes.astype(bool), len3)
    # eagerly, so that no earlier trace of the jitted function is reused
    jres = jpe.align_batch_pe.__wrapped__(
        jg, ji, *(jnp.asarray(x) for x in enc), jp)
    tres = tpe.align_batch_pe(tg, ti, *(torch.from_numpy(x) for x in enc), tp)
    _same_tree(jres, tres)

    ok = tres["pscore"] < tpe.BIG
    assert set(tres["pairtype"][ok].tolist()) == {0, 1, 2, 3}
    assert tres["npairs"][0] == 0 and not tres["pair_concordant"][0]
    assert tres["npairs"][1] == tres["npairs"][2] == 100
    # equal-score neighbours whose exact left5 order was overruled by
    # the float32 rounding (then left3 decided)
    l5 = torch.gather(tres["end5_pairing"]["left"], 1, tres["i5"].long())
    tie = ok[:, 1:] & (tres["pscore"][:, 1:] == tres["pscore"][:, :-1])
    assert (tie & (l5[:, :-1] > l5[:, 1:])).any()
    assert (tres["end5_pairing"]["left"] >= 2**31).any()
    # the chromosome test decides: one chromosome pairs more cells
    one_chr = torch.tensor([0, 2**33])
    grid = tpe.pair_grid(tres["end5_pairing"], tres["end3_pairing"],
                         torch.from_numpy(len5), torch.from_numpy(len3),
                         one_chr, tp.pairmax, 0, 100)
    assert (grid["npairs"] != tres["npairs"]).any()
    # read 2's own lengths enter the inserts
    grid = tpe.pair_grid(tres["end5_pairing"], tres["end3_pairing"],
                         torch.from_numpy(len5), torch.from_numpy(len5),
                         tg.chr_offsets, tp.pairmax, 0, 100)
    assert (grid["insert"] != tres["insert"]).any()


def test_pair_grid_rounds_insert_and_left5():
    """The two take_cols quirks in isolation: an insert above 2^24 comes
    out rounded to float32, and pairs of equal score order by the
    rounded left5, then left3 (exact)."""
    np_ = 2
    base = 100_000_000
    z = torch.zeros(1, np_, dtype=torch.int32)
    h = lambda lefts, scores=(0, 0): dict(
        left=torch.tensor([lefts]), right=torch.tensor([lefts]),
        mid=torch.tensor([lefts]), kind=z, split=z, split2=z, nindels=z,
        score=torch.tensor([scores], dtype=torch.int32),
        plusp=torch.ones(1, np_, dtype=torch.bool))
    L = torch.tensor([100], dtype=torch.int32)
    offs = torch.tensor([0, 2**32])
    # left5 base+3 and base+1 round to one float32 (spacing 8); left3
    # base+401 < base+405 decides, then the cell index
    g = tpe.pair_grid(h([base + 3, base + 1]), h([base + 405, base + 401]),
                      L, L, offs, 1000, 0, 4)
    assert g["i5"].tolist() == [[0, 1, 0, 1]]
    assert g["i3"].tolist() == [[1, 1, 0, 0]]
    # a toolong pair 2^25 + 105 apart: outer insert 2^25 + 205 rounds
    # to a multiple of 4
    g = tpe.pair_grid(h([base, base + 10**9], (0, 10**6)),
                      h([base + 2**25 + 105, base + 10**9]), L, L, offs,
                      1000, 0, 1)
    assert g["pairtype"].tolist() == [[tpe.PT_TOOLONG]]
    assert g["insert"].tolist() == [[2**25 + 204]]


def _spy(obj, name, seen, monkeypatch, count=len):
    fn = getattr(obj, name)

    def spy(*a, **k):
        out = fn(*a, **k)
        seen[name] += count(out) if count else 1
        return out

    monkeypatch.setattr(obj, name, spy)


@pytest.mark.parametrize("novel", [False, True])
def test_run_pe_sam_byte_equal(world, monkeypatch, novel):
    rng, g, db, *_ = world
    r1, r2, truth = synth.plant_pairs(np.random.default_rng(31 + novel), g,
                                      192, rna=novel)
    jr = jrun.GsnapRunner(jax_db(db), params=jse.GsnapParams(gmap_mode=""),
                          novelsplicing=novel)
    jout = io.StringIO()
    jr.run_pe(r1, r2, jout, batch_size=64)

    tr = trun.GsnapRunner(db, params=tse.GsnapParams(gmap_mode=""),
                          novelsplicing=novel, device="cpu")
    seen = dict.fromkeys(("_dispatch_wide_pe", "_pe_rescue", "_pe_sam_fast",
                          "_pe_sam_fast_spliced"), 0)
    for name in seen:
        _spy(tr, name, seen, monkeypatch,
             count=None if name in ("_dispatch_wide_pe", "_pe_rescue") else len)
    tout = io.StringIO()
    assert tr.run_pe(r1, r2, tout, batch_size=64) == len(r1)
    assert tout.getvalue() == jout.getvalue()
    assert tr.category_counts == jr.category_counts
    spliced = seen.pop("_pe_sam_fast_spliced")
    assert min(seen.values()) > 0, seen
    assert spliced > 0 if novel else spliced == 0
    cats = " ".join(tr.category_counts)
    for c in ("concordant", "paired_uniq", "unpaired", "halfmapping",
              "nomapping"):
        assert c in cats, (c, tr.category_counts)
    cigars = [f.split("\t")[5] for f in tout.getvalue().splitlines()
              if not f.startswith("@")]
    assert any("N" in c for c in cigars) == novel


def test_run_pe_fast_path_off_equal(world):
    """The vectorized PE emission (pe_fast) against the scalar path."""
    rng, g, db, *_ = world
    r1, r2, _ = synth.plant_pairs(np.random.default_rng(37), g, 96, rna=True)
    outs = []
    for fast in (True, False):
        tr = trun.GsnapRunner(db, params=tse.GsnapParams(gmap_mode=""),
                              novelsplicing=True, device="cpu")
        tr.pe_fast = fast
        o = io.StringIO()
        tr.run_pe(r1, r2, o, batch_size=48)
        outs.append(o.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") > 2 * len(r1)
