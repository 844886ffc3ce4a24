"""The CUDA kernels against their plain torch versions on the same CUDA
tensors (marked ``cuda``: they skip where there is no card), and the
wrappers' device rules, which hold on the CPU too.

On a machine with a card (and no JAX, whose import tests/conftest.py
needs):  python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gmap_gsnap_tpu_torch import convert
from gmap_gsnap_tpu_torch.align import gmap_engine as eng
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
from gmap_gsnap_tpu_torch.align import gsnap_pe as pe
from gmap_gsnap_tpu_torch.align import gsnap_se as se
from gmap_gsnap_tpu_torch.align import runner as trun
from gmap_gsnap_tpu_torch.kernels import build as kbuild
from gmap_gsnap_tpu_torch.ops import dynprog as dp
from gmap_gsnap_tpu_torch.ops import mismatch as mmo
from gmap_gsnap_tpu_torch.ops.genome import GenomeArrays
from gmap_gsnap_tpu_torch.utils import device as tdevice
from gmap_gsnap_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batch(cuda):
    rng = np.random.default_rng(21)
    g = synth.make_genome(rng, [400_000, 250_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_reads(
        rng, g, 512, weights=dict(sub=3, n=1, mid_indel=1, end_indel=1,
                                  terminal=1, repeat=2, junk=0.5))
    c, f, l = trun.encode_batch(recs, 100)
    l[::5] = 70                                   # mixed lengths
    c[::5, 70:] = 0
    tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, cuda)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    ct, ft, lt = (torch.from_numpy(x).to(cuda) for x in (c, f, l))
    crc, frc = se._revcomp_batch(ct, ft, lt)
    return (tg, ti, torch.cat([ct, crc]), torch.cat([ft, frc]),
            torch.cat([lt, lt]), (ct, ft, lt))


def _equal(a, b):
    """Equal tensors; float32 ones bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def spliced(cuda):
    """Spliced reads (junctions, short exons, distant halves) over a
    synthetic genome, both strands, on the card."""
    rng = np.random.default_rng(23)
    g = synth.make_genome(rng, [400_000, 250_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_spliced_reads(rng, g, 512)
    c, f, l = trun.encode_batch(recs, 100)
    tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, cuda)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    ct, ft, lt = (torch.from_numpy(x).to(cuda) for x in (c, f, l))
    crc, frc = se._revcomp_batch(ct, ft, lt)
    return (tg, ti, torch.cat([ct, crc]), torch.cat([ft, frc]),
            torch.cat([lt, lt]), (ct, ft, lt))


@pytest.mark.cuda
@pytest.mark.parametrize("seed_total,ncand", [(512, 32), (4096, 128)])
def test_splice_kernels_match_plain(spliced, seed_total, ncand):
    """K5, K6 and K7 against their plain versions at the main (NC = 32)
    and wide (NC = 128) shapes, on the selectors' pairs and triples and
    on random ones (invalid diagonals, diagonals below 64 whose span
    start wraps in uint32)."""
    tg, ti, c, f, l, _ = spliced
    p = se.GsnapParams(seed_total=seed_total, ncand=ncand)
    seed = se._seed_diagonals_plain(ti, c, f, l, p, True)
    top_d, votes, _ = se._top_diagonals_plain(seed[0], ncand)
    top_d[:, 3] = 0xFFFFFFFF
    top_d[:, 4] = 2
    q = se._pack_device(c, f, l, 100)
    _, pref = mmo._prefix_mismatches_plain(tg, q, top_d, l, None, None)
    budget = se.auto_budget(l, 12, 3, -1)
    g = torch.Generator(device="cpu").manual_seed(3)
    rnd = lambda n: torch.randint(0, ncand, (len(l), n), generator=g).to(l.device)

    ii, jj, pv = gg._select_pairs_plain(top_d, votes,
                                        gg._splice_pairs_eligible(200_000), 16)
    ii[:, 12:], jj[:, 12:] = rnd(4), rnd(4)
    args = (tg, top_d, pref, ii, jj, pv, l, budget, 100)
    want = gg._solve_splices_plain(*args)
    got = gg._solve_splices_cuda(*args)
    _equal([got[k] for k in gg._SPLICE_KEYS], [want[k] for k in gg._SPLICE_KEYS])
    assert want["valid"].any() and (~want["sense"][want["valid"]]).any()

    for v in (votes, torch.ones_like(votes)):           # and all votes equal
        _equal(gg._select_triples_cuda(top_d, v, 200_000, 8),
               gg._select_triples_plain(top_d, v, 200_000, 8))
    t3 = list(gg._select_triples_plain(top_d, votes, 200_000, 8))
    t3[0][:, 6:], t3[2][:, 6:] = rnd(2), rnd(2)
    args = (tg, top_d, pref, *t3, l, budget, 100)
    want = gg._solve_doublesplices_plain(*args)
    got = gg._solve_doublesplices_cuda(*args)
    _equal([got[k] for k in gg._SHORTEXON_KEYS],
           [want[k] for k in gg._SHORTEXON_KEYS])
    assert want["valid"].any()


def _known_masks(rng, nwords, dev, density):
    """Four random known-site bitvectors of ``nwords`` words (the last
    words too, which INVALID diagonals read) with about ``density`` of
    their bits set, as int32 tensors."""
    out = []
    for _ in range(4):
        bits = (rng.random((nwords, 32)) < density).astype(np.uint64)
        words = (bits << np.arange(32, dtype=np.uint64)).sum(1)
        out.append(torch.from_numpy(words.astype(np.uint32).view(np.int32))
                   .to(dev))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("novel", [True, False])
@pytest.mark.parametrize("density", [0.002, 0.15])
def test_splice_kernels_known_match_plain(spliced, novel, density):
    """K5 and K7 with known-site bitvectors against their plain versions,
    at novel True and False, on sparse and dense random masks, with
    diagonals whose span starts on a word boundary, diagonals next to the
    genome end and INVALID diagonals (which read the vectors' last
    word)."""
    tg, ti, c, f, l, _ = spliced
    p = se.GsnapParams(seed_total=512, ncand=32)
    seed = se._seed_diagonals_plain(ti, c, f, l, p, True)
    top_d, votes, _ = se._top_diagonals_plain(seed[0], 32)
    top_d[0::4, 5] = top_d[0::4, 5] & ~31            # start & 31 == 0
    top_d[1::4, 6] = tg.length - 40 - torch.arange(
        top_d[1::4].shape[0], device=top_d.device) % 30
    top_d[2::4, 7] = 0xFFFFFFFF
    q = se._pack_device(c, f, l, 100)
    _, pref = mmo._prefix_mismatches_plain(tg, q, top_d, l, None, None)
    budget = se.auto_budget(l, 12, 3, -1)
    rng = np.random.default_rng(5)
    known = _known_masks(rng, (tg.length + 31) // 32 + 2, top_d.device,
                         density)
    g = torch.Generator(device="cpu").manual_seed(4)
    rnd = lambda n: torch.randint(0, 32, (len(l), n), generator=g).to(l.device)
    ii, jj, pv = gg._select_pairs_plain(top_d, votes,
                                        gg._splice_pairs_eligible(200_000), 16)
    ii[:, 10:], jj[:, 10:] = rnd(6), rnd(6)
    ii[:, 10], jj[:, 11] = 5, 7
    args = (tg, top_d, pref, ii, jj, pv, l, budget, 100, novel, known)
    want = gg._solve_splices_plain(*args)
    _equal([gg._solve_splices_cuda(*args)[k] for k in gg._SPLICE_KEYS],
           [want[k] for k in gg._SPLICE_KEYS])
    assert want["valid"].any() or (not novel and density < 0.01)
    t3 = list(gg._select_triples_plain(top_d, votes, 200_000, 8))
    t3[0][:, 4:], t3[2][:, 4:] = rnd(4), rnd(4)
    t3[1][:, 4] = 6
    args = (tg, top_d, pref, *t3, l, budget, 100, novel, known)
    want = gg._solve_doublesplices_plain(*args)
    _equal([gg._solve_doublesplices_cuda(*args)[k] for k in gg._SHORTEXON_KEYS],
           [want[k] for k in gg._SHORTEXON_KEYS])


@pytest.mark.cuda
def test_align_batch_gapped_known_alt_cuda_equals_cpu(spliced):
    """align_batch_gapped with known sites (novel off) and an alt genome:
    the card's result tree equals the CPU plain path's."""
    tg, ti, _, _, _, (c, f, l) = spliced
    rng = np.random.default_rng(6)
    known = _known_masks(rng, (tg.length + 31) // 32 + 2, c.device, 0.01)
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    gp = gg.GappedParams(base=se.GsnapParams(seed_total=512))
    got = gg.align_batch_gapped(tg, ti, c, f, l, gp, alt=alt, known=known)
    cpu = lambda x: x.cpu()
    tg_c = GenomeArrays(cpu(tg.ref16), cpu(tg.flag16), tg.length,
                        cpu(tg.chr_offsets))
    ti_c = se.IndexArrays(cpu(ti.offsets), cpu(ti.positions), ti.k, ti.interval)
    want = gg.align_batch_gapped(tg_c, ti_c, cpu(c), cpu(f), cpu(l), gp,
                                 alt=tuple(cpu(a) for a in alt),
                                 known=tuple(cpu(k) for k in known))
    assert set(got) == set(want)
    _equal([got[k].cpu() for k in sorted(want)], [want[k] for k in sorted(want)])


@pytest.mark.cuda
def test_align_batch_gapped_splicing_cuda_equals_cpu(spliced):
    tg, ti, _, _, _, (c, f, l) = spliced
    gp = gg.GappedParams(base=se.GsnapParams(seed_total=512),
                         novelsplicing=True)
    got = gg.align_batch_gapped(tg, ti, c, f, l, gp)
    cpu = lambda x: x.cpu()
    tg_c = GenomeArrays(cpu(tg.ref16), cpu(tg.flag16), tg.length,
                        cpu(tg.chr_offsets))
    ti_c = se.IndexArrays(cpu(ti.offsets), cpu(ti.positions), ti.k, ti.interval)
    want = gg.align_batch_gapped(tg_c, ti_c, cpu(c), cpu(f), cpu(l), gp)
    assert set(got) == set(want)
    _equal([got[k].cpu() for k in sorted(want)], [want[k] for k in sorted(want)])


@pytest.mark.cuda
@pytest.mark.parametrize("seed_total,ncand", [(384, 32), (4096, 128), (0, 128)])
def test_kernels_match_plain(batch, seed_total, ncand):
    tg, ti, c, f, l, _ = batch
    p = se.GsnapParams(seed_total=seed_total, ncand=ncand)
    seed = se._seed_diagonals_plain(ti, c, f, l, p, True)
    _equal(se._seed_diagonals_cuda(ti, c, f, l, p, True), seed)
    top = se._top_diagonals_plain(seed[0], ncand)
    _equal(se._top_diagonals_cuda(seed[0], ncand), top)
    q = se._pack_device(c, f, l, 100)
    mm, pref = mmo._prefix_mismatches_plain(tg, q, top[0], l, None, None)
    _equal(mmo._prefix_mismatches_cuda(tg, q, top[0], l, None, None),
           (mm, pref))
    ii, jj, pv = gg._select_pairs_plain(top[0], top[1],
                                        gg._indel_pairs_eligible(30, 9), 16)
    qp5, qp3 = se._qpos_ranges_plain(seed[0], seed[1], top[0])
    args = (top[0], mm, pref, ii, jj, pv, l, se.auto_budget(l, 12, 3, -1),
            100, qp5, qp3, 9, 30, 4)
    want = gg._solve_indels_plain(*args)
    got = gg._solve_indels_cuda(*args)
    _equal([got[k] for k in gg._INDEL_KEYS], [want[k] for k in gg._INDEL_KEYS])


@pytest.mark.cuda
@pytest.mark.parametrize("conversion", [None, "ct", "ga", "ag", "tc"])
def test_prefix_mismatches_conversions_and_alt(batch, conversion):
    tg, ti, c, f, l, _ = batch
    q = se._pack_device(c, f, l, 100)
    diag = se._seed_diagonals_plain(ti, c, f, l, se.GsnapParams(), True)[0]
    top_d = se._top_diagonals_plain(diag, 32)[0]
    top_d[:, -1] = tg.length - 60                 # runs past the genome end
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    for a in (None, alt):
        _equal(mmo._prefix_mismatches_cuda(tg, q, top_d, l, conversion, a),
               mmo._prefix_mismatches_plain(tg, q, top_d, l, conversion, a))


@pytest.mark.cuda
def test_top_diagonals_long_runs(cuda):
    g = tdevice.generator(1, cuda)
    d = torch.randint(0, 40, (64, 4096), generator=g, device=cuda)
    d[:, ::7] = 0xFFFFFFFF
    _equal(se._top_diagonals_cuda(d, 128), se._top_diagonals_plain(d, 128))


@pytest.mark.cuda
def test_align_batch_gapped_cuda_equals_cpu(batch):
    tg, ti, _, _, _, (c, f, l) = batch
    got = gg.align_batch_gapped(tg, ti, c, f, l)
    cpu = lambda x: x.cpu()
    tg_c = GenomeArrays(cpu(tg.ref16), cpu(tg.flag16), tg.length,
                        cpu(tg.chr_offsets))
    ti_c = se.IndexArrays(cpu(ti.offsets), cpu(ti.positions), ti.k, ti.interval)
    want = gg.align_batch_gapped(tg_c, ti_c, cpu(c), cpu(f), cpu(l))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _ranked_ends(out, b, base, np_):
    """Both ends' ranked pairing hits (rank_hits, no optimal filter) of a
    gather_candidates-layout dict with read 1 in rows :b."""
    return [gg.rank_hits({k: v[s] for k, v in out.items()}, base,
                         apply_optimal=False, maxout=np_)
            for s in (slice(0, b), slice(b, None))]


@pytest.mark.cuda
def test_pair_grid_matches_plain(cuda):
    """K8 against its plain version: on the ranked end hits of planted
    RNA pairs (through K1-K7) and on hand-built hits (lefts above 2^24
    and near 2^31, every pair type, 256 chosen cells), at NP = 16 and 8,
    DNA and RNA pairmax, subopt 0 and 2."""
    rng = np.random.default_rng(41)
    g = synth.make_genome(rng, [400_000, 250_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, cuda)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    base = se.GsnapParams(seed_total=512)
    r1, r2, _ = synth.plant_pairs(rng, g, 512, rna=True)
    r2 = [trun.Record(r.label, r.header, trun.dna.revcomp_str(r.seq),
                      r.quality[::-1]) for r in r2]
    enc = [torch.from_numpy(np.concatenate([a, b])).to(cuda) for a, b in
           zip(trun.encode_batch(r1, 100), trun.encode_batch(r2, 100))]
    out, _ = gg.gather_candidates(tg, ti, None, *enc,
                                  gg.GappedParams(base=base,
                                                  novelsplicing=True))
    planted = (out, enc[2][:512], enc[2][512:], 512)
    hand, len5, len3 = synth.pair_hit_cases(rng, 256, db.chr_ends)
    hand = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v).to(cuda) for k, v in hand.items()}
    cases = 0
    for out, lens5, lens3, b in (
            planted, (hand, torch.from_numpy(len5).to(cuda),
                      torch.from_numpy(len3).to(cuda), 256)):
        for np_, pairmax, subopt in ((16, 1000, 0), (16, 200_000, 2),
                                     (8, 1000, 0)):
            h5, h3 = _ranked_ends(out, b, base, np_)
            args = (h5, h3, lens5, lens3, tg.chr_offsets, pairmax, subopt,
                    100)
            want = pe._pair_grid_plain(*args)
            got = pe._pair_grid_cuda(*args)
            _equal([got[k] for k in pe.PAIR_GRID_KEYS],
                   [want[k] for k in pe.PAIR_GRID_KEYS])
            assert want["npairs"].sum() > 0
            cases += 1
    assert cases == 6


def _gmap_queries(db, g, rng, n):
    """[2n, 128] oligo rows of planted reads (repeat copies, indels,
    junctions) and their reverse complements, as align_cdna_batch makes
    them."""
    recs, _ = synth.plant_reads(rng, g, n, weights=dict(
        sub=2, repeat=2, mid_indel=1, junk=0.5))
    srecs, _ = synth.plant_spliced_reads(rng, g, n // 2)
    seqs = [r.seq for r in recs + srecs]
    seqs += [trun.dna.revcomp_str(x) for x in seqs]
    oligos = np.zeros((len(seqs), 128), np.int32)
    valid = np.zeros((len(seqs), 128), bool)
    for i, x in enumerate(seqs):
        c, f = trun.dna.encode(x)
        oligos[i, : len(c) - 11] = trun.dna.pack_kmers(c, 12)
        valid[i, : len(c) - 11] = ~(np.convolve(f.astype(int), np.ones(12, int),
                                                "valid") > 0)
    return oligos, valid


@pytest.mark.cuda
@pytest.mark.parametrize("H,S,smem", [(1024, 192, True), (64, 8, True),
                                      (128, 512, True), (16384, 192, True),
                                      (1024, 3072, False)])
def test_gmap_seed_and_chain_match_plain(cuda, monkeypatch, H, S, smem):
    """K9 and K10 against their plain versions: hit and segment overflow,
    segment arrays narrower than S, the largest H of 100 bp reads, the
    global-scratch path; both intron limits; a backtrack of one step
    (every chain is deeper)."""
    rng = np.random.default_rng(43)
    g = synth.make_genome(rng, [400_000, 250_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    oligos, valid = (torch.from_numpy(x).to(cuda)
                     for x in _gmap_queries(db, g, rng, 256))
    if not smem:
        monkeypatch.setattr(eng, "SEED_SMEM_BYTES", 0)
    got = eng._seed_segments_cuda(ti.offsets, ti.positions, oligos, valid, 12,
                                  H, S, 100)
    want = eng._seed_segments_plain(ti.offsets, ti.positions, oligos, valid,
                                    12, H, S, 100)
    _equal([got[k] for k in eng.SEG_KEYS], [want[k] for k in eng.SEG_KEYS])
    segs = [want[k] for k in ("qstart", "qend", "diag", "valid")]
    for il, C in ((30, 192), (200_000, 192), (200_000, 1)):
        got = eng._chain_cuda(*segs, 12, il, C)
        want = eng._chain_plain(*segs, 12, il, C)
        _equal([got[k] for k in eng.CHAIN_KEYS],
               [want[k] for k in eng.CHAIN_KEYS])
    assert want["deep"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [32, 128])
def test_gmap_dynprog_matches_plain(cuda, nb):
    """K11 and K12 against banded_matrices -> bridge_intron -> traceback:
    random junction windows with code-5 padding, both gap tiers, all
    three cdna_direction tables, halfp, nosplicing, known-site rewards."""
    rng = np.random.default_rng(nb)
    M, W, NL = 64, 23, 72
    q = rng.integers(0, 5, (2 * nb, M)).astype(np.int32)
    g = rng.integers(0, 5, (2 * nb, NL)).astype(np.int32)
    g[:, :M] = np.where(rng.random((2 * nb, M)) < 0.8, q, g[:, :M])
    len1 = np.tile(rng.integers(2, M + 1, nb), 2).astype(np.int32)
    q[np.arange(M)[None, :] >= len1[:, None]] = 5
    len2 = len1 + 8
    lb, rb = dp.compute_bands(len1, len2, 7)
    late = np.arange(2 * nb) >= nb
    known = torch.from_numpy((rng.integers(0, 2, (nb, NL + 1)) * 20)
                             .astype(np.int32)).to(cuda)
    loff = rng.integers(0, 1000, nb)
    roff = loff + rng.integers(0, 200, nb)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    for open_, ext in ((dp.PAIRED_OPEN, dp.PAIRED_EXTEND),
                       (dp.SINGLE_OPEN, dp.SINGLE_EXTEND)):
        args = (t(q), t(g), t(len1), t(len2), t(lb), t(rb),
                dp.pair_matrix(dp.MISMATCH_HIGHQ), t(late), M, W, open_, ext)
        mats = dp._banded_matrices_plain(*args)
        _equal(dp._banded_matrices_cuda(*args), mats)
        for cd, halfp, nospl, kn in ((1, False, False, known * 0),
                                     (-1, True, False, known),
                                     (0, False, True, known * 0)):
            bargs = (mats, t(len1[:nb]), t(len2[:nb]), t(len2[nb:]),
                     t(lb[:nb]), t(lb[nb:]), t(g[:nb]), t(g[nb:]), kn, kn,
                     t(loff), t(roff), M, W, M + NL + 2, open_, ext, 30, cd,
                     True, halfp, nospl)
            _equal(dp._bridge_traceback_cuda(*bargs),
                   dp._bridge_traceback_plain(*bargs))


def test_gmap_wrappers_reject_other_devices():
    meta = torch.empty((2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        eng.seed_segments(meta[0], meta[0], meta, meta.bool(), 12, 64, 8, 100)
    with pytest.raises(ValueError, match="unsupported device"):
        eng.chain(meta, meta, meta.long(), meta.bool(), 12, 30)
    with pytest.raises(ValueError, match="unsupported device"):
        dp.banded_matrices(meta, meta, meta[0], meta[0], meta[0], meta[0],
                           dp.pair_matrix(-3), meta[0].bool(), 64, 23, -18, -3)
    mats = (torch.empty((4, 65, 23), device="meta"),) * 4
    with pytest.raises(ValueError, match="unsupported device"):
        dp.bridge_traceback(mats, *(meta[0, :2],) * 11, 64, 23, 138, -18, -3,
                            30, 1, True, False)


def test_wrappers_reject_other_devices():
    meta = torch.empty((2, 100), dtype=torch.uint8, device="meta")
    idx = se.IndexArrays(torch.empty(5, dtype=torch.int32, device="meta"),
                         torch.empty(5, dtype=torch.int32, device="meta"), 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        se.seed_diagonals(idx, meta, meta.bool(), meta[:, 0].int(),
                          se.GsnapParams())
    with pytest.raises(ValueError, match="unsupported device"):
        se.top_diagonals(meta.long(), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gg.select_triples(meta.long(), meta.int(), 200_000, 8)
    hits = {"left": meta.long()}
    with pytest.raises(ValueError, match="unsupported device"):
        pe.pair_grid(hits, hits, meta[:, 0].int(), meta[:, 0].int(),
                     meta[0].long(), 1000, 0, 100)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "_lib", None)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(kbuild.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.library()


def test_launch_checks_arguments_before_building(monkeypatch):
    def no_build():
        raise AssertionError("library() must not be reached")

    monkeypatch.setattr(kbuild, "library", no_build)
    before = kbuild.LAUNCHES["gsnap_top_diagonals"]
    dev = torch.device("cuda", 0)
    with pytest.raises(TypeError):
        kbuild.launch("gsnap_top_diagonals", dev, None)
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="expected contiguous on cuda"):
        kbuild.launch("gsnap_top_diagonals", dev, t, t, t, t, t, 1, 4, 4, 2)
    assert kbuild.LAUNCHES["gsnap_top_diagonals"] == before


def test_device_helpers():
    a = torch.randint(0, 1000, (8,), generator=tdevice.generator(5, "cpu"))
    b = torch.randint(0, 1000, (8,), generator=tdevice.generator(5, "cpu"))
    assert torch.equal(a, b)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


@pytest.mark.parametrize("with_known", [False, True])
def test_splice_wrappers_argument_order(monkeypatch, with_known):
    """K5's and K7's wrappers hand the C entry points their arguments in
    the declared order (checked on the CPU with the launch captured): the
    known-site words (or null pointers) after the outputs, then the
    genome's word count, then the known vectors' word count and the
    novel flag."""
    seen = {}
    monkeypatch.setattr(kbuild, "launch",
                        lambda name, dev, *a: seen.__setitem__(name, a))
    g = GenomeArrays(torch.zeros(96, dtype=torch.int32),
                     torch.zeros(96, dtype=torch.int32), 1000,
                     torch.zeros(2, dtype=torch.int64))
    known = (tuple(torch.full((34,), i, dtype=torch.int32) for i in range(4))
             if with_known else None)
    top_d = torch.zeros((2, 8), dtype=torch.int64)
    pref = torch.zeros((2, 8, 101), dtype=torch.int32)
    idx = torch.zeros((2, 4), dtype=torch.int64)
    ok = torch.zeros((2, 4), dtype=torch.bool)
    ln = torch.full((2,), 100, dtype=torch.int32)
    gg._solve_splices_cuda(g, top_d, pref, idx, idx, ok, ln, ln, 100, False,
                           known)
    gg._solve_doublesplices_cuda(g, top_d, pref, idx, idx, idx, ok, ln, ln,
                                 100, True, known)
    for name, nptr, novel in (("gsnap_solve_splices", 22, 0),
                              ("gsnap_solve_doublesplices", 28, 1)):
        a = seen[name]
        assert len(a) == len(kbuild._SIGNATURES[name]) == nptr + 7
        assert kbuild._SIGNATURES[name][nptr - 4:] == "pppplliiiii"
        kw = a[nptr - 4 : nptr]
        assert all((k is None) != with_known for k in kw)
        assert a[nptr : nptr + 2] == (96, 34 if with_known else 0)
        assert a[nptr + 2 :] == (2, 4, 8, 100, novel)


# ------------------------------------------- K13-K16: the cascade's stages

def _dict_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("ncand", [32, 128])
def test_lane_features_matches_plain(batch, cuda, ncand):
    """K13 against _trim_ends_device + _lane_features + _bitpack_mask on
    K3's output for planted reads (mixed lengths, NC = 32 and the wide
    lane's 128) and on hand-built masks (all / no mismatches, reads
    shorter than lmax), at trim scores -3, -1 and 0."""
    tg, ti, c, f, l, _ = batch
    p = se.GsnapParams(seed_total=512 if ncand == 32 else 4096, ncand=ncand)
    seed = se._seed_diagonals_plain(ti, c, f, l, p, True)
    top_d = se._top_diagonals_plain(seed[0], ncand)[0]
    q = se._pack_device(c, f, l, 100)
    mm, pref = mmo._prefix_mismatches_plain(tg, q, top_d, l, None, None)
    hm, hp, hl = synth.mismatch_rows(np.random.default_rng(5), 64, ncand)
    cases = [(mm, pref, l)] + [(torch.from_numpy(x).to(cuda) for x in
                                (hm, hp, hl))]
    for mm_, pref_, l_ in cases:
        for score in (-3, -1, 0):
            want = gg.lane_features(mm_.cpu(), pref_.cpu(), l_.cpu(), 12, 3,
                                    score)
            got = gg._lane_features_cuda(mm_, l_, 12, 3, score)
            _dict_equal({k: v.cpu() for k, v in got.items()}, want)


@pytest.mark.cuda
def test_rank_hits_matches_plain(batch, spliced, cuda):
    """K14 against _rank_hits_plain on gather_candidates' output (DNA and
    spliced reads, both apply_optimal, maxout below and above ncand) and
    on hand-built rows with exact duplicates and equal (score, left) on
    both strands; and its SE epilogue (overflow and lane gates) against
    the plain gates through align_batch_gapped's ranking step."""
    base = se.GsnapParams(seed_total=512)
    cases = []
    for tg, ti, _, _, _, (c, f, l) in (batch, spliced):
        for novel in (False, True):
            gp = gg.GappedParams(base=base, novelsplicing=novel)
            out, cands = gg.gather_candidates(tg, ti, None, c, f, l, gp)
            cases.append(out)
            for gate in (True, False):
                args = (out, cands, l.int(), 12, 3, gp, gate)
                want = gg._rank_gate_se_plain(*args)
                got = gg._rank_gate_se_cuda(*args)
                _dict_equal({k: v for k, v in got.items()},
                            {k: v.to(cuda) for k, v in want.items()})
    hand = synth.rank_hit_cases(np.random.default_rng(9), 128, 144)
    cases.append({k: torch.from_numpy(v).to(cuda) for k, v in hand.items()})
    for out in cases:
        ncand = out["score"].shape[1]
        for opt, maxout in ((True, None), (False, 16), (True, ncand + 7)):
            want = gg._rank_hits_plain(out, base, opt, maxout)
            got = gg._rank_hits_cuda(out, base, opt, maxout)[0]
            _dict_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed_total,ncand", [(384, 32), (4096, 128)])
def test_qpos_ranges_matches_plain(batch, seed_total, ncand):
    """K15 against _qpos_ranges_plain on the seed grids of planted reads
    (empty slots carrying the last usable qpos) and INVALID diagonals."""
    tg, ti, c, f, l, _ = batch
    p = se.GsnapParams(seed_total=seed_total, ncand=ncand)
    diag, qg, *_ = se._seed_diagonals_plain(ti, c, f, l, p, True)
    top_d = se._top_diagonals_plain(diag, ncand)[0]
    top_d[:, -3:] = se.INVALID_DIAG
    _equal(se._qpos_ranges_cuda(diag, qg, top_d),
           se._qpos_ranges_plain(diag, qg, top_d))


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [32, 128])
def test_select_pairs_matches_plain(batch, cuda, nc):
    """K16 against _select_pairs_plain, indel and splice rules, on
    planted reads' top diagonals and on hand-built diagonals near 2^31
    and 2^32 with INVALID ones and equal votes; maxpairs 16 and above
    NC^2 for a tiny NC."""
    tg, ti, c, f, l, _ = batch
    p = se.GsnapParams(seed_total=512 if nc == 32 else 4096, ncand=nc)
    diag = se._seed_diagonals_plain(ti, c, f, l, p, True)[0]
    top_d, votes, _ = se._top_diagonals_plain(diag, nc)
    hd, hv = synth.diag_pair_cases(np.random.default_rng(7), 256, nc)
    cases = [(top_d, votes), (torch.from_numpy(hd).to(cuda),
                              torch.from_numpy(hv).to(cuda)),
             (top_d[:, :3].contiguous(), votes[:, :3].contiguous())]
    for td, vt in cases:
        for kw in (dict(max_del=30, max_ins=9), dict(maxdist=200_000),
                   dict(maxdist=2**31 + 5)):
            fn = (gg._splice_pairs_eligible(kw["maxdist"]) if "maxdist" in kw
                  else gg._indel_pairs_eligible(30, 9))
            want = gg._select_pairs_plain(td, vt, fn, 16)
            rule, a, b_ = ((1, kw["maxdist"], 0) if "maxdist" in kw
                           else (0, 30, 9))
            _equal(gg._select_pairs_cuda(td, vt, 16, rule, a, b_), want)
