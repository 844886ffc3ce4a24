"""The CUDA kernels against their plain torch versions on the same CUDA
tensors (marked ``cuda``: they skip where there is no card), and the
wrappers' device rules, which hold on the CPU too.

On a machine with a card (and no JAX, whose import tests/conftest.py
needs):  python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import dataclasses
import io
import os

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
from gmap_gsnap_tpu_torch.kernels import limits as klimits
from gmap_gsnap_tpu_torch.ops import dynprog as dp
from gmap_gsnap_tpu_torch.ops import mismatch as mmo
from gmap_gsnap_tpu_torch.ops.genome import GenomeArrays
from gmap_gsnap_tpu_torch.parallel import shard
from gmap_gsnap_tpu_torch.utils import device as tdevice
from gmap_gsnap_tpu_torch.utils import dna
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
    crc, frc = se._revcomp_batch_plain(ct, ft, lt)
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
    crc, frc = se._revcomp_batch_plain(ct, ft, lt)
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
    q = se._pack_device_plain(c, f, l, 100)
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
    q = se._pack_device_plain(c, f, l, 100)
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
    q = se._pack_device_plain(c, f, l, 100)
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
    q = se._pack_device_plain(c, f, l, 100)
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
@pytest.mark.parametrize("H,S", [(1024, 192), (64, 8), (128, 512),
                                 (16384, 192), (1024, 3072)])
def test_gmap_seed_and_chain_match_plain(cuda, H, S):
    """K9 and K10 against their plain versions: hit and segment overflow,
    segment arrays narrower than S, the largest H of 100 bp reads (a
    global scratch row passed), segment rows as wide as K10 stages; both
    intron limits; a backtrack of one step (every chain is deeper)."""
    rng = np.random.default_rng(43)
    g = synth.make_genome(rng, [400_000, 250_000, 100_000])
    db = synth.genome_db(g, 12, 3)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    oligos, valid = (torch.from_numpy(x).to(cuda)
                     for x in _gmap_queries(db, g, rng, 256))
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
def test_seed_segments_at_the_default_shared_memory_size(cuda):
    """K9 at Q = 1,024, H = 8,192 and S = 4,096, where its dynamic shared
    memory is exactly the 48 KB a CTA gets without the opt-in, which its
    static block-reduction array then needs (a cDNA query of more than
    1,024 segments takes S = 4,096 at the first retry)."""
    assert klimits.seed_segments_bytes(1024, 8192, 4096) == 48 * 1024
    rng = np.random.default_rng(44)
    g = synth.make_genome(rng, [400_000, 250_000])
    db = synth.genome_db(g, 12, 3)
    ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, cuda)
    codes, _ = g.codes_flags
    starts = rng.integers(0, len(codes) - 1100, 6)
    oligos = np.stack([dna.pack_kmers(codes[p : p + 1035], 12)[:1024]
                       for p in starts]).astype(np.int32)
    oligos = torch.from_numpy(oligos).to(cuda)
    valid = torch.ones(oligos.shape, dtype=torch.bool, device=cuda)
    args = (ti.offsets, ti.positions, oligos, valid, 12, 8192, 4096, 100)
    got, want = eng._seed_segments_cuda(*args), eng._seed_segments_plain(*args)
    _equal([got[k] for k in eng.SEG_KEYS], [want[k] for k in eng.SEG_KEYS])
    assert int(want["nsegs"].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("Q,k,thr,H,S,nhits", synth.SEED_SEGMENT_CASES,
                         ids=["Q1", "Q33", "Q128-k15", "Q128-edge"])
def test_seed_segment_cases_match_plain(cuda, Q, k, thr, H, S, nhits):
    """K9 against its plain version on synth.seed_segment_cases (counts 0,
    1, threshold and one above; no valid k-mer; nhits = H and H + 1;
    nsegs = S and S + 1; MIN_SEGLEN and a base shorter; gaps 2k and 2k +
    1; wrapping diagonals) at the case's H and S and at H / 4, S / 2; one
    device op a call."""
    case = synth.seed_segment_cases(np.random.default_rng(Q + k + H), Q, k,
                                    thr, H, S, nhits)
    a = tuple(torch.from_numpy(case[x]).to(cuda)
              for x in ("offsets", "positions", "oligos", "valid"))
    for h, s_ in ((H, S), (max(H // 4, 1), max(S // 2, 1))):
        args = (*a, k, h, s_, thr)
        got = eng._seed_segments_cuda(*args)
        want = eng._seed_segments_plain(*args)
        _equal([got[x] for x in eng.SEG_KEYS], [want[x] for x in eng.SEG_KEYS])
    _one_device_op(lambda: eng._seed_segments_cuda(*a, k, H, S, thr))


def _one_device_op(fn):
    """fn launches one device op (torch.profiler over 3 calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    assert n in (0, 3), n     # 0: a profile that recorded nothing


@pytest.mark.cuda
@pytest.mark.parametrize("S,lvs", synth.CHAIN_CASE_SHAPES)
def test_chain_cases_match_plain(cuda, S, lvs):
    """K10 against its plain version on synth.chain_cases (lv 0, 31, 32,
    33 and S - 1; ties; no valid segment; past 1,024 segments read in
    place), both intron limits, C 192 and 1; one device op a call."""
    case = synth.chain_cases(np.random.default_rng(S), 8, S, lvs)
    a = [torch.from_numpy(case[x]).to(cuda)
         for x in ("qstart", "qend", "diag", "valid")]
    for il, C in ((30, 192), (200_000, 192), (200_000, 1)):
        got = eng._chain_cuda(*a, 12, il, C)
        want = eng._chain_plain(*a, 12, il, C)
        _equal([got[x] for x in eng.CHAIN_KEYS],
               [want[x] for x in eng.CHAIN_KEYS])
    _one_device_op(lambda: eng._chain_cuda(*a, 12, 200_000))


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


def test_shard_lookup_rejects_other_devices():
    meta = torch.empty((2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        shard.shard_index_lookup(meta, meta[0], meta[0], 8, 2)
    with pytest.raises(ValueError, match="rows"):
        shard.shard_index_lookup(meta, meta[0], meta[0], 8, 2, row0=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_seed_and_lookup_match_plain(batch, n):
    """K1 with each shard's bounds against the plain version shard by
    shard, their MIN (seed_diagonals on a ShardedIndexArrays) against K1
    on the whole index, and K18 over every shard and over one, against
    its plain version (starts at shard ends and past the array, counts 0
    to past the cap)."""
    tg, ti, c, f, l, _ = batch
    p = se.GsnapParams()
    sh = shard.ShardedIndexArrays.from_index(ti, n)
    for r in range(n):
        view = se.IndexArrays(sh.offsets, sh.rows[r], 12, 3)
        args = (view, c, f, l, p, True, r * sh.shard_len, sh.shard_len)
        _equal(se._seed_diagonals_cuda(*args), se._seed_diagonals_plain(*args))
    whole = se._seed_diagonals_cuda(ti, c, f, l, p, True)
    before = kbuild.LAUNCHES["gsnap_seed_diagonals"]
    _equal(se.seed_diagonals(sh, c, f, l, p), whole)
    assert kbuild.LAUNCHES["gsnap_seed_diagonals"] == before + n
    rng = np.random.default_rng(n)
    npos = ti.positions.shape[0]
    starts = rng.integers(0, npos, 300)
    starts[:n] = [(r + 1) * sh.shard_len - 3 for r in range(n)]
    starts[n] = npos + 5
    st = torch.from_numpy(starts.astype(np.int32)).to(c.device)
    cn = torch.from_numpy(rng.integers(0, 40, 300).astype(np.int32)).to(
        c.device)
    for rows, row0 in ((sh.rows, 0), (sh.rows[1:2].contiguous(), 1)):
        for cap in (32, 128):
            want = shard._shard_index_lookup_plain(rows, st, cn, cap, n, row0)
            got = shard.shard_index_lookup(rows, st, cn, cap, n, row0)
            assert torch.equal(got, want)


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
        kbuild.launch("gsnap_top_diagonals", dev, t, t, t, t, 1, 4, 2)
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
    q = se._pack_device_plain(c, f, l, 100)
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
@pytest.mark.parametrize("L", [75, 100, 150])
@pytest.mark.parametrize("ncand", [32, 128])
def test_lane_features_edges_match_plain(cuda, L, ncand):
    """K13 on synth.mismatch_edge_rows: untrimmed ends that tie the best
    trims, equal maxima, mismatches only past the read's length, all- and
    no-mismatch rows; rows of L bytes whatever their alignment, and a
    last warp cut short (37 rows); trim scores beyond the read length
    too, which the C entry clamps."""
    hm, hp, hl = synth.mismatch_edge_rows(np.random.default_rng(L), 37,
                                          ncand, L)
    mm, pref, ln = (torch.from_numpy(x).to(cuda) for x in (hm, hp, hl))
    for k, interval in ((12, 3), (15, 3)):
        for score in (-3, -1, 0, -200, 1000):
            want = gg.lane_features(mm.cpu(), pref.cpu(), ln.cpu(), k,
                                    interval, score)
            got = gg._lane_features_cuda(mm, ln, k, interval, score)
            _dict_equal({key: v.cpu() for key, v in got.items()}, want)


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
@pytest.mark.parametrize("w,ncand", [(384, 32), (383, 32), (385, 32),
                                     (4096, 128), (4096, 4096), (64, 64),
                                     (20000, 128), (32768, 16384)])
def test_top_diagonals_edges_match_plain(cuda, w, ncand):
    """K2 on synth.diag_vote_rows: votes tied across the cut, fewer heads
    than ncand, all-INVALID rows, one diagonal W times, W off a power of
    two, ncand equal to W, and the block sort's widths up to 32768."""
    rng = np.random.default_rng(w + ncand)
    d = torch.from_numpy(synth.diag_vote_rows(
        rng, 4 * len(synth.DIAG_ROW_KINDS), w, ncand)).to(cuda)
    _equal(se._top_diagonals_cuda(d, ncand), se._top_diagonals_plain(d, ncand))


@pytest.mark.cuda
@pytest.mark.parametrize("edge", synth.RANK_EDGE_KINDS)
def test_rank_hits_edges_match_plain(cuda, edge):
    """K14 on synth.rank_hit_edges rows at 1, 144, 336 and 512
    candidates, the optimal filter on and off, maxout above n."""
    rng = np.random.default_rng(29)
    base = se.GsnapParams(subopt_levels=1)
    for n in (1, 144, 336, 512):
        out = {k: torch.from_numpy(v).to(cuda)
               for k, v in synth.rank_hit_edges(rng, 64, n, edge).items()}
        for opt, maxout in ((True, None), (False, 16), (True, n + 9)):
            _dict_equal(gg._rank_hits_cuda(out, base, opt, maxout)[0],
                        gg._rank_hits_plain(out, base, opt, maxout))


@pytest.mark.cuda
@pytest.mark.parametrize("with_se", [False, True])
def test_rank_hits_is_one_launch(batch, cuda, with_se):
    """One _rank_hits_cuda call, with and without the SE epilogue, is one
    launch of K14 and returns every key of the plain version's dict with
    its dtype."""
    tg, ti, _, _, _, (c, f, l) = batch
    gp = gg.GappedParams(base=se.GsnapParams())
    out, cands = gg.gather_candidates(tg, ti, None, c, f, l, gp)
    before = kbuild.LAUNCHES["gsnap_rank_hits"]
    if with_se:
        args = (out, cands, l.int(), 12, 3, gp, True)
        got, want = gg._rank_gate_se_cuda(*args), gg._rank_gate_se_plain(*args)
    else:
        got = gg._rank_hits_cuda(out, gp.base)[0]
        want = gg._rank_hits_plain(out, gp.base)
    assert kbuild.LAUNCHES["gsnap_rank_hits"] == before + 1
    assert list(got) == list(want)
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
@pytest.mark.parametrize("w,p", [(1, 1), (31, 32), (33, 32), (384, 32),
                                 (4096, 128), (385, 1)])
def test_qpos_ranges_edges_match_plain(cuda, w, p):
    """K15 on synth.qpos_range_cases: selected diagonals repeated and
    INVALID, rows whose every slot is INVALID, diagonals 0 and
    0xFFFFFFFE, qpos not monotone; W off a multiple of 4 (the kernel's
    16-byte loads then give way to single ones)."""
    args = [torch.from_numpy(x).to(cuda) for x in synth.qpos_range_cases(
        np.random.default_rng(w + p), 64, w, p)]
    _equal(se._qpos_ranges_cuda(*args), se._qpos_ranges_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("w,nc", [(32769, 32), (40000, 128), (100000, 1024),
                                  (818100, 128)])
def test_top_diagonals_wide_rows_match_plain(cuda, w, nc):
    """K2's path for rows wider than 32,768 slots (the runner's exact seed
    grid: S x the size threshold, 818,100 for 8,181 k-mers at 100) on
    synth.diag_vote_rows: ties across the cut, fewer heads, all-INVALID
    rows, one diagonal W times, every vote 1."""
    d = torch.from_numpy(synth.diag_vote_rows(np.random.default_rng(w), 12,
                                              w, nc)).to(cuda)
    _equal(se._top_diagonals_cuda(d, nc), se._top_diagonals_plain(d, nc))


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [2, 3, 31, 32, 33, 64, 128])
def test_select_triples_edges_match_plain(cuda, nc):
    """K6 on synth.triple_cases (clusters, differences that wrap uint32,
    equal and zero votes, all-INVALID rows, sums at the key's width 2^23
    - 2) at maxdist 0, 1 and 2^32 - 1 and T = 1, 8 and 4 NC."""
    top, votes = (torch.from_numpy(x).to(cuda) for x in
                  synth.triple_cases(np.random.default_rng(nc), 96, nc))
    for maxdist in (0, 1, 200_000, 2**32 - 1):
        for t in sorted({1, 8, 4 * nc}):
            _equal(gg._select_triples_cuda(top, votes, maxdist, t),
                   gg._select_triples_plain(top, votes, maxdist, t))


_TRIPLE_TRAP_SCRIPT = """
import sys, torch
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
v = int(sys.argv[1])
top = torch.tensor([[100, 105, 110]], dtype=torch.int64, device="cuda")
# the middle 105 between 100 and 110: sum v + v + v, or a vote v < 0
w = v if v > 0 else 1
votes = torch.tensor([[w, v, w]], dtype=torch.int32, device="cuda")
out = gg._select_triples_cuda(top, votes, 200_000, 4)
torch.cuda.synchronize()
print("no trap", out[0].tolist(), out[3].tolist())
"""


@pytest.mark.cuda
@pytest.mark.parametrize("vote", [2**22, -20])
def test_select_triples_key_out_of_range_traps(cuda, vote):
    """A vote sum of a valid triple the key cannot hold (3 x 2^22, above
    2^23 - 2) or a negative vote of a valid diagonal (which ranks below
    an ineligible entry) stops K6 with a trap, and the launch fails:
    neither is ever clamped.  In a process of its own, since a trap ends the
    CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRIPLE_TRAP_SCRIPT,
                           str(vote)], cwd=repo, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "no trap" not in proc.stdout


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


@pytest.mark.cuda
@pytest.mark.parametrize("nc,maxpairs", [(3, 16), (24, 16), (32, 16),
                                         (32, 1024), (128, 16),
                                         (128, 16384)])
def test_select_pairs_edges_match_plain(cuda, nc, maxpairs):
    """K16 on synth.diag_pair_rows (no eligible pair, fewer than
    maxpairs, equal vote sums, sums at the key's width limit) under both
    rules, NC off a power of two, maxpairs above NC^2 and equal to it at
    NC = 128 (every entry selected and sorted)."""
    top, votes = (torch.from_numpy(x).to(cuda) for x in synth.diag_pair_rows(
        np.random.default_rng(nc + maxpairs), 64, nc))
    for rule, a, b_, fn in ((0, 30, 9, gg._indel_pairs_eligible(30, 9)),
                            (1, 200_000, 0,
                             gg._splice_pairs_eligible(200_000)),
                            (1, 2**31 + 5, 0,
                             gg._splice_pairs_eligible(2**31 + 5))):
        _equal(gg._select_pairs_cuda(top, votes, maxpairs, rule, a, b_),
               gg._select_pairs_plain(top, votes, fn, maxpairs))


_TRAP_SCRIPT = """
import sys, torch
from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
v = int(sys.argv[1])
top = torch.tensor([[100, 105, 110]], dtype=torch.int64, device="cuda")
votes = torch.tensor([[v, v, 1]], dtype=torch.int32, device="cuda")
out = gg._select_pairs_cuda(top, votes, 4, 1, 200_000, 0)
torch.cuda.synchronize()
print("no trap", out[0].tolist(), out[2].tolist())
"""


@pytest.mark.cuda
@pytest.mark.parametrize("vote", [2**17, -2])
def test_select_pairs_key_out_of_range_traps(cuda, vote):
    """An eligible vote sum the key cannot hold (2^18 - 1 and above, or
    below 0) stops K16 with a trap, and the launch fails: it is never
    clamped into the key.  In a process of its own, since a trap ends
    the CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, str(vote)],
                          cwd=repo, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "no trap" not in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("nc,novel,with_known", [
    (32, True, False), (32, True, True), (32, False, True),
    (128, True, False), (128, True, True), (128, False, True)])
def test_solve_doublesplices_edges_match_plain(cuda, nc, novel, with_known):
    """K7 on synth.doublesplice_cases: more than 8 candidates per
    junction, sites at s = 2 and s = len - 2, diagonals 63 and 64, at the
    genome end and INVALID, reads shorter than L, equal keys on both
    strands; the known-site masks with novel splicing on and off."""
    case = synth.doublesplice_cases(np.random.default_rng(nc), 64, nc)
    codes = case["codes"]
    tg = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                  [len(codes)], cuda)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()
         if k != "known"}
    known = (tuple(torch.from_numpy(k.view(np.int32).copy()).to(cuda)
                   for k in case["known"]) if with_known else None)
    args = (tg, t["top_d"], t["pref"], t["ti"], t["tm"], t["tj"],
            t["tvalid"], t["lengths"], t["budget"], 100, novel, known)
    want = gg._solve_doublesplices_plain(*args)
    _equal([gg._solve_doublesplices_cuda(*args)[k] for k in gg._SHORTEXON_KEYS],
           [want[k] for k in gg._SHORTEXON_KEYS])
    assert want["valid"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("nc,novel,with_known", [
    (32, True, False), (32, True, True), (32, False, True),
    (128, True, False), (128, True, True), (128, False, True)])
def test_solve_splices_edges_match_plain(cuda, nc, novel, with_known):
    """K5 on synth.splice_pair_cases: more than 16 candidates a class
    (the first-16 rule decides), diagonals 63 and 64, at the genome end,
    near 2^32 and INVALID, equal sums and antisense equal to sense, known
    bits at word boundaries and in the vectors' last words, budgets 0-6
    and pairs that are not valid; novel splicing on and off."""
    case = synth.splice_pair_cases(np.random.default_rng(nc), 64, nc)
    codes = case["codes"]
    tg = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                  [len(codes)], cuda)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()
         if k != "known"}
    known = (tuple(torch.from_numpy(k.view(np.int32).copy()).to(cuda)
                   for k in case["known"]) if with_known else None)
    args = (tg, t["top_d"], t["pref"], t["ii"], t["jj"], t["pvalid"],
            t["lengths"], t["budget"], 100, novel, known)
    want = gg._solve_splices_plain(*args)
    _equal([gg._solve_splices_cuda(*args)[k] for k in gg._SPLICE_KEYS],
           [want[k] for k in gg._SPLICE_KEYS])
    assert want["valid"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [75, 100, 150, 1024])
def test_prefix_mismatches_edges_match_plain(cuda, monkeypatch, L):
    """K3 on synth.prefix_mismatch_cases: 37 x 24 placements (the last
    tile cut short), INVALID diagonals and diagonals at and past the
    genome end, genome N runs and query Ns, reads of 1, 15, 16 and 17 nt;
    every conversion, with and without an alt genome, under both N
    rules."""
    case = synth.prefix_mismatch_cases(np.random.default_rng(L), 37, 24, L)
    tg = convert.genome_from_host(case["gcodes"], case["gflags"],
                                  [len(case["gcodes"])], cuda)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    q = se._pack_device_plain(t["codes"], t["nflags"], t["lengths"], L)
    alt = (tg.ref16.flip(0).contiguous(), tg.flag16)
    for qunk, gunk in ((False, True), (True, False)):
        monkeypatch.setattr(mmo, "QUERY_UNK_MISMATCH", qunk)
        monkeypatch.setattr(mmo, "GENOME_UNK_MISMATCH", gunk)
        for conv in (None, "ct", "ga", "ag", "tc"):
            for a in (None, alt):
                args = (tg, q, t["diags"], t["lengths"], conv, a)
                _equal(mmo._prefix_mismatches_cuda(*args),
                       mmo._prefix_mismatches_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [75, 100, 150, 1024])
@pytest.mark.parametrize("min_end", [0, 4, 60])
def test_solve_indels_edges_match_plain(cuda, L, min_end):
    """K4 on synth.indel_pair_cases: insertions of every shift 1-9,
    deletions of 1, 2, 30 and 31, differences that wrap in uint32 and
    int32, pairs of a read naming the same rows (and one row twice), a
    candidate only at s = L (min_end 0), ties in total, rows without
    mismatches (no candidate: nmm1 at GSNAP_BIG_SCORE's split), min_end
    past half the read; with and without the seed-order gate."""
    case = synth.indel_pair_cases(np.random.default_rng(L + min_end), 64,
                                  32, 16, L)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    for gate in (True, False):
        args = (t["top_d"], t["mm"], t["pref"], t["ii"], t["jj"],
                t["pvalid"], t["lengths"], t["budget"], L,
                t["qp5"] if gate else None, t["qp3"] if gate else None, 9,
                30, min_end)
        want = gg._solve_indels_plain(*args)
        _equal([gg._solve_indels_cuda(*args)[k] for k in gg._INDEL_KEYS],
               [want[k] for k in gg._INDEL_KEYS])
        assert want["valid"].any() or min_end == 60


@pytest.mark.cuda
def test_align_batch_gapped_long_reads_cuda_equals_cpu(cuda):
    """align_batch_gapped at -N 1 on reads of 513 to 1024 nt (K3 loops
    over a row's words; K1, K13 and the rest at their limits), the card
    against the CPU plain path."""
    rng = np.random.default_rng(29)
    g = synth.make_genome(rng, [400_000, 250_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_spliced_reads(rng, g, 64,
                                        L=mmo.CUDA_MAX_READ_LENGTH)
    cut = rng.integers(513, mmo.CUDA_MAX_READ_LENGTH + 1, len(recs))
    recs = [dataclasses.replace(r, seq=r.seq[:n], quality=r.quality[:n])
            for r, n in zip(recs, cut)]
    enc = trun.encode_batch(recs, mmo.CUDA_MAX_READ_LENGTH)
    gp = gg.GappedParams(base=se.GsnapParams(seed_total=512),
                         novelsplicing=True)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, dev)
        ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, dev)
        outs.append(gg.align_batch_gapped(
            tg, ti, *(torch.from_numpy(x).to(dev) for x in enc), gp))
    _dict_equal({k: v.cpu() for k, v in outs[0].items()}, outs[1])
    assert int((outs[1]["npaths"] > 0).sum()) > len(recs) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("L,nreads", [(8192, 6),
                                      (mmo.CUDA_MAX_READ_LENGTH, 4)])
def test_long_reads_cuda_equals_cpu(cuda, L, nreads):
    """Reads of 8,192 nt and of the card's limit (CUDA_MAX_READ_LENGTH,
    14,432 nt) on the card: align_batch_gapped -N 1 (K1 with its k-mers
    in dynamic shared memory, K3, K4, K5 and K7 with fewer warps a CTA,
    K13's wide keys and staging) and GsnapRunner.run at -N 1 with the
    default GMAP lanes (K2's wide path on the runner's exact seed grid),
    against the CPU plain path."""
    rng = np.random.default_rng(31 if L == 8192 else 37)
    g = synth.make_genome(rng, [400_000, 250_000])
    db = synth.genome_db(g, 12, 3)
    recs, _ = synth.plant_spliced_reads(rng, g, nreads, L=L)
    enc = trun.encode_batch(recs, L)
    gp = gg.GappedParams(base=se.GsnapParams(seed_total=512),
                         novelsplicing=True)
    outs, sams = [], []
    before = dict(kbuild.LAUNCHES)
    for dev in (cuda, torch.device("cpu")):
        tg = convert.genome_from_host(db.codes, db.flags, db.chr_ends, dev)
        ti = convert.index_from_arrays(db.offsets, db.positions, 12, 3, dev)
        outs.append(gg.align_batch_gapped(
            tg, ti, *(torch.from_numpy(x).to(dev) for x in enc), gp))
        out = io.StringIO()
        trun.GsnapRunner(db, lmax=L, novelsplicing=True,
                         device=dev).run(recs, out, batch_size=8)
        sams.append(out.getvalue())
    _dict_equal({k: v.cpu() for k, v in outs[0].items()}, outs[1])
    assert int((outs[1]["npaths"] > 0).sum()) > len(recs) // 2
    assert sams[0] == sams[1]
    for name in ("gsnap_seed_diagonals", "gsnap_top_diagonals_wide",
                 "gsnap_prefix_mismatches", "gsnap_solve_indels",
                 "gsnap_lane_features", "gsnap_solve_splices",
                 "gsnap_solve_doublesplices"):
        assert kbuild.LAUNCHES[name] > before.get(name, 0), name


# ------------------------------- K17 and K8's overflow-gate epilogue

def _pack_inputs(rng, b, lmax, cuda):
    """Reads with the edge lengths 1, 15, 16, 17 and lmax, random ones,
    N runs and random codes past each length."""
    c = rng.integers(0, 4, (b, lmax)).astype(np.uint8)
    f = rng.random((b, lmax)) < 0.03
    f[::7, lmax // 3 : lmax // 3 + 9] = True
    ln = rng.integers(1, lmax + 1, b).astype(np.int32)
    edges = [x for x in (1, 15, 16, 17) if x <= lmax] + [lmax]
    ln[: len(edges)] = edges
    return tuple(torch.from_numpy(x).to(cuda) for x in (c, f, ln))


def _packed_equal(got, want):
    for g, w in zip(got, want):
        if isinstance(w, mmo.PackedQueries):
            _equal([g.codes16, g.nflags16, g.length], [w.codes16, w.nflags16,
                                                        w.length.int()])
            assert g.lmax == w.lmax
        else:
            _equal([g], [w])


@pytest.mark.cuda
@pytest.mark.parametrize("lmax", [100, 17, 16, 151])
def test_pack_batch_matches_plain(cuda, lmax):
    """K17 against _pack_batch_plain, mixed lengths and (on the reads of
    length lmax) the uniform flip; then on synth.pack_query_cases at every
    PACK_QUERY_SHAPES of this lmax (lmax 100 also takes the others), both
    uniform forms, on the batch and on its rows from the second on (rows
    that start off a 4-byte boundary where lmax is odd)."""
    c, f, ln = _pack_inputs(np.random.default_rng(lmax), 1024, lmax, cuda)
    _packed_equal(se._pack_batch_cuda(c, f, ln), se._pack_batch_plain(c, f, ln))
    full = ln == lmax
    args = (c[full].contiguous(), f[full].contiguous(), ln[full], True)
    _packed_equal(se._pack_batch_cuda(*args), se._pack_batch_plain(*args))
    for b, L in synth.PACK_QUERY_SHAPES:
        if L != lmax and (lmax != 100 or L in (17, 16, 151)):
            continue
        for uniform in (False, True):
            c, f, ln = (torch.from_numpy(x).to(cuda) for x in
                        synth.pack_query_cases(np.random.default_rng(b + L),
                                               b, L, uniform))
            for rows in (slice(None), slice(1, None)):
                a = (c[rows], f[rows], ln[rows], uniform)
                _packed_equal(se._pack_batch_cuda(*a),
                              se._pack_batch_plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("novel", [False, True])
def test_pair_grid_gate_matches_plain(cuda, novel):
    """K8 with its gate epilogue against _pair_grid_plain +
    _pair_gate_plain on hand-built rows where each gate term flips
    (synth.pair_gate_cases; bounds of 2^31 - 2 wrap the int32 sums), and
    without the gate (known sites): the overflow flags stay as given."""
    rng = np.random.default_rng(43 + novel)
    b = 512
    hand, len5, len3 = synth.pair_hit_cases(rng, b, [500_000, 2**32])
    cands = synth.pair_gate_cases(rng, b)
    hand = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v).to(cuda) for k, v in hand.items()}
    base = se.GsnapParams()
    h5, h3 = _ranked_ends(hand, b, base, 16)
    offs = torch.tensor([0, 500_000, 2**32], dtype=torch.int64, device=cuda)
    lens = (torch.from_numpy(len5).to(cuda), torch.from_numpy(len3).to(cuda))
    for ipm, gate_on in ((2, True), (0, True), (2, False)):
        c5, c3 = ({k: torch.from_numpy(v[s]).to(cuda) for k, v in cands.items()}
                  for s in (slice(0, b), slice(b, None)))
        w5, w3 = dict(c5), dict(c3)
        args = (h5, h3, *lens, offs, 200_000, 0, 100)
        want = pe._pair_grid_plain(*args)
        got = pe._pair_grid_cuda(*args, (c5, c3, ipm, novel) if gate_on
                                 else None)
        _equal([got[k] for k in pe.PAIR_GRID_KEYS],
               [want[k] for k in pe.PAIR_GRID_KEYS])
        if gate_on:
            o5, o3 = pe._pair_gate_plain(want, h5, h3, w5, w3, 0, ipm, novel)
            _equal([c5["overflow"], c3["overflow"]], [o5, o3])
            assert (o5 != w5["overflow"]).any() and o5.any()
        else:
            _equal([c5["overflow"], c3["overflow"]],
                   [w5["overflow"], w3["overflow"]])


def _junction_args(case, dev, W, T, table, open_, ext):
    """bridge_traceback's arguments from a junction_traceback_cases dict
    (or one of its layout) on dev, M = 64."""
    cd, halfp, nospl, known = table
    t = lambda k: torch.from_numpy(np.ascontiguousarray(case[k])).to(dev)
    kn = t("known") if known else torch.zeros_like(t("known"))
    mats = tuple(t(k) for k in ("nogap", "gap1", "gap2", "ndiag"))
    return (mats, t("len1"), t("len2L"), t("len2R"), t("lbandL"),
            t("lbandR"), t("gl"), t("grv"), kn, kn, t("loff"), t("roff"), 64,
            W, T, open_, ext, 30, cd, True, halfp, nospl)


JUNCTION_TABLES = ((1, False, False, False), (-1, True, False, True),
                   (0, False, False, False), (1, False, True, True))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [23, 32])
@pytest.mark.parametrize("T", [138, 6])
def test_bridge_traceback_edges_match_plain(cuda, W, T):
    """K12 against its plain version on synth.junction_traceback_cases
    (ties under jump early and late, walks past k = 0 and past k = W - 1,
    len1 2 and 64) and on band-sweep windows at W (the kernel's dynamic
    shared memory passes 48 KB at W = 32), every table, both gap tiers;
    T = 6 cuts every walk."""
    cases = [synth.junction_traceback_cases(np.random.default_rng(W + s),
                                            nb, 64, W, 72)
             for s, nb in ((0, 24), (1, 300))]
    rng = np.random.default_rng(W)
    nb = 64
    q = rng.integers(0, 5, (2 * nb, 64)).astype(np.int32)
    g = rng.integers(0, 5, (2 * nb, 72)).astype(np.int32)
    g[:, :64] = np.where(rng.random((2 * nb, 64)) < 0.8, q, g[:, :64])
    len1 = np.tile(np.r_[2, 64, rng.integers(2, 65, nb - 2)], 2).astype(
        np.int32)
    q[np.arange(64)[None, :] >= len1[:, None]] = 5
    lb, rb = dp.compute_bands(len1, len1 + 8, 7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    mats = dp._banded_matrices_cuda(
        t(q), t(g), t(len1), t(len1 + 8), t(lb), t(rb),
        dp.pair_matrix(dp.MISMATCH_HIGHQ), t(np.arange(2 * nb) >= nb), 64, W,
        dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
    loff = rng.integers(0, 1000, nb)
    cases.append(dict(
        nogap=mats[0].cpu().numpy(), gap1=mats[1].cpu().numpy(),
        gap2=mats[2].cpu().numpy(), ndiag=mats[3].cpu().numpy(),
        len1=len1[:nb], len2L=len1[:nb] + 8, len2R=len1[nb:] + 8,
        lbandL=lb[:nb], lbandR=lb[nb:], gl=g[:nb], grv=g[nb:],
        known=(rng.integers(0, 2, (nb, 73)) * 20).astype(np.int32),
        loff=loff, roff=loff + rng.integers(0, 200, nb)))
    for case in cases:
        for open_, ext in ((dp.PAIRED_OPEN, dp.PAIRED_EXTEND),
                           (dp.SINGLE_OPEN, dp.SINGLE_EXTEND)):
            for table in JUNCTION_TABLES:
                a = _junction_args(case, cuda, W, T, table, open_, ext)
                _equal(dp._bridge_traceback_cuda(*a),
                       dp._bridge_traceback_plain(*a))


@pytest.mark.cuda
def test_bridge_traceback_at_its_shared_memory_limit(cuda):
    """K12 at the largest M whose shared memory kernels/limits.py admits
    (W = 32, NL = NR = M + 8, T = M + NL + 2: about 227 KB of dynamic
    shared memory) against its plain version; one row more is refused."""
    def fits(m):
        return klimits.bridge_traceback_bytes(m, 32, m + 8, m + 8,
                                              2 * m + 10) <= klimits.SMEM_MAX

    m = max(x for x in range(64, 1024) if fits(x))
    rng = np.random.default_rng(m)
    nb = 16
    shape = (2 * nb, m + 1, 32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    mats = tuple(t(rng.integers(-30, 31, shape).astype(np.int32))
                 for _ in range(3)) + (t(rng.random(shape) < 0.3),)
    len1 = t(rng.integers(2, m + 1, nb).astype(np.int32))
    lb = t(rng.integers(0, 8, nb).astype(np.int32))
    win = t(rng.integers(0, 5, (nb, m + 8)).astype(np.int32))
    kn = t((rng.integers(0, 2, (nb, m + 9)) * 20).astype(np.int32))
    off = t(rng.integers(0, 1000, nb))
    a = (mats, len1, len1 + 8, len1 + 8, lb, lb, win, win, kn, kn, off,
         off + 50, m, 32, 2 * m + 10, dp.PAIRED_OPEN, dp.PAIRED_EXTEND, 30,
         0, True, False, False)
    _equal(dp._bridge_traceback_cuda(*a), dp._bridge_traceback_plain(*a))
    assert not fits(m + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("np_", [1, 7, 16])
def test_pair_grid_edges_match_plain(cuda, np_):
    """K8 against its plain grid and gate on synth.pair_grid_edges (1,000
    chromosome offsets, rows whose every cell is BIG, rows of one pair
    score, lefts above 2^24 and near 2^31) at NP = np_, K = 1, NP^2 and
    100, with and without the gate."""
    rng = np.random.default_rng(np_)
    b = 1024
    hits, len5, len3, offsets = synth.pair_grid_edges(rng, b)
    cands = synth.pair_gate_cases(rng, b)
    t = lambda v: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                   else v).to(cuda)
    h5, h3 = _ranked_ends({k: t(v) for k, v in hits.items()}, b,
                          se.GsnapParams(), np_)
    lens = (t(len5), t(len3))
    for K in sorted({1, np_ * np_, min(100, np_ * np_)}):
        for pairmax, subopt, gate_on in ((200_000, 2, True), (1000, 0, False)):
            c5, c3 = ({k: t(v[s]) for k, v in cands.items()}
                      for s in (slice(0, b), slice(b, None)))
            w5, w3 = dict(c5), dict(c3)
            args = (h5, h3, *lens, t(offsets), pairmax, subopt, K)
            want = pe._pair_grid_plain(*args)
            got = pe._pair_grid_cuda(*args, (c5, c3, 1, True) if gate_on
                                     else None)
            _equal([got[k] for k in pe.PAIR_GRID_KEYS],
                   [want[k] for k in pe.PAIR_GRID_KEYS])
            assert (want["npairs"] == 0).any() and (want["npairs"] > 0).any()
            if gate_on:
                o5, o3 = pe._pair_gate_plain(want, h5, h3, w5, w3, subopt, 1,
                                             True)
                _equal([c5["overflow"], c3["overflow"]], [o5, o3])


def test_pack_and_gate_wrappers_argument_order(monkeypatch):
    """K17's and K8's wrappers hand the C entry points as many arguments
    as they declare (checked on the CPU with the launch captured), the
    gate's ten pointers null and its flag 0 without a gate."""
    seen = {}
    monkeypatch.setattr(kbuild, "launch",
                        lambda name, dev, *a: seen.setdefault(name, []).append(a))
    c = torch.zeros((3, 40), dtype=torch.uint8)
    se._pack_batch_cuda(c, c.bool(), torch.full((3,), 40, dtype=torch.int32))
    a = seen["gsnap_pack_queries"][0]
    assert len(a) == len(kbuild._SIGNATURES["gsnap_pack_queries"])
    assert a[9:] == (3, 40, 3, 0)
    rng = np.random.default_rng(5)
    hand, len5, len3 = synth.pair_hit_cases(rng, 4, [500_000])
    hand = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v) for k, v in hand.items()}
    h5, h3 = _ranked_ends(hand, 4, se.GsnapParams(), 16)
    cands = synth.pair_gate_cases(rng, 4)
    c5, c3 = ({k: torch.from_numpy(v[s]) for k, v in cands.items()}
              for s in (slice(0, 4), slice(4, None)))
    offs = torch.tensor([0, 500_000], dtype=torch.int64)
    for gate in (None, (c5, c3, 2, True)):
        pe._pair_grid_cuda(h5, h3, torch.from_numpy(len5),
                           torch.from_numpy(len3), offs, 1000, 0, 100, gate)
    sig = kbuild._SIGNATURES["gsnap_pair_grid"]
    for a, on in zip(seen["gsnap_pair_grid"], (0, 1)):
        assert len(a) == len(sig)
        assert all((x is None) != bool(on) for x in a[28:38])
        assert a[38:] == (4, 16, 100, 2, 1000, 0, on, 2 * on, on)


def test_rank_hits_wrapper_tables(monkeypatch):
    """K14's wrapper hands the C entry point its key and field tables
    (checked on the CPU with the launch captured): the eight keys in the
    kernel's order, the broadcast plusp with row stride 0, every field of
    the hit table with its destination, the score in mode 2 and the
    zeroed fields in mode 1; the SE flag and the epilogue's outputs."""
    seen = []
    monkeypatch.setattr(kbuild, "launch",
                        lambda name, dev, *a: seen.append((name, a)))
    b, n = 3, 40
    out = {k: torch.from_numpy(v) for k, v in
           synth.rank_hit_cases(np.random.default_rng(4), b, n).items()}
    out["plusp"] = (torch.arange(n) < n // 2).expand(b, n)
    final, ep = gg._rank_hits_cuda(out, se.GsnapParams(maxpaths=7))
    name, a = seen[0]
    sig = kbuild._SIGNATURES[name]
    assert name == "gsnap_rank_hits" and len(a) == len(sig) and ep is None
    keys, fields, nf = a[0], a[1], a[2]
    assert len(keys) == 6 * len(gg._RANK_KEYS) and nf == len(out)
    for i, k in enumerate(gg._RANK_KEYS):
        t = out[k]
        assert keys[6 * i : 6 * i + 6] == [t.data_ptr(), 0, t.stride(0),
                                           t.stride(1), t.element_size(), 0]
    assert keys[6 * gg._RANK_KEYS.index("plusp") + 2] == 0
    for i, k in enumerate(out):
        mode = 2 if k == "score" else int(k in gg._RANK_ZEROED)
        assert fields[6 * i + 1] == final[k].data_ptr()
        assert fields[6 * i + 4 :6 * i + 6] == [out[k].element_size(), mode]
        assert final[k].shape == (b, 7) and final[k].dtype == out[k].dtype
    assert a[3] is final["npaths"] and all(x is None for x in a[4:27])
    assert a[27:] == (b, n, 7, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0)


def test_rank_and_top_wrappers_refuse(monkeypatch):
    """What the kernels' widths cannot hold raises before any launch:
    K14 beyond 512 candidates or with a floating-point key, K2 beyond
    W=2^24 - 1 or ncand 16384 (1024 past W=32768, its wide path), or
    ncand above W."""
    monkeypatch.setattr(kbuild, "launch", lambda *a: pytest.fail("launched"))
    out = {k: torch.from_numpy(v) for k, v in
           synth.rank_hit_cases(np.random.default_rng(4), 2, 513).items()}
    with pytest.raises(ValueError, match="at most 512"):
        gg._rank_hits_cuda(out, se.GsnapParams())
    out = {k: v[:, :40] for k, v in out.items()}
    out["split"] = out["split"].float()
    with pytest.raises(ValueError, match="key fields are integers"):
        gg._rank_hits_cuda(out, se.GsnapParams())
    for w, nc in ((2**24, 32), (32769, 1025), (32768, 16385), (100, 101)):
        with pytest.raises(ValueError, match="top_diagonals kernel"):
            se._top_diagonals_cuda(
                torch.zeros(1, dtype=torch.int64).expand(1, w), nc)


def test_top_diagonals_wrapper_passes_no_scratch(monkeypatch):
    """K2's wrapper passes the row, its three outputs and (B, W, ncand):
    the kernel keeps the sorted row on chip."""
    seen = []
    monkeypatch.setattr(kbuild, "launch",
                        lambda name, dev, *a: seen.append((name, a)))
    d = torch.zeros((5, 383), dtype=torch.int64)
    top_d, votes, nd = se._top_diagonals_cuda(d, 32)
    name, a = seen[0]
    assert name == "gsnap_top_diagonals"
    assert len(a) == len(kbuild._SIGNATURES[name]) == 7
    assert a[0] is d and a[1] is top_d and a[2] is votes and a[3] is nd
    assert a[4:] == (5, 383, 32)
    assert top_d.shape == (5, 32) and votes.dtype == torch.int32


# ---------------------------------------------- K11 and K1 on their edges

@pytest.mark.cuda
@pytest.mark.parametrize("W,M", [(1, 1), (1, 64), (23, 64), (32, 64),
                                 (32, 1), (23, 100), (32, 33)])
def test_banded_gotoh_edges_match_plain(cuda, W, M):
    """K11 against the plain band sweep on synth.band_sweep_cases (lband
    0, a band of W cells and one past W, len2 below W and len2 = N, codes
    4 and 5, jump late and early), both gap tiers, 20 and 300 problems."""
    for nb in (20, 300):
        case = synth.band_sweep_cases(np.random.default_rng(W + M + nb), nb,
                                      M, W)
        t = lambda k: torch.from_numpy(case[k]).to(cuda)
        for tier in ((dp.PAIRED_OPEN, dp.PAIRED_EXTEND),
                     (dp.SINGLE_OPEN, dp.SINGLE_EXTEND)):
            a = (t("q"), t("g"), t("len1"), t("len2"), t("lband"),
                 t("rband"), dp.pair_matrix(dp.MISMATCH_HIGHQ), t("late"), M,
                 W, *tier)
            _equal(dp._banded_matrices_cuda(*a), dp._banded_matrices_plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("S,q", [(31, 1), (32, 32), (33, 3), (1, 32),
                                 (100, 7)])
def test_seed_diagonals_edges_match_plain(cuda, S, q):
    """K1 against the plain seed diagonals on synth.seed_row_cases (k = 4,
    threshold 5: counts of 0, the threshold and one above it, N runs,
    reads shorter than L and than k, positions below their query
    position, repeat reads that overflow a 24-slot grid), grids of 24 and
    100 slots and the exact one, half on and off."""
    k, thr = 4, 5
    case = synth.seed_row_cases(np.random.default_rng(S), 200, S + k - 1, k,
                                thr)
    t = lambda key: torch.from_numpy(case[key]).to(cuda)
    ti = se.IndexArrays(t("offsets"), t("positions"), k, q)
    for seed_total in (24, 100, 0):
        p = se.GsnapParams(seed_total=seed_total, size_threshold=thr)
        for half in (True, False):
            a = (ti, t("codes"), t("nflags"), t("lengths"), p, half)
            _equal(se._seed_diagonals_cuda(*a), se._seed_diagonals_plain(*a))


def test_banded_gotoh_wrapper_passes_no_copies(monkeypatch):
    """K11's wrapper hands the C entry point the pair matrix as a host
    table of 36 scores (no device copy) and jump_late as a view of its
    bytes (no cast), and raises on a jump_late that is not bool (checked
    on the CPU with the launch captured)."""
    seen = []
    monkeypatch.setattr(kbuild, "launch",
                        lambda name, dev, *a: seen.append((name, a)))
    case = synth.band_sweep_cases(np.random.default_rng(3), 6, 8, 23)
    t = lambda k: torch.from_numpy(case[k])
    late = t("late")
    pm = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    args = (t("q"), t("g"), t("len1"), t("len2"), t("lband"), t("rband"),
            pm, late, 8, 23, dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
    out = dp._banded_matrices_cuda(*args)
    name, a = seen[0]
    assert name == "gmap_banded_gotoh"
    assert len(a) == len(kbuild._SIGNATURES[name])
    assert a[5].dtype == torch.uint8 and a[5].data_ptr() == late.data_ptr()
    assert a[6:10] == out and a[10] == pm.reshape(-1).tolist()
    assert a[11:] == (6, 8, 16, 23, dp.PAIRED_OPEN, dp.PAIRED_EXTEND)
    with pytest.raises(ValueError, match="expected torch.bool"):
        dp._banded_matrices_cuda(*args[:7], late.int(), *args[8:])


GMAP_CLI_KERNELS = ("gmap_seed_segments", "gmap_chain", "gmap_banded_gotoh",
                    "gmap_bridge_traceback")


@pytest.fixture(scope="module")
def gmap_disk(cuda, tmp_path_factory):
    """A 1 Mbp genome built by the port's gmap_build (k = 12) and 16 cDNA
    queries: 12 three-exon ones (half with a messy junction), 2
    chimeras, a duplicated segment and one long query (Q = 65,536)."""
    from gmap_gsnap_tpu_torch.cli import gmap_build

    d = str(tmp_path_factory.mktemp("gmapcard"))
    rng = np.random.default_rng(29)
    g = synth.make_genome(rng, [400_000, 300_000, 300_000])
    reps, _, _ = synth.gmap_repeat_queries(rng, g, 1)
    g.write_fasta(f"{d}/g.fa")
    assert gmap_build.main(["-d", "syn", "-D", d, "-k", "12",
                            f"{d}/g.fa"]) == 0
    q, _ = synth.gmap_queries(rng, g, 12, messy=0.5)
    x, _ = synth.gmap_chimeras(rng, g, 2)
    lq, _ = synth.gmap_long_queries(rng, g, 1)
    synth.write_fasta_records(f"{d}/q.fa", q + x + reps + lq)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["-f", "samse"], ["-A"]])
def test_gmap_cli_matches_cpu(gmap_disk, capsys, flags):
    """The gmap CLI on the card (its default device) prints the bytes it
    prints with --device cpu, and launches K9-K12."""
    from gmap_gsnap_tpu_torch.cli import gmap as tcli

    args = flags + ["-D", gmap_disk, "-d", "syn", f"{gmap_disk}/q.fa"]
    before = {n: kbuild.LAUNCHES[n] for n in GMAP_CLI_KERNELS}
    assert tcli.main(args) == 0
    card = capsys.readouterr().out
    launched = {n: kbuild.LAUNCHES[n] - before[n] for n in GMAP_CLI_KERNELS}
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert card == capsys.readouterr().out
    assert card.count("\n") > 16
    assert all(launched.values()), launched


@pytest.mark.cuda
def test_gmap_query_past_the_engine_refused_on_the_card(gmap_disk):
    """On the card, as on the CPU, a query longer than 65,536 + k - 1
    bases raises ValueError naming its length; one base shorter aligns
    through K9's scratch path."""
    from gmap_gsnap_tpu_torch.align import gmap as tgmap
    from gmap_gsnap_tpu_torch.db.datadir import GenomeDB

    db = GenomeDB.open(f"{gmap_disk}/syn", "syn")
    n = 65_536 + db.k - 1
    rng = np.random.default_rng(5)
    q = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n + 1)]
    q = q.tobytes().decode()
    with pytest.raises(ValueError, match=f"query of {n + 1} bases"):
        tgmap.align_cdna_paths(db, q)
    before = kbuild.LAUNCHES["gmap_seed_segments"]
    assert isinstance(tgmap.align_cdna_paths(db, q[:n]), list)
    assert kbuild.LAUNCHES["gmap_seed_segments"] > before


@pytest.fixture(scope="module")
def multimap_disk(cuda, tmp_path_factory):
    """A 1 Mbp genome with 12 blocks of 400 nt copied to three places
    each, built by the port's gmap_build (k = 12); its genes map
    (synth.copy_genes_gtf through gtf_genes and iit_store) in the maps
    folder, a tally and a runlength map beside it; reads and pairs from the
    copies with planted ordinary ones, as FASTQ."""
    import contextlib

    from gmap_gsnap_tpu_torch.cli import gmap_build, gtf_genes, iit_store

    d = tmp_path_factory.mktemp("mapscard")
    rng = np.random.default_rng(31)
    g = synth.make_genome(rng, [400_000, 300_000, 300_000])
    blocks = synth.duplicate_blocks(rng, g, 12)
    g.write_fasta(str(d / "g.fa"))
    assert gmap_build.main(["-d", "syn", "-D", str(d), "-k", "12",
                            str(d / "g.fa")]) == 0
    reads = synth.plant_copy_reads(rng, g, blocks, 400, 192)[0]
    reads += synth.plant_reads(rng, g, 64, weights=dict(
        sub=3, end_indel=1, terminal=1, repeat=1, junk=1))[0]
    synth.write_fastq(str(d / "se.fq"), reads)
    p1, p2, _ = synth.plant_copy_pairs(rng, g, blocks, 400, 128, far=0.2)
    q1, q2, _ = synth.plant_pairs(rng, g, 64, rna=True)
    synth.write_fastq(str(d / "p_1.fq"), p1 + q1)
    synth.write_fastq(str(d / "p_2.fq"), p2 + q2)
    (d / "genes.gtf").write_text(synth.copy_genes_gtf(g, blocks, 400))
    genes = io.StringIO()
    with contextlib.redirect_stdout(genes):
        assert gtf_genes.main([str(d / "genes.gtf")]) == 0
    (d / "genes.txt").write_text(genes.getvalue())
    (d / "tally.txt").write_text(synth.copy_tally_text(rng, g, blocks, 400))
    (d / "rl.txt").write_text(synth.copy_runlength_text(g, blocks, 400))
    for out, name in ((d / "syn" / "syn.maps" / "genes", "genes"),
                      (d / "tally", "tally"), (d / "rl", "rl")):
        assert iit_store.main(["-o", str(out), str(d / f"{name}.txt")]) == 0
    return d, g


MAPS_ROUTER_CASES = [
    ("se", ["-g", "genes", "-M", "1"]),
    ("pe", ["-N", "1", "-g", "genes", "--favor-multiexon", "--use-tally",
            "tally", "--tallydir", "DIR", "--use-runlength", "rl",
            "--runlengthdir", "DIR"]),
    ("pe", ["-g", "genes", "--split-output", "ROOT", "--fails-as-input",
            "--read-group-id", "RG1", "--read-group-name", "s", "-j", "3"]),
    ("se", ["--use-runlength", "rl", "--runlengthdir", "DIR",
            "--split-output", "ROOT", "--barcode-length", "4", "--nofails"]),
    ("pe", ["-A", "gsnap", "-g", "genes", "--split-output", "ROOT",
            "-q", "1/2"]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ends,extra", MAPS_ROUTER_CASES)
def test_gsnap_cli_maps_and_router_match_cpu(multimap_disk, capsys,
                                             tmp_path, ends, extra):
    """The gsnap CLI with the multimapping maps and the output router's
    flags on the card (its default device): standard output and every
    --split-output file byte-equal to --device cpu's, with the cascade's
    kernels launched."""
    from gmap_gsnap_tpu_torch.cli import gsnap as tcli

    d, _ = multimap_disk
    inputs = ([str(d / "se.fq")] if ends == "se"
              else [str(d / "p_1.fq"), str(d / "p_2.fq")])
    outs = []
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        root.mkdir()
        args = ["-D", str(d), "-d", "syn", *[
            str(d) if a == "DIR" else str(root / "out") if a == "ROOT"
            else a for a in extra], *inputs, "--device", dev]
        before = dict(kbuild.LAUNCHES)
        assert tcli.main(args) == 0
        launched = {k: n - before.get(k, 0)
                    for k, n in kbuild.LAUNCHES.items()}
        files = {f: (root / f).read_text() for f in sorted(os.listdir(root))}
        outs.append((capsys.readouterr().out, files, launched))
    (card, card_files, launched), (cpu, cpu_files, _) = outs
    assert card == cpu and card_files == cpu_files
    assert card or card_files
    assert all(launched.get(k, 0) for k in (
        "gsnap_seed_diagonals", "gsnap_top_diagonals",
        "gsnap_prefix_mismatches", "gsnap_pack_queries")), launched


@pytest.mark.cuda
@pytest.mark.parametrize("suffix", [False, True])
def test_uniqscan_matches_cpu(multimap_disk, capsys, suffix):
    """uniqscan on the card on 200 nt from a repeat copy (prefixes, or
    with -3 suffixes): its lines byte-equal to --device cpu's, the first
    a multimapping one, with the cascade's kernels launched."""
    from gmap_gsnap_tpu_torch.cli import uniqscan

    d, g = multimap_disk
    p = int(g.repeats[2])
    seq = (g.ascii[p - 50 : p + 150] if suffix
           else g.ascii[p + 250 : p + 450]).tobytes().decode()
    args = ["-D", str(d), "-d", "syn", *(["-3"] if suffix else []), seq]
    before = kbuild.LAUNCHES["gsnap_seed_diagonals"]
    assert uniqscan.main(args) == 0
    card = capsys.readouterr().out
    assert kbuild.LAUNCHES["gsnap_seed_diagonals"] > before
    assert uniqscan.main(args + ["--device", "cpu"]) == 0
    assert card == capsys.readouterr().out
    assert int(card.splitlines()[0].split(": ")[1]) > 1
