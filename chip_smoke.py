#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (gmap_gsnap_tpu_torch).

    python3 chip_smoke.py [--mbp 100] [--reads 8192] [--pairs 8192]
                          [--batch 2048]

Runs in about 15 minutes on one H100 (build, eight paths, checks,
timings).

Needs one CUDA device; exits nonzero, printing no result, without one.
Every path runs gsnap's default --gmap-mode (pairsearch,
indel_knownsplice, terminal, improvement).  Phases (any failure raises
and ends the run with a nonzero exit):

  1. the card: torch.cuda.get_device_name and nvidia-smi's name and
     power limit;
  2. build the sixteen CUDA kernels from csrc/ (nvcc, sm_90a);
  3. a synthetic genome of 4 chromosomes (--mbp, default 100, about the
     C. elegans genome) with N runs and a repeat family, indexed at
     gmap_build's large-genome setting k=15 / interval 3; planted 100 bp
     DNA reads for the SE -N 0 path (0-3 substitutions, half
     reverse-complemented, some with N, some with 1-3 nt indels, in a
     random order with the messy junctions below), RNA
     reads for the SE -N 1 path (50% unspliced, 30% one junction, 10% a
     short middle exon, 5% distant halves, 5% N or indel, then 1% of them
     replaced by reads in repeat copies; every junction GT-AG or CT-AC
     with maxent >= 0.90 at both sites), and 100 bp read pairs for the
     two PE paths (synth.plant_pairs: DNA 80% concordant with 200-600 nt
     fragments, indels, halfmapping, random, toolong, inversion,
     scramble, translocated and repeat pairs; RNA adds 30% pairs with a
     read across a junction, 10% with the reads on two sides of an
     intron, 5% with a short middle exon; 30% written mate first); every
     set also carries 1-3% messy junctions (a junction read with a 1-3
     nt indel or 2-3 substitutions within 11 nt of the junction), reads
     the GSNAP cascade leaves to the GMAP lanes;
     for paths 5 and 6 (known sites and SNPs, BASELINE config 4): a
     splicesites map of ~50,000 introns (every planted local junction,
     400 non-canonical introns, 4,000 introns for short-end reads, the
     inside-ambiguous pairs' introns, random ones) and 5,000 decoy sites,
     and a SNP map of one SNP per 1,000 bp plus the SNP-heavy reads'
     SNPs, written with the port's IIT writer into a temporary directory,
     the SNP index built there by db/transforms.write_snp_index; path 5
     reads are path 2's RNA mix with 10% SNP-heavy reads (5-8 alt
     alleles), 5% short-end reads (1-12 nt past a known site) and 5%
     reads across known non-canonical introns; path 6 pairs are path 4's
     mix with the same additions as read 1 of concordant pairs and 3%
     pairs whose ambiguous short end faces inside the pair; each set-up
     step's time is printed; for path 7 bisulfite reads (--reads; either
     strand, non-CpG C -> T, CpG C kept with probability 0.75, 0-2 extra
     substitutions, 5% with a read-C / genome-T site, 1% in repeat
     copies) and for path 8 RNA pairs of path 4's mix (--pairs / 2) with
     2-10 A-to-I edits in a 50-nt window of each mate of 30% of them;
  4. each kernel against its plain torch version on the same CUDA
     tensors at the main paths' shapes (2048 reads x 2 strands, L=100,
     W=384 / 512 and 4096, NC=32 and 128, P=16, T=8; K8 on the PE -N 1
     runner's own ranked end hits of 2048 pairs and on 2048 hand-built
     pairs with lefts above 2^24 and near 2^31; K9-K12 on the inputs the
     SE -N 1 and SE -N 0 runners' GMAP lanes give them on one batch
     (max_intronlen 200,000 and 30), K9 also at a
     forced hit/segment overflow and at the retry's sizes, K11/K12 also
     on 32 and 128 random junction windows with both gap tiers and every
     cdna_direction; K1/K2 on the SNP index, K3 with the alt genome and
     K5/K7 with the known-site masks at novel 1 and 0 on path 5's reads,
     and K5/K7 on dense random masks with word-aligned, genome-end and
     INVALID diagonals; K13-K16 on the strands of one batch of SE -N 0
     and SE -N 1 at NC=32 and at the wide lane's W=4096 / NC=128 and of
     one PE -N 1 batch, with K14 also without the optimal filter at
     maxout 16, with maxout above the candidate count and with the SE
     gates as its epilogue, and on hand-built edges: all- and
     no-mismatch masks and reads shorter than lmax, exact duplicate
     candidates and equal (score, left) on both strands, INVALID
     diagonals and seed slots, diagonals near 2^31 and 2^32 under both
     pair rules): outputs must be equal, float32 ones bit for bit;
  5. the four main paths, each through GsnapRunner.run or run_pe over all
     its reads into a SAM buffer, with every kernel's launch count reset
     before and read after:
     SE -N 0 (--reads): K1-K4, K9, K10 must launch and K5-K8 must not
           (K11/K12 may: GMAP bridges gaps up to 30 nt at -N 0); >= 99%
           of reads with <= 2 substitutions must map uniquely at their
           planted position and strand;
     SE -N 1 (--reads): K1-K7 and K9-K12 must launch, K8 must not; >=
           90% of the easy single-junction reads (both flanks >= 30 nt,
           <= 1 substitution) must map uniquely with their planted intron;
     PE -N 0 (--pairs / 2): K1-K4, K8, K9, K10 must launch, K5-K7 must
           not;
     PE -N 1 (--pairs): K1-K12 must all launch;
     SE -N 1 -s -v (--reads): K1-K7 must launch (the GMAP terminal and
           improvement lanes are gated off under -s/-v); >= 99% of the
           SNP-heavy reads placed once at their origin, >= 90% of the
           short-end reads whose short end matches only its planted
           partner site spliced with their intron, >= 90% of the
           non-canonical reads spliced, >= 90% of the easy junctions;
     PE -N 1 -s -v (--pairs): K1-K8 must launch; >= 1 inside-ambiguous
           pair resolved by the runner's _resolve_inside_ambi, >= 99% of
           the SNP-heavy reads' pairs placed, the PE -N 1 bars on the
           pairs of path 4's mix, >= 90% of the non-canonical reads
           spliced;
     every path must launch K13-K16 too;
     on both PE paths >= 99% of the concordant pairs with <= 2
     substitutions per read must be reported as one proper pair (0x2)
     at both planted positions with |TLEN| the fragment length; with
     -N 1 >= 90% of the easy junction pairs (flanks >= 30 nt, <= 1
     substitution in the spliced read) must carry the planted intron;
     each path prints its GMAP hits in the SAM (single end) or in the
     ends' final hit lists and in rescued pairs (paired end), the GMAP
     candidate hits they came from, and the host seconds of its
     prefetch_gmap passes;
  5b. paths 7 and 8, one at a time: the mode's converted index pair
     written by db/transforms.write_converted_indexes into the temporary
     directory and loaded by the runner (cmet_dir / atoi_dir); K1 on
     both converted indexes, K3 with each strand's conversion and
     K13-K16 checked on the path's own strands; then the path, its bars
     and a CPU-vs-CUDA SAM subset (512 reads, 256 pairs); then the pair
     and its files are freed:
     SE --mode cmet-stranded -N 0 (--reads): K1-K4 and K13-K16 must
           launch; >= 99% of the non-repeat bisulfite reads placed once at
           their origin; every read-C / genome-T site of a placed read
           shown as a mismatch in MD;
     PE --mode atoi-stranded -N 1 (--pairs / 2): K1-K8 and K13-K16 must
           launch; >= 99% of the edited (and of all) concordant pairs
           with <= 2 substitutions proper at both positions;
     both print whether K9-K12 launched (the modes gate the GMAP
     terminal and improvement lanes off; pairsearch is not);
  6. each path's SAM from the plain torch path on the CPU must be
     byte-equal to the CUDA run's (first 512 reads, first 256 pairs),
     and the CUDA run of that subset must launch K9/K10 and convert at
     least one GMAP candidate hit (paths 5 and 6: launch K5-K7, with
     SNP-heavy and short-end reads in the subset);
  7. each kernel's device time (torch.profiler) and per-call time beside
     its plain version's, and profiles of the SE -N 1 and PE -N 1 runs
     (device busy share, top device ops), measured last so that the
     profiler cannot perturb step 5's timing.

Prints one JSON line with every kernel's launches (on the PE -N 1 path,
which runs all sixteen; per path under launches_by_path; the checks of
other inputs, such as K5 with known masks, under variants), error, device
time (ms, plain_ms at the first shape checked), its bound (bound_ms: the
larger of the bytes it must move over 3.35 TB/s and its operations over
67 T/s, the H100's float32 rate outside the tensor cores: its int32 rate
is lower (64 int32 lanes per SM against 128 float32), so the operations
term is an underestimate; bound_by says which) and the time of one PyTorch
call computing the same function where there is one (library_ms, else
null), then the nvidia-smi line, then {"ok": true, "device": {...}}
last.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

N0_KERNELS = ("gsnap_seed_diagonals", "gsnap_top_diagonals",
              "gsnap_prefix_mismatches", "gsnap_solve_indels")
SPLICE_KERNELS = ("gsnap_solve_splices", "gsnap_select_triples",
                  "gsnap_solve_doublesplices")
PAIR_KERNELS = ("gsnap_pair_grid",)
GMAP_KERNELS = ("gmap_seed_segments", "gmap_chain")
DYNPROG_KERNELS = ("gmap_banded_gotoh", "gmap_bridge_traceback")
# K13-K16: trims and lane features, ranking (+ the SE gates), seed qpos
# ranges, pair selection — every path runs them
STAGE_KERNELS = ("gsnap_lane_features", "gsnap_rank_hits",
                 "gsnap_qpos_ranges", "gsnap_select_pairs")
ALL_KERNELS = (N0_KERNELS + SPLICE_KERNELS + PAIR_KERNELS + GMAP_KERNELS
               + DYNPROG_KERNELS + STAGE_KERNELS)
GMAP_CHECKS = ("seed_segments", "chain", "banded_gotoh", "bridge_traceback")
STAGE_NAMES = ("lane_features", "rank_hits", "qpos_ranges", "select_pairs")
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# the float32 rate outside the tensor cores, the nearest published rate
# to the kernels' int32 work; the card's int32 rate is lower (64 int32
# lanes per SM against 128 float32), so the operations term, and with it
# the bound, is an underestimate where it decides
OPS_PER_S = 67e12


def _nbytes(*xs) -> int:
    """Bytes of the tensors in xs (nested tuples, lists and dicts)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += _nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += _nbytes(*x)
        elif hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def _bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the least time for the bytes or the
    operations, whichever is larger."""
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    to = ops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _call_ms(fn, reps: int = 5) -> float:
    """Mean ms per call of fn between CUDA events, after one warm-up
    call: device time plus whatever launch gaps the host leaves."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 5) -> float:
    """Mean device time per call of fn: the summed time of the CUDA
    kernels and copies it ran, from torch.profiler.  A profile that
    recorded no device time is taken again; if the second one records
    none either, the time between CUDA events stands in and is said so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    print("  (torch.profiler recorded no device time twice: CUDA event "
          "time instead)", flush=True)
    return _call_ms(fn, reps)


def _fields(fn, args, keys) -> tuple:
    """fn(*args)'s dict values at keys, from ONE call of fn (a timed call
    must launch the kernel once)."""
    out = fn(*args)
    return tuple(out[k] for k in keys)


def _first(fn, args, keys) -> tuple:
    """The dict that is fn(*args)[0] at keys, from ONE call of fn."""
    return _fields(lambda *a: fn(*a)[0], args, keys)


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over paired outputs, and 1 where two tensors are
    not identical (float32 ones compared bit for bit); raises on a shape
    or type change."""
    import torch

    err = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise SystemExit(f"shape/dtype differ: {x.shape} {x.dtype} vs "
                             f"{y.shape} {y.dtype}")
        if x.numel():
            err = max(err, (x.double() - y.double()).abs().max().item())
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            err = max(err, 1.0)
    return err


def _sam_lines(sam_text: str) -> dict:
    lines = {}
    for line in sam_text.splitlines():
        if not line.startswith("@"):
            f = line.split("\t")
            lines.setdefault(f[0], []).append(f)
    return lines


def _placed_ok(sam_text: str, items, genome, mate: int | None = None
               ) -> tuple[int, int]:
    """(#reads placed once at their planted position and strand, #reads)
    of items (read name, universal left, plusp); with ``mate`` (0 or 1)
    the reads are that mate of a pair placed once."""
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = 0
    for name, left, plusp in items:
        recs = lines.get(name, [])
        if mate is not None:
            m = _mates(recs)
            recs = [] if m is None else [m[mate]]
        if len(recs) != 1 or recs[0][2] == "*":
            continue
        f = recs[0]
        lead = int(f[5][: f[5].index("S")]) if "S" in f[5].split("M")[0] else 0
        good += (starts[f[2]] + int(f[3]) - 1 - lead == left
                 and (not int(f[1]) & 16) == plusp)
    return good, len(items)


def _planted_ok(sam_text: str, truth, genome) -> tuple[int, int]:
    """(#reads with <= 2 substitutions placed uniquely at their planted
    position and strand, #such reads)."""
    return _placed_ok(sam_text, [(f"r{i}", t.left, t.plusp)
                                 for i, t in enumerate(truth)
                                 if t.kind == "sub" and t.nsub <= 2], genome)


def _introns(f, starts) -> list:
    """[(start, end)) introns (universal coordinates) of a SAM record's
    N operations."""
    import re

    pos = starts[f[2]] + int(f[3]) - 1
    out = []
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]):
        n = int(n)
        if op == "N":
            out.append((pos, pos + n))
        if op in "MDN=X":
            pos += n
    return out


def _junctions_ok(sam_text: str, truth, genome) -> tuple[int, int]:
    """(#easy single-junction reads — both flanks >= 30 nt, <= 1
    substitution — placed uniquely with exactly their planted intron,
    #such reads)."""
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = total = 0
    for i, t in enumerate(truth):
        if t.kind != "junction" or min(t.flanks) < 30 or t.nsub > 1:
            continue
        total += 1
        recs = lines.get(f"s{i}", [])
        if len(recs) == 1 and recs[0][2] != "*":
            good += _introns(recs[0], starts) == list(t.junctions)
    return good, total


def _mates(recs):
    """The two records of a pair placed once, as (read 1, read 2), or
    None."""
    if len(recs) != 2:
        return None
    m = {int(f[1]) & 0xC0: f for f in recs}
    if set(m) != {0x40, 0x80} or any(f[2] == "*" for f in recs):
        return None
    return m[0x40], m[0x80]


def _pairs_ok(sam_text: str, truth, genome, prefix: str = "q",
              only=None) -> tuple[int, int]:
    """(#concordant pairs with <= 2 substitutions per read reported as
    one proper pair at both planted positions with |TLEN| the fragment
    length, #such pairs); ``only`` (bools per pair) restricts them."""
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = total = 0
    for i, t in enumerate(truth):
        if (t.kind != "concordant" or max(t.nsub) > 2
                or (only is not None and not only[i])):
            continue
        total += 1
        mates = _mates(lines.get(f"{prefix}{i}", []))
        if mates is None:
            continue
        ok = True
        for f, left in zip(mates, t.lefts):
            cigar = f[5]
            lead = int(cigar[: cigar.index("S")]) if "S" in cigar.split("M")[0] else 0
            ok &= (int(f[1]) & 0x2 != 0
                   and starts[f[2]] + int(f[3]) - 1 - lead == left
                   and abs(int(f[8])) == t.insert)
        good += ok
    return good, total


def _junction_pairs_ok(sam_text: str, truth, genome) -> tuple[int, int]:
    """(#easy junction pairs — the spliced read's flanks >= 30 nt, <= 1
    substitution in it — placed once with the spliced read carrying
    exactly its planted intron, #such pairs)."""
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = total = 0
    for i, t in enumerate(truth):
        if t.kind != "junction":
            continue
        m = 0 if t.introns[0] else 1
        if min(t.flanks[m]) < 30 or t.nsub[m] > 1:
            continue
        total += 1
        mates = _mates(lines.get(f"q{i}", []))
        if mates is not None:
            good += _introns(mates[m], starts) == list(t.introns[m])
    return good, total


def _spliced_ok(sam_text: str, items, genome, mate: int | None = None
                ) -> tuple[int, int]:
    """(#reads placed once with exactly their planted intron, #reads) of
    items (read name, (donor, acceptor)); with ``mate`` (0 or 1) the
    reads are that mate of a pair placed once."""
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = 0
    for name, intron in items:
        recs = lines.get(name, [])
        if mate is not None:
            m = _mates(recs)
            recs = [] if m is None else [m[mate]]
        if len(recs) == 1 and recs[0][2] != "*":
            good += _introns(recs[0], starts) == [intron]
    return good, len(items)


def _known_masks(torch, rng, nwords: int, dev, density: float) -> tuple:
    """Four random known-site bitvectors of ``nwords`` words, the last
    words included (INVALID diagonals read them), about ``density`` of
    their bits set."""
    out = []
    for _ in range(4):
        words = np.zeros(nwords, np.uint32)
        nset = int(nwords * 32 * density)
        pos = rng.integers(0, nwords * 32, nset)
        np.bitwise_or.at(words, pos >> 5,
                         np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32)))
        out.append(torch.from_numpy(words.view(np.int32)).to(dev))
    return tuple(out)


def _junction_windows(torch, dp, rng, nb: int, dev):
    """2 nb random junction windows at the GMAP path's shapes (M = 64,
    W = 23, 72 genome columns): nb left sides (jump early), then nb
    reversed right sides (jump late), queries copying the genome with
    noise and code-5 padding past their length."""
    M, NL = 64, 72
    q = rng.integers(0, 5, (2 * nb, M)).astype(np.int32)
    g = rng.integers(0, 5, (2 * nb, NL)).astype(np.int32)
    g[:, :M] = np.where(rng.random((2 * nb, M)) < 0.8, q, g[:, :M])
    len1 = np.tile(rng.integers(2, M + 1, nb), 2).astype(np.int32)
    q[np.arange(M)[None, :] >= len1[:, None]] = 5
    len2 = len1 + 8
    lb, rb = dp.compute_bands(len1, len2, 7)
    loff = rng.integers(0, 1000, nb)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(q=t(q), g=t(g), len1=t(len1), len2=t(len2), lb=t(lb),
                rb=t(rb), late=t(np.arange(2 * nb) >= nb), loff=t(loff),
                roff=t(loff + rng.integers(0, 200, nb)),
                known=t((rng.integers(0, 2, (nb, NL + 1)) * 20)
                        .astype(np.int32)))


def _lane_inputs(eng, dp, runner, recs, batch: int, label: str) -> dict:
    """The inputs the GMAP lane of ``runner`` gives K9-K12 over one batch
    of ``recs`` (the largest call of each kernel), by name."""
    captured = {}
    hooks = [(eng, "seed_segments", lambda a: a[2].shape[0]),
             (eng, "chain", lambda a: a[0].shape[0]),
             (dp, "banded_matrices", lambda a: a[0].shape[0]),
             (dp, "bridge_traceback", lambda a: a[0][0].shape[0])]
    saved = []
    for mod, name, size in hooks:
        fn = getattr(mod, name)
        saved.append(fn)

        def spy(*a, fn=fn, name=name, size=size):
            if name not in captured or size(a) > size(captured[name]):
                captured[name] = a
            return fn(*a)

        setattr(mod, name, spy)
    try:
        runner.run(recs[:batch], io.StringIO(), batch_size=batch)
    finally:
        for (mod, name, _), fn in zip(hooks, saved):
            setattr(mod, name, fn)
    if "seed_segments" not in captured or "chain" not in captured:
        raise SystemExit(f"{label}: the GMAP lane did not run on one batch")
    print(f"GMAP lane inputs of one {label} batch: oligos "
          f"{tuple(captured['seed_segments'][2].shape)}, max_intronlen "
          f"{captured['chain'][5]}, junction dynprog "
          f"{'ran' if 'banded_matrices' in captured else 'did not run'}",
          flush=True)
    return captured


def _gmap_checks(torch, eng, dp, lanes, rng, dev, costs):
    """K9-K12 checks (name, shape, kernel call, plain call): on the
    inputs each runner's GMAP lane gave each kernel (``lanes``: (label,
    _lane_inputs) pairs, the first sets the costs), K9 also at a forced
    hit/segment overflow and at the retry's sizes, K11/K12 also on 32 and
    128 random junction windows, both gap tiers, every cdna_direction
    table.  Fills ``costs`` with each kernel's (bytes, operations)."""
    checks = []

    def dynprog(label, margs, bargs):
        checks.append(("banded_gotoh", label,
                       partial(dp._banded_matrices_cuda, *margs),
                       partial(dp._banded_matrices_plain, *margs)))
        checks.append(("bridge_traceback", label,
                       partial(dp._bridge_traceback_cuda, *bargs),
                       partial(dp._bridge_traceback_plain, *bargs)))

    for label, captured in lanes:
        offs, pos, oligos, valid, k, H, S, thr = captured["seed_segments"]
        for h, s_ in ((H, S), (H // 8, max(S // 8, 1)), (4 * H, 4 * S)):
            a = (offs, pos, oligos, valid, k, h, s_, thr)
            checks.append(("seed_segments",
                           f"{label} {oligos.shape[0]} rows H={h} S={s_}",
                           partial(_fields, eng._seed_segments_cuda, a,
                                   eng.SEG_KEYS),
                           partial(_fields, eng._seed_segments_plain, a,
                                   eng.SEG_KEYS)))
        ch = captured["chain"]
        checks.append(("chain", f"{label} {ch[0].shape[0]} rows "
                                f"S={ch[0].shape[1]} il={ch[5]}",
                       partial(_fields, eng._chain_cuda, ch, eng.CHAIN_KEYS),
                       partial(_fields, eng._chain_plain, ch, eng.CHAIN_KEYS)))
        if "banded_matrices" in captured:
            margs = captured["banded_matrices"]
            dynprog(f"{label} {margs[0].shape[0] // 2} junctions", margs,
                    captured["bridge_traceback"])
    offs, pos, oligos, valid, k, H, S, thr = lanes[0][1]["seed_segments"]
    nvalid = int(valid.sum())

    def seed_cost(out, H=H):
        nv = out[4].clamp(max=H).double()
        return (_nbytes(oligos, valid, out) + nvalid * 8 + float(nv.sum()) * 4,
                float((nv * torch.log2(nv.clamp(min=1))).sum()))

    costs["seed_segments"] = seed_cost
    ch = lanes[0][1]["chain"]

    def chain_cost(out):
        S_ = ch[3].shape[1]
        idx = torch.arange(S_, device=dev)
        lv = torch.where(ch[3], idx, -1).max(1).values.clamp(min=0).double()
        # ~12 integer operations per transition scored
        return _nbytes(ch[:4], out), 12 * float((lv * (lv + 1) / 2).sum())

    costs["chain"] = chain_cost
    for nb in (32, 128):
        w = _junction_windows(torch, dp, rng, nb, dev)
        for open_, ext in ((dp.PAIRED_OPEN, dp.PAIRED_EXTEND),
                           (dp.SINGLE_OPEN, dp.SINGLE_EXTEND)):
            margs = (w["q"], w["g"], w["len1"], w["len2"], w["lb"], w["rb"],
                     dp.pair_matrix(dp.MISMATCH_HIGHQ), w["late"], 64, 23,
                     open_, ext)
            mats = dp._banded_matrices_plain(*margs)
            for cd, halfp, nospl, kn in ((1, False, False, w["known"] * 0),
                                         (-1, True, False, w["known"]),
                                         (0, False, True, w["known"] * 0)):
                bargs = (mats, w["len1"][:nb], w["len2"][:nb],
                         w["len2"][nb:], w["lb"][:nb], w["lb"][nb:],
                         w["g"][:nb], w["g"][nb:], kn, kn, w["loff"],
                         w["roff"], 64, 23, 138, open_, ext, 30, cd, True,
                         halfp, nospl)
                dynprog(f"nb={nb} open={open_} cdna={cd}", margs, bargs)
    first = next(c for c in checks if c[0] == "banded_gotoh")
    ma = first[2].args
    # ~20 integer operations per band cell, ~15 per junction candidate
    costs["banded_gotoh"] = lambda out: (
        _nbytes(ma[:6], ma[7], out), 20 * out[0].numel())
    fb = next(c for c in checks if c[0] == "bridge_traceback")[2].args
    costs["bridge_traceback"] = lambda out: (
        _nbytes(fb[0][0], fb[0][3], fb[1:12], out),
        15 * fb[0][0].shape[0] // 2 * 64 * 2 * 23)
    return checks


def _stage_checks(torch, gg, se, mmo, genome_dev, index, index_minus, c, f,
                  ln, gp, label, rank=True):
    """K13-K16 checks (name, shape, kernel call, plain call, cost) on one
    batch (codes c, flags f, lengths ln of read 1s) under GappedParams
    ``gp``: per strand batch as _strand_hits runs it (both strands
    stacked in standard mode; under a cmet/atoi conversion each strand on
    its own index, with K1 on that index and K3 with that conversion
    checked too), and K14 (with ``rank``) on the batch's candidates:
    the SE ranking with its gates, and the PE pairing call (no optimal
    filter, maxout 16) and maxout above the candidate count."""
    base = gp.base
    conv_plus, conv_minus = se._MODE_CONV[base.mode]
    crc, frc = se._revcomp_batch(c, f, ln)
    if conv_plus is None and index_minus is None:
        batches = [("both strands", index, torch.cat([c, crc]),
                    torch.cat([f, frc]), torch.cat([ln, ln]), None)]
    else:
        batches = [("plus", index, c, f, ln, conv_plus),
                   ("minus", index_minus or index, crc, frc, ln, conv_minus)]
    checks = []
    lf_keys = ("cand_mm",) + gg._LANE_FEATURE_KEYS
    for strand, idx, cc, ff, ll, conv in batches:
        shape = f"{label} {strand} NC={base.ncand}"
        q = se._pack_device(cc, ff, ll, 100)
        cconv = se._convert_codes(cc, conv)
        diag, qgrid = se._seed_diagonals_plain(idx, cconv, ff, ll, base,
                                               True)[:2]
        top_d, votes, _ = se._top_diagonals_plain(diag, base.ncand)
        mm, pref = mmo._prefix_mismatches_plain(genome_dev, q, top_d, ll,
                                                conv, None)
        if conv is not None:
            kmers = cc.shape[0] * (100 - idx.k + 1)
            sargs = (idx, cconv, ff, ll, base, True)
            checks += [
                (f"seed_diagonals/{conv} index", shape,
                 partial(se._seed_diagonals_cuda, *sargs),
                 partial(se._seed_diagonals_plain, *sargs),
                 lambda out, a=sargs, n=kmers: (
                     _nbytes(a[1:4], out) + n * 8
                     + int((out[0] != se.INVALID_DIAG).sum()) * 4, 0)),
                (f"prefix_mismatches/{conv}", shape,
                 partial(mmo._prefix_mismatches_cuda, genome_dev, q, top_d,
                         ll, conv, None),
                 partial(mmo._prefix_mismatches_plain, genome_dev, q, top_d,
                         ll, conv, None),
                 lambda out, q=q, t=top_d, ll=ll: (
                     _nbytes(q, t, ll, out) + t.numel() * (100 // 16 + 2) * 8,
                     0))]
        largs = (mm, ll, idx.k, idx.interval, base.trim_mismatch_score)

        def lane_plain(mm=mm, pref=pref, ll=ll, idx=idx):
            out = {"cand_mm": gg._bitpack_mask(mm),
                   **gg._lane_features_plain(mm, pref, ll, idx.k,
                                             idx.interval,
                                             base.trim_mismatch_score)}
            return tuple(out[k] for k in lf_keys)

        checks += [
            ("lane_features", shape,
             partial(_fields, gg._lane_features_cuda, largs, lf_keys),
             lane_plain, lambda out, a=largs: (_nbytes(a[:2], out), 0)),
            ("qpos_ranges", shape,
             partial(se._qpos_ranges_cuda, diag, qgrid, top_d),
             partial(se._qpos_ranges_plain, diag, qgrid, top_d),
             lambda out, a=(diag, qgrid, top_d): (_nbytes(a, out),
                                                  a[0].numel()))]
        for rule, dist, fn, npairs in (
                ("indel", None, gg._indel_pairs_eligible(
                    base.max_middle_deletions, base.max_middle_insertions),
                 gp.indel_pairs),
                ("splice", base.shortsplicedist,
                 gg._splice_pairs_eligible(base.shortsplicedist),
                 gp.splice_pairs)):
            kargs = ((1, dist, 0) if dist else
                     (0, base.max_middle_deletions,
                      base.max_middle_insertions))
            checks.append((
                "select_pairs" + ("" if rule == "indel" else "/splice"),
                shape,
                partial(gg._select_pairs_cuda, top_d, votes, npairs, *kargs),
                partial(gg._select_pairs_plain, top_d, votes, fn, npairs),
                lambda out, t=top_d, v=votes: (
                    _nbytes(t, v, out), 8 * t.numel() * t.shape[1])))
    if not rank:
        return checks
    out, cands = gg.gather_candidates(genome_dev, index, index_minus, c, f,
                                      ln, gp)
    keys = sorted(out) + ["npaths"]
    shape = f"{label} n={out['score'].shape[1]}"
    key_bytes = _nbytes([out[k] for k, _ in gg._RANK_KEY_FIELDS])
    b, n = out["score"].shape

    def rank_cost(nout):
        return lambda res: (key_bytes + b * nout * 12 + b * 4,
                            b * n * math.log2(n))

    for suffix, opt, maxout in (("", True, None), ("/pairing", False, 16),
                                ("/maxout>ncand", True, n + 9)):
        nout = min(base.maxpaths if maxout is None else maxout, n)
        rargs = (out, base, opt, maxout)
        checks.append((
            "rank_hits" + suffix, shape,
            partial(_first, gg._rank_hits_cuda, rargs, keys),
            partial(_fields, gg._rank_hits_plain, rargs, keys),
            rank_cost(nout)))
    gargs = (out, cands, ln.int(), index.k, index.interval, gp, True)
    gkeys = sorted(gg._rank_gate_se_plain(*gargs))
    checks.append((
        "rank_hits/se gates", shape,
        partial(_fields, gg._rank_gate_se_cuda, gargs, gkeys),
        partial(_fields, gg._rank_gate_se_plain, gargs, gkeys),
        rank_cost(min(base.maxpaths, n))))
    return checks


def _stage_edges(torch, gg, se, synth, rng, dev, base):
    """K13-K16 checks on hand-built edges: masks with all / no
    mismatches and reads shorter than lmax (K13), exact duplicate
    candidates and equal (score, left) on both strands with maxout above
    the candidate count (K14), INVALID diagonals and seed slots (K15),
    diagonals near 2^31 and 2^32 under both rules (K16)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    mm, pref, ln = (t(x) for x in synth.mismatch_rows(rng, 512, 32))
    lf_keys = ("cand_mm",) + gg._LANE_FEATURE_KEYS
    checks = []
    def lane_plain(score):
        out = {"cand_mm": gg._bitpack_mask(mm),
               **gg._lane_features_plain(mm, pref, ln, 12, 3, score)}
        return tuple(out[k] for k in lf_keys)

    for score in (-3, -1):
        a = (mm, ln, 12, 3, score)
        checks.append((
            "lane_features/edges", f"score {score}",
            partial(_fields, gg._lane_features_cuda, a, lf_keys),
            partial(lane_plain, score),
            lambda out, a=a: (_nbytes(a[:2], out), 0)))
    out = {k: t(v) for k, v in synth.rank_hit_cases(rng, 1024, 144).items()}
    keys = sorted(out) + ["npaths"]
    for opt, maxout in ((True, None), (False, 151)):
        rargs = (out, base, opt, maxout)
        checks.append((
            "rank_hits/edges", f"optimal={opt} maxout={maxout}",
            partial(_first, gg._rank_hits_cuda, rargs, keys),
            partial(_fields, gg._rank_hits_plain, rargs, keys),
            lambda res: (_nbytes(list(out.values()), res), 0)))
    top, votes = (t(x) for x in synth.diag_pair_cases(rng, 1024, 32))
    grid = top.repeat(1, 12)
    qgrid = torch.arange(grid.shape[1], device=dev, dtype=torch.int32
                         ).expand(grid.shape[0], -1).contiguous() // 7
    checks.append(("qpos_ranges/edges", "INVALID and repeated slots",
                   partial(se._qpos_ranges_cuda, grid, qgrid, top),
                   partial(se._qpos_ranges_plain, grid, qgrid, top),
                   lambda out: (_nbytes(grid, qgrid, top, out), grid.numel())))
    for label, kargs, fn in (
            ("indel", (0, 30, 9), gg._indel_pairs_eligible(30, 9)),
            ("splice", (1, 200_000, 0), gg._splice_pairs_eligible(200_000)),
            ("splice 2^31+5", (1, 2**31 + 5, 0),
             gg._splice_pairs_eligible(2**31 + 5))):
        checks.append((
            "select_pairs/edges", f"{label} near 2^31 / 2^32",
            partial(gg._select_pairs_cuda, top, votes, 16, *kargs),
            partial(gg._select_pairs_plain, top, votes, fn, 16),
            lambda out: (_nbytes(top, votes, out), 8 * top.numel() * 32)))
    return checks


def _md_mismatches(md: str) -> list:
    """Aligned-span positions of the mismatches an MD string shows."""
    import re

    out, pos = [], 0
    for num, dele, base in re.findall(r"(\d+)|\^([A-Z]+)|([A-Z])", md):
        if num:
            pos += int(num)
        elif base:
            out.append(pos)
            pos += 1
    return out


def _ct_sites_shown(sam_text: str, truth, genome) -> tuple:
    """(#bisulfite reads placed once at their origin whose read-C /
    genome-T site MD shows as a mismatch, #such placed reads)."""
    import re

    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]]).tolist()))
    lines = _sam_lines(sam_text)
    good = total = 0
    for i, t in enumerate(truth):
        recs = lines.get(f"b{i}", [])
        if t.site < 0 or len(recs) != 1 or recs[0][2] == "*":
            continue
        f = recs[0]
        lead = re.match(r"(\d+)S", f[5])
        clip = int(lead.group(1)) if lead else 0
        if (starts[f[2]] + int(f[3]) - 1 - clip != t.left
                or (not int(f[1]) & 16) != t.plusp):
            continue
        total += 1
        md = next(x[5:] for x in f[11:] if x.startswith("MD:Z:"))
        at = t.site if t.plusp else len(f[9]) - 1 - t.site
        good += at - clip in _md_mismatches(md)
    return good, total


def _resident(db) -> str:
    """The card's bytes of the database's cached index arrays, by kind."""
    out = {}
    for key, val in db.__dict__.get("_port_device_arrays", {}).items():
        kind = key[0] if isinstance(key[0], str) else key[0][0]
        if kind == "genome" or key[1].type != "cuda":
            continue
        idx = [val] if kind == "index" else (
            [val[0]] if kind == "snps" else list(val))
        out[kind] = out.get(kind, 0) + sum(
            _nbytes(i.offsets, i.positions) for i in idx)
    return ", ".join(f"{k} {v} B ({v / 2**30:.2f} GiB)" for k, v in out.items())


def _count_gmap_hits(runner) -> dict:
    """Count, on ``runner`` until _uncount_gmap_hits: the GMAP candidate
    hits that prefetch_gmap converts from paths, the GMAP hits that the
    terminal and improvement gates put into a read's final hit list (for
    single-end reads, its SAM records), and the GMAP hits in the pairs
    that pair rescue chooses (pairsearch's among them)."""
    counts = dict(candidates=0, final=0, pairs=0)
    path_to_hit, rescued, pe_rescue = (runner._gmap_path_to_hit,
                                       runner._rescued_hits,
                                       runner._pe_rescue)

    def count_candidates(rec, path):
        hit = path_to_hit(rec, path)
        counts["candidates"] += hit is not None
        return hit

    def count_final(*a):
        final = rescued(*a)
        counts["final"] += sum(h.hittype == "gmap" for h in final)
        return final

    def count_pairs(*a):
        out = pe_rescue(*a)
        counts["pairs"] += sum(h.hittype == "gmap" for p in out[0]
                               for h in p[:2])
        return out

    runner._gmap_path_to_hit = count_candidates
    runner._rescued_hits = count_final
    runner._pe_rescue = count_pairs
    return counts


def _uncount_gmap_hits(runner) -> None:
    for name in ("_gmap_path_to_hit", "_rescued_hits", "_pe_rescue"):
        delattr(runner, name)


def _drive(torch, kbuild, runner, records, batch: int, label: str,
           pairs=None) -> dict:
    """One main path: a warm-up run, the device cascade alone, then the
    timed run with every kernel's launch count set to 0 just before it
    and read just after.  ``pairs`` (the read-2 records) makes it a PE
    path through run_pe / dispatch_pairs."""
    if pairs is None:
        run = lambda recs, out, **kw: runner.run(recs, out, **kw)
        dispatch = lambda i: runner.dispatch_records(records[i : i + batch])
        unit = "reads"
    else:
        run = lambda recs, out, **kw: runner.run_pe(
            recs, pairs[: len(recs)], out, **kw)
        dispatch = lambda i: runner.dispatch_pairs(
            records[i : i + batch], pairs[i : i + batch])
        unit = "pairs"
    t0 = time.time()
    run(records[:batch], io.StringIO(), batch_size=batch)
    print(f"{label} warm-up run: {time.time() - t0:.2f} s", flush=True)
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(0, len(records), batch):
        dispatch(i)
    torch.cuda.synchronize()
    cascade_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    runner.category_counts.clear()
    runner.gmap_seconds = 0.0
    counts = _count_gmap_hits(runner)
    runner.ambi_resolved = 0
    kbuild.LAUNCHES.clear()
    out = io.StringIO()
    t0 = time.time()
    n = run(records, out, batch_size=batch)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches = dict(kbuild.LAUNCHES)
    _uncount_gmap_hits(runner)
    peak = torch.cuda.max_memory_allocated()
    if n != len(records):
        raise SystemExit(f"{label}: run returned {n} of {len(records)} {unit}")
    print(f"{label} main path: {n} {unit}; device cascade "
          f"{n / cascade_s:.1f} {unit}/s ({cascade_s:.3f} s); end to end "
          f"{n / e2e_s:.1f} {unit}/s ({e2e_s:.3f} s); max_memory_allocated "
          f"{peak} B ({peak / 2**30:.2f} GiB); categories "
          f"{dict(runner.category_counts)}; launches {launches}", flush=True)
    final = ("GMAP hits in the SAM" if pairs is None else
             "GMAP hits in the ends' final hit lists")
    print(f"{label} GMAP lanes: {counts['final']} {final}"
          + (f", {counts['pairs']} GMAP hits in rescued pairs"
             if pairs is not None else "")
          + f" (of {counts['candidates']} GMAP candidate hits that "
          f"prefetch_gmap converted); prefetch_gmap "
          f"{runner.gmap_seconds:.3f} s of host wall", flush=True)
    return dict(sam=out.getvalue(), launches=launches,
                ambi_resolved=runner.ambi_resolved)


def _profile_run(torch, run, label: str) -> None:
    """torch.profiler over one call of run() (a GsnapRunner.run or
    run_pe): device busy share of the wall and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    if busy <= 0:
        print(f"{label} profile: torch.profiler recorded no device time "
              f"(busy share not measured)", flush=True)
        return
    print(f"{label} profile: wall {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% "
          f"idle)", flush=True)
    hand = [e for e in ev if any(f"{n[len('gsnap_'):]}_kernel(" in e.key
                                 for n in ALL_KERNELS)]
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:12]
    for e in top + [e for e in hand if e not in top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    print(f"{label} profile: hand kernels "
          f"{sum(e.self_device_time_total for e in hand) / 1e3:.3f} ms of "
          f"{busy * 1e3:.3f} ms device time", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=100.0,
                    help="genome size in Mbp (>= 32)")
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gmap_gsnap_tpu_torch.align import gmap_engine as eng
    from gmap_gsnap_tpu_torch.align import gsnap_gapped as gg
    from gmap_gsnap_tpu_torch.align import gsnap_pe as pe
    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.align import runner as runner_mod
    from gmap_gsnap_tpu_torch.db import datadir, iit_text, splicesites
    from gmap_gsnap_tpu_torch.db import transforms
    from gmap_gsnap_tpu_torch.db.iit import IIT
    from gmap_gsnap_tpu_torch.kernels import build as kbuild
    from gmap_gsnap_tpu_torch.ops import dynprog as dp
    from gmap_gsnap_tpu_torch.ops import mismatch as mmo
    from gmap_gsnap_tpu_torch.utils import synth

    t_start = time.time()
    # 1. the card
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi_line = smi.strip().splitlines()[0]
    print(f"device: {kind}; nvidia-smi: {smi_line}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build the kernels
    kbuild.library()
    print(f"build: {kbuild.build_seconds:.1f} s (nvcc {kbuild.NVCC_FLAGS[1]}, "
          f"{len(kbuild._SIGNATURES)} kernels)",
          flush=True)
    for line in kbuild.build_log.splitlines():
        if "Used" in line:
            print(f"  ptxas: {line.split(':', 1)[1].strip()}")

    # 3. genome, index, reads
    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    total = int(args.mbp * 1e6)
    chr_lengths = [total * w // 10 for w in (4, 3, 2)]
    chr_lengths.append(total - sum(chr_lengths))
    genome = synth.make_genome(rng, chr_lengths, n_runs=20)
    db = synth.genome_db(genome, k=15, interval=3)
    # 1% of the DNA reads are messy junctions, for the GMAP lanes
    nmessy = args.reads // 100
    records, truth = synth.plant_reads(
        rng, genome, args.reads - nmessy,
        weights=dict(sub=0.88, n=0.04, mid_indel=0.04, end_indel=0.01,
                     terminal=0.01, repeat=0.01, junk=0.01))
    records += synth.plant_spliced_reads(
        rng, genome, nmessy, weights=dict(messy_junction=1), prefix="m")[0]
    # interleaved, so every batch and the CPU subset of step 6 hold some
    records = [records[i] for i in rng.permutation(len(records))]
    rna, rna_truth = synth.plant_spliced_reads(
        rng, genome, args.reads, weights=dict(
            unspliced=0.5, junction=0.3, shortexon=0.1, distant=0.05,
            n_indel=0.05, messy_junction=0.03))
    # 1% of them from repeat copies, which overflow the candidate budget,
    # so the -N 1 path runs its wide lane too
    nrep = args.reads // 100
    rna = rna[: args.reads - nrep] + synth.plant_reads(
        rng, genome, nrep, weights=dict(repeat=1), prefix="p")[0]
    rna_truth = rna_truth[: args.reads - nrep]
    p1, p2, p_truth = synth.plant_pairs(
        rng, genome, args.pairs // 2,
        weights={**synth.DNA_PAIR_MIX, "messy_junction": 0.02})
    rp1, rp2, rp_truth = synth.plant_pairs(
        rng, genome, args.pairs,
        weights={**synth.RNA_PAIR_MIX, "messy_junction": 0.03})
    # path 7: bisulfite reads (cmet); path 8: A-to-I edited RNA pairs (atoi)
    bis, bis_truth = synth.plant_bisulfite_reads(rng, genome, args.reads)
    ep1, ep2, ep_truth, ep_edited = synth.plant_edited_pairs(
        rng, genome, args.pairs // 2)
    print(f"setup: {total / 1e6:.1f} Mbp, 4 chromosomes, k=15/3 index "
          f"({len(db.positions)} positions), {len(records)} DNA + {len(rna)} "
          f"RNA reads, {len(p1)} DNA + {len(rp1)} RNA pairs, "
          f"{len(bis)} bisulfite reads ({sum(t.site >= 0 for t in bis_truth)}"
          f" with a read-C / genome-T site), {len(ep1)} RNA pairs "
          f"({int(ep_edited.sum())} A-to-I edited) in "
          f"{time.time() - t0:.1f} s", flush=True)
    params = se.GsnapParams(   # the default --gmap-mode: every GMAP lane
        size_threshold=se.dynamic_size_threshold(int(db.offsets[-1]), db.k,
                                                 "standard"))
    # both runners share the database's device genome and index
    runner = runner_mod.GsnapRunner(db, params, lmax=100, device=dev)
    runner_n1 = runner_mod.GsnapRunner(db, params, lmax=100,
                                       novelsplicing=True, device=dev)
    index, genome_dev = runner.index, runner.genome
    assert runner_n1.index is index and runner_n1.genome is genome_dev

    # 3b. known splice sites (-s) and SNPs (-v) for paths 5 and 6, and
    # their reads: path 2's RNA mix with 10% SNP-heavy reads, 5% short-end
    # reads and 5% reads across known non-canonical introns; path 4's
    # pair mix with the same additions as read 1 of concordant pairs and
    # 3% pairs whose ambiguous short end faces inside the pair
    t0 = time.time()
    n5, n6 = args.reads, args.pairs
    add5 = (n5 // 10, n5 // 20, n5 // 20)
    add6 = (n6 // 10, n6 // 20, n6 // 20, 3 * n6 // 100)
    nc_introns = synth.random_introns(rng, genome, 400, canonical=False)
    pool = synth.random_introns(rng, genome, 4000)   # short ends' introns
    snp5, snp5_t, (sp5, sa5) = synth.plant_snp_reads(rng, genome, add5[0])
    short5, short5_t = synth.plant_site_reads(rng, genome, pool, add5[1],
                                              short_end=True)
    nc5, nc5_t = synth.plant_site_reads(rng, genome, nc_introns, add5[2],
                                        prefix="c")
    n_base5 = n5 - sum(add5)
    rna5 = rna[:n_base5] + snp5 + short5 + nc5
    rna5 = [rna5[i] for i in rng.permutation(len(rna5))]
    snp6, snp6_t, (sp6, sa6) = synth.plant_snp_reads(rng, genome, add6[0],
                                                     prefix="w")
    short6, short6_t = synth.plant_site_reads(rng, genome, pool, add6[1],
                                              short_end=True, prefix="j")
    nc6, nc6_t = synth.plant_site_reads(rng, genome, nc_introns, add6[2],
                                        prefix="n")
    amb1, amb2, _, amb_introns = synth.inside_ambiguous_pairs(
        rng, genome, add6[3])
    spans = ([(t.left, t.left + 100, t.plusp) for t in snp6_t]
             + [(t.left, t.intron.acceptor + t.flanks[1], t.plusp)
                for t in short6_t + nc6_t])
    extra1 = snp6 + short6 + nc6
    extra2 = synth.mates_for(rng, genome, extra1, spans)
    n_base6 = n6 - sum(add6)
    order6 = rng.permutation(n6)
    r61 = [(rp1[:n_base6] + extra1 + amb1)[i] for i in order6]
    r62 = [(rp2[:n_base6] + extra2 + amb2)[i] for i in order6]
    # the map: every planted local intron, the non-canonical and short-end
    # ones, random introns up to ~50,000, and 5,000 decoy sites
    # a planted junction's gene strand shows in its donor dinucleotide
    sense = lambda a: genome.ascii[a : a + 2].tobytes() == b"GT"
    planted = [synth.Intron(a, b, sense(a))
               for t in rna_truth for a, b in t.junctions
               if 0 < b - a < params.shortsplicedist]
    planted += [synth.Intron(a, b, sense(a))
                for t in rp_truth for iv in t.introns for a, b in iv]
    introns = planted + nc_introns + pool + amb_introns
    introns += synth.random_introns(rng, genome, max(50_000 - len(introns),
                                                     0))
    decoys = synth.random_decoys(rng, genome, 5_000)
    bg_pos, bg_alt = synth.random_snps(rng, genome, 1 / 1000)
    spos = np.concatenate([sp5, sp6, bg_pos])
    salt = np.concatenate([sa5, sa6, bg_alt])
    spos, first = np.unique(spos, return_index=True)
    salt = salt[first]
    print(f"setup -s/-v: {len(introns)} introns ({len(nc_introns)} "
          f"non-canonical) + {len(decoys)} decoy sites, {len(spos)} SNPs, "
          f"{len(rna5)} reads for path 5, {len(r61)} pairs for path 6 in "
          f"{time.time() - t0:.1f} s", flush=True)
    # removed when the process ends, whether or not a phase failed
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    sites_path = os.path.join(tmp, "sites.iit")
    t0 = time.time()
    iit_text.iit_from_text(synth.splicesites_text(
        genome, introns, decoys)).write(sites_path)
    t_sites = time.time() - t0
    t0 = time.time()
    snps_iit = iit_text.iit_from_text(synth.snps_text(genome, spos, salt))
    snps_iit.write(os.path.join(tmp, "snps.iit"))
    t_snps = time.time() - t0
    t0 = time.time()
    codes, flags = genome.codes_flags
    alt_codes = transforms.alt_genome_from_snps(codes, snps_iit, db.chr_names,
                                                db.chr_starts)
    transforms.write_snp_index(tmp, db.dbname, "snps", codes, flags,
                               db.chr_ends, alt_codes, k=db.k,
                               basesize=db.k, interval=db.interval,
                               ref_index=(db.offsets, db.positions))
    t_index = time.time() - t0
    t0 = time.time()
    sites = splicesites.load_splicesites(IIT.read(sites_path), db.chr_names,
                                         db.chr_starts)
    t_load = time.time() - t0
    t0 = time.time()
    sites.device_bitmasks(len(db.codes), dev)
    torch.cuda.synchronize()
    t_bits = time.time() - t0
    t0 = time.time()
    runner_sv = runner_mod.GsnapRunner(
        db, params, lmax=100, novelsplicing=True, splicesdb=sites_path,
        snpsdb="snps", snps_dir=tmp, device=dev)
    torch.cuda.synchronize()
    t_runner = time.time() - t0
    print(f"setup -s/-v times: splicesites IIT write {t_sites:.2f} s "
          f"({sites.nsites} sites), SNP IIT write {t_snps:.2f} s, alt genome "
          f"+ write_snp_index {t_index:.2f} s "
          f"({len(runner_sv.index.positions)} positions), load_splicesites "
          f"{t_load:.2f} s, bitmask upload {t_bits:.3f} s, runner set-up "
          f"(splice sites again, SNP index read and upload) {t_runner:.2f} s",
          flush=True)

    # 4. each kernel against its plain version, at the main path's shapes
    def strands(recs):
        b = min(args.batch, len(recs))
        codes, nflags, lengths = runner_mod.encode_batch(recs[:b], 100)
        c = torch.from_numpy(codes).to(dev)
        f = torch.from_numpy(nflags).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        crc, frc = se._revcomp_batch(c, f, ln)
        return torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])

    c2, f2, l2 = strands(records)
    q2 = se._pack_device(c2, f2, l2, 100)
    budget = se.auto_budget(l2, db.k, db.interval, -1)
    checks = []   # (name, shape, kernel call, plain call), checked now, timed last
    # per kernel, at its first shape: (bytes, operations) of the work from
    # its plain output, and one PyTorch call computing the same function
    costs, library = {}, {}
    gwords = lambda nt: (nt // 16 + 2) * 8     # ref + flag words of a span
    for st, nc in ((384, 32), (4096, 128)):
        p = se.GsnapParams(seed_total=st, ncand=nc,
                           size_threshold=params.size_threshold)
        seed = se._seed_diagonals_plain(index, c2, f2, l2, p, True)
        diag, qgrid = seed[0], seed[1]
        top_d, votes, _ = se._top_diagonals_plain(diag, nc)
        mm, pref = mmo._prefix_mismatches_plain(genome_dev, q2, top_d, l2,
                                                None, None)
        ii, jj, pv = gg._select_pairs_plain(top_d, votes,
                                      gg._indel_pairs_eligible(30, 9), 16)
        qp5, qp3 = se._qpos_ranges_plain(diag, qgrid, top_d)
        kargs = (top_d, mm, pref, ii, jj, pv, l2, budget, 100, qp5, qp3, 9,
                 30, 4)
        shape = f"W={st} NC={nc}"
        checks += [
            ("seed_diagonals", shape,
             partial(se._seed_diagonals_cuda, index, c2, f2, l2, p, True),
             partial(se._seed_diagonals_plain, index, c2, f2, l2, p, True)),
            ("top_diagonals", shape,
             partial(se._top_diagonals_cuda, diag, nc),
             partial(se._top_diagonals_plain, diag, nc)),
            ("prefix_mismatches", shape,
             partial(mmo._prefix_mismatches_cuda, genome_dev, q2, top_d, l2,
                     None, None),
             partial(mmo._prefix_mismatches_plain, genome_dev, q2, top_d, l2,
                     None, None)),
            ("solve_indels", shape,
             partial(_fields, gg._solve_indels_cuda, kargs, gg._INDEL_KEYS),
             partial(_fields, gg._solve_indels_plain, kargs, gg._INDEL_KEYS)),
        ]
        # reads, index lookups (two offsets per k-mer, a position per
        # filled slot), genome words of each candidate span, outputs
        kmers = c2.shape[0] * (100 - db.k + 1)
        costs.setdefault("seed_diagonals", lambda out: (
            _nbytes(c2, f2, l2, out) + kmers * 8
            + int((out[0] != se.INVALID_DIAG).sum()) * 4, 0))
        costs.setdefault("top_diagonals", lambda out, d=diag: (
            _nbytes(d, out), d.numel() * math.log2(d.shape[1])))
        library.setdefault("top_diagonals", partial(
            torch.sort, diag, dim=1, stable=True))
        costs.setdefault("prefix_mismatches", lambda out, t=top_d: (
            _nbytes(q2, t, l2, out) + t.numel() * gwords(100), 0))
        costs.setdefault("solve_indels", lambda out, a=kargs: (
            _nbytes(a, out), 0))
        # the conversion and SNP (alt genome) variants of K3
        alt = (genome_dev.ref16.flip(0).contiguous(), genome_dev.flag16)
        for conv, a in (("ct", None), ("ga", alt)):
            checks.append((f"prefix_mismatches/{conv}", shape,
                           partial(mmo._prefix_mismatches_cuda, genome_dev,
                                   q2, top_d, l2, conv, a),
                           partial(mmo._prefix_mismatches_plain, genome_dev,
                                   q2, top_d, l2, conv, a)))
    # the splice kernels on the RNA reads (the -N 1 runner's seed budget)
    r2, rf2, rl2 = strands(rna)
    rq2 = se._pack_device(r2, rf2, rl2, 100)
    rbudget = se.auto_budget(rl2, db.k, db.interval, -1)
    sdist = params.shortsplicedist
    for st, nc in ((runner_n1.params.seed_total, 32), (4096, 128)):
        p = se.GsnapParams(seed_total=st, ncand=nc,
                           size_threshold=params.size_threshold)
        diag = se._seed_diagonals_plain(index, r2, rf2, rl2, p, True)[0]
        top_d, votes, _ = se._top_diagonals_plain(diag, nc)
        _, pref = mmo._prefix_mismatches_plain(genome_dev, rq2, top_d, rl2,
                                               None, None)
        si, sj, sv = gg._select_pairs_plain(top_d, votes,
                                      gg._splice_pairs_eligible(sdist), 16)
        tr = gg._select_triples_plain(top_d, votes, sdist, 8)
        sargs = (genome_dev, top_d, pref, si, sj, sv, rl2, rbudget, 100)
        dargs = (genome_dev, top_d, pref, *tr, rl2, rbudget, 100)
        shape = f"W={st} NC={nc}"
        checks += [
            ("solve_splices", shape,
             partial(_fields, gg._solve_splices_cuda, sargs, gg._SPLICE_KEYS),
             partial(_fields, gg._solve_splices_plain, sargs,
                     gg._SPLICE_KEYS)),
            ("select_triples", shape,
             partial(gg._select_triples_cuda, top_d, votes, sdist, 8),
             partial(gg._select_triples_plain, top_d, votes, sdist, 8)),
            ("solve_doublesplices", shape,
             partial(_fields, gg._solve_doublesplices_cuda, dargs,
                     gg._SHORTEXON_KEYS),
             partial(_fields, gg._solve_doublesplices_plain, dargs,
                     gg._SHORTEXON_KEYS)),
        ]
        costs.setdefault("solve_splices", lambda out, a=sargs: (
            _nbytes(a[1:], out) + a[3].numel() * 2 * gwords(164), 0))
        costs.setdefault("select_triples", lambda out, t=top_d, v=votes: (
            _nbytes(t, v, out), 0))
        costs.setdefault("solve_doublesplices", lambda out, a=dargs: (
            _nbytes(a[1:], out) + a[3].numel() * 3 * gwords(164), 0))
        if nc == 32:
            sp = gg._solve_splices_plain(*sargs)
            sx = gg._solve_doublesplices_plain(*dargs)
            print(f"splice inputs W={st} NC={nc}: {int(sp['valid'].sum())} "
                  f"valid splice pairs ({int((sp['valid'] & ~sp['sense']).sum())}"
                  f" antisense), {int(sx['valid'].sum())} valid short exons",
                  flush=True)
    # K8 on the PE -N 1 runner's own ranked end hits of one batch of
    # pairs, and on hand-built hits (lefts above 2^24 and near 2^31)
    b = min(args.batch, len(rp1))
    inv2 = runner_mod.invert_records(rp2[:b])
    res, _ = runner_n1.dispatch_pairs(rp1[:b], inv2)
    plens = [torch.from_numpy(runner_mod.encode_batch(r, 100)[2]).to(dev)
             for r in (rp1[:b], inv2)]
    hand, *hlens = synth.pair_hit_cases(rng, args.batch, db.chr_ends)
    hand = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                else v).to(dev) for k, v in hand.items()}
    h5, h3 = ({k: v[sl] for k, v in hand.items()}
              for sl in (slice(0, args.batch), slice(args.batch, None)))
    hlens = [torch.from_numpy(x).to(dev) for x in hlens]
    for what, e5, e3, (ln5, ln3) in (
            ("runner", res["end5_pairing"], res["end3_pairing"], plens),
            ("hand-built",
             gg.rank_hits(h5, params, apply_optimal=False, maxout=16),
             gg.rank_hits(h3, params, apply_optimal=False, maxout=16), hlens)):
        gargs = (e5, e3, ln5, ln3, genome_dev.chr_offsets,
                 runner_n1._pairmax(), params.subopt_levels, 100)
        checks.append((
            "pair_grid", f"{len(ln5)} {what} pairs",
            partial(_fields, pe._pair_grid_cuda, gargs, pe.PAIR_GRID_KEYS),
            partial(_fields, pe._pair_grid_plain, gargs, pe.PAIR_GRID_KEYS)))
        costs.setdefault("pair_grid", lambda out, a=gargs: (
            _nbytes(a, out), 0))
    # K13-K16 on the main paths' inputs: SE -N 0 and -N 1 at the main and
    # the wide lane's widths, one PE -N 1 batch (read 1s and inverted read
    # 2s, as align_batch_pe stacks them), and hand-built edges
    def batch1(recs, mates=None):
        b = min(args.batch, len(recs))
        enc = runner_mod.encode_batch(recs[:b], 100)
        if mates is not None:
            enc = [np.concatenate([x, y]) for x, y in zip(enc, (
                runner_mod.encode_batch(runner_mod.invert_records(
                    mates[:b]), 100)))]
        return [torch.from_numpy(x).to(dev) for x in enc]

    def stage(label, recs, gp, mates=None, rank=True):
        for name, shape, fk, fp, cost in _stage_checks(
                torch, gg, se, mmo, genome_dev, index, None,
                *batch1(recs, mates), gp, label, rank):
            checks.append((name, shape, fk, fp))
            costs.setdefault(name, cost)

    wide = lambda gp: dataclasses.replace(gp, base=dataclasses.replace(
        gp.base, seed_total=4096, ncand=128))
    stage("SE -N 0", records, runner.gapped_params)
    stage("SE -N 0 wide", records, wide(runner.gapped_params))
    stage("SE -N 1", rna, runner_n1.gapped_params)
    stage("SE -N 1 wide", rna, wide(runner_n1.gapped_params))
    stage("PE -N 1", rp1, runner_n1.gapped_params, rp2)
    for name, shape, fk, fp, cost in _stage_edges(torch, gg, se, synth, rng,
                                                  dev, params):
        checks.append((name, shape, fk, fp))
        costs.setdefault(name, cost)
    # library yardsticks: one stable sort of the packed (score, left,
    # !plusp) key per read (K14), one of the negated pair scores (K16)
    c1, f1, l1 = batch1(records)
    out1, _ = gg.gather_candidates(genome_dev, index, None, c1, f1, l1,
                                   runner.gapped_params)
    rkey = ((out1["score"].long() << 33) | (out1["left"] << 1)
            | (~out1["plusp"]).long())
    library["rank_hits"] = partial(torch.sort, rkey, dim=1, stable=True)
    crc1, frc1 = se._revcomp_batch(c1, f1, l1)
    sdiag = se._seed_diagonals_plain(
        index, torch.cat([c1, crc1]), torch.cat([f1, frc1]),
        torch.cat([l1, l1]), runner.params, True)[0]
    std, svt, _ = se._top_diagonals_plain(sdiag, 32)
    elig = (gg._indel_pairs_eligible(30, 9)(std[:, :, None], std[:, None, :])
            & (std != se.INVALID_DIAG)[:, :, None]
            & (std != se.INVALID_DIAG)[:, None, :])
    pscore = torch.where(elig, svt[:, :, None] + svt[:, None, :], -1
                         ).reshape(std.shape[0], -1)
    library["select_pairs"] = partial(torch.sort, -pscore, dim=1, stable=True)

    # the -s / -v inputs: path 5's reads, seeded on the SNP index (K1, K2),
    # verified against the alt genome (K3), spliced with the known-site
    # masks at novel 1 and 0 (K5, K7); then K5/K7 again on dense random
    # masks with diagonals whose start is a multiple of 32, diagonals next
    # to the genome end and INVALID ones
    v2, vf2, vl2 = strands(rna5)
    vq2 = se._pack_device(v2, vf2, vl2, 100)
    vbudget = se.auto_budget(vl2, db.k, db.interval, -1)
    sidx, alt, known = runner_sv.index, runner_sv.alt, runner_sv.known
    p = se.GsnapParams(seed_total=runner_sv.params.seed_total, ncand=32,
                       size_threshold=params.size_threshold)
    seed = se._seed_diagonals_plain(sidx, v2, vf2, vl2, p, True)
    top_d, votes, _ = se._top_diagonals_plain(seed[0], 32)
    shape = "path 5 NC=32"
    checks += [
        ("seed_diagonals/snp index", shape,
         partial(se._seed_diagonals_cuda, sidx, v2, vf2, vl2, p, True),
         partial(se._seed_diagonals_plain, sidx, v2, vf2, vl2, p, True)),
        ("top_diagonals/snp index", shape,
         partial(se._top_diagonals_cuda, seed[0], 32),
         partial(se._top_diagonals_plain, seed[0], 32)),
        ("prefix_mismatches/alt", shape,
         partial(mmo._prefix_mismatches_cuda, genome_dev, vq2, top_d, vl2,
                 None, alt),
         partial(mmo._prefix_mismatches_plain, genome_dev, vq2, top_d, vl2,
                 None, alt))]
    kmers5 = v2.shape[0] * (100 - db.k + 1)
    costs["seed_diagonals/snp index"] = lambda out: (
        _nbytes(v2, vf2, vl2, out) + kmers5 * 8
        + int((out[0] != se.INVALID_DIAG).sum()) * 4, 0)
    costs["top_diagonals/snp index"] = lambda out, d=seed[0]: (
        _nbytes(d, out), d.numel() * math.log2(d.shape[1]))
    # K3 with alt reads the alt words of each span too
    costs["prefix_mismatches/alt"] = lambda out, t=top_d: (
        _nbytes(vq2, t, vl2, out) + t.numel() * gwords(100) * 3 // 2, 0)
    _, vpref = mmo._prefix_mismatches_plain(genome_dev, vq2, top_d, vl2, None,
                                            alt)
    si, sj, sv = gg._select_pairs_plain(top_d, votes,
                                  gg._splice_pairs_eligible(sdist), 16)
    tr = gg._select_triples_plain(top_d, votes, sdist, 8)
    G = int(genome_dev.length)
    top_e = top_d.clone()
    top_e[0::4, 5] &= ~31                            # start & 31 == 0
    top_e[1::4, 6] = G - 40 - torch.arange(top_e[1::4].shape[0],
                                           device=dev) % 30
    top_e[2::4, 7] = se.INVALID_DIAG
    _, epref = mmo._prefix_mismatches_plain(genome_dev, vq2, top_e, vl2, None,
                                            alt)
    ei, ej = si.clone(), sj.clone()
    ei[:, 10], ej[:, 11], ei[:, 12], ej[:, 13] = 5, 6, 7, 5
    etr = [x.clone() for x in tr]
    etr[0][:, 4], etr[1][:, 5], etr[2][:, 6] = 5, 6, 7
    rnd_known = _known_masks(torch, rng, known[0].shape[0], dev, 0.15)
    kwords = lambda n_seg: n_seg * 2 * ((100 + 1 + 31) // 32 + 1) * 4
    for label, td, pr, pairs, trip, kn, novel in (
            ("no masks novel=1", top_d, vpref, (si, sj, sv), tr, None, True),
            ("known novel=1", top_d, vpref, (si, sj, sv), tr, known, True),
            ("known novel=0", top_d, vpref, (si, sj, sv), tr, known, False),
            ("random masks novel=1", top_e, epref, (ei, ej, sv), etr,
             rnd_known, True),
            ("random masks novel=0", top_e, epref, (ei, ej, sv), etr,
             rnd_known, False)):
        sargs = (genome_dev, td, pr, *pairs, vl2, vbudget, 100, novel, kn)
        dargs = (genome_dev, td, pr, *trip, vl2, vbudget, 100, novel, kn)
        checks += [
            (f"solve_splices/{label}", shape,
             partial(_fields, gg._solve_splices_cuda, sargs, gg._SPLICE_KEYS),
             partial(_fields, gg._solve_splices_plain, sargs,
                     gg._SPLICE_KEYS)),
            (f"solve_doublesplices/{label}", shape,
             partial(_fields, gg._solve_doublesplices_cuda, dargs,
                     gg._SHORTEXON_KEYS),
             partial(_fields, gg._solve_doublesplices_plain, dargs,
                     gg._SHORTEXON_KEYS))]
        # the splice kernels' bytes plus the bitvector words they read: per
        # pair (triple), 2 (3) segments, 2 classes, the words of L + 1 bits
        nk = 0 if kn is None else 1
        costs[f"solve_splices/{label}"] = lambda out, a=sargs, nk=nk: (
            _nbytes(a[1:9], out) + a[3].numel() * 2 * gwords(164)
            + nk * kwords(a[3].numel() * 2), 0)
        costs[f"solve_doublesplices/{label}"] = lambda out, a=dargs, nk=nk: (
            _nbytes(a[1:10], out) + a[3].numel() * 3 * gwords(164)
            + nk * kwords(a[3].numel() * 3), 0)
        if label.startswith("known"):
            sp = gg._solve_splices_plain(*sargs)
            sx = gg._solve_doublesplices_plain(*dargs)
            print(f"splice inputs of path 5, {label}: "
                  f"{int(sp['valid'].sum())} valid splice pairs, "
                  f"{int(sx['valid'].sum())} valid short exons", flush=True)
    lanes = [("SE -N 1", _lane_inputs(eng, dp, runner_n1, rna, args.batch,
                                      "SE -N 1")),
             ("SE -N 0", _lane_inputs(eng, dp, runner, records, args.batch,
                                      "SE -N 0"))]
    checks += _gmap_checks(torch, eng, dp, lanes, rng, dev, costs)
    errs, bounds, times = {}, {}, {}
    print(f"kernel checks at {time.time() - t_start:.1f} s", flush=True)
    for name, shape, fk, fp in checks:
        want = fp()
        err = _max_abs_err(fk(), want)
        print(f"kernel {name:20s} {shape:22s}: max_abs_err={err}", flush=True)
        if err != 0:
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version (max_abs_err={err})")
        if name not in errs:
            errs[name] = err
            cost = costs.get(name) or costs[name.split("/")[0]]
            bounds[name] = _bound(*cost(want))
    torch.cuda.synchronize()

    # 5. the four main paths
    paths = {}

    def path(label, want, recs, run_with, mates=None, optional=()):
        """Drive one main path and check which kernels it launched."""
        out = _drive(torch, kbuild, run_with, recs, args.batch, label, mates)
        missing = [k for k in want if out["launches"].get(k, 0) == 0]
        extra = [k for k in ALL_KERNELS if k not in want + optional
                 and out["launches"].get(k, 0)]
        if missing or extra:
            raise SystemExit(f"{label} path: kernels not launched {missing}, "
                             f"launched but not on the path {extra}")
        paths[label] = out["launches"]
        return out["sam"]

    def bar(label, what, good, tot, share):
        print(f"{label}: {what} {good}/{tot} ({100 * good / max(tot, 1):.1f}%)",
              flush=True)
        if tot == 0 or good < share * tot:
            raise SystemExit(f"{label}: only {good}/{tot} {what}")

    print(f"resident index bytes: {_resident(db)}", flush=True)
    sam = path("SE -N 0", N0_KERNELS + STAGE_KERNELS + GMAP_KERNELS, records,
               runner,
               optional=DYNPROG_KERNELS)
    bar("SE -N 0", "planted <=2-sub reads placed",
        *_planted_ok(sam, truth, genome), 0.99)
    sam = path("SE -N 1", N0_KERNELS + SPLICE_KERNELS + GMAP_KERNELS
               + DYNPROG_KERNELS + STAGE_KERNELS, rna, runner_n1)
    bar("SE -N 1", "easy planted junctions recovered",
        *_junctions_ok(sam, rna_truth, genome), 0.90)
    sam = path("PE -N 0", N0_KERNELS + PAIR_KERNELS + GMAP_KERNELS
               + STAGE_KERNELS, p1, runner, p2, optional=DYNPROG_KERNELS)
    bar("PE -N 0", "planted <=2-sub concordant pairs proper at both "
        "positions and |TLEN|", *_pairs_ok(sam, p_truth, genome), 0.99)
    sam = path("PE -N 1", ALL_KERNELS, rp1, runner_n1, rp2)
    bar("PE -N 1", "planted <=2-sub concordant pairs proper at both "
        "positions and |TLEN|", *_pairs_ok(sam, rp_truth, genome), 0.99)
    bar("PE -N 1", "easy junction pairs with their planted intron",
        *_junction_pairs_ok(sam, rp_truth, genome), 0.90)

    # paths 5 and 6: -N 1 with known sites and the SNP index.  The GMAP
    # terminal and improvement lanes are gated off under -s/-v
    # (runner.py:2208, :2299-2301, :2342); pairsearch is not
    sites_of = synth.site_arrays(introns, decoys)
    # the short-end lane splices a read whose short end matches its planted
    # partner site alone; it never splices a minus read whose short end is
    # the left piece of a sense intron (runner.py:1532, the reference's
    # own behaviour)
    splices = lambda t: (synth.shortend_unique(genome, sites_of, t)
                         and not (t.intron.sense and t.short_side == "L"
                                  and not t.plusp))
    sam = path("SE -N 1 -s -v", N0_KERNELS + SPLICE_KERNELS + STAGE_KERNELS,
               rna5, runner_sv,
               optional=GMAP_KERNELS + DYNPROG_KERNELS)
    bar("SE -N 1 -s -v", "SNP-heavy reads placed at their origin",
        *_placed_ok(sam, [(f"v{i}", t.left, t.plusp)
                          for i, t in enumerate(snp5_t)], genome), 0.99)
    eligible = [(f"k{i}", (t.intron.donor, t.intron.acceptor))
                for i, t in enumerate(short5_t) if splices(t)]
    print(f"SE -N 1 -s -v: {len(eligible)} of {len(short5_t)} short-end "
          f"reads have a unique partner site", flush=True)
    bar("SE -N 1 -s -v", "short-end reads with a unique partner spliced "
        "with their planted intron", *_spliced_ok(sam, eligible, genome), 0.90)
    bar("SE -N 1 -s -v", "reads across known non-canonical introns spliced",
        *_spliced_ok(sam, [(f"c{i}", (t.intron.donor, t.intron.acceptor))
                           for i, t in enumerate(nc5_t)], genome), 0.90)
    bar("SE -N 1 -s -v", "easy planted junctions recovered",
        *_junctions_ok(sam, rna_truth[:n_base5], genome), 0.90)
    sam = path("PE -N 1 -s -v", N0_KERNELS + SPLICE_KERNELS + PAIR_KERNELS
               + STAGE_KERNELS, r61, runner_sv, r62,
               optional=GMAP_KERNELS + DYNPROG_KERNELS)
    resolved = runner_sv.ambi_resolved
    print(f"PE -N 1 -s -v: {resolved} ambiguous short ends resolved inside "
          f"a pair by _resolve_inside_ambi ({len(amb1)} such pairs planted)",
          flush=True)
    if resolved < 1:
        raise SystemExit("PE -N 1 -s -v: no inside-ambiguous pair resolved")
    bar("PE -N 1 -s -v", "SNP-heavy read 1 of a pair placed at its origin",
        *_placed_ok(sam, [(f"w{i}", t.left, t.plusp)
                          for i, t in enumerate(snp6_t)], genome, mate=0),
        0.99)
    bar("PE -N 1 -s -v", "planted <=2-sub concordant pairs proper at both "
        "positions and |TLEN|", *_pairs_ok(sam, rp_truth[:n_base6], genome),
        0.99)
    bar("PE -N 1 -s -v", "easy junction pairs with their planted intron",
        *_junction_pairs_ok(sam, rp_truth[:n_base6], genome), 0.90)
    bar("PE -N 1 -s -v", "reads across known non-canonical introns spliced "
        "in a pair", *_spliced_ok(
            sam, [(f"n{i}", (t.intron.donor, t.intron.acceptor))
                  for i, t in enumerate(nc6_t)], genome, mate=0), 0.90)

    # 6. the plain torch path on the CPU gives the same SAM
    print(f"CPU plain paths at {time.time() - t_start:.1f} s", flush=True)
    nsub, npairs = min(512, len(records)), min(256, len(p1))
    for label, novel, run_cuda, run in (
            ("SE -N 0", False, runner,
             lambda r, out: r.run(records[:nsub], out, batch_size=256)),
            ("SE -N 1", True, runner_n1,
             lambda r, out: r.run(rna[:nsub], out, batch_size=256)),
            ("PE -N 0", False, runner,
             lambda r, out: r.run_pe(p1[:npairs], p2[:npairs], out,
                                     batch_size=128)),
            ("PE -N 1", True, runner_n1,
             lambda r, out: r.run_pe(rp1[:npairs], rp2[:npairs], out,
                                     batch_size=128))):
        cpu_runner = runner_mod.GsnapRunner(db, params, lmax=100,
                                            novelsplicing=novel, device="cpu")
        ref_out, cuda_out = io.StringIO(), io.StringIO()
        run(cpu_runner, ref_out)
        counts = _count_gmap_hits(run_cuda)
        kbuild.LAUNCHES.clear()
        run(run_cuda, cuda_out)
        _uncount_gmap_hits(run_cuda)
        if ref_out.getvalue() != cuda_out.getvalue():
            raise SystemExit(f"{label}: CUDA and CPU plain-path SAM differ")
        unit = f"{npairs} pairs" if label[0] == "P" else f"{nsub} reads"
        gmap = {k: kbuild.LAUNCHES.get(k, 0) for k in GMAP_KERNELS}
        if counts["candidates"] == 0 or 0 in gmap.values():
            raise SystemExit(f"{label}: the GMAP lanes did not fire in the "
                             f"compared subset ({counts}, launches {gmap})")
        print(f"{label} cpu plain path: SAM of {unit} byte-equal to the CUDA "
              f"run, whose GMAP lanes converted {counts['candidates']} "
              f"candidate hits ({counts['final']} in final hit lists, "
              f"{counts['pairs']} in rescued pairs; launches {gmap})",
              flush=True)
    # paths 5 and 6: the subset must launch K5/K7 (with the known masks,
    # which runner_sv always passes) and hold short-end and SNP-heavy reads
    cpu_sv = runner_mod.GsnapRunner(
        db, params, lmax=100, novelsplicing=True, splicesdb=sites_path,
        snpsdb="snps", snps_dir=tmp, device="cpu")
    for label, recs, run in (
            ("SE -N 1 -s -v", rna5[:nsub],
             lambda r, out: r.run(rna5[:nsub], out, batch_size=256)),
            ("PE -N 1 -s -v", r61[:npairs],
             lambda r, out: r.run_pe(r61[:npairs], r62[:npairs], out,
                                     batch_size=128))):
        kinds = {c: sum(r.label[0] == c for r in recs) for c in "vwkjcna"}
        ref_out, cuda_out = io.StringIO(), io.StringIO()
        run(cpu_sv, ref_out)
        kbuild.LAUNCHES.clear()
        run(runner_sv, cuda_out)
        if ref_out.getvalue() != cuda_out.getvalue():
            raise SystemExit(f"{label}: CUDA and CPU plain-path SAM differ")
        spl = {k: kbuild.LAUNCHES.get(k, 0) for k in SPLICE_KERNELS}
        snp = kinds["v"] + kinds["w"]
        short = kinds["k"] + kinds["j"]
        if 0 in spl.values() or not snp or not short:
            raise SystemExit(f"{label}: the compared subset lacks known-site "
                             f"splicing launches ({spl}), SNP-heavy ({snp}) "
                             f"or short-end ({short}) reads")
        unit = f"{npairs} pairs" if label[0] == "P" else f"{nsub} reads"
        print(f"{label} cpu plain path: SAM of {unit} byte-equal to the CUDA "
              f"run ({snp} SNP-heavy, {short} short-end, "
              f"{kinds['c'] + kinds['n']} non-canonical, {kinds['a']} "
              f"inside-ambiguous; launches {spl})", flush=True)
    del cpu_sv

    # paths 7 and 8: the cmet / atoi modes (BASELINE config 5).  Each
    # writes its converted index pair (flat offsets) into the temporary
    # directory, loads it through the runner (--cmetdir / --atoidir),
    # checks K1 on both converted indexes, K3 with each strand's
    # conversion and K13-K16 on the path's own strands, drives the path,
    # compares a CPU subset, then frees the pair and its files before the
    # next mode loads its own
    def mode_path(mode, kind_, label, recs, mates, novel, want, bars):
        t0 = time.time()
        mdir = os.path.join(tmp, kind_)
        os.makedirs(mdir)
        transforms.write_converted_indexes(
            mdir, db.dbname, codes, flags, db.chr_ends, kind_, k=db.k,
            basesize=db.k, interval=db.interval)
        t_write = time.time() - t0
        t0 = time.time()
        mparams = se.GsnapParams(mode=mode, size_threshold=(
            se.dynamic_size_threshold(int(db.offsets[-1]), db.k, mode)))
        mkw = {f"{kind_}_dir": mdir}
        r = runner_mod.GsnapRunner(db, mparams, lmax=100,
                                   novelsplicing=novel, device=dev, **mkw)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        print(f"setup {label}: write_converted_indexes ({kind_}, two "
              f"k={db.k} indexes) {t_write:.2f} s, runner set-up (read and upload of "
              f"the pair) {t_load:.2f} s, {len(r.index.positions)} + "
              f"{len(r.index_minus.positions)} positions", flush=True)
        print(f"resident index bytes: {_resident(db)}", flush=True)
        for name, shape, fk, fp, cost in _stage_checks(
                torch, gg, se, mmo, genome_dev, r.index, r.index_minus,
                *batch1(recs, mates), r.gapped_params, label):
            name = f"{name} {label}" if "/" in name else f"{name}/{label}"
            err = _max_abs_err(fk(), fp())
            print(f"kernel {name:20s} {shape:22s}: max_abs_err={err}",
                  flush=True)
            if err != 0:
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version (max_abs_err={err})")
            errs[name] = err
            bounds[name] = _bound(*cost(fp()))
            if (name.startswith(("seed_diagonals/", "prefix_mismatches/"))
                    or name in (f"rank_hits/{label}",
                                f"lane_features/{label}")):
                times[name] = (_device_ms(fk), _device_ms(fp))
        sam = path(label, want, recs, r, mates,
                   optional=GMAP_KERNELS + DYNPROG_KERNELS)
        gl = {k: paths[label].get(k, 0) for k in GMAP_KERNELS
              + DYNPROG_KERNELS}
        print(f"{label}: GMAP kernel launches {gl}", flush=True)
        bars(sam)
        cpu_r = runner_mod.GsnapRunner(db, mparams, lmax=100,
                                       novelsplicing=novel, device="cpu",
                                       **mkw)
        n = nsub if mates is None else npairs
        ref_out, cuda_out = io.StringIO(), io.StringIO()
        for rr, o in ((cpu_r, ref_out), (r, cuda_out)):
            if mates is None:
                rr.run(recs[:n], o, batch_size=256)
            else:
                rr.run_pe(recs[:n], mates[:n], o, batch_size=128)
        if ref_out.getvalue() != cuda_out.getvalue():
            raise SystemExit(f"{label}: CUDA and CPU plain-path SAM differ")
        print(f"{label} cpu plain path: SAM of {n} "
              f"{'reads' if mates is None else 'pairs'} byte-equal to the "
              f"CUDA run", flush=True)
        del cpu_r, r
        datadir.release(db, "converted")
        torch.cuda.empty_cache()
        shutil.rmtree(mdir)

    def bars7(sam):
        bar("SE cmet -N 0", "planted non-repeat bisulfite reads placed at "
            "their origin", *_placed_ok(sam, [
                (f"b{i}", t.left, t.plusp) for i, t in enumerate(bis_truth)
                if t.kind != "repeat"], genome), 0.99)
        bar("SE cmet -N 0", "read-C / genome-T sites shown in MD",
            *_ct_sites_shown(sam, bis_truth, genome), 1.0)

    def bars8(sam):
        bar("PE atoi -N 1", "edited <=2-sub concordant pairs proper at both "
            "positions and |TLEN|", *_pairs_ok(sam, ep_truth, genome, "e",
                                               ep_edited), 0.99)
        bar("PE atoi -N 1", "planted <=2-sub concordant pairs proper at both "
            "positions and |TLEN|", *_pairs_ok(sam, ep_truth, genome, "e"),
            0.99)

    mode_path("cmet-stranded", "cmet", "SE cmet -N 0", bis, None, False,
              N0_KERNELS + STAGE_KERNELS, bars7)
    mode_path("atoi-stranded", "atoi", "PE atoi -N 1", ep1, ep2, True,
              N0_KERNELS + SPLICE_KERNELS + PAIR_KERNELS + STAGE_KERNELS,
              bars8)
    if "jax" in sys.modules or "gmap_gsnap_tpu" in sys.modules:
        raise SystemExit("jax or the JAX package was imported")

    # 7. kernel and plain-version times, and the -N 1 profiles, last, so
    # that the profiler cannot perturb the main paths' timing
    print(f"timing phase at {time.time() - t_start:.1f} s", flush=True)
    for name, shape, fk, fp in checks:
        # K9-K12 are timed at their first shape only: their plain
        # versions run thousands of small torch ops per call; K13-K16 at
        # their first shape too (their variants are checked, not timed)
        base_name = name.split("/")[0]
        if name in times and name in GMAP_CHECKS:
            continue
        if base_name in STAGE_NAMES and (name in times or "/" in name):
            continue
        ms, plain_ms = _device_ms(fk), _device_ms(fp)
        call, plain_call = _call_ms(fk), _call_ms(fp)
        print(f"kernel {name:20s} {shape:22s}: device time cuda {ms:.4f} ms, "
              f"plain torch {plain_ms:.4f} ms; per call (events) "
              f"{call:.4f} / {plain_call:.4f} ms", flush=True)
        times.setdefault(name, (ms, plain_ms))
    library_ms = {name: _device_ms(fn) for name, fn in library.items()}
    for name, ms in library_ms.items():
        print(f"library call for {name}: {ms:.4f} ms", flush=True)
    _profile_run(torch, lambda: runner_n1.run(rna, io.StringIO(),
                                              batch_size=args.batch),
                 "SE -N 1")
    _profile_run(torch, lambda: runner_n1.run_pe(rp1, rp2, io.StringIO(),
                                                 batch_size=args.batch),
                 "PE -N 1")

    src = "gmap_gsnap_tpu/align/gsnap_gapped.py"
    sources = {
        "seed_diagonals": ("gsnap_seed_diagonals", "seed_diagonals.cu",
                           "gmap_gsnap_tpu/align/gsnap_se.py:289"),
        "top_diagonals": ("gsnap_top_diagonals", "top_diagonals.cu",
                          "gmap_gsnap_tpu/align/gsnap_se.py:354"),
        "prefix_mismatches": ("gsnap_prefix_mismatches",
                              "prefix_mismatches.cu", f"{src}:89"),
        "solve_indels": ("gsnap_solve_indels", "solve_indels.cu", f"{src}:383"),
        "solve_splices": ("gsnap_solve_splices", "solve_splices.cu",
                          f"{src}:515"),
        "select_triples": ("gsnap_select_triples", "select_triples.cu",
                           f"{src}:668"),
        "solve_doublesplices": ("gsnap_solve_doublesplices",
                                "solve_doublesplices.cu", f"{src}:706"),
        "pair_grid": ("gsnap_pair_grid", "pair_grid.cu",
                      "gmap_gsnap_tpu/align/gsnap_pe.py:119"),
        "seed_segments": ("gmap_seed_segments", "gmap_seed_segments.cu",
                          "gmap_gsnap_tpu/align/gmap_engine.py:48"),
        "chain": ("gmap_chain", "gmap_chain.cu",
                  "gmap_gsnap_tpu/align/gmap_engine.py:184"),
        "banded_gotoh": ("gmap_banded_gotoh", "banded_gotoh.cu",
                         "gmap_gsnap_tpu/ops/dynprog.py:107"),
        "bridge_traceback": ("gmap_bridge_traceback", "bridge_traceback.cu",
                             "gmap_gsnap_tpu/ops/dynprog.py:328"),
        "lane_features": ("gsnap_lane_features", "lane_features.cu",
                          f"{src}:170"),
        "rank_hits": ("gsnap_rank_hits", "rank_hits.cu", f"{src}:1165"),
        "qpos_ranges": ("gsnap_qpos_ranges", "qpos_ranges.cu",
                        "gmap_gsnap_tpu/align/gsnap_se.py:385"),
        "select_pairs": ("gsnap_select_pairs", "select_pairs.cu",
                         f"{src}:334"),
    }
    kernels = []
    for name, (entry, cu, replaces) in sources.items():
        ms, plain_ms = times[name]
        variants = {v.split("/", 1)[1]: {
            "ms": times.get(v, (None, None))[0],
            "plain_ms": times.get(v, (None, None))[1],
            "max_abs_err": errs[v], "bound_ms": bounds[v][0],
            "bound_by": bounds[v][1]}
            for v in errs if v.startswith(name + "/")}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"gmap_gsnap_tpu_torch/csrc/{cu}",
                        "replaces": replaces,
                        "launches": paths["PE -N 1"][entry],
                        "launches_by_path": {
                            label: launches.get(entry, 0)
                            for label, launches in paths.items()},
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "library_ms": library_ms.get(name),
                        "variants": variants})
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
