#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (gmap_gsnap_tpu_torch).

    python3 chip_smoke.py [--mbp 100] [--reads 8192] [--pairs 8192]
                          [--batch 2048]

Runs in 13 to 17 minutes on one H100, as its host's CPU allows (build,
the database tools, eight gsnap paths, the gsnap CLI, the gmap CLI (path
9), the gsnap CLI with maps and split outputs (path 10), uniqscan,
checks, timings).

Needs one CUDA device; exits nonzero, printing no result, without one.
Every path runs gsnap's default --gmap-mode (pairsearch,
indel_knownsplice, terminal, improvement).  Phases (any failure raises
and ends the run with a nonzero exit):

  1. the card: torch.cuda.get_device_name and nvidia-smi's name and
     power limit;
  2. build the eighteen CUDA kernels from csrc/ (nvcc, sm_90a);
  3. a synthetic genome of 4 chromosomes (--mbp, default 100, about the
     C. elegans genome) with N runs and a repeat family, written as FASTA
     and built into a database directory by the port's gmap_build
     (python -m gmap_gsnap_tpu_torch.cli.gmap_build -k 15 -q 3: the
     large-genome setting, at the default basesize 12, so gamma offsets),
     opened with GenomeDB.open; its codes, flags, chromosome bounds,
     offsets and positions must equal synth.genome_db of the same genome,
     and every path runs on it; the seconds of the FASTA write, the build
     and the open are printed; while gmap_build runs, planted 100 bp
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
     SNPs, each written as text and stored by the port's iit_store into
     the database's maps folder, the SNP index built by its snpindex; path 5
     reads are path 2's RNA mix with 10% SNP-heavy reads (5-8 alt
     alleles), 5% short-end reads (1-12 nt past a known site) and 5%
     reads across known non-canonical introns; path 6 pairs are path 4's
     mix with the same additions as read 1 of concordant pairs and 3%
     pairs whose ambiguous short end faces inside the pair; each set-up
     step's time is printed; for path 7 bisulfite reads (--reads; either
     strand, non-CpG C -> T, CpG C kept with probability 0.75, 0-2 extra
     substitutions, 5% with a read-C / genome-T site, 1% in repeat
     copies) and for path 8 RNA pairs of path 4's mix (--pairs / 4) with
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
     cdna_direction, K11 also on synth.band_sweep_cases (W 1, 23 and 32,
     M 1, 33, 64 and 100, lband 0, a band of W cells and one past W, len2 below W
     and len2 = N, codes 4 and 5, jump late and early, both gap tiers);
     K1 on synth.seed_row_cases (k = 4: counts of 0, the threshold and
     one above it, N runs, reads shorter than L and than k, positions
     below their query position, grids that the repeat reads overflow;
     S 1, 31, 32, 33 and 100, interval 1, 3, 7 and 32, half on and off);
     K1/K2 on the SNP index, K3 with the alt genome and
     K5/K7 with the known-site masks at novel 1 and 0 on path 5's reads,
     and K5/K7 on dense random masks with word-aligned, genome-end and
     INVALID diagonals; K13-K16 on the strands of one batch of SE -N 0
     and SE -N 1 at NC=32 and at the wide lane's W=4096 / NC=128 and of
     one PE -N 1 batch, with K14 also without the optimal filter at
     maxout 16, with maxout above the candidate count and with the SE
     gates as its epilogue, and on hand-built edges:
     synth.mismatch_edge_rows at L 75, 100 and 150 (untrimmed ends that
     tie the trims, equal maxima, mismatches only past the read, all- and
     no-mismatch masks, reads shorter than lmax, a trim score beyond the
     read length), exact duplicate
     candidates and equal (score, left) on both strands, INVALID
     diagonals and seed slots, synth.qpos_range_cases (repeated and
     INVALID selected diagonals, all-INVALID rows, diagonals 0 and
     0xFFFFFFFE, qpos not monotone; W 1 to 4096) for K15,
     synth.triple_cases (clusters, wrapping differences, equal and zero
     votes, all-INVALID rows, sums at the key's width; NC 2 to 128,
     maxdist 0, 1, 200,000 and 2^32 - 1, T 1, 8 and 4 NC) for K6,
     diagonals near 2^31 and 2^32 under both pair rules and synth.diag_pair_rows (no or few eligible pairs, equal
     vote sums, sums at K16's key width; NC 3 to 128, maxpairs up to
     NC^2)); K7 on synth.doublesplice_cases (more than 8 candidates a
     junction, sites at s = 2 and len - 2, diagonals 63 and 64, at the
     genome end and INVALID, short reads, equal keys on both strands;
     NC 32 and 128, with and without known sites and novel splicing) and
     K5 on synth.splice_pair_cases (more than 16 candidates a class, the
     first-16 rule deciding; diagonals 63, 64, at the genome end, near
     2^32 and INVALID; equal sums, antisense equal to sense, known bits at
     word boundaries; budgets 0-6; the same variants);
     K3 on synth.prefix_mismatch_cases (B x NC off K3's tile, INVALID
     diagonals and diagonals at and past the genome end, N runs and
     query Ns, reads of 1, 15, 16 and 17 nt; every conversion with and
     without an alt genome, both N rules) and K4 on
     synth.indel_pair_cases (insertions of every shift, deletions,
     wrapping differences, rows named by several pairs, a candidate only
     at s = L, ties, rows without mismatches; min_end 0, 4 and past half
     the read, with and without the seed-order gate), both at L 75, 100,
     150 and 1024;
     K17 on each path's batch as the path gives it (the
     uniform flip) and in a mixed-length form (lengths 1, 15, 16, 17, 100,
     N runs), and on synth.pack_query_cases (lengths 0-33 and L, all-N
     reads, N runs, lengths past L; L 100, 17, 151, 16, 33 and 14,432, B
     61, 37, 1 and 0; both uniform forms); K8 with its overflow-gate
     epilogue on the PE -N 1 runner's own candidates of one batch and on
     hand-built rows where each term of the gate flips (truncated ends,
     int32 sums that wrap), at -N 0 and -N 1, and without the gate (known
     sites): outputs must be equal, float32 ones bit for bit;
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
     every path must launch K13-K17 too;
     on both PE paths >= 99% of the concordant pairs with <= 2
     substitutions per read must be reported as one proper pair (0x2)
     at both planted positions with |TLEN| the fragment length; with
     -N 1 >= 90% of the easy junction pairs (flanks >= 30 nt, <= 1
     substitution in the spliced read) must carry the planted intron;
     each path prints its GMAP hits in the SAM (single end) or in the
     ends' final hit lists and in rescued pairs (paired end), the GMAP
     candidate hits they came from, and the host seconds of its
     prefetch_gmap passes;
  5b. paths 7 and 8, one at a time, after both modes' converted index
     pairs are written side by side into the database directory by the
     port's cmetindex and atoiindex (gamma offsets; they run while the
     CPU plain paths of step 6 do, and end before its CLI runs): the
     mode's pair
     loaded by the runner (cmet_dir / atoi_dir); K1 on
     both converted indexes, K3 with each strand's conversion and
     K13-K16 checked on the path's own strands; then the path, its bars
     and a CPU-vs-CUDA SAM subset (512 reads, 256 pairs); then the pair
     and its files are freed:
     SE --mode cmet-stranded -N 0 (--reads): K1-K4 and K13-K17 must
           launch; >= 99% of the non-repeat bisulfite reads placed once at
           their origin; every read-C / genome-T site of a placed read
           shown as a mismatch in MD;
     PE --mode atoi-stranded -N 1 (--pairs / 4): K1-K8 and K13-K17 must
           launch; >= 99% of the edited (and of all) concordant pairs
           with <= 2 substitutions proper at both positions;
     both print whether K9-K12 launched (the modes gate the GMAP
     terminal and improvement lanes off; pairsearch is not);
  6. each path's SAM from the plain torch path on the CPU must be
     byte-equal to the CUDA run's (first 512 reads, first 256 pairs),
     and the CUDA run of that subset must launch K9/K10 and convert at
     least one GMAP candidate hit (paths 5 and 6: launch K5-K7, with
     SNP-heavy and short-end reads in the subset); and 256 planted RNA
     reads of 513 to 4,096 nt through align_batch_gapped at -N 1 (the
     card takes up to ops/mismatch.CUDA_MAX_READ_LENGTH bases): every
     output equal to the CPU plain path's, K1-K7 and K13-K17 launched, and
     K17 alone on their batch;
  6b. the gsnap CLI on the card: python -m gmap_gsnap_tpu_torch.cli.gsnap
     -D <dir> -d syn as a subprocess on the first 2048 reads or pairs of
     path 1 (SE -N 0), path 4 (PE -N 1, two FASTQ files), path 5 (-N 1 -s
     sites -v snps) and path 7 (--mode cmet-stranded --cmetdir, during
     5b): SAM byte-equal to the runner's for the same reads at the same
     batch size, header included, and the kernels the process launched
     (written at its exit by a shim that runs the CLI module as
     __main__) those of its path; its wall time and its own rate line
     printed;
  6c. -A gsnap (GSNAP's native output) on the card on 256 reads or pairs
     of paths 1, 4 and 5 (with --print-snps), byte-equal to the same CLI
     with --device cpu;
  6d. path 9, the gmap CLI on the card (BASELINE config 1), after paths 7
     and 8: python -m gmap_gsnap_tpu_torch.cli.gmap -D <dir> -d syn on 142
     cDNA queries (64 three-exon queries shaped as bench.py's gmap
     workload with their introns between strong splice sites, a quarter
     with 2 substitutions beside a junction; 64 with bench.py's own
     draws, whose junctions fall anywhere; 8 cross-chromosome chimeras; 4 queries of 20-60 kb in 20-40 exons, at
     Q = 65,536; 2 queries on duplicated segments, which the genome gets
     before it is written) in the default Paths format, -f samse and -A,
     in one process (_gmap_cli_runs, the runs sharing one database open)
     that counts each run's kernel launches: each output byte-equal to
     the same CLI's with --device cpu (started beside paths 7 and 8);
     K9-K12 must launch and no other kernel; K9 must run at Q = 65,536
     and on rows past its register hits; >= 99% of the three-exon
     queries of each set best on their planted chromosome and strand
     over the planted span; >= 90% of the first set's introns exact;
     >= 85% of the second set's exact or at a shift that leaves the
     spliced sequence as it is, and >= 99% those or moved to a
     canonical intron within 10 nt (GMAP takes a canonical intron and
     its mismatches over a non-canonical one); >= 7 of 8 chimeras as
     two parts on their planted chromosomes (samse); queries/s, walls,
     peak device memory and a profile of the -A run (device busy share,
     hand-kernel time, K9-K12's time and launches), with the clock at the
     path's start and end;
  6e. path 10, the gsnap CLI with the multimapping maps and the output
     router: one process of python -m gmap_gsnap_tpu_torch.cli.gsnap at
     PE -N 1 on 2048 pairs (a quarter inside copies of the repeat family)
     under -M 1, with a genes map (synth.copy_genes_gtf through the port's
     gtf_genes and iit_store), a tally and a runlength map over chosen
     copies (-g, --use-tally, --use-runlength), --split-output, a read
     group and -j 5: every split file and standard output byte-equal to
     the runner's in process through an OutputRouter with the same maps,
     K1-K17 launched, and fewer pairs with NH > 1 than the runner reports
     without the maps (both counts printed, with the CLI's rate line, wall
     and peak device memory); then uniqscan on the card on 200 nt that
     start 250 nt into a repeat copy, byte-equal to uniqscan --device cpu
     (started at path 10's start), launching SE -N 0's kernels;
  6f. path 11, scale-out (parallel/shard.py): the positions index in 2
     and 4 shards on cuda:0, K1 with each shard's bounds and the MIN over
     the shards at the main shape equal to K1 on the whole index, and
     align_batch_gapped -N 1 on each sharded index equal to the
     replicated one; K18 (shard_index_lookup) on 2048 reads' first k-mers
     at caps 32 and 128 over four shards and over one; two ranks started
     as torchrun starts them (RANK, WORLD_SIZE, ...; parallel/shard
     init_from_env: two cards with nccl where the host has them, else
     both on cuda:0 with gloo) run PE -N 1 on path 4's pairs against the
     gmap_build directory, SAM byte-equal to path 4's, each rank
     launching K1-K17, seeding on its own shard with the all-reduce MIN
     equal to the whole index, and timing the all-reduce MIN; a one-rank
     nccl group's all-reduce MIN on an int64 diag; the two ranks' pairs/s
     beside one process's on the same pairs;
  7. each kernel's device time (torch.profiler) and per-call time beside
     its plain version's (and its library call's) on the same clock: K1-K4,
     K6 and K8 at every shape and variant, K2, K6 and K14 at every shape
     and K16 on every strand batch under both rules (its edge rows once),
     each with its own library sort and bound, K15 at W=384 / NC=32 and
     W=4096 / NC=128, K5, K7, K9-K13 and K17 at their first shape (K10-K12
     over one call a profile), the edge-row checks untimed but K9's and
     K10's (tools/time_kernels.py times the others); each timing line and
     phase with the wall
     clock since the start and the seconds it took; the number of device
     ops one K14 call runs (1: its fields are gathered inside it), one
     K11 call (1: the pair matrix goes by value) and one K9, K10 and K17
     call (1 each); then profiles of the SE -N 1 and PE -N 1 runs (device
     busy share, top device ops, and every hand kernel with its time and
     launches, a template's instantiations summed), measured last so that
     the profiler cannot perturb step 5's timing.

Prints one JSON line with every kernel's launches (on the PE -N 1 path,
which runs all of them but K18, whose launches are path 11's; per path
under launches_by_path, the gmap CLI's default-format run as "gmap CLI",
path 10's process as "gsnap CLI maps", uniqscan's as "uniqscan" and path
11's as "scale-out"; the checks of
other inputs, such as K5 with known masks, under variants), error, device
time (ms, plain_ms at the first shape checked; clock says whether both
are torch.profiler device times or, where a profile recorded none, CUDA
event times with the host's launch gaps), its bound (bound_ms: the
larger of the bytes it must move over 3.35 TB/s and its operations over
67 T/s, the H100's float32 rate outside the tensor cores: its int32 rate
is lower (64 int32 lanes per SM against 128 float32), so the operations
term is an underestimate; bound_by says which) and the time of one PyTorch
call computing the same function where there is one (library_ms, else
null); K2, K6, K14, K15 and K16 also list every timed shape under "shapes" with its
own times, library time and bound; then the nvidia-smi line, then
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

N0_KERNELS = ("gsnap_seed_diagonals", "gsnap_top_diagonals",
              "gsnap_prefix_mismatches", "gsnap_solve_indels")
SPLICE_KERNELS = ("gsnap_solve_splices", "gsnap_select_triples",
                  "gsnap_solve_doublesplices")
PAIR_KERNELS = ("gsnap_pair_grid",)
GMAP_KERNELS = ("gmap_seed_segments", "gmap_chain")
DYNPROG_KERNELS = ("gmap_banded_gotoh", "gmap_bridge_traceback")
# checks timed at their first shape only (K5, K7, K9-K13, K17;
# tools/time_kernels.py times K5 and K7 at both shapes, with and without
# known-site masks)
FIRST_SHAPE_ONLY = ("solve_splices", "solve_doublesplices", "seed_segments",
                    "chain", "banded_gotoh", "bridge_traceback",
                    "lane_features", "pack_queries")
# of those, the edge checks timed once (their first shape), beside their
# bound: K9's and K10's
TIMED_EDGES = ("seed_segments/edges", "chain/edges")
# the other edge-row checks are checked, not timed (tools/time_kernels.py
# times the kernels on them): a variant whose name ends in one of these
UNTIMED_EDGES = ("/edges", "hand-built", "/near duplicates",
                 "/left 0 and 2^32-1", "/BIG-1, BIG, 0")
# kernels timed at every shape with their own library call and bound
PER_SHAPE = ("top_diagonals", "select_triples", "rank_hits",
             "select_pairs", "qpos_ranges")
# of those, the ones timed at these shapes alone (K15 at the main and the
# wide lane's seed grid: W = 384, NC = 32 and W = 4096, NC = 128)
ONLY_SHAPES = {"qpos_ranges": ("SE -N 0 both strands NC=32",
                               "SE -N 0 wide both strands NC=128")}
# of PER_SHAPE's, the checks timed at every shape (K16: both rules on every
# strand batch; its edge rows are timed once, as the other kernels' are,
# and at every shape by tools/time_kernels.py)
EVERY_CHECK = ("select_pairs", "select_pairs/splice")
# checks whose plain version is timed over one call a profile, not five
# (the kernel over five, in a profile of its own): the plain versions of
# K10-K12 run thousands of small torch ops a call, and five calls' events
# took the profiler 32-216 s a line to gather (an H100 run's clock)
ONE_REP = ("chain", "banded_gotoh", "bridge_traceback")
# K13-K16: trims and lane features, ranking (+ the SE gates), seed qpos
# ranges, pair selection — every path runs them
# K17 the read packing and reverse complement at the head of the cascade
STAGE_KERNELS = ("gsnap_lane_features", "gsnap_rank_hits",
                 "gsnap_qpos_ranges", "gsnap_select_pairs",
                 "gsnap_pack_queries")
ALL_KERNELS = (N0_KERNELS + SPLICE_KERNELS + PAIR_KERNELS + GMAP_KERNELS
               + DYNPROG_KERNELS + STAGE_KERNELS)
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_READS = 2048     # reads or pairs of each path the gsnap CLI aligns
NATIVE_READS = 256   # reads or pairs of each -A gsnap GPU-vs-CPU check
LONG_READS = 256     # reads of 513 nt and longer, card against CPU
LONG_LMAX = 4096     # the longest of them
CASCADE_PASSES = 5   # passes of a main path's device cascade alone
# path 9, the gmap CLI: three-exon cDNAs with their introns between
# strong splice sites (a quarter with a messy junction), as many shaped
# as bench.py make_gmap_workload draws them (junctions anywhere),
# cross-chromosome chimeras, long cDNAs (Q = 65,536) and queries on
# duplicated segments
GMAP_QUERIES, GMAP_BENCH, GMAP_CHIMERAS, GMAP_LONG, GMAP_DUPS = (
    64, 64, 8, 4, 2)
GMAP_FORMATS = (("paths", []), ("samse", ["-f", "samse"]), ("-A", ["-A"]))
# path 10, the gsnap CLI with the multimapping maps and the output router:
# PE -N 1 pairs, a quarter of them inside copies of the repeat family,
# under -M PATH10_M, a read group and -j PATH10_SHIFT
PATH10_PAIRS, PATH10_M, PATH10_SHIFT = 2048, 1, 5
PATH10_RG = ("--read-group-id", "RG10", "--read-group-name", "synth",
             "--read-group-library", "lib10", "--read-group-platform",
             "ILLUMINA")
UNIQSCAN_NT = 200   # uniqscan's sequence: 150 nt of a repeat copy, 50 past
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


def _pair_sort(torch, se, top_d, votes, eligible):
    """K16's library call: one stable torch.sort of the negated pair
    scores of these inputs (the plain version's scores).  The scores are
    made at the first call, the warm-up of every timing, so that the
    paths' peaks do not hold them (up to 268 MB a check at NC=128)."""
    neg = []

    def sort():
        if not neg:
            okd = top_d != se.INVALID_DIAG
            elig = (eligible(top_d[:, :, None], top_d[:, None, :])
                    & okd[:, :, None] & okd[:, None, :])
            score = torch.where(elig, votes[:, :, None] + votes[:, None, :],
                                -1)
            neg.append(-score.reshape(len(top_d), -1))
        return torch.sort(neg[0], dim=1, stable=True)

    return sort


def _grid_sort(torch, pe, gargs):
    """K8's library call: one stable torch.sort of the [B, NP^2] int64
    keys K8 ranks (eff << 16 | r5 << 12 | r3 << 8 | cell; r5 the rank of
    the cell's float32-rounded left5 among the row's NP, r3 of its left3),
    made from the plain version's cells at the first call, the warm-up of
    every timing.  It times the ranking's sort alone: no one PyTorch call
    computes K8's whole function."""
    keys = []

    def sort():
        if not keys:
            cells = pe._pair_cells_plain(*gargs[:7])
            l5 = cells["l5"][:, :, 0].int().float()
            l3 = cells["l3"][:, 0, :]
            r5 = (l5[:, None, :] < l5[:, :, None]).sum(2)
            r3 = (l3[:, None, :] < l3[:, :, None]).sum(2)
            b, np_ = r5.shape
            cell = torch.arange(np_ * np_, device=r5.device)
            keys.append(cells["eff"] << 16
                        | (r5[:, :, None] << 12 | r3[:, None, :] << 8)
                        .reshape(b, -1) | cell)
        return torch.sort(keys[0], dim=1, stable=True)

    return sort


def _bridge_cost(bargs):
    """K12's cost (bytes, operations) on bridge_traceback's arguments:
    both sides' nogap and ndiag (the candidates read them; the traceback
    reads gap1 / gap2 only along its walk), the problem's other inputs
    and the outputs; ~15 integer operations a junction candidate."""
    def cost(out):
        nb = bargs[0][0].shape[0] // 2
        return (_nbytes(bargs[0][0], bargs[0][3], bargs[1:12], out),
                15 * nb * bargs[12] * 2 * bargs[13])

    return cost


def _seed_cost(se, codes, nflags, lengths, k: int):
    """K1's cost (bytes, operations) on seed_diagonals' reads: the reads
    and the outputs, two offsets-table reads a k-mer and a positions read
    a filled slot."""
    def cost(out):
        kmers = codes.shape[0] * (codes.shape[1] - k + 1)
        return (_nbytes(codes, nflags, lengths, out) + kmers * 8
                + int((out[0] != se.INVALID_DIAG).sum()) * 4, 0)

    return cost


def _segment_cost(torch, sargs):
    """K9's (bytes, operations) on seed_segments' arguments: the oligos
    and valid flags, each valid k-mer's two offsets, each hit's position
    (min(nhits, H) a row) and the outputs; n log2 n compares a row's
    hits."""
    offs, pos, oligos, valid, k, H, S, thr = sargs
    nvalid = int(valid.sum())

    def cost(out):
        nv = out[4].clamp(max=H).double()
        return (_nbytes(oligos, valid, out) + nvalid * 8 + float(nv.sum()) * 4,
                float((nv * torch.log2(nv.clamp(min=1))).sum()))

    return cost


def _chain_lv(torch, valid):
    """Each row's last valid segment index (0 where none): the dependent
    steps K10 runs."""
    idx = torch.arange(valid.shape[1], device=valid.device)
    return torch.where(valid, idx, -1).max(1).values.clamp(min=0)


def _chain_cost(torch, cargs):
    """K10's (bytes, operations) on chain's arguments: the segments and
    the outputs; ~12 integer operations a transition scored (lv (lv + 1)
    / 2 a row)."""
    def cost(out):
        lv = _chain_lv(torch, cargs[3]).double()
        return _nbytes(cargs[:4], out), 12 * float((lv * (lv + 1) / 2).sum())

    return cost


def _gotoh_cost(margs):
    """K11's cost (bytes, operations) on banded_matrices' arguments: the
    codes, lengths, bands and jump rule read once, the four matrices
    written once; ~20 integer operations a band cell."""
    return lambda out: (_nbytes(margs[:6], margs[7], out),
                        20 * out[0].numel())


def _triple_cost(top_d, votes, maxdist: int, T: int):
    """K6's cost (bytes, operations), counting the work its range design
    needs on these inputs: the read's NC diagonals and votes in, 3 int64
    and a bool out for each of its T triples; the sort of a read's n valid
    diagonals (n log2 n compares), a binary search at each end of each
    valid middle's predecessor and successor ranges (4 log2 n), one top-2
    update (2 compares) at each end of each eligible edge, and the
    selection of T of the 4 NC keys (4 NC log2(4 NC))."""
    b, nc = top_d.shape
    nbytes = _nbytes(top_d, votes) + b * T * 25
    ok = top_d != 0xFFFFFFFF  # INVALID_DIAG
    nv = ok.sum(1).double()
    ops = float((5 * nv * nv.clamp(min=2).log2()).sum())
    ops += b * 4 * nc * math.log2(4 * nc)
    for r in range(0, b, 256):  # eligible edges, 256 reads at a time
        d, o = top_d[r:r + 256], ok[r:r + 256]
        step = (d[:, None, :] - d[:, :, None]) & 0xFFFFFFFF
        ops += 4 * int(((step >= 1) & (step <= maxdist) & o[:, :, None]
                        & o[:, None, :]).sum())
    return nbytes, ops


def _triple_sort(torch, se, top_d, votes, maxdist: int):
    """K6's library call: one stable torch.sort of the negated vote sums
    [B, 4 NC] of these inputs (the plain version's sums: each middle
    diagonal with its two best predecessors and successors, -1 where one
    is missing).  It times the final sort alone: the sums are made at the
    first call, the warm-up of every timing, and no one PyTorch call
    computes K6's whole function.  The first call prints the share of
    the sums that are valid."""
    neg = []

    def sort():
        if not neg:
            okd = top_d != se.INVALID_DIAG
            step = (top_d[:, None, :] - top_d[:, :, None]) & 0xFFFFFFFF
            elig = ((step >= 1) & (step <= maxdist) & okd[:, :, None]
                    & okd[:, None, :])
            v = votes.long()
            top2 = lambda x: torch.sort(x, dim=-1, descending=True,
                                        stable=True).values[..., :2]
            v2i = top2(torch.where(elig, v[:, :, None], -1).transpose(1, 2))
            v2j = top2(torch.where(elig, v[:, None, :], -1))
            vsum = (v[:, :, None, None] + v2i[:, :, :, None]
                    + v2j[:, :, None, :])
            ok = ((v2i[:, :, :, None] >= 0) & (v2j[:, :, None, :] >= 0)
                  & okd[:, :, None, None])
            neg.append(-torch.where(ok, vsum, -1).reshape(len(top_d), -1))
            print(f"K6 library sort: {tuple(neg[0].shape)} int64 sums, "
                  f"{float(ok.float().mean()):.4f} of them valid",
                  flush=True)
        return torch.sort(neg[0], dim=1, stable=True)

    return sort


def _named_rows(torch, top_d, segs) -> int:
    """The candidate rows that the pairs or triples name (segs: their
    index tensors [B, n]), each counted once a read."""
    base = torch.arange(len(segs[0]), device=segs[0].device)[:, None]
    return int(torch.unique(torch.cat(segs, 1) + base * top_d.shape[1])
               .numel())


def _segment_bytes(torch, top_d, segs, L: int, novel: bool, known) -> int:
    """Bytes of the candidate rows that the pairs or triples name (segs:
    their index tensors), each row once a read: its diagonal, its pref
    row (L + 1 int32), with novel splicing its genome span (L + 41 bases:
    without it every candidate is known on both sides and scores 1.0, so
    the genome is not needed) and, with known sites, the words of four
    site kinds over L + 1 positions."""
    nrows = _named_rows(torch, top_d, segs)
    per_row = 8 + (L + 1) * 4
    if novel:
        per_row += ((L + 41 + 15) // 16 + 1) * 4
    if known is not None:
        per_row += 4 * ((L + 32) // 32 + 1) * 4
    return nrows * per_row


def _splice_cost(torch, sargs):
    """K5's cost function on sargs = (genome, top_d, pref, ii, jj, pvalid,
    lengths, budget, L[, novel, known]): (bytes, operations).  Bytes: the
    pairs, lengths and budgets read once and the outputs written, and of
    the candidate rows only those the pairs name (_segment_bytes)."""
    novel = sargs[9] if len(sargs) > 9 else True
    known = sargs[10] if len(sargs) > 10 else None
    rows = _segment_bytes(torch, sargs[1], [sargs[3], sargs[4]], sargs[8],
                          novel, known)
    return lambda out: (_nbytes(sargs[3:9], out) + rows, 0)


def _prefix_cost(q, top_d, lengths, L: int, alt) -> callable:
    """K3's cost function: (bytes, operations).  Bytes: the packed reads,
    diagonals and lengths read once, the outputs written, and each
    placement's genome span: its code and N-flag words (L // 16 + 2 of
    each), and with an alt genome its alt code words too."""
    words = top_d.numel() * (L // 16 + 2) * (3 if alt is not None else 2)
    return lambda out: (_nbytes(q, top_d, lengths, out) + words * 4, 0)


def _indel_cost(torch, kargs):
    """K4's cost function on kargs = (top_d, mm, pref, ii, jj, pvalid,
    lengths, budget, L, qp5, qp3, ...): (bytes, operations).  Bytes: the
    mm rows that a read's pairs name, once a read (L bytes each; pref is
    not needed: mm determines it), the diagonals, pairs, lengths, budgets
    and seed ranges read once, and the outputs written.  (An earlier
    formula counted every mm and pref row.)"""
    top_d, ii, jj, L = kargs[0], kargs[3], kargs[4], kargs[8]
    rows = _named_rows(torch, top_d, [ii, jj]) * L
    return lambda out: (_nbytes(top_d, kargs[3:8], kargs[9:11], out) + rows,
                        0)


def _doublesplice_ops(torch, top_d, ti, tm, tj, L: int, novel: bool) -> int:
    """Operations K7's function needs on these inputs: for each triple
    whose three diagonals are >= 64 (the others stop there), 8 site-mask
    words per 32 scan positions (with novel splicing two 2-bit compares of
    a 64-bit window and the even-bit compaction, ~64 operations a word;
    without it only the known word, ~8), the candidate search (~8 a word
    and slot), 32 scored slots (~80 each: two windows, 8 table reads, 8
    float operations; ~20 without novel splicing, where every side is
    known and scores 1.0) and 128 grid cells (~20 each)."""
    d = [torch.gather(top_d, 1, t) for t in (ti, tm, tj)]
    active = int(((d[0] >= 64) & (d[1] >= 64) & (d[2] >= 64)).sum())
    words = (L + 32) // 32
    site, slot = (64, 80) if novel else (8, 20)
    return active * (8 * words * site + 32 * words * 8 + 32 * slot
                     + 128 * 20)


def _doublesplice_cost(torch, dargs):
    """K7's cost function on dargs = (genome, top_d, pref, ti, tm, tj,
    tvalid, lengths, budget, L[, novel, known]): (bytes, operations).
    Bytes: the triples, lengths and budgets read once and the outputs
    written, and of the candidate rows only those the triples name
    (_segment_bytes).  Operations: _doublesplice_ops."""
    top_d, ti, tm, tj, L = dargs[1], dargs[3], dargs[4], dargs[5], dargs[9]
    novel = dargs[10] if len(dargs) > 10 else True
    known = dargs[11] if len(dargs) > 11 else None
    rows = _segment_bytes(torch, top_d, [ti, tm, tj], L, novel, known)
    return lambda out: (_nbytes(dargs[3:9], out) + rows,
                        _doublesplice_ops(torch, top_d, ti, tm, tj, L,
                                          novel))


_T0 = time.time()  # the script's start, for _clock


def _clock(since: float | None = None) -> str:
    """The wall clock since the script started, and since ``since``."""
    now = time.time()
    return (f"[{now - _T0:.1f} s" + (f", +{now - since:.1f} s"
                                      if since is not None else "") + "]")


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


def _cuda_profile(fn, reps: int, tries: int, whole: bool) -> tuple:
    """(device ms, device ops) per call of fn: the summed time and the
    number of the CUDA kernels, copies and fills it ran, from
    torch.profiler tracing CUDA activity alone over ``reps`` calls after
    a warm-up call; (None, None) when ``tries`` profiles recorded none.

    A profile now and then holds no device activity at all (its raw
    trace is empty, not only its summary), most often late in a long
    run and with the host's activity traced too, and now and then loses
    some of it: such a profile is taken again, and with ``whole`` also
    one whose op count is no multiple of ``reps`` (every call runs the
    same ops), the last one's figures standing if none is whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    last = (None, None)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n > 0:
            us = sum(e.self_device_time_total for e in events)
            last = (us / 1e3 / reps, n / reps)
            if not whole or n % reps == 0:
                break
    return last


def _device_ms(fn, reps: int = 5, tries: int = 4) -> float | None:
    """Mean device time per call of fn (_cuda_profile, from a profile
    that recorded every call's ops where one of ``tries`` did: one that
    lost some reads low)."""
    return _cuda_profile(fn, reps, tries, whole=True)[0]


def _device_ops(fn, reps: int = 5, tries: int = 8) -> float | None:
    """The number of CUDA device ops per call of fn (_cuda_profile), from
    a profile that recorded every call's ops; None when none of ``tries``
    did (each recorded none, or lost some: a count that is no whole
    number a call)."""
    ops = _cuda_profile(fn, reps, tries, whole=True)[1]
    return ops if ops is not None and float(ops).is_integer() else None


def _timed(*fns, reps: int = 5) -> tuple:
    """(times, clock, call times): each fn's device time from the
    profiler, or, when any fn's profile recorded none, each fn's time
    between CUDA events for all of them, so that the times compared are
    on one clock ("profiler" or "events"); and each fn's time between
    CUDA events (device time plus the host's launch gaps)."""
    dev = [_device_ms(fn, reps) for fn in fns]
    calls = [_call_ms(fn, reps) for fn in fns]
    if any(ms is None for ms in dev):
        return calls, "events", calls
    return dev, "profiler", calls


_STARTED: list = []  # every tool process started, stopped at exit


def _start_tool(name: str, *args, env=None, out=None) -> subprocess.Popen:
    """Start ``python -m gmap_gsnap_tpu_torch.cli.<name> args`` from the
    checkout's root; its standard output to the file ``out`` if given
    (a tool that runs unread in the background must not fill a pipe)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"gmap_gsnap_tpu_torch.cli.{name}",
         *map(str, args)], cwd=REPO,
        stdout=subprocess.PIPE if out is None else open(out, "w"),
        stderr=subprocess.PIPE, text=True, env=env)
    _STARTED.append(proc)
    return proc


def _stop_tools() -> None:
    """Kill the tool processes still running (a phase failed while they
    ran beside it)."""
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish_tool(proc: subprocess.Popen, name: str) -> tuple:
    """(stdout, stderr) of a started tool; raises when it failed."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"{name} exited {proc.returncode}:\n{err[-4000:]}")
    return out, err


def _tool(name: str, *args, env=None) -> tuple:
    return _finish_tool(_start_tool(name, *args, env=env), name)


def _gmap_cli_runs(spec_file: str) -> None:
    """Path 9's shim, run in a process of its own (``python -c "import
    chip_smoke; chip_smoke._gmap_cli_runs(spec)"`` from the checkout's
    root): the port's gmap CLI module as __main__ (python -m) once per
    entry of the JSON spec's "runs", with that entry's arguments and its
    standard output written to that entry's file.  The runs share one
    GenomeDB.open (and so its device index).  Writes to the spec's
    "result" file each run's exit code, wall seconds, kernel launches,
    the (Q, H, S, most hits in a row) of its K9 calls, and for the entry
    marked "profile" the
    CUDA events of a torch.profiler trace of the run; and the peak device
    memory of all runs."""
    import contextlib
    import runpy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gmap_gsnap_tpu_torch.align import gmap_engine as eng
    from gmap_gsnap_tpu_torch.db import datadir
    from gmap_gsnap_tpu_torch.kernels import build as kbuild

    with open(spec_file) as f:
        spec = json.load(f)
    real_open, opened = datadir.GenomeDB.open, {}

    def open_once(*a, **kw):
        key = json.dumps([a, kw], default=str)
        if key not in opened:
            opened[key] = real_open(*a, **kw)
        return opened[key]

    k9, seen = eng._seed_segments_cuda, set()

    def k9_seen(offsets, positions, oligos, valid, k, H, S, threshold):
        out = k9(offsets, positions, oligos, valid, k, H, S, threshold)
        seen.add((int(oligos.shape[1]), int(H), int(S),
                  int(out["nhits"].max())))
        return out

    datadir.GenomeDB.open = open_once
    eng._seed_segments_cuda = k9_seen
    torch.cuda.reset_peak_memory_stats()
    results = []
    for run in spec["runs"]:
        before = dict(kbuild.LAUNCHES)
        seen.clear()
        sys.argv = ["gmap", *run["args"]]
        prof = (profile(activities=[ProfilerActivity.CUDA])
                if run.get("profile") else contextlib.nullcontext())
        with open(run["out"], "w") as f, contextlib.redirect_stdout(f), \
                prof as trace:
            t0 = time.time()
            try:
                runpy.run_module("gmap_gsnap_tpu_torch.cli.gmap",
                                 run_name="__main__", alter_sys=True)
                rc = 0
            except SystemExit as e:
                rc = e.code
            torch.cuda.synchronize()
            wall = time.time() - t0
        results.append(dict(
            rc=rc, wall=wall, k9=sorted(seen),
            launches={k: n - before.get(k, 0) for k, n in
                      kbuild.LAUNCHES.items() if n > before.get(k, 0)},
            events=None if trace is None else [
                [e.key, e.count, e.self_device_time_total]
                for e in trace.key_averages()
                if e.device_type == DeviceType.CUDA]))
    with open(spec["result"], "w") as f:
        json.dump(dict(runs=results, peak=torch.cuda.max_memory_allocated()),
                  f)


def _scaleout_rank(spec_file: str) -> None:
    """Path 11's rank, one process of a world of two (``python -c "import
    chip_smoke; chip_smoke._scaleout_rank(spec)"`` from the checkout's
    root, with RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and
    MASTER_ADDR / MASTER_PORT set as torchrun sets them).  It joins the
    group (parallel/shard.init_from_env: a card a rank and nccl where the
    host has two, else both ranks on cuda:0 and gloo), opens the JSON
    spec's database directory, runs the PE -N 1 runner over both ranks on
    the spec's pairs (a warm-up chunk, then the timed run with the launch
    counts set to 0 just before it; rank 0 writes the SAM), seeds the
    spec's reads against its own shard of the positions with the
    all-reduce MIN, against the whole index too, and times the all-reduce
    MIN alone on that [B, W] int64 diag.  Writes its figures to the spec's
    "result" file with the rank's number appended."""
    import torch
    import torch.distributed as dist

    from gmap_gsnap_tpu_torch.align import gsnap_se as se
    from gmap_gsnap_tpu_torch.align import runner as runner_mod
    from gmap_gsnap_tpu_torch.db import datadir
    from gmap_gsnap_tpu_torch.io import fasta
    from gmap_gsnap_tpu_torch.kernels import build as kbuild
    from gmap_gsnap_tpu_torch.parallel import shard

    with open(spec_file) as f:
        spec = json.load(f)
    t0 = time.time()
    dev = shard.init_from_env("cuda", share_card=True)
    rank, size = dist.get_rank(), dist.get_world_size()
    kbuild.library()
    db = datadir.GenomeDB.open(spec["dbdir"], spec["db"])
    runner = runner_mod.GsnapRunner(db, lmax=100, novelsplicing=True,
                                    device=dev)
    r1 = list(fasta.read_seqfile(spec["pairs"][0]))
    r2 = list(fasta.read_seqfile(spec["pairs"][1]))
    batch = spec["batch"]
    runner.run_pe(r1[:batch], r2[:batch], io.StringIO(), batch_size=batch)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    dist.barrier()
    kbuild.LAUNCHES.clear()
    out = io.StringIO()
    t1 = time.time()
    n = runner.run_pe(r1, r2, out, batch_size=batch)
    torch.cuda.synchronize()
    dist.barrier()
    wall_s = time.time() - t1
    launches = dict(kbuild.LAUNCHES)
    if rank == 0:
        with open(spec["sam"], "w") as f:
            f.write(out.getvalue())
    # the sharded index across the ranks: a shard a rank, K1 with its
    # bounds, the all-reduce MIN; against the whole index on this rank
    c, fl, ln = (torch.from_numpy(x).to(dev) for x in runner_mod.encode_batch(
        r1[:batch], 100))
    params = runner.params
    sh = shard.ShardedIndexArrays.from_index(runner.index, size,
                                             group=dist.group.WORLD)
    want = se.seed_diagonals(runner.index, c, fl, ln, params, True)
    kbuild.LAUNCHES.clear()
    got = se.seed_diagonals(sh, c, fl, ln, params, True)
    torch.cuda.synchronize()
    seed_launches = dict(kbuild.LAUNCHES)
    seed_equal = all(torch.equal(a, b) for a, b in zip(want, got))
    diag = want[0].clone()
    shard.all_reduce_min(diag)
    torch.cuda.synchronize()
    reps = 10
    t2 = time.time()
    for _ in range(reps):
        shard.all_reduce_min(diag)
    torch.cuda.synchronize()
    allreduce_ms = (time.time() - t2) / reps * 1e3
    with open(f"{spec['result']}{rank}", "w") as f:
        json.dump(dict(rank=rank, size=size, device=str(dev),
                       backend=dist.get_backend(), n=n, setup_s=setup_s,
                       wall_s=wall_s, launches=launches,
                       seed_launches=seed_launches, seed_equal=seed_equal,
                       diag_shape=list(diag.shape),
                       allreduce_equal=bool(torch.equal(diag, want[0])),
                       allreduce_ms=allreduce_ms,
                       peak=torch.cuda.max_memory_allocated(dev)), f)
    dist.destroy_process_group()


def _sam_records(sam_text: str) -> dict:
    """SAM body lines as {qname: [fields of each line, in order]}."""
    out: dict = {}
    for line in sam_text.splitlines():
        if line and not line.startswith("@"):
            f = line.split("\t")
            out.setdefault(f[0], []).append(f)
    return out


def _ref_span(f, starts) -> tuple:
    """A SAM line's universal [start, end) and its introns [(start, end)],
    read from POS and the CIGAR's reference-consuming operations."""
    p = start = int(starts[f[2]]) + int(f[3]) - 1
    introns = []
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5]):
        if op in "MD=X":
            p += int(n)
        elif op == "N":
            introns.append((p, p + int(n)))
            p += int(n)
    return start, p, introns


def _intron_shift_equal(ascii_g, planted, got) -> bool:
    """``got`` is the planted intron or the same intron shifted along the
    genome by bases that leave the spliced sequence as it is (the bases
    it moves from one end of the intron equal those it takes in at the
    other): an ambiguous junction placed elsewhere, not an error."""
    (s, e), (s2, e2) = planted, got
    d = s2 - s
    if e2 - s2 != e - s:
        return False
    if d >= 0:
        return bytes(ascii_g[s:s + d]) == bytes(ascii_g[e:e + d])
    return bytes(ascii_g[s + d:s]) == bytes(ascii_g[e + d:e])


# the canonical intron ends (GT-AG, GC-AG, AT-AC) on either strand
_CANONICAL_INTRONS = {"GT..AG", "GC..AG", "AT..AC", "CT..AC", "CT..GC",
                      "GT..AT"}


def _intron_canonical_near(ascii_g, planted, got, reach: int = 10) -> bool:
    """``got`` has canonical ends, each within ``reach`` bases of the
    planted intron's: GMAP moves a non-canonical junction to a canonical
    one close by and takes the mismatches that costs."""
    (s, e), (s2, e2) = planted, got
    ends = (bytes(ascii_g[s2:s2 + 2]) + b".." + bytes(ascii_g[e2 - 2:e2]))
    return (abs(s2 - s) <= reach and abs(e2 - e) <= reach
            and ends.decode() in _CANONICAL_INTRONS)


def _gmap_bars(sam_text: str, genome, truths, bench_truths, chimeras,
               long_truths, dups) -> dict:
    """Path 9's planted truths against the card's samse output: the
    counts (good, of) of best paths on the planted chromosome and strand
    over the planted span (ends within 20 nt), of planted introns
    reported exactly (and, for the bench-shaped queries, exactly or at a
    shift that leaves the spliced sequence as it is, and those or moved
    to a canonical intron close by), of chimeras
    reported as two parts on their planted chromosomes, of long queries
    placed, and of duplicated-segment queries reported with both exact
    copies (NH 2)."""
    recs = _sam_records(sam_text)
    starts = dict(zip(genome.names,
                      np.concatenate([[0], genome.chr_ends[:-1]])))

    def placed(name, t):
        f = recs.get(name, [None])[0]
        if f is None or f[2] != t.chrom or bool(int(f[1]) & 16) == t.plusp:
            return None
        start, end, introns = _ref_span(f, starts)
        ok = (abs(start - t.exons[0][0]) <= 20
              and abs(end - t.exons[-1][1]) <= 20)
        return introns if ok else None

    got = {k: [0, 0] for k in ("placed", "introns", "bench_placed",
                               "bench_exact", "bench_introns",
                               "bench_canonical", "chimeras",
                               "long", "dups")}
    for i, t in enumerate(truths):
        introns = placed(f"c{i}", t)
        got["placed"][0] += introns is not None
        got["introns"][0] += sum(iv in (introns or ()) for iv in t.introns)
        got["placed"][1] += 1
        got["introns"][1] += len(t.introns)
    for i, t in enumerate(bench_truths):
        introns = placed(f"b{i}", t)
        got["bench_placed"][0] += introns is not None
        introns = introns or ()
        got["bench_exact"][0] += sum(iv in introns for iv in t.introns)
        same = [any(_intron_shift_equal(genome.ascii, iv, j)
                    for j in introns) for iv in t.introns]
        got["bench_introns"][0] += sum(same)
        got["bench_canonical"][0] += sum(
            ok or any(_intron_canonical_near(genome.ascii, iv, j)
                      for j in introns) for ok, iv in zip(same, t.introns))
        got["bench_placed"][1] += 1
        for key in ("bench_exact", "bench_introns", "bench_canonical"):
            got[key][1] += len(t.introns)
    for i, t in enumerate(chimeras):
        fs = recs.get(f"x{i}", [])
        got["chimeras"][0] += (len(fs) == 2 and all("XT:Z:" in "\t".join(f)
                                                     for f in fs)
                               and [f[2] for f in fs]
                               == [p.chrom for p in t.parts])
        got["chimeras"][1] += 1
    for i, t in enumerate(long_truths):
        got["long"][0] += placed(f"long{i}", t) is not None
        got["long"][1] += 1
    for i in range(dups):
        got["dups"][0] += any("NH:i:2" in f for f in recs.get(f"dup{i}",
                                                              [[]])[0])
        got["dups"][1] += 1
    return {k: tuple(v) for k, v in got.items()}


# python -c program: ``<launches.json> <module> <args>`` runs the port's
# CLI module gmap_gsnap_tpu_torch.cli.<module> as __main__ and, at the
# process's exit, writes the kernel launches it counted
# (kernels.build.LAUNCHES) and its peak device memory to launches.json
_CLI_COUNTING = (
    "import atexit, json, runpy, sys\n"
    "import torch\n"
    "from gmap_gsnap_tpu_torch.kernels import build\n"
    "out, mod = sys.argv.pop(1), sys.argv.pop(1)\n"
    "atexit.register(lambda: json.dump(dict(\n"
    "    launches=dict(build.LAUNCHES),\n"
    "    peak=torch.cuda.max_memory_allocated()\n"
    "    if torch.cuda.is_initialized() else 0), open(out, 'w')))\n"
    "runpy.run_module('gmap_gsnap_tpu_torch.cli.' + mod, run_name='__main__',"
    " alter_sys=True)\n")


def _cli_counting(lfile: str, module: str, *args) -> tuple:
    """(stdout, stderr) of the port's CLI ``module`` run with args; the
    kernels it launched and its peak device memory are written to lfile
    as JSON."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _CLI_COUNTING, lfile, module,
         *map(str, args)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _STARTED.append(proc)
    return _finish_tool(proc, module)


def _split_outputs(root: str) -> dict:
    """{suffix: text} of the files a --split-output ``root`` wrote."""
    head, base = os.path.split(root)
    return {f[len(base) + 1:]: open(os.path.join(head, f)).read()
            for f in sorted(os.listdir(head)) if f.startswith(base + ".")}


def _multimapped_pairs(sam_text: str) -> tuple:
    """(pairs whose read 1 lines carry NH > 1, their NH summed)."""
    nhs = {}
    for line in sam_text.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        if not int(f[1]) & 0x40:
            continue
        nh = [x for x in f[11:] if x.startswith("NH:i:")]
        if nh and int(nh[0][5:]) > 1:
            nhs[f[0]] = int(nh[0][5:])
    return len(nhs), sum(nhs.values())


def _rate_line(stderr: str) -> str:
    """The gsnap CLI's own rate line ("Processed N queries in ...")."""
    lines = [l for l in stderr.splitlines() if l.startswith("Processed")]
    return lines[-1] if lines else "(no rate line)"


def _packed(fn, *a) -> tuple:
    """pack_batch's four outputs as a flat tuple of tensors."""
    fwd, crc, frc, rev = fn(*a)
    return (fwd.codes16, fwd.nflags16, crc, frc, rev.codes16, rev.nflags16)


def _mixed_lengths(torch, c, f, ln):
    """A copy of a read batch with the edge lengths 1, 15, 16, 17 and L
    in its first rows, random shorter reads in every seventh, and N runs
    in every ninth (the codes past each length stay as they are)."""
    c, f, ln = c.clone(), f.clone(), ln.clone()
    L = c.shape[1]
    edges = torch.tensor([1, 15, 16, 17, L], dtype=ln.dtype, device=ln.device)
    ln[:5] = edges
    ln[5::7] = (L - torch.arange(ln[5::7].shape[0], device=ln.device) % 60
                ).to(ln.dtype)
    f[::9, L // 3 : L // 3 + 12] = True
    return c, f, ln


def _grid_gate(pe, cuda: bool, gargs, c5, c3, ipm: int, novel: bool,
               gate: bool = True) -> tuple:
    """K8 with its overflow-gate epilogue (cuda) or the plain grid and
    the plain gate: the grid's fields and both ends' overflow flags, from
    ONE K8 call.  Without ``gate`` (known sites) the flags stay."""
    d5, d3 = dict(c5), dict(c3)
    g = (d5, d3, ipm, novel) if gate else None
    if cuda:
        grid = pe._pair_grid_cuda(*gargs, g)
    else:
        grid = pe._pair_grid_plain(*gargs)
        if gate:
            d5["overflow"], d3["overflow"] = pe._pair_gate_plain(
                grid, gargs[0], gargs[1], d5, d3, gargs[6], ipm, novel)
    return (tuple(grid[k] for k in pe.PAIR_GRID_KEYS)
            + (d5["overflow"], d3["overflow"]))


def _grid_reads(pe, gargs, ends=None) -> int:
    """Bytes K8 reads, at the dtypes its wrapper passes: each end's
    ranked hits' pe._HIT_FIELDS (45 B a hit; rank_hits' other fields are
    not read), the lengths, chr_offsets and, with the gate epilogue, each
    end's overflow flags and what decides them (10 B a row)."""
    h5, h3, len5, len3, offs = gargs[:5]
    n = sum(h[f].numel() * dt.itemsize for h in (h5, h3)
            for f, dt in pe._HIT_FIELDS)
    n += 4 * (len5.numel() + len3.numel()) + 8 * offs.numel()
    return n + (0 if ends is None else
                sum(10 * c["overflow"].numel() for c in ends))


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
    import torch

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
    seg, ch = captured["seed_segments"], captured["chain"]
    print(f"GMAP lane inputs of one {label} batch: oligos "
          f"{tuple(seg[2].shape)}, K9 rows {seg[2].shape[0]} H {seg[5]} S "
          f"{seg[6]}, K10 rows {ch[0].shape[0]} S {ch[0].shape[1]} largest "
          f"lv {int(_chain_lv(torch, ch[3]).max())}, max_intronlen "
          f"{ch[5]}, junction dynprog "
          f"{'ran' if 'banded_matrices' in captured else 'did not run'}",
          flush=True)
    return captured


def _segment_edge_checks(torch, eng, synth, rng, dev, costs) -> list:
    """K9 checks on synth.seed_segment_cases (counts 0, 1, threshold and
    one above; no valid k-mer; nhits = H and H + 1; nsegs = S and S + 1;
    MIN_SEGLEN and a base shorter; query gaps 2k and 2k + 1; wrapping
    diagonals; Q 1, 33, 128; k 12 and 15; rows of 2,048 and 2,049 hits,
    either side of the register / scratch edge) at the case's H and S and
    at H / 4, S / 2; K10 checks on synth.chain_cases (lv 0, 31, 32, 33, S
    - 1, ties, no valid segment; S 48, 64 and 1,100: past 1,024 segments
    a row is read in place), both intron limits, C 192 and 1."""
    checks = []
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for Q, k, thr, H, S, nh in synth.SEED_SEGMENT_CASES:
        case = synth.seed_segment_cases(rng, Q, k, thr, H, S, nh)
        a = tuple(t(case[x]) for x in ("offsets", "positions", "oligos",
                                       "valid"))
        for h, s_ in ((H, S), (max(H // 4, 1), max(S // 2, 1))):
            sargs = (*a, k, h, s_, thr)
            checks.append(("seed_segments/edges",
                           f"Q={Q} k={k} H={h} S={s_} {len(case['kinds'])} "
                           f"rows",
                           partial(_fields, eng._seed_segments_cuda, sargs,
                                   eng.SEG_KEYS),
                           partial(_fields, eng._seed_segments_plain, sargs,
                                   eng.SEG_KEYS)))
            costs.setdefault("seed_segments/edges",
                             _segment_cost(torch, sargs))
    for S, lvs in synth.CHAIN_CASE_SHAPES:
        case = synth.chain_cases(rng, 64, S, lvs)
        a = tuple(t(case[x]) for x in ("qstart", "qend", "diag", "valid"))
        for il, C in ((30, 192), (200_000, 192), (200_000, 1)):
            cargs = (*a, 12, il, C)
            checks.append(("chain/edges", f"S={S} il={il} C={C} 64 rows",
                           partial(_fields, eng._chain_cuda, cargs,
                                   eng.CHAIN_KEYS),
                           partial(_fields, eng._chain_plain, cargs,
                                   eng.CHAIN_KEYS)))
            costs.setdefault("chain/edges", _chain_cost(torch, cargs))
    return checks


def _junction_edge_checks(torch, dp, synth, rng, dev, costs) -> list:
    """K12 checks on synth.junction_traceback_cases: ties under both jump
    rules, walks off the band past k = 0 and past k = W - 1, len1 2 and
    64, offsets whose difference wraps int32, W 23 and 32 (dynamic shared
    memory past 48 KB), T 138 and 6."""
    checks = []
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for W in (23, 32):
        case = synth.junction_traceback_cases(rng, 128, 64, W, 72)
        mats = tuple(t(case[k]) for k in ("nogap", "gap1", "gap2", "ndiag"))
        for T, cd, halfp, nospl, known, open_, ext in (
                (138, 1, False, False, False, dp.PAIRED_OPEN,
                 dp.PAIRED_EXTEND),
                (138, -1, True, False, True, dp.SINGLE_OPEN,
                 dp.SINGLE_EXTEND),
                (6, 0, False, True, True, dp.PAIRED_OPEN, dp.PAIRED_EXTEND)):
            kn = t(case["known"] * known)
            bargs = (mats, *(t(case[k]) for k in (
                "len1", "len2L", "len2R", "lbandL", "lbandR", "gl", "grv")),
                kn, kn, t(case["loff"]), t(case["roff"]), 64, W, T, open_,
                ext, 30, cd, True, halfp, nospl)
            checks.append(("bridge_traceback/edges",
                           f"W={W} T={T} cdna={cd} 128 junctions",
                           partial(dp._bridge_traceback_cuda, *bargs),
                           partial(dp._bridge_traceback_plain, *bargs)))
            costs.setdefault("bridge_traceback/edges", _bridge_cost(bargs))
    return checks


def _sweep_edge_checks(torch, dp, synth, rng, dev, costs) -> list:
    """K11 checks on synth.band_sweep_cases: W 1, 23 and 32, M 1, 33, 64
    and 100 (a pass of 32 rows cut short, rows past K11's ring of 64),
    lband 0, a band of W cells and one past W, len2 below W and len2 = N,
    codes 4 and 5, jump late and early, both gap tiers."""
    checks = []
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for W, M in ((1, 1), (1, 64), (23, 64), (32, 64), (32, 1), (23, 100),
                 (32, 33)):
        case = synth.band_sweep_cases(rng, 300, M, W)
        for open_, ext in ((dp.PAIRED_OPEN, dp.PAIRED_EXTEND),
                           (dp.SINGLE_OPEN, dp.SINGLE_EXTEND)):
            margs = (*(t(case[k]) for k in ("q", "g", "len1", "len2",
                                            "lband", "rband")),
                     dp.pair_matrix(dp.MISMATCH_HIGHQ), t(case["late"]), M,
                     W, open_, ext)
            checks.append(("banded_gotoh/edges",
                           f"W={W} M={M} open={open_} 300 problems",
                           partial(dp._banded_matrices_cuda, *margs),
                           partial(dp._banded_matrices_plain, *margs)))
            costs.setdefault("banded_gotoh/edges", _gotoh_cost(margs))
    return checks


def _seed_edge_checks(torch, se, synth, rng, dev, costs) -> list:
    """K1 checks on synth.seed_row_cases (k = 4, threshold 5): counts of
    0, the threshold and one above it, N runs, reads shorter than L and
    than k, positions below their query position, repeat reads that
    overflow a 24-slot grid; S 1, 31, 32, 33 and 100 k-mers; interval 1,
    3, 7 and 32; grids of 24 and 100 slots and the exact one; half on and
    off."""
    checks = []
    k, thr = 4, 5
    t = lambda a: torch.from_numpy(a).to(dev)
    for S, q in ((31, 1), (32, 32), (33, 3), (1, 32), (100, 7)):
        case = synth.seed_row_cases(rng, 512, S + k - 1, k, thr)
        idx = se.IndexArrays(t(case["offsets"]), t(case["positions"]), k, q)
        reads = tuple(t(case[x]) for x in ("codes", "nflags", "lengths"))
        for seed_total, half in ((24, True), (100, False), (0, True)):
            p = se.GsnapParams(seed_total=seed_total, size_threshold=thr)
            sargs = (idx, *reads, p, half)
            checks.append(("seed_diagonals/edges",
                           f"S={S} q={q} seed_total={seed_total} half="
                           f"{int(half)} 512 reads",
                           partial(se._seed_diagonals_cuda, *sargs),
                           partial(se._seed_diagonals_plain, *sargs)))
            costs.setdefault("seed_diagonals/edges",
                             _seed_cost(se, *reads, k))
    return checks


def _pair_edge_checks(torch, gg, pe, synth, rng, b: int, params, ipm: int,
                      dev, costs) -> list:
    """K8 checks on synth.pair_grid_edges (1,000 chromosome offsets, rows
    whose every cell is BIG, rows of one pair score) at NP 1, 7 and 16, K
    from 1 to NP^2, with the gate and without."""
    checks = []
    eh, *elens, eoffs = synth.pair_grid_edges(rng, b)
    eh = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                              else v).to(dev) for k, v in eh.items()}
    elens = [torch.from_numpy(x).to(dev) for x in elens]
    ec = {k: torch.from_numpy(v).to(dev)
          for k, v in synth.pair_gate_cases(rng, b).items()}
    ec5, ec3 = ({k: v[sl] for k, v in ec.items()}
                for sl in (slice(0, b), slice(b, None)))
    for np_, K, gate in ((1, 1, True), (7, 1, False), (7, 49, True),
                         (16, 1, True), (16, 100, True), (16, 256, False)):
        ee5, ee3 = (gg.rank_hits({k: v[sl] for k, v in eh.items()}, params,
                                 apply_optimal=False, maxout=np_)
                    for sl in (slice(0, b), slice(b, None)))
        eargs = (ee5, ee3, *elens, torch.from_numpy(eoffs).to(dev), 200_000,
                 params.subopt_levels, K)
        checks.append(("pair_grid/edges",
                       f"NP={np_} K={K} gate={int(gate)} {b} pairs",
                       partial(_grid_gate, pe, True, eargs, ec5, ec3, ipm,
                               True, gate),
                       partial(_grid_gate, pe, False, eargs, ec5, ec3, ipm,
                               True, gate)))
        costs.setdefault("pair_grid/edges", lambda out, a=eargs, c=(ec5, ec3):
                         (_grid_reads(pe, a, c) + _nbytes(out), 0))
    return checks


def _gmap_checks(torch, eng, dp, lanes, rng, dev, costs):
    """K9-K12 checks (name, shape, kernel call, plain call): on the
    inputs each runner's GMAP lane gave each kernel (``lanes``: (label,
    _lane_inputs) pairs, the first sets the costs), K9 also at a forced
    hit/segment overflow and at the retry's sizes, K11/K12 also on 32 and
    128 random junction windows, both gap tiers, every cdna_direction
    table, and K12 on synth.junction_traceback_cases' edges.  Fills
    ``costs`` with each kernel's (bytes, operations)."""
    from gmap_gsnap_tpu_torch.utils import synth

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
                                f"S={ch[0].shape[1]} il={ch[5]} lv<="
                                f"{int(_chain_lv(torch, ch[3]).max())}",
                       partial(_fields, eng._chain_cuda, ch, eng.CHAIN_KEYS),
                       partial(_fields, eng._chain_plain, ch, eng.CHAIN_KEYS)))
        if "banded_matrices" in captured:
            margs = captured["banded_matrices"]
            dynprog(f"{label} {margs[0].shape[0] // 2} junctions", margs,
                    captured["bridge_traceback"])
    costs["seed_segments"] = _segment_cost(torch, lanes[0][1]["seed_segments"])
    costs["chain"] = _chain_cost(torch, lanes[0][1]["chain"])
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
    checks += _segment_edge_checks(torch, eng, synth, rng, dev, costs)
    checks += _junction_edge_checks(torch, dp, synth, rng, dev, costs)
    checks += _sweep_edge_checks(torch, dp, synth, rng, dev, costs)
    first = next(c for c in checks if c[0] == "banded_gotoh")
    costs["banded_gotoh"] = _gotoh_cost(first[2].args)
    fb = next(c for c in checks if c[0] == "bridge_traceback")[2].args
    costs["bridge_traceback"] = _bridge_cost(fb)
    return checks


def _stage_checks(torch, gg, se, mmo, genome_dev, index, index_minus, c, f,
                  ln, gp, label, rank=True):
    """K13-K16 checks (name, shape, kernel call, plain call, cost,
    library call or None) on one
    batch (codes c, flags f, lengths ln of read 1s) under GappedParams
    ``gp``: per strand batch as _strand_hits runs it (both strands
    stacked in standard mode; under a cmet/atoi conversion each strand on
    its own index, with K1 on that index and K3 with that conversion
    checked too), and K14 (with ``rank``) on the batch's candidates:
    the SE ranking with its gates, and the PE pairing call (no optimal
    filter, maxout 16) and maxout above the candidate count, each with
    one stable torch.sort of the batch's packed (score, left, !plusp)
    key as its library call."""
    base = gp.base
    conv_plus, conv_minus = se._MODE_CONV[base.mode]
    crc, frc = se._revcomp_batch_plain(c, f, ln)
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
        q = se._pack_device_plain(cc, ff, ll, 100)
        cconv = se._convert_codes(cc, conv)
        diag, qgrid = se._seed_diagonals_plain(idx, cconv, ff, ll, base,
                                               True)[:2]
        top_d, votes, _ = se._top_diagonals_plain(diag, base.ncand)
        mm, pref = mmo._prefix_mismatches_plain(genome_dev, q, top_d, ll,
                                                conv, None)
        if conv is not None:
            sargs = (idx, cconv, ff, ll, base, True)
            checks += [
                (f"seed_diagonals/{conv} index", shape,
                 partial(se._seed_diagonals_cuda, *sargs),
                 partial(se._seed_diagonals_plain, *sargs),
                 _seed_cost(se, cconv, ff, ll, idx.k), None),
                (f"prefix_mismatches/{conv}", shape,
                 partial(mmo._prefix_mismatches_cuda, genome_dev, q, top_d,
                         ll, conv, None),
                 partial(mmo._prefix_mismatches_plain, genome_dev, q, top_d,
                         ll, conv, None),
                 _prefix_cost(q, top_d, ll, 100, None), None)]
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
             lane_plain, lambda out, a=largs: (_nbytes(a[:2], out), 0),
             None),
            ("qpos_ranges", shape,
             partial(se._qpos_ranges_cuda, diag, qgrid, top_d),
             partial(se._qpos_ranges_plain, diag, qgrid, top_d),
             lambda out, a=(diag, qgrid, top_d): (_nbytes(a, out),
                                                  a[0].numel()), None)]
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
                    _nbytes(t, v, out), 8 * t.numel() * t.shape[1]),
                _pair_sort(torch, se, top_d, votes, fn)))
    if not rank:
        return checks
    out, cands = gg.gather_candidates(genome_dev, index, index_minus, c, f,
                                      ln, gp)
    keys = sorted(out) + ["npaths"]
    shape = f"{label} n={out['score'].shape[1]}"
    key_bytes = _nbytes([out[k] for k in gg._RANK_KEYS])
    b, n = out["score"].shape
    # the library yardstick: one stable sort of the packed key per read
    rkey = ((out["score"].long() << 33) | (out["left"] << 1)
            | (~out["plusp"]).long())
    lib = partial(torch.sort, rkey, dim=1, stable=True)

    def rank_cost(nout, extra=0):
        # the key fields read in full; of every other field the nout
        # ranked entries read; every field's nout entries and npaths
        # written
        ranked = sum(v.element_size() for v in out.values()) * b * nout
        other = sum(v.element_size() for k, v in out.items()
                    if k not in gg._RANK_KEYS) * b * nout
        return lambda res: (key_bytes + other + ranked + b * 4 + extra,
                            b * n * math.log2(n))

    for suffix, opt, maxout in (("", True, None), ("/pairing", False, 16),
                                ("/maxout>ncand", True, n + 9)):
        nout = min(base.maxpaths if maxout is None else maxout, n)
        rargs = (out, base, opt, maxout)
        checks.append((
            "rank_hits" + suffix, shape,
            partial(_first, gg._rank_hits_cuda, rargs, keys),
            partial(_fields, gg._rank_hits_plain, rargs, keys),
            rank_cost(nout), lib))
    gargs = (out, cands, ln.int(), index.k, index.interval, gp, True)
    gkeys = sorted(gg._rank_gate_se_plain(*gargs))
    # the epilogue reads each candidate's lane features and the row's
    # overflow inputs, and writes two flags a candidate and two a row
    nc2 = cands["cand_nmm"].shape[1]
    se_bytes = _nbytes([cands[k] for k in (
        "cand_nmm", *gg._LANE_FEATURE_KEYS, "overflow", "overflow_trunc",
        "ovf_bound", "hbound")], ln) + 2 * b * nc2 + 2 * b
    checks.append((
        "rank_hits/se gates", shape,
        partial(_fields, gg._rank_gate_se_cuda, gargs, gkeys),
        partial(_fields, gg._rank_gate_se_plain, gargs, gkeys),
        rank_cost(min(base.maxpaths, n), se_bytes), lib))
    return checks


def _stage_edges(torch, gg, se, synth, rng, dev, base):
    """K2, K3, K4, K5, K7 and K13-K16 checks (name, shape, kernel call,
    plain call, cost, library call or None) on hand-built edges:
    synth.mismatch_edge_rows at L 75, 100 and 150 (untrimmed ends tying
    the trims, equal maxima, mismatches only past the read, all / no
    mismatches, a trim score beyond the read; K13), exact duplicate
    candidates and equal (score, left) on both strands with maxout above
    the candidate count, and synth.rank_hit_edges' rows (K14), INVALID
    diagonals and seed slots and synth.qpos_range_cases at W 1 to 4096
    (K15), synth.triple_cases at NC 2 to 128 (K6), synth.diag_vote_rows
    at W = 40,000 (K2's path for rows past 32,768 slots), diagonals near
    2^31 and 2^32 under both rules and synth.diag_pair_rows at NC 3 to
    128, maxpairs up to NC^2 (K16), synth.diag_vote_rows at W off a power of two and ncand
    equal to W (K2), synth.prefix_mismatch_cases (K3) and
    synth.indel_pair_cases (K4) at L 75, 100, 150 and 1024, and
    synth.splice_pair_cases (K5) and synth.doublesplice_cases (K7) at NC
    32 and 128, with and without known sites and novel splicing."""
    from gmap_gsnap_tpu_torch import convert
    from gmap_gsnap_tpu_torch.ops import mismatch as mmo

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lf_keys = ("cand_mm",) + gg._LANE_FEATURE_KEYS
    checks = []

    def lane_plain(mm, pref, ln, k, score):
        out = {"cand_mm": gg._bitpack_mask(mm),
               **gg._lane_features_plain(mm, pref, ln, k, 3, score)}
        return tuple(out[x] for x in lf_keys)

    # one (k, score) a length: -200 lies beyond the read, where the C
    # entry clamps the score
    for L, k, score in ((75, 12, -3), (100, 15, -1), (150, 12, -200)):
        mm, pref, ln = (t(x) for x in synth.mismatch_edge_rows(rng, 512, 32,
                                                               L))
        a = (mm, ln, k, 3, score)
        checks.append((
            "lane_features/edges", f"L={L} k={k} score {score}",
            partial(_fields, gg._lane_features_cuda, a, lf_keys),
            partial(lane_plain, mm, pref, ln, k, score),
            lambda out, a=a: (_nbytes(a[:2], out), 0), None))
    out = {k: t(v) for k, v in synth.rank_hit_cases(rng, 1024, 144).items()}
    keys = sorted(out) + ["npaths"]
    for opt, maxout in ((True, None), (False, 151)):
        rargs = (out, base, opt, maxout)
        checks.append((
            "rank_hits/edges", f"optimal={opt} maxout={maxout}",
            partial(_first, gg._rank_hits_cuda, rargs, keys),
            partial(_fields, gg._rank_hits_plain, rargs, keys),
            lambda res: (_nbytes(list(out.values()), res), 0), None))
    for edge in synth.RANK_EDGE_KINDS:
        eout = {k: t(v) for k, v in synth.rank_hit_edges(rng, 1024, 144,
                                                         edge).items()}
        rargs = (eout, base, True, None)
        checks.append((
            f"rank_hits/{edge}", "1024 rows n=144",
            partial(_first, gg._rank_hits_cuda, rargs, keys),
            partial(_fields, gg._rank_hits_plain, rargs, keys),
            lambda res, o=eout: (_nbytes(list(o.values()), res), 0), None))
    for w, nc in ((383, 32), (385, 32), (4096, 128), (4096, 4096)):
        d = t(synth.diag_vote_rows(rng, 1024 if w < 512 else 256, w, nc))
        checks.append((
            "top_diagonals/edges", f"W={w} NC={nc} {d.shape[0]} rows",
            partial(se._top_diagonals_cuda, d, nc),
            partial(se._top_diagonals_plain, d, nc),
            lambda out, d=d: (_nbytes(d, out),
                              d.numel() * math.log2(d.shape[1])), None))
    # K2's path for rows past 32,768 slots (the runner's exact seed grid
    # of reads past ~4,100 bases); its own generator
    wd = t(synth.diag_vote_rows(np.random.default_rng(13), 128, 40000, 128))
    checks.append(("top_diagonals/wide rows", "128 rows W=40000 NC=128",
                   partial(se._top_diagonals_cuda, wd, 128),
                   partial(se._top_diagonals_plain, wd, 128),
                   lambda out: (_nbytes(wd, out),
                                wd.numel() * math.log2(wd.shape[1])),
                   partial(torch.sort, wd, dim=1, stable=True)))
    top, votes = (t(x) for x in synth.diag_pair_cases(rng, 1024, 32))
    grid = top.repeat(1, 12)
    qgrid = torch.arange(grid.shape[1], device=dev, dtype=torch.int32
                         ).expand(grid.shape[0], -1).contiguous() // 7
    checks.append(("qpos_ranges/edges", "INVALID and repeated slots",
                   partial(se._qpos_ranges_cuda, grid, qgrid, top),
                   partial(se._qpos_ranges_plain, grid, qgrid, top),
                   lambda out: (_nbytes(grid, qgrid, top, out), grid.numel()),
                   None))
    # K15 on synth.qpos_range_cases (repeated and INVALID selected
    # diagonals, all-INVALID rows, diagonals 0 and 0xFFFFFFFE, qpos not
    # monotone; W off a multiple of 4) and K6 on synth.triple_cases
    # (clusters, wrapping differences, equal and zero votes, all-INVALID
    # rows, sums at the key's width) at maxdist 0, 1 and 2^32 - 1 and T =
    # 1, 8 and 4 NC; their own generator
    qrng = np.random.default_rng(12)
    for w, p in ((1, 1), (33, 32), (384, 32), (385, 1), (4096, 128)):
        a = tuple(t(x) for x in synth.qpos_range_cases(qrng, 1024, w, p))
        checks.append(("qpos_ranges/edges", f"cases W={w} P={p}",
                       partial(se._qpos_ranges_cuda, *a),
                       partial(se._qpos_ranges_plain, *a),
                       lambda out, a=a: (_nbytes(a, out), a[0].numel()),
                       None))
    for nc in (2, 3, 31, 32, 33, 64, 128):
        top3, votes3 = (t(x) for x in synth.triple_cases(qrng, 1024, nc))
        for maxdist, T in ((0, 8), (1, 1), (200_000, 8), (2**32 - 1, 4 * nc)):
            checks.append((
                "select_triples/edges", f"NC={nc} maxdist={maxdist} T={T}",
                partial(gg._select_triples_cuda, top3, votes3, maxdist, T),
                partial(gg._select_triples_plain, top3, votes3, maxdist, T),
                lambda out, a=(top3, votes3, maxdist, T): _triple_cost(*a),
                None))
    rules = (("indel", (0, 30, 9), gg._indel_pairs_eligible(30, 9)),
             ("splice", (1, 200_000, 0), gg._splice_pairs_eligible(200_000)),
             ("splice 2^31+5", (1, 2**31 + 5, 0),
              gg._splice_pairs_eligible(2**31 + 5)))
    for label, kargs, fn in rules:
        checks.append((
            "select_pairs/edges", f"{label} near 2^31 / 2^32",
            partial(gg._select_pairs_cuda, top, votes, 16, *kargs),
            partial(gg._select_pairs_plain, top, votes, fn, 16),
            lambda out: (_nbytes(top, votes, out), 8 * top.numel() * 32),
            _pair_sort(torch, se, top, votes, fn)))
    for nc, npairs in ((3, 16), (24, 16), (32, 16), (32, 1024), (128, 16),
                       (128, 16384)):
        pt, pv = (t(x) for x in synth.diag_pair_rows(rng, 1024, nc))
        for label, kargs, fn in rules[:2]:
            checks.append((
                "select_pairs/edges", f"{label} NC={nc} P={npairs} "
                f"{len(pt)} rows",
                partial(gg._select_pairs_cuda, pt, pv, npairs, *kargs),
                partial(gg._select_pairs_plain, pt, pv, fn, npairs),
                lambda out, pt=pt, pv=pv: (_nbytes(pt, pv, out),
                                           8 * pt.numel() * pt.shape[1]),
                _pair_sort(torch, se, pt, pv, fn)))
    for nc in (32, 128):
        case = synth.splice_pair_cases(rng, 1024, nc)
        codes = case["codes"]
        g = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                     [len(codes)], dev)
        d = {k: t(v) for k, v in case.items() if k != "known"}
        kn = tuple(t(k.view(np.int32)) for k in case["known"])
        for novel, known in ((True, None), (True, kn), (False, kn)):
            sargs = (g, d["top_d"], d["pref"], d["ii"], d["jj"], d["pvalid"],
                     d["lengths"], d["budget"], 100, novel, known)
            checks.append((
                "solve_splices/edges",
                f"NC={nc} novel={int(novel)} known={int(known is not None)}",
                partial(_fields, gg._solve_splices_cuda, sargs,
                        gg._SPLICE_KEYS),
                partial(_fields, gg._solve_splices_plain, sargs,
                        gg._SPLICE_KEYS),
                _splice_cost(torch, sargs), None))
    # K3 on synth.prefix_mismatch_cases: 257 x 24 placements (the last
    # tile cut short), INVALID diagonals and diagonals at and past the
    # genome end, N runs and query Ns, reads of 1, 15, 16 and 17 nt; every
    # conversion with and without an alt genome, and the other N rules
    # (query N mismatches, genome N not) on two of them.  K4 on
    # synth.indel_pair_cases (insertions of every shift, deletions,
    # wrapping differences, rows named by several pairs, a candidate only
    # at s = L, ties, rows without mismatches) at min_end 0, 4 and past
    # half the read, with and without the seed-order gate.  Both at L 75,
    # 100, 150 and the longest read the card takes.  Their own generator,
    # so that the other checks' inputs stay as they were
    krng = np.random.default_rng(11)

    def under_rules(fn, qunk, gunk):
        def call():
            saved = mmo.QUERY_UNK_MISMATCH, mmo.GENOME_UNK_MISMATCH
            mmo.QUERY_UNK_MISMATCH, mmo.GENOME_UNK_MISMATCH = qunk, gunk
            try:
                return fn()
            finally:
                mmo.QUERY_UNK_MISMATCH, mmo.GENOME_UNK_MISMATCH = saved
        return call

    for L in (75, 100, 150, 1024):
        case = synth.prefix_mismatch_cases(krng, 257, 24, L)
        g = convert.genome_from_host(case["gcodes"], case["gflags"],
                                     [len(case["gcodes"])], dev)
        d, ln = t(case["diags"]), t(case["lengths"])
        q = se._pack_device_plain(t(case["codes"]), t(case["nflags"]), ln, L)
        alt = (g.ref16.flip(0).contiguous(), g.flag16)
        variants = [(conv, a, False, True) for conv in (None, "ct", "ga",
                                                        "ag", "tc")
                    for a in (None, alt)]
        variants += [(None, None, True, False), ("ga", alt, True, False)]
        for conv, a, qunk, gunk in variants:
            pargs = (g, q, d, ln, conv, a)
            checks.append((
                "prefix_mismatches/edges",
                f"L={L} {conv} alt={int(a is not None)} "
                f"N rules {int(qunk)}{int(gunk)}",
                under_rules(partial(mmo._prefix_mismatches_cuda, *pargs),
                            qunk, gunk),
                under_rules(partial(mmo._prefix_mismatches_plain, *pargs),
                            qunk, gunk),
                _prefix_cost(q, d, ln, L, a), None))
        case = {k: t(v) for k, v in synth.indel_pair_cases(
            krng, 1024, 32, 16, L).items()}
        for min_end in (0, 4, L // 2 + 1):
            for gate in (True, False):
                kargs = (case["top_d"], case["mm"], case["pref"], case["ii"],
                         case["jj"], case["pvalid"], case["lengths"],
                         case["budget"], L,
                         case["qp5"] if gate else None,
                         case["qp3"] if gate else None, 9, 30, min_end)
                checks.append((
                    "solve_indels/edges",
                    f"L={L} min_end={min_end} gate={int(gate)}",
                    partial(_fields, gg._solve_indels_cuda, kargs,
                            gg._INDEL_KEYS),
                    partial(_fields, gg._solve_indels_plain, kargs,
                            gg._INDEL_KEYS),
                    _indel_cost(torch, kargs), None))
    for nc in (32, 128):
        case = synth.doublesplice_cases(rng, 1024, nc)
        codes = case["codes"]
        g = convert.genome_from_host(codes, np.zeros(len(codes), np.uint8),
                                     [len(codes)], dev)
        d = {k: t(v) for k, v in case.items() if k != "known"}
        kn = tuple(t(k.view(np.int32)) for k in case["known"])
        for novel, known in ((True, None), (True, kn), (False, kn)):
            dargs = (g, d["top_d"], d["pref"], d["ti"], d["tm"], d["tj"],
                     d["tvalid"], d["lengths"], d["budget"], 100, novel,
                     known)
            checks.append((
                "solve_doublesplices/edges",
                f"NC={nc} novel={int(novel)} known={int(known is not None)}",
                partial(_fields, gg._solve_doublesplices_cuda, dargs,
                        gg._SHORTEXON_KEYS),
                partial(_fields, gg._solve_doublesplices_plain, dargs,
                        gg._SHORTEXON_KEYS),
                _doublesplice_cost(torch, dargs), None))
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
    """One main path: a warm-up run, the device cascade alone (the median
    of CASCADE_PASSES passes over the records), then the timed run with
    every kernel's launch count set to 0 just before it and read just
    after.  ``pairs`` (the read-2 records) makes it a PE
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
    # the cascade's host wall is a few ms a batch and moves with the
    # host's load: the median of CASCADE_PASSES passes, with their range
    passes = []
    for _ in range(CASCADE_PASSES):
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(0, len(records), batch):
            dispatch(i)
        torch.cuda.synchronize()
        passes.append(time.time() - t0)
    passes.sort()
    cascade_s = passes[len(passes) // 2]
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
          f"{n / cascade_s:.1f} {unit}/s ({cascade_s:.3f} s, the median of "
          f"{len(passes)} passes of {passes[0]:.3f}-{passes[-1]:.3f} s); "
          f"end to end "
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
                ambi_resolved=runner.ambi_resolved, e2e_s=e2e_s)


def _profile_run(torch, run, label: str) -> None:
    """torch.profiler over one call of run() (a GsnapRunner.run or
    run_pe): device busy share of the wall and the top device ops.  It
    traces the device's activity alone: tracing the host's too made
    every host op an event (and the host slower) for no figure printed
    here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    hand = {}
    for e in ev:
        n = _hand_kernel(e.key)
        if n is not None:
            hand.setdefault(n, []).append(e)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    print(f"{label} profile: every hand kernel (its instantiations summed)",
          flush=True)
    for n in ALL_KERNELS:
        es = hand.get(n, [])
        print(f"  {sum(e.self_device_time_total for e in es) / 1e3:9.3f} ms  "
              f"{sum(e.count for e in es):6d}x  {n}"
              + (f" ({len(es)} instantiations)" if len(es) > 1 else ""))
    total = sum(e.self_device_time_total for es in hand.values() for e in es)
    print(f"{label} profile: hand kernels {total / 1e3:.3f} ms of "
          f"{busy * 1e3:.3f} ms device time", flush=True)


def _hand_kernel(key: str) -> str | None:
    """The entry of ALL_KERNELS whose kernel a profiler event names, or
    None: its key holds the kernel's function name, followed by "(" or,
    for a template (K2, K6, K13-K16), by "<" (``rank_hits_kernel<8,
    1>(...)``); K2's wide path is ``top_diagonals_wide_kernel``."""
    for n in ALL_KERNELS:
        base = n.split("_", 1)[1]
        if re.search(rf"(?<![A-Za-z0-9_]){base}(?:_wide)?_kernel[(<]", key):
            return n
    return None


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
    from gmap_gsnap_tpu_torch.db import datadir, splicesites
    from gmap_gsnap_tpu_torch.io import fasta
    from gmap_gsnap_tpu_torch.db.iit import IIT
    from gmap_gsnap_tpu_torch.kernels import build as kbuild
    from gmap_gsnap_tpu_torch.kernels import limits as klimits
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
          f"{len(kbuild._SIGNATURES)} entry points: eighteen kernels, K2 "
          f"with a second for wide rows, K17 with its empty floor)",
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
    # path 9's duplicated segments are copied into the genome before it
    # is written; its queries come from a generator of their own
    grng = np.random.default_rng(args.seed + 9)
    dup_recs, _, _ = synth.gmap_repeat_queries(grng, genome, GMAP_DUPS)
    t_genome = time.time() - t0
    # 3a. the user's database flow: the genome as FASTA, the port's
    # gmap_build at the large-genome setting (k=15, interval 3, the
    # default basesize 12: Elias-gamma offsets) and GenomeDB.open of the
    # directory it wrote; its arrays must equal the in-memory database of
    # the same genome.  Removed when the process ends, whether or not a
    # phase failed
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    t1 = time.time()
    fasta_path = os.path.join(tmp, "genome.fa")
    genome.write_fasta(fasta_path)
    t_fa = time.time() - t1
    # the in-memory database, which the directory must equal, is built
    # on a thread while gmap_build (a process of its own) runs
    def mem_db():
        t = time.time()
        return synth.genome_db(genome, k=15, interval=3), time.time() - t

    with ThreadPoolExecutor(1) as pool:
        mem_job = pool.submit(mem_db)
        t1 = time.time()
        build = _start_tool("gmap_build", "-d", "syn", "-D", tmp, "-k", 15,
                            "-q", 3, fasta_path)
        # the reads of every path are planted while gmap_build runs
        t0 = time.time()
        # 1% of the DNA reads are messy junctions, for the GMAP lanes
        nmessy = args.reads // 100
        records, truth = synth.plant_reads(
            rng, genome, args.reads - nmessy,
            weights=dict(sub=0.88, n=0.04, mid_indel=0.04, end_indel=0.01,
                         terminal=0.01, repeat=0.01, junk=0.01))
        records += synth.plant_spliced_reads(
            rng, genome, nmessy, weights=dict(messy_junction=1),
            prefix="m")[0]
        # interleaved, so every batch and the CPU subset of step 6 hold some
        records = [records[i] for i in rng.permutation(len(records))]
        rna, rna_truth = synth.plant_spliced_reads(
            rng, genome, args.reads, weights=dict(
                unspliced=0.5, junction=0.3, shortexon=0.1, distant=0.05,
                n_indel=0.05, messy_junction=0.03))
        # 1% of them from repeat copies, which overflow the candidate
        # budget, so the -N 1 path runs its wide lane too
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
        # path 7: bisulfite reads (cmet); path 8: A-to-I edited RNA
        # pairs (atoi)
        bis, bis_truth = synth.plant_bisulfite_reads(rng, genome, args.reads)
        # (--pairs / 4: path 8 runs at ~100 pairs/s, host-bound)
        ep1, ep2, ep_truth, ep_edited = synth.plant_edited_pairs(
            rng, genome, args.pairs // 4)
        t_reads = time.time() - t0
        # path 9's cDNA queries, written as FASTA
        gq, gq_truth = synth.gmap_queries(grng, genome, GMAP_QUERIES,
                                          messy=0.25)
        gx, gx_truth = synth.gmap_chimeras(grng, genome, GMAP_CHIMERAS)
        gl, gl_truth = synth.gmap_long_queries(grng, genome, GMAP_LONG)
        gb, gb_truth = synth.gmap_queries(grng, genome, GMAP_BENCH,
                                          sites=False, prefix="b")
        gmap_fa = os.path.join(tmp, "cdna.fa")
        synth.write_fasta_records(gmap_fa, gq + gb + gx + gl + dup_recs)
        _finish_tool(build, "gmap_build")
        t_build = time.time() - t1
        mem, t_mem = mem_job.result()
    dbdir = os.path.join(tmp, "syn")
    maps = os.path.join(dbdir, "syn.maps")
    t1 = time.time()
    db = datadir.GenomeDB.open(dbdir, "syn")
    _ = db.offsets, db.positions     # read lazily: count them in the open
    t_open = time.time() - t1
    gamma = sorted(f for f in os.listdir(dbdir) if "gammaptrs" in f)
    diff = [f for f in ("codes", "flags", "chr_starts", "chr_ends", "offsets",
                        "positions") if not np.array_equal(getattr(db, f),
                                                           getattr(mem, f))]
    if (diff or db.chr_names != mem.chr_names or (db.k, db.interval,
                                                   db.basesize) != (15, 3, 12)
            or not gamma):
        raise SystemExit(f"the FASTA-built directory differs from the "
                         f"in-memory database: {diff}, {db.chr_names}, k "
                         f"{db.k}, interval {db.interval}, basesize "
                         f"{db.basesize}, gamma files {gamma}")
    del mem
    print(f"database: FASTA write {t_fa:.2f} s ({os.path.getsize(fasta_path)}"
          f" B), gmap_build -k 15 -q 3 {t_build:.2f} s (the reads planted "
          f"beside it; basesize 12, gamma "
          f"offsets: {', '.join(gamma)}; "
          f"{sum(os.path.getsize(os.path.join(dbdir, f)) for f in os.listdir(dbdir) if os.path.isfile(os.path.join(dbdir, f)))}"
          f" B on disk), GenomeDB.open with the offsets decoded and "
          f"positions read {t_open:.2f} s; codes, flags, chromosome bounds "
          f"and names, offsets and positions equal to synth.genome_db "
          f"(built in {t_mem:.2f} s beside gmap_build)", flush=True)
    print(f"setup: {total / 1e6:.1f} Mbp, 4 chromosomes, k=15/3 index "
          f"({len(db.positions)} positions), {len(records)} DNA + {len(rna)} "
          f"RNA reads, {len(p1)} DNA + {len(rp1)} RNA pairs, "
          f"{len(bis)} bisulfite reads ({sum(t.site >= 0 for t in bis_truth)}"
          f" with a read-C / genome-T site), {len(ep1)} RNA pairs "
          f"({int(ep_edited.sum())} A-to-I edited), "
          f"{len(gq) + len(gx) + len(gl) + len(dup_recs)} cDNA queries "
          f"({len(gq)} three-exon, {len(gx)} chimeras, "
          f"{len(gl)} of {min(len(r.seq) for r in gl)}-"
          f"{max(len(r.seq) for r in gl)} nt, {len(dup_recs)} on duplicated "
          f"segments): genome {t_genome:.1f} s, reads {t_reads:.1f} s",
          flush=True)
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
    # the maps from text through the port's iit_store into the
    # database's maps folder, and the SNP index through its snpindex
    # (gamma offsets, as the database's own)
    sites_path = os.path.join(maps, "sites.iit")
    with open(os.path.join(tmp, "sites.txt"), "w") as f:
        f.write(synth.splicesites_text(genome, introns, decoys))
    with open(os.path.join(tmp, "snps.txt"), "w") as f:
        f.write(synth.snps_text(genome, spos, salt))
    # both maps' iit_store side by side
    t0 = time.time()
    stores = [_start_tool("iit_store", "-o", os.path.join(maps, m),
                          os.path.join(tmp, f"{m}.txt"))
              for m in ("sites", "snps")]
    _finish_tool(stores[1], "iit_store")
    t_snps = time.time() - t0
    _finish_tool(stores[0], "iit_store")
    t_sites = time.time() - t0
    t0 = time.time()
    _tool("snpindex", "-D", tmp, "-d", "syn", "-v", "snps",
          os.path.join(maps, "snps.iit"))
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
        snpsdb="snps", device=dev)
    torch.cuda.synchronize()
    t_runner = time.time() - t0
    print(f"setup -s/-v times: iit_store of the splicesites map "
          f"{t_sites:.2f} s ({sites.nsites} sites), iit_store of the SNP map "
          f"{t_snps:.2f} s (side by side), snpindex {t_index:.2f} s "
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
        crc, frc = se._revcomp_batch_plain(c, f, ln)
        return torch.cat([c, crc]), torch.cat([f, frc]), torch.cat([ln, ln])

    c2, f2, l2 = strands(records)
    q2 = se._pack_device_plain(c2, f2, l2, 100)
    budget = se.auto_budget(l2, db.k, db.interval, -1)
    checks = []   # (name, shape, kernel call, plain call), checked now, timed last
    # per kernel, at its first shape: (bytes, operations) of the work from
    # its plain output, and one PyTorch call computing the same function;
    # for PER_SHAPE's kernels both also per (name, shape)
    costs, library, shape_costs = {}, {}, {}
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
        costs.setdefault("seed_diagonals",
                         _seed_cost(se, c2, f2, l2, db.k))
        k2_cost = lambda out, d=diag: (
            _nbytes(d, out), d.numel() * math.log2(d.shape[1]))
        costs.setdefault("top_diagonals", k2_cost)
        shape_costs[("top_diagonals", shape)] = k2_cost
        library[("top_diagonals", shape)] = partial(
            torch.sort, diag, dim=1, stable=True)
        costs.setdefault("prefix_mismatches",
                         _prefix_cost(q2, top_d, l2, 100, None))
        costs.setdefault("solve_indels", _indel_cost(torch, kargs))
        # the conversion and SNP (alt genome) variants of K3
        alt = (genome_dev.ref16.flip(0).contiguous(), genome_dev.flag16)
        for conv, a in (("ct", None), ("ga", alt)):
            checks.append((f"prefix_mismatches/{conv}", shape,
                           partial(mmo._prefix_mismatches_cuda, genome_dev,
                                   q2, top_d, l2, conv, a),
                           partial(mmo._prefix_mismatches_plain, genome_dev,
                                   q2, top_d, l2, conv, a)))
    checks += _seed_edge_checks(torch, se, synth, rng, dev, costs)
    # the splice kernels on the RNA reads (the -N 1 runner's seed budget)
    r2, rf2, rl2 = strands(rna)
    rq2 = se._pack_device_plain(r2, rf2, rl2, 100)
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
        costs.setdefault("solve_splices", _splice_cost(torch, sargs))
        k6_cost = lambda out, t=top_d, v=votes: _triple_cost(t, v, sdist, 8)
        costs.setdefault("select_triples", k6_cost)
        shape_costs[("select_triples", shape)] = k6_cost
        library[("select_triples", shape)] = _triple_sort(torch, se, top_d,
                                                          votes, sdist)
        costs.setdefault("solve_doublesplices",
                         _doublesplice_cost(torch, dargs))
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
    # K8 with its overflow-gate epilogue, first on the PE -N 1 runner's
    # own inputs of that batch (the ends' candidates before the gate, as
    # align_batch_pe makes them), then on hand-built rows where each term
    # of the gate flips (synth.pair_gate_cases, overflow_trunc set on some
    # safe rows, bounds of 2^31 - 2 that wrap the int32 sums) at -N 0 and
    # -N 1, and without the gate (known sites)
    enc5 = runner_mod.encode_batch(rp1[:b], 100)
    enc3 = runner_mod.encode_batch(inv2, 100)
    ggp = runner_n1._gp_uniform(runner_n1.gapped_params, enc5[2], enc3[2])
    out2, cands2 = gg.gather_candidates(
        genome_dev, index, None,
        *(torch.from_numpy(np.concatenate([x, y])).to(dev)
          for x, y in zip(enc5, enc3)), ggp)
    g5, g3 = (gg.rank_hits({k: v[sl] for k, v in out2.items()}, ggp.base,
                           apply_optimal=False, maxout=16)
              for sl in (slice(0, b), slice(b, None)))
    gc5, gc3 = ({k: v[sl] for k, v in cands2.items()}
                for sl in (slice(0, b), slice(b, None)))
    ipm = ggp.base.indel_penalty_middle
    gargs = (g5, g3, *plens, genome_dev.chr_offsets, runner_n1._pairmax(),
             params.subopt_levels, 100)
    checks.append(("pair_grid", f"{b} runner pairs + gate",
                   partial(_grid_gate, pe, True, gargs, gc5, gc3, ipm, True),
                   partial(_grid_gate, pe, False, gargs, gc5, gc3, ipm,
                           True)))
    costs["pair_grid"] = lambda out, a=gargs, c=(gc5, gc3): (
        _grid_reads(pe, a, c) + _nbytes(out), 0)
    library["pair_grid"] = _grid_sort(torch, pe, gargs)
    print(f"K8 gate inputs: runner batch {int(gc5['overflow'].sum())} / "
          f"{int(gc3['overflow'].sum())} ends overflowing before the gate",
          flush=True)
    hc = synth.pair_gate_cases(rng, args.batch)
    hc = {k: torch.from_numpy(v).to(dev) for k, v in hc.items()}
    hc5, hc3 = ({k: v[sl] for k, v in hc.items()}
                for sl in (slice(0, args.batch), slice(args.batch, None)))
    he5 = gg.rank_hits(h5, params, apply_optimal=False, maxout=16)
    he3 = gg.rank_hits(h3, params, apply_optimal=False, maxout=16)
    hargs = (he5, he3, *hlens, genome_dev.chr_offsets, 200_000,
             params.subopt_levels, 100)
    for label, novel, gate in (("novel=0", False, True),
                               ("novel=1", True, True),
                               ("known sites, no gate", True, False)):
        checks.append((f"pair_grid/gate hand-built {label}",
                       f"{args.batch} hand-built pairs",
                       partial(_grid_gate, pe, True, hargs, hc5, hc3, ipm,
                               novel, gate),
                       partial(_grid_gate, pe, False, hargs, hc5, hc3, ipm,
                               novel, gate)))
        costs[f"pair_grid/gate hand-built {label}"] = (
            lambda out, a=hargs, c=(hc5, hc3): (
                _grid_reads(pe, a, c) + _nbytes(out), 0))
        want = _grid_gate(pe, False, hargs, hc5, hc3, ipm, novel, gate)
        print(f"K8 gate hand-built {label}: "
              f"{int(hc5['overflow'].sum() + hc3['overflow'].sum())} "
              f"overflow flags in, {int(want[-2].sum() + want[-1].sum())} "
              f"out ({int((hc5['overflow_trunc'] & hc5['overflow']).sum())}"
              f" read-1 flags truncated)", flush=True)
    checks += _pair_edge_checks(torch, gg, pe, synth, rng, args.batch, params,
                                ipm, dev, costs)
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
            _grid_reads(pe, a) + _nbytes(out), 0))
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
        for name, shape, fk, fp, cost, lib in _stage_checks(
                torch, gg, se, mmo, genome_dev, index, None,
                *batch1(recs, mates), gp, label, rank):
            checks.append((name, shape, fk, fp))
            costs.setdefault(name, cost)
            shape_costs[(name, shape)] = cost
            if lib is not None:
                library[(name, shape)] = lib

    wide = lambda gp: dataclasses.replace(gp, base=dataclasses.replace(
        gp.base, seed_total=4096, ncand=128))
    stage("SE -N 0", records, runner.gapped_params)
    stage("SE -N 0 wide", records, wide(runner.gapped_params))
    stage("SE -N 1", rna, runner_n1.gapped_params)
    stage("SE -N 1 wide", rna, wide(runner_n1.gapped_params))
    stage("PE -N 1", rp1, runner_n1.gapped_params, rp2)
    # K17 on each path's batch (PE: read 1s and inverted read 2s stacked,
    # as align_batch_pe hands them over): as the path gives it (every read
    # 100 nt, so the uniform flip) and in the mixed-length form (lengths
    # 1, 15, 16, 17, 100 and others, N runs)
    for label, recs, mates in (
            ("SE -N 0", records, None), ("SE -N 1", rna, None),
            ("PE -N 0", p1, p2), ("PE -N 1", rp1, rp2),
            ("SE -N 1 -s -v", rna5, None), ("PE -N 1 -s -v", r61, r62),
            ("SE cmet -N 0", bis, None), ("PE atoi -N 1", ep1, ep2)):
        c, f, ln = batch1(recs, mates)
        uni = bool((ln == 100).all())
        for form, (cc, ff, ll), u in (
                ("uniform" if uni else "as given", (c, f, ln), uni),
                ("mixed", _mixed_lengths(torch, c, f, ln), False)):
            name = ("pack_queries" if "pack_queries" not in costs
                    else f"pack_queries/{label} {form}")
            checks.append((name, f"{label} {form} {len(ll)} reads",
                           partial(_packed, se._pack_batch_cuda, cc, ff, ll,
                                   u),
                           partial(_packed, se._pack_batch_plain, cc, ff, ll,
                                   u)))
            costs[name] = lambda out, a=(cc, ff, ll): (_nbytes(a, out), 0)
    # K17 on synth.pack_query_cases (lengths 0-33 and L, all-N reads, N
    # runs, lengths past L; rows off a 4-byte boundary, the card's longest
    # read, B off a CTA's reads, 1 and 0), both uniform forms; their own
    # generators
    for b_, L_ in synth.PACK_QUERY_SHAPES:
        for u in (False, True):
            cc, ff, ll = (torch.from_numpy(x).to(dev) for x in
                          synth.pack_query_cases(np.random.default_rng(
                              b_ + L_), b_, L_, u))
            checks.append(("pack_queries/edges",
                           f"B={b_} L={L_} uniform={int(u)}",
                           partial(_packed, se._pack_batch_cuda, cc, ff, ll,
                                   u),
                           partial(_packed, se._pack_batch_plain, cc, ff, ll,
                                   u)))
            costs.setdefault("pack_queries/edges",
                             lambda out, a=(cc, ff, ll): (_nbytes(a, out), 0))
    for name, shape, fk, fp, cost, lib in _stage_edges(
            torch, gg, se, synth, rng, dev, params):
        checks.append((name, shape, fk, fp))
        costs.setdefault(name, cost)
        shape_costs[(name, shape)] = cost
        if lib is not None:
            library[(name, shape)] = lib
    # SE -N 0's candidates, for counting K14's device ops
    c1, f1, l1 = batch1(records)
    out1, cands1 = gg.gather_candidates(genome_dev, index, None, c1, f1, l1,
                                        runner.gapped_params)

    # the -s / -v inputs: path 5's reads, seeded on the SNP index (K1, K2),
    # verified against the alt genome (K3), spliced with the known-site
    # masks at novel 1 and 0 (K5, K7); then K5/K7 again on dense random
    # masks with diagonals whose start is a multiple of 32, diagonals next
    # to the genome end and INVALID ones
    v2, vf2, vl2 = strands(rna5)
    vq2 = se._pack_device_plain(v2, vf2, vl2, 100)
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
    costs["seed_diagonals/snp index"] = _seed_cost(se, v2, vf2, vl2, db.k)
    costs["top_diagonals/snp index"] = lambda out, d=seed[0]: (
        _nbytes(d, out), d.numel() * math.log2(d.shape[1]))
    shape_costs[("top_diagonals/snp index", shape)] = costs[
        "top_diagonals/snp index"]
    library[("top_diagonals/snp index", shape)] = partial(
        torch.sort, seed[0], dim=1, stable=True)
    costs["prefix_mismatches/alt"] = _prefix_cost(vq2, top_d, vl2, 100, alt)
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
        costs[f"solve_splices/{label}"] = _splice_cost(torch, sargs)
        costs[f"solve_doublesplices/{label}"] = _doublesplice_cost(torch,
                                                                   dargs)
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
    bound_shape = {}  # the shape each name's bound was computed at
    # library call times (first shape), and PER_SHAPE's kernels' rows:
    # every timed shape with its library call and bound
    library_ms, per_shape = {}, {}

    def shape_time(name, shape, fk, fp, lib, bound):
        t0 = time.time()
        ms, clock, calls = _timed(fk, fp, *([lib] if lib else []))
        lib_ms = ms[2] if lib else None
        print(f"kernel {name:20s} {shape:22s}: {clock} time cuda "
              f"{ms[0]:.4f} ms, plain torch {ms[1]:.4f} ms"
              + (f", library {lib_ms:.4f} ms" if lib else "")
              + f", bound {bound[0]:.5f} ms ({bound[1]})"
              + f"; per call (events) {calls[0]:.4f} / {calls[1]:.4f} ms "
              + _clock(t0), flush=True)
        times.setdefault(name, (ms[0], ms[1], clock))
        if lib:
            library_ms.setdefault(name, lib_ms)
        per_shape.setdefault(name.split("/")[0], []).append({
            "check": name, "shape": shape, "ms": ms[0], "plain_ms": ms[1],
            "library_ms": lib_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "clock": clock})
        return clock
    print(f"kernel checks at {time.time() - t_start:.1f} s {_clock()}",
          flush=True)
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
            bound_shape[name] = shape
    torch.cuda.synchronize()

    # 5. the four main paths
    paths, e2e = {}, {}

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
        e2e[label] = out["e2e_s"]
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
    sam = sam_pe_n1 = path("PE -N 1", ALL_KERNELS, rp1, runner_n1, rp2)
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
    # both modes' converted index pairs for paths 7-8, built side by side
    # (each tool is one host process of ~80 s) while the CPU plain paths
    # run, and both done before the CLI runs, whose walls they would load
    before = set(os.listdir(dbdir))
    t_modes = time.time()
    builds = {k: _start_tool(f"{k}index", "-D", tmp, "-d", "syn")
              for k in ("cmet", "atoi")}
    print(f"CPU plain paths at {time.time() - t_start:.1f} s {_clock()}",
          flush=True)
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
    # reads of 513 to 4,096 nt (K3 looping over a row's words, K1 with
    # 4,000 k-mers in dynamic shared memory, K13's wide keys and staging,
    # K5 and K7 with fewer warps a CTA): align_batch_gapped at -N 1 on
    # the card against the CPU plain path, on the genome and index those
    # CPU runners loaded; its own generator
    lrng = np.random.default_rng(args.seed + 1)
    lmax = LONG_LMAX
    long_recs, _ = synth.plant_spliced_reads(lrng, genome, LONG_READS,
                                             L=lmax, prefix="long")
    long_recs = [dataclasses.replace(r, seq=r.seq[:n], quality=r.quality[:n])
                 for r, n in zip(long_recs, lrng.integers(513, lmax + 1,
                                                          LONG_READS))]
    enc = runner_mod.encode_batch(long_recs, lmax)
    t0 = time.time()
    kbuild.LAUNCHES.clear()
    long_out = [gg.align_batch_gapped(
        datadir.device_genome(db, d), datadir.device_index(db, d),
        *(torch.from_numpy(x).to(d) for x in enc), runner_n1.gapped_params)
        for d in (dev, torch.device("cpu"))]
    keys = sorted(long_out[1])
    err = _max_abs_err([long_out[0][k].cpu() for k in keys],
                       [long_out[1][k] for k in keys])
    long_launches = {k: kbuild.LAUNCHES.get(k, 0) for k in
                     N0_KERNELS + SPLICE_KERNELS + STAGE_KERNELS}
    placed = int((long_out[1]["npaths"] > 0).sum())
    print(f"long reads ({LONG_READS} of {int(enc[2].min())}-"
          f"{int(enc[2].max())} nt, lmax {lmax}): align_batch_gapped -N 1 "
          f"on the card vs the CPU plain path max_abs_err={err}, {placed} "
          f"reads with a hit, {time.time() - t0:.1f} s; launches "
          f"{long_launches}", flush=True)
    if err != 0 or 0 in long_launches.values() or placed < LONG_READS // 2:
        raise SystemExit(f"long reads: the card disagrees with the CPU "
                         f"plain path (max_abs_err={err}), a kernel did not "
                         f"launch ({long_launches}) or few reads placed "
                         f"({placed})")
    # K17 alone on the long reads' batch
    lenc = tuple(torch.from_numpy(x).to(dev) for x in enc)
    want17 = _packed(se._pack_batch_plain, *lenc)
    err17 = _max_abs_err(_packed(se._pack_batch_cuda, *lenc), want17)
    errs["pack_queries/long reads"] = err17
    bounds["pack_queries/long reads"] = _bound(_nbytes(lenc, want17), 0)
    print(f"kernel pack_queries/long reads {LONG_READS} reads L={lmax}: "
          f"max_abs_err={err17}", flush=True)
    if err17 != 0:
        raise SystemExit(f"kernel pack_queries disagrees with its plain "
                         f"version on the long reads (max_abs_err={err17})")
    del long_out

    # paths 5 and 6: the subset must launch K5/K7 (with the known masks,
    # which runner_sv always passes) and hold short-end and SNP-heavy reads
    cpu_sv = runner_mod.GsnapRunner(
        db, params, lmax=100, novelsplicing=True, splicesdb=sites_path,
        snpsdb="snps", device="cpu")
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

    # 6b. the user's flow on the card: python -m
    # gmap_gsnap_tpu_torch.cli.gsnap as a subprocess on the directory
    # gmap_build wrote, over the first CLI_READS reads or pairs of a
    # path's set, written as FASTQ; its SAM (header included) must equal
    # what the runner writes for the same reads at the same batch size,
    # and the kernels it launched (written by _CLI_COUNTING) must be its
    # path's
    def write_inputs(tag, recs, mates, n):
        files = [os.path.join(tmp, f"{tag}_1.fq")]
        synth.write_fastq(files[0], recs[:n])
        if mates is not None:
            files.append(os.path.join(tmp, f"{tag}_2.fq"))
            synth.write_fastq(files[1], mates[:n])
        return files

    def cli_run(label, want, recs, run_with, extra, mates=None, optional=()):
        n = min(CLI_READS, len(recs))
        files = write_inputs("cli", recs, mates, n)
        reads = [list(fasta.read_seqfile(f)) for f in files]
        ref = io.StringIO()
        if mates is None:
            run_with.run(reads[0], ref, batch_size=args.batch)
        else:
            run_with.run_pe(reads[0], reads[1], ref, batch_size=args.batch)
        lfile = os.path.join(tmp, "launches.json")
        t0 = time.time()
        out, err = _cli_counting(lfile, "gsnap", "-D", tmp, "-d", "syn",
                                 "--batch-size", args.batch, *extra, *files)
        wall = time.time() - t0
        if out != ref.getvalue():
            a, b = out.splitlines(), ref.getvalue().splitlines()
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            raise SystemExit(f"CLI {label}: SAM differs from the runner's at "
                             f"line {i} of {len(a)} / {len(b)}")
        with open(lfile) as f:
            launches = json.load(f)["launches"]
        os.remove(lfile)
        missing = [k for k in want if launches.get(k, 0) == 0]
        extra_k = [k for k in ALL_KERNELS if k not in want + optional
                   and launches.get(k, 0)]
        if missing or extra_k:
            raise SystemExit(f"CLI {label}: kernels not launched {missing}, "
                             f"launched but not on the path {extra_k}")
        unit = "pairs" if mates is not None else "reads"
        print(f"CLI {label} (gsnap {' '.join(map(str, extra))}): {n} {unit}, "
              f"SAM of {len(out)} B byte-equal to the runner's, header "
              f"included; wall {wall:.2f} s (process start, database open "
              f"and upload included); its rate line: {_rate_line(err)}; "
              f"launches {launches}", flush=True)

    t_write, made_by = {}, {}
    for k, tag in (("cmet", ".met"), ("atoi", ".a2i")):
        _finish_tool(builds[k], f"{k}index")
        t_write[k] = time.time() - t_modes
        made_by[k] = sorted(f for f in set(os.listdir(dbdir)) - before
                            if tag in f)
    print(f"CLI runs at {time.time() - t_start:.1f} s {_clock()}",
          flush=True)
    cli_run("SE -N 0", N0_KERNELS + STAGE_KERNELS + GMAP_KERNELS, records,
            runner, [], optional=DYNPROG_KERNELS)
    cli_run("PE -N 1", ALL_KERNELS, rp1, runner_n1, ["-N", 1], rp2)
    cli_run("SE -N 1 -s -v", N0_KERNELS + SPLICE_KERNELS + STAGE_KERNELS,
            rna5, runner_sv, ["-N", 1, "-s", "sites", "-v", "snps"],
            optional=GMAP_KERNELS + DYNPROG_KERNELS)

    # 6c. GSNAP's native output (-A gsnap) on the card: on NATIVE_READS
    # reads or pairs of paths 1, 4 and 5 (this one with --print-snps),
    # byte-equal to the same CLI with --device cpu.  The CPU runs go on
    # beside the card's (two torch threads each)
    native = []
    for tag, recs, mates, extra in (
            ("SE -N 0", records, None, []),
            ("PE -N 1", rp1, rp2, ["-N", 1]),
            ("SE -N 1 -s -v", rna5, None,
             ["-N", 1, "-s", "sites", "-v", "snps", "--print-snps"])):
        files = write_inputs(f"native{len(native)}", recs, mates,
                             NATIVE_READS)
        cmd = ["-D", tmp, "-d", "syn", "-A", "gsnap", "--batch-size",
               NATIVE_READS, *extra, *files]
        cpu = _start_tool("gsnap", *cmd, "--device", "cpu",
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
        native.append((tag, extra, cmd, cpu, time.time()))
    for tag, extra, cmd, cpu, t_cpu in native:
        t0 = time.time()
        out, err = _tool("gsnap", *cmd)
        wall = time.time() - t0
        ref, _ = _finish_tool(cpu, "gsnap --device cpu")
        if out != ref or not out.startswith((">", "<")):
            raise SystemExit(f"-A gsnap {tag}: the card's output differs "
                             f"from --device cpu")
        print(f"-A gsnap {tag} ({' '.join(map(str, extra))}): "
              f"{len(out)} B byte-equal to --device cpu "
              f"({out.count(chr(10) + '>') + 1} read blocks"
              f"{', with snps: fields' if 'snps:' in out else ''}); card wall "
              f"{wall:.2f} s, {_rate_line(err)}; cpu run finished "
              f"{time.time() - t_cpu:.2f} s after its start", flush=True)

    # paths 7 and 8: the cmet / atoi modes (BASELINE config 5).  Each
    # writes its converted index pair (flat offsets) into the temporary
    # directory, loads it through the runner (--cmetdir / --atoidir),
    # checks K1 on both converted indexes, K3 with each strand's
    # conversion and K13-K16 on the path's own strands, drives the path,
    # compares a CPU subset, then frees the pair and its files before the
    # next mode loads its own
    def mode_path(mode, kind_, label, recs, mates, novel, want, bars,
                  cli_extra=None):
        made = made_by[kind_]
        t0 = time.time()
        mparams = se.GsnapParams(mode=mode, size_threshold=(
            se.dynamic_size_threshold(int(db.offsets[-1]), db.k, mode)))
        mkw = {f"{kind_}_dir": dbdir}
        r = runner_mod.GsnapRunner(db, mparams, lmax=100,
                                   novelsplicing=novel, device=dev, **mkw)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        print(f"setup {label}: {kind_}index (two k={db.k} indexes, gamma "
              f"offsets: {', '.join(made)}) {t_write[kind_]:.2f} s (both "
              f"modes' tools side by side, beside the CPU plain paths), "
              f"runner set-up "
              f"(read, decode and upload of the pair) {t_load:.2f} s, "
              f"{len(r.index.positions)} + {len(r.index_minus.positions)} "
              f"positions", flush=True)
        print(f"resident index bytes: {_resident(db)}", flush=True)
        for name, shape, fk, fp, cost, lib in _stage_checks(
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
            if name == f"rank_hits/{label}" or name.startswith(
                    "select_pairs"):
                shape_time(name, shape, fk, fp, lib, bounds[name])
            elif (name.startswith(("seed_diagonals/", "prefix_mismatches/"))
                    or name == f"lane_features/{label}"):
                (ms, plain_ms), clock, _ = _timed(fk, fp)
                times[name] = (ms, plain_ms, clock)
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
        del cpu_r
        if cli_extra is not None:
            cli_run(label, want, recs, r, cli_extra, mates,
                    optional=GMAP_KERNELS + DYNPROG_KERNELS)
        del r
        datadir.release(db, "converted")
        torch.cuda.empty_cache()
        for f in made:
            os.remove(os.path.join(dbdir, f))

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

    # path 9's references: the gmap CLI with --device cpu on its cDNA
    # queries in each format, started now, so that they run beside paths 7
    # and 8 (two torch threads each)
    gmap_cmd = ["-D", tmp, "-d", "syn", gmap_fa]
    gmap_cpu = {fmt: _start_tool("gmap", *flags, *gmap_cmd, "--device", "cpu",
                                 env={**os.environ, "OMP_NUM_THREADS": "2"},
                                 out=os.path.join(tmp, f"gmap_cpu_{i}"))
                for i, (fmt, flags) in enumerate(GMAP_FORMATS)}
    t_gmap_cpu = time.time()
    mode_path("cmet-stranded", "cmet", "SE cmet -N 0", bis, None, False,
              N0_KERNELS + STAGE_KERNELS, bars7,
              cli_extra=["--mode", "cmet-stranded", "--cmetdir", dbdir])
    mode_path("atoi-stranded", "atoi", "PE atoi -N 1", ep1, ep2, True,
              N0_KERNELS + SPLICE_KERNELS + PAIR_KERNELS + STAGE_KERNELS,
              bars8)

    # 9. the gmap CLI on the card (BASELINE config 1): python -m
    # gmap_gsnap_tpu_torch.cli.gmap on the directory gmap_build wrote, in
    # a process of its own (_gmap_cli_runs) that runs it in each format
    # and counts its kernel launches; each output byte-equal to the CLI's
    # with --device cpu; the planted truths checked on the samse output
    t9 = time.time()
    cpu_left = sum(proc.poll() is None for proc in gmap_cpu.values())
    print(f"path 9 (gmap CLI) at {t9 - t_start:.1f} s {_clock()}; "
          f"{cpu_left} of its {len(gmap_cpu)} --device cpu runs (started "
          f"{t9 - t_gmap_cpu:.1f} s ago) still running", flush=True)
    spec = {"result": os.path.join(tmp, "gmap_runs.json"), "runs": [
        {"args": [*flags, *gmap_cmd], "out": os.path.join(tmp, f"gmap_{i}"),
         "profile": fmt == "-A"}
        for i, (fmt, flags) in enumerate(GMAP_FORMATS)]}
    with open(os.path.join(tmp, "gmap_spec.json"), "w") as f:
        json.dump(spec, f)
    _finish_tool(subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke._gmap_cli_runs(sys.argv[1])",
         os.path.join(tmp, "gmap_spec.json")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "gmap CLI on the card")
    with open(spec["result"]) as f:
        got9 = json.load(f)
    nq9 = len(gq) + len(gb) + len(gx) + len(gl) + len(dup_recs)
    card9 = {}
    for i, ((fmt, flags), run, r9) in enumerate(zip(
            GMAP_FORMATS, spec["runs"], got9["runs"])):
        with open(run["out"]) as f:
            card9[fmt] = f.read()
        _finish_tool(gmap_cpu[fmt], f"gmap {fmt} --device cpu")
        with open(os.path.join(tmp, f"gmap_cpu_{i}")) as f:
            ref = f.read()
        if r9["rc"] != 0 or card9[fmt] != ref or card9[fmt].count("\n") < nq9:
            raise SystemExit(f"gmap CLI {fmt}: the card's output (exit "
                             f"{r9['rc']}, {len(card9[fmt])} B) differs from "
                             f"--device cpu's ({len(ref)} B)")
        want9 = GMAP_KERNELS + DYNPROG_KERNELS
        missing = [k for k in want9 if r9["launches"].get(k, 0) == 0]
        extra_k = [k for k in r9["launches"] if k not in want9]
        if missing or extra_k:
            raise SystemExit(f"gmap CLI {fmt}: kernels not launched "
                             f"{missing}, launched but not on the path "
                             f"{extra_k}")
        note = {"paths": ", the database open and upload included",
                "-A": ", traced by torch.profiler"}.get(fmt, "")
        print(f"gmap CLI {fmt} ({' '.join(flags) or 'default'}): {nq9} "
              f"queries, {len(card9[fmt])} B byte-equal to --device cpu; "
              f"card wall {r9['wall']:.2f} s ({nq9 / r9['wall']:.2f} "
              f"queries/s{note}); launches {r9['launches']}", flush=True)
    print(f"gmap CLI: peak device memory of the card's runs "
          f"{got9['peak']} B ({got9['peak'] / 2**30:.2f} GiB)", flush=True)
    k9calls = {tuple(c) for r9 in got9["runs"] for c in r9["k9"]}
    qs9 = sorted({c[0] for c in k9calls})
    # rows of more hits than K9 sorts in registers take its scratch row
    scratch9 = sorted(c for c in k9calls
                      if c[3] > klimits.seed_segments_register_hits())
    if qs9[-1] != 65_536 or not scratch9:
        raise SystemExit(f"gmap CLI: K9 never ran at Q = 65,536 ({qs9}) or "
                         f"on a row past its register hits")
    paths["gmap CLI"] = dict(got9["runs"][0]["launches"])
    b9 = _gmap_bars(card9["samse"], genome, gq_truth, gb_truth, gx_truth,
                    gl_truth, len(dup_recs))
    print(f"gmap CLI: K9 at Q {qs9}; rows past its register hits in "
          f"{len(scratch9)} calls, (Q, H, S, most hits) {scratch9[-3:]}; "
          f"{b9['long'][0]} of {b9['long'][1]} "
          f"long queries placed over their planted span; "
          f"{b9['dups'][0]} of {b9['dups'][1]} duplicated-segment queries "
          f"with both exact copies (NH:i:2)", flush=True)
    bar("gmap CLI", "planted three-exon queries best on their chromosome "
        "and strand over the planted span", *b9["placed"], 0.99)
    bar("gmap CLI", "planted introns reported exactly", *b9["introns"], 0.90)
    print(f"gmap CLI: bench-shaped queries' planted introns reported "
          f"exactly {b9['bench_exact'][0]}/{b9['bench_exact'][1]}",
          flush=True)
    bar("gmap CLI", "bench-shaped three-exon queries best on their "
        "chromosome and strand over the planted span", *b9["bench_placed"],
        0.99)
    bar("gmap CLI", "bench-shaped queries' planted introns reported exactly "
        "or at a shift that leaves the spliced sequence as it is",
        *b9["bench_introns"], 0.85)
    bar("gmap CLI", "bench-shaped queries' planted introns reported exactly, "
        "at such a shift, or moved to a canonical intron within 10 nt",
        *b9["bench_canonical"], 0.99)
    bar("gmap CLI", "chimeras reported as two parts on their planted "
        "chromosomes", *b9["chimeras"], 7 / 8)
    ev = got9["runs"][2]["events"] or []
    busy = sum(e[2] for e in ev) / 1e6
    wall9 = got9["runs"][2]["wall"]
    hand9 = {}
    for key, count, us in ev:
        n = _hand_kernel(key)
        if n is not None:
            c, t = hand9.get(n, (0, 0.0))
            hand9[n] = (c + count, t + us)
    print(f"gmap CLI -A profile: wall {wall9:.3f} s, device busy {busy:.4f} s"
          f" ({100 * busy / wall9:.1f}% busy), hand kernels "
          f"{sum(t for _, t in hand9.values()) / 1e3:.3f} ms; "
          + ", ".join(f"{n} {hand9.get(n, (0, 0.0))[1] / 1e3:.3f} ms "
                      f"{hand9.get(n, (0, 0.0))[0]}x"
                      for n in GMAP_KERNELS + DYNPROG_KERNELS), flush=True)
    print(f"path 9 done at {time.time() - t_start:.1f} s {_clock(t9)}",
          flush=True)
    # 10. the gsnap CLI with the multimapping maps and the output router
    # on the card: PE -N 1 (BASELINE.md's headline config) on PATH10_PAIRS
    # pairs, a quarter of them inside copies of the genome's repeat family
    # (synth.plant_copy_pairs), under -M PATH10_M, with three maps over
    # chosen copies (a genes map from synth.copy_genes_gtf through the
    # port's gtf_genes and iit_store, a tally and a runlength map through
    # iit_store), --split-output, a read group and -j; every split file
    # and standard output byte-equal to what the runner writes in process
    # through an OutputRouter with the same maps for the same pairs, its
    # kernels those of PE -N 1, and fewer pairs multimapped (NH > 1) than
    # the runner reports without the maps.  uniqscan --device cpu (10b)
    # runs beside it
    from gmap_gsnap_tpu_torch.io import outbuffer
    from gmap_gsnap_tpu_torch.io import sam as sam_mod

    t10 = time.time()
    print(f"path 10 (gsnap CLI with maps and router flags) at "
          f"{t10 - t_start:.1f} s {_clock()}", flush=True)
    uq_at = next(int(p) + 250 for p in genome.repeats
                 if b"N" not in genome.ascii[p + 250 : p + 250 + UNIQSCAN_NT]
                 .tobytes() and np.searchsorted(genome.chr_ends, p + 250,
                                                side="right")
                 == np.searchsorted(genome.chr_ends, p + 250 + UNIQSCAN_NT,
                                    side="right"))
    uq_seq = genome.ascii[uq_at : uq_at + UNIQSCAN_NT].tobytes().decode()
    uq_cmd = ["-D", tmp, "-d", "syn", uq_seq]
    uq_cpu = _start_tool("uniqscan", *uq_cmd, "--device", "cpu",
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    t_uq_cpu = time.time()
    groups, unit = genome.repeats[None], genome.repeat_unit
    mrng = np.random.default_rng(args.seed + 10)
    texts10 = {"genes.gtf": synth.copy_genes_gtf(genome, groups, unit),
               "tally.txt": synth.copy_tally_text(mrng, genome, groups, unit),
               "rl.txt": synth.copy_runlength_text(genome, groups, unit)}
    for name, text in texts10.items():
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    stores = [_start_tool("iit_store", "-o", os.path.join(tmp, m),
                          os.path.join(tmp, f"{m}.txt"))
              for m in ("tally", "rl")]
    genes_txt, _ = _tool("gtf_genes", os.path.join(tmp, "genes.gtf"))
    with open(os.path.join(tmp, "genes.txt"), "w") as f:
        f.write(genes_txt)
    stores.append(_start_tool("iit_store", "-o", os.path.join(maps, "genes"),
                              os.path.join(tmp, "genes.txt")))
    ncopy = PATH10_PAIRS // 4
    c1, c2, _ = synth.plant_copy_pairs(mrng, genome, groups, unit, ncopy)
    order10 = mrng.permutation(PATH10_PAIRS)
    m1 = [(rp1[: PATH10_PAIRS - ncopy] + c1)[i] for i in order10]
    m2 = [(rp2[: PATH10_PAIRS - ncopy] + c2)[i] for i in order10]
    files10 = [os.path.join(tmp, f"m10_{e}.fq") for e in (1, 2)]
    synth.write_fastq(files10[0], m1)
    synth.write_fastq(files10[1], m2)
    reads10 = [list(fasta.read_seqfile(f)) for f in files10]
    for proc, m in zip(stores, ("tally", "rl", "genes")):
        _finish_tool(proc, f"iit_store {m}")
    t_maps = time.time() - t10
    params10 = dataclasses.replace(params, subopt_levels=PATH10_M)
    map_kw = dict(genesdb="genes", tallydb="tally", tally_dir=tmp,
                  runlengthdb="rl", runlength_dir=tmp)
    t0 = time.time()
    plain10 = io.StringIO()
    runner_mod.GsnapRunner(db, params10, lmax=100, novelsplicing=True,
                           device=dev).run_pe(*reads10, plain10,
                                              batch_size=args.batch)
    without = _multimapped_pairs(plain10.getvalue())
    t_without = time.time() - t0
    t0 = time.time()
    r10 = runner_mod.GsnapRunner(db, params10, lmax=100, novelsplicing=True,
                                 device=dev, **map_kw)
    header10 = sam_mod.header(db.chr_names,
                              (db.chr_ends - db.chr_starts).tolist())
    header10 += outbuffer.read_group_header(*PATH10_RG[1::2])
    ref_root = os.path.join(tmp, "p10_ref", "out")
    cli_root = os.path.join(tmp, "p10_cli", "out")
    for root in (ref_root, cli_root):
        os.makedirs(os.path.dirname(root))
    ref10 = io.StringIO()
    router = outbuffer.OutputRouter(
        out=ref10, split_root=ref_root, fmt="sam", header=header10,
        transform=outbuffer.SamTransform(PATH10_RG[1], PATH10_SHIFT))
    r10.run_pe(*reads10, ref10, batch_size=args.batch, router=router)
    router.close()
    t_with = time.time() - t0
    lfile = os.path.join(tmp, "launches10.json")
    flags10 = ["-N", 1, "-M", PATH10_M, "-g", "genes", "--use-tally", "tally",
               "--tallydir", tmp, "--use-runlength", "rl", "--runlengthdir",
               tmp, "--split-output", cli_root, *PATH10_RG, "-j",
               PATH10_SHIFT]
    t0 = time.time()
    out10, err10 = _cli_counting(lfile, "gsnap", "-D", tmp, "-d", "syn",
                                 "--batch-size", args.batch, *flags10,
                                 *files10)
    wall10 = time.time() - t0
    with open(lfile) as f:
        got10 = json.load(f)
    ref_files, cli_files = _split_outputs(ref_root), _split_outputs(cli_root)
    if out10 != ref10.getvalue() or cli_files != ref_files:
        diff = sorted(k for k in set(ref_files) | set(cli_files)
                      if ref_files.get(k) != cli_files.get(k))
        raise SystemExit(f"path 10: the CLI's outputs differ from the "
                         f"runner's through its OutputRouter (stdout "
                         f"{len(out10)} / {len(ref10.getvalue())} B; split "
                         f"files {diff})")
    launches10 = got10["launches"]
    missing = [k for k in ALL_KERNELS if launches10.get(k, 0) == 0]
    if missing:
        raise SystemExit(f"path 10: kernels not launched {missing}")
    paths["gsnap CLI maps"] = launches10
    with_maps = _multimapped_pairs("".join(ref_files.values()))
    rg_ok = all(t.startswith(header10)
                and "\tRG:Z:RG10" in t[len(header10):]
                for t in ref_files.values())
    print(f"path 10 (gsnap {' '.join(map(str, flags10))}): "
          f"{PATH10_PAIRS} pairs ({ncopy} inside repeat copies); "
          f"{len(cli_files)} split files ({', '.join(cli_files)}), "
          f"{sum(map(len, cli_files.values()))} B, and standard output "
          f"({len(out10)} B) byte-equal to the runner's through an "
          f"OutputRouter; read group and header on every file: {rg_ok}; "
          f"maps built in {t_maps:.2f} s (gtf_genes, three iit_store); "
          f"runner without the maps {t_without:.2f} s, with them and the "
          f"router {t_with:.2f} s; CLI wall {wall10:.2f} s (process start, "
          f"database open and upload included); its rate line: "
          f"{_rate_line(err10)}; CLI peak device memory {got10['peak']} B "
          f"({got10['peak'] / 2**30:.2f} GiB); launches {launches10}",
          flush=True)
    print(f"path 10: multimapped pairs (NH > 1) under -M {PATH10_M}: "
          f"{without[0]} without the maps, {with_maps[0]} with them; their "
          f"NH summed {without[1]} and {with_maps[1]}", flush=True)
    if not rg_ok or without[0] == 0 or with_maps[0] >= without[0]:
        raise SystemExit(f"path 10: read group missing ({rg_ok}) or the "
                         f"maps resolved no multimapping pair ({without} "
                         f"without, {with_maps} with)")
    del r10, plain10, ref10

    # 10b. uniqscan on the card: one process on UNIQSCAN_NT nt that start
    # 250 nt into a repeat copy (its short prefixes align to many copies),
    # byte-equal to uniqscan --device cpu started at path 10's start; the
    # kernels those of SE -N 0's cascade (the GMAP lanes' where they run)
    t0 = time.time()
    uq_out, uq_err = _cli_counting(lfile, "uniqscan", *uq_cmd)
    uq_wall = time.time() - t0
    with open(lfile) as f:
        uq_launches = json.load(f)["launches"]
    os.remove(lfile)
    uq_ref, _ = _finish_tool(uq_cpu, "uniqscan --device cpu")
    counts = [int(l.split(": ")[1]) for l in uq_out.splitlines()]
    missing = [k for k in N0_KERNELS + STAGE_KERNELS
               if uq_launches.get(k, 0) == 0]
    extra_k = [k for k in uq_launches if k not in N0_KERNELS + STAGE_KERNELS
               + GMAP_KERNELS + DYNPROG_KERNELS]
    if (uq_out != uq_ref or not counts or counts[0] < 2 or missing
            or extra_k):
        raise SystemExit(f"uniqscan: the card's output ({len(uq_out)} B) "
                         f"differs from --device cpu's ({len(uq_ref)} B), "
                         f"found no multimapping prefix ({counts[:3]}), or "
                         f"kernels not launched {missing} / off the path "
                         f"{extra_k}")
    print(f"uniqscan ({UNIQSCAN_NT} nt from {uq_at}, 150 of them in a repeat "
          f"copy): {len(counts)} lines byte-equal to --device cpu (first "
          f"{uq_out.splitlines()[0]!r}, last {uq_out.splitlines()[-1]!r}); "
          f"card wall {uq_wall:.2f} s (process start and database open "
          f"included); cpu run finished {time.time() - t_uq_cpu:.2f} s "
          f"after its start; launches {uq_launches}", flush=True)
    paths["uniqscan"] = uq_launches
    print(f"path 10 done at {time.time() - t_start:.1f} s {_clock(t10)}",
          flush=True)

    # 11. scale-out (parallel/shard.py).  (a) the sharded positions index
    # in this process, its shards on cuda:0: K1 with each shard's bounds
    # and the MIN over the shards at the main shape, n = 2 and 4, equal to
    # K1 on the whole index; align_batch_gapped (the -N 1 runner's
    # parameters) on each sharded index equal to the replicated one; K18's
    # candidate lists of the reads' first k-mers, over the four shards and
    # over one shard alone (a rank's form).  (b) two ranks through
    # parallel/shard.init_from_env: PE -N 1 on path 4's pairs against the
    # gmap_build directory, SAM byte-equal to path 4's, with their
    # all-reduce MIN timed; (c) a one-rank nccl group's all-reduce MIN
    t11 = time.time()
    import torch.distributed as dist

    from gmap_gsnap_tpu_torch.parallel import shard

    p384 = se.GsnapParams(seed_total=384, ncand=32,
                          size_threshold=params.size_threshold)
    sharded = {n: shard.ShardedIndexArrays.from_index(index, n)
               for n in (2, 4)}
    sc, sf, sl = strands(records)     # K1's main shape, as in step 4
    rc1, rf1, rl1 = (torch.from_numpy(x).to(dev) for x in
                  runner_mod.encode_batch(records[: args.batch], 100))
    # K18's lists: each read's first k-mer that the index holds
    oligos, ok1 = se._extract_oligos(rc1, rf1, rl1, db.k)
    st18 = index.offsets[oligos].long() & 0xFFFFFFFF
    cn18 = (index.offsets[oligos + 1].long() & 0xFFFFFFFF) - st18
    first = ((cn18 > 0) & ok1).int().argmax(1, keepdim=True)
    st18 = st18.gather(1, first)[:, 0].int()
    cn18 = cn18.gather(1, first)[:, 0].int()
    whole = se._seed_diagonals_cuda(index, sc, sf, sl, p384, True)
    rep_gapped = gg.align_batch_gapped(genome_dev, index, rc1, rf1, rl1,
                                       runner_n1.gapped_params)
    torch.cuda.synchronize()
    kbuild.LAUNCHES.clear()
    variant_launches, t_a = {}, time.time()
    for n, sh in sharded.items():
        before = kbuild.LAUNCHES["gsnap_seed_diagonals"]
        got = gg.align_batch_gapped(genome_dev, sh, rc1, rf1, rl1,
                                    runner_n1.gapped_params)
        variant_launches[f"seed_diagonals/shards {n}"] = (
            kbuild.LAUNCHES["gsnap_seed_diagonals"] - before)
        diff = [k for k in rep_gapped if not torch.equal(rep_gapped[k],
                                                         got[k])]
        if diff:
            raise SystemExit(f"scale-out: align_batch_gapped on {n} shards "
                             f"differs from the replicated index on {diff}")
    looks = {}
    for cap in (32, 128):
        before = kbuild.LAUNCHES["gsnap_shard_index_lookup"]
        looks[cap] = sharded[4].lookup(st18, cn18, cap)
        variant_launches[f"shard_index_lookup/cap {cap}"] = (
            kbuild.LAUNCHES["gsnap_shard_index_lookup"] - before)
    torch.cuda.synchronize()
    launches11 = dict(kbuild.LAUNCHES)
    for k in ("gsnap_seed_diagonals", "gsnap_shard_index_lookup"):
        if launches11.get(k, 0) == 0:
            raise SystemExit(f"scale-out: {k} not launched on the sharded "
                             f"index ({launches11})")
    print(f"scale-out (a): align_batch_gapped -N 1 on {args.batch} reads "
          f"with the positions in 2 and 4 shards on cuda:0 (shard lengths "
          f"{sharded[2].shard_len}, {sharded[4].shard_len}) equal to the "
          f"replicated index on every key; K18 over 4 shards, caps 32 and "
          f"128 ({int((looks[32] != se.INVALID_DIAG).sum())} and "
          f"{int((looks[128] != se.INVALID_DIAG).sum())} entries filled); launches "
          f"{launches11} in {time.time() - t_a:.2f} s", flush=True)

    def sharded_plain(sh):
        out = None
        for r in range(sh.rows.shape[0]):
            res = se._seed_diagonals_plain(
                se.IndexArrays(sh.offsets, sh.rows[r], sh.k, sh.interval),
                sc, sf, sl, p384, True, r * sh.shard_len, sh.shard_len)
            out = list(res) if out is None else [torch.minimum(out[0],
                                                               res[0]),
                                                 *out[1:]]
        return tuple(out)

    new_checks = []
    for n, sh in sharded.items():
        new_checks.append((f"seed_diagonals/shards {n}", "W=384 NC=32",
                           partial(se.seed_diagonals, sh, sc, sf, sl, p384,
                                   True),
                           partial(sharded_plain, sh)))
    held = shard.ShardedIndexArrays.from_index(index, 4, rank=1)
    for name, sh, cap in (("shard_index_lookup", sharded[4], 32),
                          ("shard_index_lookup/cap 128", sharded[4], 128),
                          ("shard_index_lookup/held shard 1", held, 32)):
        new_checks.append((name, f"R={args.batch} cap={cap} n=4", partial(
            shard._shard_index_lookup_cuda, sh.rows, st18, cn18, cap, 4,
            sh.row0), partial(shard._shard_index_lookup_plain, sh.rows,
                              st18, cn18, cap, 4, sh.row0)))
    for name, shape, fk, fp in new_checks:
        want = fp()
        err = _max_abs_err(fk(), want)
        print(f"kernel {name:20s} {shape:22s}: max_abs_err={err}", flush=True)
        if err != 0:
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version (max_abs_err={err})")
        if name.startswith("seed_diagonals/"):
            err_w = _max_abs_err(want, whole)
            if err_w != 0:
                raise SystemExit(f"{name}: the MIN over the shards differs "
                                 f"from K1 on the whole index ({err_w})")
            cost = costs["seed_diagonals"]
        else:
            # starts and counts read, each filled entry's position read
            # once, the int64 lists written
            cost = lambda out, n=st18.numel(): (
                8 * n + 4 * int((out != se.INVALID_DIAG).sum()) + 8 * out.numel(),
                0)
            if name == "shard_index_lookup":
                sh4 = sharded[4]
                own = (st18.long() // sh4.shard_len).clamp(0, 3)
                j = torch.arange(32, device=dev)[None, :]
                gidx = (own[:, None] * sh4.shard_len + (
                    st18.long() - own * sh4.shard_len)[:, None] + j).clamp(
                    max=sh4.rows.numel() - 1)
                ok = j < cn18.long()[:, None]
                flat = sh4.rows.view(-1)
                # int32 lists holding uint32 bits: -1 is 0xFFFFFFFF
                library[name] = lambda: torch.where(ok, flat[gidx], -1)
        errs[name] = err
        bounds[name] = _bound(*cost(want))
        bound_shape[name] = shape
    checks.extend(new_checks)
    del whole, looks, rep_gapped

    # (b) two ranks: a card each with nccl where there are two, else
    # both on cuda:0 with gloo
    torch.cuda.empty_cache()
    ncards = torch.cuda.device_count()
    topology = ("two ranks, a card each, nccl" if ncards > 1 else
                "two ranks sharing cuda:0, gloo (NCCL refuses two ranks on "
                "one device)")
    pfiles = [os.path.join(tmp, f"scale_{i}.fq") for i in (1, 2)]
    synth.write_fastq(pfiles[0], rp1)
    synth.write_fastq(pfiles[1], rp2)
    spec11 = os.path.join(tmp, "scale.json")
    with open(spec11, "w") as f:
        json.dump(dict(dbdir=dbdir, db="syn", pairs=pfiles, batch=args.batch,
                       sam=os.path.join(tmp, "scale.sam"),
                       result=os.path.join(tmp, "scale_result")), f)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    ranks = []
    t_b = time.time()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke._scaleout_rank({spec11!r})"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _STARTED.append(proc)
        ranks.append(proc)
    deadline = time.time() + 300
    while any(p.poll() is None for p in ranks):
        failed = [p for p in ranks if p.poll() not in (None, 0)]
        if failed or time.time() > deadline:
            _stop_tools()
            errs11 = [p.communicate()[1][-3000:] for p in ranks]
            raise SystemExit(f"scale-out: a rank failed or hung "
                             f"(exit codes {[p.returncode for p in ranks]}):"
                             f"\n" + "\n".join(errs11))
        time.sleep(0.5)
    for p in ranks:
        _finish_tool(p, "scale-out rank")
    res11 = []
    for rank in range(2):
        with open(os.path.join(tmp, f"scale_result{rank}")) as f:
            res11.append(json.load(f))
    with open(os.path.join(tmp, "scale.sam")) as f:
        sam11 = f.read()
    missing = [k for k in ALL_KERNELS
               if any(r["launches"].get(k, 0) == 0 for r in res11)]
    bad = [r["rank"] for r in res11
           if not (r["seed_equal"] and r["allreduce_equal"]
                   and r["n"] == len(rp1))]
    if sam11 != sam_pe_n1 or missing or bad:
        raise SystemExit(f"scale-out: the two ranks' SAM "
                         f"({len(sam11)} B) differs from path 4's "
                         f"({len(sam_pe_n1)} B): {sam11 != sam_pe_n1}; "
                         f"kernels a rank did not launch {missing}; ranks "
                         f"whose count, sharded seeding or all-reduce was "
                         f"wrong {bad}")
    rate2 = len(rp1) / max(r["wall_s"] for r in res11)
    rate1 = len(rp1) / e2e["PE -N 1"]
    print(f"scale-out (b), {topology} ({ncards} card(s) visible): PE -N 1 on "
          f"{len(rp1)} pairs, SAM byte-equal to path 4's one-process SAM; "
          f"{rate2:.1f} pairs/s on two ranks beside {rate1:.1f} pairs/s "
          f"for one process on the same pairs (path 4's end to end; two "
          f"ranks on one card are a record, not a scaling figure); "
          + "; ".join(
              f"rank {r['rank']} on {r['device']} ({r['backend']}): set-up "
              f"{r['setup_s']:.2f} s, run {r['wall_s']:.3f} s, peak "
              f"{r['peak']} B, sharded seeding (a shard a rank + "
              f"all-reduce MIN) equal to the whole index with launches "
              f"{r['seed_launches']}, all-reduce MIN of a {r['diag_shape']} "
              f"int64 diag {r['allreduce_ms']:.3f} ms" for r in res11)
          + f"; smi {smi_line}; {time.time() - t_b:.1f} s", flush=True)

    # (c) a one-rank nccl group's all-reduce MIN on the same diag's shape
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        diag1 = se._seed_diagonals_cuda(index, rc1, rf1, rl1,
                                        runner_n1.params, True)[0]
        red = diag1.clone()
        dist.all_reduce(red, op=dist.ReduceOp.MIN)
        torch.cuda.synchronize()
        if not torch.equal(red, diag1):
            raise SystemExit("scale-out: a one-rank nccl all-reduce MIN "
                             "changed the diag")
        nccl_ms = _call_ms(lambda: dist.all_reduce(red, op=dist.ReduceOp.MIN),
                           reps=20)
    finally:
        dist.destroy_process_group()
    print(f"scale-out (c): one-rank nccl all-reduce MIN of a "
          f"{list(red.shape)} int64 diag {nccl_ms:.4f} ms (CUDA events, 20 "
          f"calls); smi {smi_line}", flush=True)
    scaleout = dict(
        topology=topology, pairs=len(rp1), pairs_per_s_two_ranks=rate2,
        pairs_per_s_one_process=rate1,
        allreduce_ms={f"gloo (host copy), rank {r['rank']}"
                      if r["backend"] == "gloo" else
                      f"nccl, rank {r['rank']}": r["allreduce_ms"]
                      for r in res11},
        allreduce_ms_nccl_one_rank=nccl_ms, diag_shape=res11[0]["diag_shape"])
    scaleout["allreduce_ms"]["nccl one rank"] = nccl_ms
    launches11 = dict(launches11)
    for r in res11:
        for k, v in r["launches"].items():
            launches11[k] = launches11.get(k, 0) + v
    paths["scale-out"] = launches11
    print(f"path 11 done at {time.time() - t_start:.1f} s {_clock(t11)}",
          flush=True)
    if "jax" in sys.modules or "gmap_gsnap_tpu" in sys.modules:
        raise SystemExit("jax or the JAX package was imported")

    # 7. kernel and plain-version times, and the -N 1 profiles, last, so
    # that the profiler cannot perturb the main paths' timing
    print(f"timing phase at {time.time() - t_start:.1f} s {_clock()}",
          flush=True)
    n_events = 0
    for name, shape, fk, fp in checks:
        # K1-K4, K6 and K8 are timed at every shape and variant (a name's
        # line keeps its first shape's times; the mode paths timed their
        # own variants); EVERY_CHECK's names at every check;
        # FIRST_SHAPE_ONLY's at their first shape only: K9-K12's plain
        # versions run thousands of small torch ops a call, and the
        # others' other shapes and variants are checked, not timed.  A
        # kernel's first shape is timed with its library call, on one
        # clock
        base = name.split("/")[0]
        once, variant = base in FIRST_SHAPE_ONLY, "/" in name
        if (variant and name not in TIMED_EDGES
                and any(e in name for e in UNTIMED_EDGES)):
            continue
        if name not in EVERY_CHECK and (
                (once and ((variant and name not in TIMED_EDGES)
                           or name in times))
                or (variant and name in times)):
            continue
        if name in ONLY_SHAPES and shape not in ONLY_SHAPES[name]:
            continue
        if base in PER_SHAPE:
            cost = shape_costs.get((name, shape))
            bound = _bound(*cost(fp())) if cost else bounds[name]
            n_events += shape_time(name, shape, fk, fp,
                                   library.get((name, shape)),
                                   bound) == "events"
            continue
        lib = library.get(name) if name not in times else None
        t0 = time.time()
        if base in ONE_REP:   # the kernel over 5 calls, the plain over 1
            ms, clock, calls = _timed(fk, *([lib] if lib else []))
            pms, pclock, pcalls = _timed(fp, reps=1)
            ms, calls = [ms[0], pms[0], *ms[1:]], [calls[0], pcalls[0]]
            clock = clock if pclock == clock else f"{clock} / plain {pclock}"
        else:
            ms, clock, calls = _timed(fk, fp, *([lib] if lib else []))
        n_events += "events" in clock
        print(f"kernel {name:20s} {shape:22s}: {clock} time cuda "
              f"{ms[0]:.4f} ms, plain torch {ms[1]:.4f} ms"
              + (f", library {ms[2]:.4f} ms" if lib else "")
              + (f", bound {bounds[name][0]:.5f} ms ({bounds[name][1]})"
                 if bound_shape.get(name) == shape else "")
              + f"; per call (events) {calls[0]:.4f} / {calls[1]:.4f} ms "
              + _clock(t0), flush=True)
        times.setdefault(name, (ms[0], ms[1], clock))
        if lib:
            library_ms[name] = ms[2]
    print(f"timing phase: {n_events} of the timed shapes on CUDA-event "
          f"time (a profile recorded no device time), the rest on "
          f"torch.profiler device time", flush=True)
    # K14 is one launch a call, its fields gathered inside it
    gargs1 = (out1, cands1, l1.int(), index.k, index.interval,
              runner.gapped_params, True)
    for what, fn in (("alone", partial(gg._rank_hits_cuda, out1,
                                        runner.gapped_params.base)),
                     ("with the SE epilogue",
                      partial(gg._rank_gate_se_cuda, *gargs1))):
        nops = _device_ops(fn)
        print(f"rank_hits: {nops} CUDA device ops per _rank_hits_cuda call "
              f"({what}, SE -N 0 batch"
              + ("; not measured: every profile lost device ops)"
                 if nops is None else ")"), flush=True)
        if nops is not None and nops != 1:
            raise SystemExit(f"_rank_hits_cuda ({what}) ran {nops} device "
                             f"ops, expected its one kernel")
    # K11, K9, K10 and K17 are one launch a call: K11's pair matrix goes
    # by value, and each wrapper passes its bool flags as a view of their
    # bytes (K9 also at a retry's H, with its global scratch row); K17's
    # inputs come contiguous with int32 lengths
    margs = next(c for c in checks if c[0] == "banded_gotoh")[2].args
    seg = lanes[0][1]["seed_segments"]
    for what, fn in (
            ("_banded_matrices_cuda", partial(dp._banded_matrices_cuda,
                                              *margs)),
            ("_seed_segments_cuda", partial(eng._seed_segments_cuda, *seg)),
            ("_seed_segments_cuda at 16 H", partial(
                eng._seed_segments_cuda, *seg[:5], 16 * seg[5], seg[6],
                seg[7])),
            ("_chain_cuda", partial(eng._chain_cuda,
                                    *lanes[0][1]["chain"])),
            ("_pack_batch_cuda", next(
                c for c in checks if c[0] == "pack_queries")[2]),
            ("_pack_batch_cuda on PE -N 1's stacked mates", next(
                c for c in checks
                if c[0] == "pack_queries/PE -N 1 mixed")[2])):
        nops = _device_ops(fn)
        print(f"{what}: {nops} CUDA device ops a call (the first lane's "
              f"inputs" + ("; not measured: every profile lost device ops)"
                           if nops is None else ")"), flush=True)
        if nops is not None and nops != 1:
            raise SystemExit(f"{what} ran {nops} device ops, expected its "
                             f"one kernel")
    print(f"profiles at {time.time() - t_start:.1f} s {_clock()}",
          flush=True)
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
                      "gmap_gsnap_tpu/align/gsnap_pe.py:119"),   # to :283
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
        "pack_queries": ("gsnap_pack_queries", "pack_queries.cu",
                         "gmap_gsnap_tpu/align/gsnap_se.py:547"),
        "shard_index_lookup": ("gsnap_shard_index_lookup",
                               "shard_index_lookup.cu",
                               "gmap_gsnap_tpu/parallel/shard.py:83"),
    }
    kernels = []
    for name, (entry, cu, replaces) in sources.items():
        ms, plain_ms, clock = times[name]
        variants = {v.split("/", 1)[1]: {
            "ms": times.get(v, (None, None, None))[0],
            "plain_ms": times.get(v, (None, None, None))[1],
            "clock": times.get(v, (None, None, None))[2],
            "max_abs_err": errs[v], "bound_ms": bounds[v][0],
            "bound_by": bounds[v][1],
            **({"launches": variant_launches[v]}
               if v in variant_launches else {})}
            for v in errs if v.startswith(name + "/")}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"gmap_gsnap_tpu_torch/csrc/{cu}",
                        "replaces": replaces,
                        # K18 runs on path 11 alone, the others on PE -N 1
                        "launches": paths["PE -N 1"].get(
                            entry, paths["scale-out"].get(entry, 0)),
                        "launches_by_path": {
                            label: launches.get(entry, 0)
                            for label, launches in paths.items()},
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "clock": clock,
                        "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "library_ms": library_ms.get(name),
                        "variants": variants,
                        **({"shapes": per_shape[name]}
                           if name in per_shape else {})})
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "scale_out": scaleout}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_tools()
