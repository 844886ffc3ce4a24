"""gsnap-compatible CLI of the port: single-end or paired-end, standard,
cmet-stranded or atoi-stranded mode (--mode, with --cmetdir /
--atoidir), -N 0 or -N 1 (novel splicing), known splice sites (-s) and
SNP-tolerant alignment (-v), the GMAP rescue lanes of --gmap-mode (all
of them by default), multimapping resolution by known genes, tallies and
runlength maps (-g, --favor-multiexon, --use-tally, --use-runlength),
SAM or GSNAP's native output (-A gsnap, with --print-snps and
--show-refdiff), split and filtered outputs (--split-output,
--fails-as-input, --failsonly, --nofails), read groups and quality
shifts, on one CUDA device.

Usage:  python -m gmap_gsnap_tpu_torch.cli.gsnap -D <dir> -d <db> \\
            [-N 1] [-s <sites> [--splicingdir D]] [-v <snps> [-V D]] \\
            [-g <genes>] [--gmap-mode <lanes>] [options] <fastq> \\
            [<fastq of read 2>]

Paired-end input is two files (read 1, read 2) or one FASTA whose
records carry two sequence lines; three or more files are read as one
single-end stream.  The parser takes every flag of
gmap_gsnap_tpu/cli/gsnap.py (whose parser cannot be imported: it sets up
JAX) with the same names, defaults and exit codes, the flags it accepts
with no effect included (-B, -G, -t, -O, --gunzip, the buffer sizes,
--unload), plus --device: cuda (the default) or cpu for the plain torch
versions of the kernels.  Reads longer than the CUDA kernels take
(ops/mismatch.CUDA_MAX_READ_LENGTH) exit 2 unless --device cpu, and a
missing card raises; there is no fallback to the CPU.  The GMAP tuning flags
--trigger-score-for-gmap, --max-gmap-improvement, --gmap-min-coverage,
--microexon-spliceprob and --antistranded-penalty reach GsnapParams, as
in the JAX CLI, where no lane reads them.

Several ranks: started by torchrun (WORLD_SIZE > 1), each rank joins
the process group (parallel/shard.init_from_env: rank i on cuda:i with
nccl, or gloo under --device cpu), aligns its block of every batch, and
rank 0 alone writes standard output, the split outputs and the messages
on standard error:

    torchrun --nproc-per-node 2 -m gmap_gsnap_tpu_torch.cli.gsnap ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _expand_gmap_mode(s: str) -> str:
    """--gmap-mode parser (gsnap.c:1032 add_gmap_mode): each token ORs
    a lane in; 'none' clears and stops parsing further tokens."""
    allowed = {"improve": "improvement", "improvement": "improvement",
               "terminal": "terminal",
               "indel_knownsplice": "indel_knownsplice",
               "pairsearch": "pairsearch", "all": "all"}
    modes: set[str] = set()
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "none":
            return ""
        if tok not in allowed:
            print(f"Don't recognize gmap-mode type {tok}\n"
                  "Allowed values are: none, improve, terminal, "
                  "indel_knownsplice, pairsearch", file=sys.stderr)
            sys.exit(9)
        if tok == "all":
            return "pairsearch,indel_knownsplice,terminal,improvement"
        modes.add(allowed[tok])
    return ",".join(sorted(modes))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gsnap", add_help=True)
    p.add_argument("-D", "--dir", required=True, help="genome directory")
    p.add_argument("-d", "--db", required=True, help="genome database")
    p.add_argument("-A", "--format", default="sam", choices=["sam", "gsnap"],
                   help="output format (sam, or the gsnap native format)")
    p.add_argument("-m", "--max-mismatches", type=float, default=-1)
    p.add_argument("-i", "--indel-penalty", type=int, default=2)
    p.add_argument("--indel-penalty-middle", type=int, default=None)
    p.add_argument("--indel-penalty-end", type=int, default=None)
    p.add_argument("--indel-endlength", type=int, default=4)
    p.add_argument("-y", "--max-middle-insertions", type=int, default=9)
    p.add_argument("-z", "--max-middle-deletions", type=int, default=30)
    p.add_argument("-Y", "--max-end-insertions", type=int, default=3)
    p.add_argument("-Z", "--max-end-deletions", type=int, default=6)
    p.add_argument("-w", "--localsplicedist", type=int, default=200_000,
                   help="max length for local splice (gsnap.c:194)")
    p.add_argument("-e", "--local-splice-penalty", type=int, default=0)
    p.add_argument("-E", "--distant-splice-penalty", type=int, default=1)
    p.add_argument("-K", "--distant-splice-endlength", type=int, default=16)
    p.add_argument("-l", "--shortend-splice-endlength", type=int, default=2)
    p.add_argument("--merge-distant-samechr", action="store_true",
                   help="print same-chromosome distant splices as one "
                        "record instead of translocation halves "
                        "(samprint.c merge_samechr_p)")
    p.add_argument("--pairmax-dna", type=int, default=1_000,
                   help="max concordant insert, DNA mode (gsnap.c:162)")
    p.add_argument("--pairmax-rna", type=int, default=200_000,
                   help="max concordant insert, RNA mode (gsnap.c:163)")
    p.add_argument("--pairexpect", type=int, default=200,
                   help="expected paired-end length (gsnap.c:165)")
    p.add_argument("--pairdev", type=int, default=25,
                   help="allowable deviation from expected paired-end "
                        "length (gsnap.c:166)")
    p.add_argument("-o", "--orientation", default="FR",
                   choices=["FR", "RF", "FF"],
                   help="paired-end orientation (gsnap.c:1469-1482)")
    p.add_argument("--clip-overlap", action="store_true",
                   help="hard-clip the overlapping halves of proper "
                        "pairs (samprint.c clip_overlap_p)")
    p.add_argument("-a", "--adapter-strip", default=None,
                   choices=["paired", "off"],
                   help="strip paired-end adapter readthrough and retry "
                        "(the reference enables stripping for 'off' too, "
                        "gsnap.c:1485-1491)")
    p.add_argument("--terminal-threshold", type=int, default=2)
    p.add_argument("--trim-mismatch-score", type=int, default=-3)
    p.add_argument("--trim-indel-score", type=int, default=-4)
    p.add_argument("-k", "--kmer", type=int, default=0)
    p.add_argument("--sampling", type=int, default=0)
    p.add_argument("--basesize", type=int, default=0)
    p.add_argument("--sam-use-0M", action="store_true",
                   help="insert 0M between adjacent gap CIGAR ops "
                        "(Picard compat, samprint.c)")
    p.add_argument("--sam-multiple-primaries", action="store_true",
                   help="do not mark multimappers secondary (0x100)")
    p.add_argument("--no-sam-headers", action="store_true")
    p.add_argument("-Q", "--quiet-if-excessive", action="store_true")
    p.add_argument("--mode", default="standard",
                   choices=["standard", "cmet-stranded", "atoi-stranded"])
    p.add_argument("--cmetdir", default=None,
                   help="directory for methylcytosine index files "
                        "(gsnap.c:257-259)")
    p.add_argument("--atoidir", default=None,
                   help="directory for A-to-I RNA editing index files "
                        "(gsnap.c:261-263)")
    p.add_argument("-J", "--quality-zero-score", type=int, default=None,
                   help="FASTQ quality score corresponding to zero "
                        "(default 33 sanger; gsnap.c:443)")
    p.add_argument("-0", "--noexceptions", action="store_true",
                   help="turn off the offending-read crash guard "
                        "(gsnap.c:454 exception_raise_p)")
    p.add_argument("--time", action="store_true", dest="timing",
                   help="print per-batch alignment runtimes to stderr "
                        "(gsnap.c:581-599 --time)")
    p.add_argument("--gmap-mode",
                   default="pairsearch,indel_knownsplice,terminal,improvement",
                   help="when to run GMAP on reads: comma-separated list "
                        "of none, all, pairsearch, indel_knownsplice, "
                        "terminal, improvement (gsnap.c:1188)")
    p.add_argument("--trigger-score-for-gmap", type=int, default=5,
                   help="try GMAP pairsearch on nearby genomic regions "
                        "when best score is greater than this (gsnap.c:98)")
    p.add_argument("--max-gmap-pairsearch", type=int, default=10,
                   help="perform GMAP pairsearch on nearby genomic regions "
                        "up to this many hits (gsnap.c:90)")
    p.add_argument("--max-gmap-terminal", type=int, default=50,
                   help="perform GMAP terminal on nearby genomic regions up "
                        "to this many hits (gsnap.c:91)")
    p.add_argument("--max-gmap-improvement", type=int, default=5,
                   help="perform GMAP improvement on nearby genomic regions "
                        "up to this many hits (gsnap.c:92)")
    p.add_argument("--gmap-min-coverage", type=float, default=0.50,
                   help="keep GMAP hit only if it has this coverage "
                        "(gsnap.c:84)")
    p.add_argument("--microexon-spliceprob", type=float, default=0.95,
                   help="allow microexons only if one of the splice-site "
                        "probabilities is greater than this (gsnap.c:94)")
    p.add_argument("--antistranded-penalty", type=int, default=0,
                   help="penalty for antistranded splicing when using "
                        "stranded RNA-Seq protocols (gsnap.c:202; the "
                        "reference compiles out every application site)")
    p.add_argument("--query-unk-mismatch", type=int, default=0, choices=[0, 1])
    p.add_argument("--genome-unk-mismatch", type=int, default=1, choices=[0, 1])
    p.add_argument("--print-snps", action="store_true",
                   help="print detailed information about SNPs in reads "
                        "(works with -v; gsnap.c:460)")
    p.add_argument("--show-refdiff", action="store_true",
                   help="show differences from the reference genome "
                        "rather than from both genomes in SNP mode "
                        "(gsnap.c:459)")
    p.add_argument("-V", "--snpsdir", default=None,
                   help="directory holding the snpindex files (default: "
                        "the genome directory)")
    p.add_argument("--splicingdir", default=None,
                   help="directory holding the splicesites map IIT")
    p.add_argument("-v", "--use-snps", default=None,
                   help="use SNP-tolerant index built by snpindex")
    p.add_argument("-N", "--novelsplicing", type=int, default=0, choices=[0, 1])
    p.add_argument("-s", "--use-splicing", default=None,
                   help="known splice sites map IIT (name in <db>.maps or path)")
    p.add_argument("--ambig-splice-noclip", action="store_true",
                   help="for ambiguous known splicing at read ends, do "
                        "not clip at the splice site but extend into "
                        "the intron (gsnap.c:1247 amb_clip_p=false)")
    p.add_argument("--fastq-id-start", type=int, default=0,
                   help="whitespace field of the header where the "
                        "accession starts (0-based)")
    p.add_argument("--fastq-id-end", type=int, default=0,
                   help="whitespace field where the accession ends")
    p.add_argument("-g", "--genes", default=None, metavar="STRING",
                   help="look for known genes in <STRING>.iit to resolve "
                        "multimapping reads (gsnap.c -g)")
    p.add_argument("--favor-multiexon", action="store_true",
                   help="favor overlaps with multi-exon genes when "
                        "resolving multimapping reads")
    p.add_argument("--tallydir", default=None,
                   help="directory for tally IIT file (gsnap --tallydir)")
    p.add_argument("--use-tally", default=None, metavar="STRING",
                   help="use this tally IIT file to resolve multimapping "
                        "reads (gsnap.c:270-273)")
    p.add_argument("--runlengthdir", default=None,
                   help="directory for runlength IIT file")
    p.add_argument("--use-runlength", default=None, metavar="STRING",
                   help="use this runlength (FAIRE) IIT file to resolve "
                        "multimapping reads (gsnap.c:275-278)")
    p.add_argument("--sam-headers-batch", type=int, default=None,
                   help="print headers only for this batch index "
                        "(-q part; gsnap.c:445)")
    # accepted for compatibility, with no effect, as in the JAX CLI
    p.add_argument("-B", "--batch", default="2",
                   help="batch mode for memory mapping (accepted; the "
                        "genome and index are always held in memory)")
    p.add_argument("-G", "--genomefull", action="store_true",
                   help="use full genome (accepted; the genome is always "
                        "decoded from the compressed store)")
    p.add_argument("--output-buffer-size", type=int, default=1000,
                   help="buffer size for output threads (accepted; "
                        "output is written per batch)")
    p.add_argument("--unload", action="store_true",
                   help="unload memory-mapped files (accepted no-op)")
    p.add_argument("--version", action="version",
                   version="gsnap (gmap_gsnap_tpu_torch) reference-compatible "
                           "with GMAP/GSNAP version 2012-07-03")
    p.add_argument("-t", "--nthreads", type=int, default=1,
                   help="accepted for compatibility (batching replaces threads)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--npaths", "-n", type=int, default=100)
    p.add_argument("-q", "--part", default=None,
                   help="process only the i-th of n parts, as i/n "
                        "(multi-process input sharding, gsnap.c:999-1028)")
    p.add_argument("--split-output", default=None, metavar="ROOT",
                   help="write outputs per resulttype to ROOT.<suffix> "
                        "files (7-way split, samprint.h:41-52)")
    p.add_argument("--fails-as-input", action="store_true",
                   help="print failed reads in input FASTA/FASTQ format "
                        "(gsnap.c:299,463; requires --split-output or "
                        "--failsonly)")
    p.add_argument("--failsonly", action="store_true",
                   help="print only failed alignments")
    p.add_argument("--nofails", action="store_true",
                   help="exclude failed alignments")
    p.add_argument("--read-group-id", default=None)
    p.add_argument("--read-group-name", default=None)
    p.add_argument("--read-group-library", default=None)
    p.add_argument("--read-group-platform", default=None)
    p.add_argument("--quality-protocol", default=None,
                   choices=["illumina", "sanger"],
                   help="FASTQ quality protocol (illumina: shift -31 on "
                        "output; sanger: no shift; gsnap.c:286-292)")
    p.add_argument("-j", "--quality-print-shift", type=int, default=0,
                   help="shift FASTQ quality scores on output")
    p.add_argument("-M", "--suboptimal-levels", type=int, default=0)
    p.add_argument("--gunzip", action="store_true",
                   help="accepted for compatibility (gzip inputs are "
                        "auto-detected)")
    p.add_argument("-O", "--ordered", action="store_true",
                   help="accepted for compatibility (output is always "
                        "in input order)")
    p.add_argument("--input-buffer-size", type=int, default=1000,
                   help="accepted for compatibility (chunking is "
                        "--batch-size)")
    p.add_argument("--barcode-length", type=int, default=0,
                   help="strip this many bases from the start of every "
                        "read (gsnap.c barcode_length)")
    p.add_argument("--filter-chastity", default="off",
                   choices=["off", "either", "both"],
                   help="skip reads whose FASTQ header carries the "
                        "Illumina chastity-failed flag "
                        "(<read>:Y:<control>:<index>)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (plain torch "
                        "versions of the kernels)")
    p.add_argument("input", nargs="+",
                   help="FASTQ/FASTA file(s): two for paired-end reads, "
                        "three or more read as one single-end stream")
    # The -0 flag makes argparse treat every negative number as a
    # potential option, rejecting values like --trim-mismatch-score -5
    # or -j -31; exact option matches (-0) are resolved before this
    # marker is consulted, so clearing it restores negative values
    del p._has_negative_number_optionals[:]
    return p


def _select_records(args, paired, records, records3):
    """-q/--part, --fastq-id-start/-end, --barcode-length and
    --filter-chastity applied to the reads, as the JAX CLI applies them
    (gsnap.c:999-1028, 1293-1304, barcode_length; shortread.c:486-508).
    Returns (records, records3, barcode map) or an exit code."""
    from ..io import fasta

    if args.part:
        i, n = (int(x) for x in args.part.split("/"))
        records = records[i::n]
        if paired:
            records3 = records3[i::n]

    fid0 = max(args.fastq_id_start - 1, 0)
    fid1 = max(args.fastq_id_end - 1, 0)
    if fid1 < fid0:
        print("gsnap: --fastq-id-end must be equal to or greater than "
              "--fastq-id-start", file=sys.stderr)
        return 9
    if fid0 > 0 or fid1 > 0:
        # accession = header fields [start..end], 1-based flags
        def _acc(r):
            fields = r.header.split()
            i0 = min(fid0, max(len(fields) - 1, 0))
            i1 = min(fid1, max(len(fields) - 1, 0))
            acc = " ".join(fields[i0 : i1 + 1]) if fields else r.label
            return fasta.Record(acc, r.header, r.seq, r.quality)

        records = [_acc(r) for r in records]
        if paired:
            records3 = [_acc(r) for r in records3]

    bcmap: dict = {}
    if args.barcode_length > 0:
        bl = args.barcode_length

        def _chop(r, end):
            bcmap[(r.label, end)] = r.seq[:bl]
            return fasta.Record(r.label, r.header, r.seq[bl:],
                                r.quality[bl:] if r.quality else r.quality)

        if paired:
            records = [_chop(r, 1) for r in records]
            records3 = [_chop(r, 2) for r in records3]
        else:
            records = [_chop(r, 0) for r in records]

    if args.filter_chastity != "off":
        # Illumina casava header: <acc> <read>:<filtered Y/N>:...
        def _flagged(r):
            parts = r.header.split(None, 1)
            if len(parts) < 2:
                return False
            q = parts[1]
            i = q.find(":")
            return 0 <= i < len(q) - 1 and q[i + 1] == "Y"

        if paired:
            keep = [
                not (_flagged(a) and _flagged(b))
                if args.filter_chastity == "both"
                else not (_flagged(a) or _flagged(b))
                for a, b in zip(records, records3)
            ]
            records = [r for r, k in zip(records, keep) if k]
            records3 = [r for r, k in zip(records3, keep) if k]
        else:
            records = [r for r in records if not _flagged(r)]
    return records, records3, bcmap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return _main(args, 0)
    import torch.distributed as dist

    from ..parallel import shard

    args.device = str(shard.init_from_env(args.device))
    try:
        return _main(args, dist.get_rank())
    finally:
        dist.destroy_process_group()


def _main(args, rank: int) -> int:

    from ..align import gsnap_se, runner as runner_mod
    from ..db.datadir import GenomeDB
    from ..io import fasta, outbuffer
    from ..io import sam as sam_mod
    from ..ops import mismatch as mismatch_mod

    paired = len(args.input) == 2
    records3 = None
    if paired:
        records = list(fasta.read_seqfile(args.input[0]))
        records3 = list(fasta.read_seqfile(args.input[1]))
        if len(records) != len(records3):
            print("gsnap: paired files differ in read count", file=sys.stderr)
            return 2
    else:
        # a single FASTA whose records carry TWO sequence lines is
        # GSNAP's paired input format (shortread.c extended FASTA)
        with fasta._open(args.input[0]) as f:
            first = f.read(1)
        if first == b">" and len(args.input) == 1:
            records, records3 = fasta.read_fasta_paired(args.input[0])
            paired = bool(records3) and all(r is not None for r in records3)
        if not paired:
            # one file, or three or more read as one stream (gsnap.c)
            records = [r for path in args.input
                       for r in fasta.read_seqfile(path)]
    lmax = max((len(r.seq) for r in records + (records3 if paired else [])),
               default=100)
    if args.device != "cpu" and lmax > mismatch_mod.CUDA_MAX_READ_LENGTH:
        print(f"gsnap: reads of {lmax} bases are longer than the CUDA "
              f"kernels take ({mismatch_mod.CUDA_MAX_READ_LENGTH}); run "
              f"with --device cpu", file=sys.stderr)
        return 2

    db = GenomeDB.open(
        args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}",
        args.db, required_k=args.kmer, required_interval=args.sampling,
        required_basesize=args.basesize)
    picked = _select_records(args, paired, records, records3)
    if isinstance(picked, int):
        return picked
    records, records3, bcmap = picked
    mm = int(args.max_mismatches) if args.max_mismatches >= 0 else -1
    sth = (gsnap_se.dynamic_size_threshold(int(db.offsets[-1]), db.k,
                                           args.mode)
           if db.offsets is not None else 100)
    params = gsnap_se.GsnapParams(
        size_threshold=sth,
        maxpaths=args.npaths, max_mismatches=mm, mode=args.mode,
        subopt_levels=args.suboptimal_levels,
        indel_penalty_middle=(args.indel_penalty_middle
                              if args.indel_penalty_middle is not None
                              else args.indel_penalty),
        indel_penalty_end=(args.indel_penalty_end
                           if args.indel_penalty_end is not None
                           else args.indel_penalty),
        trim_indel_score=args.trim_indel_score,
        min_indel_end_matches=args.indel_endlength,
        max_middle_insertions=args.max_middle_insertions,
        max_middle_deletions=args.max_middle_deletions,
        max_end_insertions=args.max_end_insertions,
        max_end_deletions=args.max_end_deletions,
        localsplicing_penalty=args.local_splice_penalty,
        distantsplicing_penalty=args.distant_splice_penalty,
        min_distant_end_matches=args.distant_splice_endlength,
        min_shortend=args.shortend_splice_endlength,
        shortsplicedist=args.localsplicedist,
        pairmax_dna=args.pairmax_dna,
        pairmax_rna=args.pairmax_rna,
        terminal_threshold=args.terminal_threshold,
        trim_mismatch_score=args.trim_mismatch_score,
        gmap_mode=_expand_gmap_mode(args.gmap_mode),
        trigger_score_for_gmap=args.trigger_score_for_gmap,
        max_gmap_pairsearch=args.max_gmap_pairsearch,
        max_gmap_terminal=args.max_gmap_terminal,
        max_gmap_improvement=args.max_gmap_improvement,
        gmap_min_coverage=args.gmap_min_coverage,
        microexon_spliceprob=args.microexon_spliceprob,
        antistranded_penalty=args.antistranded_penalty,
        expected_pairlength=args.pairexpect,
        pairlength_deviation=args.pairdev,
    )
    # set before any alignment (read by the mismatch kernel's callers)
    mismatch_mod.QUERY_UNK_MISMATCH = bool(args.query_unk_mismatch)
    mismatch_mod.GENOME_UNK_MISMATCH = bool(args.genome_unk_mismatch)
    if args.quality_zero_score is not None:
        if args.quality_protocol is not None:
            print("gsnap: cannot specify both -J (--quality-zero-score) "
                  "and --quality-protocol", file=sys.stderr)
            return 9
        runner_mod.QUALITY_ADJ = args.quality_zero_score
    elif args.quality_protocol == "illumina":
        runner_mod.QUALITY_ADJ = 64  # gsnap.c:287
    if args.noexceptions:
        runner_mod.EXCEPTION_GUARD = False
    r = runner_mod.GsnapRunner(db, params, lmax=lmax, snpsdb=args.use_snps,
                               novelsplicing=bool(args.novelsplicing),
                               splicesdb=args.use_splicing,
                               snps_dir=args.snpsdir,
                               splicing_dir=args.splicingdir,
                               genesdb=args.genes,
                               favor_multiexon=args.favor_multiexon,
                               tallydb=args.use_tally,
                               tally_dir=args.tallydir,
                               runlengthdb=args.use_runlength,
                               runlength_dir=args.runlengthdir,
                               cmet_dir=args.cmetdir, atoi_dir=args.atoidir,
                               device=args.device)
    r.quiet_if_excessive = args.quiet_if_excessive
    r.merge_samechr = args.merge_distant_samechr
    r.clip_overlap = args.clip_overlap
    r.amb_clip = not args.ambig_splice_noclip
    r.invert_first = args.orientation == "RF"
    r.invert_second = args.orientation == "FR"
    # the reference enables chopping for BOTH 'paired' and 'off'
    r.chop_primers = args.adapter_strip is not None
    r.show_refdiff = args.show_refdiff
    r.print_snps = args.print_snps
    sam_mod.INSERT_0M = args.sam_use_0M
    sam_mod.MULTIPLE_PRIMARIES = args.sam_multiple_primaries

    if args.fails_as_input and not (args.split_output or args.failsonly):
        print("gsnap: --fails-as-input requires --split-output or "
              "--failsonly; turning it off", file=sys.stderr)
        args.fails_as_input = False
    qshift = args.quality_print_shift
    if args.quality_protocol == "illumina":
        qshift -= 31  # gsnap.c:287 (illumina qualities are +64-based)
    transform = outbuffer.SamTransform(args.read_group_id, qshift,
                                       barcodes=bcmap or None)
    router = None
    if rank == 0 and (args.split_output or args.fails_as_input
                      or args.failsonly or args.nofails
                      or not transform.identity):
        # the router writes the header itself, --no-sam-headers or not,
        # as in the JAX CLI
        header = sam_mod.header(
            db.chr_names, (db.chr_ends - db.chr_starts).tolist())
        if args.read_group_id:
            header += outbuffer.read_group_header(
                args.read_group_id, args.read_group_name,
                args.read_group_library, args.read_group_platform)
        router = outbuffer.OutputRouter(
            out=sys.stdout, split_root=args.split_output, fmt=args.format,
            header=header if args.format == "sam" else "",
            fails_as_input=args.fails_as_input, failsonly=args.failsonly,
            nofails=args.nofails, transform=transform)

    hdr = not args.no_sam_headers
    if args.sam_headers_batch is not None:
        # print headers only on this -q part index (gsnap.c:1384)
        part_i = int(args.part.split("/")[0]) if args.part else 0
        hdr = hdr and part_i == args.sam_headers_batch
    t0 = time.time()
    if paired:
        n = r.run_pe(records, records3, sys.stdout,
                     batch_size=args.batch_size, emit_header=hdr,
                     fmt=args.format, router=router)
    else:
        n = r.run(records, sys.stdout, batch_size=args.batch_size,
                  emit_header=hdr, fmt=args.format, router=router)
    dt = time.time() - t0
    if router is not None:
        router.close()
    if rank != 0:
        return 0
    if args.timing:
        for cat in sorted(r.category_counts):
            print(f"{cat}: {r.category_counts[cat]}", file=sys.stderr)
        for bi, (bt, nb) in enumerate(r.batch_times):
            print(f"batch {bi}: {nb} reads in {bt:.3f} s "
                  f"({1000.0 * bt / max(nb, 1):.3f} ms/read)",
                  file=sys.stderr)
    print(f"Processed {n} queries in {dt:.2f} seconds "
          f"({n / max(dt, 1e-9):.2f} queries/sec)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
