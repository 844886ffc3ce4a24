"""gsnap-compatible CLI of the port: single-end or paired-end, standard,
cmet-stranded or atoi-stranded mode (--mode, with --cmetdir /
--atoidir), -N 0 or -N 1 (novel splicing), known splice sites (-s) and
SNP-tolerant alignment (-v), the GMAP rescue lanes of --gmap-mode (all
of them by default), SAM output, on one CUDA device.

Usage:  python -m gmap_gsnap_tpu_torch.cli.gsnap -D <dir> -d <db> \\
            [-N 1] [-s <sites> [--splicingdir D]] [-v <snps> [-V D]] \\
            [--gmap-mode <lanes>] [options] <fastq> [<fastq of read 2>]

Paired-end input is two files (read 1, read 2) or one FASTA whose
records carry two sequence lines.  The flags keep the names and
defaults of gmap_gsnap_tpu/cli/gsnap.py (whose parser cannot be
imported: it sets up JAX).  Flags of paths the port does not have yet —
-A gsnap, three or more input files, and
values of --trigger-score-for-gmap or --max-gmap-improvement that no
lane reads — exit with an error naming the ROADMAP.md item instead of
running a reduced path.
"""

from __future__ import annotations

import argparse
import sys
import time

_ROADMAP = "not ported yet (ROADMAP.md queue A)"


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
    p.add_argument("-A", "--format", default="sam",
                   help="output format (sam only in this port)")
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
                        "when best score is greater than this (gsnap.c:98; "
                        "no lane reads it yet, so only 5 is accepted)")
    p.add_argument("--max-gmap-pairsearch", type=int, default=10,
                   help="perform GMAP pairsearch on nearby genomic regions "
                        "up to this many hits (gsnap.c:90)")
    p.add_argument("--max-gmap-terminal", type=int, default=50,
                   help="perform GMAP terminal on nearby genomic regions up "
                        "to this many hits (gsnap.c:91)")
    p.add_argument("--max-gmap-improvement", type=int, default=5,
                   help="perform GMAP improvement on nearby genomic regions "
                        "up to this many hits (gsnap.c:92; no lane reads "
                        "it yet, so only 5 is accepted)")
    p.add_argument("--query-unk-mismatch", type=int, default=0, choices=[0, 1])
    p.add_argument("--genome-unk-mismatch", type=int, default=1, choices=[0, 1])
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
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--npaths", "-n", type=int, default=100)
    p.add_argument("-M", "--suboptimal-levels", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (plain torch "
                        "versions of the kernels)")
    p.add_argument("input", nargs="+",
                   help="FASTQ/FASTA file (two for paired-end reads)")
    return p


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    unsupported = [
        (args.format != "sam", f"-A {args.format} is {_ROADMAP} (item 3)"),
        (len(args.input) > 2,
         "three or more input files (read as one single-end stream) are "
         f"{_ROADMAP} (item 7)"),
        (args.trigger_score_for_gmap != 5,
         f"--trigger-score-for-gmap other than 5 is {_ROADMAP} (item 3)"),
        (args.max_gmap_improvement != 5,
         f"--max-gmap-improvement other than 5 is {_ROADMAP} (item 3)"),
    ]
    for bad, msg in unsupported:
        if bad:
            p.error(msg)

    from ..align import gsnap_se, runner as runner_mod
    from ..db.datadir import GenomeDB
    from ..io import fasta
    from ..io import sam as sam_mod
    from ..ops import mismatch as mismatch_mod

    paired = len(args.input) == 2
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
        if first == b">":
            records, records3 = fasta.read_fasta_paired(args.input[0])
            paired = bool(records3) and all(r is not None for r in records3)
        if not paired:
            records = list(fasta.read_seqfile(args.input[0]))
    lmax = max((len(r.seq) for r in records + (records3 if paired else [])),
               default=100)

    db = GenomeDB.open(
        args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}",
        args.db, required_k=args.kmer, required_interval=args.sampling,
        required_basesize=args.basesize)
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
        expected_pairlength=args.pairexpect,
        pairlength_deviation=args.pairdev,
    )
    # set before any alignment (read by the mismatch kernel's callers)
    mismatch_mod.QUERY_UNK_MISMATCH = bool(args.query_unk_mismatch)
    mismatch_mod.GENOME_UNK_MISMATCH = bool(args.genome_unk_mismatch)
    if args.quality_zero_score is not None:
        runner_mod.QUALITY_ADJ = args.quality_zero_score
    if args.noexceptions:
        runner_mod.EXCEPTION_GUARD = False
    r = runner_mod.GsnapRunner(db, params, lmax=lmax, snpsdb=args.use_snps,
                               novelsplicing=bool(args.novelsplicing),
                               splicesdb=args.use_splicing,
                               snps_dir=args.snpsdir,
                               splicing_dir=args.splicingdir,
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
    sam_mod.INSERT_0M = args.sam_use_0M
    sam_mod.MULTIPLE_PRIMARIES = args.sam_multiple_primaries

    t0 = time.time()
    if paired:
        n = r.run_pe(records, records3, sys.stdout,
                     batch_size=args.batch_size,
                     emit_header=not args.no_sam_headers)
    else:
        n = r.run(records, sys.stdout, batch_size=args.batch_size,
                  emit_header=not args.no_sam_headers)
    dt = time.time() - t0
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
