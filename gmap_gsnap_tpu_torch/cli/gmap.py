"""gmap-compatible CLI of the port: cDNA/EST spliced alignment on one
CUDA device.

Usage: python -m gmap_gsnap_tpu_torch.cli.gmap -D <dir> -d <db> [-f format] <fasta>
       python -m gmap_gsnap_tpu_torch.cli.gmap -g <genomicseg> <fasta>   (user segment)

A copy of gmap_gsnap_tpu/cli/gmap.py, flag for flag with the same names,
defaults and exit codes, plus --device (cuda, the default, or cpu for
the plain torch versions of the kernels).  Each query is aligned on its
own (align_cdna_paths, then align_cdna_chimera), as the JAX CLI does:
the junction dynprog's gap tier depends on the batch's widest window.
A CUDA device that is missing is an error (exit 2), as is a query
longer than the GMAP engine aligns (65,536 + k - 1 bases, on every
device); there is no fallback to the CPU.  --version names this
package.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gmap")
    p.add_argument("-D", "--dir")
    p.add_argument("-d", "--db")
    p.add_argument("-g", "--gseg", help="user-supplied genomic segment FASTA")
    p.add_argument("--cmdline", default=None, metavar="GSEG,QUERY",
                   help="genomic segment and query given directly on the "
                        "command line, comma-separated (gmap.c:3319-3328)")
    p.add_argument("-k", "--kmer", type=int, default=None,
                   help="k-mer size of the genome index to use")
    p.add_argument("--basesize", type=int, default=None,
                   help="base size of the index offsets files")
    p.add_argument("--sampling", type=int, default=None,
                   help="index sampling interval to use")
    p.add_argument("-G", "--genomefull", action="store_true",
                   help="use the full (uncompressed) genome; accepted for "
                        "compatibility — spans always decode exactly here")
    p.add_argument("-B", "--batch", default=None,
                   help="batch/memory-mapping mode 0-5; accepted for "
                        "compatibility (DB arrays are always resident)")
    p.add_argument("--input-buffer-size", type=int, default=1000,
                   help="size of the input read-ahead buffer")
    p.add_argument("--output-buffer-size", type=int, default=1000,
                   help="output buffer size; accepted for compatibility")
    p.add_argument("-p", "--prunelevel", type=int, default=0,
                   choices=[0, 1, 2, 3],
                   help="0=no pruning (default), 1=poor seqs, "
                        "2=repetitive seqs, 3=both (gmap.c:3003-3012)")
    p.add_argument("--min-intronlength", type=int, default=9,
                   help="min length for a genome gap to be an intron "
                        "(gmap.c:181 min_intronlength)")
    p.add_argument("-w", "--localsplicedist", "--reference",
                   dest="localsplicedist", type=int, default=200000,
                   help="largest distance for a local splice "
                        "(accepted; gmap bounds introns via -K here)")
    p.add_argument("--nosplicing", action="store_true",
                   help="turn off splicing (genome gaps score as "
                        "noncanonical, no intron rewards)")
    p.add_argument("--canonical-mode", type=int, default=1,
                   choices=[0, 1, 2],
                   help="0=low reward for canonical introns, 1=high "
                        "reward (default), 2=high reward for "
                        "low-identity seqs only (gmap.c:753-761)")
    p.add_argument("--cross-species", action="store_true",
                   help="use a more sensitive search for canonical "
                        "splicing (accepted for compatibility)")
    p.add_argument("--allow-close-indels", type=int, default=1,
                   choices=[0, 1, 2],
                   help="0=no, 1=yes (default), 2=only for high-quality "
                        "alignments (close_indels_mode, gmap.c:2788-2799)")
    p.add_argument("--microexon-spliceprob", type=float, default=0.95,
                   help="accepted for compatibility: the 2012 reference "
                        "parses this for gmap but never consumes it "
                        "(gmap.c:263,2805 — no other use)")
    p.add_argument("--stage2-start", type=int, default=-1,
                   help="stage-2 debugging: suboptimal score at start "
                        "(gmap.c:264)")
    p.add_argument("--stage2-end", type=int, default=3,
                   help="stage-2 debugging: suboptimal score at end "
                        "(gmap.c:265)")
    p.add_argument("-H", "--trimendexons", type=int, default=9,
                   help="trim end exons with fewer than this many "
                        "matches (minendexon, gmap.c:195)")
    p.add_argument("-C", "--chrsubsetfile", default=None,
                   help="user-supplied chromosome subset file")
    p.add_argument("-o", "--chimera-overlap", type=int, default=0,
                   help="overlap to show between chimeric parts "
                        "(gmap.c:304)")
    p.add_argument("--suboptimal-score", type=int, default=1000000,
                   help="report only paths whose score is within this "
                        "value of the best path (gmap.c:283,602)")
    p.add_argument("--version", action="store_true",
                   help="print version and exit")
    p.add_argument("-0", "--noexceptions", action="store_true",
                   help="let signals pass through (accepted)")
    p.add_argument("-9", "--check", dest="selfcheck", action="store_true",
                   help="run internal consistency checks (accepted)")
    p.add_argument("-8", "--stage3debug", default=None,
                   help="stage-3 debug dumps (accepted)")
    p.add_argument("-6", "--graphic", dest="graphic", action="store_true",
                   help="graphic debug output (accepted)")
    p.add_argument("-V", "--use-snps", default=None,
                   help="use the given SNP database for SNP-tolerant "
                        "display (accepted; alignment is SNP-blind "
                        "like the reference gmap default modes)")
    p.add_argument("--splicingdir", default=None,
                   help="directory holding the splicing IIT")
    p.add_argument("-s", "--use-splicing", default=None,
                   help="look for splicing at known sites from this "
                        "splicesites/introns IIT (accepted)")
    p.add_argument("--cmetdir", default=None)
    p.add_argument("--atoidir", default=None)
    p.add_argument("--mode", default="standard",
                   choices=["standard", "cmet-stranded", "cmet-nonstranded",
                            "atoi-stranded", "atoi-nonstranded"],
                   help="alignment mode (bisulfite / RNA-editing)")
    p.add_argument("-f", "--format", default="paths",
                   choices=["paths", "gff3_gene", "gff3_match_cdna",
                            "gff3_match_est", "summary", "samse", "sampe",
                            "psl",
                            "splicesites", "introns", "map_genes",
                            "map_exons", "coords"])
    p.add_argument("-A", "--align", dest="A", action="store_true",
                   help="alignment output")
    p.add_argument("-3", "--continuous", dest="continuous",
                   action="store_true",
                   help="show alignment in three continuous lines")
    p.add_argument("-4", "--continuous-by-exon", dest="continuous_by_exon",
                   action="store_true",
                   help="show alignment in three lines per exon")
    p.add_argument("-S", "--summary", dest="summary_only",
                   action="store_true",
                   help="summary output + exon table (no alignment rows)")
    p.add_argument("-n", "--npaths", type=int, default=5,
                   help="maximum number of paths to show (0: one path, "
                        "or two if chimera detected)")
    p.add_argument("-Z", "--compress", action="store_true",
                   help="compressed output format")
    p.add_argument("-E", "--exons", default=None, choices=["cdna", "genomic"],
                   help="print exon sequences")
    p.add_argument("-K", "--intronlength", type=int, default=1_000_000,
                   help="max intron length (gmap.c:233 maxintronlen_bound)")
    p.add_argument("-L", "--totallength", type=int, default=2_400_000,
                   help="max total genomic span (gmap.c:232)")
    p.add_argument("-x", "--chimera-margin", type=int, default=40,
                   help="uncovered-margin threshold for chimera search "
                        "(gmap.c:234)")
    p.add_argument("-q", "--part", default=None,
                   help="process only the i-th of n parts, as i/n")
    p.add_argument("-1", "--selfalign", action="store_true",
                   help="align the input sequence against itself")
    p.add_argument("-2", "--pairalign", action="store_true",
                   help="align the 2nd input sequence against the 1st")
    p.add_argument("-O", "--ordered", action="store_true",
                   help="accepted for compatibility (output is always "
                        "in input order)")
    p.add_argument("-t", "--nthreads", type=int, default=1,
                   help="accepted for compatibility")
    p.add_argument("-5", "--md5", action="store_true",
                   help="print MD5 checksum in query headers")
    p.add_argument("-l", "--wraplength", type=int, default=50,
                   help="alignment block width (gmap -l, pair.c)")
    p.add_argument("-i", "--introngap", type=int, default=3,
                   help="dots shown in -A intron gaps (gmap -i ngap)")
    p.add_argument("-c", "--chrsubset", default=None,
                   help="restrict the search to one chromosome")
    p.add_argument("-m", "--map", dest="mapfile", default=None,
                   help="map IIT for annotation lookup per path")
    p.add_argument("-M", "--mapdir", default=None,
                   help="directory holding the map IIT")
    p.add_argument("-b", "--mapboth", action="store_true",
                   help="report map hits on both strands")
    p.add_argument("-u", "--nflanking", type=int, default=0,
                   help="also report this many flanking map entries")
    p.add_argument("--print-comment", action="store_true",
                   help="print the map entry annotations too")
    p.add_argument("-F", "--fulllength", action="store_true",
                   help="translation starts from the first Met "
                        "(fulllengthp, gmap.c:315)")
    p.add_argument("-a", "--cdsstart", type=int, default=None,
                   help="translate codons from the given nucleotide "
                        "(1-based; gmap.c:485)")
    p.add_argument("-T", "--truncate", action="store_true",
                   help="truncate alignment around the full-length "
                        "protein, Met to Stop (implies -F; gmap.c:3128)")
    p.add_argument("-Y", "--tolerant", action="store_true",
                   help="translate with corrections for frameshifts "
                        "(gmap.c:489)")
    p.add_argument("-I", "--invertmode", type=int, default=0,
                   choices=[0, 1, 2],
                   help="mode for alignments to the genomic (-) strand: "
                        "0=don't invert, 1=invert cDNA + print genomic "
                        "(-) strand, 2=invert cDNA + print genomic (+) "
                        "strand (pair.c:810-825)")
    p.add_argument("-e", "--mapexons", action="store_true",
                   help="map each exon separately against the map IIT")
    p.add_argument("--no-sam-headers", action="store_true",
                   help="do not print @SQ headers for SAM output")
    p.add_argument("--sam-use-0M", action="store_true",
                   help="insert 0M in CIGAR between adjacent "
                        "insertions and deletions")
    p.add_argument("--read-group-id", default=None)
    p.add_argument("--read-group-name", default=None)
    p.add_argument("--read-group-library", default=None)
    p.add_argument("--read-group-platform", default=None)
    p.add_argument("--quality-protocol", default=None,
                   choices=["illumina", "sanger"],
                   help="quality protocol of input (shifts printed "
                        "quality strings)")
    p.add_argument("-j", "--quality-print-shift", type=int, default=0,
                   help="shift FASTQ quality scores by this amount "
                        "on output")
    p.add_argument("--failsonly", action="store_true",
                   help="print only failed (unaligned) queries")
    p.add_argument("--nofails", action="store_true",
                   help="exclude failed (unaligned) queries")
    p.add_argument("--fails-as-input", action="store_true",
                   help="print failed queries in input FASTA format")
    p.add_argument("--split-output", default=None, metavar="ROOT",
                   help="basename for separate nomapping/uniq/mult/"
                        "transloc output files (gmap.c:3036-3040)")
    p.add_argument("--quiet-if-excessive", action="store_true",
                   help="suppress alignments when paths exceed -n")
    p.add_argument("-z", "--direction", default="auto",
                   choices=["sense_force", "antisense_force",
                            "sense_filter", "antisense_filter", "auto"],
                   help="cDNA direction to try/keep (gmap.c:3129-3148; "
                        "force modes are applied as filters here)")
    p.add_argument("--nolengths", "-N", action="store_true",
                   help="omit intron lengths in -A output (nointronlenp)")
    p.add_argument("-P", "--protein-dna", action="store_true",
                   help="print protein sequence (cDNA)")
    p.add_argument("-Q", "--protein-gen", action="store_true",
                   help="print protein sequence (genomic)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (plain torch "
                        "versions of the kernels)")
    p.add_argument("input", nargs="*")
    args = p.parse_args(argv)
    if not args.input and not args.cmdline and not args.version:
        p.error("need input files (or --cmdline/--version)")

    if args.version:
        from .. import __version__ as _v

        print(f"GMAP: Genomic Mapping and Alignment Program (CUDA)\n"
              f"Part of gmap_gsnap_tpu_torch, version {_v}")
        return 0

    from ..utils.device import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"gmap: {e}", file=sys.stderr)
        return 2

    from ..align import gmap as gmap_mod
    from ..align import translation as _tr

    if args.truncate:
        args.fulllength = True  # gmap.c:3128: -T implies -F
    _tr.FULLLENGTH_P = args.fulllength
    _tr.CDS_STARTPOS = args.cdsstart or 0
    # alignment knobs (module statics, mirroring the reference's
    # setup-time globals; gmap.c:753-761, :181, :195)
    from ..align import gmap_config

    gmap_mod.MIN_INTRONLENGTH = args.min_intronlength
    gmap_config.CANONICAL_MODE = args.canonical_mode
    gmap_config.NOSPLICING = args.nosplicing
    gmap_config.MINENDEXON = args.trimendexons
    if args.nosplicing:
        # genome gaps are never introns (stage3.c:3338); chains may
        # only bridge deletion-sized gaps (max_deletionlength,
        # gsnap.c:102), so distant segments become separate paths
        args.intronlength = min(args.intronlength, 50)
    from ..db import build as build_mod
    from ..db.datadir import GenomeDB
    from ..io import fasta, gmap_out
    from ..utils import dna

    if args.cmdline:
        # --cmdline=GSEG,QUERY (gmap.c:3319-3328): both sequences on
        # the command line; the first is the genomic segment
        import tempfile

        if "," not in args.cmdline:
            print("--cmdline requires two strings separated by a comma",
                  file=sys.stderr)
            return 9
        gs, qs = args.cmdline.split(",", 1)
        ctmp = tempfile.mkdtemp()
        gfa = f"{ctmp}/cmdline_gseg.fa"
        with open(gfa, "w") as f:
            f.write(f">cmdline\n{gs}\n")
        qfa = f"{ctmp}/cmdline_query.fa"
        with open(qfa, "w") as f:
            f.write(f">query\n{qs}\n")
        args.gseg = gfa
        args.input = [qfa]

    if args.selfalign or args.pairalign:
        # -1/-2 (gmap.c:2935-2936): first input sequence acts as the
        # genome; the query is the same sequence (-1) or the second
        # sequence (-2)
        import tempfile

        seqs = []
        for path_in in args.input:
            seqs.extend(fasta.read_fasta(path_in))
        if args.pairalign and len(seqs) < 2:
            p.error("-2/--pairalign needs two input sequences")
        gtmp = tempfile.mkdtemp()
        gfa = f"{gtmp}/useralign.fa"
        with open(gfa, "w") as f:
            f.write(f">{seqs[0].label}\n{seqs[0].seq}\n")
        dbdir = build_mod.build_db([gfa], "usersegment", gtmp, k=12)
        db = GenomeDB.open(dbdir, "usersegment")
        dbmode = False
        qrec = seqs[0] if args.selfalign else seqs[1]
        qfa = f"{gtmp}/query.fa"
        with open(qfa, "w") as f:
            f.write(f">{qrec.label} {qrec.header.split(None, 1)[1] if len(qrec.header.split(None, 1)) > 1 else ''}".rstrip()
                    + f"\n{qrec.seq}\n")
        args.input = [qfa]
    elif args.gseg:
        # user-segment mode: build an in-memory DB from the segment
        import tempfile

        tmp = tempfile.mkdtemp()
        dbdir = build_mod.build_db([args.gseg], "usersegment", tmp, k=12)
        db = GenomeDB.open(dbdir, "usersegment")
        dbmode = False
    else:
        if not (args.dir and args.db):
            p.error("need -D/-d or -g")
        db = GenomeDB.open(
            args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}",
            args.db,
        )
        dbmode = True

    map_iit = None
    if args.mapfile:
        import os as _os

        from ..db.iit import IIT as _IIT

        mp = args.mapfile
        for cand in (mp,
                     _os.path.join(args.mapdir or "", mp),
                     _os.path.join(args.mapdir or "", f"{mp}.iit"),
                     _os.path.join(db.dbdir, f"{db.dbname}.maps", mp),
                     _os.path.join(db.dbdir, f"{db.dbname}.maps",
                                   f"{mp}.iit")):
            if cand and _os.path.exists(cand):
                map_iit = _IIT.read(cand)
                break
        if map_iit is None:
            print(f"gmap: cannot find map file {mp}", file=sys.stderr)
            return 9

    # -c/--chrsubset: the 2012 reference resolves the named subset from
    # <db>.chrsubset and prints the "[chrsubset: NAME]" label on every
    # Paths line — but its stage1 does NOT actually restrict the search
    # (verified: a query outside the subset still reports its path).
    # Mirrored label-only for byte parity.
    chrsubset_label = None
    if args.chrsubset:
        import os as _os1

        subf = (args.chrsubsetfile
                or _os1.path.join(db.dbdir, f"{db.dbname}.chrsubset"))
        found = False
        if _os1.path.exists(subf):
            cur = None
            for line in open(subf):
                if line.startswith(">"):
                    cur = line[1:].strip()
                    if cur == args.chrsubset:
                        found = True
                        break
        if not found:
            print(f"Unable to find subset {args.chrsubset} in chromosome "
                  f"subset file {subf}", file=sys.stderr)
            return 9
        chrsubset_label = args.chrsubset

    gstr = db.genome_str
    from ..io.outbuffer import (OutputRouter, SamTransform,
                                read_group_header)

    qshift = args.quality_print_shift
    if args.quality_protocol == "illumina":
        qshift -= 31  # gsnap.c:286-292 protocol base 64 -> 33
    samfmt = args.format in ("samse", "sampe")
    header = ""
    if samfmt and not args.no_sam_headers:
        header = "".join(
            f"@SQ\tSN:{n}\tLN:{int(e - s)}\n"
            for n, s, e in zip(db.chr_names, db.chr_starts, db.chr_ends))
        if args.read_group_id:
            header += read_group_header(
                args.read_group_id, args.read_group_name,
                args.read_group_library, args.read_group_platform)
    router = OutputRouter(
        out=sys.stdout, split_root=args.split_output,
        fmt="sam" if samfmt else args.format, header=header,
        fails_as_input=args.fails_as_input, failsonly=args.failsonly,
        nofails=args.nofails,
        transform=SamTransform(args.read_group_id, qshift)
        if samfmt else None,
        input_suffix="fa")
    import io as _io

    import numpy as _np

    chimera_ok = args.format in ("paths", "summary", "samse") and dbmode
    maxpaths = 1 if args.npaths == 0 else args.npaths
    allrecs = []
    for path_in in args.input:
        allrecs.extend(fasta.read_fasta(path_in))
    if args.part:
        pi_, pn_ = (int(x) for x in args.part.split("/"))
        allrecs = allrecs[pi_::pn_]
    if args.md5:
        import hashlib

        allrecs = [
            fasta.Record(r.label,
                         f"{r.header} md5:"
                         + hashlib.md5(r.seq.encode()).hexdigest(),
                         r.seq, r.quality)
            for r in allrecs
        ]
    # the longest Q rung of the GMAP engine (K9's limit); JAX fails on
    # such a query at its oligo assignment, the port refuses it up front
    qmax = gmap_mod._Q_LADDER[-1] + db.k - 1
    for rec in allrecs:
        if len(rec.seq) > qmax:
            print(f"gmap: query {rec.label} of {len(rec.seq)} bases is "
                  f"longer than the GMAP engine aligns ({qmax} bases)",
                  file=sys.stderr)
            return 2

    def _render(rec, w) -> str:
            if len(rec.seq) < db.k and args.format == "paths":
                # gmap.c:2425-2441 failure types
                word = ("Empty sequence" if len(rec.seq) == 0
                        else "Short sequence < index oligo size")
                sub0 = (f"  [chrsubset: {chrsubset_label}]"
                        if chrsubset_label else "")
                w.write(
                    f">{rec.header}\nPaths (0):{sub0} *** {word} ***\n\n")
                if args.A or args.summary_only or args.continuous_by_exon:
                    w.write("Alignments:\n")
                if map_iit is not None:
                    w.write("Maps:\n")
                return "nomapping"
            if args.prunelevel in (1, 3):
                # -p poor-sequence pruning (gmap.c:2046-2068; the
                # repetitive test is compiled out in this snapshot)
                from ..align import inquery

                poorp, _rep = inquery.classify(rec.seq)
                if poorp:
                    if args.format == "paths" and not args.compress:
                        sub0 = (f"  [chrsubset: {chrsubset_label}]"
                                if chrsubset_label else "")
                        w.write(f">{rec.header}\nPaths (0):{sub0} *** "
                                "Poor sequence (use -p flag to change "
                                "pruning behavior) ***\n\n")
                        if (args.A or args.summary_only
                                or args.continuous_by_exon):
                            w.write("Alignments:\n")
                        if map_iit is not None:
                            w.write("Maps:\n")
                    elif args.format in ("samse", "sampe"):
                        w.write(gmap_out.sam_record(
                            None, rec.label, rec.seq, None, "", 0,
                            rec.seq.upper(), gstr))
                    return "nomapping"
            chimera_pos = None
            if dbmode:
                # None for a query shorter than k, which then takes
                # each format's nomapping record (the Paths format
                # printed "Short sequence" above)
                allpaths = gmap_mod.align_cdna_paths(
                    db, rec.seq, max_intronlen=args.intronlength,
                    device=args.device) or []
                allpaths = [pt for pt in allpaths
                            if abs(pt.gend - pt.gstart)
                            <= args.totallength]
                if args.direction != "auto":
                    want = (1 if args.direction.startswith("sense")
                            else -1)
                    kept = [pt for pt in allpaths
                            if pt.cdna_direction == want
                            or pt.cdna_direction == 0]
                    allpaths = kept
                if allpaths and args.suboptimal_score < 1000000:
                    # --suboptimal-score (gmap.c:602): keep paths whose
                    # goodness is within N of the best
                    thr = (gmap_mod.path_goodness(allpaths[0])
                           - args.suboptimal_score)
                    allpaths = [pt for pt in allpaths
                                if gmap_mod.path_goodness(pt) >= thr]
                path = allpaths[0] if allpaths else None
                cpaths = allpaths
                if chimera_ok and path is not None:
                    ch, chimera_pos = gmap_mod.align_cdna_chimera(
                        db, rec.seq, best=path,
                        max_intronlen=args.intronlength,
                        margin=args.chimera_margin,
                        overlap=args.chimera_overlap, device=args.device)
                    if chimera_pos is not None:
                        cpaths = ch
            else:
                path = gmap_mod.align_cdna(
                    db, rec.seq, max_intronlen=args.intronlength,
                    device=args.device)
                cpaths = [path] if path is not None else []
            if args.truncate and path is not None:
                # -T: truncate each path around the full-length protein
                # (truncate_fulllength -> Stage3_apply_bounds,
                # stage3.c:4101-4119)
                from ..io.gmap_out import _translation_bounds as _tbf

                L0 = len(rec.seq)
                newp = []
                for pt in cpaths:
                    q2 = (rec.seq.upper() if pt.watsonp
                          else dna.revcomp_str(rec.seq.upper()))
                    tb = _tbf(pt, q2, gstr)
                    if tb:
                        r1, r2, _ = tb
                        lo, hi = (r1, r2) if r1 <= r2 else (r2, r1)
                        cp = gmap_mod._clip_path_read(
                            pt, lo, hi + 1, L0, gstr, rec.seq.upper())
                        if cp is not None:
                            cp.chrnum = pt.chrnum
                            cp.cdna_direction = pt.cdna_direction
                            newp.append(cp)
                            continue
                    newp.append(pt)
                cpaths = newp
                path = cpaths[0] if cpaths else None
            qstr = (
                rec.seq.upper()
                if path is None or path.watsonp
                else dna.revcomp_str(rec.seq.upper())
            )
            if args.format in ("samse", "sampe"):
                if path is None:
                    w.write(gmap_out.sam_record(
                        None, rec.label, rec.seq, None, "", 0, qstr, gstr))
                    return "nomapping"
                if (args.quiet_if_excessive and chimera_pos is None
                        and len(cpaths) > maxpaths):
                    # outbuffer.c:1139: excessive paths print a
                    # nomapping record into the mult stream
                    w.write(gmap_out.sam_record(
                        None, rec.label, rec.seq, None, "", 0, qstr, gstr))
                    return "mult"
                if chimera_pos is not None:
                    # chimeric halves: hard clips, NH 2, both HI 1,
                    # multimapper MAPQ 3, XT junction tag (gmap.c)
                    xt = "XT:Z:NN-NN,0.00,0.00"
                    for part in cpaths:
                        cn = int(_np.searchsorted(
                            db.chr_ends, part.gstart, side="right"))
                        pq = (rec.seq.upper() if part.watsonp
                              else dna.revcomp_str(rec.seq.upper()))
                        w.write(gmap_out.sam_record(
                            part, rec.label, rec.seq, None,
                            db.chr_names[cn], int(db.chr_starts[cn]),
                            pq, gstr, nh=2, hi=1, mapq=3, sm=40,
                            hardclip=True, extra=[xt],
                        ))
                    return "transloc"
                if True:
                    # one record per surviving path (up to -n), with
                    # multimapper NH/HI/MAPQ/XQ/X2 (Stage3_recompute_
                    # goodness softmax posterior, stage3.c:3657)
                    mapqs, absmqs, second = gmap_mod.path_mapqs(cpaths)
                    for hi_i, pt in enumerate(cpaths[:maxpaths]):
                        chrnum = int(_np.searchsorted(
                            db.chr_ends, pt.gstart, side="right"))
                        pq = (rec.seq.upper() if pt.watsonp
                              else dna.revcomp_str(rec.seq.upper()))
                        line = gmap_out.sam_record(
                            pt, rec.label, rec.seq, None,
                            db.chr_names[chrnum],
                            int(db.chr_starts[chrnum]), pq, gstr,
                            nh=len(cpaths), hi=hi_i + 1,
                            mapq=mapqs[hi_i], sm=40,
                            xq=absmqs[hi_i], x2=second,
                        )
                        if args.format == "sampe":
                            # sampe sets the paired-read bits on a
                            # single end (gmap.c "setting paired_read
                            # bit")
                            fields = line.split("\t")
                            fields[1] = str(int(fields[1]) | 0x41)
                            line = "\t".join(fields)
                        w.write(line)
                return "uniq" if len(cpaths) == 1 else "mult"
            if path is None:
                if args.format == "paths" and not args.compress:
                    sub0 = (f"  [chrsubset: {chrsubset_label}]"
                            if chrsubset_label else "")
                    w.write(f">{rec.header}\nPaths (0):{sub0}\n\n")
                    if args.A or args.summary_only or args.continuous_by_exon:
                        # the Alignments section header prints even for
                        # 0 paths (gmap.c print_result -S/-A)
                        w.write("Alignments:\n")
                return "nomapping"
            if (args.quiet_if_excessive and chimera_pos is None
                    and len(cpaths) > maxpaths):
                # outbuffer.c:1610-1613: printp = false, no output
                return "uniq" if len(cpaths) == 1 else "mult"
            chrnum = int(
                __import__("numpy").searchsorted(db.chr_ends, path.gstart, side="right")
            )
            chrname = db.chr_names[chrnum]
            chr_start = int(db.chr_starts[chrnum])
            chrlength = int(db.chr_ends[chrnum] - db.chr_starts[chrnum])
            path.chrnum = chrnum
            from ..io import gmap_align_fmt as afmt

            cat = ("transloc" if chimera_pos is not None
                   else ("uniq" if len(cpaths) == 1 else "mult"))
            if args.continuous:
                w.write(f">{rec.header}\n")
                w.write(afmt.continuous_body(path, qstr, gstr,
                        invertmode=args.invertmode))
                return cat
            if args.compress:
                w.write(gmap_out.compressed_output(
                    path, rec.label, 1, 1, chrname, chr_start,
                    qstr=qstr, gstr=gstr,
                    dbname=db.dbname if dbmode else None))
            elif args.exons:
                w.write(afmt.exons_output(
                    path, rec.header, qstr, gstr, args.exons == "genomic"))
            elif args.protein_dna or args.protein_gen:
                w.write(afmt.protein_output(
                    path, rec.header, qstr, gstr, args.protein_gen))
            elif args.format == "psl":
                w.write(gmap_out.psl_output(
                    path, rec.label, chrname, chr_start, chrlength))
            elif args.format == "splicesites":
                w.write(gmap_out.splicesites_output(path, rec.label, chrname))
            elif args.format == "introns":
                w.write(gmap_out.introns_output(path, rec.label, chrname))
            elif args.format in ("map_genes", "map_exons"):
                w.write(gmap_out.map_output(
                    path, rec.label, rec.header, chrname,
                    args.format == "map_exons", chr_start=chr_start))
            elif args.format in ("gff3_match_cdna", "gff3_match_est"):
                w.write(gmap_out.gff3_match(
                    path, 1, rec.label, chrname, db.dbname, qstr, gstr,
                    est=args.format == "gff3_match_est",
                    chr_start=chr_start))
            elif args.format == "coords":
                w.write(gmap_out.coords_output(
                    path, rec.header, qstr, gstr, chrname, chr_start))
            elif args.format == "gff3_gene":
                w.write(
                    gmap_out.gff3_gene(
                        path, 1, rec.label, chrname, db.dbname, qstr,
                        gstr, chr_start=chr_start
                    )
                )
                w.write("###\n")
            else:
                outpaths = cpaths
                chrinfo = None
                if dbmode and chimera_pos is None:
                    chrinfo = []
                    for pt in outpaths[:maxpaths]:
                        pcn = int(_np.searchsorted(
                            db.chr_ends, pt.gstart, side="right"))
                        chrinfo.append((db.chr_names[pcn], int(
                            db.chr_ends[pcn] - db.chr_starts[pcn]),
                            int(db.chr_starts[pcn])))
                w.write(
                    gmap_out.paths_output(
                        rec.header, outpaths, chrname, chrlength, qstr,
                        gstr, dbmode, chimera_pos=chimera_pos,
                        read=rec.seq.upper(),
                        maxpaths=None if chimera_pos is not None
                        else maxpaths,
                        chrinfo=chrinfo,
                        dbname=db.dbname if dbmode else None,
                        chr_start=chr_start,
                        chrsubset_label=chrsubset_label,
                    )
                )
                if chimera_pos is None:
                    outpaths = outpaths[:maxpaths]
                if args.A or args.summary_only or args.continuous_by_exon:
                    from ..io import gmap_align_fmt as afmt

                    cname = chrname if dbmode else None
                    codes = db.codes if dbmode else None
                    aa_maps = None
                    if chimera_pos is not None and len(outpaths) > 1:
                        aa_maps = gmap_out.chimera_aa_maps(outpaths, gstr)
                    w.write("Alignments:\n")
                    for pi, part in enumerate(outpaths):
                        pq = (rec.seq.upper() if part.watsonp
                              else dna.revcomp_str(rec.seq.upper()))
                        pcn = int(_np.searchsorted(
                            db.chr_ends, part.gstart, side="right"))
                        pcs = int(db.chr_starts[pcn]) if dbmode else chr_start
                        pcname = (db.chr_names[pcn] if dbmode else cname)
                        w.write(
                            f"  Alignment for path {pi + 1}:\n\n")
                        w.write(afmt.exon_table(
                            part, pcs, pcname if dbmode else cname,
                            codes=codes, invertmode=args.invertmode))
                        w.write("\n")
                        if args.continuous_by_exon:
                            w.write(afmt.continuous_by_exon_body(
                                part, pq, gstr,
                                invertmode=args.invertmode))
                        elif args.A:
                            w.write(afmt.alignment_body(
                                part, pq, gstr, pcs,
                                pcname if dbmode else cname,
                                aa_override=(aa_maps[pi] if aa_maps
                                             else None),
                                wraplength=args.wraplength,
                                ngap=args.introngap,
                                nolengths=args.nolengths,
                                invertmode=args.invertmode))
                if map_iit is not None:
                    w.write("Maps:\n")
                    for pi, part in enumerate(outpaths):
                        pcn = int(_np.searchsorted(
                            db.chr_ends, part.gstart, side="right"))
                        fn = (gmap_out.map_hits_exons if args.mapexons
                              else gmap_out.map_hits)
                        kw = ({} if args.mapexons
                              else {"nflanking": args.nflanking})
                        w.write(fn(
                            part, pi + 1, map_iit, args.mapfile,
                            db.chr_names[pcn], int(db.chr_starts[pcn]),
                            bothstrands=args.mapboth,
                            print_comment=args.print_comment, **kw))
            return cat

    for rec in allrecs:
        w = _io.StringIO()
        category = _render(rec, w)
        router.write(category, w.getvalue(), recs=(rec,))
    router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
