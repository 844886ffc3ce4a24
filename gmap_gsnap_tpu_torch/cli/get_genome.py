"""get-genome: extract a genomic segment from a database.

Usage: python -m gmap_gsnap_tpu_torch.cli.get_genome -D <dir> -d <db> \
           [-v snps_root] [-f mode] <chr>:<start>..<end>

Coordinates are 1-based inclusive; start > end yields the reverse
complement (reference get-genome.c behavior, README:478-489).  With a
SNP database (-v, built by snpindex), -f selects the print mode
(get-genome.c:42): 1 = alternate genome only, 2 = SNP-marked genome
(ambiguous positions as N), 3 = ref/alt line pairs (default).

A copy of gmap_gsnap_tpu/cli/get_genome.py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="get-genome")
    p.add_argument("-D", "--dir", required=True)
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-v", "--use-snps", default=None,
                   help="SNP database root (snpindex output)")
    p.add_argument("-f", "--snps-mode", type=int, default=3,
                   help="1=alt only, 2=snps marked, 3=ref/alt pairs")
    p.add_argument("query")
    args = p.parse_args(argv)

    import numpy as np

    from ..db.datadir import GenomeDB
    from ..db.iit_text import parse_coords
    from ..utils import dna

    dbdir = (args.dir if args.dir.endswith(args.db)
             else f"{args.dir}/{args.db}")
    db = GenomeDB.open(dbdir, args.db)
    div, start, end = parse_coords(args.query)
    revcomp = start > end
    if revcomp:
        start, end = end, start
    if div:
        try:
            ci = db.chr_names.index(div)
        except ValueError:
            print(f"unknown chromosome {div}", file=sys.stderr)
            return 9
        off = int(db.chr_starts[ci])
    else:
        ci, off = 0, 0
    lo, hi = off + start - 1, off + end
    chrn = div or db.chr_names[0]
    # the reference prints the revcomp label one past the low end
    # (get-genome.c header quirk)
    label = (f"{chrn}:{end}..{start + 1}" if revcomp
             else f"{chrn}:{start}..{end}")
    sys.stdout.write(f">{label} {args.query}\n")

    def wrap(s):
        for i in range(0, len(s), 60):
            sys.stdout.write(s[i : i + 60] + "\n")

    ref = dna.decode(db.codes[lo:hi], db.flags[lo:hi])
    if revcomp:
        ref = dna.revcomp_str(ref)

    if args.use_snps is None or args.snps_mode == 0:
        wrap(ref)
        return 0

    from ..db import genomecomp as gcomp

    snpfile = f"{dbdir}/{args.db}.genomecomp.{args.use_snps}"
    codes_s, flags_s = gcomp.read(snpfile, len(db.codes))
    # alternate bases: the SNP genome's CODE bits carry the alt base
    # under the ambiguity flag
    alt_raw = dna.decode(codes_s[lo:hi], np.zeros(hi - lo, bool))
    marked = dna.decode(codes_s[lo:hi], flags_s[lo:hi])
    if revcomp:
        alt_raw = dna.revcomp_str(alt_raw)
        marked = dna.revcomp_str(marked)

    if args.snps_mode == 1:
        wrap(alt_raw)
    elif args.snps_mode == 2:
        wrap(marked)
    else:
        snp = [marked[i] == "N" and ref[i] != "N" for i in range(len(ref))]
        for i in range(0, len(ref), 60):
            blk = range(i, min(i + 60, len(ref)))
            sys.stdout.write("ref\t" + ref[i : i + 60] + "\n")
            sys.stdout.write(
                "alt\t" + "".join(alt_raw[j] if snp[j] else " " for j in blk)
                + "\n\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
