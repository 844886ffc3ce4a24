"""snpindex: build a SNP-tolerant index from a SNPs IIT.

Usage: python -m gmap_gsnap_tpu_torch.cli.snpindex -D <dir> -d <db> -v <snpsdb> <snps.iit>
Writes <db>.<snps>.genomecomp (minor-allele genome) and
<db>.ref.<snps>* index files (snpindex.c / README:1084-1093).

A copy of gmap_gsnap_tpu/cli/snpindex.py, with the same flags and defaults;
it reuses the database's k-mer index instead of building it again.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="snpindex")
    p.add_argument("-D", "--dir", required=True)
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-v", "--snpsdb", required=True, help="name for the SNP index")
    p.add_argument("snps_iit")
    args = p.parse_args(argv)

    from ..db.datadir import GenomeDB
    from ..db.iit import IIT
    from ..db import transforms

    dbdir = args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}"
    db = GenomeDB.open(dbdir, args.db)
    snps = IIT.read(args.snps_iit)
    alt = transforms.alt_genome_from_snps(db.codes, snps, db.chr_names, db.chr_starts)
    # the database's own index is the reference index the SNP index
    # merges into (the JAX tool builds it again: the same arrays)
    ref_index = ((db.offsets, db.positions) if db.k and db.interval
                 else None)
    transforms.write_snp_index(
        db.dbdir, db.dbname, args.snpsdb, db.codes, db.flags, db.chr_ends, alt,
        k=db.k or 12, basesize=db.basesize or None, interval=db.interval or 3,
        ref_index=ref_index,
    )
    nsubst = int((alt != db.codes).sum())
    print(f"wrote SNP-tolerant index {args.snpsdb} ({nsubst} substitutions)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
