"""cmetindex: build bisulfite (C->T / G->A) indexes for a database.

Usage: python -m gmap_gsnap_tpu_torch.cli.cmetindex -D <dir> -d <db> [-k 12]
Writes <db>.metct*/<db>.metga* index files (cmetindex.c naming); a copy
of gmap_gsnap_tpu/cli/cmetindex.py on the port's host GenomeDB.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, kind: str = "cmet") -> int:
    p = argparse.ArgumentParser(prog=f"{kind}index")
    p.add_argument("-D", "--dir", required=True)
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-k", "--kmer", type=int, default=None)
    p.add_argument("-q", "--interval", type=int, default=None)
    args = p.parse_args(argv)

    from ..db import transforms
    from ..db.datadir import GenomeDB

    dbdir = args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}"
    db = GenomeDB.open(dbdir, args.db)
    k = args.kmer or db.k or 12
    q = args.interval or db.interval or 3
    transforms.write_converted_indexes(
        db.dbdir, db.dbname, db.codes, db.flags, db.chr_ends, kind, k=k, interval=q
    )
    print(f"wrote {kind} indexes for {db.dbname} (k={k}, q={q})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
