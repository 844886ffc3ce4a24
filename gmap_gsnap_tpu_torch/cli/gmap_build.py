"""gmap_build: one-shot genome database construction (util/gmap_build.pl.in:
fa_coords -> gmap_process | gmapindex -A/-G/-O/-P, all in-process).

A copy of gmap_gsnap_tpu/cli/gmap_build.py, with the same flags and defaults.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..db import build

    p = argparse.ArgumentParser(prog="gmap_build")
    p.add_argument("-d", "--db", required=True, help="genome name")
    p.add_argument("-D", "--dir", default=".", help="destination directory")
    p.add_argument("-k", "--kmer", type=int, default=12)
    p.add_argument("-q", "--sampling", type=int, default=3)
    p.add_argument("-b", "--basesize", type=int, default=None)
    p.add_argument("fastas", nargs="+")
    args = p.parse_args(argv)
    dbdir = build.build_db(
        args.fastas, args.db, args.dir, k=args.kmer, interval=args.sampling,
        basesize=args.basesize,
    )
    print(f"built {args.db} in {dbdir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
