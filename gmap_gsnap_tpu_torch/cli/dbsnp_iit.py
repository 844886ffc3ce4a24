"""dbsnp_iit: UCSC dbSNP dump -> SNPs map text (util/dbsnp_iit.pl.in).

A copy of gmap_gsnap_tpu/cli/dbsnp_iit.py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..utils import annot

    p = argparse.ArgumentParser(prog="dbsnp_iit")
    p.add_argument("-c", "--chr", default=None, help="restrict to chromosome")
    p.add_argument("-w", "--weight", type=int, default=1,
                   help="max item weight (1 = most confident)")
    p.add_argument("input", nargs="?", default=None)
    args = p.parse_args(argv)
    lines = sys.stdin if args.input is None else open(args.input)
    sys.stdout.write(annot.dbsnp_text(lines, args.chr, args.weight))
    return 0


if __name__ == "__main__":
    sys.exit(main())
