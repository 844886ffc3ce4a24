"""iit_store: build an IIT file from FASTA-like interval text.

Usage: python -m gmap_gsnap_tpu_torch.cli.iit_store -o <output> [input]
Mirrors the reference iit_store (src/iit_store.c) new-format parser.

A copy of gmap_gsnap_tpu/cli/iit_store.py, with the same flags and defaults.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="iit_store")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--sort", default="chrom",
                   choices=["none", "alpha", "numeric-alpha", "chrom"])
    p.add_argument("-v", "--version", type=int, default=5)
    p.add_argument("input", nargs="?")
    args = p.parse_args(argv)

    from ..db.iit import ALPHA_SORT, CHROM_SORT, NO_SORT, NUMERIC_ALPHA_SORT
    from ..db.iit_text import iit_from_text

    sort = {
        "none": NO_SORT, "alpha": ALPHA_SORT,
        "numeric-alpha": NUMERIC_ALPHA_SORT, "chrom": CHROM_SORT,
    }[args.sort]
    text = open(args.input).read() if args.input else sys.stdin.read()
    iit = iit_from_text(text, divsort=sort, version=args.version)
    out = args.output if args.output.endswith(".iit") else args.output + ".iit"
    iit.write(out, version=args.version)
    return 0


if __name__ == "__main__":
    sys.exit(main())
