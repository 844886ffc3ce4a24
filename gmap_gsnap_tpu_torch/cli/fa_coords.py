"""fa_coords: FASTA headers -> coords file (util/fa_coords.pl.in).

A copy of gmap_gsnap_tpu/cli/fa_coords.py, with the same flags and defaults.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..db import build

    p = argparse.ArgumentParser(prog="fa_coords")
    p.add_argument("-o", "--output", default="coords.txt")
    p.add_argument("fastas", nargs="+")
    args = p.parse_args(argv)
    text = build.fa_coords_text(args.fastas)
    with open(args.output, "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
