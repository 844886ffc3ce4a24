"""gmap_process: normalize FASTA against a coords file for gmapindex
(util/gmap_process.pl.in).  Emits '>contig\\tcoords\\t0' headers +
60-column uppercase sequence — byte-compatible with the reference
pipeline (gmap_process | gmapindex).

A copy of gmap_gsnap_tpu/cli/gmap_process.py, with the same flags and defaults.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..io import fasta

    p = argparse.ArgumentParser(prog="gmap_process")
    p.add_argument("-c", "--coords", required=True)
    p.add_argument("fastas", nargs="+")
    args = p.parse_args(argv)

    coords = {}
    for line in open(args.coords):
        if line.startswith("#") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        coords[f[0]] = f[1]

    out = sys.stdout
    for path in args.fastas:
        for rec in fasta.read_fasta(path):
            if rec.label not in coords:
                continue
            out.write(f">{rec.label}\t{coords[rec.label]}\t0\n")
            seq = rec.seq.upper()
            for i in range(0, len(seq), 60):
                out.write(seq[i : i + 60] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
