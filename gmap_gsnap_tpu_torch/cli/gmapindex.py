"""gmap_build-style database construction CLI.

One command replaces the reference's gmap_setup/gmap_build pipeline
(fa_coords | gmap_process | gmapindex -A/-G/-O/-P):

    python -m gmap_gsnap_tpu_torch.cli.gmapindex -d <db> -D <destdir> [-k 12] <fasta...>

A copy of gmap_gsnap_tpu/cli/gmapindex.py, with the same flags and defaults.
"""

from __future__ import annotations

import argparse
import sys


def _compress(infile) -> int:
    """gmapindex -C: nucleotide text (non-alpha skipped) -> genomecomp
    blocks on stdout (Compress_compress, compress.c: N = flag, X =
    T+flag, other alpha = N with a warning; trailing block pads X)."""
    import numpy as np

    from ..db import genomecomp

    data = infile.read()
    if isinstance(data, str):
        data = data.encode("latin-1")
    b = np.frombuffer(data, np.uint8)
    up = np.where((b >= 97) & (b <= 122), b - 32, b)
    alpha = ((up >= 65) & (up <= 90))
    up = up[alpha]
    codes = np.zeros(len(up), np.uint8)
    flags = np.zeros(len(up), bool)
    for ch, (code, flag) in {"A": (0, False), "C": (1, False),
                             "G": (2, False), "T": (3, False),
                             "U": (3, False), "N": (0, True),
                             "X": (3, True)}.items():
        m = up == ord(ch)
        codes[m] = code
        flags[m] = flag
    known = np.isin(up, np.frombuffer(b"ACGTUNX", np.uint8))
    flags[~known] = True
    words = genomecomp.pack(codes, flags)
    sys.stdout.buffer.write(words.astype("<u4").tobytes())
    return 0


def _uncompress(infile, wraplength: int) -> int:
    """gmapindex -U [-w n]: genomecomp blocks -> nucleotide text
    (Compress_uncompress; trailing X padding prints)."""
    import numpy as np

    from ..db import genomecomp

    data = infile.read()
    words = np.frombuffer(data, "<u4")
    nblocks = len(words) // 3
    codes, flags = genomecomp.unpack(words[: nblocks * 3])
    chars = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    chars[flags & (codes == 3)] = ord("X")
    chars[flags & (codes != 3)] = ord("N")
    text = chars.tobytes().decode("latin-1")
    out = sys.stdout
    if wraplength and wraplength > 0:
        for i in range(0, len(text), wraplength):
            out.write(text[i : i + wraplength] + "\n")
    else:
        out.write(text)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gmapindex")
    p.add_argument("-C", dest="compress", action="store_true",
                   help="compress nucleotide text to genomecomp blocks")
    p.add_argument("-U", dest="uncompress", action="store_true",
                   help="uncompress genomecomp blocks to text")
    p.add_argument("-w", "--wraplength", type=int, default=0)
    p.add_argument("-d", "--db")
    p.add_argument("-D", "--destdir", default=".")
    p.add_argument("-k", "--kmer", type=int, default=12)
    p.add_argument("-b", "--basesize", type=int, default=None)
    p.add_argument("-q", "--interval", type=int, default=3)
    p.add_argument("--sort", default="none", choices=["none", "alpha", "chrom"])
    p.add_argument("fasta", nargs="*")
    args = p.parse_args(argv)

    if args.compress or args.uncompress:
        if args.fasta:
            mode = "rb"
            f = open(args.fasta[0], mode)
        else:
            f = sys.stdin.buffer
        try:
            return (_compress(f) if args.compress
                    else _uncompress(f, args.wraplength))
        finally:
            if args.fasta:
                f.close()
    if not args.db or not args.fasta:
        p.error("need -d and fasta inputs (or -C/-U)")

    from ..db import build
    from ..db.iit import NO_SORT, ALPHA_SORT, CHROM_SORT

    sort = {"none": NO_SORT, "alpha": ALPHA_SORT, "chrom": CHROM_SORT}[args.sort]
    dbdir = build.build_db(
        args.fasta, args.db, args.destdir,
        k=args.kmer, basesize=args.basesize, interval=args.interval, sort=sort,
    )
    print(f"built {dbdir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
