"""gff3_introns: extract introns from GFF3 annotations (util/gff3_introns.pl.in).

A copy of gmap_gsnap_tpu/cli/gff3_introns.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..utils import annot

    lines = sys.stdin if argv is None or not argv else open(argv[0])
    transcripts = annot.parse_gff3(lines)
    fn = annot.introns_text
    sys.stdout.write(fn(transcripts))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
