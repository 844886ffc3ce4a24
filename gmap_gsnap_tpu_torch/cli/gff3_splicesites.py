"""gff3_splicesites: extract splicesites from GFF3 annotations (util/gff3_splicesites.pl.in).

A copy of gmap_gsnap_tpu/cli/gff3_splicesites.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..utils import annot

    lines = sys.stdin if argv is None or not argv else open(argv[0])
    transcripts = annot.parse_gff3(lines)
    fn = annot.splicesites_text
    sys.stdout.write(fn(transcripts))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
