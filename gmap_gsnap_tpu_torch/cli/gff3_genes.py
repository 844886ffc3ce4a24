"""gff3_genes: extract a genes map from GFF3 annotations
(util/gff3_genes.pl.in).

A copy of gmap_gsnap_tpu/cli/gff3_genes.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..utils import annot

    lines = sys.stdin if argv is None or not argv else open(argv[0])
    transcripts = annot.parse_gff3(lines)
    sys.stdout.write(annot.genes_text(
        transcripts, min_exons=2))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
