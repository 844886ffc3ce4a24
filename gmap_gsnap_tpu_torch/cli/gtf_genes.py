"""gtf_genes: extract a genes map from GTF annotations
(util/gtf_genes.pl.in).

A copy of gmap_gsnap_tpu/cli/gtf_genes.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..utils import annot

    lines = sys.stdin if argv is None or not argv else open(argv[0])
    transcripts = annot.parse_gtf(lines)
    sys.stdout.write(annot.genes_text(
        transcripts, min_exons=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
