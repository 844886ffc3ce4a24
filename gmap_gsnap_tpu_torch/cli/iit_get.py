"""iit_get: query an IIT file by coordinates or label.

Usage: python -m gmap_gsnap_tpu_torch.cli.iit_get <file.iit> <coord> [<coord2>]
       python -m gmap_gsnap_tpu_torch.cli.iit_get <file.iit> <div>:<start>..<end>

A copy of gmap_gsnap_tpu/cli/iit_get.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: iit_get <file.iit> <coord> [coord2]", file=sys.stderr)
        return 9
    from ..db.iit import IIT
    from ..db.iit_text import iit_get_text, parse_coords

    iit = IIT.read(argv[0])
    if ".." in argv[1] or ":" in argv[1]:
        div, x, y = parse_coords(argv[1])
    else:
        div, x = "", int(argv[1])
        y = int(argv[2]) if len(argv) > 2 else x
    sys.stdout.write(iit_get_text(iit, div, x, y))
    return 0


if __name__ == "__main__":
    sys.exit(main())
