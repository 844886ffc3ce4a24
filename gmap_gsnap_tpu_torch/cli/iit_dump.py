"""iit_dump: dump an IIT file back to its text form.

Usage: python -m gmap_gsnap_tpu_torch.cli.iit_dump <file.iit>

A copy of gmap_gsnap_tpu/cli/iit_dump.py.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: iit_dump <file.iit>", file=sys.stderr)
        return 9
    from ..db.iit import IIT

    iit = IIT.read(argv[0])
    sys.stdout.write(iit.dump())
    return 0


if __name__ == "__main__":
    sys.exit(main())
