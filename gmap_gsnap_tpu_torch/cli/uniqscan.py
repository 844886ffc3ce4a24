"""uniqscan: minimal unique alignment length scanner (src/uniqscan.c).

Prints "sublength: npaths" per prefix length, starting at index1part+2
and stopping once a unique alignment is found (uniqueness_scan,
uniqscan.c:378-452).  Instead of re-running the engine per prefix, ALL
prefix lengths align in one device batch (rows = prefixes), and the scan
walks the npaths vector.

A copy of gmap_gsnap_tpu/cli/uniqscan.py with --device added: cuda (the
default) runs the cascade's kernels, and the GMAP lanes' where a row asks
for them; cpu runs their plain versions.  A missing card exits 2; there
is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(prog="uniqscan")
    p.add_argument("-D", "--dir", required=True)
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-3", "--from-right", action="store_true", dest="from_right",
                   help="scan suffixes instead of prefixes")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (plain torch "
                        "versions of the kernels)")
    p.add_argument("sequence")
    args = p.parse_args(argv)

    from ..align import runner as runner_mod
    from ..db.datadir import GenomeDB
    from ..ops import mismatch as mismatch_mod
    from ..utils.device import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"uniqscan: {e}", file=sys.stderr)
        return 2
    seq = args.sequence.upper()
    full = len(seq)
    if args.device != "cpu" and full > mismatch_mod.CUDA_MAX_READ_LENGTH:
        print(f"uniqscan: a sequence of {full} bases is longer than the "
              f"CUDA kernels take ({mismatch_mod.CUDA_MAX_READ_LENGTH}); run "
              f"with --device cpu", file=sys.stderr)
        return 2
    db = GenomeDB.open(
        args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}",
        args.db,
    )
    minlen = db.k + 2
    if full < minlen:
        return 0

    lengths = np.arange(minlen, full + 1, dtype=np.int32)
    records = []
    for sublen in lengths:
        sub = seq[full - sublen :] if args.from_right else seq[:sublen]
        records.append(
            runner_mod.Record(f"prefix{sublen}", f"prefix{sublen}", sub))

    # all prefixes align in ONE device batch, then each row runs the
    # full rescue ladder (end indels / terminals / distant / GMAP) so
    # npaths matches the complete single-read engine the reference's
    # uniqueness_scan invokes (uniqscan.c:378-452)
    runner = runner_mod.GsnapRunner(db, lmax=full, device=args.device)
    hits = runner.align_records(records)
    for i, sublen in enumerate(lengths):
        final = runner._rescued_hits(
            records[i], hits, i, int(hits["npaths"][i]), maxpaths=100)
        npaths = len(final)
        print(f"{sublen}: {npaths}")
        if npaths <= 1:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
