"""Interval Index Tree (IIT) binary format: the reader.

The reading half of gmap_gsnap_tpu/db/iit.py (the port opens databases;
it writes, queries and dumps no IIT).  Binary-compatible with the
reference format (genome-vendor/gmap-gsnap, src/iit-write.c:373-406
file-format comment, src/iit-read.c readers):

  header:   [0, version]           (version >= 2 only)
            [label_ptr_size, annot_ptr_size]  (version >= 5 only)
            total_nintervals, ntypes
            nfields                (version >= 2)
            ndivs, nintervals[ndivs], cum_nintervals[ndivs+1]   (version >= 3)
            nnodes[ndivs]
            cum_nnodes[ndivs+1]    (version >= 3)
            divsort                (version >= 3)
            divpointers[ndivs+1], div strings   (version >= 3)
  per div:  alphas, betas          (version >= 2)  [each nintervals+1 ints]
            sigmas, omegas         [each nintervals+1 ints]
            fnodes                 [nnodes * 5 ints: value,a,b,left,right]
  footer:   intervals (low, high, sign [v>=2], type)
            typepointers, types
            fieldpointers, fields  (version >= 2)
            labelorder, labelpointers, labels
            annotpointers, annotations

All integers little-endian; intervals are stored with uint32 low/high.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

NO_SORT, CHROM_SORT = 0, 3
LATEST_VERSION = 5


@dataclass
class Interval:
    low: int
    high: int
    sign: int = 0
    type: int = 0


@dataclass
class IIT:
    """An in-memory IIT: divisions, typed/labeled/annotated intervals."""

    version: int = LATEST_VERSION
    divsort: int = CHROM_SORT
    divs: list[str] = field(default_factory=lambda: [""])
    types: list[str] = field(default_factory=lambda: [""])
    fields: list[str] = field(default_factory=list)
    # per-div parallel lists
    intervals: dict[str, list[Interval]] = field(default_factory=dict)
    labels: dict[str, list[str]] = field(default_factory=dict)
    annotations: dict[str, list[bytes]] = field(default_factory=dict)

    # ------------------------------------------------------------------- read
    @classmethod
    def read(cls, path: str) -> "IIT":
        with open(path, "rb") as f:
            buf = f.read()
        pos = [0]

        def ri(n=None):
            m = 1 if n is None else n
            vals = struct.unpack_from(f"<{m}i", buf, pos[0])
            pos[0] += 4 * m
            return vals[0] if n is None else list(vals)

        def ru(n=None):
            m = 1 if n is None else n
            vals = struct.unpack_from(f"<{m}I", buf, pos[0])
            pos[0] += 4 * m
            return vals[0] if n is None else list(vals)

        first = ri()
        label_ptr_size = annot_ptr_size = 4
        if first == 0:
            version = ri()
            if version >= 5:
                label_ptr_size = ri()
                annot_ptr_size = ri()
            total = ri()
        else:
            version = 1
            total = first
        ntypes = ri()
        nfields = ri() if version >= 2 else 0
        if version >= 3:
            ndivs = ri()
            nintervals = ri(ndivs)
            ri(ndivs + 1)  # cum_nintervals
        else:
            ndivs = 1
            nintervals = [total]
        nnodes = ri(ndivs)
        if version >= 3:
            ri(ndivs + 1)  # cum_nnodes
            divsort = ri()
            divptrs = ru(ndivs + 1)
            strlen_total = divptrs[-1]
            raw = buf[pos[0] : pos[0] + strlen_total]
            pos[0] += strlen_total
            divs = [
                raw[divptrs[i] : divptrs[i + 1] - 1].decode() for i in range(ndivs)
            ]
        else:
            divsort = NO_SORT
            divs = [""]

        iit = cls(version=version, divsort=divsort, divs=list(divs))

        for di in range(ndivs):
            n = nintervals[di]
            if version >= 2:
                ri(n + 1)  # alphas
                ri(n + 1)  # betas
            ri(n + 1)  # sigmas
            ri(n + 1)  # omegas
            pos[0] += nnodes[di] * 20  # fnodes, rebuilt on write

        all_ivs: list[Interval] = []
        for di in range(ndivs):
            for _ in range(nintervals[di]):
                low = ru()
                high = ru()
                sign = ri() if version >= 2 else (1 if low < high else 0)
                typ = ri()
                all_ivs.append(Interval(low, high, sign, typ))

        typeptrs = ru(ntypes + 1)
        raw = buf[pos[0] : pos[0] + typeptrs[-1]]
        pos[0] += typeptrs[-1]
        iit.types = [raw[typeptrs[i] : typeptrs[i + 1] - 1].decode() for i in range(ntypes)]

        if version >= 2:
            fieldptrs = ru(nfields + 1)
            raw = buf[pos[0] : pos[0] + fieldptrs[-1]]
            pos[0] += fieldptrs[-1]
            iit.fields = [
                raw[fieldptrs[i] : fieldptrs[i + 1] - 1].decode() for i in range(nfields)
            ]

        ri(total)  # labelorder (recomputed on demand)
        if label_ptr_size == 8:
            labelptrs = list(struct.unpack_from(f"<{total+1}Q", buf, pos[0]))
            pos[0] += 8 * (total + 1)
        else:
            labelptrs = ru(total + 1)
        raw = buf[pos[0] : pos[0] + labelptrs[-1]]
        pos[0] += labelptrs[-1]
        labels = [raw[labelptrs[i] : labelptrs[i + 1] - 1].decode() for i in range(total)]

        if annot_ptr_size == 8:
            annotptrs = list(struct.unpack_from(f"<{total+1}Q", buf, pos[0]))
            pos[0] += 8 * (total + 1)
        else:
            annotptrs = ru(total + 1)
        raw = buf[pos[0] : pos[0] + annotptrs[-1]]
        annots = [raw[annotptrs[i] : annotptrs[i + 1] - 1] for i in range(total)]

        k = 0
        for di, d in enumerate(divs):
            n = nintervals[di]
            iit.intervals[d] = all_ivs[k : k + n]
            iit.labels[d] = labels[k : k + n]
            iit.annotations[d] = annots[k : k + n]
            k += n
        return iit
