"""Interval Index Tree (IIT) binary format: the reader and the writer.

A copy of gmap_gsnap_tpu/db/iit.py without its queries and dumps: the
port opens databases and maps, and writes splice-site and SNP maps
(db/iit_text.py).  Binary-compatible with the
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

The interval-tree construction replicates the reference algorithm
(Node_make, src/iit-write.c:206-265) so written trees are structurally
identical.

All integers little-endian; intervals are stored with uint32 low/high.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

NO_SORT, ALPHA_SORT, NUMERIC_ALPHA_SORT, CHROM_SORT = 0, 1, 2, 3
LATEST_VERSION = 5


@dataclass
class Interval:
    low: int
    high: int
    sign: int = 0
    type: int = 0

    @classmethod
    def new(cls, start: int, end: int, type: int = 0) -> "Interval":
        # Interval_new (src/interval.c:37-56): normalizes low<=high, keeps sign
        if start < end:
            return cls(start, end, +1, type)
        if start > end:
            return cls(end, start, -1, type)
        return cls(start, end, 0, type)


def _chrom_sort_key(name: str):
    """CHROM_SORT ordering (src/chrom.c): numeric chromosomes first in
    numeric order, then X, Y, M/MT, then others alphabetically."""
    s = name
    for prefix in ("chr", "Chr", "CHR"):
        if s.startswith(prefix):
            s = s[len(prefix):]
            break
    # split leading numeric part
    if s[:1].isdigit():
        i = 0
        while i < len(s) and s[i].isdigit():
            i += 1
        return (0, int(s[:i]), s[i:])
    if s in ("X",):
        return (1, 0, s)
    if s in ("Y",):
        return (2, 0, s)
    if s in ("M", "MT"):
        return (3, 0, s)
    return (4, 0, s)


class _Node:
    __slots__ = ("value", "a", "b", "left", "right", "index")

    def __init__(self):
        self.value = 0
        self.a = 0
        self.b = 0
        self.left = None
        self.right = None
        self.index = -1


def _build_tree(intervals: list[Interval]):
    """Replicates IIT_build_one_div (src/iit-write.c:323-369).

    Returns (alphas, betas, sigmas, omegas, fnodes) where fnodes is a list of
    (value, a, b, leftindex, rightindex) in DFS (pre-order) storage order.
    All of alphas/betas/sigmas/omegas are 1-based arrays of length n+1 with
    [0] == 0.
    """
    n = len(intervals)
    lows = [iv.low for iv in intervals]
    highs = [iv.high for iv in intervals]

    def sort_by_low(idx_list):
        return sorted(idx_list, key=lambda i: lows[i - 1])

    def sort_by_high(idx_list):
        return sorted(idx_list, key=lambda i: highs[i - 1])

    alphas = [0] + sort_by_low(list(range(1, n + 1)))
    betas = [0] + sort_by_high(list(range(1, n + 1)))
    sigmas = [0] + sort_by_low(list(range(1, n + 1)))
    omegas = [0] * (n + 1)

    def contained(x: int, index: int) -> bool:
        return lows[index - 1] <= x <= highs[index - 1]

    nodes = []

    def node_make(i: int, j: int):
        if i > j:
            return None
        node = _Node()
        nodes.append(node)
        # node_select (iit-write.c:177-204)
        r = j - (j - i) // 3
        k = lows[sigmas[r] - 1]
        while r < j and lows[sigmas[r + 1] - 1] == k:
            r += 1
        if not contained(k, sigmas[r]):
            while r > i and not contained(k, sigmas[r - 1]):
                r -= 1
            if not contained(k, sigmas[r]):
                r -= 1
        node.value = k
        # mark "contains" intervals from sigma[i..r] into omega
        q = r
        for lam in range(r, i - 1, -1):
            if contained(node.value, sigmas[lam]):
                omegas[q] = sigmas[lam]
                sigmas[lam] = 0
                q -= 1
        # compact remaining "left of" intervals
        iota = i
        for lam in range(i, r + 1):
            if sigmas[lam] != 0:
                sigmas[iota] = sigmas[lam]
                iota += 1
        # copy back and sort omegas[q+1..r] by high
        for lam in range(q + 1, r + 1):
            sigmas[lam] = omegas[lam]
        omegas[q + 1 : r + 1] = sort_by_high(omegas[q + 1 : r + 1])
        node.a = q + 1
        node.b = r
        node.left = node_make(i, q)
        node.right = node_make(r + 1, j)
        return node

    root = node_make(1, n) if n > 0 else None

    # Node_index: pre-order numbering
    counter = [0]

    def assign_index(node):
        if node is not None:
            node.index = counter[0]
            counter[0] += 1
            assign_index(node.left)
            assign_index(node.right)

    assign_index(root)

    fnodes: list[tuple[int, int, int, int, int]] = []

    def store(node):
        if node is not None:
            fnodes.append(
                (
                    node.value,
                    node.a,
                    node.b,
                    node.left.index if node.left else -1,
                    node.right.index if node.right else -1,
                )
            )
            store(node.left)
            store(node.right)

    store(root)
    return alphas, betas, sigmas, omegas, fnodes


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

    # ------------------------------------------------------------------ build
    def add(self, div: str, label: str, interval: Interval, annotation: bytes = b"") -> None:
        if div not in self.intervals:
            if div != "" and div not in self.divs:
                self.divs.append(div)
            self.intervals[div] = []
            self.labels[div] = []
            self.annotations[div] = []
        self.intervals[div].append(interval)
        self.labels[div].append(label)
        self.annotations[div].append(annotation)

    def type_index(self, typestring: str) -> int:
        if typestring not in self.types:
            self.types.append(typestring)
        return self.types.index(typestring)

    def sorted_divs(self) -> list[str]:
        """Division order as written: empty div first, then proper divs in
        divsort order (iit_store.c:901-940)."""
        proper = [d for d in self.divs if d != ""]
        if self.divsort == ALPHA_SORT:
            proper = sorted(proper)
        elif self.divsort == CHROM_SORT:
            proper = sorted(proper, key=_chrom_sort_key)
        elif self.divsort == NUMERIC_ALPHA_SORT:
            proper = sorted(proper, key=_chrom_sort_key)
        return [""] + proper

    # ------------------------------------------------------------------ write
    def write(self, path: str, version: int | None = None) -> None:
        version = self.version if version is None else version
        divs = self.sorted_divs()
        if version < 3:
            # Old format supports only one division; flatten in div order.
            flat_ivs: list[Interval] = []
            flat_labels: list[str] = []
            flat_annots: list[bytes] = []
            for d in divs:
                flat_ivs.extend(self.intervals.get(d, []))
                flat_labels.extend(self.labels.get(d, []))
                flat_annots.extend(self.annotations.get(d, []))
            divs = [""]
            per_div = {"": (flat_ivs, flat_labels, flat_annots)}
        else:
            per_div = {
                d: (
                    self.intervals.get(d, []),
                    self.labels.get(d, []),
                    self.annotations.get(d, []),
                )
                for d in divs
            }

        nintervals = [len(per_div[d][0]) for d in divs]
        total = sum(nintervals)
        cum_niv = np.concatenate([[0], np.cumsum(nintervals)]).astype(np.int32)

        built = {d: _build_tree(per_div[d][0]) for d in divs}
        nnodes = [len(built[d][4]) for d in divs]
        cum_nn = np.concatenate([[0], np.cumsum(nnodes)]).astype(np.int32)

        out = bytearray()

        def wi(*vals):
            out.extend(struct.pack(f"<{len(vals)}i", *vals))

        def wu(*vals):
            out.extend(struct.pack(f"<{len(vals)}I", *vals))

        if version >= 2:
            wi(0, version)
        if version >= 5:
            wi(4, 4)  # label/annot pointer sizes (4-byte)
        wi(total, len(self.types))
        if version >= 2:
            wi(len(self.fields))
        if version >= 3:
            wi(len(divs))
            wi(*nintervals)
            wi(*cum_niv.tolist())
        wi(*nnodes)
        if version >= 3:
            wi(*cum_nn.tolist())
            wi(self.divsort)
            ptr = 0
            wu(ptr)
            for d in divs:
                ptr += len(d.encode()) + 1
                wu(ptr)
            for d in divs:
                out.extend(d.encode() + b"\0")

        for d in divs:
            alphas, betas, sigmas, omegas, fnodes = built[d]
            if version >= 2:
                wi(*alphas)
                wi(*betas)
            wi(*sigmas)
            wi(*omegas)
            for value, a, b, li, ri in fnodes:
                wu(value)
                wi(a, b, li, ri)

        # footer: intervals
        for d in divs:
            for iv in per_div[d][0]:
                wu(iv.low & 0xFFFFFFFF, iv.high & 0xFFFFFFFF)
                if version >= 2:
                    wi(iv.sign)
                wi(iv.type)

        # typepointers + types
        ptr = 0
        wu(ptr)
        for t in self.types:
            ptr += len(t.encode()) + 1
            wu(ptr)
        for t in self.types:
            out.extend(t.encode() + b"\0")

        if version >= 2:
            ptr = 0
            wu(ptr)
            for f in self.fields:
                ptr += len(f.encode()) + 1
                wu(ptr)
            for f in self.fields:
                out.extend(f.encode() + b"\0")

        # labelorder: global record numbers sorted by label (strcmp on bytes)
        flat_labels: list[str] = []
        for d in divs:
            flat_labels.extend(per_div[d][1])
        order = sorted(range(total), key=lambda i: flat_labels[i].encode())
        wi(*order)

        ptr = 0
        wu(ptr)
        for lab in flat_labels:
            ptr += len(lab.encode()) + 1
            wu(ptr)
        for lab in flat_labels:
            out.extend(lab.encode() + b"\0")

        flat_annots: list[bytes] = []
        for d in divs:
            flat_annots.extend(per_div[d][2])
        ptr = 0
        wu(ptr)
        for ann in flat_annots:
            ptr += len(ann) + 1
            wu(ptr)
        for ann in flat_annots:
            out.extend(ann + b"\0")

        with open(path, "wb") as f:
            f.write(bytes(out))

    # ------------------------------------------------------------------- read

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

    def divs_in_file_order(self) -> list[str]:
        return list(self.divs)
