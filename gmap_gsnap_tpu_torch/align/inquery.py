"""Query oligo-composition diagnostics for GMAP input pruning.

Replicates Oligoindex_set_inquery (reference src/oligoindex.c:728) with
its changepoint edge detectors (edge_detect :491, trim_start_detect
:571, trim_end_detect :645) over 8-mer counts, and the poor/repetitive
classification thresholds used by gmap's -p/--prunelevel
(src/gmap.c:68-70, :2046-2062).

Vectorized NumPy over the prefix sums; the detectors scan with the
exact sequential min-RSS tie-breaking of the reference.

A copy of gmap_gsnap_tpu/align/inquery.py; the port's modules stand behind its
relative imports.
"""

from __future__ import annotations

import numpy as np

INDEXSIZE = 8  # oligoindices_major[0] for GMAP (oligoindex.c:81)
THETADIFF1 = 20.0  # oligoindex.c:104
THETADIFF2 = 20.0  # oligoindex.c:105
REPOLIGOCOUNT = 8  # oligoindex.c:106
MAX_OLIGODEPTH = 3.0  # gmap.c:68
MAX_BADOLIGOS = 0.30  # gmap.c:69
MAX_REPOLIGOS = 0.40  # gmap.c:70

_CODE = np.full(256, -1, np.int64)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i


def _oligo_stream(q: np.ndarray, indexsize: int):
    """Per-position masked oligo values and validity, mimicking the
    reference's shift-register scan (oligo resets on non-ACGT)."""
    n = len(q)
    codes = _CODE[q]
    oligos = np.zeros(n, np.int64)
    valid = np.zeros(n, bool)
    oligo = 0
    in_counter = 0
    mask = (1 << (2 * indexsize)) - 1
    for i in range(n):
        c = codes[i]
        in_counter += 1
        if c < 0:
            oligo = 0
            in_counter = 0
        else:
            oligo = ((oligo << 2) | int(c)) & 0xFFFFFFFF
        if in_counter == indexsize:
            oligos[i] = oligo & mask
            valid[i] = True
            in_counter -= 1
    return oligos, valid


def _edge_detect(sumx: np.ndarray, sumxx: np.ndarray, length: int):
    """oligoindex.c:491 — returns (side, edge); side -1=5', +1=3', 0=none."""
    side, edge = 0, -1
    sumx_right = sumx[length] - sumx[0]
    theta = sumx_right / length
    min_rss_sep = (sumxx[length] - sumxx[0]) - sumx_right * theta
    n_left, n_right = 1, length - 1
    for pos in range(1, length):
        sxl = sumx[pos] - sumx[0]
        sxxl = sumxx[pos] - sumxx[0]
        sxr = sumx[length] - sumx[pos]
        sxxr = sumxx[length] - sumxx[pos]
        theta_left = sxl / n_left
        theta_right = sxr / n_right
        rss_sep = (sxxl - sxl * theta_left) + (sxxr - sxr * theta_right)
        if theta_left > theta_right + THETADIFF1:
            if rss_sep < min_rss_sep:
                min_rss_sep, edge, side = rss_sep, pos, -1
        elif theta_right > theta_left + THETADIFF1:
            if rss_sep < min_rss_sep:
                min_rss_sep, edge, side = rss_sep, pos, +1
        n_left += 1
        n_right -= 1
    return side, edge


def _trim_start_detect(start: int, end: int, sumx, sumxx):
    """oligoindex.c:571."""
    edge = -1
    if end <= start:
        return -1
    sumx_right = sumx[end] - sumx[start]
    theta = sumx_right / (end - start)
    min_rss_sep = (sumxx[end] - sumxx[start]) - sumx_right * theta
    n_left, n_right = 1, end - (start + 1)
    for pos in range(start + 1, end):
        sxl = sumx[pos] - sumx[start]
        sxxl = sumxx[pos] - sumxx[start]
        sxr = sumx[end] - sumx[pos]
        sxxr = sumxx[end] - sumxx[pos]
        theta_left = sxl / n_left
        theta_right = sxr / n_right if n_right else 0.0
        rss_sep = (sxxl - sxl * theta_left) + (sxxr - sxr * theta_right)
        if theta_left < theta_right:
            return edge
        elif theta_left > theta_right + THETADIFF2:
            if rss_sep < min_rss_sep:
                min_rss_sep, edge = rss_sep, pos
        n_left += 1
        n_right -= 1
    return edge


def _trim_end_detect(start: int, end: int, sumx, sumxx):
    """oligoindex.c:645."""
    edge = -1
    if end <= start:
        return -1
    sumx_right = sumx[end] - sumx[start]
    theta = sumx_right / (end - start)
    min_rss_sep = (sumxx[end] - sumxx[start]) - sumx_right * theta
    n_left, n_right = end - (start + 1), 1
    for pos in range(end - 1, start, -1):
        sxl = sumx[pos] - sumx[start]
        sxxl = sumxx[pos] - sumxx[start]
        sxr = sumx[end] - sumx[pos]
        sxxr = sumxx[end] - sumxx[pos]
        theta_left = sxl / n_left if n_left else 0.0
        theta_right = sxr / n_right
        rss_sep = (sxxl - sxl * theta_left) + (sxxr - sxr * theta_right)
        if theta_right < theta_left:
            return edge
        elif theta_right > theta_left + THETADIFF2:
            if rss_sep < min_rss_sep:
                min_rss_sep, edge = rss_sep, pos
        n_left -= 1
        n_right += 1
    return edge


def set_inquery(query: str, indexsize: int = INDEXSIZE):
    """Returns (oligodepth, badoligos, repoligos, trimoligos,
    trim_start, trim_end) per Oligoindex_set_inquery with trimp=true
    (oligoindex.c:728)."""
    q = np.frombuffer(query.upper().encode(), np.uint8)
    n = len(q)
    if n <= indexsize:
        return 1.0, 0, 0, 0, 0, n

    oligos, valid = _oligo_stream(q, indexsize)
    vo = oligos[valid]
    noligos = int(valid.sum())
    counts = np.zeros(1 << (2 * indexsize), np.int64)
    np.add.at(counts, vo, 1)
    nunique = int((counts > 0).sum())

    # Changepoint trim over x = counts[oligo at querypos] (1 when the
    # window is invalid); querypos = i - (indexsize - 1) for scan
    # index i, so x at querypos qp is x[qp + indexsize - 1].
    m = n - indexsize  # slots 0..m; the loop fills 0..m-1 inclusively
    x = np.ones(n, np.int64)
    x[valid] = counts[oligos[valid]]
    xs = x[indexsize - 1:]
    sumx = np.zeros(m + 1, np.int64)
    sumxx = np.zeros(m + 1, np.int64)
    sumx[:m] = np.cumsum(xs[:m])  # INCLUSIVE prefix (oligoindex.c)
    sumxx[:m] = np.cumsum(xs[:m] * xs[:m])
    # after the loop the reference stores the running totals at slot m
    # (no further x is added, so slot m equals slot m-1)
    sumx[m] = sumx[m - 1] if m > 0 else 0
    sumxx[m] = sumxx[m - 1] if m > 0 else 0

    trim_start, trim_end = 0, n - 1
    side, edge = _edge_detect(sumx, sumxx, m)
    if side == -1:
        trim_start = edge + 1
        e2 = _trim_end_detect(trim_start, m, sumx, sumxx)
        if e2 >= 0:
            trim_end = e2 + 1
    elif side == +1:
        trim_end = edge + 1
        e2 = _trim_start_detect(0, trim_end, sumx, sumxx)
        if e2 >= 0:
            trim_start = e2

    # Count good oligos in the trimmed region (oligoindex.c:885-917):
    # a fresh shift-register scan starting at trim_start.
    sub = q[trim_start:trim_end]
    so, sv = _oligo_stream(sub, indexsize)
    ngood = int(sv.sum())
    nrep = int((counts[so[sv]] >= REPOLIGOCOUNT).sum())

    trimoligos = (trim_end - indexsize) - trim_start + 1
    badoligos = trimoligos - ngood
    if nunique == 0:
        oligodepth = 1000000.0
    else:
        oligodepth = noligos / nunique
    return oligodepth, badoligos, nrep, trimoligos, trim_start, trim_end


def classify(query: str):
    """gmap.c:2046-2062 poor/repetitive classification.  Returns
    (poorp, repetitivep)."""
    oligodepth, bad, rep, trimo, ts, te = set_inquery(query)
    if trimo == 0:
        poorp = True
    elif (bad / trimo > MAX_BADOLIGOS) or (te - ts < 80 and bad > 0):
        poorp = True
    else:
        poorp = False
    # gmap.c:2052-2062: repetitivep is hard-disabled (#if 0) in this
    # snapshot — the oligodepth/repoligos test is compiled out.
    repetitivep = False
    return poorp, repetitivep
