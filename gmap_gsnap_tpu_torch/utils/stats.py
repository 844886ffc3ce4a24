"""Statistics kernels: binomial CDF and order statistics.

Python equivalents of the reference's pbinom.c (``Pbinom`` =
gsl_cdf_binomial_P, the lower-tail binomial CDF via the regularized
incomplete beta function) and orderstat.c (``Orderstat_*_pct`` = the
ceil(pct*length)-th order statistic via quickselect; a numpy partition
here).  Used by oligo-count overabundance thresholds
(oligoindex_hr.c:12310, stage1.c:2361) and changepoint trimming.

A copy of gmap_gsnap_tpu/utils/stats.py.
"""

from __future__ import annotations

import math

import numpy as np


def _betainc_cf(a: float, b: float, x: float) -> float:
    """Continued fraction for the regularized incomplete beta."""
    TINY = 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < TINY:
        d = TINY
    d = 1.0 / d
    h = d
    for m in range(1, 200):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < TINY:
            d = TINY
        c = 1.0 + aa / c
        if abs(c) < TINY:
            c = TINY
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < TINY:
            d = TINY
        c = 1.0 + aa / c
        if abs(c) < TINY:
            c = TINY
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 3e-15:
            break
    return h


def betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log1p(-x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betainc_cf(a, b, x) / a
    return 1.0 - bt * _betainc_cf(b, a, 1.0 - x) / b


def pbinom(k: int, n: int, theta: float) -> float:
    """P[X <= k] for X ~ Binomial(n, theta) (Pbinom, pbinom.c:
    gsl_cdf_binomial_P lower tail)."""
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    return betainc(n - k, k + 1.0, 1.0 - theta)


def orderstat_pct(values, pct: float):
    """The ceil(pct*length)-th smallest value (Orderstat_int_pct /
    Orderstat_double_pct, orderstat.c:quickselect)."""
    a = np.asarray(values)
    n = len(a)
    if n == 0:
        raise ValueError("empty set")
    cutoff = min(int(pct * n + 1), n)
    return a[np.argpartition(a, cutoff - 1)[cutoff - 1]]
