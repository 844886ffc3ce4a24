"""Changepoint end trimming — exact port of the reference's Chow-test
edge detection (src/changepoint.c) and the chop policy of
chop_ends_by_changepoint (src/stage3.c:2130-2300); a copy of
gmap_gsnap_tpu/align/changepoint.py.

GMAP trims noisy alignment ends by finding the sharpest drop in match
rate (Changepoint_left scans 3'->5', Changepoint_right 5'->3'), then
chops an end only when the binomial probability of its match count
under the interior match rate (minus THETA_SLACK) falls below
TRIM_END_PVALUE.
"""

from __future__ import annotations

import math

NPSEUDO = 12.0
SLACK = 0.10
THETA_SLACK = 0.10
TRIM_END_PVALUE = 1e-4


def _binom_cdf(k: int, n: int, p: float) -> float:
    """P(X <= k) for X ~ Binomial(n, p) (gsl_cdf_binomial_P)."""
    if k >= n:
        return 1.0
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0
    lq = math.log1p(-p)
    lp = math.log(p)
    total = 0.0
    for i in range(0, k + 1):
        total += math.exp(
            math.lgamma(n + 1) - math.lgamma(i + 1) - math.lgamma(n - i + 1)
            + i * lp + (n - i) * lq
        )
    return min(total, 1.0)


def changepoint_left(matchscores) -> tuple[int, int, int]:
    """Returns (edge, nmatches_left, ntotal_left); matchscores[i] in
    {1 match, 0 mismatch, -1 ignore}."""
    length = len(matchscores)
    x = sum(1 for s in matchscores if s == 1)
    y = sum(1 for s in matchscores if s == 0)
    n = x + y
    edge, nm_l, nt_l = 0, 0, 0
    if n == 0:
        return edge, nm_l, nt_l
    rss = x * y / n
    if rss == 0.0:
        return edge, nm_l, nt_l
    min_rss_sep = rss
    x_pseudo = NPSEUDO * (x / n)
    x_past = y_past = n_past = 0
    x_future, y_future, n_future = x, y, n
    for pos in range(length - 1, 0, -1):
        if matchscores[pos] < 0:
            continue
        if matchscores[pos] == 1:
            x_past += 1
            x_future -= 1
        else:
            y_past += 1
            y_future -= 1
        n_past += 1
        n_future -= 1
        theta_past = (x_past + x_pseudo) / (n_past + NPSEUDO)
        theta_future = (x_future + x_pseudo) / (n_future + NPSEUDO)
        rss_past = x_past * (1 - theta_past) ** 2 + y_past * theta_past ** 2
        rss_future = (x_future * (1 - theta_future) ** 2
                      + y_future * theta_future ** 2)
        rss_sep = rss_past + rss_future
        if rss_sep == 0.0:
            continue
        if theta_future < theta_past - SLACK and rss_sep < min_rss_sep:
            min_rss_sep = rss_sep
            edge = pos
            nm_l, nt_l = x_future, n_future
    return edge, nm_l, nt_l


def changepoint_right(matchscores) -> tuple[int, int, int]:
    """Returns (edge, nmatches_right, ntotal_right)."""
    length = len(matchscores)
    x = sum(1 for s in matchscores if s == 1)
    y = sum(1 for s in matchscores if s == 0)
    n = x + y
    edge, nm_r, nt_r = length, 0, 0
    if n == 0:
        return edge, nm_r, nt_r
    rss = x * y / n
    if rss == 0.0:
        return edge, nm_r, nt_r
    min_rss_sep = rss
    x_pseudo = NPSEUDO * (x / n)
    x_past = y_past = n_past = 0
    x_future, y_future, n_future = x, y, n
    for pos in range(1, length):
        if matchscores[pos] < 0:
            continue
        if matchscores[pos] == 1:
            x_past += 1
            x_future -= 1
        else:
            y_past += 1
            y_future -= 1
        n_past += 1
        n_future -= 1
        theta_past = (x_past + x_pseudo) / (n_past + NPSEUDO)
        theta_future = (x_future + x_pseudo) / (n_future + NPSEUDO)
        rss_past = x_past * (1 - theta_past) ** 2 + y_past * theta_past ** 2
        rss_future = (x_future * (1 - theta_future) ** 2
                      + y_future * theta_future ** 2)
        rss_sep = rss_past + rss_future
        if rss_sep == 0.0:
            continue
        if theta_future < theta_past - SLACK and rss_sep < min_rss_sep:
            min_rss_sep = rss_sep
            edge = pos
            nm_r, nt_r = x_future, n_future
    return edge, nm_r, nt_r


def chop_ends(matchscores) -> tuple[int, int]:
    """chop_ends_by_changepoint: returns (nchop_left, nchop_right) in
    alignment columns."""
    length = len(matchscores)
    nmatches = sum(1 for s in matchscores if s == 1)
    ntotal = sum(1 for s in matchscores if s in (0, 1))
    left_edge, nm_l, nt_l = changepoint_left(matchscores)
    right_edge, nm_r, nt_r = changepoint_right(matchscores)

    def pbinom_low(nm, nt):
        theta = (nmatches - nm) / (ntotal - nt)
        theta = max(theta - THETA_SLACK, 0.10)
        return _binom_cdf(nm, nt, theta)

    if right_edge <= left_edge:
        # edges cross: chop the shorter side only
        if nt_l == 0 or ntotal - nt_l <= 0:
            return 0, length - right_edge
        if nt_r == 0 or ntotal - nt_r <= 0:
            return left_edge, 0
        if nt_l < nt_r:
            return left_edge, 0
        return 0, length - right_edge

    chop_l = chop_r = 0
    if nt_l > 0 and ntotal - nt_l > 0 and pbinom_low(nm_l, nt_l) <= TRIM_END_PVALUE:
        chop_l = left_edge
    if nt_r > 0 and ntotal - nt_r > 0 and pbinom_low(nm_r, nt_r) <= TRIM_END_PVALUE:
        chop_r = length - right_edge
    return chop_l, chop_r
