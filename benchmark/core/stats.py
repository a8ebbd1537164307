"""Percentiles as the benchmark states them: linear interpolation between order
statistics (numpy's default method), over every value; a request that failed or
never came counts as infinitely late."""

import math


def percentile(values, q: float) -> float:
    v = sorted(float(x) for x in values)
    if not v:
        return math.nan
    h = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(h), math.ceil(h)
    if lo == hi or v[lo] == v[hi]:
        return v[lo]
    return v[lo] + (h - lo) * (v[hi] - v[lo])


def median(values) -> float:
    return percentile(values, 50.0)
