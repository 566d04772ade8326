"""The regression split of path linearization in float64 NumPy: a witness
for the f32 split of both packages where it is ill-conditioned.

``linearize`` (``aosx/plan/linearize.py``; reference:
src/aos_path_linearization_node.cpp) cuts a raw path into at most 4
segments (10 when the goal is the origin) by recursive regression: the line
y = a x + b of [s, e] (a = 0 when every x is equal, nothing for fewer than
3 points) splits at the argmin of the count-weighted mean of the two
halves' MSE while the largest interior deviation reaches
``linearize_max_dev``, left half first (cpp:50-177). Both packages take
the regression sums from f32 prefix sums of x, y, x*y, x^2 and y^2; far
from the origin (x^2 ~ 3.6e4 at 190 m) the MSE is then a difference of
large sums, and its rounding can decide a split. This module evaluates the
same split with the same f32 parameters in f64, from coordinates centred on
each range, and returns the breakpoints, which decide the linearized
plan's point count. Used by ``chip_smoke.py`` phase 7 and
``tests/test_torch_plancache.py``.
"""

from __future__ import annotations

import numpy as np


def _mse_table(x, y):
    """mse(i, j) of the least-squares line over the inclusive range [i, j]
    of x, y (broadcasting i against j), from f64 prefix sums of the
    coordinates centred on their mean."""
    cx, cy = x - x.mean(), y - y.mean()
    p = {k: np.concatenate([[0.0], np.cumsum(v)]) for k, v in
         dict(n=np.ones_like(cx), x=cx, y=cy, xy=cx * cy, xx=cx * cx, yy=cy * cy).items()}
    # a range whose x are all equal has a = 0: equal run numbers tell it
    run = np.concatenate([[0], np.cumsum(x[1:] != x[:-1])])

    def mse(i, j):
        i, j = np.broadcast_arrays(np.asarray(i), np.asarray(j))
        s = {k: v[j + 1] - v[i] for k, v in p.items()}
        n = s["n"]
        flat = run[j] == run[i]
        den = np.where(flat, 1.0, n * s["xx"] - s["x"] * s["x"])
        a = np.where(flat, 0.0, (n * s["xy"] - s["x"] * s["y"]) / den)
        b = (s["y"] - a * s["x"]) / n
        err = (s["yy"] - 2 * a * s["xy"] - 2 * b * s["y"] + a * a * s["xx"]
               + 2 * a * b * s["x"] + n * b * b) / n
        return np.where(j - i < 2, 0.0, np.maximum(err, 0.0))

    return mse


def _max_dev(x, y):
    """Largest |y - (a x + b)| over the interior points of x, y, for the
    least-squares line of all of them (a = 0 when every x is equal)."""
    cx, cy = x - x.mean(), y - y.mean()
    a = 0.0 if np.all(x == x[0]) else (cx * cy).sum() / (cx * cx).sum()
    b = cy.mean() - a * cx.mean()
    return float(np.abs(cy[1:-1] - (a * cx[1:-1] + b)).max())


def _best_split(x, y, s, e):
    """findBestSplitPoint (cpp:99-125): the first argmin over sp in (s, e)."""
    mse = _mse_table(x[s:e + 1], y[s:e + 1])
    sp = np.arange(1, e - s)
    n1 = sp + 1.0
    n2 = (e - s) - sp + 1.0
    tot = (mse(0, sp) * n1 + mse(sp, e - s) * n2) / (n1 + n2)
    return s + 1 + int(np.argmin(tot))


def breakpoints(xy, count, *, max_segments, max_dev=np.float32(0.1)):
    """Sorted breakpoint indices (0 and count - 1 included) of the raw path
    ``xy[:count]`` (f32 [P, 2]): every point of a path of at most 4, else
    splitPathRecursive (cpp:128-177) in f64. ``max_segments`` is
    Statics.max_segments, used when the path ends at the origin."""
    count = int(count)
    if count <= 4:
        return list(range(count))
    pts = np.asarray(xy, np.float64)[:count]
    x, y = pts[:, 0], pts[:, 1]
    if abs(x[-1]) >= 1e-6 or abs(y[-1]) >= 1e-6:
        max_segments = 4
    bp = set()
    stack = [(0, count - 1)]
    while stack:
        s, e = stack.pop()
        if e - s < 2 or len(bp) >= max_segments - 1:
            continue
        if _max_dev(x[s:e + 1], y[s:e + 1]) < float(max_dev):
            continue
        split = _best_split(x, y, s, e)
        bp.add(split)
        if len(bp) < max_segments - 1:
            stack.append((split, e))
            stack.append((s, split))
    return sorted(bp | {0, count - 1})
