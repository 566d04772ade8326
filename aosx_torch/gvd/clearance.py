"""Edge clearances (mirror of ``aosx/gvd/clearance.py``), an extension
beyond the reference, which always publishes 0.0 (aos_gvd_node.cpp:856).

A jump-flood distance field to the nearest occupied skeleton cell (the
obstacle set the edge-crossing filter samples), then each edge's clearance
is the least field value over its res/2-spaced samples. Off by default in
``build_gvd_graph``; ``compute_clearances=True`` turns it on.

The flood is not kernel K1's: within a pass the 8 directions are chained
(each reads the state the one before it wrote) and a candidate wins only if
strictly nearer, so it runs as plain PyTorch. It mirrors ``aosx``'s
static-shift form; the dynamic-shift form there computes the same field.
Its squared distances are sums of squares of integers below 2^24, exact in
f32 however they are rounded.
"""

from __future__ import annotations

import torch

from ..config import Statics
from ..ops import div_const, fma, sqrt
from ..perceive.raster import f32, iota2, live_mask, shift2d
from ..types import GridWorld

BIG = 1 << 30
FAR = 3.4e38


def _passes(h: int, w: int):
    n = max(h, w)
    k = 1
    while k < n:
        k *= 2
    k //= 2
    return [1] + [k >> i for i in range(k.bit_length()) if (k >> i) >= 1]


def obstacle_distance_field(grid: GridWorld, s: Statics):
    """Euclidean distance (m, cell-corner metric) from every cell to the
    nearest occupied cell of the live region, f32 [H, W]."""
    h, w = grid.occ.shape
    dev = grid.occ.device
    iy, ix = iota2((h, w), dev)
    occ = (grid.occ == 1) & live_mask(grid)
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    far = f32(FAR, dev)

    def d2_of(py, px):
        dy = (py - iy).to(torch.float32)
        dx = (px - ix).to(torch.float32)
        return torch.where(py < BIG, dy * dy + dx * dx, far)

    ny = torch.where(occ, iy, big)
    nx = torch.where(occ, ix, big)
    best = d2_of(ny, nx)
    for step in _passes(h, w):
        for dys in (-1, 0, 1):
            for dxs in (-1, 0, 1):
                if dys == 0 and dxs == 0:
                    continue
                cy = shift2d(ny, dys * step, dxs * step, BIG)
                cx = shift2d(nx, dys * step, dxs * step, BIG)
                cand = d2_of(cy, cx)
                better = cand < best
                ny = torch.where(better, cy, ny)
                nx = torch.where(better, cx, nx)
                best = torch.where(better, cand, best)
    return sqrt(torch.clamp(best, max=FAR)) * f32(s.resolution, dev)


def edge_clearances(dist_field, grid: GridWorld, pos, edges, edge_valid, s: Statics,
                    n_samples: int = 64):
    """Least obstacle distance along each edge, sampled like the crossing
    filter (res/2 steps, t in [0, 1]); 0 for invalid edges."""
    dev = dist_field.device
    a = pos[torch.clamp(edges[:, 0], min=0).long()]
    b = pos[torch.clamp(edges[:, 1], min=0).long()]
    d = b - a
    length = sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    num = torch.clamp(div_const(length, s.resolution * 0.5).to(torch.int32) + 1,
                      max=n_samples - 1)
    i = torch.arange(n_samples, dtype=torch.float32, device=dev)[None, :]
    t = torch.clamp(i / torch.clamp(num[:, None].to(torch.float32), min=1.0), max=1.0)
    # a + t * (b - a) rounded once: XLA:CPU fuses it
    px = fma(t, d[:, 0:1], a[:, 0:1])
    py = fma(t, d[:, 1:2], a[:, 1:2])
    H, W = dist_field.shape
    mx = torch.clamp(div_const(px - grid.origin_x, s.resolution).to(torch.int32), 0, W - 1)
    my = torch.clamp(div_const(py - grid.origin_y, s.resolution).to(torch.int32), 0, H - 1)
    vals = dist_field.reshape(-1)[(my.long() * W + mx.long())]
    vals = torch.where(i <= num[:, None].to(torch.float32), vals, f32(FAR, dev))
    return torch.where(edge_valid, vals.min(dim=1).values, f32(0.0, dev))
