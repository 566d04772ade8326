"""Vectorized geometry helpers (mirror of ``aosx/geom.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .f32math import atan2_f32
from .ops import lanes, take
from .types import Polygon

TWO_PI_F32 = torch.tensor(2 * math.pi, dtype=torch.float32).item()
INV_TWO_PI_F32 = float(np.float32(1.0) / np.float32(TWO_PI_F32))


def point_in_polygon(px, py, poly: Polygon):
    """Ray-casting point-in-polygon, faithful to the reference
    (aos_seed_gen_node.cpp:1231-1255): a crossing counts only when
    |dy| > 1e-9. px/py: broadcastable f32 tensors. Polygons with
    count < 3 return False. With leading world axes B on the polygon (pts
    [*B, P, 2], count [*B]), px and py carry B as their leading axes and
    each lane is tested against its own polygon."""
    P = poly.pts.shape[-2]
    nb = poly.pts.dim() - 2
    idx = torch.arange(P, device=poly.pts.device)
    count = poly.count[..., None]
    valid = idx < count
    jdx = torch.where(idx == 0, count - 1, idx - 1)
    pi = poly.pts
    pj = take(poly.pts, torch.clamp(jdx, 0, P - 1), nb)

    px = px.to(torch.float32)
    py = py.to(torch.float32)
    extra = max(px.dim(), py.dim()) - nb

    def per_lane(v):
        # [*B, P] -> [*B, 1 ..., P] against px's trailing axes
        return v.reshape(v.shape[:-1] + (1,) * extra + v.shape[-1:])

    xi, yi = per_lane(pi[..., 0]), per_lane(pi[..., 1])
    xj, yj = per_lane(pj[..., 0]), per_lane(pj[..., 1])
    px, py = px[..., None], py[..., None]
    dy = yj - yi
    big_dy = torch.abs(dy) > 1e-9
    safe_dy = torch.where(big_dy, dy, torch.ones_like(dy))
    crosses = (
        big_dy
        & ((yi > py) != (yj > py))
        & (px < (xj - xi) * (py - yi) / safe_dy + xi)
        & per_lane(valid)
    )
    inside = crosses.to(torch.int32).sum(-1) % 2 == 1
    return inside & lanes(poly.count >= 3, inside)


def active_bounds(poly: Polygon, clip_xy, margin):
    """getActiveBounds (aos_seed_gen_node.cpp:873-890)."""
    minx, maxx, miny, maxy = poly.bbox()
    has_poly = poly.count > 0
    return (
        torch.where(has_poly, minx - margin, clip_xy[0]),
        torch.where(has_poly, maxx + margin, clip_xy[1]),
        torch.where(has_poly, miny - margin, clip_xy[2]),
        torch.where(has_poly, maxy + margin, clip_xy[3]),
    )


def normalized_angle(a):
    """aos_state_machine_node.cpp:196-204: one conditional wrap (valid for a
    difference of two angles in (-pi, pi]; see aosx.geom)."""
    a = torch.where(a > math.pi, a - TWO_PI_F32, a)
    a = torch.where(a < -math.pi, a + TWO_PI_F32, a)
    return a


def wrap_angle(a):
    """Full wrap to [-pi, pi]; bitwise no-op for |a| <= pi. As XLA:CPU
    compiles the reference's ``a - 2pi * round(a / 2pi)`` under jit: the
    division by the constant becomes a product with its f32 reciprocal, and
    the subtraction a fused multiply-add, here a - k 2pi in f64 rounded
    once (k 2pi is exact in f64, and a - k 2pi too: k 2pi lies within a
    factor 2 of a, or k is 0)."""
    k = torch.round(a * INV_TWO_PI_F32)
    return (a.double() - k.double() * TWO_PI_F32).float()


def atan2(y, x):
    """f32 atan2 as XLA:CPU evaluates it (glibc's atan2f,
    ``f32math.atan2_f32``), the same bits on the CPU and the card."""
    return atan2_f32(y, x)

