"""Voronoi seed generation (mirror of ``aosx/perceive/seeds.py``;
reference: aos_seed_gen_node.cpp:1670-2268): virtual seeds along rows with
perpendicular raycasts, endpoint rays, row endpoint seeds, greedy dedupes.

- raycasts: all rays march in lockstep; the bounded virtual-seed rays use
  the coarse-to-fine scheme of ``aosx`` (a dilated coarse pass, then exact
  9-lane fine windows), the unbounded endpoint rays march 256 samples per
  loop iteration.
- the reference's greedy sequential dedupe is computed with the parallel
  frontier algorithm of ``aosx`` (bit-identical to the sequential loop).
- all candidate families keep the reference's publish order.

World axis: rows, grids and polygons may carry a leading world axis B (the
axis ``aosx`` maps with ``jax.vmap``); every ray reads its own world's grid,
and the lockstep loops run while any world has a ray or a candidate
undecided, a world's finished lanes unchanged by the extra iterations.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import AosParams, Statics
from ..geom import point_in_polygon
from ..ops import chunk_rows, div_const, fma, lanes, scatter_set, sqrt, take, while_loop
from ..types import GridWorld, Polygon, SeedSet, TreeRows
from .raster import edge_replicated, f32, shift2d

# candidate rows of the [rows, C] conflict matrix built at once
_DEDUPE_CHUNK = 2048


def _conflicts(xy, t2):
    """[*B, C, C] bool: j < i and |xy_i - xy_j|^2 < t2 (t2 0-d or of shape B)."""
    B = xy.shape[:-2]
    C = xy.shape[-2]
    dev = xy.device
    t2 = t2.reshape(t2.shape + (1, 1))
    out = torch.empty(B + (C, C), dtype=torch.bool, device=dev)
    j = torch.arange(C, device=dev)
    rc = chunk_rows(_DEDUPE_CHUNK, math.prod(B))
    for r0 in range(0, C, rc):
        a = xy[..., r0:r0 + rc, :]
        ddx = a[..., :, None, 0] - xy[..., None, :, 0]
        ddy = a[..., :, None, 1] - xy[..., None, :, 1]
        d2 = ddx * ddx + ddy * ddy
        out[..., r0:r0 + rc, :] = (d2 < t2) & (j[None, :] < j[r0:r0 + rc, None])
    return out


def greedy_dedupe(xy, valid, thresh):
    """Accepted mask of the sequential greedy dedupe: candidate i is
    accepted iff valid[i] and no accepted j < i lies within ``thresh``.
    Each round decides every candidate whose earlier conflicts are all
    decided; once nothing is undecided a round changes nothing (which is
    what makes the lockstep of several worlds sound)."""
    t2 = torch.as_tensor(thresh, dtype=torch.float32, device=xy.device) ** 2
    conflict = _conflicts(xy.to(torch.float32), t2)

    def undecided(st):
        accepted, rejected = st
        return valid & ~accepted & ~rejected

    def body(st):
        accepted, rejected = st
        und = undecided(st)
        conf_acc = (conflict & accepted[..., None, :]).any(dim=-1)
        conf_und = (conflict & und[..., None, :]).any(dim=-1)
        return accepted | (und & ~conf_acc & ~conf_und), rejected | (und & conf_acc)

    zeros = torch.zeros_like(valid)
    accepted, _ = while_loop(lambda st: undecided(st).any(dim=-1), body, (zeros, zeros),
                             "greedy_dedupe")
    return accepted


def dilate_chebyshev(occ01, r: int):
    """Max over the (2r+1) x (2r+1) square, zero outside (reduce_window
    "SAME" with a 0 init)."""
    out = occ01
    for dx in range(1, r + 1):
        out = torch.maximum(out, torch.maximum(shift2d(occ01, 0, dx), shift2d(occ01, 0, -dx)))
    rows = out
    for dy in range(1, r + 1):
        out = torch.maximum(out, torch.maximum(shift2d(rows, dy, 0), shift2d(rows, -dy, 0)))
    return out


def raycast_bounded(grid: GridWorld, start, direction, active, max_dist, min_dist, s: Statics):
    """raycastToOccupiedCell (cpp:1730-1771): step = res/2, first occupied
    sample at distance >= min_dist wins; worldToGrid clamps out-of-bounds.
    start/direction: [*B, N, 2] (B the grid's world axes). Returns (hit
    [*B, N], hit_xy [*B, N, 2]).

    Coarse-to-fine march (see ``aosx.perceive.seeds.raycast_bounded`` for
    the exactness argument): every 8th fine sample is looked up in the grid
    dilated by Chebyshev radius 3, then flagged 9-lane windows are examined
    exactly in ascending order until the first hit."""
    dev = start.device
    nb = start.dim() - 2
    step = s.resolution * 0.5
    n_steps = int(max_dist / step)
    occ_ext = edge_replicated(grid)
    H, W = occ_ext.shape[-2:]
    B = start.shape[:-2]
    N = start.shape[-2]
    C = 8
    NC = (n_steps + C - 1) // C
    LN = C + 1
    ox = lanes(grid.origin_x, start)
    oy = lanes(grid.origin_y, start)
    min_dist = lanes(min_dist, start)

    occ01 = (occ_ext == 1).to(torch.uint8)
    dil = dilate_chebyshev(occ01, 3)

    dnorm = sqrt(direction[..., 0] * direction[..., 0] + direction[..., 1] * direction[..., 1])

    def cells(px, py):
        gx = torch.clamp(torch.floor(div_const(px - ox, s.resolution)).to(torch.int32), 0, W - 1)
        gy = torch.clamp(torch.floor(div_const(py - oy, s.resolution)).to(torch.int32), 0, H - 1)
        return gy * W + gx

    kc = torch.arange(NC + 1, dtype=torch.float32, device=dev) * C
    cpx = start[..., 0:1] + direction[..., 0:1] * (kc * step)
    cpy = start[..., 1:2] + direction[..., 1:2] * (kc * step)
    cmask = take(dil.flatten(-2), cells(cpx, cpy), nb) == 1
    cmask = cmask | (dnorm > 1.0 + 1e-6)[..., None]
    cmask = cmask & active[..., None]

    occ_flat = occ_ext.flatten(-2)
    widx = torch.arange(NC + 1, dtype=torch.int32, device=dev)
    lanes_ = torch.arange(LN, dtype=torch.float32, device=dev) - C / 2

    def fine_window(w):
        f = w.to(torch.float32)[..., None] * C + lanes_
        ok = (f >= 1.0) & (f <= float(n_steps))
        px = start[..., 0:1] + direction[..., 0:1] * (f * step)
        py = start[..., 1:2] + direction[..., 1:2] * (f * step)
        d = f * step * dnorm[..., None]
        occ = take(occ_flat, cells(px, py), nb) == 1
        cand = occ & ok & (d >= min_dist)
        found = cand.any(dim=-1)
        lane = cand.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        return found, w * C - C // 2 + lane

    def body(st):
        resolved, kcur, hit, first_k = st
        rem = cmask & (widx >= kcur[..., None])
        has_w = rem.any(dim=-1)
        w = rem.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        found, fk = fine_window(w)
        live = ~resolved & has_w
        newly_hit = live & found
        return (resolved | ~has_w | newly_hit,
                torch.where(live & ~found, w + 1, kcur),
                hit | newly_hit,
                torch.where(newly_hit, fk, first_k))

    state0 = (~active | ~cmask.any(dim=-1),
              torch.zeros(B + (N,), dtype=torch.int32, device=dev),
              torch.zeros(B + (N,), dtype=torch.bool, device=dev),
              torch.ones(B + (N,), dtype=torch.int32, device=dev))
    _, _, hit, first_k = while_loop(lambda st: (~st[0]).any(dim=-1), body, state0,
                                     "raycast_bounded")

    kf = first_k.to(torch.float32)
    # start + direction * (k * step) rounded once: XLA:CPU fuses it (the ray
    # seeds a polygon does not drop show it)
    hx = fma(direction[..., 0], kf * step, start[..., 0])
    hy = fma(direction[..., 1], kf * step, start[..., 1])
    hit_xy = torch.where(hit[..., None], torch.stack([hx, hy], dim=-1), 0.0)
    return hit, hit_xy


def cast_rays_unbounded(grid: GridWorld, start, direction, active, min_dist,
                        step: float, diag_mult: float, s: Statics):
    """castRayFromEndpoint (cpp:1774-1891): march from min_dist with `step`
    until leaving the grid (the clamped boundary point) or hitting an
    occupied skeleton cell (the sample point). start/direction: [*B, N, 2]
    (B the grid's world axes)."""
    dev = start.device
    nb = start.dim() - 2
    res = f32(s.resolution, dev)
    minx = grid.origin_x
    maxx = grid.origin_x + grid.w_cells.to(torch.float32) * res
    miny = grid.origin_y
    maxy = grid.origin_y + grid.h_cells.to(torch.float32) * res
    gw = grid.w_cells.to(torch.float32) * res
    gh = grid.h_cells.to(torch.float32) * res
    abs_max = sqrt(gw * gw + gh * gh) * diag_mult
    # the per-world bounds against [*B, N] and [*B, N, CH] samples
    minx2, maxx2, miny2, maxy2 = (v[..., None] for v in (minx, maxx, miny, maxy))
    minx3, maxx3, miny3, maxy3 = (v[..., None, None] for v in (minx, maxx, miny, maxy))
    ox3, oy3 = grid.origin_x[..., None, None], grid.origin_y[..., None, None]
    wc3, hc3 = grid.w_cells[..., None, None], grid.h_cells[..., None, None]
    abs_max3 = abs_max[..., None, None]

    def clamp(p):
        return torch.stack([torch.minimum(torch.maximum(p[..., 0], minx2), maxx2),
                            torch.minimum(torch.maximum(p[..., 1], miny2), maxy2)], dim=-1)

    result0 = clamp(start + direction * abs_max3)
    B = start.shape[:-2]
    N = start.shape[-2]
    CH = 256
    Hc, Wc = grid.occ.shape[-2:]
    occ_flat = grid.occ.flatten(-2)
    k = torch.arange(CH, dtype=torch.float32, device=dev)

    def cond(st):
        dist, done, _ = st
        return (~done & (dist <= abs_max[..., None])).any(dim=-1)

    def body(st):
        dist, done, result = st
        dk = dist[..., None] + k * step
        # start + direction * dk rounded once: XLA:CPU fuses it
        px = fma(direction[..., 0:1], dk, start[..., 0:1])
        py = fma(direction[..., 1:2], dk, start[..., 1:2])
        inb = (px >= minx3) & (px <= maxx3) & (py >= miny3) & (py <= maxy3)
        # C-truncation cast toward zero (cpp:1821-1822); the division as
        # XLA compiles it (MC world 106: a sample at y = 9.9 over origin -1
        # falls in row 218 by XLA's product, in skeleton row 217 by a
        # division)
        mx = div_const(px - ox3, s.resolution).to(torch.int32)
        my = div_const(py - oy3, s.resolution).to(torch.int32)
        ing = (mx >= 0) & (mx < wc3) & (my >= 0) & (my < hc3)
        flat = torch.clamp(my, 0, Hc - 1) * Wc + torch.clamp(mx, 0, Wc - 1)
        occ = (take(occ_flat, flat, nb) == 1) & ing
        within = dk <= abs_max3
        event = (~inb | occ) & within
        has = event.any(dim=-1)
        first = event.to(torch.uint8).argmax(dim=-1, keepdim=True)
        ep = torch.stack([torch.gather(px, -1, first)[..., 0],
                          torch.gather(py, -1, first)[..., 0]], dim=-1)
        e_inb = torch.gather(inb, -1, first)[..., 0]
        fire = ~done & has
        result = torch.where((fire & ~e_inb)[..., None], clamp(ep), result)
        result = torch.where((fire & e_inb)[..., None], ep, result)
        return dist + CH * step, done | fire, result

    md = torch.as_tensor(min_dist, dtype=torch.float32, device=dev)
    dist0 = torch.full(B + (N,), 1.0, dtype=torch.float32, device=dev) * md[..., None]
    _, _, result = while_loop(cond, body, (dist0, ~active, result0), "cast_rays_unbounded")
    return result


def _row_dirs(rows: TreeRows):
    d = rows.ep2 - rows.ep1
    dist = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    safe = torch.clamp(dist, min=1e-6)
    return d, dist, d / safe[..., None]


def virtual_seed_candidates(rows: TreeRows, skel: GridWorld, poly: Polygon,
                            params: AosParams, s: Statics):
    """Ordered candidates of generateVirtualSeeds (cpp:1987-2268): per row
    r, per interval i, the triple (base, perp1-ray seed, perp2-ray seed).
    Returns (xy [*B, R*I*3, 2], valid [*B, R*I*3])."""
    dev = rows.center.device
    B = rows.valid.shape[:-1]
    R, I = s.max_rows, s.max_seeds_per_row
    d, dist, rd = _row_dirs(rows)
    interval = lanes(params.virtual_seed_interval, dist)
    num = torch.floor(dist / interval).to(torch.int32)
    row_ok = rows.valid & (dist >= interval)

    i_idx = torch.arange(1, I + 1, dtype=torch.float32, device=dev)
    t = i_idx / (num[..., None].to(torch.float32) + 1.0)
    # rounded once, as XLA:CPU evaluates aosx's ep1 + t*d
    base = fma(t[..., None], d[..., :, None, :], rows.ep1[..., :, None, :])
    iv = row_ok[..., None] & (torch.arange(1, I + 1, device=dev) <= num[..., None])

    perp1 = torch.stack([-rd[..., 1], rd[..., 0]], dim=-1)
    perp2 = -perp1

    base_f = base.reshape(B + (R * I, 2))
    iv_f = iv.reshape(B + (R * I,))
    starts = torch.cat([base_f, base_f], dim=-2)
    dirs = torch.cat(
        [perp1[..., :, None, :].expand(B + (R, I, 2)).reshape(B + (R * I, 2)),
         perp2[..., :, None, :].expand(B + (R, I, 2)).reshape(B + (R * I, 2))], dim=-2)
    act = torch.cat([iv_f, iv_f], dim=-1)
    hit, hit_xy = raycast_bounded(
        skel, starts, dirs, act, s.seed_raycast_max, params.seed_raycast_min, s)
    miss_xy = starts + dirs * s.seed_raycast_max
    ray_xy = torch.where(hit[..., None], hit_xy, miss_xy)
    ray1 = ray_xy[..., :R * I, :].reshape(B + (R, I, 2))
    ray2 = ray_xy[..., R * I:, :].reshape(B + (R, I, 2))

    # ray seeds skipped when inside the polygon (cpp:2128-2135)
    has_poly = poly.count >= 3
    in1 = point_in_polygon(ray1[..., 0], ray1[..., 1], poly) & lanes(has_poly, iv)
    in2 = point_in_polygon(ray2[..., 0], ray2[..., 1], poly) & lanes(has_poly, iv)

    cand = torch.stack([base, ray1, ray2], dim=-2)
    cvalid = torch.stack([iv, iv & ~in1, iv & ~in2], dim=-1)
    return cand.reshape(B + (R * I * 3, 2)), cvalid.reshape(B + (R * I * 3,))


def _cos_sin_f32(angle_deg: float):
    """cos and sin of f32(|angle| in radians), rounded to f32."""
    a = float(np.float32(abs(angle_deg) * math.pi / 180.0))
    return float(np.float32(math.cos(a))), float(np.float32(math.sin(a)))


def endpoint_ray_candidates(rows: TreeRows, skel: GridWorld, poly: Polygon,
                            params: AosParams, s: Statics):
    """Ordered candidates of generateRayPointsFromEndpoints (cpp:1894-1982):
    per row, 6 rays (ep1: 0/-90/+90 deg; ep2: 0/-90/+90 deg), kept iff
    inside the grid bounds and outside the polygon."""
    dev = rows.center.device
    B = rows.valid.shape[:-1]
    R = s.max_rows
    unit_x = torch.tensor([1.0, 0.0], dtype=torch.float32, device=dev)

    def ray_dir(ep, other, angle_deg):
        d = other - ep
        n = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        fwd = torch.where(n[..., None] > 1e-6, d / torch.clamp(n, min=1e-6)[..., None], unit_x)
        outward = -fwd
        perp = torch.stack([-fwd[..., 1], fwd[..., 0]], dim=-1)
        ca, sa = _cos_sin_f32(angle_deg)
        side = perp if angle_deg > 0 else -perp
        rd = ca * outward + sa * side
        rn = sqrt(rd[..., 0] * rd[..., 0] + rd[..., 1] * rd[..., 1])
        return rd / torch.clamp(rn, min=1e-12)[..., None]

    starts, dirs = [], []
    for ep, other in ((rows.ep1, rows.ep2), (rows.ep2, rows.ep1)):
        for ang in (0.0, -90.0, 90.0):
            starts.append(ep)
            dirs.append(ray_dir(ep, other, ang))
    start = torch.stack(starts, dim=-2).reshape(B + (R * 6, 2))
    direction = torch.stack(dirs, dim=-2).reshape(B + (R * 6, 2))
    active = rows.valid[..., None].expand(B + (R, 6)).reshape(B + (R * 6,))

    pts = cast_rays_unbounded(skel, start, direction, active,
                              params.seed_raycast_min, 0.1, 3.0, s)
    res = f32(s.resolution, dev)
    minx = lanes(skel.origin_x, active)
    maxx = lanes(skel.origin_x + skel.w_cells.to(torch.float32) * res, active)
    miny = lanes(skel.origin_y, active)
    maxy = lanes(skel.origin_y + skel.h_cells.to(torch.float32) * res, active)
    in_grid = ((pts[..., 0] >= minx) & (pts[..., 0] <= maxx)
               & (pts[..., 1] >= miny) & (pts[..., 1] <= maxy))
    has_poly = poly.count >= 3
    in_poly = point_in_polygon(pts[..., 0], pts[..., 1], poly) & lanes(has_poly, active)
    finite = torch.isfinite(pts[..., 0]) & torch.isfinite(pts[..., 1])
    return pts, active & finite & in_grid & ~in_poly


def endpoint_seed_candidates(rows: TreeRows, s: Statics):
    """Row start/end points (cpp:1450-1497), order [ep1_r, ep2_r] per row."""
    B = rows.valid.shape[:-1]
    pts = torch.stack([rows.ep1, rows.ep2], dim=-2).reshape(B + (s.max_rows * 2, 2))
    return pts, rows.valid[..., None].expand(B + (s.max_rows, 2)).reshape(B + (s.max_rows * 2,))


def generate_seeds(rows: TreeRows, skel: GridWorld, poly: Polygon,
                   params: AosParams, s: Statics) -> SeedSet:
    """/voronoi_seeds in publish order (cpp:1670-1710): virtual (base+ray,
    deduped), endpoint rays (deduped), row endpoints (deduped)."""
    dev = rows.center.device
    B = rows.valid.shape[:-1]
    v_xy, v_val = virtual_seed_candidates(rows, skel, poly, params, s)
    r_xy, r_val = endpoint_ray_candidates(rows, skel, poly, params, s)
    e_xy, e_val = endpoint_seed_candidates(rows, s)

    v_acc = greedy_dedupe(v_xy, v_val, params.seed_dedupe_dist)
    r_acc = greedy_dedupe(r_xy, r_val, params.seed_dedupe_dist)
    e_acc = greedy_dedupe(e_xy, e_val, params.seed_dedupe_dist)

    xy = torch.cat([v_xy, r_xy, e_xy], dim=-2)
    acc = torch.cat([v_acc, r_acc, e_acc], dim=-1)
    kind = torch.cat([
        torch.zeros(v_xy.shape[-2], dtype=torch.int8, device=dev),
        torch.full((r_xy.shape[-2],), 2, dtype=torch.int8, device=dev),
        torch.full((e_xy.shape[-2],), 3, dtype=torch.int8, device=dev),
    ]).expand(acc.shape)
    Smax = s.max_seeds
    rank = torch.cumsum(acc.to(torch.int32), -1, dtype=torch.int32) - 1
    tgt = torch.where(acc & (rank < Smax), rank, Smax)
    n = torch.clamp(acc.sum(dim=-1, dtype=torch.int32), max=Smax)
    return SeedSet(xy=scatter_set(Smax, 0.0, tgt, xy),
                   valid=torch.arange(Smax, device=dev) < n[..., None],
                   kind=scatter_set(Smax, 0, tgt, kind))
