"""Occupancy rasterization + inflation + borders (mirror of
``aosx/perceive/raster.py``; reference: aos_seed_gen_node.cpp:581-967).

- scatter-to-grid: one scatter-max of 1 into the cells of kept points.
- disc inflation: the separable decomposition of ``aosx`` (horizontal
  dilations H_k, then a vertical max over shifted H_{w(|dy|)}), exactly the
  dilation by the disc dx^2 + dy^2 <= ic^2.
- borders / rectangle boundary: index masks.

The grid lives in a static [grid_h, grid_w] buffer; the live region
[0:h_cells, 0:w_cells] is carried as 0-d tensors. Every function also takes
grids with leading world axes B (occ [*B, H, W], the bounds and origins of
shape B): each world keeps its own live region, origin and cells.
"""

from __future__ import annotations

import math

import torch

from ..config import Statics
from ..ops import div_const, lanes
from ..types import GridWorld


def f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def iota2(shape, device):
    """(iy, ix) int32 index planes of ``shape``."""
    h, w = shape
    iy = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    ix = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return iy, ix


def shift2d(a, dy: int, dx: int, fill=0):
    """Static fill shift of the last two axes: out[..., y, x] =
    a[..., y - dy, x - dx] (``fill`` outside)."""
    h, w = a.shape[-2:]
    if abs(dy) >= h or abs(dx) >= w:
        return torch.full_like(a, fill)
    out = torch.full_like(a, fill)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        a[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def to_plane(v):
    """A value of shape B (a world's bound or origin) against [*B, H, W]
    planes; 0-d or a Python scalar for one world."""
    return v[..., None, None] if torch.is_tensor(v) else v


def live_mask(grid: GridWorld):
    iy, ix = iota2(grid.occ.shape[-2:], grid.occ.device)
    return (iy < to_plane(grid.h_cells)) & (ix < to_plane(grid.w_cells))


def generate_grid(xy, keep, bounds, s: Statics) -> GridWorld:
    """generateOccupancyGrid (aos_seed_gen_node.cpp:581-622). xy [*B, N, 2]
    and keep [*B, N] with bounds of shape B rasterise each world into its
    own [H, W] plane."""
    dev = xy.device
    minx, maxx, miny, maxy = bounds
    zero = f32(0.0, dev)
    width = torch.maximum(zero, maxx - minx)
    height = torch.maximum(zero, maxy - miny)
    # every division by the resolution as XLA compiles it (ops.div_const)
    w_cells = torch.clamp(torch.ceil(div_const(width, s.resolution)).to(torch.int32),
                          min=1, max=s.grid_w)
    h_cells = torch.clamp(torch.ceil(div_const(height, s.resolution)).to(torch.int32),
                          min=1, max=s.grid_h)
    # C-truncation cast (points are >= origin after clipping, so trunc == floor)
    gx = div_const(xy[..., 0] - minx[..., None], s.resolution).to(torch.int32)
    gy = div_const(xy[..., 1] - miny[..., None], s.resolution).to(torch.int32)
    ok = keep & (gx >= 0) & (gx < w_cells[..., None]) & (gy >= 0) & (gy < h_cells[..., None])
    # dropped points index (-1, -1), which aosx's scatter normalizes to the
    # last row and column of the buffer (negative indices wrap); mirror it.
    # The index is into the point's own world's plane, so a dropped point
    # writes that world's last cell
    gx = torch.where(ok, gx, s.grid_w - 1)
    gy = torch.where(ok, gy, s.grid_h - 1)
    occ = torch.zeros(xy.shape[:-2] + (s.grid_h * s.grid_w,), dtype=torch.uint8, device=dev)
    flat = gy.long() * s.grid_w + gx.long()
    occ.scatter_(-1, flat, torch.ones_like(flat, dtype=torch.uint8))
    return GridWorld(
        occ=occ.reshape(xy.shape[:-2] + (s.grid_h, s.grid_w)),
        origin_x=minx.to(torch.float32),
        origin_y=miny.to(torch.float32),
        h_cells=h_cells,
        w_cells=w_cells,
    )


def dilate_disc(occ, ic: int):
    """Binary dilation with the disc dx^2 + dy^2 <= ic^2 via the separable
    horizontal-dilation decomposition (no live-region masking)."""
    H = [occ]
    cur = occ
    for k in range(1, ic + 1):
        cur = torch.maximum(cur, torch.maximum(shift2d(occ, 0, k), shift2d(occ, 0, -k)))
        H.append(cur)
    out = H[ic]
    for dy in range(1, ic + 1):
        w = int(math.floor(math.sqrt(ic * ic - dy * dy)))
        band = H[w]
        out = torch.maximum(out, torch.maximum(shift2d(band, dy, 0), shift2d(band, -dy, 0)))
    return out


def _with_occ(grid: GridWorld, occ) -> GridWorld:
    return GridWorld(occ, grid.origin_x, grid.origin_y, grid.h_cells, grid.w_cells)


def inflate(grid: GridWorld, s: Statics) -> GridWorld:
    """applyInflation (aos_seed_gen_node.cpp:933-967)."""
    out = dilate_disc(grid.occ, s.inflation_cells)
    out = torch.where(live_mask(grid), out, torch.zeros_like(out))
    return _with_occ(grid, out)


def mark_borders(grid: GridWorld, thickness: int = 5) -> GridWorld:
    """markBoundariesAsOccupied (aos_seed_gen_node.cpp:708-757)."""
    iy, ix = iota2(grid.occ.shape[-2:], grid.occ.device)
    border = (
        (iy < thickness)
        | (iy >= to_plane(grid.h_cells) - thickness)
        | (ix < thickness)
        | (ix >= to_plane(grid.w_cells) - thickness)
    )
    occ = torch.where(border & live_mask(grid), torch.ones_like(grid.occ), grid.occ)
    return _with_occ(grid, occ)


def edge_replicated(grid: GridWorld):
    """occ with the dead region filled by replicating the live edge:
    occ_ext[y, x] == occ[min(y, h_cells-1), min(x, w_cells-1)]."""
    h, w = grid.occ.shape[-2:]
    iy, ix = iota2((h, w), grid.occ.device)
    c = torch.clamp(grid.w_cells - 1, 0, w - 1).long()
    last_col = torch.gather(grid.occ, -1, c[..., None, None].expand(grid.occ.shape[:-1] + (1,)))
    colrep = torch.where(ix >= to_plane(grid.w_cells), last_col, grid.occ)
    r = torch.clamp(grid.h_cells - 1, 0, h - 1).long()
    last_row = torch.gather(colrep, -2, r[..., None, None].expand(colrep.shape[:-2] + (1, w)))
    return torch.where(iy >= to_plane(grid.h_cells), last_row, colrep)


def world_to_grid_clamped(grid: GridWorld, wx, wy, res: float):
    """worldToGrid (aos_seed_gen_node.cpp:760-769): floor + clamp to live
    region; wx, wy carry the grid's world axes as their leading axes."""
    gx = torch.floor(div_const(wx - lanes(grid.origin_x, wx), res)).to(torch.int32)
    gy = torch.floor(div_const(wy - lanes(grid.origin_y, wy), res)).to(torch.int32)
    gx = torch.minimum(torch.clamp(gx, min=0), lanes(grid.w_cells, gx) - 1)
    gy = torch.minimum(torch.clamp(gy, min=0), lanes(grid.h_cells, gy) - 1)
    return gx, gy


def mark_polygon_rect(grid: GridWorld, poly, margin, s: Statics) -> GridWorld:
    """markPolygonBoundaryAsOccupied (aos_seed_gen_node.cpp:772-825): the
    axis-aligned rectangle (polygon bbox +- margin) boundary; 5-cell borders
    when there is no polygon."""
    minx, maxx, miny, maxy = poly.bbox()
    gx0, gy0 = world_to_grid_clamped(grid, minx - margin, miny - margin, s.resolution)
    gx1, gy1 = world_to_grid_clamped(grid, maxx + margin, maxy + margin, s.resolution)
    iy, ix = iota2(grid.occ.shape[-2:], grid.occ.device)
    gx0, gy0, gx1, gy1 = (to_plane(v) for v in (gx0, gy0, gx1, gy1))
    on_rect = (
        ((iy == gy0) | (iy == gy1)) & (ix >= gx0) & (ix <= gx1)
    ) | (((ix == gx0) | (ix == gx1)) & (iy >= gy0) & (iy <= gy1))
    occ_rect = torch.where(on_rect & live_mask(grid), torch.ones_like(grid.occ), grid.occ)
    borders = mark_borders(grid)
    occ = torch.where(to_plane(poly.count > 0), occ_rect, borders.occ)
    return _with_occ(grid, occ)
