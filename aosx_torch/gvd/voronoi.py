"""Grid-space Voronoi field via jump flooding (mirror of
``aosx/gvd/voronoi.py``).

The "1+JFA" variant (an extra step-1 pass first) with JACOBI passes: all 8
directional candidates are read from the pass-start planes and folded with a
lexicographic (d2, owner) min, ties to the lower seed index. The flood
carries the owner plane alone: a cell's owner position is the seed table's
row, ``table[owner]``, at the start and after every pass. All passes of a
flood are one call of kernel K1 (``jfa_pass_cuda.jfa_flood``) with no host
read in it. Grids and seed sets with a leading world axis flood in that one
call too: each world keeps its own origin, live bounds and table, and runs
the same pass list (``_passes`` is static).
"""

from __future__ import annotations

import torch

from ..config import Statics
from ..ops import div_const, fma, lanes
from ..perceive.raster import f32, live_mask
from ..types import GridWorld, SeedSet

INF = 3.4e38


def _passes(s: Statics):
    n = max(s.grid_h, s.grid_w)
    steps = [1]
    k = 1
    while k < n:
        k *= 2
    k //= 2
    while k >= 1:
        steps.append(k)
        k //= 2
    return steps


def _jfa_init(grid: GridWorld, seeds: SeedSet, s: Statics):
    """Seed scatter -> (owner [*B, H,W] i32 with S = no owner, table
    [*B, S+1, 2] f32 = seeds.xy with the row (1e9, 1e9) of "no owner"
    appended). Seeds sharing a cell: the lowest valid seed index wins
    (scatter-min, which no order of the writes changes), so every cell's
    owner position is table[owner]. Each world scatters into its own plane."""
    h, w = grid.occ.shape[-2:]
    dev = grid.occ.device
    B = seeds.valid.shape[:-1]
    S = seeds.xy.shape[-2]
    sx = torch.floor(div_const(seeds.xy[..., 0] - lanes(grid.origin_x, seeds.valid),
                               s.resolution)).to(torch.int32)
    sx = torch.minimum(torch.clamp(sx, min=0), lanes(grid.w_cells, sx) - 1)
    sy = torch.floor(div_const(seeds.xy[..., 1] - lanes(grid.origin_y, seeds.valid),
                               s.resolution)).to(torch.int32)
    sy = torch.minimum(torch.clamp(sy, min=0), lanes(grid.h_cells, sy) - 1)
    flat = (sy.long() * w + sx.long())
    sidx = torch.where(seeds.valid, torch.arange(S, dtype=torch.int32, device=dev), S)
    owner = torch.full(B + (h * w,), S, dtype=torch.int32, device=dev)
    owner = owner.scatter_reduce(-1, flat, sidx, reduce="amin", include_self=True)
    far = torch.full(B + (1, 2), 1e9, dtype=torch.float32, device=dev)
    return owner.reshape(B + (h, w)), torch.cat([seeds.xy.to(torch.float32), far], dim=-2)


def jacobi_fold(o0, x0, y0, neighbors, S: int, cellx, celly):
    """One Jacobi JFA update: fold the 8 pass-start neighbour triples
    (owner, x, y) into the state with a lexicographic (d2, owner) min.
    d2 = fma(dx, dx, dy * dy) for dx = px - cellx, dy = py - celly: the
    fused multiply-add XLA:CPU makes of ``aosx``'s squared distance (the
    CUDA kernel does the same)."""

    def dist2(px, py):
        dx = px - cellx
        dy = py - celly
        return fma(dx, dx, dy * dy)

    inf = torch.tensor(INF, dtype=torch.float32, device=o0.device)
    d2 = torch.where(o0 < S, dist2(x0, y0), inf)
    o, x, y = o0, x0, y0
    for no, nx, ny in neighbors:
        nd = torch.where(no < S, dist2(nx, ny), inf)
        better = (nd < d2) | ((nd == d2) & (no < o))
        o = torch.where(better, no, o)
        x = torch.where(better, nx, x)
        y = torch.where(better, ny, y)
        d2 = torch.where(better, nd, d2)
    return o, x, y


def jump_flood(grid: GridWorld, seeds: SeedSet, s: Statics):
    """Nearest-seed ownership over the live region. Returns owner [*B, H,W]
    i32: seed index, or -1 outside the live region / with no seeds.
    Distances are measured from cell corners (world = origin + cell*res)."""
    from .jfa_pass_cuda import jfa_flood

    S = seeds.xy.shape[-2]
    owner, table = _jfa_init(grid, seeds, s)
    owner = jfa_flood(owner, table, _passes(s), S, grid.origin_x, grid.origin_y, s.resolution)
    return torch.where(live_mask(grid) & (owner < S), owner, -1)
