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

Each pass rounds the squared distance one way (``ROUNDINGS``), chosen as
``aosx`` chooses the lowering of that pass (``pass_roundings``): the passes
``aosx`` sends through its banded Pallas kernel (``jfa_pass_pallas``, static
shifts, fewer than 4000 rows, step <= 128) round d2 as XLA:CPU builds that
kernel's owner plane inside a jit, every other pass as the XLA lowering's
fold. The port does not mirror one thing of the Pallas build: its x and y
planes are selected by folds rounded apart from the owner plane's, so that a
cell's carried position can be another seed's (ROADMAP section 3). Here a
cell's position stays its owner's seed.
"""

from __future__ import annotations

import torch

from ..config import Statics
from ..ops import div_const, fma, lanes
from ..perceive.raster import f32, live_mask
from ..types import GridWorld, SeedSet

INF = 3.4e38
# aosx/gvd/jfa_pass_pallas.py's MAX_STEP, and the grid height from which
# aosx/gvd/voronoi.py's jump_flood keeps every pass on the XLA lowering
PALLAS_MAX_STEP = 128
PALLAS_MAX_ROWS = 4000
# A pass's rounding of d2 for dx = px - cellx, dy = py - celly: a letter for
# each candidate, the cell's own owner first, then the neighbours in
# jacobi_fold's order ((dys, dxs) = (-1, -1), (-1, 0), ..., (1, 1)). "x" is
# fma(dx, dx, dy * dy), "y" fma(dy, dy, dx * dx), "u" dx * dx + dy * dy with
# both products rounded. As XLA:CPU compiles aosx's flood inside a jit
# (tests/torch_reference/owner_cells.py reads them from its build):
ROUNDINGS = {
    # the XLA lowering's fold (static or dynamic shifts)
    "xla": "xxxxxxxxx",
    # the Pallas kernel's owner plane in a pass whose position planes are used
    "pallas": "yyyxxxxxx",
    # the same in a flood's last pass, whose position planes XLA drops
    "pallas_last": "uuuuxuxxx",
}


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


def pass_roundings(s: Statics, steps):
    """The ``ROUNDINGS`` key of each pass of a flood over ``steps``: the
    Pallas ones where ``aosx``'s ``jump_flood`` runs the pass through the
    Pallas pass kernel under ``s`` (aosx/gvd/voronoi.py's rule), else
    "xla"."""
    pallas = s.jfa_pass_pallas and not s.jfa_dynamic_shifts and s.grid_h < PALLAS_MAX_ROWS
    last = len(steps) - 1
    return [("pallas_last" if i == last else "pallas") if pallas and k <= PALLAS_MAX_STEP
            else "xla" for i, k in enumerate(steps)]


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


def jacobi_fold(o0, x0, y0, neighbors, S: int, cellx, celly, rounding: str = "xla"):
    """One Jacobi JFA update: fold the 8 pass-start neighbour triples
    (owner, x, y) into the state with a lexicographic (d2, owner) min, each
    candidate's d2 rounded as ``ROUNDINGS[rounding]`` says (the CUDA kernel
    does the same)."""

    def dist2(px, py, form):
        dx = px - cellx
        dy = py - celly
        if form == "y":
            return fma(dy, dy, dx * dx)
        if form == "u":
            return dx * dx + dy * dy
        return fma(dx, dx, dy * dy)

    forms = ROUNDINGS[rounding]
    inf = torch.tensor(INF, dtype=torch.float32, device=o0.device)
    d2 = torch.where(o0 < S, dist2(x0, y0, forms[0]), inf)
    o, x, y = o0, x0, y0
    for (no, nx, ny), form in zip(neighbors, forms[1:], strict=True):
        nd = torch.where(no < S, dist2(nx, ny, form), inf)
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
    steps = _passes(s)
    owner = jfa_flood(owner, table, steps, S, grid.origin_x, grid.origin_y, s.resolution,
                      rounding=pass_roundings(s, steps))
    return torch.where(live_mask(grid) & (owner < S), owner, -1)
