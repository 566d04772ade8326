"""Grid-space Voronoi field via jump flooding (mirror of
``aosx/gvd/voronoi.py``).

The "1+JFA" variant (an extra step-1 pass first) with JACOBI passes: all 8
directional candidates are read from the pass-start planes and folded with a
lexicographic (d2, owner) min, ties to the lower seed index. The flood
carries three planes as ``aosx`` does, the owner and the owner position's x
and y, each selected by a fold of its own; d2 is measured from a
candidate's carried position. All passes of a flood are one call of kernel
K1 (``jfa_pass_cuda.jfa_flood``) with no host read in it. Grids and seed
sets with a leading world axis flood in that one call too: each world keeps
its own origin, live bounds and table, and runs the same pass list
(``_passes`` is static).

Each plane rounds each candidate's squared distance in one of three forms
(``ROUNDINGS``), as XLA:CPU builds that plane in the lowering ``aosx`` runs
the pass in (``pass_roundings``): the passes ``aosx`` sends through its
banded Pallas kernel (``jfa_pass_pallas``, static shifts, fewer than 4000
rows, step <= 128), the static-shift and dynamic-shift XLA lowerings, and
the banded ``jump_flood_sharded``. Because the planes round apart, at an
exact tie of two seeds the owner plane can take one and a position plane
the other: the cell then carries a position that is no seed's, and the next
passes fold from it, as the JAX package's flood does.
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
# A pass's rounding of d2 for dx = px - cellx, dy = py - celly in each of the
# three planes (owner, x, y): a letter for each candidate, the cell's own
# triple first, then the neighbours in jacobi_fold's order ((dys, dxs) = (-1,
# -1), (-1, 0), ..., (1, 1)). "x" is fma(dx, dx, dy * dy), "y" fma(dy, dy,
# dx * dx), "u" dx * dx + dy * dy with both products rounded. XLA:CPU builds
# each plane of a pass as a loop fusion of its own that recomputes the whole
# fold (in the optimized HLO of a static-shift pass, the ROOT tuple of
# or_select_fusion, select_select_fusion.1 and select_select_fusion for the
# owner, x and y planes; the same three in aosx's jump_flood_sharded block
# and its dynamic-shift loop body; in the interpret-mode Pallas pass, one
# fusion a plane inside the grid loop), and LLVM contracts each fusion's
# (px - cx)**2 + (py - cy)**2 its own way. Each form was pinned, with jax
# 0.9.0 on the CPU, on planes of seeded near ties (pairs of candidates at
# swapped offsets (a, b), (b, a), or one on an axis, 2,700-4,000 pairs a pass
# at steps 1, 2, 8, 64, 100 on 256 x 512), on which exactly one assignment of
# forms reproduces JAX's plane, and then on whole jitted floods with lines of
# exact ties (tests/test_torch_flood_bench.py's diagonal pairs at 192 x 256;
# at 64 x 128 too for the dynamic shifts and the sharded flood, while the
# Pallas flood there fits none of these forms: ROADMAP section 3), the bench
# orchard and Monte-Carlo worlds 0-127:
ROUNDINGS = {
    # a pass of the XLA lowerings whose planes go on: static shifts (a pass
    # jitted alone and the bench flood's steps 256-1024), dynamic shifts
    # (make_mc_reference.py's prepare_world jit: all 128 worlds' floods,
    # worlds 102 and 118 too) and jump_flood_sharded's banded passes; the
    # dynamic-shift flood's last pass rounds its owner plane so too
    "xla": ("xxxxxxxxx", "yyyyyyyyy", "xxxxxxxxx"),
    # the static-shift flood's last pass, whose x and y planes XLA drops
    # (pinned on the pass jitted alone, returning its owner plane: the whole
    # static-shift flood's jit did not compile within 50 minutes even at
    # 64 x 128, so no whole flood confirms it)
    "xla_last": ("uuuuuuuuu", "yyyyyyyyy", "xxxxxxxxx"),
    # the Pallas kernel's pass whose planes go on (the bench flood's steps
    # 1-128; a pass jitted alone at 192 x 256 rounds some owner cells
    # otherwise at steps <= 16, the whole jit as here)
    "pallas": ("yyyxxxxxx", "yyyyyyyyy", "xxxxxxxxx"),
    # the Pallas kernel's last pass inside a jit, its owner plane alone
    "pallas_last": ("uuuuxuxxx", "yyyyyyyyy", "xxxxxxxxx"),
}
# jump_flood_sharded's last pass rounds its owner plane as the Pallas one
ROUNDINGS["sharded_last"] = ROUNDINGS["pallas_last"]


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
    """The ``ROUNDINGS`` key of each pass of a flood over ``steps`` as
    ``aosx``'s ``jump_flood`` lowers it under ``s`` (aosx/gvd/voronoi.py's
    rule): the Pallas ones where it runs the pass through the Pallas pass
    kernel, else "xla", the last pass "xla_last" with static shifts."""
    pallas = s.jfa_pass_pallas and not s.jfa_dynamic_shifts and s.grid_h < PALLAS_MAX_ROWS
    last = len(steps) - 1
    out = []
    for i, k in enumerate(steps):
        if pallas and k <= PALLAS_MAX_STEP:
            out.append("pallas_last" if i == last else "pallas")
        else:
            out.append("xla_last" if i == last and not s.jfa_dynamic_shifts else "xla")
    return out


def _jfa_init(grid: GridWorld, seeds: SeedSet, s: Statics):
    """Seed scatter -> (owner [*B, H,W] i32 with S = no owner, table
    [*B, S+1, 2] f32 = seeds.xy with the row (1e9, 1e9) of "no owner"
    appended). Seeds sharing a cell: the lowest valid seed index wins
    (scatter-min, which no order of the writes changes). The initial
    position planes are table[owner], the owners' seeds (``aosx`` scatters
    the winner's coordinates per seed, the same values); the flood takes
    them from the table. Each world scatters into its own plane."""
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
    """One Jacobi JFA update of the carried planes (owner, x, y): each plane
    is the lexicographic (d2, owner) min over the cell's own triple and the
    8 pass-start neighbour triples, with each candidate's d2 rounded as that
    plane's forms in ``ROUNDINGS[rounding]`` say (the CUDA kernel does the
    same). Planes with the same forms share one fold."""
    forms = ROUNDINGS[rounding]
    cands = [(o0, x0, y0)] + list(neighbors)
    if len(cands) != 9:
        raise ValueError(f"jacobi_fold: 8 neighbours, got {len(cands) - 1}")
    inf = torch.tensor(INF, dtype=torch.float32, device=o0.device)
    d2s = {}

    def dist2(m, form):
        if (m, form) not in d2s:
            no, px, py = cands[m]
            dx = px - cellx
            dy = py - celly
            if form == "y":
                v = fma(dy, dy, dx * dx)
            elif form == "u":
                v = dx * dx + dy * dy
            else:
                v = fma(dx, dx, dy * dy)
            d2s[m, form] = torch.where(no < S, v, inf)
        return d2s[m, form]

    def fold(f):
        o, x, y = cands[0]
        d2 = dist2(0, f[0])
        for m in range(1, 9):
            no, nx, ny = cands[m]
            nd = dist2(m, f[m])
            better = (nd < d2) | ((nd == d2) & (no < o))
            o = torch.where(better, no, o)
            x = torch.where(better, nx, x)
            y = torch.where(better, ny, y)
            d2 = torch.where(better, nd, d2)
        return o, x, y

    folds = {}
    for f in forms:
        if f not in folds:
            folds[f] = fold(f)
    return folds[forms[0]][0], folds[forms[1]][1], folds[forms[2]][2]


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
