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
rows, step <= 128) over more row bands than one or over one, the XLA
lowering, and the banded ``jump_flood_sharded``. Because the planes round apart, at an exact tie of
two seeds the owner plane can take one and a position plane the other: the
cell then carries a position that is no seed's, and the next passes fold
from it, as the JAX package's flood does. Where XLA fuses a one-band pass
into its consumer and recomputes it there for the cell's own candidate, the
flood carries the two recomputed triples too (``CHAINS``).
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
# dx * dx), "u" dx * dx + dy * dy with both products rounded.
#
# The rule, read from XLA:CPU's optimized HLO and LLVM IR (jax 0.9.0): XLA
# builds each plane of a pass as a loop fusion that recomputes the fold, each
# d2 an add(dx * dx, dy * dy). LLVM's Reassociate pass puts the operand of
# lower rank first (the ranks follow the order of the loads in the fusion's
# loop body), and the instruction selector contracts that operand's product
# into the add, or neither where the products lie in another basic block
# ("u"). So a candidate's form follows from the order in which its fusion
# loads the candidate's x and y, and which fusions there are follows from
# the lowering:
#   - a pass inside a loop (the Pallas pass over more than one row band, the
#     dynamic shifts) or whose input and output are materialized (a pass
#     jitted alone, jump_flood_sharded's bands) is three fusions, one a
#     plane, each folding the carried planes: the keys below;
#   - a Pallas pass over one band (nb = 1: H <= 104 rows and H + 2 halo
#     <= 320) loses its grid loop, and where its consumer reads it through
#     slices (a one-band pass at a step that is a multiple of 8, or a static
#     XLA pass), XLA fuses its fold into every consumer fusion and
#     recomputes it there for the cell's own candidate: a chain (CHAINS).
# Each key was checked by evaluating the optimized HLO in numpy with every d2
# rounded as the IR says (bitwise JAX's flood at 32 x 64, 64 x 128, 96 x 128,
# 64 x 256, 104 x 256 and 64 x 512) and on whole jitted floods
# (tests/test_torch_flood_sizes.py, test_torch_flood_bench.py):
ROUNDINGS = {
    # a pass of the XLA lowering, the last one too: static shifts (a pass
    # jitted alone and the bench flood's steps 256-1024), dynamic shifts
    # (make_mc_reference.py's prepare_world jit: all 128 worlds' floods,
    # worlds 7, 74, 102 and 118 too) and jump_flood_sharded's banded
    # passes. A whole static-shift flood has no result on XLA:CPU (at
    # MC_STATICS its last fusion recomputes the earlier passes through 191
    # outlined functions, 6.0e23 calls a cell by its IR's call graph), so
    # the JAX package runs MC_STATICS on CPU devices with dynamic shifts
    # (aosx/config.py), and the port's XLA floods round as those
    "xla": ("xxxxxxxxx", "yyyyyyyyy", "xxxxxxxxx"),
    # the Pallas pass over more than one band, its planes going on (the grid
    # loop body's three fusions; the bench flood's steps 1-128)
    "pallas": ("yyyxxxxxx", "yyyyyyyyy", "xxxxxxxxx"),
    # a flood's last Pallas pass inside a jit, its owner plane alone (over
    # one band or more)
    "pallas_last": ("uuuuxuxxx", "yyyyyyyyy", "xxxxxxxxx"),
    # a one-band Pallas pass whose planes are fusions of their own: no
    # consumer fuses it, or a chain's first pass ("band_window",
    # "band_slice": the copy of its planes that its consumer's neighbours
    # read)
    "band": ("xxxxxxxxx", "xxyyyyyyy", "xxxxxxxxx"),
    # a pass fused into a chain (CHAINS["chain"])
    "chain": ("xxxxxxxxx", "xyyyyyyyy", "xxxxxxxxx"),
}
# jump_flood_sharded's last pass rounds its owner plane as the Pallas one
ROUNDINGS["sharded_last"] = ROUNDINGS["pallas_last"]
ROUNDINGS["band_window"] = ROUNDINGS["band_slice"] = ROUNDINGS["band"]
# The banded loop reads the cells' x from a row of W coordinates that XLA
# hoists out of the loop, origin + f32(index) * res, which LLVM contracts
# into one fma where it keeps the row's loop (W >= 448) and rounds twice
# where it unrolls the loop and folds the products into constants (W <= 447;
# read from the IR and the object of that fusion at 136 x 256, and pinned on
# whole floods at 0.05 m from origin 3.5: 128 to 447 wide twice, 448 to 2048
# wide once; tests/test_torch_flood_sizes.py): the keys whose passes take the
# cells' x so, with their forms.
SPLIT_X = {"pallas_narrow": "pallas", "pallas_last_narrow": "pallas_last"}
for _k, _v in SPLIT_X.items():
    ROUNDINGS[_k] = ROUNDINGS[_v]
# the widest grid whose coordinate row LLVM unrolls (447 yes, 448 no)
SPLIT_X_MAX_W = 447

# A chain carries, besides the planes its consumers' neighbours read ("m":
# the owner, x and y planes), the two triples its consumers recompute for the
# cell's own candidate: "a", as the owner and y planes' fusions recompute it,
# and "b", as the x plane's fusion does (each one fold, its owner, x and y
# sharing their forms). For each chain key: the triple each plane's fold
# starts from ("own", for the owner, x, y planes), and the forms and the
# starting triple of the folds that make "a" and "b".
# A chain's fusions come in two kinds, and a chain pass in two versions of
# its planes and triples: the fusions that write a pass's planes padded for
# the next pass are vectorized and round a cell's y once, fma(iy, res,
# origin); the next pass reads them, or copies of them, for all but the two
# neighbours in the cell's row. Those two it reads from fusions that write
# the planes shifted by the next step, scalar loops whose row product lies
# in the outer loop's block, so they round the y twice (read from each
# fusion's IR and checked against XLA's own compiled kernels called on the
# flood's buffers; a cell's x is rounded once in both). "p" and "s":
# jfa_pass_cuda._chain_pass.
CHAIN_VERSIONS = ("p", "s")

CHAINS = {
    # the chain's first pass, its planes folded from the carried planes as
    # "band"; "a" and "b" as its consumers recompute it, from its step-1
    # window's shifted copies or from row slices
    "band_window": dict(own="mmm", a=("xxyyyyyyy", "m"), b=("xxxxxxxxx", "m")),
    "band_slice": dict(own="mmm", a=("xxxxxxxxx", "m"), b=("xxyyyyyyy", "m")),
    # a pass fused into the chain: the owner and y planes fold from "a", the
    # x plane from "b", and "a" and "b" go on
    "chain": dict(own="aba", a=("xxxxxxxxx", "a"), b=("xyyyyyyyy", "b")),
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


def band_height(grid_h: int, hp: int) -> int:
    """The row band of ``aosx``'s Pallas pass (its ``_band_height``): the
    largest divisor of grid_h that is a multiple of 8, at most 104 rows, with
    a window (band + 2 hp halo rows) of at most 320 rows; 8 where none is."""
    best = 8
    d = 8
    while d <= grid_h:
        if grid_h % d == 0 and d + 2 * hp <= 320 and d <= 104:
            best = d
        d += 8
    return best


def pallas_bands(grid_h: int, step: int) -> int:
    """How many row bands ``aosx``'s Pallas pass runs a pass at ``step`` over
    (nb = H // band, the band for a halo of the step rounded up to 8)."""
    hp = max(8, ((step + 7) // 8) * 8)
    return grid_h // band_height(grid_h, hp)


# the keys of the passes after which a pass that XLA can fuse joins a chain
ROUNDINGS_CHAINED = ("band", "band_window", "band_slice", "chain")


def pass_roundings(s: Statics, steps, shape=None):
    """The ``ROUNDINGS`` key of each pass of a flood over ``steps`` and
    planes of ``shape`` (H, W; None: the statics' grid) as ``aosx``'s
    ``jump_flood`` lowers it under ``s`` (aosx/gvd/voronoi.py's rule, which
    takes H and W from the planes): where it runs the pass through the
    Pallas pass kernel (static shifts, fewer than 4000 rows, step <= 128),
    "pallas" over more bands than one and "band" over one, the last pass
    "pallas_last" (over more bands than one on planes at most SPLIT_X_MAX_W
    wide, "pallas_narrow" and "pallas_last_narrow"); a pass that
    XLA fuses into the previous one-band pass's chain (a one-band pass at a
    step that is a multiple of 8, or a static XLA pass) "chain", the chain's
    first pass "band_window" (step 1) or "band_slice"; else "xla"."""
    H, W = shape if shape is not None else (s.grid_h, s.grid_w)
    pallas = s.jfa_pass_pallas and not s.jfa_dynamic_shifts and H < PALLAS_MAX_ROWS
    last = len(steps) - 1
    out = []
    for i, k in enumerate(steps):
        if not pallas or (k > PALLAS_MAX_STEP and not (out and out[-1] in ROUNDINGS_CHAINED)):
            out.append("xla")
        elif i == last:
            out.append("pallas_last")
        elif k > PALLAS_MAX_STEP or (k % 8 == 0 and pallas_bands(H, k) == 1
                                     and out and out[-1] in ROUNDINGS_CHAINED):
            out.append("chain")
        else:
            out.append("band" if pallas_bands(H, k) == 1 else "pallas")
    if pallas and W <= SPLIT_X_MAX_W:
        out = [r + "_narrow" if r in ("pallas", "pallas_last") and pallas_bands(H, k) > 1
               else r for r, k in zip(out, steps)]
    for i in range(1, len(out)):
        if out[i] == "chain" and out[i - 1] == "band":
            out[i - 1] = "band_window" if steps[i - 1] % 8 else "band_slice"
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


def jacobi_fold(o0, x0, y0, neighbors, S: int, cellx, celly, rounding: str = "xla",
                chain=None):
    """One Jacobi JFA update of the carried planes (owner, x, y): each plane
    is the lexicographic (d2, owner) min over the cell's own triple and the
    8 pass-start neighbour triples, with each candidate's d2 rounded as that
    plane's forms in ``ROUNDINGS[rounding]`` say (the CUDA kernel does the
    same). Planes with the same forms and own triple share one fold. For a
    key of ``CHAINS``, ``chain`` is the triples (a, b) the pass's folds may
    start from (None at a chain's first pass) and the result is
    ((owner, x, y), a, b), the triples the chain carries on."""
    forms = ROUNDINGS[rounding]
    spec = CHAINS.get(rounding)
    own = {"m": (o0, x0, y0)}
    if chain is not None:
        own["a"], own["b"] = chain
    if len(neighbors) != 8:
        raise ValueError(f"jacobi_fold: 8 neighbours, got {len(neighbors)}")
    inf = torch.tensor(INF, dtype=torch.float32, device=o0.device)
    d2s = {}

    def dist2(cand, key, form):
        if (key, form) not in d2s:
            no, px, py = cand
            dx = px - cellx
            dy = py - celly
            if form == "y":
                v = fma(dy, dy, dx * dx)
            elif form == "u":
                v = dx * dx + dy * dy
            else:
                v = fma(dx, dx, dy * dy)
            d2s[key, form] = torch.where(no < S, v, inf)
        return d2s[key, form]

    folds = {}

    def fold(f, src):
        if (f, src) in folds:
            return folds[f, src]
        o, x, y = own[src]
        d2 = dist2(own[src], src, f[0])
        for m in range(1, 9):
            no, nx, ny = neighbors[m - 1]
            nd = dist2(neighbors[m - 1], m, f[m])
            better = (nd < d2) | ((nd == d2) & (no < o))
            o = torch.where(better, no, o)
            x = torch.where(better, nx, x)
            y = torch.where(better, ny, y)
            d2 = torch.where(better, nd, d2)
        folds[f, src] = (o, x, y)
        return folds[f, src]

    srcs = spec["own"] if spec else "mmm"
    planes = tuple(fold(forms[q], srcs[q])[q] for q in range(3))
    if spec is None:
        return planes
    return planes, fold(*spec["a"]), fold(*spec["b"])


def jump_flood(grid: GridWorld, seeds: SeedSet, s: Statics):
    """Nearest-seed ownership over the live region. Returns owner [*B, H,W]
    i32: seed index, or -1 outside the live region / with no seeds.
    Distances are measured from cell corners (world = origin + cell*res)."""
    from .jfa_pass_cuda import jfa_flood

    S = seeds.xy.shape[-2]
    owner, table = _jfa_init(grid, seeds, s)
    steps = _passes(s)
    owner = jfa_flood(owner, table, steps, S, grid.origin_x, grid.origin_y, s.resolution,
                      rounding=pass_roundings(s, steps, tuple(grid.occ.shape[-2:])))
    return torch.where(live_mask(grid) & (owner < S), owner, -1)
