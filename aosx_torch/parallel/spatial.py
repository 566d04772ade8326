"""Row-sharded grid stencils (mirror of ``aosx/parallel/spatial.py``).

``aosx`` runs these under ``shard_map`` from one process over a ``Mesh`` of
devices: every function takes whole planes and returns whole planes, and
inside, each device holds one band of rows and trades halo rows with its
neighbours through ``ppermute``. The port keeps that single-controller
model with a ``Mesh`` of its own, a tuple of ``torch.device``s and an axis
name:

- the planes are split into row bands, band ``k`` on ``mesh.devices[k]``;
- a ``ppermute`` copies a band's rows to the neighbour's device, and a band
  with no sender receives zeros, as in JAX (the flood then fills S or 1e9);
- the ``psum`` of the thinning's changed flag is an OR of the bands' flags.

``Mesh((torch.device("cuda", 0),) * 4, ("space",))`` runs the band and halo
logic on one card; with distinct devices the bands spread over them. No
``torch.distributed`` group is involved: the entry points stay plain calls,
as in ``aosx``, and the same code runs on a CPU mesh in the tests.

- ``inflate_sharded``: an ``inflation_cells`` halo, then ``dilate_disc``.
- ``skeletonize_sharded``: morph open with a 1-row halo and the global live
  and interior masks, then Zhang-Suen with a halo before each sub-iteration,
  to the fixpoint or ``skeleton_max_iters``.
- ``jump_flood_sharded``: a pass's row shift by ``d = q * Hb + r`` rows is at
  most two whole-band moves and a local stitch; the fold is
  ``voronoi.jacobi_fold`` over the carried owner, x and y planes, each
  rounded as XLA:CPU builds ``aosx``'s sharded flood (the "xla" forms, the
  last pass "sharded_last").

All three are bitwise equal to the single-device stages
(tests/test_torch_spatial.py). These are the plain PyTorch counterparts of
``aosx``'s XLA stencils; no TPU kernel is on this path, so none of K1/K2 is
launched here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Statics
from ..gvd.jfa_pass_cuda import FAR
from ..gvd.voronoi import _jfa_init, _passes, jacobi_fold
from ..ops import fma
from ..perceive.raster import dilate_disc, shift2d
from ..perceive.skeleton import _CROSS
from ..perceive.skeleton_cuda import _subiter
from ..types import GridWorld, SeedSet


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices[k]`` holds band (or lane block) k."""

    devices: tuple
    axis_names: tuple = ("space",)

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        assert len(self.axis_names) == 1, "only one-axis meshes"

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def _split(plane, mesh: Mesh, Hb: int):
    """Band k of ``plane`` (rows k*Hb .. (k+1)*Hb) on mesh.devices[k]."""
    return [plane[k * Hb:(k + 1) * Hb].to(dev) for k, dev in enumerate(mesh.devices)]


def _join(bands, device):
    return torch.cat([b.to(device) for b in bands])


def _ppermute(parts, off: int, mesh: Mesh):
    """parts[k] sent to band k + off: band k receives parts[k - off] on its
    device, or zeros where no band sends."""
    n = len(parts)
    return [parts[k - off].to(mesh.devices[k]) if 0 <= k - off < n
            else torch.zeros_like(parts[k]) for k in range(n)]


def _halo(bands, rows: int, mesh: Mesh):
    """Each band with ``rows`` rows of its upper and lower neighbours around
    it (zeros at the edges of the mesh)."""
    up = _ppermute([b[-rows:] for b in bands], 1, mesh)
    down = _ppermute([b[:rows] for b in bands], -1, mesh)
    return [torch.cat([u, b, d]) for u, b, d in zip(up, bands, down)]


def _rows_cols(k: int, Hb: int, W: int, pad: int, device):
    """Global row and column index planes of band k's rows, with ``pad``
    halo rows above and below."""
    gy = torch.arange(-pad, Hb + pad, dtype=torch.int32, device=device)[:, None] + k * Hb
    gx = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return gy.expand(Hb + 2 * pad, W), gx.expand(Hb + 2 * pad, W)


def _scalars(mesh: Mesh, *xs):
    """Each scalar tensor on every band's device."""
    return [[x.to(dev) for x in xs] for dev in mesh.devices]


def _with_occ(grid: GridWorld, occ) -> GridWorld:
    return GridWorld(occ, grid.origin_x, grid.origin_y, grid.h_cells, grid.w_cells)


def inflate_sharded(grid: GridWorld, s: Statics, mesh: Mesh, axis: str = "space") -> GridWorld:
    """Row-sharded disc inflation with an ``inflation_cells`` halo exchange."""
    ic = s.inflation_cells
    n = mesh.shape[axis]
    H, W = grid.occ.shape
    assert H % n == 0, (H, n)
    Hb = H // n
    assert Hb > ic, "shard height must exceed the halo"
    out = []
    for k, (padded, (h_cells, w_cells)) in enumerate(zip(
            _halo(_split(grid.occ, mesh, Hb), ic, mesh),
            _scalars(mesh, grid.h_cells, grid.w_cells))):
        dil = dilate_disc(padded, ic)[ic:ic + Hb]
        gy, gx = _rows_cols(k, Hb, W, 0, dil.device)
        live = (gy < h_cells) & (gx < w_cells)
        out.append(torch.where(live, dil, torch.zeros_like(dil)))
    return _with_occ(grid, _join(out, grid.occ.device))


def skeletonize_sharded(grid: GridWorld, s: Statics, mesh: Mesh,
                        axis: str = "space") -> GridWorld:
    """Row-sharded skeletonization: morph open + Zhang-Suen to the fixpoint.

    Each 3x3 stencil runs on a band padded with one halo row from each
    neighbour (zeros at the mesh's edges, as ``shift2d``'s global zero fill),
    with the GLOBAL live and interior masks, and keeps the band's own rows.
    The loop stops after the first iteration that changes no band (an OR of
    the bands' flags) or after ``skeleton_max_iters`` iterations. Bitwise
    equal to ``perceive.skeleton.skeletonize`` (reference:
    aos_seed_gen_node.cpp:672-705)."""
    n = mesh.shape[axis]
    H, W = grid.occ.shape
    assert H % n == 0, (H, n)
    Hb = H // n
    assert Hb >= 2, "shard height must cover the 1-row stencil halo"
    masks = []
    for k, (h_cells, w_cells) in enumerate(_scalars(mesh, grid.h_cells, grid.w_cells)):
        # padded row r of band k holds global row k*Hb + r - 1
        py, px = _rows_cols(k, Hb, W, 1, mesh.devices[k])
        live = (py >= 0) & (py < h_cells) & (px < w_cells)
        interior = (py >= 1) & (py < h_cells - 1) & (px >= 1) & (px < w_cells - 1)
        outside = {(dy, dx): (py - dy < 0) | (py - dy >= h_cells)
                   | (px - dx < 0) | (px - dx >= w_cells) for dy, dx in _CROSS}
        masks.append((live, interior, outside))

    def stencil(bands, fn):
        """fn(padded band, masks of band k) on every band; keeps own rows."""
        return [fn(p, *masks[k])[1:Hb + 1] for k, p in enumerate(_halo(bands, 1, mesh))]

    def erode(p, live, interior, outside):
        one = torch.ones_like(p)
        er = one
        for dy, dx in _CROSS:
            er = torch.minimum(er, torch.where(outside[dy, dx], one, shift2d(p, dy, dx)))
        return torch.where(live, er, torch.zeros_like(er))

    def dilate(p, live, interior, outside):
        di = torch.zeros_like(p)
        for dy, dx in _CROSS:
            di = torch.maximum(di, shift2d(p, dy, dx))
        return torch.where(live, di, torch.zeros_like(di))

    p = stencil(stencil(_split(grid.occ, mesh, Hb), erode), dilate)
    it = 0
    while it < s.skeleton_max_iters:
        q = stencil(p, lambda b, live, interior, outside: _subiter(b, 0, interior))
        q = stencil(q, lambda b, live, interior, outside: _subiter(b, 1, interior))
        changed = any(bool((a != b).any()) for a, b in zip(q, p))
        p, it = q, it + 1
        if not changed:
            break
    return _with_occ(grid, _join(p, grid.occ.device))


def jump_flood_sharded(grid: GridWorld, seeds: SeedSet, s: Statics, mesh: Mesh,
                       axis: str = "space"):
    """Row-sharded 1+JFA nearest-seed ownership (``gvd.voronoi.jump_flood``
    on planes split into row bands).

    A pass at offset k reads rows shifted by +-k, and k reaches H/2, so no
    halo will do. A global row shift by d rows (``q, r = divmod(d, Hb)``,
    floor semantics for negative d) is built from at most two whole-band
    moves, the bands of i-q-1 and i-q, stitched on band i:

        out rows [i*Hb, (i+1)*Hb) = band(i-q-1)[Hb-r:] ++ band(i-q)[:Hb-r]

    with owner S (positions 1e9) outside [0, H). Column shifts stay on the
    band (fill S, positions 0.0). Positions never matter where the owner is
    S. The owner, x and y planes are folded in the forms XLA:CPU gives
    ``aosx``'s sharded flood (``voronoi.ROUNDINGS``: "xla", the last pass
    "sharded_last"). Returns owner i32 [H, W] on the grid's device: seed
    index, or -1 outside the live region."""
    n = mesh.shape[axis]
    H, W = grid.occ.shape
    assert H % n == 0, (H, n)
    Hb = H // n
    S = seeds.xy.shape[0]
    owner0, table = _jfa_init(grid, seeds, s)
    pos = table[owner0.long()]
    o = _split(owner0, mesh, Hb)
    x = _split(pos[..., 0].contiguous(), mesh, Hb)
    y = _split(pos[..., 1].contiguous(), mesh, Hb)
    gys, cells, lives = [], [], []
    for k, (h_cells, w_cells, ox, oy) in enumerate(_scalars(
            mesh, grid.h_cells, grid.w_cells, grid.origin_x, grid.origin_y)):
        gy, gx = _rows_cols(k, Hb, W, 0, mesh.devices[k])
        # origin + f32(index) * res rounded once, as jfa_pass_cuda.cell_coords
        res = torch.full((Hb, W), s.resolution, dtype=torch.float32, device=gy.device)
        cells.append((fma(gx.to(torch.float32), res, ox.to(torch.float32).expand(Hb, W)),
                      fma(gy.to(torch.float32), res, oy.to(torch.float32).expand(Hb, W))))
        gys.append(gy)
        lives.append((gy < h_cells) & (gx < w_cells))

    def shift_rows(bands, d: int, fill):
        """out[g] = plane[g - d] in global rows, ``fill`` outside [0, H)."""
        if d == 0:
            return bands
        q, r = divmod(d, Hb)
        lo = _ppermute(bands, q, mesh)
        if r == 0:
            out = lo
        else:
            hi = _ppermute(bands, q + 1, mesh)
            out = [torch.cat([h[Hb - r:], b[:Hb - r]]) for h, b in zip(hi, lo)]
        return [torch.where((gy - d < 0) | (gy - d >= H), torch.full_like(b, fill), b)
                for gy, b in zip(gys, out)]

    steps = _passes(s)
    for i, step in enumerate(steps):
        rounding = "sharded_last" if i == len(steps) - 1 else "xla"
        rows = {dys: (shift_rows(o, dys * step, S), shift_rows(x, dys * step, FAR),
                      shift_rows(y, dys * step, FAR)) for dys in (-1, 0, 1)}
        new = []
        for k in range(n):
            neighbors = []
            for dys in (-1, 0, 1):
                od, xd, yd = (p[k] for p in rows[dys])
                for dxs in (-1, 0, 1):
                    if dys == 0 and dxs == 0:
                        continue
                    neighbors.append((shift2d(od, 0, dxs * step, S),
                                      shift2d(xd, 0, dxs * step, 0.0),
                                      shift2d(yd, 0, dxs * step, 0.0)))
            new.append(jacobi_fold(o[k], x[k], y[k], neighbors, S, *cells[k], rounding))
        o, x, y = (list(t) for t in zip(*new))
    out = [torch.where(live & (ob < S), ob, torch.full_like(ob, -1))
           for live, ob in zip(lives, o)]
    return _join(out, grid.occ.device)
