"""Point-cloud preprocessing: radius outlier removal + clipping + exclusion
discs as fixed-shape masks (mirror of ``aosx/perceive/points.py``;
reference: aos_seed_gen_node.cpp:230-538).

ROR methods:
- 'sorted': sort by x and compare each block of 2048 points with itself and
            its two neighbour blocks (the main path);
- 'exact' : all pairs, elementwise (xi-xj)^2 sums in f32;
- 'pallas': all pairs, d2 = (|a|^2 + |b|^2) - 2 a.b in f32, through kernel
            K3 (``ror_cuda.ror_counts``) on a CUDA tensor and its plain
            version on a CPU tensor;
- 'mxu'   : the same d2 formula, which ``aosx`` takes to XLA dots; here the
            same path as 'pallas'.
"""

from __future__ import annotations

import math

import torch

from ..config import AosParams, Statics
from ..geom import active_bounds
from ..guards import GUARD_ROR_SPAN
from ..ops import chunk_rows, lanes, sqrt, take
from ..types import PointCloud, Polygon
from . import ror_cuda

# rows of the [rows, 3W] distance tile evaluated at once (for all the worlds
# of a group together: ops.chunk_rows)
_ROW_CHUNK = 256


def _d2(a, b):
    """Squared 3-D distance, summed as (dx^2 + dy^2) + dz^2."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def park(xyz, valid):
    """Invalid points parked far away, each at its own spot (1e9 + i*1e3),
    so that they never count each other in an exact pass. xyz [*B, n, 3]."""
    n = xyz.shape[-2]
    far = 1e9 + torch.arange(n, dtype=torch.float32, device=xyz.device)[:, None] * 1e3
    return torch.where(valid[..., None], xyz, far)


def pad_to_block(pts, block: int):
    """[*B, n, 3] points padded to a multiple of ``block`` rows at -1e9."""
    pad = -pts.shape[-2] % block
    return torch.cat([pts, torch.full(pts.shape[:-2] + (pad, 3), -1e9, dtype=torch.float32,
                                      device=pts.device)], dim=-2)


def ror_counts(xyz, valid, radius, *, method: str = "exact", block: int = None):
    """Number of OTHER valid points within ``radius`` (3-D), per point.
    xyz [*B, n, 3], valid [*B, n]: each world of the leading axes B counts
    its own points (``radius`` 0-d or of shape B).

    Returns (counts [*B, n] i32, span_violated bool [*B]); the flag is only
    ever True for 'sorted' when its block-span precondition breaks
    (guards.GUARD_ROR_SPAN)."""
    if method not in ("exact", "sorted", "pallas", "mxu"):
        raise ValueError(f"unknown ror method {method!r}")
    B = xyz.shape[:-2]
    n = xyz.shape[-2]
    dev = xyz.device
    pts = park(xyz, valid)
    r2 = torch.as_tensor(radius, dtype=torch.float32, device=dev) ** 2
    no_span = torch.zeros(B, dtype=torch.bool, device=dev)
    if method == "sorted":
        return _ror_counts_sorted(pts, n, r2)
    if method in ("pallas", "mxu"):
        # padding never counts towards a point (-1e9 lies far from every
        # point and parked spot), so one block size serves both
        return ror_cuda.ror_counts(pad_to_block(pts, block or 2048), r2)[..., :n] - 1, no_span
    block = block or 2048
    r2l = r2.reshape(r2.shape + (1, 1))
    cnt = torch.zeros(B + (n,), dtype=torch.int32, device=dev)
    rc = chunk_rows(_ROW_CHUNK, math.prod(B))
    for r0 in range(0, n, rc):
        rows = pts[..., r0:r0 + rc, :]
        c = torch.zeros(rows.shape[:-1], dtype=torch.int32, device=dev)
        for c0 in range(0, n, block):
            d2 = _d2(rows[..., :, None, :], pts[..., None, c0:c0 + block, :])
            c += (d2 <= r2l).sum(dim=-1, dtype=torch.int32)
        cnt[..., r0:r0 + rc] = c
    # exclude self (d2 == 0 with itself is always counted)
    return cnt - 1, no_span


def _ror_counts_sorted(pts, n, r2, W: int = 2048):
    """Sorted-sweep neighbour counting (see ``aosx.perceive.points``): exact
    whenever no within-radius pair spans two block boundaries. pts [*B, N,
    3], each world sorted on its own. Returns counts (excluding self) in the
    ORIGINAL point order."""
    dev = pts.device
    B = pts.shape[:-2]
    N = pts.shape[-2]
    pad = (-N) % W
    if pad:
        parked = 2e9 + torch.arange(pad, dtype=torch.float32, device=dev) * 1e3
        parked = torch.stack([parked, parked, parked], dim=1).expand(B + (pad, 3))
        ptsp = torch.cat([pts, parked], dim=-2)
    else:
        ptsp = pts
    Np = ptsp.shape[-2]
    order = torch.argsort(ptsp[..., 0], dim=-1, stable=True)
    ps = take(ptsp, order, len(B))
    Nb = Np // W
    blocks = ps.reshape(B + (Nb, W, 3))
    far = torch.full(B + (1, W, 3), -3e9, dtype=torch.float32, device=dev)
    left = torch.cat([far, blocks[..., :-1, :, :]], dim=-3)
    far2 = torch.full(B + (1, W, 3), 3.2e9, dtype=torch.float32, device=dev)
    right = torch.cat([blocks[..., 1:, :, :], far2], dim=-3)
    trip = torch.cat([left, blocks, right], dim=-2)            # [*B, Nb, 3W, 3]

    r2l = r2.reshape(r2.shape + (1, 1, 1))
    cnt_sorted = torch.empty(B + (Nb, W), dtype=torch.int32, device=dev)
    rc = chunk_rows(_ROW_CHUNK, math.prod(B))
    for j in range(0, W, rc):
        b = blocks[..., j:j + rc, :]                                    # [*B, Nb, C, 3]
        d2 = _d2(b[..., :, :, None, :], trip[..., :, None, :, :])       # [*B, Nb, C, 3W]
        cnt_sorted[..., j:j + rc] = (d2 <= r2l).sum(dim=-1, dtype=torch.int32) - 1
    cnt = torch.empty(B + (Np,), dtype=torch.int32, device=dev)
    cnt.scatter_(-1, order, cnt_sorted.reshape(B + (Np,)))
    first_x = blocks[..., :, 0, 0]
    last_x = blocks[..., :, -1, 0]
    if Nb > 2:
        violated = (first_x[..., 2:] - last_x[..., :-2] < lanes(sqrt(r2), first_x)).any(dim=-1)
    else:
        violated = torch.zeros(B, dtype=torch.bool, device=dev)
    return cnt[..., :n], violated


def static_keep_mask(xyz, params: AosParams, exclusions, bounds):
    """PassThrough z / x / y against the active bounds + exclusion discs
    (aos_seed_gen_node.cpp:452-525). xyz [*B, n, 3]; the bounds and the
    parameters 0-d or of shape B; exclusions [E, 3] for every world or
    [*B, E, 3]."""
    minx, maxx, miny, maxy = (lanes(b, xyz[..., 0]) for b in bounds)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    m = (z >= lanes(params.clipping_minz, z)) & (z <= lanes(params.clipping_maxz, z))
    m &= (x >= minx) & (x <= maxx) & (y >= miny) & (y <= maxy)
    ex = exclusions.to(torch.float32)
    ddx = x[..., :, None] - ex[..., None, :, 0]
    ddy = y[..., :, None] - ex[..., None, :, 1]
    d2 = ddx * ddx + ddy * ddy
    r = ex[..., None, :, 2]
    inside_excl = ((d2 <= r * r) & (r > 0)).any(dim=-1)
    return m & ~inside_excl


def preprocess_full(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
                    s: Statics, *, ror_method: str = "exact"):
    """Returns (xy [*B, N,2], keep [*B, N], cnt [*B, N] i32 ROR neighbour
    counts, valid [*B, N] post-isfinite, bounds tuple, guards i32 bitmask),
    for a cloud and polygon with leading world axes B, or none."""
    xyz, valid = pc.xyz, pc.valid
    valid = valid & torch.isfinite(xyz).all(dim=-1)
    cnt, ror_span_violated = ror_counts(xyz, valid, params.ror_radius, method=ror_method)
    keep = valid & (cnt >= lanes(params.ror_min_neighbors, cnt))
    bounds = active_bounds(
        poly,
        (params.clipping_minx, params.clipping_maxx, params.clipping_miny, params.clipping_maxy),
        params.polygon_margin,
    )
    keep &= static_keep_mask(xyz, params, exclusions, bounds)
    guards = torch.where(ror_span_violated, GUARD_ROR_SPAN, 0).to(torch.int32)
    return xyz[..., :2], keep, cnt, valid, bounds, guards


def preprocess(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
               s: Statics, *, ror_method: str = "exact"):
    """Returns (xy [*B, N,2], keep [*B, N], bounds tuple, guards i32 bitmask)."""
    xy, keep, _, _, bounds, guards = preprocess_full(
        pc, poly, params, exclusions, s, ror_method=ror_method)
    return xy, keep, bounds, guards
