"""GVD graph builder (mirror of ``aosx/gvd/graph.py``; reference:
aos_gvd_node.cpp).

Stages:
 1. greedy 0.5 m seed merge                      (aos_gvd_node.cpp:84-128)
 2. jump-flood nearest-seed field                 (gvd/voronoi.py, kernel K1)
 3. Voronoi vertices: >= 3 distinct owners around a cell corner, plus
    border vertices where ownership changes along the live border
 4. ridge edges: vertices sharing a seed-pair ridge, connected
    consecutively along the ridge tangent
 5. occupied-crossing filter, sampled at res/2    (cpp:320-359)
 6. proximity edges <= 0.5 m                      (cpp:861-894)
 7. TL/TR/BL/BR labels                            (cpp:485-790)
 8. GvdGraph assembly                             (cpp:897-1010)

Edge clearances are 0, as the reference publishes them, unless
``compute_clearances`` asks for the min-obstacle distances of
``gvd/clearance.py`` (an extension, as in ``aosx``).

World axis: the seeds, rows, skeleton and every intermediate array may carry
a leading world axis B (the axis ``aosx`` maps with ``jax.vmap``); sorts,
keys and compactions stay per world (the i32 keys a*N+b and lo*(S+1)+hi
never span worlds), and the loop counts read on the host (the seed-merge
ranks, the crossing samples) are the group's maximum: iterations past a
world's own count only write its drop slot or samples it masks.
"""

from __future__ import annotations

import math

import torch

from ..config import AosParams, Statics
from ..guards import (
    GUARD_CROSS_DENSE,
    GUARD_EDGE_COARSE,
    GUARD_PROX_PPN,
    GUARD_RIDGE_COMPACT,
)
from ..ops import (chunk_rows, compact_take, compact_true, compact_true_hier, div_const, fma,
                   gather_last, lanes, norm2, scatter_set, segment_sum, sqrt, take, while_loop)
from ..perceive.raster import to_plane, f32, iota2
from ..perceive.rows import lexsort2
from ..perceive.seeds import cast_rays_unbounded, dilate_chebyshev
from ..types import GridWorld, GvdGraph, SeedSet, TreeRows
from .clearance import edge_clearances, obstacle_distance_field
from .voronoi import jump_flood

_PROX_CHUNK = 2048
# sample columns of the dense crossing evaluation built at once
_CROSS_CHUNK = 64


def _i32(x, device):
    return torch.tensor(x, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# 1. seed merge
# ---------------------------------------------------------------------------


def _ordered_segment_sum(vals, segs, num: int):
    """Per-segment sums added in increasing index order, ((0 + v_a) + v_b)
    + ..., for every segment and on every device: members are added one
    rank at a time, so no two additions race for one segment. vals
    [*B, n, *T], segs [*B, n]: every lane has segments of its own."""
    dev = vals.device
    B = segs.shape[:-1]
    n = segs.shape[-1]
    order = torch.argsort(segs, dim=-1, stable=True)
    ss = gather_last(segs, order)
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(B + (1,), dtype=torch.bool, device=dev),
                          ss[..., 1:] != ss[..., :-1]], dim=-1)
    rank_sorted = pos - torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    out = torch.zeros(B + (num + 1,) + vals.shape[segs.dim():], dtype=vals.dtype, device=dev)
    drop = torch.full_like(segs, num)
    for r in range(int(rank_sorted.max()) + 1 if n else 0):
        m = rank == r
        out = out + segment_sum(vals, torch.where(m, segs, drop), num + 1)
    return out.narrow(segs.dim() - 1, 0, num)


def merge_seeds(seeds: SeedSet, params: AosParams, s: Statics) -> SeedSet:
    """Greedy order-dependent merge (cpp:84-128): seed i is a representative
    iff no earlier representative lies within merge distance (<=); every
    non-representative is absorbed by its EARLIEST representative; the
    output is the member centroid, in representative order. Non-finite seeds
    are dropped up front."""
    dev = seeds.xy.device
    S = seeds.xy.shape[-2]
    finite = torch.isfinite(seeds.xy).all(dim=-1)
    sxy = torch.where(finite[..., None], seeds.xy, 0.0)
    svalid = seeds.valid & finite
    park = 1e9 + torch.arange(S, dtype=torch.float32, device=dev)[:, None] * 1e3
    xy = torch.where(svalid[..., None], sxy, park)
    t = torch.as_tensor(params.seed_merge_dist, dtype=torch.float32, device=dev)
    t = t.reshape(t.shape + (1, 1))
    idx = torch.arange(S, device=dev)
    ddx = xy[..., :, None, 0] - xy[..., None, :, 0]
    ddy = xy[..., :, None, 1] - xy[..., None, :, 1]
    d2 = ddx * ddx + ddy * ddy
    earlier_near = (d2 <= t * t) & (idx[None, :] < idx[:, None])   # j < i within t

    def undecided(st):
        rep, absorbed = st
        return svalid & ~rep & ~absorbed

    def body(st):
        rep, absorbed = st
        und = undecided(st)
        conf_rep = (earlier_near & rep[..., None, :]).any(dim=-1)
        conf_und = (earlier_near & und[..., None, :]).any(dim=-1)
        return rep | (und & ~conf_rep & ~conf_und), absorbed | (und & conf_rep)

    zeros = torch.zeros_like(svalid)
    rep, absorbed = while_loop(lambda st: undecided(st).any(dim=-1), body, (zeros, zeros))
    within = earlier_near & rep[..., None, :]
    absorber = torch.where(within, idx, S).min(dim=-1).values
    owner = torch.where(rep, idx, torch.where(absorbed, absorber, S))
    sum_xy = _ordered_segment_sum(torch.where(svalid[..., None], sxy, 0.0), owner, S + 1)
    cnt = _ordered_segment_sum(svalid.to(torch.float32), owner, S + 1)
    centroid = sum_xy[..., :S, :] / torch.clamp(cnt[..., :S, None], min=1.0)

    rank = torch.cumsum(rep.to(torch.int32), -1, dtype=torch.int32) - 1
    n = rep.sum(dim=-1, dtype=torch.int32)
    out = scatter_set(S, 0.0, torch.where(rep, rank, S), centroid)
    return SeedSet(xy=out, valid=torch.arange(S, device=dev) < n[..., None],
                   kind=torch.zeros(svalid.shape, dtype=torch.int8, device=dev))


# ---------------------------------------------------------------------------
# 3. vertices
# ---------------------------------------------------------------------------


def _fused_coord(origin, k, res):
    """origin + f32(k) * res rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact. XLA:CPU contracts aosx's vertex
    coordinates this way, so the graph's node positions agree bitwise."""
    return (origin.double() + k.to(torch.float32).double() * res.double()).float()


def extract_vertices(grid: GridWorld, owner, s: Statics):
    """Voronoi vertices from the ownership field. Returns (pos [*B, N,2]
    f32, owners [*B, N,4] i32 (-1 pad), valid [*B, N]) with N = s.max_nodes,
    in raster order (interior corners first, then border runs)."""
    h, w = owner.shape[-2:]
    B = owner.shape[:-2]
    dev = owner.device
    res = f32(s.resolution, dev)

    o00 = owner
    o01 = torch.roll(owner, -1, dims=-1)
    o10 = torch.roll(owner, -1, dims=-2)
    o11 = torch.roll(torch.roll(owner, -1, dims=-2), -1, dims=-1)

    iy, ix = iota2((h, w), dev)
    hc, wc = to_plane(grid.h_cells), to_plane(grid.w_cells)
    interior = (iy < hc - 1) & (ix < wc - 1)

    def distinct_count(a, b, c, d):
        cnt = (a >= 0).to(torch.int32)
        cnt += ((b >= 0) & (b != a)).to(torch.int32)
        cnt += ((c >= 0) & (c != a) & (c != b)).to(torch.int32)
        cnt += ((d >= 0) & (d != a) & (d != b) & (d != c)).to(torch.int32)
        return cnt

    is_vertex = interior & (distinct_count(o00, o01, o10, o11) >= 3)
    vx = _fused_coord(to_plane(grid.origin_x), ix + 1, res).expand(B + (h, w))
    vy = _fused_coord(to_plane(grid.origin_y), iy + 1, res).expand(B + (h, w))

    top = (iy == hc - 1) & (ix < wc - 1) & (o00 != o01) & (o00 >= 0) & (o01 >= 0)
    bot = (iy == 0) & (ix < wc - 1) & (o00 != o01) & (o00 >= 0) & (o01 >= 0)
    lef = (ix == 0) & (iy < hc - 1) & (o00 != o10) & (o00 >= 0) & (o10 >= 0)
    rig = (ix == wc - 1) & (iy < hc - 1) & (o00 != o10) & (o00 >= 0) & (o10 >= 0)

    topy = _fused_coord(grid.origin_y, grid.h_cells, res)
    rigx = _fused_coord(grid.origin_x, grid.w_cells, res)
    hm1 = torch.clamp(grid.h_cells - 1, 0, h - 1).long()
    wm1 = torch.clamp(grid.w_cells - 1, 0, w - 1).long()

    def row_at(plane):
        """Row h_cells - 1 of each world's plane: [*B, W]."""
        return torch.gather(plane, -2, hm1[..., None, None].expand(B + (1, w)))[..., 0, :]

    def col_at(plane):
        """Column w_cells - 1 of each world's plane: [*B, H]."""
        return torch.gather(plane, -1, wm1[..., None, None].expand(B + (h, 1)))[..., 0]

    ones_w = torch.ones(w, dtype=torch.float32, device=dev)
    ones_h = torch.ones(h, dtype=torch.float32, device=dev)
    none_w = torch.full(B + (w,), -1, dtype=torch.int32, device=dev)
    none_h = torch.full(B + (h,), -1, dtype=torch.int32, device=dev)
    segs = [
        (is_vertex.flatten(-2), vx.flatten(-2), vy.flatten(-2),
         o00.flatten(-2), o01.flatten(-2), o10.flatten(-2), o11.flatten(-2)),
        (row_at(top), row_at(vx), ones_w * topy[..., None],
         row_at(o00), row_at(o01), none_w, none_w),
        (bot[..., 0, :].expand(B + (w,)), vx[..., 0, :], ones_w * grid.origin_y[..., None],
         o00[..., 0, :], o01[..., 0, :], none_w, none_w),
        (lef[..., :, 0].expand(B + (h,)), ones_h * grid.origin_x[..., None], vy[..., :, 0],
         o00[..., :, 0], o10[..., :, 0], none_h, none_h),
        (col_at(rig), ones_h * rigx[..., None], col_at(vy),
         col_at(o00), col_at(o10), none_h, none_h),
    ]
    masks = torch.cat([p[0] for p in segs], dim=-1)
    pxs = torch.cat([p[1] for p in segs], dim=-1)
    pys = torch.cat([p[2] for p in segs], dim=-1)
    ow = [torch.cat([p[3 + k] for p in segs], dim=-1) for k in range(4)]

    N = s.max_nodes
    sel, n_nodes = compact_true_hier(masks, N, kw=N)
    pos = torch.stack([compact_take(pxs, sel, 0.0), compact_take(pys, sel, 0.0)], dim=-1)
    a = torch.stack([compact_take(o, sel, -1) for o in ow], dim=-1)
    # mask duplicate owners within a vertex to -1 (so pair keys are unique)
    for k in range(1, 4):
        dup = torch.zeros(B + (N,), dtype=torch.bool, device=dev)
        for j in range(k):
            dup |= (a[..., k] == a[..., j]) & (a[..., k] >= 0)
        a = a.clone()
        a[..., k] = torch.where(dup, -1, a[..., k])
    return pos, a, torch.arange(N, device=dev) < n_nodes[..., None]


# ---------------------------------------------------------------------------
# 4-6. edges
# ---------------------------------------------------------------------------


def _edge_crossing_dense(grid: GridWorld, a, b, valid, num, s: Statics, n_samples: int,
                         sample_ok=None):
    """edgePassesThroughOccupiedPixels (cpp:320-359) with every sample
    evaluated: samples k = 0..num at t = min(k/num, 1), cells by C
    truncation, any occupied in-grid sample crosses. a, b [*B, n, 2], each
    world's entries against its own grid. sample_ok [*B, n, n_samples]:
    only the samples it marks are looked at (the fine windows of
    ``edge_crossing_packed``)."""
    dev = a.device
    nb = a.dim() - 2
    ab = b - a
    length = sqrt(ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1])
    Hs, Ws = grid.occ.shape[-2:]
    occ_flat = grid.occ.flatten(-2)
    ox, oy = to_plane(grid.origin_x), to_plane(grid.origin_y)
    wc, hc = to_plane(grid.w_cells), to_plane(grid.h_cells)
    numf = num.to(torch.float32)[..., None]
    den = torch.clamp(numf, min=1.0)
    # a sample's cell: the division by res as XLA compiles it (a sample on
    # a cell boundary, y = 8.3 over origin -10, falls in row 366 by XLA's
    # product and in row 365 by a division)
    hit = torch.zeros(a.shape[:-1], dtype=torch.bool, device=dev)
    for c0 in range(0, n_samples, _CROSS_CHUNK):
        i = torch.arange(c0, min(c0 + _CROSS_CHUNK, n_samples),
                         dtype=torch.float32, device=dev)
        t = torch.clamp(i / den, max=1.0)
        px = a[..., 0:1] + t * ab[..., 0:1]
        py = a[..., 1:2] + t * ab[..., 1:2]
        mx = div_const(px - ox, s.resolution).to(torch.int32)
        my = div_const(py - oy, s.resolution).to(torch.int32)
        ing = (mx >= 0) & (mx < wc) & (my >= 0) & (my < hc)
        flat = torch.clamp(my, 0, Hs - 1) * Ws + torch.clamp(mx, 0, Ws - 1)
        occ = take(occ_flat, flat, nb) == 1
        sel = occ & ing & (i <= numf)
        if sample_ok is not None:
            sel &= sample_ok[..., c0:c0 + _CROSS_CHUNK]
        hit |= sel.any(dim=-1)
    return hit & valid & (length >= 1e-6)


def edge_crossing_packed(grid: GridWorld, a, b, nmax, valid, s: Statics, cap: int):
    """edgePassesThroughOccupiedPixels (cpp:320-359) for a batch of entries
    with per-entry sample caps: num = min(len/step + 1, nmax-1), samples
    k = 0..num at t = k/num.

    ``aosx`` evaluates this coarse-to-fine in a packed slot buffer (every
    C4-th sample in a dilated grid, then exact windows around coarse hits),
    which decides exactly like the dense evaluation whenever its buffers
    hold. When they overflow (GUARD_CROSS_DENSE) it falls back to the dense
    evaluation, but with ``exact_fallbacks=False`` keeps the fine result of
    the truncated buffers, which may keep edges the dense one drops. Here
    a world whose buffers hold takes the dense evaluation; an overflowed
    world takes the dense evaluation (exact_fallbacks) or looks only at the
    samples in the fine windows ``aosx``'s truncated buffers keep
    (``_fine_windows``). GUARD_EDGE_COARSE flags capped entries; both guard
    bits per world."""
    dev = a.device
    ab = b - a
    length = sqrt(ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1])
    num_raw = div_const(length, s.resolution * 0.5).to(torch.int32) + 1
    num = torch.minimum(num_raw, nmax - 1)
    capped = num_raw > nmax - 1
    C4 = s.crossing_coarse_factor
    assert C4 % 4 == 0 and C4 >= 4, C4

    # packed-buffer accounting (aosx's slot layout): coarse samples 0..numc
    # per entry, slots in a [NR, 4096] buffer, fine windows capped at F
    numc = (num + C4 - 1) // C4
    nsamp = torch.where(valid, numc + 1, 0)
    total = nsamp.sum(dim=-1, dtype=torch.int32)
    NC = 4096
    NR = (cap // C4 + NC - 1) // NC
    capp = NR * NC
    F = max(4096, cap // 64)
    hitc = _coarse_hits(grid, a, ab, num, numc, nsamp, capped, C4, s)
    nwin_true = hitc.sum(dim=(-2, -1), dtype=torch.int32)
    ok_fast = (total <= capp) & (nwin_true <= F)

    # the group's longest cap: samples past an entry's own num are masked
    dense_n = max(256, s.crossing_nmax_long, int(nmax.max()))
    sample_ok = None
    if not s.exact_fallbacks:
        windows = _fine_windows(hitc, nsamp, num, capp, F, C4, dense_n)
        sample_ok = windows | ok_fast[..., None, None]
    crossing = _edge_crossing_dense(grid, a, b, valid, num, s, dense_n, sample_ok)
    zero = _i32(0, dev)
    guards = torch.where((valid & (num_raw > nmax - 1)).any(dim=-1), GUARD_EDGE_COARSE, zero)
    guards |= torch.where(~ok_fast, GUARD_CROSS_DENSE, zero)
    return crossing & valid & (length >= 1e-6), guards


def _fine_windows(hitc, nsamp, num, capp: int, F: int, C4: int, n_samples: int):
    """The fine samples [*B, n, n_samples] that ``aosx``'s packed crossing
    pass looks at when it keeps its own result. Entry e's coarse samples
    m = 0..numc fill slots off_e + m of a buffer of capp slots (the
    exclusive prefix of nsamp; slots past capp are dropped); the first F
    flagged slots in slot order open a window of the fine samples
    fc - C4/2 .. fc + 3 C4/2 - 1 around fc = min(m C4, num). Without an
    overflow the windows hold every fine hit, and the result is the dense
    one."""
    dev = hitc.device
    M = hitc.shape[-1]
    off = torch.cumsum(nsamp, dim=-1, dtype=torch.int32) - nsamp
    m = torch.arange(M, dtype=torch.int32, device=dev)
    slot = off[..., None] + m
    rank = torch.cumsum(hitc.flatten(-2).to(torch.int32), dim=-1,
                        dtype=torch.int32).reshape(hitc.shape) - hitc.to(torch.int32)
    sel = hitc & (slot < capp) & (rank < F)
    lo = torch.minimum(m * C4, num[..., None]) - C4 // 2
    ends = torch.zeros(hitc.shape[:-1] + (n_samples + 1,), dtype=torch.int32, device=dev)
    one = sel.to(torch.int32)
    ends.scatter_add_(-1, torch.clamp(lo, 0, n_samples).long(), one)
    ends.scatter_add_(-1, torch.clamp(lo + 2 * C4, 0, n_samples).long(), -one)
    return torch.cumsum(ends, dim=-1, dtype=torch.int32)[..., :n_samples] > 0


def _coarse_hits(grid: GridWorld, a, ab, num, numc, nsamp, capped, C4: int, s: Statics):
    """The coarse slots flagged by aosx's packed crossing pass [*B, n, M]:
    coarse samples m = 0..numc (m < M, the group's most) of each valid
    entry whose cell in the occupancy grid dilated by Chebyshev radius
    C4/4 + 1 is occupied, and every slot of a capped entry."""
    dev = a.device
    nb = a.dim() - 2
    Hs, Ws = grid.occ.shape[-2:]
    dil = dilate_chebyshev((grid.occ == 1).to(torch.uint8), C4 // 4 + 1).flatten(-2)
    ox, oy = to_plane(grid.origin_x), to_plane(grid.origin_y)
    numf = torch.clamp(num.to(torch.float32), min=1.0)[..., None]
    # the group's most samples: columns past an entry's own nsamp are masked
    mmax = int(nsamp.max()) if nsamp.numel() else 0
    hits = []
    for c0 in range(0, mmax, _CROSS_CHUNK):
        m = torch.arange(c0, min(c0 + _CROSS_CHUNK, mmax), dtype=torch.float32, device=dev)
        tt = torch.clamp(m * C4 / numf, max=1.0)
        px = a[..., 0:1] + tt * ab[..., 0:1]
        py = a[..., 1:2] + tt * ab[..., 1:2]
        mx = div_const(px - ox, s.resolution).to(torch.int32)
        my = div_const(py - oy, s.resolution).to(torch.int32)
        flat = torch.clamp(my, 0, Hs - 1) * Ws + torch.clamp(mx, 0, Ws - 1)
        hitc = (take(dil, flat, nb) == 1) | capped[..., None]
        hits.append(hitc & (m < nsamp[..., None]))
    if not hits:
        return torch.zeros(num.shape + (0,), dtype=torch.bool, device=dev)
    return torch.cat(hits, dim=-1)


def _ridge_edges_from(lo, hi, pok, vidx, pos, sx, sy, N: int, S: int, E: int):
    """Candidate (pair, vertex) entries -> E-compacted deduped ridge edges.
    Entries sharing a seed-pair ridge are connected consecutively along the
    ridge tangent (sort by (pair key, tangent projection)), per world."""
    dev = lo.device
    B = lo.shape[:-1]
    nb = len(B)
    his = torch.clamp(hi, max=S)
    los = torch.clamp(lo, max=S)
    tx = gather_last(sx, his) - gather_last(sx, los)
    ty = gather_last(sy, his) - gather_last(sy, los)
    vsafe = torch.clamp(vidx, 0, N - 1)
    vpos = take(pos, vsafe, nb)
    # ridge tangent = rot90(seed_b - seed_a)
    tproj = vpos[..., 0] * -ty + vpos[..., 1] * tx

    key = torch.where(pok, lo * (S + 1) + hi, (S + 1) * (S + 1))
    order = lexsort2(key, tproj)
    key_s = gather_last(key, order)
    vidx_s = gather_last(vidx, order)
    same = (key_s[..., :-1] == key_s[..., 1:]) & (key_s[..., :-1] < (S + 1) * (S + 1))
    ra = vidx_s[..., :-1]
    rb = vidx_s[..., 1:]
    r_valid = same & (ra != rb)

    ea = torch.minimum(ra, rb)
    eb = torch.maximum(ra, rb)
    ekey_s = torch.sort(torch.where(r_valid, ea * N + eb, N * N), dim=-1).values
    first = torch.cat([torch.ones(B + (1,), dtype=torch.bool, device=dev),
                       ekey_s[..., 1:] != ekey_s[..., :-1]], dim=-1)
    ridge_valid = first & (ekey_s < N * N)
    ridge_a = ekey_s // N
    ridge_b = ekey_s % N

    rrank = torch.cumsum(ridge_valid.to(torch.int32), -1, dtype=torch.int32) - 1
    rtgt = torch.where(ridge_valid & (rrank < E), rrank, E)
    edges_a = scatter_set(E, -1, rtgt, ridge_a)
    edges_b = scatter_set(E, -1, rtgt, ridge_b)
    n_ridge_cand = torch.clamp(ridge_valid.sum(dim=-1, dtype=torch.int32), max=E)
    return edges_a, edges_b, n_ridge_cand


def build_edges(pos, owners, node_valid, grid: GridWorld, seeds: SeedSet,
                params: AosParams, s: Statics, *, fused_length: bool = True):
    """Ridge edges + proximity edges, occupied-crossing filtered.
    fused_length: the squared edge length as XLA:CPU rounds it in aosx's
    graph build, dy * dy + dx * dx in one FMA; False rounds the two
    products apart, as it does when the graph computes clearances."""
    dev = pos.device
    B = node_valid.shape[:-1]
    nb = len(B)
    G = math.prod(B)
    N, E = s.max_nodes, s.max_edges
    S = seeds.xy.shape[-2]

    # ---- ridge entries: (pair key, tangent projection, vertex idx) --------
    los, his, oks = [], [], []
    for ii in range(4):
        for jj in range(ii + 1, 4):
            a = owners[..., ii]
            b = owners[..., jj]
            lo = torch.minimum(a, b)
            ok = (lo >= 0) & node_valid
            los.append(torch.where(ok, lo, S))
            his.append(torch.where(ok, torch.maximum(a, b), S))
            oks.append(ok)
    lo = torch.cat(los, dim=-1)
    hi = torch.cat(his, dim=-1)
    pok = torch.cat(oks, dim=-1)
    vidx = torch.arange(N, dtype=torch.int32, device=dev).repeat(6).expand(B + (6 * N,))

    zero1 = torch.zeros(B + (1,), dtype=torch.float32, device=dev)
    sx = torch.cat([seeds.xy[..., 0], zero1], dim=-1)
    sy = torch.cat([seeds.xy[..., 1], zero1], dim=-1)

    # aosx sorts the live entries compacted to RK = 3N slots when they fit,
    # else the full list; both give the same edges whenever they fit. The
    # exact mode takes the full list; the fast-only mode compacts (and
    # flags an overflow).
    RK = 3 * N
    n_live = pok.sum(dim=-1, dtype=torch.int32)
    ridge_ok = n_live <= RK
    if s.exact_fallbacks:
        edges_a, edges_b, n_ridge_cand = _ridge_edges_from(lo, hi, pok, vidx, pos, sx, sy, N, S, E)
    else:
        crank = torch.cumsum(pok.to(torch.int32), -1, dtype=torch.int32) - 1
        ctgt = torch.where(pok & (crank < RK), crank, RK)
        edges_a, edges_b, n_ridge_cand = _ridge_edges_from(
            scatter_set(RK, S, ctgt, lo), scatter_set(RK, S, ctgt, hi),
            scatter_set(RK, False, ctgt, pok), scatter_set(RK, 0, ctgt, vidx),
            pos, sx, sy, N, S, E)
    ridge_guard = torch.where(~ridge_ok, GUARD_RIDGE_COMPACT, _i32(0, dev))
    rvalid = torch.arange(E, device=dev) < n_ridge_cand[..., None]
    pa = take(pos, torch.clamp(edges_a, min=0), nb)
    pb = take(pos, torch.clamp(edges_b, min=0), nb)
    # two-tier sample caps: 64 samples for edges <= 63*res/2, the long tier
    # (crossing_nmax_long) for the rest
    T1 = 64
    dab = pb - pa
    length = sqrt(dab[..., 0] * dab[..., 0] + dab[..., 1] * dab[..., 1])
    num = div_const(length, s.resolution * 0.5).to(torch.int32) + 1
    nmax_ridge = torch.where(num <= T1 - 1, _i32(T1, dev), _i32(s.crossing_nmax_long, dev))

    # ---- proximity edges <= 0.5 m (cpp:861-894), row-chunked --------------
    posm = torch.where(node_valid[..., None], pos, 1e9)
    iidx = torch.arange(N, dtype=torch.int32, device=dev)
    t = torch.as_tensor(params.proximity_edge_dist, dtype=torch.float32, device=dev)
    t = t.reshape(t.shape + (1, 1))
    PPN = 8
    RC = min(chunk_rows(_PROX_CHUNK, G), N)
    if N % RC:
        RC = N
    ppn_overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    cand_rows = []
    for base in range(0, N, RC):
        rpos = posm[..., base:base + RC, :]
        ri = iidx[base:base + RC]
        ddx = rpos[..., :, None, 0] - posm[..., None, :, 0]
        ddy = rpos[..., :, None, 1] - posm[..., None, :, 1]
        d2 = ddx * ddx + ddy * ddy
        prox = (d2 <= t * t) & (d2 > 1e-12) & (iidx[None, :] > ri[:, None])
        ppn_overflow |= (prox.sum(dim=-1) > PPN).any(dim=-1)
        row_j = torch.where(prox, iidx, N)
        cand_rows.append(torch.sort(row_j, dim=-1, stable=True).values[..., :PPN])
    cand_j = torch.cat(cand_rows, dim=-2)
    cand_ok = cand_j < N
    cand_i = iidx[:, None].expand(B + (N, PPN))
    PE = E
    psel, n_prox_cand = compact_true(cand_ok.flatten(-2), PE)
    sel_safe = torch.clamp(psel, min=0)
    cpi = torch.where(psel >= 0, gather_last(cand_i.flatten(-2), sel_safe), -1)
    cpj = torch.where(psel >= 0, gather_last(cand_j.flatten(-2), sel_safe), -1)
    pvalid = torch.arange(PE, device=dev) < n_prox_cand[..., None]
    cpa = take(pos, torch.clamp(cpi, min=0), nb)
    cpb = take(pos, torch.clamp(cpj, min=0), nb)

    # ---- ONE crossing pass over ridge + prox candidates -------------------
    crossing_all, cross_guards = edge_crossing_packed(
        grid, torch.cat([pa, cpa], dim=-2), torch.cat([pb, cpb], dim=-2),
        torch.cat([nmax_ridge, torch.full(B + (PE,), 32, dtype=torch.int32, device=dev)], dim=-1),
        torch.cat([rvalid, pvalid], dim=-1), s,
        cap=s.crossing_cap_edges_factor * s.max_edges)
    rvalid = rvalid & ~crossing_all[..., :E]
    pcross = crossing_all[..., E:]

    # re-compact surviving ridge edges (keeps sorted-key order)
    rrank2 = torch.cumsum(rvalid.to(torch.int32), -1, dtype=torch.int32) - 1
    rtgt2 = torch.where(rvalid & (rrank2 < E), rrank2, E)
    edges_a = scatter_set(E, -1, rtgt2, edges_a)
    edges_b = scatter_set(E, -1, rtgt2, edges_b)
    n_ridge = torch.clamp(rvalid.sum(dim=-1, dtype=torch.int32), max=E)

    # not already a surviving ridge edge (cpp:844-857)
    ar_e = torch.arange(E, device=dev)
    ridge_live = ar_e < n_ridge[..., None]
    skeys = torch.sort(torch.where(ridge_live, edges_a * N + edges_b, N * N), dim=-1).values
    ckeys = torch.where(pvalid, cpi * N + cpj, N * N - 1)
    loc = torch.searchsorted(skeys, ckeys)
    in_ridge = (loc < E) & (gather_last(skeys, torch.clamp(loc, max=E - 1)) == ckeys)
    pvalid = pvalid & ~in_ridge & ~pcross

    # ---- final edge list: ridges then proximity ---------------------------
    all_a = torch.cat([edges_a, torch.where(pvalid, cpi, -1)], dim=-1)
    all_b = torch.cat([edges_b, torch.where(pvalid, cpj, -1)], dim=-1)
    all_ok = torch.cat([ridge_live, pvalid], dim=-1)
    frank = torch.cumsum(all_ok.to(torch.int32), -1, dtype=torch.int32) - 1
    ftgt = torch.where(all_ok & (frank < E), frank, E)
    fa = scatter_set(E, -1, ftgt, all_a)
    fb = scatter_set(E, -1, ftgt, all_b)
    n_edges = torch.clamp(all_ok.sum(dim=-1, dtype=torch.int32), max=E)
    ev = ar_e < n_edges[..., None]
    dd = take(pos, torch.clamp(fb, min=0), nb) - take(pos, torch.clamp(fa, min=0), nb)
    # sqrt(fma(dy, dy, dx * dx)): the fused multiply-add XLA:CPU makes of
    # aosx's squared length here. With clearances the edge-end gathers are
    # shared with the clearance samples, and the products reach the sum
    # through a lane shuffle that the backend does not contract
    dx2 = dd[..., 0] * dd[..., 0]
    sq = fma(dd[..., 1], dd[..., 1], dx2) if fused_length else dx2 + dd[..., 1] * dd[..., 1]
    lengths = torch.where(ev, sqrt(sq), 0.0)
    guards = (cross_guards | ridge_guard
              | torch.where(ppn_overflow, GUARD_PROX_PPN, _i32(0, dev)))
    return fa, fb, ev, lengths, n_edges, guards


# ---------------------------------------------------------------------------
# 7. labels
# ---------------------------------------------------------------------------


def _cast_ray_gvd(grid: GridWorld, start, direction, active, s: Statics):
    """castRay (cpp:558-684): step = max(res/2, 0.01), from min_dist 1.0."""
    step = max(s.resolution * 0.5, 0.01)
    return cast_rays_unbounded(grid, start, direction, active, 1.0, step, 3.0, s)


def find_labels(pos, node_valid, rows_sorted: TreeRows, skel: GridWorld,
                params: AosParams, s: Statics):
    """findClusterEndpointVoronoiBoundaryPoints (cpp:485-556) +
    findVoronoiBoundaryPointNearEndpoint (cpp:686-790): per (cluster,
    label in TL,TR,BL,BR), the nearest node in expanding radii {5, 7, 9,
    diag*2} within the label's quarter-plane; castRay fallback otherwise.
    Returns (label_points [*B, C,4,2], label_valid [*B, C,4], node idx or
    -1)."""
    dev = pos.device
    B = node_valid.shape[:-1]
    nb = len(B)
    C = s.max_rows
    res = f32(s.resolution, dev)

    swap = rows_sorted.ep1[..., 0] > rows_sorted.ep2[..., 0]
    ep1 = torch.where(swap[..., None], rows_sorted.ep2, rows_sorted.ep1)
    ep2 = torch.where(swap[..., None], rows_sorted.ep1, rows_sorted.ep2)

    eps = torch.stack([ep1, ep1, ep2, ep2], dim=-2)          # [*B, C,4,2]
    oth = torch.stack([ep2, ep2, ep1, ep1], dim=-2)
    sign = torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=torch.float32, device=dev)

    d = oth - eps
    n = sqrt(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
    unit_x = torch.tensor([1.0, 0.0], dtype=torch.float32, device=dev)
    main = torch.where(n > 1e-6, d / torch.clamp(n, min=1e-6), unit_x)
    outward = -main
    perp = torch.stack([-main[..., 1], main[..., 0]], dim=-1)

    diff = pos[..., None, None, :, :] - eps[..., :, :, None, :]       # [*B, C,4,N,2]
    # sqrt(fma(dy, dy, dx * dx)) as XLA:CPU fuses it (MC world 67: two
    # nodes 9e-8 m apart in distance tie in f32 that way, and the lower
    # index wins)
    dist = norm2(diff)
    dirn = diff / torch.clamp(dist, min=1e-12)[..., None]
    dot_out = (outward[..., 0, None] * dirn[..., 0]
               + outward[..., 1, None] * dirn[..., 1])
    dot_perp = perp[..., 0, None] * dirn[..., 0] + perp[..., 1, None] * dirn[..., 1]

    def per_world(v):
        """A parameter or per-world value against [*B, C, 4, N]."""
        return lanes(torch.as_tensor(v, dtype=torch.float32, device=dev), dist)

    base_ok = (
        node_valid[..., None, None, :]
        & (dist >= per_world(params.label_search_min_dist))
        & (dot_out >= 0.0)
        & (dot_perp * sign[:, None] >= 0.0)
    )
    gw = skel.w_cells.to(torch.float32) * res
    gh = skel.h_cells.to(torch.float32) * res
    diag2 = sqrt(gw * gw + gh * gh) * 2.0
    radii = [params.label_search_radius0, 7.0, 9.0, diag2]

    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    best_idx = torch.full(B + (C, 4), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(B + (C, 4), dtype=torch.bool, device=dev)
    for r in radii:
        dmask = torch.where(base_ok & (dist <= per_world(r)), dist, big)
        tier_found = dmask.min(dim=-1).values < big
        tier_idx = torch.argmin(dmask, dim=-1).to(torch.int32)
        best_idx = torch.where(~found & tier_found, tier_idx, best_idx)
        found = found | tier_found

    # castRay fallback for not-found (always "valid" per cpp:788-789)
    ray_dir = perp * sign[:, None]
    need = (~found & rows_sorted.valid[..., None]).reshape(B + (C * 4,))
    fb = _cast_ray_gvd(skel, eps.reshape(B + (C * 4, 2)), ray_dir.reshape(B + (C * 4, 2)),
                       need, s).reshape(B + (C, 4, 2))
    node_pts = take(pos, torch.clamp(best_idx, min=0), nb)
    label_points = torch.where(found[..., None], node_pts, fb)
    label_valid = rows_sorted.valid[..., None].expand(B + (C, 4))
    return label_points, label_valid, torch.where(found, best_idx, -1)


def assign_labels(pos, node_valid, label_points, label_valid, params, s: Statics):
    """publishGraph label matching (cpp:918-995): a node gets bit (1<<li)
    when within the tolerance of any cluster's label point;
    label_node[c,li] = first matching node index."""
    dev = pos.device
    N = s.max_nodes
    diff = pos[..., :, None, None, :] - label_points[..., None, :, :, :]     # [*B, N,C,4,2]
    d = sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    tol = lanes(torch.as_tensor(params.label_match_tolerance, dtype=torch.float32, device=dev), d)
    match = (d < tol) & label_valid[..., None, :, :] & node_valid[..., :, None, None]
    bits = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=dev)
    node_labels = torch.where(match.any(dim=-2), bits, 0).sum(dim=-1, dtype=torch.int32)
    idxs = torch.where(match, torch.arange(N, dtype=torch.int32, device=dev)[:, None, None], N)
    first = idxs.min(dim=-3).values
    return node_labels, torch.where(first < N, first, -1)


# ---------------------------------------------------------------------------
# full build
# ---------------------------------------------------------------------------


def build_gvd_graph(seeds: SeedSet, rows_sorted: TreeRows, skel: GridWorld,
                    params: AosParams, s: Statics, *,
                    compute_clearances: bool = False, stencil_mesh=None,
                    stencil_axis: str = "space") -> GvdGraph:
    """processGraph (cpp:255-318). Edge clearances are 0, as the reference
    publishes them (aos_gvd_node.cpp:856), unless ``compute_clearances``:
    then each edge's least distance to the skeleton (gvd/clearance.py).
    stencil_mesh: optional ``parallel.spatial.Mesh``; the ownership flood
    then runs on row bands over its devices
    (``parallel.spatial.jump_flood_sharded``, bitwise equal). A leading
    world axis on the inputs builds a group's graphs in one call (neither
    clearances nor a mesh with it: no ``aosx`` caller combines them)."""
    batched = skel.occ.dim() > 2
    if batched and (compute_clearances or stencil_mesh is not None):
        raise ValueError("build_gvd_graph: a world axis takes neither compute_clearances "
                         "nor stencil_mesh")
    merged = merge_seeds(seeds, params, s)
    if stencil_mesh is not None:
        from ..parallel.spatial import jump_flood_sharded

        owner = jump_flood_sharded(skel, merged, s, stencil_mesh, stencil_axis)
    else:
        owner = jump_flood(skel, merged, s)
    pos, owners, node_valid = extract_vertices(skel, owner, s)
    ea, eb, ev, lengths, n_edges, edge_guards = build_edges(
        pos, owners, node_valid, skel, merged, params, s, fused_length=not compute_clearances)
    label_points, label_valid, _ = find_labels(pos, node_valid, rows_sorted, skel, params, s)
    node_labels, label_node = assign_labels(pos, node_valid, label_points, label_valid, params, s)
    edges = torch.stack([ea, eb], dim=-1)
    if compute_clearances:
        clearances = edge_clearances(obstacle_distance_field(skel, s), skel, pos, edges, ev, s)
    else:
        clearances = torch.zeros_like(lengths)
    return GvdGraph(
        nodes=pos,
        node_valid=node_valid,
        node_labels=node_labels,
        label_node=label_node,
        edges=edges,
        edge_valid=ev,
        edge_lengths=lengths,
        edge_clearances=clearances,
        num_nodes=node_valid.sum(dim=-1, dtype=torch.int32),
        num_edges=n_edges,
        guards=edge_guards,
    )
