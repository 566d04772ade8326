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
"""

from __future__ import annotations

import torch

from ..config import AosParams, Statics
from ..guards import (
    GUARD_CROSS_DENSE,
    GUARD_EDGE_COARSE,
    GUARD_PROX_PPN,
    GUARD_RIDGE_COMPACT,
)
from ..ops import (compact_take, compact_true, compact_true_hier, fma, scatter_set, sqrt,
                   while_loop)
from ..perceive.raster import f32, iota2
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
    rank at a time, so no two additions race for one segment."""
    dev = vals.device
    n = segs.shape[0]
    order = torch.argsort(segs, stable=True)
    ss = segs[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ss[1:] != ss[:-1]])
    rank_sorted = pos - torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    out = torch.zeros((num + 1,) + vals.shape[1:], dtype=vals.dtype, device=dev)
    drop = torch.full_like(segs, num)
    for r in range(int(rank_sorted.max()) + 1 if n else 0):
        m = rank == r
        out.index_add_(0, torch.where(m, segs, drop).long(), vals)
    return out[:num]


def merge_seeds(seeds: SeedSet, params: AosParams, s: Statics) -> SeedSet:
    """Greedy order-dependent merge (cpp:84-128): seed i is a representative
    iff no earlier representative lies within merge distance (<=); every
    non-representative is absorbed by its EARLIEST representative; the
    output is the member centroid, in representative order. Non-finite seeds
    are dropped up front."""
    dev = seeds.xy.device
    S = seeds.xy.shape[0]
    finite = torch.isfinite(seeds.xy).all(dim=1)
    sxy = torch.where(finite[:, None], seeds.xy, 0.0)
    svalid = seeds.valid & finite
    park = 1e9 + torch.arange(S, dtype=torch.float32, device=dev)[:, None] * 1e3
    xy = torch.where(svalid[:, None], sxy, park)
    t = torch.as_tensor(params.seed_merge_dist, dtype=torch.float32, device=dev)
    idx = torch.arange(S, device=dev)
    ddx = xy[:, None, 0] - xy[None, :, 0]
    ddy = xy[:, None, 1] - xy[None, :, 1]
    d2 = ddx * ddx + ddy * ddy
    earlier_near = (d2 <= t * t) & (idx[None, :] < idx[:, None])   # j < i within t

    def undecided(st):
        rep, absorbed = st
        return svalid & ~rep & ~absorbed

    def body(st):
        rep, absorbed = st
        und = undecided(st)
        conf_rep = (earlier_near & rep[None, :]).any(dim=1)
        conf_und = (earlier_near & und[None, :]).any(dim=1)
        return rep | (und & ~conf_rep & ~conf_und), absorbed | (und & conf_rep)

    zeros = torch.zeros(S, dtype=torch.bool, device=dev)
    rep, absorbed = while_loop(lambda st: undecided(st).any(), body, (zeros, zeros))
    within = earlier_near & rep[None, :]
    absorber = torch.where(within, idx[None, :], S).min(dim=1).values
    owner = torch.where(rep, idx, torch.where(absorbed, absorber, S))
    sum_xy = _ordered_segment_sum(torch.where(svalid[:, None], sxy, 0.0), owner, S + 1)[:S]
    cnt = _ordered_segment_sum(svalid.to(torch.float32), owner, S + 1)[:S]
    centroid = sum_xy / torch.clamp(cnt[:, None], min=1.0)

    rank = torch.cumsum(rep.to(torch.int32), 0, dtype=torch.int32) - 1
    n = rep.sum(dtype=torch.int32)
    out = scatter_set(S, 0.0, torch.where(rep, rank, S), centroid)
    return SeedSet(xy=out, valid=torch.arange(S, device=dev) < n,
                   kind=torch.zeros(S, dtype=torch.int8, device=dev))


# ---------------------------------------------------------------------------
# 3. vertices
# ---------------------------------------------------------------------------


def _fused_coord(origin, k, res):
    """origin + f32(k) * res rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact. XLA:CPU contracts aosx's vertex
    coordinates this way, so the graph's node positions agree bitwise."""
    return (origin.double() + k.to(torch.float32).double() * res.double()).float()


def extract_vertices(grid: GridWorld, owner, s: Statics):
    """Voronoi vertices from the ownership field. Returns (pos [N,2] f32,
    owners [N,4] i32 (-1 pad), valid [N]) with N = s.max_nodes, in raster
    order (interior corners first, then border runs)."""
    h, w = owner.shape
    dev = owner.device
    res = f32(s.resolution, dev)

    o00 = owner
    o01 = torch.roll(owner, -1, dims=1)
    o10 = torch.roll(owner, -1, dims=0)
    o11 = torch.roll(torch.roll(owner, -1, dims=0), -1, dims=1)

    iy, ix = iota2((h, w), dev)
    interior = (iy < grid.h_cells - 1) & (ix < grid.w_cells - 1)

    def distinct_count(a, b, c, d):
        cnt = (a >= 0).to(torch.int32)
        cnt += ((b >= 0) & (b != a)).to(torch.int32)
        cnt += ((c >= 0) & (c != a) & (c != b)).to(torch.int32)
        cnt += ((d >= 0) & (d != a) & (d != b) & (d != c)).to(torch.int32)
        return cnt

    is_vertex = interior & (distinct_count(o00, o01, o10, o11) >= 3)
    vx = _fused_coord(grid.origin_x, ix + 1, res)
    vy = _fused_coord(grid.origin_y, iy + 1, res)

    top = (iy == grid.h_cells - 1) & (ix < grid.w_cells - 1) & (o00 != o01) & (o00 >= 0) & (o01 >= 0)
    bot = (iy == 0) & (ix < grid.w_cells - 1) & (o00 != o01) & (o00 >= 0) & (o01 >= 0)
    lef = (ix == 0) & (iy < grid.h_cells - 1) & (o00 != o10) & (o00 >= 0) & (o10 >= 0)
    rig = (ix == grid.w_cells - 1) & (iy < grid.h_cells - 1) & (o00 != o10) & (o00 >= 0) & (o10 >= 0)

    topy = _fused_coord(grid.origin_y, grid.h_cells, res)
    rigx = _fused_coord(grid.origin_x, grid.w_cells, res)
    hm1 = torch.clamp(grid.h_cells - 1, 0, h - 1).long().reshape(1)
    wm1 = torch.clamp(grid.w_cells - 1, 0, w - 1).long().reshape(1)

    def row_at(plane):
        return plane.index_select(0, hm1)[0]

    def col_at(plane):
        return plane.index_select(1, wm1)[:, 0]

    ones_w = torch.ones(w, dtype=torch.float32, device=dev)
    ones_h = torch.ones(h, dtype=torch.float32, device=dev)
    none_w = torch.full((w,), -1, dtype=torch.int32, device=dev)
    none_h = torch.full((h,), -1, dtype=torch.int32, device=dev)
    segs = [
        (is_vertex.reshape(-1), vx.reshape(-1), vy.reshape(-1),
         o00.reshape(-1), o01.reshape(-1), o10.reshape(-1), o11.reshape(-1)),
        (row_at(top), row_at(vx), ones_w * topy,
         row_at(o00), row_at(o01), none_w, none_w),
        (bot[0], vx[0], ones_w * grid.origin_y,
         o00[0], o01[0], none_w, none_w),
        (lef[:, 0], ones_h * grid.origin_x, vy[:, 0],
         o00[:, 0], o10[:, 0], none_h, none_h),
        (col_at(rig), ones_h * rigx, col_at(vy),
         col_at(o00), col_at(o10), none_h, none_h),
    ]
    masks = torch.cat([p[0] for p in segs])
    pxs = torch.cat([p[1] for p in segs])
    pys = torch.cat([p[2] for p in segs])
    ow = [torch.cat([p[3 + k] for p in segs]) for k in range(4)]

    N = s.max_nodes
    sel, n_nodes = compact_true_hier(masks, N, kw=N)
    pos = torch.stack([compact_take(pxs, sel, 0.0), compact_take(pys, sel, 0.0)], dim=1)
    a = torch.stack([compact_take(o, sel, -1) for o in ow], dim=1)
    # mask duplicate owners within a vertex to -1 (so pair keys are unique)
    for k in range(1, 4):
        dup = torch.zeros(N, dtype=torch.bool, device=dev)
        for j in range(k):
            dup |= (a[:, k] == a[:, j]) & (a[:, k] >= 0)
        a = a.clone()
        a[:, k] = torch.where(dup, -1, a[:, k])
    return pos, a, torch.arange(N, device=dev) < n_nodes


# ---------------------------------------------------------------------------
# 4-6. edges
# ---------------------------------------------------------------------------


def _edge_crossing_dense(grid: GridWorld, a, b, valid, num, s: Statics, n_samples: int):
    """edgePassesThroughOccupiedPixels (cpp:320-359) with every sample
    evaluated: samples k = 0..num at t = min(k/num, 1), cells by C
    truncation, any occupied in-grid sample crosses."""
    dev = a.device
    res = f32(s.resolution, dev)
    ab = b - a
    length = sqrt(ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1])
    Hs, Ws = grid.occ.shape
    occ_flat = grid.occ.reshape(-1)
    numf = num.to(torch.float32)[:, None]
    den = torch.clamp(numf, min=1.0)
    hit = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
    for c0 in range(0, n_samples, _CROSS_CHUNK):
        i = torch.arange(c0, min(c0 + _CROSS_CHUNK, n_samples),
                         dtype=torch.float32, device=dev)[None, :]
        t = torch.clamp(i / den, max=1.0)
        px = a[:, 0:1] + t * ab[:, 0:1]
        py = a[:, 1:2] + t * ab[:, 1:2]
        mx = ((px - grid.origin_x) / res).to(torch.int32)
        my = ((py - grid.origin_y) / res).to(torch.int32)
        ing = (mx >= 0) & (mx < grid.w_cells) & (my >= 0) & (my < grid.h_cells)
        flat = (torch.clamp(my, 0, Hs - 1) * Ws + torch.clamp(mx, 0, Ws - 1)).long()
        occ = occ_flat[flat] == 1
        hit |= (occ & ing & (i <= numf)).any(dim=1)
    return hit & valid & (length >= 1e-6)


def edge_crossing_packed(grid: GridWorld, a, b, nmax, valid, s: Statics, cap: int):
    """edgePassesThroughOccupiedPixels (cpp:320-359) for a batch of entries
    with per-entry sample caps: num = min(len/step + 1, nmax-1), samples
    k = 0..num at t = k/num.

    ``aosx`` evaluates this coarse-to-fine in a packed slot buffer (every
    C4-th sample in a dilated grid, then exact windows around coarse hits),
    which decides exactly like the dense evaluation whenever its buffers
    hold, and falls back to the dense evaluation when they overflow. Here
    the decision is always the dense evaluation; the packed buffers are
    only accounted, to raise the same guard bits (GUARD_CROSS_DENSE on
    overflow, GUARD_EDGE_COARSE for capped entries)."""
    dev = a.device
    res = f32(s.resolution, dev)
    step = res * 0.5
    E = a.shape[0]
    ab = b - a
    length = sqrt(ab[:, 0] * ab[:, 0] + ab[:, 1] * ab[:, 1])
    num_raw = (length / step).to(torch.int32) + 1
    num = torch.minimum(num_raw, nmax - 1)
    capped = num_raw > nmax - 1
    C4 = s.crossing_coarse_factor
    assert C4 % 4 == 0 and C4 >= 4, C4

    # packed-buffer accounting (aosx's slot layout): coarse samples 0..numc
    # per entry, slots in a [NR, 4096] buffer, fine windows capped at F
    numc = (num + C4 - 1) // C4
    nsamp = torch.where(valid, numc + 1, 0)
    total = nsamp.sum(dtype=torch.int32)
    NC = 4096
    NR = (cap // C4 + NC - 1) // NC
    capp = NR * NC
    F = max(4096, cap // 64)
    nwin_true = _coarse_hits(grid, a, ab, num, numc, nsamp, capped, C4, s)
    ok_fast = (total <= capp) & (nwin_true <= F)

    dense_n = max(256, s.crossing_nmax_long, int(nmax.max()))
    crossing = _edge_crossing_dense(grid, a, b, valid, num, s, dense_n)
    zero = _i32(0, dev)
    guards = torch.where((valid & (num_raw > nmax - 1)).any(), GUARD_EDGE_COARSE, zero)
    guards |= torch.where(~ok_fast, GUARD_CROSS_DENSE, zero)
    return crossing & valid & (length >= 1e-6), guards


def _coarse_hits(grid: GridWorld, a, ab, num, numc, nsamp, capped, C4: int, s: Statics):
    """Number of coarse slots flagged by aosx's packed crossing pass: coarse
    samples m = 0..numc of each valid entry whose cell in the occupancy
    grid dilated by Chebyshev radius C4/4 + 1 is occupied, plus every slot
    of a capped entry."""
    dev = a.device
    res = f32(s.resolution, dev)
    Hs, Ws = grid.occ.shape
    dil = dilate_chebyshev((grid.occ == 1).to(torch.uint8), C4 // 4 + 1).reshape(-1)
    numf = torch.clamp(num.to(torch.float32), min=1.0)[:, None]
    total = torch.zeros((), dtype=torch.int32, device=dev)
    mmax = int(nsamp.max()) if nsamp.numel() else 0
    for c0 in range(0, mmax, _CROSS_CHUNK):
        m = torch.arange(c0, min(c0 + _CROSS_CHUNK, mmax), dtype=torch.float32, device=dev)[None, :]
        tt = torch.clamp(m * C4 / numf, max=1.0)
        px = a[:, 0:1] + tt * ab[:, 0:1]
        py = a[:, 1:2] + tt * ab[:, 1:2]
        mx = ((px - grid.origin_x) / res).to(torch.int32)
        my = ((py - grid.origin_y) / res).to(torch.int32)
        flat = (torch.clamp(my, 0, Hs - 1) * Ws + torch.clamp(mx, 0, Ws - 1)).long()
        hitc = (dil[flat] == 1) | capped[:, None]
        total += (hitc & (m < nsamp[:, None])).sum(dtype=torch.int32)
    return total


def _ridge_edges_from(lo, hi, pok, vidx, pos, sx, sy, N: int, S: int, E: int):
    """Candidate (pair, vertex) entries -> E-compacted deduped ridge edges.
    Entries sharing a seed-pair ridge are connected consecutively along the
    ridge tangent (sort by (pair key, tangent projection))."""
    dev = lo.device
    his = torch.clamp(hi, max=S).long()
    los = torch.clamp(lo, max=S).long()
    tx = sx[his] - sx[los]
    ty = sy[his] - sy[los]
    vsafe = torch.clamp(vidx, 0, N - 1).long()
    # ridge tangent = rot90(seed_b - seed_a)
    tproj = pos[vsafe, 0] * -ty + pos[vsafe, 1] * tx

    key = torch.where(pok, lo * (S + 1) + hi, (S + 1) * (S + 1))
    order = lexsort2(key, tproj)
    key_s = key[order]
    vidx_s = vidx[order]
    same = (key_s[:-1] == key_s[1:]) & (key_s[:-1] < (S + 1) * (S + 1))
    ra = vidx_s[:-1]
    rb = vidx_s[1:]
    r_valid = same & (ra != rb)

    ea = torch.minimum(ra, rb)
    eb = torch.maximum(ra, rb)
    ekey_s = torch.sort(torch.where(r_valid, ea * N + eb, N * N)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ekey_s[1:] != ekey_s[:-1]])
    ridge_valid = first & (ekey_s < N * N)
    ridge_a = ekey_s // N
    ridge_b = ekey_s % N

    rrank = torch.cumsum(ridge_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    rtgt = torch.where(ridge_valid & (rrank < E), rrank, E)
    edges_a = scatter_set(E, -1, rtgt, ridge_a)
    edges_b = scatter_set(E, -1, rtgt, ridge_b)
    n_ridge_cand = torch.clamp(ridge_valid.sum(dtype=torch.int32), max=E)
    return edges_a, edges_b, n_ridge_cand


def build_edges(pos, owners, node_valid, grid: GridWorld, seeds: SeedSet,
                params: AosParams, s: Statics):
    """Ridge edges + proximity edges, occupied-crossing filtered."""
    dev = pos.device
    N, E = s.max_nodes, s.max_edges
    S = seeds.xy.shape[0]

    # ---- ridge entries: (pair key, tangent projection, vertex idx) --------
    los, his, oks = [], [], []
    for ii in range(4):
        for jj in range(ii + 1, 4):
            a = owners[:, ii]
            b = owners[:, jj]
            lo = torch.minimum(a, b)
            ok = (lo >= 0) & node_valid
            los.append(torch.where(ok, lo, S))
            his.append(torch.where(ok, torch.maximum(a, b), S))
            oks.append(ok)
    lo = torch.cat(los)
    hi = torch.cat(his)
    pok = torch.cat(oks)
    vidx = torch.arange(N, dtype=torch.int32, device=dev).repeat(6)

    zero1 = torch.zeros(1, dtype=torch.float32, device=dev)
    sx = torch.cat([seeds.xy[:, 0], zero1])
    sy = torch.cat([seeds.xy[:, 1], zero1])

    # aosx sorts the live entries compacted to RK = 3N slots when they fit,
    # else the full list; both give the same edges whenever they fit. The
    # exact mode takes the full list; the fast-only mode compacts (and
    # flags an overflow).
    RK = 3 * N
    n_live = pok.sum(dtype=torch.int32)
    ridge_ok = n_live <= RK
    if s.exact_fallbacks:
        edges_a, edges_b, n_ridge_cand = _ridge_edges_from(lo, hi, pok, vidx, pos, sx, sy, N, S, E)
    else:
        crank = torch.cumsum(pok.to(torch.int32), 0, dtype=torch.int32) - 1
        ctgt = torch.where(pok & (crank < RK), crank, RK)
        edges_a, edges_b, n_ridge_cand = _ridge_edges_from(
            scatter_set(RK, S, ctgt, lo), scatter_set(RK, S, ctgt, hi),
            scatter_set(RK, False, ctgt, pok), scatter_set(RK, 0, ctgt, vidx),
            pos, sx, sy, N, S, E)
    ridge_guard = torch.where(~ridge_ok, GUARD_RIDGE_COMPACT, _i32(0, dev))
    rvalid = torch.arange(E, device=dev) < n_ridge_cand
    pa = pos[torch.clamp(edges_a, min=0).long()]
    pb = pos[torch.clamp(edges_b, min=0).long()]
    # two-tier sample caps: 64 samples for edges <= 63*res/2, the long tier
    # (crossing_nmax_long) for the rest
    T1 = 64
    dab = pb - pa
    length = sqrt(dab[:, 0] * dab[:, 0] + dab[:, 1] * dab[:, 1])
    num = (length / f32(s.resolution * 0.5, dev)).to(torch.int32) + 1
    nmax_ridge = torch.where(num <= T1 - 1, _i32(T1, dev), _i32(s.crossing_nmax_long, dev))

    # ---- proximity edges <= 0.5 m (cpp:861-894), row-chunked --------------
    posm = torch.where(node_valid[:, None], pos, 1e9)
    iidx = torch.arange(N, dtype=torch.int32, device=dev)
    t = torch.as_tensor(params.proximity_edge_dist, dtype=torch.float32, device=dev)
    PPN = 8
    RC = min(_PROX_CHUNK, N)
    if N % RC:
        RC = N
    ppn_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    cand_rows = []
    for base in range(0, N, RC):
        rpos = posm[base:base + RC]
        ri = iidx[base:base + RC]
        ddx = rpos[:, None, 0] - posm[None, :, 0]
        ddy = rpos[:, None, 1] - posm[None, :, 1]
        d2 = ddx * ddx + ddy * ddy
        prox = (d2 <= t * t) & (d2 > 1e-12) & (iidx[None, :] > ri[:, None])
        ppn_overflow |= (prox.sum(dim=1) > PPN).any()
        row_j = torch.where(prox, iidx[None, :], N)
        cand_rows.append(torch.sort(row_j, dim=1, stable=True).values[:, :PPN])
    cand_j = torch.cat(cand_rows)
    cand_ok = cand_j < N
    cand_i = iidx[:, None].expand(N, PPN)
    PE = E
    psel, n_prox_cand = compact_true(cand_ok.reshape(-1), PE)
    sel_safe = torch.clamp(psel, min=0).long()
    cpi = torch.where(psel >= 0, cand_i.reshape(-1)[sel_safe], -1)
    cpj = torch.where(psel >= 0, cand_j.reshape(-1)[sel_safe], -1)
    pvalid = torch.arange(PE, device=dev) < n_prox_cand
    cpa = pos[torch.clamp(cpi, min=0).long()]
    cpb = pos[torch.clamp(cpj, min=0).long()]

    # ---- ONE crossing pass over ridge + prox candidates -------------------
    crossing_all, cross_guards = edge_crossing_packed(
        grid, torch.cat([pa, cpa]), torch.cat([pb, cpb]),
        torch.cat([nmax_ridge, torch.full((PE,), 32, dtype=torch.int32, device=dev)]),
        torch.cat([rvalid, pvalid]), s,
        cap=s.crossing_cap_edges_factor * s.max_edges)
    rvalid = rvalid & ~crossing_all[:E]
    pcross = crossing_all[E:]

    # re-compact surviving ridge edges (keeps sorted-key order)
    rrank2 = torch.cumsum(rvalid.to(torch.int32), 0, dtype=torch.int32) - 1
    rtgt2 = torch.where(rvalid & (rrank2 < E), rrank2, E)
    edges_a = scatter_set(E, -1, rtgt2, edges_a)
    edges_b = scatter_set(E, -1, rtgt2, edges_b)
    n_ridge = torch.clamp(rvalid.sum(dtype=torch.int32), max=E)

    # not already a surviving ridge edge (cpp:844-857)
    ar_e = torch.arange(E, device=dev)
    skeys = torch.sort(torch.where(ar_e < n_ridge, edges_a * N + edges_b, N * N)).values
    ckeys = torch.where(pvalid, cpi * N + cpj, N * N - 1)
    loc = torch.searchsorted(skeys, ckeys)
    in_ridge = (loc < E) & (skeys[torch.clamp(loc, max=E - 1)] == ckeys)
    pvalid = pvalid & ~in_ridge & ~pcross

    # ---- final edge list: ridges then proximity ---------------------------
    all_a = torch.cat([edges_a, torch.where(pvalid, cpi, -1)])
    all_b = torch.cat([edges_b, torch.where(pvalid, cpj, -1)])
    all_ok = torch.cat([ar_e < n_ridge, pvalid])
    frank = torch.cumsum(all_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    ftgt = torch.where(all_ok & (frank < E), frank, E)
    fa = scatter_set(E, -1, ftgt, all_a)
    fb = scatter_set(E, -1, ftgt, all_b)
    n_edges = torch.clamp(all_ok.sum(dtype=torch.int32), max=E)
    ev = ar_e < n_edges
    dd = pos[torch.clamp(fb, min=0).long()] - pos[torch.clamp(fa, min=0).long()]
    # sqrt(fma(dy, dy, dx * dx)): the fused multiply-add XLA:CPU makes of
    # aosx's squared length here
    lengths = torch.where(ev, sqrt(fma(dd[:, 1], dd[:, 1], dd[:, 0] * dd[:, 0])), 0.0)
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
    Returns (label_points [C,4,2], label_valid [C,4], node idx or -1)."""
    dev = pos.device
    C = s.max_rows
    res = f32(s.resolution, dev)

    swap = rows_sorted.ep1[:, 0] > rows_sorted.ep2[:, 0]
    ep1 = torch.where(swap[:, None], rows_sorted.ep2, rows_sorted.ep1)
    ep2 = torch.where(swap[:, None], rows_sorted.ep1, rows_sorted.ep2)

    eps = torch.stack([ep1, ep1, ep2, ep2], dim=1)          # [C,4,2]
    oth = torch.stack([ep2, ep2, ep1, ep1], dim=1)
    sign = torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=torch.float32, device=dev)

    d = oth - eps
    n = sqrt(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
    unit_x = torch.tensor([1.0, 0.0], dtype=torch.float32, device=dev)
    main = torch.where(n > 1e-6, d / torch.clamp(n, min=1e-6), unit_x)
    outward = -main
    perp = torch.stack([-main[..., 1], main[..., 0]], dim=-1)

    diff = pos[None, None, :, :] - eps[:, :, None, :]       # [C,4,N,2]
    dist = sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    dirn = diff / torch.clamp(dist, min=1e-12)[..., None]
    dot_out = outward[:, :, None, 0] * dirn[..., 0] + outward[:, :, None, 1] * dirn[..., 1]
    dot_perp = perp[:, :, None, 0] * dirn[..., 0] + perp[:, :, None, 1] * dirn[..., 1]
    base_ok = (
        node_valid[None, None, :]
        & (dist >= params.label_search_min_dist)
        & (dot_out >= 0.0)
        & (dot_perp * sign[None, :, None] >= 0.0)
    )
    gw = skel.w_cells.to(torch.float32) * res
    gh = skel.h_cells.to(torch.float32) * res
    diag2 = sqrt(gw * gw + gh * gh) * 2.0
    radii = [params.label_search_radius0, 7.0, 9.0, diag2]

    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    best_idx = torch.full((C, 4), -1, dtype=torch.int32, device=dev)
    found = torch.zeros((C, 4), dtype=torch.bool, device=dev)
    for r in radii:
        dmask = torch.where(base_ok & (dist <= r), dist, big)
        tier_found = dmask.min(dim=-1).values < big
        tier_idx = torch.argmin(dmask, dim=-1).to(torch.int32)
        best_idx = torch.where(~found & tier_found, tier_idx, best_idx)
        found = found | tier_found

    # castRay fallback for not-found (always "valid" per cpp:788-789)
    ray_dir = perp * sign[None, :, None]
    need = (~found & rows_sorted.valid[:, None]).reshape(C * 4)
    fb = _cast_ray_gvd(skel, eps.reshape(C * 4, 2), ray_dir.reshape(C * 4, 2),
                       need, s).reshape(C, 4, 2)
    node_pts = pos[torch.clamp(best_idx, min=0).long()]
    label_points = torch.where(found[..., None], node_pts, fb)
    label_valid = rows_sorted.valid[:, None].expand(C, 4)
    return label_points, label_valid, torch.where(found, best_idx, -1)


def assign_labels(pos, node_valid, label_points, label_valid, params, s: Statics):
    """publishGraph label matching (cpp:918-995): a node gets bit (1<<li)
    when within the tolerance of any cluster's label point;
    label_node[c,li] = first matching node index."""
    dev = pos.device
    N = s.max_nodes
    tol = torch.as_tensor(params.label_match_tolerance, dtype=torch.float32, device=dev)
    diff = pos[:, None, None, :] - label_points[None, :, :, :]     # [N,C,4,2]
    d = sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    match = (d < tol) & label_valid[None, :, :] & node_valid[:, None, None]
    bits = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=dev)
    node_labels = torch.where(match.any(dim=1), bits[None, :], 0).sum(dim=-1, dtype=torch.int32)
    idxs = torch.where(match, torch.arange(N, dtype=torch.int32, device=dev)[:, None, None], N)
    first = idxs.min(dim=0).values
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
    (``parallel.spatial.jump_flood_sharded``, bitwise equal)."""
    merged = merge_seeds(seeds, params, s)
    if stencil_mesh is not None:
        from ..parallel.spatial import jump_flood_sharded

        owner = jump_flood_sharded(skel, merged, s, stencil_mesh, stencil_axis)
    else:
        owner = jump_flood(skel, merged, s)
    pos, owners, node_valid = extract_vertices(skel, owner, s)
    ea, eb, ev, lengths, n_edges, edge_guards = build_edges(
        pos, owners, node_valid, skel, merged, params, s)
    label_points, label_valid, _ = find_labels(pos, node_valid, rows_sorted, skel, params, s)
    node_labels, label_node = assign_labels(pos, node_valid, label_points, label_valid, params, s)
    edges = torch.stack([ea, eb], dim=1)
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
        num_nodes=node_valid.sum(dtype=torch.int32),
        num_edges=n_edges,
        guards=edge_guards,
    )
