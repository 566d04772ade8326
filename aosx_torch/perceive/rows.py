"""Skeleton clustering + tree-row fitting (mirror of
``aosx/perceive/rows.py``; reference: aos_seed_gen_node.cpp:970-1512).

- Connected components run on the compacted skeleton-cell list: a
  run-level union-find (horizontal runs are the unit of merging), with the
  exact cell-level union-find as the fallback when the run/pair buffers
  overflow. Component root = min compact index = first cell in raster
  order, which is the reference's BFS discovery order.
- Per-cluster stats are segment reductions over the cell list. The sums
  add integer-valued cell coordinates, so they are exact in any order while
  a cluster's sum stays below 2^24.
- Exact max-pairwise cluster length over +-1 blocks of the cells sorted
  (stably) by cluster id.
- Endpoints: farthest-from-centroid, then farthest in the opposite
  half-space; ties broken by the lowest cell index.

World axis: every function also takes a leading world axis B on its grids,
polygons, cell lists and cluster arrays (the axis ``aosx`` maps with
``jax.vmap``). The union-find loops run while any world changes, each
world's update masked with its own condition; sorts run per world; the
exact cell-level fallback, a host branch here and a ``lax.cond`` in
``aosx`` (a select of both branches under ``vmap``), runs when any world
overflowed and is kept only for the worlds that did.
"""

from __future__ import annotations

import math

import torch

from ..config import AosParams, Statics, _round_up
from ..geom import point_in_polygon
from ..guards import (
    GUARD_CCL_CELL_FALLBACK,
    GUARD_CLUSTER_CAP,
    GUARD_CLUSTER_LEN,
    GUARD_SKEL_OVERFLOW,
)
from ..ops import (
    chunk_rows,
    compact_take,
    compact_true,
    compact_true_hier,
    gather_last,
    lanes,
    read_any,
    scatter_set,
    segment_max,
    segment_min,
    segment_sum,
    sqrt,
    take,
    while_loop,
)
from ..types import GridWorld, Polygon, TreeRows
from .raster import f32, live_mask

_NEIGH = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))

# rows of the [nblk, rows, 3B] pairwise-length tile evaluated at once (for all
# the worlds of a group together: ops.chunk_rows)
_LEN_CHUNK = 512


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _compress(L):
    """Four fixed pointer-jumping hops (as aosx's union-find rounds), per lane."""
    for _ in range(4):
        L = torch.minimum(L, gather_last(L, L))
    return L


def compact_inverse(cell_flat, cell_ok, n: int):
    """inv [*B, n + 1] i32: flat index -> compact index of a cell that
    cell_ok keeps, M = cell_flat.shape[-1] at every other index and at the
    pad slot n. Cells scatter to distinct indices and the rest to
    ``scatter_set``'s drop slot, so no two writes race."""
    M = cell_flat.shape[-1]
    tgt = torch.where(cell_ok, torch.clamp(cell_flat, min=0), n + 1)
    return scatter_set(n + 1, M, tgt, _arange(M, cell_flat.device).expand(cell_flat.shape))


def compact_cells(mask, s: Statics):
    """Scatter-compact the True cells of mask [*B, H, W] into raster order.

    Returns (cell_flat [*B, M] i32 flat index or -1, cell_ok [*B, M] bool,
    inv [*B, H*W+1] i32 mapping flat index -> compact index, M if not a
    cell), M = s.max_skel_cells."""
    h, w = mask.shape[-2:]
    cell_flat, _ = compact_true(mask.flatten(-2), s.max_skel_cells)
    cell_ok = cell_flat >= 0
    return cell_flat, cell_ok, compact_inverse(cell_flat, cell_ok, h * w)


def neighbor_table(cell_flat, cell_ok, inv, h: int, w: int):
    """[*B, M, 8] compact indices of 8-neighbours (M = none)."""
    safe = torch.clamp(cell_flat, min=0)
    cy = safe // w
    cx = safe % w
    cols = []
    for dy, dx in _NEIGH:
        ny, nx = cy + dy, cx + dx
        ok = cell_ok & (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        nflat = torch.where(ok, ny * w + nx, h * w)
        cols.append(gather_last(inv, nflat))
    return torch.stack(cols, dim=-1)


def _run_starts(cell_flat, cell_ok, w: int):
    """(cont, is_start): a cell continues the run of the previous compact
    slot, or starts a run. prev_ok breaks runs at cells masked out after
    compaction (the polygon filter)."""
    dev = cell_flat.device
    B = cell_flat.shape[:-1]
    prev_flat = torch.cat([torch.full(B + (1,), -9, dtype=torch.int32, device=dev),
                           cell_flat[..., :-1]], dim=-1)
    prev_ok = torch.cat([torch.zeros(B + (1,), dtype=torch.bool, device=dev),
                         cell_ok[..., :-1]], dim=-1)
    xcol = torch.where(cell_flat >= 0, cell_flat % w, 0)
    cont = (cell_flat == prev_flat + 1) & (xcol > 0) & cell_ok & prev_ok
    return cont, cell_ok & ~cont


def run_collapse_init(cell_flat, cell_ok, w: int):
    """Initial labels with horizontal runs pre-merged: label = compact index
    of the run's first cell."""
    M = cell_flat.shape[-1]
    cont, _ = _run_starts(cell_flat, cell_ok, w)
    idx = _arange(M, cell_flat.device)
    starts = torch.where(cont, -1, idx)
    L = torch.cummax(starts, dim=-1).values
    return torch.where(cell_ok, L, idx)


def union_find_labels(nbrs, s: Statics, L0=None):
    """Connected-component labels on the compact cell list (hook each
    cell's minimum neighbour label onto its root, then compress).
    nbrs [*B, M, k]. Returns L [*B, M] i32: per-cell root compact index
    (root = min index). Each lane's loop state is updated only while its
    own condition holds."""
    M = nbrs.shape[-2]
    B = nbrs.shape[:-2]
    dev = nbrs.device
    if L0 is None:
        L0 = _arange(M, dev).expand(B + (M,))
    m_col = torch.full(B + (1,), M, dtype=torch.int32, device=dev)

    def cond(st):
        _, changed, it = st
        return changed & (it < s.ccl_max_iters)

    def body(st):
        L, changed, it = st
        active = changed & (it < s.ccl_max_iters)
        nbmin = gather_last(torch.cat([L, m_col], dim=-1), nbrs).min(dim=-1).values
        nbmin = torch.minimum(nbmin, L)
        L1 = L.scatter_reduce(-1, L.long(), nbmin, reduce="amin", include_self=True)
        L1 = _compress(L1)
        return (torch.where(active[..., None], L1, L),
                torch.where(active, (L1 != L).any(dim=-1), changed),
                it + active.to(torch.int32))

    state = (L0, torch.ones(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    L, _, _ = while_loop(cond, body, state, "union_find_labels")
    return L


def run_level_labels(cell_flat, cell_ok, h: int, w: int, s: Statics):
    """Connected-component labels via a run-level union-find (see
    ``aosx.perceive.rows.run_level_labels``). Returns (L [*B, M] i32 root
    compact index per cell, overflow bool [*B]); on overflow the labels are
    garbage and the caller takes the cell-level path."""
    M = cell_flat.shape[-1]
    B = cell_flat.shape[:-1]
    dev = cell_flat.device
    R = s.max_ccl_runs or max(256, s.max_skel_cells // 8)
    P = R

    _, is_start = _run_starts(cell_flat, cell_ok, w)
    nrun = is_start.sum(dim=-1, dtype=torch.int32)
    rid = torch.cumsum(is_start.to(torch.int32), -1, dtype=torch.int32) - 1

    tgt = torch.where(cell_ok, torch.clamp(cell_flat, min=0), h * w + 1)
    rid_plane = scatter_set(h * w + 1, -1, tgt, rid)

    safe = torch.clamp(cell_flat, min=0)
    cy = safe // w
    cx = safe % w
    pas, pbs, oks = [], [], []
    for dy, dx in _NEIGH[:3]:
        ny, nx = cy + dy, cx + dx
        inb = cell_ok & (ny >= 0) & (nx >= 0) & (nx < w)
        nflat = torch.where(inb, ny * w + nx, h * w)
        rnb = gather_last(rid_plane, nflat)
        oks.append(inb & (rnb >= 0))
        pas.append(rid)
        pbs.append(rnb)
    pa_all = torch.cat(pas, dim=-1)
    pb_all = torch.cat(pbs, dim=-1)
    ok_all = torch.cat(oks, dim=-1)
    npairs = ok_all.sum(dim=-1, dtype=torch.int32)

    sel, _ = compact_true(ok_all, P)
    pa = torch.clamp(compact_take(pa_all, sel, R), max=R - 1).long()
    pb = torch.clamp(compact_take(pb_all, sel, R), max=R - 1).long()
    pok = sel >= 0
    r_drop = torch.full_like(sel, R)

    def cond(st):
        _, changed, it = st
        return changed & (it < s.ccl_max_iters)

    def body(st):
        Lr, changed, it = st
        active = changed & (it < s.ccl_max_iters)
        ca = gather_last(Lr, pa)
        cb = gather_last(Lr, pb)
        m = torch.minimum(ca, cb)
        ext = torch.cat([Lr, Lr.new_full(B + (1,), R)], dim=-1)
        ext = ext.scatter_reduce(-1, torch.where(pok, ca, r_drop).long(), m,
                                 reduce="amin", include_self=True)
        ext = ext.scatter_reduce(-1, torch.where(pok, cb, r_drop).long(), m,
                                 reduce="amin", include_self=True)
        Lr1 = _compress(ext[..., :R])
        return (torch.where(active[..., None], Lr1, Lr),
                torch.where(active, (Lr1 != Lr).any(dim=-1), changed),
                it + active.to(torch.int32))

    state = (_arange(R, dev).expand(B + (R,)), torch.ones(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    Lr, _, _ = while_loop(cond, body, state, "run_level_labels")

    # root run -> its start's compact index (= the component's min cell)
    stgt = torch.where(is_start & (rid < R), rid, R)
    run_start_idx = scatter_set(R, M, stgt, _arange(M, dev).expand(B + (M,)))
    root_run = gather_last(Lr, torch.clamp(rid, 0, R - 1))
    L = torch.where(cell_ok, gather_last(run_start_idx, root_run), _arange(M, dev))
    overflow = (nrun > R) | (npairs > P)
    return L, overflow


def cluster_grid(skel: GridWorld, poly: Polygon, params: AosParams, s: Statics):
    """clusterOccupiedCells (cpp:970-1083): components of occupied and
    in-polygon cells. Returns padded cluster arrays (grid-unit centers, exact
    lengths in meters, sizes) ordered like the reference, plus the compacted
    cell list; every array with the grid's world axes leading."""
    h, w = skel.occ.shape[-2:]
    B = skel.occ.shape[:-2]
    G = math.prod(B)
    dev = skel.occ.device
    res = f32(s.resolution, dev)
    M = s.max_skel_cells
    K = s.max_clusters
    mask0 = (skel.occ == 1) & live_mask(skel)
    cell_flat, _, hier_overflow = compact_true_hier(
        mask0.flatten(-2), M, kw=max(4096, M // 8),
        exact_fallback=s.exact_fallbacks, with_overflow=True,
    )
    in_buf = cell_flat >= 0
    safe0 = torch.clamp(cell_flat, min=0)
    cwx0 = lanes(skel.origin_x, safe0) + (safe0 % w).to(torch.float32) * res
    cwy0 = lanes(skel.origin_y, safe0) + (safe0 // w).to(torch.float32) * res
    has_poly = poly.count >= 3
    inp = point_in_polygon(cwx0, cwy0, poly)
    cell_ok = in_buf & torch.where(lanes(has_poly, inp), inp, True)

    L_fast, uf_overflow = run_level_labels(cell_flat, cell_ok, h, w, s)
    if s.exact_fallbacks and read_any(uf_overflow, "uf_overflow"):
        # the cell-level fallback for every world, kept where it overflowed
        nbrs = neighbor_table(cell_flat, cell_ok, compact_inverse(cell_flat, cell_ok, h * w),
                              h, w)
        # run-collapse init keeps each horizontal run label-uniform, so the
        # W (col 3) and E (col 4) neighbours never contribute a new minimum
        nbrs6 = nbrs[..., [0, 1, 2, 5, 6, 7]]
        L_exact = union_find_labels(nbrs6, s, L0=run_collapse_init(cell_flat, cell_ok, w))
        L = torch.where(uf_overflow[..., None], L_exact, L_fast)
    else:
        L = L_fast

    # cluster ids: rank of root among roots (raster == discovery order)
    ar = _arange(M, dev)
    is_root = cell_ok & (L == ar)
    rank = torch.cumsum(is_root.to(torch.int32), -1, dtype=torch.int32) - 1
    n_clusters = is_root.sum(dim=-1, dtype=torch.int32)
    root_rank = torch.where(is_root, rank, 0)
    # overflowed fast-only labels may point past the buffer; aosx's gather
    # clamps such indices
    cid = torch.where(cell_ok, gather_last(root_rank, torch.clamp(L, 0, M - 1)), -1)

    seg = torch.where((cid >= 0) & (cid < K), cid, K)
    cell_x = torch.where(cell_ok, (safe0 % w).to(torch.float32), 0.0)
    cell_y = torch.where(cell_ok, (safe0 // w).to(torch.float32), 0.0)

    ones = torch.where(cell_ok, 1.0, 0.0)
    count = segment_sum(ones, seg, K + 1)[..., :K]
    sum_x = segment_sum(cell_x, seg, K + 1)[..., :K]
    sum_y = segment_sum(cell_y, seg, K + 1)[..., :K]
    valid = (_arange(K, dev) < torch.clamp(n_clusters, max=K)[..., None]) & (count > 0)
    one = torch.ones_like(count)
    center_x = torch.where(count > 0, sum_x / torch.maximum(count, one), 0.0)
    center_y = torch.where(count > 0, sum_y / torch.maximum(count, one), 0.0)

    # exact max pairwise distance per cluster over +-1 blocks of the cells
    # sorted (stably) by cluster id
    cell_cid = torch.where(cell_ok, torch.clamp(seg, max=K), K)
    Bk = s.cluster_band if s.cluster_band else min(4096, M)
    if Bk > 512:
        Bk = _round_up(Bk, 512)
    nblk = (M + Bk - 1) // Bk
    Mp = nblk * Bk
    sorder = torch.argsort(cell_cid, dim=-1, stable=True)
    sx = gather_last(torch.where(cell_ok, cell_x, 1e9), sorder)
    sy = gather_last(torch.where(cell_ok, cell_y, -1e9), sorder)
    sc = gather_last(cell_cid, sorder)
    if Mp != M:
        sx = torch.cat([sx, torch.full(B + (Mp - M,), 1e9, device=dev)], dim=-1)
        sy = torch.cat([sy, torch.full(B + (Mp - M,), -1e9, device=dev)], dim=-1)
        sc = torch.cat([sc, torch.full(B + (Mp - M,), K, dtype=torch.int32, device=dev)], dim=-1)
    sxb = sx.reshape(B + (nblk, Bk))
    syb = sy.reshape(B + (nblk, Bk))
    scb = sc.reshape(B + (nblk, Bk))

    def nb_concat(a, fill):
        pad = torch.full(B + (1, Bk), fill, dtype=a.dtype, device=dev)
        left = torch.cat([pad, a[..., :-1, :]], -2)
        right = torch.cat([a[..., 1:, :], pad], -2)
        return torch.cat([left, a, right], dim=-1)     # [*B, nblk, 3Bk]

    tx = nb_concat(sxb, -1e9)
    ty = nb_concat(syb, 1e9)
    tc = nb_concat(scb, K)
    best = torch.full(B + (K + 1,), -1.0, device=dev)
    C = min(chunk_rows(_LEN_CHUNK, G), Bk)
    for j in range(0, Bk, C):
        rx = sxb[..., j:j + C, None]
        ry = syb[..., j:j + C, None]
        rc = scb[..., j:j + C]
        ddx = rx - tx[..., None, :]
        ddy = ry - ty[..., None, :]
        d2 = ddx * ddx + ddy * ddy
        same = rc[..., None] == tc[..., None, :]
        row_max = torch.where(same, d2, -1.0).max(dim=-1).values
        best = torch.maximum(best, segment_max(row_max.flatten(-2), rc.flatten(-2), K + 1))
    length = torch.where(valid, sqrt(torch.clamp(best[..., :K], min=0.0)) * res, 0.0)

    n_cells_true = mask0.sum(dim=(-2, -1), dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    guards = torch.where(n_cells_true > M, GUARD_SKEL_OVERFLOW, zero)
    if not s.exact_fallbacks:
        guards |= torch.where(hier_overflow, GUARD_SKEL_OVERFLOW, zero)
    if Bk < M:
        guards |= torch.where((count > Bk).any(dim=-1), GUARD_CLUSTER_LEN, zero)
    guards |= torch.where(uf_overflow, GUARD_CCL_CELL_FALLBACK, zero)
    guards |= torch.where(n_clusters > K, GUARD_CLUSTER_CAP, zero)

    return dict(
        guards=guards,
        count=count,
        center_x=center_x,
        center_y=center_y,
        length=length,
        valid=valid,
        n_clusters=n_clusters,
        cell_x=cell_x,
        cell_y=cell_y,
        cell_cid=cell_cid,
        cell_ok=cell_ok,
    )


def rows_from_clusters(clusters: dict, skel: GridWorld, poly: Polygon,
                       params: AosParams, s: Statics) -> TreeRows:
    """Length filter (cpp:1262-1270) + convertClustersToTreeRows
    (cpp:1309-1512). Rows keep the cluster order (NOT sorted)."""
    K = s.max_clusters
    dev = skel.occ.device
    res = f32(s.resolution, dev)
    center_wx = lanes(skel.origin_x, clusters["center_x"]) + clusters["center_x"] * res
    center_wy = lanes(skel.origin_y, clusters["center_y"]) + clusters["center_y"] * res
    has_poly = poly.count >= 3
    in_poly = point_in_polygon(center_wx, center_wy, poly)
    keep = (
        clusters["valid"]
        & (clusters["length"] >= lanes(params.cluster_min_length, center_wx))
        & torch.where(lanes(has_poly, in_poly), in_poly, True)
    )

    cwx = lanes(skel.origin_x, clusters["cell_x"]) + clusters["cell_x"] * res
    cwy = lanes(skel.origin_y, clusters["cell_y"]) + clusters["cell_y"] * res
    ccid = clusters["cell_cid"]
    M = cwx.shape[-1]
    ar = _arange(M, dev)
    cidc = torch.clamp(ccid, max=K - 1)

    dx = cwx - gather_last(center_wx, cidc)
    dy = cwy - gather_last(center_wy, cidc)
    d2 = dx * dx + dy * dy
    d2m = torch.where(ccid < K, d2, -1.0)
    segs = torch.clamp(ccid, max=K)

    def seg_argmax(vals):
        """argmax per segment, lowest index on ties; M when empty."""
        maxv = segment_max(vals, segs, K + 1)
        is_max = (vals == gather_last(maxv, segs)) & (vals > -0.5)
        arg = segment_min(torch.where(is_max, ar, M), segs, K + 1)
        return maxv, arg

    max_d2, arg1 = seg_argmax(d2m)
    arg1 = torch.clamp(arg1[..., :K], max=M - 1)
    ep1x, ep1y = gather_last(cwx, arg1), gather_last(cwy, arg1)
    n1 = sqrt(torch.clamp(max_d2[..., :K], min=1e-30))
    f_dirx = (ep1x - center_wx) / n1
    f_diry = (ep1y - center_wy) / n1

    nrm = sqrt(torch.clamp(d2, min=1e-30))
    dot = (dx / nrm) * gather_last(f_dirx, cidc) + (dy / nrm) * gather_last(f_diry, cidc)
    not_first = ar != gather_last(arg1, cidc)
    opp_ok = (dot < 0.0) & not_first & (ccid < K) & (d2 > 0)
    max_opp, arg2a = seg_argmax(torch.where(opp_ok, d2, -1.0))
    fdx = cwx - gather_last(ep1x, cidc)
    fdy = cwy - gather_last(ep1y, cidc)
    _, arg2b = seg_argmax(torch.where(not_first & (ccid < K), fdx * fdx + fdy * fdy, -1.0))
    use_fallback = max_opp[..., :K] <= 0.0
    arg2 = torch.clamp(torch.where(use_fallback, arg2b[..., :K], arg2a[..., :K]), max=M - 1)
    ep2x, ep2y = gather_last(cwx, arg2), gather_last(cwy, arg2)

    R = s.max_rows
    kept_rank = torch.cumsum(keep.to(torch.int32), -1, dtype=torch.int32) - 1
    n_rows = keep.sum(dim=-1, dtype=torch.int32)
    tgt = torch.where(keep & (kept_rank < R), kept_rank, R)

    def compact(vals):
        return scatter_set(R, 0.0, tgt, vals)

    return TreeRows(
        center=torch.stack([compact(center_wx), compact(center_wy)], -1),
        ep1=torch.stack([compact(ep1x), compact(ep1y)], -1),
        ep2=torch.stack([compact(ep2x), compact(ep2y)], -1),
        length=compact(clusters["length"]),
        valid=_arange(R, dev) < torch.clamp(n_rows, max=R)[..., None],
    )


def lexsort2(primary, secondary):
    """Stable order by (primary, secondary) along the last axis, as
    ``jnp.lexsort((secondary, primary))``: two stable sorts."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    return gather_last(o1, torch.argsort(gather_last(primary, o1), dim=-1, stable=True))


def sort_rows(rows: TreeRows) -> TreeRows:
    """Sort by center y (x tie-break within 1e-6; cpp:2552-2560). y is
    quantized relative to the smallest valid y so y*1e6 keeps its 1e-6
    tolerance in f32. Each world's rows sort on their own."""
    big = torch.tensor(1e9, dtype=torch.float32, device=rows.center.device)
    key_y = torch.where(rows.valid, rows.center[..., 1], big)
    key_x = torch.where(rows.valid, rows.center[..., 0], big)
    ybase = key_y.min(dim=-1, keepdim=True).values
    order = lexsort2(torch.round((key_y - ybase) * 1e6), key_x)
    nb = order.dim() - 1
    return TreeRows(
        center=take(rows.center, order, nb),
        ep1=take(rows.ep1, order, nb),
        ep2=take(rows.ep2, order, nb),
        length=take(rows.length, order, nb),
        valid=take(rows.valid, order, nb),
    )
