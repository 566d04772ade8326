"""Path linearization (mirror of ``aosx/plan/linearize.py``; reference:
src/aos_path_linearization_node.cpp).

Recursive regression splitting (max 4 segments; 10 when the goal is the
origin), 5 cm interpolation, backtracking-point removal. The per-split
regression sums come from prefix sums; the recursion is an explicit DFS
stack (left segment first, as the reference calls it).
"""

from __future__ import annotations

import torch

from ..config import AosParams, Statics
from ..geom import atan2
from ..ops import scatter_set, sqrt, while_loop
from ..types import Path

SEG_CAP = 1024  # interpolated points cap per segment (51 m at 5 cm)
_FAR = 3.4e38


def _prefix(v):
    """[0, v0, v0+v1, ...] in f32, accumulated in f64 so that every device
    gives the same sums."""
    c = torch.cumsum(v.double(), 0).float()
    return torch.cat([torch.zeros(1, dtype=torch.float32, device=v.device), c])


def _fit_tables(xy, count):
    """Prefix sums giving (slope, intercept, mse) of any [s, e] in O(1)."""
    m = torch.arange(xy.shape[0], device=xy.device) < count
    x = torch.where(m, xy[:, 0], 0.0)
    y = torch.where(m, xy[:, 1], 0.0)
    return dict(sx=_prefix(x), sy=_prefix(y), sxy=_prefix(x * y),
                sxx=_prefix(x * x), syy=_prefix(y * y))


def _linreg(tab, s_, e_):
    """y = a x + b over inclusive [s, e] (cpp:50-96). Returns (a, b, mse)."""
    n = (e_ - s_ + 1).to(torch.float32)
    ei = (e_ + 1).long()
    si = s_.long()

    def seg(p):
        return p[ei] - p[si]

    sx, sy = seg(tab["sx"]), seg(tab["sy"])
    sxy, sxx, syy = seg(tab["sxy"]), seg(tab["sxx"]), seg(tab["syy"])
    den = n * sxx - sx * sx
    degenerate = torch.abs(den) < 1e-9
    nn = torch.clamp(n, min=1.0)
    a = torch.where(degenerate, 0.0,
                    (n * sxy - sx * sy) / torch.where(degenerate, torch.ones_like(den), den))
    b = torch.where(degenerate, sy / nn, (sy - a * sx) / nn)
    err = (syy - 2 * a * sxy - 2 * b * sy + a * a * sxx + 2 * a * b * sx + n * b * b) / nn
    short = (e_ <= s_) | (e_ - s_ < 2)
    return (torch.where(short, 0.0, a), torch.where(short, 0.0, b),
            torch.where(short, 0.0, torch.clamp(err, min=0.0)))


def _best_split(tab, s_, e_, P):
    """findBestSplitPoint (cpp:99-125): argmin over sp in (s, e) of the
    count-weighted mean of the two segment MSEs."""
    sp = torch.arange(P, dtype=torch.int32, device=s_.device)
    ones = torch.ones(P, dtype=torch.int32, device=s_.device)
    _, _, e1 = _linreg(tab, ones * s_, sp)
    _, _, e2 = _linreg(tab, sp, ones * e_)
    n1 = (sp - s_ + 1).to(torch.float32)
    n2 = (e_ - sp + 1).to(torch.float32)
    tot = (e1 * n1 + e2 * n2) / torch.clamp(n1 + n2, min=1.0)
    tot = torch.where((sp > s_) & (sp < e_), tot, _FAR)
    best = torch.argmin(tot).to(torch.int32)
    return torch.where(e_ <= s_ + 1, e_, best)


def _find_breakpoints(xy, count, max_segments, params, P):
    """splitPathRecursive (cpp:128-177) as an explicit DFS stack (left
    first). Returns bp_mask [P]. A body with an empty stack changes
    nothing (its updates are masked)."""
    dev = xy.device
    tab = _fit_tables(xy, count)
    idxs = torch.arange(P, device=dev)
    STK = 2 * 16

    def body(st):
        bp_mask, stack_s, stack_e, sp_, nbp = st
        active = sp_ > 0
        top = torch.clamp(sp_ - 1, min=0)
        s_ = stack_s[top.long()]
        e_ = stack_e[top.long()]
        a, b, _ = _linreg(tab, s_, e_)
        interior = (idxs > s_) & (idxs < e_) & (idxs < count)
        dev_ = torch.abs(xy[:, 1] - (a * xy[:, 0] + b))
        max_dev = torch.where(interior, dev_, -1.0).max()
        skip = (e_ <= s_) | (max_dev < params.linearize_max_dev) | (nbp >= max_segments - 1)
        split = _best_split(tab, s_, e_, P)
        si = split.long()
        is_new = ~bp_mask[si] & ~skip
        bp2 = bp_mask.clone()
        bp2[si] = bp_mask[si] | ~skip
        nbp2 = nbp + is_new.to(torch.int32)
        recurse = ~skip & (nbp2 < max_segments - 1)
        # push right then left (left popped first)
        ss2 = stack_s.clone()
        se2 = stack_e.clone()
        ss2[top.long()] = split
        se2[top.long()] = e_
        ss2[(top + 1).long()] = s_
        se2[(top + 1).long()] = split
        ss2 = torch.where(recurse, ss2, stack_s)
        se2 = torch.where(recurse, se2, stack_e)
        sp2 = torch.where(recurse, top + 2, top)
        return (torch.where(active, bp2, bp_mask), torch.where(active, ss2, stack_s),
                torch.where(active, se2, stack_e), torch.where(active, sp2, sp_),
                torch.where(active, nbp2, nbp))

    ss = torch.zeros(STK, dtype=torch.int32, device=dev)
    se = torch.zeros(STK, dtype=torch.int32, device=dev)
    se[0] = count - 1
    state = (torch.zeros(P, dtype=torch.bool, device=dev), ss, se,
             torch.ones((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    bp_mask, _, _, _, _ = while_loop(lambda st: st[3] > 0, body, state)
    return bp_mask


def _dot_rows(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def _backtrack_keep(oxy, oseg, ocount, NSEG: int):
    """Keep-mask of the sequential backtracking removal, computed per
    segment (see aosx.plan.linearize for the equivalence argument). Carry:
    the last two kept points and the kept count."""
    dev = oxy.device
    Q = oxy.shape[0]
    idxq = torch.arange(Q, device=dev)
    live = idxq < ocount
    prev2 = torch.zeros(2, dtype=torch.float32, device=dev)
    prev1 = torch.zeros(2, dtype=torch.float32, device=dev)
    nkept = torch.zeros((), dtype=torch.int32, device=dev)
    keep = torch.zeros(Q, dtype=torch.bool, device=dev)
    for j in range(NSEG):
        in_seg = (oseg == j) & live
        vals0 = _dot_rows(oxy - prev1[None, :], (prev1 - prev2)[None, :])
        c1 = in_seg & ((nkept <= 1) | (vals0 >= -0.01))
        any1 = c1.any()
        k1 = c1.to(torch.uint8).argmax()
        p_k1 = oxy[k1]
        prev2_a = torch.where(nkept >= 1, prev1, prev2)
        vals1 = _dot_rows(oxy - p_k1[None, :], (p_k1 - prev2_a)[None, :])
        c2 = in_seg & (idxq > k1) & ((nkept + 1 <= 1) | (vals1 >= -0.01))
        any2 = c2.any()
        k2 = c2.to(torch.uint8).argmax()
        keep_seg = in_seg & any1 & ((idxq == k1) | (any2 & (idxq >= k2)))
        cnt = keep_seg.sum(dtype=torch.int32)
        last = torch.where(keep_seg, idxq, -1).max()
        second = torch.where(keep_seg & (idxq < last), idxq, -1).max()
        p_last = oxy[torch.clamp(last, min=0)]
        p_second = oxy[torch.clamp(second, min=0)]
        new_prev1 = torch.where(cnt >= 1, p_last, prev1)
        new_prev2 = torch.where(cnt >= 2, p_second,
                                torch.where((cnt == 1) & (nkept >= 1), prev1, prev2))
        prev2, prev1, nkept = new_prev2, new_prev1, nkept + cnt
        keep = keep | keep_seg
    return keep


def breakpoint_mask(path: Path, params: AosParams, s: Statics):
    """[max_path] bool: the points where the linearized path's segments
    start and end (0 and count - 1 included); every point of a path of at
    most 4, else the regression split's (max 10 segments when the goal is
    the origin, else 4)."""
    P = s.max_path
    xy, count = path.xy, path.count
    end_pt = xy[torch.clamp(count - 1, min=0).long()]
    is_long = (torch.abs(end_pt[0]) < 1e-6) & (torch.abs(end_pt[1]) < 1e-6)
    max_segments = torch.where(is_long, s.max_segments, 4).to(torch.int32)

    bp_mask = _find_breakpoints(xy, count, max_segments, params, P)
    idxs = torch.arange(P, device=xy.device)
    interior_all = (idxs > 0) & (idxs < count - 1)
    bp_mask = torch.where(count <= 4, interior_all, bp_mask)
    bp_mask = bp_mask & (idxs > 0) & (idxs < count - 1)
    bp_mask = bp_mask.clone()
    bp_mask[0] = count > 0
    bp_mask = bp_mask | (idxs == count - 1)
    return bp_mask & (idxs < count)


def linearize(path: Path, params: AosParams, s: Statics) -> Path:
    """convertToLinearSegments (cpp:248-370). Input path of n points:
    n <= 1: passthrough; n == 2: one interpolated segment; 3 <= n <= 4:
    consecutive-point interpolation; else regression split."""
    dev = path.xy.device
    P = s.max_path
    Q = s.max_plan
    xy, count = path.xy, path.count
    end_pt = xy[torch.clamp(count - 1, min=0).long()]
    start_pt = xy[0]
    bp_mask = breakpoint_mask(path, params, s)
    idxs = torch.arange(P, device=dev)

    NSEG = max(s.max_segments, 4) + 1
    MAXBP = NSEG + 1
    rank = torch.cumsum(bp_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(bp_mask & (rank < MAXBP), rank, MAXBP)
    bps = scatter_set(MAXBP, -1, tgt, idxs.to(torch.int32))
    nbp = torch.clamp(bp_mask.sum(dtype=torch.int32), max=MAXBP)

    # ---- interpolate segments at 5 cm (cpp:190-245) -----------------------
    spacing = params.linearize_spacing
    seg_i = torch.arange(NSEG, device=dev)
    s_idx = bps[torch.clamp(seg_i, 0, MAXBP - 1)]
    e_idx = bps[torch.clamp(seg_i + 1, 0, MAXBP - 1)]
    seg_ok = (seg_i < nbp - 1) & (s_idx >= 0) & (e_idx >= 0)
    p1 = xy[torch.clamp(s_idx, min=0).long()]
    p2 = xy[torch.clamp(e_idx, min=0).long()]
    d = p2 - p1
    dist = sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    yaw = atan2(d[:, 1], d[:, 0])
    degen = dist < 1e-6
    num_mid = torch.floor(dist / spacing).to(torch.int32)
    cand = torch.clamp(num_mid, max=SEG_CAP - 1)
    t_cand = cand.to(torch.float32) * spacing / torch.clamp(dist, min=1e-9)
    n_mid = torch.clamp(cand - (t_cand >= 1.0).to(torch.int32), min=0)
    has_end = (n_mid + 1) <= SEG_CAP - 1
    first = seg_i == 0
    k0 = torch.where(first, 0, 1)
    cnt = torch.where(seg_ok & ~degen,
                      n_mid + first.to(torch.int32) + has_end.to(torch.int32), 0)
    cnt = torch.where(seg_ok & degen, torch.where(first, 1, 0), cnt)
    off = torch.cumsum(cnt, 0) - cnt
    total = cnt.sum()

    qidx = torch.arange(Q, device=dev)
    onehot = (qidx[:, None] >= off[None, :]) & (qidx[:, None] < (off + cnt)[None, :])
    valid_q = onehot.any(dim=1)

    def pick(v):
        """[NSEG] -> [Q]; exactly one (or zero) nonzero term per slot."""
        return torch.where(onehot, v[None, :], torch.zeros_like(v)[None, :]).sum(dim=1)

    kq_i = qidx - pick(off) + pick(k0)
    t_q = kq_i.to(torch.float32) * spacing / torch.clamp(pick(dist), min=1e-9)
    is_end_q = valid_q & (kq_i == pick(n_mid) + 1)
    px_q = torch.where(is_end_q, pick(p2[:, 0]), pick(p1[:, 0]) + t_q * pick(d[:, 0]))
    py_q = torch.where(is_end_q, pick(p2[:, 1]), pick(p1[:, 1]) + t_q * pick(d[:, 1]))
    oxy = torch.where(valid_q[:, None], torch.stack([px_q, py_q], dim=1), 0.0)
    oyaw = torch.where(valid_q, pick(yaw), 0.0)
    oseg = torch.where(valid_q, pick(seg_i), NSEG)
    ocount = torch.clamp(total, max=Q)

    # exact endpoints (cpp:329-333)
    has_pts = ocount > 0
    oxy = oxy.clone()
    oxy[0] = torch.where(has_pts, start_pt, oxy[0])
    last_i = torch.clamp(ocount - 1, min=0)
    oxy[last_i] = torch.where(has_pts, end_pt, oxy[last_i])

    # ---- backtracking removal (cpp:336-369) -------------------------------
    keep = _backtrack_keep(oxy, oseg, ocount, NSEG)
    keep = torch.where(ocount <= 2, qidx < ocount, keep)
    rank3 = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt3 = torch.where(keep & (rank3 < Q), rank3, Q)
    fxy = scatter_set(Q, 0.0, tgt3, oxy)
    fyaw = scatter_set(Q, 0.0, tgt3, oyaw)
    fcount = torch.clamp(keep.sum(dtype=torch.int32), max=Q)
    fi = torch.clamp(fcount - 1, min=0)
    fxy[fi] = torch.where(fcount > 0, end_pt, fxy[fi])

    # passthrough for 0/1-point paths
    tiny = count <= 1
    tiny_xy = torch.zeros_like(fxy)
    tiny_xy[0] = start_pt
    return Path(xy=torch.where(tiny, tiny_xy, fxy),
                yaw=torch.where(tiny, torch.zeros_like(fyaw), fyaw),
                count=torch.where(tiny, count, fcount).to(torch.int32))
