"""Path linearization (mirror of ``aosx/plan/linearize.py``; reference:
src/aos_path_linearization_node.cpp).

Recursive regression splitting (max 4 segments; 10 when the goal is the
origin), 5 cm interpolation, backtracking-point removal. The per-split
regression sums come from prefix sums; the recursion is an explicit DFS
stack (left segment first, as the reference calls it).

The f32 arithmetic is XLA:CPU's for the jitted reference (``jax.lax.map``
of ``linearize``, as ``build_plan_cache`` runs it, and ``engine.step``),
bit for bit: the prefix sums in its blocked scan (``ops.cumsum_xla``),
and a fused multiply-add (``ops.fma``) wherever it contracts one, read
from its optimized HLO and held against it
(tests/test_torch_linearize_parity.py). In a - b where both are products
it fuses the first: fma(p, q, -(r*s)).
"""

from __future__ import annotations

import torch

from ..config import AosParams, Statics
from ..geom import atan2
from ..ops import cumsum_xla, fma, lanes, norm2, scatter_set, set_at, take, take_row, while_loop
from ..types import Path

SEG_CAP = 1024  # interpolated points cap per segment (51 m at 5 cm)
_FAR = 3.4e38


def _prefix(v):
    """[..., 0, v0, v0+v1, ...] in f32 over the last axis, in XLA:CPU's
    order for ``jnp.cumsum`` (``ops.cumsum_xla``), the same on every device
    and batch shape."""
    c = cumsum_xla(v)
    return torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=torch.float32, device=v.device), c],
                     dim=-1)


def _fit_tables(xy, count):
    """Prefix sums giving (slope, intercept, mse) of any [s, e] in O(1):
    [*B, 5, P + 1] rows sy, sx, sxy, sxx, syy, one scan for all five."""
    m = torch.arange(xy.shape[-2], device=xy.device) < count[..., None]
    x = torch.where(m, xy[..., 0], 0.0)
    y = torch.where(m, xy[..., 1], 0.0)
    return _prefix(torch.stack([y, x, x * y, x * x, y * y], dim=-2))


def _linreg(tab, s_, e_):
    """y = a x + b over inclusive [s, e] (cpp:50-96), for s_ and e_ of the
    table's batch axes B and more axes J. Returns (a, b, mse) [*B, *J]. The
    slope's numerator and denominator, n sxy - sx sy and n sxx - sx sx, are
    one ``fma`` over the table's rows (sxy, sxx) and (sy, sx)."""
    n = (e_ - s_ + 1).to(torch.float32)
    B = tab.shape[:-2]
    J = s_.shape[len(B):]
    k = len(B)

    def rows(i):
        return tab.gather(-1, i.long().reshape(B + (1, -1)).expand(B + (5, -1)))

    seg = (rows(e_ + 1) - rows(s_)).reshape(B + (5,) + J)
    sy, sx, sxy, sxx, syy = seg.unbind(k)
    num, den = fma(n.unsqueeze(k), seg.narrow(k, 2, 2),
                   -(sx.unsqueeze(k) * seg.narrow(k, 0, 2))).unbind(k)
    degenerate = torch.abs(den) < 1e-9
    nn = torch.clamp(n, min=1.0)
    a = torch.where(degenerate, 0.0,
                    num / torch.where(degenerate, torch.ones_like(den), den))
    b = torch.where(degenerate, sy / nn, fma(-a, sx, sy) / nn)
    # (syy - 2a sxy - 2b sy + a^2 sxx + 2ab sx + n b^2) / n, one FMA a term
    err = fma(-(2 * a), sxy, syy)
    err = fma(-(2 * b), sy, err)
    err = fma(a * a, sxx, err)
    err = fma(2 * a * b, sx, err)
    err = fma(n * b, b, err) / nn
    short = (e_ <= s_) | (e_ - s_ < 2)
    return (torch.where(short, 0.0, a), torch.where(short, 0.0, b),
            torch.where(short, 0.0, torch.clamp(err, min=0.0)))


def _fit_and_split(tab, s_, e_, P):
    """The line of [s, e] and findBestSplitPoint (cpp:99-125), the argmin
    over sp in (s, e) of the count-weighted mean of the MSEs of [s, sp] and
    [sp, e], per lane: one ``_linreg`` over the 1 + 2P ranges. Returns (a,
    b, split)."""
    sp = torch.arange(P, dtype=torch.int32, device=s_.device)
    lo, hi = s_[..., None], e_[..., None]
    shape = s_.shape + (P,)
    a, b, err = _linreg(tab, torch.cat([lo, lo.expand(shape), sp.expand(shape)], dim=-1),
                        torch.cat([hi, sp.expand(shape), hi.expand(shape)], dim=-1))
    err1, err2 = err[..., 1:P + 1], err[..., P + 1:]
    n1 = (sp - lo + 1).to(torch.float32)
    n2 = (hi - sp + 1).to(torch.float32)
    tot = fma(err1, n1, err2 * n2) / torch.clamp(n1 + n2, min=1.0)
    tot = torch.where((sp > lo) & (sp < hi), tot, _FAR)
    best = torch.argmin(tot, dim=-1).to(torch.int32)
    return a[..., 0], b[..., 0], torch.where(e_ <= s_ + 1, e_, best)


def _find_breakpoints(xy, count, max_segments, params, P):
    """splitPathRecursive (cpp:128-177) as an explicit DFS stack (left
    first), one stack per lane of count's batch axes. Returns bp_mask
    [*B, P]. A lane whose stack is empty changes nothing (its updates are
    masked with its own activity), however long the others run."""
    dev = xy.device
    B = count.shape
    tab = _fit_tables(xy, count)
    idxs = torch.arange(P, device=dev)
    STK = 2 * 16
    max_dev_ok = lanes(params.linearize_max_dev, count)

    def at(a, i):
        return a.gather(-1, i[..., None].long()).squeeze(-1)

    def body(st):
        bp_mask, stack_s, stack_e, sp_, nbp = st
        active = sp_ > 0
        top = torch.clamp(sp_ - 1, min=0)
        s_ = at(stack_s, top)
        e_ = at(stack_e, top)
        a, b, split = _fit_and_split(tab, s_, e_, P)
        interior = (idxs > s_[..., None]) & (idxs < e_[..., None]) & (idxs < count[..., None])
        dev_ = torch.abs(xy[..., 1] - fma(a[..., None], xy[..., 0], b[..., None]))
        max_dev = torch.where(interior, dev_, -1.0).max(dim=-1).values
        skip = (e_ <= s_) | (max_dev < max_dev_ok) | (nbp >= max_segments - 1)
        # an empty path's split is -1, which indexes the last point, as
        # a negative index does in both packages
        si = torch.where(split < 0, split + P, split)
        old = at(bp_mask, si)
        is_new = ~old & ~skip
        bp2 = bp_mask.scatter(-1, si[..., None].long(), (old | ~skip)[..., None])
        nbp2 = nbp + is_new.to(torch.int32)
        recurse = ~skip & (nbp2 < max_segments - 1)
        # push right then left (left popped first)
        t0 = top[..., None].long()
        t1 = t0 + 1
        ss2 = stack_s.scatter(-1, t0, split[..., None]).scatter(-1, t1, s_[..., None])
        se2 = stack_e.scatter(-1, t0, e_[..., None]).scatter(-1, t1, split[..., None])
        r2 = recurse[..., None]
        ss2 = torch.where(r2, ss2, stack_s)
        se2 = torch.where(r2, se2, stack_e)
        sp2 = torch.where(recurse, top + 2, top)
        a2 = active[..., None]
        return (torch.where(a2, bp2, bp_mask), torch.where(a2, ss2, stack_s),
                torch.where(a2, se2, stack_e), torch.where(active, sp2, sp_),
                torch.where(active, nbp2, nbp))

    ss = torch.zeros(B + (STK,), dtype=torch.int32, device=dev)
    se = torch.zeros(B + (STK,), dtype=torch.int32, device=dev)
    se[..., 0] = count - 1
    state = (torch.zeros(B + (P,), dtype=torch.bool, device=dev), ss, se,
             torch.ones(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    bp_mask, _, _, _, _ = while_loop(lambda st: st[3] > 0, body, state, "linearize")
    return bp_mask


def _dot_rows(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def _backtrack_keep(oxy, oseg, ocount, NSEG: int):
    """Keep-mask of the sequential backtracking removal, computed per
    segment (see aosx.plan.linearize for the equivalence argument), per
    lane of ocount's batch axes. Carry: the last two kept points and the
    kept count."""
    dev = oxy.device
    B = ocount.shape
    Q = oxy.shape[-2]
    idxq = torch.arange(Q, device=dev)
    live = idxq < ocount[..., None]
    prev2 = torch.zeros(B + (2,), dtype=torch.float32, device=dev)
    prev1 = torch.zeros(B + (2,), dtype=torch.float32, device=dev)
    nkept = torch.zeros(B, dtype=torch.int32, device=dev)
    keep = torch.zeros(B + (Q,), dtype=torch.bool, device=dev)
    for j in range(NSEG):
        in_seg = (oseg == j) & live
        vals0 = _dot_rows(oxy - prev1.unsqueeze(-2), (prev1 - prev2).unsqueeze(-2))
        c1 = in_seg & ((nkept <= 1)[..., None] | (vals0 >= -0.01))
        any1 = c1.any(dim=-1)
        k1 = c1.to(torch.uint8).argmax(dim=-1)
        p_k1 = take_row(oxy, k1)
        prev2_a = torch.where((nkept >= 1)[..., None], prev1, prev2)
        vals1 = _dot_rows(oxy - p_k1.unsqueeze(-2), (p_k1 - prev2_a).unsqueeze(-2))
        c2 = in_seg & (idxq > k1[..., None]) & ((nkept + 1 <= 1)[..., None] | (vals1 >= -0.01))
        any2 = c2.any(dim=-1)
        k2 = c2.to(torch.uint8).argmax(dim=-1)
        keep_seg = in_seg & any1[..., None] & ((idxq == k1[..., None])
                                               | (any2[..., None] & (idxq >= k2[..., None])))
        cnt = keep_seg.sum(dim=-1, dtype=torch.int32)
        last = torch.where(keep_seg, idxq, -1).max(dim=-1).values
        second = torch.where(keep_seg & (idxq < last[..., None]), idxq, -1).max(dim=-1).values
        p_last = take_row(oxy, torch.clamp(last, min=0))
        p_second = take_row(oxy, torch.clamp(second, min=0))
        new_prev1 = torch.where((cnt >= 1)[..., None], p_last, prev1)
        new_prev2 = torch.where((cnt >= 2)[..., None], p_second,
                                torch.where(((cnt == 1) & (nkept >= 1))[..., None], prev1, prev2))
        prev2, prev1, nkept = new_prev2, new_prev1, nkept + cnt
        keep = keep | keep_seg
    return keep


def breakpoint_mask(path: Path, params: AosParams, s: Statics):
    """[*B, max_path] bool: the points where the linearized path's segments
    start and end (0 and count - 1 included); every point of a path of at
    most 4, else the regression split's (max 10 segments when the goal is
    the origin, else 4)."""
    P = s.max_path
    xy, count = path.xy, path.count
    c1 = count[..., None]
    end_pt = take_row(xy, torch.clamp(count - 1, min=0))
    is_long = (torch.abs(end_pt[..., 0]) < 1e-6) & (torch.abs(end_pt[..., 1]) < 1e-6)
    max_segments = torch.where(is_long, s.max_segments, 4).to(torch.int32)

    bp_mask = _find_breakpoints(xy, count, max_segments, params, P)
    idxs = torch.arange(P, device=xy.device)
    interior_all = (idxs > 0) & (idxs < c1 - 1)
    bp_mask = torch.where(c1 <= 4, interior_all, bp_mask)
    bp_mask = bp_mask & (idxs > 0) & (idxs < c1 - 1)
    bp_mask = torch.where(idxs == 0, c1 > 0, bp_mask)
    bp_mask = bp_mask | (idxs == c1 - 1)
    return bp_mask & (idxs < c1)


def linearize(path: Path, params: AosParams, s: Statics) -> Path:
    """convertToLinearSegments (cpp:248-370). Input path of n points:
    n <= 1: passthrough; n == 2: one interpolated segment; 3 <= n <= 4:
    consecutive-point interpolation; else regression split.

    Batch axes, as ``jax.vmap`` maps them: path.xy [*B, max_path, 2],
    path.count [*B]; params 0-d or with leading axes B. Each lane is the
    single path's result bit for bit (one call for every row of a plan
    cache)."""
    dev = path.xy.device
    P = s.max_path
    Q = s.max_plan
    xy, count = path.xy, path.count
    nb = count.dim()
    B = count.shape
    end_pt = take_row(xy, torch.clamp(count - 1, min=0))
    start_pt = xy[..., 0, :]
    bp_mask = breakpoint_mask(path, params, s)
    idxs = torch.arange(P, device=dev)

    NSEG = max(s.max_segments, 4) + 1
    MAXBP = NSEG + 1
    rank = torch.cumsum(bp_mask.to(torch.int32), -1, dtype=torch.int32) - 1
    tgt = torch.where(bp_mask & (rank < MAXBP), rank, MAXBP)
    bps = scatter_set(MAXBP, -1, tgt, idxs.to(torch.int32).expand(B + (P,)))
    nbp = torch.clamp(bp_mask.sum(dim=-1, dtype=torch.int32), max=MAXBP)

    # ---- interpolate segments at 5 cm (cpp:190-245) -----------------------
    seg_i = torch.arange(NSEG, device=dev)
    s_idx = bps[..., torch.clamp(seg_i, 0, MAXBP - 1)]
    e_idx = bps[..., torch.clamp(seg_i + 1, 0, MAXBP - 1)]
    seg_ok = (seg_i < nbp[..., None] - 1) & (s_idx >= 0) & (e_idx >= 0)
    p1 = take(xy, torch.clamp(s_idx, min=0), nb)
    p2 = take(xy, torch.clamp(e_idx, min=0), nb)
    d = p2 - p1
    dist = norm2(d)
    yaw = atan2(d[..., 1], d[..., 0])
    degen = dist < 1e-6
    spacing = lanes(params.linearize_spacing, dist)
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
    off = torch.cumsum(cnt, -1) - cnt
    total = cnt.sum(dim=-1)

    qidx = torch.arange(Q, device=dev)
    onehot = ((qidx[:, None] >= off.unsqueeze(-2))
              & (qidx[:, None] < (off + cnt).unsqueeze(-2)))     # [*B, Q, NSEG]
    valid_q = onehot.any(dim=-1)

    def pick(v):
        """[*B, NSEG] -> [*B, Q]; exactly one (or zero) nonzero term per slot."""
        return torch.where(onehot, v.unsqueeze(-2), torch.zeros_like(v).unsqueeze(-2)).sum(dim=-1)

    kq_i = qidx - pick(off) + pick(k0)
    t_q = kq_i.to(torch.float32) * lanes(params.linearize_spacing, kq_i) \
        / torch.clamp(pick(dist), min=1e-9)
    is_end_q = valid_q & (kq_i == pick(n_mid) + 1)
    px_q = torch.where(is_end_q, pick(p2[..., 0]), fma(t_q, pick(d[..., 0]), pick(p1[..., 0])))
    py_q = torch.where(is_end_q, pick(p2[..., 1]), fma(t_q, pick(d[..., 1]), pick(p1[..., 1])))
    oxy = torch.where(valid_q[..., None], torch.stack([px_q, py_q], dim=-1), 0.0)
    oyaw = torch.where(valid_q, pick(yaw), 0.0)
    oseg = torch.where(valid_q, pick(seg_i.expand(B + (NSEG,))), NSEG)
    ocount = torch.clamp(total, max=Q)

    # exact endpoints (cpp:329-333)
    has_pts = (ocount > 0)[..., None]
    oxy = set_at(oxy, torch.zeros_like(ocount), torch.where(has_pts, start_pt, oxy[..., 0, :]), nb)
    last_i = torch.clamp(ocount - 1, min=0)
    oxy = set_at(oxy, last_i, torch.where(has_pts, end_pt, take_row(oxy, last_i)), nb)

    # ---- backtracking removal (cpp:336-369) -------------------------------
    keep = _backtrack_keep(oxy, oseg, ocount, NSEG)
    keep = torch.where((ocount <= 2)[..., None], qidx < ocount[..., None], keep)
    rank3 = torch.cumsum(keep.to(torch.int32), -1, dtype=torch.int32) - 1
    tgt3 = torch.where(keep & (rank3 < Q), rank3, Q)
    fxy = scatter_set(Q, 0.0, tgt3, oxy)
    fyaw = scatter_set(Q, 0.0, tgt3, oyaw)
    fcount = torch.clamp(keep.sum(dim=-1, dtype=torch.int32), max=Q)
    fi = torch.clamp(fcount - 1, min=0)
    fxy = set_at(fxy, fi, torch.where((fcount > 0)[..., None], end_pt, take_row(fxy, fi)), nb)

    # passthrough for 0/1-point paths
    tiny = count <= 1
    tiny_xy = set_at(torch.zeros_like(fxy), torch.zeros_like(count), start_pt, nb)
    return Path(xy=torch.where(tiny[..., None, None], tiny_xy, fxy),
                yaw=torch.where(tiny[..., None], torch.zeros_like(fyaw), fyaw),
                count=torch.where(tiny, count, fcount).to(torch.int32))
