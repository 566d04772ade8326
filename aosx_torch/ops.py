"""Shared tensor ops (mirror of ``aosx/ops.py``).

compact_true: order-preserving compaction of a boolean mask into the flat
indices of its first K true elements. ``aosx`` takes ``lax.top_k`` of the
negated priorities; here a stable ascending sort of the same priorities
takes its place (``torch.topk`` leaves the order of ties unspecified).
"""

from __future__ import annotations

import torch


def _first_k(prio, k: int):
    """The k smallest priorities, ascending."""
    return torch.sort(prio, stable=True).values[:k]


def compact_true(mask_flat, k: int):
    """First-K true positions of mask_flat in index order.

    Returns (indices [min(k, n)] i32, -1 padded; count i32)."""
    n = mask_flat.shape[0]
    k = min(k, n)
    ar = torch.arange(n, dtype=torch.int32, device=mask_flat.device)
    prio = torch.where(mask_flat, ar, torch.full_like(ar, n))
    sel = _first_k(prio, k)
    ok = sel < n
    count = ok.to(torch.int32).sum(dtype=torch.int32)
    return torch.where(ok, sel, torch.full_like(sel, -1)), count


def compact_true_hier(mask_flat, k: int, kw: int, win: int = 32,
                      exact_fallback: bool = True, with_overflow: bool = False):
    """First-K-true positions through a window-level compaction (see
    ``aosx.ops.compact_true_hier``). With ``exact_fallback`` the result is
    the direct first-K compaction, which is what the hierarchical pass
    yields whenever at most ``kw`` windows hold a true element and what
    ``aosx`` falls back to otherwise. Without it, trailing cells beyond the
    first ``kw`` true windows are dropped (flagged by ``with_overflow``).

    Returns (indices [k] i32, -1 padded; count i32 = min(true count, k))."""
    dev = mask_flat.device
    n = mask_flat.shape[0]
    if n % win != 0:
        pad = win - n % win
        mask_flat = torch.cat([mask_flat, torch.zeros(pad, dtype=torch.bool, device=dev)])
        n = n + pad
    nw = n // win
    kw = min(kw, nw)
    m2 = mask_flat.reshape(nw, win)
    wany = m2.any(dim=1)
    nw_true = wany.to(torch.int32).sum(dtype=torch.int32)
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)

    if exact_fallback:
        ar = torch.arange(n, dtype=torch.int32, device=dev)
        sel = _first_k(torch.where(mask_flat, ar, sentinel), min(k, n))
        if n < k:
            sel = torch.cat([sel, torch.full((k - n,), n, dtype=torch.int32, device=dev)])
    else:
        wsel, _ = compact_true(wany, kw)
        wsafe = torch.clamp(wsel, min=0).long()
        cand = m2[wsafe] & (wsel >= 0)[:, None]
        orig = (wsafe.to(torch.int32)[:, None] * win
                + torch.arange(win, dtype=torch.int32, device=dev)[None, :])
        prio = torch.where(cand, orig, sentinel).reshape(-1)
        kk = min(k, kw * win)
        sel = _first_k(prio, kk)
        if kk < k:
            sel = torch.cat([sel, torch.full((k - kk,), n, dtype=torch.int32, device=dev)])
    ok = sel < n
    count = ok.to(torch.int32).sum(dtype=torch.int32)
    out = torch.where(ok, sel, torch.full_like(sel, -1))
    if with_overflow:
        return out, count, nw_true > kw
    return out, count


# body iterations between host reads of a data-dependent loop condition
CHECK_EVERY = 4


def while_loop(cond, body, state, check_every: int = CHECK_EVERY):
    """``lax.while_loop`` as a Python loop that reads ``cond`` on the host
    only every ``check_every`` iterations. Sound only for bodies that leave
    the state unchanged once ``cond`` is false; the bodies in this package
    either are such no-ops by construction or mask their updates with
    ``cond`` (see each caller)."""
    while bool(cond(state)):
        for _ in range(check_every):
            state = body(state)
    return state


def segment_sum(vals, segs, num: int):
    """Sum of vals per segment id in [0, num), adding in index order."""
    out = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, segs.long(), vals)


def segment_max(vals, segs, num: int):
    """Max per segment; -inf (or the dtype's min) for empty segments."""
    init = -float("inf") if vals.dtype.is_floating_point else torch.iinfo(vals.dtype).min
    out = torch.full((num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, segs.long(), vals, reduce="amax", include_self=True)


def segment_min(vals, segs, num: int):
    """Min per segment; +inf (or the dtype's max) for empty segments."""
    init = float("inf") if vals.dtype.is_floating_point else torch.iinfo(vals.dtype).max
    out = torch.full((num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, segs.long(), vals, reduce="amin", include_self=True)


def scatter_set(size: int, fill, idx, vals):
    """``full(size, fill).at[idx].set(vals, mode="drop")`` for idx in
    [0, size]; index ``size`` is the drop slot. Callers only drop or write
    distinct indices, so no write races."""
    out = torch.full((size + 1,) + vals.shape[1:], fill, dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out[:size]


def lanes(cond, like):
    """cond with trailing singleton axes appended until it broadcasts against
    ``like`` from the left: cond's axes are ``like``'s leading (lane) axes."""
    return cond.reshape(cond.shape + (1,) * (like.dim() - cond.dim()))


def _row_index(arr, i):
    n = i.dim()
    return i.reshape(i.shape + (1,) * (arr.dim() - n)).expand(i.shape + (1,) + arr.shape[n + 1:])


def take_row(arr, i):
    """Row ``i`` of ``arr``. With a 0-d ``i`` this is ``arr[i]``; with lane
    axes, ``i`` of shape B and ``arr`` of shape B + (R, ...), it is
    ``arr[b, i[b]]`` for every lane b, as a gather (every bit kept)."""
    i = torch.as_tensor(i, device=arr.device).long()
    if i.dim() == 0:
        return arr[i]
    return torch.gather(arr, i.dim(), _row_index(arr, i)).squeeze(i.dim())


def put_row(arr, i, value):
    """A copy of ``arr`` with row ``i`` set to the scalar ``value``
    (``take_row``'s indexing)."""
    i = torch.as_tensor(i, device=arr.device).long()
    if i.dim() == 0:
        out = arr.clone()
        out[i] = value
        return out
    return arr.scatter(i.dim(), _row_index(arr, i), value)


def compact_take(vals, indices, fill):
    """Gather vals at compacted indices (-1 padded) with a fill value."""
    safe = torch.clamp(indices, min=0).long()
    out = vals[safe]
    mask = indices >= 0
    if out.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim()))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype, device=out.device))


def fma(a, b, c):
    """f32 a * b + c rounded once, as a fused multiply-add. XLA:CPU
    contracts many of aosx's a*b + c expressions this way; the port uses it
    where the results must agree, and CUDA's __fmaf_rn gives the same bits.

    The f64 product of two f32 values is exact. The f64 sum is made
    round-to-odd (TwoSum gives its rounding error e; when e != 0 the sum is
    truncated toward zero and its last bit set), and rounding a 53-bit
    round-to-odd value to 24 bits equals rounding the exact value once
    (Boldo and Melquiond), where plain f64 rounding could round twice."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    inexact = (e != 0) & torch.isfinite(s)
    t = torch.where(inexact & ((e < 0) != (s < 0)), torch.nextafter(s, torch.zeros_like(s)), s)
    return torch.where(inexact, (t.view(torch.int64) | 1).view(torch.float64), s).float()
