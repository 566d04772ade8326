"""Shared tensor ops (mirror of ``aosx/ops.py``).

compact_true: order-preserving compaction of a boolean mask into the flat
indices of its first K true elements. ``aosx`` takes ``lax.top_k`` of the
negated priorities; here a stable ascending sort of the same priorities
takes its place (``torch.topk`` leaves the order of ties unspecified).

Batch axes: the compactions, the segment reductions, ``compact_take`` and
``scatter_set`` work along the LAST axis of their mask, ids or indices;
leading axes are lanes (the worlds of a group, the axes ``aosx`` maps with
``jax.vmap``), each handled on its own and bit for bit as alone.
"""

from __future__ import annotations

import functools
import math

import torch

from . import profiling


def _first_k(prio, k: int):
    """The k smallest priorities along the last axis, ascending."""
    return torch.sort(prio, dim=-1, stable=True).values[..., :k]


def compact_true(mask_flat, k: int):
    """First-K true positions of mask_flat [*B, n] in index order, per lane.

    Returns (indices [*B, min(k, n)] i32, -1 padded; count [*B] i32)."""
    n = mask_flat.shape[-1]
    k = min(k, n)
    ar = torch.arange(n, dtype=torch.int32, device=mask_flat.device)
    prio = torch.where(mask_flat, ar, torch.full_like(ar, n))
    sel = _first_k(prio, k)
    ok = sel < n
    count = ok.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return torch.where(ok, sel, torch.full_like(sel, -1)), count


def compact_true_hier(mask_flat, k: int, kw: int, win: int = 32,
                      exact_fallback: bool = True, with_overflow: bool = False):
    """First-K-true positions through a window-level compaction (see
    ``aosx.ops.compact_true_hier``). With ``exact_fallback`` the result is
    the direct first-K compaction, which is what the hierarchical pass
    yields whenever at most ``kw`` windows hold a true element and what
    ``aosx`` falls back to otherwise. Without it, trailing cells beyond the
    first ``kw`` true windows are dropped (flagged by ``with_overflow``).
    mask_flat [*B, n]; every lane is compacted on its own.

    Returns (indices [*B, k] i32, -1 padded; count [*B] i32 = min(true
    count, k))."""
    dev = mask_flat.device
    B = mask_flat.shape[:-1]
    n = mask_flat.shape[-1]
    if n % win != 0:
        pad = win - n % win
        mask_flat = torch.cat([mask_flat, torch.zeros(B + (pad,), dtype=torch.bool, device=dev)],
                              dim=-1)
        n = n + pad
    nw = n // win
    kw = min(kw, nw)
    m2 = mask_flat.reshape(B + (nw, win))
    wany = m2.any(dim=-1)
    nw_true = wany.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)

    if exact_fallback:
        ar = torch.arange(n, dtype=torch.int32, device=dev)
        sel = _first_k(torch.where(mask_flat, ar, sentinel), min(k, n))
        if n < k:
            sel = torch.cat([sel, torch.full(B + (k - n,), n, dtype=torch.int32, device=dev)],
                            dim=-1)
    else:
        wsel, _ = compact_true(wany, kw)
        wsafe = torch.clamp(wsel, min=0).long()
        cand = take(m2, wsafe, len(B)) & (wsel >= 0)[..., None]
        orig = (wsafe.to(torch.int32)[..., None] * win
                + torch.arange(win, dtype=torch.int32, device=dev))
        prio = torch.where(cand, orig, sentinel).reshape(B + (-1,))
        kk = min(k, kw * win)
        sel = _first_k(prio, kk)
        if kk < k:
            sel = torch.cat([sel, torch.full(B + (k - kk,), n, dtype=torch.int32, device=dev)],
                            dim=-1)
    ok = sel < n
    count = ok.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    out = torch.where(ok, sel, torch.full_like(sel, -1))
    if with_overflow:
        return out, count, nw_true > kw
    return out, count


# body iterations between host reads of a data-dependent loop condition
CHECK_EVERY = 4


def while_loop(cond, body, state, site: str, check_every: int = CHECK_EVERY):
    """``lax.while_loop`` as a Python loop that reads ``cond`` on the host
    only every ``check_every`` iterations. ``site`` names the caller in the
    counters (``profiling``): ``host_read.<site>`` each condition read
    (``read_any``), ``loop_iters.<site>`` the bodies run and
    ``loop_calls.<site>`` the calls, so that the reads are
    ``loop_iters / check_every + loop_calls``.

    ``cond`` may return a tensor of lanes (the batch axes of a vmapped
    loop): the loop runs while ANY lane is active, every lane in lockstep,
    as ``jax.vmap`` of a ``while_loop`` runs it. Sound only for bodies that
    leave each lane's state unchanged once that lane's ``cond`` is false,
    so that neither the extra iterations between host checks nor the
    iterations a lane spends waiting for the slowest lane change it. The
    callers and how each keeps that:

    - masked with the lane's own condition: ``plan.astar.astar`` (and the
      DFS of ``plan.plancache.tour_feasibility``), the union-finds
      ``perceive.rows.union_find_labels`` and ``run_level_labels``;
    - no-ops by construction once a lane is done (nothing undecided, every
      ray resolved or fired): ``perceive.seeds.greedy_dedupe``,
      ``raycast_bounded`` and ``cast_rays_unbounded``, ``gvd.graph.merge_seeds``.

    Each returns one condition per world of a group (the world axis of
    ``engine.prepare_world``) or per lane of a batch."""
    trips = 0
    while read_any(cond(state), site):
        for _ in range(check_every):
            state = body(state)
        trips += check_every
    profiling.count("loop_iters." + site, trips)
    profiling.count("loop_calls." + site)
    return state


def read_any(x, site: str) -> bool:
    """``bool(x.any())``: the host waits for the device to read it, counted
    as ``host_read.<site>`` (``profiling``)."""
    profiling.count("host_read." + site)
    return bool(x.any())


def segment_sum(vals, segs, num: int):
    """Sum of vals [*B, n, *T] per segment id of segs [*B, n] in [0, num),
    adding in index order; each lane of B has segments of its own.
    Returns [*B, num, *T]."""
    B = segs.shape[:-1]
    T = vals.shape[segs.dim():]
    G = math.prod(B)
    off = torch.arange(G, device=segs.device).reshape(B + (1,)) * num
    out = torch.zeros((G * num,) + T, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (segs.long() + off).reshape(-1), vals.reshape((-1,) + T))
    return out.reshape(B + (num,) + T)


def segment_max(vals, segs, num: int):
    """Max per segment along the last axis of segs, per lane; -inf (or the
    dtype's min) for empty segments."""
    init = -float("inf") if vals.dtype.is_floating_point else torch.iinfo(vals.dtype).min
    out = torch.full(segs.shape[:-1] + (num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, segs.long(), vals, reduce="amax", include_self=True)


def segment_min(vals, segs, num: int):
    """Min per segment along the last axis of segs, per lane; +inf (or the
    dtype's max) for empty segments."""
    init = float("inf") if vals.dtype.is_floating_point else torch.iinfo(vals.dtype).max
    out = torch.full(segs.shape[:-1] + (num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, segs.long(), vals, reduce="amin", include_self=True)


def scatter_set(size: int, fill, idx, vals):
    """``full(size, fill).at[idx].set(vals, mode="drop")`` along the last
    axis of idx, for idx in [0, size]; index ``size`` is the drop slot.
    idx [*B, n] and vals [*B, n, *T] give [*B, size, *T]: leading axes are
    lanes, each scattered on its own. Callers only drop or write distinct
    indices within a lane, so no write races."""
    nb = idx.dim() - 1
    T = vals.shape[nb + 1:]
    out = torch.full(idx.shape[:-1] + (size + 1,) + T, fill, dtype=vals.dtype,
                     device=vals.device)
    ix = idx.long().reshape(idx.shape + (1,) * len(T)).expand(vals.shape)
    return out.scatter_(nb, ix, vals).narrow(nb, 0, size)


def lanes(cond, like):
    """cond with trailing singleton axes appended until it broadcasts against
    ``like`` from the left: cond's axes are ``like``'s leading (lane) axes.
    A Python scalar (a parameter) is returned as it is."""
    if not torch.is_tensor(cond):
        return cond
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
        # indexing by a 0-d tensor reads it on the host
        profiling.count("host_read.take_row")
        return arr[i]
    return torch.gather(arr, i.dim(), _row_index(arr, i)).squeeze(i.dim())


def take(arr, idx, nb: int):
    """``arr[b, idx[b, ...]]`` for every lane b of ``nb`` leading batch
    axes: arr is [*Ba, N, *T] and idx [*Bi, *J] with Ba and Bi of length nb
    and broadcastable (a world of batch axis 1 serves every row of a lane);
    the result is [*broadcast(Ba, Bi), *J, *T]. A gather by advanced
    indexing: no copy of a broadcast arr, every bit kept. nb = 0 is
    ``arr[idx]``."""
    idx = idx.long()
    J = idx.dim() - nb
    ix = []
    for d in range(nb):
        n = arr.shape[d]
        shape = [1] * (nb + J)
        shape[d] = n
        ix.append(torch.arange(n, device=arr.device).reshape(shape))
    return arr[tuple(ix) + (idx,)]


def set_at(arr, i, value, nb: int):
    """A copy of arr [*B, N, *T] with entry ``i[b]`` of every lane b
    (i [*B]) set to value (broadcastable to [*B, *T]): a select against
    the one-hot of i, so no two lanes ever write one cell."""
    T = arr.dim() - nb - 1
    hot = torch.arange(arr.shape[nb], device=arr.device) == i.unsqueeze(-1)
    if torch.is_tensor(value):
        value = value.to(arr.device, arr.dtype)
        if value.dim() > 0:
            value = value.unsqueeze(-T - 1)
    else:
        # filled on the device: no copy from the host (a CUDA graph
        # captures it)
        value = torch.full((), value, dtype=arr.dtype, device=arr.device)
    return torch.where(hot.reshape(hot.shape + (1,) * T), value, arr)


def _sum_sequential(x):
    """0 + x[..., 0] + x[..., 1] + ... over the last axis, one add at a time."""
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


# XLA:CPU's reduction rewrite: a reduced axis longer than this is summed in
# windows of this many elements, recursively
XLA_REDUCE_WINDOW = 32


def sum_xla(x):
    """Sum over the last axis as XLA:CPU sums an f32 ``jnp.sum``, bit for
    bit: while the axis is longer than 32 it is padded with zeros to whole
    windows of 32 (half of the padding in front, the larger half behind)
    and each window is summed sequentially from 0; the last <= 32 partial
    sums are then added sequentially from 0. The same order for any leading
    shape and device, and for the axis reduced alone, along axis 0 or under
    ``jax.vmap`` (tests/test_torch_xla_f32.py); it does not depend on the
    host's vector ISA (the same bits under ``--xla_cpu_max_isa=SSE4_2``,
    ``AVX2`` and AVX-512)."""
    w = XLA_REDUCE_WINDOW
    while x.shape[-1] > w:
        n = x.shape[-1]
        nb = -(-n // w)
        pad = nb * w - n
        lead = x.shape[:-1]
        x = torch.cat([x.new_zeros(lead + (pad // 2,)), x, x.new_zeros(lead + (pad - pad // 2,))],
                      dim=-1)
        x = _sum_sequential(x.reshape(lead + (nb, w)))
    return _sum_sequential(x)


# XLA:CPU's rewrite of a cumulative sum: blocks of this many elements
XLA_SCAN_BLOCK = 16


def cumsum_xla(x):
    """Inclusive prefix sums over the last axis as XLA:CPU evaluates an f32
    ``jnp.cumsum``, bit for bit: the axis padded with zeros behind to whole
    blocks of 16, a sequential scan inside each block (from 0), the block
    totals scanned the same way (recursively), and each block's exclusive
    prefix added to its entries. The same order for any leading shape and
    device (torch.cumsum on the card orders by shape); the same bits as
    ``jnp.cumsum`` along any axis and under ``jax.vmap``
    (tests/test_torch_xla_f32.py)."""
    b = XLA_SCAN_BLOCK
    n = x.shape[-1]
    lead = x.shape[:-1]
    nb = max(-(-n // b), 1)
    blocks = torch.cat([x, x.new_zeros(lead + (nb * b - n,))], dim=-1).reshape(lead + (nb, b))
    cols = [blocks[..., 0] + 0.0]
    for j in range(1, b):
        cols.append(cols[-1] + blocks[..., j])
    y = torch.stack(cols, dim=-1)
    if nb > 1:
        inc = cumsum_xla(y[..., -1])
        y = y + torch.cat([inc.new_zeros(lead + (1,)), inc[..., :-1]], dim=-1)[..., None]
    return y.reshape(lead + (nb * b,))[..., :n]


# > 0 while ``capture_graph`` runs its function: ``card_graph`` then runs
# its own as it is, so that its kernels join the graph being made
_capture_depth = 0


def capture_graph(fn, dev):
    """A CUDA graph of ``fn()`` on the card ``dev``: fn runs once on a side
    stream (what it makes at its first call, such as constant tables, is
    made then), then once more under capture. While fn runs, a
    ``card_graph`` function it calls runs as it is, so that its kernels
    join this graph. Counted as ``graph.capture`` (``profiling``). Returns
    (the graph, what the captured call returned); ``graph.replay()`` reruns
    its kernels on the current stream, reading and writing the tensors fn
    read and wrote under capture."""
    global _capture_depth
    _capture_depth += 1
    try:
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
    finally:
        _capture_depth -= 1
    profiling.count("graph.capture")
    return graph, out


def copy_leaves(dst, src):
    """``d.copy_(s)`` for each pair of the tensor lists dst and src: one
    multi-tensor copy a dtype where the two agree in dtype, shape and
    strides, one copy a pair elsewhere."""
    groups = {}
    for d, s in zip(dst, src, strict=True):
        if not d.numel():
            continue
        if d.dtype == s.dtype and d.shape == s.shape and d.stride() == s.stride():
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
        else:
            d.copy_(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def card_graph(fn):
    """``fn`` of tensors replayed on the card from a CUDA graph, captured at
    its first call for each device, shape and dtype of its arguments: the
    same kernels, so the same bits, in one launch, where a chain of dozens
    of small launches would cost the host far more than the card spends on
    them. The arguments are copied into the graph's inputs and its outputs
    cloned. fn must read nothing from the host once it has run once (its
    constant tables are made then). Arguments on the CPU, or on more than
    one device, run fn as it is; so does a call made while a graph is
    being captured (``capture_graph``, or any capture on the current
    stream), whose graph then holds fn's kernels. Captures and replays are
    counted (``graph.capture``, ``graph.replay``; ``profiling``)."""
    graphs = {}

    @functools.wraps(fn)
    def run(*args):
        dev = args[0].device
        if (dev.type != "cuda" or any(a.device != dev for a in args) or _capture_depth
                or torch.cuda.is_current_stream_capturing()):
            return fn(*args)
        key = tuple((a.shape, a.dtype) for a in args) + (dev,)
        entry = graphs.get(key)
        if entry is None:
            static = [a.clone() for a in args]
            graph, out = capture_graph(lambda: fn(*static), dev)
            entry = graphs[key] = (graph, static, out)
        graph, static, out = entry
        copy_leaves(static, args)
        graph.replay()
        profiling.count("graph.replay")
        return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()

    return run


def compact_take(vals, indices, fill):
    """Gather vals [*B, n, *T] at compacted indices [*B, k] (-1 padded) with
    a fill value."""
    safe = torch.clamp(indices, min=0).long()
    out = take(vals, safe, indices.dim() - 1)
    mask = indices >= 0
    if out.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim()))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype, device=out.device))


def gather_last(arr, idx):
    """``arr[..., idx]`` per lane: arr [*B, n] and idx [*B, *J] (the same
    leading axes) give [*B, *J]; ``take`` over all but arr's last axis."""
    return take(arr, idx, arr.dim() - 1)


def chunk_rows(rows: int, lanes_: int, floor: int = 64) -> int:
    """Rows of a row-chunked pass evaluated at once when ``lanes_`` lanes run
    together: about ``rows`` rows' worth of temporaries in all, and at least
    ``floor`` rows a lane. The counts and maxima such passes make do not
    depend on the chunking."""
    return max(min(rows, floor), rows // max(lanes_, 1))


def _round_odd_f32(p, c):
    """The exact sum of p (f64, an exact product of two f32 values) and c
    (f32) rounded once to f32. The f64 sum s is made round-to-odd: TwoSum
    gives its rounding error e, and where e != 0 s steps one ulp toward
    zero if the exact sum lies there and its last bit is set. Rounding a
    53-bit round-to-odd value to 24 bits equals rounding the exact value
    once (Boldo and Melquiond), where plain f64 rounding could round twice.
    An infinite or NaN s has a NaN e and is kept."""
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    inexact = e.abs() > 0
    # e and s of opposite signs (their product neither underflows nor
    # overflows for sums of f32 products and f32 values)
    toward_zero = (e * s < 0).long()
    return ((s.view(torch.int64) - toward_zero) | inexact).view(torch.float64).float()


def fma(a, b, c):
    """f32 a * b + c rounded once, as a fused multiply-add. XLA:CPU
    contracts many of aosx's a*b + c expressions this way; the port uses it
    where the results must agree, and CUDA's __fmaf_rn gives the same bits:
    the f64 product of two f32 values is exact, and the sum is rounded once
    (``_round_odd_f32``). For CPU tensors of one shape the f64 sum rounds
    straight to f32 wherever it is not an f32 rounding midpoint (an f64
    value strictly between the exact sum and a midpoint would be nearer to
    it) and lies in f32's normal range, so only the midpoints and the tiny
    sums take ``_round_odd_f32``; other tensors take it whole (no host
    read)."""
    p = a.double() * b
    if not (p.device.type == "cpu" and isinstance(c, torch.Tensor) and p.shape == c.shape):
        return _round_odd_f32(p, c)
    s = p + c
    out = s.float()
    redo = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0 ** -125)
    idx = redo.reshape(-1).nonzero().squeeze(1)
    if idx.numel():
        out.view(-1)[idx] = _round_odd_f32(p.reshape(-1)[idx], c.reshape(-1)[idx])
    return out


def norm2(v):
    """|v| of 2-vectors v [..., 2] as XLA:CPU evaluates the reference's
    ``jnp.sqrt(jnp.sum(v ** 2, axis=-1))``: its two-term reduction, fused
    with the squares, adds v1^2 to v0^2 in one multiply-add,
    sqrt(fma(v1, v1, v0 * v0)), correctly rounded."""
    v1 = v[..., 1].double()
    return sqrt(_round_odd_f32(v1 * v1, v[..., 0] * v[..., 0]))


def vector_lanes(lanes: int, site: str = "") -> int:
    """How many leading lanes of a per-lane 2-vector norm XLA:CPU computes
    in LLVM's vectorized loop, in a program that ``jax.vmap`` maps over
    ``lanes`` lanes (the Monte-Carlo harness's chunk). There the squares
    reach their sum through a shuffle and are not fused,
    sqrt(v0 * v0 + v1 * v1); the loop's scalar remainder fuses them as
    ``norm2`` does. Read from the chunk's LLVM IR (jax 0.9.0, AVX-512 host,
    256-bit vectors) at 1-18, 20, 24, 28, 32, 36, 44, 64, 66, 100, 128 and
    256 lanes: below 16 lanes (a trip count LLVM calls tiny) only 4 and 8
    are vectorized, whole; from 16 on, 8 lanes a vector iteration and a
    scalar remainder, except at 20 lanes and, for every site but the
    travel segment ("travel"), at 28, where 4 lanes a vector iteration
    leave no remainder."""
    if lanes in (4, 8):
        return lanes
    if lanes < 16:
        return 0
    if lanes == 20 or (lanes == 28 and site != "travel"):
        return lanes
    return lanes - lanes % 8


def norm2_lanes(v, vector: int):
    """|v| of per-lane 2-vectors v [L, 2] as a vmapped XLA:CPU program
    evaluates the reference's ``jnp.sqrt(jnp.sum(v ** 2))``: lanes
    [0, vector) unfused (its vectorized loop), the rest as ``norm2``
    (``vector_lanes``)."""
    unfused = sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    if vector >= v.shape[0]:
        return unfused
    lane = torch.arange(v.shape[0], device=v.device)
    return torch.where(lane < vector, unfused, norm2(v))


def div_const(x, c: float):
    """f32 x / c for a constant c as XLA compiles aosx's division by a
    static constant under jit: its algebraic simplifier makes it a product
    with the f32 reciprocal of f32(c) (20 for a resolution of 0.05 m), which
    now and then differs from the quotient in the last place, so that a
    truncating cast puts a point on a cell edge into the next cell."""
    return x * (1.0 / torch.tensor(c, dtype=torch.float32)).item()


def sqrt(x):
    """Square root, correctly rounded for f32 as XLA's and CUDA's are.
    torch's f32 kernel on the CPU is not: it is 1 ulp off on about 0.7 % of
    uniform inputs, so there the f32 root is taken as the f64 root rounded to
    f32, which is correctly rounded (a double rounding cannot err for a square
    root, since 53 >= 2 * 24 + 2). On the card torch.sqrt already is."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
