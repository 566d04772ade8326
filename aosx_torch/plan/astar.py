"""Weighted A* over the padded GVD graph (mirror of ``aosx/plan/astar.py``;
reference: aos_path_gen_node.cpp:800-932).

The graph is held as a padded-CSR adjacency (``CsrCosts``: [N, D] neighbour
ids + costs). One pop is a masked argmin over f = g + w*h (ties: lowest
index); a relaxation is a D-wide scatter-min. The k candidate starts of
``plan_between`` run as one batch of searches, and so do the leading batch
axes of the plan cache (worlds x rows).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import AosParams, Statics
from ..guards import GUARD_DEGREE_CAP
from ..ops import gather_last, lanes, norm2, sum_xla, take, take_row, while_loop
from ..types import GvdGraph

INF = 3.4e38


@dataclasses.dataclass(frozen=True)
class CsrCosts:
    """Padded-CSR edge costs: slot j of row i holds neighbour ``idx[i, j]``
    at cost ``cost[i, j]`` (pad: idx = N, cost = INF). ``guards`` carries
    GUARD_DEGREE_CAP when a node exceeded max_degree."""

    idx: torch.Tensor    # [N, D] i32
    cost: torch.Tensor   # [N, D] f32
    guards: torch.Tensor  # i32 scalar


def cost_matrix(graph: GvdGraph, s: Statics) -> CsrCosts:
    """Edge list -> padded-CSR adjacency. Both directions of every valid
    edge are slotted onto their source row; slot = rank among same-source
    entries (one stable sort + a segmented cumulative max). A graph with
    leading world axes gives each world its own [N, D] adjacency."""
    dev = graph.edges.device
    N, D = s.max_nodes, s.max_degree
    B = graph.edge_valid.shape[:-1]
    E = graph.edges.shape[-2]
    a = torch.where(graph.edge_valid, graph.edges[..., 0], N).to(torch.int32)
    b = torch.where(graph.edge_valid, graph.edges[..., 1], N).to(torch.int32)
    lens = torch.where(graph.edge_valid, graph.edge_lengths, INF)
    src = torch.cat([a, b], dim=-1)
    dst = torch.cat([b, a], dim=-1)
    c = torch.cat([lens, lens], dim=-1)

    order = torch.argsort(src, dim=-1, stable=True)
    ss = gather_last(src, order)
    pos = torch.arange(2 * E, dtype=torch.int32, device=dev)
    is_start = torch.cat([torch.ones(B + (1,), dtype=torch.bool, device=dev),
                          ss[..., 1:] != ss[..., :-1]], dim=-1)
    slot = pos - torch.cummax(torch.where(is_start, pos, 0), dim=-1).values

    live = ss < N
    ok = live & (slot < D)
    overflow = (live & (slot >= D)).any(dim=-1)
    flat = (torch.where(ok, ss, N).long() * D + torch.clamp(slot, max=D - 1).long())
    idx = torch.full(B + ((N + 1) * D,), N, dtype=torch.int32, device=dev)
    idx.scatter_(-1, flat, gather_last(dst, order))
    cost = torch.full(B + ((N + 1) * D,), INF, dtype=torch.float32, device=dev)
    cost.scatter_(-1, flat, gather_last(c, order))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return CsrCosts(idx=idx[..., :N * D].reshape(B + (N, D)),
                    cost=cost[..., :N * D].reshape(B + (N, D)),
                    guards=torch.where(overflow, GUARD_DEGREE_CAP, zero))


def _world_axes(costs: CsrCosts) -> int:
    """Number of leading batch axes of a world's leaves."""
    return costs.idx.dim() - 2


def astar(costs: CsrCosts, nodes, node_valid, start, goal, weight, s: Statics,
          enabled=None):
    """Weighted A* (f = g + w*h, h = euclidean to goal; cpp:800-896) from
    each of the start nodes ``start`` [*B, K] to ``goal`` [*B]. Returns
    (path [*B, K, max_path] i32 padded with -1, path_len [*B, K] i32, found
    [*B, K] bool). Pops the open node with min f (ties: lowest index).

    Batch axes B, as ``jax.vmap`` maps them: the world's leaves (costs,
    nodes, node_valid) carry len(B) leading axes of B's sizes or 1 (one
    world serving every search of a lane), or none (one world for all);
    ``weight`` and ``enabled`` are 0-d or carry B. B = () is one world's
    search. Every lane and start runs the single search's arithmetic bit
    for bit.

    The searches run in lockstep over B x K; a search that is done keeps
    its state (its updates are masked with its own activity), so the
    iterations it spends waiting for the slowest search, and those between
    host checks of the loop condition, change nothing.

    enabled (optional bool): where False the search starts done, so its
    lane never changes, and (all -1, 0, False) is returned, exactly what an
    unreachable search gives (build_plan_cache's dead rows)."""
    dev = nodes.device
    N = s.max_nodes
    nw = _world_axes(costs)
    B, K = start.shape[:-1], start.shape[-1]
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    start = start.long()
    goal = torch.as_tensor(goal, device=dev).long().expand(B)
    h = norm2(nodes - take(nodes, goal, nw).unsqueeze(-2)) * lanes(weight, goal[..., None])

    g0 = torch.full(B + (K, N), INF, dtype=torch.float32, device=dev)
    g0.scatter_(-1, start[..., None], 0.0)
    open0 = torch.zeros(B + (K, N), dtype=torch.bool, device=dev)
    open0.scatter_(-1, start[..., None], True)

    start_ok = take(node_valid, start, nw) & take(node_valid, goal, nw)[..., None]
    has_nb_start = (take(costs.cost, start, nw) < inf).any(dim=-1)
    has_nb_goal = (take(costs.cost, goal, nw) < inf).any(dim=-1)
    runnable = start_ok & has_nb_start & has_nb_goal[..., None] & (start != goal[..., None])
    if enabled is not None:
        enabled = torch.as_tensor(enabled, device=dev)[..., None]
        runnable = runnable & enabled

    def active(st):
        _, _, open_, _, done, it = st
        return ~done & open_.any(dim=-1) & (it < N)

    def body(st):
        g, parent, open_, closed, done, it = st
        act = active(st)
        f = torch.where(open_, g + h.unsqueeze(-2), inf)
        u = torch.argmin(f, dim=-1)                              # [*B, K]
        at_goal = u == goal[..., None]
        u1 = u[..., None]
        closed1 = closed.scatter(-1, u1, True)
        open1 = open_.scatter(-1, u1, False)
        t = take(costs.idx, u, nw).long()                        # [*B, K, D]
        c = take(costs.cost, u, nw)
        tc = torch.clamp(t, max=N - 1)
        ng = torch.where((c < inf) & ~closed1.gather(-1, tc) & ~at_goal[..., None],
                         g.gather(-1, u1) + c, inf)
        gext = torch.cat([g, torch.full(B + (K, 1), INF, dtype=g.dtype, device=dev)], dim=-1)
        g2 = gext.scatter_reduce(-1, t, ng, reduce="amin", include_self=True)[..., :N]
        better = g2 < g
        parent1 = torch.where(better, u.to(torch.int32)[..., None], parent)
        open1 = open1 | better
        a2 = act[..., None]
        return (torch.where(a2, g2, g), torch.where(a2, parent1, parent),
                torch.where(a2, open1, open_), torch.where(a2, closed1, closed),
                torch.where(act, done | at_goal, done), it + act.to(torch.int32))

    state = (g0, torch.full(B + (K, N), -1, dtype=torch.int32, device=dev), open0,
             torch.zeros(B + (K, N), dtype=torch.bool, device=dev), ~runnable,
             torch.zeros(B + (K,), dtype=torch.int32, device=dev))
    _, parent, _, closed, done, _ = while_loop(active, body, state, "astar")
    goal_k = goal[..., None].expand(B + (K,))
    found = done & runnable & closed.gather(-1, goal_k[..., None]).squeeze(-1)

    # reconstruct goal -> start by pointer doubling over the parent table
    # (parent -1 is the absorbing index N), then reverse front-aligned
    P = s.max_path
    par = torch.where(parent >= 0, parent, N).long()
    par = torch.cat([par, torch.full(B + (K, 1), N, dtype=torch.long, device=dev)], dim=-1)
    seq = torch.where(found, goal_k, N)[..., None]              # [*B, K, 1]
    jump = par
    while seq.shape[-1] < P:
        seq = torch.cat([seq, jump.gather(-1, seq)], dim=-1)
        jump = jump.gather(-1, jump)
    seq = seq[..., :P]
    ok = seq < N
    rev = torch.where(ok, seq, -1).to(torch.int32)
    ln = ok.sum(dim=-1, dtype=torch.int32)
    idx = torch.arange(P, device=dev)
    src_i = torch.clamp(ln[..., None] - 1 - idx, 0, P - 1).long()
    path = torch.where(idx < ln[..., None], rev.gather(-1, src_i), -1)
    # single-node degenerate case start == goal (cpp:808-811)
    trivial = start_ok & (start == goal[..., None])
    if enabled is not None:
        trivial = trivial & enabled
    triv_path = torch.full(B + (K, P), -1, dtype=torch.int32, device=dev)
    triv_path[..., 0] = start.to(torch.int32)
    path = torch.where(trivial[..., None], triv_path, path)
    ln = torch.where(trivial, 1, torch.where(found, ln, 0)).to(torch.int32)
    return path, ln, found | trivial


def path_cost(costs: CsrCosts, nodes, path, path_len):
    """calculatePathCost (cpp:935-973): edge costs along consecutive path
    pairs, euclidean where no edge matches. path [*B, ..., P], path_len
    [*B, ...], the world's leaves with the batch axes B. Summed in f32 in
    XLA:CPU's order for ``jnp.sum`` (``ops.sum_xla``), the same on every
    device and batch shape."""
    nw = _world_axes(costs)
    P = path.shape[-1]
    a = path[..., :-1]
    b = path[..., 1:]
    ok = ((torch.arange(P - 1, device=path.device) < (path_len[..., None] - 1))
          & (a >= 0) & (b >= 0))
    ai = torch.clamp(a, min=0).long()
    bi = torch.clamp(b, min=0).long()
    rows = take(costs.idx, ai, nw)                 # [..., P-1, D]
    match = rows == bi[..., None]
    has = match.any(dim=-1)
    slot = match.to(torch.uint8).argmax(dim=-1)
    c = take(costs.cost, ai, nw).gather(-1, slot[..., None]).squeeze(-1)
    eu = norm2(take(nodes, bi, nw) - take(nodes, ai, nw))
    c = torch.where(has, c, eu)
    return sum_xla(torch.where(ok, c, 0.0))


def k_nearest_nodes(nodes, node_valid, point, k: int):
    """findKNearestNodes (cpp:914-932): k nearest by distance, ties to the
    lower index (a stable sort, as lax.top_k orders ties). point [*B, 2]
    and the nodes of the world of each lane give [*B, k]."""
    d = norm2(nodes - point.unsqueeze(-2))
    d = torch.where(node_valid, d, INF)
    return torch.argsort(d, dim=-1, stable=True)[..., :k].to(torch.int32)


def plan_between(costs: CsrCosts, nodes, node_valid, start_point, goal_node,
                 params: AosParams, s: Statics, enabled=None):
    """The k-candidate-start planning core (cpp:1282-1386): A* from each of
    the astar_k nearest nodes to start_point, score = dist(start,
    candidate) + path cost, keep the best (first on ties). Returns
    (path [*B, max_path] i32, path_len [*B], found [*B]) for start_point
    [*B, 2] and goal_node [*B]; batch axes and enabled: see astar."""
    nw = _world_axes(costs)
    cands = k_nearest_nodes(nodes, node_valid, start_point, s.astar_k)
    goal_node = torch.as_tensor(goal_node, device=nodes.device).expand(cands.shape[:-1])
    paths, lens, found = astar(costs, nodes, node_valid, cands, goal_node,
                               params.heuristic_weight, s, enabled=enabled)
    usable = found & (lens > 1) & (cands != goal_node[..., None])
    cost = (path_cost(costs, nodes, paths, lens)
            + norm2(start_point.unsqueeze(-2) - take(nodes, cands, nw)))
    cost = torch.where(usable, cost, INF)
    best = torch.argmin(cost, dim=-1)
    any_ok = usable.any(dim=-1)
    return take_row(paths, best), torch.where(any_ok, take_row(lens, best), 0), any_ok
