"""Mission planner: boustrophedon waypoint tour + progressive-planning FSM
(mirror of ``aosx/plan/mission.py``; reference: aos_path_gen_node.cpp).

- build_waypoints(graph)    <- buildClusterWaypointMapping +
                               buildWaypointSequence (cpp:588-765)
- mission_tick(state, ...)  <- currentPosCallback (cpp:195-278) +
                               controlModCallback (cpp:280-343)
- plan_current_path(...)    <- planAndPublishPath (cpp:976-1567) +
                               trimPathNearOccupiedRegions (cpp:1570-1630)
- rebuild_waypoints(...)    <- graphCallback's tour rebuild (cpp:456-560)
- force_next_waypoint(...)  <- the /aos/next_waypoint service (cpp:349-416)

Status codes: 0 Success, 1 Failed, 2 Returning..., 3 Exploration Complete.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import AosParams, Statics
from ..geom import atan2
from ..ops import fma, lanes, norm2, scatter_set, set_at, take, take_row
from ..perceive.raster import f32, shift2d
from ..types import GridWorld, GvdGraph, MissionState, Path, Waypoints
from .astar import INF, plan_between


# ---------------------------------------------------------------------------
# waypoint tour
# ---------------------------------------------------------------------------


def build_waypoints(graph: GvdGraph, params: AosParams, s: Statics) -> Waypoints:
    """Even cluster BR->BL, odd TL->TR; tail TR on the last cluster when the
    max cluster index is even, BL when odd; consecutive waypoints <= 0.2 m
    apart are dropped (cpp:588-702). The last slot is reserved for the
    origin-return waypoint. A graph with leading world axes gives each
    world its own tour (the sequential filter runs over the worlds at once)."""
    dev = graph.nodes.device
    B = graph.num_nodes.shape
    nb = len(B)
    C = s.max_rows
    ln = graph.label_node                      # [*B, C,4] TL,TR,BL,BR
    present = (ln >= 0).any(dim=-1)
    cidx = torch.arange(C, device=dev)
    max_c = torch.where(present, cidx, -1).max(dim=-1).values
    last_odd = (max_c % 2) == 1
    is_last = cidx == max_c[..., None]
    even = (cidx % 2) == 0

    n0 = torch.where(even, ln[..., 3], ln[..., 0])   # BR | TL
    n1 = torch.where(even, ln[..., 2], ln[..., 1])   # BL | TR
    tail_even = is_last & ~last_odd[..., None] & even
    tail_odd = is_last & last_odd[..., None] & ~even
    n2 = torch.where(tail_even, ln[..., 1], torch.where(tail_odd, ln[..., 2], -1))
    slots = torch.stack([n0, n1, n2], dim=-1)
    slot_ok = present[..., None] & (slots >= 0) & (slots < graph.num_nodes[..., None, None])
    flat = slots.reshape(B + (-1,))
    ok = slot_ok.reshape(B + (-1,))
    pos = take(graph.nodes, torch.clamp(flat, min=0), nb)

    # sequential consecutive-distance filter (3C entries)
    T = 3 * C
    dmin = lanes(params.min_waypoint_distance, ok[..., 0])
    keep = torch.zeros(B + (T,), dtype=torch.bool, device=dev)
    last_xy = torch.full(B + (2,), 1e9, dtype=torch.float32, device=dev)
    any_kept = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(T):
        p = pos[..., i, :]
        d = norm2(p - last_xy)
        k = ok[..., i] & (~any_kept | (d > dmin))
        keep[..., i] = k
        last_xy = torch.where(k[..., None], p, last_xy)
        any_kept = any_kept | k

    W = s.max_waypoints
    rank = torch.cumsum(keep.to(torch.int32), -1, dtype=torch.int32) - 1
    tgt = torch.where(keep & (rank < W - 1), rank, W)
    return Waypoints(xy=scatter_set(W, 0.0, tgt, pos),
                     node_idx=scatter_set(W, -1, tgt, flat),
                     count=torch.clamp(keep.sum(dim=-1, dtype=torch.int32), max=W - 1))


def labeled_cluster_total(graph: GvdGraph):
    """Number of clusters with any TL/TR/BL/BR label (cpp:1633-1652);
    label_node may carry leading lane axes."""
    return (graph.label_node >= 0).any(dim=-1).sum(dim=-1, dtype=torch.int32)


def cluster_index_from_total(target_wp, total):
    """calculateClusterIndex (cpp:1633-1652) given the labeled-cluster count."""
    in_tail = target_wp < 2 * (total - 1) + 3
    cluster = torch.where(target_wp < 2 * (total - 1), target_wp // 2, total - 1)
    cluster = torch.where(in_tail, cluster, 0)
    return torch.where((target_wp < 0) | (total <= 0), -1, cluster).to(torch.int32)


def current_cluster_index(target_wp, graph: GvdGraph):
    """Published on /aos/current_cluster_index (cpp:1655-1663)."""
    return cluster_index_from_total(target_wp, labeled_cluster_total(graph))


def _append_origin(wp: Waypoints, params: AosParams) -> Waypoints:
    """Append the (0,0) origin-return waypoint unless the last waypoint is
    already within 0.2 m of it (cpp:299-310). Leaves may carry leading lane
    axes."""
    W = wp.xy.shape[-2]
    last = take_row(wp.xy, torch.clamp(wp.count - 1, min=0))
    near = (wp.count > 0) & (norm2(last) <= 0.2)
    slot = torch.clamp(wp.count, max=W - 1)
    xy = set_at(wp.xy, slot, 0.0, slot.dim())
    node_idx = set_at(wp.node_idx, slot, -1, slot.dim())
    return Waypoints(xy=torch.where(lanes(near, xy), wp.xy, xy),
                     node_idx=torch.where(lanes(near, node_idx), wp.node_idx, node_idx),
                     count=torch.where(near, wp.count, torch.clamp(wp.count + 1, max=W)))


# ---------------------------------------------------------------------------
# FSM tick
# ---------------------------------------------------------------------------


def mission_tick(state: MissionState, wp: Waypoints, robot_xy, control_mod,
                 params: AosParams):
    """One mission update: control-mod handling (cpp:280-343) then position
    handling (cpp:195-278). Returns (state, wp, should_replan). Every leaf
    (and every field of params) may carry leading lane axes; each lane runs
    the single-lane arithmetic."""
    advance = (control_mod == 3) & state.waiting_for_docking
    at_last = state.target_wp >= wp.count - 1
    completing = advance & at_last & ~state.exploration_completed
    wp2 = _append_origin(wp, params)
    wp = Waypoints(
        xy=torch.where(lanes(completing, wp.xy), wp2.xy, wp.xy),
        node_idx=torch.where(lanes(completing, wp.node_idx), wp2.node_idx, wp.node_idx),
        count=torch.where(completing, wp2.count, wp.count),
    )
    go_origin = advance & at_last
    prev_wp = torch.where(advance, state.target_wp, state.prev_wp)
    target_wp = torch.where(
        advance, torch.where(go_origin, wp.count - 1, state.target_wp + 1), state.target_wp)
    waiting = torch.where(advance, False, state.waiting_for_docking)
    completed = state.exploration_completed | completing
    status = torch.where(completing, 2, state.status)
    origin_appended = state.origin_appended | completing

    # ---- currentPosCallback -------------------------------------------------
    init_wp = torch.stack([params.initial_waypoint_x, params.initial_waypoint_y], dim=-1)
    d_init = norm2(robot_xy - init_wp)
    reach_init = ~state.initial_reached & (d_init <= params.initial_arrive_dist)
    target_wp = torch.where(reach_init & (wp.count > 0), 0, target_wp)
    prev_wp = torch.where(reach_init, -1, prev_wp)
    initial_reached = state.initial_reached | reach_init

    W = wp.xy.shape[-2]
    tvalid = (target_wp >= 0) & (target_wp < wp.count)
    target = take_row(wp.xy, torch.clamp(target_wp, 0, W - 1))
    d_target = norm2(robot_xy - target)

    # Exploration Complete at the origin (cpp:230-246)
    at_origin_goal = (completed & tvalid & (torch.abs(target[..., 0]) < 0.1)
                      & (torch.abs(target[..., 1]) < 0.1) & (d_target <= 1.0))
    status = torch.where(at_origin_goal, 3, status)
    # docking freeze (cpp:248-256)
    enter_dock = initial_reached & tvalid & (d_target <= params.docking_radius) & ~waiting
    waiting = waiting | enter_dock

    st = MissionState(
        target_wp=target_wp.to(torch.int32),
        prev_wp=prev_wp.to(torch.int32),
        initial_reached=initial_reached,
        exploration_completed=completed,
        waiting_for_docking=waiting,
        status=status.to(torch.int32),
        origin_appended=origin_appended,
    )
    return st, wp, ~waiting | advance


def rebuild_waypoints(state: MissionState, old_wp: Waypoints, graph: GvdGraph,
                      params: AosParams, s: Statics):
    """graphCallback's waypoint-sequence rebuild + target restoration by
    POSITION (cpp:456-560): the tour is rebuilt from the new graph unless
    exploration completed, when the old tour is kept and the origin
    re-appended if it was there; the target is re-found as the closest new
    waypoint to the saved target position within 0.5 m, else the saved
    index if still valid, else progress is kept. Returns (state, wp)."""
    W = old_wp.xy.shape[0]
    saved_idx = state.target_wp
    saved_valid = (saved_idx >= 0) & (saved_idx < old_wp.count)
    saved_pos = old_wp.xy[torch.clamp(saved_idx, 0, W - 1).long()]

    done = state.exploration_completed
    built = build_waypoints(graph, params, s)
    new_wp = Waypoints(xy=torch.where(done, old_wp.xy, built.xy),
                       node_idx=torch.where(done, old_wp.node_idx, built.node_idx),
                       count=torch.where(done, old_wp.count, built.count))
    wp2 = _append_origin(new_wp, params)
    use_append = done & state.origin_appended
    wp = Waypoints(xy=torch.where(use_append, wp2.xy, new_wp.xy),
                   node_idx=torch.where(use_append, wp2.node_idx, new_wp.node_idx),
                   count=torch.where(use_append, wp2.count, new_wp.count))

    d = norm2(wp.xy - saved_pos[None, :])
    d = torch.where(torch.arange(W, device=d.device) < wp.count, d, INF)
    best = torch.argmin(d).to(torch.int32)
    best_ok = (wp.count > 0) & (d[best.long()] < 0.5)
    idx_ok = (saved_idx >= 0) & (saved_idx < wp.count)
    keep_or_zero = torch.where(state.target_wp < 0, 0, state.target_wp)
    fallback = torch.where(done, torch.where(idx_ok, saved_idx, wp.count - 1),
                           torch.where(idx_ok, saved_idx, keep_or_zero))
    new_target = torch.where(saved_valid & best_ok, best, fallback)
    new_target = torch.where(wp.count > 0, new_target, state.target_wp).to(torch.int32)
    return dataclasses.replace(state, target_wp=new_target), wp


def force_next_waypoint(state: MissionState, wp: Waypoints, params: AosParams):
    """The /aos/next_waypoint Empty service (cpp:349-416): the manual escape
    hatch that clears the docking freeze and force-advances the target,
    appending the origin and completing exploration at the last waypoint.
    Returns (state, wp, plan_from_current_position bool)."""
    not_ready = ~state.initial_reached
    ready = ~not_ready
    target = state.target_wp
    at_last = (target >= 0) & (target >= wp.count - 1)
    mid = (target >= 0) & (target < wp.count - 1)
    unstarted = (target < 0) & (wp.count > 0)

    wp2 = _append_origin(wp, params)
    use_append = ready & at_last
    wp = Waypoints(xy=torch.where(use_append, wp2.xy, wp.xy),
                   node_idx=torch.where(use_append, wp2.node_idx, wp.node_idx),
                   count=torch.where(use_append, wp2.count, wp.count))
    minus1 = torch.full_like(state.prev_wp, -1)
    new_prev = torch.where(ready & (at_last | mid), target,
                           torch.where(ready & unstarted, minus1, state.prev_wp))
    new_target = torch.where(
        not_ready, target,
        torch.where(at_last, wp.count - 1,
                    torch.where(mid, target + 1,
                                torch.where(unstarted, torch.zeros_like(target), target))))
    out = MissionState(
        target_wp=new_target.to(torch.int32),
        prev_wp=new_prev.to(torch.int32),
        initial_reached=state.initial_reached,
        exploration_completed=state.exploration_completed | use_append,
        waiting_for_docking=torch.zeros_like(state.waiting_for_docking),
        status=torch.where(use_append, torch.full_like(state.status, 2), state.status),
        origin_appended=state.origin_appended | use_append,
    )
    return out, wp, ready & (at_last | mid | unstarted)


# ---------------------------------------------------------------------------
# path planning
# ---------------------------------------------------------------------------


def _assemble(cand_xy, cand_ok, s: Statics):
    """Compaction of the ok candidates [*B, n, 2] into a [*B, max_path, 2]
    buffer and their count, per lane."""
    P = s.max_path
    rank = torch.cumsum(cand_ok.to(torch.int32), -1, dtype=torch.int32) - 1
    tgt = torch.where(cand_ok & (rank < P), rank, P)
    return (scatter_set(P, 0.0, tgt, cand_xy),
            torch.clamp(cand_ok.sum(dim=-1, dtype=torch.int32), max=P))


def _yaws(xy, count, last_yaw):
    P = xy.shape[-2]
    d = torch.roll(xy, -1, dims=-2) - xy
    yaw = atan2(d[..., 1], d[..., 0])
    idx = torch.arange(P, device=xy.device)
    yaw = torch.where(idx == count[..., None] - 1, last_yaw[..., None], yaw)
    return torch.where(idx < count[..., None], yaw, 0.0)


def _trim_offsets(s: Statics):
    """(dy, dx, dist_m) cell offsets within s.trim_max_distance."""
    res = s.resolution
    rc = int(math.ceil(s.trim_max_distance / res))
    return [
        (dy, dx, math.hypot(dx, dy) * res)
        for dy in range(-rc, rc + 1)
        for dx in range(-rc, rc + 1)
        if math.hypot(dx, dy) * res <= s.trim_max_distance
    ]


_TRIM_FAR = 3.4e38


def trim_distance_plane(skel: GridWorld, s: Statics):
    """Per-cell min distance (m, f32) to an occupied skeleton cell within
    s.trim_max_distance (3.4e38 where none), computed once per world (for
    every world of a leading world axis at once)."""
    occ1 = (skel.occ == 1).to(torch.uint8)
    far = torch.tensor(_TRIM_FAR, dtype=torch.float32, device=skel.occ.device)
    out = torch.full(skel.occ.shape, _TRIM_FAR, dtype=torch.float32, device=skel.occ.device)
    for dy, dx, dist in _trim_offsets(s):
        hit = shift2d(occ1, -dy, -dx) == 1
        out = torch.minimum(out, torch.where(hit, f32(dist, skel.occ.device), far))
    return out


def _trim(xy, yaw, count, skel: GridWorld, params: AosParams, s: Statics, trim_plane):
    """trimPathNearOccupiedRegions (cpp:1570-1630) through the distance
    plane: the first index i >= 1 whose trim disc touches an occupied
    skeleton cell truncates the path to i. xy [*B, P, 2]; the skeleton and
    its plane carry the world's batch axes."""
    nw = skel.occ.dim() - 2
    resf = f32(s.resolution, xy.device)
    H, W = skel.occ.shape[-2:]
    x, y = xy[..., 0], xy[..., 1]
    mx = ((x - lanes(skel.origin_x, x)) / resf).to(torch.int32)
    my = ((y - lanes(skel.origin_y, y)) / resf).to(torch.int32)
    ing = ((mx >= 0) & (mx < lanes(skel.w_cells, x))
           & (my >= 0) & (my < lanes(skel.h_cells, x)))
    flat = torch.clamp(my, 0, H - 1) * W + torch.clamp(mx, 0, W - 1)
    too_close = (take(trim_plane.flatten(-2), flat, nw)
                 <= lanes(params.trim_safety_distance, x)) & ing
    idx = torch.arange(xy.shape[-2], device=xy.device)
    bad = too_close & (idx >= 1) & (idx < count[..., None])
    first_bad = torch.where(bad, idx, xy.shape[-2]).min(dim=-1).values
    return xy, yaw, torch.minimum(count, first_bad.to(torch.int32))


def plan_current_path(state: MissionState, wp: Waypoints, graph: GvdGraph, costmat,
                      skel: GridWorld, params: AosParams, s: Statics, *, trim_plane,
                      use_current_position=None, astar_enabled=None):
    """planAndPublishPath (cpp:976-1567) with the trim distance plane.
    Returns (Path, success bool). use_current_position (f32 [2]): the
    robot's position as the start, for the next_waypoint service's plan.
    astar_enabled (bool tensor): False skips the graph search
    (plan_between's ``enabled``; build_plan_cache's dead rows).

    Batch axes, as ``jax.vmap`` maps them: the mission's leaves are [*B],
    the tour's [*B, ...], astar_enabled 0-d or [*B]; the world's leaves
    (graph, costmat, skel, trim_plane) carry len(B) leading axes of B's
    sizes or 1, or none (one world for every lane); params are 0-d or carry
    the leading axes too. B = () is one plan. Each lane's result is the
    single plan's bit for bit (build_plan_cache: worlds x rows)."""
    dev = graph.nodes.device
    P = s.max_path
    nb = state.target_wp.dim()
    nw = graph.nodes.dim() - 2
    init_wp = torch.stack([params.initial_waypoint_x, params.initial_waypoint_y], dim=-1)
    arP = torch.arange(P, device=dev)

    # ---------------- initial straight path (cpp:983-1031) -----------------
    # from the params alone: [*Bp, P] for params of leading axes Bp
    npb = init_wp.dim() - 1
    dist0 = norm2(init_wp)
    num0 = torch.ceil(dist0 / params.path_step).to(torch.int32)
    t0 = arP.to(torch.float32) / torch.clamp(num0.to(torch.float32), min=1.0)[..., None]
    straight = t0[..., None] * init_wp.unsqueeze(-2)
    straight_xy, straight_count = _assemble(straight, arP <= num0[..., None], s)
    straight_xy = set_at(straight_xy, torch.clamp(straight_count - 1, min=0), init_wp, npb)
    yaw0 = atan2(init_wp[..., 1], init_wp[..., 0])
    straight_yaw = torch.where(arP < straight_count[..., None], yaw0[..., None], 0.0)

    # ---------------- graph path (cpp:1046-1549) ---------------------------
    Wn = wp.xy.shape[-2]
    tw = torch.clamp(state.target_wp, 0, Wn - 1)
    target = take_row(wp.xy, tw)
    target_node = take_row(wp.node_idx, tw)
    prev_ok = (state.prev_wp >= 0) & (state.prev_wp < wp.count)
    start_point = torch.where(prev_ok[..., None],
                              take_row(wp.xy, torch.clamp(state.prev_wp, 0, Wn - 1)), init_wp)
    if use_current_position is not None:
        start_point = torch.as_tensor(use_current_position, dtype=torch.float32,
                                      device=dev).expand(start_point.shape)

    origin_return = target_node < 0
    d_to_nodes = norm2(graph.nodes - target.unsqueeze(-2))
    nearest_to_target = torch.argmin(torch.where(graph.node_valid, d_to_nodes, INF),
                                     dim=-1).to(torch.int32)
    goal = torch.where(origin_return, nearest_to_target, torch.clamp(target_node, min=0))

    node_path, plen, found = plan_between(costmat, graph.nodes, graph.node_valid,
                                          start_point, goal, params, s,
                                          enabled=astar_enabled)

    first_node_xy = take(graph.nodes, torch.clamp(node_path[..., 0], min=0), nw)
    add_start = norm2(start_point - first_node_xy) > 0.1
    node_xy = take(graph.nodes, torch.clamp(node_path, min=0), nw)
    node_ok = (arP < plen[..., None]) & (node_path >= 0)
    # drop exact-duplicate consecutive node positions (cpp:1446-1454)
    prev_xy = torch.cat([start_point.unsqueeze(-2), node_xy[..., :-1, :]], dim=-2)
    prev_ok_arr = torch.cat([add_start[..., None], node_ok[..., :-1]], dim=-1)
    dup = node_ok & prev_ok_arr & (node_xy == prev_xy).all(dim=-1)
    node_ok = node_ok & ~dup

    last_node = take_row(node_path, torch.clamp(plen - 1, min=0))
    last_node_xy = take(graph.nodes, torch.clamp(last_node, min=0), nw)
    dtail = target - last_node_xy
    tail_num = torch.ceil(norm2(dtail) / params.path_step).to(torch.int32)
    it = arP.to(torch.float32) + 1.0
    tt = it / torch.clamp(tail_num.to(torch.float32), min=1.0)[..., None]
    # last_node + t * dtail rounded once: XLA:CPU fuses it
    tail_xy = fma(tt[..., None], dtail.unsqueeze(-2), last_node_xy.unsqueeze(-2))
    tail_ok = (arP < tail_num[..., None]) & origin_return[..., None]
    target_point_ok = ~origin_return & (norm2(last_node_xy - target) > 0.01)
    tail_xy = torch.where((arP == 0)[:, None] & ~origin_return[..., None, None],
                          target.unsqueeze(-2), tail_xy)
    tail_ok = tail_ok | ((arP == 0) & target_point_ok[..., None])

    cand_xy = torch.cat([start_point.unsqueeze(-2), node_xy, tail_xy], dim=-2)
    cand_ok = torch.cat([add_start[..., None], node_ok, tail_ok], dim=-1) & found[..., None]
    gxy, gcount = _assemble(cand_xy, cand_ok, s)
    # exact target at the end (cpp:1252-1255,1494-1503)
    gxy_t = set_at(gxy, torch.clamp(gcount - 1, min=0), target, nb)
    gxy = torch.where((found & (gcount > 0))[..., None, None], gxy_t, gxy)

    # last yaw: face the next waypoint if any (cpp:1517-1534)
    has_next = state.target_wp < wp.count - 1
    nxt_wp = take_row(wp.xy, torch.clamp(state.target_wp + 1, 0, Wn - 1))
    last_pt = take_row(gxy, torch.clamp(gcount - 1, min=0))
    prev_pt = take_row(gxy, torch.clamp(gcount - 2, min=0))
    dn = torch.where(has_next[..., None], nxt_wp - last_pt, last_pt - prev_pt)
    gyaw = _yaws(gxy, gcount, atan2(dn[..., 1], dn[..., 0]))

    # ---------------- select branch + trim ---------------------------------
    use_straight = ~state.initial_reached
    have_wp = (wp.count > 0) & (state.target_wp >= 0) & (state.target_wp < wp.count)
    success = torch.where(use_straight, True, found & have_wp)
    xy = torch.where(use_straight[..., None, None], straight_xy, gxy)
    yaw = torch.where(use_straight[..., None], straight_yaw, gyaw)
    count = torch.where(use_straight, straight_count, torch.where(success, gcount, 0))
    xy, yaw, count = _trim(xy, yaw, count.to(torch.int32), skel, params, s, trim_plane)
    return Path(xy=xy, yaw=yaw, count=count), success
