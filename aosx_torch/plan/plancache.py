"""Precomputed plan cache: replan-free control ticks on a static world
(mirror of ``aosx/plan/plancache.py``).

plan_current_path's start is the PREVIOUS WAYPOINT, not the robot pose
(aos_path_gen_node.cpp:1046-1060), so on a fixed world the raw path is a
pure function of the mission configuration (initial_reached, target_wp,
prev_wp, origin_appended), and an episode visits at most W+4 of them:

    row 0        initial straight line (0,0)->(8,0)   [~initial_reached]
    rows 1..W    target t in 0..W-1, prev = t-1
    row W+1      origin return, prev = last tour wp
    row W+2      origin return, prev == target
    row W+3      target_wp < 0 with initial_reached   [always fails]
    row W+4      the initial empty path and its linearization

``build_plan_cache`` plans every row once per world; ``step_cached`` then
selects a row by index each tick, bit-identical to replanning every tick
(``engine.step``). ``add_carry_row`` appends row R = W+5, which keeps the
published plan across a world rebuild (``serving.serve_map_frame``).

``build_plan_cache`` takes worlds of leading batch axes B and plans the
[*B, R] rows in one batched plan_current_path and one batched linearize
(worlds x rows x A* candidates, the axes ``aosx`` vmaps); dead rows are
masked lanes of the one search. ``step_cached`` and what it calls take an
optional leading lane axis on every state, cache, world-lite and parameter
leaf (the Monte-Carlo chunk of ``aosx_torch.parallel.batch``). Either way
there is one copy of the logic, and each lane is the single-lane arithmetic
bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tree
from ..config import AosParams, Statics
from ..engine import Robot, _move_robot, initial_state, stack_metrics, vmap_forms
from ..guards import GUARD_NONFINITE, GUARD_PLAN_CAP
from ..ops import lanes, sqrt, take_row
from ..types import ControlState, MissionState, Path, Waypoints
from .control import control_tick
from .linearize import linearize
from .mission import (
    _append_origin,
    cluster_index_from_total,
    labeled_cluster_total,
    mission_tick,
    plan_current_path,
)


@dataclasses.dataclass(frozen=True)
class PlanCache:
    """Per-world precomputed plans, one row per reachable mission config."""

    plan_xy: torch.Tensor     # [R, max_plan, 2] f32 linearized /plan points
    plan_yaw: torch.Tensor    # [R, max_plan] f32 per-point yaw (serving export)
    plan_count: torch.Tensor  # [R] i32
    goal_xy: torch.Tensor     # [R, 2] f32 = plan_xy[r, max(count-1, 0)]
    goal_yaw: torch.Tensor    # [R] f32  = plan_yaw[r, max(count-1, 0)]
    success: torch.Tensor     # [R] bool plan_current_path success
    nonfinite: torch.Tensor   # [R] i32 nonfinite entries of plan.xy + raw.xy


@dataclasses.dataclass(frozen=True)
class WorldLite:
    """What step_cached still needs of the World once the plans are cached."""

    guards: torch.Tensor         # i32 world-build guard bitmask
    cluster_total: torch.Tensor  # i32 labeled-cluster count


def world_lite(world) -> WorldLite:
    return WorldLite(guards=world.guards, cluster_total=labeled_cluster_total(world.graph))


@dataclasses.dataclass(frozen=True)
class CachedEngineState:
    """engine.EngineState with the carried paths replaced by the adopted
    cache row index (keep-last-path == keep-last-index)."""

    robot: Robot
    mission: MissionState
    control: ControlState
    wp: Waypoints
    adopted: torch.Tensor    # i32 cache row currently published as /plan
    last_mod: torch.Tensor
    t: torch.Tensor


def num_rows(s: Statics) -> int:
    return s.max_waypoints + 5


def cache_row_index(mission: MissionState, s: Statics):
    """The cache row of a mission configuration (module docstring)."""
    W = s.max_waypoints
    return torch.where(
        ~mission.initial_reached, 0,
        torch.where(mission.target_wp < 0, W + 3,
                    torch.where(~mission.origin_appended, 1 + mission.target_wp,
                                torch.where(mission.prev_wp == mission.target_wp,
                                            W + 2, W + 1)))).to(torch.int32)


def _row_payload(raw: Path, plan: Path, success) -> dict:
    """Cache rows from (raw, linearized) plan pairs of any leading axes;
    shared by build_plan_cache and pin_live_row."""
    gi = torch.clamp(plan.count - 1, min=0)
    nf = ((~torch.isfinite(plan.xy)).sum(dim=(-2, -1), dtype=torch.int32)
          + (~torch.isfinite(raw.xy)).sum(dim=(-2, -1), dtype=torch.int32))
    return dict(plan_xy=plan.xy, plan_yaw=plan.yaw, plan_count=plan.count,
                goal_xy=take_row(plan.xy, gi), goal_yaw=take_row(plan.yaw, gi),
                success=success, nonfinite=nf)


def row_missions(wp0: Waypoints, params: AosParams, s: Statics):
    """(MissionState [*B, R], Waypoints [*B, R, ...]) of the R rows (module
    docstring) as tensors, from a tour wp0 of leading axes B (as
    ``aosx.plan.plancache.build_plan_cache`` builds them)."""
    dev = wp0.count.device
    W = s.max_waypoints
    R = num_rows(s)
    wp2 = _append_origin(wp0, params)
    c2 = wp2.count[..., None]
    B = wp0.count.shape
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    none = (rows == 0) | (rows >= W + 3)
    target = torch.where(none, -1, torch.where(rows <= W, rows - 1, c2 - 1))
    prev = torch.where(none, -1, torch.where(rows <= W, rows - 2,
                                             torch.where(rows == W + 1, c2 - 2, c2 - 1)))
    use_wp2 = (rows == W + 1) | (rows == W + 2)
    false = torch.zeros(B + (R,), dtype=torch.bool, device=dev)
    missions = MissionState(
        target_wp=target.to(torch.int32).expand(B + (R,)),
        prev_wp=prev.to(torch.int32).expand(B + (R,)),
        initial_reached=(rows != 0).expand(B + (R,)),
        exploration_completed=false, waiting_for_docking=false,
        status=torch.zeros(B + (R,), dtype=torch.int32, device=dev),
        origin_appended=use_wp2.expand(B + (R,)))
    wps = Waypoints(
        xy=torch.where(use_wp2[:, None, None], wp2.xy.unsqueeze(-3), wp0.xy.unsqueeze(-3)),
        node_idx=torch.where(use_wp2[:, None], wp2.node_idx.unsqueeze(-2),
                             wp0.node_idx.unsqueeze(-2)),
        count=torch.where(use_wp2, c2, wp0.count[..., None]))
    return missions, wps


def _row_axis(t, nb: int):
    """Leaves of nb leading axes B as [*B, 1, ...]: one world (or parameter
    set) serving every row of its lane. 0-d leaves stay as they are."""
    if not nb:
        return t
    return tree.tree_map(lambda x: x.unsqueeze(nb) if torch.is_tensor(x) and x.dim() else x, t)


def _plan_all_rows(world, params: AosParams, s: Statics, wp_base=None):
    """(raw Path [*B, R], success [*B, R]) of every row of the worlds of
    leading axes B: ONE plan_current_path call over the [*B, R] missions.
    Dead rows (row 0's graph search, targets outside the tour, W+3, W+4)
    are masked lanes of the one search: their search result is never read
    (``aosx.plan.plancache.build_plan_cache``)."""
    nb = world.waypoints.count.dim()
    wp0 = world.waypoints if wp_base is None else wp_base
    missions, wps = row_missions(wp0, params, s)
    live = missions.initial_reached & (missions.target_wp >= 0) & (missions.target_wp < wps.count)
    graph, costmat, skel, trim = _row_axis(
        (world.graph, world.costmat, world.skeleton, world.trim_skel), nb)
    return plan_current_path(missions, wps, graph, costmat, skel, _row_axis(params, nb), s,
                             trim_plane=trim, astar_enabled=live)


def plan_rows(world, params: AosParams, s: Statics, wp_base=None):
    """[(raw Path, success)] of rows 0..W+3 of one world, for inspection:
    the rows of the one batched plan_current_path call of
    ``build_plan_cache``.

    wp_base is the tour the engine carries (default world.waypoints); after
    a graph change mid-survey pass the post-rebuild_waypoints tour (see
    ``aosx.plan.plancache.build_plan_cache``)."""
    raws, success = _plan_all_rows(world, params, s, wp_base)
    return [(tree.tree_map(lambda x: x[r], raws), success[r]) for r in range(num_rows(s) - 1)]


def build_plan_cache(world, params: AosParams, s: Statics, wp_base=None) -> PlanCache:
    """plan_current_path + linearize for every row of the worlds of leading
    axes B (every world leaf [*B, ...]; params 0-d or [*B]): one batched
    plan_current_path and one batched linearize over the [*B, R] rows, as
    ``jax.vmap`` maps worlds x rows x A* candidates. Row W+4 is planned
    dead and then replaced by the engine's initial empty /aos/path before
    the linearize, as the JAX package's row W+4. Returns [*B, R, ...]
    leaves; each lane's rows are the single world's bit for bit."""
    raws, success = _plan_all_rows(world, params, s, wp_base)
    W4 = num_rows(s) - 1
    empty = torch.arange(num_rows(s), device=success.device) == W4
    raws = Path(xy=torch.where(empty[:, None, None], 0.0, raws.xy),
                yaw=torch.where(empty[:, None], 0.0, raws.yaw),
                count=torch.where(empty, 0, raws.count).to(torch.int32))
    success = success & ~empty
    plans = linearize(raws, _row_axis(params, world.waypoints.count.dim()), s)
    return PlanCache(**_row_payload(raws, plans, success))


def tour_feasibility(cache: PlanCache, wp: Waypoints, params: AosParams, s: Statics, *,
                     dock_margin=0.0) -> dict:
    """Static mission-completion feasibility of a world from its plan cache
    (see ``aosx.plan.plancache.tour_feasibility`` for the contract): a tour
    leg is completable iff its plan exists and some linearized plan point
    lies within ``docking_radius - dock_margin`` of the leg's target; the
    mission also needs the initial straight leg to end within
    ``initial_arrive_dist`` of the initial waypoint and a nonempty tour.

    Returns tensors of the worlds' leading axes B (cache [*B, R, ...], wp
    [*B, ...], params 0-d or [*B]; 0-d for one world): feasible, row0_ok,
    returnable (bool), first_bad_leg (i32 cache row, num_rows(s) if none;
    row 0 reads waypoint 0 through the clamp of rows - 1) and bad_legs
    (i32)."""
    dev = cache.plan_xy.device
    W = s.max_waypoints
    R = num_rows(s)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    Wn = wp.xy.shape[-2]

    wp2 = _append_origin(wp, params)
    origin_tgt = take_row(wp2.xy, torch.clamp(wp2.count - 1, 0, Wn - 1))
    tgt = wp.xy[..., torch.clamp(rows - 1, 0, Wn - 1).long(), :]
    is_origin_row = (rows == W + 1) | (rows == W + 2)
    tgt = torch.where(is_origin_row[:, None], origin_tgt.unsqueeze(-2), tgt)

    dp = cache.plan_xy - tgt.unsqueeze(-2)
    d = sqrt(dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1])
    valid = (torch.arange(cache.plan_xy.shape[-2], device=dev)
             < cache.plan_count[..., None])
    far = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    mind = torch.where(valid, d, far).min(dim=-1).values
    dockable = (cache.success & (cache.plan_count > 0)
                & (mind <= lanes(params.docking_radius - dock_margin, mind)))

    live = (rows >= 1) & (rows <= wp.count[..., None])   # mid-tour legs: targets 0..count-1
    legs_ok = torch.where(live, dockable, True)
    init_wp = torch.stack([params.initial_waypoint_x, params.initial_waypoint_y], dim=-1)
    d0 = cache.goal_xy[..., 0, :] - init_wp
    row0_ok = sqrt(d0[..., 0] * d0[..., 0] + d0[..., 1] * d0[..., 1]) <= params.initial_arrive_dist
    first_bad = torch.where(legs_ok, R, rows).min(dim=-1).values.to(torch.int32)
    return dict(
        feasible=row0_ok & legs_ok.all(dim=-1) & (wp.count > 0),
        row0_ok=row0_ok,
        first_bad_leg=torch.where(row0_ok, first_bad, 0).to(torch.int32),
        bad_legs=(~legs_ok).sum(dim=-1, dtype=torch.int32) + (~row0_ok).to(torch.int32),
        returnable=dockable[..., W + 1],
    )


def add_carry_row(cache: PlanCache, s: Statics) -> PlanCache:
    """Append the CARRY row (index num_rows(s)), initialised to the empty
    row W+4. cache_row_index never returns it; a rebuild sets it to the old
    cache's adopted row (carry_adopted_row) and points adoption at it."""
    W4 = num_rows(s) - 1
    return PlanCache(**{f.name: torch.cat([getattr(cache, f.name),
                                           getattr(cache, f.name)[W4:W4 + 1]])
                        for f in dataclasses.fields(cache)})


def carry_adopted_row(new_cache: PlanCache, old_cache: PlanCache, old_adopted) -> PlanCache:
    """new_cache with its carry row := old_cache[old_adopted] (exact
    keep-last-path across a world rebuild)."""
    R = new_cache.plan_xy.shape[0] - 1
    idx = torch.as_tensor(old_adopted).long()

    def put(a, b):
        a = a.clone()
        a[R] = b[idx]
        return a

    return PlanCache(**{f.name: put(getattr(new_cache, f.name), getattr(old_cache, f.name))
                        for f in dataclasses.fields(new_cache)})


def rows_bitwise_equal(cache: PlanCache, i, j):
    """True iff rows i and j of every leaf are bitwise identical (floats
    compared as int32 views, so NaN payloads and -0.0 equal themselves)."""
    i = torch.as_tensor(i).long()
    j = torch.as_tensor(j).long()
    eq = []
    for f in dataclasses.fields(cache):
        a = getattr(cache, f.name)
        if a.is_floating_point():
            a = a.view(torch.int32)
        eq.append((a[i] == a[j]).all())
    return torch.stack(eq).all()


def pin_live_row(cache: PlanCache, world, mission: MissionState, wp: Waypoints,
                 params: AosParams, s: Statics) -> PlanCache:
    """Overwrite the row cache_row_index(mission) selects with the plan for
    the ACTUAL (prev_wp, target_wp) pair: rebuild_waypoints restores the
    target by position but keeps prev_wp, so right after a rebuild the live
    config may break the rows' prev == target - 1 encoding."""
    raw, success = plan_current_path(mission, wp, world.graph, world.costmat, world.skeleton,
                                     params, s, trim_plane=world.trim_skel)
    pay = _row_payload(raw, linearize(raw, params, s), success)
    r = cache_row_index(mission, s).long()
    out = {}
    for k, v in pay.items():
        a = getattr(cache, k).clone()
        a[r] = v
        out[k] = a
    return PlanCache(**out)


def initial_cached_state(world, s: Statics) -> CachedEngineState:
    st = initial_state(world, s)
    return CachedEngineState(
        robot=st.robot, mission=st.mission, control=st.control, wp=st.wp,
        adopted=torch.full(st.t.shape, s.max_waypoints + 4, dtype=torch.int32,
                           device=st.t.device),
        last_mod=st.last_mod, t=st.t)


def _on_path_cached(state: ControlState, cache: PlanCache, adopted) -> ControlState:
    """control.on_path on the cached plan: only the goal pose and count > 0
    are read, both precomputed per row."""
    has = take_row(cache.plan_count, adopted) > 0
    new_xy = take_row(cache.goal_xy, adopted)
    new_yaw = take_row(cache.goal_yaw, adopted)
    changed = has & (~state.goal_initialized | (new_xy != state.goal_xy).any(dim=-1)
                     | (new_yaw != state.goal_yaw))
    return ControlState(
        mode=state.mode,
        is_path_received=state.is_path_received | changed,
        goal_initialized=state.goal_initialized | changed,
        odom_cnt=state.odom_cnt,
        goal_xy=torch.where(lanes(changed, new_xy), new_xy, state.goal_xy),
        goal_yaw=torch.where(changed, new_yaw, state.goal_yaw),
    )


def select_row(arr, adopted):
    """Row ``adopted`` of an [R, ...] array, or of every lane of an
    [L, R, ...] array for ``adopted`` [L]. A gather keeps every bit (the
    JAX package's one-hot bitcast sum serves vmapped TPU lanes)."""
    return take_row(arr, adopted)


def step_cached(state: CachedEngineState, lite: WorldLite, cache: PlanCache,
                params: AosParams, s: Statics, *, v_dt=0.12, external_pose: bool = False,
                vmap_lanes: int = 0):
    """engine.step with the per-tick replan + linearization replaced by the
    cache row select; bit-identical metrics and trajectories.

    external_pose=True: state.robot already holds the MEASURED pose
    (serving.serve_control_tick), nothing simulates motion, and the metrics
    also carry the selected ``plan_xy``.

    Lanes: every leaf of state, lite, cache ([L, R, ...]) and, for a sweep,
    params may carry one leading lane axis; lanes do not interact.
    vmap_lanes: round as ``jax.vmap`` over that many lanes
    (``engine.step``)."""
    dev = state.t.device
    vmapped, vector = vmap_forms(vmap_lanes)
    # 1. control tick on the currently published /plan
    ctrl = _on_path_cached(state.control, cache, state.adopted)
    ctrl, fired, mod, goal_xy, goal_yaw = control_tick(ctrl, state.robot.xy, state.robot.yaw,
                                                       params, vector=vector)
    mod_pub = torch.where(fired | ~ctrl.goal_initialized, mod, state.last_mod)

    # 2. mission FSM; the "replan" is the cache row lookup
    mission, wp, should_replan = mission_tick(state.mission, state.wp, state.robot.xy,
                                              mod_pub, params, vector=vector)
    idx_now = cache_row_index(mission, s)
    success = take_row(cache.success, idx_now)
    use_new = should_replan & success
    adopted = torch.where(use_new, idx_now, state.adopted).to(torch.int32)

    plan_count = take_row(cache.plan_count, adopted)
    plan_xy = select_row(cache.plan_xy, adopted)
    plan_path = Path(xy=plan_xy, yaw=torch.zeros_like(plan_xy[..., 0]), count=plan_count)
    status = torch.where(mission.status == 3, 3,
                         torch.where(mission.status == 2, 2,
                                     torch.where(success, 0, 1))).to(torch.int32)
    mission = dataclasses.replace(mission, status=status)

    # 3. robot kinematics; the follower's progress index resets when the
    # ADOPTED ROW changes (engine.step's content-changed reset in cache
    # coordinates)
    if external_pose:
        robot = state.robot
    else:
        robot_in = dataclasses.replace(
            state.robot,
            follow_i=torch.where(use_new & (idx_now != state.adopted), 0,
                                 state.robot.follow_i).to(torch.int32))
        robot = _move_robot(robot_in, mod_pub, plan_path, ctrl.goal_xy, ctrl.goal_yaw,
                            v_dt=v_dt, vmapped=vmapped)

    new_state = CachedEngineState(robot=robot, mission=mission, control=ctrl, wp=wp,
                                  adopted=adopted, last_mod=mod_pub, t=state.t + 1)
    nonfinite = ((~torch.isfinite(robot.xy)).sum(dim=-1, dtype=torch.int32)
                 + take_row(cache.nonfinite, adopted)
                 + (~torch.isfinite(ctrl.goal_xy)).sum(dim=-1, dtype=torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    metrics = dict(
        xy=robot.xy,
        yaw=robot.yaw,
        mod=mod_pub,
        status=status,
        target_wp=mission.target_wp,
        cluster_idx=cluster_index_from_total(mission.target_wp, lite.cluster_total),
        waiting=mission.waiting_for_docking,
        completed=mission.exploration_completed,
        plan_len=plan_count,
        nonfinite=nonfinite,
        guards=lite.guards
        | torch.where(nonfinite > 0, GUARD_NONFINITE, zero)
        | torch.where(plan_count >= s.max_plan, GUARD_PLAN_CAP, zero),
    )
    if external_pose:
        metrics["plan_xy"] = plan_xy
    return new_state, metrics


def episode_cached(world, params: AosParams, s: Statics, n_steps: int, *, v_dt=0.12):
    """engine.episode through the plan cache. Returns (final
    CachedEngineState, per-step metrics stacked along a leading axis)."""
    cache = build_plan_cache(world, params, s)
    lite = world_lite(world)
    st = initial_cached_state(world, s)
    per_step = []
    for _ in range(n_steps):
        st, m = step_cached(st, lite, cache, params, s, v_dt=v_dt)
        per_step.append(m)
    return st, stack_metrics(per_step)
