"""Closed-loop exploration engine (mirror of ``aosx/engine.py``).

perceive -> GVD graph -> waypoints run once per map (``prepare_world``),
then each ``step`` runs
    control mode update  (aos_state_machine_node)
    mission FSM + replan (aos_path_gen_node)
    path linearization   (aos_path_linearization_node)
    robot kinematics     (a simple unicycle stand-in)
``episode`` is a Python loop over ``step``; ``replay_episode`` runs it over
a growing map, rebuilding the world from scratch at every frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import AosParams, Statics
from .geom import atan2, cos, sin, wrap_angle
from .guards import GUARD_NONFINITE, GUARD_PLAN_CAP
from .ops import lanes, take_row
from .gvd.graph import build_gvd_graph
from .perceive.pipeline import PerceiveOut, perceive
from .plan.astar import CsrCosts, cost_matrix
from .plan.control import control_tick, on_path
from .plan.linearize import linearize
from .plan.mission import (
    build_waypoints,
    current_cluster_index,
    mission_tick,
    plan_current_path,
    rebuild_waypoints,
    trim_distance_plane,
)
from .types import (
    ControlState,
    GridWorld,
    GvdGraph,
    MissionState,
    Path,
    PointCloud,
    Polygon,
    Waypoints,
)


@dataclasses.dataclass(frozen=True)
class World:
    """Static per-episode data (one map)."""

    skeleton: GridWorld
    occupancy: GridWorld
    graph: GvdGraph
    costmat: CsrCosts
    waypoints: Waypoints
    guards: torch.Tensor
    # per-cell distance to the skeleton within the trim cap
    # (plan.mission.trim_distance_plane)
    trim_skel: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Robot:
    xy: torch.Tensor
    yaw: torch.Tensor
    # monotone plan-follow progress: the smallest plan index _move_robot
    # may snap to (see aosx.engine.Robot); reset when the plan changes
    follow_i: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineState:
    robot: Robot
    mission: MissionState
    control: ControlState
    wp: Waypoints          # mutates when the origin is appended
    plan: Path             # linearized /plan
    raw_path: Path         # /aos/path
    last_mod: torch.Tensor
    t: torch.Tensor


def prepare_world_full(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
                       s: Statics, *, ror_method: str = "sorted"):
    """One full perception + graph pass over a static map. Returns
    (World, PerceiveOut)."""
    out = perceive(pc, poly, params, exclusions, s, ror_method=ror_method)
    return world_from_perceive(out, params, s), out


def world_from_perceive(out: PerceiveOut, params: AosParams, s: Statics) -> World:
    """Graph + costmat + waypoints + trim plane from a PerceiveOut."""
    graph = build_gvd_graph(out.seeds, out.rows_sorted, out.skeleton, params, s)
    costmat = cost_matrix(graph, s)
    return World(
        skeleton=out.skeleton,
        occupancy=out.occupancy,
        graph=graph,
        costmat=costmat,
        waypoints=build_waypoints(graph, params, s),
        guards=out.guards | graph.guards | costmat.guards,
        trim_skel=trim_distance_plane(out.skeleton, s),
    )


def prepare_world(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
                  s: Statics, *, ror_method: str = "sorted") -> World:
    """One full perception + graph pass over a static map."""
    return prepare_world_full(pc, poly, params, exclusions, s, ror_method=ror_method)[0]


def initial_state(world: World, s: Statics) -> EngineState:
    dev = world.graph.nodes.device
    P, Q = s.max_path, s.max_plan

    def empty(n):
        return Path(xy=torch.zeros((n, 2), dtype=torch.float32, device=dev),
                    yaw=torch.zeros(n, dtype=torch.float32, device=dev),
                    count=torch.zeros((), dtype=torch.int32, device=dev))

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    return EngineState(
        robot=Robot(xy=torch.zeros(2, dtype=torch.float32, device=dev),
                    yaw=torch.zeros((), dtype=torch.float32, device=dev),
                    follow_i=zero_i),
        mission=MissionState.initial(dev),
        control=ControlState.initial(dev),
        wp=world.waypoints,
        plan=empty(Q),
        raw_path=empty(P),
        last_mod=torch.full((), 3, dtype=torch.int32, device=dev),
        t=zero_i,
    )


def _move_robot(robot: Robot, mod, plan: Path, goal_xy, goal_yaw, v_dt=0.12, yaw_rate=0.6):
    """Minimal unicycle stand-in for the external controller: follow the
    plan in mode 0, converge on the goal pose in modes 1/2, freeze in 3.
    Every leaf may carry leading lane axes; reductions run over a lane's own
    plan axis, and two-term sums are written out, so a lane's result equals
    the single-lane call's bit for bit."""
    dev = plan.xy.device
    Q = plan.xy.shape[-2]
    v_dt = torch.as_tensor(v_dt, dtype=torch.float32, device=dev)
    yaw_rate = torch.as_tensor(yaw_rate, dtype=torch.float32, device=dev)
    far = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    idx = torch.arange(Q, device=dev)
    dp = plan.xy - robot.xy[..., None, :]
    d = torch.sqrt(dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1])
    # monotone window; the global search when the window is empty
    live_g = idx < plan.count[..., None]
    live_w = live_g & (idx >= robot.follow_i[..., None])
    ci = torch.where(live_w.any(dim=-1), torch.argmin(torch.where(live_w, d, far), dim=-1),
                     torch.argmin(torch.where(live_g, d, far), dim=-1))
    look = torch.minimum(ci + 10, torch.clamp(plan.count - 1, min=0))
    follow_tgt = take_row(plan.xy, look)

    tgt = torch.where(lanes(mod == 0, goal_xy), follow_tgt, goal_xy)
    delta = tgt - robot.xy
    dist = torch.sqrt(delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1])
    step = torch.minimum(v_dt, dist)
    move = torch.where((dist > 1e-6)[..., None],
                       delta / torch.clamp(dist, min=1e-6)[..., None] * step[..., None],
                       torch.zeros_like(delta))
    new_xy = torch.where(lanes(mod == 3, delta), robot.xy, robot.xy + move)

    heading = atan2(delta[..., 1], delta[..., 0])
    desired = torch.where((mod == 1) | (mod == 2) | (dist <= 1e-6),
                          torch.where(dist < 0.3, goal_yaw, heading), heading)
    dyaw = atan2(sin(desired - robot.yaw), cos(desired - robot.yaw))
    new_yaw = torch.where(mod == 3, robot.yaw,
                          robot.yaw + torch.minimum(torch.maximum(dyaw, -yaw_rate), yaw_rate))
    return Robot(xy=new_xy, yaw=wrap_angle(new_yaw), follow_i=ci.to(torch.int32))


def step(state: EngineState, world: World, params: AosParams, s: Statics, *, v_dt=0.12):
    """One engine tick. Returns (state, metrics dict)."""
    # 1. control tick on the current /plan (odometry message equivalent)
    ctrl = on_path(state.control, state.plan)
    ctrl, fired, mod, goal_xy, goal_yaw = control_tick(ctrl, state.robot.xy, state.robot.yaw, params)
    mod_pub = torch.where(fired | ~ctrl.goal_initialized, mod, state.last_mod)

    # 2. mission FSM + replanning
    mission, wp, should_replan = mission_tick(state.mission, state.wp, state.robot.xy,
                                              mod_pub, params)
    raw, success = plan_current_path(mission, wp, world.graph, world.costmat,
                                     world.skeleton, params, s, trim_plane=world.trim_skel)
    # keep the last path when frozen or failed (cpp:265-271, 1036-1043)
    use_new = should_replan & success
    raw_path = Path(
        xy=torch.where(use_new, raw.xy, state.raw_path.xy),
        yaw=torch.where(use_new, raw.yaw, state.raw_path.yaw),
        count=torch.where(use_new, raw.count, state.raw_path.count),
    )
    plan_path = linearize(raw_path, params, s)
    status = torch.where(mission.status == 3, 3,
                         torch.where(mission.status == 2, 2,
                                     torch.where(success, 0, 1))).to(torch.int32)
    mission = dataclasses.replace(mission, status=status)

    # 3. robot kinematics; the follower's progress index resets when the
    # adopted plan's CONTENT changes (bitwise, so NaN compares as equal)
    raw_bits = raw.xy.view(torch.int32)
    old_bits = state.raw_path.xy.view(torch.int32)
    content_changed = use_new & ((raw.count != state.raw_path.count)
                                 | (raw_bits != old_bits).any())
    robot_in = dataclasses.replace(
        state.robot,
        follow_i=torch.where(content_changed, 0, state.robot.follow_i).to(torch.int32))
    robot = _move_robot(robot_in, mod_pub, plan_path, ctrl.goal_xy, ctrl.goal_yaw, v_dt=v_dt)

    new_state = EngineState(robot=robot, mission=mission, control=ctrl, wp=wp,
                            plan=plan_path, raw_path=raw_path, last_mod=mod_pub,
                            t=state.t + 1)

    nonfinite = ((~torch.isfinite(robot.xy)).sum(dtype=torch.int32)
                 + (~torch.isfinite(plan_path.xy)).sum(dtype=torch.int32)
                 + (~torch.isfinite(raw_path.xy)).sum(dtype=torch.int32)
                 + (~torch.isfinite(ctrl.goal_xy)).sum(dtype=torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=nonfinite.device)
    # a /plan that fills max_plan was almost certainly truncated by
    # linearize's fixed buffer
    plan_capped = plan_path.count >= s.max_plan
    metrics = dict(
        xy=robot.xy,
        yaw=robot.yaw,
        mod=mod_pub,
        status=status,
        target_wp=mission.target_wp,
        cluster_idx=current_cluster_index(mission.target_wp, world.graph),
        waiting=mission.waiting_for_docking,
        completed=mission.exploration_completed,
        plan_len=plan_path.count,
        nonfinite=nonfinite,
        guards=world.guards
        | torch.where(nonfinite > 0, GUARD_NONFINITE, zero)
        | torch.where(plan_capped, GUARD_PLAN_CAP, zero),
    )
    return new_state, metrics


def frame(pc_frames: PointCloud, f: int) -> PointCloud:
    """Frame f of a stacked [F, ...] snapshot sequence."""
    return PointCloud(xyz=pc_frames.xyz[f], valid=pc_frames.valid[f])


def stack_metrics(per_step):
    """A list of per-tick metric dicts stacked along a leading axis."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def replay_episode(pc_frames: PointCloud, poly: Polygon, params: AosParams, exclusions,
                   s: Statics, steps_per_frame: int, *, ror_method: str = "sorted"):
    """Dynamic-map closed loop: per map frame, the full perceive -> GVD ->
    waypoints pass (the reference recomputes the graph on every map update,
    aos_gvd_node.cpp:152-177), the mission target restored across the
    rebuild (aos_path_gen_node.cpp:456-560), then ``steps_per_frame`` ticks.
    pc_frames holds stacked [F, ...] snapshots. Returns (final state,
    per-frame metrics stacked [F, steps_per_frame, ...])."""
    world0 = prepare_world(frame(pc_frames, 0), poly, params, exclusions, s,
                           ror_method=ror_method)
    st = initial_state(world0, s)
    per_frame = []
    for f in range(pc_frames.xyz.shape[0]):
        world = prepare_world(frame(pc_frames, f), poly, params, exclusions, s,
                              ror_method=ror_method)
        mission, wp = rebuild_waypoints(st.mission, st.wp, world.graph, params, s)
        st = dataclasses.replace(st, mission=mission, wp=wp)
        per_step = []
        for _ in range(steps_per_frame):
            st, m = step(st, world, params, s)
            per_step.append(m)
        per_frame.append(stack_metrics(per_step))
    return st, stack_metrics(per_frame)


def episode(world: World, params: AosParams, s: Statics, n_steps: int, *, v_dt=0.12):
    """Closed-loop rollout as a Python loop. Returns (final state, per-step
    metrics stacked along a leading axis)."""
    st = initial_state(world, s)
    per_step = []
    for _ in range(n_steps):
        st, m = step(st, world, params, s, v_dt=v_dt)
        per_step.append(m)
    return st, stack_metrics(per_step)
