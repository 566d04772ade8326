"""Closed-loop exploration engine (mirror of ``aosx/engine.py``).

perceive -> GVD graph -> waypoints run once per map (``prepare_world``),
then each ``step`` runs
    control mode update  (aos_state_machine_node)
    mission FSM + replan (aos_path_gen_node)
    path linearization   (aos_path_linearization_node)
    robot kinematics     (a simple unicycle stand-in)
``episode`` is a Python loop over ``step``; ``replay_episode`` runs it over
a growing map, rebuilding the world from scratch at every frame.

World axis: ``prepare_world``, ``prepare_world_full``, ``world_from_perceive``
and ``initial_state`` take a cloud and polygon (or a PerceiveOut) whose
leaves carry a leading world axis [G] (``aosx`` maps them with
``jax.vmap``) and build the group's worlds in one call: K1, K2 and K3
launch once a group, and each world of the result equals its unbatched
build bit for bit. ``step`` and ``episode`` take states and worlds with
leading lane axes; every reduction runs over a lane's own axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import profiling
from .config import AosParams, Statics
from .f32math import sincos_f32
from .geom import atan2, wrap_angle
from .guards import GUARD_NONFINITE, GUARD_PLAN_CAP
from .ops import card_graph, fma, lanes, norm2, take_row, vector_lanes
from .tree import tree_map
from .gvd.graph import build_gvd_graph, merge_seeds
from .gvd.voronoi import jump_flood
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
                       s: Statics, *, ror_method: str = "sorted", with_owner: bool = False,
                       stencil_mesh=None, stencil_axis: str = "space"):
    """One full perception + graph pass over a static map. Returns (World,
    PerceiveOut, owner plane or None); the extras feed the renderer's seed,
    tree-row and Voronoi-cell overlays (io/render.py). stencil_mesh:
    optional ``parallel.spatial.Mesh``, over whose devices the grid stencils
    and the flood run on row bands (bitwise equal). With a world axis on
    the cloud and polygon (xyz [G, N, 3]; exclusions [E, 3] for every world
    or [G, E, 3]) every leaf of the result carries it; a mesh does not take
    one (no ``aosx`` caller combines the two)."""
    if stencil_mesh is not None and pc.xyz.dim() > 2:
        raise ValueError("prepare_world: stencil_mesh does not take a world axis")
    out = perceive(pc, poly, params, exclusions, s, ror_method=ror_method,
                   stencil_mesh=stencil_mesh, stencil_axis=stencil_axis)
    world = world_from_perceive(out, params, s, stencil_mesh=stencil_mesh,
                                stencil_axis=stencil_axis)
    return world, out, owner_plane(out, params, s) if with_owner else None


def owner_plane(out: PerceiveOut, params: AosParams, s: Statics):
    """The Voronoi ownership plane (i32 [H, W], seed index or -1) of the
    merged seeds over the skeleton: the renderer's cell overlay."""
    return jump_flood(out.skeleton, merge_seeds(out.seeds, params, s), s)


def world_from_perceive(out: PerceiveOut, params: AosParams, s: Statics, *,
                        stencil_mesh=None, stencil_axis: str = "space") -> World:
    """Graph + costmat + waypoints + trim plane from a PerceiveOut (with or
    without a leading world axis): one ``gvd`` span (``profiling``)."""
    with profiling.span("gvd"):
        graph = build_gvd_graph(out.seeds, out.rows_sorted, out.skeleton, params, s,
                                stencil_mesh=stencil_mesh, stencil_axis=stencil_axis)
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
                  s: Statics, *, ror_method: str = "sorted", stencil_mesh=None,
                  stencil_axis: str = "space") -> World:
    """One full perception + graph pass over a static map, or over a group
    of maps with a leading world axis [G] (one call, every world bitwise
    its unbatched build)."""
    return prepare_world_full(pc, poly, params, exclusions, s, ror_method=ror_method,
                              stencil_mesh=stencil_mesh, stencil_axis=stencil_axis)[0]


def initial_state(world: World, s: Statics) -> EngineState:
    """The state before the first tick; with a world axis on ``world``
    every leaf carries it."""
    dev = world.graph.nodes.device
    B = world.graph.num_nodes.shape
    P, Q = s.max_path, s.max_plan

    def lanes_of(t):
        return tree_map(lambda x: x.expand(B + x.shape).clone(), t)

    def empty(n):
        return Path(xy=torch.zeros(B + (n, 2), dtype=torch.float32, device=dev),
                    yaw=torch.zeros(B + (n,), dtype=torch.float32, device=dev),
                    count=torch.zeros(B, dtype=torch.int32, device=dev))

    zero_i = torch.zeros(B, dtype=torch.int32, device=dev)
    return EngineState(
        robot=Robot(xy=torch.zeros(B + (2,), dtype=torch.float32, device=dev),
                    yaw=torch.zeros(B, dtype=torch.float32, device=dev),
                    follow_i=zero_i),
        mission=lanes_of(MissionState.initial(dev)),
        control=lanes_of(ControlState.initial(dev)),
        wp=world.waypoints,
        plan=empty(Q),
        raw_path=empty(P),
        last_mod=torch.full(B, 3, dtype=torch.int32, device=dev),
        t=zero_i,
    )


def _drive_form(fuse_y: bool):
    """The follower's step (``_drive``) with the y move fused or not."""

    @card_graph
    def drive(tgt, xy, yaw, mod, goal_yaw, v_dt, yaw_rate):
        """The follower's move toward tgt and its turn toward the look-ahead
        point (mode 0, or farther than 1e-6 from the goal) or the goal's yaw
        (modes 1 and 2 within 0.3 m); mode 3 freezes. Returns (xy, yaw).
        XLA:CPU's f32 arithmetic (the fused norm and move, glibc's atan2f,
        sinf and cosf, the jitted wrap), about 230 small kernels, replayed
        on the card as one CUDA graph (``card_graph``)."""
        delta = tgt - xy
        dist = norm2(delta)
        step = torch.minimum(v_dt, dist)
        # xy + (delta / dist) * step, rounded as XLA:CPU compiles it. Where
        # the reference steps one rollout in a scan (engine.episode,
        # rollout_chunk[_cached], the serving loop) its code for the two
        # coordinates branches on the moving test: x's product reaches its
        # add in the same block and is fused into it, y's through a phi
        # after the branches and is not. Under vmap over two lanes or more
        # (the harness's chunk) each lane's block holds both adds, and both
        # are fused (jit(step) fuses both too; tests/test_torch_step_batch.py)
        unit = delta / torch.clamp(dist, min=1e-6)[..., None]
        y = fma(unit[..., 1], step, xy[..., 1]) if fuse_y else xy[..., 1] + unit[..., 1] * step
        moved = torch.stack([fma(unit[..., 0], step, xy[..., 0]), y], dim=-1)
        moved = torch.where((dist > 1e-6)[..., None], moved, xy + 0.0)
        new_xy = torch.where(lanes(mod == 3, delta), xy, moved)

        heading = atan2(delta[..., 1], delta[..., 0])
        desired = torch.where((mod == 1) | (mod == 2) | (dist <= 1e-6),
                              torch.where(dist < 0.3, goal_yaw, heading), heading)
        # desired and yaw lie in [-pi, pi] (atan2, and wrap_angle below), so
        # their difference is within +-2 pi, inside sin's and cos's |x| < 120
        # (no host check)
        dyaw = atan2(*sincos_f32(desired - yaw, check=False))
        new_yaw = torch.where(mod == 3, yaw, yaw + torch.minimum(torch.maximum(dyaw, -yaw_rate),
                                                                   yaw_rate))
        return new_xy, wrap_angle(new_yaw)

    return drive


_drive = _drive_form(False)
_drive_vmapped = _drive_form(True)


def _f32_on(v, dev):
    """v as an f32 tensor on ``dev``; a Python number is filled on the
    device, with no copy from the host (a CUDA graph captures it)."""
    if torch.is_tensor(v):
        return v.to(dev, torch.float32)
    return torch.full((), v, dtype=torch.float32, device=dev)


def _move_robot(robot: Robot, mod, plan: Path, goal_xy, goal_yaw, v_dt=0.12, yaw_rate=0.6,
                vmapped: bool = False):
    """Minimal unicycle stand-in for the external controller: follow the
    plan in mode 0, converge on the goal pose in modes 1/2, freeze in 3.
    Every leaf may carry leading lane axes; reductions run over a lane's own
    plan axis, and two-term sums are written out, so a lane's result equals
    the single-lane call's bit for bit. vmapped: round the move as XLA:CPU
    does under ``jax.vmap`` over two lanes or more (``_drive``)."""
    dev = plan.xy.device
    Q = plan.xy.shape[-2]
    far = 3.4e38    # f32 on the select, as the reference's f32 constant
    idx = torch.arange(Q, device=dev)
    dp = plan.xy - robot.xy[..., None, :]
    d = norm2(dp)
    # monotone window; the global search when the window is empty
    live_g = idx < plan.count[..., None]
    live_w = live_g & (idx >= robot.follow_i[..., None])
    ci = torch.where(live_w.any(dim=-1), torch.argmin(torch.where(live_w, d, far), dim=-1),
                     torch.argmin(torch.where(live_g, d, far), dim=-1))
    look = torch.minimum(ci + 10, torch.clamp(plan.count - 1, min=0))
    follow_tgt = take_row(plan.xy, look)

    tgt = torch.where(lanes(mod == 0, goal_xy), follow_tgt, goal_xy)
    drive = _drive_vmapped if vmapped else _drive
    new_xy, new_yaw = drive(tgt, robot.xy, robot.yaw, torch.as_tensor(mod, device=dev),
                            goal_yaw, _f32_on(v_dt, dev), _f32_on(yaw_rate, dev))
    return Robot(xy=new_xy, yaw=new_yaw, follow_i=ci.to(torch.int32))


def vmap_forms(vmap_lanes: int):
    """(vmapped, vector lanes of the control, mission and plan distances) of
    a tick that follows XLA:CPU's rounding of ``jax.vmap`` over
    ``vmap_lanes`` lanes (the Monte-Carlo harness's chunk); 0 or 1: one
    rollout's scan (a vmap over one lane rounds as the scan does)."""
    if vmap_lanes < 2:
        return False, None
    return True, vector_lanes(vmap_lanes)


def step(state: EngineState, world: World, params: AosParams, s: Statics, *, v_dt=0.12,
         vmap_lanes: int = 0):
    """One engine tick. Returns (state, metrics dict). Every leaf of the
    state and the world (and every field of params) may carry leading lane
    axes; each lane runs the single-lane tick bit for bit, its reductions
    over its own axes. vmap_lanes: round as ``jax.vmap`` of the tick over
    that many lanes, the leading axis (``vmap_forms``), where a lane's bits
    depend on its index; 0: as one rollout's scan."""
    vmapped, vector = vmap_forms(vmap_lanes)
    # 1. control tick on the current /plan (odometry message equivalent)
    ctrl = on_path(state.control, state.plan)
    ctrl, fired, mod, goal_xy, goal_yaw = control_tick(ctrl, state.robot.xy, state.robot.yaw,
                                                       params, vector=vector)
    mod_pub = torch.where(fired | ~ctrl.goal_initialized, mod, state.last_mod)

    # 2. mission FSM + replanning
    mission, wp, should_replan = mission_tick(state.mission, state.wp, state.robot.xy,
                                              mod_pub, params, vector=vector)
    raw, success = plan_current_path(mission, wp, world.graph, world.costmat,
                                     world.skeleton, params, s, trim_plane=world.trim_skel,
                                     vector=vector)
    # keep the last path when frozen or failed (cpp:265-271, 1036-1043)
    use_new = should_replan & success
    raw_path = Path(
        xy=torch.where(lanes(use_new, raw.xy), raw.xy, state.raw_path.xy),
        yaw=torch.where(lanes(use_new, raw.yaw), raw.yaw, state.raw_path.yaw),
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
                                 | (raw_bits != old_bits).flatten(-2).any(dim=-1))
    robot_in = dataclasses.replace(
        state.robot,
        follow_i=torch.where(content_changed, 0, state.robot.follow_i).to(torch.int32))
    robot = _move_robot(robot_in, mod_pub, plan_path, ctrl.goal_xy, ctrl.goal_yaw, v_dt=v_dt,
                        vmapped=vmapped)

    new_state = EngineState(robot=robot, mission=mission, control=ctrl, wp=wp,
                            plan=plan_path, raw_path=raw_path, last_mod=mod_pub,
                            t=state.t + 1)

    def n_nonfinite(x, axes):
        return (~torch.isfinite(x)).sum(dim=axes, dtype=torch.int32)

    nonfinite = (n_nonfinite(robot.xy, -1)
                 + n_nonfinite(plan_path.xy, (-2, -1))
                 + n_nonfinite(raw_path.xy, (-2, -1))
                 + n_nonfinite(ctrl.goal_xy, -1))
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
    metrics stacked along a leading axis). A world with leading lane axes
    runs every lane's episode in the same ticks (metrics [n_steps, *B, ...])."""
    st = initial_state(world, s)
    per_step = []
    for _ in range(n_steps):
        st, m = step(st, world, params, s, v_dt=v_dt)
        per_step.append(m)
    return st, stack_metrics(per_step)
