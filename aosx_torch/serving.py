"""Live serving API: drive the engine from a feed of map snapshots and
measured poses (mirror of ``aosx/serving.py``).

A deployment receives map snapshots one at a time from a running SLAM
stack (/lio_sam/mapping/global_map, aos_seed_gen_node.cpp:230) and
odometry at 10-50 Hz from the robot (aos_state_machine_node.cpp:83,
aos_path_gen_node.cpp:195):

    sv = serve_init(pc0, poly, params, exclusions, s)
    sv, level = serve_map_frame(sv, pc_f, poly, params, exclusions, s)
    sv, cmd   = serve_control_tick(sv, robot_xy, robot_yaw, params, s)

serve_map_frame runs the exact incremental world gates (``incremental``)
and rebuilds the plan cache only when the graph changed (level >= 2),
keeping the published plan across the rebuild (the carry row).
serve_control_tick takes the MEASURED pose and returns what the reference
publishes per odometry message; its decisions equal those of the closed
loop fed the same poses. ``ServeState`` is a dataclass tree, so
``io.checkpoint.save_state``/``load_state`` resume a survey mid-mission.

The JAX package's ``host_jit``/``_canon`` work around its jit dispatch and
have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import AosParams, Statics
from .engine import Robot
from .geom import wrap_angle
from .incremental import LEVEL_DOWNSTREAM, IncrementalState, perceive_init, perceive_update
from .plan import plancache
from .plan.mission import rebuild_waypoints
from .types import PointCloud, Polygon


@dataclasses.dataclass(frozen=True)
class ServeState:
    """Everything a live survey carries between messages."""

    inc: IncrementalState              # world + incremental intermediates
    cache: plancache.PlanCache         # plan cache with its carry row
    st: plancache.CachedEngineState    # mission / control / robot / adopted row
    lite: plancache.WorldLite          # derived from inc.world at world changes


def serve_init(pc: PointCloud, poly: Polygon, params: AosParams, exclusions, s: Statics,
               *, ror_method: str = "exact", stencil_mesh=None,
               stencil_axis: str = "space") -> ServeState:
    """First map snapshot: the from-scratch world and its plan cache.
    stencil_mesh: optional ``parallel.spatial.Mesh`` for the grid stencils
    and the flood of the world updates (bitwise equal;
    incremental.perceive_init)."""
    inc0 = perceive_init(pc, poly, params, exclusions, s, ror_method=ror_method,
                         stencil_mesh=stencil_mesh, stencil_axis=stencil_axis)
    cache0 = plancache.add_carry_row(plancache.build_plan_cache(inc0.world, params, s), s)
    return ServeState(inc=inc0, cache=cache0,
                      st=plancache.initial_cached_state(inc0.world, s),
                      lite=plancache.world_lite(inc0.world))


def serve_map_frame(sv: ServeState, pc_f: PointCloud, poly: Polygon, params: AosParams,
                    exclusions, s: Statics, *, ror_method: str = "exact", stencil_mesh=None,
                    stencil_axis: str = "space"):
    """One SLAM map message. Returns (state, level i32 tensor), the
    incremental reuse level taken (incremental.LEVEL_*).

    On a graph change (aos_path_gen_node.cpp:418-579) the waypoint tour is
    rebuilt with the target restored by position, and the plan cache is
    rebuilt with the adopted row carried over and the restored live
    config's row pinned (plancache.pin_live_row)."""
    inc, level = perceive_update(sv.inc, pc_f, poly, params, exclusions, s,
                                 ror_method=ror_method, stencil_mesh=stencil_mesh,
                                 stencil_axis=stencil_axis)
    mission, wp = rebuild_waypoints(sv.st.mission, sv.st.wp, inc.world.graph, params, s)
    cache, adopted = sv.cache, sv.st.adopted
    if int(level) >= LEVEL_DOWNSTREAM:
        fresh = plancache.add_carry_row(
            plancache.build_plan_cache(inc.world, params, s, wp_base=wp), s)
        fresh = plancache.carry_adopted_row(fresh, sv.cache, sv.st.adopted)
        fresh = plancache.pin_live_row(fresh, inc.world, mission, wp, params, s)
        # park adoption at the live row when it holds the carried plan
        # bitwise, else at the carry row: a later re-adoption then resets
        # the follower exactly when engine.step's content compare would
        carry_idx = torch.tensor(plancache.num_rows(s), dtype=torch.int32,
                                 device=adopted.device)
        live_idx = plancache.cache_row_index(mission, s)
        same = plancache.rows_bitwise_equal(fresh, carry_idx, live_idx)
        cache, adopted = fresh, torch.where(same, live_idx, carry_idx).to(torch.int32)
    st = dataclasses.replace(sv.st, mission=mission, wp=wp, adopted=adopted)
    return ServeState(inc=inc, cache=cache, st=st, lite=plancache.world_lite(inc.world)), level


def serve_control_tick(sv: ServeState, robot_xy, robot_yaw, params: AosParams, s: Statics):
    """One odometry message with the MEASURED pose. Returns (state, cmd).

    cmd carries the reference's per-tick publications: mod (/Control/mod),
    goal_xy and goal_yaw (/Planning/goal_point), plan_xy, plan_yaw and
    plan_len (the current /plan), status, target_wp, cluster_idx, waiting
    and completed (planner status), nonfinite and guards, xy/yaw echoing the
    pose acted on, and adopted (the published cache row)."""
    dev = sv.st.t.device
    # the measured pose is copied (the state never aliases the caller's
    # buffer) and its yaw wrapped to [-pi, pi] (a bitwise no-op in range)
    robot = Robot(xy=torch.as_tensor(robot_xy, dtype=torch.float32, device=dev).clone(),
                  yaw=wrap_angle(torch.as_tensor(robot_yaw, dtype=torch.float32, device=dev)),
                  follow_i=torch.zeros((), dtype=torch.int32, device=dev))
    st, metrics = plancache.step_cached(dataclasses.replace(sv.st, robot=robot), sv.lite,
                                        sv.cache, params, s, external_pose=True)
    cmd = dict(metrics, goal_xy=st.control.goal_xy, goal_yaw=st.control.goal_yaw,
               plan_yaw=plancache.select_row(sv.cache.plan_yaw, st.adopted),
               adopted=st.adopted)
    return dataclasses.replace(sv, st=st), cmd
