"""The /aos/next_waypoint service of the port (``force_next_waypoint``) and
``plan_current_path(use_current_position=)`` against the JAX package.

Cases: the mission states of tests/test_mission_fsm.py's
test_force_next_waypoint and every other branch of the service (unstarted,
mid-tour, at the last waypoint, not yet at the initial waypoint, a tour
whose last waypoint is the origin already), each returning the state, the
tour and the plan-from-here flag bitwise; then, on the test orchard's world,
the service followed by a plan from the robot's position, for every
waypoint of the tour, bitwise, the path's yaws included (XLA:CPU's f32
atan2 is glibc's atanf-based atan2f, ``f32math.atan2_f32``; the yaws carried
a 4-ulp bound while the port rounded an f64 atan2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aosx.config as jc
from aosx import engine as jengine
from aosx.plan.mission import force_next_waypoint as jforce, plan_current_path as jplan
from aosx.types import (MissionState as JMission, PointCloud as JCloud, Polygon as JPolygon,
                        Waypoints as JWaypoints)
from aosx_torch import engine
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_torch
from aosx_torch.perceive.pipeline import PerceiveOut
from aosx_torch.plan.mission import force_next_waypoint, plan_current_path
from aosx_torch.types import MissionState, Waypoints
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401


def _wp(points):
    W = S.max_waypoints
    xy = np.zeros((W, 2), np.float32)
    xy[:len(points)] = np.asarray(points, np.float32).reshape(-1, 2)
    ni = np.full(W, -1, np.int32)
    ni[:len(points)] = np.arange(len(points))
    return xy, ni, len(points)


def _pair(points, **kw):
    """(JAX state, JAX tour, port state, port tour) of one case."""
    xy, ni, n = _wp(points)
    jwp = JWaypoints(xy=jnp.asarray(xy), node_idx=jnp.asarray(ni), count=jnp.int32(n))
    wp = Waypoints(xy=torch.from_numpy(xy), node_idx=torch.from_numpy(ni),
                   count=torch.tensor(n, dtype=torch.int32))
    jst = dataclasses.replace(JMission.initial(), **{k: jnp.asarray(v) for k, v in kw.items()})
    st = dataclasses.replace(MissionState.initial("cpu"), **{
        k: torch.tensor(v, dtype=torch.bool if isinstance(v, bool) else torch.int32)
        for k, v in kw.items()})
    return jst, jwp, st, wp


TOUR = [[10.0, 5.0], [12.0, 5.0], [14.0, 5.0]]
CASES = {
    "mid_docking": (TOUR, dict(initial_reached=True, target_wp=np.int32(0),
                               prev_wp=np.int32(-1), waiting_for_docking=True)),
    "at_last": (TOUR, dict(initial_reached=True, target_wp=np.int32(2), prev_wp=np.int32(1))),
    "not_ready": (TOUR, {}),
    "unstarted": (TOUR, dict(initial_reached=True, target_wp=np.int32(-1))),
    "origin_last": ([[10.0, 5.0], [0.05, 0.05]],
                    dict(initial_reached=True, target_wp=np.int32(1), prev_wp=np.int32(0),
                         status=np.int32(0))),
    "empty_tour": ([], dict(initial_reached=True, target_wp=np.int32(-1))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_force_next_waypoint_matches_jax(case):
    points, kw = CASES[case]
    jst, jwp, st, wp = _pair(points, **kw)
    jp = jc.params_as_f32(jc.AosParams())
    ref = jax.jit(jforce)(jst, jwp, jp)
    got = force_next_waypoint(st, wp, params_as_f32(AosParams(), "cpu"))
    assert_same(list(ref), list(got))
    if case == "mid_docking":  # tests/test_mission_fsm.py's expectations
        assert int(got[0].target_wp) == 1 and int(got[0].prev_wp) == 0
        assert not bool(got[0].waiting_for_docking) and bool(got[2])
    if case == "at_last":
        assert bool(got[0].exploration_completed) and int(got[1].count) == 4
    if case == "not_ready":
        assert int(got[0].target_wp) == -1 and not bool(got[2])


def test_service_then_plan_from_current_position_matches_jax():
    """On the test orchard's world: for each waypoint of the tour, force the
    next one and plan from a position beside the robot's current target."""
    JS = jc.TEST_STATICS
    buf, valid, poly = orchard_buffers(S, seed=0)
    jp = jc.params_as_f32(jc.AosParams())
    jworld, jout, _ = jax.jit(lambda pc, pl, p, ex: jengine.prepare_world_full(pc, pl, p, ex, JS))(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jp, jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    pt = params_as_f32(AosParams(), "cpu")
    world = engine.world_from_perceive(to_torch(jout, PerceiveOut, "cpu"), pt, S)
    assert_same(jworld, world)

    def jstep(st, wp, here):
        st, wp, from_here = jforce(st, wp, jp)
        path, ok = jplan(st, wp, jworld.graph, jworld.costmat, jworld.skeleton, jp, JS,
                         use_current_position=here, trim_plane=jworld.trim_skel)
        return st, wp, from_here, path, ok

    jstep = jax.jit(jstep)
    jst = dataclasses.replace(JMission.initial(), initial_reached=jnp.bool_(True))
    st = dataclasses.replace(MissionState.initial("cpu"), initial_reached=torch.tensor(True))
    jwp, wp = jworld.waypoints, world.waypoints
    n = int(wp.count)
    planned = 0
    for i in range(n + 1):
        here = np.asarray(world.waypoints.xy[min(i, n - 1)], np.float32) + np.float32(0.3)
        jst, jwp, jfrom, jpath, jok = jstep(jst, jwp, jnp.asarray(here))
        st, wp, from_here = force_next_waypoint(st, wp, pt)
        path, ok = plan_current_path(st, wp, world.graph, world.costmat, world.skeleton, pt, S,
                                     trim_plane=world.trim_skel,
                                     use_current_position=torch.from_numpy(here))
        assert_same([jst, jwp, jfrom, jpath, jok], [st, wp, from_here, path, ok])
        planned += int(bool(ok) and int(path.count) > 0)
        assert torch.equal(path.xy[0], torch.from_numpy(here)) or int(path.count) == 0
    assert planned >= n - 1 and bool(st.exploration_completed)
