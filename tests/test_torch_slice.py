"""The slice end to end: bench.py's ``stage_full`` composition (perceive ->
GVD graph -> costs -> waypoints + trim plane) and then 20 ticks of
``engine.step``, the port against the JAX package on one numpy orchard.

The robot runs at v_dt = 0.5 m/tick (the engine's own knob for shortening
episodes) so that it reaches the (8, 0) initial waypoint and adopts graph
paths within the 20 ticks.

Every leaf is bitwise, floats included: the port evaluates linearize (its
blocked prefix sums and fused multiply-adds), atan2, sin, cos and the
follower's norms and move as XLA:CPU does (``ops.cumsum_xla``, ``ops.fma``,
``f32math``); while it did not, ``plan.xy`` and the yaws carried 4-ulp
bounds. The JAX side runs as ``aosx.dashboard`` runs an episode, the ticks
in one jitted ``engine.episode`` (a scan), the context whose rounding of the
follower's move the port follows (engine._move_robot)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from aosx import engine as jengine
from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import engine
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.types import PointCloud, Polygon
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401

V_DT = 0.5
TICKS = 20


@pytest.fixture(scope="module")
def runs():
    buf, valid, poly = orchard_buffers(S, seed=0)
    jp = jparams(JParams())
    jworld = jax.jit(lambda pc, poly, p, ex: jengine.prepare_world(pc, poly, p, ex, JS))(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jp, jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    jst, jstacked = jax.jit(lambda w, p: jengine.episode(w, p, JS, TICKS,
                                                          v_dt=jnp.float32(V_DT)))(jworld, jp)
    jmetrics = [{k: v[t] for k, v in jstacked.items()} for t in range(TICKS)]

    pt = params_as_f32(AosParams(), "cpu")
    world = engine.prepare_world(
        PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
        Polygon.from_array(poly, S, "cpu"), pt, torch.zeros((S.max_exclusions, 3)), S)
    st, stacked = engine.episode(world, pt, S, TICKS, v_dt=V_DT)
    metrics = [{k: v[t] for k, v in stacked.items()} for t in range(TICKS)]
    return (jworld, jst, jmetrics), (world, st, metrics)


def test_world_matches_jax(runs):
    (jworld, _, _), (world, _, _) = runs
    assert_same(jworld, world)
    assert int(world.guards) == 0 and int(world.waypoints.count) >= 4


@pytest.mark.parametrize("tick", range(TICKS))
def test_step_metrics_match_jax(runs, tick):
    (_, _, jmetrics), (_, _, metrics) = runs
    assert_same(jmetrics[tick], metrics[tick])


def test_final_state_matches_jax(runs):
    (_, jst, jm), (_, st, m) = runs
    assert_same(jst, st)
    # the tour has started: the initial waypoint was reached and a graph
    # path adopted
    assert bool(st.mission.initial_reached)
    assert len({int(x["plan_len"]) for x in m}) > 1
