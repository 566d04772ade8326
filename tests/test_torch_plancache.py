"""The plan cache (``plan/plancache.py``) at TEST_STATICS: the port's cache
built on a JAX world equals the JAX package's leaf for leaf, the port's
cached episode equals JAX's, and the port's cached episode equals its own
replan-every-tick ``engine.episode`` (the bit-identity that
``aosx/plan/plancache.py`` promises).

Every leaf is bitwise, floats included: the cache's plan points and yaws,
the ``xy``/``yaw`` metrics and the final pose (the port evaluates linearize,
A* and the follower as XLA:CPU does: ``ops.cumsum_xla``, ``ops.fma``,
``f32math.atan2_f32``; these carried 4-ulp bounds while it did not). The
robot runs at v_dt = 0.5 m/tick, so that 40 ticks reach the first
waypoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.plan import plancache as jplancache
from aosx.types import MissionState as JMission, PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import engine
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_torch
from aosx_torch.plan import plancache
from aosx_torch.types import MissionState
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401

V_DT = 0.5
TICKS = 40


@pytest.fixture(scope="module")
def runs():
    buf, valid, poly = orchard_buffers(S, seed=0)
    jp = jparams(JParams())
    jworld = jax.jit(lambda pc, poly, p, ex: jengine.prepare_world(pc, poly, p, ex, JS))(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jp, jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    jcache = jax.jit(lambda w, p: jplancache.build_plan_cache(w, p, JS))(jworld, jp)
    jfinal, jmetrics = jax.jit(lambda w, p: jplancache.episode_cached(
        w, p, JS, TICKS, v_dt=jnp.float32(V_DT)))(jworld, jp)

    pt = params_as_f32(AosParams(), "cpu")
    world = to_torch(jworld, engine.World, "cpu")
    cache = plancache.build_plan_cache(world, pt, S)
    final, metrics = plancache.episode_cached(world, pt, S, TICKS, v_dt=V_DT)
    return dict(jworld=jworld, jp=jp, jcache=jcache, jfinal=jfinal, jmetrics=jmetrics,
                world=world, pt=pt, cache=cache, final=final, metrics=metrics)


def test_build_plan_cache_matches_jax(runs):
    assert_same(runs["jcache"], runs["cache"])
    cache = runs["cache"]
    R = plancache.num_rows(S)
    assert cache.plan_xy.shape == (R, S.max_plan, 2)
    # the straight row and several tour legs plan; the empty row never does
    assert bool(cache.success[0]) and int(cache.success.sum()) >= 4
    assert not bool(cache.success[R - 1]) and int(cache.plan_count[R - 1]) == 0


@pytest.mark.parametrize("key", ["xy", "yaw", "mod", "status", "target_wp", "cluster_idx",
                                 "waiting", "completed", "plan_len", "nonfinite", "guards"])
def test_episode_cached_metrics_match_jax(runs, key):
    assert_same(runs["jmetrics"][key], runs["metrics"][key])


def test_episode_cached_final_state_matches_jax(runs):
    assert_same(runs["jfinal"], runs["final"])
    # the tour has started: the initial waypoint was reached and a graph
    # leg adopted
    assert bool(runs["final"].mission.initial_reached)
    assert int(runs["final"].adopted) >= 1


def test_episode_cached_equals_replanning_episode(runs):
    """The port's cached episode equals its own engine.episode bitwise:
    every metric, the mission and control state, and the adopted row's plan
    equals the engine's carried plan."""
    final, metrics = engine.episode(runs["world"], runs["pt"], S, TICKS, v_dt=V_DT)
    assert_same(metrics, runs["metrics"])
    fc = runs["final"]
    assert_same([final.robot, final.mission, final.control, final.wp, final.last_mod, final.t],
                [fc.robot, fc.mission, fc.control, fc.wp, fc.last_mod, fc.t])
    a = int(fc.adopted)
    assert torch.equal(runs["cache"].plan_xy[a].view(torch.int32), final.plan.xy.view(torch.int32))
    assert int(runs["cache"].plan_count[a]) == int(final.plan.count)


def test_plan_rows_linearize_to_the_cache(runs):
    """plan_rows gives the raw path of every row 0..W+3; linearized they are
    the cache's rows, and the f64 witness of chip_smoke.py phase 7
    (torch_reference/linearize_f64.py) splits every row of this world near
    the origin, where f32 is well-conditioned, where the port does."""
    from aosx_torch.plan.linearize import breakpoint_mask, linearize
    from torch_reference.linearize_f64 import breakpoints

    rows = plancache.plan_rows(runs["world"], runs["pt"], S)
    cache = runs["cache"]
    assert len(rows) == plancache.num_rows(S) - 1
    for r, (raw, success) in enumerate(rows):
        plan = linearize(raw, runs["pt"], S)
        assert torch.equal(plan.xy, cache.plan_xy[r]) and bool(success) == bool(cache.success[r])
        assert int(plan.count) == int(cache.plan_count[r])
        port = torch.nonzero(breakpoint_mask(raw, runs["pt"], S)).flatten().tolist()
        assert breakpoints(raw.xy.numpy(), raw.count, max_segments=S.max_segments) == port, r
    # regression splits ran: rows of more than 4 points with a breakpoint
    assert sum(int(raw.count) > 4 and len(breakpoints(raw.xy.numpy(), raw.count,
                                                      max_segments=S.max_segments)) > 2
               for raw, _ in rows) >= 2


def test_pin_live_row_and_rows_bitwise_equal_match_jax(runs):
    """The rebuild helpers of serving: carry row, carried adoption, the
    pinned live row of a config that breaks the prev == target - 1
    encoding, and the bitwise row compare, against the JAX package."""
    mission = dict(target_wp=2, prev_wp=0, initial_reached=True, exploration_completed=False,
                   waiting_for_docking=False, status=0, origin_appended=False)
    jm = JMission(**{k: jnp.asarray(v, jnp.bool_ if isinstance(v, bool) else jnp.int32)
                     for k, v in mission.items()})
    m = to_torch(jm, MissionState, "cpu")
    carry = plancache.num_rows(S)
    live = int(plancache.cache_row_index(m, S))
    assert live == 3 and int(jplancache.cache_row_index(jm, JS)) == live

    @jax.jit
    def jrebuild(w, p, cache):
        fresh = jplancache.add_carry_row(cache, JS)
        fresh = jplancache.carry_adopted_row(fresh, fresh, jnp.int32(live))
        fresh = jplancache.pin_live_row(fresh, w, jm, w.waypoints, p, JS)
        return fresh, jplancache.rows_bitwise_equal(fresh, carry, live)

    jfresh, jsame = jrebuild(runs["jworld"], runs["jp"], runs["jcache"])
    fresh = plancache.add_carry_row(runs["cache"], S)
    fresh = plancache.carry_adopted_row(fresh, fresh, torch.tensor(live, dtype=torch.int32))
    fresh = plancache.pin_live_row(fresh, runs["world"], m, runs["world"].waypoints, runs["pt"], S)
    same = plancache.rows_bitwise_equal(fresh, carry, live)
    assert_same(jfresh, fresh)
    # the pinned plan starts at waypoint 0, not at the row's assumed 1
    assert bool(same) == bool(jsame) and not bool(same)
    assert bool(plancache.rows_bitwise_equal(fresh, carry, carry))
    # the carry row holds the row as built; the pin replaced the live row
    built = runs["cache"].plan_xy[live]
    assert torch.equal(plancache.select_row(fresh.plan_xy, carry), built)
    assert not torch.equal(fresh.plan_xy[live], built)
