"""The Monte-Carlo path (``aosx_torch/parallel/batch.py`` and
``plancache.tour_feasibility``) at DRYRUN_STATICS against the JAX package's,
on the orchard of tests/test_parallel.py.

The clouds are the JAX package's own ``make_orchard(key, SPEC, S)`` for
``jax.random.split(PRNGKey(5), 8)``, read back as numpy and handed to the
port's ``clouds`` argument, so both harnesses run the same eight worlds.

Tolerances. Every int and bool field is bitwise. ``travel_distance`` is a
sequential f32 sum of one segment a tick in both packages and
``final_dist_to_origin`` one norm; the port may differ from XLA:CPU by the
rounding of a segment (XLA contracts x*x + y*y into a fused multiply-add) and
by the 4-ulp pose bound of tests/test_torch_plancache.py. FLOAT_BOUND_M
states it in metres; measured: 0 on all eight rollouts of this file (the
first 60 ticks walk the straight initial leg)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import DRYRUN_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.orchards import OrchardSpec as JSpec, make_orchard
from aosx.parallel import batch as jbatch
from aosx.plan import plancache as jplancache
from aosx import engine as jengine
from aosx_torch import tree
from aosx_torch.config import DRYRUN_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_numpy, to_torch
from aosx_torch.guards import GUARD_SKEL_OVERFLOW
from aosx_torch.orchards import OrchardSpec
from aosx_torch.parallel import batch
from aosx_torch.plan import plancache
from aosx_torch.types import Waypoints
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

SPEC_KW = dict(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
               trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
JSPEC = JSpec(**SPEC_KW)
SPEC = OrchardSpec(**SPEC_KW)
CPU = torch.device("cpu")
TOTAL, BATCH, REFILL, BUDGET, CHUNK = 8, 4, 2, 60, 20
INT_FIELDS = ("completed", "steps_to_complete", "final_status", "waypoints", "guards",
              "feasible")
FLOAT_FIELDS = ("travel_distance", "final_dist_to_origin")
# metres; 8 ulp of the 6.72 m the budget travels (measured: 0)
FLOAT_BOUND_M = 8 * float(np.spacing(np.float32(6.72)))


def cloud_of(key, s=JS):
    """The JAX package's orchard for ``key`` as the port's cloud."""
    pc, poly = jax.jit(lambda k: make_orchard(k, JSPEC, s))(key)
    valid = np.asarray(pc.valid)
    n = int(valid.sum())
    assert valid[:n].all()
    return np.asarray(pc.xyz)[:n], np.asarray(poly.pts)[:int(poly.count)]


@pytest.fixture(scope="module")
def clouds():
    return [cloud_of(k) for k in jax.random.split(jax.random.PRNGKey(5), TOTAL)]


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


@pytest.fixture(scope="module")
def jax_sustained():
    return jbatch.sustained_rollouts(TOTAL, BATCH, JSPEC, jparams(JParams()), JS, BUDGET,
                                     chunk_steps=CHUNK, refill=REFILL, seed=5,
                                     ror_method="exact", cached=True)


@pytest.fixture(scope="module")
def port_sustained(clouds, params):
    return batch.sustained_rollouts(TOTAL, BATCH, SPEC, params, S, BUDGET, chunk_steps=CHUNK,
                                    refill=REFILL, ror_method="exact", cached=True,
                                    clouds=clouds.__getitem__, device=CPU)


# ---------------------------------------------------------------------------
# tour_feasibility
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cache(clouds):
    """(JAX waypoints, JAX plan cache) of cloud 0."""
    xyz, poly = clouds[0]
    pc, _ = batch.cloud_tensors((xyz, poly), S, CPU)
    from aosx.types import PointCloud, Polygon

    jp = jparams(JParams())

    @jax.jit
    def build(pc, poly, p):
        world = jengine.prepare_world(pc, poly, p, jnp.zeros((JS.max_exclusions, 3)), JS,
                                      ror_method="exact")
        return world.waypoints, jplancache.build_plan_cache(world, p, JS)

    return build(PointCloud(xyz=jnp.asarray(pc.xyz.numpy()), valid=jnp.asarray(pc.valid.numpy())),
                 Polygon.from_array(poly, JS), jp)


@pytest.mark.parametrize("case", ["default", "dock_margin_inside", "docking_radius_shrunk",
                                  "dock_margin", "initial_arrive_dist_shrunk"])
def test_tour_feasibility_matches_jax(jax_cache, case):
    """Every field bitwise, on the feasible world and on the same world made
    infeasible. A leg's plan ends exactly on its target (the straight leg on
    the initial waypoint), so only an empty ring (radius - margin < 0, a
    negative arrive distance) makes a leg fail."""
    jwp, jcache = jax_cache
    over = dict(docking_radius_shrunk=dict(docking_radius=-0.1),
                initial_arrive_dist_shrunk=dict(initial_arrive_dist=-1.0)).get(case, {})
    margin = dict(dock_margin=0.75, dock_margin_inside=0.3).get(case, 0.0)
    jfeas = jax.jit(lambda c, w, p: jplancache.tour_feasibility(c, w, p, JS, dock_margin=margin))(
        jcache, jwp, jparams(dataclasses.replace(JParams(), **over)))
    feas = plancache.tour_feasibility(
        to_torch(jcache, plancache.PlanCache, CPU), to_torch(jwp, Waypoints, CPU),
        params_as_f32(dataclasses.replace(AosParams(), **over), CPU), S, dock_margin=margin)
    assert_same(jfeas, feas)
    assert bool(feas["feasible"]) == (case in ("default", "dock_margin_inside"))
    if case == "initial_arrive_dist_shrunk":
        assert int(feas["first_bad_leg"]) == 0 and not bool(feas["row0_ok"])
    elif not bool(feas["feasible"]):
        assert int(feas["first_bad_leg"]) == 1 and int(feas["bad_legs"]) >= 1


# ---------------------------------------------------------------------------
# lanes against single runs (port only)
# ---------------------------------------------------------------------------


def test_lanes_equal_single_runs(clouds, params):
    """4 lanes x 60 ticks of the lane step_cached equal 4 single-lane runs,
    every state leaf and metric bitwise (v_dt = 0.5 m a tick, so the lanes
    leave the straight leg, dock and replan)."""
    singles = [batch.rollout_begin_cached(c, params, S, 60, ror_method="exact", device=CPU)
               for c in clouds[:4]]
    lite_b, cache_b, st_b, _ = tree.stack(singles)
    lane_metrics = []
    for _ in range(60):
        st_b, m = plancache.step_cached(st_b, lite_b, cache_b, params, S, v_dt=0.5)
        lane_metrics.append(m)
    targets = set()
    for ln, (lite, cache, st, _) in enumerate(singles):
        for t in range(60):
            st, m = plancache.step_cached(st, lite, cache, params, S, v_dt=0.5)
            assert_same(m, tree.lane(lane_metrics[t], ln))
        assert_same(st, tree.lane(st_b, ln))
        targets.add(int(st.mission.target_wp))
    assert max(targets) >= 1  # the tour advanced past its first waypoint


# ---------------------------------------------------------------------------
# the sustained harness
# ---------------------------------------------------------------------------


def test_sustained_accounting(port_sustained, jax_sustained):
    res, stats = port_sustained
    jres, jstats = jax_sustained
    assert set(res) == set(jres)
    assert all(v.shape[0] == TOTAL and v.dtype == jres[k].dtype for k, v in res.items())
    assert stats["begin_calls"] == jstats["begin_calls"] == BATCH // REFILL + (TOTAL - BATCH) // REFILL
    assert stats["chunk_calls"] == jstats["chunk_calls"]
    assert set(jstats) <= set(stats)


@pytest.mark.parametrize("field", INT_FIELDS + FLOAT_FIELDS)
def test_sustained_matches_jax(port_sustained, jax_sustained, field):
    got, want = port_sustained[0][field], np.asarray(jax_sustained[0][field])
    if field in FLOAT_FIELDS:
        assert float(np.abs(got.astype(np.float64) - want).max()) <= FLOAT_BOUND_M
        assert (got > 1.0).all()  # every robot moved
    else:
        assert np.array_equal(got, want), (got, want)


def test_port_chunk_from_jax_begin(jax_sustained):
    """The JAX package's vmapped begin carried across (``convert``: lane-stacked
    PlanCache, CachedEngineState, WorldLite and accumulator) and run through
    the port's lane chunk gives the records of the JAX harness's first lanes."""
    from aosx_torch.convert import dict_to_torch

    jp = jparams(JParams())
    keys = jax.random.split(jax.random.PRNGKey(5), TOTAL)[:REFILL]
    jlite, jcache, jst, jacc = jax.jit(jax.vmap(lambda k: jbatch.rollout_begin_cached(
        k, JSPEC, jp, JS, BUDGET, ror_method="exact")))(keys)
    lite = to_torch(jlite, plancache.WorldLite, CPU)
    cache = to_torch(jcache, plancache.PlanCache, CPU)
    st = to_torch(jst, plancache.CachedEngineState, CPU)
    acc = dict_to_torch(jacc, CPU)
    assert cache.plan_xy.shape == (REFILL, plancache.num_rows(S), S.max_plan, 2)
    assert cache.plan_yaw.shape[-1] == 0  # dropped by begin, as in the port
    params = params_as_f32(AosParams(), CPU)
    for off in range(0, BUDGET, CHUNK):
        st, acc = batch.rollout_chunk_cached(lite, cache, st, acc, params, S, CHUNK,
                                             torch.full((REFILL,), off, dtype=torch.int32))
    got = to_numpy(batch.rollout_finish(st, acc, S))
    for k in INT_FIELDS:
        assert np.array_equal(got[k], np.asarray(jax_sustained[0][k])[:REFILL]), k
    for k in FLOAT_FIELDS:
        assert float(np.abs(got[k] - np.asarray(jax_sustained[0][k])[:REFILL]).max()) \
            <= FLOAT_BOUND_M, k


def test_sustained_uncached_matches_cached(port_sustained, clouds, params):
    """cached=False (engine.step lanes one after the other, classify=True)
    records what the cached harness records, bit for bit."""
    res, stats = batch.sustained_rollouts(
        TOTAL, BATCH, SPEC, params, S, BUDGET, chunk_steps=CHUNK, refill=REFILL,
        ror_method="exact", cached=False, classify=True, clouds=clouds.__getitem__, device=CPU)
    assert_same(port_sustained[0], res)
    assert stats["chunk_calls"] == port_sustained[1]["chunk_calls"]


def test_sustained_rejects_bad_shapes(params):
    for kw in (dict(total=3, batch=4), dict(total=7, batch=4, refill=2),
               dict(total=8, batch=4, refill=3)):
        kw = dict(dict(total=8, batch=4, refill=2), **kw)
        with pytest.raises(AssertionError):
            batch.sustained_rollouts(kw["total"], kw["batch"], SPEC, params, S, BUDGET,
                                     chunk_steps=CHUNK, refill=kw["refill"], device=CPU)
    with pytest.raises(AssertionError):
        batch.sustained_rollouts(8, 4, SPEC, params, S, 50, chunk_steps=CHUNK, refill=2,
                                 device=CPU)


def test_default_clouds_are_make_orchard_np(params):
    """Without ``clouds`` rollout id i runs make_orchard_np(spec, seed + i)."""
    from aosx_torch.orchards import make_orchard_np

    res, _ = batch.sustained_rollouts(2, 2, SPEC, params, S, CHUNK, chunk_steps=CHUNK, refill=1,
                                      seed=3, ror_method="exact", cached=True, device=CPU)
    want, _ = batch.sustained_rollouts(
        2, 2, SPEC, params, S, CHUNK, chunk_steps=CHUNK, refill=1, ror_method="exact",
        cached=True, clouds=lambda i: make_orchard_np(SPEC, seed=3 + i), device=CPU)
    assert_same(want, res)


# ---------------------------------------------------------------------------
# guard-flagged lanes
# ---------------------------------------------------------------------------


def test_flagged_lane_cannot_report_success():
    def poisoned(mod, **over):
        i32 = (lambda v: torch.tensor(v, dtype=torch.int32)) if mod is torch else jnp.int32
        f32 = (lambda v: torch.tensor(v, dtype=torch.float32)) if mod is torch else jnp.float32
        flag = (lambda v: torch.tensor(v)) if mod is torch else jnp.bool_
        d = dict(completed=flag(True), steps_to_complete=i32(42), final_status=i32(3),
                 travel_distance=f32(12.5), final_dist_to_origin=f32(0.01), waypoints=i32(7),
                 guards=i32(2))
        d.update({k: i32(v) for k, v in over.items()})
        return d

    for s_port, s_jax in ((dataclasses.replace(S, exact_fallbacks=False),
                           dataclasses.replace(JS, exact_fallbacks=False)), (S, JS)):
        for over in ({}, dict(guards=0)):
            out = batch._invalidate_flagged(poisoned(torch, **over), s_port)
            assert_same(jbatch._invalidate_flagged(poisoned(jnp, **over), s_jax), out)
    out = batch._invalidate_flagged(poisoned(torch), dataclasses.replace(S, exact_fallbacks=False))
    assert not bool(out["completed"]) and int(out["final_status"]) == 1
    assert int(out["steps_to_complete"]) == 42  # diagnostics preserved


def test_flagged_lane_end_to_end(params):
    """A tripped guard (skeleton buffer overflow under max_skel_cells=8) with
    exact_fallbacks=False: the same guard bits in both packages, and the
    lane forced to not-completed / Failed."""
    tiny = dict(exact_fallbacks=False, max_skel_cells=8)
    js, s = dataclasses.replace(JS, **tiny), dataclasses.replace(S, **tiny)
    key = jax.random.PRNGKey(0)
    jp = jparams(JParams())
    want = jax.jit(lambda k: jbatch.rollout_one(k, JSPEC, jp, js, 5, ror_method="exact"))(key)
    got = batch.rollout_one(cloud_of(key, js), params, s, 5, ror_method="exact", device=CPU)
    assert int(got["guards"]) & GUARD_SKEL_OVERFLOW
    assert not bool(got["completed"]) and int(got["final_status"]) == 1
    for k in INT_FIELDS:
        assert np.array_equal(to_numpy(got[k]), np.asarray(want[k])), k
    for k in FLOAT_FIELDS:
        assert abs(float(got[k]) - float(want[k])) <= FLOAT_BOUND_M, k
