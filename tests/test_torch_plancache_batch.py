"""The batch axes of the plan-cache path (``ops.while_loop``,
``plan/astar``, ``plan/mission``, ``plan/linearize``, ``plan/plancache``,
``parallel/batch.rollout_begin_group``): the axes ``aosx`` maps with
``jax.vmap`` (worlds x rows x A* candidates) run as one batched call, and
every lane equals the unbatched call bitwise.

- A* and plan_between over 3 worlds x 2 rows x K candidates, with a start
  == goal lane, an unreachable goal and a disabled (dead) lane, equal the
  per-world, per-row calls (TEST_STATICS worlds of the port).
- linearize over a batch of paths equals the per-path calls: paths 190 m
  from the origin, near it, of 0 and 1 points, and one whose split stops at
  max_segments.
- build_plan_cache on a group of JAX worlds equals JAX's build_plan_cache
  of each world leaf for leaf, floats included, and the port's unbatched
  build of each world bitwise (DRYRUN_STATICS).
- The group begin over the refill keys of tests/test_torch_parallel.py
  equals JAX's jitted ``jax.vmap(rollout_begin_cached)`` leaf for leaf and
  the stack of single-key begins bitwise.
- build_plan_cache on a group calls plan_current_path and linearize once
  each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import DRYRUN_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.orchards import OrchardSpec as JSpec, make_orchard
from aosx.parallel import batch as jbatch
from aosx.plan import plancache as jplancache
from aosx_torch import engine, tree
from aosx_torch.config import DRYRUN_STATICS as S, TEST_STATICS as TS, AosParams, params_as_f32
from aosx_torch.convert import dict_to_torch, to_torch
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.parallel import batch
from aosx_torch.plan import astar, linearize as lin, plancache
from aosx_torch.types import Path
from torch_helpers import WORLD_SPECS, assert_same, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SPEC_KW = dict(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
               trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
JSPEC = JSpec(**SPEC_KW)
BUDGET, REFILL = 60, 2


def bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def assert_bitwise(ref, got):
    ra, ga = tree.leaves(ref), tree.leaves(got)
    assert len(ra) == len(ga)
    for a, b in zip(ra, ga):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert torch.equal(bits(a), bits(b))


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


@pytest.fixture(scope="module")
def worlds(params):
    """Three TEST_STATICS worlds of the port, of different orchards."""
    specs = [WORLD_SPECS["test"], WORLD_SPECS["curved"], WORLD_SPECS["4x14"]]
    return [batch._world(batch.cloud_tensors(make_orchard_np(sp, seed=i), TS, CPU), params, TS,
                         "exact") for i, sp in enumerate(specs)]


# ---------------------------------------------------------------------------
# (1) A* and plan_between
# ---------------------------------------------------------------------------


def search_cases(worlds):
    """starts [3, 2, K], goals [3, 2], enabled [3, 2]: world 0 row 0 has a
    start == goal candidate, world 1 row 1 an invalid (unreachable) goal,
    world 2 row 0 is disabled."""
    rng = np.random.default_rng(0)
    K = TS.astar_k
    starts, goals = [], []
    for w in worlds:
        ok = np.nonzero(w.graph.node_valid.numpy())[0]
        starts.append(rng.choice(ok, size=(2, K)))
        goals.append(rng.choice(ok, size=2))
    starts, goals = np.stack(starts), np.stack(goals)
    starts[0, 0, 2] = goals[0, 0]
    bad = np.nonzero(~worlds[1].graph.node_valid.numpy())[0]
    goals[1, 1] = bad[0]
    enabled = np.ones((3, 2), bool)
    enabled[2, 0] = False
    return (torch.from_numpy(starts.astype(np.int32)), torch.from_numpy(goals.astype(np.int32)),
            torch.from_numpy(enabled))


def stacked(worlds):
    """The worlds' graphs and cost matrices on a [3, 1] batch (one world for
    both rows of its lane)."""
    g = tree.tree_map(lambda x: x[:, None], tree.stack([w.graph for w in worlds]))
    c = tree.tree_map(lambda x: x[:, None], tree.stack([w.costmat for w in worlds]))
    return g, c


def test_astar_batched_equals_per_world(worlds, params):
    starts, goals, enabled = search_cases(worlds)
    g, c = stacked(worlds)
    got = astar.astar(c, g.nodes, g.node_valid, starts, goals, params.heuristic_weight, TS,
                      enabled=enabled)
    assert got[0].shape == (3, 2, TS.astar_k, TS.max_path)
    for b, w in enumerate(worlds):
        for r in range(2):
            want = astar.astar(w.costmat, w.graph.nodes, w.graph.node_valid, starts[b, r],
                               goals[b, r], params.heuristic_weight, TS, enabled=enabled[b, r])
            assert_bitwise(want, tuple(x[b, r] for x in got))
    found, lens = got[2], got[1]
    assert bool(found[0, 0, 2]) and int(lens[0, 0, 2]) == 1        # start == goal
    assert not found[1, 1].any() and not found[2, 0].any()          # unreachable, dead
    assert int(lens[found].max()) > 5                               # real searches ran


def test_plan_between_batched_equals_per_world(worlds, params):
    _, goals, enabled = search_cases(worlds)
    rng = np.random.default_rng(1)
    points = torch.from_numpy(rng.uniform(0.0, 20.0, (3, 2, 2)).astype(np.float32))
    g, c = stacked(worlds)
    got = astar.plan_between(c, g.nodes, g.node_valid, points, goals, params, TS,
                             enabled=enabled)
    for b, w in enumerate(worlds):
        for r in range(2):
            want = astar.plan_between(w.costmat, w.graph.nodes, w.graph.node_valid, points[b, r],
                                      goals[b, r], params, TS, enabled=enabled[b, r])
            assert_bitwise(want, tuple(x[b, r] for x in got))
    assert int(got[2].sum()) >= 3


# ---------------------------------------------------------------------------
# (2) linearize
# ---------------------------------------------------------------------------


def paths():
    """[n] paths of TEST_STATICS: random walks 190 m out and near the
    origin, paths of 0 and 1 points, and a zigzag to the origin whose split
    runs into max_segments."""
    rng = np.random.default_rng(2)
    P = TS.max_path
    out = []

    def add(pts):
        xy = np.zeros((P, 2), np.float32)
        xy[:len(pts)] = pts
        out.append((xy, len(pts)))

    for base, step in ((190.0, 0.5), (190.0, 2.0), (0.0, 0.05), (0.01, 0.2), (40.0, 1.0)):
        for n in (5, 17, P):
            add((base + rng.normal(size=(n, 2)).cumsum(0) * step).astype(np.float32))
    add(np.zeros((0, 2), np.float32))
    add(np.array([[190.5, -3.25]], np.float32))
    t = np.arange(40, dtype=np.float32)
    zig = np.stack([12.0 - 0.3 * t, np.where(t % 8 < 4, t % 4, 4 - t % 4)], 1).astype(np.float32)
    zig[-1] = 0.0
    add(zig)
    xy = torch.from_numpy(np.stack([p[0] for p in out]))
    count = torch.tensor([p[1] for p in out], dtype=torch.int32)
    return Path(xy=xy, yaw=torch.zeros(xy.shape[:2]), count=count)


def test_linearize_batched_equals_per_path(params):
    batch_ = paths()
    n = batch_.count.shape[0]
    got = lin.linearize(batch_, params, TS)
    got2 = lin.linearize(tree.tree_map(lambda x: x.reshape((2, n // 2) + x.shape[1:]), batch_),
                         params, TS)
    assert_bitwise(got, tree.tree_map(lambda x: x.reshape((n,) + x.shape[2:]), got2))
    bps = lin.breakpoint_mask(batch_, params, TS)
    for i in range(n):
        one = tree.lane(batch_, i)
        assert_bitwise(lin.linearize(one, params, TS), tree.lane(got, i))
        assert torch.equal(lin.breakpoint_mask(one, params, TS), bps[i])
    # the zigzag to the origin splits into max_segments segments
    assert int(bps[-1].sum()) == TS.max_segments + 1
    assert int(got.count[-3]) == 0 and int(got.count[-2]) == 1


# ---------------------------------------------------------------------------
# (3), (4) against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_group():
    """JAX's world, build_plan_cache and rollout_begin_cached for each of the
    refill keys, in one jitted vmap."""
    jp = jparams(JParams())
    keys = jax.random.split(jax.random.PRNGKey(5), 8)[:REFILL]

    def one(k):
        pc, poly = make_orchard(k, JSPEC, JS)
        w = jengine.prepare_world(pc, poly, jp, jnp.zeros((JS.max_exclusions, 3)), JS,
                                  ror_method="exact")
        return w, jplancache.build_plan_cache(w, jp, JS), jbatch.rollout_begin_cached(
            k, JSPEC, jp, JS, BUDGET, ror_method="exact")

    return jax.jit(jax.vmap(one))(keys)


def test_build_plan_cache_group_matches_jax(jax_group, params):
    jworld, jcache, _ = jax_group
    world = to_torch(jworld, engine.World, CPU)
    cache = plancache.build_plan_cache(world, params, S)
    assert cache.plan_xy.shape == (REFILL, plancache.num_rows(S), S.max_plan, 2)
    assert_same(jcache, cache)
    for i in range(REFILL):
        assert_bitwise(plancache.build_plan_cache(tree.lane(world, i), params, S),
                       tree.lane(cache, i))
    assert int(cache.success.sum()) >= 2 * REFILL


def test_group_begin_matches_jax_and_single_begins(jax_group, params):
    from aosx_torch import prng

    _, _, (jlite, jcache, jst, jacc) = jax_group
    keys = prng.split(prng.prng_key(5, CPU), 8)[:REFILL]
    got = batch.rollout_begin_group(keys, OrchardSpec(**SPEC_KW), params, S, BUDGET,
                                    ror_method="exact", device=CPU)
    want = (to_torch(jlite, plancache.WorldLite, CPU), to_torch(jcache, plancache.PlanCache, CPU),
            to_torch(jst, plancache.CachedEngineState, CPU), dict_to_torch(jacc, CPU))
    assert_same(list(want), list(got))
    singles = [batch.rollout_begin_cached(k, OrchardSpec(**SPEC_KW), params, S, BUDGET,
                                          ror_method="exact", device=CPU) for k in keys]
    assert_bitwise(tree.stack(singles), got)


# ---------------------------------------------------------------------------
# (5) one call a group
# ---------------------------------------------------------------------------


def test_group_cache_makes_one_plan_and_one_linearize_call(worlds, params, monkeypatch):
    calls = {"plan_current_path": 0, "linearize": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(plancache, name, counted(name, getattr(plancache, name)))
    cache = plancache.build_plan_cache(tree.stack(worlds), params, TS)
    assert calls == {"plan_current_path": 1, "linearize": 1}
    assert cache.plan_xy.shape[:2] == (3, plancache.num_rows(TS))
