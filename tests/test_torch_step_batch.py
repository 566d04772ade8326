"""The lane-aware ``engine.step`` and the uncached Monte-Carlo path
(``parallel/batch.py``): lanes step together, as ``aosx`` runs them under
``jax.vmap``, and every lane equals its run alone bit for bit.

- The episode of three TEST_STATICS worlds (built in one batched
  ``prepare_world``) as lanes of one ``engine.episode``, 48 ticks at
  v_dt = 0.5 m/tick, equals the three unbatched episodes: every metric of
  every tick and every leaf of the final state, bitwise.
- The same lanes against jitted ``jax.vmap(aosx.engine.step)`` from the
  same worlds, over all 48 ticks: every metric of every tick and the state
  after them bitwise, floats included (the port evaluates linearize and
  the follower's atan2, sin and cos as XLA:CPU does; while it did not, the
  plan points and yaws carried 4-ulp bounds and only 20 ticks were held).
  The port rounds the follower's move as JAX's scans compile it (x's
  product fused into its add, y's not: engine._move_robot); jit(step) and
  vmap(step) fuse both, which no tick of these worlds tells apart.
- The uncached ``sustained_rollouts`` (lane-aware engine.step chunks, one
  group begin a refill) records what the cached harness records on the same
  keys, bitwise (``aosx`` pins the same pair in tests/test_plancache.py).
- ``batched_rollouts`` on four keys (one batched begin, one lane-aware
  episode) equals the keys' ``rollout_one`` bitwise, and ``aosx``'s
  ``batched_rollouts`` on the same keys: int and bool fields bitwise, the
  travel and the distance to the origin within the metres of
  tests/test_torch_parallel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import (DRYRUN_STATICS as JDS, TEST_STATICS as JTS, AosParams as JParams,
                         params_as_f32 as jparams)
from aosx.parallel import batch as jbatch
from aosx_torch import engine, prng, tree
from aosx_torch.config import DRYRUN_STATICS as DS, TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_numpy
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.parallel import batch
from torch_helpers import WORLD_SPECS, assert_same, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
V_DT = 0.5
TICKS = 48
# ticks held against JAX: the whole episode
JAX_TICKS = TICKS
SPEC_KW = dict(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
               trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
TOTAL, BATCH, REFILL, BUDGET, CHUNK = 8, 4, 2, 160, 40
INT_FIELDS = ("completed", "steps_to_complete", "final_status", "waypoints", "guards",
              "feasible")
FLOAT_FIELDS = ("travel_distance", "final_dist_to_origin")
# metres, as tests/test_torch_parallel.py
FLOAT_BOUND_M = 0.0


def bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def assert_bitwise(ref, got):
    ra, ga = tree.leaves(ref), tree.leaves(got)
    assert len(ra) == len(ga)
    for a, b in zip(ra, ga):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert torch.equal(bits(a), bits(b))


def to_jax(obj, cls=None):
    """The JAX package's dataclass of the same name as the port's ``obj``
    (or ``cls``), field for field."""
    from aosx import types as jtypes
    from aosx.plan import astar as jastar

    cls = cls or getattr(jtypes, type(obj).__name__, None) or getattr(jastar, type(obj).__name__)
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = to_jax(v)
        else:
            out[f.name] = jnp.asarray(to_numpy(v))
    return cls(**out)


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


@pytest.fixture(scope="module")
def group(params):
    """Three TEST_STATICS worlds of different orchards, built in one call."""
    clouds = [make_orchard_np(WORLD_SPECS[k], seed=i)
              for i, k in enumerate(("test", "curved", "4x14"))]
    orchards = [batch.cloud_tensors(c, S, CPU) for c in clouds]
    return batch._world(tree.stack(orchards), params, S, "sorted")


@pytest.fixture(scope="module")
def episodes(group, params):
    """(the batched episode, the three unbatched episodes)."""
    batched = engine.episode(group, params, S, TICKS, v_dt=V_DT)
    singles = [engine.episode(tree.lane(group, i), params, S, TICKS, v_dt=V_DT)
               for i in range(3)]
    return batched, singles


def test_batched_episode_equals_single_episodes(episodes):
    (final, metrics), singles = episodes
    assert metrics["xy"].shape == (TICKS, 3, 2)
    for i, (f1, m1) in enumerate(singles):
        assert_bitwise(f1, tree.lane(final, i))
        assert_bitwise(m1, {k: v[:, i] for k, v in metrics.items()})
    # the lanes part ways: each adopts graph paths and none ends where another does
    assert bool(final.mission.initial_reached.all())
    assert len({tuple(x) for x in final.robot.xy.tolist()}) == 3
    assert all(len(set(metrics["plan_len"][:, i].tolist())) > 1 for i in range(3))


def test_batched_episode_matches_jax_vmap_step(episodes, group, params):
    (_, metrics), _ = episodes
    jp = jparams(JParams())
    jworld = to_jax(group, jengine.World)
    jstep = jax.jit(jax.vmap(lambda st, w: jengine.step(st, w, jp, JTS, v_dt=jnp.float32(V_DT))))
    jst = jax.vmap(lambda w: jengine.initial_state(w, JTS))(jworld)
    for t in range(JAX_TICKS):
        jst, jm = jstep(jst, jworld)
        assert_same(jm, {k: v[t] for k, v in metrics.items()})
    final, _ = engine.episode(group, params, S, JAX_TICKS, v_dt=V_DT)
    assert_same(jst, final)


# ---------------------------------------------------------------------------
# the uncached harness and batched_rollouts
# ---------------------------------------------------------------------------


def test_uncached_sustained_equals_cached(params, monkeypatch):
    """Default keys (``aosx``'s split of PRNGKey(0)): the uncached harness,
    whose chunk steps every lane in one engine.step call a tick, records
    what the cached harness records, bitwise."""
    spec = OrchardSpec(**SPEC_KW)
    kw = dict(chunk_steps=CHUNK, refill=REFILL, ror_method="exact", device=CPU)
    cached, cstats = batch.sustained_rollouts(TOTAL, BATCH, spec, params, DS, BUDGET,
                                              cached=True, **kw)
    calls = []
    step = engine.step

    def counted(st, *a, **k):
        calls.append(st.t.shape)
        return step(st, *a, **k)

    monkeypatch.setattr(engine, "step", counted)
    uncached, ustats = batch.sustained_rollouts(TOTAL, BATCH, spec, params, DS, BUDGET,
                                                cached=False, classify=True, **kw)
    assert_same(cached, uncached)
    assert ustats["chunk_calls"] == cstats["chunk_calls"]
    assert ustats["begin_calls"] == cstats["begin_calls"]
    # one call a tick for every lane of the block
    assert len(calls) == ustats["chunk_calls"] * CHUNK and set(calls) == {(BATCH,)}
    assert len(set(cached["travel_distance"].tolist())) > 1


@pytest.fixture(scope="module")
def rollouts(params):
    keys = prng.split(prng.prng_key(5, CPU), 4)
    got = batch.batched_rollouts(keys, OrchardSpec(**SPEC_KW), params, DS, 40,
                                 ror_method="exact", v_dt=V_DT, device=CPU)
    return keys, got


def test_batched_rollouts_equal_single_rollouts(rollouts, params):
    keys, got = rollouts
    for i, k in enumerate(keys):
        one = batch.rollout_one(k, OrchardSpec(**SPEC_KW), params, DS, 40, ror_method="exact",
                                v_dt=V_DT, device=CPU)
        assert_bitwise(one, {f: v[i] for f, v in got.items()})


def test_batched_rollouts_match_jax(rollouts):
    from aosx.orchards import OrchardSpec as JSpec

    _, got = rollouts
    jp = jparams(JParams())
    want = jax.jit(lambda k: jbatch.batched_rollouts(k, JSpec(**SPEC_KW), jp, JDS, 40,
                                                     ror_method="exact", v_dt=V_DT))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    got = to_numpy(got)
    for k in INT_FIELDS:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    for k in FLOAT_FIELDS:
        assert float(np.abs(got[k] - np.asarray(want[k])).max()) <= FLOAT_BOUND_M, k
    assert int(got["waypoints"].min()) >= 2
