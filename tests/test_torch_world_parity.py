"""World parity over many orchards: the port's perceive output, Voronoi owner
plane and whole world (graph, A* costs, waypoint tour, trim plane) equal the
JAX package's bitwise on 24 orchards at TEST_STATICS.

The orchards are ``make_orchard_np`` seeds 0-5 of four specs: the test
orchard of ``torch_helpers.SPEC``, the same with rows bowed by 0.6 m, 4 rows
of 14 m 3.5 m apart with 128 noise points, and 5 rows of 16 m 3 m apart.
Before the port rounded the reference's fused multiply-adds once (the
flood's cell coordinates and squared distance, the endpoint rays' sample
points, the squared edge length) and took its square roots correctly
rounded, the owner plane differed on 8 of them, the graph on 2, the tour on
1 and a seed on 1; ``edge_lengths`` and ``costmat.cost`` differed by 1 ulp on
21. Every leaf is bitwise now: the stated bound is 0 ulp for every float."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import engine
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.types import PointCloud, Polygon
from torch_helpers import WORLD_SPECS as SPECS, assert_same, one_torch_thread, orchard_buffers  # noqa: F401,E501

CASES = [(name, seed) for name in SPECS for seed in range(6)]


@pytest.fixture(scope="module")
def jax_world():
    """The JAX package's prepare_world_full with the owner plane, one jit
    (TEST_STATICS takes the dynamic-shift flood, which compiles in
    seconds)."""
    assert JS.jfa_dynamic_shifts
    return jax.jit(lambda pc, poly, p, ex: jengine.prepare_world_full(
        pc, poly, p, ex, JS, with_owner=True))


@pytest.mark.parametrize("spec,seed", CASES)
def test_world_matches_jax(jax_world, spec, seed):
    buf, valid, poly = orchard_buffers(S, seed=seed, spec=SPECS[spec])
    jworld, jout, jowner = jax_world(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jparams(JParams()), jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    world, out, owner = engine.prepare_world_full(
        PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
        Polygon.from_array(poly, S, "cpu"), params_as_f32(AosParams(), "cpu"),
        torch.zeros((S.max_exclusions, 3)), S, with_owner=True)
    assert_same(jout, out)
    assert np.array_equal(np.asarray(jowner), owner.numpy())
    assert_same(jworld, world)
    assert int(world.waypoints.count) >= 4 and int(world.graph.num_edges) > 10
