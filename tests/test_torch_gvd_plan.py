"""GVD graph, A* costs, waypoint tour and trim plane of the port, each fed
the JAX package's output of the stage before, equal the JAX package's.

Cases: two seeded orchards at TEST_STATICS, and one at MC_STATICS, whose
exact_fallbacks=False takes the fast-only paths (window compaction without
fallback, compacted ridge candidates).

Every leaf is bitwise, float leaves included: the port rounds the squared
edge length as one fused multiply-add, fma(dy, dy, dx * dx), as XLA:CPU
contracts it here."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest

import aosx.config as jc
import aosx_torch.config as tc
from aosx.gvd import build_gvd_graph as jgraph
from aosx.perceive import perceive as jperceive
from aosx.plan.astar import cost_matrix as jcosts, plan_between as jplan
from aosx.plan.mission import build_waypoints as jwaypoints, trim_distance_plane as jtrim
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch.convert import to_torch
from aosx_torch.gvd import build_gvd_graph
from aosx_torch.perceive.pipeline import PerceiveOut
from aosx_torch.plan.astar import cost_matrix, plan_between
from aosx_torch.plan.mission import build_waypoints, trim_distance_plane
from aosx_torch.types import GvdGraph
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401


@pytest.fixture(scope="module", params=[("TEST_STATICS", 0), ("TEST_STATICS", 3),
                                        ("MC_STATICS", 0)])
def case(request):
    """The JAX package's perceive output and graph for one seeded orchard,
    with both packages' statics and params."""
    name, seed = request.param
    # the dynamic-shift JFA lowering compiles in seconds on XLA:CPU; these
    # presets run no Pallas pass, and the port rounds every pass as the XLA
    # lowerings do
    JS = dataclasses.replace(getattr(jc, name), jfa_dynamic_shifts=True)
    S = getattr(tc, name)
    buf, valid, poly = orchard_buffers(S, seed=seed)
    jp = jc.params_as_f32(jc.AosParams())
    out = jax.jit(lambda pc, poly, p, ex: jperceive(pc, poly, p, ex, JS))(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jp, jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    graph = jax.jit(lambda o, p: jgraph(o.seeds, o.rows_sorted, o.skeleton, p, JS))(out, jp)
    return types.SimpleNamespace(JS=JS, S=S, out=out, graph=graph, jp=jp,
                                 pt=tc.params_as_f32(tc.AosParams(), "cpu"))


def test_build_gvd_graph_matches_jax(case):
    o = to_torch(case.out, PerceiveOut, "cpu")
    got = build_gvd_graph(o.seeds, o.rows_sorted, o.skeleton, case.pt, case.S)
    assert_same(case.graph, got)
    assert int(got.num_nodes) > 10 and int(got.num_edges) > 10


def test_cost_matrix_matches_jax(case):
    ref = jax.jit(lambda g: jcosts(g, case.JS))(case.graph)
    assert_same(ref, cost_matrix(to_torch(case.graph, GvdGraph, "cpu"), case.S))


def test_build_waypoints_matches_jax(case):
    got = build_waypoints(to_torch(case.graph, GvdGraph, "cpu"), case.pt, case.S)
    assert_same(jax.jit(lambda g, p: jwaypoints(g, p, case.JS))(case.graph, case.jp), got)
    assert int(got.count) >= 4


def test_trim_distance_plane_matches_jax(case):
    ref = jax.jit(lambda sk: jtrim(sk, case.JS))(case.out.skeleton)
    got = trim_distance_plane(to_torch(case.out, PerceiveOut, "cpu").skeleton, case.S)
    assert_same(ref, got)
    assert bool((got < 1.0).any())


def test_astar_paths_match_jax(case):
    """Plan from every waypoint of the tour to the next one's node."""
    g = to_torch(case.graph, GvdGraph, "cpu")
    costs = cost_matrix(g, case.S)
    jcost = jax.jit(lambda gr: jcosts(gr, case.JS))(case.graph)
    wp = build_waypoints(g, case.pt, case.S)
    run = jax.jit(lambda c, gr, sp, goal, p: jplan(c, gr.nodes, gr.node_valid, sp, goal, p,
                                                   case.JS))
    n = int(wp.count)
    for i in range(n - 1):
        start, goal = wp.xy[i], wp.node_idx[i + 1]
        ref = run(jcost, case.graph, jnp.asarray(start.numpy()), jnp.int32(int(goal)), case.jp)
        got = plan_between(costs, g.nodes, g.node_valid, start, goal, case.pt, case.S)
        assert_same(list(ref), list(got))
    assert n >= 4
