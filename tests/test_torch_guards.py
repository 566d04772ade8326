"""The guard triggers of tests/test_guards.py run through both packages on
the same inputs: every output and guard bit of the port bitwise the JAX
package's, at DRYRUN_STATICS.

- GUARD_CROSS_DENSE: the packed crossing filter with a cap of 64 slots
  overflows. With exact fallbacks both packages take the dense decision;
  with ``exact_fallbacks=False`` (the Monte-Carlo mode) ``aosx`` keeps the
  fine result of its truncated buffers, which keeps edges the dense one
  drops, and so does the port (``gvd/graph._fine_windows``).
- GUARD_EDGE_COARSE: an 11 m edge capped at 16 samples.
- GUARD_PROX_PPN: 12 nodes in a 0.2 m blob.
- GUARD_RIDGE_COMPACT: 4 distinct owners on every vertex, exact and
  fast-only.
- GUARD_CLUSTER_CAP: max_clusters components, then 4 more.
- GUARD_CCL_CELL_FALLBACK: the run buffers overflow in fast-only mode.
- GUARD_PLAN_CAP: a /plan that fills max_plan = 8.
- Fast-only against exact: a seeded orchard's perceive output and world in
  both modes, each against the JAX package's, the two modes' equal and
  their guards clean."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aosx.config as jc
from aosx import engine as jengine
from aosx.gvd.graph import build_edges as jbuild_edges
from aosx.gvd.graph import edge_crossing_packed as jcrossing
from aosx.orchards import OrchardSpec as JSpec, make_orchard as jorchard
from aosx.perceive.rows import cluster_grid as jcluster_grid
from aosx.types import GridWorld as JGrid, Polygon as JPolygon, SeedSet as JSeeds
from aosx_torch import engine
from aosx_torch.config import DRYRUN_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_torch
from aosx_torch.guards import (GUARD_CCL_CELL_FALLBACK, GUARD_CLUSTER_CAP, GUARD_CROSS_DENSE,
                               GUARD_EDGE_COARSE, GUARD_PLAN_CAP, GUARD_PROX_PPN,
                               GUARD_RIDGE_COMPACT)
from aosx_torch.gvd.graph import build_edges, edge_crossing_packed
from aosx_torch.perceive.rows import cluster_grid
from aosx_torch.types import GridWorld, PointCloud, Polygon, SeedSet
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

JS = jc.DRYRUN_STATICS
FAST = dataclasses.replace(S, exact_fallbacks=False)
JFAST = dataclasses.replace(JS, exact_fallbacks=False)
SMALL_SPEC = dict(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0, trunk_pts=10,
                  noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)


def grids(occ):
    """(JAX grid, port grid) of a u8 occupancy plane at the origin."""
    h, w = occ.shape
    j = JGrid(occ=jnp.asarray(occ), origin_x=jnp.float32(0.0), origin_y=jnp.float32(0.0),
              h_cells=jnp.int32(h), w_cells=jnp.int32(w))
    return j, GridWorld(occ=torch.from_numpy(occ), origin_x=torch.tensor(0.0),
                        origin_y=torch.tensor(0.0), h_cells=torch.tensor(h, dtype=torch.int32),
                        w_cells=torch.tensor(w, dtype=torch.int32))


def random_occ(seed, density):
    rng = np.random.default_rng(seed)
    return (rng.random((S.grid_h, S.grid_w)) < density).astype(np.uint8)


def params():
    return jc.params_as_f32(jc.AosParams()), params_as_f32(AosParams(), "cpu")


def no_polygon():
    return (JPolygon(pts=jnp.zeros((JS.max_poly, 2), jnp.float32), count=jnp.int32(0)),
            Polygon(pts=torch.zeros((S.max_poly, 2)), count=torch.tensor(0, dtype=torch.int32)))


def entries(n=1024, seed=2):
    """tests/test_guards.py's crossing entries: short edges, 90 % valid."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, [S.grid_w * S.resolution, S.grid_h * S.resolution],
                    (n, 2)).astype(np.float32)
    b = a + rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    return a, b, rng.random(n) < 0.9


def crossing_both(jgrid, tgrid, a, b, nmax, valid, fast, cap):
    js, ts = (JFAST, FAST) if fast else (JS, S)
    want = jax.jit(lambda: jcrossing(jgrid, jnp.asarray(a), jnp.asarray(b), jnp.asarray(nmax),
                                     jnp.asarray(valid), js, cap=cap))()
    got = edge_crossing_packed(tgrid, torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(nmax), torch.from_numpy(valid), ts, cap=cap)
    assert_same(want, got)
    return [np.asarray(x) for x in want]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_only"])
def test_crossing_overflow_matches_jax(fast):
    jgrid, tgrid = grids(random_occ(5, 0.003))
    a, b, valid = entries()
    nmax = np.full(a.shape[0], 64, np.int32)
    small, g_small = crossing_both(jgrid, tgrid, a, b, nmax, valid, fast, 64)
    big, g_big = crossing_both(jgrid, tgrid, a, b, nmax, valid, fast, 256 * S.max_edges)
    assert int(g_small) & GUARD_CROSS_DENSE and not int(g_big) & GUARD_CROSS_DENSE
    if fast:
        # the truncated buffers keep crossing edges the dense decision drops
        assert (big & ~small).any() and not (small & ~big).any()
    else:
        assert np.array_equal(small, big)


def test_crossing_coarse_sampling_matches_jax():
    jgrid, tgrid = grids(np.zeros((S.grid_h, S.grid_w), np.uint8))
    a = np.asarray([[1.0, 1.0]], np.float32)
    b = np.asarray([[9.0, 9.0]], np.float32)
    _, guards = crossing_both(jgrid, tgrid, a, b, np.asarray([16], np.int32),
                              np.asarray([True]), False, 32 * S.max_edges)
    assert int(guards) & GUARD_EDGE_COARSE


def edges_both(pos, owners, node_valid, occ, sxy, svalid, skind, fast=False):
    jgrid, tgrid = grids(occ)
    (jp, tp), (js, ts) = params(), ((JFAST, FAST) if fast else (JS, S))
    jseeds = JSeeds(xy=jnp.asarray(sxy), valid=jnp.asarray(svalid), kind=jnp.asarray(skind))
    tseeds = SeedSet(xy=torch.from_numpy(sxy), valid=torch.from_numpy(svalid),
                     kind=torch.from_numpy(skind))
    want = jax.jit(lambda p, o, v: jbuild_edges(p, o, v, jgrid, jseeds, jp, js))(
        jnp.asarray(pos), jnp.asarray(owners), jnp.asarray(node_valid))
    got = build_edges(torch.from_numpy(pos), torch.from_numpy(owners),
                      torch.from_numpy(node_valid), tgrid, tseeds, tp, ts)
    assert_same(want, got)
    return [np.asarray(x) for x in want]


def test_prox_partner_cap_matches_jax():
    N = S.max_nodes
    pos = np.ones((N, 2), np.float32) * 50.0
    pos[:12] = 5.0 + np.random.default_rng(0).uniform(0, 0.2, (12, 2))
    node_valid = np.zeros(N, bool)
    node_valid[:12] = True
    out = edges_both(pos, np.full((N, 4), -1, np.int32), node_valid,
                     np.zeros((S.grid_h, S.grid_w), np.uint8),
                     np.zeros((S.max_seeds, 2), np.float32), np.zeros(S.max_seeds, bool),
                     np.zeros(S.max_seeds, np.int32))
    assert int(out[5]) & GUARD_PROX_PPN


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_only"])
def test_ridge_compact_overflow_matches_jax(fast):
    N = S.max_nodes
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.5, 8.0, (N, 2)).astype(np.float32)
    owners = np.stack([rng.permutation(S.max_seeds)[:4] for _ in range(N)]).astype(np.int32)
    sxy = rng.uniform(0.0, 9.0, (S.max_seeds, 2)).astype(np.float32)
    out = edges_both(pos, owners, np.ones(N, bool), np.zeros((S.grid_h, S.grid_w), np.uint8),
                     sxy, np.ones(S.max_seeds, bool), np.zeros(S.max_seeds, np.int8), fast)
    assert int(out[5]) & GUARD_RIDGE_COMPACT
    assert int(out[4]) > 0


def cluster_both(occ, fast=False):
    jgrid, tgrid = grids(occ)
    (jp, tp), (jpoly, tpoly) = params(), no_polygon()
    js, ts = (JFAST, FAST) if fast else (JS, S)
    want = jax.jit(lambda g: jcluster_grid(g, jpoly, jp, js))(jgrid)
    got = cluster_grid(tgrid, tpoly, tp, ts)
    assert_same(want, got)
    return int(want["guards"])


@pytest.mark.parametrize("extra", [0, 4])
def test_cluster_cap_matches_jax(extra):
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    occ[8 + 8 * np.arange(S.max_clusters + extra), 8] = 1   # isolated 1-cell components
    assert bool(cluster_both(occ) & GUARD_CLUSTER_CAP) == (extra > 0)


def test_ccl_fallback_fast_only_matches_jax():
    assert cluster_both(random_occ(3, 0.30), fast=True) & GUARD_CCL_CELL_FALLBACK


@pytest.fixture(scope="module")
def built():
    """mode -> (JAX world, JAX perceive output, port world, port perceive
    output) of one seeded small orchard at DRYRUN_STATICS, exact and
    fast-only (``prepare_world_full``, ror_method="exact")."""
    pc, poly = jorchard(jax.random.PRNGKey(4), JSpec(**SMALL_SPEC), JS)
    tpc = PointCloud(xyz=torch.from_numpy(np.array(pc.xyz)),
                     valid=torch.from_numpy(np.array(pc.valid)))
    tpoly = to_torch(poly, Polygon, "cpu")
    jp, tp = params()
    out = {}
    for mode, js, ts in (("exact", JS, S), ("fast_only", JFAST, FAST)):
        jw, jout, _ = jax.jit(lambda pc, poly: jengine.prepare_world_full(
            pc, poly, jp, jnp.zeros((js.max_exclusions, 3), jnp.float32), js,
            ror_method="exact"))(pc, poly)
        tw, tout, _ = engine.prepare_world_full(tpc, tpoly, tp, torch.zeros((ts.max_exclusions, 3)),
                                                ts, ror_method="exact")
        out[mode] = (jw, jout, tw, tout)
    return out


@pytest.mark.parametrize("max_plan", [S.max_plan, 8])
def test_plan_cap_matches_jax(built, max_plan):
    """The world does not depend on max_plan; its ticks under a /plan buffer
    of 8 fill it and raise the guard, under the full buffer neither."""
    js = dataclasses.replace(JS, max_plan=max_plan)
    ts = dataclasses.replace(S, max_plan=max_plan)
    jworld, _, tworld, _ = built["exact"]
    jp = jc.params_as_f32(dataclasses.replace(jc.AosParams(), initial_arrive_dist=100.0))
    tp = params_as_f32(dataclasses.replace(AosParams(), initial_arrive_dist=100.0), "cpu")
    jstep = jax.jit(lambda st, w: jengine.step(st, w, jp, js))
    jst, tst = jengine.initial_state(jworld, js), engine.initial_state(tworld, ts)
    for _ in range(3):
        jst, jm = jstep(jst, jworld)
        tst, tm = engine.step(tst, tworld, tp, ts)
        assert_same(jm, tm)
    capped = int(jm["plan_len"]) == 8
    assert capped == (max_plan == 8)
    assert bool(int(jm["guards"]) & GUARD_PLAN_CAP) == capped


@pytest.mark.parametrize("mode", ["exact", "fast_only"])
def test_fast_only_matches_exact_without_overflow(built, mode):
    jw, jout, tw, tout = built[mode]
    assert_same(jout, tout)
    assert_same(jw, tw)
    assert int(tw.guards) == 0 and int(tw.graph.num_edges) > 0
    # both modes give the same perceive output and graph, bitwise
    _, _, ew, eout = built["exact"]
    assert_same(eout, tout)
    assert_same(ew.graph, tw.graph)
