"""Edge clearances of the port (``aosx_torch/gvd/clearance.py``) against the
JAX package's (``aosx/gvd/clearance.py``) and scipy's exact distance
transform.

The distance field is bitwise equal to JAX's and within 1e-5 m of scipy's;
edge clearances and whole graphs built with ``compute_clearances=True`` are
bitwise equal to JAX's on orchards of each world-parity spec, every leaf. The
port rounds the edge samples a + t * (b - a) once, divides by the resolution
as a product with its f32 reciprocal, and rounds the squared edge length's
two products apart (with clearances XLA:CPU shares the edge-end gathers with
the samples and does not contract them), as XLA:CPU compiles the
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.gvd import build_gvd_graph as jgraph
from aosx.gvd.clearance import edge_clearances as jedge, obstacle_distance_field as jfield
from aosx.perceive import perceive as jperceive
from aosx.types import GridWorld as JGrid, PointCloud as JCloud, Polygon as JPolygon
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_torch
from aosx_torch.gvd.clearance import edge_clearances, obstacle_distance_field
from aosx_torch.gvd.graph import build_gvd_graph
from aosx_torch.perceive.pipeline import PerceiveOut
from aosx_torch.types import GridWorld
from torch_helpers import WORLD_SPECS as SPECS, assert_same, one_torch_thread, orchard_buffers  # noqa: F401,E501


def _grids(occ):
    j = JGrid(occ=jnp.asarray(occ), origin_x=jnp.float32(0), origin_y=jnp.float32(0),
              h_cells=jnp.int32(occ.shape[0]), w_cells=jnp.int32(occ.shape[1]))
    t = GridWorld(occ=torch.from_numpy(occ), origin_x=torch.tensor(0.0),
                  origin_y=torch.tensor(0.0), h_cells=torch.tensor(occ.shape[0], dtype=torch.int32),
                  w_cells=torch.tensor(occ.shape[1], dtype=torch.int32))
    return j, t


def test_distance_field_matches_jax_and_scipy():
    ndi = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(0)
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    occ[40:300, 40:460] = rng.random((260, 420)) < 0.003
    jg, tg = _grids(occ)
    ref = np.asarray(jax.jit(lambda g: jfield(g, JS))(jg))
    got = obstacle_distance_field(tg, S).numpy()
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))
    edt = ndi.distance_transform_edt(~occ.astype(bool)) * S.resolution
    assert np.abs(got - edt).max() < 1e-5


def test_edge_clearance_values_match_jax():
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    occ[100, 200] = 1  # a single obstacle at (10.0, 5.0) m
    jg, tg = _grids(occ)
    pos = np.array([[5.0, 4.0], [15.0, 4.0], [10.0, 7.5], [9.9, 5.1]], np.float32)
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], np.int32)
    valid = np.array([True, True, True, False])
    jd = jax.jit(lambda g: jfield(g, JS))(jg)
    ref = np.asarray(jax.jit(lambda d, g, p, e, v: jedge(d, g, p, e, v, JS))(
        jd, jg, jnp.asarray(pos), jnp.asarray(edges), jnp.asarray(valid)))
    got = edge_clearances(obstacle_distance_field(tg, S), tg, torch.from_numpy(pos),
                          torch.from_numpy(edges), torch.from_numpy(valid), S).numpy()
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))
    assert abs(got[0] - 1.0) < 0.08 and got[3] == 0.0  # ~1 m below the obstacle; invalid


@pytest.fixture(scope="module")
def jax_graph():
    p = jparams(JParams())
    per = jax.jit(lambda pc, poly, ex: jperceive(pc, poly, p, ex, JS))
    graph = jax.jit(lambda o: jgraph(o.seeds, o.rows_sorted, o.skeleton, p, JS,
                                     compute_clearances=True))
    return per, graph


@pytest.mark.parametrize("spec,seed", [(name, seed) for name in SPECS for seed in (0, 5)])
def test_graph_clearances_match_jax(jax_graph, spec, seed):
    per, graph = jax_graph
    buf, valid, poly = orchard_buffers(S, seed=seed, spec=SPECS[spec])
    jout = per(JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)),
               JPolygon.from_array(poly, JS), jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    ref = graph(jout)
    o = to_torch(jout, PerceiveOut, "cpu")
    got = build_gvd_graph(o.seeds, o.rows_sorted, o.skeleton, params_as_f32(AosParams(), "cpu"),
                          S, compute_clearances=True)
    assert_same(ref, got)
    e = int(got.num_edges)
    assert (got.edge_clearances[:e] > 0).all() and (got.edge_clearances[e:] == 0).all()
