"""Host IO of the port against the JAX package: the YAML parameter schema,
save_cluster_info, PCD files (numpy and native readers, files written by
either package), the native library, the ROS message dictionaries, and an
episode driven by a graph in the reference's wire format.

Every array, dictionary and file is compared exactly, the wire-format
episode's 150 ticks included (its plan points, yaws and poses carried 4 and
64-ulp bounds while the port rounded linearize and atan2 otherwise than
XLA:CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aosx.config as jc
from aosx import dashboard as jdash
from aosx import engine as jengine
from aosx.io import checkpoint as jckpt, pcd as jpcd, ros_msgs as jmsgs
from aosx.perceive import perceive as jperceive
from aosx.types import GvdGraph as JGraph, PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import dashboard, engine
from aosx_torch.config import TEST_STATICS as S, AosParams, load_yaml, params_as_f32
from aosx_torch.convert import to_torch
from aosx_torch.io import checkpoint, pcd, ros_msgs
from aosx_torch.native import binding
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.perceive.pipeline import PerceiveOut
from aosx_torch.plan.astar import cost_matrix
from aosx_torch.plan.mission import build_waypoints, trim_distance_plane
from aosx_torch.types import GridWorld, GvdGraph, Path
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401

YAML = """/**:
  ros__parameters:
    grid_resolution: 0.05
    inflation_radius: 0.8
    clipping_minz: -0.3
    clipping_maxx: 72.0
    cluster_min_length: 2.5
/aos_seed_gen_node:
  ros__parameters:
    clipping_minz: -0.4
    inflation_radius: 0.85
"""


@pytest.mark.parametrize("node", ["aos_seed_gen_node", "aos_gvd_node"])
def test_load_yaml_matches_jax(tmp_path, node):
    p = tmp_path / "p.yaml"
    p.write_text(YAML)
    jparams, jstatics = jc.load_yaml(str(p), node)
    params, statics = load_yaml(str(p), node)
    assert statics == jstatics
    assert {k: float(v) for k, v in vars(params).items()} == \
        {k: float(v) for k, v in vars(jparams).items()}


def test_params_set_roundtrip_matches_jax(tmp_path):
    for mod, name in ((jdash, "j.yaml"), (dashboard, "t.yaml")):
        p = tmp_path / name
        p.write_text("/**:\n  ros__parameters:\n    grid_resolution: 0.05\n")
        mod.params_set(str(p), {"inflation_radius": 0.9})
    assert (tmp_path / "j.yaml").read_text() == (tmp_path / "t.yaml").read_text()
    assert dashboard.params_get(str(tmp_path / "t.yaml"))[1]["inflation_radius"] == 0.9


@pytest.fixture(scope="module")
def test_world():
    """The JAX package's perceive output and world on the test orchard."""
    buf, valid, poly = orchard_buffers(S, seed=0)
    jp = jc.params_as_f32(jc.AosParams())
    args = (JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)),
            JPolygon.from_array(poly, jc.TEST_STATICS), jp,
            jnp.zeros((S.max_exclusions, 3), jnp.float32))
    jworld, jout, _ = jax.jit(lambda *a: jengine.prepare_world_full(*a, jc.TEST_STATICS))(*args)
    out = to_torch(jout, PerceiveOut, "cpu")
    world = engine.world_from_perceive(out, params_as_f32(AosParams(), "cpu"), S)
    return jworld, jout, world, out


def test_save_cluster_info_matches_jax(tmp_path, test_world):
    jworld, jout, world, out = test_world
    jckpt.save_cluster_info(str(tmp_path / "j"), jworld.graph, jout.rows_sorted)
    checkpoint.save_cluster_info(str(tmp_path / "t"), world.graph, out.rows_sorted)
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_roundtrip_and_cross_package(tmp_path, monkeypatch, binary):
    xyz = np.random.default_rng(0).normal(0, 5, (500, 3)).astype(np.float32)
    pcd.save_pcd(str(tmp_path / "t.pcd"), xyz, binary=binary)
    jpcd.save_pcd(str(tmp_path / "j.pcd"), xyz, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    for native in (True, False):
        if not native:
            monkeypatch.setattr(binding, "available", lambda: False)
        back = pcd.load_pcd(str(tmp_path / "j.pcd"))
        assert back.dtype == np.float32 and back.shape == xyz.shape
        assert np.array_equal(back, jpcd.load_pcd(str(tmp_path / "t.pcd")))
        if binary:
            assert np.array_equal(back, xyz)


def test_native_reader_takes_binary_files(tmp_path, monkeypatch):
    assert binding.available(), "g++ builds the native library here"
    xyz, _ = make_orchard_np(OrchardSpec(n_rows=2, row_len=6.0), seed=1)
    p = str(tmp_path / "map.pcd")
    pcd.save_pcd(p, xyz.astype(np.float32))
    calls = binding.load_pcd_xyz.calls
    got = pcd.load_pcd(p)
    assert binding.load_pcd_xyz.calls == calls + 1
    monkeypatch.setattr(binding, "available", lambda: False)
    assert np.array_equal(got, pcd.load_pcd(p))
    assert binding.load_pcd_xyz.calls == calls + 1
    assert np.array_equal(got, xyz.astype(np.float32))


def test_native_thin_and_label_match_references():
    from aosx.oracle import perceive as oracle

    ndi = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(3)
    img = (rng.random((64, 96)) < 0.5).astype(np.uint8)
    assert (binding.thin(img) == oracle.zhang_suen_thin(img)).all()
    mask = rng.random((40, 50)) < 0.3
    labels, n = binding.label(mask)
    ref, rn = ndi.label(mask, structure=np.ones((3, 3)))
    assert n == rn and np.array_equal(labels, ref - 1)


def test_pcd_replay_perceive_matches_jax(tmp_path):
    """A map through the PCD file and both packages' perceive."""
    from aosx_torch.perceive.pipeline import perceive
    from aosx_torch.types import PointCloud, Polygon

    xyz, poly = make_orchard_np(OrchardSpec(n_rows=2, row_len=6.0), seed=1)
    p = str(tmp_path / "map.pcd")
    pcd.save_pcd(p, xyz.astype(np.float32))
    back = pcd.load_pcd(p)
    buf = np.zeros((S.max_points, 3), np.float32)
    buf[:len(back)] = back
    valid = np.zeros(S.max_points, bool)
    valid[:len(back)] = True
    JS = jc.TEST_STATICS
    ref = jax.jit(lambda pc, pl, pr, ex: jperceive(pc, pl, pr, ex, JS, ror_method="exact"))(
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)),
        JPolygon.from_array(poly.astype(np.float32), JS), jc.params_as_f32(jc.AosParams()),
        jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    got = perceive(PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
                   Polygon.from_array(poly.astype(np.float32), S, "cpu"),
                   params_as_f32(AosParams(), "cpu"), torch.zeros((S.max_exclusions, 3)), S,
                   ror_method="exact")
    assert_same(ref, got)
    assert int(got.rows.valid.sum()) == 2


def _fabricated_graph(make, zeros, arange, i32, N, E, C):
    nodes = np.zeros((N, 2), np.float32)
    nodes[:4] = [[0, 0], [1, 0], [0, 1], [1, 1]]
    label_node = np.full((C, 4), -1, np.int32)
    label_node[0] = [0, 1, 2, 3]
    label_node[1, 0] = 1  # node 1 also TL of cluster 1
    labels = np.zeros(N, np.int32)
    labels[:4] = [1, 2 | 1, 4, 8]
    edges = np.array([[0, 1], [1, 3]] + [[-1, -1]] * (E - 2), np.int32)
    lengths = np.array([1.0, 1.0] + [0.0] * (E - 2), np.float32)
    return dict(nodes=make(nodes), node_valid=arange(N) < 4, node_labels=make(labels),
                label_node=make(label_node), edges=make(edges), edge_valid=arange(E) < 2,
                edge_lengths=make(lengths), edge_clearances=zeros(E),
                num_nodes=i32(4), num_edges=i32(2))


def test_gvd_graph_msg_export_matches_jax():
    N, E, C = S.max_nodes, S.max_edges, S.max_rows
    jg = JGraph(**_fabricated_graph(jnp.asarray, lambda n: jnp.zeros(n, jnp.float32), jnp.arange,
                                    jnp.int32, N, E, C))
    tg = GvdGraph(**_fabricated_graph(torch.from_numpy,
                                      lambda n: torch.zeros(n, dtype=torch.float32), torch.arange, lambda v: torch.tensor(v, dtype=torch.int32),
                                      N, E, C))
    msg = ros_msgs.gvd_graph_to_msg(tg, 0.05, -1.0, -2.0)
    assert msg == jmsgs.gvd_graph_to_msg(jg, 0.05, -1.0, -2.0)
    assert msg["node_label_counts"] == [1, 2, 1, 1]
    assert msg["node_label_clusters"] == [0, 0, 1, 0, 0]
    assert msg["node_label_types"] == [0, 1, 0, 2, 3]
    for a, b in zip(ros_msgs.msg_to_gvd_arrays(msg), jmsgs.msg_to_gvd_arrays(msg)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the legacy bitmask encoding
    legacy = {k: v for k, v in msg.items() if not k.startswith("node_label_")}
    for a, b in zip(ros_msgs.msg_to_gvd_arrays(legacy), jmsgs.msg_to_gvd_arrays(legacy)):
        assert np.array_equal(a, b)


def test_world_msgs_match_jax(test_world):
    jworld, _, world, _ = test_world
    args = (S.resolution, float(world.skeleton.origin_x), float(world.skeleton.origin_y))
    msg = ros_msgs.gvd_graph_to_msg(world.graph, *args)
    assert msg == jmsgs.gvd_graph_to_msg(jworld.graph, *args)
    assert ros_msgs.occupancy_grid_to_msg(world.occupancy, S.resolution) == \
        jmsgs.occupancy_grid_to_msg(jworld.occupancy, S.resolution)
    n = 40
    xy = np.random.default_rng(2).uniform(-5, 20, (S.max_path, 2)).astype(np.float32)
    yaw = np.random.default_rng(3).uniform(-3.1, 3.1, S.max_path).astype(np.float32)
    from aosx.types import Path as JPath

    assert ros_msgs.path_to_msg(Path(xy=torch.from_numpy(xy), yaw=torch.from_numpy(yaw),
                                     count=torch.tensor(n, dtype=torch.int32))) == \
        jmsgs.path_to_msg(JPath(xy=jnp.asarray(xy), yaw=jnp.asarray(yaw), count=jnp.int32(n)))
    # the message back into a graph: the same graph, clearances 0
    back = ros_msgs.msg_to_gvd_graph(msg, S, "cpu")
    assert_same(jmsgs.msg_to_gvd_graph(msg, jc.TEST_STATICS), back)
    e = int(world.graph.num_edges)
    for f in ("nodes", "node_valid", "node_labels", "label_node", "edges", "edge_valid",
              "num_nodes", "num_edges"):
        assert torch.equal(getattr(back, f), getattr(world.graph, f)), f
    assert torch.equal(back.edge_lengths[:e], world.graph.edge_lengths[:e])


REF_STEPS = 150


def test_reference_graph_episode_matches_jax():
    """A graph in the C++ node's wire format (built from the JAX package's
    Subdiv2D oracle, as tests/test_ref_format.py builds it) drives an
    episode in both packages: the same graph, tour, metrics and state."""
    from aosx.oracle import gvd as og, perceive as op
    from aosx.plan.astar import cost_matrix as jcosts
    from aosx.plan.mission import build_waypoints as jwaypoints, trim_distance_plane as jtrim
    from test_ref_format import _grid_to_world, _ref_graph_to_msg

    JS = jc.TEST_STATICS
    xyz, poly = make_orchard_np(OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0),
                                            noise_pts=64), seed=0)
    ores = op.perceive(xyz, poly)
    ref = og.gvd_graph(ores.seeds, ores.skeleton, ores.rows_sorted)
    msg = _ref_graph_to_msg(ref, ores.skeleton.resolution, ores.skeleton.origin_x,
                            ores.skeleton.origin_y)
    jp = jc.params_as_f32(jc.AosParams())
    jgraph = jmsgs.msg_to_gvd_graph(msg, JS)
    jskel, jocc = _grid_to_world(ores.skeleton, JS), _grid_to_world(ores.occupancy, JS)
    jcost, jwp, jtrimp = jax.jit(lambda g, sk: (jcosts(g, JS), jwaypoints(g, jp, JS),
                                               jtrim(sk, JS)))(jgraph, jskel)
    jworld = jengine.World(skeleton=jskel, occupancy=jocc, graph=jgraph, costmat=jcost,
                           waypoints=jwp, trim_skel=jtrimp)
    jfinal, jmetrics = jax.jit(lambda w, p: jengine.episode(w, p, JS, REF_STEPS))(jworld, jp)

    pt = params_as_f32(AosParams(), "cpu")
    graph = ros_msgs.msg_to_gvd_graph(msg, S, "cpu")
    assert_same(jgraph, graph)
    skel, occ = to_torch(jskel, GridWorld, "cpu"), to_torch(jocc, GridWorld, "cpu")
    world = engine.World(skeleton=skel, occupancy=occ, graph=graph, costmat=cost_matrix(graph, S),
                         waypoints=build_waypoints(graph, pt, S),
                         guards=torch.zeros((), dtype=torch.int32),
                         trim_skel=trim_distance_plane(skel, S))
    assert_same(jworld.waypoints, world.waypoints)
    final, metrics = engine.episode(world, pt, S, REF_STEPS)
    assert_same(jmetrics, metrics)
    assert_same(jfinal, final)
    assert bool(final.mission.initial_reached) and int(world.waypoints.count) >= 4
