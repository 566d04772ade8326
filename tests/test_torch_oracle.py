"""The port's NumPy oracle (``aosx_torch/oracle``) and the port's pipeline
against it.

1. The copy against ``aosx.oracle``: every public function runs once in both
   packages on the same inputs (``make_orchard_np(OrchardSpec(), 0)``, a
   no-polygon orchard, a random graph, hand-made paths) and the outputs are
   bitwise equal; the NumPy branch of ``morph_open`` (OpenCV blocked) equals
   its OpenCV branch.
2. The port's CPU pipeline against the port's oracle: the grid-level anchors
   of tests/test_perceive_grids.py, test_rows.py, test_seeds.py,
   test_gvd.py, test_plan.py and test_no_polygon.py, where the port runs in
   place of JAX, with the tolerances those tests state (each test cites the
   one it mirrors)."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from aosx.oracle import gvd as jog
from aosx.oracle import perceive as jop
from aosx.oracle import plan as jplan
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.gvd import graph as tgraph
from aosx_torch.oracle import gvd as og
from aosx_torch.oracle import perceive as op
from aosx_torch.oracle import plan as oplan
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.parallel.batch import cloud_tensors
from aosx_torch.perceive import points as tpoints
from aosx_torch.perceive import raster as traster
from aosx_torch.perceive import rows as trows
from aosx_torch.perceive import skeleton as tskel
from aosx_torch.perceive.pipeline import perceive as tperceive
from aosx_torch.plan import astar as tastar
from aosx_torch.plan import control as tctrl
from aosx_torch.plan import linearize as tlin
from aosx_torch.plan.mission import build_waypoints
from aosx_torch.types import (ControlState, GridWorld, GvdGraph, Path, Polygon, SeedSet,
                              TreeRows)
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NO_POLY_CLIP = (0.0, 14.0, 0.0, 10.0)


def assert_equal(a, b, where="result"):
    """Bitwise equality of two oracle results: dataclasses field by field,
    sequences and dicts element by element, arrays with their dtypes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a.view(np.uint8) if a.dtype.kind == "f" else a,
                              b.view(np.uint8) if b.dtype.kind == "f" else b), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


# ---------------------------------------------------------------------------
# 1. the copy against aosx.oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def default_orchard():
    """tests/test_oracle.py's orchard and both packages' oracle results."""
    xyz, poly = make_orchard_np(OrchardSpec(), seed=0)
    return xyz, poly, jop.perceive(xyz, poly), op.perceive(xyz, poly)


def test_perceive_copy_matches(default_orchard):
    _, _, want, got = default_orchard
    assert_equal(want, got)
    assert len(got.rows_all) == 4 and len(got.seeds) > 10


def test_perceive_copy_matches_without_polygon():
    xyz, _ = make_orchard_np(OrchardSpec(n_rows=2, row_len=8.0, origin=(3.0, 3.0)), seed=7)
    assert_equal(jop.perceive(xyz, None, clip_xy=NO_POLY_CLIP),
                 op.perceive(xyz, None, clip_xy=NO_POLY_CLIP))


def test_gvd_copy_matches(default_orchard):
    """gvd_graph (Subdiv2D edges, boundary points, build_graph, the outside
    filter, label rays) and build_graph on its own."""
    _, _, jres, res = default_orchard
    want = jog.gvd_graph(jres.seeds, jres.skeleton, jres.rows_sorted)
    got = og.gvd_graph(res.seeds, res.skeleton, res.rows_sorted)
    assert_equal(want, got)
    assert len(got.edges) > 100
    seeds = og.merge_seeds(res.seeds)
    box = (res.skeleton.origin_x, res.skeleton.origin_x + res.skeleton.w * 0.05,
           res.skeleton.origin_y, res.skeleton.origin_y + res.skeleton.h * 0.05)
    vedges = og.compute_voronoi_edges(seeds, *box)
    bpts = og.extract_boundary_points(vedges)
    assert_equal(jog.build_graph(bpts, vedges, jres.skeleton),
                 og.build_graph(bpts, vedges, res.skeleton))


def _random_graph(rng, n_nodes=40, n_edges=90):
    """tests/test_plan.py's random graph."""
    nodes = rng.uniform(0, 20, (n_nodes, 2)).astype(np.float32)
    edges = set()
    while len(edges) < n_edges:
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    edges = sorted(edges)
    lengths = [float(np.linalg.norm(nodes[a] - nodes[b])) for a, b in edges]
    return nodes, edges, lengths


@pytest.fixture(scope="module")
def graph():
    return _random_graph(np.random.default_rng(7))


def _linearize_cases():
    """tests/test_plan.py::test_linearize_parity's paths."""
    rng = np.random.default_rng(5)
    xs = np.linspace(0, 8, 24)
    ys = np.where(xs < 4, 0.02 * xs, 0.08 + 0.9 * (xs - 4))
    zig = np.stack([xs, ys], 1) + rng.normal(0, 0.005, (24, 2))
    xh = np.linspace(0, 4, 12)
    hair = np.concatenate([np.stack([xh, 0.02 * xh], 1),
                           np.stack([xh[::-1][1:], 0.1 + 0.02 * xh[::-1][1:]], 1),
                           [[0.0, 2.0]]], 0)
    xl = np.linspace(8, 0.0, 30)
    long_ = np.stack([xl, np.abs(np.sin(xl)) * 0.5], 1)
    long_[-1] = [0.0, 0.0]
    return {
        "two": np.array([[0.0, 0.0], [1.3, 0.7]]),
        "four": np.array([[0, 0], [1, 0.1], [2, -0.1], [3.0, 0.4]]),
        "zigzag": zig,
        "reversal": np.array([[0, 0], [1.0, 0.0], [2.0, 0.0], [1.2, 0.05], [1.2, 1.5],
                              [0.5, 2.0]]),
        "double_back": np.array([[0, 0], [2.0, 0.1], [0.3, 0.0], [0.3, 2.0]]),
        "hairpin_mid": hair,
        "long": long_,
    }


def _control_script():
    """tests/test_plan.py::test_control_parity's approach along x."""
    return np.concatenate([np.linspace(0, 4.6, 30), np.linspace(4.62, 5.0, 40)])


def test_plan_copy_matches(graph, default_orchard):
    """astar, plan_graph_path (on-graph target and origin return),
    linearize_path, trim_path_near_occupied, build_waypoint_sequence,
    path_yaws, initial_straight_path and a ControlSM tick sequence."""
    nodes, edges, lengths = graph
    n64 = nodes.astype(np.float64)
    adj = oplan.build_adjacency(len(nodes), edges)
    assert_equal(jplan.build_adjacency(len(nodes), edges), adj)
    elen = {e: ln for e, ln in zip(edges, lengths)}
    rng = np.random.default_rng(1)
    for _ in range(12):
        a, b = map(int, rng.integers(0, len(nodes), 2))
        p = oplan.astar(n64, adj, elen, a, b)
        assert_equal(jplan.astar(n64, adj, elen, a, b), p)
        assert_equal(jplan.path_cost(nodes, elen, p), oplan.path_cost(nodes, elen, p))
    start = np.array([5.0, 5.0])
    for target_node, target in ((7, n64[7]), (-1, np.array([0.0, 0.0]))):
        want = jplan.plan_graph_path(n64, adj, elen, start, target_node, target)
        got = oplan.plan_graph_path(n64, adj, elen, start, target_node, target)
        assert_equal(want, got)
        assert_equal(jplan.path_yaws(want, None), oplan.path_yaws(got, None))
        assert_equal(jplan.path_yaws(want, n64[3]), oplan.path_yaws(got, n64[3]))
    assert_equal(jplan.k_nearest(nodes, start, 5), oplan.k_nearest(nodes, start, 5))
    for name, pts in _linearize_cases().items():
        assert_equal(jplan.linearize_path(pts), oplan.linearize_path(pts), name)
    assert_equal(jplan.initial_straight_path(), oplan.initial_straight_path())
    label_node = np.random.default_rng(3).choice(len(nodes), (3, 4), replace=False)
    cl = oplan.build_cluster_waypoint_mapping(label_node)
    assert_equal(jplan.build_cluster_waypoint_mapping(label_node), cl)
    assert_equal(jplan.build_waypoint_sequence(cl, n64), oplan.build_waypoint_sequence(cl, n64))

    # trim: a straight run across the orchard's first tree row
    _, _, jres, res = default_orchard
    r = res.rows_all[0]
    run = np.stack([np.full(40, r.center[0]), r.center[1] - 2.0 + 0.1 * np.arange(40)], 1)
    got = oplan.trim_path_near_occupied(run, res.skeleton)
    assert_equal(jplan.trim_path_near_occupied(run, jres.skeleton), got)
    assert 1 < len(got) < len(run)

    jsm, sm = jplan.ControlSM(), oplan.ControlSM()
    pts = np.stack([np.linspace(0, 5, 101), np.zeros(101)], 1)
    jsm.on_path(pts, np.zeros(101))
    sm.on_path(pts, np.zeros(101))
    mods = [sm.tick(np.array([x, 0.0]), 0.0) for x in _control_script()]
    assert mods == [jsm.tick(np.array([x, 0.0]), 0.0) for x in _control_script()]
    assert_equal(jsm, sm)
    assert 3 in mods


def test_morph_open_numpy_branch_equals_cv2(monkeypatch):
    """Without OpenCV (the card's machine has none) morph_open takes its
    NumPy branch, which equals the OpenCV branch."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    imgs = [(rng.random((64, 96)) < p).astype(np.uint8) for p in (0.2, 0.4, 0.7)]
    imgs.append(np.ones((9, 7), np.uint8))
    with_cv2 = [op.morph_open(im) for im in imgs]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for im, want in zip(imgs, with_cv2):
        got = op.morph_open(im)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# 2. the port's pipeline against the port's oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


@pytest.fixture(scope="module")
def small(params):
    """tests/test_perceive_grids.py's orchard (3 rows of 12 m, seed 3): the
    oracle's result (f64 inputs) and the port's grid stages at TEST_STATICS."""
    xyz, poly = make_orchard_np(OrchardSpec(n_rows=3, row_len=12.0), seed=3)
    xyz, poly = xyz.astype(np.float32), poly.astype(np.float32)
    ores = op.perceive(xyz.astype(np.float64), poly.astype(np.float64))
    pc, tpoly = cloud_tensors((xyz, poly), S, CPU)
    excl = torch.zeros((S.max_exclusions, 3), dtype=torch.float32)
    xy, keep, bounds, _ = tpoints.preprocess(pc, tpoly, params, excl, S)
    grid = traster.generate_grid(xy, keep, bounds, S)
    inflated = traster.inflate(grid, S)
    skel = tskel.skeletonize(inflated, S)
    grids = dict(raw=grid, occupancy=traster.mark_borders(inflated), skeleton=skel,
                 skeleton_pub=traster.mark_polygon_rect(skel, tpoly, params.polygon_margin, S))
    out = tperceive(pc, tpoly, params, excl, S, ror_method="exact")
    return dict(xyz=xyz, poly=poly, ores=ores, grids=grids, out=out, tpoly=tpoly)


def _live(g: GridWorld):
    return g.occ[:int(g.h_cells), :int(g.w_cells)].numpy()


def test_raw_grid_parity(small):
    """tests/test_perceive_grids.py::test_raw_grid_parity (bitwise)."""
    xyz, poly = small["xyz"].astype(np.float64), small["poly"].astype(np.float64)
    keep = op.radius_outlier_removal(xyz)
    pts = op.preprocess_points(xyz[keep], poly, (-0.4, 0.5), (-5.0, 72.0, -10.0, 20.0),
                               np.zeros((0, 3)))
    og_ = op.generate_occupancy_grid(pts, op.active_bounds(poly, None), 0.05)
    got = _live(small["grids"]["raw"])
    assert got.shape == og_.data.shape and (got == (og_.data == 100)).all()


@pytest.mark.parametrize("name", ["occupancy", "skeleton", "skeleton_pub"])
def test_grid_parity(small, name):
    """tests/test_perceive_grids.py::test_inflated_parity (the occupancy plane
    with its borders), ::test_skeleton_parity and ::test_skeleton_pub_parity
    (bitwise)."""
    got = _live(small["grids"][name])
    ref = getattr(small["ores"], name).data == 100
    assert got.shape == ref.shape and (got == ref).all()


@pytest.fixture(scope="module")
def port_rows(small, params):
    """tests/test_rows.py's setup: the port's clustering on the oracle's
    skeleton."""
    ores = small["ores"]
    skel_np = (ores.skeleton.data == 100).astype(np.uint8)
    h, w = skel_np.shape
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    occ[:h, :w] = skel_np
    grid = GridWorld(torch.from_numpy(occ), torch.tensor(ores.skeleton.origin_x,
                                                         dtype=torch.float32),
                     torch.tensor(ores.skeleton.origin_y, dtype=torch.float32),
                     torch.tensor(h, dtype=torch.int32), torch.tensor(w, dtype=torch.int32))
    clusters = trows.cluster_grid(grid, small["tpoly"], params, S)
    rows = trows.rows_from_clusters(clusters, grid, small["tpoly"], params, S)
    return clusters, rows, trows.sort_rows(rows)


def test_clusters_match_oracle(small, port_rows):
    """tests/test_rows.py::test_cluster_count_and_sizes and
    ::test_cluster_centers_and_lengths (centres 1e-3, lengths 1e-4)."""
    ores = small["ores"]
    clusters = port_rows[0]
    n = int(clusters["n_clusters"])
    assert n == len(ores.clusters)
    assert list(clusters["count"][:n].numpy().astype(int)) == [c.size for c in ores.clusters]
    for i, c in enumerate(ores.clusters):
        assert abs(float(clusters["center_x"][i]) - c.center_x) < 1e-3
        assert abs(float(clusters["center_y"][i]) - c.center_y) < 1e-3
        assert abs(float(clusters["length"][i]) - c.length) < 1e-4


def test_rows_match_oracle(small, port_rows):
    """tests/test_rows.py::test_rows_match and ::test_rows_sorted (1e-4)."""
    ores = small["ores"]
    _, rows, rows_sorted = port_rows
    nv = int(rows.valid.sum())
    assert nv == len(ores.rows_all)
    for i, r in enumerate(ores.rows_all):
        assert np.allclose(rows.center[i].numpy(), r.center, atol=1e-4)
        assert np.allclose(rows.ep1[i].numpy(), r.start_point, atol=1e-4)
        assert np.allclose(rows.ep2[i].numpy(), r.end_point, atol=1e-4)
    for i, r in enumerate(ores.rows_sorted):
        assert np.allclose(rows_sorted.center[i].numpy(), r.center, atol=1e-4)


def test_seeds_match_oracle(small):
    """tests/test_seeds.py: seed count, positions and order (1e-3), kinds,
    and the row count of the full perceive."""
    ores, out = small["ores"], small["out"]
    n = int(out.seeds.valid.sum())
    assert n == len(ores.seeds)
    assert np.abs(out.seeds.xy[:n].numpy() - ores.seeds).max() < 1e-3
    kinds = out.seeds.kind[:n].numpy()
    nv, nr = len(ores.virtual_seeds), len(ores.ray_seeds)
    assert (kinds[:nv] == 0).all() and (kinds[nv:nv + nr] == 2).all()
    assert (kinds[nv + nr:] == 3).all()
    assert int(out.rows.valid.sum()) == len(ores.rows_all)


def test_no_polygon_matches_oracle(params):
    """tests/test_no_polygon.py: the occupancy and published skeleton planes
    bitwise, rows and seed counts, seed positions (1e-3), without a
    polygon."""
    xyz, _ = make_orchard_np(OrchardSpec(n_rows=2, row_len=8.0, origin=(3.0, 3.0)), seed=7)
    ores = op.perceive(xyz, None, clip_xy=NO_POLY_CLIP)
    pc, _ = cloud_tensors((xyz, np.zeros((0, 2))), S, CPU)
    poly = Polygon.from_array(np.zeros((0, 2), np.float32), S, CPU)
    p = params_as_f32(AosParams(clipping_minx=0.0, clipping_maxx=14.0, clipping_miny=0.0,
                                clipping_maxy=10.0), CPU)
    out = tperceive(pc, poly, p, torch.zeros((S.max_exclusions, 3)), S, ror_method="exact")
    h, w = int(out.occupancy.h_cells), int(out.occupancy.w_cells)
    assert (h, w) == ores.occupancy.data.shape
    assert (out.occupancy.occ[:h, :w].numpy() == (ores.occupancy.data == 100)).all()
    assert (out.skeleton_pub.occ[:h, :w].numpy() == (ores.skeleton_pub.data == 100)).all()
    assert int(out.rows.valid.sum()) == len(ores.rows_all)
    n = int(out.seeds.valid.sum())
    assert n == len(ores.seeds)
    assert np.abs(out.seeds.xy[:n].numpy() - ores.seeds).max() < 1e-3


@pytest.fixture(scope="module")
def gvd_setup(small, params):
    """tests/test_gvd.py's setup for its first orchard: the port's graph on
    the oracle's skeleton, seeds and sorted rows, and the Subdiv2D graph."""
    pytest.importorskip("cv2")
    ores = small["ores"]
    skel_np = (ores.skeleton.data == 100).astype(np.uint8)
    h, w = skel_np.shape
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    occ[:h, :w] = skel_np
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    skel = GridWorld(torch.from_numpy(occ), f32(ores.skeleton.origin_x),
                     f32(ores.skeleton.origin_y), torch.tensor(h, dtype=torch.int32),
                     torch.tensor(w, dtype=torch.int32))
    ns = len(ores.seeds)
    sxy = np.zeros((S.max_seeds, 2), np.float32)
    sxy[:ns] = ores.seeds
    seeds = SeedSet(torch.from_numpy(sxy), torch.arange(S.max_seeds) < ns,
                    torch.zeros(S.max_seeds, dtype=torch.int8))
    R = S.max_rows
    cols = {k: np.zeros((R, 2), np.float32) for k in ("center", "ep1", "ep2")}
    ln, va = np.zeros(R, np.float32), np.zeros(R, bool)
    for i, r in enumerate(ores.rows_sorted):
        cols["center"][i], cols["ep1"][i], cols["ep2"][i] = r.center, r.start_point, r.end_point
        ln[i], va[i] = r.length, True
    rows = TreeRows(center=torch.from_numpy(cols["center"]), ep1=torch.from_numpy(cols["ep1"]),
                    ep2=torch.from_numpy(cols["ep2"]), length=torch.from_numpy(ln),
                    valid=torch.from_numpy(va))
    g = tgraph.build_gvd_graph(seeds, rows, skel, params, S)
    ref = og.gvd_graph(ores.seeds, ores.skeleton, ores.rows_sorted)
    return ores, g, ref, seeds


def test_gvd_seed_merge_matches_oracle(gvd_setup, params):
    """tests/test_gvd.py::test_seed_merge_parity (1e-3)."""
    ores, _, _, seeds = gvd_setup
    merged = tgraph.merge_seeds(seeds, params, S)
    ref = og.merge_seeds(ores.seeds)
    n = int(merged.valid.sum())
    assert n == len(ref)
    assert np.abs(merged.xy[:n].numpy() - ref).max() < 1e-3


def test_gvd_graph_matches_oracle(gvd_setup):
    """tests/test_gvd.py::test_node_coverage (every Subdiv2D node within 3
    cells of a port node, at most max(1, 2 %) missed),
    ::test_edge_correspondence (>= 98 % direct or via one node, >= 90 %
    direct, at most 1 miss) and ::test_label_decisions (the same labelled
    (cluster, corner) pairs, points within 0.5 m)."""
    ores, g, ref, _ = gvd_setup
    n = int(g.num_nodes)
    nodes = g.nodes[:n].numpy()
    d = np.linalg.norm(nodes[None, :, :] - np.asarray(ref.nodes)[:, None, :], axis=2)
    nearest, mind = d.argmin(1), d.min(1)
    tol = 3 * 0.05
    assert int((mind > tol).sum()) <= max(1, int(0.02 * len(ref.nodes)))
    adj, nbr = set(), {}
    for a, b in g.edges[:int(g.num_edges)].numpy():
        adj.add((min(a, b), max(a, b)))
        nbr.setdefault(int(a), set()).add(int(b))
        nbr.setdefault(int(b), set()).add(int(a))
    direct = via1 = miss = 0
    for a, b in ref.edges:
        if mind[a] > tol or mind[b] > tol or nearest[a] == nearest[b]:
            continue
        ma, mb = int(nearest[a]), int(nearest[b])
        if (min(ma, mb), max(ma, mb)) in adj:
            direct += 1
        elif nbr.get(ma, set()) & nbr.get(mb, set()):
            via1 += 1
        else:
            miss += 1
    tot = direct + via1 + miss
    assert tot > 0 and miss <= 1 and (direct + via1) / tot >= 0.98, (direct, via1, miss)
    assert direct / tot >= 0.90, (direct, via1, miss)
    jln = g.label_node.numpy()
    for c in range(len(ores.rows_sorted)):
        for li in range(4):
            assert (jln[c, li] >= 0) == (ref.label_node[c, li] >= 0), (c, li)
            if ref.label_node[c, li] >= 0:
                rp, p = ref.nodes[ref.label_node[c, li]], g.nodes[jln[c, li]].numpy()
                assert np.linalg.norm(rp - p) < 0.5, (c, li)


def _to_gvd(nodes, edges, lengths, label_node=None):
    """tests/test_plan.py's padded graph, as the port's GvdGraph."""
    N, E, C = S.max_nodes, S.max_edges, S.max_rows
    n, e = len(nodes), len(edges)
    jn = np.zeros((N, 2), np.float32)
    jn[:n] = nodes
    je = np.full((E, 2), -1, np.int32)
    je[:e] = np.asarray(edges, np.int32)
    jl = np.zeros(E, np.float32)
    jl[:e] = lengths
    ln = np.full((C, 4), -1, np.int32)
    if label_node is not None:
        ln[:label_node.shape[0]] = label_node
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return GvdGraph(nodes=torch.from_numpy(jn), node_valid=torch.arange(N) < n,
                    node_labels=torch.zeros(N, dtype=torch.int32),
                    label_node=torch.from_numpy(ln), edges=torch.from_numpy(je),
                    edge_valid=torch.arange(E) < e, edge_lengths=torch.from_numpy(jl),
                    edge_clearances=torch.zeros(E), num_nodes=i32(n), num_edges=i32(e))


def test_astar_matches_oracle(graph, params):
    """tests/test_plan.py::test_astar_parity (same cost within 1e-3, a path
    found wherever the oracle finds one) and ::test_k_nearest."""
    nodes, edges, lengths = graph
    g = _to_gvd(nodes, edges, lengths)
    cm = tastar.cost_matrix(g, S)
    adj = oplan.build_adjacency(len(nodes), edges)
    elen = {e: ln for e, ln in zip(edges, lengths)}
    rng = np.random.default_rng(1)
    checked = 0
    for _ in range(12):
        a, b = map(int, rng.integers(0, len(nodes), 2))
        ref = oplan.astar(nodes.astype(np.float64), adj, elen, a, b)
        path, ln, found = tastar.astar(cm, g.nodes, g.node_valid,
                                       torch.tensor([a], dtype=torch.int32),
                                       torch.tensor(b, dtype=torch.int32),
                                       params.heuristic_weight, S)
        if ref:
            assert bool(found[0])
            gc = float(tastar.path_cost(cm, g.nodes, path[0], ln[0]))
            assert abs(oplan.path_cost(nodes, elen, ref) - gc) < 1e-3, (a, b)
            checked += 1
        else:
            assert not bool(found[0]) or int(ln[0]) <= 1
    assert checked >= 6
    got = tastar.k_nearest_nodes(g.nodes, g.node_valid, torch.tensor([5.0, 5.0]), 5)
    assert list(got.numpy()) == oplan.k_nearest(nodes, np.array([5.0, 5.0], np.float32), 5)


def test_waypoint_sequence_matches_oracle(graph, params):
    """tests/test_plan.py::test_waypoint_sequence_parity (1e-4)."""
    nodes, edges, lengths = graph
    label_node = np.random.default_rng(3).choice(len(nodes), (3, 4),
                                                 replace=False).astype(np.int32)
    wp = build_waypoints(_to_gvd(nodes, edges, lengths, label_node), params, S)
    cl = oplan.build_cluster_waypoint_mapping(label_node)
    ref_xy, ref_nodes = oplan.build_waypoint_sequence(cl, nodes.astype(np.float64))
    n = int(wp.count)
    assert n == len(ref_nodes) and list(wp.node_idx[:n].numpy()) == ref_nodes
    assert np.abs(wp.xy[:n].numpy() - ref_xy).max() < 1e-4


@pytest.mark.parametrize("case", list(_linearize_cases()))
def test_linearize_matches_oracle(case, params):
    """tests/test_plan.py::test_linearize_parity (points 2e-3, yaw 1e-2)."""
    pts = _linearize_cases()[case]
    xy = np.zeros((S.max_path, 2), np.float32)
    xy[:len(pts)] = pts
    path = Path(xy=torch.from_numpy(xy), yaw=torch.zeros(S.max_path),
                count=torch.tensor(len(pts), dtype=torch.int32))
    got = tlin.linearize(path, params, S)
    ref_xy, ref_yaw = oplan.linearize_path(pts)
    n = int(got.count)
    assert n == len(ref_xy)
    assert np.abs(got.xy[:n].numpy() - ref_xy).max() < 2e-3
    dy = np.abs(got.yaw[:n].numpy() - ref_yaw)
    assert np.minimum(dy, 2 * np.pi - dy).max() < 1e-2


def test_control_matches_oracle(params):
    """tests/test_plan.py::test_control_parity: the published modes of a
    scripted approach, decimated 1 in 5."""
    pts = np.stack([np.linspace(0, 5, 101), np.zeros(101)], 1)
    xy = np.zeros((S.max_plan, 2), np.float32)
    xy[:101] = pts
    path = Path(xy=torch.from_numpy(xy), yaw=torch.zeros(S.max_plan),
                count=torch.tensor(101, dtype=torch.int32))
    ref = oplan.ControlSM()
    ref.on_path(pts, np.zeros(101))
    st = tctrl.on_path(ControlState.initial(CPU), path)
    mods_ref, mods = [], []
    for cnt, x in enumerate(_control_script(), 1):
        m = ref.tick(np.array([x, 0.0], np.float32), 0.0) if cnt % 5 == 0 else None
        st, fired, mod, _, _ = tctrl.control_tick(st, torch.tensor([x, 0.0], dtype=torch.float32),
                                                  torch.tensor(0.0), params)
        if m is not None:
            assert bool(fired)
            mods_ref.append(m)
            mods.append(int(mod))
    assert mods == mods_ref and 3 in mods
