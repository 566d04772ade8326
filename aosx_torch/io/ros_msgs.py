"""ROS message-schema exporters (mirror of ``aosx/io/ros_msgs.py``): the
dense padded trees as dictionaries with the reference's message fields.

- GvdGraph       <- msg/GvdGraph.msg:1-59 (with the ragged
                    node_label_clusters/types/counts encoding and the
                    deprecated node_cluster_indices)
- OccupancyGrid  <- nav_msgs/OccupancyGrid ({0,100} int8 data, row-major,
                    origin + resolution)
- Path           <- nav_msgs/Path (positions + z-yaw quaternions)

Tensors on any device are read through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import GvdGraph


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def gvd_graph_to_msg(graph, resolution: float, origin_x: float, origin_y: float) -> dict:
    n = int(graph.num_nodes)
    e = int(graph.num_edges)
    nodes = _np(graph.nodes)[:n]
    labels = _np(graph.node_labels)[:n]
    label_node = _np(graph.label_node)          # [C,4]
    # the ragged per-node (cluster, label_type) arrays in the reference's
    # order: per node, clusters ascending, label types ascending
    # (aos_gvd_node.cpp:936-995)
    per_node: dict[int, list[tuple[int, int]]] = {}
    for c in range(label_node.shape[0]):
        for t in range(4):
            ni = int(label_node[c, t])
            if ni >= 0:
                per_node.setdefault(ni, []).append((c, t))
    node_label_clusters: list[int] = []
    node_label_types: list[int] = []
    node_label_counts = np.zeros(n, np.int32)
    node_cluster_indices = np.full(n, -1, np.int32)
    for i in range(n):
        pairs = sorted(per_node.get(i, []))
        node_label_counts[i] = len(pairs)
        if pairs:
            node_cluster_indices[i] = pairs[0][0]
        for c, t in pairs:
            node_label_clusters.append(c)
            node_label_types.append(t)
    edges = _np(graph.edges)[:e]
    return dict(
        resolution=float(resolution),
        origin_x=float(origin_x),
        origin_y=float(origin_y),
        num_nodes=n,
        num_edges=e,
        nodes=[dict(x=float(p[0]), y=float(p[1]), z=0.0) for p in nodes],
        node_labels=labels.tolist(),
        node_cluster_indices=node_cluster_indices.tolist(),
        node_label_clusters=node_label_clusters,
        node_label_types=node_label_types,
        node_label_counts=node_label_counts.tolist(),
        edges=edges.reshape(-1).tolist(),
        edge_lengths=_np(graph.edge_lengths)[:e].astype(np.float32).tolist(),
        edge_clearances=_np(graph.edge_clearances)[:e].astype(np.float32).tolist(),
    )


def occupancy_grid_to_msg(grid, resolution: float) -> dict:
    h = int(grid.h_cells)
    w = int(grid.w_cells)
    data = np.where(_np(grid.occ)[:h, :w] == 1, 100, 0).astype(np.int8)
    return dict(
        info=dict(resolution=float(resolution), width=w, height=h,
                  origin=dict(x=float(grid.origin_x), y=float(grid.origin_y), z=0.0)),
        data=data.reshape(-1).tolist(),
    )


def path_to_msg(path) -> dict:
    n = int(path.count)
    xy = _np(path.xy)[:n]
    yaw = _np(path.yaw)[:n]
    poses = [
        dict(position=dict(x=float(p[0]), y=float(p[1]), z=0.0),
             orientation=dict(x=0.0, y=0.0, z=float(np.sin(y / 2)), w=float(np.cos(y / 2))))
        for p, y in zip(xy, yaw)
    ]
    return dict(poses=poses)


def msg_to_gvd_arrays(msg: dict):
    """A reference-format GvdGraph dict (e.g. recorded from the C++ node) as
    dense arrays for the planner, with the legacy bitmask path of
    buildClusterWaypointMapping (aos_path_gen_node.cpp:711-736). Returns
    (nodes [n,2] f32, edges [e,2] i32, edge_lengths [e] f32, label_node
    [C,4] i32)."""
    n = int(msg["num_nodes"])
    nodes = np.array([[p["x"], p["y"]] for p in msg["nodes"]], np.float32)
    edges = np.asarray(msg["edges"], np.int32).reshape(-1, 2)
    counts = np.asarray(msg.get("node_label_counts", []), np.int32)
    clusters = np.asarray(msg.get("node_label_clusters", []), np.int32)
    types = np.asarray(msg.get("node_label_types", []), np.int32)
    max_c = int(clusters.max()) + 1 if clusters.size else 0
    label_node = np.full((max(max_c, 1), 4), -1, np.int32)
    if counts.size:
        k = 0
        for i in range(n):
            for _ in range(int(counts[i])):
                c, t = int(clusters[k]), int(types[k])
                if label_node[c, t] < 0:
                    label_node[c, t] = i
                k += 1
    else:  # legacy bitmask encoding
        labels = np.asarray(msg["node_labels"], np.int32)
        ci = np.asarray(msg["node_cluster_indices"], np.int32)
        max_c = int(ci.max()) + 1 if ci.size and ci.max() >= 0 else 1
        label_node = np.full((max_c, 4), -1, np.int32)
        for i in range(n):
            if ci[i] >= 0 and labels[i] > 0:
                for t in range(4):
                    if labels[i] & (1 << t):
                        label_node[ci[i], t] = i
    return nodes, edges, np.asarray(msg["edge_lengths"], np.float32), label_node


def msg_to_gvd_graph(msg: dict, s, device) -> GvdGraph:
    """Reference-format GvdGraph dict -> the port's padded GvdGraph on
    ``device``, ready for cost_matrix / build_waypoints / an episode."""
    nodes, edges, lengths, label_node = msg_to_gvd_arrays(msg)
    n, e = nodes.shape[0], edges.shape[0]
    N, E, C = s.max_nodes, s.max_edges, s.max_rows
    if n > N or e > E or label_node.shape[0] > C:
        raise ValueError(f"message exceeds Statics caps: nodes {n}/{N}, edges {e}/{E}, "
                         f"clusters {label_node.shape[0]}/{C}")
    pnodes = np.zeros((N, 2), np.float32)
    pnodes[:n] = nodes
    pedges = np.full((E, 2), -1, np.int32)
    pedges[:e] = edges
    plen = np.zeros((E,), np.float32)
    plen[:e] = lengths
    pln = np.full((C, 4), -1, np.int32)
    pln[:label_node.shape[0]] = label_node
    plabels = np.zeros((N,), np.int32)
    raw = np.asarray(msg.get("node_labels", []), np.int32)
    plabels[:raw.shape[0]] = raw[:N]

    def t(a):
        return torch.from_numpy(a).to(device)

    return GvdGraph(
        nodes=t(pnodes),
        node_valid=torch.arange(N, device=device) < n,
        node_labels=t(plabels),
        label_node=t(pln),
        edges=t(pedges),
        edge_valid=torch.arange(E, device=device) < e,
        edge_lengths=t(plen),
        edge_clearances=torch.zeros((E,), dtype=torch.float32, device=device),
        num_nodes=torch.tensor(n, dtype=torch.int32, device=device),
        num_edges=torch.tensor(e, dtype=torch.int32, device=device),
        guards=torch.zeros((), dtype=torch.int32, device=device),
    )
