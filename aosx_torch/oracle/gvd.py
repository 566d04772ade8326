"""Oracle for the GVD graph stage (reference: src/aos_gvd_node.cpp +
src/utils/voronoi_diagram.cpp). Uses cv2.Subdiv2D exactly like the reference.

Because the tensor implementation builds the Voronoi graph in grid space (jump
flooding) rather than from float-precision Subdiv2D facets, graph parity is
defined at the DECISION level (SURVEY.md hard part #2): tolerant node
matching, identical label/cluster assignments, isomorphic connectivity. This
oracle provides both the reference graph and helpers to score that parity.
A copy of ``aosx/oracle/gvd.py``; ``cv2`` is imported only where Subdiv2D
is called.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .perceive import Grid, point_in_polygon


# ---------------------------------------------------------------------------
# seed merge (aos_gvd_node.cpp:84-128)
# ---------------------------------------------------------------------------


def merge_seeds(seeds: np.ndarray, merge_distance: float = 0.5) -> np.ndarray:
    """Greedy order-dependent merge: for each unused seed i (in order), absorb
    all unused j > i within merge_distance OF SEED i and emit the centroid."""
    n = len(seeds)
    used = np.zeros(n, bool)
    out = []
    for i in range(n):
        if used[i]:
            continue
        members = [i]
        used[i] = True
        for j in range(i + 1, n):
            if used[j]:
                continue
            if np.linalg.norm(seeds[i] - seeds[j]) <= merge_distance:
                members.append(j)
                used[j] = True
        out.append(seeds[members].mean(axis=0))
    return np.asarray(out) if out else np.zeros((0, 2))


# ---------------------------------------------------------------------------
# Voronoi via Subdiv2D (voronoi_diagram.cpp:16-207)
# ---------------------------------------------------------------------------


def compute_voronoi_edges(seeds: np.ndarray, minx, maxx, miny, maxy):
    """VoronoiDiagram::compute: facet edges from cv::Subdiv2D over the grid
    bbox +- 1 m. Returns list of (start[2], end[2]) float arrays."""
    import cv2

    if len(seeds) == 0:
        return []
    if minx > maxx:
        minx, maxx = maxx, minx
    if miny > maxy:
        miny, maxy = maxy, miny
    if maxx - minx < 1.0:
        c = (minx + maxx) / 2
        minx, maxx = c - 0.5, c + 0.5
    if maxy - miny < 1.0:
        c = (miny + maxy) / 2
        miny, maxy = c - 0.5, c + 0.5
    rect = (
        float(minx - 1.0),
        float(miny - 1.0),
        float(abs(maxx - minx) + 2.0),
        float(abs(maxy - miny) + 2.0),
    )
    sd = cv2.Subdiv2D(rect)
    margin = 0.1
    for sx, sy in seeds:
        if not (np.isfinite(sx) and np.isfinite(sy)):
            continue
        x = min(max(float(sx), rect[0] + margin), rect[0] + rect[2] - margin)
        y = min(max(float(sy), rect[1] + margin), rect[1] + rect[3] - margin)
        try:
            sd.insert((float(np.float32(x)), float(np.float32(y))))
        except cv2.error:
            continue
    facets, _centers = sd.getVoronoiFacetList([])
    edges = []
    for facet in facets:
        if len(facet) < 2:
            continue
        for i in range(len(facet)):
            j = (i + 1) % len(facet)
            edges.append(
                (np.array(facet[i], np.float64), np.array(facet[j], np.float64))
            )
    return edges


def extract_boundary_points(edges) -> np.ndarray:
    """extractBoundaryPoints (voronoi_diagram.cpp:149-207): int-hash + 5 cm
    distance dedupe, insertion order preserved."""
    unique = set()
    pts: List[np.ndarray] = []
    thr2 = 0.05 * 0.05
    for start, end in edges:
        for p in (start, end):
            key = (int(p[0] * 100), int(p[1] * 100))
            if key in unique:
                continue
            too_close = False
            for e in pts:
                if (e[0] - p[0]) ** 2 + (e[1] - p[1]) ** 2 < thr2:
                    too_close = True
                    break
            if not too_close:
                unique.add(key)
                pts.append(p.copy())
    return np.asarray(pts) if pts else np.zeros((0, 2))


# ---------------------------------------------------------------------------
# graph build (aos_gvd_node.cpp:320-895)
# ---------------------------------------------------------------------------


def edge_crosses_occupied(grid: Grid, a: np.ndarray, b: np.ndarray) -> bool:
    """edgePassesThroughOccupiedPixels (cpp:320-359): sample at res/2."""
    length = np.linalg.norm(b - a)
    if length < 1e-6:
        return False
    step = grid.resolution * 0.5
    num = int(length / step) + 1
    d = (b - a) / length
    for i in range(num + 1):
        t = 1.0 if i == num else i / num
        p = a + t * d * length
        mx = int((p[0] - grid.origin_x) / grid.resolution)
        my = int((p[1] - grid.origin_y) / grid.resolution)
        if 0 <= mx < grid.w and 0 <= my < grid.h:
            if grid.data[my, mx] == 100:
                return True
    return False


@dataclasses.dataclass
class RefGraph:
    nodes: np.ndarray                 # [N,2]
    edges: List[Tuple[int, int]]      # (a<b) pairs, insertion order
    edge_lengths: List[float]
    node_labels: np.ndarray           # [N] bitmask 1=TL,2=TR,4=BL,8=BR
    label_node: np.ndarray            # [C,4] node idx per (cluster, TL/TR/BL/BR), -1 none
    label_points: np.ndarray          # [C,4,2] the found label points
    label_valid: np.ndarray           # [C,4]


def build_graph(
    boundary_points: np.ndarray, voronoi_edges, skel: Grid
):
    """buildGraphFromBoundaryPoints (cpp:794-895): snap facet-edge endpoints
    to nearest boundary points, drop occupied-crossing edges, dedupe, plus
    proximity edges <= 0.5 m."""
    M = len(boundary_points)
    edges: List[Tuple[int, int]] = []
    lengths: List[float] = []
    added = set()
    if M == 0:
        return edges, lengths

    def nearest(p):
        d2 = ((boundary_points - p) ** 2).sum(1)
        return int(np.argmin(d2))

    for start, end in voronoi_edges:
        si = nearest(start)
        ei = nearest(end)
        if si >= 0 and ei >= 0 and si != ei:
            a, b = (si, ei) if si < ei else (ei, si)
            key = (a, b)
            if key in added:
                continue
            sp, ep = boundary_points[si], boundary_points[ei]
            if edge_crosses_occupied(skel, sp, ep):
                continue
            added.add(key)
            edges.append(key)
            lengths.append(float(np.linalg.norm(ep - sp)))
    # proximity edges
    for i in range(M):
        for j in range(i + 1, M):
            dist = float(np.linalg.norm(boundary_points[i] - boundary_points[j]))
            if 1e-6 < dist <= 0.5:
                key = (i, j)
                if key in added:
                    continue
                if edge_crosses_occupied(skel, boundary_points[i], boundary_points[j]):
                    continue
                added.add(key)
                edges.append(key)
                lengths.append(dist)
    return edges, lengths


def filter_outside_grid(boundary_points, edges, lengths, skel: Grid):
    """filterNodesAndEdgesOutsideGrid (cpp:420-483)."""
    minx = skel.origin_x
    maxx = minx + skel.w * skel.resolution
    miny = skel.origin_y
    maxy = miny + skel.h * skel.resolution
    keep = (
        (boundary_points[:, 0] >= minx)
        & (boundary_points[:, 0] <= maxx)
        & (boundary_points[:, 1] >= miny)
        & (boundary_points[:, 1] <= maxy)
    )
    remap = -np.ones(len(boundary_points), int)
    remap[keep] = np.arange(keep.sum())
    new_pts = boundary_points[keep]
    new_edges, new_lengths = [], []
    for (a, b), _l in zip(edges, lengths):
        na, nb = remap[a], remap[b]
        if na >= 0 and nb >= 0 and na != nb:
            aa, bb = (na, nb) if na < nb else (nb, na)
            ln = float(np.linalg.norm(new_pts[nb] - new_pts[na]))
            new_edges.append((int(aa), int(bb)))
            new_lengths.append(ln)
    return new_pts, new_edges, new_lengths


def cast_ray_gvd(
    grid: Optional[Grid], start: np.ndarray, other: np.ndarray, angle_deg: float,
    min_distance: float = 1.0,
):
    """castRay (aos_gvd_node.cpp:558-684): like the seed-gen endpoint ray but
    with step = res/2 (floored at 0.01) and diag*3 reach."""
    d = other - start
    n = np.linalg.norm(d)
    fwd = np.array([1.0, 0.0]) if n < 1e-6 else d / n
    outward = -fwd
    perp = np.array([-fwd[1], fwd[0]])
    a = math.radians(angle_deg)
    if angle_deg > 0:
        ray = math.cos(a) * outward + math.sin(a) * perp
    else:
        ray = math.cos(-a) * outward + math.sin(-a) * (-perp)
    ray = ray / np.linalg.norm(ray)

    step = 0.1
    if grid is not None:
        step = max(grid.resolution * 0.5, 0.01)
    if grid is not None:
        minx, miny = grid.origin_x, grid.origin_y
        maxx = minx + grid.w * grid.resolution
        maxy = miny + grid.h * grid.resolution
        gw, gh = grid.w * grid.resolution, grid.h * grid.resolution
        abs_max = math.hypot(gw, gh) * 3.0
    else:
        abs_max = 10000.0

    cur = min_distance
    while cur <= abs_max:
        p = start + ray * cur
        if grid is not None and not (minx <= p[0] <= maxx and miny <= p[1] <= maxy):
            return np.array(
                [min(max(p[0], minx), maxx), min(max(p[1], miny), maxy)]
            )
        if grid is not None:
            mx = int((p[0] - grid.origin_x) / grid.resolution)
            my = int((p[1] - grid.origin_y) / grid.resolution)
            if 0 <= mx < grid.w and 0 <= my < grid.h and grid.data[my, mx] == 100:
                return p
        cur += step
    p = start + ray * abs_max
    if grid is not None:
        p = np.array([min(max(p[0], minx), maxx), min(max(p[1], miny), maxy)])
    return p


def find_label_point(
    nodes: np.ndarray, endpoint: np.ndarray, other: np.ndarray, angle_deg: float,
    skel: Optional[Grid], min_distance: float = 0.5, max_distance: float = 5.0,
):
    """findVoronoiBoundaryPointNearEndpoint (cpp:686-790): expanding-radius
    quarter-plane search (outward half + perp sign), nearest candidate;
    castRay fallback. Returns (point, came_from_node: index or -1)."""
    d = other - endpoint
    n = np.linalg.norm(d)
    main = np.array([1.0, 0.0]) if n < 1e-6 else d / n
    outward = -main
    perp = np.array([-main[1], main[0]])
    if abs(angle_deg + 90.0) < 1e-6:
        target = -perp
    elif abs(angle_deg - 90.0) < 1e-6:
        target = perp
    else:
        a = math.radians(angle_deg)
        target = math.cos(a) * outward + math.sin(a) * perp
    radii = [max_distance, 7.0, 9.0]
    if skel is not None:
        gw, gh = skel.w * skel.resolution, skel.h * skel.resolution
        radii.append(math.hypot(gw, gh) * 2.0)
    else:
        radii.append(1000.0)

    for radius in radii:
        best, best_d, best_i = None, float("inf"), -1
        for i, p in enumerate(nodes):
            dirv = p - endpoint
            dist = np.linalg.norm(dirv)
            if dist < min_distance or dist > radius:
                continue
            dirn = dirv / dist
            if outward @ dirn < 0.0:
                continue
            dp = perp @ dirn
            if abs(angle_deg + 90.0) < 1e-6 and dp > 0.0:
                continue
            if abs(angle_deg - 90.0) < 1e-6 and dp < 0.0:
                continue
            if dist < best_d:
                best, best_d, best_i = p, dist, i
        if best is not None:
            return best.copy(), best_i
    p = cast_ray_gvd(skel, endpoint, other, angle_deg, min_distance=1.0)
    return p, -1


def gvd_graph(
    raw_seeds: np.ndarray,
    skel: Grid,
    exploration_rows: Sequence,   # list of TreeRow (sorted order), ep1/ep2 raw
) -> RefGraph:
    """Full processGraph (cpp:255-318) + publishGraph label assignment
    (cpp:897-1010). exploration_rows: rows as published (sorted); each row's
    endpoints are re-oriented so ep1 = smaller x ("TOP"; cpp:134-145)."""
    seeds = merge_seeds(raw_seeds)
    seeds = seeds[np.isfinite(seeds).all(axis=1)]
    minx = skel.origin_x
    maxx = minx + skel.w * skel.resolution
    miny = skel.origin_y
    maxy = miny + skel.h * skel.resolution
    vedges = compute_voronoi_edges(seeds, minx, maxx, miny, maxy)
    bpts = extract_boundary_points(vedges)
    edges, lengths = build_graph(bpts, vedges, skel)
    nodes, edges_lengths = bpts, None
    nodes, edges, lengths = filter_outside_grid(bpts, edges, lengths, skel)

    # tree rows: ep1 = smaller x
    rows = []
    for r in exploration_rows:
        a, b = np.asarray(r.start_point, float), np.asarray(r.end_point, float)
        if a[0] > b[0]:
            a, b = b, a
        rows.append((a, b))

    C = len(rows)
    label_points = np.zeros((C, 4, 2))
    label_valid = np.zeros((C, 4), bool)
    for c, (ep1, ep2) in enumerate(rows):
        for li, (ep, other, ang) in enumerate(
            [(ep1, ep2, -90.0), (ep1, ep2, 90.0), (ep2, ep1, -90.0), (ep2, ep1, 90.0)]
        ):
            p, _ = find_label_point(nodes, ep, other, ang, skel)
            label_points[c, li] = p
            label_valid[c, li] = True

    # node label bitmasks + per-(cluster,label) node table (cpp:918-995)
    N = len(nodes)
    node_labels = np.zeros(N, int)
    label_node = -np.ones((C, 4), int)
    tol = 0.1
    for i in range(N):
        for c in range(C):
            for li in range(4):
                if not label_valid[c, li]:
                    continue
                if np.linalg.norm(nodes[i] - label_points[c, li]) < tol:
                    node_labels[i] |= 1 << li
                    if label_node[c, li] < 0:
                        label_node[c, li] = i
    return RefGraph(
        nodes=nodes,
        edges=edges,
        edge_lengths=lengths,
        node_labels=node_labels,
        label_node=label_node,
        label_points=label_points,
        label_valid=label_valid,
    )
