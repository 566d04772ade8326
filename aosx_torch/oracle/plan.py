"""Oracle for mission planning / path post-processing / control
(reference: src/aos_path_gen_node.cpp, src/aos_path_linearization_node.cpp,
src/aos_state_machine_node.cpp). Loop-faithful NumPy/pure-Python; a copy of
``aosx/oracle/plan.py``."""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .perceive import Grid


# ---------------------------------------------------------------------------
# graph utilities (aos_path_gen_node.cpp:418-454, 704-765)
# ---------------------------------------------------------------------------


def build_adjacency(num_nodes: int, edges: Sequence[Tuple[int, int]]):
    adj: List[List[int]] = [[] for _ in range(num_nodes)]
    for a, b in edges:
        if 0 <= a < num_nodes and 0 <= b < num_nodes:
            adj[a].append(b)
            adj[b].append(a)
    return adj


def build_cluster_waypoint_mapping(label_node: np.ndarray) -> Dict[int, List[int]]:
    """buildClusterWaypointMapping (cpp:704-765), new-format path: cluster ->
    [TL, TR, BL, BR] node indices (-1 if none). label_node is already the
    dense [C,4] first-match table."""
    out: Dict[int, List[int]] = {}
    for c in range(label_node.shape[0]):
        if (label_node[c] >= 0).any():
            out[c] = [int(v) for v in label_node[c]]
    return out


def build_waypoint_sequence(
    cluster_nodes: Dict[int, List[int]],
    graph_nodes: np.ndarray,
    min_waypoint_distance: float = 0.2,
):
    """buildWaypointSequence (cpp:588-702): even cluster BR->BL, odd TL->TR;
    tail TR (last even) / BL (last odd); consecutive <=0.2 m dropped.
    Returns (waypoints [W,2], node_indices [W])."""
    if not cluster_nodes:
        return np.zeros((0, 2)), []
    idxs = sorted(cluster_nodes.keys())
    max_idx = idxs[-1]
    last_odd = max_idx % 2 == 1
    temp: List[Tuple[np.ndarray, int]] = []
    N = len(graph_nodes)
    for pos, c in enumerate(idxs):
        wp = cluster_nodes[c]
        is_last = pos == len(idxs) - 1
        if c % 2 == 0:
            order = [wp[3], wp[2]]  # BR, BL
            if is_last and not last_odd:
                order.append(wp[1])  # TR
        else:
            order = [wp[0], wp[1]]  # TL, TR
            if is_last and last_odd:
                order.append(wp[2])  # BL
        for ni in order:
            if 0 <= ni < N:
                temp.append((graph_nodes[ni].copy(), ni))
    if not temp:
        return np.zeros((0, 2)), []
    out = [temp[0]]
    for p, ni in temp[1:]:
        if np.linalg.norm(p - out[-1][0]) > min_waypoint_distance:
            out.append((p, ni))
    return np.array([p for p, _ in out]), [ni for _, ni in out]


# ---------------------------------------------------------------------------
# A* (cpp:800-896)
# ---------------------------------------------------------------------------


def astar(
    nodes: np.ndarray,
    adj: List[List[int]],
    edge_len: Dict[Tuple[int, int], float],
    start: int,
    goal: int,
    w: float = 3.0,
):
    """Weighted A* with lazy-deletion priority queue, identical tie behavior
    to std::priority_queue on (f, g, node) is NOT guaranteed by heapq; the
    reference pops the smallest f (ties unspecified). Decision parity holds
    when costs are distinct (generic data)."""
    N = len(nodes)
    if not (0 <= start < N and 0 <= goal < N):
        return []
    if start == goal:
        return [start]
    if not adj[start] or not adj[goal]:
        return []

    def h(i):
        return float(np.linalg.norm(nodes[i] - nodes[goal])) * w

    g = np.full(N, np.inf)
    parent = np.full(N, -1, int)
    visited = set()
    g[start] = 0.0
    pq = [(h(start), start)]
    while pq:
        f, u = heapq.heappop(pq)
        if u in visited:
            continue
        visited.add(u)
        if u == goal:
            path = []
            v = goal
            while v != -1:
                path.append(v)
                v = int(parent[v])
            return path[::-1]
        for v in adj[u]:
            if v in visited:
                continue
            key = (u, v) if u < v else (v, u)
            cost = edge_len.get(key)
            if cost is None:
                cost = float(np.linalg.norm(nodes[u] - nodes[v]))
            ng = g[u] + cost
            if ng < g[v]:
                g[v] = ng
                parent[v] = u
                heapq.heappush(pq, (ng + h(v), v))
    return []


def path_cost(nodes, edge_len, node_path):
    if len(node_path) < 2:
        return 0.0
    total = 0.0
    for a, b in zip(node_path[:-1], node_path[1:]):
        key = (a, b) if a < b else (b, a)
        c = edge_len.get(key)
        if c is None:
            c = float(np.linalg.norm(nodes[a] - nodes[b]))
        total += c
    return total


def k_nearest(nodes: np.ndarray, point: np.ndarray, k: int = 5):
    d = np.linalg.norm(nodes - point, axis=1)
    order = sorted(range(len(nodes)), key=lambda i: (d[i], i))
    return order[:k]


def plan_graph_path(
    nodes: np.ndarray,
    adj,
    edge_len,
    start_point: np.ndarray,
    target_node: int,
    target_point: np.ndarray,
    k: int = 5,
):
    """The candidate-start planning core (cpp:1282-1504 for on-graph targets,
    cpp:1095-1279 for origin return). Returns the path points [P,2] or None.
    For target_node < 0 (origin return), plans to the node nearest the target
    then appends a 0.2 m-step straight tail."""
    origin_return = target_node < 0
    if origin_return:
        d = np.linalg.norm(nodes - target_point, axis=1)
        goal = int(np.argmin(d))
    else:
        goal = target_node
    candidates = k_nearest(nodes, start_point, k)
    best, best_cost = None, np.inf
    for c in candidates:
        if c == goal:
            continue
        p = astar(nodes, adj, edge_len, c, goal)
        if len(p) > 1:
            cost = path_cost(nodes, edge_len, p) + float(
                np.linalg.norm(start_point - nodes[c])
            )
            if cost < best_cost:
                best_cost, best = cost, p
    if best is None:
        return None
    pts: List[np.ndarray] = []
    if np.linalg.norm(start_point - nodes[best[0]]) > 0.1:
        pts.append(np.asarray(start_point, float).copy())
    for ni in best:
        p = nodes[ni]
        if not pts or np.linalg.norm(pts[-1] - p) > 0.0:
            pts.append(p.copy())
    if origin_return:
        # straight 0.2 m tail from last node to the origin target (cpp:1227-1250)
        last = pts[-1]
        d = target_point - last
        dist = float(np.linalg.norm(d))
        steps = int(math.ceil(dist / 0.2)) if dist > 0 else 0
        for i in range(1, steps + 1):
            t = i / steps
            pts.append(last + t * d)
        pts[-1] = np.asarray(target_point, float).copy()
    else:
        if np.linalg.norm(pts[-1] - target_point) > 0.01:
            pts.append(np.asarray(target_point, float).copy())
        else:
            pts[-1] = np.asarray(target_point, float).copy()
    return np.asarray(pts)


def initial_straight_path(target=np.array([8.0, 0.0]), step=0.2):
    """cpp:983-1015: (0,0) -> (8,0) at 0.2 m steps."""
    d = target.copy()
    dist = float(np.linalg.norm(d))
    n = int(math.ceil(dist / step))
    pts = np.array([i / n * d for i in range(n + 1)])
    pts[-1] = target
    return pts


def path_yaws(pts: np.ndarray, next_waypoint: Optional[np.ndarray]):
    """cpp:1517-1549: each pose faces the next; the last faces the NEXT
    waypoint if any, else keeps the previous segment direction."""
    n = len(pts)
    yaw = np.zeros(n)
    for i in range(n - 1):
        d = pts[i + 1] - pts[i]
        yaw[i] = math.atan2(d[1], d[0])
    if next_waypoint is not None:
        d = next_waypoint - pts[-1]
        yaw[-1] = math.atan2(d[1], d[0])
    elif n > 1:
        d = pts[-1] - pts[-2]
        yaw[-1] = math.atan2(d[1], d[0])
    return yaw


def trim_path_near_occupied(pts: np.ndarray, skel: Grid, safety=0.2):
    """trimPathNearOccupiedRegions (cpp:1570-1630)."""
    if skel is None or len(pts) == 0:
        return pts
    rc = int(math.ceil(safety / skel.resolution))
    for i, p in enumerate(pts):
        too_close = False
        for dx in range(-rc, rc + 1):
            if too_close:
                break
            for dy in range(-rc, rc + 1):
                dist = math.hypot(dx, dy) * skel.resolution
                if dist > safety:
                    continue
                cx = p[0] + dx * skel.resolution
                cy = p[1] + dy * skel.resolution
                mx = int((cx - skel.origin_x) / skel.resolution)
                my = int((cy - skel.origin_y) / skel.resolution)
                if 0 <= mx < skel.w and 0 <= my < skel.h and skel.data[my, mx] == 100:
                    too_close = True
                    break
        if too_close and i > 0:
            return pts[:i].copy()
    return pts


# ---------------------------------------------------------------------------
# linearization (aos_path_linearization_node.cpp)
# ---------------------------------------------------------------------------


def _linreg(pts, s, e):
    if e <= s or e - s < 2:
        return 0.0, 0.0, 0.0
    xs = pts[s : e + 1, 0]
    ys = pts[s : e + 1, 1]
    n = e - s + 1
    sx, sy = xs.sum(), ys.sum()
    sxy = (xs * ys).sum()
    sx2 = (xs * xs).sum()
    den = n * sx2 - sx * sx
    if abs(den) < 1e-9:
        a, b = 0.0, sy / n
    else:
        a = (n * sxy - sx * sy) / den
        b = (sy - a * sx) / n
    err = (((ys - (a * xs + b)) ** 2).sum()) / n
    return a, b, err


def _best_split(pts, s, e):
    if e <= s + 1:
        return e
    best, best_err = s + 1, np.inf
    for sp in range(s + 1, e):
        _, _, e1 = _linreg(pts, s, sp)
        _, _, e2 = _linreg(pts, sp, e)
        n1, n2 = sp - s + 1, e - sp + 1
        tot = (e1 * n1 + e2 * n2) / (n1 + n2)
        if tot < best_err:
            best_err, best = tot, sp
    return best


def _split_recursive(pts, s, e, breakpoints: List[int], max_segments: int):
    if e <= s or max_segments <= 1:
        return
    a, b, _ = _linreg(pts, s, e)
    max_d = 0.0
    for i in range(s + 1, e):
        d = abs(pts[i, 1] - (a * pts[i, 0] + b))
        if d > max_d:
            max_d = d
    if max_d < 0.1 or len(breakpoints) >= max_segments - 1:
        return
    sp = _best_split(pts, s, e)
    if sp not in breakpoints:
        breakpoints.append(sp)
        breakpoints.sort()
    if len(breakpoints) < max_segments - 1:
        _split_recursive(pts, s, sp, breakpoints, max_segments)
        _split_recursive(pts, sp, e, breakpoints, max_segments)


def _interp_segment(p1, p2, out: List, spacing=0.05, skip_start=False):
    d = p2[:2] - p1[:2]
    dist = float(np.linalg.norm(d))
    if dist < 1e-6:
        if not skip_start:
            out.append((p1[:2].copy(), p1[2] if len(p1) > 2 else 0.0))
        return
    yaw = math.atan2(d[1], d[0])
    if not skip_start:
        out.append((p1[:2].copy(), yaw))
    num = int(math.floor(dist / spacing))
    for i in range(1, num + 1):
        t = i * spacing / dist
        if t >= 1.0:
            break
        out.append((p1[:2] + t * d, yaw))
    out.append((p2[:2].copy(), yaw))


def linearize_path(pts: np.ndarray):
    """convertToLinearSegments (cpp:248-370) on [P,2] points. Returns
    ([Q,2] points, [Q] yaws)."""
    n = len(pts)
    if n == 0:
        return np.zeros((0, 2)), np.zeros(0)
    if n == 1:
        return pts.copy(), np.zeros(1)
    start, end = pts[0], pts[-1]
    is_long = abs(end[0]) < 1e-6 and abs(end[1]) < 1e-6
    max_segments = 10 if is_long else 4
    out: List = []
    if n == 2:
        _interp_segment(pts[0], pts[1], out)
    elif n <= 4:
        for i in range(n - 1):
            _interp_segment(pts[i], pts[i + 1], out, skip_start=(i > 0))
    else:
        bps: List[int] = []
        _split_recursive(pts, 0, n - 1, bps, max_segments)
        if not bps or bps[0] != 0:
            bps.insert(0, 0)
        if not bps or bps[-1] != n - 1:
            bps.append(n - 1)
        bps = sorted(set(bps))
        for i in range(len(bps) - 1):
            _interp_segment(pts[bps[i]], pts[bps[i + 1]], out, skip_start=(i > 0))
    if out:
        out[0] = (start.copy(), out[0][1])
        out[-1] = (end.copy(), out[-1][1])
    # backtracking removal (cpp:336-369)
    if len(out) > 2:
        kept = [out[0]]
        for i in range(1, len(out)):
            if len(kept) > 1:
                pp, p = kept[-2][0], kept[-1][0]
                c = out[i][0]
                if (p - pp) @ (c - p) < -0.01:
                    continue
            kept.append(out[i])
        kept[-1] = (end.copy(), kept[-1][1])
        out = kept
    xy = np.array([p for p, _ in out])
    yaw = np.array([y for _, y in out])
    return xy, yaw


# ---------------------------------------------------------------------------
# control state machine (aos_state_machine_node.cpp:109-160)
# ---------------------------------------------------------------------------


def normalized_angle(a):
    if a > math.pi:
        return a - 2 * math.pi
    if a < -math.pi:
        return a + 2 * math.pi
    return a


@dataclasses.dataclass
class ControlSM:
    mode: int = 0
    is_path_received: bool = False
    goal_initialized: bool = False
    goal_xy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    goal_yaw: float = 0.0
    path_xy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2)))

    def on_path(self, xy: np.ndarray, yaw: np.ndarray):
        """pathCallback (cpp:60-77): update only if the goal pose changed."""
        if len(xy) == 0:
            return
        new_goal = xy[-1]
        if (
            not self.goal_initialized
            or not np.allclose(new_goal, self.goal_xy)
            or not np.isclose(yaw[-1], self.goal_yaw)
        ):
            self.goal_xy = new_goal.copy()
            self.goal_yaw = float(yaw[-1])
            self.path_xy = xy.copy()
            self.is_path_received = True
            self.goal_initialized = True

    def tick(self, pose_xy: np.ndarray, pose_yaw: float) -> int:
        """updateControlMode (cpp:109-141); caller handles the 1-in-5
        decimation and the pre-init mode-3 publish."""
        if not self.goal_initialized:
            return 3
        dist = float(np.linalg.norm(self.goal_xy - pose_xy))
        yaw_diff = abs(normalized_angle(self.goal_yaw - pose_yaw))
        if dist < 0.05 and yaw_diff < 0.0524 and self.mode == 1 and self.is_path_received:
            self.mode = 3
            self.is_path_received = False
        elif dist < 0.1 and yaw_diff < 0.0873 and self.mode == 2 and self.is_path_received:
            self.mode = 3
            self.is_path_received = False
        elif (dist < 0.5 and self.mode != 3) or self._closest_is_end(pose_xy):
            self.mode = 2  # is_precise_task is hard-coded false (cpp:48)
        elif self.mode not in (1, 2) and self.is_path_received:
            self.mode = 0
        return self.mode

    def _closest_is_end(self, pose_xy):
        """findClosestIndex == path size (cpp:126): NOTE this can never be
        true (argmin < size); reproduced faithfully as always-false."""
        return False
