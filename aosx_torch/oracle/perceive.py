"""Oracle for the perception stage (reference: src/aos_seed_gen_node.cpp).

Pure NumPy, loop-faithful to the C++ (including iteration order, truncation
casts, and greedy dedupes) so that the tensor pipeline can be tested for
bit-identical grids and decision-identical seeds/rows. A copy of
``aosx/oracle/perceive.py`` (tests/test_torch_oracle.py holds the two equal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def point_in_polygon(px: float, py: float, poly: np.ndarray) -> bool:
    """Ray casting, faithful to aos_seed_gen_node.cpp:1231-1255 (including the
    |dy| > 1e-9 guard)."""
    n = len(poly)
    if n < 3:
        return False
    inside = False
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        dy = yj - yi
        if abs(dy) > 1e-9:
            if ((yi > py) != (yj > py)) and (px < (xj - xi) * (py - yi) / dy + xi):
                inside = not inside
        j = i
    return inside


def active_bounds(poly: Optional[np.ndarray], clip, margin: float = 2.5):
    """getActiveBounds (aos_seed_gen_node.cpp:873-890): polygon bbox +- margin
    if polygon present, else clipping params. clip = (minx,maxx,miny,maxy)."""
    if poly is not None and len(poly) > 0:
        minx, maxx = poly[:, 0].min(), poly[:, 0].max()
        miny, maxy = poly[:, 1].min(), poly[:, 1].max()
        return (minx - margin, maxx + margin, miny - margin, maxy + margin)
    return clip


# ---------------------------------------------------------------------------
# point-cloud preprocessing (C2)
# ---------------------------------------------------------------------------


def radius_outlier_removal(xyz: np.ndarray, radius: float = 0.2, min_neighbors: int = 2):
    """PCL RadiusOutlierRemoval semantics (aos_seed_gen_node.cpp:236-242):
    keep a point iff it has >= min_neighbors OTHER points within `radius`
    (3D euclidean).  Returns a boolean keep-mask."""
    n = len(xyz)
    keep = np.zeros(n, bool)
    if n == 0:
        return keep
    r2 = radius * radius
    # O(N^2) blocked; fine for oracle sizes
    for i0 in range(0, n, 1024):
        blk = xyz[i0 : i0 + 1024]
        d2 = ((blk[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        cnt = (d2 <= r2).sum(1) - 1  # exclude self
        keep[i0 : i0 + 1024] = cnt >= min_neighbors
    return keep


def preprocess_points(
    xyz: np.ndarray,
    poly: Optional[np.ndarray],
    clip_z: Tuple[float, float],
    clip_xy: Tuple[float, float, float, float],
    exclusions: np.ndarray,
    margin: float = 2.5,
) -> np.ndarray:
    """processPointCloud steps 1-2 (aos_seed_gen_node.cpp:452-538):
    PassThrough z,x,y (inclusive limits), exclusion discs (d^2 <= r^2 removed),
    flatten z=0. Returns the filtered [M,2] xy array."""
    minx, maxx, miny, maxy = active_bounds(poly, clip_xy, margin)
    m = (
        (xyz[:, 2] >= clip_z[0])
        & (xyz[:, 2] <= clip_z[1])
        & (xyz[:, 0] >= minx)
        & (xyz[:, 0] <= maxx)
        & (xyz[:, 1] >= miny)
        & (xyz[:, 1] <= maxy)
    )
    pts = xyz[m]
    if len(exclusions):
        d2 = (pts[:, None, 0] - exclusions[None, :, 0]) ** 2 + (
            pts[:, None, 1] - exclusions[None, :, 1]
        ) ** 2
        excl = (d2 <= exclusions[None, :, 2] ** 2).any(1)
        pts = pts[~excl]
    return pts[:, :2].copy()


# ---------------------------------------------------------------------------
# occupancy grid (C3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Grid:
    data: np.ndarray  # [h, w] int8, {0, 100}
    origin_x: float
    origin_y: float
    resolution: float

    @property
    def w(self):
        return self.data.shape[1]

    @property
    def h(self):
        return self.data.shape[0]


def generate_occupancy_grid(
    xy: np.ndarray, bounds, resolution: float
) -> Grid:
    """generateOccupancyGrid (aos_seed_gen_node.cpp:581-622). Casts are
    C-truncation toward zero (points are within bounds so non-negative)."""
    minx, maxx, miny, maxy = bounds
    width = max(0.0, maxx - minx)
    height = max(0.0, maxy - miny)
    w = max(1, int(math.ceil(width / resolution)))
    h = max(1, int(math.ceil(height / resolution)))
    data = np.zeros((h, w), np.int8)
    gx = ((xy[:, 0] - minx) / resolution).astype(np.int32)  # trunc toward 0
    gy = ((xy[:, 1] - miny) / resolution).astype(np.int32)
    ok = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
    data[gy[ok], gx[ok]] = 100
    return Grid(data, minx, miny, resolution)


def apply_inflation(grid: Grid, inflation_radius: float) -> Grid:
    """applyInflation (aos_seed_gen_node.cpp:933-967): disc of
    int(inflation_radius/res) cells, dx^2+dy^2 <= ic^2."""
    ic = int(inflation_radius / grid.resolution)
    occ = grid.data == 100
    dy, dx = np.mgrid[-ic : ic + 1, -ic : ic + 1]
    disc = (dx * dx + dy * dy) <= ic * ic
    # binary dilation via shifted ORs
    out = np.zeros_like(occ)
    h, w = occ.shape
    ys, xs = np.nonzero(disc)
    for oy, ox in zip(ys - ic, xs - ic):
        src_y0, src_y1 = max(0, -oy), min(h, h - oy)
        src_x0, src_x1 = max(0, -ox), min(w, w - ox)
        out[src_y0 + oy : src_y1 + oy, src_x0 + ox : src_x1 + ox] |= occ[
            src_y0:src_y1, src_x0:src_x1
        ]
    data = np.where(out, 100, grid.data).astype(np.int8)
    # note: reference starts from result_grid = grid (keeps any non-100 values,
    # but inputs here are only {0,100})
    data = np.where(out, 100, 0).astype(np.int8)
    return Grid(data, grid.origin_x, grid.origin_y, grid.resolution)


def mark_borders(grid: Grid, thickness: int = 5) -> Grid:
    """markBoundariesAsOccupied (aos_seed_gen_node.cpp:708-757)."""
    data = grid.data.copy()
    data[:thickness, :] = 100
    data[-thickness:, :] = 100
    data[:, :thickness] = 100
    data[:, -thickness:] = 100
    return Grid(data, grid.origin_x, grid.origin_y, grid.resolution)


def world_to_grid(grid: Grid, wx: float, wy: float) -> Tuple[int, int]:
    """worldToGrid (aos_seed_gen_node.cpp:760-769): floor + clamp."""
    gx = int(math.floor((wx - grid.origin_x) / grid.resolution))
    gy = int(math.floor((wy - grid.origin_y) / grid.resolution))
    gx = min(max(gx, 0), grid.w - 1)
    gy = min(max(gy, 0), grid.h - 1)
    return gx, gy


def draw_line(data: np.ndarray, x0, y0, x1, y1):
    """Bresenham (aos_seed_gen_node.cpp:828-870)."""
    h, w = data.shape
    x0 = min(max(x0, 0), w - 1)
    y0 = min(max(y0, 0), h - 1)
    x1 = min(max(x1, 0), w - 1)
    y1 = min(max(y1, 0), h - 1)
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    x, y = x0, y0
    while True:
        data[y, x] = 100
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy


def mark_polygon_boundary(grid: Grid, poly: Optional[np.ndarray], margin: float = 2.5) -> Grid:
    """markPolygonBoundaryAsOccupied (aos_seed_gen_node.cpp:772-825):
    rectangle (polygon bbox +- margin) drawn with Bresenham."""
    if poly is None or len(poly) == 0:
        return mark_borders(grid)
    data = grid.data.copy()
    minx, maxx = poly[:, 0].min() - margin, poly[:, 0].max() + margin
    miny, maxy = poly[:, 1].min() - margin, poly[:, 1].max() + margin
    gx0, gy0 = world_to_grid(grid, minx, miny)
    gx1, gy1 = world_to_grid(grid, maxx, maxy)
    draw_line(data, gx0, gy0, gx1, gy0)
    draw_line(data, gx0, gy1, gx1, gy1)
    draw_line(data, gx0, gy0, gx0, gy1)
    draw_line(data, gx1, gy0, gx1, gy1)
    return Grid(data, grid.origin_x, grid.origin_y, grid.resolution)


# ---------------------------------------------------------------------------
# skeletonization (C4)
# ---------------------------------------------------------------------------

# cv::getStructuringElement(MORPH_ELLIPSE, (3,3)) == the 3x3 cross
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)


def morph_open(binary: np.ndarray) -> np.ndarray:
    """cv::morphologyEx(MORPH_OPEN, 3x3 ellipse) on a {0,1} image.
    OpenCV border handling for erode uses replicated borders (BORDER_CONSTANT
    with +inf/-inf morphological defaults => border pixels treated as if
    outside is 'does not constrain')."""
    try:
        import cv2

        img = (binary * 255).astype(np.uint8)
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
        out = cv2.morphologyEx(img, cv2.MORPH_OPEN, k)
        return (out > 0).astype(np.uint8)
    except ImportError:  # without OpenCV: the same cross-kernel open in NumPy
        pad = np.pad(binary.astype(np.uint8), 1, constant_values=1)
        er = np.ones_like(binary, np.uint8)
        for dy, dx in [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]:
            er &= pad[1 + dy : 1 + dy + binary.shape[0], 1 + dx : 1 + dx + binary.shape[1]]
        pad = np.pad(er, 1, constant_values=0)
        di = np.zeros_like(binary, np.uint8)
        for dy, dx in [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)]:
            di |= pad[1 + dy : 1 + dy + binary.shape[0], 1 + dx : 1 + dx + binary.shape[1]]
        return di


def zhang_suen_thin(binary: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """cv::ximgproc::thinning(THINNING_ZHANGSUEN) semantics: iterate
    (sub-iteration 0, sub-iteration 1) until no change; border pixels (outer
    1-ring) are never modified. Vectorized but bit-faithful."""
    img = binary.astype(np.uint8).copy()

    def subiter(img, phase):
        p = img
        h, w = p.shape
        z = np.zeros((h + 2, w + 2), np.uint8)
        z[1:-1, 1:-1] = p

        def sh(dy, dx):
            return z[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

        p2 = sh(-1, 0)
        p3 = sh(-1, 1)
        p4 = sh(0, 1)
        p5 = sh(1, 1)
        p6 = sh(1, 0)
        p7 = sh(1, -1)
        p8 = sh(0, -1)
        p9 = sh(-1, -1)
        seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
        A = np.zeros(p.shape, np.int32)
        for a, b in zip(seq[:-1], seq[1:]):
            A += ((a == 0) & (b == 1)).astype(np.int32)
        B = (
            p2.astype(np.int32) + p3 + p4 + p5 + p6 + p7 + p8 + p9
        )
        if phase == 0:
            m1 = p2 * p4 * p6
            m2 = p4 * p6 * p8
        else:
            m1 = p2 * p4 * p8
            m2 = p2 * p6 * p8
        cond = (A == 1) & (B >= 2) & (B <= 6) & (m1 == 0) & (m2 == 0) & (p == 1)
        # border never touched (OpenCV loops run 1..rows-2)
        cond[0, :] = cond[-1, :] = False
        cond[:, 0] = cond[:, -1] = False
        out = img.copy()
        out[cond] = 0
        return out

    for _ in range(max_iters):
        prev = img
        img = subiter(img, 0)
        img = subiter(img, 1)
        if np.array_equal(prev, img):
            break
    return img


def skeletonize(grid: Grid) -> Grid:
    """skeletonizeOccupancyGrid (aos_seed_gen_node.cpp:672-705): morph open
    (3x3 ellipse) then Zhang-Suen thinning; 100 <-> 255 conversions."""
    binary = (grid.data == 100).astype(np.uint8)
    opened = morph_open(binary)
    thin = zhang_suen_thin(opened)
    return Grid((thin * 100).astype(np.int8), grid.origin_x, grid.origin_y, grid.resolution)


# ---------------------------------------------------------------------------
# clustering + tree rows (C5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cluster:
    cells: List[Tuple[int, int]]  # (x, y) grid coords, BFS order
    center_x: float = 0.0         # grid units (cell coords), like the C++
    center_y: float = 0.0
    size: int = 0
    length: float = 0.0           # meters


def cluster_occupied_cells(grid: Grid, poly: Optional[np.ndarray]) -> List[Cluster]:
    """clusterOccupiedCells (aos_seed_gen_node.cpp:970-1083): 8-connected BFS
    over occupied(==100) & in-polygon cells; exact O(n^2) max-pairwise length."""
    from collections import deque

    h, w = grid.h, grid.w
    visited = np.zeros((h, w), bool)
    use_poly = poly is not None and len(poly) > 0
    DX = [-1, -1, -1, 0, 0, 1, 1, 1]
    DY = [-1, 0, 1, -1, 1, -1, 0, 1]

    def in_poly_cell(x, y):
        wx = grid.origin_x + float(np.float32(x)) * grid.resolution
        wy = grid.origin_y + float(np.float32(y)) * grid.resolution
        return point_in_polygon(wx, wy, poly)

    clusters: List[Cluster] = []
    for y in range(h):
        for x in range(w):
            if grid.data[y, x] == 100 and not visited[y, x]:
                if use_poly and not in_poly_cell(x, y):
                    visited[y, x] = True
                    continue
                cells = []
                q = deque([(x, y)])
                visited[y, x] = True
                while q:
                    cx, cy = q.popleft()
                    cells.append((cx, cy))
                    for dx, dy in zip(DX, DY):
                        nx, ny = cx + dx, cy + dy
                        if 0 <= nx < w and 0 <= ny < h:
                            if not visited[ny, nx] and grid.data[ny, nx] == 100:
                                if use_poly and not in_poly_cell(nx, ny):
                                    visited[ny, nx] = True
                                    continue
                                visited[ny, nx] = True
                                q.append((nx, ny))
                c = Cluster(cells)
                arr = np.asarray(cells, np.float64)
                c.center_x = float(arr[:, 0].sum() / len(cells))
                c.center_y = float(arr[:, 1].sum() / len(cells))
                c.size = len(cells)
                # exact max pairwise distance (cpp:1062-1074)
                d2 = (
                    (arr[:, None, 0] - arr[None, :, 0]) ** 2
                    + (arr[:, None, 1] - arr[None, :, 1]) ** 2
                )
                c.length = float(np.sqrt(d2.max()) * grid.resolution)
                clusters.append(c)
    return clusters


@dataclasses.dataclass
class TreeRow:
    center: np.ndarray      # world coords [2]
    start_point: np.ndarray
    end_point: np.ndarray
    length: float


def clusters_to_tree_rows(
    clusters: Sequence[Cluster], grid: Grid, poly: Optional[np.ndarray]
) -> List[TreeRow]:
    """convertClustersToTreeRows (aos_seed_gen_node.cpp:1309-1512): polygon
    center filter + endpoint extraction (farthest-from-center, then farthest
    in the opposite half-space)."""
    use_poly = poly is not None and len(poly) > 0
    rows: List[TreeRow] = []
    for c in clusters:
        if not c.cells:
            continue
        center_x = grid.origin_x + np.float32(c.center_x) * grid.resolution
        center_y = grid.origin_y + np.float32(c.center_y) * grid.resolution
        if use_poly and not point_in_polygon(center_x, center_y, poly):
            continue
        wp = np.array(
            [
                [
                    grid.origin_x + np.float32(x) * grid.resolution,
                    grid.origin_y + np.float32(y) * grid.resolution,
                ]
                for x, y in c.cells
            ],
            np.float64,
        )
        center = np.array([center_x, center_y], np.float64)
        diff = wp - center
        d2 = (diff**2).sum(1)
        first_idx = 0
        max_d2 = 0.0
        first_dir = None
        for i in range(len(wp)):
            if d2[i] > max_d2:
                max_d2 = d2[i]
                first_idx = i
                n = math.sqrt(d2[i])
                first_dir = diff[i] / n if n > 0 else np.array([0.0, 0.0])
        # farthest in opposite half-space
        second_idx = 0
        max_opp = 0.0
        for i in range(len(wp)):
            if i == first_idx:
                continue
            n = math.sqrt(d2[i])
            if n == 0:
                continue
            dot = (diff[i] / n) @ first_dir
            if dot < 0.0 and d2[i] > max_opp:
                max_opp = d2[i]
                second_idx = i
        if max_opp == 0.0:
            for i in range(len(wp)):
                if i == first_idx:
                    continue
                dd = ((wp[i] - wp[first_idx]) ** 2).sum()
                if dd > max_opp:
                    max_opp = dd
                    second_idx = i
        rows.append(
            TreeRow(
                center=center,
                start_point=wp[first_idx].copy(),
                end_point=wp[second_idx].copy(),
                length=c.length,
            )
        )
    return rows


def sort_rows(rows: Sequence[TreeRow]) -> List[TreeRow]:
    """Sort by center y (ascending), then x when |dy| < 1e-6
    (aos_seed_gen_node.cpp:2552-2560)."""
    import functools

    def cmp(a, b):
        if abs(a.center[1] - b.center[1]) < 1e-6:
            return -1 if a.center[0] < b.center[0] else 1
        return -1 if a.center[1] < b.center[1] else 1

    return sorted(rows, key=functools.cmp_to_key(cmp))


# ---------------------------------------------------------------------------
# seeds (C6)
# ---------------------------------------------------------------------------


def raycast_to_occupied(
    grid: Grid, sx, sy, dx, dy, max_distance: float, min_distance: float = 1.0
):
    """raycastToOccupiedCell (aos_seed_gen_node.cpp:1730-1771): step res/2,
    min-distance skip, worldToGrid CLAMPS out-of-bounds samples to edge cells."""
    step = grid.resolution * 0.5
    max_steps = int(max_distance / step)
    cx, cy = sx, sy
    for _ in range(max_steps):
        cx += dx * step
        cy += dy * step
        dist = math.hypot(cx - sx, cy - sy)
        if dist < min_distance:
            continue
        gx, gy = world_to_grid(grid, cx, cy)
        if grid.data[gy, gx] == 100:
            return True, cx, cy
    return False, 0.0, 0.0


def cast_ray_from_endpoint(
    start: np.ndarray,
    other: np.ndarray,
    angle_offset_deg: float,
    grid: Grid,
    min_distance: float = 1.0,
    step_size: float = 0.1,
    diag_mult: float = 3.0,
):
    """castRayFromEndpoint (aos_seed_gen_node.cpp:1774-1891). Returns the ray
    terminal point (hit point / clipped boundary point)."""
    d = other - start
    n = np.linalg.norm(d)
    fwd = np.array([1.0, 0.0]) if n < 1e-6 else d / n
    outward = -fwd
    perp = np.array([-fwd[1], fwd[0]])
    a = math.radians(angle_offset_deg)
    if angle_offset_deg > 0:
        ray = math.cos(a) * outward + math.sin(a) * perp
    else:
        ray = math.cos(-a) * outward + math.sin(-a) * (-perp)
    ray = ray / np.linalg.norm(ray)

    minx = grid.origin_x
    maxx = minx + grid.w * grid.resolution
    miny = grid.origin_y
    maxy = miny + grid.h * grid.resolution
    gw, gh = grid.w * grid.resolution, grid.h * grid.resolution
    abs_max = math.hypot(gw, gh) * diag_mult

    cur = min_distance
    while cur <= abs_max:
        p = start + ray * cur
        if not (minx <= p[0] <= maxx and miny <= p[1] <= maxy):
            return np.array([min(max(p[0], minx), maxx), min(max(p[1], miny), maxy)])
        mx = int((p[0] - grid.origin_x) / grid.resolution)
        my = int((p[1] - grid.origin_y) / grid.resolution)
        if 0 <= mx < grid.w and 0 <= my < grid.h and grid.data[my, mx] == 100:
            return p
        cur += step_size
    p = start + ray * abs_max
    return np.array([min(max(p[0], minx), maxx), min(max(p[1], miny), maxy)])


def generate_virtual_seeds(
    rows: Sequence[TreeRow],
    skel: Grid,
    poly: Optional[np.ndarray],
    interval: float = 1.0,
    dedupe: float = 0.5,
    raycast_max: float = 4.0,
):
    """generateVirtualSeeds (aos_seed_gen_node.cpp:1987-2268). Returns the
    virtual seed list (order-faithful greedy dedupe)."""
    use_poly = poly is not None and len(poly) > 0
    seeds: List[np.ndarray] = []

    def exists(p):
        for s in seeds:
            if math.hypot(s[0] - p[0], s[1] - p[1]) < dedupe:
                return True
        return False

    for row in rows:
        if use_poly and not point_in_polygon(row.center[0], row.center[1], poly):
            continue
        d = row.end_point - row.start_point
        dist = math.hypot(d[0], d[1])
        if dist < interval:
            continue
        rd = d / dist
        perp1 = np.array([-rd[1], rd[0]])
        perp2 = -perp1
        num = int(math.floor(dist / interval))
        for i in range(1, num + 1):
            t = i / (num + 1)
            base = row.start_point + t * d
            if not exists(base):
                seeds.append(base.copy())
            for perp in (perp1, perp2):
                hit, hx, hy = raycast_to_occupied(
                    skel, base[0], base[1], perp[0], perp[1], raycast_max
                )
                if hit:
                    sp = np.array([hx, hy])
                else:
                    sp = base + perp * raycast_max
                if use_poly and point_in_polygon(sp[0], sp[1], poly):
                    continue
                if not exists(sp):
                    seeds.append(sp.copy())
    return seeds


def generate_ray_points_from_endpoints(
    rows: Sequence[TreeRow], skel: Grid, poly: Optional[np.ndarray], dedupe: float = 0.5
):
    """generateRayPointsFromEndpoints (aos_seed_gen_node.cpp:1894-1982):
    3 rays (0, -90, +90 deg) per endpoint; keep only points inside grid and
    OUTSIDE the polygon; greedy 0.5 m dedupe."""
    use_poly = poly is not None and len(poly) > 0
    out: List[np.ndarray] = []
    minx = skel.origin_x
    maxx = minx + skel.w * skel.resolution
    miny = skel.origin_y
    maxy = miny + skel.h * skel.resolution
    for row in rows:
        ep1, ep2 = row.start_point, row.end_point
        pts = [
            cast_ray_from_endpoint(ep1, ep2, 0.0, skel),
            cast_ray_from_endpoint(ep1, ep2, -90.0, skel),
            cast_ray_from_endpoint(ep1, ep2, 90.0, skel),
            cast_ray_from_endpoint(ep2, ep1, 0.0, skel),
            cast_ray_from_endpoint(ep2, ep1, -90.0, skel),
            cast_ray_from_endpoint(ep2, ep1, 90.0, skel),
        ]
        for p in pts:
            if not (np.isfinite(p[0]) and np.isfinite(p[1])):
                continue
            if not (minx <= p[0] <= maxx and miny <= p[1] <= maxy):
                continue
            if use_poly and point_in_polygon(p[0], p[1], poly):
                continue
            dup = any(math.hypot(e[0] - p[0], e[1] - p[1]) < dedupe for e in out)
            if not dup:
                out.append(p.copy())
    return out


def tree_row_endpoint_seeds(rows: Sequence[TreeRow], dedupe: float = 0.5):
    """Endpoint seeds with greedy dedupe (aos_seed_gen_node.cpp:1450-1497)."""
    out: List[np.ndarray] = []
    for row in rows:
        for p in (row.start_point, row.end_point):
            dup = any(math.hypot(e[0] - p[0], e[1] - p[1]) < dedupe for e in out)
            if not dup:
                out.append(p.copy())
    return out


# ---------------------------------------------------------------------------
# full perception pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PerceiveResult:
    occupancy: Grid            # inflated + borders (published /occupancy_grid)
    skeleton: Grid             # skeleton WITHOUT boundary (used for seeds/rays)
    skeleton_pub: Grid         # skeleton + polygon boundary (published)
    clusters: List[Cluster]
    rows_all: List[TreeRow]    # length >= min filter + center-in-polygon
    rows_sorted: List[TreeRow]  # exploration order (sorted)
    virtual_seeds: List[np.ndarray]
    ray_seeds: List[np.ndarray]
    endpoint_seeds: List[np.ndarray]
    seeds: np.ndarray          # concatenated /voronoi_seeds order


def perceive(
    xyz: np.ndarray,
    poly: Optional[np.ndarray],
    resolution: float = 0.05,
    inflation_radius: float = 0.8,
    clip_z=(-0.4, 0.5),
    clip_xy=(-5.0, 72.0, -10.0, 20.0),
    exclusions: Optional[np.ndarray] = None,
    cluster_min_length: float = 2.0,
    ror: bool = True,
) -> PerceiveResult:
    """Full globalMapCallback -> processPointCloud pass
    (aos_seed_gen_node.cpp:230-579 + clusterAndVisualize + seeds)."""
    if exclusions is None:
        exclusions = np.zeros((0, 3))
    if ror:
        keep = radius_outlier_removal(xyz)
        xyz = xyz[keep]
    pts = preprocess_points(xyz, poly, clip_z, clip_xy, exclusions)
    bounds = active_bounds(poly, clip_xy)
    grid = generate_occupancy_grid(pts, bounds, resolution)
    inflated = apply_inflation(grid, inflation_radius)
    occupancy = mark_borders(inflated)
    skel = skeletonize(inflated)
    clusters = cluster_occupied_cells(skel, poly)
    filtered = [c for c in clusters if c.length >= cluster_min_length]
    rows_all = clusters_to_tree_rows(filtered, skel, poly)
    rows_sorted = sort_rows(rows_all)

    virtual = generate_virtual_seeds(rows_all, skel, poly)
    rays = generate_ray_points_from_endpoints(rows_all, skel, poly)
    endpoints = tree_row_endpoint_seeds(rows_all)
    # /voronoi_seeds publish order: virtual, real(empty), ray, endpoint
    # (aos_seed_gen_node.cpp:1670-1710)
    all_seeds = virtual + rays + endpoints
    seeds = np.array(all_seeds, np.float64) if all_seeds else np.zeros((0, 2))
    skeleton_pub = mark_polygon_boundary(skel, poly)
    return PerceiveResult(
        occupancy=occupancy,
        skeleton=skel,
        skeleton_pub=skeleton_pub,
        clusters=clusters,
        rows_all=rows_all,
        rows_sorted=rows_sorted,
        virtual_seeds=virtual,
        ray_seeds=rays,
        endpoint_seeds=endpoints,
        seeds=seeds,
    )
