"""The perception of an orchard's points, written from the semantics of the
reference's ``aos_seed_gen_node.cpp`` (processPointCloud,
generateOccupancyGrid, applyInflation, skeletonizeOccupancyGrid,
clusterOccupiedCells, convertClustersToTreeRows), in plain PyTorch:

- the points within the height clip and within the polygon's box grown by
  ``polygon_margin`` (inclusive) are kept when at least
  ``ror_min_neighbors`` other kept points lie within ``ror_radius`` (3-D);
- the grid covers that box at ``resolution``, a point in the cell its
  offsets truncate to; the occupied cells are grown by a disc of
  int(``inflation_radius`` / ``resolution``) cells;
- the skeleton is the grown grid opened by a 3 x 3 cross and thinned by
  Zhang and Suen's two sub-iterations until nothing changes (the outer ring
  of cells untouched);
- a row is an 8-connected set of skeleton cells inside the polygon (a
  cell's corner tested), at least ``cluster_min_length`` across (the
  largest distance between two of its cells) and centred inside the
  polygon.

Coordinates in the dtype asked for; the grids are boolean."""

from __future__ import annotations


def inside(px, py, poly):
    """Ray casting of points (px, py) against polygon [P, 2]: inside where
    an odd number of edges with |dy| > 1e-9 cross the ray to +x."""
    import torch

    out = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    n = poly.shape[0]
    for i in range(n):
        xi, yi = poly[i, 0], poly[i, 1]
        xj, yj = poly[(i - 1) % n, 0], poly[(i - 1) % n, 1]
        dy = yj - yi
        if abs(float(dy)) > 1e-9:
            cross = ((yi > py) != (yj > py)) & (px < (xj - xi) * (py - yi) / dy + xi)
            out = out ^ cross
    return out


def kept_points(pts, poly, p: dict):
    """The points the grid is made of, [M, 2]."""
    import torch

    margin = p["polygon_margin"]
    lo, hi = poly.min(0).values - margin, poly.max(0).values + margin
    m = ((pts[:, 2] >= p["clip_z"][0]) & (pts[:, 2] <= p["clip_z"][1])
         & (pts[:, 0] >= lo[0]) & (pts[:, 0] <= hi[0])
         & (pts[:, 1] >= lo[1]) & (pts[:, 1] <= hi[1]))
    q = pts[m]
    d = q[:, None, :] - q[None, :, :]
    d2 = (d * d).sum(-1)
    r = torch.tensor(p["ror_radius"], dtype=q.dtype, device=q.device)
    near = (d2 <= r * r).sum(-1) - 1
    return q[near >= p["ror_min_neighbors"], :2]


def grid_frame(poly, p: dict):
    """(min x, min y, cells high, cells wide) of the grid of a polygon."""
    import math

    margin, res = p["polygon_margin"], p["resolution"]
    lo, hi = poly.min(0).values - margin, poly.max(0).values + margin
    w = max(1, math.ceil(float(hi[0] - lo[0]) / res))
    h = max(1, math.ceil(float(hi[1] - lo[1]) / res))
    return lo[0], lo[1], h, w


def grids(pts, poly, p: dict):
    """The skeleton [h, w] bool and the grid's frame (min x, min y)."""
    import torch
    import torch.nn.functional as F

    x0, y0, h, w = grid_frame(poly, p)
    xy = kept_points(pts, poly, p)
    res = torch.tensor(p["resolution"], dtype=xy.dtype, device=xy.device)
    gx = torch.trunc((xy[:, 0] - x0) / res).long()
    gy = torch.trunc((xy[:, 1] - y0) / res).long()
    ok = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
    raw = torch.zeros(h, w, dtype=torch.bool, device=xy.device)
    raw[gy[ok], gx[ok]] = True
    ic = int(p["inflation_radius"] / p["resolution"] + 1e-9)
    r = torch.arange(-ic, ic + 1, device=xy.device)
    disc = ((r[:, None] ** 2 + r[None, :] ** 2) <= ic * ic).float()
    grown = F.conv2d(raw.float()[None, None], disc[None, None], padding=ic)[0, 0] > 0.5
    return thin(open_cross(grown)), (x0, y0)


def _shift(z, dy: int, dx: int, h: int, w: int):
    return z[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


CROSS = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


def open_cross(b):
    """Erosion (outside counts as set) then dilation (outside unset) by the
    3 x 3 cross."""
    import torch.nn.functional as F

    h, w = b.shape
    z = F.pad(b, (1, 1, 1, 1), value=True)
    er = b.clone()
    for dy, dx in CROSS:
        er &= _shift(z, dy, dx, h, w)
    z = F.pad(er, (1, 1, 1, 1), value=False)
    out = er.clone()
    for dy, dx in CROSS:
        out |= _shift(z, dy, dx, h, w)
    return out


def thin(b, max_iters: int = 10000):
    """Zhang-Suen thinning to a fixed point."""
    import torch
    import torch.nn.functional as F

    img = b.clone()
    h, w = img.shape
    inner = torch.zeros_like(img)
    inner[1:-1, 1:-1] = True
    for _ in range(max_iters):
        before = img
        for phase in (0, 1):
            z = F.pad(img.to(torch.int32), (1, 1, 1, 1))
            p2, p3, p4 = _shift(z, -1, 0, h, w), _shift(z, -1, 1, h, w), _shift(z, 0, 1, h, w)
            p5, p6, p7 = _shift(z, 1, 1, h, w), _shift(z, 1, 0, h, w), _shift(z, 1, -1, h, w)
            p8, p9 = _shift(z, 0, -1, h, w), _shift(z, -1, -1, h, w)
            ring = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
            a = sum(((u == 0) & (v == 1)).to(torch.int32) for u, v in zip(ring[:-1], ring[1:]))
            nb = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
            if phase == 0:
                m1, m2 = p2 * p4 * p6, p4 * p6 * p8
            else:
                m1, m2 = p2 * p4 * p8, p2 * p6 * p8
            drop = (a == 1) & (nb >= 2) & (nb <= 6) & (m1 == 0) & (m2 == 0) & img & inner
            img = img & ~drop
        if torch.equal(before, img):
            break
    return img


def components(mask):
    """8-connected labels of ``mask`` (0 outside; a set's label is its
    largest cell index + 1), by repeated 3 x 3 maxima and pointer jumps."""
    import torch
    import torch.nn.functional as F

    h, w = mask.shape
    idx = torch.arange(1, h * w + 1, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, 0)
    while True:
        nxt = F.max_pool2d(lab[None, None].double(), 3, 1, 1)[0, 0].long()
        nxt = torch.where(mask, nxt, 0)
        flat = nxt.flatten()
        # jump: a cell takes the label of the cell its label names
        jumped = torch.where(flat > 0, flat[(flat - 1).clamp(min=0)], 0).reshape(h, w)
        nxt = torch.maximum(nxt, jumped)
        if torch.equal(nxt, lab):
            return lab
        lab = nxt


def rows(skel, frame, poly, p: dict) -> list:
    """The tree rows the skeleton holds, sorted by centre y (then x): for
    each, its centre and its two ends (the cell farthest from the centre,
    then the farthest on the other side of it), in metres, as float64."""
    import torch

    x0, y0 = frame
    res = p["resolution"]
    h, w = skel.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=skel.device),
                            torch.arange(w, device=skel.device), indexing="ij")
    dt = poly.dtype
    r = torch.tensor(res, dtype=dt, device=skel.device)
    cells = skel & inside(x0 + gx.to(dt) * r, y0 + gy.to(dt) * r, poly)
    lab = components(cells)
    out = []
    for v in torch.unique(lab[lab > 0]).tolist():
        ys, xs = torch.nonzero(lab == v, as_tuple=True)
        c = torch.stack([xs, ys], -1).double()
        span = (c[:, None] - c[None]).pow(2).sum(-1).max().sqrt().item() * res
        if span < p["cluster_min_length"]:
            continue
        centre = c.mean(0)
        if not inside((x0 + centre[0].to(dt) * r).reshape(1),
                      (y0 + centre[1].to(dt) * r).reshape(1), poly).item():
            continue
        d = c - centre
        d2 = (d * d).sum(-1)
        first = int(d2.argmax())
        back = (d @ d[first]) < 0
        second = int(torch.where(back, d2, -1.0).argmax()) if back.any() else int(
            ((c - c[first]) ** 2).sum(-1).argmax())
        m = lambda q: (float(x0) + float(q[0]) * res, float(y0) + float(q[1]) * res)  # noqa: E731
        out.append((m(centre), m(c[first]), m(c[second])))
    return sorted(out, key=lambda t: (t[0][1], t[0][0]))
