"""Host-side renderer of the reference's RViz marker semantics (mirror of
``aosx/io/render.py``): numpy from the port's tensors, on any device.
matplotlib is imported only when a figure is drawn; the engine never needs
it.

Marker families mirrored from the reference (aos_gvd_node.cpp:1012-1591,
aos_path_gen_node.cpp:1676-1799, aos_seed_gen_node markers):
- /gvd_voronoi_seeds        yellow dots (0.2 spheres)
- /gvd_voronoi_nodes        purple dots (0.15)
- /gvd_voronoi_edges        sky-blue lines
- /gvd_voronoi_cells        per-seed golden-angle HSV fill (TRIANGLE_LIST ->
                            semi-transparent ownership overlay here)
- /gvd_voronoi_cell_boundaries  black ownership-change outlines
- /gvd_labeled_nodes        0.3 spheres, orange ring here
- /gvd_node_labels          TEXT "TL"/"BL" cyan, "TR"/"BR" orange
- /gvd_cluster_endpoints    ep1 red, ep2 blue (0.5 spheres)
- /gvd_ep{1,2}_voronoi_lines   endpoint -> labeled-node lines, cyan/orange
- tree rows                 green ep1->ep2 segments (seed_gen)
- ray/endpoint seeds        seed `kind` rendered as edge color (seed_gen's
                            ray markers: virtual-ray red, endpoint-ray gray)
- waypoints                 completed black / current yellow (green + large
                            while docking) / future red, with WP text
"""

from __future__ import annotations

import colorsys

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _golden_colors(n):
    """The reference's per-cell color scheme: hue stepped by the golden
    angle (aos_gvd_node.cpp voronoi cell markers)."""
    cols = np.zeros((n, 3))
    for i in range(n):
        cols[i] = colorsys.hsv_to_rgb((i * 137.508 / 360.0) % 1.0, 0.55, 0.95)
    return cols


def render_world(world, state=None, metrics=None, ax=None, show_grid=True,
                 seeds=None, rows=None, owner=None, show_cells=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(14, 6))

    skel = world.skeleton
    h = int(skel.h_cells)
    w = int(skel.w_cells)
    res = _res(world)
    ox, oy = float(skel.origin_x), float(skel.origin_y)
    extent = (ox, ox + w * res, oy, oy + h * res)

    if show_grid:
        occ = _np(world.occupancy.occ)[:h, :w]
        sk = _np(skel.occ)[:h, :w]
        img = np.zeros((h, w, 3))
        img[occ == 1] = (0.85, 0.85, 0.85)
        img[sk == 1] = (0.2, 0.2, 0.2)
        ax.imshow(img, origin="lower", extent=extent, interpolation="nearest")

    # ---- /gvd_voronoi_cells + cell boundaries -----------------------------
    if owner is not None and show_cells:
        own = _np(owner)[:h, :w]
        n_owners = int(own.max()) + 1 if own.max() >= 0 else 0
        if n_owners:
            cols = _golden_colors(n_owners)
            rgba = np.zeros((h, w, 4))
            valid = own >= 0
            rgba[valid, :3] = cols[own[valid]]
            rgba[valid, 3] = 0.30
            # black boundaries where ownership changes (cell_boundaries)
            bd = np.zeros((h, w), bool)
            bd[:, 1:] |= (own[:, 1:] != own[:, :-1]) & valid[:, 1:] & valid[:, :-1]
            bd[1:, :] |= (own[1:, :] != own[:-1, :]) & valid[1:, :] & valid[:-1, :]
            rgba[bd] = (0, 0, 0, 0.8)
            ax.imshow(rgba, origin="lower", extent=extent, interpolation="nearest")

    # ---- /gvd_voronoi_seeds (+ seed_gen ray markers by kind) --------------
    if seeds is not None:
        sv = _np(seeds.valid)
        sxy = _np(seeds.xy)[sv]
        kind = _np(seeds.kind)[sv]
        edge = np.array([
            (0.9, 0.9, 0.0),   # 0 virtual base: yellow
            (1.0, 0.2, 0.2),   # 1 virtual raycast: red (hit markers)
            (0.5, 0.5, 0.5),   # 2 endpoint ray: gray
            (0.0, 0.6, 0.0),   # 3 row endpoint: green
            (1.0, 0.5, 0.0),   # 4 real: orange
        ])[np.clip(kind, 0, 4)]
        ax.scatter(sxy[:, 0], sxy[:, 1], s=10, c=[(1.0, 1.0, 0.0)],
                   edgecolors=edge, linewidths=0.6, zorder=3)

    g = world.graph
    n = int(g.num_nodes)
    e = int(g.num_edges)
    nodes = _np(g.nodes)[:n]
    edges = _np(g.edges)[:e]
    for a, b in edges:
        ax.plot(*zip(nodes[a], nodes[b]), color=(0.0, 0.8, 1.0), lw=0.6, zorder=2)
    ax.scatter(nodes[:, 0], nodes[:, 1], s=6, color=(0.8, 0.0, 0.8), zorder=3)

    labels = _np(g.node_labels)[:n]
    lab = nodes[labels > 0]
    ax.scatter(lab[:, 0], lab[:, 1], s=40, facecolors="none", edgecolors="orange", zorder=4)

    # ---- /gvd_node_labels text: TL/BL cyan, TR/BR orange ------------------
    ln = _np(g.label_node)
    names = ("TL", "TR", "BL", "BR")
    cyan, orange = (0.0, 0.9, 0.9), (1.0, 0.5, 0.0)
    for c in range(ln.shape[0]):
        for li in range(4):
            ni = ln[c, li]
            if 0 <= ni < n:
                col = cyan if li in (0, 2) else orange
                ax.annotate(names[li], nodes[ni], fontsize=6, color=col,
                            zorder=6, xytext=(2, 2), textcoords="offset points")

    # ---- tree rows + /gvd_cluster_endpoints + ep->label lines -------------
    if rows is not None:
        rv = _np(rows.valid)
        e1 = _np(rows.ep1)
        e2 = _np(rows.ep2)
        for i in np.nonzero(rv)[0]:
            ax.plot([e1[i, 0], e2[i, 0]], [e1[i, 1], e2[i, 1]],
                    color=(0.0, 0.7, 0.0), lw=1.4, zorder=3)
            ax.scatter(*e1[i], s=55, color="red", zorder=5)      # ep1 red
            ax.scatter(*e2[i], s=55, color="blue", zorder=5)     # ep2 blue
            if i < ln.shape[0]:
                # ep1 -> TL/BL labeled nodes (cyan), ep2 -> TR/BR (orange)
                for li, ep, col in ((0, e1[i], cyan), (2, e1[i], cyan),
                                    (1, e2[i], orange), (3, e2[i], orange)):
                    ni = ln[i, li]
                    if 0 <= ni < n:
                        ax.plot([ep[0], nodes[ni, 0]], [ep[1], nodes[ni, 1]],
                                color=col, lw=0.7, alpha=0.7, zorder=4)

    wp = world.waypoints if state is None else state.wp
    nw = int(wp.count)
    wxy = _np(wp.xy)[:nw]
    if state is not None:
        cur = int(state.mission.target_wp)
        dock = bool(_np(state.mission.waiting_for_docking))
        for i, p in enumerate(wxy):
            if i < cur:
                c, s = "black", 25
            elif i == cur:
                c, s = ("green", 90) if dock else ("yellow", 60)
            else:
                c, s = "red", 25
            ax.scatter(*p, s=s, color=c, zorder=5, edgecolors="k", linewidths=0.5)
            ax.annotate(f"WP{i}", p, fontsize=6, zorder=6)
    else:
        ax.scatter(wxy[:, 0], wxy[:, 1], s=30, color="red", zorder=5)

    if state is not None:
        # CachedEngineState (plan/plancache.py) carries a cache row index
        # instead of a materialized plan; skip the path polyline for it
        plan = getattr(state, "plan", None)
        if plan is not None:
            pc = int(plan.count)
            pxy = _np(plan.xy)[:pc]
            if pc:
                ax.plot(pxy[:, 0], pxy[:, 1], "b-", lw=1.2, zorder=4)
        ax.scatter(*_np(state.robot.xy), marker="*", s=120, color="magenta", zorder=7)

    if metrics is not None:
        trail = _np(metrics["xy"])
        ax.plot(trail[:, 0], trail[:, 1], color="magenta", lw=0.8, alpha=0.6, zorder=4)

    ax.set_aspect("equal")
    return ax


def _res(world):
    # resolution is static config, not carried in GridWorld; infer from the
    # occupancy bbox if the caller didn't bake it in. Default 0.05.
    return getattr(world, "resolution", 0.05)


def save_episode_figure(path, world, state=None, metrics=None, resolution=0.05,
                        seeds=None, rows=None, owner=None, show_cells=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    class _W:  # tiny shim carrying resolution for extent computation
        def __init__(self, w):
            self.__dict__.update({k: getattr(w, k) for k in
                                  ("skeleton", "occupancy", "graph", "waypoints")})
            self.resolution = resolution

    ax = render_world(_W(world), state=state, metrics=metrics, seeds=seeds,
                      rows=rows, owner=owner, show_cells=show_cells)
    ax.figure.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(ax.figure)
