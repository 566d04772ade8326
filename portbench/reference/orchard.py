"""The procedural orchard of a key, written from its description: ``n_rows``
rows ``row_spacing`` apart starting at ``origin``, a tree every
``tree_spacing`` along ``row_len``, each tree's centre jittered by a normal
of deviation ``jitter`` and bowed across the row by ``row_curve`` sin(pi t
/ (trees - 1)), ``trunk_pts`` points scattered uniformly in angle and radius
(up to ``trunk_radius``) around it at heights in [-0.2, 0.4), a tree
missing where its draw falls under ``dropout``, ``noise_pts`` stray points
uniform over the rows' box grown by 2 m (heights in [-0.3, 0.4)), and the
exploration polygon: the rows' box grown by ``polygon_pad`` (and by
``row_curve`` at the top).

The key is split into seven streams, in this order: the x jitter, the y
jitter, the trunk angles, the trunk radii, the trunk heights, the noise,
and the missing trees. Arithmetic in the torch dtype asked for."""

from __future__ import annotations

import math

import numpy as np

from . import keys as K


def orchard(key, spec: dict, dtype, device):
    """(points [N, 3], polygon [4, 2]) of the orchard of ``key``, as torch
    tensors of ``dtype`` on ``device``; missing trees are left out."""
    import torch

    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    R, rl, sp = int(spec["n_rows"]), float(spec["row_len"]), float(spec["row_spacing"])
    T = int(rl / float(spec["tree_spacing"])) + 1
    P = int(spec["trunk_pts"])
    ox, oy = (float(v) for v in spec["origin"])
    curve, dropout = float(spec.get("row_curve", 0.0)), float(spec.get("dropout", 0.0))
    jitter = float(spec.get("jitter", 0.15))
    ks = K.split(key, 7 if dropout > 0.0 else 6)

    rows = torch.arange(R, device=device).to(dtype)
    trees = torch.arange(T, device=device).to(dtype)
    cx = t(ox) + trees[None, :] * t(spec["tree_spacing"]) + t(jitter) * t(
        K.standard_normal(ks[0], (R, T)))
    cy = t(oy) + rows[:, None] * t(sp) + t(jitter) * t(K.standard_normal(ks[1], (R, T)))
    if curve != 0.0:
        cy = cy + t(curve) * torch.sin(t(math.pi / max(T - 1, 1)) * trees)[None, :]
    ang = t(K.uniform(ks[2], (R, T, P), 0.0, 2 * np.pi))
    rad = t(K.uniform(ks[3], (R, T, P), 0.0, spec.get("trunk_radius", 0.15)))
    z = t(K.uniform(ks[4], (R, T, P), -0.2, 0.4))
    trunk = torch.stack([cx[..., None] + rad * torch.cos(ang),
                         cy[..., None] + rad * torch.sin(ang), z], -1)
    if dropout > 0.0:
        keep = K.uniform(ks[6], (R, T), 0.0, 1.0) >= np.float32(dropout)
        trunk = trunk[torch.as_tensor(keep, device=device)]
    noise = t(K.uniform(ks[5], (int(spec["noise_pts"]), 3),
                        [ox - 2, oy - 2, -0.3], [ox + rl + 2, oy + (R - 1) * sp + 2, 0.4]))
    pts = torch.cat([trunk.reshape(-1, 3), noise], 0)
    pad = float(spec["polygon_pad"])
    ytop = oy + (R - 1) * sp + (curve if curve > 0.0 else 0.0)
    poly = t([[ox - pad, oy - pad], [ox + rl + pad, oy - pad],
              [ox + rl + pad, ytop + pad], [ox - pad, ytop + pad]])
    return pts, poly
