"""Procedural orchard generators (mirror of ``aosx/orchards.py``): the
orchard point clouds the perception stack expects, parallel tree rows
(trunk point clusters), stray noise, and an exploration polygon around the
rows.

- ``make_orchard_np``: the host-side NumPy generator, a copy (every
  ``aosx`` module imports jax); tests/test_torch_config.py checks that the
  two agree.
- ``make_orchard``: the fixed-shape tensor generator, drawn from a threefry
  key on any device, bitwise equal to the JAX package's on its CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import prng
from .f32math import cos_f32, sin_f32
from .ops import fma
from .types import PointCloud, Polygon


@dataclasses.dataclass(frozen=True)
class OrchardSpec:
    n_rows: int = 4                  # number of tree rows
    row_len: float = 18.0            # row length (m)
    row_spacing: float = 4.0         # spacing between rows (m)
    tree_spacing: float = 1.0        # trunk spacing along a row (m)
    trunk_pts: int = 24              # points per trunk
    trunk_radius: float = 0.15       # trunk point scatter (m)
    noise_pts: int = 64              # stray noise points (mostly ROR-removed)
    origin: Tuple[float, float] = (4.0, 3.0)  # first row start (world m)
    jitter: float = 0.15             # per-tree position jitter (m)
    polygon_pad: float = 1.5         # polygon margin around the row bbox
    # --- realism knobs (default 0.0 = the classic rectangular orchard; the
    # generators are BIT-IDENTICAL to their pre-knob outputs at defaults:
    # both knobs gate their PRNG draws / adds behind static Python branches)
    row_curve: float = 0.0           # max lateral bow of a row (m): rows
    # follow a sin arc like terrain-contoured plantings; stresses endpoint
    # extraction + linearization (more regression segments per path)
    dropout: float = 0.0             # per-tree missing probability: dead or
    # removed trees leave gaps that can split a skeleton row into several
    # clusters - the cluster/waypoint machinery must cope (real orchards do
    # this; the reference's demo field relies on continuous rows)


def make_orchard_np(spec: OrchardSpec, seed: int = 0):
    """Returns (xyz [N,3] float64, polygon [4,2] float64)."""
    rng = np.random.default_rng(seed)
    pts = []
    ox, oy = spec.origin
    n_trees = int(spec.row_len / spec.tree_spacing) + 1
    for r in range(spec.n_rows):
        y = oy + r * spec.row_spacing
        for t in range(n_trees):
            x = ox + t * spec.tree_spacing
            cx = x + rng.normal(0, spec.jitter)
            cy = y + rng.normal(0, spec.jitter)
            if spec.row_curve != 0.0:
                cy += spec.row_curve * np.sin(np.pi * t / max(n_trees - 1, 1))
            ang = rng.uniform(0, 2 * np.pi, spec.trunk_pts)
            rad = rng.uniform(0, spec.trunk_radius, spec.trunk_pts)
            z = rng.uniform(-0.2, 0.4, spec.trunk_pts)
            if spec.dropout > 0.0 and rng.uniform() < spec.dropout:
                continue  # dead / removed tree: a gap in the row
            pts.append(
                np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang), z], 1)
            )
    # stray noise (isolated points -> removed by ROR)
    minx, maxx = ox - 2, ox + spec.row_len + 2
    miny, maxy = oy - 2, oy + (spec.n_rows - 1) * spec.row_spacing + 2
    noise = np.stack(
        [
            rng.uniform(minx, maxx, spec.noise_pts),
            rng.uniform(miny, maxy, spec.noise_pts),
            rng.uniform(-0.3, 0.4, spec.noise_pts),
        ],
        1,
    )
    xyz = np.concatenate(pts + [noise], 0)
    ytop = oy + (spec.n_rows - 1) * spec.row_spacing
    if spec.row_curve > 0.0:
        ytop += spec.row_curve  # bowed rows reach row_curve past the grid
    poly = np.array(
        [
            [ox - spec.polygon_pad, oy - spec.polygon_pad],
            [ox + spec.row_len + spec.polygon_pad, oy - spec.polygon_pad],
            [ox + spec.row_len + spec.polygon_pad, ytop + spec.polygon_pad],
            [ox - spec.polygon_pad, ytop + spec.polygon_pad],
        ]
    )
    return xyz, poly


def make_orchard(key, spec: OrchardSpec, s, device=None):
    """The on-device orchard generator (mirror of ``aosx.orchards.make_orchard``):
    fixed shapes, drawn from ``key`` (``prng.prng_key(seed, device)``) with
    the JAX package's threefry streams. Returns (PointCloud, Polygon) on the
    key's device. Keys [G, 2] draw G orchards in one call, every leaf with a
    leading [G] axis (``jax.vmap`` of ``aosx.orchards.make_orchard``).

    Keys, bits, uniforms, normals and the trunk trig equal the JAX
    package's on the CPU bit for bit (``prng``, ``f32math``), and so does
    the cloud (tests/test_torch_orchards.py)."""
    dev = key.device if device is None else torch.device(device)
    key = key.to(dev)
    G = key.shape[:-1]
    n_trees = int(spec.row_len / spec.tree_spacing) + 1
    n_trunk = spec.n_rows * n_trees * spec.trunk_pts
    n_total = n_trunk + spec.noise_pts
    if n_total > s.max_points:
        raise ValueError(f"orchard of {n_total} points exceeds max_points {s.max_points}")
    ks = prng.split(key, 7 if spec.dropout > 0.0 else 6)
    ox, oy = spec.origin
    R, T, P = spec.n_rows, n_trees, spec.trunk_pts
    f32 = torch.float32

    rr = torch.arange(R, dtype=f32, device=dev)
    tt = torch.arange(T, dtype=f32, device=dev)
    cy0 = np.float32(oy) + rr[:, None] * np.float32(spec.row_spacing)
    cx0 = np.float32(ox) + tt[None, :] * np.float32(spec.tree_spacing)
    # jitter * normal: XLA:CPU folds jitter * sqrt(2) into one f32 constant
    # and fuses its product with the add that follows
    scale = torch.full(G + (R, T), float(np.float32(spec.jitter) * prng.SQRT2), device=dev)
    ex = prng.erfinv_uniform(ks[..., 0, :], (R, T))
    ey = prng.erfinv_uniform(ks[..., 1, :], (R, T))
    cx = fma(scale, ex, cx0.expand(G + (R, T)))
    if spec.row_curve != 0.0:
        # XLA:CPU folds pi / (T - 1) into one f32 constant, and fuses the
        # bow's product with the jitter it is added to
        arc = (np.float32(np.pi) / np.float32(max(T - 1, 1))) * tt
        bow = sin_f32(arc)[None, :].expand(G + (R, T))
        cy = cy0 + fma(torch.full_like(bow, float(np.float32(spec.row_curve))), bow, scale * ey)
    else:
        cy = fma(scale, ey, cy0.expand(G + (R, T)))
    cx, cy = cx[..., None], cy[..., None]

    ang = prng.uniform(ks[..., 2, :], (R, T, P), 0.0, np.float32(2 * np.pi))
    rad = prng.uniform(ks[..., 3, :], (R, T, P), 0.0, spec.trunk_radius)
    z = prng.uniform(ks[..., 4, :], (R, T, P), -0.2, 0.4)
    # cx + rad * cos(ang) rounded once: XLA:CPU fuses it
    px = fma(rad, cos_f32(ang), cx.expand_as(rad))
    py = fma(rad, sin_f32(ang), cy.expand_as(rad))
    trunk = torch.stack([px, py, z], -1).reshape(G + (n_trunk, 3))

    minx, maxx = ox - 2, ox + spec.row_len + 2
    miny, maxy = oy - 2, oy + (spec.n_rows - 1) * spec.row_spacing + 2
    noise = prng.uniform(ks[..., 5, :], (spec.noise_pts, 3),
                         np.array([minx, miny, -0.3], np.float32),
                         np.array([maxx, maxy, 0.4], np.float32))
    xyz = torch.zeros(G + (s.max_points, 3), dtype=f32, device=dev)
    xyz[..., :n_trunk, :] = trunk
    xyz[..., n_trunk:n_total, :] = noise
    valid = (torch.arange(s.max_points, device=dev) < n_total).expand(G + (s.max_points,))
    if spec.dropout > 0.0:
        # fixed shapes: a dropped tree keeps its slots, only its validity flips
        keep_tree = prng.uniform(ks[..., 6, :], (R, T)) >= np.float32(spec.dropout)
        trunk_valid = keep_tree.reshape(G + (-1,)).repeat_interleave(P, dim=-1)
        valid = valid & torch.cat([trunk_valid,
                                   torch.ones(G + (s.max_points - n_trunk,), dtype=torch.bool,
                                              device=dev)], dim=-1)
    ytop = oy + (spec.n_rows - 1) * spec.row_spacing
    if spec.row_curve > 0.0:
        ytop += spec.row_curve
    poly = np.array([[ox - spec.polygon_pad, oy - spec.polygon_pad],
                     [ox + spec.row_len + spec.polygon_pad, oy - spec.polygon_pad],
                     [ox + spec.row_len + spec.polygon_pad, ytop + spec.polygon_pad],
                     [ox - spec.polygon_pad, ytop + spec.polygon_pad]], np.float32)
    polygon = Polygon.from_array(poly, s, dev)
    if G:
        polygon = Polygon(pts=polygon.pts.expand(G + polygon.pts.shape).contiguous(),
                          count=polygon.count.expand(G).contiguous())
    return PointCloud(xyz=xyz, valid=valid.contiguous()), polygon
