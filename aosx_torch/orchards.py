"""Procedural orchard generator (NumPy), copied from ``aosx/orchards.py``.

``make_orchard_np`` is the host-side generator of the orchard point clouds
the perception stack expects: parallel tree rows (trunk point clusters),
stray noise, and an exploration polygon around the rows. Every ``aosx``
module imports jax, so the port carries its own copy; the two are kept
identical (tests/test_torch_config.py checks that they agree).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
