"""Configuration for the PyTorch port of the aosx orchard exploration engine.

Field-for-field mirror of ``aosx/config.py``: the same ``Statics`` (every
field, every preset, ``for_grid`` and the 8/128 rounding in
``__post_init__``) and the same ``AosParams`` defaults, so that both packages
build identically shaped buffers and the parity tests can compare leaf for
leaf. Reference citations for every constant live in ``aosx/config.py``.

Two kinds of configuration:

``Statics``   -- hashable, shape-determining constants (grid caps, buffer
                 caps, resolution, iteration caps).
``AosParams`` -- runtime scalars; ``params_as_f32`` turns them into 0-d
                 tensors on an explicit device.

``jfa_pass_pallas``, ``skeleton_pallas`` and ``jfa_dynamic_shifts`` choose
between TPU/XLA lowerings in ``aosx``. In this package every jump-flood pass
and every thinning iteration runs through its hand-written CUDA kernel when
the tensors live on a CUDA device (``gvd/jfa_pass_cuda.py``,
``perceive/skeleton_cuda.py``), whatever they say. ``skeleton_pallas``
exists only for field parity. ``jfa_pass_pallas`` and ``jfa_dynamic_shifts``
choose how each flood pass rounds its squared distances: as ``aosx``'s
XLA:CPU build of the lowering they select for that pass
(``gvd/voronoi.py``'s ``pass_roundings``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Statics:
    """Hashable shape-determining constants (see ``aosx.config.Statics`` for
    the derivation of every cap)."""

    grid_h: int = 576
    grid_w: int = 1664
    resolution: float = 0.05
    inflation_radius: float = 0.8

    max_points: int = 65536
    max_poly: int = 8
    max_exclusions: int = 16
    max_clusters: int = 64
    max_skel_cells: int = 16384
    max_rows: int = 32
    max_seeds_per_row: int = 96
    max_seeds: int = 1024
    max_nodes: int = 1024
    max_edges: int = 4096
    max_labels: int = 256
    max_waypoints: int = 68
    max_path: int = 256
    max_plan: int = 4096
    astar_k: int = 5
    max_segments: int = 10
    max_degree: int = 16
    crossing_coarse_factor: int = 8
    crossing_nmax_long: int = 256
    crossing_cap_edges_factor: int = 32
    astar_serial_candidates: bool = False
    cluster_band: int = 0
    max_ccl_runs: int = 0
    max_delta_points: int = 8192
    seed_raycast_max: float = 4.0
    trim_max_distance: float = 0.2
    skeleton_max_iters: int = 64
    ccl_max_iters: int = 32
    # with jfa_pass_pallas: the flood's rounding (gvd/voronoi.py's
    # pass_roundings)
    jfa_dynamic_shifts: bool = False
    exact_fallbacks: bool = True
    # the flood's rounding: aosx's Pallas pass kernel's for steps <= 128
    # (gvd/voronoi.py's pass_roundings)
    jfa_pass_pallas: bool = False
    # kept for field parity with aosx; no effect in this package
    skeleton_pallas: bool = False

    def __post_init__(self):
        object.__setattr__(self, "grid_h", _round_up(self.grid_h, 8))
        object.__setattr__(self, "grid_w", _round_up(self.grid_w, 128))

    @property
    def inflation_cells(self) -> int:
        return int(self.inflation_radius / self.resolution)

    @classmethod
    def for_grid(cls, grid_h: int, grid_w: int, resolution: float = 0.05,
                 **overrides) -> "Statics":
        """Content caps derived for an arbitrary (grid_h x grid_w) map; the
        same scaling rules as ``aosx.config.Statics.for_grid``."""
        cells = grid_h * grid_w
        area = max(1, -(-cells // (2000 * 2048)))
        long_side = max(grid_h, grid_w)
        meters_long = long_side * resolution
        meters_h = grid_h * resolution
        mlinear = max(1, -(-int(meters_long * 10) // 1024))
        max_rows = max(32, 16 * max(1, -(-int(meters_h * 10) // 1024)))
        base = dict(
            grid_h=grid_h, grid_w=grid_w, resolution=resolution,
            max_points=min(131072 * area, 1048576),
            max_skel_cells=65536 * area,
            max_rows=max_rows,
            max_seeds_per_row=512,
            max_seeds=4096 * min(area, 4),
            max_clusters=min(64 * area, 1024),
            max_nodes=min(8192 * area, 32768),
            max_edges=min(32768 * area, 131072),
            max_labels=8 * max_rows,
            max_waypoints=2 * max_rows + 4,
            max_path=768 * mlinear,
            max_plan=4096 * mlinear,
            cluster_band=min(_round_up(long_side, 512), 65536 * area),
            crossing_nmax_long=512,
            crossing_cap_edges_factor=48 * max(
                1, -(-cells // (12 * 2000 * 2048))),
            jfa_pass_pallas=True,
        )
        base.update(overrides)
        return cls(**base)


TEST_STATICS = Statics(
    grid_h=384,
    grid_w=512,
    resolution=0.05,
    max_points=4096,
    max_clusters=16,
    max_skel_cells=2048,
    max_rows=8,
    max_seeds_per_row=48,
    max_seeds=256,
    max_nodes=256,
    max_edges=1024,
    max_labels=64,
    max_waypoints=20,
    max_path=64,
    max_plan=2048,
    max_delta_points=1024,
    jfa_dynamic_shifts=True,
)

DRYRUN_STATICS = Statics(
    grid_h=192,
    grid_w=256,
    resolution=0.05,
    max_points=512,
    max_poly=8,
    max_clusters=8,
    max_skel_cells=512,
    max_rows=4,
    max_seeds_per_row=16,
    max_seeds=128,
    max_nodes=128,
    max_edges=512,
    max_labels=32,
    max_waypoints=12,
    max_path=64,
    max_plan=1024,
    max_delta_points=128,
    skeleton_max_iters=32,
    jfa_dynamic_shifts=True,
)

MC_STATICS = dataclasses.replace(
    TEST_STATICS, jfa_dynamic_shifts=False, exact_fallbacks=False,
    max_plan=1024)

MC_REALISM_STATICS = dataclasses.replace(
    MC_STATICS,
    crossing_nmax_long=512,
    crossing_cap_edges_factor=48,
    max_ccl_runs=512,
)

# 200 x 200 m at 0.1 m (BASELINE.md's north-star field): the bench.py size
BENCH_STATICS = Statics(
    grid_h=2000,
    grid_w=2048,
    resolution=0.1,
    max_points=131072,
    max_skel_cells=65536,
    max_rows=32,
    max_seeds_per_row=192,
    max_seeds=4096,
    max_nodes=8192,
    max_edges=32768,
    max_path=768,
    max_plan=4096,
    jfa_pass_pallas=True,
)


@dataclasses.dataclass(frozen=True)
class AosParams:
    """Runtime scalar parameters, one-to-one with ``aosx.config.AosParams``.
    Python scalars by default; ``params_as_f32`` makes 0-d tensors."""

    clipping_minz: Any = -0.4
    clipping_maxz: Any = 0.5
    clipping_minx: Any = -5.0
    clipping_maxx: Any = 72.0
    clipping_miny: Any = -10.0
    clipping_maxy: Any = 20.0
    cluster_min_length: Any = 2.0
    ror_radius: Any = 0.2
    ror_min_neighbors: Any = 2
    polygon_margin: Any = 2.5
    virtual_seed_interval: Any = 1.0
    seed_dedupe_dist: Any = 0.5
    seed_raycast_max: Any = 4.0
    seed_raycast_min: Any = 1.0
    seed_merge_dist: Any = 0.5
    proximity_edge_dist: Any = 0.5
    label_search_min_dist: Any = 0.5
    label_search_radius0: Any = 5.0
    label_match_tolerance: Any = 0.1
    initial_waypoint_x: Any = 8.0
    initial_waypoint_y: Any = 0.0
    initial_arrive_dist: Any = 1.0
    docking_radius: Any = 0.7
    heuristic_weight: Any = 3.0
    min_waypoint_distance: Any = 0.2
    path_step: Any = 0.2
    trim_safety_distance: Any = 0.2
    linearize_spacing: Any = 0.05
    linearize_max_dev: Any = 0.1
    sm_precise_dist: Any = 0.05
    sm_precise_yaw: Any = 0.0524
    sm_semi_dist: Any = 0.1
    sm_semi_yaw: Any = 0.0873
    sm_approach_dist: Any = 0.5
    sm_skipping_hz: Any = 5
    utm_zone: Any = 52
    gps_offset_x: Any = -0.65
    gps_offset_y: Any = 0.55


def params_as_f32(p: AosParams, device) -> AosParams:
    """Every numeric field as a 0-d tensor on ``device``: int32 for
    integers, float32 for everything else (as ``aosx.config.params_as_f32``)."""

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (int, np.integer)):
            return torch.tensor(int(x), dtype=torch.int32, device=device)
        return torch.tensor(np.float32(x), dtype=torch.float32, device=device)

    return AosParams(**{f.name: conv(getattr(p, f.name))
                        for f in dataclasses.fields(p)})


# YAML keys of the reference's aos_planner_params.yaml and the AosParams
# fields they set (same names where they exist)
_YAML_TO_FIELD = {
    "clipping_minz": "clipping_minz",
    "clipping_maxz": "clipping_maxz",
    "clipping_minx": "clipping_minx",
    "clipping_maxx": "clipping_maxx",
    "clipping_miny": "clipping_miny",
    "clipping_maxy": "clipping_maxy",
    "cluster_min_length": "cluster_min_length",
}
# ... and the shape-determining ones, returned apart for a Statics
_YAML_TO_STATIC = {
    "grid_resolution": "resolution",
    "inflation_radius": "inflation_radius",
}


def load_yaml(path: str, node: str = "aos_seed_gen_node"):
    """Load the reference's aos_planner_params.yaml schema: the global
    ``/**`` section, then the node's overrides (as ``aosx.config.load_yaml``).

    Returns (params: AosParams, static_overrides: dict): resolution and
    inflation radius determine shapes, so they come back apart for the
    caller to fold into a Statics."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    merged: dict = {}
    merged.update(doc.get("/**", {}).get("ros__parameters", {}))
    merged.update(doc.get(f"/{node}", {}).get("ros__parameters", {}))
    params = {fk: float(merged[yk]) for yk, fk in _YAML_TO_FIELD.items() if yk in merged}
    statics = {fk: float(merged[yk]) for yk, fk in _YAML_TO_STATIC.items() if yk in merged}
    return AosParams(**params), statics
