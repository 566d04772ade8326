"""The full perception pass: points -> (occupancy, skeleton, rows, seeds)
(mirror of ``aosx/perceive/pipeline.py``; reference:
aos_seed_gen_node.cpp:230-2268)."""

from __future__ import annotations

import dataclasses

import torch

from .. import profiling
from ..config import AosParams, Statics
from ..types import GridWorld, PointCloud, Polygon, SeedSet, TreeRows
from . import points as _points
from . import raster as _raster
from . import rows as _rows
from . import seeds as _seeds
from . import skeleton as _skeleton


@dataclasses.dataclass(frozen=True)
class PerceiveOut:
    occupancy: GridWorld      # inflated + borders (/occupancy_grid)
    skeleton: GridWorld       # skeleton without boundary (raycast source)
    skeleton_pub: GridWorld   # + polygon rectangle (/skeletonized_occupancy_grid)
    rows: TreeRows            # reference (discovery) order
    rows_sorted: TreeRows     # /exploration_tree_rows_info order
    seeds: SeedSet            # /voronoi_seeds order
    guards: torch.Tensor      # aosx_torch.guards bitmask


def perceive(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
             s: Statics, *, ror_method: str = "sorted", stencil_mesh=None,
             stencil_axis: str = "space") -> PerceiveOut:
    """Preprocess, rasterize, inflate, mark borders, skeletonize, then
    ``perceive_tail``. stencil_mesh: optional ``parallel.spatial.Mesh``; the
    disc inflation and the morph open + Zhang-Suen then run on row bands
    over its devices (``parallel/spatial.py``), bitwise equal to the
    single-device stages. The other stages run as without a mesh.

    A cloud and polygon with a leading world axis (xyz [G, N, 3], the
    polygon's pts [G, P, 2]) perceive a group of worlds in one call, K2 and
    K3 launched once for the group; a mesh does not take a world axis.

    Spans (``profiling``): ``perceive``, its stages ``perceive.points``
    (preprocess, ROR), ``perceive.raster`` (grid, inflation, borders),
    ``perceive.skeleton`` (K2), then ``perceive_tail``'s."""
    if stencil_mesh is not None and pc.xyz.dim() > 2:
        raise ValueError("perceive: stencil_mesh does not take a world axis")
    with profiling.span("perceive"):
        with profiling.span("perceive.points"):
            xy, keep, bounds, guards = _points.preprocess(
                pc, poly, params, exclusions, s, ror_method=ror_method)
        with profiling.span("perceive.raster"):
            grid = _raster.generate_grid(xy, keep, bounds, s)
            if stencil_mesh is not None:
                from ..parallel.spatial import inflate_sharded

                inflated = inflate_sharded(grid, s, stencil_mesh, stencil_axis)
            else:
                inflated = _raster.inflate(grid, s)
            occupancy = _raster.mark_borders(inflated)
        with profiling.span("perceive.skeleton"):
            if stencil_mesh is not None:
                from ..parallel.spatial import skeletonize_sharded

                skel = skeletonize_sharded(inflated, s, stencil_mesh, stencil_axis)
            else:
                skel = _skeleton.skeletonize(inflated, s)
        return perceive_tail(skel, occupancy, poly, params, s, guards)


def perceive_tail(skel, occupancy, poly: Polygon, params: AosParams,
                  s: Statics, pre_guards) -> PerceiveOut:
    """Everything downstream of the skeleton: clusters -> rows -> seeds ->
    published grids. pre_guards seeds the output guard bitmask. Spans
    ``perceive.rows`` (clusters, union-finds, rows, sort) and
    ``perceive.seeds`` (seeds, published skeleton)."""
    with profiling.span("perceive.rows"):
        clusters = _rows.cluster_grid(skel, poly, params, s)
        rows = _rows.rows_from_clusters(clusters, skel, poly, params, s)
        rows_sorted = _rows.sort_rows(rows)
    with profiling.span("perceive.seeds"):
        seeds = _seeds.generate_seeds(rows, skel, poly, params, s)
        skeleton_pub = _raster.mark_polygon_rect(skel, poly, params.polygon_margin, s)
    return PerceiveOut(
        occupancy=occupancy,
        skeleton=skel,
        skeleton_pub=skeleton_pub,
        rows=rows,
        rows_sorted=rows_sorted,
        seeds=seeds,
        guards=pre_guards | clusters["guards"],
    )
