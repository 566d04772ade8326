"""Skeletonization: morphological open (3x3 cross) then Zhang-Suen thinning
to fixpoint (mirror of ``aosx/perceive/skeleton.py``; reference:
aos_seed_gen_node.cpp:672-705, cv::morphologyEx +
cv::ximgproc::thinning(THINNING_ZHANGSUEN)).

OpenCV border semantics: erosion treats outside-of-image as 1, dilation as
0; thinning never modifies the outer 1-pixel ring of the live image. A whole
thinning, every iteration up to the fixpoint, is one call of kernel K2
(``skeleton_cuda.zhang_suen_fixpoint``) with no host read in it; a group of
grids with a leading world axis is one call too, each world stopping at its
own fixpoint.
"""

from __future__ import annotations

import torch

from ..config import Statics
from ..types import GridWorld
from .raster import to_plane, iota2, live_mask, shift2d
from .skeleton_cuda import zhang_suen_fixpoint

_CROSS = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


def _outside_live(grid: GridWorld, dy: int, dx: int):
    """Mask of cells whose (y-dy, x-dx) source lies outside the live region."""
    iy, ix = iota2(grid.occ.shape[-2:], grid.occ.device)
    sy, sx = iy - dy, ix - dx
    return (sy < 0) | (sy >= to_plane(grid.h_cells)) | (sx < 0) | (sx >= to_plane(grid.w_cells))


def morph_open(grid: GridWorld) -> GridWorld:
    """cv::morphologyEx(MORPH_OPEN) with the 3x3 ellipse (cross) kernel."""
    p = grid.occ
    one = torch.ones_like(p)
    er = one
    for dy, dx in _CROSS:
        nb = torch.where(_outside_live(grid, dy, dx), one, shift2d(p, dy, dx))
        er = torch.minimum(er, nb)
    live = live_mask(grid)
    er = torch.where(live, er, torch.zeros_like(er))
    di = torch.zeros_like(p)
    for dy, dx in _CROSS:
        di = torch.maximum(di, shift2d(er, dy, dx))
    di = torch.where(live, di, torch.zeros_like(di))
    return GridWorld(di, grid.origin_x, grid.origin_y, grid.h_cells, grid.w_cells)


def zhang_suen(grid: GridWorld, s: Statics) -> GridWorld:
    """Thin to fixpoint (both sub-iterations per iteration, stop after the
    first iteration that changes nothing), capped at s.skeleton_max_iters
    iterations. The stopping rule runs on the device: the host reads
    nothing, and the live bounds go to the kernel as the grid's own device
    scalars."""
    occ, _ = zhang_suen_fixpoint(grid.occ.contiguous(), grid.h_cells, grid.w_cells,
                                 s.skeleton_max_iters)
    return GridWorld(occ, grid.origin_x, grid.origin_y, grid.h_cells, grid.w_cells)


def skeletonize(grid: GridWorld, s: Statics) -> GridWorld:
    """skeletonizeOccupancyGrid (aos_seed_gen_node.cpp:672-705)."""
    return zhang_suen(morph_open(grid), s)
