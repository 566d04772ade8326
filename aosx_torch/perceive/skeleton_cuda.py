"""Kernel K2: one Zhang-Suen thinning iteration (both sub-iterations).

Replaces the TPU kernel ``aosx/perceive/skeleton_pallas.py::zhang_suen_pallas``.
The CUDA C++ source is ``aosx_torch/csrc/zhang_suen.cu`` (design and bounds in
its header note); ``zhang_suen_iteration_plain`` is the same computation in
plain PyTorch, mirroring ``aosx.perceive.skeleton._subiter``.

``zhang_suen_iteration`` takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from .raster import iota2, shift2d


def _neighbors(p):
    """p2..p9 (N, NE, E, SE, S, SW, W, NW) with row y-1 as N."""
    return (shift2d(p, 1, 0), shift2d(p, 1, -1), shift2d(p, 0, -1),
            shift2d(p, -1, -1), shift2d(p, -1, 0), shift2d(p, -1, 1),
            shift2d(p, 0, 1), shift2d(p, 1, 1))


def _subiter(p, phase: int, interior):
    p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(p)
    seq = (p2, p3, p4, p5, p6, p7, p8, p9, p2)
    A = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    for a, b in zip(seq[:-1], seq[1:]):
        A += ((a == 0) & (b == 1)).to(torch.int32)
    B = p2.to(torch.int32) + p3 + p4 + p5 + p6 + p7 + p8 + p9
    if phase == 0:
        m1 = p2 * p4 * p6
        m2 = p4 * p6 * p8
    else:
        m1 = p2 * p4 * p8
        m2 = p2 * p6 * p8
    delete = (A == 1) & (B >= 2) & (B <= 6) & (m1 == 0) & (m2 == 0) & (p == 1) & interior
    return torch.where(delete, torch.zeros_like(p), p)


def zhang_suen_iteration_plain(occ, h_cells, w_cells):
    """Both sub-iterations in plain PyTorch. Returns (occ u8 [H,W],
    changed-cell count i32)."""
    iy, ix = iota2(occ.shape, occ.device)
    interior = (iy >= 1) & (iy < h_cells - 1) & (ix >= 1) & (ix < w_cells - 1)
    q = _subiter(occ, 0, interior)
    q = _subiter(q, 1, interior)
    return q, (q != occ).sum(dtype=torch.int32)


_vp = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("zhang_suen")
    fn = lib.zhang_suen_iteration
    fn.argtypes = [_vp, _vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int, _vp]
    fn.restype = ctypes.c_int
    return fn


def zhang_suen_iteration(occ, h_cells, w_cells):
    """One thinning iteration. Returns (occ u8 [H,W], changed-cell count i32
    0-d tensor). CPU tensors take the plain version; CUDA tensors launch
    kernel K2 (counted in ``zhang_suen_iteration.launches``)."""
    if occ.device.type == "cpu":
        return zhang_suen_iteration_plain(occ, h_cells, w_cells)
    if occ.device.type != "cuda":
        raise ValueError(f"zhang_suen_iteration: unsupported device {occ.device}")
    if occ.dtype != torch.uint8 or occ.dim() != 2 or not occ.is_contiguous():
        raise ValueError("zhang_suen_iteration: occ must be a contiguous 2-D uint8 tensor")
    H, W = occ.shape
    bounds = torch.stack([torch.as_tensor(h_cells, device=occ.device),
                          torch.as_tensor(w_cells, device=occ.device)]).to(torch.int32)
    tmp = torch.empty_like(occ)
    out = torch.empty_like(occ)
    changed = torch.empty((), dtype=torch.int32, device=occ.device)
    stream = torch.cuda.current_stream(occ.device).cuda_stream
    rc = _lib()(occ.data_ptr(), tmp.data_ptr(), out.data_ptr(), bounds.data_ptr(),
                changed.data_ptr(), H, W, stream)
    cuda_build.check(rc, "zhang_suen_iteration")
    zhang_suen_iteration.launches += 1
    return out, changed


zhang_suen_iteration.launches = 0
