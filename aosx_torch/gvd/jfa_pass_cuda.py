"""Kernel K1: one Jacobi jump-flood pass at offset ``step``.

Replaces the TPU kernel ``aosx/gvd/jfa_pass_pallas.py::jfa_pass``. The CUDA
C++ source is ``aosx_torch/csrc/jfa_pass.cu`` (design and bounds in its
header note); ``jfa_pass_plain`` is the same pass in plain PyTorch: shifted
pass-start planes folded by ``voronoi.jacobi_fold``.

``jfa_pass`` takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Unlike the TPU kernel it has no
step limit: every pass of the flood, 1 to 1024, runs through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from . import voronoi as _voronoi
from ..perceive.raster import iota2, shift2d

FAR = 1e9


def cell_coords(shape, origin_x, origin_y, res: float, device):
    """(cellx, celly) f32 planes: origin + f32(index) * res."""
    iy, ix = iota2(shape, device)
    resf = torch.tensor(res, dtype=torch.float32, device=device)
    return (origin_x + ix.to(torch.float32) * resf,
            origin_y + iy.to(torch.float32) * resf)


def jfa_pass_plain(owner, ox, oy, step: int, S: int, origin_x, origin_y, res: float):
    """One Jacobi pass in plain PyTorch. Returns (owner, ox, oy)."""
    cellx, celly = cell_coords(owner.shape, origin_x, origin_y, res, owner.device)
    neighbors = [
        (shift2d(owner, dys * step, dxs * step, S),
         shift2d(ox, dys * step, dxs * step, FAR),
         shift2d(oy, dys * step, dxs * step, FAR))
        for dys in (-1, 0, 1)
        for dxs in (-1, 0, 1)
        if not (dys == 0 and dxs == 0)
    ]
    return _voronoi.jacobi_fold(owner, ox, oy, neighbors, S, cellx, celly)


_vp = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    fn = cuda_build.load("jfa_pass").jfa_pass
    fn.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, _vp]
    fn.restype = ctypes.c_int
    return fn


def jfa_pass(owner, ox, oy, step: int, S: int, origin_x, origin_y, res: float):
    """One 8-direction Jacobi pass over the full [H, W] carried planes
    (owner i32 with S = none, ox/oy f32). CPU tensors take the plain
    version; CUDA tensors launch kernel K1 (counted in
    ``jfa_pass.launches``)."""
    if owner.device.type == "cpu":
        return jfa_pass_plain(owner, ox, oy, step, S, origin_x, origin_y, res)
    if owner.device.type != "cuda":
        raise ValueError(f"jfa_pass: unsupported device {owner.device}")
    if owner.dtype != torch.int32 or ox.dtype != torch.float32 or oy.dtype != torch.float32:
        raise ValueError("jfa_pass: owner must be int32, ox/oy float32")
    if owner.dim() != 2 or ox.shape != owner.shape or oy.shape != owner.shape:
        raise ValueError("jfa_pass: owner, ox, oy must share one 2-D shape")
    if not (owner.is_contiguous() and ox.is_contiguous() and oy.is_contiguous()):
        raise ValueError("jfa_pass: planes must be contiguous")
    if ox.device != owner.device or oy.device != owner.device:
        raise ValueError("jfa_pass: planes must share one device")
    H, W = owner.shape
    origin = torch.stack([torch.as_tensor(origin_x, device=owner.device),
                          torch.as_tensor(origin_y, device=owner.device)]).to(torch.float32)
    o1 = torch.empty_like(owner)
    x1 = torch.empty_like(ox)
    y1 = torch.empty_like(oy)
    stream = torch.cuda.current_stream(owner.device).cuda_stream
    rc = _lib()(owner.data_ptr(), ox.data_ptr(), oy.data_ptr(), o1.data_ptr(),
                x1.data_ptr(), y1.data_ptr(), origin.data_ptr(), H, W, int(step),
                int(S), float(res), stream)
    cuda_build.check(rc, "jfa_pass")
    jfa_pass.launches += 1
    return o1, x1, y1


jfa_pass.launches = 0
