"""Kernel K3: all-pairs ROR neighbour counts, self included.

Replaces the TPU kernel ``aosx/perceive/ror_pallas.py::ror_counts_pallas``.
The CUDA C++ source is ``aosx_torch/csrc/ror_counts.cu`` (design and bound in
its header note); ``ror_counts_plain`` is the same computation in plain
PyTorch: d2 = (|a|^2 + |b|^2) - 2 (a.b), with the K=3 dot and the squared
norms written out as the chains of fused multiply-adds that XLA:CPU runs for
the JAX package's kernel (interpret mode) and its 'mxu' path,

    |a|^2 = fma(z, z, fma(y, y, x*x)),   a.b = fma(z, z', fma(y, y', x*x')),

each rounded once (``ops.fma``; ``__fmaf_rn`` in the kernel), so that kernel
and plain version agree bitwise and both reproduce the reference's counts.
At orchard coordinates the formula cancels: |a|^2 ~ 3.6e4 at 190 m, whose
f32 ulp (0.004) is a tenth of r^2 = 0.04, so rounding each operation
separately instead moves thousands of counts. (A matrix product over K=3
would leave the order, and on the card TF32, to a library.)

Both take a leading world axis: [G, N, 3] points with r2 0-d or [G] count
each world's points against its own (``jax.vmap`` of the TPU kernel, which
gains a grid dimension); [N, 3] is the same call with G = 1. The kernel runs
a group in one launch, the world a grid dimension.

``ror_counts`` takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import cuda_build
from ..ops import chunk_rows, fma

# rows of the [rows, N] d2 tile the plain version evaluates at once; it never
# materialises the N x N plane (68.7 GB in f32 at N = 131,072)
_ROW_CHUNK = 1024


def _dot3(a, b):
    """fma(az, bz, fma(ay, by, ax*bx)) over the last axis (broadcasting)."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def ror_counts_plain(xyz_padded, r2):
    """Counts of points within sqrt(r2), self included, for an [*B, N, 3]
    f32 buffer (invalid points parked far away), per world of the leading
    axes B (r2 0-d or of shape B). Returns [*B, N] i32."""
    B = xyz_padded.shape[:-2]
    n = xyz_padded.shape[-2]
    dev = xyz_padded.device
    pts = xyz_padded.to(torch.float32)
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=dev)
    r2 = r2.reshape(r2.shape + (1, 1))
    sq = _dot3(pts, pts)
    cnt = torch.empty(B + (n,), dtype=torch.int32, device=dev)
    rc = chunk_rows(_ROW_CHUNK, math.prod(B))
    for r0 in range(0, n, rc):
        dot = _dot3(pts[..., r0:r0 + rc, None, :], pts[..., None, :, :])
        d2 = (sq[..., r0:r0 + rc, None] + sq[..., None, :]) - 2.0 * dot
        cnt[..., r0:r0 + rc] = (d2 <= r2).sum(dim=-1, dtype=torch.int32)
    return cnt


_vp = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    fn = cuda_build.load("ror_counts").ror_counts
    fn.argtypes = [_vp, _vp, _vp, ctypes.c_int, ctypes.c_int, _vp]
    fn.restype = ctypes.c_int
    return fn


def ror_counts(xyz_padded, r2):
    """All-pairs neighbour counts including self, [*B, N] i32, of an
    [*B, N, 3] f32 point buffer, each world of the leading axes B on its
    own (r2 0-d or of shape B). CPU tensors take the plain version; CUDA
    tensors launch kernel K3 once for the whole group (counted in
    ``ror_counts.launches``)."""
    if xyz_padded.device.type == "cpu":
        return ror_counts_plain(xyz_padded, r2)
    dev = xyz_padded.device
    if dev.type != "cuda":
        raise ValueError(f"ror_counts: unsupported device {dev}")
    if (xyz_padded.dtype != torch.float32 or xyz_padded.dim() < 2
            or xyz_padded.shape[-1] != 3 or not xyz_padded.is_contiguous()):
        raise ValueError("ror_counts: points must be a contiguous [*B, N, 3] float32 tensor")
    B = xyz_padded.shape[:-2]
    G, n = math.prod(B), xyz_padded.shape[-2]
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=dev)
    r2 = r2.expand(B).contiguous().reshape(G)
    out = torch.empty(B + (n,), dtype=torch.int32, device=dev)
    if G == 0 or n == 0:
        return out
    if G > 65535:
        raise ValueError(f"ror_counts: {G} worlds exceed the grid's 65,535")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(xyz_padded.data_ptr(), r2.data_ptr(), out.data_ptr(), n, G, stream)
    cuda_build.check(rc, "ror_counts")
    ror_counts.launches += 1
    return out


ror_counts.launches = 0
