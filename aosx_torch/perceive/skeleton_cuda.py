"""Kernel K2: Zhang-Suen thinning to the fixpoint in one call.

Replaces the TPU kernel ``aosx/perceive/skeleton_pallas.py::zhang_suen_pallas``.
The CUDA C++ source is ``aosx_torch/csrc/zhang_suen.cu`` (design and bounds in
its header note): one cooperative launch keeps the plane bit-packed, 32 cells
of a row to a word, in shared memory for every iteration, and stops on the
device when an iteration changes nothing.

Plain PyTorch versions beside it: ``zhang_suen_iteration_plain`` mirrors
``aosx.perceive.skeleton._subiter`` on the byte plane,
``zhang_suen_fixpoint_plain`` loops it with the stopping rule of
``aosx.perceive.skeleton.zhang_suen``, and ``pack_rows`` / ``unpack_rows`` /
``_subiter_bits_plain`` are the kernel's bit-sliced sub-iteration on packed
int32 words, so that its boolean circuit is held against the byte stencil
without a card.

World axis: ``zhang_suen_fixpoint``, ``zhang_suen_fixpoint_plain`` and
``zhang_suen_iteration_plain`` take planes [*B, H, W] with live bounds of
shape B, as ``jax.vmap`` maps the TPU kernel's loop: each world stops at its
own fixpoint or at ``max_iters``. The kernel thins a whole group in one
launch (a counted launch a chunk of worlds where the group exceeds the
card's co-resident blocks); [H, W] is the same call with one world.

``zhang_suen_fixpoint`` and ``zhang_suen_iteration`` take the plain version
only for a tensor on the CPU. For a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import cuda_build
from .raster import to_plane, iota2, shift2d

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


def _interior(occ, h_cells, w_cells):
    iy, ix = iota2(occ.shape[-2:], occ.device)
    return (iy >= 1) & (iy < to_plane(h_cells) - 1) & (ix >= 1) & (ix < to_plane(w_cells) - 1)


def zhang_suen_iteration_plain(occ, h_cells, w_cells):
    """Both sub-iterations in plain PyTorch. Returns (occ u8 [*B, H, W],
    changed-cell count i32 [*B])."""
    interior = _interior(occ, h_cells, w_cells)
    q = _subiter(occ, 0, interior)
    q = _subiter(q, 1, interior)
    return q, (q != occ).sum(dim=(-2, -1), dtype=torch.int32)


def zhang_suen_fixpoint_plain(occ, h_cells, w_cells, max_iters: int):
    """Iterations until one changes nothing, at most ``max_iters``
    (``aosx.perceive.skeleton.zhang_suen``'s loop). Returns (occ u8
    [*B, H, W], iterations run, changed-cell count of the last iteration);
    the iteration that finds the fixpoint counts. With world axes B each
    world stops on its own (the counts are then i32 tensors of shape B; for
    one plane, Python ints)."""
    B = occ.shape[:-2]
    dev = occ.device
    its = torch.zeros(B, dtype=torch.int32, device=dev)
    last = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for k in range(max_iters):
        if not bool(active.any()):
            break
        q, n = zhang_suen_iteration_plain(occ, h_cells, w_cells)
        occ = torch.where(to_plane(active), q, occ)
        its = torch.where(active, k + 1, its).to(torch.int32)
        last = torch.where(active, n, last)
        active = active & (n != 0)
    if not B:
        return occ, int(its), int(last)
    return occ, its, last


# ---------------------------------------------------------------------------
# the kernel's sub-iteration in plain PyTorch: bit-sliced, on packed words
# ---------------------------------------------------------------------------


def pack_rows(occ):
    """u8 {0,1} [H, W] -> int32 [H, ceil(W / 32)]: bit b of word j of a row is
    cell x = 32 j + b; bits past W are 0."""
    H, W = occ.shape
    wd = -(-W // 32)
    bits = torch.zeros((H, wd * 32), dtype=torch.int64, device=occ.device)
    bits[:, :W] = occ
    bits = bits.reshape(H, wd, 32)
    weights = 1 << torch.arange(31, dtype=torch.int64, device=occ.device)
    low = (bits[..., :31] * weights).sum(-1)
    return (low - (bits[..., 31] << 31)).to(torch.int32)


def unpack_rows(words, W: int):
    """int32 [H, Wd] -> u8 {0,1} [H, W] (``pack_rows``'s inverse)."""
    H = words.shape[0]
    b = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> b) & 1
    return bits.reshape(H, -1)[:, :W].to(torch.uint8)


def _east(row):
    """Per bit, the cell at x + 1: the word shifted down by one bit, bit 31
    from bit 0 of the next word of the row (0 past the row's end)."""
    nxt = shift2d(row, 0, -1)
    return ((row >> 1) & 0x7FFFFFFF) | (nxt << 31)


def _west(row):
    """Per bit, the cell at x - 1: the word shifted up by one bit, bit 0 from
    bit 31 of the word before (0 before the row's start)."""
    prv = shift2d(row, 0, 1)
    return (row << 1) | ((prv >> 31) & 1)


def _full_add(a, b, c):
    ab = a ^ b
    return ab ^ c, (a & b) | (c & ab)


def _subiter_bits_plain(words, phase: int, interior):
    """One sub-iteration on packed int32 words [H, Wd], 32 cells a step, as
    kernel K2 computes it. ``interior`` is the packed interior mask."""
    up, dn = shift2d(words, 1, 0), shift2d(words, -1, 0)
    p2, p3, p4, p5 = up, _east(up), _east(words), _east(dn)
    p6, p7, p8, p9 = dn, _west(dn), _west(words), _west(up)
    # B = p2 + ... + p9 as four bit planes b3 b2 b1 b0
    s1, c1 = _full_add(p2, p3, p4)
    s2, c2 = _full_add(p5, p6, p7)
    s3, c3 = p8 ^ p9, p8 & p9
    b0, c4 = _full_add(s1, s2, s3)
    s5, c5 = _full_add(c1, c2, c3)
    b1, c6 = s5 ^ c4, s5 & c4
    b2, b3 = c5 ^ c6, c5 & c6
    b_ok = (b1 | b2) & ~b3 & ~(b2 & b1 & b0)
    # A == 1: exactly one 0 -> 1 step around the ring p2, p3, ..., p9, p2
    one = torch.zeros_like(words)
    two = torch.zeros_like(words)
    ring = (p2, p3, p4, p5, p6, p7, p8, p9, p2)
    for a, b in zip(ring[:-1], ring[1:]):
        t = ~a & b
        two = two | (one & t)
        one = one | t
    if phase == 0:
        m = ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
    else:
        m = ~(p2 & p4 & p8) & ~(p2 & p6 & p8)
    delete = words & interior & b_ok & one & ~two & m
    return words & ~delete


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_vp = ctypes.c_void_p
_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    fn = cuda_build.load("zhang_suen").zhang_suen_fixpoint
    fn.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                   ctypes.POINTER(_int), _vp]
    fn.restype = _int
    return fn


def _world_values(v, B, G: int, dev):
    """A per-world int32 value (0-d, or of shape B) as a contiguous [G]
    device tensor: a view, not a copy, where it is one already."""
    return torch.as_tensor(v).to(device=dev, dtype=torch.int32).expand(B).contiguous().reshape(G)


def zhang_suen_fixpoint(occ, h_cells, w_cells, max_iters: int):
    """Thin ``occ`` (u8 [*B, H, W] holding only 0 and 1: ``morph_open``'s
    output; the precondition is not checked here, a check would be a host
    read) until an iteration changes nothing, at most ``max_iters``
    iterations, each world of the leading axes B on its own (its live
    bounds 0-d or of shape B). Returns (occ u8 [*B, H, W], stats i32
    [*B, 2] = iterations run and the last iteration's changed-cell count, per
    world). CPU tensors take the plain version; CUDA tensors launch kernel
    K2 once for the group, or once a chunk of worlds where the group
    exceeds the card's co-resident blocks, with no host read (counted in
    ``zhang_suen_fixpoint.launches``): the bounds are read on the device."""
    B = occ.shape[:-2]
    if occ.device.type == "cpu":
        out, it, changed = zhang_suen_fixpoint_plain(occ, h_cells, w_cells, max_iters)
        if not B:
            return out, torch.tensor([it, changed], dtype=torch.int32)
        return out, torch.stack([it, changed], dim=-1)
    if occ.device.type != "cuda":
        raise ValueError(f"zhang_suen_fixpoint: unsupported device {occ.device}")
    if occ.dtype != torch.uint8 or occ.dim() < 2 or not occ.is_contiguous():
        raise ValueError("zhang_suen_fixpoint: occ must be a contiguous [*B, H, W] uint8 tensor")
    if not 0 <= max_iters <= 4096:
        raise ValueError(f"zhang_suen_fixpoint: max_iters {max_iters} outside 0..4096")
    H, W = occ.shape[-2:]
    G = math.prod(B)
    dev = occ.device
    hc = _world_values(h_cells, B, G, dev)
    wc = _world_values(w_cells, B, G, dev)
    out = torch.empty_like(occ)
    stats = torch.empty(B + (2,), dtype=torch.int32, device=dev)
    if G == 0:
        return out, stats
    # per-world and per-iteration changed counts, the group's per-iteration
    # totals, then the edge rows the bands exchange: (even, odd iteration) x
    # blocks (at most one an SM) x (first two, last two rows) x words of a row
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(min(G, sms) * max_iters + max_iters + 8 * sms * -(-W // 32),
                          dtype=torch.int32, device=dev)
    launches = _int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(occ.data_ptr(), out.data_ptr(), hc.data_ptr(), wc.data_ptr(),
                    stats.data_ptr(), scratch.data_ptr(), G, H, W, max_iters,
                    ctypes.byref(launches), stream)
    zhang_suen_fixpoint.launches += launches.value
    cuda_build.check(rc, "zhang_suen_fixpoint")
    return out, stats


zhang_suen_fixpoint.launches = 0


def zhang_suen_iteration(occ, h_cells, w_cells):
    """One thinning iteration: the fixpoint kernel capped at one. Returns
    (occ u8 [*B, H, W], changed-cell count i32 of shape B)."""
    out, stats = zhang_suen_fixpoint(occ, h_cells, w_cells, 1)
    return out, stats[..., 1]
