"""Kernel K1: the Jacobi jump flood, every pass of it from one call.

Replaces the TPU kernel ``aosx/gvd/jfa_pass_pallas.py::jfa_pass``. The CUDA
C++ source is ``aosx_torch/csrc/jfa_pass.cu`` (design and bounds in its
header note): it carries the flood's owner, x and y planes as the TPU kernel
does, the owners as u16 words between its first and its closing pass, a
cell's position as the indices of the seeds whose x and y it holds, stored
only where it is not the owner's seed; a thread folds 4 cells of a row.

Plain PyTorch versions beside it: ``jfa_pass_plain`` is one pass over the
three carried planes (the TPU kernel's interface: shifted pass-start planes
folded by ``voronoi.jacobi_fold``), ``jfa_states_plain`` starts the
position planes at ``table[owner]`` and runs the passes over the steps (a
chain's passes carry its triples from one to the next there), and
``jfa_flood_plain`` returns its last state.

World axis: ``jfa_flood`` and the plain versions take owner planes
[*B, H, W], seed tables [*B, S + 1, 2] and origins of shape B, as
``jax.vmap`` maps the TPU kernel; every world runs the same pass list, from
its own origin and table. The kernel floods a whole group in one launch (a
counted launch a chunk of worlds where the group exceeds the card's
co-resident blocks); [H, W] is the same call with one world.

Roundings: ``rounding`` names each pass's forms of the squared distance in
each plane (``voronoi.ROUNDINGS``; ``voronoi.pass_roundings`` gives a
flood's, as ``aosx`` lowers each pass), a chain's passes also the folds of
its two recomputed triples (``voronoi.CHAINS``). The kernel takes them as
six words a pass (``form_codes``), in the same call and launch.

``jfa_flood`` takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Unlike the TPU kernel it has no
step limit: every pass of the flood, 1 to 1024, runs through it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import cuda_build
from . import voronoi as _voronoi
from ..ops import fma, take
from ..perceive.raster import to_plane, iota2, shift2d

FAR = 1e9
MAX_STEPS = 32
# jfa_pass.cu's kMaxSeeds: an owner (a seed index, or S for none) in the 15
# bits of a u16 owner word
MAX_SEEDS = 0x7FFF
# jfa_pass.cu's code of a d2 form (Steps::forms: 2 bits a candidate), of the
# triple a fold starts from (Steps::own: 2 bits a fold) and its chain flag
FORM_CODES = {"x": 0, "y": 1, "u": 2}
OWN_CODES = {"m": 0, "a": 1, "b": 2}
CHAIN_BIT = 1 << 10
# the own word's flag of a pass whose cells' x is rounded twice (voronoi.SPLIT_X)
SPLIT_X_BIT = 1 << 11
# jfa_pass.cu's kChainPlanes: a chain's planes a world
CHAIN_PLANES = 12


@functools.lru_cache(maxsize=None)
def form_codes(rounding: str):
    """The kernel's six words of a ``voronoi.ROUNDINGS`` key: the form words
    of its five folds (owner, x, y planes, a chain's triples a and b;
    candidate m's form in bits 2m, 2m + 1, 0 for a fold the pass does not
    make), then the own word (the triple each fold starts from, 2 bits a
    fold, CHAIN_BIT for a key of ``voronoi.CHAINS`` and SPLIT_X_BIT for one
    of ``voronoi.SPLIT_X``)."""
    def word(forms):
        return sum(FORM_CODES[c] << (2 * m) for m, c in enumerate(forms))

    spec = _voronoi.CHAINS.get(rounding)
    words = tuple(word(f) for f in _voronoi.ROUNDINGS[rounding])
    if spec is None:
        return words + (0, 0, SPLIT_X_BIT if rounding in _voronoi.SPLIT_X else 0)
    own = list(spec["own"]) + [spec["a"][1], spec["b"][1]]
    return words + (word(spec["a"][0]), word(spec["b"][0]),
                    CHAIN_BIT | sum(OWN_CODES[c] << (2 * q) for q, c in enumerate(own)))


def cell_coords(shape, origin_x, origin_y, res: float, device, split_x: bool = False,
                split_y: bool = False):
    """(cellx, celly) f32 planes [*B, H, W] (``shape`` is (H, W), the
    origins 0-d or of shape B): origin + f32(index) * res rounded once, as
    the fused multiply-add XLA:CPU makes of ``aosx/gvd/voronoi.py``'s cell
    coordinates; with ``split_x`` (``split_y``) the x (y) rounded twice, the
    product and then the sum (``voronoi.SPLIT_X``, ``voronoi.CHAINS``)."""
    iy, ix = iota2(shape, device)
    resf = torch.tensor(res, dtype=torch.float32, device=device)
    ox = to_plane(torch.as_tensor(origin_x, dtype=torch.float32, device=device))
    oy = to_plane(torch.as_tensor(origin_y, dtype=torch.float32, device=device))
    cx = ix.to(torch.float32) * resf + ox if split_x else fma(ix.to(torch.float32), resf, ox)
    cy = iy.to(torch.float32) * resf + oy if split_y else fma(iy.to(torch.float32), resf, oy)
    return cx, cy


def _neighbors(planes, shifted, step, S):
    """The 8 neighbour triples in jacobi_fold's order: the two in the cell's
    row (dys = 0) from ``shifted``, the others from ``planes``."""
    out = []
    for dys in (-1, 0, 1):
        for dxs in (-1, 0, 1):
            if dys or dxs:
                o, x, y = shifted if dys == 0 else planes
                out.append((shift2d(o, dys * step, dxs * step, S),
                            shift2d(x, dys * step, dxs * step, FAR),
                            shift2d(y, dys * step, dxs * step, FAR)))
    return out


def jfa_pass_plain(owner, ox, oy, step: int, S: int, origin_x, origin_y, res: float,
                   rounding: str = "xla"):
    """One Jacobi pass in plain PyTorch over planes [*B, H, W], d2 rounded as
    ``voronoi.ROUNDINGS[rounding]``. Returns (owner, ox, oy). A chain's pass
    (a key of ``voronoi.CHAINS``) folds from the chain's recomputed triples
    too, so it runs only inside a flood (``jfa_states_plain``)."""
    if rounding in _voronoi.CHAINS:
        raise ValueError(f"jfa_pass_plain: {rounding} is a chain's pass; run it in a flood "
                         "(jfa_states_plain)")
    cellx, celly = cell_coords(owner.shape[-2:], origin_x, origin_y, res, owner.device,
                               rounding in _voronoi.SPLIT_X)
    nb = _neighbors((owner, ox, oy), (owner, ox, oy), step, S)
    return _voronoi.jacobi_fold(owner, ox, oy, nb, S, cellx, celly, rounding)


def _chain_pass(planes, step: int, S: int, origin_x, origin_y, res: float, rounding: str,
                chain):
    """A chain's pass (a key of ``voronoi.CHAINS``), made in its two versions
    (``voronoi.CHAIN_VERSIONS``): "p", the cells' y rounded once, the
    carried planes, which the next pass reads but for the two neighbours in
    the cell's row, and "s", the y rounded twice, which a next chain pass
    reads for those two. Returns ("p" planes, chain), chain the dict of the
    "s" planes and of both versions' recomputed triples ("ap", "bp", "as",
    "bs"), from ``chain`` the previous chain pass's (None at a chain's
    first pass)."""
    owner, ox, oy = planes
    nb = _neighbors(planes, chain["s"] if chain else planes, step, S)
    out = {}
    for v in _voronoi.CHAIN_VERSIONS:
        cellx, celly = cell_coords(owner.shape[-2:], origin_x, origin_y, res, owner.device,
                                   split_y=v == "s")
        triples = (chain["a" + v], chain["b" + v]) if chain else None
        out[v], out["a" + v], out["b" + v] = _voronoi.jacobi_fold(
            owner, ox, oy, nb, S, cellx, celly, rounding, triples)
    return out.pop("p"), out


def _roundings(steps, rounding):
    """A ``voronoi.ROUNDINGS`` key a step ("xla" for all where None)."""
    names = ["xla"] * len(steps) if rounding is None else list(rounding)
    if len(names) != len(steps) or any(r not in _voronoi.ROUNDINGS for r in names):
        raise ValueError(f"jfa_flood: roundings {names} for {len(steps)} steps; each one of "
                         f"{list(_voronoi.ROUNDINGS)}")
    if names and names[-1] in _voronoi.CHAINS:
        raise ValueError(f"jfa_flood: a chain pass ({names[-1]}) cannot close a flood")
    return names


def jfa_states_plain(owner, table, steps, S: int, origin_x, origin_y, res: float,
                     rounding=None):
    """The passes at ``steps`` in plain PyTorch, from an owner plane (i32
    [*B, H, W], owners in 0..S) and the seed table (f32 [*B, S + 1, 2], row
    S = (1e9, 1e9)), the position planes starting at ``table[owner]``, each
    pass rounded as its key in ``rounding`` (None: all "xla"; a chain's
    triples carried from pass to pass). Yields the carried planes (owner,
    ox, oy) before each pass and after the last."""
    nb = owner.dim() - 2
    pos = take(table, owner.flatten(-2), nb).reshape(owner.shape + (2,))
    state = (owner, pos[..., 0].contiguous(), pos[..., 1].contiguous())
    chain = None
    for step, r in zip(steps, _roundings(steps, rounding)):
        yield state
        if r in _voronoi.CHAINS:
            state, chain = _chain_pass(state, int(step), S, origin_x, origin_y, res, r, chain)
        else:
            state, chain = jfa_pass_plain(*state, int(step), S, origin_x, origin_y, res, r), None
    yield state


def jfa_flood_plain(owner, table, steps, S: int, origin_x, origin_y, res: float, rounding=None):
    """``jfa_states_plain``'s last state: the carried planes (owner, ox, oy)
    after the passes at ``steps``."""
    for state in jfa_states_plain(owner, table, steps, S, origin_x, origin_y, res, rounding):
        pass
    return state


@functools.lru_cache(maxsize=64)
def _codes(names):
    """The kernel's form words of a flood's passes, six a pass."""
    return tuple(c for r in names for c in form_codes(r))


_vp = ctypes.c_void_p
_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("jfa_pass")
    lib.jfa_flood.argtypes = [_vp] * 10 + [ctypes.POINTER(_int)] * 2 + [_int] * 5 + [
        ctypes.c_float, _vp, _vp, ctypes.POINTER(_int), _vp]
    lib.jfa_flood.restype = _int
    lib.jfa_flood_config.argtypes = [_int] + [ctypes.POINTER(_int)] * 5
    lib.jfa_flood_config.restype = _int
    return lib


def launch_config(S: int, device=None):
    """The launch K1 takes on the card for a flood with S seeds: {"threads"
    a block, "blocks_per_sm" co-resident, "registers" and "local_bytes"
    (the stack frame of its out-of-line calls and any spills) a thread,
    "shared_table": the seed table staged in shared memory}."""
    names = ("threads", "blocks_per_sm", "registers", "local_bytes", "shared_table")
    vals = [_int(0) for _ in names]
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = _lib().jfa_flood_config(int(S), *(ctypes.byref(v) for v in vals))
    cuda_build.check(rc, "jfa_flood_config")
    return {k: v.value for k, v in zip(names, vals)}


def jfa_flood(owner, table, steps, S: int, origin_x, origin_y, res: float,
              want_positions: bool = False, rounding=None):
    """The 8-direction Jacobi passes at ``steps`` (a single pass is
    ``steps=[k]``) over the owner planes (i32 [*B, H, W], owners in 0..S
    with S = none, S <= 32767), the position planes starting at the owners'
    seeds in ``table`` (f32 [*B, S + 1, 2], row S = (1e9, 1e9)), each world
    of the leading axes B from its own origin (0-d or of shape B), each pass
    rounded as its ``voronoi.ROUNDINGS`` key in ``rounding`` (None: all
    "xla"). Returns the owner planes, or the carried planes (owner, ox, oy)
    with ``want_positions`` (the last pass then carries its x and y planes
    too).

    CPU tensors take the plain version. CUDA tensors launch kernel K1: one
    call into the library and one cooperative launch for the whole flood of
    the whole group (a launch a chunk of worlds where the group exceeds the
    card's co-resident blocks), with no host read (``jfa_flood.launches``
    counts the launches, ``jfa_flood.passes`` the passes they ran). The
    kernel reads ``owner`` (16-byte aligned) in its first pass and writes
    the result to a new plane; ``owner`` is not modified."""
    steps = [int(k) for k in steps]
    names = _roundings(steps, rounding)
    if owner.device.type == "cpu":
        out = jfa_flood_plain(owner, table, steps, S, origin_x, origin_y, res, names)
        return out if want_positions else out[0]
    dev = owner.device
    if dev.type != "cuda":
        raise ValueError(f"jfa_flood: unsupported device {dev}")
    if owner.dtype != torch.int32 or owner.dim() < 2 or not owner.is_contiguous():
        raise ValueError("jfa_flood: owner must be a contiguous [*B, H, W] int32 tensor")
    B = owner.shape[:-2]
    if (table.dtype != torch.float32 or tuple(table.shape) != B + (S + 1, 2)
            or not table.is_contiguous() or table.device != dev):
        raise ValueError(f"jfa_flood: table must be a contiguous float32 {list(B)} + "
                         f"[{S + 1}, 2] tensor on the owner plane's device")
    H, W = owner.shape[-2:]
    G = math.prod(B)
    if W % 4 != 0:
        raise ValueError(f"jfa_flood: the plane's width {W} must be a multiple of 4")
    if H * W >= 2 ** 31:
        raise ValueError(f"jfa_flood: a plane of {H} x {W} cells; the kernel indexes in 32 bits")
    if owner.data_ptr() % 16:
        raise ValueError("jfa_flood: the owner plane must be 16-byte aligned")
    if not 0 <= S <= MAX_SEEDS:
        raise ValueError(f"jfa_flood: {S} seeds; an owner word holds owners up to {MAX_SEEDS}")
    if not 1 <= len(steps) <= MAX_STEPS or any(k < 1 for k in steps):
        raise ValueError(f"jfa_flood: 1 to {MAX_STEPS} steps, each >= 1: {steps}")

    def per_world(v):
        v = torch.as_tensor(v).to(device=dev, dtype=torch.float32)
        return v.expand(B).contiguous().reshape(G)

    gx, gy = per_world(origin_x), per_world(origin_y)
    out = torch.empty_like(owner)
    # the owner words' (u16) and the position words' ping-pong pairs (a flood
    # of one pass needs none)
    words = pos = [None, None]
    if len(steps) > 1:
        words = list(torch.empty((2,) + tuple(owner.shape), dtype=torch.int16, device=dev))
        pos = [torch.empty_like(owner) for _ in range(2)]
    # a chain's planes: the triples a and b of its two versions and the "s"
    # version's owner and position ping-pong pairs (jfa_pass.cu's chain)
    chain = (torch.empty(B + (CHAIN_PLANES, H, W), dtype=torch.int32, device=dev)
             if any(r in _voronoi.CHAINS for r in names) else None)
    ox = oy = None
    if want_positions:
        ox = torch.empty(owner.shape, dtype=torch.float32, device=dev)
        oy = torch.empty_like(ox)
    launches = _int(0)
    if G > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            forms = _codes(tuple(names))
            rc = _lib().jfa_flood(owner.data_ptr(), out.data_ptr(),
                                  *(p.data_ptr() if p is not None else None
                                    for p in words + pos),
                                  chain.data_ptr() if chain is not None else None,
                                  table.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                                  (_int * len(steps))(*steps), (_int * len(forms))(*forms),
                                  len(steps), G, H, W, int(S),
                                  float(res), ox.data_ptr() if want_positions else None,
                                  oy.data_ptr() if want_positions else None,
                                  ctypes.byref(launches), stream)
        jfa_flood.launches += launches.value
        jfa_flood.passes += launches.value * len(steps)
        cuda_build.check(rc, "jfa_flood")
    return (out, ox, oy) if want_positions else out


jfa_flood.launches = 0
jfa_flood.passes = 0
