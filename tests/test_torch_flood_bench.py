"""K1's roundings held to the JAX package's lowerings of the flood.

At BENCH_STATICS ``aosx``'s ``jump_flood`` runs every pass of step <= 128
through the banded Pallas kernel (``aosx/gvd/jfa_pass_pallas.py``); its
tests run that kernel on the CPU in interpret mode, and so did the JAX side
of these, which ``tests/torch_reference/make_flood_bench_reference.py`` now
runs once into ``flood_bench_ref.npz`` (the JAX package unchanged; the port
side runs live). XLA:CPU builds a pass's owner, x and y planes in fusions of
their own, each a whole fold that contracts the squared distances into fused
multiply-adds its own way, a direction at a time, and differently where the
pass's position planes are dropped (a flood's last pass inside a jit). The
port carries the three planes and rounds each as
``aosx_torch.gvd.voronoi.ROUNDINGS`` names it; these tests hold it to the JAX
planes bitwise:

- the whole flood of the committed bench inputs
  (``tests/torch_reference/bench_np_seed0_flood_in.npz``: the BENCH skeleton,
  4,096 merged seeds, origin (3.5, 3.5), res 0.1), JAX's ``jump_flood``
  jitted as the references jit it, in every cell. After the step-4 pass the
  cell PHANTOM_CELL holds owner 2388 with seed 2209's y in JAX's planes and
  in the port's (its y plane's fold took 2209 where the owner plane's took
  2388), and that position wins the cells PHANTOM for 2388;
- every Pallas pass from JAX's own state before it: the owner plane and the
  port's own x and y planes bitwise JAX's;
- a DRYRUN-size grid at BENCH's origin and resolution, two bands, with
  seeds in mirrored pairs whose ties the roundings decide;
- DRYRUN-size floods of seed pairs with swapped offsets from a cell, whose
  45-degree bisector is a line of exact ties that only the forms decide, in
  the dynamic-shift, the Pallas and the sharded lowering.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from aosx_torch.config import BENCH_STATICS, DRYRUN_STATICS
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.types import GridWorld, SeedSet
from torch_helpers import one_torch_thread  # noqa: F401

REF_DIR = pathlib.Path(__file__).parent / "torch_reference"
sys.path.insert(0, str(REF_DIR))
from flood_planes import unpack  # noqa: E402

FLOOD_IN = REF_DIR / "bench_np_seed0_flood_in.npz"
REFERENCE = REF_DIR / "flood_bench_ref.npz"
# after the step-4 pass the cell PHANTOM_CELL holds owner 2388 but seed 2209's
# y, and that phantom position wins the cells PHANTOM for 2388 in the last two
# passes, each farther (f64) from 2388's seed than from 2209's
PHANTOM = {(r, c) for r in (1077, 1078, 1079) for c in (1244, 1245, 1246)}
PHANTOM_CELL, PHANTOM_PASS, PHANTOM_OWNER, PHANTOM_Y_SEED = (1080, 1243), 9, 2388, 2209
# make_flood_bench_reference.py's DRYRUN-size planes: (origin, resolution)
MIRRORED = (3.5, 0.1)
DIAGONAL = (2.0, 0.125)


@pytest.fixture(scope="module")
def stored():
    return dict(np.load(REFERENCE))


def _port_inputs(inp):
    h, w = (torch.tensor(int(v), dtype=torch.int32) for v in inp["cells"])
    grid = GridWorld(torch.from_numpy(inp["occ"]), torch.tensor(inp["origin"][0]),
                     torch.tensor(inp["origin"][1]), h, w)
    xy = torch.from_numpy(inp["seeds_xy"])
    return grid, SeedSet(xy, torch.from_numpy(inp["seeds_valid"]),
                         torch.zeros(len(xy), dtype=torch.int8))


@pytest.fixture(scope="module")
def bench(stored):
    """The bench inputs, JAX's jitted Pallas flood of them, JAX's state
    before every pass and after the last (a jit a pass), and the last pass's
    owner plane as the whole jit builds it (its owner plane alone), from
    flood_bench_ref.npz."""
    inp = dict(np.load(FLOOD_IN))
    xy = inp["seeds_xy"]
    shape = inp["occ"].shape
    return dict(inp=inp, whole=unpack("bench/whole/", stored, xy, shape)[0],
                states=unpack("bench/states/", stored, xy, shape),
                last_owner=unpack("bench/last_owner/", stored, xy, shape)[0], S=len(xy))


def test_bench_flood_matches_pallas_lowering(bench):
    """The port's jump_flood of the bench inputs under BENCH_STATICS (its
    plain K1 on the CPU, in pass_roundings' keys) == JAX's jitted jump_flood
    with the Pallas pass in interpret mode, in every cell. The step-4 pass
    from JAX's state before it gives JAX's state after it, which holds at
    PHANTOM_CELL the owner 2388 with seed 2209's y (the y plane's fold took
    2209 where the owner plane's took 2388); the PHANTOM cells, which that
    position wins for 2388, lie farther (f64) from 2388's seed than from
    2209's."""
    inp = bench["inp"]
    grid, seeds = _port_inputs(inp)
    want = bench["whole"]
    jo, jx, jy = bench["states"][PHANTOM_PASS + 1]
    xy = inp["seeds_xy"]
    assert jo[PHANTOM_CELL] == PHANTOM_OWNER
    assert jx[PHANTOM_CELL] == xy[PHANTOM_OWNER, 0] and jy[PHANTOM_CELL] == xy[PHANTOM_Y_SEED, 1]
    steps = voronoi._passes(BENCH_STATICS)
    rounding = voronoi.pass_roundings(BENCH_STATICS, steps)
    args = (bench["S"], grid.origin_x, grid.origin_y, BENCH_STATICS.resolution)
    before = tuple(torch.from_numpy(np.array(a)) for a in bench["states"][PHANTOM_PASS])
    carried = jfa_pass_cuda.jfa_pass_plain(*before, steps[PHANTOM_PASS], *args,
                                           rounding[PHANTOM_PASS])
    for a, b in zip(carried, (jo, jx, jy)):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(voronoi.jump_flood(grid, seeds, BENCH_STATICS).numpy(), want)
    org, res = inp["origin"].astype(np.float64), float(np.float32(BENCH_STATICS.resolution))
    for c in PHANTOM:
        corner = org + np.array([c[1], c[0]]) * res
        d_own, d_y = (float(((xy[k].astype(np.float64) - corner) ** 2).sum())
                      for k in (PHANTOM_OWNER, PHANTOM_Y_SEED))
        assert want[c] == PHANTOM_OWNER and d_own > d_y


PALLAS_PASSES = [m for m, k in enumerate(voronoi._passes(BENCH_STATICS))
                 if k <= voronoi.PALLAS_MAX_STEP]


@pytest.mark.parametrize("m", PALLAS_PASSES + ["last"])
def test_bench_pass_matches_pallas_pass(bench, m):
    """Pass m of the bench flood from JAX's state before it: jfa_pass_plain
    in the "pallas" rounding == JAX's jitted jfa_pass (interpret mode) in the
    owner plane and in the carried x and y planes, bitwise: XLA:CPU builds
    the three planes in fusions rounded apart (the x plane's every d2
    fma(dy, dy, dx * dx), the y plane's fma(dx, dx, dy * dy)), so a cell's
    position can leave its owner's seed, and the port folds them so too.
    "last": the flood's last pass with its owner plane alone returned, as
    inside the whole jit, == the "pallas_last" rounding."""
    steps = voronoi._passes(BENCH_STATICS)
    S, inp = bench["S"], bench["inp"]
    org = (float(inp["origin"][0]), float(inp["origin"][1]), BENCH_STATICS.resolution)
    k = len(steps) - 1 if m == "last" else m
    before = tuple(torch.from_numpy(np.array(a)) for a in bench["states"][k])
    if m == "last":
        got = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "pallas_last")
        assert np.array_equal(got[0].numpy(), bench["last_owner"])
        return
    want = bench["states"][k + 1]
    got = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "pallas")
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


def test_pallas_rounding_decides_mirrored_ties(stored):
    """DRYRUN_STATICS' grid (192 x 256, two bands of 96 rows for the Pallas
    kernel's small steps) at BENCH's origin 3.5 and resolution 0.1 with the
    Pallas lowering on: the port's jump_flood == JAX's jitted jump_flood
    (interpret mode) bitwise on 64 mirrored seed pairs; from JAX's state
    before each pass (a jit a pass), the port's pass in the flood's own
    rounding (on this 256-wide grid "pallas_narrow": voronoi.SPLIT_X) gives
    JAX's owner, x and y planes bitwise; and every pass in the "xla"
    rounding (the XLA lowering's folds) leaves cells where the pairs' exact
    ties go the other way."""
    s = dataclasses.replace(DRYRUN_STATICS, resolution=MIRRORED[1], jfa_pass_pallas=True,
                            jfa_dynamic_shifts=False)
    org = MIRRORED[0]
    H, W, S = s.grid_h, s.grid_w, s.max_seeds
    xy = stored["mirrored/xy"]
    want = unpack("mirrored/want/", stored, xy, (H, W))[0]
    states = unpack("mirrored/states/", stored, xy, (H, W))
    valid = np.ones(S, bool)
    grid, seeds = _grid_seeds(xy, valid, H, W, org)
    assert np.array_equal(voronoi.jump_flood(grid, seeds, s).numpy(), want)
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    steps = voronoi._passes(s)
    rounding = voronoi.pass_roundings(s, steps)
    for m, step in enumerate(steps):
        before = tuple(torch.from_numpy(np.array(a)) for a in states[m])
        r = "pallas_narrow" if rounding[m] == "pallas_last_narrow" else rounding[m]
        got = jfa_pass_cuda.jfa_pass_plain(*before, step, S, org, org, s.resolution, r)
        for a, b in zip(got, states[m + 1]):
            assert np.array_equal(a.numpy(), b)
    xla = jfa_pass_cuda.jfa_flood(owner0, table, steps, S, org, org, s.resolution)
    assert int((torch.where(xla < S, xla, -1) != torch.from_numpy(want)).sum()) > 0


def _grid_seeds(xy, valid, H, W, origin):
    """The port's GridWorld (empty, all live) and SeedSet for seeds xy."""
    i32 = dict(dtype=torch.int32)
    grid = GridWorld(torch.zeros((H, W), dtype=torch.uint8), torch.tensor(origin),
                     torch.tensor(origin), torch.tensor(H, **i32), torch.tensor(W, **i32))
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(valid),
                    torch.zeros(len(xy), dtype=torch.int8))
    return grid, seeds


DIAGONAL_LOWERINGS = ("dynamic", "pallas", "sharded")


@pytest.mark.parametrize("lowering", DIAGONAL_LOWERINGS)
def test_lowering_forms_decide_diagonal_ties(stored, lowering):
    """DRYRUN_STATICS' grid at origin 2.0 and resolution 0.125 (cell corners
    exact in f32) with 64 swapped seed pairs: the port's flood == JAX's
    jitted flood in the lowering (flood_bench_ref.npz), bitwise (the dynamic
    shifts: "xla" throughout; the Pallas kernel in interpret mode: "pallas",
    its last pass "pallas_last", on this 256-wide grid their "_narrow" keys;
    jump_flood_sharded over 4 CPU devices: "xla", its last pass
    "sharded_last"), while a flood that folds x and y as its owner
    plane (every position its owner's seed) differs in many cells."""
    from aosx_torch.parallel.spatial import Mesh, jump_flood_sharded

    org, res = DIAGONAL
    flags = dict(resolution=res, jfa_pass_pallas=lowering == "pallas",
                 jfa_dynamic_shifts=lowering == "dynamic")
    s = dataclasses.replace(DRYRUN_STATICS, **flags)
    H, W, S = s.grid_h, s.grid_w, s.max_seeds
    xy = stored["diagonal/xy"]
    want = unpack(f"diagonal/{lowering}/", stored, xy, (H, W))[0]
    valid = np.ones(S, bool)
    grid, seeds = _grid_seeds(xy, valid, H, W, org)
    if lowering == "sharded":
        got = jump_flood_sharded(grid, seeds, s, Mesh((torch.device("cpu"),) * 4, ("space",)))
    else:
        got = voronoi.jump_flood(grid, seeds, s)
    assert np.array_equal(got.numpy(), want)
    # the planes folded as the owner plane: every cell's position its owner's
    owner_only = {k: (v[0],) * 3 for k, v in voronoi.ROUNDINGS.items()
                  if k not in voronoi.CHAINS}
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    steps = voronoi._passes(s)
    rounding = voronoi.pass_roundings(s, steps)
    if lowering == "sharded":
        rounding = ["xla"] * (len(steps) - 1) + ["sharded_last"]
    saved = dict(voronoi.ROUNDINGS)
    try:
        voronoi.ROUNDINGS.update(owner_only)
        old = jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, S, org, org, res, rounding)[0]
    finally:
        voronoi.ROUNDINGS.update(saved)
    assert int((torch.where(old < S, old, -1).numpy() != want).sum()) > 50
