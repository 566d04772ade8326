"""K1's roundings held to the JAX package's Pallas lowering of the flood.

At BENCH_STATICS ``aosx``'s ``jump_flood`` runs every pass of step <= 128
through the banded Pallas kernel (``aosx/gvd/jfa_pass_pallas.py``); its
tests run that kernel on the CPU in interpret mode, and so do these. XLA:CPU
contracts the kernel's squared distances into fused multiply-adds a
direction at a time, and differently where the pass's position planes are
dropped (a flood's last pass inside a jit). The port rounds each pass as
``aosx_torch.gvd.voronoi.ROUNDINGS`` names it; these tests hold it to the
JAX planes bitwise:

- the whole flood of the committed bench inputs
  (``tests/torch_reference/bench_np_seed0_flood_in.npz``: the BENCH skeleton,
  4,096 merged seeds, origin (3.5, 3.5), res 0.1), JAX's ``jump_flood``
  jitted as the references jit it. 9 cells differ, all named below: the
  reference's x and y planes are selected by folds rounded apart from its
  owner plane's, which the port does not mirror (a cell's position stays
  its owner's seed);
- every Pallas pass from JAX's own state before it: the owner plane
  bitwise, and the x and y planes bitwise to folds in the roundings that
  XLA:CPU gives them, which proves every cell where they leave the owner's
  seed;
- a DRYRUN-size grid at BENCH's origin and resolution, two bands, with
  seeds in mirrored pairs whose ties the roundings decide.
"""

from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import BENCH_STATICS as JBENCH, DRYRUN_STATICS as JDRY
from aosx.gvd import jfa_pass_pallas as jpp
from aosx.gvd import voronoi as jvoronoi
from aosx.perceive.raster import shift2d as jshift2d
from aosx.types import GridWorld as JGrid, SeedSet as JSeeds

from aosx_torch.config import BENCH_STATICS, DRYRUN_STATICS
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.types import GridWorld, SeedSet

FLOOD_IN = pathlib.Path(__file__).parent / "torch_reference" / "bench_np_seed0_flood_in.npz"
# the bench cells where the port's owner differs from JAX's Pallas flood:
# after the step-4 pass JAX's cell (1080, 1243) holds owner 2388 but seed
# 2209's y, and that phantom position wins these cells for 2388 in the last
# two passes (chip_smoke.py's NAMED_OWNER_CELLS)
PHANTOM = {(r, c) for r in (1077, 1078, 1079) for c in (1244, 1245, 1246)}
PHANTOM_CELL, PHANTOM_PASS, PHANTOM_OWNER, PHANTOM_Y_SEED = (1080, 1243), 9, 2388, 2209


def _jax_inputs(inp):
    grid = JGrid(jnp.asarray(inp["occ"]), jnp.float32(inp["origin"][0]),
                 jnp.float32(inp["origin"][1]), jnp.int32(inp["cells"][0]),
                 jnp.int32(inp["cells"][1]))
    S = len(inp["seeds_xy"])
    return grid, JSeeds(jnp.asarray(inp["seeds_xy"]), jnp.asarray(inp["seeds_valid"]),
                        jnp.zeros((S,), jnp.int8))


def _port_inputs(inp):
    h, w = (torch.tensor(int(v), dtype=torch.int32) for v in inp["cells"])
    grid = GridWorld(torch.from_numpy(inp["occ"]), torch.tensor(inp["origin"][0]),
                     torch.tensor(inp["origin"][1]), h, w)
    xy = torch.from_numpy(inp["seeds_xy"])
    return grid, SeedSet(xy, torch.from_numpy(inp["seeds_valid"]),
                         torch.zeros(len(xy), dtype=torch.int8))


def _static_pass(grid, state, step, S, s):
    """One pass of aosx's static-shift XLA lowering (jump_flood's jacobi_pass
    with shift_fill_s), as one jit."""
    h, w = grid.occ.shape

    def fill(a, dy, dx):
        pads = ((max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0)))
        return jnp.pad(a, pads, constant_values=S)[max(-dy, 0):max(-dy, 0) + h,
                                                   max(-dx, 0):max(-dx, 0) + w]

    def one(g, o0, x0, y0):
        res = jnp.float32(s.resolution)
        iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        nb = [(fill(o0, a * step, b * step), jshift2d(x0, a * step, b * step),
               jshift2d(y0, a * step, b * step))
              for a in (-1, 0, 1) for b in (-1, 0, 1) if a or b]
        return jvoronoi.jacobi_fold(o0, x0, y0, nb, S, g.origin_x + ix.astype(jnp.float32) * res,
                                    g.origin_y + iy.astype(jnp.float32) * res)

    return jax.jit(one)(grid, *state)


@pytest.fixture(scope="module")
def bench():
    """The bench inputs, JAX's jitted Pallas flood of them, and JAX's state
    before every pass (each pass a jit of its own, its three planes
    returned: the Pallas kernel in interpret mode for steps <= 128)."""
    inp = dict(np.load(FLOOD_IN))
    grid, seeds = _jax_inputs(inp)
    S = len(inp["seeds_xy"])
    jpp.INTERPRET = True
    try:
        whole = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, JBENCH))(grid, seeds))
        state = jax.jit(lambda g, se: jvoronoi._jfa_init(g, se, JBENCH))(grid, seeds)
        states = []
        for step in jvoronoi._passes(JBENCH):
            states.append(tuple(np.asarray(a) for a in state))
            if step <= jpp.MAX_STEP:
                state = jax.jit(lambda o, x, y, gx, gy, step=step: jpp.jfa_pass(
                    o, x, y, step, S, gx, gy, JBENCH.resolution))(*state, grid.origin_x,
                                                                   grid.origin_y)
            else:
                state = _static_pass(grid, state, step, S, JBENCH)
        states.append(tuple(np.asarray(a) for a in state))
        # the last pass as the whole jit builds it: its owner plane alone
        last = states[-2]
        last_owner = np.asarray(jax.jit(lambda o, x, y, gx, gy: jpp.jfa_pass(
            o, x, y, 1, S, gx, gy, JBENCH.resolution)[0])(*last, grid.origin_x, grid.origin_y))
    finally:
        jpp.INTERPRET = False
    return dict(inp=inp, whole=whole, states=states, last_owner=last_owner, S=S)


def test_bench_flood_matches_pallas_lowering(bench):
    """The port's jump_flood of the bench inputs (plain K1 on the CPU) ==
    JAX's jitted jump_flood under BENCH_STATICS with the Pallas pass in
    interpret mode, in every cell but the 9 PHANTOM cells. There, JAX's
    state after the step-4 pass holds at PHANTOM_CELL the owner 2388 with
    seed 2209's y (its y plane's fold took 2209 where the owner plane's took
    2388), and JAX's owner lies farther than the port's in f64."""
    inp = bench["inp"]
    got = voronoi.jump_flood(*_port_inputs(inp), BENCH_STATICS).numpy()
    want = bench["whole"]
    cells = {tuple(int(v) for v in c) for c in np.argwhere(got != want)}
    assert cells == PHANTOM
    o, x, y = bench["states"][PHANTOM_PASS + 1]
    xy = inp["seeds_xy"]
    assert o[PHANTOM_CELL] == PHANTOM_OWNER
    assert x[PHANTOM_CELL] == xy[PHANTOM_OWNER, 0] and y[PHANTOM_CELL] == xy[PHANTOM_Y_SEED, 1]
    org, res = inp["origin"].astype(np.float64), float(np.float32(JBENCH.resolution))
    for c in PHANTOM:
        corner = org + np.array([c[1], c[0]]) * res
        d_ref, d_port = (float(((xy[k].astype(np.float64) - corner) ** 2).sum())
                         for k in (want[c], got[c]))
        assert (want[c], got[c]) == (PHANTOM_OWNER, PHANTOM_Y_SEED) and d_ref > d_port


PALLAS_PASSES = [m for m, k in enumerate(jvoronoi._passes(JBENCH)) if k <= jpp.MAX_STEP]


@pytest.mark.parametrize("m", PALLAS_PASSES + ["last"])
def test_bench_pass_matches_pallas_pass(bench, m, monkeypatch):
    """Pass m of the bench flood from JAX's state before it: jfa_pass_plain
    in the "pallas" rounding == JAX's jitted jfa_pass (interpret mode) in the
    owner plane, bitwise. JAX's x plane == the same fold with every d2
    fma(dy, dy, dx * dx), its y plane == the fold with every d2
    fma(dx, dx, dy * dy) (the "xla" rounding), bitwise: XLA:CPU builds the
    three planes in fusions rounded apart, so a cell's position can leave its
    owner's seed. "last": the flood's last pass with its owner plane alone
    returned, as inside the whole jit, == the "pallas_last" rounding."""
    steps = jvoronoi._passes(JBENCH)
    S, inp = bench["S"], bench["inp"]
    org = (float(inp["origin"][0]), float(inp["origin"][1]), JBENCH.resolution)
    k = len(steps) - 1 if m == "last" else m
    before = tuple(torch.from_numpy(np.array(a)) for a in bench["states"][k])
    if m == "last":
        got = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "pallas_last")
        assert np.array_equal(got[0].numpy(), bench["last_owner"])
        return
    want = bench["states"][k + 1]
    got = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "pallas")
    assert np.array_equal(got[0].numpy(), want[0])
    monkeypatch.setitem(voronoi.ROUNDINGS, "x_plane", "yyyyyyyyy")
    x_plane = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "x_plane")[1]
    y_plane = jfa_pass_cuda.jfa_pass_plain(*before, steps[k], S, *org, "xla")[2]
    assert np.array_equal(x_plane.numpy(), want[1]) and np.array_equal(y_plane.numpy(), want[2])


def _mirrored_pairs(S, H, W, res, origin, seed):
    """S seeds in pairs (x, m - d), (x, m + d) mirrored exactly (in f32)
    about the y of a cell row m, x on a 0.5 m lattice: every cell of row m
    below such a pair is an exact tie, which the candidates' roundings
    decide where they differ."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < S:
        r = int(rng.integers(20, H - 20))
        m = np.float32(np.float64(r) * np.float64(np.float32(res)) + origin)
        x = np.float32(origin + 0.5 * int(rng.integers(2, int(W * res / 0.5) - 2)))
        y1 = np.float32(m - np.float32(rng.uniform(0.3, 2.0)))
        y2 = np.float32(m + (m - y1))
        if np.float32(y2 - m) == np.float32(m - y1):
            pts += [(x, y1), (x, y2)]
    return np.array(pts[:S], np.float32)


def test_pallas_rounding_decides_mirrored_ties():
    """DRYRUN_STATICS' grid (192 x 256, two bands of 96 rows for the Pallas
    kernel's small steps) at BENCH's origin 3.5 and resolution 0.1 with the
    Pallas lowering on: the port's jump_flood == JAX's jitted jump_flood
    (interpret mode) bitwise on 64 mirrored seed pairs, while every pass in
    the "xla" rounding (the port's flood before the Pallas roundings) leaves
    cells where the pairs' exact ties go the other way."""
    js = dataclasses.replace(JDRY, resolution=0.1, jfa_pass_pallas=True,
                             jfa_dynamic_shifts=False)
    s = dataclasses.replace(DRYRUN_STATICS, resolution=0.1, jfa_pass_pallas=True,
                            jfa_dynamic_shifts=False)
    H, W, S = s.grid_h, s.grid_w, s.max_seeds
    xy = _mirrored_pairs(S, H, W, s.resolution, 3.5, seed=1)
    valid = np.ones(S, bool)
    jgrid = JGrid(jnp.zeros((H, W), jnp.uint8), jnp.float32(3.5), jnp.float32(3.5),
                  jnp.int32(H), jnp.int32(W))
    jpp.INTERPRET = True
    try:
        want = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(
            jgrid, JSeeds(jnp.asarray(xy), jnp.asarray(valid), jnp.zeros(S, jnp.int8))))
    finally:
        jpp.INTERPRET = False
    i32 = dict(dtype=torch.int32)
    grid = GridWorld(torch.zeros((H, W), dtype=torch.uint8), torch.tensor(3.5), torch.tensor(3.5),
                     torch.tensor(H, **i32), torch.tensor(W, **i32))
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(valid), torch.zeros(S, dtype=torch.int8))
    assert np.array_equal(voronoi.jump_flood(grid, seeds, s).numpy(), want)
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    xla = jfa_pass_cuda.jfa_flood(owner0, table, voronoi._passes(s), S, 3.5, 3.5, s.resolution)
    assert int((torch.where(xla < S, xla, -1) != torch.from_numpy(want)).sum()) > 0
