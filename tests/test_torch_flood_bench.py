"""K1's roundings held to the JAX package's lowerings of the flood.

At BENCH_STATICS ``aosx``'s ``jump_flood`` runs every pass of step <= 128
through the banded Pallas kernel (``aosx/gvd/jfa_pass_pallas.py``); its
tests run that kernel on the CPU in interpret mode, and so do these. XLA:CPU
builds a pass's owner, x and y planes in fusions of their own, each a whole
fold that contracts the squared distances into fused multiply-adds its own
way, a direction at a time, and differently where the pass's position planes
are dropped (a flood's last pass inside a jit). The port carries the three
planes and rounds each as ``aosx_torch.gvd.voronoi.ROUNDINGS`` names it;
these tests hold it to the JAX planes bitwise:

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
# after the step-4 pass the cell PHANTOM_CELL holds owner 2388 but seed 2209's
# y, and that phantom position wins the cells PHANTOM for 2388 in the last two
# passes, each farther (f64) from 2388's seed than from 2209's
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


def _pallas_states(grid, seeds, s):
    """JAX's state before every pass of the flood in the Pallas lowering and
    after the last, each pass a jit of its own that returns its three planes
    (the Pallas kernel in interpret mode for steps <= 128, the static shifts
    elsewhere); call with jpp.INTERPRET set."""
    S = seeds.xy.shape[0]
    state = jax.jit(lambda g, se: jvoronoi._jfa_init(g, se, s))(grid, seeds)
    states = []
    for step in jvoronoi._passes(s):
        states.append(tuple(np.asarray(a) for a in state))
        if step <= jpp.MAX_STEP:
            state = jax.jit(lambda o, x, y, gx, gy, step=step: jpp.jfa_pass(
                o, x, y, step, S, gx, gy, s.resolution))(*state, grid.origin_x, grid.origin_y)
        else:
            state = _static_pass(grid, state, step, S, s)
    states.append(tuple(np.asarray(a) for a in state))
    return states


@pytest.fixture(scope="module")
def bench():
    """The bench inputs, JAX's jitted Pallas flood of them, and JAX's state
    before every pass (_pallas_states)."""
    inp = dict(np.load(FLOOD_IN))
    grid, seeds = _jax_inputs(inp)
    S = len(inp["seeds_xy"])
    jpp.INTERPRET = True
    try:
        whole = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, JBENCH))(grid, seeds))
        states = _pallas_states(grid, seeds, JBENCH)
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
    interpret mode, in every cell. After the step-4 pass JAX's state and the
    port's carried planes are equal, and hold at PHANTOM_CELL the owner 2388
    with seed 2209's y (the y plane's fold took 2209 where the owner plane's
    took 2388); the PHANTOM cells, which that position wins for 2388, lie
    farther (f64) from 2388's seed than from 2209's."""
    inp = bench["inp"]
    grid, seeds = _port_inputs(inp)
    got = voronoi.jump_flood(grid, seeds, BENCH_STATICS).numpy()
    want = bench["whole"]
    assert np.array_equal(got, want)
    jo, jx, jy = bench["states"][PHANTOM_PASS + 1]
    xy = inp["seeds_xy"]
    assert jo[PHANTOM_CELL] == PHANTOM_OWNER
    assert jx[PHANTOM_CELL] == xy[PHANTOM_OWNER, 0] and jy[PHANTOM_CELL] == xy[PHANTOM_Y_SEED, 1]
    steps = voronoi._passes(BENCH_STATICS)
    rounding = voronoi.pass_roundings(BENCH_STATICS, steps)
    S = bench["S"]
    owner0, table = voronoi._jfa_init(grid, seeds, BENCH_STATICS)
    carried = jfa_pass_cuda.jfa_flood_plain(owner0, table, steps[:PHANTOM_PASS + 1], S,
                                            grid.origin_x, grid.origin_y,
                                            BENCH_STATICS.resolution, rounding[:PHANTOM_PASS + 1])
    for a, b in zip(carried, (jo, jx, jy)):
        assert np.array_equal(a.numpy(), b)
    org, res = inp["origin"].astype(np.float64), float(np.float32(JBENCH.resolution))
    for c in PHANTOM:
        corner = org + np.array([c[1], c[0]]) * res
        d_own, d_y = (float(((xy[k].astype(np.float64) - corner) ** 2).sum())
                      for k in (PHANTOM_OWNER, PHANTOM_Y_SEED))
        assert want[c] == PHANTOM_OWNER and d_own > d_y


PALLAS_PASSES = [m for m, k in enumerate(jvoronoi._passes(JBENCH)) if k <= jpp.MAX_STEP]


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
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


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
    (interpret mode) bitwise on 64 mirrored seed pairs; from JAX's state
    before each pass (a jit a pass), the port's pass gives JAX's x and y
    planes bitwise; and every pass in the "xla" rounding (the XLA lowering's
    folds) leaves cells where the pairs' exact ties go the other way. (A
    Pallas pass jitted alone at this size rounds some owner cells otherwise
    at steps <= 16 than inside the whole jit, whose owner plane the port
    follows: ROADMAP section 3.)"""
    js = dataclasses.replace(JDRY, resolution=0.1, jfa_pass_pallas=True,
                             jfa_dynamic_shifts=False)
    s = dataclasses.replace(DRYRUN_STATICS, resolution=0.1, jfa_pass_pallas=True,
                            jfa_dynamic_shifts=False)
    H, W, S = s.grid_h, s.grid_w, s.max_seeds
    xy = _mirrored_pairs(S, H, W, s.resolution, 3.5, seed=1)
    valid = np.ones(S, bool)
    jgrid = JGrid(jnp.zeros((H, W), jnp.uint8), jnp.float32(3.5), jnp.float32(3.5),
                  jnp.int32(H), jnp.int32(W))
    jseeds = JSeeds(jnp.asarray(xy), jnp.asarray(valid), jnp.zeros(S, jnp.int8))
    jpp.INTERPRET = True
    try:
        want = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(jgrid, jseeds))
        states = _pallas_states(jgrid, jseeds, js)
    finally:
        jpp.INTERPRET = False
    grid, seeds = _grid_seeds(xy, valid, H, W, 3.5)
    assert np.array_equal(voronoi.jump_flood(grid, seeds, s).numpy(), want)
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    steps = voronoi._passes(s)
    for m, step in enumerate(steps):
        before = tuple(torch.from_numpy(np.array(a)) for a in states[m])
        got = jfa_pass_cuda.jfa_pass_plain(*before, step, S, 3.5, 3.5, s.resolution, "pallas")
        for a, b in zip(got[1:], states[m + 1][1:]):
            assert np.array_equal(a.numpy(), b)
    xla = jfa_pass_cuda.jfa_flood(owner0, table, steps, S, 3.5, 3.5, s.resolution)
    assert int((torch.where(xla < S, xla, -1) != torch.from_numpy(want)).sum()) > 0


def _grid_seeds(xy, valid, H, W, origin):
    """The port's GridWorld (empty, all live) and SeedSet for seeds xy."""
    i32 = dict(dtype=torch.int32)
    grid = GridWorld(torch.zeros((H, W), dtype=torch.uint8), torch.tensor(origin),
                     torch.tensor(origin), torch.tensor(H, **i32), torch.tensor(W, **i32))
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(valid),
                    torch.zeros(len(xy), dtype=torch.int8))
    return grid, seeds


def _swapped_pairs(S, H, W, res, origin, seed):
    """S seeds in pairs A = c + (a, b), B = c + (b, a) about a cell corner c
    with a, b in f32 at that binade's spacing: every cell on the 45-degree
    line through c sees them at swapped offsets, an exact tie in real
    arithmetic that the forms of d2 decide (fma(dx, dx, dy * dy) of A is
    fma(dy, dy, dx * dx) of B)."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < S:
        i, j = int(rng.integers(8, H - 8)), int(rng.integers(8, W - 8))
        cx, cy = np.float32(origin + j * res), np.float32(origin + i * res)
        a = (np.float32(cx + np.float32(rng.uniform(-2.0, 2.0))),
             np.float32(cy + np.float32(rng.uniform(-2.0, 2.0))))
        da, db = np.float32(a[0] - cx), np.float32(a[1] - cy)
        b = (np.float32(cx + db), np.float32(cy + da))
        if np.float32(b[0] - cx) == db and np.float32(b[1] - cy) == da:
            pts += [a, b]
    return np.array(pts[:S], np.float32)


DIAGONAL_LOWERINGS = ("dynamic", "pallas", "sharded")


@pytest.mark.parametrize("lowering", DIAGONAL_LOWERINGS)
def test_lowering_forms_decide_diagonal_ties(lowering):
    """DRYRUN_STATICS' grid at origin 2.0 and resolution 0.125 (cell corners
    exact in f32) with 64 swapped seed pairs: the port's flood == JAX's
    jitted flood in the lowering, bitwise (the dynamic shifts: "xla"
    throughout; the Pallas kernel in interpret mode: "pallas", its last pass
    "pallas_last"; jump_flood_sharded over 4 CPU devices: "xla", its last
    pass "sharded_last"), while a flood that folds x and y as its owner
    plane (every position its owner's seed) differs in many cells."""
    from jax.sharding import Mesh as JMesh

    from aosx.parallel.spatial import jump_flood_sharded as jflood_sharded
    from aosx_torch.parallel.spatial import Mesh, jump_flood_sharded

    org, res = 2.0, 0.125
    flags = dict(resolution=res, jfa_pass_pallas=lowering == "pallas",
                 jfa_dynamic_shifts=lowering == "dynamic")
    js, s = dataclasses.replace(JDRY, **flags), dataclasses.replace(DRYRUN_STATICS, **flags)
    H, W, S = s.grid_h, s.grid_w, s.max_seeds
    xy = _swapped_pairs(S, H, W, res, org, seed=0)
    valid = np.ones(S, bool)
    jgrid = JGrid(jnp.zeros((H, W), jnp.uint8), jnp.float32(org), jnp.float32(org),
                  jnp.int32(H), jnp.int32(W))
    jseeds = JSeeds(jnp.asarray(xy), jnp.asarray(valid), jnp.zeros(S, jnp.int8))
    grid, seeds = _grid_seeds(xy, valid, H, W, org)
    if lowering == "sharded":
        jmesh = JMesh(np.array(jax.devices("cpu")[:4]), ("space",))
        want = np.asarray(jax.jit(lambda g, se: jflood_sharded(g, se, js, jmesh))(jgrid, jseeds))
        got = jump_flood_sharded(grid, seeds, s, Mesh((torch.device("cpu"),) * 4, ("space",)))
    else:
        jpp.INTERPRET = lowering == "pallas"
        try:
            want = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(jgrid, jseeds))
        finally:
            jpp.INTERPRET = False
        got = voronoi.jump_flood(grid, seeds, s)
    assert np.array_equal(got.numpy(), want)
    # the planes folded as the owner plane: every cell's position its owner's
    owner_only = {k: (v[0],) * 3 for k, v in voronoi.ROUNDINGS.items()}
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
