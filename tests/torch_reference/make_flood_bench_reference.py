"""Stored references of the JAX package's floods that
``tests/test_torch_flood_bench.py`` holds the port to.

- the bench flood: the committed bench inputs (``bench_np_seed0_flood_in.npz``:
  the BENCH skeleton, 4,096 merged seeds, origin (3.5, 3.5), res 0.1), JAX's
  ``jump_flood`` jitted under BENCH_STATICS (its owner plane), JAX's state
  before every pass and after the last (a jit a pass that returns its three
  planes: the Pallas pass in interpret mode for steps <= 128, the static
  shifts elsewhere), and the last pass's owner plane jitted as the whole jit
  builds it (its owner plane alone);
- mirrored seed pairs on DRYRUN_STATICS' grid (192 x 256) at origin 3.5 and
  resolution 0.1 with the Pallas lowering on: the jitted flood's owner plane
  and the state before every pass (a jit a pass);
- swapped seed pairs on DRYRUN_STATICS' grid at origin 2.0 and resolution
  0.125: the jitted flood's owner plane in the dynamic-shift, the Pallas and
  the sharded (4 CPU devices) lowering.

The JAX package is not changed: the Pallas pass runs in interpret mode
through ``jfa_pass_pallas.INTERPRET``, as ``aosx``'s tests run it. Written
with ``flood_planes.pack`` to ``flood_bench_ref.npz`` beside this file.

Run from the repository root (about 12 minutes, most of it the bench flood's
passes in interpret mode):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_reference/make_flood_bench_reference.py
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import numpy as np  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx.config import BENCH_STATICS as JBENCH, DRYRUN_STATICS as JDRY  # noqa: E402
from aosx.gvd import jfa_pass_pallas as jpp, voronoi as jvoronoi  # noqa: E402
from aosx.perceive.raster import shift2d as jshift2d  # noqa: E402
from aosx.types import GridWorld as JGrid, SeedSet as JSeeds  # noqa: E402
from flood_planes import pack  # noqa: E402

OUT = HERE / "flood_bench_ref.npz"
FLOOD_IN = HERE / "bench_np_seed0_flood_in.npz"
# the DRYRUN-size planes: (origin, resolution, seeds' generator seed)
MIRRORED = (3.5, 0.1, 1)
DIAGONAL = (2.0, 0.125, 0)
DIAGONAL_LOWERINGS = ("dynamic", "pallas", "sharded")


def jax_inputs(inp):
    grid = JGrid(jnp.asarray(inp["occ"]), jnp.float32(inp["origin"][0]),
                 jnp.float32(inp["origin"][1]), jnp.int32(inp["cells"][0]),
                 jnp.int32(inp["cells"][1]))
    S = len(inp["seeds_xy"])
    return grid, JSeeds(jnp.asarray(inp["seeds_xy"]), jnp.asarray(inp["seeds_valid"]),
                        jnp.zeros((S,), jnp.int8))


def static_pass(grid, state, step, S, s):
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


def pallas_states(grid, seeds, s):
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
            state = static_pass(grid, state, step, S, s)
    states.append(tuple(np.asarray(a) for a in state))
    return states


def mirrored_pairs(S, H, W, res, origin, seed):
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


def swapped_pairs(S, H, W, res, origin, seed):
    """S seeds in pairs A = c + (a, b), B = c + (b, a) about a cell corner c
    with a, b in f32 at that binade's spacing: every cell on the 45-degree
    line through c sees them at swapped offsets, an exact tie in real
    arithmetic that the forms of d2 decide."""
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


def dry_inputs(xy, origin):
    H, W, S = JDRY.grid_h, JDRY.grid_w, len(xy)
    grid = JGrid(jnp.zeros((H, W), jnp.uint8), jnp.float32(origin), jnp.float32(origin),
                 jnp.int32(H), jnp.int32(W))
    return grid, JSeeds(jnp.asarray(xy), jnp.ones(S, bool), jnp.zeros(S, jnp.int8))


def bench(out):
    inp = dict(np.load(FLOOD_IN))
    grid, seeds = jax_inputs(inp)
    S = len(inp["seeds_xy"])
    whole = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, JBENCH))(grid, seeds))
    states = pallas_states(grid, seeds, JBENCH)
    last_owner = np.asarray(jax.jit(lambda o, x, y, gx, gy: jpp.jfa_pass(
        o, x, y, 1, S, gx, gy, JBENCH.resolution)[0])(*states[-2], grid.origin_x,
                                                       grid.origin_y))
    pack("bench/whole/", [whole], inp["seeds_xy"], out)
    pack("bench/states/", states, inp["seeds_xy"], out)
    pack("bench/last_owner/", [last_owner], inp["seeds_xy"], out)


def mirrored(out):
    origin, res, seed = MIRRORED
    js = dataclasses.replace(JDRY, resolution=res, jfa_pass_pallas=True,
                             jfa_dynamic_shifts=False)
    xy = mirrored_pairs(js.max_seeds, js.grid_h, js.grid_w, res, origin, seed)
    grid, seeds = dry_inputs(xy, origin)
    want = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(grid, seeds))
    out["mirrored/xy"] = xy
    pack("mirrored/want/", [want], xy, out)
    pack("mirrored/states/", pallas_states(grid, seeds, js), xy, out)


def diagonal(out):
    from jax.sharding import Mesh as JMesh

    from aosx.parallel.spatial import jump_flood_sharded

    origin, res, seed = DIAGONAL
    xy = swapped_pairs(JDRY.max_seeds, JDRY.grid_h, JDRY.grid_w, res, origin, seed)
    grid, seeds = dry_inputs(xy, origin)
    out["diagonal/xy"] = xy
    for lowering in DIAGONAL_LOWERINGS:
        js = dataclasses.replace(JDRY, resolution=res, jfa_pass_pallas=lowering == "pallas",
                                 jfa_dynamic_shifts=lowering == "dynamic")
        if lowering == "sharded":
            mesh = JMesh(np.array(jax.devices("cpu")[:4]), ("space",))
            want = jax.jit(lambda g, se: jump_flood_sharded(g, se, js, mesh))(grid, seeds)
        else:
            want = jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(grid, seeds)
        pack(f"diagonal/{lowering}/", [np.asarray(want)], xy, out)


def main():
    out = {}
    jpp.INTERPRET = True
    try:
        for part in (diagonal, mirrored, bench):
            t = time.time()
            part(out)
            print(f"{part.__name__}: {time.time() - t:.1f} s", flush=True)
    finally:
        jpp.INTERPRET = False
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
