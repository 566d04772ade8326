"""Stored references of the JAX package's jump flood at the grid sizes of
``tests/test_torch_flood_sizes.py``, in ``Statics.for_grid``'s lowering.

For each size: a plane of seeds in swapped pairs about cell corners (every
cell on a pair's 45-degree line sees the two at swapped offsets, an exact
tie in real arithmetic that the forms of d2 decide; at these resolutions
the corners are not exact in f32, so the ties are near ties), and JAX's
``jump_flood`` jitted as a whole (the Pallas pass in interpret mode, as
``aosx``'s tests run it on the CPU): its owner plane, and the owner, x and y
planes of the same flood jitted with its carried planes returned (the same
passes, the last one keeping its x and y planes). The JAX package is not
changed. Written with ``flood_planes.pack`` to ``flood_sizes_<size>.npz``
beside this file, one a size; the carried planes' owner plane is stored
only where it differs from the whole flood's.

Run from the repository root (about 5 minutes, most of it the 2000 x 2048
flood in interpret mode):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_flood_sizes_reference.py
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx.config import Statics  # noqa: E402
from aosx.gvd import jfa_pass_pallas as jpp, voronoi as jvoronoi  # noqa: E402
from aosx.perceive.raster import shift2d  # noqa: E402
from aosx.types import GridWorld, SeedSet  # noqa: E402
from flood_planes import pack  # noqa: E402

def out_path(name):
    return HERE / f"flood_sizes_{name}.npz"
ORIGIN = 3.5
# name: (H, W, resolution); the seeds are min(max_seeds, max(128, H W / 256)),
# H W / 64 on the one-band grids (H <= 104), whose ties are few otherwise
SIZES = {
    "64x128": (64, 128, 0.05),
    # one band at 0.1 m: the chain's two versions of a cell's y decide
    "64x256": (64, 256, 0.1),
    "96x128": (96, 128, 0.1),
    "136x256": (136, 256, 0.05),
    "192x256": (192, 256, 0.05),
    # banded grids either side of the widest grid whose cells' x row LLVM
    # unrolls (voronoi.SPLIT_X_MAX_W: 447), one of them not a multiple of 8
    "192x128": (192, 128, 0.05),
    "192x320": (192, 320, 0.05),
    "136x384": (136, 384, 0.05),
    "136x432": (136, 432, 0.05),
    "136x444": (136, 444, 0.05),
    "136x447": (136, 447, 0.05),
    "136x448": (136, 448, 0.05),
    "136x300": (136, 300, 0.05),
    "384x512": (384, 512, 0.05),
    "1000x1024": (1000, 1024, 0.1),
    "2000x2048": (2000, 2048, 0.1),
}


def statics(name):
    H, W, res = SIZES[name]
    return Statics.for_grid(H, W, res)


def swapped_pairs(S, H, W, res, origin, seed):
    """S seeds in pairs A = c + (a, b), B = c + (b, a) about a cell corner c
    (f32), a and b within 2 m."""
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


def seeds_of(name):
    H, W, res = SIZES[name]
    S = min(statics(name).max_seeds, max(128, H * W // (64 if H <= 104 else 256)))
    return swapped_pairs(S, H, W, res, ORIGIN, seed=0)


def flood_planes(grid, seeds, s):
    """aosx/gvd/voronoi.py's jump_flood with static shifts, the same passes
    (the Pallas pass where it runs it), returning the carried planes
    (owner, x, y) after the last pass instead of the live owner plane."""
    h, w = grid.occ.shape
    res = jnp.float32(s.resolution)
    S = seeds.xy.shape[0]
    iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    cellx = grid.origin_x + ix.astype(jnp.float32) * res
    celly = grid.origin_y + iy.astype(jnp.float32) * res

    def shift_fill_s(a, dy, dx):
        out = a
        if dy > 0:
            out = jnp.pad(out, ((dy, 0), (0, 0)), constant_values=S)[:h, :]
        elif dy < 0:
            out = jnp.pad(out, ((0, -dy), (0, 0)), constant_values=S)[-h:, :]
        if dx > 0:
            out = jnp.pad(out, ((0, 0), (dx, 0)), constant_values=S)[:, :w]
        elif dx < 0:
            out = jnp.pad(out, ((0, 0), (0, -dx)), constant_values=S)[:, -w:]
        return out

    state = jvoronoi._jfa_init(grid, seeds, s)
    use_pallas = s.jfa_pass_pallas and h < 4000
    for step in jvoronoi._passes(s):
        if use_pallas and step <= jpp.MAX_STEP:
            state = jpp.jfa_pass(*state, step, S, grid.origin_x, grid.origin_y, s.resolution)
            continue
        o0, x0, y0 = state
        nb = [(shift_fill_s(o0, a * step, b * step), shift2d(x0, a * step, b * step),
               shift2d(y0, a * step, b * step))
              for a in (-1, 0, 1) for b in (-1, 0, 1) if a or b]
        state = jvoronoi.jacobi_fold(o0, x0, y0, nb, S, cellx, celly)
    return state


def inputs(name):
    H, W, _ = SIZES[name]
    xy = seeds_of(name)
    grid = GridWorld(jnp.zeros((H, W), jnp.uint8), jnp.float32(ORIGIN), jnp.float32(ORIGIN),
                     jnp.int32(H), jnp.int32(W))
    return grid, SeedSet(jnp.asarray(xy), jnp.ones(len(xy), bool),
                         jnp.zeros(len(xy), jnp.int8)), xy


def main():
    jpp.INTERPRET = True
    try:
        for name in sys.argv[1:] or SIZES:
            t = time.time()
            s = statics(name)
            grid, seeds, xy = inputs(name)
            owner = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, s))(grid, seeds))
            planes = tuple(np.asarray(a) for a in
                           jax.jit(lambda g, se: flood_planes(g, se, s))(grid, seeds))
            out = dict(xy=xy)
            pack("owner/", [owner], xy, out)
            pack("planes/", [planes], xy, out)
            if np.array_equal(np.where(planes[0] < len(xy), planes[0], -1), owner):
                # the same owner plane: kept once
                out["planes/o0"] = np.int32(-1)
            np.savez_compressed(out_path(name), **out)
            print(f"{name}: {len(xy)} seeds, {int((owner >= 0).sum())} owned cells, "
                  f"{time.time() - t:.1f} s, {out_path(name).stat().st_size} bytes", flush=True)
    finally:
        jpp.INTERPRET = False


if __name__ == "__main__":
    main()
