"""The port's flood against the JAX reference's, cell by cell.

``chip_smoke.py`` phase 5 prints the cells of the BENCH_STATICS owner plane
that differ from ``bench_np_seed0_owner.npz`` (JAX's ``jump_flood`` inside
``make_bench_reference.py``'s ``stage_full`` jit, in BENCH_STATICS' own
lowering: the Pallas pass kernel in interpret mode for steps <= 128) and
fails on a cell that ``NAMED_OWNER_CELLS`` does not name; it names none.
This script shows where and why a flood parts from the reference: JAX's
flood folds its owner, x and y planes each in its own rounding, so at an
exact tie a cell can carry a position that is not its owner's seed. The
port's ``jump_flood`` carries the three planes so too and reports 0 cells
for the bench orchard and for Monte-Carlo worlds 102 and 118; a flood that
keeps each position its owner's seed (one fold a pass)
parts from the reference in 9 bench cells and in 73 and 992 cells of those
worlds.

``--lowering pallas|static|dynamic`` picks the JAX lowering of the bench
flood (default pallas, the reference's): the Pallas pass kernel for steps
<= 128 with the static shifts elsewhere, the static shifts throughout
(``jfa_pass_pallas=False``; its whole jit compiles for a long time), or the
dynamic shifts (``jfa_dynamic_shifts=True``, the lowering of the references
before the Pallas one).

``make`` (needs jax; ~1-3 min on the CPU) runs that ``stage_full`` jit in the
lowering, returning also the flood's inputs (the skeleton plane and its grid
scalars, the merged seeds), and saves the inputs to
``bench_np_seed0_flood_in.npz`` (whose owner planes are the dynamic
lowering's: the reference's jit, ``jump_flood`` jitted alone, and run op by
op) where it is the dynamic lowering's run, else checks that they are the
saved ones. In the Pallas lowering it checks that its owner plane is the
reference's and saves to ``_archive/owner_cells/bench_pallas.npz``
(gitignored) the planes of ``jump_flood`` jitted alone and JAX's state
before and after every pass, each pass a jit of its own that returns its
three planes, as the whole jit's passes do but its last.

``passes --lowering dynamic`` (needs jax; ~10 min) jits JAX's dynamic-shift flood (the code of
``aosx.gvd.voronoi.jump_flood``, with its ``_jfa_init`` and ``jacobi_fold``)
over the first m passes, m = 1..12, and saves each owner plane to
``_archive/owner_cells/jax_passes.npz`` (gitignored); ``analyse`` then finds
the first pass whose owner plane differs from the port's, and where.

``analyse`` (torch only; the default) holds the port's ``jump_flood`` of the
saved inputs against every JAX plane (0 cells), then floods them with one
fold a pass (x and y selected with the owner, every position its owner's
seed) under several roundings of the cell coordinates and of d2, counts for
each the cells that differ from every JAX plane, and prints, for the first
cells where that flood differs from the reference, each pass's candidates:
owner, d2 in f32 under each rounding and in f64. In the Pallas lowering it
holds each pass of the port (``jfa_pass_plain`` in the pass's
``voronoi.ROUNDINGS`` key) to JAX's pass from JAX's state in all three
planes, prints every cell whose JAX position is not its owner's seed (the x
plane's fold rounds every d2 as fma(dy, dy, dx * dx), the y plane's as
fma(dx, dx, dy * dy)), holds the port's ``jump_flood`` to the reference, and
prints the cells where a flood that keeps each position its owner's seed
differs, each with how much farther (f64) the reference's owner lies.

``--world N`` does the same for Monte-Carlo world N of
``make_mc_reference.py`` (``make_orchard_np(MC_SPEC, seed=N)`` at MC_STATICS;
``chip_smoke.py`` phase 9 names world 102). ``make`` runs JAX's jitted
``prepare_world_full(with_owner=True)`` with ``jfa_dynamic_shifts=True``, as
the reference's ``begin`` builds the world, and saves the flood's inputs with
JAX's owner planes to ``_archive/owner_cells/mc_world<N>_flood_in.npz``
(gitignored), each as it is ready: that jit's, ``jump_flood`` op by op, the
static-shift lowering (MC_STATICS' own) with a jit a pass (``static_passes``,
which also prints each pass's cells whose carried position is not their
owner's seed), and ``jump_flood`` jitted alone with dynamic shifts (about 2
min in all). ``analyse`` holds the port's ``jump_flood`` (0 cells against
the jitted floods; JAX's flood run op by op rounds otherwise) and each
rounding of a one-fold flood against them, and says how much farther (f64)
the reference's owner lies at each cell where the one-fold flood differs.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference/owner_cells.py make
    python tests/torch_reference/owner_cells.py analyse
    JAX_PLATFORMS=cpu python tests/torch_reference/owner_cells.py make --lowering dynamic
    JAX_PLATFORMS=cpu python tests/torch_reference/owner_cells.py passes --lowering dynamic
    python tests/torch_reference/owner_cells.py analyse --lowering dynamic
    JAX_PLATFORMS=cpu python tests/torch_reference/owner_cells.py make --world 102
    JAX_PLATFORMS=cpu python tests/torch_reference/owner_cells.py passes --world 102
    python tests/torch_reference/owner_cells.py analyse --world 102
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
FLOOD_IN = HERE / "bench_np_seed0_flood_in.npz"
REF_OWNER = HERE / "bench_np_seed0_owner.npz"
JAX_PASSES = ROOT / "_archive" / "owner_cells" / "jax_passes.npz"
PALLAS_PLANES = JAX_PASSES.with_name("bench_pallas.npz")
LOWERINGS = ("pallas", "static", "dynamic")


def _files(world):
    """(flood inputs, JAX's per-pass planes) of the bench orchard or of
    Monte-Carlo world ``world``."""
    if world is None:
        return FLOOD_IN, JAX_PASSES
    return (JAX_PASSES.with_name(f"mc_world{world}_flood_in.npz"),
            JAX_PASSES.with_name(f"mc_world{world}_jax_passes.npz"))


def _owner_planes(inp, world):
    """JAX's owner planes of the saved flood, by name."""
    if world is None:
        # the dynamic lowering's planes, saved with the inputs; the static
        # lowering's where make --lowering static has saved them
        planes = {"dynamic stage_full": inp["owner_stage"],
                  "dynamic jump_flood alone": inp["owner_alone"],
                  "dynamic jump_flood op by op": inp["owner_eager"]}
        static = JAX_PASSES.with_name("bench_static.npz")
        if static.exists():
            planes.update({f"static {k}": v for k, v in np.load(static).items()})
        return planes
    names = {"owner_stage": "reference (prepare_world jit)", "owner_eager": "jump_flood op by op",
             "owner_static_passes": "static shifts, a jit a pass",
             "owner_alone": "jump_flood alone"}
    return {v: inp[k] for k, v in names.items() if k in inp}


def make_world(world):
    """``make --world N``: Monte-Carlo world N's flood inputs and JAX's owner
    planes (module docstring)."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(HERE))
    from make_mc_reference import MC_SPEC  # noqa: E402

    from aosx import engine
    from aosx.config import MC_STATICS, AosParams, params_as_f32
    from aosx.gvd.graph import merge_seeds
    from aosx.gvd.voronoi import jump_flood
    from aosx.orchards import OrchardSpec, make_orchard_np
    from aosx.types import GridWorld, PointCloud, Polygon, SeedSet

    s = dataclasses.replace(MC_STATICS, jfa_dynamic_shifts=True)
    xyz, poly = make_orchard_np(OrchardSpec(**MC_SPEC), seed=world)
    buf = np.zeros((s.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(s.max_points, bool)
    valid[:len(xyz)] = True

    @jax.jit
    def build(pc, poly, params, excl):
        _, out, owner = engine.prepare_world_full(pc, poly, params, excl, s,
                                                  ror_method="sorted", with_owner=True)
        return out.skeleton, merge_seeds(out.seeds, params, s), owner

    skel, merged, owner = jax.block_until_ready(build(
        PointCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), Polygon.from_array(poly, s),
        params_as_f32(AosParams()), jnp.zeros((s.max_exclusions, 3), jnp.float32)))
    grid = GridWorld(skel.occ, skel.origin_x, skel.origin_y, skel.h_cells, skel.w_cells)
    seeds = SeedSet(merged.xy, merged.valid, merged.kind)
    path = _files(world)[0]
    path.parent.mkdir(parents=True, exist_ok=True)
    planes = dict(owner_stage=np.asarray(owner))

    def save(name, plane):
        # saved after each plane, since the jitted floods take long
        planes[name] = np.asarray(plane)
        print(f"world {world}, {name}: {int((planes[name] != planes['owner_stage']).sum())} "
              f"cells differ from the prepare_world jit's", flush=True)
        np.savez_compressed(
            path, occ=np.asarray(skel.occ), origin=np.array(
                [np.asarray(skel.origin_x), np.asarray(skel.origin_y)], np.float32),
            cells=np.array([int(skel.h_cells), int(skel.w_cells)], np.int32),
            seeds_xy=np.asarray(merged.xy), seeds_valid=np.asarray(merged.valid),
            resolution=np.float32(s.resolution), statics="MC_STATICS", **planes)

    with jax.disable_jit():
        save("owner_eager", jump_flood(grid, seeds, s))
    save("owner_static_passes", static_passes(grid, seeds, MC_STATICS))
    save("owner_alone", jax.jit(lambda g, se: jump_flood(g, se, s))(grid, seeds))


def static_passes(grid, seeds, s):
    """aosx.gvd.voronoi.jump_flood's static-shift lowering with every pass
    jitted on its own (the seed scatter too): the same fold and shifts as
    the whole static-shift jit, which compiles in about a minute at
    MC_STATICS but does not finish running (XLA fuses every pass into the
    later ones and its last fusion's outlined functions recompute them per
    use), where a pass runs in seconds. A pass jitted alone is not that
    jit's context (ROADMAP section 3)."""
    import jax
    import jax.numpy as jnp

    from aosx.gvd.voronoi import _jfa_init, _passes, jacobi_fold
    from aosx.perceive.raster import live_mask, shift2d

    h, w = grid.occ.shape
    S = seeds.xy.shape[0]

    def fill(a, dy, dx):
        # shift_fill_s of jump_flood: pad with S, then crop
        pads = ((max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0)))
        return jnp.pad(a, pads, constant_values=S)[max(-dy, 0):max(-dy, 0) + h,
                                                   max(-dx, 0):max(-dx, 0) + w]

    def one_pass(g, o0, x0, y0, step):
        res = jnp.float32(s.resolution)
        iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        cellx = g.origin_x + ix.astype(jnp.float32) * res
        celly = g.origin_y + iy.astype(jnp.float32) * res
        nb = [(fill(o0, dys * step, dxs * step), shift2d(x0, dys * step, dxs * step),
               shift2d(y0, dys * step, dxs * step))
              for dys in (-1, 0, 1) for dxs in (-1, 0, 1) if dys or dxs]
        return jacobi_fold(o0, x0, y0, nb, S, cellx, celly)

    # where a cell's carried position is not its owner's seed: the jitted
    # fold updates the owner and the two position planes in fusions of
    # their own, which can decide a tie apart
    table = np.concatenate([np.asarray(seeds.xy), [[1e9, 1e9]]]).astype(np.float32)
    state = jax.jit(lambda g, se: _jfa_init(g, se, s))(grid, seeds)
    for m, step in enumerate(_passes(s), 1):
        state = jax.jit(one_pass, static_argnums=4)(grid, *state, step)
        o, x, y = (np.asarray(a) for a in state)
        own = table[np.minimum(o, S)]
        apart = np.argwhere((o < S) & ((x != own[..., 0]) | (y != own[..., 1])))
        if len(apart):
            c = tuple(int(v) for v in apart[0])
            print(f"static shifts, pass {m} (step {step}): {len(apart)} cells hold a position "
                  f"that is not their owner's seed, the first {c}: owner {o[c]} at "
                  f"{table[o[c]].tolist()}, position {[float(x[c]), float(y[c])]}", flush=True)
    return jnp.where(live_mask(grid) & (state[0] < S), state[0], -1)


def _bench_statics(lowering):
    """aosx's BENCH_STATICS in the lowering, with the Pallas kernel switched
    to interpret mode where it runs."""
    from aosx.config import BENCH_STATICS
    from aosx.gvd import jfa_pass_pallas

    jfa_pass_pallas.INTERPRET = lowering == "pallas"
    return dataclasses.replace(BENCH_STATICS, jfa_pass_pallas=lowering == "pallas",
                               jfa_dynamic_shifts=lowering == "dynamic")


def pallas_chain(grid, seeds, s):
    """JAX's state before and after every pass of the flood in the Pallas
    lowering, each pass a jit of its own that returns its three planes
    (Pallas in interpret mode for steps <= 128, the static shifts a pass
    elsewhere): {"o<m>", "x<m>", "y<m>": the state after m passes}."""
    import jax

    from aosx.gvd import jfa_pass_pallas as jpp
    from aosx.gvd.voronoi import _jfa_init, _passes, jacobi_fold
    from aosx.perceive.raster import shift2d

    h, w = grid.occ.shape
    S = seeds.xy.shape[0]

    def fill(a, dy, dx):
        pads = ((max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0)))
        return jax.numpy.pad(a, pads, constant_values=S)[max(-dy, 0):max(-dy, 0) + h,
                                                         max(-dx, 0):max(-dx, 0) + w]

    def static(g, o0, x0, y0, step):
        import jax.numpy as jnp

        res = jnp.float32(s.resolution)
        iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        nb = [(fill(o0, a * step, b * step), shift2d(x0, a * step, b * step),
               shift2d(y0, a * step, b * step))
              for a in (-1, 0, 1) for b in (-1, 0, 1) if a or b]
        return jacobi_fold(o0, x0, y0, nb, S, g.origin_x + ix.astype(jnp.float32) * res,
                           g.origin_y + iy.astype(jnp.float32) * res)

    def pallas(g, o0, x0, y0, step):
        return jpp.jfa_pass(o0, x0, y0, step, S, g.origin_x, g.origin_y, s.resolution)

    state = jax.jit(lambda g, se: _jfa_init(g, se, s))(grid, seeds)
    out = {}
    for m, step in enumerate(_passes(s)):
        out.update({f"{k}{m}": np.asarray(a) for k, a in zip("oxy", state)})
        f = pallas if step <= jpp.MAX_STEP else static
        state = jax.jit(f, static_argnums=4)(grid, *state, step)
    out.update({f"{k}{len(_passes(s))}": np.asarray(a) for k, a in zip("oxy", state)})
    return out


def make(world=None, lowering="pallas"):
    if world is not None:
        return make_world(world)
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(HERE))
    from make_bench_reference import BENCH_SPEC  # noqa: E402

    from aosx import engine
    from aosx.config import AosParams, params_as_f32
    from aosx.gvd.graph import build_gvd_graph, merge_seeds
    from aosx.gvd.voronoi import jump_flood
    from aosx.orchards import OrchardSpec, make_orchard_np
    from aosx.perceive import perceive
    from aosx.plan.astar import cost_matrix
    from aosx.plan.mission import build_waypoints, trim_distance_plane
    from aosx.types import GridWorld, PointCloud, Polygon, SeedSet

    s = _bench_statics(lowering)
    xyz, poly = make_orchard_np(OrchardSpec(**BENCH_SPEC), seed=0)
    buf = np.zeros((s.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(s.max_points, bool)
    valid[:len(xyz)] = True
    pc = PointCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid))
    polygon = Polygon.from_array(poly, s)
    params = params_as_f32(AosParams())
    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    # make_bench_reference.py's stage_full, returning the flood's inputs too
    @jax.jit
    def stage_full(pc, poly, params, excl):
        out = perceive(pc, poly, params, excl, s, ror_method="sorted")
        g = build_gvd_graph(out.seeds, out.rows_sorted, out.skeleton, params, s)
        cm = cost_matrix(g, s)
        wp = build_waypoints(g, params, s)
        world = engine.World(skeleton=out.skeleton, occupancy=out.occupancy, graph=g,
                             costmat=cm, waypoints=wp,
                             guards=out.guards | g.guards | cm.guards,
                             trim_skel=trim_distance_plane(out.skeleton, s))
        _, metrics = engine.step(engine.initial_state(world, s), world, params, s)
        merged = merge_seeds(out.seeds, params, s)
        owner = jump_flood(out.skeleton, merged, s)
        return out.skeleton, merged, metrics["plan_len"], owner

    skel, merged, _, owner = jax.block_until_ready(stage_full(pc, polygon, params, excl))
    ref = np.load(REF_OWNER)["owner"]
    print(f"stage_full again ({lowering} lowering): {int((np.asarray(owner) != ref).sum())} "
          f"cells differ from the reference owner plane", flush=True)
    grid = GridWorld(skel.occ, skel.origin_x, skel.origin_y, skel.h_cells, skel.w_cells)
    seeds = SeedSet(merged.xy, merged.valid, merged.kind)
    alone = jax.block_until_ready(jax.jit(lambda g, se: jump_flood(g, se, s))(grid, seeds))
    print(f"jump_flood jitted alone: {int((np.asarray(alone) != ref).sum())} cells differ",
          flush=True)
    if lowering != "dynamic":
        inp = np.load(FLOOD_IN)
        same = all(np.array_equal(np.asarray(a), inp[k]) for a, k in (
            (skel.occ, "occ"), (merged.xy, "seeds_xy"), (merged.valid, "seeds_valid")))
        print(f"flood inputs equal the saved ones: {same}", flush=True)
        planes = dict(owner_stage=np.asarray(owner), owner_alone=np.asarray(alone))
        if lowering == "pallas":
            planes.update(pallas_chain(grid, seeds, s))
        out = JAX_PASSES.with_name(f"bench_{lowering}.npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, **planes)
        return
    with jax.disable_jit():
        eager = np.asarray(jump_flood(grid, seeds, s))
    print(f"jump_flood op by op: {int((eager != ref).sum())} cells differ", flush=True)
    np.savez_compressed(
        FLOOD_IN, occ=np.asarray(skel.occ), origin=np.array(
            [np.asarray(skel.origin_x), np.asarray(skel.origin_y)], np.float32),
        cells=np.array([int(skel.h_cells), int(skel.w_cells)], np.int32),
        seeds_xy=np.asarray(merged.xy), seeds_valid=np.asarray(merged.valid),
        resolution=np.float32(s.resolution), owner_stage=np.asarray(owner),
        owner_alone=np.asarray(alone), owner_eager=eager)


def _statics_name(inp):
    return str(inp["statics"]) if "statics" in inp else "BENCH_STATICS"


def jax_passes(world=None):
    """JAX's jitted dynamic-shift flood stopped after m passes, m = 1..all."""
    import jax
    import jax.numpy as jnp

    import aosx.config
    from aosx.gvd.voronoi import _jfa_init, _passes, jacobi_fold
    from aosx.types import GridWorld, SeedSet

    flood_in, passes_out = _files(world)
    inp = dict(np.load(flood_in))
    s = getattr(aosx.config, _statics_name(inp))
    grid = GridWorld(jnp.asarray(inp["occ"]), jnp.float32(inp["origin"][0]),
                     jnp.float32(inp["origin"][1]), jnp.int32(inp["cells"][0]),
                     jnp.int32(inp["cells"][1]))
    S = len(inp["seeds_xy"])
    seeds = SeedSet(jnp.asarray(inp["seeds_xy"]), jnp.asarray(inp["seeds_valid"]),
                    jnp.zeros((S,), jnp.int8))
    passes = _passes(s)

    def flood(grid, seeds, m):
        # aosx.gvd.voronoi.jump_flood's dynamic-shift branch over passes[:m]
        h, w = grid.occ.shape
        res = jnp.float32(s.resolution)
        iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        cellx = grid.origin_x + ix.astype(jnp.float32) * res
        celly = grid.origin_y + iy.astype(jnp.float32) * res
        steps = jnp.asarray(passes[:m], jnp.int32)

        def dyn_shift(a, dy, dx, fill):
            out = jnp.roll(a, (dy, dx), axis=(0, 1))
            bad = (iy - dy < 0) | (iy - dy >= h) | (ix - dx < 0) | (ix - dx >= w)
            return jnp.where(bad, fill, out)

        def body(k, state):
            step = steps[k]
            o0, x0, y0 = state
            nb = [(dyn_shift(o0, dys * step, dxs * step, jnp.int32(S)),
                   dyn_shift(x0, dys * step, dxs * step, jnp.float32(1e9)),
                   dyn_shift(y0, dys * step, dxs * step, jnp.float32(1e9)))
                  for dys in (-1, 0, 1) for dxs in (-1, 0, 1) if dys or dxs]
            return jacobi_fold(o0, x0, y0, nb, S, cellx, celly)

        state = jax.lax.fori_loop(0, m, body, _jfa_init(grid, seeds, s), unroll=m)
        return state[0]

    out = {}
    for m in range(1, len(passes) + 1):
        out[f"m{m}"] = np.asarray(jax.jit(lambda g, se: flood(g, se, m))(grid, seeds))
        print(f"passes[:{m}] done", flush=True)
    passes_out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(passes_out, **out)


# ---------------------------------------------------------------------------
# the port's flood under several roundings
# ---------------------------------------------------------------------------

VARIANTS = {
    # name: (cell coordinates fused, d2 form)
    "one_fold": (True, "fma_dx"),   # fma(ix, res, origin); fma(dx, dx, dy * dy)
    "fma_dy": (True, "fma_dy"),     # fma(dy, dy, dx * dx)
    "d2_unfused": (True, "plain"),  # dx * dx + dy * dy, rounded op by op
    "coords_unfused": (False, "fma_dx"),
    "unfused": (False, "plain"),
}


def _d2(form, dx, dy):
    from aosx_torch.ops import fma

    if form == "fma_dx":
        return fma(dx, dx, dy * dy)
    if form == "fma_dy":
        return fma(dy, dy, dx * dx)
    return dx * dx + dy * dy


def _coords(shape, origin, res, fused):
    import torch

    from aosx_torch.gvd.jfa_pass_cuda import cell_coords

    if fused:
        return cell_coords(shape, float(origin[0]), float(origin[1]), float(res),
                           torch.device("cpu"))
    h, w = shape
    r = torch.tensor(res)
    cx = torch.tensor(origin[0]) + torch.arange(w, dtype=torch.float32)[None, :] * r
    cy = torch.tensor(origin[1]) + torch.arange(h, dtype=torch.float32)[:, None] * r
    return cx.expand(h, w), cy.expand(h, w)


def _candidates(o, x, y, step, S):
    from aosx_torch.perceive.raster import shift2d

    out = [(o, x, y)]
    for dys in (-1, 0, 1):
        for dxs in (-1, 0, 1):
            if dys or dxs:
                out.append((shift2d(o, dys * step, dxs * step, S),
                            shift2d(x, dys * step, dxs * step, 1e9),
                            shift2d(y, dys * step, dxs * step, 1e9)))
    return out


def flood(inp, variant, watch=(), states=None):
    """The port's Jacobi flood of the saved inputs under ``variant``. Returns
    (owner plane masked as jump_flood masks it, trace): trace[cell] lists per
    pass the candidates (owner, {variant: d2 f32}, d2 f64) at that cell."""
    import torch

    import aosx_torch.config
    from aosx_torch.gvd.voronoi import _jfa_init, _passes
    from aosx_torch.types import GridWorld, SeedSet

    s = getattr(aosx_torch.config, _statics_name(inp))
    fused, form = VARIANTS[variant]
    occ = torch.from_numpy(inp["occ"])
    origin, res = inp["origin"], inp["resolution"]
    h_cells, w_cells = (torch.tensor(int(v), dtype=torch.int32) for v in inp["cells"])
    grid = GridWorld(occ, torch.tensor(origin[0]), torch.tensor(origin[1]), h_cells, w_cells)
    sxy = torch.from_numpy(inp["seeds_xy"])
    seeds = SeedSet(sxy, torch.from_numpy(inp["seeds_valid"]),
                    torch.zeros(len(sxy), dtype=torch.int8))
    S = len(sxy)
    owner, table = _jfa_init(grid, seeds, s)
    pos = table[owner.long()]
    o, x, y = owner, pos[..., 0].contiguous(), pos[..., 1].contiguous()
    cellx, celly = _coords(occ.shape, origin, res, fused)
    all_coords = {v: _coords(occ.shape, origin, res, f) for v, (f, _) in VARIANTS.items()}
    inf = torch.tensor(3.4e38)
    trace = {c: [] for c in watch}
    for step in _passes(s):
        cands = _candidates(o, x, y, step, S)
        for (cy_, cx_) in watch:
            rows = []
            for no, nx, ny in cands:
                k = int(no[cy_, cx_])
                if k >= S:
                    continue
                px, py = nx[cy_, cx_], ny[cy_, cx_]
                d32 = {}
                for v, (f, fm) in VARIANTS.items():
                    ccx, ccy = all_coords[v]
                    d32[v] = float(_d2(fm, (px - ccx[cy_, cx_])[None], (py - ccy[cy_, cx_])[None])[0])
                gx = float(origin[0]) + (cx_ * float(np.float32(res)))
                gy = float(origin[1]) + (cy_ * float(np.float32(res)))
                d64 = (float(px) - gx) ** 2 + (float(py) - gy) ** 2
                rows.append((k, d32, d64))
            trace[(cy_, cx_)].append((step, sorted(set((r[0], tuple(r[1].items()), r[2])
                                                     for r in rows))))
        d2 = torch.where(o < S, _d2(form, x - cellx, y - celly), inf)
        no_, nx_, ny_ = o, x, y
        for co, cx2, cy2 in cands[1:]:
            nd = torch.where(co < S, _d2(form, cx2 - cellx, cy2 - celly), inf)
            better = (nd < d2) | ((nd == d2) & (co < no_))
            no_ = torch.where(better, co, no_)
            nx_ = torch.where(better, cx2, nx_)
            ny_ = torch.where(better, cy2, ny_)
            d2 = torch.where(better, nd, d2)
        o, x, y = no_, nx_, ny_
        if states is not None:
            states.append(o.numpy().copy())
    iy = torch.arange(occ.shape[0])[:, None]
    ix = torch.arange(occ.shape[1])[None, :]
    live = (iy < h_cells) & (ix < w_cells)
    return torch.where(live & (o < S), o, -1).numpy(), trace


# cells whose per-pass candidates analyse prints
TRACED = 8


def _port_grid(inp):
    """(GridWorld, SeedSet) of the port for the saved inputs."""
    import torch

    from aosx_torch.types import GridWorld, SeedSet

    origin = inp["origin"]
    h_cells, w_cells = (torch.tensor(int(v), dtype=torch.int32) for v in inp["cells"])
    grid = GridWorld(torch.from_numpy(inp["occ"]), torch.tensor(origin[0]),
                     torch.tensor(origin[1]), h_cells, w_cells)
    sxy = torch.from_numpy(inp["seeds_xy"])
    return grid, SeedSet(sxy, torch.from_numpy(inp["seeds_valid"]),
                         torch.zeros(len(sxy), dtype=torch.int8))


def _port_jump_flood(inp):
    """The port's own jump_flood (the plain Jacobi fold on the CPU) of the
    saved inputs."""
    import aosx_torch.config
    from aosx_torch.gvd.voronoi import jump_flood

    return jump_flood(*_port_grid(inp),
                      getattr(aosx_torch.config, _statics_name(inp))).numpy()


def analyse(world=None):
    import torch

    torch.set_num_threads(4)
    flood_in, passes_in = _files(world)
    inp = dict(np.load(flood_in))
    planes = _owner_planes(inp, world)
    ref_name = next(iter(planes))
    ref = planes[ref_name]
    for a, pa in planes.items():
        for b, pb in planes.items():
            if a < b:
                print(f"JAX {a} vs JAX {b}: {int((pa != pb).sum())} cells differ")
    own = _port_jump_flood(inp)
    print("the port's jump_flood (three planes carried) vs JAX's planes: " + json.dumps(
        {a: int((own != pa).sum()) for a, pa in planes.items()}), flush=True)
    # the one-fold floods below carry a position with its owner (x and y
    # selected by the owner plane's fold): where they part from the reference
    port, _ = flood(inp, "one_fold")
    print(f"the port's jump_flood vs a one-fold flood: {int((own != port).sum())} "
          "cells differ", flush=True)
    cells = [tuple(int(v) for v in c) for c in np.argwhere(port != ref)]
    summary = {}
    for v in VARIANTS:
        got = port if v == "one_fold" else flood(inp, v)[0]
        summary[v] = {a: int((got != pa).sum()) for a, pa in planes.items()}
        print(f"port flood, {v}: cells differing from " + json.dumps(summary[v]), flush=True)
    print(f"cells where the one-fold flood differs from the reference: {len(cells)}, "
          f"the first {cells[:TRACED]}")
    # f64 squared distance from a cell's corner to each plane's owner there
    xy, org = inp["seeds_xy"].astype(np.float64), inp["origin"].astype(np.float64)
    res = float(np.float32(inp["resolution"]))

    def d2_64(c, k):
        return float(((xy[k] - (org + np.array([c[1], c[0]]) * res)) ** 2).sum())

    gaps = [d2_64(c, ref[c]) - d2_64(c, port[c]) for c in cells]
    if gaps:
        print(f"at those cells the reference's owner lies farther than the one-fold "
              f"flood's (f64 d2, "
              f"m^2): {sum(g > 0 for g in gaps)} of {len(gaps)} cells, by "
              f"{min(gaps)!r} to {max(gaps)!r}")
    _, trace = flood(inp, "one_fold", watch=cells[:TRACED])
    for c in cells[:TRACED]:
        print(f"\ncell (row, col) {c}: port {port[c]} (f64 d2 {d2_64(c, port[c])!r}), "
              + ", ".join(f"{a} {pa[c]} ({d2_64(c, pa[c])!r})" for a, pa in planes.items()))
        for step, rows in trace[c]:
            print(f"  pass step {step}:")
            for k, d32, d64 in rows:
                vals = " ".join(f"{v}={d!r}" for v, d in d32)
                print(f"    owner {k}: f64 {d64!r}  f32 {vals}")
    if passes_in.exists():
        jp = np.load(passes_in)
        print("\nJAX's jitted flood stopped after m passes against the port's state after m "
              "passes, cells that differ under each rounding:")
        for v in VARIANTS:
            states = []
            flood(inp, v, states=states)
            counts = [int((jp[f"m{m}"] != st).sum()) for m, st in enumerate(states, 1)]
            print(f"  {v}: {counts}", flush=True)
            if v == "one_fold":
                port_states = states
        # a step-1 pass moves an owner at most one cell from its seed's cell
        xy, org = inp["seeds_xy"], inp["origin"]
        res = np.float32(inp["resolution"])
        print("after the first pass (step 1), where JAX's jitted state differs:")
        for r, c in np.argwhere(jp["m1"] != port_states[0])[:8]:
            for who, k in (("JAX", jp["m1"][r, c]), ("one-fold", port_states[0][r, c])):
                if k < len(xy):
                    cell = (int(np.floor((xy[k, 1] - org[1]) / res)),
                            int(np.floor((xy[k, 0] - org[0]) / res)))
                    print(f"  cell {(int(r), int(c))}: {who} owner {int(k)}, whose seed lies "
                          f"in cell {cell}")
    return summary


def _owner_only(voronoi):
    """voronoi.ROUNDINGS with each key's x and y planes folded as its owner
    plane: every cell's position stays its owner's seed."""
    return {k: (v[0],) * 3 for k, v in voronoi.ROUNDINGS.items()}


def analyse_pallas():
    """``analyse`` in the Pallas lowering (module docstring)."""
    import torch

    from aosx_torch.config import BENCH_STATICS
    from aosx_torch.gvd import jfa_pass_cuda, voronoi

    torch.set_num_threads(4)
    inp = dict(np.load(FLOOD_IN))
    jp = np.load(PALLAS_PLANES)
    xy = inp["seeds_xy"]
    S = len(xy)
    table = np.concatenate([xy, [[1e9, 1e9]]]).astype(np.float32)
    steps = voronoi._passes(BENCH_STATICS)
    rounding = voronoi.pass_roundings(BENCH_STATICS, steps)
    org = (float(inp["origin"][0]), float(inp["origin"][1]), BENCH_STATICS.resolution)

    print("each pass from JAX's state (a jit a pass, its three planes returned): cells where "
          "the port's owner / x / y planes differ from JAX's")
    for m, (step, r) in enumerate(zip(steps, rounding)):
        before = tuple(torch.from_numpy(np.array(jp[f"{k}{m}"])) for k in "oxy")
        after = [jp[f"{k}{m + 1}"] for k in "oxy"]
        # a pass that returns its planes rounds its owner plane as "pallas"
        r_pass = "pallas" if r == "pallas_last" else r
        got = jfa_pass_cuda.jfa_pass_plain(*before, step, S, *org, r_pass)
        print(f"  pass {m} (step {step}, {r_pass}): "
              + " / ".join(str(int((g.numpy() != a).sum())) for g, a in zip(got, after)))
        own = table[np.minimum(after[0], S)]
        apart = (after[0] < S) & ((after[1] != own[..., 0]) | (after[2] != own[..., 1]))
        for c in np.argwhere(apart):
            c = tuple(int(v) for v in c)
            k = int(after[0][c])
            sx = np.flatnonzero(xy[:, 0] == after[1][c])[:3].tolist()
            sy = np.flatnonzero(xy[:, 1] == after[2][c])[:3].tolist()
            print(f"    cell {c}: owner {k} at {table[k].tolist()}, position "
                  f"({float(after[1][c])!r}, {float(after[2][c])!r}): x of seeds {sx}, y of "
                  f"seeds {sy}")

    ref = np.load(REF_OWNER)["owner"]
    port = _port_jump_flood(inp)
    print(f"the port's jump_flood vs the reference: {int((port != ref).sum())} cells differ; vs "
          f"jump_flood jitted alone: {int((port != jp['owner_alone']).sum())}")
    # for contrast, a flood that keeps every cell's position its owner's seed
    saved = dict(voronoi.ROUNDINGS)
    try:
        voronoi.ROUNDINGS.update(_owner_only(voronoi))
        single = _port_jump_flood(inp)
    finally:
        voronoi.ROUNDINGS.update(saved)
    cells = [tuple(int(v) for v in c) for c in np.argwhere(single != ref)]
    print(f"a flood whose positions stay their owners' seeds vs the reference: {len(cells)} "
          f"cells differ: {cells}")
    org64 = inp["origin"].astype(np.float64)
    res = float(np.float32(BENCH_STATICS.resolution))
    for c in cells:
        corner = org64 + np.array([c[1], c[0]]) * res
        d = {k: float(((xy[k].astype(np.float64) - corner) ** 2).sum())
             for k in (ref[c], single[c])}
        print(f"  cell {c}: reference {ref[c]} (f64 d2 {d[ref[c]]!r}), owner-only flood "
              f"{single[c]} ({d[single[c]]!r}): the reference's lies "
              f"{d[ref[c]] - d[single[c]]!r} m^2 farther")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="analyse", choices=("make", "passes", "analyse"))
    ap.add_argument("--world", type=int, default=None,
                    help="a Monte-Carlo world of make_mc_reference.py in place of the bench orchard")
    ap.add_argument("--lowering", choices=LOWERINGS, default="pallas",
                    help="the JAX lowering of the bench flood (the reference's: pallas)")
    a = ap.parse_args()
    if a.world is None and a.mode == "make":
        make(None, a.lowering)
    elif a.world is None and a.mode == "analyse" and a.lowering == "pallas":
        analyse_pallas()
    elif a.world is None and a.mode == "passes" and a.lowering != "dynamic":
        raise SystemExit("passes: the dynamic lowering's; make saves the Pallas lowering's passes")
    else:
        {"make": make, "passes": jax_passes, "analyse": analyse}[a.mode](a.world)
