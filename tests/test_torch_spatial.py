"""Row-sharded stencils (``aosx_torch/parallel/spatial.py``) and the
``stencil_mesh=`` / ``mesh=`` entry points on a CPU mesh at DRYRUN_STATICS
(192 x 256: 48-row bands on four devices, 96 on two).

The inputs are those of tests/test_parallel.py (the JAX package's sharding
tests, which each case cites). Every comparison is bitwise: the banded
stages equal the port's single-device stages, the banded flood equals the
JAX package's ``jump_flood_sharded`` on conftest's CPU devices, and a world,
an incremental state, a serving state or a Monte-Carlo record made with a
mesh equals the one made without."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import DRYRUN_STATICS as JS
from aosx.parallel.spatial import jump_flood_sharded as jflood_sharded
from aosx.types import GridWorld as JGrid, SeedSet as JSeeds
from aosx_torch import engine, incremental, prng, serving, tree
from aosx_torch.config import DRYRUN_STATICS as S, AosParams, params_as_f32
from aosx_torch.gvd.voronoi import jump_flood
from aosx_torch.orchards import OrchardSpec, make_orchard
from aosx_torch.parallel import batch
from aosx_torch.parallel.spatial import (Mesh, inflate_sharded, jump_flood_sharded,
                                         skeletonize_sharded)
from aosx_torch.perceive.raster import inflate
from aosx_torch.perceive.skeleton import skeletonize
from aosx_torch.types import GridWorld, PointCloud, Polygon, SeedSet
from helpers import frames_growing
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SPEC = OrchardSpec(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
                   trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
# (bands, live rows cut, live columns cut): the JAX tests' live regions on 4
# and on 2 bands, and a live region that leaves the two lower bands dead
CASES = {"n4": (4, None), "n2": (2, None), "n4_small_live": (4, (60, 100))}


def mesh_of(n: int, axis: str = "space") -> Mesh:
    return Mesh((CPU,) * n, (axis,))


def _grid(occ, ox, oy, h_cells, w_cells):
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return GridWorld(torch.from_numpy(occ), torch.tensor(ox, dtype=torch.float32),
                     torch.tensor(oy, dtype=torch.float32), i32(h_cells), i32(w_cells))


def _live(case, dh, dw):
    small = CASES[case][1]
    return small if small else (S.grid_h - dh, S.grid_w - dw)


@pytest.mark.parametrize("case", CASES)
def test_inflate_sharded(case):
    """tests/test_parallel.py::test_spatial_sharded_inflation."""
    rng = np.random.default_rng(11)
    occ = (rng.random((S.grid_h, S.grid_w)) < 0.01).astype(np.uint8)
    grid = _grid(occ, 0.0, 0.0, *_live(case, 7, 13))
    got = inflate_sharded(grid, S, mesh_of(CASES[case][0]))
    assert torch.equal(inflate(grid, S).occ, got.occ)
    assert int(got.occ.sum()) > 0


@pytest.mark.parametrize("case", CASES)
def test_skeletonize_sharded(case):
    """tests/test_parallel.py::test_spatial_sharded_skeletonize: blobby
    occupancy, so that the thinning iterates."""
    rng = np.random.default_rng(13)
    occ = (rng.random((S.grid_h, S.grid_w)) < 0.18).astype(np.uint8)
    grid = _grid(occ, 0.0, 0.0, *_live(case, 5, 9))
    got = skeletonize_sharded(grid, S, mesh_of(CASES[case][0]))
    assert torch.equal(skeletonize(grid, S).occ, got.occ)


def test_skeletonize_sharded_stops_at_max_iters():
    """The loop ends at skeleton_max_iters, as JAX's while_loop does."""
    rng = np.random.default_rng(13)
    occ = (rng.random((S.grid_h, S.grid_w)) < 0.5).astype(np.uint8)
    grid = _grid(occ, 0.0, 0.0, S.grid_h, S.grid_w)
    s1 = dataclasses.replace(S, skeleton_max_iters=1)
    got = skeletonize_sharded(grid, s1, mesh_of(4))
    assert torch.equal(skeletonize(grid, s1).occ, got.occ)
    assert not torch.equal(skeletonize(grid, S).occ, got.occ)


def _flood_inputs(case):
    """tests/test_parallel.py::test_spatial_sharded_jump_flood's input: 64
    random seeds, one duplicated cell (the lower seed index wins)."""
    rng = np.random.default_rng(17)
    occ = (rng.random((S.grid_h, S.grid_w)) < 0.05).astype(np.uint8)
    h, w = _live(case, 11, 3)
    ns = 64
    xy = np.stack([-1.5 + rng.random(ns) * S.grid_w * S.resolution,
                   0.5 + rng.random(ns) * S.grid_h * S.resolution], axis=1).astype(np.float32)
    xy[1] = xy[0]
    valid = rng.random(ns) < 0.9
    return occ, (-1.5, 0.5, h, w), xy, valid


@pytest.mark.parametrize("case", CASES)
def test_jump_flood_sharded(case):
    """tests/test_parallel.py::test_spatial_sharded_jump_flood: pass offsets
    reach 128 rows against 48- or 96-row bands, so the moves over whole
    bands (q > 0) run."""
    occ, gs, xy, valid = _flood_inputs(case)
    grid = _grid(occ, *gs)
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(valid),
                    torch.zeros(len(xy), dtype=torch.int8))
    got = jump_flood_sharded(grid, seeds, S, mesh_of(CASES[case][0]))
    want = jump_flood(grid, seeds, S)
    assert torch.equal(want, got)
    assert int((got >= 0).sum()) == int(gs[2]) * int(gs[3])


def test_jump_flood_sharded_matches_jax():
    """The port's banded flood and JAX's ``jump_flood_sharded`` over four of
    conftest's CPU devices, on the same input: bitwise equal owners (JAX's
    band code writes the cell coordinates as origin + index * res, which
    XLA:CPU contracts as the port's fused multiply-add does)."""
    from jax.sharding import Mesh as JMesh

    occ, (ox, oy, h, w), xy, valid = _flood_inputs("n4")
    jgrid = JGrid(jnp.asarray(occ), jnp.float32(ox), jnp.float32(oy), jnp.int32(h),
                  jnp.int32(w))
    jseeds = JSeeds(jnp.asarray(xy), jnp.asarray(valid), jnp.zeros(len(xy), jnp.int8))
    jmesh = JMesh(np.array(jax.devices("cpu")[:4]), ("space",))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jax.jit(lambda g, se: jflood_sharded(g, se, JS, jmesh))(jgrid, jseeds))
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(valid),
                    torch.zeros(len(xy), dtype=torch.int8))
    got = jump_flood_sharded(_grid(occ, ox, oy, h, w), seeds, S, mesh_of(4))
    assert np.array_equal(want, got.numpy())


def test_mesh_shapes_are_checked():
    occ = np.zeros((S.grid_h, S.grid_w), np.uint8)
    grid = _grid(occ, 0.0, 0.0, S.grid_h, S.grid_w)
    with pytest.raises(AssertionError):   # H % n != 0
        inflate_sharded(grid, S, mesh_of(5))
    with pytest.raises(AssertionError):   # Hb = 12 <= inflation_cells = 16
        inflate_sharded(grid, S, mesh_of(16))
    with pytest.raises(AssertionError):   # Hb = 1 < 2
        skeletonize_sharded(grid, S, mesh_of(S.grid_h))
    with pytest.raises(AssertionError):
        Mesh((CPU, CPU), ("space", "data"))
    assert mesh_of(3, "data").shape == {"data": 3}


# ---------------------------------------------------------------------------
# the entry points with stencil_mesh=
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


def test_prepare_world_sharded_stencils(params):
    """tests/test_parallel.py::test_prepare_world_sharded_stencils: the world
    (and the PerceiveOut of prepare_world_full) with the stencils and the
    flood on four bands equals the single-device one, leaf for leaf."""
    pc, poly = make_orchard(prng.prng_key(2, CPU), SPEC, S, CPU)
    excl = torch.zeros((S.max_exclusions, 3), dtype=torch.float32)
    want = engine.prepare_world_full(pc, poly, params, excl, S, ror_method="exact")[:2]
    got = engine.prepare_world_full(pc, poly, params, excl, S, ror_method="exact",
                                    stencil_mesh=mesh_of(4))[:2]
    assert_same(want, got)
    assert int(want[0].graph.num_edges) > 0


@pytest.fixture(scope="module")
def growing():
    """tests/test_parallel.py::test_incremental_sharded_stencils' frames:
    0.55 and 1.0 of the test-spec orchard of seed 7, then the full map with
    one point moved (a from-scratch level)."""
    bufs, valids, poly = frames_growing([0.55, 1.0], S, seed=7, spec=SPEC)
    frames = [PointCloud(torch.from_numpy(b), torch.from_numpy(v)) for b, v in zip(bufs, valids)]
    moved = bufs[1].copy()
    moved[0, 0] += 0.01
    frames.append(PointCloud(torch.from_numpy(moved), torch.from_numpy(valids[1])))
    return frames, Polygon.from_array(poly.astype(np.float32), S, CPU)


def test_incremental_sharded_stencils(params, growing):
    """tests/test_parallel.py::test_incremental_sharded_stencils: init and
    updates with a mesh equal those without at every level, with the same
    levels, and the growth recomputes downstream."""
    frames, poly = growing
    excl = torch.zeros((S.max_exclusions, 3), dtype=torch.float32)
    mesh = mesh_of(4)
    st_r = incremental.perceive_init(frames[0], poly, params, excl, S)
    st_s = incremental.perceive_init(frames[0], poly, params, excl, S, stencil_mesh=mesh)
    assert_same(st_r, st_s)
    levels = []
    for pc in frames[1:]:
        st_r, lv_r = incremental.perceive_update(st_r, pc, poly, params, excl, S)
        st_s, lv_s = incremental.perceive_update(st_s, pc, poly, params, excl, S,
                                                 stencil_mesh=mesh)
        assert int(lv_r) == int(lv_s)
        assert_same(st_r, st_s)
        levels.append(int(lv_s))
    assert levels[0] >= incremental.LEVEL_REUSE_DOWNSTREAM
    assert levels[1] == incremental.LEVEL_FULL


def test_serving_sharded_stencils(params, growing):
    """serve_init and serve_map_frame with a 2-band mesh give the mesh-less
    serving states, leaf for leaf."""
    frames, poly = growing
    excl = torch.zeros((S.max_exclusions, 3), dtype=torch.float32)
    mesh = mesh_of(2)
    sv_r = serving.serve_init(frames[0], poly, params, excl, S)
    sv_s = serving.serve_init(frames[0], poly, params, excl, S, stencil_mesh=mesh)
    assert_same(sv_r, sv_s)
    sv_r, lv_r = serving.serve_map_frame(sv_r, frames[1], poly, params, excl, S)
    sv_s, lv_s = serving.serve_map_frame(sv_s, frames[1], poly, params, excl, S,
                                         stencil_mesh=mesh)
    assert int(lv_r) == int(lv_s) >= incremental.LEVEL_DOWNSTREAM
    assert_same(sv_r, sv_s)


# ---------------------------------------------------------------------------
# lanes over a mesh
# ---------------------------------------------------------------------------


def test_sharded_rollouts_match_batched(params):
    """tests/test_parallel.py::test_shard_map_matches_vmap: 4 rollouts over a
    2-device "data" mesh equal the batched rollouts, and total_done is their
    completed count."""
    keys = prng.split(prng.prng_key(7, CPU), 4)
    want = batch.batched_rollouts(keys, SPEC, params, S, 5, ror_method="exact", device=CPU)
    got, done = batch.sharded_rollouts(keys, SPEC, params, S, 5, mesh_of(2, "data"),
                                       ror_method="exact")
    assert_same(want, got)
    assert int(done) == int(want["completed"].sum())
    with pytest.raises(AssertionError):
        batch.sharded_rollouts(keys[:3], SPEC, params, S, 5, mesh_of(2, "data"))


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
def test_sustained_mesh_matches_single(params, cached):
    """sustained_rollouts(mesh=) with 2 lanes over 2 devices records every
    rollout as mesh=None does; the refills land in both blocks (lane 0, then
    lane 1)."""
    kw = dict(chunk_steps=20, refill=1, seed=5, ror_method="exact", cached=cached,
              classify=True, device=CPU)
    want, wstats = batch.sustained_rollouts(4, 2, SPEC, params, S, 20, **kw)
    got, stats = batch.sustained_rollouts(4, 2, SPEC, params, S, 20, mesh=mesh_of(2, "data"),
                                          **kw)
    assert_same(want, got)
    assert (stats["chunk_calls"], stats["begin_calls"]) == (wstats["chunk_calls"],
                                                             wstats["begin_calls"]) == (2, 4)
    with pytest.raises(AssertionError):
        batch.sustained_rollouts(4, 2, SPEC, params, S, 20, mesh=mesh_of(3, "data"), **kw)


def test_params_queue_over_mesh():
    """A swept queue's rows follow their lanes into both blocks."""
    rows = [dataclasses.replace(AosParams(), heuristic_weight=w) for w in (3.0, 1.0, 2.0, 1.5)]
    queue = tree.stack([params_as_f32(p, CPU) for p in rows])
    kw = dict(chunk_steps=20, refill=1, seed=1, ror_method="exact", cached=True, device=CPU,
              params_queue=queue)
    want, _ = batch.sustained_rollouts(4, 2, SPEC, None, S, 20, **kw)
    got, _ = batch.sustained_rollouts(4, 2, SPEC, None, S, 20, mesh=mesh_of(2, "data"), **kw)
    assert_same(want, got)
