"""The world axis of the Monte-Carlo begin (``parallel/batch.py``): a group
of worlds built in one call, as ``aosx`` builds it under ``jax.vmap``.

Inputs: four TEST_STATICS clouds whose lanes part ways, from numpy seeds
(``make_orchard_np``): the test orchard; a 4 x 14 m orchard whose skeleton
holds more horizontal runs than ``max_ccl_runs`` (lowered to 120 here), so
that it alone takes the exact cell-level union-find (exact_fallbacks=True);
a cloud of isolated noise points, which the ROR filter empties (no row, no
seed, no graph); and the curved orchard without a polygon (the clipping
bounds instead).

- ``prepare_world`` over the group equals the port's unbatched call on each
  world, every leaf bitwise, through the sorted ROR, and through K3's plain
  version (``ror_method="pallas"``) on the first two worlds.
- The group equals jitted ``jax.vmap(aosx.engine.prepare_world)`` leaf for
  leaf, bitwise, with no bound. ``jax.vmap`` changes the fusion context in
  which XLA:CPU contracts multiply-adds; on this group that moves no bit of
  the reference, which ``test_vmap_reference_equals_its_unbatched_build``
  shows by holding JAX's vmapped build against its own unbatched one. (The
  polygon-less world is the one that showed two rounding sites of the port
  where XLA:CPU's jitted build differs from an op-by-op one: the virtual
  seed rays' hit point, which XLA fuses into a multiply-add, and the
  crossing test's division by the constant resolution, which it makes a
  product with the reciprocal; the port now rounds both as XLA does.)
- The plain batched kernels against ``jax.vmap`` of the JAX functions and of
  the Pallas kernels in interpret mode, bitwise: K1's flood
  (``jump_flood``), K2's thinning with per-world iteration counts that
  differ (one world capped at ``skeleton_max_iters``), K3's all-pairs
  counts.
- ``make_orchard`` over keys [G, 2] equals ``jax.vmap`` of the JAX
  generator and the per-key draws.
- One call a group: a group's build calls ``perceive`` and the plain K1 and
  K2 versions once, not once a world.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import (DRYRUN_STATICS as JDS, TEST_STATICS as JTS, AosParams as JParams,
                         params_as_f32 as jparams)
from aosx.types import GridWorld as JGrid, PointCloud as JCloud, Polygon as JPolygon
from aosx.types import SeedSet as JSeeds
from aosx_torch import engine, prng, tree
from aosx_torch.config import DRYRUN_STATICS, TEST_STATICS, AosParams, params_as_f32
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.guards import GUARD_CCL_CELL_FALLBACK
from aosx_torch.orchards import OrchardSpec, make_orchard, make_orchard_np
from aosx_torch.parallel import batch
from aosx_torch.perceive import ror_cuda, skeleton_cuda
from aosx_torch.types import GridWorld, PointCloud, Polygon, SeedSet
from torch_helpers import WORLD_SPECS, assert_same, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RUNS = 120
S = dataclasses.replace(TEST_STATICS, max_ccl_runs=RUNS)
JS = dataclasses.replace(JTS, max_ccl_runs=RUNS)


def _clouds():
    """(xyz [N, 3], polygon [k, 2]) of the four lanes (module docstring)."""
    test = make_orchard_np(WORLD_SPECS["test"], seed=0)
    runs = make_orchard_np(WORLD_SPECS["4x14"], seed=1)
    noise = make_orchard_np(WORLD_SPECS["test"], seed=2)
    noise = (noise[0][-WORLD_SPECS["test"].noise_pts:], noise[1])
    curved = make_orchard_np(WORLD_SPECS["curved"], seed=3)
    return [test, runs, noise, (curved[0], np.zeros((0, 2)))]


def _buffers(clouds, s):
    """Padded numpy buffers: xyz [G, N, 3], valid [G, N], polygon pts
    [G, P, 2] and counts [G]."""
    xyz = np.zeros((len(clouds), s.max_points, 3), np.float32)
    valid = np.zeros((len(clouds), s.max_points), bool)
    pts = np.zeros((len(clouds), s.max_poly, 2), np.float32)
    count = np.zeros(len(clouds), np.int32)
    for i, (c, poly) in enumerate(clouds):
        xyz[i, :len(c)] = c
        valid[i, :len(c)] = True
        pts[i, :len(poly)] = poly
        count[i] = len(poly)
    return xyz, valid, pts, count


@pytest.fixture(scope="module")
def params():
    return params_as_f32(AosParams(), CPU)


@pytest.fixture(scope="module")
def group():
    """The group's inputs on the CPU: (PointCloud [G], Polygon [G], the
    single orchards)."""
    clouds = _clouds()
    xyz, valid, pts, count = _buffers(clouds, S)
    pc = PointCloud(xyz=torch.from_numpy(xyz), valid=torch.from_numpy(valid))
    poly = Polygon(pts=torch.from_numpy(pts), count=torch.from_numpy(count))
    singles = [batch.cloud_tensors(c, S, CPU) for c in clouds]
    return pc, poly, singles


@pytest.fixture(scope="module")
def built(group, params):
    """The port's group world (one call, sorted ROR), and the calls it made
    of ``perceive`` and of the plain K1 and K2 versions."""
    calls = {"perceive": 0, "jfa_flood_plain": 0, "zhang_suen_fixpoint_plain": 0}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((engine, "perceive"), (jfa_pass_cuda, "jfa_flood_plain"),
                          (skeleton_cuda, "zhang_suen_fixpoint_plain")):
            def wrapper(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)
            mp.setattr(mod, name, wrapper)
        pc, poly, _ = group
        world = engine.prepare_world(pc, poly, params, torch.zeros((S.max_exclusions, 3)), S)
    return world, calls


def bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def assert_bitwise(ref, got):
    ra, ga = tree.leaves(ref), tree.leaves(got)
    assert len(ra) == len(ga)
    for a, b in zip(ra, ga):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# the group build against the port's unbatched build
# ---------------------------------------------------------------------------


def test_group_world_equals_unbatched_worlds(group, built, params):
    pc, poly, singles = group
    built, _ = built
    assert_bitwise(batch.looped_worlds(singles, params, S, "sorted"), built)
    # the lanes part ways: the exact union-find fallback taken by some worlds
    # and not by others, an empty world, worlds with and without a polygon
    fallback = ((built.guards & GUARD_CCL_CELL_FALLBACK) != 0).tolist()
    assert not fallback[0] and fallback[1]
    counts = built.waypoints.count.tolist()
    assert counts[2] == 0 and min(counts[0], counts[1], counts[3]) >= 4
    assert int(built.graph.num_nodes[2]) == 0 and int(built.graph.num_nodes[3]) > 0
    assert poly.count.tolist()[3] == 0


def test_group_world_through_k3_equals_unbatched_worlds(group, params):
    """ror_method="pallas" (K3's plain version on the CPU) over the first two
    worlds, one of which takes the fallback."""
    pc, poly, singles = group
    two = tree.lane((pc, poly), slice(0, 2))
    world = engine.prepare_world(*two, params, torch.zeros((S.max_exclusions, 3)), S,
                                 ror_method="pallas")
    assert_bitwise(batch.looped_worlds(singles[:2], params, S, "pallas"), world)


# ---------------------------------------------------------------------------
# against jax.vmap of the JAX package's build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_worlds():
    """The group through jitted jax.vmap(aosx.engine.prepare_world), and the
    first world through JAX's unbatched build."""
    xyz, valid, pts, count = (jnp.asarray(a) for a in _buffers(_clouds(), JS))
    jp = jparams(JParams())
    excl = jnp.zeros((JS.max_exclusions, 3), jnp.float32)

    def one(x, v, p, c):
        return jengine.prepare_world(JCloud(xyz=x, valid=v), JPolygon(pts=p, count=c), jp,
                                     excl, JS)

    vmapped = jax.jit(jax.vmap(one))(xyz, valid, pts, count)
    return vmapped, jax.jit(one)(xyz[1], valid[1], pts[1], count[1])


def test_group_world_matches_jax_vmap(jax_worlds, built):
    assert_same(jax_worlds[0], built[0])


def test_vmap_reference_equals_its_unbatched_build(jax_worlds):
    """The reference's vmapped rounding: JAX's vmapped build of the lane
    that takes the fallback equals JAX's unbatched build of it, bitwise."""
    vmapped, single = jax_worlds
    assert_same(single, jax.tree_util.tree_map(lambda a: a[1], vmapped))


# ---------------------------------------------------------------------------
# the kernels' plain batched versions against jax.vmap
# ---------------------------------------------------------------------------


def _seeds(s, G):
    """G seed sets of 40, 25 and 3 random valid seeds, and a grid origin
    per world."""
    rng = np.random.default_rng(3)
    xy = np.zeros((G, s.max_seeds, 2), np.float32)
    valid = np.zeros((G, s.max_seeds), bool)
    for g, n in enumerate((40, 25, 3)[:G]):
        xy[g, :n, 0] = rng.uniform(0.2, s.grid_w * s.resolution - 0.2, n)
        xy[g, :n, 1] = rng.uniform(0.2, s.grid_h * s.resolution - 0.2, n)
        valid[g, :n] = True
    origin = np.array([[0.0, 0.0], [-1.25, 3.5], [40.0, -7.75]], np.float32)[:G]
    xy += origin[:, None, :]
    live = np.array([[s.grid_h, s.grid_w], [s.grid_h - 9, s.grid_w - 30], [57, 101]],
                    np.int32)[:G]
    return xy, valid, origin, live


def test_k1_flood_batched_matches_jax_vmap():
    """K1's plain batched flood (three worlds of their own origin, live
    bounds and seeds) == jax.vmap of aosx's jump_flood, both through XLA's
    passes and through the Pallas pass kernel in interpret mode, and == the
    port's flood of each world alone."""
    from aosx.gvd import jfa_pass_pallas as jpp
    from aosx.gvd.voronoi import jump_flood

    s = DRYRUN_STATICS
    G = 3
    xy, valid, origin, live = _seeds(s, G)

    def jflood(js):
        def one(o, lv, sxy, sv):
            grid = JGrid(occ=jnp.zeros((js.grid_h, js.grid_w), jnp.uint8), origin_x=o[0],
                         origin_y=o[1], h_cells=lv[0], w_cells=lv[1])
            return jump_flood(grid, JSeeds(xy=sxy, valid=sv, kind=jnp.zeros(js.max_seeds,
                                                                             jnp.int8)), js)
        return np.asarray(jax.vmap(one)(jnp.asarray(origin), jnp.asarray(live),
                                        jnp.asarray(xy), jnp.asarray(valid)))

    ref = jflood(JDS)
    jpp.INTERPRET = True
    try:
        ref_pallas = jflood(dataclasses.replace(JDS, jfa_pass_pallas=True,
                                                jfa_dynamic_shifts=False))
    finally:
        jpp.INTERPRET = False

    def port(sl):
        o, lv = torch.from_numpy(origin[sl]), torch.from_numpy(live[sl])
        grid = GridWorld(occ=torch.zeros(o.shape[:-1] + (s.grid_h, s.grid_w), dtype=torch.uint8),
                         origin_x=o[..., 0], origin_y=o[..., 1], h_cells=lv[..., 0],
                         w_cells=lv[..., 1])
        seeds = SeedSet(xy=torch.from_numpy(xy[sl]), valid=torch.from_numpy(valid[sl]),
                        kind=torch.zeros(valid[sl].shape, dtype=torch.int8))
        return voronoi.jump_flood(grid, seeds, s).numpy()

    got = port(slice(None))
    assert np.array_equal(ref, got) and np.array_equal(ref_pallas, got)
    for g in range(G):
        assert np.array_equal(port(g), got[g])
    assert (got[0] >= 0).all() and (got[2] == -1).any()


def _k2_masks(s):
    """Three planes whose thinnings take different numbers of iterations:
    thin blobs, 12-cell bars, and 40-cell bars that a cap of 8 stops."""
    from torch_helpers import blobby_mask

    h, w = s.grid_h, s.grid_w
    out = np.zeros((3, h, w), np.uint8)
    out[0] = blobby_mask(h, w, seed=7)
    out[1, 20:32, 10:w - 10] = 1
    out[1, 60:140, 100:112] = 1
    out[2, 30:70, 20:w - 20] = 1
    out[2, 100:180, 60:100] = 1
    live = np.array([[h, w], [h - 5, w - 17], [190, 250]], np.int32)
    return out, live


def test_k2_thinning_batched_matches_jax_vmap():
    """K2's plain batched fixpoint: each world stops at its own fixpoint or
    at the cap, as jax.vmap of aosx's zhang_suen (and of its Pallas kernel
    in interpret mode) does; plane and per-world counts == the single-world
    calls."""
    from aosx.perceive.skeleton import zhang_suen
    from aosx.perceive.skeleton_pallas import zhang_suen_pallas

    s = dataclasses.replace(DRYRUN_STATICS, skeleton_max_iters=8)
    js = dataclasses.replace(JDS, skeleton_max_iters=8)
    masks, live = _k2_masks(s)

    def one(fn):
        def f(m, lv):
            g = JGrid(occ=m, origin_x=jnp.float32(0.0), origin_y=jnp.float32(0.0),
                      h_cells=lv[0], w_cells=lv[1])
            return fn(g, js).occ
        return np.asarray(jax.vmap(f)(jnp.asarray(masks), jnp.asarray(live)))

    ref = one(zhang_suen)
    ref_pallas = one(lambda g, js_: zhang_suen_pallas(g, js_, interpret=True))
    lv = torch.from_numpy(live)
    occ, its, last = skeleton_cuda.zhang_suen_fixpoint_plain(
        torch.from_numpy(masks), lv[:, 0], lv[:, 1], s.skeleton_max_iters)
    assert np.array_equal(ref, occ.numpy()) and np.array_equal(ref_pallas, occ.numpy())
    out, stats = skeleton_cuda.zhang_suen_fixpoint(torch.from_numpy(masks), lv[:, 0], lv[:, 1],
                                                   s.skeleton_max_iters)
    assert torch.equal(out, occ) and torch.equal(stats, torch.stack([its, last], -1))
    for g in range(3):
        o1, it1, ch1 = skeleton_cuda.zhang_suen_fixpoint_plain(
            torch.from_numpy(masks[g]), int(live[g, 0]), int(live[g, 1]), s.skeleton_max_iters)
        assert torch.equal(o1, occ[g]) and [it1, ch1] == [int(its[g]), int(last[g])]
    # the worlds stop at different iterations, the last one at the cap
    assert len(set(its.tolist())) == 3 and int(its[2]) == 8 and int(last[2]) > 0
    assert int(last[0]) == 0 and int(last[1]) == 0


def test_k3_counts_batched_matches_jax_vmap():
    """K3's plain batched counts (three clouds, each its own r2) == jax.vmap
    of aosx's Pallas kernel in interpret mode, and == each cloud alone."""
    from aosx.perceive.ror_pallas import ror_counts_pallas

    rng = np.random.default_rng(11)
    n = 2048
    xyz = np.stack([np.stack([rng.uniform(0, w, n), rng.uniform(0, 10, n),
                              rng.uniform(-0.3, 0.4, n)], 1)
                    for w in (30.0, 12.0, 190.0)]).astype(np.float32)
    xyz[2, :, 0] += 150.0
    r2 = (np.array([0.2, 0.3, 0.25], np.float32)) ** 2
    ref = np.asarray(jax.vmap(lambda x, r: ror_counts_pallas(x, r, interpret=True))(
        jnp.asarray(xyz), jnp.asarray(r2)))
    got = ror_cuda.ror_counts(torch.from_numpy(xyz), torch.from_numpy(r2))
    assert np.array_equal(ref, got.numpy())
    for g in range(3):
        assert torch.equal(ror_cuda.ror_counts_plain(torch.from_numpy(xyz[g]),
                                                     torch.tensor(r2[g])), got[g])
    assert len({float(m) for m in got.float().mean(-1)}) == 3


def test_make_orchard_over_keys_matches_jax_vmap():
    from aosx.orchards import OrchardSpec as JSpec, make_orchard as jmake

    spec = dataclasses.replace(WORLD_SPECS["curved"], dropout=0.1)
    jspec = JSpec(**dataclasses.asdict(spec))
    keys = prng.split(prng.prng_key(9, CPU), 3)
    pc, poly = make_orchard(keys, spec, S, CPU)
    jpc, jpoly = jax.jit(jax.vmap(lambda k: jmake(k, jspec, JS)))(
        jax.random.split(jax.random.PRNGKey(9), 3))
    assert_same((jpc, jpoly), (pc, poly))
    for g in range(3):
        assert_bitwise(make_orchard(keys[g], spec, S, CPU), tree.lane((pc, poly), g))


# ---------------------------------------------------------------------------
# one call a group
# ---------------------------------------------------------------------------


def test_group_build_is_one_call(built):
    world, calls = built
    assert calls == {"perceive": 1, "jfa_flood_plain": 1, "zhang_suen_fixpoint_plain": 1}
    assert world.graph.nodes.shape[0] == 4


def test_world_axis_refuses_a_mesh(group, params):
    from aosx_torch.parallel.spatial import Mesh

    pc, poly, _ = group
    with pytest.raises(ValueError, match="world axis"):
        engine.prepare_world(pc, poly, params, torch.zeros((S.max_exclusions, 3)), S,
                             stencil_mesh=Mesh((CPU, CPU)))


def test_uncached_group_begin_equals_per_key_begins(params):
    """rollout_begin over keys [G, 2] (the uncached group begin) equals the
    per-key begins, every leaf bitwise."""
    spec = OrchardSpec(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
                       trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
    keys = prng.split(prng.prng_key(5, CPU), 3)
    got = batch.rollout_begin(keys, spec, params, DRYRUN_STATICS, 60, ror_method="exact",
                              classify=True, device=CPU)
    want = [batch.rollout_begin(k, spec, params, DRYRUN_STATICS, 60, ror_method="exact",
                                classify=True, device=CPU) for k in keys]
    assert_bitwise(tree.stack(want), got)
