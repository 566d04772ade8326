"""Kernels K1 (the Jacobi jump flood) and K2 (Zhang-Suen to the fixpoint).

On the CPU, the port's flood and thinning (which take each kernel's plain
PyTorch version there) are held bitwise against the JAX package's functions
and its Pallas kernels in interpret mode; K2's bit-sliced sub-iteration on
packed words is held against the byte stencil, and K1's owner-only flood
against the loop that carries the positions. Tolerance: none, everywhere.
The cases marked ``cuda`` hold each CUDA kernel bitwise against its plain
version on the card and skip elsewhere; they import no JAX, so they run on
a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from aosx_torch.config import DRYRUN_STATICS
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.perceive import skeleton, skeleton_cuda
from aosx_torch.types import GridWorld, SeedSet
from torch_helpers import blobby_mask, cuda_device, one_torch_thread  # noqa: F401

LIVE_REGIONS = [(192, 256), (184, 232)]


def _seeds_np(s, n=40, seed=3):
    """The 40-seed case of tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(seed)
    S = s.max_seeds
    xy = np.zeros((S, 2), np.float32)
    xy[:n, 0] = rng.uniform(0.2, s.grid_w * s.resolution - 0.2, n)
    xy[:n, 1] = rng.uniform(0.2, s.grid_h * s.resolution - 0.2, n)
    valid = np.zeros(S, bool)
    valid[:n] = True
    return xy, valid


def _grid(mask, live_h, live_w, device):
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return GridWorld(occ=torch.as_tensor(mask, device=device),
                     origin_x=torch.zeros((), **f32), origin_y=torch.zeros((), **f32),
                     h_cells=torch.tensor(live_h, **i32), w_cells=torch.tensor(live_w, **i32))


def _flood_port(s, device):
    xy, valid = _seeds_np(s)
    grid = _grid(np.zeros((s.grid_h, s.grid_w), np.uint8), s.grid_h, s.grid_w, device)
    seeds = SeedSet(xy=torch.from_numpy(xy).to(device), valid=torch.from_numpy(valid).to(device),
                    kind=torch.zeros(s.max_seeds, dtype=torch.int8, device=device))
    return voronoi.jump_flood(grid, seeds, s)


def test_jump_flood_matches_pallas_interpret():
    """Full flood: the port's passes (plain on the CPU) == aosx's banded
    Pallas pass kernel in interpret mode, bitwise. Steps 1..128 all run
    through the Pallas kernel (jfa_dynamic_shifts=False)."""
    import jax.numpy as jnp
    from aosx.config import DRYRUN_STATICS as JS
    from aosx.gvd import jfa_pass_pallas as jpp
    from aosx.gvd.voronoi import jump_flood
    from aosx.types import GridWorld as JGrid, SeedSet as JSeeds

    s_p = dataclasses.replace(JS, jfa_pass_pallas=True, jfa_dynamic_shifts=False)
    xy, valid = _seeds_np(s_p)
    grid = JGrid(occ=jnp.zeros((s_p.grid_h, s_p.grid_w), jnp.uint8),
                 origin_x=jnp.float32(0.0), origin_y=jnp.float32(0.0),
                 h_cells=jnp.int32(s_p.grid_h), w_cells=jnp.int32(s_p.grid_w))
    seeds = JSeeds(xy=jnp.asarray(xy), valid=jnp.asarray(valid),
                   kind=jnp.zeros(s_p.max_seeds, jnp.int8))
    jpp.INTERPRET = True
    try:
        ref = np.asarray(jump_flood(grid, seeds, s_p))
    finally:
        jpp.INTERPRET = False
    got = _flood_port(DRYRUN_STATICS, "cpu").numpy()
    assert (got >= 0).all()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("live_h,live_w", LIVE_REGIONS)
def test_zhang_suen_matches_pallas_interpret(live_h, live_w):
    """Thinning to fixpoint: the port (plain iteration on the CPU) ==
    aosx's banded Pallas kernel in interpret mode, bitwise, including live
    regions that are not a multiple of the band height."""
    import jax.numpy as jnp
    from aosx.config import DRYRUN_STATICS as JS
    from aosx.perceive.skeleton_pallas import zhang_suen_pallas
    from aosx.types import GridWorld as JGrid

    s = DRYRUN_STATICS
    mask = blobby_mask(s.grid_h, s.grid_w, seed=7, live_h=live_h, live_w=live_w)
    g = JGrid(occ=jnp.asarray(mask), origin_x=jnp.float32(0.0), origin_y=jnp.float32(0.0),
              h_cells=jnp.int32(live_h), w_cells=jnp.int32(live_w))
    ref = np.asarray(zhang_suen_pallas(g, JS, interpret=True).occ)
    got = skeleton.zhang_suen(_grid(mask, live_h, live_w, "cpu"), s).occ.numpy()
    assert np.array_equal(ref, got)
    assert (got != mask).any()


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    def counts():
        return (jfa_pass_cuda.jfa_flood.launches, jfa_pass_cuda.jfa_flood.passes,
                skeleton_cuda.zhang_suen_fixpoint.launches)

    n0 = counts()
    _flood_port(DRYRUN_STATICS, "cpu")
    s = DRYRUN_STATICS
    skeleton.zhang_suen(_grid(blobby_mask(s.grid_h, s.grid_w, 7), s.grid_h, s.grid_w, "cpu"), s)
    assert counts() == n0


# ---------------------------------------------------------------------------
# K2: the bit-sliced sub-iteration and the fixpoint loop, on the CPU
# ---------------------------------------------------------------------------


def _random_mask(h, w, seed, live_h, live_w, density=0.55):
    """Dense random cells inside the live region: every stencil case."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.uint8)
    out[:live_h, :live_w] = rng.random((live_h, live_w)) < density
    return out


def _bars_mask(h, w, live_h, live_w):
    """blobby_mask's blobs and thick bars (inflated tree rows) that reach the
    live region's last interior cells: some twenty iterations to thin."""
    out = blobby_mask(h, w, seed=7, live_h=live_h, live_w=live_w)
    out[live_h // 8:live_h // 3, live_w // 8:live_w - 1] = 1
    out[live_h // 2:live_h - 1, live_w // 4:live_w // 4 + live_w // 6] = 1
    out[live_h // 2:live_h // 2 + live_h // 5, live_w // 2:live_w - 3] = 1
    return out


def _thinning_input(kind, h, w, live_h, live_w):
    if kind == "blobby":
        return blobby_mask(h, w, seed=7, live_h=live_h, live_w=live_w)
    if kind == "bars":
        return _bars_mask(h, w, live_h, live_w)
    return _random_mask(h, w, 11, live_h, live_w)


# the buffer and its live region; the last: a width that is not a multiple of 32
BIT_SHAPES = [(192, 256, 192, 256), (192, 256, 184, 232), (40, 75, 37, 70)]


@pytest.mark.parametrize("shape", [(5, 32), (7, 75), (3, 1), (4, 256)])
def test_pack_rows_round_trip(shape):
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8))
    words = skeleton_cuda.pack_rows(occ)
    assert words.dtype == torch.int32 and words.shape == (shape[0], -(-shape[1] // 32))
    assert torch.equal(skeleton_cuda.unpack_rows(words, shape[1]), occ)
    # bit b of word j is cell 32 j + b; bits past the width are 0
    x = shape[1] - 1
    one = torch.zeros(shape, dtype=torch.uint8)
    one[0, x] = 1
    w0 = skeleton_cuda.pack_rows(one)
    assert int(w0[0, x // 32]) & 0xFFFFFFFF == 1 << (x % 32)
    assert int((w0 != 0).sum()) == 1


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("kind", ["random", "blobby"])
@pytest.mark.parametrize("h,w,live_h,live_w", BIT_SHAPES)
def test_subiter_bits_matches_byte_stencil(h, w, live_h, live_w, kind, phase):
    """The kernel's boolean circuit on packed words == _subiter on bytes."""
    occ = torch.from_numpy(_thinning_input(kind, h, w, live_h, live_w))
    interior = skeleton_cuda._interior(occ, live_h, live_w)
    ref = skeleton_cuda._subiter(occ, phase, interior)
    got = skeleton_cuda._subiter_bits_plain(
        skeleton_cuda.pack_rows(occ), phase, skeleton_cuda.pack_rows(interior.to(torch.uint8)))
    assert torch.equal(skeleton_cuda.unpack_rows(got, w), ref)
    assert (ref != occ).any()


def _jax_thinning(mask, live_h, live_w, max_iters):
    """aosx.perceive.skeleton.zhang_suen's loop with its iteration count kept
    (the function returns the plane only). Returns (plane, iterations)."""
    import jax
    import jax.numpy as jnp
    from aosx.perceive.skeleton import _subiter

    h, w = mask.shape
    iy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (iy >= 1) & (iy < live_h - 1) & (ix >= 1) & (ix < live_w - 1)

    def body(state):
        p, _, it = state
        q = _subiter(_subiter(p, 0, interior), 1, interior)
        return q, jnp.any(q != p), it + 1

    p, _, it = jax.lax.while_loop(lambda st: st[1] & (st[2] < max_iters), body,
                                  (jnp.asarray(mask), jnp.bool_(True), jnp.int32(0)))
    return np.asarray(p), int(it)


@pytest.mark.parametrize("max_iters", [DRYRUN_STATICS.skeleton_max_iters, 3])
@pytest.mark.parametrize("live_h,live_w", LIVE_REGIONS)
def test_zhang_suen_fixpoint_plain_matches_jax(live_h, live_w, max_iters):
    """Plane and iteration count == the JAX zhang_suen (and its Pallas kernel
    in interpret mode), also capped at 3, where the fixpoint is not reached."""
    import jax.numpy as jnp
    from aosx.config import DRYRUN_STATICS as JS
    from aosx.perceive.skeleton import zhang_suen
    from aosx.perceive.skeleton_pallas import zhang_suen_pallas
    from aosx.types import GridWorld as JGrid

    s = DRYRUN_STATICS
    js = dataclasses.replace(JS, skeleton_max_iters=max_iters)
    mask = _bars_mask(s.grid_h, s.grid_w, live_h, live_w)
    g = JGrid(occ=jnp.asarray(mask), origin_x=jnp.float32(0.0), origin_y=jnp.float32(0.0),
              h_cells=jnp.int32(live_h), w_cells=jnp.int32(live_w))
    ref, it_ref = _jax_thinning(mask, live_h, live_w, max_iters)
    assert np.array_equal(ref, np.asarray(zhang_suen(g, js).occ))
    assert np.array_equal(ref, np.asarray(zhang_suen_pallas(g, js, interpret=True).occ))
    got, it, changed = skeleton_cuda.zhang_suen_fixpoint_plain(
        torch.from_numpy(mask), live_h, live_w, max_iters)
    assert np.array_equal(ref, got.numpy()) and it == it_ref
    # capped: stopped before the fixpoint; else the last iteration found it
    assert (it == 3 and changed > 0) if max_iters == 3 else (3 < it < max_iters and changed == 0)
    # the wrapper on the CPU, and the port's entry point
    occ, stats = skeleton_cuda.zhang_suen_fixpoint(torch.from_numpy(mask), live_h, live_w,
                                                   max_iters)
    assert torch.equal(occ, got) and stats.tolist() == [it, changed]
    s_cap = dataclasses.replace(s, skeleton_max_iters=max_iters)
    assert torch.equal(skeleton.zhang_suen(_grid(mask, live_h, live_w, "cpu"), s_cap).occ, got)


@pytest.mark.parametrize("live_h,live_w", LIVE_REGIONS)
def test_fixpoint_through_bit_sliced_iterations(live_h, live_w):
    """The whole thinning through the packed sub-iterations, as the kernel
    runs it (pack once, iterate on words, unpack once) == the byte loop."""
    s = DRYRUN_STATICS
    occ = torch.from_numpy(_bars_mask(s.grid_h, s.grid_w, live_h, live_w))
    ref, it_ref, _ = skeleton_cuda.zhang_suen_fixpoint_plain(occ, live_h, live_w,
                                                             s.skeleton_max_iters)
    interior = skeleton_cuda.pack_rows(
        skeleton_cuda._interior(occ, live_h, live_w).to(torch.uint8))
    words, it = skeleton_cuda.pack_rows(occ), 0
    while it < s.skeleton_max_iters:
        q = skeleton_cuda._subiter_bits_plain(words, 0, interior)
        q = skeleton_cuda._subiter_bits_plain(q, 1, interior)
        it += 1
        done = torch.equal(q, words)
        words = q
        if done:
            break
    assert it == it_ref > 3
    assert torch.equal(skeleton_cuda.unpack_rows(words, s.grid_w), ref)


# ---------------------------------------------------------------------------
# K1: the owner-only flood against the loop that carries positions, on the CPU
# ---------------------------------------------------------------------------


def _flood_case(device, h=96, w=128, S=24, seed=5):
    """A grid with seeds that share a cell and invalid seeds (one of them in
    a cell of its own, one in a valid seed's cell)."""
    rng = np.random.default_rng(seed)
    res = 0.1
    xy = np.stack([rng.uniform(0.3, w * res - 0.3, S), rng.uniform(0.3, h * res - 0.3, S)],
                  1).astype(np.float32)
    xy[3] = xy[9] + np.float32(0.01)      # seeds 3 and 9 share a cell: 3 owns it
    xy[9] = np.floor(xy[9] / res) * res + np.float32(0.03)
    xy[3] = xy[9] + np.float32(0.02)
    valid = np.ones(S, bool)
    valid[[5, 17, 20]] = False
    xy[17] = xy[2]                        # an invalid seed in a valid seed's cell
    valid[S - 2:] = False
    grid = GridWorld(occ=torch.zeros((h, w), dtype=torch.uint8, device=device),
                     origin_x=torch.tensor(-1.5, device=device),
                     origin_y=torch.tensor(0.75, device=device),
                     h_cells=torch.tensor(h, dtype=torch.int32, device=device),
                     w_cells=torch.tensor(w, dtype=torch.int32, device=device))
    off = np.array([-1.5, 0.75], np.float32)
    seeds = SeedSet(xy=torch.from_numpy(xy + off).to(device),
                    valid=torch.from_numpy(valid).to(device),
                    kind=torch.zeros(S, dtype=torch.int8, device=device))
    s = dataclasses.replace(DRYRUN_STATICS, grid_h=h, grid_w=w, max_seeds=S, resolution=res)
    return grid, seeds, s


def test_jfa_flood_plain_carries_table_rows():
    """jfa_flood_plain == the triple-carrying loop of jfa_pass_plain in all
    three planes, and ox, oy == table[owner] after every pass."""
    grid, seeds, s = _flood_case("cpu")
    S = seeds.xy.shape[0]
    owner, table = voronoi._jfa_init(grid, seeds, s)
    valid = seeds.valid.numpy()
    own0 = owner.numpy()
    assert set(np.unique(own0)) <= set(np.flatnonzero(valid)) | {S}
    assert (own0 == 3).sum() == 1 and (own0 == 9).sum() == 0     # shared cell: lowest index
    assert (own0 == 2).sum() == 1 and (own0 == 17).sum() == 0    # invalid seeds own nothing
    assert table.shape == (S + 1, 2) and table[S].tolist() == [1e9, 1e9]
    steps = voronoi._passes(s)
    args = (S, grid.origin_x, grid.origin_y, s.resolution)
    state = (owner, table[owner.long()][..., 0], table[owner.long()][..., 1])
    for k, step in enumerate(steps):
        state = jfa_pass_cuda.jfa_pass_plain(*state, step, *args)
        pos = table[state[0].long()]
        assert torch.equal(state[1], pos[..., 0]) and torch.equal(state[2], pos[..., 1])
        part = jfa_pass_cuda.jfa_flood_plain(owner, table, steps[:k + 1], *args)
        assert all(torch.equal(a, b) for a, b in zip(part, state))
    assert (state[0] < S).all()
    got = jfa_pass_cuda.jfa_flood(owner, table, steps, *args, want_positions=True)
    assert all(torch.equal(a, b) for a, b in zip(got, state))
    assert torch.equal(jfa_pass_cuda.jfa_flood(owner, table, steps, *args), state[0])
    # brute force: a jump flood is not exact, but nearly every cell's owner
    # is the nearest of the seeds that own their cell
    cx, cy = jfa_pass_cuda.cell_coords(owner.shape, grid.origin_x, grid.origin_y, s.resolution,
                                       "cpu")
    d2 = (seeds.xy[:, 0, None, None] - cx) ** 2 + (seeds.xy[:, 1, None, None] - cy) ** 2
    d2[~seeds.valid] = float("inf")
    d2[9] = float("inf")
    mine = torch.gather(d2, 0, state[0].long()[None])[0]
    assert float((mine == d2.min(0).values).float().mean()) > 0.99


def test_jump_flood_matches_jax_with_shared_and_invalid_seeds():
    """voronoi.jump_flood through the owner-only flood == aosx's jump_flood
    on seeds that share cells and invalid seeds, bitwise."""
    import jax.numpy as jnp
    from aosx.config import DRYRUN_STATICS as JS
    from aosx.gvd.voronoi import jump_flood
    from aosx.types import GridWorld as JGrid, SeedSet as JSeeds

    grid, seeds, s = _flood_case("cpu")
    js = dataclasses.replace(JS, grid_h=s.grid_h, grid_w=s.grid_w, max_seeds=s.max_seeds,
                             resolution=s.resolution, jfa_pass_pallas=False)
    jg = JGrid(occ=jnp.zeros(grid.occ.shape, jnp.uint8), origin_x=jnp.float32(-1.5),
               origin_y=jnp.float32(0.75), h_cells=jnp.int32(s.grid_h),
               w_cells=jnp.int32(s.grid_w))
    jseeds = JSeeds(xy=jnp.asarray(seeds.xy.numpy()), valid=jnp.asarray(seeds.valid.numpy()),
                    kind=jnp.zeros(s.max_seeds, jnp.int8))
    ref = np.asarray(jump_flood(jg, jseeds, js))
    got = voronoi.jump_flood(grid, seeds, s).numpy()
    assert np.array_equal(ref, got)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _planes(h, w, S, device, seed=0):
    """A mid-flood state: random owners (some none), the seed table, and the
    positions the owners carry."""
    rng = np.random.default_rng(seed)
    table = np.concatenate([np.stack([rng.uniform(0, w * 0.1, S), rng.uniform(0, h * 0.1, S)], 1),
                            [[1e9, 1e9]]]).astype(np.float32)
    owner = rng.integers(0, S + 1, (h, w)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (owner, table, table[owner, 0],
                                                     table[owner, 1])]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,S", [(192, 256, 128), (2000, 2048, 4096)])
@pytest.mark.parametrize("step", [1, 7, 128, 1024])
def test_jfa_pass_kernel_matches_plain(cuda_device, h, w, S, step):  # noqa: F811
    owner, table, ox, oy = _planes(h, w, S, cuda_device)
    org = torch.tensor([1.25, -3.5], device=cuda_device)
    flood = jfa_pass_cuda.jfa_flood
    n0 = (flood.launches, flood.passes)
    ref = jfa_pass_cuda.jfa_pass_plain(owner, ox, oy, step, S, org[0], org[1], 0.1)
    got = flood(owner.clone(), table, [step], S, org[0], org[1], 0.1, want_positions=True)
    torch.cuda.synchronize()
    assert (flood.launches, flood.passes) == (n0[0] + 1, n0[1] + 1)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,S", [(96, 128, 24), (384, 512, 256), (2000, 2048, 4096),
                                   (192, 256, 16384)])
def test_jfa_flood_kernel_matches_plain(cuda_device, h, w, S):  # noqa: F811
    """Every pass of a flood from one call == jfa_flood_plain, in owner, ox
    and oy; with and without the positions; the largest seed table too."""
    owner, table, _, _ = _planes(h, w, S, cuda_device, seed=2)
    owner[torch.rand(owner.shape, device=cuda_device) < 0.98] = S
    org = torch.tensor([-2.0, 0.5], device=cuda_device)
    s = dataclasses.replace(DRYRUN_STATICS, grid_h=h, grid_w=w)
    steps = voronoi._passes(s)
    ref = jfa_pass_cuda.jfa_flood_plain(owner, table, steps, S, org[0], org[1], 0.1)
    flood = jfa_pass_cuda.jfa_flood
    n0 = (flood.launches, flood.passes)
    got = flood(owner.clone(), table, steps, S, org[0], org[1], 0.1, want_positions=True)
    torch.cuda.synchronize()
    assert (flood.launches, flood.passes) == (n0[0] + 1, n0[1] + len(steps))
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    only = flood(owner.clone(), table, steps, S, org[0], org[1], 0.1)
    assert torch.equal(only, ref[0])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,S", [(384, 512, 256), (2000, 2048, 4096), (64, 128, 256),
                                   (104, 256, 256)])
def test_jfa_flood_kernel_roundings_match_plain(cuda_device, h, w, S):  # noqa: F811
    """A flood in the Pallas roundings (voronoi.pass_roundings with
    jfa_pass_pallas on; at 64 x 128 and 104 x 256 over one row band, with
    chains) and single passes in each rounding == the plain versions,
    bitwise, from one launch each."""
    owner, table, ox, oy = _planes(h, w, S, cuda_device, seed=3)
    org = torch.tensor([3.5, 3.5], device=cuda_device)
    s = dataclasses.replace(DRYRUN_STATICS, grid_h=h, grid_w=w, jfa_pass_pallas=True,
                            jfa_dynamic_shifts=False)
    steps = voronoi._passes(s)
    rounding = voronoi.pass_roundings(s, steps)
    sparse = owner.clone()
    sparse[torch.rand(owner.shape, device=cuda_device) < 0.98] = S
    ref = jfa_pass_cuda.jfa_flood_plain(sparse, table, steps, S, org[0], org[1], 0.1, rounding)
    got = jfa_pass_cuda.jfa_flood(sparse.clone(), table, steps, S, org[0], org[1], 0.1,
                                  want_positions=True, rounding=rounding)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    # a chain's passes fold from its triples (voronoi.CHAINS): whole floods only
    for r in (r for r in voronoi.ROUNDINGS if r not in voronoi.CHAINS):
        for step in (1, 2, 64):
            ref = jfa_pass_cuda.jfa_pass_plain(owner, ox, oy, step, S, org[0], org[1], 0.1, r)
            got = jfa_pass_cuda.jfa_flood(owner.clone(), table, [step], S, org[0], org[1], 0.1,
                                          want_positions=True, rounding=[r])
            for a, b in zip(ref, got):
                assert torch.equal(a, b)


def test_jfa_flood_refuses_unknown_roundings():
    """A rounding a step, each a voronoi.ROUNDINGS key, on every device."""
    owner, table, _, _ = _planes(16, 32, 8, "cpu")
    args = (8, 0.0, 0.0, 0.1)
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner, table, [2, 1], *args, rounding=["pallas"])
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner, table, [1], *args, rounding=["tpu"])
    assert torch.equal(jfa_pass_cuda.jfa_flood(owner, table, [2, 1], *args),
                       jfa_pass_cuda.jfa_flood(owner, table, [2, 1], *args,
                                               rounding=["xla", "xla"]))


@pytest.mark.cuda
def test_jfa_flood_refuses_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    owner, table, _, _ = _planes(64, 128, 8, cuda_device)
    args = (8, 0.0, 0.0, 0.1)
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner.long(), table, [1], *args)
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner[:, :126].contiguous(), table, [1], *args)
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner, table[:8], [1], *args)
    with pytest.raises(ValueError):
        jfa_pass_cuda.jfa_flood(owner, table, [], *args)


@pytest.mark.cuda
@pytest.mark.parametrize("live_h,live_w", LIVE_REGIONS)
def test_zhang_suen_kernel_matches_plain(cuda_device, live_h, live_w):  # noqa: F811
    s = DRYRUN_STATICS
    mask = blobby_mask(s.grid_h, s.grid_w, seed=7, live_h=live_h, live_w=live_w)
    g = _grid(mask, live_h, live_w, cuda_device)
    for _ in range(3):
        ref, n_ref = skeleton_cuda.zhang_suen_iteration_plain(g.occ, g.h_cells, g.w_cells)
        got, n_got = skeleton_cuda.zhang_suen_iteration(g.occ, g.h_cells, g.w_cells)
        assert torch.equal(ref, got) and int(n_ref) == int(n_got)
        g = dataclasses.replace(g, occ=got)


# heights that one block an SM of a 132-SM card cuts into ragged bands: a last
# band of one row (301 and 271 into bands of 3) and of 15 rows (1999 into 16s)
RAGGED_SHAPES = [(301, 96, 299, 90), (271, 75, 268, 70), (1999, 160, 1990, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [64, 3, 1, 0])
@pytest.mark.parametrize("kind", ["random", "bars"])
@pytest.mark.parametrize("h,w,live_h,live_w", BIT_SHAPES + RAGGED_SHAPES)
def test_zhang_suen_fixpoint_kernel_matches_plain(cuda_device, h, w, live_h, live_w,  # noqa: F811
                                                  kind, max_iters):
    """Plane, iteration count and last changed count == the plain loop:
    uncapped, capped, one iteration, none; band heights that do not divide
    the rows."""
    mask = _thinning_input(kind, h, w, live_h, live_w)
    g = _grid(mask, live_h, live_w, cuda_device)
    ref, it, changed = skeleton_cuda.zhang_suen_fixpoint_plain(g.occ, g.h_cells, g.w_cells,
                                                               max_iters)
    n0 = skeleton_cuda.zhang_suen_fixpoint.launches
    got, stats = skeleton_cuda.zhang_suen_fixpoint(g.occ, g.h_cells, g.w_cells, max_iters)
    torch.cuda.synchronize()
    assert skeleton_cuda.zhang_suen_fixpoint.launches == n0 + 1
    assert torch.equal(ref, got) and stats.tolist() == [it, changed]
    assert torch.equal(g.occ, torch.as_tensor(mask, device=cuda_device))    # input untouched


@pytest.mark.cuda
def test_subiter_bits_plain_on_card(cuda_device):  # noqa: F811
    """The packed plain version's shifts behave on the card as on the CPU."""
    occ = torch.from_numpy(_random_mask(40, 75, 11, 37, 70)).to(cuda_device)
    interior = skeleton_cuda._interior(occ, 37, 70)
    for phase in (0, 1):
        got = skeleton_cuda._subiter_bits_plain(
            skeleton_cuda.pack_rows(occ), phase,
            skeleton_cuda.pack_rows(interior.to(torch.uint8)))
        assert torch.equal(skeleton_cuda.unpack_rows(got, 75),
                           skeleton_cuda._subiter(occ, phase, interior))


@pytest.mark.cuda
def test_zhang_suen_refuses_what_the_kernel_does_not_take(cuda_device):  # noqa: F811
    occ = torch.zeros((64, 128), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        skeleton_cuda.zhang_suen_fixpoint(occ.int(), 64, 128, 4)
    with pytest.raises(ValueError):
        skeleton_cuda.zhang_suen_fixpoint(occ[:, ::2], 64, 64, 4)
    out, stats = skeleton_cuda.zhang_suen_fixpoint(
        torch.zeros((2000, 2048), dtype=torch.uint8, device=cuda_device), 2000, 2048, 4)
    assert stats.tolist() == [1, 0] and not out.any()
    # a band of a plane this large does not fit a block's shared memory: no fallback
    big = torch.zeros((30000, 8192), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(RuntimeError):
        skeleton_cuda.zhang_suen_fixpoint(big, 30000, 8192, 4)


@pytest.mark.cuda
def test_jump_flood_on_card_matches_cpu(cuda_device):  # noqa: F811
    s = dataclasses.replace(DRYRUN_STATICS, max_seeds=4096)
    assert torch.equal(_flood_port(s, cuda_device).cpu(), _flood_port(s, "cpu"))
    grid, seeds, s = _flood_case(cuda_device)
    grid_c, seeds_c, _ = _flood_case("cpu")
    assert torch.equal(voronoi.jump_flood(grid, seeds, s).cpu(),
                       voronoi.jump_flood(grid_c, seeds_c, s))
