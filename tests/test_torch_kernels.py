"""Kernels K1 (Jacobi jump-flood pass) and K2 (Zhang-Suen iteration).

On the CPU, the port's flood and thinning (which take each kernel's plain
PyTorch version there) are held bitwise against the JAX package's Pallas
kernels in interpret mode. The cases marked ``cuda`` hold each CUDA kernel
bitwise against its plain version on the card and skip elsewhere; they
import no JAX, so they run on a machine without it:

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
    n0 = (jfa_pass_cuda.jfa_pass.launches, skeleton_cuda.zhang_suen_iteration.launches)
    _flood_port(DRYRUN_STATICS, "cpu")
    s = DRYRUN_STATICS
    skeleton.zhang_suen(_grid(blobby_mask(s.grid_h, s.grid_w, 7), s.grid_h, s.grid_w, "cpu"), s)
    assert (jfa_pass_cuda.jfa_pass.launches,
            skeleton_cuda.zhang_suen_iteration.launches) == n0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _planes(h, w, S, device, seed=0):
    """A mid-flood state: random owners (some none) with their positions."""
    rng = np.random.default_rng(seed)
    sx = rng.uniform(0, w * 0.1, S).astype(np.float32)
    sy = rng.uniform(0, h * 0.1, S).astype(np.float32)
    owner = rng.integers(0, S + 1, (h, w)).astype(np.int32)
    ox = np.where(owner < S, np.append(sx, 1e9)[owner], 1e9).astype(np.float32)
    oy = np.where(owner < S, np.append(sy, 1e9)[owner], 1e9).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (owner, ox, oy)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,S", [(192, 256, 128), (2000, 2048, 4096)])
@pytest.mark.parametrize("step", [1, 7, 128, 1024])
def test_jfa_pass_kernel_matches_plain(cuda_device, h, w, S, step):  # noqa: F811
    owner, ox, oy = _planes(h, w, S, cuda_device)
    org = torch.tensor([1.25, -3.5], device=cuda_device)
    n0 = jfa_pass_cuda.jfa_pass.launches
    got = jfa_pass_cuda.jfa_pass(owner, ox, oy, step, S, org[0], org[1], 0.1)
    torch.cuda.synchronize()
    assert jfa_pass_cuda.jfa_pass.launches == n0 + 1
    ref = jfa_pass_cuda.jfa_pass_plain(owner, ox, oy, step, S, org[0], org[1], 0.1)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


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


@pytest.mark.cuda
def test_jump_flood_on_card_matches_cpu(cuda_device):  # noqa: F811
    s = dataclasses.replace(DRYRUN_STATICS, max_seeds=4096)
    assert torch.equal(_flood_port(s, cuda_device).cpu(), _flood_port(s, "cpu"))
