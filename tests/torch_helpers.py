"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages;
outputs are compared leaf for leaf through ``aosx_torch.convert.to_numpy``,
which walks JAX and port dataclasses alike."""

import dataclasses

import numpy as np
import pytest
import torch

from aosx_torch.convert import to_numpy
from aosx_torch.orchards import OrchardSpec, make_orchard_np

# the test_episode.py orchard: near the origin, so that the (8, 0) initial
# waypoint and the origin return are reachable
SPEC = OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0), noise_pts=64)
# the specs of the world-parity orchards (tests/test_torch_world_parity.py)
WORLD_SPECS = {
    "test": SPEC,
    "curved": dataclasses.replace(SPEC, row_curve=0.6),
    "4x14": OrchardSpec(n_rows=4, row_len=14.0, row_spacing=3.5, noise_pts=128),
    "5x16": OrchardSpec(n_rows=5, row_len=16.0, row_spacing=3.0),
}


def orchard_buffers(statics, seed=0, spec=SPEC):
    """(xyz [N,3] f32, valid [N] bool, polygon [4,2] f64) padded to
    statics.max_points."""
    xyz, poly = make_orchard_np(spec, seed=seed)
    buf = np.zeros((statics.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(statics.max_points, bool)
    valid[:len(xyz)] = True
    return buf, valid, poly


def blobby_mask(h, w, seed, density=0.004, live_h=None, live_w=None):
    """Random dilated blobs confined to the live region (the thinning input
    of tests/test_pallas_kernels.py)."""
    rng = np.random.default_rng(seed)
    m = rng.random((h, w)) < density
    for _ in range(2):
        m = m | np.roll(m, 1, 0) | np.roll(m, 1, 1) | np.roll(m, -1, 0) | np.roll(m, -1, 1)
    out = np.zeros((h, w), np.uint8)
    lh = live_h or h
    lw = live_w or w
    out[1:lh - 1, 1:lw - 1] = m[1:lh - 1, 1:lw - 1]
    return out


def _ulp_distance(a, b):
    """Max |a - b| of two f32 arrays in units in the last place of the
    larger magnitude of ``a``: an error of one rounding in a + t*d is one
    ulp of the operands, however much a and t*d cancel."""
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    if not (np.isfinite(a) == np.isfinite(b)).all():
        return np.iinfo(np.int32).max
    # finite, and below the 3.4e38 pad value of cost and distance planes
    fin = np.isfinite(a) & (np.abs(a) < 1e30)
    if not fin.any():
        return 0
    scale = np.spacing(np.float32(np.abs(a[fin]).max()))
    return int(np.ceil(np.abs(a[fin].astype(np.float64) - b[fin].astype(np.float64)).max() / scale))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def assert_same(ref, got, ulp_bounds=None):
    """Every leaf of ``got`` equals ``ref``: int/bool leaves and f32 leaves
    bitwise, except f32 leaves named in ``ulp_bounds`` (leaf path -> max
    ulp), which may differ by at most that many units in the last place of
    the leaf's largest magnitude (see _ulp_distance)."""
    ulp_bounds = ulp_bounds or {}
    ref_leaves = dict(_leaves(to_numpy(ref)))
    got_leaves = dict(_leaves(to_numpy(got)))
    assert ref_leaves.keys() == got_leaves.keys()
    bad = []
    for name, a in ref_leaves.items():
        b = got_leaves[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        elif a.dtype == np.float32 and name in ulp_bounds:
            d = _ulp_distance(a, b)
            if d > ulp_bounds[name]:
                bad.append(f"{name}: {d} ulp > {ulp_bounds[name]}")
        elif a.dtype == np.float32:
            if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                bad.append(f"{name}: f32 differs by {_ulp_distance(a, b)} ulp")
        elif not np.array_equal(a, b):
            bad.append(f"{name}: {int((a != b).sum())} entries differ")
    assert not bad, "\n".join(bad)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs six test workers on a few cores: torch's intra-op thread
    pool in each would oversubscribe them (the port's CPU tensors here are
    small), so every module importing this fixture runs torch on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels of aosx_torch/csrc build with
    nvcc for sm_90a and run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written sm_90a kernels)")
    return torch.device("cuda")
