"""Kernel K3 (all-pairs ROR neighbour counts) and the ``ror_counts``
methods around it, plus the preprocessing guard bits.

On the CPU the port's ``ror_counts(method="pallas")`` takes K3's plain
version and is held against the JAX package's Pallas kernel in interpret
mode; ``"mxu"``, the same path in the port, against JAX's ``"mxu"``. Both
use d2 = (|a|^2 + |b|^2) - 2 a.b in f32, with the fused multiply-add chains
XLA:CPU runs (see
``aosx_torch/perceive/ror_cuda.py``), so the counts equal JAX's on every
valid point. Within the port, the dot formula is held against the
elementwise ``"exact"`` method with a stated tolerance: a point whose count
differs must owe it to a pair whose exact d2 lies within 4 ulp of the
squared norms (the formula's rounding scale) of r^2, and the test says so
when that happens. Parked points' counts are junk on both sides (the dot
formula cancels at 1e9) and are compared only between the kernel and its
plain version.

The cases marked ``cuda`` import no JAX, so they run on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_ror.py
"""

import numpy as np
import pytest
import torch

from aosx_torch.perceive import points, ror_cuda
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

R = 0.2
TIE_ULP = 4


def _cloud(n=2048, seed=11, invalid=50):
    """The cloud of tests/test_pallas_kernels.py::test_ror_pallas_matches_exact."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(0, 30, n), rng.uniform(0, 10, n),
                    rng.uniform(-0.3, 0.4, n)], 1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - invalid:] = False
    return xyz, valid


def _parked(xyz, valid):
    park = 1e9 + np.arange(len(xyz), dtype=np.float32)[:, None] * 1e3
    return np.where(valid[:, None], xyz, park).astype(np.float32)


def _assert_counts_equal(ref, got, xyz, valid):
    """Equal counts on valid points, or differences explained by near-ties."""
    diff = np.flatnonzero(valid & (ref != got))
    if not diff.size:
        return
    r2 = np.float32(R) ** 2
    v = xyz[valid].astype(np.float64)
    tol = TIE_ULP * np.spacing(np.float32((v ** 2).sum(axis=1).max()))
    for i in diff:
        d2 = ((v - xyz[i].astype(np.float64)) ** 2).sum(axis=1)
        ties = int((np.abs(d2 - np.float64(r2)) <= tol).sum())
        assert abs(int(ref[i]) - int(got[i])) <= ties, (i, ref[i], got[i], ties)
    print(f"{diff.size} point(s) differ by near-ties within {TIE_ULP} ulp of |a|^2 of r^2")


def _assert_counts_exact(ref, got, valid):
    """Equal counts on every valid point."""
    diff = np.flatnonzero(valid & (ref != got))
    assert not diff.size, [(int(i), int(ref[i]), int(got[i])) for i in diff[:8]]


def test_pallas_method_matches_pallas_interpret():
    """ror_counts(method='pallas') on the CPU (K3's plain version) equals the
    JAX Pallas kernel in interpret mode, on every valid point."""
    import jax.numpy as jnp
    from aosx.perceive.ror_pallas import ror_counts_pallas

    xyz, valid = _cloud()
    n = len(xyz)
    ref = np.asarray(ror_counts_pallas(jnp.asarray(_parked(xyz, valid)), jnp.float32(R) ** 2,
                                       interpret=True))[:n] - 1
    n0 = ror_cuda.ror_counts.launches
    got, span = points.ror_counts(torch.from_numpy(xyz), torch.from_numpy(valid), R,
                                  method="pallas")
    assert ror_cuda.ror_counts.launches == n0
    assert got.dtype == torch.int32 and not bool(span)
    _assert_counts_exact(ref, got.numpy(), valid)
    assert (got.numpy()[valid] > 0).any()


def test_mxu_method_matches_jax_mxu():
    import jax.numpy as jnp
    from aosx.perceive.points import ror_counts as jror_counts

    xyz, valid = _cloud()
    ref, _ = jror_counts(jnp.asarray(xyz), jnp.asarray(valid), R, method="mxu")
    n0 = ror_cuda.ror_counts.launches
    got, span = points.ror_counts(torch.from_numpy(xyz), torch.from_numpy(valid), R,
                                  method="mxu")
    assert ror_cuda.ror_counts.launches == n0
    assert not bool(span)
    _assert_counts_exact(np.asarray(ref), got.numpy(), valid)


@pytest.mark.parametrize("method", ["pallas", "mxu"])
def test_dot_methods_match_exact_away_from_ties(method):
    """The dot formula counts like the elementwise one except at pairs whose
    d2 lies within its rounding (a few ulp of |a|^2) of r^2."""
    xyz, valid = _cloud(seed=3)
    t, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    ref, _ = points.ror_counts(t, v, R, method="exact")
    got, _ = points.ror_counts(t, v, R, method=method)
    _assert_counts_equal(ref.numpy(), got.numpy(), xyz, valid)


def _preprocess_pair(xyz, valid, method):
    """preprocess_full through both packages on one cloud: (jax, port)."""
    import jax.numpy as jnp
    from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
    from aosx.perceive.points import preprocess_full as jpre
    from aosx.types import PointCloud as JCloud, Polygon as JPolygon

    from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
    from aosx_torch.types import PointCloud, Polygon

    poly = np.float32([[-1, -1], [200, -1], [200, 50], [-1, 50]])
    ref = jpre(JCloud(xyz=jnp.asarray(xyz), valid=jnp.asarray(valid)),
               JPolygon.from_array(poly, JS), jparams(JParams()),
               jnp.zeros((JS.max_exclusions, 3), jnp.float32), JS, ror_method=method)
    got = points.preprocess_full(
        PointCloud(xyz=torch.from_numpy(xyz), valid=torch.from_numpy(valid)),
        Polygon.from_array(poly, S, "cpu"), params_as_f32(AosParams(), "cpu"),
        torch.zeros((S.max_exclusions, 3)), S, ror_method=method)
    return ref, got


def test_guard_ror_span_fires_like_jax():
    """GUARD_ROR_SPAN: a sorted-sweep cloud so dense in x that blocks i and
    i+2 lie closer than the radius (three blocks of 2048 points over 0.3 m)
    sets the bit in both packages, with equal counts and keep masks."""
    from aosx_torch.guards import GUARD_ROR_SPAN

    rng = np.random.default_rng(5)
    n = 3 * 2048
    xyz = np.stack([rng.uniform(0, 0.3, n), rng.uniform(0, 5, n),
                    rng.uniform(-0.3, 0.4, n)], 1).astype(np.float32)
    valid = np.ones(n, bool)
    ref, got = _preprocess_pair(xyz, valid, "sorted")
    assert int(ref[5]) == int(got[5]) == GUARD_ROR_SPAN
    assert np.array_equal(np.asarray(ref[2]), got[2].numpy())
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())

    # control: the same number of points spread over 60 m keeps the bit off
    xyz[:, 0] *= 200.0
    ref, got = _preprocess_pair(xyz, valid, "sorted")
    assert int(ref[5]) == int(got[5]) == 0


@pytest.mark.parametrize("method", ["sorted", "pallas"])
def test_nan_point_is_dropped_like_jax(method, monkeypatch):
    """A NaN point is taken out at the input boundary (valid & isfinite) by
    both packages; it sets no guard bit and every count and mask agrees.
    The JAX side runs its Pallas kernel in interpret mode."""
    import functools

    from aosx.perceive import ror_pallas

    monkeypatch.setattr(ror_pallas, "ror_counts_pallas",
                        functools.partial(ror_pallas.ror_counts_pallas, interpret=True))
    xyz, valid = _cloud(n=2048, seed=7, invalid=0)
    xyz[10] = [np.nan, 1.0, 0.0]
    xyz[11, 2] = np.inf
    ref, got = _preprocess_pair(xyz, valid, method)
    assert int(ref[5]) == int(got[5]) == 0
    assert not got[3].numpy()[10] and not got[3].numpy()[11]
    assert np.array_equal(np.asarray(ref[3]), got[3].numpy())
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    v = got[3].numpy()
    assert np.array_equal(np.asarray(ref[2])[v], got[2].numpy()[v])


def test_pallas_method_matches_pallas_interpret_far_from_origin():
    """At orchard coordinates (a 2048-point cloud 150 m out, |a|^2 ~ 3e4,
    whose f32 ulp is a twentieth of r^2) the dot formula rounds coarsely,
    and only the same fused multiply-add chains as XLA:CPU's give the same
    counts: equal on every valid point. The same formula with every
    operation rounded on its own (no FMA) counts differently at many points
    of this cloud (139 of its 1,998 valid points)."""
    import jax.numpy as jnp
    from aosx.perceive.ror_pallas import ror_counts_pallas

    xyz, valid = _cloud(seed=13)
    xyz = (xyz * np.float32([0.2, 0.5, 1.0]) + np.float32([150.0, 80.0, 0.0])).astype(np.float32)
    n = len(xyz)
    parked = _parked(xyz, valid)
    ref = np.asarray(ror_counts_pallas(jnp.asarray(parked), jnp.float32(R) ** 2,
                                       interpret=True))[:n] - 1
    got, _ = points.ror_counts(torch.from_numpy(xyz), torch.from_numpy(valid), R, method="pallas")
    got = got.numpy()
    assert np.array_equal(ref[valid], got[valid])
    assert (got[valid] > 2).mean() > 0.5

    p = torch.from_numpy(parked)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    sq = (x * x + y * y) + z * z
    dot = (x[:, None] * x[None] + y[:, None] * y[None]) + z[:, None] * z[None]
    d2 = (sq[:, None] + sq[None]) - 2.0 * dot
    separate = ((d2 <= torch.tensor(R) ** 2).sum(dim=1) - 1).numpy()
    assert int((separate != ref)[valid].sum()) > 50


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 131072])
def test_ror_kernel_matches_plain(cuda_device, n):  # noqa: F811
    """K3 against its plain version on the card, bitwise on every point,
    parked and padded ones included."""
    xyz, valid = _cloud(n=n, seed=11, invalid=n // 40)
    pts = torch.from_numpy(_parked(xyz, valid)).to(cuda_device)
    pts[-7:] = -1e9
    r2 = torch.tensor(R, device=cuda_device) ** 2
    n0 = ror_cuda.ror_counts.launches
    got = ror_cuda.ror_counts(pts, r2)
    torch.cuda.synchronize()
    assert ror_cuda.ror_counts.launches == n0 + 1
    ref = ror_cuda.ror_counts_plain(pts, r2)
    assert torch.equal(ref, got)
    assert int(got[:n - n // 40].min()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pallas", "mxu"])
def test_pallas_method_on_card_matches_cpu(cuda_device, method):  # noqa: F811
    """Both dot-formula methods launch K3 once on a CUDA tensor and count
    as the plain version does on the CPU."""
    xyz, valid = _cloud(n=4096, seed=2)
    args = (torch.from_numpy(xyz), torch.from_numpy(valid))
    ref, _ = points.ror_counts(*args, R, method=method)
    n0 = ror_cuda.ror_counts.launches
    got, _ = points.ror_counts(*(a.to(cuda_device) for a in args), R, method=method)
    assert ror_cuda.ror_counts.launches == n0 + 1
    assert torch.equal(ref, got.cpu())
