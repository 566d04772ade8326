"""The port's copies of XLA:CPU's f32 arithmetic on the plan path, bit for
bit against jitted ``jax`` on the same seeded inputs:

- ``ops.cumsum_xla`` against ``jnp.cumsum`` (linearize's prefix sums):
  lengths 1 to 17 and the path lengths 769, 1,200 and 4,097, along the
  last axis of a batch, along axis 0 and under ``jax.vmap``;
- ``ops.sum_xla`` against ``jnp.sum`` (``path_cost`` over max_path - 1
  terms, the rollout travel over n_steps - 1), alone, along axis 0 and
  under ``jax.vmap``;
- ``f32math.atan2_f32`` against ``jnp.arctan2`` on 1,048,576 seeded pairs
  and the edge cases: the axes, signed zeros, infinities, NaN, |y| = |x|,
  ratios near 0 and near f32's limits, subnormals;
- ``f32math.sin_f32`` / ``cos_f32`` over +-3 pi (the follower's turn);
- ``ops.norm2`` against the reference's fused ``sqrt(sum(v**2))`` and
  ``geom.wrap_angle`` against the jitted wrap;
- ``ops.fma``'s CPU path (f64 sums rounded straight to f32, the midpoints
  and tiny sums redone) bitwise its round-to-odd path, and both against
  XLA:CPU's contracted ``a * a + c``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.geom import wrap_angle as jwrap
from aosx_torch import f32math
from aosx_torch.geom import wrap_angle
from aosx_torch.ops import _round_odd_f32, cumsum_xla, fma, norm2, sum_xla
from torch_helpers import one_torch_thread  # noqa: F401


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_bitwise(want, got):
    want, got = np.asarray(want), np.asarray(got)
    both_nan = np.isnan(want) & np.isnan(got)
    bad = (_bits(want) != _bits(got)) & ~both_nan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ, first at {np.argwhere(bad)[:3]}"


def _values(rng, shape):
    """Signed values over many binades, as prefix-sum and path-cost terms
    are (coordinates, their products and squares)."""
    return (rng.standard_normal(shape) * np.exp(rng.uniform(-6, 6, shape))).astype(np.float32)


SCAN_LENGTHS = list(range(1, 18)) + [769, 1200, 4097]


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_cumsum_xla_matches_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    v = _values(rng, (5, n))
    got = cumsum_xla(torch.from_numpy(v)).numpy()
    _assert_bitwise(jax.jit(lambda a: jnp.cumsum(a, axis=1))(v), got)
    _assert_bitwise(jax.jit(jax.vmap(jnp.cumsum))(v), got)
    _assert_bitwise(jax.jit(lambda a: jnp.cumsum(a, axis=0))(v.T.copy()).T, got)
    # linearize's tables: [*B, 5, P + 1] prefix rows of a batch of paths
    v3 = _values(rng, (2, 3, n))
    _assert_bitwise(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(v3),
                    cumsum_xla(torch.from_numpy(v3)).numpy())


# path_cost over max_path - 1 (TEST, DRYRUN and MC_STATICS: 63; BENCH: 767)
# and the travel over n_steps - 1 of the tests' and chip_smoke's rollouts
SUM_LENGTHS = [1, 2, 31, 32, 33, 39, 47, 63, 149, 159, 767, 1199, 2047, 4500]


@pytest.mark.parametrize("n", SUM_LENGTHS)
def test_sum_xla_matches_jnp_sum(n):
    rng = np.random.default_rng(1000 + n)
    v = _values(rng, (6, n))
    got = sum_xla(torch.from_numpy(v)).numpy()
    _assert_bitwise(jax.jit(lambda a: jnp.sum(a, axis=1))(v), got)
    _assert_bitwise(jax.jit(jax.vmap(jnp.sum))(v), got)
    _assert_bitwise(jax.jit(lambda a: jnp.sum(a, axis=0))(v.T.copy()), got)
    # the travel: segment lengths (non-negative) summed over ticks, lanes beside
    seg = np.abs(v) * np.float32(1e-3)
    _assert_bitwise(jax.jit(lambda a: jnp.sum(jnp.sqrt(a * a), axis=0))(seg.T.copy()),
                    sum_xla(torch.from_numpy(seg)).numpy())


def _atan2_pairs(case, rng):
    f32 = np.float32
    if case == "random":
        n = 1 << 20
        y = rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))
        x = rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))
        return y.astype(f32), x.astype(f32)
    if case == "special":
        info = np.finfo(f32)
        vals = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 7.0, 1e-10, 1e-30, 1e30,
                         info.tiny, -info.tiny, info.max, -info.max, info.eps,
                         1e-45, -1e-45, 1e-40, np.inf, -np.inf, np.nan,
                         0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** 25, 2.0 ** -29], f32)
        y, x = np.meshgrid(vals, vals)
        return y.ravel(), x.ravel()
    t = (rng.standard_normal(1 << 16) * np.exp(rng.uniform(-20, 20, 1 << 16))).astype(f32)
    if case == "diagonals":            # |y| = |x|, and one ulp off it
        up = np.nextafter(t, np.float32(np.inf))
        return np.concatenate([t, t, -t, t]), np.concatenate([t, -t, t, up])
    if case == "ratios":               # |y/x| near 0, near 2^+-60 and at f32's limits
        s = np.exp2(rng.integers(-150, 150, t.size)).astype(np.float64)
        with np.errstate(over="ignore"):         # infinities are cases too
            y = (t.astype(np.float64) * s).astype(f32)
        return np.concatenate([y, t]), np.concatenate([t, y])
    # subnormals against normals and each other
    sub = (rng.uniform(-1, 1, t.size) * np.finfo(f32).tiny).astype(f32)
    return np.concatenate([sub, t, sub]), np.concatenate([t, sub, sub[::-1]])


@pytest.mark.parametrize("case", ["random", "special", "diagonals", "ratios", "subnormals"])
def test_atan2_f32_matches_jnp_arctan2(case):
    y, x = _atan2_pairs(case, np.random.default_rng(7))
    _assert_bitwise(jax.jit(jnp.arctan2)(y, x),
                    f32math.atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_sincos_f32_over_the_turn_domain(fn):
    """The follower takes sin and cos of desired - yaw, within +-2 pi; the
    whole of +-3 pi is held, with the points near the multiples of pi / 2."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-3 * np.pi, 3 * np.pi, 1 << 20).astype(np.float32)
    k = (np.pi / 2 * np.arange(-6, 7)).astype(np.float32)
    near = (k[:, None] + np.arange(-64, 65)[None, :] * np.spacing(np.float32(10.0))).ravel()
    a = np.concatenate([a, near.astype(np.float32), np.float32([0.0, -0.0])])
    jf, tf = (jnp.sin, f32math.sin_f32) if fn == "sin" else (jnp.cos, f32math.cos_f32)
    _assert_bitwise(jax.jit(jf)(a), tf(torch.from_numpy(a)).numpy())


def test_norm2_matches_fused_reference():
    rng = np.random.default_rng(3)
    v = (rng.uniform(-200, 200, (1 << 18, 2))
         * np.exp(rng.uniform(-8, 0, (1 << 18, 1)))).astype(np.float32)
    want = jax.jit(lambda a: jnp.sqrt(jnp.sum(a ** 2, axis=1)))(v)
    _assert_bitwise(want, norm2(torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("case", ["binades", "cancel", "midpoints", "tiny", "special"])
def test_fma_host_equals_fma(case):
    """fma on CPU tensors of one shape (the host path) == the round-to-odd
    path that other tensors take, bit for bit (NaN for NaN), on values over
    many binades, sums that cancel, sums whose f64 rounding lands on an f32
    midpoint, sums below f32's normal range and the special values; on the
    finite normal cases also == XLA:CPU's jitted a * a + c (one fma; XLA:CPU
    flushes subnormals, which neither path keeps away)."""
    rng = np.random.default_rng(11)
    n = 1 << 18
    if case == "special":
        sp = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, 1e-45, 1.0])
        a, b, c = (x.ravel() for x in np.meshgrid(sp, sp, sp, indexing="ij"))
    else:
        a = _values(rng, n)
        if case == "binades":
            c = _values(rng, n)
        elif case == "cancel":
            c = -(a * a)
        elif case == "midpoints":
            # a small power of two beside a * a: the f64 sum sits on an f32
            # rounding midpoint where f32(a * a) is exact
            a = np.float32(rng.integers(1, 1 << 12, n)) * np.float32(2.0 ** -6)
            c = (a * a * np.float32(2.0 ** -24)).astype(np.float32)
        else:
            a = (a * np.float32(1e-21)).astype(np.float32)
            c = (_values(rng, n) * np.float32(1e-40)).astype(np.float32)
        b = a
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (a, b, c)]
    _assert_bitwise(_round_odd_f32(t[0].double() * t[1], t[2]).numpy(), fma(*t).numpy())
    # 0-d operands (the follower's scalars) and strided ones take the CPU path too
    for k in range(8):
        _assert_bitwise(_round_odd_f32(t[0][k].double() * t[1][k], t[2][k]).numpy(),
                        fma(t[0][k], t[1][k], t[2][k]).numpy())
    _assert_bitwise(_round_odd_f32(t[0][::3].double() * t[1][::3], t[2][::3]).numpy(),
                    fma(t[0][::3], t[1][::3], t[2][::3]).numpy())
    if case not in ("special", "tiny"):
        want = jax.jit(lambda x, z: x * x + z)(a, c)
        _assert_bitwise(want, fma(t[0], t[0], t[2]).numpy())


def test_wrap_angle_matches_jitted_wrap():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.uniform(-50, 50, 1 << 18), rng.uniform(-4, 4, 1 << 18),
                        np.pi + rng.uniform(-1e-5, 1e-5, 1 << 14),
                        -np.pi + rng.uniform(-1e-5, 1e-5, 1 << 14)]).astype(np.float32)
    _assert_bitwise(jax.jit(jwrap)(a), wrap_angle(torch.from_numpy(a)).numpy())

