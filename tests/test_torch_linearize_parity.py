"""``linearize`` of the port bitwise equal to the JAX package's on the
BENCH_STATICS raw A* paths of the serving reference's frame 0
(tests/torch_reference/serving_np_seed0_frame0.npz: 73 plan-cache rows, up
to 363 points at up to 190 m from the origin, where the regression split is
ill-conditioned), and on seeded random paths of the same extent.

The context pinned is the one the plan cache runs: JAX's ``linearize``
jitted under ``jax.lax.map`` over the rows, the form
tests/torch_reference/make_serving_reference.py checks frame 0's cache with
(``build_plan_cache`` maps its rows the same way). Every row's point count,
points and yaws are held bitwise. Rows 11, 23, 37, 39 and 41 are the rows
whose counts differed while the port summed its prefix tables in f64 and
rounded linearize's multiply-adds as two operations (XLA:CPU's blocked
cumsum and fused multiply-adds: ``ops.cumsum_xla``, ``ops.fma``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import BENCH_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.plan.linearize import linearize as jlinearize
from aosx.types import Path as JPath
from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
from aosx_torch.plan.linearize import linearize
from aosx_torch.types import Path
from torch_helpers import one_torch_thread  # noqa: F401

FRAME0 = "tests/torch_reference/serving_np_seed0_frame0.npz"
ROWS = 73
RANDOM_PATHS = 48


def _random_paths(n, seed):
    """Paths through 2-7 random corners in [0, 200] x [-5, 100] m, sampled
    on the 0.1 m lattice with +-0.1/0.2 m jitter, lengths 0 to max_path,
    some ending at the origin (linearize's 10-segment case)."""
    rng = np.random.default_rng(seed)
    P = S.max_path
    xy = np.zeros((n, P, 2), np.float32)
    count = np.zeros(n, np.int32)
    for i in range(n):
        m = int(rng.choice([rng.integers(0, 8), rng.integers(5, 200), rng.integers(200, P + 1)]))
        k = int(rng.integers(2, 8))
        corners = np.stack([rng.uniform(0, 200, k), rng.uniform(-5, 100, k)], 1)
        if rng.random() < 0.3:
            corners[-1] = 0
        t = (np.linspace(0, 1, m) if m > 1 else np.zeros(m)) * (k - 1)
        j = np.minimum(t.astype(int), k - 2)
        f = (t - j)[:, None]
        pts = corners[j] * (1 - f) + corners[j + 1] * f
        pts = np.round(pts * 10) / 10 + rng.choice([0, 0, 0.1, -0.1, 0.2], (m, 2))
        if m:
            pts[-1] = corners[-1]
        xy[i, :m] = pts
        count[i] = m
    return xy, count


def _both(xy, count):
    jp = jparams(JParams())
    want = jax.jit(lambda xy, c: jax.lax.map(
        lambda r: jlinearize(JPath(xy=r[0], yaw=jnp.zeros(JS.max_path), count=r[1]), jp, JS),
        (xy, c)))(jnp.asarray(xy), jnp.asarray(count))
    got = linearize(Path(xy=torch.from_numpy(xy), yaw=torch.zeros(xy.shape[:2]),
                         count=torch.from_numpy(count)), params_as_f32(AosParams(), "cpu"), S)
    return ({k: np.asarray(getattr(want, k)) for k in ("xy", "yaw", "count")},
            {k: getattr(got, k).numpy() for k in ("xy", "yaw", "count")})


@pytest.fixture(scope="module")
def bench_rows():
    d = np.load(FRAME0)
    assert d["raw_xy"].shape == (ROWS, S.max_path, 2)
    return _both(d["raw_xy"], d["raw_count"])


@pytest.fixture(scope="module")
def random_rows():
    return _both(*_random_paths(RANDOM_PATHS, seed=0))


def _assert_row(want, got, r):
    assert int(got["count"][r]) == int(want["count"][r]), (r, got["count"][r], want["count"][r])
    for k in ("xy", "yaw"):
        a, b = want[k][r].view(np.int32), got[k][r].view(np.int32)
        assert np.array_equal(a, b), (r, k, int((a != b).sum()))


@pytest.mark.parametrize("row", range(ROWS))
def test_bench_row_linearizes_as_jax(bench_rows, row):
    _assert_row(*bench_rows, row)


def test_bench_rows_cover_the_split_rows(bench_rows):
    """The rows named above are real regression splits: long paths, not the
    passthrough or few-point cases."""
    want, _ = bench_rows
    d = np.load(FRAME0)
    for r in (11, 23, 37, 39, 41, 1, 3, 9, 70):
        assert int(d["raw_count"][r]) > 4 and int(want["count"][r]) > 4, r


@pytest.mark.parametrize("row", range(RANDOM_PATHS))
def test_random_path_linearizes_as_jax(random_rows, row):
    _assert_row(*random_rows, row)
