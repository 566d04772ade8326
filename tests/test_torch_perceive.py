"""The port's perception pass equals the JAX package's leaf for leaf
(occupancy, skeletons, rows, sorted rows, seeds, guards) on the CPU,
bitwise, float leaves included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.perceive import perceive as jperceive
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.perceive import perceive
from aosx_torch.types import PointCloud, Polygon
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401

_JITS = {m: jax.jit(lambda pc, poly, p, ex, m=m: jperceive(pc, poly, p, ex, JS, ror_method=m))
         for m in ("sorted", "exact")}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ror_method", ["sorted", "exact"])
def test_perceive_matches_jax(ror_method, seed):
    buf, valid, poly = orchard_buffers(S, seed=seed)
    ref = _JITS[ror_method](
        JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), JPolygon.from_array(poly, JS),
        jparams(JParams()), jnp.zeros((JS.max_exclusions, 3), jnp.float32))
    got = perceive(
        PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
        Polygon.from_array(poly, S, "cpu"), params_as_f32(AosParams(), "cpu"),
        torch.zeros((S.max_exclusions, 3)), S, ror_method=ror_method)
    assert_same(ref, got)
    assert int(got.seeds.valid.sum()) > 0 and int(got.rows.valid.sum()) == 3


def test_ror_guard_and_nonfinite_points_match_jax():
    """A cloud packed into a 1 cm x-span trips the sorted-sweep block-span
    guard in both packages; NaN points are dropped before the sweep."""
    rng = np.random.default_rng(4)
    n = 3 * 2048
    xyz = np.stack([rng.uniform(5.0, 5.01, n), rng.uniform(4.0, 6.0, n),
                    rng.uniform(-0.2, 0.3, n)], 1).astype(np.float32)
    xyz[::97] = np.nan
    valid = np.ones(n, bool)
    from aosx.perceive.points import ror_counts as jror
    from aosx_torch.perceive.points import ror_counts as tror

    for method in ("sorted", "exact"):
        fin = valid & np.isfinite(xyz).all(1)
        cj, vj = jror(jnp.asarray(xyz), jnp.asarray(fin), 0.2, method=method)
        ct, vt = tror(torch.from_numpy(xyz), torch.from_numpy(fin), 0.2, method=method)
        assert np.array_equal(np.asarray(cj), ct.numpy())
        assert bool(vj) == bool(vt) == (method == "sorted")
