"""Parameter sweeps (``aosx_torch/parallel/sweep.py``) against the JAX
package's ``aosx/parallel/sweep.py``: the grid's order and leaves, the
host-side aggregation and paired comparison on one synthetic table (numpy
equal: the bootstrap draws from ``default_rng(seed)`` in both), and one
2-configuration x 2-orchard cached sweep at DRYRUN_STATICS on the clouds of
the JAX package's keys.

Tolerances as in tests/test_torch_parallel.py: every field bitwise
(FLOAT_BOUND_M, in metres, is 0)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from aosx.config import DRYRUN_STATICS as JS
from aosx.orchards import OrchardSpec as JSpec, make_orchard
from aosx.parallel import sweep as jsweep
from aosx_torch.config import DRYRUN_STATICS as S, AosParams
from aosx_torch.orchards import OrchardSpec
from aosx_torch.parallel import sweep
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

SPEC_KW = dict(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0,
               trunk_pts=10, noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
CPU = torch.device("cpu")
BUDGET, K = 60, 2
INT_FIELDS = ("completed", "steps_to_complete", "final_status", "waypoints", "guards",
              "feasible")
FLOAT_FIELDS = ("travel_distance", "final_dist_to_origin")
FLOAT_BOUND_M = 0.0


def test_grid_params_matches_jax():
    axes = dict(heuristic_weight=[3.0, 1.0], docking_radius=[0.7, 0.25], sm_skipping_hz=[5, 2])
    stacked, configs = sweep.grid_params(device=CPU, **axes)
    jstacked, jconfigs = jsweep.grid_params(**axes)
    assert configs == jconfigs
    # sorted axis names, the last fastest
    assert [c["docking_radius"] for c in configs] == [0.7] * 4 + [0.25] * 4
    assert [c["sm_skipping_hz"] for c in configs] == [5, 2] * 4
    assert_same(jstacked, stacked)  # every leaf: shape [8], dtype, bits
    assert stacked.sm_skipping_hz.dtype == torch.int32
    base = dataclasses.replace(AosParams(), path_step=0.3)
    assert_same(jsweep.grid_params(dataclasses.replace(jsweep.AosParams(), path_step=0.3),
                                   heuristic_weight=[2.0])[0],
                sweep.grid_params(base, device=CPU, heuristic_weight=[2.0])[0])
    with pytest.raises(ValueError):
        sweep.grid_params(device=CPU, not_a_field=[1.0])
    with pytest.raises(ValueError):
        sweep.grid_params(device=CPU)


def _synthetic(P, K_, seed):
    rng = np.random.default_rng(seed)
    n = P * K_
    return dict(
        completed=rng.random(n) < 0.7,
        travel_distance=rng.uniform(40.0, 90.0, n).astype(np.float32),
        steps_to_complete=rng.integers(300, 1200, n).astype(np.int32),
        final_status=rng.integers(0, 4, n).astype(np.int32),
        guards=(rng.random(n) < 0.2).astype(np.int32) * 4,
    )


@pytest.mark.parametrize("P,K_,seed", [(3, 8, 0), (2, 5, 1), (2, 3, 2)])
def test_summarize_and_compare_match_jax(P, K_, seed):
    res = _synthetic(P, K_, seed)
    if seed == 2:
        res["completed"][K_:] = False  # a configuration that never completed
    table, agg = sweep.summarize_sweep(res, P, K_)
    jtable, jagg = jsweep.summarize_sweep(res, P, K_)
    for k in jtable:
        assert np.array_equal(table[k], jtable[k]), k
    for k in jagg:
        assert np.array_equal(agg[k], jagg[k], equal_nan=True), k
    out = sweep.compare_configs(table, 0, 1, n_boot=512, seed=7)
    jout = jsweep.compare_configs(jtable, 0, 1, n_boot=512, seed=7)
    assert out.keys() == jout.keys()
    for f in out:
        for k, v in jout[f].items():
            assert np.array_equal(out[f][k], v, equal_nan=True), (f, k)


@pytest.fixture(scope="module")
def sweeps():
    """The same 2 x 2 cached sweep in both packages, on the JAX keys' clouds."""
    jspec = JSpec(**SPEC_KW)
    axes = dict(heuristic_weight=[3.0, 1.0])
    jstacked, jconfigs = jsweep.grid_params(**axes)
    jres, jstats = jsweep.sweep_rollouts(jstacked, jconfigs, K, jspec, JS, BUDGET, batch=4,
                                         chunk_steps=20, refill=2, seed=5, ror_method="exact",
                                         cached=True)
    clouds = []
    for key in jax.random.split(jax.random.PRNGKey(5), K):
        pc, poly = jax.jit(lambda k: make_orchard(k, jspec, JS))(key)
        n = int(np.asarray(pc.valid).sum())
        clouds.append((np.asarray(pc.xyz)[:n], np.asarray(poly.pts)[:int(poly.count)]))
    calls = []

    def cloud(k):
        calls.append(k)
        return clouds[k]

    stacked, configs = sweep.grid_params(device=CPU, **axes)
    res, stats = sweep.sweep_rollouts(stacked, configs, K, OrchardSpec(**SPEC_KW), S, BUDGET,
                                      batch=4, chunk_steps=20, refill=2, ror_method="exact",
                                      cached=True, clouds=cloud, device=CPU)
    return dict(res=res, stats=stats, jres=jres, jstats=jstats, calls=calls)


def test_sweep_is_configuration_major(sweeps):
    # id c*K + k runs orchard k: every configuration sees the same K clouds
    assert sweeps["calls"] == [0, 1, 0, 1]
    assert sweeps["stats"]["begin_calls"] == sweeps["jstats"]["begin_calls"] == 2
    assert sweeps["stats"]["chunk_calls"] == sweeps["jstats"]["chunk_calls"]


def test_sweep_default_keys_are_jax_keys(sweeps):
    """Without ``clouds`` orchard k of every configuration is drawn from the
    JAX package's ``base_keys = split(PRNGKey(seed), K)``: the records equal
    those of the sweep on those keys' clouds, bitwise."""
    stacked, configs = sweep.grid_params(device=CPU, heuristic_weight=[3.0, 1.0])
    res, _ = sweep.sweep_rollouts(stacked, configs, K, OrchardSpec(**SPEC_KW), S, BUDGET,
                                  batch=4, chunk_steps=20, refill=2, seed=5, ror_method="exact",
                                  cached=True, device=CPU)
    assert_same(sweeps["res"], res)


@pytest.mark.parametrize("field", INT_FIELDS + FLOAT_FIELDS)
def test_sweep_rollouts_match_jax(sweeps, field):
    got, want = sweeps["res"][field], np.asarray(sweeps["jres"][field])
    assert got.shape == (2 * K,)
    if field in FLOAT_FIELDS:
        assert float(np.abs(got.astype(np.float64) - want).max()) <= FLOAT_BOUND_M
    else:
        assert np.array_equal(got, want), (got, want)
