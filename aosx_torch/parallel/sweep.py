"""Parameter-sweep Monte-Carlo evaluation (mirror of
``aosx/parallel/sweep.py``): many AosParams configurations through the
sustained rollout harness in lockstep lanes.

Stacking P configurations gives an AosParams whose leaves are [P] tensors,
and the lane-batched tick evaluates each lane with its own row:

    stacked, configs = grid_params(heuristic_weight=[1.0, 3.0],
                                   docking_radius=[0.4, 0.7])
    res, stats = sweep_rollouts(stacked, configs, seeds_per_config=32,
                                spec=spec, s=s, steps_budget=1200,
                                batch=128)
    table, agg = summarize_sweep(res, len(configs), 32)

Rollout id layout is configuration-major: id = c * K + k runs configuration
c on orchard k, and every configuration sees the SAME K orchards, so
per-orchard differences between configurations are paired (common random
numbers): rollout id c * K + k draws from ``base_keys[k]``, with ``aosx``'s
``base_keys = prng.split(prng.prng_key(seed), K)``, or runs ``clouds(k)``
where the caller passes clouds.
``summarize_sweep`` and ``compare_configs`` are numpy on the host, this
package's own copies.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import prng, tree
from ..config import AosParams, Statics, params_as_f32
from ..orchards import OrchardSpec
from .batch import default_device, sustained_rollouts


def stack_params(plist, device=None) -> AosParams:
    """[P] AosParams from P configurations (leaves stacked on a new leading
    axis; numeric canonicalisation through params_as_f32)."""
    device = default_device() if device is None else device
    return tree.stack([params_as_f32(p, device) for p in plist])


def grid_params(base: AosParams | None = None, device=None, **axes):
    """Cartesian product over named AosParams fields.

    Returns (stacked [P] AosParams, configs): configs[i] is the dict of axis
    values of row i (axes in sorted-name order, the last fastest:
    itertools.product order)."""
    if not axes:
        raise ValueError("grid_params needs at least one axis")
    base = AosParams() if base is None else base
    for name in axes:
        if not hasattr(base, name):
            raise ValueError(f"AosParams has no field {name!r}")
    names = sorted(axes)
    configs = [dict(zip(names, combo))
               for combo in itertools.product(*[axes[n] for n in names])]
    stacked = stack_params([dataclasses.replace(base, **cfg) for cfg in configs], device)
    return stacked, configs


def sweep_rollouts(stacked: AosParams, configs, seeds_per_config: int, spec: OrchardSpec,
                   s: Statics, steps_budget: int, *, batch: int, chunk_steps: int = 150,
                   refill: int | None = None, seed: int = 0, ror_method: str = "sorted",
                   cached: bool = False, on_progress=None, classify: bool | None = None,
                   clouds=None, device=None):
    """P configurations x seeds_per_config rollouts, configuration-major,
    through sustained_rollouts' lane-refill harness (params_queue). Every
    configuration runs the same seeds_per_config orchard keys,
    ``prng.split(prng.prng_key(seed), seeds_per_config)`` as in ``aosx``, or
    the clouds ``clouds(k)`` for k < seeds_per_config where given.

    Returns (results, stats) exactly like sustained_rollouts; reshape with
    summarize_sweep."""
    P = len(configs)
    assert tree.leaves(stacked)[0].shape[0] == P, "stacked/configs length mismatch"
    K = seeds_per_config
    device = tree.leaves(stacked)[0].device if device is None else device
    queue = tree.tree_map(lambda x: torch.repeat_interleave(x.to(device), K, dim=0), stacked)
    keys = None
    if clouds is None:
        base_keys = prng.split(prng.prng_key(seed, torch.device("cpu")), K)
        keys = base_keys[torch.arange(K).repeat(P)]
    return sustained_rollouts(
        P * K, batch, spec, None, s, steps_budget,
        chunk_steps=chunk_steps, refill=refill, ror_method=ror_method,
        cached=cached, on_progress=on_progress, params_queue=queue, keys=keys,
        clouds=None if clouds is None else (lambda i: clouds(i % K)),
        classify=classify, device=device,
    )


def summarize_sweep(results: dict, P: int, K: int):
    """Reshape sustained results to [P, K] and aggregate per configuration.

    Returns (table, agg): table[k] has shape [P, K]; agg per-config arrays
    [P]: completion_rate, mean/std travel and steps over COMPLETED rollouts
    only (NaN when none completed), failed and guard-flagged counts.
    Guard-flagged lanes are already forced completed=False / status=Failed
    (batch._invalidate_flagged), so no aggregate counts a degraded rollout
    as a success."""
    table = {k: np.asarray(v).reshape((P, K) + np.asarray(v).shape[1:])
             for k, v in results.items()}
    comp = table["completed"].astype(bool)
    n_done = comp.sum(axis=1)

    def _masked(field):
        x = table[field].astype(np.float64)
        tot = np.where(comp, x, 0.0).sum(axis=1)
        mean = np.divide(tot, n_done, out=np.full(P, np.nan), where=n_done > 0)
        var = np.where(comp, (x - mean[:, None]) ** 2, 0.0).sum(axis=1)
        std = np.sqrt(np.divide(var, n_done, out=np.full(P, np.nan), where=n_done > 0))
        return mean, std

    travel_mean, travel_std = _masked("travel_distance")
    steps_mean, steps_std = _masked("steps_to_complete")
    agg = dict(
        completion_rate=n_done / K,
        travel_mean=travel_mean, travel_std=travel_std,
        steps_mean=steps_mean, steps_std=steps_std,
        failed=(table["final_status"] == 1).sum(axis=1),
        guard_flagged=(table["guards"] != 0).sum(axis=1),
    )
    return table, agg


def compare_configs(table, i: int, j: int, *,
                    fields=("travel_distance", "steps_to_complete"),
                    n_boot: int = 4096, seed: int = 0):
    """Paired comparison of configurations i and j (rows i and j of
    ``table`` ran the same K orchards). For each field: per-orchard
    differences d_k = x_i[k] - x_j[k] over orchards where BOTH completed,
    with the mean and a percentile bootstrap CI (resampling orchards with a
    fixed seed). Completion is compared as a paired discordance count.

    Returns a dict: per field {mean_diff, ci_lo, ci_hi, n_pairs}; plus
    completion {rate_i, rate_j, only_i, only_j, n_seeds}. ci_lo/ci_hi are
    NaN when fewer than 2 paired orchards completed."""
    comp = np.asarray(table["completed"]).astype(bool)
    ci_mask = comp[i] & comp[j]
    n_pairs = int(ci_mask.sum())
    rng = np.random.default_rng(seed)
    out = {}
    for f in fields:
        x = np.asarray(table[f], dtype=np.float64)
        d = (x[i] - x[j])[ci_mask]
        if n_pairs == 0:
            out[f] = dict(mean_diff=np.nan, ci_lo=np.nan, ci_hi=np.nan, n_pairs=0)
            continue
        mean = float(d.mean())
        if n_pairs < 2:
            lo = hi = np.nan
        else:
            idx = rng.integers(0, n_pairs, size=(n_boot, n_pairs))
            boot = d[idx].mean(axis=1)
            lo, hi = (float(q) for q in np.percentile(boot, [2.5, 97.5]))
        out[f] = dict(mean_diff=mean, ci_lo=lo, ci_hi=hi, n_pairs=n_pairs)
    out["completion"] = dict(
        rate_i=float(comp[i].mean()), rate_j=float(comp[j].mean()),
        only_i=int((comp[i] & ~comp[j]).sum()),
        only_j=int((~comp[i] & comp[j]).sum()),
        n_seeds=int(comp.shape[1]),
    )
    return out
