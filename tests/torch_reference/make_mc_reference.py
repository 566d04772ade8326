"""Full-size reference records of the JAX package's Monte-Carlo harness.

Runs ``aosx.parallel.batch.sustained_rollouts`` itself at MC_STATICS (384 x
512 at 0.05 m, max_plan 1024, exact_fallbacks=False) on the CPU, plan-cached,
as ``chip_smoke.py``'s phase 9 runs the port's: 128 rollouts through 64 lanes,
refill groups of 32, a budget of 1,200 ticks in chunks of 150. Its begin,
chunk and finish are jitted and vmapped over the lanes, so every record is
rounded as the harness rounds it (a vmapped chunk rounds the follower's move
and some distances otherwise than one rollout's scan: ``aosx_torch/ops.py``,
``vector_lanes``).

Rollout id i runs the numpy cloud ``make_orchard_np(spec, seed=i)`` of
benchmarks/bench_sustained.py's orchard (4 rows of 12 m, 3.5 m apart, 16
points a trunk, 64 noise points): the harness draws its orchards through
``make_orchard(key, spec, s)``, which this script replaces, for the run, by a
look-up of the 128 clouds at key[1] (the keys are (0, i)); nothing else of
the package is touched. A lane retires at the first chunk boundary at which
``mission.exploration_completed`` is set, or after the budget of 8 chunks;
the mission sets that flag when it leaves the last tour waypoint, so a
retired lane is as a rule still on its way back to the origin (final_status
2, "Returning...").

Writes ``mc_np_seed0.json`` beside this file: per rollout id the fields of
``rollout_finish`` and, to explain a record that differs, the world's tour
length, guard bits, first infeasible leg and plan-cache lengths (from the
harness's begin, jitted and vmapped over refill groups of 32).
``chip_smoke.py`` (phase 9) and ``tests/test_torch_mc_worlds.py`` hold the
PyTorch port's sustained harness to these records.

``jfa_dynamic_shifts=True``: MC_STATICS' own static-shift flood has no
XLA:CPU result (``fusion_calls.py``), and the package runs its CPU probes so
("identical results", ``aosx/config.py``); the port rounds every pass of an
MC_STATICS flood as that lowering's fold (the "xla" rounding of
``aosx_torch/gvd/voronoi.py``).

Run from the repository root (about 2 minutes):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_mc_reference.py
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx import engine  # noqa: E402
from aosx.config import MC_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.orchards import OrchardSpec, make_orchard_np  # noqa: E402
from aosx.parallel import batch  # noqa: E402
from aosx.plan import plancache  # noqa: E402
from aosx.types import PointCloud, Polygon  # noqa: E402

# benchmarks/bench_sustained.py's orchard
MC_SPEC = dict(n_rows=4, row_len=12.0, row_spacing=3.5, tree_spacing=1.0,
               trunk_pts=16, noise_pts=64, origin=(4.0, 3.0), polygon_pad=1.5)
TOTAL, LANES, REFILL = 128, 64, 32
STEPS_BUDGET = 1200
CHUNK_STEPS = 150
OUT = pathlib.Path(__file__).resolve().parent / "mc_np_seed0.json"


def main():
    s = dataclasses.replace(MC_STATICS, jfa_dynamic_shifts=True)
    spec = OrchardSpec(**MC_SPEC)
    params = params_as_f32(AosParams())
    bufs, valids, polys = [], [], []
    for i in range(TOTAL):
        xyz, poly = make_orchard_np(spec, seed=i)
        buf = np.zeros((s.max_points, 3), np.float32)
        buf[:len(xyz)] = xyz
        valid = np.zeros(s.max_points, bool)
        valid[:len(xyz)] = True
        bufs.append(buf)
        valids.append(valid)
        polys.append(Polygon.from_array(poly, s))
    clouds = PointCloud(xyz=jnp.asarray(np.stack(bufs)), valid=jnp.asarray(np.stack(valids)))
    polys = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *polys)

    def cloud_of(key, spec_, s_):
        i = key[1]
        return (PointCloud(xyz=clouds.xyz[i], valid=clouds.valid[i]),
                jax.tree_util.tree_map(lambda x: x[i], polys))

    keys = jnp.stack([jnp.zeros(TOTAL, jnp.uint32), jnp.arange(TOTAL, dtype=jnp.uint32)], 1)
    t0 = time.time()
    make_orchard = batch.make_orchard
    batch.make_orchard = cloud_of
    try:
        res, stats = batch.sustained_rollouts(
            TOTAL, LANES, spec, params, s, STEPS_BUDGET, chunk_steps=CHUNK_STEPS, refill=REFILL,
            ror_method="sorted", cached=True, keys=keys)
    finally:
        batch.make_orchard = make_orchard
    print(f"# harness: {time.time() - t0:.0f} s, {stats['chunk_calls']} chunk calls", flush=True)

    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    @jax.jit
    @jax.vmap
    def extras(key):
        pc, poly = cloud_of(key, spec, s)
        world = engine.prepare_world(pc, poly, params, excl, s, ror_method="sorted")
        cache = plancache.build_plan_cache(world, params, s)
        feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
        return dict(tour=world.waypoints.count, world_guards=world.guards,
                    cache_count=cache.plan_count, cache_success=cache.success,
                    first_bad_leg=feas["first_bad_leg"])

    ex = {k: [] for k in ("tour", "world_guards", "cache_count", "cache_success",
                          "first_bad_leg")}
    for g in range(0, TOTAL, REFILL):
        for k, v in extras(keys[g:g + REFILL]).items():
            ex[k].extend(np.asarray(v).tolist())
    records = []
    for i in range(TOTAL):
        rec = {k: np.asarray(v[i]).item() for k, v in res.items()}
        rec.update(tour=ex["tour"][i], world_guards=ex["world_guards"][i],
                   first_bad_leg=ex["first_bad_leg"][i], cache_count=ex["cache_count"][i],
                   cache_success=[int(b) for b in ex["cache_success"][i]])
        records.append(rec)
    OUT.write_text(json.dumps(dict(
        spec=MC_SPEC, statics="MC_STATICS, jfa_dynamic_shifts=True", total=TOTAL, lanes=LANES,
        refill=REFILL, steps_budget=STEPS_BUDGET, chunk_steps=CHUNK_STEPS, ror_method="sorted",
        context="aosx.parallel.batch.sustained_rollouts, cached", jax=jax.__version__,
        records=records), indent=1) + "\n")
    print(f"wrote {OUT} ({TOTAL} rollouts, {time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
