"""Full-size reference records of the JAX package's Monte-Carlo path.

Runs ``aosx``'s plan-cached rollout at MC_STATICS (384 x 512 at 0.05 m,
max_plan 1024, exact_fallbacks=False) on the CPU, per cloud:

    prepare_world -> build_plan_cache -> tour_feasibility      (one jit)
    -> rollout_chunk_cached (150 ticks, one jit) until the lane retires
    -> rollout_finish

A lane retires as ``sustained_rollouts`` retires it: at the first chunk
boundary at which ``mission.exploration_completed`` is set, or after the
budget of 8 chunks. The mission sets that flag when it leaves the last tour
waypoint, so a retired lane is as a rule still on its way back to the origin
(final_status 2, "Returning..."): the record is the harness's, not the
fixed-budget rollout's. The fixed-budget record (all 8 chunks) is kept beside
it under ``full_budget``.

on the numpy clouds ``make_orchard_np(spec, seed=i)``, i = 0..127, of
benchmarks/bench_sustained.py's orchard (4 rows of 12 m, 3.5 m apart, 16
points a trunk, 64 noise points), and writes ``mc_np_seed0.json`` beside this
file: per rollout id the fields of ``rollout_finish``, the chunks run and, to explain a
record that differs, the world's tour length, guard bits and plan-cache
lengths. ``chip_smoke.py`` holds the PyTorch port's sustained harness on the
GPU to these records.

``jfa_dynamic_shifts=True`` shortens the XLA:CPU compile from more than half
an hour to seconds; every JFA lowering of ``aosx`` gives the same owners
(aosx/config.py).

Run from the repository root (about 1 minute):

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
from aosx.parallel.batch import _acc_init, rollout_chunk_cached, rollout_finish  # noqa: E402
from aosx.plan import plancache  # noqa: E402
from aosx.types import PointCloud, Polygon  # noqa: E402

# benchmarks/bench_sustained.py's orchard
MC_SPEC = dict(n_rows=4, row_len=12.0, row_spacing=3.5, tree_spacing=1.0,
               trunk_pts=16, noise_pts=64, origin=(4.0, 3.0), polygon_pad=1.5)
TOTAL = 128
STEPS_BUDGET = 1200
CHUNK_STEPS = 150
OUT = pathlib.Path(__file__).resolve().parent / "mc_np_seed0.json"


def main():
    s = dataclasses.replace(MC_STATICS, jfa_dynamic_shifts=True)
    spec = OrchardSpec(**MC_SPEC)
    params = params_as_f32(AosParams())
    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    @jax.jit
    def begin(pc, poly, params):
        world = engine.prepare_world(pc, poly, params, excl, s, ror_method="sorted")
        cache = plancache.build_plan_cache(world, params, s)
        feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
        acc = _acc_init(s, STEPS_BUDGET)
        acc["feasible"] = feas["feasible"].astype(jnp.int32)
        extra = dict(tour=world.waypoints.count, world_guards=world.guards,
                     cache_count=cache.plan_count, cache_success=cache.success,
                     first_bad_leg=feas["first_bad_leg"])
        return (plancache.world_lite(world), cache, plancache.initial_cached_state(world, s),
                acc, extra)

    chunk = jax.jit(lambda lite, cache, st, acc, params, off: rollout_chunk_cached(
        lite, cache, st, acc, params, s, CHUNK_STEPS, off))

    def rollout(pc, poly, params):
        lite, cache, st, acc, extra = begin(pc, poly, params)
        out = None
        for c in range(STEPS_BUDGET // CHUNK_STEPS):
            st, acc = chunk(lite, cache, st, acc, params, jnp.int32(c * CHUNK_STEPS))
            if out is None and bool(st.mission.exploration_completed):
                out = dict(rollout_finish(st, acc, s), chunks=c + 1)
        full = rollout_finish(st, acc, s)
        if out is None:
            out = dict(full, chunks=STEPS_BUDGET // CHUNK_STEPS)
        return out, dict(extra, full_budget=full)

    records = []
    t0 = time.time()
    for i in range(TOTAL):
        xyz, poly = make_orchard_np(spec, seed=i)
        buf = np.zeros((s.max_points, 3), np.float32)
        buf[:len(xyz)] = xyz
        valid = np.zeros(s.max_points, bool)
        valid[:len(xyz)] = True
        out, extra = rollout(PointCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)),
                             Polygon.from_array(poly, s), params)
        rec = {k: np.asarray(v).item() for k, v in out.items()}
        rec.update(full_budget={k: np.asarray(v).item() for k, v in extra["full_budget"].items()},
                   tour=int(extra["tour"]), world_guards=int(extra["world_guards"]),
                   first_bad_leg=int(extra["first_bad_leg"]),
                   cache_count=np.asarray(extra["cache_count"]).tolist(),
                   cache_success=np.asarray(extra["cache_success"]).astype(int).tolist())
        records.append(rec)
        print(f"# rollout {i}: {time.time() - t0:.0f} s, "
              f"{ {k: rec[k] for k in out} }", flush=True)
    OUT.write_text(json.dumps(dict(
        spec=MC_SPEC, statics="MC_STATICS, jfa_dynamic_shifts=True", total=TOTAL,
        steps_budget=STEPS_BUDGET, chunk_steps=CHUNK_STEPS, ror_method="sorted", jax=jax.__version__,
        records=records), indent=1) + "\n")
    print(f"wrote {OUT} ({TOTAL} rollouts, {time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
