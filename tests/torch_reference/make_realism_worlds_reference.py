"""Digests of the JAX package's realism Monte-Carlo worlds, leaf for leaf.

The realism population of ``benchmarks/bench_sustained.py ... cached
realism``: its orchard (4 rows of 12 m, 3.5 m apart) with ``row_curve=0.8``
and ``dropout=0.15``, rollout id i drawn from
``jax.random.split(PRNGKey(0), 4096)[i]`` by ``aosx.orchards.make_orchard``.
For each case, ``aosx.engine.prepare_world_full(..., with_owner=True)`` in
one jit on the CPU, with ``jfa_dynamic_shifts=True`` as the Monte-Carlo
references are made (``make_mc_harness_reference.py``):

- at MC_REALISM_STATICS: ids 0, 1 (an infeasible tour), 5 (a lane that runs
  out its budget) and 13;
- at MC_STATICS' caps: ids 2 and 7, whose long ridge candidates raise
  GUARD_EDGE_COARSE (``benchmarks/CLASSIFY_realism_default_caps.json``
  lists both).

Writes ``realism_worlds_ref.json`` beside this file: per case the digest
(shape, dtype, sha256) of every leaf of the perceive output, the world and
the owner plane (``tests/torch_helpers.leaf_digests``), and the world's
guard bits; at MC_REALISM_STATICS also of the world's plan cache
(``plancache.build_plan_cache``) and its ``tour_feasibility``. ``tests/test_torch_mc_realism.py`` holds the port's worlds to
it.

Run from the repository root (about 1 minute):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_realism_worlds_reference.py
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx import engine  # noqa: E402
from aosx.config import MC_REALISM_STATICS, MC_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.orchards import OrchardSpec, make_orchard  # noqa: E402
from aosx.plan import plancache  # noqa: E402
from torch_helpers import leaf_digests  # noqa: E402

SPEC = dict(n_rows=4, row_len=12.0, row_spacing=3.5, tree_spacing=1.0, trunk_pts=16,
            noise_pts=64, origin=(4.0, 3.0), polygon_pad=1.5, row_curve=0.8, dropout=0.15)
CASES = {"MC_REALISM_STATICS": (0, 1, 5, 13), "MC_STATICS": (2, 7)}
STATICS = {"MC_STATICS": MC_STATICS, "MC_REALISM_STATICS": MC_REALISM_STATICS}
OUT = HERE / "realism_worlds_ref.json"


def main():
    spec = OrchardSpec(**SPEC)
    params = params_as_f32(AosParams())
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    out = dict(spec=SPEC, population=dict(seed=0, size=4096), jfa_dynamic_shifts=True,
               jax=jax.__version__, cases={})
    for name, ids in CASES.items():
        s = dataclasses.replace(STATICS[name], jfa_dynamic_shifts=True)
        excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)
        orchard = jax.jit(lambda k: make_orchard(k, spec, s))
        build = jax.jit(lambda pc, poly: engine.prepare_world_full(pc, poly, params, excl, s,
                                                                   with_owner=True))
        plans = jax.jit(lambda w: (lambda c: (c, plancache.tour_feasibility(
            c, w.waypoints, params, s)))(plancache.build_plan_cache(w, params, s)))
        for i in ids:
            world, pout, owner = build(*orchard(keys[i]))
            digests = dict(perceive=leaf_digests(pout), world=leaf_digests(world),
                           owner=leaf_digests(owner))
            if name == "MC_REALISM_STATICS":
                cache, feas = plans(world)
                digests.update(cache=leaf_digests(cache), feasibility=leaf_digests(feas))
            out["cases"][f"{name}/{i}"] = dict(statics=name, id=i, guards=int(world.guards),
                                               digests=digests)
            print(f"# {name} id {i}: guards {int(world.guards)}, waypoints "
                  f"{int(world.waypoints.count)}", flush=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
