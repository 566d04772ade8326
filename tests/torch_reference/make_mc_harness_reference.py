"""Records of the JAX package's own Monte-Carlo harness, on population keys.

Runs ``aosx.parallel.batch.sustained_rollouts`` itself on the CPU, plan-cached,
its lanes under ``vmap`` as ``benchmarks/bench_sustained.py`` runs them, with
``jfa_dynamic_shifts=True`` (MC_STATICS' static-shift flood has no XLA:CPU
result: ``fusion_calls.py``; the package runs its CPU probes so, "identical
results", ``aosx/config.py``). Rollout id i runs
``make_orchard(jax.random.split(PRNGKey(0), 4096)[i], spec, s)``: the first
ids of the population that ``bench_sustained.py`` draws.

Two populations:

- ``straight``: ``bench_sustained.py``'s orchard (4 rows of 12 m, 3.5 m
  apart) at MC_STATICS;
- ``realism``: the same orchard with ``row_curve=0.8`` and ``dropout=0.15``
  (``bench_sustained.py ... cached realism``) at MC_REALISM_STATICS.

each run at three shapes:

- ``phase9``: ids 0-127 through 64 lanes, refill groups of 32 (the shape of
  ``chip_smoke.py``'s phases 9 and 9b);
- ``lanes8``: ids 0, 1, 2, 5, 7, 13, 23 and 58 through 8 lanes, no refill
  (``tests/test_torch_mc_harness.py``);
- ``lane1``: ids 2 and 7 through one lane, refilled once (the same test);

with a budget of 1,200 ticks in chunks of 150. Writes every field of every
record (``rollout_finish``'s, ``feasible`` included) to
``mc_harness_ref.json`` beside this file, under ``populations`` (each with its
spec and statics, then a shape's ids, lanes, refill and records). A shape's
name as an argument runs that shape alone and keeps the file's other entries.

Run from the repository root (about 4 minutes for all six runs):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_mc_harness_reference.py [SHAPE ...]
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

from aosx.config import MC_REALISM_STATICS, MC_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.orchards import OrchardSpec  # noqa: E402
from aosx.parallel.batch import sustained_rollouts  # noqa: E402

# benchmarks/bench_sustained.py's orchard, and its realism knobs
MC_SPEC = dict(n_rows=4, row_len=12.0, row_spacing=3.5, tree_spacing=1.0,
               trunk_pts=16, noise_pts=64, origin=(4.0, 3.0), polygon_pad=1.5)
REALISM = dict(row_curve=0.8, dropout=0.15)
POPULATIONS = {"straight": (MC_SPEC, "MC_STATICS"),
               "realism": (dict(MC_SPEC, **REALISM), "MC_REALISM_STATICS")}
STATICS = {"MC_STATICS": MC_STATICS, "MC_REALISM_STATICS": MC_REALISM_STATICS}
POPULATION_SIZE, SEED = 4096, 0
SHAPES = {"phase9": dict(ids=list(range(128)), lanes=64, refill=32),
          "lanes8": dict(ids=[0, 1, 2, 5, 7, 13, 23, 58], lanes=8, refill=8),
          "lane1": dict(ids=[2, 7], lanes=1, refill=1)}
STEPS_BUDGET, CHUNK_STEPS = 1200, 150
OUT = pathlib.Path(__file__).resolve().parent / "mc_harness_ref.json"


def population_keys(ids):
    return jax.random.split(jax.random.PRNGKey(SEED), POPULATION_SIZE)[np.asarray(ids)]


def run(population, shape):
    spec_kw, statics = POPULATIONS[population]
    s = dataclasses.replace(STATICS[statics], jfa_dynamic_shifts=True)
    sh = SHAPES[shape]
    t0 = time.time()
    res, stats = sustained_rollouts(
        len(sh["ids"]), sh["lanes"], OrchardSpec(**spec_kw), params_as_f32(AosParams()), s,
        STEPS_BUDGET, chunk_steps=CHUNK_STEPS, refill=sh["refill"], ror_method="sorted",
        cached=True, classify=True, keys=population_keys(sh["ids"]))
    records = [{k: np.asarray(v[i]).item() for k, v in res.items()}
               for i in range(len(sh["ids"]))]
    print(f"# {population} {shape}: {time.time() - t0:.0f} s, {stats['chunk_calls']} chunk "
          f"calls, completed {int(res['completed'].sum())}, infeasible "
          f"{int((res['feasible'] == 0).sum())}, flagged {int((res['guards'] != 0).sum())}",
          flush=True)
    return dict(ids=sh["ids"], lanes=sh["lanes"], refill=sh["refill"], records=records)


def main(shapes):
    out = json.loads(OUT.read_text()) if OUT.exists() else {}
    out.update(population=dict(seed=SEED, size=POPULATION_SIZE), steps_budget=STEPS_BUDGET,
               chunk_steps=CHUNK_STEPS, ror_method="sorted", cached=True,
               jfa_dynamic_shifts=True, jax=jax.__version__)
    pops = out.setdefault("populations", {})
    for population, (spec_kw, statics) in POPULATIONS.items():
        entry = pops.setdefault(population, {})
        entry.update(spec=spec_kw, statics=statics)
        for shape in shapes:
            entry[shape] = run(population, shape)
            OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1:] or list(SHAPES))
