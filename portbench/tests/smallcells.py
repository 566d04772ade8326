"""Small versions of the benchmark's cells for the harness's CPU tests:
every cell of BENCHMARK.json with its configuration cut to DRYRUN_STATICS
(a 192 x 256 grid) and a small orchard, and its traffic cut to a few lanes
. The code path is the run's: ``runner.run_cell`` with
the plain kernels of the CPU."""

from __future__ import annotations

import time

from portbench.harness import runner, spec

SEED = 2 ** 31 + 12345

CONFIG_CUTS = {
    "sustained_rollouts": dict(statics="DRYRUN_STATICS", steps_budget=60, chunk_steps=20,
                               statics_overrides={"exact_fallbacks": False}),
}
ORCHARD_CUTS = {
    "sustained_rollouts": dict(n_rows=2, row_len=6.0),
}
TRAFFIC_CUTS = {
    "sustained_rollouts": dict(lanes=8, refill=4, population=512, trace_cycles=1,
                               compare_per_block=2, compare_groups=1),
}


def small(cell_name: str):
    """(bench, cell, config, traffic) of a cell cut to the CPU's size."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    tr = spec.traffic(cell["traffic"])
    kind = tr["driver"]
    cfg.update(CONFIG_CUTS[kind])
    cfg["orchard"].update(ORCHARD_CUTS[kind])
    tr.update(TRAFFIC_CUTS[kind])
    return bench, cell, cfg, tr


def run_small(cell_name: str, trace: bool = False, fault: str | None = None,
              seconds: float = 2.0, seed: int = SEED):
    import torch

    bench, cell, cfg, tr = small(cell_name)
    return runner.run_cell(bench, cell, seed, seconds, trace, time.perf_counter(),
                           torch.device("cpu"), cfg, tr, fault)


def cells():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


def cells_of(driver: str):
    bench = spec.load_benchmark()
    return [w["name"] for w in bench["workloads"]
            if spec.traffic(w["traffic"])["driver"] == driver]
