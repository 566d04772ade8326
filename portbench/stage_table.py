"""One run of a cell with ``--trace 1``, as ``run.py`` makes it, whose traced
slice is also reduced by the program's own stages (``harness.stages``):

    python3 portbench/stage_table.py --workload <name> --seed <n> --seconds <s> [--out FILE]

from the root of a checkout. Prints what ``run.py`` prints, then one line
``portbench stages: {...}`` (also written to FILE): the slice's chunk and
group means on the driver's spans, its idle share and device operations a
tick, the program's spans (count, host and self seconds), the device
operations launched in each and their count a tick (tick stages) or a
group (build stages), the idle seconds by stage, how much of ``begin`` its
child spans cover and of ``chunk`` its ticks, and how far the program's
counters moved in the slice (all, a group, and inside the program's
spans: ``host_reads_in_ticks``). Not part of the benchmark's
contract: the run's result line is the benchmark's own."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import portbench.run  # noqa: E402,F401  (the run's environment, set before torch loads)
from portbench.harness import program, runner, spec, stages, trace  # noqa: E402

TICK_STAGES = ("tick", "tick.control", "tick.mission", "tick.move", "tick.metrics", "tick.fold")
BUILD_STAGES = ("begin", "begin.orchard", "perceive", "perceive.points", "perceive.raster",
                "perceive.skeleton", "perceive.rows", "perceive.seeds", "gvd", "gvd.flood",
                "plan_cache", "plan_cache.astar", "plan_cache.linearize", "feasibility")


def _counters():
    from aosx_torch import profiling

    return getattr(profiling, "counters", dict)()


def _moved(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def table(got: dict) -> dict:
    """The stage table of one traced slice."""
    sm, st, c = got["summary"], got["stages"], got["counters"]
    calls, chunk_s = sm.spans["chunk"]
    groups, begin_s = sm.spans.get("begin", (0, 0.0))
    ticks = calls * got["chunk_steps"]
    ps = st.program_spans
    ops = st.ops_by_program_span
    idle = st.idle_by_stage

    def cover(name):
        n, s, own = ps.get(name, (0, 0.0, 0.0))
        return (s - own) / s if s else None

    per_group = {k: v / groups for k, v in c.items() if groups
                 and k.split(".")[0] in ("host_read", "loop_iters", "loop_calls")}
    iters = c.get("loop_iters.astar", 0)
    return {
        "slice_chunk_ms": 1e3 * chunk_s / calls, "slice_begin_ms": 1e3 * begin_s / groups
        if groups else None, "chunk_calls": calls, "groups": groups,
        "idle_pct": 100.0 * (1.0 - sm.busy_s / sm.window_s),
        "launches_per_tick": sm.ops_in_span.get("chunk", 0) / ticks,
        "program_spans": {k: list(v) for k, v in sorted(ps.items())},
        "ops_a_tick": {k: ops.get(k, (0, 0.0))[0] / ticks for k in TICK_STAGES},
        "ops_a_tick_sum": sum(ops.get(k, (0, 0.0))[0] for k in TICK_STAGES) / ticks,
        "ops_a_group": {k: ops.get(k, (0, 0.0))[0] / groups for k in BUILD_STAGES}
        if groups else {},
        "ops_by_program_span": {k: list(v) for k, v in sorted(ops.items())},
        "idle_by_stage": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_named_share": 1.0 - idle.get(stages.OUTSIDE, 0.0) / max(sum(idle.values()), 1e-12),
        "begin_children_cover": cover("begin"), "chunk_ticks_cover": cover("chunk"),
        "astar_ops_an_iteration": ops.get("plan_cache.astar", (0, 0.0))[0] / iters
        if iters else None,
        "counters": c, "counters_a_group": per_group,
        "host_reads_in_ticks": sum(n for k, n in got["span_counts"].get("tick", {}).items()
                                   if k.startswith("host_read.")),
        "counters_in_spans": {k: got["span_counts"][k] for k in ("begin", "chunk")
                              if k in got["span_counts"]},
    }


@contextlib.contextmanager
def recording(driver):
    """Within the block, the runs of ``driver``'s cells also keep their
    traced slice's stages and counter moves: yields the dict that holds
    them ("summary", "stages", "counters", "span_counts", "chunk_steps")
    once a traced run has ended."""
    got = {}
    reduce, traced = trace.reduce, driver.Driver.traced

    def both(events, cuda=True):
        events = list(events)
        got["stages"] = stages.reduce_stages(events, cuda)
        got["summary"] = reduce(events, cuda)
        return got["summary"]

    def counted(self):
        c0, s0 = _counters(), program.span_totals()
        traced(self)
        c1, s1 = _counters(), program.span_totals()
        got["counters"] = _moved(c1, c0)
        got["span_counts"] = {k: _moved(v["counts"], s0.get(k, {}).get("counts", {}))
                              for k, v in s1.items()}
        got["chunk_steps"] = self.ctx.counters["chunk_steps"]

    trace.reduce, driver.Driver.traced = both, counted
    try:
        yield got
    finally:
        trace.reduce, driver.Driver.traced = reduce, traced


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--workload", required=True)
    args, rest = ap.parse_known_args(argv)
    bench = spec.load_benchmark()
    drv = spec.driver(spec.traffic(spec.workload(bench, args.workload)["traffic"])["driver"])
    with recording(drv) as got:
        rc = runner.main(["--workload", args.workload, *rest, "--trace", "1"], T_START)
    if rc:
        return rc
    line = json.dumps(table(got))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print("portbench stages: " + line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
