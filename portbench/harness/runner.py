"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the comparison with the reference, the result line.

Order of a run: the driver's set-up (inputs from the seed, the initial
state, every shape of the cell warmed) ends ``setup_s``; the window runs
the cell's traffic for ``--seconds`` and gives the end-to-end metrics; with
``--trace 1`` a fixed slice of the same traffic then runs under the
profiler; the driver hands over what the window produced for the check,
frees the program's state, and the reference is run on it."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

from . import roofline, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "aosx")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: ``aosx_torch`` is not
    ``aosx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver and its check are given."""

    seed: int
    device: object
    cell: dict
    config: dict
    traffic: dict
    spans: "Spans"
    counters: dict = dataclasses.field(default_factory=dict)
    # a fault planted in the timed path (the harness's own tests); None in a run
    fault: str | None = None


class Spans:
    """Host-clock spans of the driver's calls into the program, by phase
    ("setup", "window", "traced", "after") and name. Each is also a
    profiler annotation, ``portbench.<name>``."""

    def __init__(self):
        self.phase = "setup"
        self.durations: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        with torch.profiler.record_function("portbench." + name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.durations.setdefault((self.phase, name), []).append(dt)

    def get(self, name: str, phase: str = "window") -> list:
        return self.durations.get((phase, name), [])


@dataclasses.dataclass
class Observed:
    """What a per-layer metric's reader reads."""

    ctx: Context
    trace: object            # harness.trace.TraceSummary
    window_peak_bytes: int

    def spans(self, name: str, phase: str = "window") -> list:
        return self.ctx.spans.get(name, phase)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _metric(value, unit):
    return {"value": float(value), "unit": unit}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device, config: dict | None = None, traffic: dict | None = None,
             fault: str | None = None, check=None):
    """Run a cell once. Returns (result dict without the checks, checks,
    notes): checks maps a compared number's name to (value, limit).
    ``check`` (ctx, produced) -> checks replaces the driver's comparison
    (the control's readings)."""
    import torch

    from .trace import traced

    cfg = config if config is not None else spec.config(bench, cell["config"])
    traffic = traffic if traffic is not None else spec.traffic(cell["traffic"])
    mod = spec.driver(traffic["driver"])
    ctx = Context(seed=seed, device=device, cell=cell, config=cfg, traffic=traffic,
                  spans=Spans(), fault=fault)
    cuda = device.type == "cuda"
    drv = mod.Driver(ctx)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ctx.spans.phase = "window"
    e2e = drv.window(seconds)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    notes = {}
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")

    summary = None
    if trace:
        ctx.spans.phase = "traced"
        with traced(cuda) as out:
            drv.traced()
            _sync(device)
        summary, notes["trace_reduce_s"] = out
        notes["traced"] = {k: v for k, v in ctx.counters.items() if k.startswith("traced")}
        notes["traced_kernels"] = {k: summary.time_matching(n)
                                   for k, n in roofline.KERNEL_NAMES.items()}
    ctx.spans.phase = "after"
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device) if cuda else 0)
    produced = drv.collect()
    drv.release()
    del drv
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = (check or mod.check)(ctx, produced)
    notes["reference_s"] = time.perf_counter() - t_ref

    e2e = dict(e2e, setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in spec.metrics_for(bench, cell["name"], False):
            metrics[m["name"]] = _metric(e2e[m["name"]], m["unit"])
    else:
        obs = Observed(ctx=ctx, trace=summary, window_peak_bytes=window_peak)
        for m in spec.metrics_for(bench, cell["name"], True):
            v = spec.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(e2e["attempted"]), "failed": int(e2e["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary.breakdown()
    notes.update({k: v for k, v in e2e.items() if k not in metrics})
    return result, checks, notes


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result, checks, notes = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                                     t_start, device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    notes["card"] = power_limit()
    notes["cpu_threads"] = torch.get_num_threads()
    print("portbench notes: " + json.dumps(notes, default=float), file=sys.stderr)
    print(check_lines(checks), file=sys.stderr, flush=True)
    print(result_line(result, checks), flush=True)
    return 0


def check_lines(checks: dict) -> str:
    """The compared numbers, each beside its limit, a line each."""
    return "\n".join(f"check {name}: {v!r} limit {lim!r}" for name, (v, lim) in checks.items())


def result_line(result: dict, checks: dict) -> str:
    """The run's last line: the result, the compared numbers last."""
    out = dict(result)
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return json.dumps(out)
