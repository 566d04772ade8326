"""Tracing and timing harness (mirror of ``aosx/profiling.py``) on
``torch.profiler``: a trace context, a per-stage wall-clock timer that
waits for the device each thunk ran on, and a NaN/Inf guard."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU, and CUDA where a
    card is present) into ``log_dir`` as a Chrome trace; yields the
    profiler, whose ``key_averages()`` sums the time by kernel."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _devices(tree, out):
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            _devices(getattr(tree, k), out)
    return out


def _wait(result):
    """Block until the work behind ``result`` is done on every CUDA device
    its tensors live on."""
    for dev in _devices(result, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return result


def time_stages(stages: Dict[str, Callable[[], object]], reps: int = 5) -> Dict[str, float]:
    """Wall-clock each thunk after one warm-up call (kernel builds
    excluded), waiting for the devices its result lives on. Returns the
    median ms per stage."""
    out = {}
    for name, thunk in stages.items():
        _wait(thunk())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _wait(thunk())
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(ts))
    return out


def nan_guard(x, name: str = "value"):
    """The reference's scattered isfinite checks (e.g.
    voronoi_diagram.cpp:28-30) as one guard: prints a message when ``x``
    holds a NaN or an Inf, and returns ``x`` unchanged either way."""
    if not bool(torch.isfinite(x).all()):
        print(f"NaN/Inf detected in {name}")
    return x
