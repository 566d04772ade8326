"""Tracing for the port on ``torch.profiler`` (the counterpart of
``aosx/profiling.py``'s trace and NaN guard; its outside timer has none
here): the program's own spans and counters, a trace context that writes
them with the device's activity to a Chrome file, and a NaN/Inf guard.

Spans. ``span(name)`` marks a stage of the program as
``aosx_torch.<name>`` in whatever ``torch.profiler`` session is recording,
in the same event stream as the CUDA activity it launches (so on the
device trace's clock); its parent is the span that encloses it on the one
host thread. With no profiler recording a span does nothing beyond one
check of the profiler's state. A span is a host-side operator event, not a
user annotation, so the profiler mirrors nothing of it on the device's
timeline: the device activity an operator's trace reads is the program's
own. While a profiler records, each span's count, host seconds, self
seconds (less what its child spans cover) and the counters it saw move are
also summed in memory (``span_totals``), so that a profiled stretch can be
read by stage without its trace. A span does nothing while the current
stream is capturing a CUDA graph (``ops.capture_graph``), so no span lies
inside a graph: a graph's kernels are seen under the span around its
replay (the Monte-Carlo chunk's ``tick``), and a tick's stage spans only
where the tick runs uncaptured.

Counters. ``count(name, n)`` adds to a plain integer that always counts, at
the site where the work happens: ``host_read.<site>`` each time the host
waits on the device for a value (the condition reads of ``ops.while_loop``,
the 0-d index of ``ops.take_row``, the union-find overflow in
``perceive.rows``, the domain check of ``f32math.sincos_f32``, the
completion read of ``parallel.batch.sustained_rollouts``),
``loop_iters.<site>`` and ``loop_calls.<site>`` the bodies and the calls of
each ``ops.while_loop`` site, ``graph.capture`` / ``graph.replay`` the
CUDA graphs of ``ops.capture_graph`` (``ops.card_graph`` and the cached
tick of ``parallel.batch.rollout_chunk_cached``), and ``tick.graphed`` the
ticks stepped by a replay of that tick's graph. ``counters()`` returns
them with the hand-written kernels' own launch counts beside them.

An operator sees the spans with ``with profiling.trace(dir):`` around the
work and reads ``profiling.counters()`` before and after it."""

from __future__ import annotations

import contextlib
import os
import time

import torch

PREFIX = "aosx_torch."

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

_counts: dict = {}
# per span name, over the spans run while a profiler recorded
_totals: dict = {}
# the spans open on the host thread while a profiler records, innermost last
_open: list = []


class _Span:
    __slots__ = ("name", "mark", "t0", "child_s", "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.mark.__enter__()
        self.child_s = 0.0
        self.counts = {}
        _open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.mark.__exit__(*exc)
        _open.pop()
        if _open:
            _open[-1].child_s += dt
        tot = _totals.setdefault(self.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                             "counts": {}})
        tot["count"] += 1
        tot["seconds"] += dt
        tot["self_seconds"] += dt - self.child_s
        for k, n in self.counts.items():
            tot["counts"][k] = tot["counts"].get(k, 0) + n
        return False


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def span(name: str):
    """A context manager marking the block as the stage ``name``
    (``aosx_torch.<name>`` in a profiler's trace); nothing while no
    profiler records, or while the current stream captures a CUDA
    graph."""
    if not _profiling() or _capturing():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to the open spans' tallies while
    a profiler records)."""
    _counts[name] = _counts.get(name, 0) + n
    for sp in _open:
        sp.counts[name] = sp.counts.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter, and beside them the launches of the
    hand-written kernels as their wrappers count them
    (``launches.<wrapper>``; K1 also ``passes.jfa_flood``)."""
    from . import probes
    from .gvd import jfa_pass_cuda
    from .perceive import ror_cuda, skeleton_cuda

    out = dict(_counts)
    for f in (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint, ror_cuda.ror_counts,
              probes.chase_rw, probes.chase_ro, probes.gather_rows):
        out["launches." + f.__name__] = f.launches
    out["passes.jfa_flood"] = jfa_pass_cuda.jfa_flood.passes
    return out


def span_totals() -> dict:
    """Per span name, summed over the spans run while a profiler recorded:
    {"count", "seconds" (host), "self_seconds" (less its child spans),
    "counts" (how much each counter moved inside them)}. A copy."""
    return {k: dict(v, counts=dict(v["counts"])) for k, v in _totals.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU, and CUDA where a
    card is present), the program's spans among its events, into
    ``log_dir`` as a Chrome trace; yields the profiler, whose
    ``key_averages()`` sums the time by kernel and by span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def nan_guard(x, name: str = "value"):
    """The reference's scattered isfinite checks (e.g.
    voronoi_diagram.cpp:28-30) as one guard: prints a message when ``x``
    holds a NaN or an Inf, and returns ``x`` unchanged either way."""
    if not bool(torch.isfinite(x).all()):
        print(f"NaN/Inf detected in {name}")
    return x
