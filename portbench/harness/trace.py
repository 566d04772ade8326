"""The traced slice of a run: ``torch.profiler`` over CPU and CUDA around a
fixed amount of the cell's work, reduced in memory to what the per-layer
metrics and the result's ``breakdown`` read. No trace file is written.

Host annotations (``torch.profiler.record_function``) mark the driver's
spans (``portbench.<span>``); device intervals are every CUDA activity
(kernels, copies, fills) of the profiler's results, on the host's clock."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

ANNOTATION = "portbench."
WINDOW = ANNOTATION + "trace_window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # device time and count by operation name
    by_name: dict
    # device operations whose start lies inside spans of each name
    ops_in_span: dict
    # spans of each name inside the window: count and host seconds
    spans: dict
    # idle seconds by what the host was doing when the device idled
    idle_by_host: dict

    def time_matching(self, *fragments: str) -> tuple[float, int]:
        """(seconds, count) of the device operations whose name holds any
        of ``fragments``."""
        s = n = 0
        for name, (t, c) in self.by_name.items():
            if any(f in name for f in fragments):
                s += t
                n += c
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[_short(k), v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n]


@contextlib.contextmanager
def traced(cuda: bool = True):
    """Profile the block; yields a list that holds the TraceSummary once the
    block has ended. The caller synchronises the device inside the block.
    ``cuda=False`` (the harness's CPU tests): the host's outermost
    operations stand in for the device's."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = []
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
    t0 = time.perf_counter()
    out.append(reduce(prof.profiler.kineto_results.events(), cuda))
    out.append(time.perf_counter() - t0)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def reduce(events, cuda: bool = True) -> TraceSummary:
    """Reduce the profiler's events (``_KinetoEvent``s) to a TraceSummary."""
    from torch.autograd import DeviceType

    window = None
    notes = []      # (start, end, name) of portbench spans
    host_ops = []   # (start, end, name) of host operations (top level found later)
    dev = []        # (start, end, name)
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # the host's annotations are mirrored on the device's timeline
            if not name.startswith(ANNOTATION):
                dev.append((a, b, name))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(ANNOTATION):
            notes.append((a, b, name[len(ANNOTATION):]))
        elif name.startswith("aten::") or name.startswith("cuda"):
            host_ops.append((a, b, name))
    if window is None:
        raise RuntimeError("the profiler recorded no trace window")
    w0, w1 = window
    host_ops.sort()
    top = []
    end = -1
    for a, b, n in host_ops:
        if a >= end:
            top.append((a, b, n))
            end = b
    if not cuda:
        dev = list(top)
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    if not dev:
        raise RuntimeError("no operation ran on the device in the traced window: the profiler "
                           "saw no CUDA activity")
    by_name = {}
    for a, b, n in dev:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + (b - a) * 1e-9, c + 1)
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-9

    notes.sort()
    spans = {}
    for a, b, n in notes:
        c, t = spans.get(n, (0, 0.0))
        spans[n] = (c + 1, t + (b - a) * 1e-9)
    starts = sorted(a for a, _, _ in dev)
    ops_in_span = {}
    for a, b, n in notes:
        k = bisect.bisect_left(starts, a)
        j = bisect.bisect_right(starts, b)
        ops_in_span[n] = ops_in_span.get(n, 0) + (j - k)

    # idle gaps, each put down to the innermost span and the outermost host
    # operation running at its midpoint
    top_starts = [a for a, _, _ in top]
    note_starts = [a for a, _, _ in notes]
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = "outside spans"
        k = bisect.bisect_right(note_starts, mid) - 1
        while k >= 0:
            na, nb, nn = notes[k]
            if na <= mid < nb:
                label = nn
                break
            k -= 1
        k = bisect.bisect_right(top_starts, mid) - 1
        op = top[k][2] if k >= 0 and top[k][0] <= mid < top[k][1] else "python"
        key = f"{label}: {op}"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, by_name=by_name,
                        ops_in_span=ops_in_span, spans=spans, idle_by_host=idle)
