"""The traced slice by the program's own stages: the profiler's events
reduced over the spans the program marks (``aosx_torch.<name>``, host-side
operator events of ``aosx_torch.profiling.span``), beside what
``harness.trace.reduce`` gives over the driver's spans.

- ``program_spans``: for each span name, the count, host seconds and self
  seconds (host seconds less what its child spans cover).
- ``ops_by_program_span``: the device operations (count, device seconds)
  whose launch call lay inside the innermost program span of each name,
  linked through the profiler's correlation ids, not by device start time
  (a launch runs later on a backlogged card). A CUDA graph's operations
  share their ``cudaGraphLaunch``'s id, so they go to the span that
  launched the graph.
- ``idle_by_stage``: the seconds of each gap in the device's activity,
  put down to the innermost program span at the gap's midpoint.

Annotations mirrored on the device's timeline (the driver's, or any that
a program marks as a user annotation) are not device operations here, as
in ``harness.trace``. With ``cuda=False`` (CPU tests) the host's outermost
operations stand in for the device's and link to themselves."""

from __future__ import annotations

import bisect
import dataclasses

from .trace import ANNOTATION, WINDOW, _union

PROGRAM = "aosx_torch."
OUTSIDE = "outside program spans"


@dataclasses.dataclass
class StageSummary:
    # name -> (count, host seconds, self seconds)
    program_spans: dict
    # name -> (device operations launched inside it, their device seconds)
    ops_by_program_span: dict
    # name -> idle seconds whose gap's midpoint lay inside it
    idle_by_stage: dict


class _Spans:
    """Nested spans of one host thread: the innermost holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [a for a, _, _ in self.spans]
        self.parent = []
        stack = []
        for k, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(k)

    def at(self, t) -> int:
        """Index of the innermost span holding t, or -1. The latest span
        to start at or before t either holds it or lies inside the one
        that does."""
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.spans[k][1] <= t:
            k = self.parent[k]
        return k


def reduce_stages(events, cuda: bool = True) -> StageSummary:
    """Reduce the profiler's events (``_KinetoEvent``s) by program span."""
    from torch.autograd import DeviceType

    window = None
    spans = []      # (start, end, name) of the program's spans
    launches = {}   # correlation id -> host start of the launch call
    host_ops = []   # (start, end) of aten and CUDA runtime calls: the CPU stand-ins
    dev = []        # (start, end, correlation id)
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (name.startswith(ANNOTATION) or name.startswith(PROGRAM)
                    or e.is_user_annotation()):
                dev.append((a, b, e.correlation_id()))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(PROGRAM):
            spans.append((a, b, name[len(PROGRAM):]))
        elif name.startswith("cuda"):
            launches[e.correlation_id()] = a
            host_ops.append((a, b))
        elif name.startswith("aten::"):
            host_ops.append((a, b))
    if window is None:
        raise RuntimeError("the profiler recorded no trace window")
    w0, w1 = window
    if not cuda:
        # the outermost host operations, each its own launch
        host_ops.sort()
        end = -1
        for k, (a, b) in enumerate(host_ops):
            if a >= end:
                dev.append((a, b, -1 - k))
                launches[-1 - k] = a
                end = b
    dev = [(max(a, w0), min(b, w1), c) for a, b, c in dev if b > w0 and a < w1]
    tree = _Spans([s for s in spans if s[1] > w0 and s[0] < w1])

    program = {}
    for k, (a, b, n) in enumerate(tree.spans):
        c, t, own = program.get(n, (0, 0.0, 0.0))
        program[n] = (c + 1, t + (b - a) * 1e-9, own + (b - a) * 1e-9)
        p = tree.parent[k]
        if p >= 0:
            pn = tree.spans[p][2]
            c, t, own = program[pn]
            program[pn] = (c, t, own - (b - a) * 1e-9)

    ops = {}
    for a, b, corr in dev:
        t = launches.get(corr)
        k = tree.at(t) if t is not None else -1
        n = tree.spans[k][2] if k >= 0 else OUTSIDE
        c, s = ops.get(n, (0, 0.0))
        ops[n] = (c + 1, s + (b - a) * 1e-9)

    idle = {}
    prev = w0
    for a, b in _union([(a, b) for a, b, _ in dev]) + [[w1, w1]]:
        if a > prev:
            k = tree.at((prev + a) // 2)
            n = tree.spans[k][2] if k >= 0 else OUTSIDE
            idle[n] = idle.get(n, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    return StageSummary(program_spans=program, ops_by_program_span=ops, idle_by_stage=idle)
