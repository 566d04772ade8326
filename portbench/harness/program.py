"""What the program keeps of the traced slice itself: the totals of the
spans it marks (``aosx_torch.profiling.span_totals``), which it sums only
while a profiler records, so over the traced slice alone. A program that
keeps none (one from before it had spans) gives nothing, and the metrics
that read it are left out of the result."""

from __future__ import annotations


def span_totals() -> dict:
    """{span name: {"count", "seconds", "self_seconds", "counts"}}, or {}."""
    from aosx_torch import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def per_group(name: str, value) -> float | None:
    """``value(totals of span name)`` over the refill groups begun in the
    slice (the program's ``begin`` spans), or None where either is
    missing."""
    t = span_totals()
    if name not in t or not t.get("begin", {}).get("count"):
        return None
    return value(t[name]) / t["begin"]["count"]
