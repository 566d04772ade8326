"""The share of the Monte-Carlo chunk's control ticks that a replay of the
program's CUDA graph of the whole tick stepped: its ``tick.graphed``
counter, moved inside its ``chunk`` spans in the traced slice, over those
spans x chunk_steps. 1 where every tick is replayed; 0 where the ticks are
launched one operation at a time; nothing from a program without spans."""

from portbench.harness.program import span_totals


def read(obs):
    t = span_totals().get("chunk")
    if not t or not t["count"]:
        return None
    return t["counts"].get("tick.graphed", 0) / (t["count"] * obs.ctx.counters["chunk_steps"])
