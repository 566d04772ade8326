"""Device operations a control tick of the Monte-Carlo chunk: the
operations (kernels, copies, fills) the profiler saw start inside the
traced slice's chunk spans, over the chunk calls x chunk_steps. Every lane
steps in each of them, so this is a tick of the whole batch."""


def read(obs):
    t = obs.trace
    calls = t.spans.get("chunk", (0, 0.0))[0]
    if not calls:
        return None
    return t.ops_in_span.get("chunk", 0) / (calls * obs.ctx.counters["chunk_steps"])
