"""ms a chunk call of the Monte-Carlo queue: the benchmark's host span from
the call of ``rollout_chunk_cached`` (chunk_steps ticks of every lane) to
the completion read, summed over the window and divided by the calls."""


def read(obs):
    d = obs.spans("chunk")
    return 1e3 * sum(d) / len(d) if d else None
