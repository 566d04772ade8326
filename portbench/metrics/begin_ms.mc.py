"""ms a refill group of the Monte-Carlo queue: the benchmark's host span
around ``rollout_begin_group`` (orchards, worlds, plan caches and
classification of the group) and the scatter into the lanes, ended by a
synchronise; summed over the window and divided by the groups."""


def read(obs):
    d = obs.spans("begin")
    return 1e3 * sum(d) / len(d) if d else None
