"""Host reads a refill group: the times the program's group build waited
on the device for a value (its ``host_read.<site>`` counters, moved inside
its ``begin`` spans in the traced slice) over the groups begun there."""

from portbench.harness.program import per_group


def read(obs):
    return per_group("begin", lambda t: sum(n for k, n in t["counts"].items()
                                            if k.startswith("host_read.")))
