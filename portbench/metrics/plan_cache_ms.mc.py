"""ms a refill group in the program's ``plan_cache`` span (the batched A*
over worlds x rows x candidates and the linearize): its host seconds in
the traced slice over the groups begun there."""

from portbench.harness.program import per_group


def read(obs):
    return per_group("plan_cache", lambda t: 1e3 * t["seconds"])
