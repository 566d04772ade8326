"""A* iterations a refill group: the trips of the plan cache's batched A*
lockstep (the program's ``loop_iters.astar`` counter, moved inside its
``begin`` spans in the traced slice) over the groups begun there."""

from portbench.harness.program import per_group


def read(obs):
    return per_group("begin", lambda t: t["counts"].get("loop_iters.astar", 0))
