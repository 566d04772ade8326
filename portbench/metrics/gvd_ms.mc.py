"""ms a refill group in the program's ``gvd`` span (the GVD graph with K1's
flood, the A* cost matrix, the tour's waypoints, the trim plane): its host
seconds in the traced slice over the groups begun there."""

from portbench.harness.program import per_group


def read(obs):
    return per_group("gvd", lambda t: 1e3 * t["seconds"])
