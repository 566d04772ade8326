"""ms a refill group in the program's ``perceive`` span (clouds to
occupancy, skeleton, rows and seeds): its host seconds in the traced slice
over the groups begun there."""

from portbench.harness.program import per_group


def read(obs):
    return per_group("perceive", lambda t: 1e3 * t["seconds"])
