"""The share of the traced slice in which no operation ran on the card."""


def read(obs):
    t = obs.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
