"""K2's share of its roofline in the Monte-Carlo cells: the least time of
the traced slice's K2 work over the device time of K2's kernel there.

Work: one thinning a world of every refill group begun in the slice. Its
bound here is the bytes side of ``chip_smoke.py``'s (each world's u8 plane
once in and once out); the operations side needs the iterations and the
words still holding a cell, which the window does not read. For a group of
Monte-Carlo grids the bytes side is the larger (PERF.md's kernel table)."""

from portbench.harness.roofline import KERNEL_NAMES, k2_bytes_ms


def read(obs):
    c = obs.ctx.counters
    ms_dev = 1e3 * obs.trace.time_matching(KERNEL_NAMES["k2"])[0]
    if not c.get("traced_begins") or ms_dev <= 0:
        return None
    h, w = c["grid"]
    return 100.0 * c["traced_begins"] * k2_bytes_ms(c["refill"], h, w) / ms_dev
