"""K1's share of its roofline in the Monte-Carlo cells: the least time of
the traced slice's K1 work over the device time of K1's kernel there.

Work: one flood a world of every refill group begun in the slice (the
group's worlds in one launch). Its bound here is the bytes side of
``chip_smoke.py``'s (each world's i32 owner plane once in and once out and
its seed table); the operations side needs each pass's planes, which the
window does not keep. For a group of Monte-Carlo worlds the bytes side is
the larger (PERF.md's kernel table), so the share stays a share of a time
the card cannot beat."""

from portbench.harness.roofline import KERNEL_NAMES, k1_bytes_ms


def read(obs):
    c = obs.ctx.counters
    ms_dev = 1e3 * obs.trace.time_matching(KERNEL_NAMES["k1"])[0]
    if not c.get("traced_begins") or ms_dev <= 0:
        return None
    h, w = c["grid"]
    least = c["traced_begins"] * k1_bytes_ms(c["refill"], h, w, c["seeds"])
    return 100.0 * least / ms_dev
