"""The yardstick of the kernels' rooflines: the card's published peaks and
the least time of each kernel's work, copied from ``chip_smoke.py``
(``bound``, ``k2_group_bound``, ``k3_bound``) so that
the program can change without moving it.

Peaks: NVIDIA's H100 SXM data sheet at 700 W: 3.35 TB/s of HBM; 67 TFLOP/s
FP32 counts an FMA as two, so FP32 instructions issue at half of it; INT32
runs on 64 of an SM's 128 lanes, half again; the four sub-partitions of an
SM dispatch one warp instruction a clock, 132 x 128 lanes at 1.98 GHz, which
caps FP32 and INT32 instructions together."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
SM_CLOCK_HZ = 1.98e9
DISPATCH_OPS_PER_S = 132 * 128 * SM_CLOCK_HZ
# K2's logic operations a 32-cell word and sub-iteration (chip_smoke.py)
K2_OPS_PER_WORD = 50

# the kernels' function names in the program's CUDA sources
KERNEL_NAMES = {"k1": "flood_kernel", "k2": "fixpoint_kernel", "k3": "ror_counts_kernel"}


def bound(n_bytes, fp32_ops=0.0, int32_ops=0.0):
    """(least ms, "bytes" or "operations"): the larger of moving n_bytes
    through HBM and issuing the operations at the card's peak rates, the
    FP32 and INT32 pipes side by side under the one dispatch rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_OPS_PER_S, int32_ops / INT32_OPS_PER_S,
                (fp32_ops + int32_ops) / DISPATCH_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bytes_ms(worlds: int, h: int, w: int, n_seeds: int) -> float:
    """K1's byte bound for ``worlds`` floods of h x w cells over n_seeds
    seeds: each world's i32 owner plane read once and written once, and its
    seed table (n_seeds + 1 rows of two f32) read once."""
    return bound(worlds * (8 * h * w + 8 * (n_seeds + 1)))[0]


def k2_bytes_ms(worlds: int, h: int, w: int) -> float:
    """K2's byte bound: each world's u8 plane read once and written once."""
    return bound(2 * worlds * h * w)[0]


def k2_ops_ms(iterations, words) -> float:
    """K2's operation bound: for each world, its iterations x two
    sub-iterations of the circuit over the words still holding a cell."""
    return bound(0, int32_ops=sum(it * 2.0 * K2_OPS_PER_WORD * w
                                  for it, w in zip(iterations, words)))[0]


def k3_bound(worlds: int, m: int):
    """K3's bound for ``worlds`` clouds of m points (the padded buffer):
    (ms, "bytes" or "operations"). The m (m + 1) / 2 distinct and self pairs
    a world, each 6 FP32 instructions and an INT32 add; 12 B a point in, 4
    B a count out."""
    pairs = worlds * m * (m + 1) / 2
    return bound(16 * worlds * m, fp32_ops=6.0 * pairs, int32_ops=pairs)
