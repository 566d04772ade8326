"""Primitive-cost probes on the card: the counterpart of
``benchmarks/probe_pallas_prims.py``.

The TPU script asked Mosaic whether a kernel may index a table with a scalar
computed in the kernel (P1 in SMEM with writes, P2 in VMEM read-only) and
gather along rows inside a kernel (P3), beside two XLA baselines (P3b, P4).
On Hopper both are ordinary, so the probes measure their price: what one
dependent scalar step and one data-dependent gather cost, which a union-find
or a crossing-filter kernel needs to know.

  P1  chase_rw      one thread, N = 65,536-entry i32 table:
                    parent[i] = i, then 65,536 dependent steps
                    j = (c*1103515245 + 12345) & (N-1); v = parent[j];
                    parent[(j+1) & (N-1)] = v; c = v ^ i   (i32, wrapping)
                    The kernel keeps the table in shared memory as u16 (N <=
                    65,536), or in global memory with ``shared=False``
  P2  chase_ro      one thread, a 4,096-entry table (shared memory), 8,192
                    dependent reads c = tab[j] ^ i
  P3  gather_rows   64 rounds of acc += take_along_axis(x, (idx+acc) & 2047)
                    on i32 [512, 2048]
  P3b               the plain PyTorch version of P3 (torch.gather per round)
  P4                16 rounds of a flat gather of 262,144 from a u8 plane of
                    2000 x 2048 (plain PyTorch)

The kernels are CUDA C++ (``aosx_torch/csrc/probe_prims.cu``). Each wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor it
launches its kernel (counted in ``<wrapper>.launches``) or raises. Beside
the plain versions stand plain mirrors of the kernels' own schemes (P1's
chain with each load ahead of the store before it, P3's staged-row layout),
which the CPU tests hold against the plain versions, and the count of
shared-memory wavefronts that a run's indices force on P3's loads.
``shared_load_clocks`` measures the shared-memory load-to-use latency on the
card, the latency in P1's and P2's bounds.

Run: ``python3 -m aosx_torch.probes [p1 p2 p3 p3b p4] [--device cpu]``
prints one line per probe; on the card the times are CUDA-event medians,
with the card kept busy ahead of each timed call.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from . import cuda_build

LCG_A = 1103515245
LCG_C = 12345
U32 = 0xFFFFFFFF

P1_N = 65536
P1_STEPS = 65536
# the largest table the shared-memory kernel holds (u16 entries, 128 KB)
P1_SMEM_MAX = 65536
P2_N = 4096
P2_STEPS = 8192
P3_ROWS = 512
P3_COLS = 2048
P3_ROUNDS = 64
# the kernel's block (a thread owns 4 columns) and staged row (xs, 4-byte words)
P3_THREADS = 512
P3_SMEM_WORDS = 2048
# shared_load_clocks' table: entry i points at entry (i + 97) & 1023
LAT_N = 1024
LAT_STRIDE = 97
LAT_LOADS = 8192
P4_CELLS = 2000 * 2048
P4_N = 262144
P4_ROUNDS = 16
SEED = 3


def _to_i32(c):
    """The i32 whose bits are the u32 value held in an i64 tensor."""
    return torch.where(c >= 2**31, c - 2**32, c).to(torch.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def chase_rw_plain(seed, n: int = P1_N, steps: int = P1_STEPS):
    """P1 as a loop over a tensor on seed's device. The i32 wrap of the
    multiply-add is written out on i64 values: the product of two u32 values
    below 2^31 * 2^32 fits, ``& 0xFFFFFFFF`` wraps it. Returns (c i32 [1],
    table i32 [n])."""
    dev = seed.device
    parent = torch.arange(n, dtype=torch.int64, device=dev)
    c = seed.reshape(()).to(torch.int64) & U32
    for i in range(steps):
        j = ((c * LCG_A + LCG_C) & U32) & (n - 1)
        v = parent[j]
        parent[(j + 1) & (n - 1)] = v
        c = (v ^ i) & U32
    return _to_i32(c).reshape(1), _to_i32(parent & U32)


def chase_ro_plain(seed, steps: int = P2_STEPS):
    """P2 as a loop over a tensor on seed's device (table of 4,096, laid out
    [32, 128] row-major in the TPU probe: the flat index is the same).
    Returns c i32 [1]."""
    dev = seed.device
    tab = torch.arange(P2_N, dtype=torch.int64, device=dev)
    c = seed.reshape(()).to(torch.int64) & U32
    for i in range(steps):
        j = ((c * LCG_A + LCG_C) & U32) & (P2_N - 1)
        c = (tab[j] ^ i) & U32
    return _to_i32(c).reshape(1)


def gather_rows_plain(x, idx, rounds: int = P3_ROUNDS):
    """P3 (and the TPU script's p3b): rounds of torch.gather along rows with
    wrapping i32 adds."""
    mask = x.shape[1] - 1
    acc = torch.zeros_like(x)
    for _ in range(rounds):
        acc = acc + torch.gather(x, 1, ((idx + acc) & mask).long())
    return acc


def flat_gather_plain(occ, idx, rounds: int = P4_ROUNDS):
    """P4: rounds of acc += occ[(idx + acc) % len(occ)] on i32 [n]."""
    acc = torch.zeros_like(idx)
    for _ in range(rounds):
        acc = acc + occ[((idx + acc) % occ.shape[0]).long()].to(torch.int32)
    return acc


# ---------------------------------------------------------------------------
# plain mirrors of the kernels' schemes (csrc/probe_prims.cu)
# ---------------------------------------------------------------------------


def chase_rw_pipelined_plain(seed, n: int = P1_N, steps: int = P1_STEPS):
    """P1 as the shared-memory kernel runs it (``chase_smem_chain``), in
    Python ints: byte offsets into a u16 table, step i+1's load ahead of
    step i's store, and the forward folded into the xor through the mask m.
    Returns (c i32 [1], table i32 [n], forwards), c and table as
    ``chase_rw_plain`` gives them; forwards counts the steps whose load read
    the entry that the step before wrote."""
    a2, c2, mask2 = (2 * LCG_A) & U32, 2 * LCG_C, 2 * (n - 1)
    tab = list(range(n))
    c = int(seed.reshape(())) & U32
    forwards = 0
    if steps > 0:
        jb = (c * a2 + c2) & U32 & mask2
        vl = tab[jb >> 1]
        m = w = 0
        for i in range(steps - 1):
            c = (vl & ~m & U32) ^ w
            v = c ^ i
            sb = (jb + 2) & mask2
            jb = (c * a2 + c2) & U32 & mask2
            vl = tab[jb >> 1]
            tab[sb >> 1] = v & 0xFFFF
            m = U32 if jb == sb else 0
            forwards += jb == sb
            w = (v & m) ^ (i + 1)
        c = (vl & ~m & U32) ^ w
        tab[((jb + 2) & mask2) >> 1] = (c ^ (steps - 1)) & 0xFFFF
    table = torch.tensor(tab, dtype=torch.int64)
    return _to_i32(torch.tensor([c])), _to_i32(table), forwards


def gather_layout(a):
    """P3's staged-row layout, the word of xs that holds column a < 2048:
    bits 5-10 kept, bits 0-4 xored with bits 6-10 (a bijection). In the
    identity layout columns a multiple of 32 apart share a bank, so indices
    with a power-of-two stride serialise a warp's load; the xor spreads
    them."""
    return a ^ (a >> 6)


def gather_lanes(device=None):
    """[64, 32] columns of a row: for each warp-wide load of a round (4
    chains of a thread, 16 warps), the columns its 32 lanes gather for.
    Thread q = 32w + l owns columns 4q + j, j < 4."""
    j, w, lane = torch.meshgrid(*(torch.arange(k, device=device) for k in (4, 16, 32)),
                                indexing="ij")
    return (4 * (32 * w + lane) + j).reshape(-1, 32)


def gather_rows_layout_plain(x, idx, rounds: int = P3_ROUNDS):
    """P3 as the kernel computes it: x staged through ``gather_layout``,
    t = idx + acc carried (a round is t += xs[layout(t & 2047)]), acc = t -
    idx at the end; i32 wrapping."""
    mask = x.shape[1] - 1
    xs = torch.empty_like(x)
    xs[:, gather_layout(torch.arange(x.shape[1], device=x.device))] = x
    t = idx.clone()
    for _ in range(rounds):
        t = t + torch.gather(xs, 1, gather_layout(t & mask).long())
    return t - idx


def bank_wavefronts(words):
    """Shared-memory wavefronts of warp-wide 4-byte loads: words [..., 32]
    holds each lane's word address. A bank (word % 32) serves one distinct
    word a wavefront; lanes that read one word share it. Returns [...]."""
    w = torch.sort(words.long(), dim=-1).values
    first = torch.ones_like(w, dtype=torch.int32)
    first[..., 1:] = (w[..., 1:] != w[..., :-1]).int()
    counts = torch.zeros(w.shape[:-1] + (32,), dtype=torch.int32, device=w.device)
    counts.scatter_add_(-1, w & 31, first)
    return counts.amax(-1)


def gather_wavefronts(x, idx, rounds: int = P3_ROUNDS, *, layout=gather_layout, lanes=None):
    """Mean wavefronts a warp-wide load of P3 over all rounds, counted from
    the plain version's indices of each round through ``layout``, with the
    lanes of ``gather_lanes`` (or [k, 32] columns ``lanes``)."""
    lanes = gather_lanes(x.device) if lanes is None else lanes
    mask = x.shape[1] - 1
    acc = torch.zeros_like(x)
    total = 0
    for _ in range(rounds):
        a = (idx + acc) & mask
        total += int(bank_wavefronts(layout(a)[:, lanes]).sum(dtype=torch.int64))
        acc = acc + torch.gather(x, 1, a.long())
    return total / (rounds * x.shape[0] * lanes.shape[0])


# ---------------------------------------------------------------------------
# inputs of the TPU script
# ---------------------------------------------------------------------------


def seed_tensor(device, seed: int = SEED):
    return torch.tensor([seed], dtype=torch.int32, device=device)


def gather_rows_inputs(device, rows: int = P3_ROWS):
    """x = iota & 1023, idx = (x*7 + 13) & 2047 on i32 [rows, 2048]."""
    x = torch.arange(rows * P3_COLS, dtype=torch.int32, device=device).reshape(rows, P3_COLS) & 1023
    return x, (x * 7 + 13) & (P3_COLS - 1)


def gather_rows_random_inputs(device, rows: int = P3_ROWS, seed: int = 0):
    """x and idx on i32 [rows, 2048], both over the whole i32 range (so sums
    wrap), from a seeded torch.Generator on the CPU: unstructured indices."""
    g = torch.Generator().manual_seed(seed)
    x, idx = (torch.randint(-2**31, 2**31, (rows, P3_COLS), dtype=torch.int32, generator=g)
              for _ in range(2))
    return x.to(device), idx.to(device)


def flat_gather_inputs(device):
    """occ = (iota & 7) as u8 [2000*2048]; idx = (iota * 48271, wrapped to
    i32) mod 2000*2048, the non-negative remainder."""
    occ = (torch.arange(P4_CELLS, dtype=torch.int32, device=device) & 7).to(torch.uint8)
    prod = (torch.arange(P4_N, dtype=torch.int64, device=device) * 48271) & U32
    return occ, _to_i32(prod) % P4_CELLS


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_vp = ctypes.c_void_p
_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("probe_prims")
    lib.probe_chase_rw.argtypes = [_vp, _vp, _int, _int, _vp, _vp]
    lib.probe_chase_rw_smem.argtypes = [_vp, _vp, _int, _int, _vp, _vp]
    lib.probe_chase_ro.argtypes = [_vp, _int, _vp, _vp]
    lib.probe_gather_rows.argtypes = [_vp, _vp, _vp, _int, _int, _vp]
    lib.probe_smem_latency.argtypes = [_vp, _int, _int, _int, _int, _vp]
    for fn in (lib.probe_chase_rw, lib.probe_chase_rw_smem, lib.probe_chase_ro,
               lib.probe_gather_rows, lib.probe_smem_latency):
        fn.restype = _int
    return lib


def _check_seed(seed, what):
    if seed.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {seed.device}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"{what}: seed must be one int32 value")


def chase_rw(seed, n: int = P1_N, steps: int = P1_STEPS, *, shared: bool = True):
    """P1 from ``seed`` (i32 [1]). Returns (c i32 [1], table i32 [n]). A
    CPU seed takes the plain version; a CUDA seed launches the kernel, with
    the table in shared memory as u16 (n <= 65,536) or, with
    ``shared=False``, in global memory (any n)."""
    if seed.device.type == "cpu":
        return chase_rw_plain(seed, n, steps)
    _check_seed(seed, "chase_rw")
    if shared and n > P1_SMEM_MAX:
        raise ValueError(f"chase_rw: a shared-memory table holds at most {P1_SMEM_MAX} entries")
    table = torch.empty(n, dtype=torch.int32, device=seed.device)
    out = torch.empty(1, dtype=torch.int32, device=seed.device)
    fn = _lib().probe_chase_rw_smem if shared else _lib().probe_chase_rw
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    cuda_build.check(fn(table.data_ptr(), out.data_ptr(), n, steps, seed.data_ptr(), stream),
                     "probe_chase_rw")
    chase_rw.launches += 1
    return out, table


chase_rw.launches = 0


def chase_ro(seed, steps: int = P2_STEPS):
    """P2 from ``seed`` (i32 [1]). Returns c i32 [1]."""
    if seed.device.type == "cpu":
        return chase_ro_plain(seed, steps)
    _check_seed(seed, "chase_ro")
    out = torch.empty(1, dtype=torch.int32, device=seed.device)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    cuda_build.check(_lib().probe_chase_ro(out.data_ptr(), steps, seed.data_ptr(), stream),
                     "probe_chase_ro")
    chase_ro.launches += 1
    return out


chase_ro.launches = 0


def gather_rows(x, idx, rounds: int = P3_ROUNDS):
    """P3 on i32 [rows, 2048] tensors x and idx. Returns acc i32 [rows, 2048]."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, rounds)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"gather_rows: unsupported devices {x.device}, {idx.device}")
    for t in (x, idx):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != P3_COLS
                or t.shape != x.shape or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"gather_rows: x and idx must be contiguous, 16-byte aligned "
                             f"[rows, {P3_COLS}] int32 tensors of one shape")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check(_lib().probe_gather_rows(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                              x.shape[0], rounds, stream),
                     "probe_gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def shared_load_clocks(device, *, wide: bool = False, loads: int = LAT_LOADS) -> float:
    """SM clocks from a shared-memory load's issue to the next load that
    takes its value as the address, measured on the card: one thread chases
    through a table of u16 (u32 with ``wide``) shared-window addresses with
    no operation between two loads. A latency has no plain version, so a
    device other than the card raises."""
    if device.type != "cuda":
        raise ValueError(f"shared_load_clocks: measures the card, not {device}")
    out = torch.zeros(2, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_build.check(_lib().probe_smem_latency(out.data_ptr(), LAT_N, LAT_STRIDE, loads,
                                               int(wide), stream),
                     "probe_smem_latency")
    clocks, last = out.tolist()
    if last != loads * LAT_STRIDE % LAT_N:
        raise RuntimeError(f"shared_load_clocks: the chase ended at entry {last}")
    return clocks / loads


# ---------------------------------------------------------------------------
# the probe entry point
# ---------------------------------------------------------------------------


def p1(device):
    seed = seed_tensor(device)
    (c, _), ms = cuda_build.timed_ms(lambda: chase_rw(seed), device)
    line = (f"P1 scalar read+write chase: c = {int(c)}, {ms:.3f} ms, "
            f"{ms * 1e6 / P1_STEPS:.1f} ns/step ({P1_N} entries, {P1_STEPS} steps)")
    if device.type == "cuda":
        (c2, _), ms2 = cuda_build.timed_ms(lambda: chase_rw(seed, shared=False), device)
        line += (f"; global-memory table: c = {int(c2)}, {ms2:.3f} ms, "
                 f"{ms2 * 1e6 / P1_STEPS:.1f} ns/step")
    return line


def p2(device):
    seed = seed_tensor(device)
    c, ms = cuda_build.timed_ms(lambda: chase_ro(seed), device)
    return (f"P2 scalar read-only chase, shared-memory table: c = {int(c)}, {ms:.3f} ms, "
            f"{ms * 1e6 / P2_STEPS:.1f} ns/step ({P2_N} stores + {P2_STEPS} steps)")


def _p3_line(name, fn, device):
    x, idx = gather_rows_inputs(device)
    out, ms = cuda_build.timed_ms(lambda: fn(x, idx), device)
    n = x.numel() * P3_ROUNDS
    return (f"{name}: sum = {int(out.sum(dtype=torch.int64))}, {ms:.3f} ms, "
            f"{ms * 1e6 / n:.4f} ns/element ({n} gathered)")


def p3(device):
    return _p3_line("P3 row gather in a kernel", gather_rows, device)


def p3b(device):
    return _p3_line("P3b row gather, torch.gather a round", gather_rows_plain, device)


def p4(device):
    occ, idx = flat_gather_inputs(device)
    out, ms = cuda_build.timed_ms(lambda: flat_gather_plain(occ, idx), device)
    n = P4_N * P4_ROUNDS
    return (f"P4 flat gather, plain PyTorch, 262k x {P4_ROUNDS}: sum = "
            f"{int(out.sum(dtype=torch.int64))}, {ms:.3f} ms, {ms * 1e6 / n:.4f} ns/element")


PROBES = dict(p1=p1, p2=p2, p3=p3, p3b=p3b, p4=p4)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = torch.device("cuda", 0)
    if "--device" in args:
        k = args.index("--device")
        device = torch.device(args[k + 1])
        del args[k:k + 2]
    if device.type == "cuda":
        print(f"# {torch.cuda.get_device_name(device)}", flush=True)
    for which in args or list(PROBES):
        print(PROBES[which](device), flush=True)


if __name__ == "__main__":
    main()
