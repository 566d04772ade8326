#!/usr/bin/env python3
"""GPU smoke run of aosx_torch, the PyTorch/CUDA port of aosx.

Drives the port's paths on one CUDA card, bench.py's stage_full (perceive ->
GVD graph -> cost matrix -> waypoints + trim plane -> one engine.step), the
live serving loop (serve_init, serve_map_frame per map message, control
ticks), the probe entry point and the Monte-Carlo harness (sustained
rollouts with lane refill, a parameter sweep), and checks every hand-written
kernel on them:

  phase 0  environment: the card's name and power limit, torch and CUDA
  phase 1  build kernels K1 (jfa_pass), K2 (zhang_suen), K3 (ror_counts)
           and P1-P3 (probe_prims) with nvcc and the native host library
           with g++, one process each, all started together
  phase 2  K1: a full jump flood at 2000 x 2048, S = 4096, and at 384 x 512,
           S = 256, each in the Pallas and in the XLA roundings of
           voronoi.ROUNDINGS, and at Statics.for_grid(64, 128) (one row
           band: every Pallas pass over one band, five of them a chain,
           voronoi.CHAINS) and for_grid(1000, 1024, 0.1) in their Pallas
           roundings, from one call of the kernel (one cooperative
           launch) and through the plain PyTorch passes: the owner plane and
           the carried x and y planes bitwise equal, single passes from a
           mid-flood state in every rounding too; ms a flood and a pass at each step value, against
           the bound; with the world axis, 32
           MC_STATICS floods of their own origins, bounds and seeds in one
           launch against the plain batched flood and each world's
           single-world flood, bitwise, ms a group beside 32 single-world
           launches, against the group's bound; 2,400 tiny worlds, more
           than the co-resident blocks, in a counted launch a chunk; planes
           of an odd number of 4-cell quads a row, owned everywhere and in
           3 % of the cells, at steps 1 to 8 and one larger than the plane
           (unaligned candidate rows, edges, quads without owners), bitwise;
           a flood at S = 32767 (the table in device memory), bitwise and
           timed, and S = 32768 refused; the launch K1 takes (threads,
           blocks an SM, registers and spills a thread)
  phase 3  K2: Zhang-Suen to the fixpoint in one cooperative launch on the
           bench and the Monte-Carlo orchard's opened grids and on live
           regions that divide by nothing, against the plain loop: plane,
           iteration count and changed count bitwise equal, also capped at 3,
           1 and 0 iterations; ms a thinning (CUDA events, no host read),
           against the bound; with the world axis, 32 MC_STATICS orchards'
           opened grids (whose fixpoints end at different iterations) and 2
           bench ones in one launch each against the plain batched loop and
           each world's single-world run, bitwise, also capped; ms a group
           beside the single-world launches, against the group's bound;
           SMs + 9 small worlds, in a counted launch a chunk
  phase 4  the port's copies of XLA:CPU's f32 arithmetic on the plan path
           (ops.cumsum_xla on [64, 769], ops.sum_xla over 767 and 1,199
           terms, f32math.atan2_f32 with its special values, sin_f32 and
           cos_f32 over +-3 pi, ops.norm2, geom.wrap_angle, ops.fma; about
           1 M seeded values each) on the card against the CPU, bitwise,
           and each one's card time, and the follower's CUDA graph
           (ops.card_graph) against its launches one by one; then the slice
           at TEST_STATICS (stage_full + 20 ticks), CUDA against the port on
           the CPU; perceive.rows.compact_cells and the union-find chain on
           its output, the card against the CPU port bitwise
  phase 5  stage_full at BENCH_STATICS on CUDA: the kernels' launch counts,
           guard bits, and the JAX package's full-size reference summary
           (tests/torch_reference/bench_np_seed0.json: counts, hashes, the
           robot's pose after the step bitwise, the waypoints bitwise, the
           owner plane bitwise in every cell);
           per-stage times
  phase 6  K3: all-pairs ROR counts of 131,072 points (the bench orchard,
           parked as ror_counts parks it, and a uniform cloud at its
           density) through the kernel and the plain version; bitwise equal;
           with the world axis, 32 MC orchards' clouds in one launch against
           the plain batched counts and each cloud's single-world launch;
           clouds of sizes that are no multiple of the kernel's tile (1, 33,
           2,047, 2,049, 5,000 points, and 3 worlds of 3,000 with r2 each
           its own), bitwise; the run fails if K3 beats its bound (the
           n (n + 1) / 2 pairs a world of the all-pairs function)
  phase 7  the serving loop at BENCH_STATICS with ror_method="pallas" over
           seven map frames (levels 0, 2, 2, 2, 2, 0, 3), 20 ticks each, then
           serve_control_tick fed the replay's poses: held against the JAX
           package's summary (tests/torch_reference/serving_np_seed0.json),
           frame 0's raw A* paths and every cache row's length bitwise, the
           ticks' xy and yaw bitwise, frame 0's ROR counts and owner plane
           bitwise, a row that differs failing unless
           NAMED_RAW_ROWS / NAMED_CACHE_ROWS names its cause (each printed
           with its f32 and f64 regression breakpoints); launches of K1, K2
           and K3, and the serving latencies; frame 0's plan cache built in
           one batched call
           against its rows one at a time through unbatched calls, bitwise
  phase 8  the probes P1 (scalar read+write chase, its table in shared and
           in global memory), P2 (scalar read-only chase) and P3 (row gather,
           on the probe's input and on random i32 input) through the kernels
           and their plain versions, bitwise equal, and against the constants
           of the TPU probe bodies (tests/torch_reference/probes.json); ms
           with the card kept busy ahead of each launch, torch.gather's time
           for P3, the bounds (the run fails if a kernel beats its bound; P1's
           and P2's latency term is the shared-memory load-to-use latency,
           measured here), the bank wavefronts P3's indices force in its
           layout and in the identity layout, as a diagnostic of the log;
           then the probe entry point (python3 -m
           aosx_torch.probes) for the launch counts
  phase 9  Monte-Carlo at MC_STATICS: the first refill group's 32 worlds in
           one batched prepare_world (K1 and K2 one launch each) against
           the same worlds built one at a time, bitwise, both timed; its plan
           caches (32 worlds x 25 rows in one batched build_plan_cache)
           against the same caches built one world and one row at a time,
           bitwise, both timed; 128 rollouts of 1,200 ticks through 64
           lanes with refill groups of 32 (plan-cached), each record held
           against the JAX package's own harness on the same clouds
           (tests/torch_reference/mc_np_seed0.json, its lanes vmapped);
           8 of them again through 8 lanes of their own, bitwise equal to
           their records; a 2 x 2 parameter sweep whose first configuration
           equals the unswept records; launches of K1 and K2 per group
           build; rollouts/s; the uncached harness (16 rollouts through 8
           lanes, refill 4, 300 ticks: lane-aware engine.step chunks)
           bitwise equal to the cached one on the same clouds, its
           lane-tick; batched_rollouts on 8 keys bitwise equal to the keys
           one at a time
  phase 9b the realism Monte-Carlo (benchmarks/bench_sustained.py ... cached
           realism: 0.8 m bow, 15 % tree dropout, MC_REALISM_STATICS): K1
           and K2 on the first refill group of population keys, of the
           realism and of the straight population, each in one launch
           against its plain batched version, bitwise, ms a group and its
           bound; then sustained_rollouts(128, 64, ..., refill=32,
           cached=True, classify=True, keys=the first 128 population keys),
           every field of every record bitwise the JAX package's own harness
           on the same keys (tests/torch_reference/mc_harness_ref.json);
           launches of K1 and K2 per group build (K3 none); rollouts/s, the
           chunk's ms a call, the lanes completed, infeasible and out of
           budget
  phase 10 the operator's surface. (a) At BENCH_STATICS on the bench orchard:
           make_orchard on the card against the CPU port and the JAX
           package's (bitwise); the bench cloud through save_pcd / load_pcd
           (the native reader and numpy) bitwise; build_gvd_graph with
           clearances (the distance field on the card == the CPU port's ==
           JAX's, its ms), the ROS messages against JAX's, msg_to_gvd_graph
           back to the graph, and the next-waypoint service with plans from
           the robot's position (tests/torch_reference/host_np_seed0.json,
           .npz). (b) The dashboard at TEST_STATICS: python -m
           aosx_torch.dashboard --steps 300 --seed 1 as a process of its own,
           then main(argv) on the verify recipe's PCD map and on its growing
           snapshots with --cached and --serve (2,400 ticks each), each
           report against the JAX package's
           (tests/torch_reference/dashboard_np.json), the launches of K1
           and K2 against the worlds built, episode_state.npz loaded back
  phase 11 row-sharded stencils and meshes (parallel/spatial.py). (a) At
           BENCH_STATICS on the bench orchard with a 4-band mesh on the
           card: prepare_world_full(stencil_mesh=) equals the single-device
           world leaf for leaf, jump_flood_sharded the single-device owner
           plane, bitwise, both in the XLA lowering's rounding (as aosx's
           jump_flood_sharded); host ms of each banded stage beside the
           single-device one; the banded path launches neither K1 nor K2
           (it is the plain counterpart of aosx's XLA stencils); over
           distinct cards too where more than one is visible. (b) At
           TEST_STATICS: serve_init + 2 map frames with a 2-band mesh equal
           the mesh-less serving states; sustained_rollouts(mesh=) of 8
           rollouts drawn from the default keys equal mesh=None per lane;
           the card pipeline's raw, inflated, occupancy and skeleton grids
           equal the port's NumPy oracle (its Subdiv2D graph only where
           OpenCV imports)

Every phase raises on failure, so the exit code is not 0 and no result is
printed. There is no CPU fallback: without a CUDA device the run fails.
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches, its error against the plain version, its
time, the plain version's, and the least time the card could take.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REFERENCE = ROOT / "tests" / "torch_reference" / "bench_np_seed0.json"
SERVING_REFERENCE = REFERENCE.with_name("serving_np_seed0.json")
# CPU parity tests state this bound for float leaves (tests/test_torch_slice.py)
ULP_BOUND = 4
# Phase 5's waypoints against the reference's, in ulp
WAYPOINT_ULP_BOUND = 0
TEST_TICKS = 20
TEST_V_DT = 0.5
REPS = 5
# K3 runs the fused multiply-add chains XLA:CPU runs for the JAX reference
# (aosx_torch/perceive/ror_cuda.py), so the frame-0 counts agree exactly: no
# valid point of the bench cloud may count differently
ROR_POINT_BOUND = 0
# The serving ticks' poses (phase 7) against JAX's: the port evaluates the
# plan path's f32 arithmetic as XLA:CPU does in the reference's serving scan
# (linearize's blocked prefix sums and multiply-adds, glibc's atan2f, sinf
# and cosf, the fused two-term norms, the follower's move), so xy and yaw
# are held bitwise
TICK_ULP_BOUND = 0
YAW_BOUND_RAD = 0.0
# Plan-cache rows whose plan length differs from JAX's, and frame-0 raw A*
# paths that are not JAX's bit for bit ("ulp" or "tie", raw_path_match), each
# with its cause as ROADMAP section 3 names it: row -> cause. Phase 7 prints
# every row that differs and fails on one not named here
NAMED_CACHE_ROWS = {}
NAMED_RAW_ROWS = {}
SERVE_REPS = 3
PROBES_REFERENCE = REFERENCE.with_name("probes.json")
MC_REFERENCE = REFERENCE.with_name("mc_np_seed0.json")
MC_TOTAL, MC_BATCH, MC_REFILL, MC_BUDGET, MC_CHUNK = 128, 64, 32, 1200, 150
MC_RERUN_IDS = (0, 1, 2, 3, 124, 125, 126, 127)
MC_SWEEP_SEEDS, MC_SWEEP_BATCH = 8, 16
# the uncached harness: total, lanes, refill, budget (a refill group at least)
MC_UNCACHED = (16, 8, 4, 300)
MC_BATCHED_KEYS, MC_BATCHED_STEPS = 8, 150
# The port evaluates the world build's and the plan path's f32 arithmetic
# as XLA:CPU does in aosx's own harness, its begin, chunk and finish jitted
# and vmapped over the lanes (make_mc_reference.py; ROADMAP section 3), so a
# record equals JAX's bit for bit
MC_FLOAT_BOUND_M = {"travel_distance": 0.0, "final_dist_to_origin": 0.0}
# Records beyond that bound, each printed with both sides and the cache rows
# whose plan lengths differ: record -> its proven cause. None since the flood
# carries its three planes as the reference's does (world 102's was the
# reference's phantom position)
MC_NAMED_RECORDS = {}
MC_RECORD_BOUND = len(MC_NAMED_RECORDS)
# ... and even those agree in every other int and bool field, within these
MC_DRIFT_TRAVEL_M = 0.4
MC_DRIFT_STEPS = 5

# the card's ceilings for the bounds (NVIDIA's H100 SXM data sheet, 700 W):
# 3.35 TB/s of HBM; 67 TFLOP/s FP32 counts an FMA as two, so FP32
# instructions run at half of it; INT32 runs on 64 of an SM's 128 lanes,
# half again, on a pipe of its own; and an SM's four sub-partitions each
# dispatch one warp instruction a clock, 132 x 128 lanes at 1.98 GHz (the
# Hopper white paper), which caps FP32 and INT32 instructions together
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
SM_CLOCK_HZ = 1.98e9
DISPATCH_OPS_PER_S = 132 * 128 * SM_CLOCK_HZ
# shared memory: 32 banks of 4 bytes a clock on each of 132 SMs
SM_SMEM_BYTES_PER_S = 32 * 4 * SM_CLOCK_HZ
SMEM_BYTES_PER_S = 132 * SM_SMEM_BYTES_PER_S
# The load-to-use latency of shared memory is measured in phase 8
# (probes.shared_load_clocks). A dependent integer operation (xor,
# multiply-add, mask) is charged its one issue clock, which no dependent
# instruction undercuts; what it takes on the chain is not measured
DEP_OP_CLOCKS = 1.0


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps):
    """(fn()'s warm-up result, median ms over reps of fn() timed with CUDA
    events). A timed call's result is dropped before the next call, so
    that each call allocates from the same cached memory."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return out, float(np.median(times))


def bound(n_bytes, fp32_ops=0.0, int32_ops=0.0):
    """(least ms, "bytes" or "operations"): the larger of moving n_bytes
    through HBM and issuing the operations at the card's peak rates, the
    FP32 and INT32 pipes side by side under the one dispatch rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_OPS_PER_S, int32_ops / INT32_OPS_PER_S,
                (fp32_ops + int32_ops) / DISPATCH_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def host_ms(fn):
    """(fn()'s result, host wall ms of one call ended by a synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def zero_counts(kernels):
    """Set every launch count of the wrappers to 0."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "passes"):
            k.passes = 0


def read_counts(kernels):
    """The wrappers' launch counts by name; K1's passes beside its launches
    (a launch is a whole flood)."""
    out = {k.__name__: k.launches for k in kernels}
    for k in kernels:
        if hasattr(k, "passes"):
            out[f"{k.__name__}.passes"] = k.passes
    return out


def assert_group_launches(counts, groups, statics, what):
    """A group's world build launches K2 once (every world's thinning) and
    K1 once (every world's flood, with every pass of the preset): ``groups``
    groups of at most as many worlds as the card holds co-resident."""
    from aosx_torch.gvd import voronoi

    npass = len(voronoi._passes(statics))
    want = {"zhang_suen_fixpoint": groups, "jfa_flood": groups,
            "jfa_flood.passes": groups * npass}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: kernel counts {counts}, expected {want}")


def cloud(statics, spec, seed, device):
    """make_orchard_np's cloud padded to statics.max_points, and its polygon."""
    from aosx_torch.orchards import make_orchard_np
    from aosx_torch.parallel.batch import cloud_tensors

    return cloud_tensors(make_orchard_np(spec, seed=seed), statics, device)


def ulp_distance(a, b):
    """Max |a - b| in ulp of a's largest finite magnitude below the 3.4e38 pad."""
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    if not (np.isfinite(a) == np.isfinite(b)).all():
        return np.inf
    fin = np.isfinite(a) & (np.abs(a) < 1e30)
    if not fin.any():
        return 0
    scale = np.spacing(np.float32(np.abs(a[fin]).max()))
    return float(np.abs(a[fin].astype(np.float64) - b[fin].astype(np.float64)).max() / scale)


def tree_leaves(tree):
    """{leaf path: numpy array} of a nested state (dataclasses, dicts, lists)."""
    from aosx_torch.convert import to_numpy

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{p}.{k}" if p else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{p}[{i}]")
        else:
            yield p, np.asarray(t)

    return dict(leaves(to_numpy(tree)))


def assert_trees_match(ref, got, what):
    """int/bool leaves bitwise, f32 leaves within ULP_BOUND."""
    r, g = tree_leaves(ref), tree_leaves(got)
    bad, worst = [], 0.0
    for name, a in r.items():
        b = g[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        elif a.dtype == np.float32:
            d = ulp_distance(a, b)
            worst = max(worst, d)
            if d > ULP_BOUND:
                bad.append(f"{name}: {d} ulp")
        elif not np.array_equal(a, b):
            bad.append(f"{name}: {int((a != b).sum())} entries differ")
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"# phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from aosx_torch import cuda_build

    from aosx_torch.native import binding

    names = ("jfa_pass", "zhang_suen", "ror_counts", "probe_prims", "native")

    def one(name):
        t0 = time.time()
        so = binding.build() if name == "native" else cuda_build.build(name)
        return so, time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(one, names)))
    for name, (so, seconds) in built.items():
        if name == "native":
            log(f"# phase 1: built the native host library with g++ in {seconds:.2f} s "
                f"({so.name})")
            continue
        cuda_build.load(name)
        report = so.with_suffix(".log")
        regs = [ln.strip() for ln in report.read_text().splitlines()
                if "registers" in ln] if report.exists() else []
        log(f"# phase 1: built {name} in {seconds:.2f} s ({so.name}); {' | '.join(regs)}")
    log(f"# phase 1: all kernels built in {time.time() - t0:.2f} s")


def assert_under_bound(name, ms, bound_ms):
    """A kernel never beats its bound: if it does, the bound is wrong."""
    if ms < bound_ms:
        raise AssertionError(f"{name}: {ms:.5f} ms is under its bound of {bound_ms:.5f} ms "
                             f"({100 * bound_ms / ms:.0f} %): the bound is wrong")


K1_SINGLE_STEPS = (1, 2, 7, 128, 1024)
K1_STEP_REPEATS = 16


def k1_case(S, device):
    """A full grid of the preset with max_seeds random valid seeds: (grid,
    seeds)."""
    import torch
    from aosx_torch.types import GridWorld, SeedSet

    rng = np.random.default_rng(0)
    n = S.max_seeds
    xy = np.stack([rng.uniform(0.5, S.grid_w * S.resolution - 0.5, n),
                   rng.uniform(0.5, S.grid_h * S.resolution - 0.5, n)], 1).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    grid = GridWorld(occ=torch.zeros((S.grid_h, S.grid_w), dtype=torch.uint8, device=device),
                     origin_x=torch.tensor(-3.25, **f32), origin_y=torch.tensor(1.5, **f32),
                     h_cells=torch.tensor(S.grid_h, **i32), w_cells=torch.tensor(S.grid_w, **i32))
    seeds = SeedSet(xy=torch.from_numpy(xy).to(device) + torch.tensor([-3.25, 1.5], **f32),
                    valid=torch.ones(n, dtype=torch.bool, device=device),
                    kind=torch.zeros(n, dtype=torch.int8, device=device))
    return grid, seeds


def k1_ops_by_pass(before, steps, n, coords, rounding=None):
    """Each pass's operations bound (ms) from the planes (owner, x, y, each
    [*B, H, W]) it starts from, in its rounding (voronoi.ROUNDINGS; None: all
    "xla"): H + W FP32 FMAs a world for the coordinates; for each distinct
    candidate among a cell's 9 (owner and carried position; one without an
    owner needs nothing), 2 subtractions, the products its forms need (dx *
    dx for "y" and "u", dy * dy for "x" and "u") and an FMA or add for each
    form the owner plane's fold asks of it, and a compare for each distinct
    (candidate, form) but the cell's own. The x and y planes' folds are not
    counted: they take the owner fold's winner but at near ties."""
    import torch
    from aosx_torch.gvd.voronoi import ROUNDINGS
    from aosx_torch.perceive.raster import shift2d

    bit = {"x": 1, "y": 2, "u": 4}
    out = []
    rounding = rounding or ["xla"] * len(steps)
    for (o, x, y), step, r in zip(before, steps, rounding):
        worlds = o[..., 0, 0].numel()
        planes = ROUNDINGS[r][:1]
        # a candidate: its owner in the high word, a hash of its position's
        # bits in the low one; no owner sorts above every owner
        xb = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        yb = y.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        key = (o.to(torch.int64) << 32) | ((xb * 2654435761) ^ yb) & 0xFFFFFFFF
        none = n << 32
        keys = [key] + [shift2d(key, dys * step, dxs * step, none)
                        for dys in (-1, 0, 1) for dxs in (-1, 0, 1) if dys or dxs]
        live = [k < none for k in keys]
        ops = 0
        # each distinct candidate once, with the union of the forms asked of it
        for m in range(9):
            first = live[m].clone()
            union = torch.zeros_like(key)
            for j in range(9):
                same = keys[j] == keys[m]
                if j < m:
                    first &= ~same
                union |= same.to(torch.int64) * sum(bit[f[j]] for f in set(planes))
            dx2 = (union & 6) != 0
            dy2 = (union & 5) != 0
            forms = (union & 1) + ((union & 2) >> 1) + ((union & 4) >> 2)
            ops += int(torch.where(first, 2 + dx2.to(torch.int64) + dy2.to(torch.int64) + forms,
                                   0).sum())
            del union, dx2, dy2, forms, first
        # a compare a distinct (candidate, form), but the own
        for f in planes:
            for m in range(9):
                first = live[m].clone()
                for j in range(m):
                    if f[j] == f[m]:
                        first &= keys[j] != keys[m]
                ops += int(first.sum()) - (int(live[0].sum()) if m == 0 else 0)
        out.append(bound(0, fp32_ops=worlds * coords + ops)[0])
        del keys, live, key
    return out


def phase_k1_shape(name, S, device, pallas):
    """K1 at one preset's shape, every pass in the "xla" rounding or, with
    ``pallas``, in the roundings of voronoi.pass_roundings with
    jfa_pass_pallas on: the flood and single passes against the plain
    versions, bitwise; times of the flood and of a pass at each step value;
    the bound."""
    import torch
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.gvd import jfa_pass_cuda, voronoi

    grid, seeds = k1_case(S, device)
    n = S.max_seeds
    steps = voronoi._passes(S)
    npass = len(steps)
    rounding = voronoi.pass_roundings(dataclasses.replace(
        S, jfa_pass_pallas=pallas, jfa_dynamic_shifts=False), steps)
    name = f"{name}, {'Pallas' if pallas else 'XLA'} rounding"
    owner0, table = voronoi._jfa_init(grid, seeds, S)
    args = (n, grid.origin_x, grid.origin_y, S.resolution)

    # the plain flood, keeping the state before every pass
    def plain_flood():
        return jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, *args, rounding)

    ref, ms_p = cuda_ms(plain_flood, 2 if S.grid_h > 1000 else REPS)
    *before, state = jfa_pass_cuda.jfa_states_plain(owner0, table, steps, *args, rounding)
    if not all(torch.equal(a, b) for a, b in zip(state, ref)):
        raise AssertionError("jfa_flood_plain differs from jfa_states_plain's last state")
    # cells whose carried position is not their owner's seed (the planes'
    # folds part at exact ties)
    seed_of = table[ref[0].long()]
    apart = int(((ref[0] < n) & ((ref[1] != seed_of[..., 0]) | (ref[2] != seed_of[..., 1])))
                .sum())

    # the flood: owner, and ox/oy with want_positions
    got = jfa_pass_cuda.jfa_flood(owner0.clone(), table, steps, *args, want_positions=True,
                                  rounding=rounding)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"K1 flood at {name} differs from its plain version (max abs "
                             f"err {err})")
    got, ms_k = timed_ms(lambda o: jfa_pass_cuda.jfa_flood(o, table, steps, *args,
                                                           rounding=rounding),
                         device, REPS, owner0.clone)
    if not torch.equal(got, ref[0]):
        raise AssertionError("K1 flood without positions differs")
    # single passes from a mid-flood state (the state before the flood's
    # fifth pass), also at steps the flood does not use, in every rounding
    # (a chain's passes fold from its triples: whole floods only)
    mid = before[4]
    for step in K1_SINGLE_STEPS:
        for r in (r for r in voronoi.ROUNDINGS if r not in voronoi.CHAINS):
            want = jfa_pass_cuda.jfa_pass_plain(*mid, step, *args, r)
            got = jfa_pass_cuda.jfa_flood(mid[0].clone(), table, [step], *args,
                                          want_positions=True, rounding=[r])
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K1 single pass at step {step} in rounding {r} ({name}) "
                                     "differs from jfa_pass_plain")
    # a pass's time at each step value of the flood, from the state the flood
    # has there: K1_STEP_REPEATS passes at that step, in its rounding, from
    # one call (a chain's passes only inside their chain: not timed alone)
    by_step = {}
    for k, step in enumerate(steps):
        if step in by_step or rounding[k] in voronoi.CHAINS:
            continue
        _, ms = timed_ms(lambda o: jfa_pass_cuda.jfa_flood(
            o, table, [step] * K1_STEP_REPEATS, *args, rounding=[rounding[k]] * K1_STEP_REPEATS),
            device, 3, before[k][0].clone)
        by_step[step] = ms / K1_STEP_REPEATS
    # the same flood over a plane without any owner: every fold is skipped, so
    # what is left is the loads, the stores and the barriers
    _, ms_empty = timed_ms(lambda o: jfa_pass_cuda.jfa_flood(o, table, steps, *args,
                                                             rounding=rounding),
                           device, REPS, lambda: torch.full_like(owner0, n))
    # Bound. The flood must read the owner plane once and write it once
    # through device memory (8 B a cell) and read the table: the carried
    # positions start as the owners' seeds and are the kernel's own state from
    # pass to pass, no input or output of a flood without positions. A pass
    # costs H + W FP32 instructions for the coordinates (an FMA for each row's
    # y and each column's x, which every cell of that row or column shares)
    # and, for each distinct candidate (owner and position) among a cell's 9,
    # 2 subtractions, the products and an FMA or add for each form that the
    # owner plane's fold asks of it (voronoi.ROUNDINGS), with a compare for
    # each distinct (candidate, form) but the own; the x and y planes' folds
    # take the owner fold's winner but at near ties, which are not counted
    # (k1_ops_by_pass). Counted on this run's states.
    cells = S.grid_h * S.grid_w
    coords = S.grid_h + S.grid_w
    ops_by_pass = k1_ops_by_pass(before, steps, n, coords, rounding)
    ops_ms = float(np.sum(ops_by_pass))
    bytes_ms, _ = bound(8 * cells + 8 * (n + 1))
    flood_bound = max(bytes_ms, ops_ms)
    b_by = "bytes" if bytes_ms >= ops_ms else "operations"
    carried_ms, _ = bound(16 * cells)
    full_ms, _ = bound(0, fp32_ops=coords + (4 + 8 * 5) * cells)
    log(f"# phase 2: K1 jump flood {name} {S.grid_h}x{S.grid_w} S={n} ({npass} passes): one "
        f"call, one cooperative launch, {ms_k:.4f} ms ({ms_empty:.4f} ms over a plane "
        f"without owners, where no candidate is folded); plain {ms_p:.3f} ms; owner, "
        f"ox and oy bitwise equal, single passes at steps {list(K1_SINGLE_STEPS)} in every "
        f"rounding but a chain's {[r for r in voronoi.ROUNDINGS if r not in voronoi.CHAINS]} "
        f"too; owned cells {int((ref[0] < n).sum())}, "
        f"{apart} of them carrying a position that is not their owner's seed")
    log(f"# phase 2: K1 {name} ms a pass by step: "
        f"{json.dumps({str(k): round(v, 5) for k, v in by_step.items()})}")
    log(f"# phase 2: K1 {name} bound {flood_bound:.4f} ms a flood ({b_by}), "
        f"{flood_bound / npass:.5f} ms a pass: the larger of the owner plane once in and once "
        f"out of device memory plus the table ({bytes_ms:.4f} ms) and {npass} passes of H + W FP32 "
        f"instructions for the coordinates + for each distinct candidate (owner, position) "
        f"among a cell's 9, 2 sub, its products and an FMA or add a form the owner fold asks, "
        f"and a compare a distinct (candidate, form) but the own ({ops_ms:.4f} ms in all; a "
        f"pass in which all nine are distinct, each in its own form: {full_ms:.5f} ms); the "
        f"share refers to it: {100 * flood_bound / ms_k:.1f} %. For "
        f"scale, 8 B a cell from device memory in every pass: {bytes_ms:.4f} ms a pass; the "
        f"owner and position words in and out, 16 B: {carried_ms:.4f} ms")
    assert_under_bound(f"K1 flood {name}", ms_k, flood_bound)
    for k, step in enumerate(steps):
        if steps.index(step) == k and step in by_step:
            assert_under_bound(f"K1 pass at step {step} {name}", by_step[step], ops_by_pass[k])
    return dict(max_abs_err=err, ms=ms_k / npass, plain_ms=ms_p / npass, flood_ms=ms_k,
                flood_plain_ms=ms_p, flood_no_owner_ms=ms_empty, passes=npass,
                positions_apart=apart,
                rounding=rounding, ms_by_step={str(k): v for k, v in by_step.items()},
                bound_ms=flood_bound / npass, bound_by=b_by)


WORLDS = 32


def k1_group_case(S, G, device):
    """G grids of the preset, each with its own origin, live bounds and
    number of random valid seeds: (GridWorld [G], SeedSet [G])."""
    import torch
    from aosx_torch.types import GridWorld, SeedSet

    rng = np.random.default_rng(2)
    n = S.max_seeds
    xy = np.zeros((G, n, 2), np.float32)
    valid = np.zeros((G, n), bool)
    origin = rng.uniform(-20.0, 20.0, (G, 2)).astype(np.float32)
    live = np.stack([S.grid_h - 7 * (np.arange(G) % 5), S.grid_w - 12 * (np.arange(G) % 3)],
                    1).astype(np.int32)
    for g in range(G):
        k = max(3, n >> (g % 6))
        xy[g, :k, 0] = rng.uniform(0.5, live[g, 1] * S.resolution - 0.5, k)
        xy[g, :k, 1] = rng.uniform(0.5, live[g, 0] * S.resolution - 0.5, k)
        valid[g, :k] = True
    xy += origin[:, None, :]
    f32 = dict(dtype=torch.float32, device=device)
    o = torch.from_numpy(origin).to(device)
    lv = torch.from_numpy(live).to(device)
    grid = GridWorld(occ=torch.zeros((G, S.grid_h, S.grid_w), dtype=torch.uint8, device=device),
                     origin_x=o[:, 0].contiguous(), origin_y=o[:, 1].contiguous(),
                     h_cells=lv[:, 0].contiguous(), w_cells=lv[:, 1].contiguous())
    seeds = SeedSet(xy=torch.from_numpy(xy).to(**f32), valid=torch.from_numpy(valid).to(device),
                    kind=torch.zeros((G, n), dtype=torch.int8, device=device))
    return grid, seeds


def k1_group_bound(owner0, table, steps, args, rounding):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms) of a
    group's floods: every world's owner plane in and out and its table, or
    every world's passes' operations, counted on this run's states."""
    from aosx_torch.gvd import jfa_pass_cuda

    G, H, W = owner0.shape
    n = args[0]
    *before, _ = jfa_pass_cuda.jfa_states_plain(owner0, table, steps, *args, rounding)
    ops_ms = float(np.sum(k1_ops_by_pass(before, steps, n, H + W, rounding)))
    del before
    bytes_ms, _ = bound(G * (8 * H * W + 8 * (n + 1)))
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms,
            ops_ms)


def phase_k1_world_axis(device, S, G=WORLDS):
    """K1 with a world axis: G floods of their own origins, bounds and seed
    tables in one launch, against the plain batched flood and against the
    single-world kernel on each world, bitwise; ms a group beside G
    single-world launches; the group's bound."""
    import torch
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.gvd import jfa_pass_cuda, voronoi

    grid, seeds = k1_group_case(S, G, device)
    n = S.max_seeds
    steps = voronoi._passes(S)
    rounding = voronoi.pass_roundings(S, steps)
    owner0, table = voronoi._jfa_init(grid, seeds, S)
    ox, oy = grid.origin_x, grid.origin_y
    args = (n, ox, oy, S.resolution)
    ref, ms_p = cuda_ms(lambda: jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, *args,
                                                              rounding), 2)
    zero_counts([jfa_pass_cuda.jfa_flood])
    got = jfa_pass_cuda.jfa_flood(owner0.clone(), table, steps, *args, want_positions=True,
                                  rounding=rounding)
    launches = jfa_pass_cuda.jfa_flood.launches
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"K1 group of {G} differs from its plain batched version "
                             f"(max abs err {err})")
    for g in range(G):
        one = jfa_pass_cuda.jfa_flood(owner0[g].clone(), table[g].contiguous(), steps, n, ox[g],
                                      oy[g], S.resolution, want_positions=True,
                                      rounding=rounding)
        if not all(torch.equal(a, b[g]) for a, b in zip(one, got)):
            raise AssertionError(f"K1 group: world {g} differs from its single-world flood")
    _, ms_k = timed_ms(lambda o: jfa_pass_cuda.jfa_flood(o, table, steps, *args,
                                                         rounding=rounding),
                       device, REPS, owner0.clone)
    tables = [table[g].contiguous() for g in range(G)]
    _, ms_1 = timed_ms(lambda os: [jfa_pass_cuda.jfa_flood(o, tables[g], steps, n, ox[g], oy[g],
                                                           S.resolution, rounding=rounding)
                                   for g, o in enumerate(os)],
                       device, REPS, lambda: [owner0[g].clone() for g in range(G)])
    b_ms, b_by, bytes_ms, ops_ms = k1_group_bound(owner0, table, steps, args, rounding)
    log(f"# phase 2: K1 world axis, {G} MC_STATICS floods ({S.grid_h}x{S.grid_w}, their own "
        f"origins, live bounds and 3 to {n} seeds; {len(steps)} passes): {launches} launch(es), "
        f"{ms_k:.4f} ms a group ({ms_k / G:.5f} a world) against {ms_1:.4f} ms for {G} "
        f"single-world launches; plain batched {ms_p:.2f} ms; owner, ox and oy bitwise equal to "
        f"the plain batched flood and to each world's single-world flood; bound {b_ms:.4f} ms "
        f"({b_by}: the planes in and out {bytes_ms:.4f} ms, the passes' operations "
        f"{ops_ms:.4f} ms), {100 * b_ms / ms_k:.1f} % of it")
    if launches != 1:
        raise AssertionError(f"K1 group of {G}: {launches} launches, expected 1")
    assert_under_bound(f"K1 group of {G}", ms_k, b_ms)
    return dict(worlds=G, group_ms=ms_k, singles_ms=ms_1, group_plain_ms=ms_p,
                group_bound_ms=b_ms, group_bound_by=b_by, group_launches=launches,
                max_abs_err=err)


def phase_k1_chunks(device, G=2400, H=8, W=16, S=6):
    """More worlds than the card holds co-resident blocks: the flood runs as
    a counted launch a chunk of worlds, and equals the plain batched flood
    and each world's single flood, bitwise."""
    import torch
    from aosx_torch.gvd import jfa_pass_cuda

    rng = np.random.default_rng(4)
    owner = torch.from_numpy(rng.integers(0, S + 1, (G, H, W)).astype(np.int32)).to(device)
    table = torch.from_numpy(rng.uniform(-1.0, 2.0, (G, S + 1, 2)).astype(np.float32)).to(device)
    table[:, S] = 1e9
    origin = torch.from_numpy(rng.uniform(-0.5, 0.5, (G, 2)).astype(np.float32)).to(device)
    ox, oy = origin[:, 0].contiguous(), origin[:, 1].contiguous()
    steps = [1, 8, 4, 2, 1]
    ref = jfa_pass_cuda.jfa_flood_plain(owner, table, steps, S, ox, oy, 0.125)
    zero_counts([jfa_pass_cuda.jfa_flood])
    got = jfa_pass_cuda.jfa_flood(owner.clone(), table, steps, S, ox, oy, 0.125,
                                  want_positions=True)
    launches = jfa_pass_cuda.jfa_flood.launches
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"K1 over {G} worlds in chunks differs from the plain batched flood")
    for g in (0, G // 2, G - 1):
        one = jfa_pass_cuda.jfa_flood(owner[g].clone(), table[g].contiguous(), steps, S, ox[g],
                                      oy[g], 0.125)
        if not torch.equal(one, got[0][g]):
            raise AssertionError(f"K1 chunks: world {g} differs from its single-world flood")
    if launches < 2:
        raise AssertionError(f"K1 over {G} worlds: {launches} launch, expected a launch a chunk")
    log(f"# phase 2: K1 over {G} worlds of {H}x{W} (more than the co-resident blocks): "
        f"{launches} counted launches, bitwise equal to the plain batched flood and to single "
        f"worlds")
    return launches


# K1's unaligned candidate rows and edges: planes whose width holds an odd
# number of 4-cell quads, every step from 1 to 8 (each residue of the column
# offset mod 4) and one larger than the plane (tests/test_torch_k1_host.py's
# cases, and a plane of many blocks)
K1_EDGE_PLANES = ((40, 52, 64), (300, 1004, 256))
K1_EDGE_STEPS = (1, 2, 3, 4, 5, 6, 7, 8, 1031)
K1_EDGE_MIXES = {"plain": ("pallas", "xla", "pallas", "pallas_last"),
                 "chain": ("band_window", "chain", "band", "pallas_last")}


def k1_random_planes(H, W, S, device, seed, spread=False):
    """Owners anywhere (some none) over seeds on a coarse lattice of
    coordinates, so that distances tie and near-tie often (with ``spread``,
    two thirds of the seeds anywhere on the plane instead): (owner, table)."""
    import torch

    rng = np.random.default_rng(seed)
    lattice = np.float32([1.1, 2.3, 3.7, 4.9, 6.1, 7.3, 8.5])
    xy = rng.choice(lattice, (S, 2))
    if spread:
        anywhere = rng.uniform(0.0, [W * 0.1, H * 0.1], (S, 2))
        xy = np.where(np.arange(S)[:, None] % 3 == 0, xy, anywhere)
    table = np.concatenate([xy, [[1e9, 1e9]]]).astype(np.float32)
    owner = rng.integers(0, S + 1, (H, W)).astype(np.int32)
    return torch.from_numpy(owner).to(device), torch.from_numpy(table).to(device)


def k1_launch_report(S):
    """K1's launch for S seeds (jfa_pass_cuda.launch_config) and the build's
    ptxas lines for its kernels and out-of-line functions (registers, stack
    and spill bytes), as a log line's text."""
    from aosx_torch import cuda_build
    from aosx_torch.gvd import jfa_pass_cuda

    cfg = jfa_pass_cuda.launch_config(S)
    log_path = cuda_build.library_path("jfa_pass").with_suffix(".log")
    lines = log_path.read_text().splitlines() if log_path.exists() else []
    funcs, name = {}, None
    for ln in lines:
        for key in ("Compiling entry function '", "Function properties for "):
            if key in ln:
                name = ln.split(key)[1].split("'")[0].strip()
        if name and ("flood_kernel" in name or "xy_folds" in name or "chain_cell" in name
                     or "stored_position" in name):
            short = next(k for k in ("flood_kernelILb1", "flood_kernelILb0", "xy_folds",
                                     "chain_cell", "stored_position", "flood_kernel")
                         if k in name)
            short = {"flood_kernelILb1": "flood_kernel<shared table>",
                     "flood_kernelILb0": "flood_kernel<device-memory table>"}.get(short, short)
            if "spill" in ln or "Used" in ln:
                funcs.setdefault(short, []).append(ln.replace("ptxas info    :", "").strip())
    return cfg, "; ".join(f"{k}: {' '.join(v)}" for k, v in funcs.items())


def phase_k1_edges(device):
    """K1 where the quads' candidate rows are unaligned or leave the grid,
    on planes of an odd number of quads a row (K1_EDGE_PLANES), owned
    everywhere or in 3 % of the cells (quads that see no owner), at every
    step of K1_EDGE_STEPS: floods of [step, 3, step, step] in each mix of
    K1_EDGE_MIXES (the step's rows read from the caller's i32 plane, then
    from the u16 words), with and without positions, and single passes at
    the step in every rounding but a chain's; all bitwise their plain
    versions. Then a flood at S = 32767, the most an owner word holds (its
    table read from device memory), bitwise and timed, and S = 32768
    refused by the wrapper and by the library's entry point. Logs the
    launch K1 takes (threads, blocks an SM, registers, spills)."""
    import ctypes

    import torch
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.gvd import jfa_pass_cuda, voronoi

    org, res = (0.35, -0.45), 0.1
    singles = [r for r in voronoi.ROUNDINGS if r not in voronoi.CHAINS]
    n_cases = 0
    for (H, W, S), step, sparse in itertools.product(K1_EDGE_PLANES, K1_EDGE_STEPS,
                                                     (False, True)):
        owner, table = k1_random_planes(H, W, S, device, step)
        if sparse:
            # owners in 3 % of the cells: whole quads see none
            owner = torch.where(torch.rand(owner.shape, generator=torch.Generator(
                device).manual_seed(step), device=device) > 0.03, S, owner)
        steps = [step, 3, step, step]
        for mix, rounding in K1_EDGE_MIXES.items():
            want = jfa_pass_cuda.jfa_flood_plain(owner, table, steps, S, *org, res,
                                                 list(rounding))
            got = jfa_pass_cuda.jfa_flood(owner, table, steps, S, *org, res,
                                          want_positions=True, rounding=list(rounding))
            alone = jfa_pass_cuda.jfa_flood(owner, table, steps, S, *org, res,
                                            rounding=list(rounding))
            if not (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(alone, want[0])):
                raise AssertionError(f"K1 {H}x{W} S={S} steps {steps} ({mix}) differs from "
                                     "its plain version")
            n_cases += 2
        for r in singles:
            want = jfa_pass_cuda.jfa_pass_plain(owner, table[owner.long()][..., 0],
                                                table[owner.long()][..., 1], step, S, *org,
                                                res, r)
            got = jfa_pass_cuda.jfa_flood(owner, table, [step], S, *org, res,
                                          want_positions=True, rounding=[r])
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K1 {H}x{W} S={S} single pass at step {step} in "
                                     f"rounding {r} differs from jfa_pass_plain")
            n_cases += 1
    log(f"# phase 2: K1 unaligned rows and edges: planes {[p[:2] for p in K1_EDGE_PLANES]} "
        f"({[p[1] // 4 for p in K1_EDGE_PLANES]} quads a row), owned everywhere and in 3 % of "
        f"the cells, steps {list(K1_EDGE_STEPS)}: {n_cases} floods and single passes bitwise "
        f"their plain versions (owner, ox, oy)")

    # the seed cap: S = 32767 (a 262,144-byte table: device memory)
    S = jfa_pass_cuda.MAX_SEEDS
    H, W = 256, 512
    owner, table = k1_random_planes(H, W, S, device, 11, spread=True)
    steps = [1, 256, 128, 64, 32, 16, 8, 4, 2, 1]
    rounding = ["pallas", "xla"] + ["pallas"] * 7 + ["pallas_last"]
    want = jfa_pass_cuda.jfa_flood_plain(owner, table, steps, S, *org, res, rounding)
    got = jfa_pass_cuda.jfa_flood(owner, table, steps, S, *org, res, want_positions=True,
                                  rounding=rounding)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K1 at S = {S} differs from its plain version")
    top = int(want[0].max())
    if top < S - 1024:
        raise AssertionError(f"K1 at S = {S}: no owner above {top} survives the flood")
    _, ms_cap = timed_ms(lambda: jfa_pass_cuda.jfa_flood(owner, table, steps, S, *org, res,
                                                         rounding=rounding), device, REPS)
    # one more seed than a word holds: the wrapper raises, the entry refuses
    big = torch.zeros((S + 2, 2), dtype=torch.float32, device=device)
    small = torch.zeros((8, 8), dtype=torch.int32, device=device)
    try:
        jfa_pass_cuda.jfa_flood(small, big, [1], S + 1, 0.0, 0.0, res)
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError(f"jfa_flood took S = {S + 1} seeds")
    launches = ctypes.c_int(0)
    xy0 = torch.zeros(1, dtype=torch.float32, device=device)
    codes = jfa_pass_cuda.form_codes("xla")
    rc = jfa_pass_cuda._lib().jfa_flood(
        small.data_ptr(), torch.empty_like(small).data_ptr(), None, None, None, None, None,
        big.data_ptr(), xy0.data_ptr(), xy0.data_ptr(), (ctypes.c_int * 1)(1),
        (ctypes.c_int * 6)(*codes), 1, 1, 8, 8, S + 1, res, None, None,
        ctypes.byref(launches), torch.cuda.current_stream(device).cuda_stream)
    if rc == 0 or launches.value != 0:
        raise AssertionError(f"the jfa_flood entry took S = {S + 1} seeds (rc {rc})")
    log(f"# phase 2: K1 at the seed cap S = {S}, {H}x{W}, {len(steps)} passes: bitwise its plain "
        f"version (owners up to {top}), {ms_cap:.4f} ms a flood with the table in device "
        f"memory; S = {S + 1} refused by the wrapper ({raised}) and by the entry point "
        f"(cudaError {rc})")
    for S in (4096, 256, jfa_pass_cuda.MAX_SEEDS):
        cfg, ptxas = k1_launch_report(S)
        log(f"# phase 2: K1 launch at S = {S}: {cfg['threads']} threads a block, "
            f"{cfg['blocks_per_sm']} blocks an SM, {cfg['registers']} registers and "
            f"{cfg['local_bytes']} local bytes (stack frame and spills) a thread, table in "
            f"{'shared' if cfg['shared_table'] else 'device'} memory")
    log(f"# phase 2: K1 ptxas: {ptxas}")
    return dict(edge_cases=n_cases, seed_cap_ms=ms_cap)


def phase_k1(device, card):
    """K1 at BENCH_STATICS and MC_STATICS, each in its own rounding (the
    Pallas roundings at BENCH, "xla" at MC) and in the other; at
    Statics.for_grid(64, 128) (one row band, chains) and for_grid(1000,
    1024, 0.1) in their Pallas roundings; the world axis and the chunked
    launches."""
    from aosx_torch.config import BENCH_STATICS, MC_STATICS, Statics

    bench = phase_k1_shape("BENCH_STATICS", BENCH_STATICS, device, pallas=True)
    log(f"# phase 2: K1 BENCH flood in the Pallas roundings {bench['flood_ms']:.4f} ms on {card}")
    bench_xla = phase_k1_shape("BENCH_STATICS", BENCH_STATICS, device, pallas=False)
    mc = phase_k1_shape("MC_STATICS", MC_STATICS, device, pallas=False)
    mc_pallas = phase_k1_shape("MC_STATICS", MC_STATICS, device, pallas=True)
    one_band = phase_k1_shape("for_grid(64, 128)", Statics.for_grid(64, 128), device,
                              pallas=True)
    field = phase_k1_shape("for_grid(1000, 1024, 0.1)", Statics.for_grid(1000, 1024, 0.1),
                           device, pallas=True)
    group = phase_k1_world_axis(device, MC_STATICS)
    group["chunked_launches"] = phase_k1_chunks(device)
    phase_k1_edges(device)
    keep = ("ms", "plain_ms", "flood_ms", "flood_plain_ms", "flood_no_owner_ms", "passes",
            "ms_by_step", "bound_ms", "bound_by")
    return dict(bench,
                xla_rounding={k: bench_xla[k] for k in keep},
                mc={k: mc[k] for k in keep},
                mc_pallas_rounding={k: mc_pallas[k] for k in keep + ("rounding",)},
                one_band={k: one_band[k] for k in keep + ("rounding",)},
                field_1000x1024={k: field[k] for k in keep + ("rounding",)},
                world_axis={k: v for k, v in group.items() if k != "max_abs_err"},
                max_abs_err=max(bench["max_abs_err"], bench_xla["max_abs_err"],
                                mc["max_abs_err"], mc_pallas["max_abs_err"],
                                one_band["max_abs_err"], field["max_abs_err"],
                                group["max_abs_err"]))


# logic operations of K2's circuit for a word of 32 cells and a sub-iteration,
# counted with three-input logic operations and funnel shifts as the card has
# them: 6 shifted planes, 2 each for 4 full adders, 2 for the half adder, 4
# for b1..b3, 2 for B in 2..6, 3 x 8 for the ring's counter, 3 for m1 and m2,
# 2 to combine and delete, 1 population count
K2_OPS_PER_WORD = 50


def opened_grid(S, spec, device, seeds=(0,)):
    """morph_open of the inflated occupancy grid of an orchard: the thinning's
    input on the main path; for several cloud seeds, the group's grids with a
    leading world axis."""
    import torch
    from aosx_torch import tree
    from aosx_torch.config import AosParams, params_as_f32
    from aosx_torch.perceive import points, raster, skeleton

    pc, poly = cloud(S, spec, seeds[0], device) if len(seeds) == 1 else tree.stack(
        [cloud(S, spec, i, device) for i in seeds])
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    xy, keep, bounds, _ = points.preprocess(pc, poly, params, excl, S, ror_method="sorted")
    return skeleton.morph_open(raster.inflate(raster.generate_grid(xy, keep, bounds, S), S))


def thick_mask(h, w, live_h, live_w, seed):
    """Random blobs and thick bars inside the live region, up to its last
    interior cells."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.uint8)
    out[1:live_h - 1, 1:live_w - 1] = rng.random((live_h - 2, live_w - 2)) < 0.3
    out[live_h // 8:live_h // 3, live_w // 8:live_w - 1] = 1
    out[live_h // 2:live_h - 1, live_w // 4:live_w // 4 + live_w // 6] = 1
    return out


def check_k2(name, occ, h_cells, w_cells, max_iters_list):
    """The fixpoint kernel against the plain loop in plane, iteration count
    and last changed count. Returns (the most iterations run, max abs err)."""
    import torch
    from aosx_torch.perceive import skeleton_cuda

    if int(occ.max()) > 1:
        raise AssertionError(f"{name}: the plane holds values other than 0 and 1")
    its, err = 0, 0.0
    for max_iters in max_iters_list:
        ref, it, changed = skeleton_cuda.zhang_suen_fixpoint_plain(occ, h_cells, w_cells,
                                                                   max_iters)
        its = max(its, it)
        got, stats = skeleton_cuda.zhang_suen_fixpoint(occ, h_cells, w_cells, max_iters)
        err = max(err, float((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref) or stats.tolist() != [it, changed]:
            raise AssertionError(
                f"K2 {name} max_iters={max_iters}: kernel {stats.tolist()} iterations/changed, "
                f"plain {[it, changed]}; {int((got != ref).sum())} cells differ")
    ref, changed = skeleton_cuda.zhang_suen_iteration_plain(occ, h_cells, w_cells)
    got, n = skeleton_cuda.zhang_suen_iteration(occ, h_cells, w_cells)
    if not torch.equal(got, ref) or int(n) != int(changed):
        raise AssertionError(f"K2 {name}: one iteration differs from zhang_suen_iteration_plain")
    return its, err


def phase_k2_shape(name, S, spec, device):
    """K2 at one preset's shape, on an orchard's opened grid: against the
    plain loop, bitwise; the fixpoint's time by CUDA events with no host
    read inside; the bound."""
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.perceive import skeleton_cuda

    opened = opened_grid(S, spec, device)
    occ, hc, wc = opened.occ.contiguous(), opened.h_cells, opened.w_cells
    H, W = occ.shape
    it_k, err = check_k2(name, occ, hc, wc, (S.skeleton_max_iters, 3))
    (skeleton, stats), ms_k = timed_ms(
        lambda: skeleton_cuda.zhang_suen_fixpoint(occ, hc, wc, S.skeleton_max_iters), device, REPS)
    assert int(stats[0]) == it_k
    (_, it_p, _), ms_p = cuda_ms(lambda: skeleton_cuda.zhang_suen_fixpoint_plain(
        occ, hc, wc, S.skeleton_max_iters), REPS)
    # Bound, a thinning: the larger of the u8 plane once in and once out of
    # device memory, and, for every iteration, two sub-iterations of the
    # circuit over the words that still hold a cell (at least the skeleton's)
    # at the INT32 rate. It charges nothing for the dependency of an iteration
    # on the one before (a grid barrier and a round trip through L2), which
    # is what the kernel's time is made of.
    cells = H * W
    words = int((skeleton_cuda.pack_rows(skeleton) != 0).sum())
    bytes_ms, _ = bound(2 * cells)
    ops_ms, _ = bound(0, int32_ops=it_k * 2.0 * K2_OPS_PER_WORD * words)
    b_ms, b_by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"# phase 3: K2 Zhang-Suen {name} {H}x{W} (live {int(hc)}x{int(wc)}, "
        f"{int(occ.sum())} set cells -> {int(skeleton.sum())}): {it_k} iterations in one "
        f"cooperative launch: {ms_k:.4f} ms a thinning, {ms_k / it_k:.5f} ms an iteration (CUDA "
        f"events, no host read); plain {ms_p:.3f} ms; plane, iteration count and changed count "
        f"bitwise equal, also capped at 3 and at 1")
    log(f"# phase 3: K2 {name} bound {b_ms:.5f} ms a thinning ({b_by}): the larger of the plane "
        f"in and out, {bytes_ms:.5f} ms, and {it_k} iterations x {K2_OPS_PER_WORD} logic "
        f"operations x 2 sub-iterations x {words} words, {ops_ms:.6f} ms; "
        f"the kernel is at {100 * b_ms / ms_k:.1f} % of it")
    assert_under_bound(f"K2 {name}", ms_k, b_ms)
    return dict(max_abs_err=err, ms=ms_k / it_k, plain_ms=ms_p / it_p, fixpoint_ms=ms_k,
                fixpoint_plain_ms=ms_p, iterations=it_k, bound_ms=b_ms / it_k, bound_by=b_by)


def check_k2_group(name, occ, h_cells, w_cells, max_iters):
    """K2 over a group (occ [G, H, W]) in one launch against the plain
    batched loop and the single-world kernel on each world: planes and
    per-world counts bitwise. Returns (stats [G, 2] as a list, launches,
    max abs err)."""
    import torch
    from aosx_torch.perceive import skeleton_cuda

    G = occ.shape[0]
    ref, its, last = skeleton_cuda.zhang_suen_fixpoint_plain(occ, h_cells, w_cells, max_iters)
    zero_counts([skeleton_cuda.zhang_suen_fixpoint])
    got, stats = skeleton_cuda.zhang_suen_fixpoint(occ, h_cells, w_cells, max_iters)
    launches = skeleton_cuda.zhang_suen_fixpoint.launches
    err = float((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref) or not torch.equal(stats, torch.stack([its, last], -1)):
        raise AssertionError(f"K2 group {name}: kernel differs from the plain batched loop "
                             f"({int((got != ref).sum())} cells; stats {stats.tolist()} vs "
                             f"{torch.stack([its, last], -1).tolist()})")
    for g in range(G):
        one, st1 = skeleton_cuda.zhang_suen_fixpoint(occ[g].contiguous(), h_cells[g], w_cells[g],
                                                     max_iters)
        if not torch.equal(one, got[g]) or not torch.equal(st1, stats[g]):
            raise AssertionError(f"K2 group {name}: world {g} differs from its single-world run")
    return stats.tolist(), launches, err


def k2_group_bound(skel, its):
    """(bound ms, "bytes" or "operations") of a group's thinnings: every
    world's plane in and out, or its iterations of the circuit over the
    words still holding a cell, summed over the group."""
    from aosx_torch.perceive import skeleton_cuda

    G, H, W = skel.shape
    words = [int((skeleton_cuda.pack_rows(skel[g]) != 0).sum()) for g in range(G)]
    bytes_ms, _ = bound(2 * G * H * W)
    ops_ms, _ = bound(0, int32_ops=sum(it * 2.0 * K2_OPS_PER_WORD * w
                                       for it, w in zip(its, words)))
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_k2_world_axis(device, S, spec, name, seeds, caps):
    """K2 with a world axis on a group of orchards' opened grids: one launch
    (or one a chunk of worlds) against the plain batched loop and the
    single-world kernel, bitwise, uncapped and at each cap of ``caps``; ms a
    group beside the single-world launches; the group's bound."""
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.perceive import skeleton_cuda

    opened = opened_grid(S, spec, device, seeds)
    occ, hc, wc = opened.occ.contiguous(), opened.h_cells, opened.w_cells
    G, H, W = occ.shape
    stats, launches, err = check_k2_group(name, occ, hc, wc, S.skeleton_max_iters)
    for cap in caps:
        check_k2_group(f"{name} capped at {cap}", occ, hc, wc, cap)
    its = [s[0] for s in stats]
    if len(set(its)) < 2:
        raise AssertionError(f"K2 group {name}: every world ran {its[0]} iterations")
    (skel, _), ms_k = timed_ms(lambda: skeleton_cuda.zhang_suen_fixpoint(
        occ, hc, wc, S.skeleton_max_iters), device, REPS)
    planes = [occ[g].contiguous() for g in range(G)]
    _, ms_1 = timed_ms(lambda: [skeleton_cuda.zhang_suen_fixpoint(planes[g], hc[g], wc[g],
                                                                  S.skeleton_max_iters)
                                for g in range(G)], device, REPS)
    b_ms, b_by = k2_group_bound(skel, its)
    log(f"# phase 3: K2 world axis, {G} {name} opened grids ({H}x{W}): {launches} launch(es), "
        f"iterations per world {its}; {ms_k:.4f} ms a group ({ms_k / G:.5f} a world) against "
        f"{ms_1:.4f} ms for {G} single-world launches; planes and per-world counts bitwise "
        f"equal to the plain batched loop and to each world's single-world run, also capped at "
        f"{list(caps)}; bound {b_ms:.5f} ms ({b_by}), {100 * b_ms / ms_k:.1f} % of it")
    assert_under_bound(f"K2 group {name}", ms_k, b_ms)
    return dict(worlds=G, group_ms=ms_k, singles_ms=ms_1, group_bound_ms=b_ms,
                group_bound_by=b_by, group_launches=launches, iterations=its, max_abs_err=err)


def phase_k2_chunks(device, H=40, W=75):
    """More worlds than SMs: K2 runs as a counted launch a chunk of at most a
    world an SM, each world stopping at its own fixpoint, and equals the
    plain batched loop bitwise."""
    import torch
    from aosx_torch.perceive import skeleton_cuda

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    G = sms + 9
    live = np.stack([H - np.arange(G) % 4, W - 3 * (np.arange(G) % 5)], 1).astype(np.int32)
    occ = torch.from_numpy(np.stack([thick_mask(H, W, int(lh), int(lw), seed=g)
                                     for g, (lh, lw) in enumerate(live)])).to(device)
    lv = torch.from_numpy(live).to(device)
    stats, launches, _ = check_k2_group(f"{G} worlds of {H}x{W}", occ, lv[:, 0].contiguous(),
                                        lv[:, 1].contiguous(), 64)
    if launches != -(-G // sms):
        raise AssertionError(f"K2 over {G} worlds: {launches} launches, expected "
                             f"{-(-G // sms)}")
    log(f"# phase 3: K2 over {G} worlds of {H}x{W} (more than the {sms} SMs): {launches} counted "
        f"launches, iterations {sorted({s[0] for s in stats})}, bitwise equal to the plain "
        f"batched loop and to each world's single-world run")
    return launches


def phase_k2(device, bench_spec):
    import torch
    from aosx_torch.config import BENCH_STATICS, MC_STATICS
    from aosx_torch.orchards import OrchardSpec

    # live regions that are not multiples of 32 columns or of a band's height
    for h, w, live_h, live_w in ((192, 256, 184, 232), (40, 75, 37, 70), (384, 512, 301, 499)):
        occ = torch.from_numpy(thick_mask(h, w, live_h, live_w, seed=3)).to(device)
        i32 = dict(dtype=torch.int32, device=device)
        it, _ = check_k2(f"{live_h}x{live_w} inside {h}x{w}", occ, torch.tensor(live_h, **i32),
                         torch.tensor(live_w, **i32), (64, 3, 0))
        log(f"# phase 3: K2 live region {live_h}x{live_w} inside {h}x{w}: {it} iterations, "
            f"bitwise equal to the plain loop uncapped, capped at 3, 1 and 0")
    bench = phase_k2_shape("BENCH_STATICS", BENCH_STATICS, bench_spec, device)
    mc_spec = OrchardSpec(**json.loads(MC_REFERENCE.read_text())["spec"])
    mc = phase_k2_shape("MC_STATICS", MC_STATICS, mc_spec, device)
    group_mc = phase_k2_world_axis(device, MC_STATICS, mc_spec, "MC_STATICS", range(WORLDS),
                                   (12, 3))
    group_bench = phase_k2_world_axis(device, BENCH_STATICS, bench_spec, "BENCH_STATICS",
                                      (0, 1), (3,))
    group_mc["chunked_launches"] = phase_k2_chunks(device)
    strip = ("max_abs_err",)
    return dict(bench, mc={k: v for k, v in mc.items() if k not in strip},
                world_axis={k: v for k, v in group_mc.items() if k not in strip},
                world_axis_bench={k: v for k, v in group_bench.items() if k not in strip},
                max_abs_err=max(bench["max_abs_err"], group_mc["max_abs_err"],
                                group_bench["max_abs_err"]))


def run_test_slice(device):
    import torch
    from aosx_torch import engine
    from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
    from aosx_torch.orchards import OrchardSpec

    spec = OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0), noise_pts=64)
    pc, poly = cloud(S, spec, 0, device)
    params = params_as_f32(AosParams(), device)
    world = engine.prepare_world(pc, poly, params, torch.zeros((S.max_exclusions, 3), device=device), S)
    st = engine.initial_state(world, S)
    metrics = []
    for _ in range(TEST_TICKS):
        st, m = engine.step(st, world, params, S, v_dt=TEST_V_DT)
        metrics.append(m)
    return world, st, metrics


XLA_F32_N = 1 << 20


def xla_f32_cases(n=XLA_F32_N, seed=0):
    """Seeded inputs of the port's copies of XLA:CPU's f32 arithmetic on the
    plan path (aosx_torch.ops, f32math, geom), at the shapes the path gives
    them, about n values each: name -> (function, numpy arguments)."""
    from aosx_torch import f32math
    from aosx_torch.geom import wrap_angle
    from aosx_torch.ops import cumsum_xla, fma, norm2, sum_xla

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def signed(*shape, lo=-6, hi=6):
        return (rng.standard_normal(shape) * np.exp(rng.uniform(lo, hi, shape))).astype(f32)

    info = np.finfo(f32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.4375, info.tiny, -info.tiny, info.max,
                        1e-45, -1e-40, np.inf, -np.inf, np.nan], f32)
    sy, sx = np.meshgrid(special, special)
    y, x = signed(n, lo=-12, hi=12), signed(n, lo=-12, hi=12)
    y[:sy.size], x[:sx.size] = sy.ravel(), sx.ravel()
    turn = rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(f32)
    return {
        # linearize's prefix tables over 768 + 1 entries; path_cost over
        # 767 terms and a rollout's travel over 1,199
        "cumsum_xla": (cumsum_xla, (signed(64, 769),)),
        "sum_xla": (sum_xla, (signed(n // 767, 767),)),
        "sum_xla_travel": (sum_xla, (np.abs(signed(n // 1199, 1199)),)),
        "atan2_f32": (f32math.atan2_f32, (y, x)),
        "sin_f32": (f32math.sin_f32, (turn,)),
        "cos_f32": (f32math.cos_f32, (turn,)),
        "norm2": (norm2, (signed(n, 2, lo=-4, hi=5),)),
        "wrap_angle": (wrap_angle, (rng.uniform(-50, 50, n).astype(f32),)),
        "fma": (fma, (signed(n), signed(n), signed(n))),
    }


def phase_xla_f32(device):
    """The port's copies of XLA:CPU's f32 arithmetic (the blocked scan and
    sum, glibc's atan2f, sinf and cosf, the fused two-term norm, the jitted
    wrap, the exact FMA) give the card the CPU's bits on the same seeded
    inputs; NaN counts as equal to NaN whatever its payload. Also each one's
    time on the card at its shape (CUDA events, median of REPS)."""
    import torch

    out = {}
    for name, (fn, args) in xla_f32_cases().items():
        cpu = fn(*(torch.from_numpy(a) for a in args)).numpy()
        dev_args = [torch.from_numpy(a).to(device) for a in args]
        card = fn(*dev_args).cpu().numpy()
        nan = np.isnan(cpu) & np.isnan(card)
        differ = int(((cpu.view(np.int32) != card.view(np.int32)) & ~nan).sum())
        if differ:
            raise AssertionError(f"phase 4: {name} differs between the card and the CPU at "
                                 f"{differ} of {cpu.size} values")
        times = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*dev_args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = dict(inputs=int(args[0].size), shape=list(args[0].shape),
                         card_ms=float(np.median(times)))
    # the follower's arithmetic replayed from one CUDA graph (ops.card_graph)
    # against the same calls launched one by one, on 64 lanes, new inputs
    # each replay
    from aosx_torch import engine

    rng = np.random.default_rng(1)
    worst = 0
    for rep in range(3):
        t = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.uniform(-20, 20, shape).astype(np.float32)).to(device)
        args = (t(64, 2), t(64, 2), t(64) / 7, torch.from_numpy(
            rng.integers(0, 4, 64).astype(np.int32)).to(device), t(64) / 7,
            torch.tensor(0.12, device=device), torch.tensor(0.6, device=device))
        for a, b in zip(engine._drive.__wrapped__(*args), engine._drive(*args)):
            worst += int((a.view(torch.int32) != b.view(torch.int32)).sum())
    if worst:
        raise AssertionError(f"phase 4: the follower's graph differs from its launches at {worst}")
    log(f"# phase 4: XLA:CPU's f32 arithmetic of the plan path, card == CPU port bitwise on "
        f"the same seeded inputs: {json.dumps(out)}; the follower's CUDA graph == its launches "
        f"one by one (64 lanes, 3 replays)")
    return out


def phase_test_slice(device):
    t0 = time.time()
    gpu = run_test_slice(device)
    t1 = time.time()
    cpu = run_test_slice("cpu")
    t2 = time.time()
    worst = assert_trees_match(cpu[0], gpu[0], "TEST_STATICS world")
    worst = max(worst, assert_trees_match(cpu[1], gpu[1], "TEST_STATICS final state"))
    for i, (a, b) in enumerate(zip(cpu[2], gpu[2])):
        worst = max(worst, assert_trees_match(a, b, f"TEST_STATICS tick {i} metrics"))
    log(f"# phase 4: TEST_STATICS stage_full + {TEST_TICKS} ticks: CUDA == CPU port "
        f"(int/bool bitwise, floats within {worst:g} ulp <= {ULP_BOUND}); "
        f"waypoints {int(gpu[0].waypoints.count)}, plan_len {[int(m['plan_len']) for m in gpu[2]][-1]}; "
        f"host wall s: cuda {t1 - t0:.1f}, cpu {t2 - t1:.1f}")


def compact_chain(cells, S):
    """perceive.rows.compact_cells and the union-find chain on its output,
    as tests/test_torch_rows.py runs them against the JAX package."""
    from aosx_torch.perceive import rows

    cell_flat, cell_ok, inv = rows.compact_cells(cells, S)
    L_fast, overflow = rows.run_level_labels(cell_flat, cell_ok, S.grid_h, S.grid_w, S)
    nbrs = rows.neighbor_table(cell_flat, cell_ok, inv, S.grid_h, S.grid_w)
    L_cell = rows.union_find_labels(nbrs[..., [0, 1, 2, 5, 6, 7]], S,
                                    L0=rows.run_collapse_init(cell_flat, cell_ok, S.grid_w))
    return dict(cell_flat=cell_flat, cell_ok=cell_ok, inv=inv, L_fast=L_fast,
                overflow=overflow, nbrs=nbrs, L_cell=L_cell)


def phase_compact_cells(device):
    """Phase 4: compact_cells and the chain on it on the card == the CPU
    port, every output bitwise, on tests/test_torch_rows.py's masks (random
    at four densities, the diagonal staircase), one at a time and as one
    group with a world axis."""
    import torch
    from aosx_torch.config import TEST_STATICS as S

    t0 = time.time()
    masks = []
    for seed, density in ((0, 0.08), (1, 0.25), (2, 0.6), (3, 0.02)):
        m = np.zeros((S.grid_h, S.grid_w), bool)
        m[:48, :64] = np.random.default_rng(seed).random((48, 64)) < density
        masks.append(m)
    side = min(S.grid_h, S.grid_w, 200)
    stair = np.zeros((S.grid_h, S.grid_w), bool)
    stair[np.arange(side), np.arange(side)] = True
    masks.append(stair)
    cases = [(f"mask {i}", torch.from_numpy(m)) for i, m in enumerate(masks)]
    cases.append(("group of 5", torch.from_numpy(np.stack(masks))))
    for name, m in cases:
        cpu = compact_chain(m, S)
        gpu = compact_chain(m.to(device), S)
        torch.cuda.synchronize()
        bad = [k for k in cpu if not torch.equal(cpu[k], gpu[k].cpu())]
        if bad:
            raise AssertionError(f"phase 4: compact_cells chain, {name}: card differs from "
                                 f"the CPU port in {bad}")
    log(f"# phase 4: perceive.rows.compact_cells + run_level_labels, neighbor_table, "
        f"union_find_labels at TEST_STATICS: card == CPU port bitwise on {len(masks)} masks "
        f"and their group; {time.time() - t0:.1f} s")


def phase_bench_slice(device, bench_spec):
    import torch
    from aosx_torch import engine
    from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.gvd.graph import merge_seeds
    from aosx_torch.gvd.voronoi import jump_flood
    from aosx_torch.perceive import perceive, skeleton_cuda

    # the port's numpy cloud, not bench.py's jax.random one: the two
    # generators draw different numbers from the same spec and seed
    pc, poly = cloud(S, bench_spec, 0, device)
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint)

    def stage_full():
        out = perceive(pc, poly, params, excl, S, ror_method="sorted")
        world = engine.world_from_perceive(out, params, S)
        state, metrics = engine.step(engine.initial_state(world, S), world, params, S)
        return out, world, metrics, state

    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.time()
    out, world, metrics, state = stage_full()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = read_counts(kernels)
    log(f"# phase 5: BENCH_STATICS stage_full (first run {first_s:.2f} s host wall): "
        f"launches {launches}")

    ref = json.loads(REFERENCE.read_text())
    owner = jump_flood(out.skeleton, merge_seeds(out.seeds, params, S), S)
    got = dict(
        seeds=int(out.seeds.valid.sum()), rows=int(out.rows.valid.sum()),
        nodes=int(world.graph.num_nodes), edges=int(world.graph.num_edges),
        waypoints=int(world.waypoints.count), plan_len=int(metrics["plan_len"]),
        mod=int(metrics["mod"]), status=int(metrics["status"]), guards=int(metrics["guards"]),
        skeleton_sha256=hashlib.sha256(out.skeleton.occ.cpu().numpy().tobytes()).hexdigest(),
        owner_sha256=hashlib.sha256(owner.cpu().numpy().astype("<i4").tobytes()).hexdigest(),
        robot_xy=[float(v) for v in state.robot.xy.cpu().numpy()],
        robot_yaw=float(state.robot.yaw))
    log(f"# phase 5: {json.dumps(got)}")
    wxy = world.waypoints.xy.cpu().numpy()[:got["waypoints"]]
    diffs = {k: (got[k], ref[k]) for k in got if got[k] != ref[k] and k != "owner_sha256"}
    if diffs:
        raise AssertionError(f"BENCH_STATICS slice differs from the JAX reference: {diffs}")
    # the owner plane bitwise: K1 and its plain version carry the flood's
    # owner, x and y planes and fold each in the rounding XLA:CPU gives it in
    # the reference's lowering (aosx_torch/gvd/voronoi.py's ROUNDINGS)
    if got["owner_sha256"] != ref["owner_sha256"]:
        ref_owner = np.load(REFERENCE.with_name("bench_np_seed0_owner.npz"))["owner"]
        off = np.argwhere(owner.cpu().numpy() != ref_owner)
        raise AssertionError(f"owner plane differs from the JAX reference in {len(off)} of "
                             f"{ref_owner.size} cells, first {off[:8].tolist()}")
    wp_ulp = ulp_distance(np.asarray(ref["waypoints_xy"], np.float32), wxy)
    if wp_ulp > WAYPOINT_ULP_BOUND:
        raise AssertionError(f"waypoint xy differ from the reference by {wp_ulp} ulp")
    assert got["seeds"] > 0 and got["rows"] > 0 and got["nodes"] > 0
    assert got["waypoints"] >= 4 and got["plan_len"] > 0
    if int(world.guards) != 0:
        raise AssertionError(f"world guard bits {int(world.guards)}")
    assert_group_launches(launches, 1, S, "stage_full")

    # per-stage medians; a stage's time includes its host synchronisations
    _, t_perceive = cuda_ms(lambda: perceive(pc, poly, params, excl, S), REPS)
    _, t_world = cuda_ms(lambda: engine.world_from_perceive(out, params, S), REPS)
    _, t_step = cuda_ms(lambda: engine.step(engine.initial_state(world, S), world, params, S), REPS)
    _, t_total = cuda_ms(stage_full, REPS)
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"# phase 5: median ms (CUDA events, {REPS} reps): perceive {t_perceive:.2f}, "
        f"graph+costs+waypoints+trim {t_world:.2f}, step {t_step:.2f}, stage_full {t_total:.2f}; "
        f"matches the JAX reference (counts, skeleton hash, the robot's pose after the step; "
        f"owner plane bitwise; waypoints within {wp_ulp:g} ulp); "
        f"peak allocated {mem:.2f} GiB")
    return launches, dict(perceive_ms=t_perceive, world_ms=t_world, step_ms=t_step,
                          stage_full_ms=t_total)


def k3_clouds(device, bench_spec):
    """K3's single-world inputs at BENCH_STATICS: the bench orchard parked
    and padded as ror_counts parks and pads it, and a uniform cloud at its
    density (its bounding box stretched along x to hold as many points).
    Returns ((name, [N, 3] points), ...), r2."""
    import torch
    from aosx_torch.config import BENCH_STATICS as S, AosParams
    from aosx_torch.perceive import points

    r2 = torch.tensor(AosParams().ror_radius, dtype=torch.float32, device=device) ** 2
    pc, _ = cloud(S, bench_spec, 0, device)
    n = S.max_points
    n_valid = int(pc.valid.sum())
    xyz = pc.xyz[pc.valid].cpu().numpy()
    lo, hi = xyz.min(0), xyz.max(0)
    hi_x = lo[0] + (hi[0] - lo[0]) * n / n_valid
    rng = np.random.default_rng(1)
    uniform = np.stack([rng.uniform(lo[0], hi_x, n), rng.uniform(lo[1], hi[1], n),
                        rng.uniform(lo[2], hi[2], n)], 1).astype(np.float32)
    return ((("bench orchard", points.pad_to_block(points.park(pc.xyz, pc.valid), 2048)),
             ("uniform", torch.from_numpy(uniform).to(device))), r2)


def k3_group(device, G=WORLDS):
    """K3's world-axis input: the parked clouds of G Monte-Carlo orchards,
    [G, 4096, 3], and r2."""
    import torch
    from aosx_torch import tree
    from aosx_torch.config import MC_STATICS as S, AosParams
    from aosx_torch.orchards import OrchardSpec
    from aosx_torch.perceive import points

    spec = OrchardSpec(**json.loads(MC_REFERENCE.read_text())["spec"])
    pc, _ = tree.stack([cloud(S, spec, i, device) for i in range(G)])
    pts = points.pad_to_block(points.park(pc.xyz, pc.valid), 2048).contiguous()
    r2 = torch.tensor(AosParams().ror_radius, dtype=torch.float32, device=device) ** 2
    return pts, r2


def k3_bound(G, m):
    """K3's bound for G worlds of m points: (ms, "bytes" or "operations",
    ms of the all-ordered-pairs count). The all-pairs function the TPU
    kernel defines compares every pair's d2 with r2, so its least work is
    the m (m + 1) / 2 distinct and self pairs a world (d2 is symmetric bit
    for bit; a schedule that skipped far or parked pairs is not counted),
    each 6 FP32 instructions (1 mul + 2 fma for a.b, the sum of
    norms, 1 fma for the difference, the compare) and an INT32 add; the
    input is read once (12 B a point), the counts written once (4 B). The
    second count charges all m^2 ordered pairs, as an implementation that
    evaluates both orders does."""
    pairs = G * m * (m + 1) / 2
    b_ms, b_by = bound(16 * G * m, fp32_ops=6.0 * pairs, int32_ops=pairs)
    square_ms, _ = bound(16 * G * m, fp32_ops=6.0 * G * m * m, int32_ops=1.0 * G * m * m)
    return b_ms, b_by, square_ms


def phase_k3(device, bench_spec):
    import torch
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.perceive import ror_cuda

    # the kernel's ms with the card kept busy ahead of the launch, as K1's,
    # K2's and the probes'
    clouds, r2 = k3_clouds(device, bench_spec)
    out = {}
    for name, pts in clouds:
        got, ms_k = timed_ms(lambda: ror_cuda.ror_counts(pts, r2), device, REPS)
        ref, ms_p = cuda_ms(lambda: ror_cuda.ror_counts_plain(pts, r2), 2)
        equal = torch.equal(got, ref)
        err = float((got.double() - ref.double()).abs().max())
        b_ms, b_by, square_ms = k3_bound(1, pts.shape[0])
        log(f"# phase 6: K3 ROR counts, {name} cloud, N = {pts.shape[0]}, r = 0.2: kernel "
            f"{ms_k:.3f} ms, plain {ms_p:.3f} ms, bitwise equal {equal}, mean count "
            f"{float(got.float().mean()):.2f}; bound {b_ms:.3f} ms ({b_by}), "
            f"{100 * b_ms / ms_k:.1f} % of it (all ordered pairs: {square_ms:.3f} ms, "
            f"{100 * square_ms / ms_k:.1f} %)")
        if not equal:
            raise AssertionError(f"K3 differs from its plain version on the {name} cloud "
                                 f"(max abs err {err})")
        assert_under_bound(f"K3 {name} cloud", ms_k, b_ms)
        out[name] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    group = phase_k3_world_axis(device)
    phase_k3_odd_sizes(device)
    bench = out["bench orchard"]
    return dict(max_abs_err=max(group.pop("max_abs_err"),
                                *(o["max_abs_err"] for o in out.values())),
                ms=bench["ms"], plain_ms=bench["plain_ms"], uniform_ms=out["uniform"]["ms"],
                uniform_plain_ms=out["uniform"]["plain_ms"], bound_ms=bench["bound_ms"],
                bound_by=bench["bound_by"], world_axis=group)


def phase_k3_world_axis(device, G=WORLDS):
    """K3 with a world axis: the parked clouds of G Monte-Carlo orchards
    [G, 4096, 3] in one launch against the plain batched counts and the
    single-world kernel on each cloud, bitwise; ms a group beside G
    single-world launches; the group's bound."""
    import torch
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.perceive import ror_cuda

    pts, r2 = k3_group(device, G)
    ref, ms_p = cuda_ms(lambda: ror_cuda.ror_counts_plain(pts, r2), 2)
    zero_counts([ror_cuda.ror_counts])
    got = ror_cuda.ror_counts(pts, r2)
    launches = ror_cuda.ror_counts.launches
    err = float((got.double() - ref.double()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"K3 group of {G} differs from its plain batched version "
                             f"(max abs err {err})")
    singles = [pts[g].contiguous() for g in range(G)]
    for g in range(G):
        if not torch.equal(ror_cuda.ror_counts(singles[g], r2), got[g]):
            raise AssertionError(f"K3 group: cloud {g} differs from its single-world launch")
    _, ms_k = timed_ms(lambda: ror_cuda.ror_counts(pts, r2), device, REPS)
    _, ms_1 = timed_ms(lambda: [ror_cuda.ror_counts(c, r2) for c in singles], device, REPS)
    m = pts.shape[1]
    b_ms, b_by, square_ms = k3_bound(G, m)
    log(f"# phase 6: K3 world axis, {G} MC clouds of {m} points: {launches} launch, "
        f"{ms_k:.4f} ms a group against {ms_1:.4f} ms for {G} single-world launches; plain "
        f"batched {ms_p:.2f} ms; bitwise equal to both; bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / ms_k:.1f} % of it (all ordered pairs: {square_ms:.4f} ms, "
        f"{100 * square_ms / ms_k:.1f} %)")
    if launches != 1:
        raise AssertionError(f"K3 group of {G}: {launches} launches, expected 1")
    assert_under_bound(f"K3 group of {G}", ms_k, b_ms)
    return dict(worlds=G, points=m, group_ms=ms_k, singles_ms=ms_1, group_plain_ms=ms_p,
                group_bound_ms=b_ms, group_bound_by=b_by, group_launches=launches,
                max_abs_err=err)


K3_ODD_SIZES = (1, 33, 2047, 2049, 5000)
K3_ODD_GROUP = (3, 3000)


def phase_k3_odd_sizes(device):
    """K3 on clouds whose size is no multiple of its tile, single worlds and
    a group with r2 each its own: bitwise its plain version, one launch a
    call."""
    import torch
    from aosx_torch.perceive import ror_cuda
    from torch_helpers import far_cloud

    cases = [(f"n = {n}", far_cloud((n, 3), n), np.float32(0.2) ** 2) for n in K3_ODD_SIZES]
    G, n = K3_ODD_GROUP
    cases.append((f"{G} worlds of {n}", far_cloud((G, n, 3), 7),
                  np.float32([0.2, 0.3, 0.15]) ** 2))
    for name, xyz, r2 in cases:
        pts = torch.from_numpy(xyz).to(device)
        r2 = torch.from_numpy(np.asarray(r2)).to(device)
        zero_counts([ror_cuda.ror_counts])
        got = ror_cuda.ror_counts(pts, r2)
        if ror_cuda.ror_counts.launches != 1:
            raise AssertionError(f"K3 {name}: {ror_cuda.ror_counts.launches} launches")
        ref = ror_cuda.ror_counts_plain(pts, r2)
        if not torch.equal(got, ref):
            err = float((got.double() - ref.double()).abs().max())
            raise AssertionError(f"K3 {name} differs from its plain version (max abs err {err})")
    log(f"# phase 6: K3 bitwise its plain version on {', '.join(c[0] for c in cases)}")


def serving_frames(ref, statics, device):
    """The reference's map frames: the bench orchard shuffled with
    default_rng(0) and revealed in ref["fracs"], one valid point of frame
    ref["moved"]["frame"] moved by dx_m. Returns ([PointCloud], polygon)."""
    import torch
    from aosx_torch.orchards import OrchardSpec, make_orchard_np
    from aosx_torch.types import PointCloud, Polygon

    xyz, poly = make_orchard_np(OrchardSpec(**ref["spec"]), seed=ref["seed"])
    xyz = xyz[np.random.default_rng(0).permutation(len(xyz))]
    frames = []
    for f, frac in enumerate(ref["fracs"]):
        k = int(len(xyz) * frac)
        buf = np.zeros((statics.max_points, 3), np.float32)
        buf[:k] = xyz[:k]
        valid = np.zeros(statics.max_points, bool)
        valid[:k] = True
        if f == ref["moved"]["frame"]:
            buf[ref["moved"]["point"], 0] += np.float32(ref["moved"]["dx_m"])
        frames.append(PointCloud(xyz=torch.from_numpy(buf).to(device),
                                 valid=torch.from_numpy(valid).to(device)))
    return frames, Polygon.from_array(poly, statics, device)


def world_summary(sv):
    """The per-frame world and cache summary of the reference."""
    out, world = sv.inc.out, sv.inc.world
    return dict(
        seeds=int(out.seeds.valid.sum()), rows=int(out.rows.valid.sum()),
        nodes=int(world.graph.num_nodes), edges=int(world.graph.num_edges),
        waypoints=int(world.waypoints.count), world_guards=int(world.guards),
        skeleton_sha256=hashlib.sha256(out.skeleton.occ.cpu().numpy().tobytes()).hexdigest(),
        cache_success=[bool(x) for x in sv.cache.success.tolist()],
        cache_count=[int(x) for x in sv.cache.plan_count.tolist()])


def split_witness(world, wp_base, params, S):
    """Per plan-cache row 0..W+3 of a world: (raw path, the port's
    breakpoints, the f64 breakpoints of tests/torch_reference/linearize_f64.py)."""
    import torch
    from aosx_torch.plan import plancache
    from aosx_torch.plan.linearize import breakpoint_mask
    from torch_reference.linearize_f64 import breakpoints

    out = []
    for raw, _ in plancache.plan_rows(world, params, S, wp_base):
        port = torch.nonzero(breakpoint_mask(raw, params, S)).flatten().tolist()
        out.append((raw, port, breakpoints(raw.xy.cpu().numpy(), int(raw.count),
                                           max_segments=S.max_segments)))
    return out


def looped_cache(world, params, S):
    """A world's plan cache built one row at a time through unbatched
    calls (plan_current_path, linearize and the row payload of each row, row
    W+4 the empty path), the way the port built it before the rows became
    one batched call: the reference that holds build_plan_cache's batched
    rows bitwise on the card."""
    import torch
    from aosx_torch import tree
    from aosx_torch.plan import plancache
    from aosx_torch.plan.linearize import linearize
    from aosx_torch.plan.mission import plan_current_path
    from aosx_torch.types import Path

    missions, wps = plancache.row_missions(world.waypoints, params, S)
    R = plancache.num_rows(S)
    rows = []
    for r in range(R):
        m, wp = tree.lane(missions, r), tree.lane(wps, r)
        live = m.initial_reached & (m.target_wp >= 0) & (m.target_wp < wp.count)
        raw, ok = plan_current_path(m, wp, world.graph, world.costmat, world.skeleton, params,
                                    S, trim_plane=world.trim_skel, astar_enabled=live)
        if r == R - 1:
            raw = Path(xy=torch.zeros_like(raw.xy), yaw=torch.zeros_like(raw.yaw),
                       count=torch.zeros_like(raw.count))
            ok = torch.zeros_like(ok)
        rows.append(plancache._row_payload(raw, linearize(raw, params, S), ok))
    return plancache.PlanCache(**{k: torch.stack([p[k] for p in rows]) for k in rows[0]})


def assert_caches_bitwise(want, got, what):
    """Every leaf of two plan caches equal bit for bit (floats as i32)."""
    import torch

    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: {f.name} differs")


def raw_path_match(a, b):
    """How the port's raw path a [n, 2] f32 matches JAX's b: "equal"
    (bitwise); "ulp" (the same points within ULP_BOUND ulp: XLA:CPU
    contracts the straight-line and tail interpolation into fused
    multiply-adds); "tie" (another route between the same end points, of
    the same length from a's first point within ULP_BOUND ulp of it: A*
    and plan_between pick among routes of equal cost, collinear nodes
    included, by f32 costs whose rounding differs from JAX's); else None."""
    if len(a) == len(b) and np.array_equal(a.view(np.int32), b.view(np.int32)):
        return "equal"
    if len(a) == len(b) and ulp_distance(b, a) <= ULP_BOUND:
        return "ulp"
    if not len(a) or not len(b) or not np.array_equal(a[-1], b[-1]):
        return None
    la, lb = route_length(a, a), route_length(a, b)
    return "tie" if abs(la - lb) <= ULP_BOUND * np.spacing(np.float32(max(la, lb))) else None


def route_length(a, p):
    """f64 length of the polyline a[0], p[0], p[1], ..."""
    d = np.diff(np.concatenate([a[:1], p]).astype(np.float64), axis=0)
    return float(np.hypot(d[:, 0], d[:, 1]).sum())


def compare_serving(ref, sv0, frame_states, got_frames, per_frame_metrics, params, S):
    """Hold the serving run against the JAX reference summary: raises on any
    difference beyond the stated bounds."""
    from aosx_torch.gvd.graph import merge_seeds
    from aosx_torch.gvd.voronoi import jump_flood

    bad = []
    ref0 = np.load(SERVING_REFERENCE.with_name("serving_np_seed0_frame0.npz"))
    # plan-cache rows: success and plan length of every row bitwise; frame
    # 0's raw A* paths bitwise (raw_path_match). A row that differs is
    # printed (with its f32 and exact f64 regression breakpoints,
    # linearize_f64.py) and fails the phase unless NAMED_CACHE_ROWS or
    # NAMED_RAW_ROWS names its cause
    adopted = {int(m["adopted"][-1]) for m in per_frame_metrics}
    adopted |= {ref["init"]["adopted"]} | {f["adopted_at_frame"] for f in ref["frames"]}
    witnesses = {}

    def witness(state, wp_base):
        key = id(state.cache)
        if key not in witnesses:
            witnesses[key] = split_witness(state.inc.world, wp_base, params, S)
        return witnesses[key]

    rows0 = witness(sv0, None)
    raw_match, ties = {}, []
    for r, (raw, _, _) in enumerate(rows0):
        a = raw.xy.cpu().numpy()[:int(raw.count)]
        b = ref0["raw_xy"][r][:int(ref0["raw_count"][r])]
        kind = raw_path_match(a, b)
        raw_match.setdefault(kind, []).append(r)
        if kind != "equal" and r not in NAMED_RAW_ROWS:
            bad.append(f"frame 0 cache row {r}: raw A* path differs from JAX's ({kind})")
        if kind in ("tie", "ulp"):
            ties.append(f"row {r} ({kind}): port {len(a)} points, {route_length(a, a):.6f} m; "
                        f"JAX {len(b)} points, {route_length(a, b):.6f} m; "
                        f"{NAMED_RAW_ROWS.get(r, 'cause not named')}")
    split_rows = [r for r, (raw, _, _) in enumerate(rows0) if int(raw.count) > 4]
    exact_rows = [r for r in split_rows if rows0[r][1] == rows0[r][2]]
    differing = {}

    def check_world(what, got, want, state, wp_base):
        for k, v in want.items():
            if k == "metrics" or k not in got:
                continue
            if k == "cache_count":
                for r, (a, b) in enumerate(zip(got[k], v)):
                    if a == b:
                        continue
                    rows = witness(state, wp_base)
                    split = (rows[r][1], rows[r][2]) if r < len(rows) else (None, None)
                    differing.setdefault(r, (a, b) + split)
                    if r in adopted or r not in NAMED_CACHE_ROWS:
                        bad.append(f"{what} cache row {r} count: {a} vs {b}")
            elif got[k] != v:
                bad.append(f"{what} {k}: {got[k]} vs {v}")

    check_world("init", dict(world_summary(sv0), keep=int(sv0.inc.keep.sum()),
                             adopted=int(sv0.st.adopted)), ref["init"], sv0, None)
    worst_ulp, worst_yaw = 0.0, 0.0
    prev = sv0
    for f, (g, rf, m, st) in enumerate(zip(got_frames, ref["frames"], per_frame_metrics,
                                           frame_states)):
        # a frame that kept the cache keeps the world and tour it was built on
        prev = prev if st.cache is prev.cache else st
        check_world(f"frame {f}", g, rf, prev, prev.st.wp if prev is not sv0 else None)
        for k, v in rf["metrics"].items():
            got = m[k].cpu().numpy()
            want = np.asarray(v, dtype=got.dtype)
            if k == "yaw":
                d = float(np.abs(want.astype(np.float64) - got).max())
                worst_yaw = max(worst_yaw, d)
                if not d <= YAW_BOUND_RAD:
                    bad.append(f"frame {f} metric yaw: {d} rad")
            elif got.dtype == np.float32:
                d = ulp_distance(want, got)
                worst_ulp = max(worst_ulp, d)
                if d > TICK_ULP_BOUND:
                    bad.append(f"frame {f} metric {k}: {d} ulp")
            elif not np.array_equal(want, got):
                bad.append(f"frame {f} metric {k}: {got.tolist()} vs {want.tolist()}")
    valid0 = sv0.inc.valid.cpu().numpy()
    if not np.array_equal(valid0, ref0["valid"]):
        raise AssertionError("frame 0: the valid mask differs from the JAX reference")
    ror_points = int((sv0.inc.cnt.cpu().numpy() != ref0["cnt"])[valid0].sum())
    owner = jump_flood(sv0.inc.out.skeleton, merge_seeds(sv0.inc.out.seeds, params, S), S)
    owner_cells = int((owner.cpu().numpy() != ref0["owner"]).sum())
    log(f"# phase 7: frame 0 ROR counts differ from the JAX reference at {ror_points} of "
        f"{int(valid0.sum())} valid points (bound {ROR_POINT_BOUND}); owner plane in "
        f"{owner_cells} of {owner.numel()} cells (bound 0); tick xy within "
        f"{worst_ulp:g} ulp (bound {TICK_ULP_BOUND}), yaw within {worst_yaw:.3g} rad (bound "
        f"{YAW_BOUND_RAD:.3g})")
    log(f"# phase 7: plan cache: frame 0 raw A* paths against JAX's, rows by kind: "
        f"{json.dumps({str(k): v for k, v in raw_match.items()})} ({len(ties)} not equal: "
        f"tie or ulp); of its {len(split_rows)} rows of more than 4 points the port's f32 "
        f"split is the exact (f64) one on {len(exact_rows)}; plan lengths equal JAX's on every "
        f"row but {len(differing)} (named in ROADMAP section 3: "
        f"{len(set(differing) & set(NAMED_CACHE_ROWS))})" + (":" if differing or ties else ""))
    for t in ties:
        log(f"#   raw {t}")
    for r, (a, b, port, f64) in sorted(differing.items()):
        log(f"#   row {r}: length port {a}, JAX {b}; breakpoints port {port}, f64 {f64}; "
            f"{NAMED_CACHE_ROWS.get(r, 'cause not named')}")
    if ror_points > ROR_POINT_BOUND:
        bad.append(f"frame 0 ROR counts differ at {ror_points} points")
    if owner_cells:
        bad.append(f"frame 0 owner plane differs in {owner_cells} cells")
    if bad:
        raise AssertionError("serving differs from the JAX reference: " + "; ".join(bad))


def phase_serving(device):
    import dataclasses

    import torch
    from aosx_torch import serving
    from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
    from aosx_torch.engine import stack_metrics
    from aosx_torch.gvd import jfa_pass_cuda, voronoi
    from aosx_torch.perceive import ror_cuda, skeleton_cuda
    from aosx_torch.plan import plancache

    ref = json.loads(SERVING_REFERENCE.read_text())
    frames, poly = serving_frames(ref, S, device)
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint, ror_cuda.ror_counts)
    ticks, v_dt = ref["ticks"], ref["v_dt"]
    torch.cuda.reset_peak_memory_stats()

    # the main path: serve_init, then per map frame serve_map_frame and the
    # control ticks (incremental.serve_frames written out, to keep the state
    # each frame's ticks start from)
    zero_counts(kernels)
    sv, init_ms = host_ms(lambda: serving.serve_init(frames[0], poly, params, excl, S,
                                                     ror_method="pallas"))
    sv0 = sv
    got_frames, frame_ms, per_frame_metrics, frame_states = [], {}, [], []
    for pc in frames:
        (sv, level), ms = host_ms(lambda: serving.serve_map_frame(
            sv, pc, poly, params, excl, S, ror_method="pallas"))
        frame_ms.setdefault(int(level), []).append(ms)
        frame_states.append(sv)
        sv_ticks = sv
        got_frames.append(dict(world_summary(sv), level=int(level),
                               adopted_at_frame=int(sv.st.adopted), tour=int(sv.st.wp.count)))
        st, per_tick = sv.st, []
        for _ in range(ticks):
            st, m = plancache.step_cached(st, sv.lite, sv.cache, params, S, v_dt=v_dt)
            per_tick.append(m)
        sv = dataclasses.replace(sv, st=st)
        m = stack_metrics(per_tick)
        m["adopted"] = st.adopted.expand(ticks)
        per_frame_metrics.append(m)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    levels = [f["level"] for f in got_frames]
    log(f"# phase 7: serving {len(frames)} frames x {ticks} ticks, ror_method='pallas': levels "
        f"{levels}, launches {launches}")

    compare_serving(ref, sv0, frame_states, got_frames, per_frame_metrics, params, S)
    if sorted(set(levels)) != [0, 2, 3]:
        raise AssertionError(f"levels {levels} do not cover 0, 2 and 3")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    # every world build of the loop: one thinning, one flood of all its passes
    n_worlds = launches["zhang_suen_fixpoint"]
    if (launches["jfa_flood"] != n_worlds
            or launches["jfa_flood.passes"] != n_worlds * len(voronoi._passes(S))):
        raise AssertionError(f"serving: {n_worlds} thinnings against floods {launches}")

    # the last frame again through serve_control_tick, fed the replay's poses
    m_last, m_prev = per_frame_metrics[-1], per_frame_metrics[-2]
    poses = [(m_prev["xy"][-1], m_prev["yaw"][-1])] + [
        (m_last["xy"][t], m_last["yaw"][t]) for t in range(ticks - 1)]
    sv_t, cmds, tick_ms = sv_ticks, [], []
    for xy, yaw in poses:
        (sv_t, cmd), ms = host_ms(lambda: serving.serve_control_tick(sv_t, xy, yaw, params, S))
        cmds.append(cmd)
        tick_ms.append(ms)
    cmds = stack_metrics(cmds)
    for k in ("mod", "status", "target_wp", "cluster_idx", "waiting", "completed", "plan_len",
              "nonfinite", "guards"):
        if not torch.equal(cmds[k], m_last[k]):
            raise AssertionError(f"serve_control_tick command {k} differs from the replay")
    if int(sv_t.st.adopted) != int(m_last["adopted"][-1]):
        raise AssertionError("serve_control_tick adopted another cache row than the replay")

    # latencies, host wall with a closing synchronise (each includes the
    # host synchronisations of the eager path)
    init_reps = [host_ms(lambda: serving.serve_init(frames[0], poly, params, excl, S,
                                                    ror_method="pallas"))[1]
                 for _ in range(SERVE_REPS)]
    cache_reps = [host_ms(lambda: plancache.build_plan_cache(sv0.inc.world, params, S))[1]
                  for _ in range(SERVE_REPS)]
    # frame 0's cache, its 73 rows in one batched call against one row at a
    # time through unbatched calls: bitwise
    looped, looped_ms = host_ms(lambda: looped_cache(sv0.inc.world, params, S))
    assert_caches_bitwise(looped, plancache.build_plan_cache(sv0.inc.world, params, S),
                          "phase 7: BENCH plan cache, batched rows against looped rows")
    reuse_reps = [host_ms(lambda: serving.serve_map_frame(sv, frames[-1], poly, params, excl, S,
                                                          ror_method="pallas"))[1]
                  for _ in range(REPS)]
    frame_ms.setdefault(0, []).extend(reuse_reps)
    mem = torch.cuda.max_memory_allocated() / 2**30
    stats = dict(serve_init_ms=float(np.median(init_reps)), serve_init_first_ms=init_ms,
                 build_plan_cache_ms=float(np.median(cache_reps)),
                 build_plan_cache_looped_ms=looped_ms,
                 serve_map_frame_ms={lv: float(np.median(v)) for lv, v in sorted(frame_ms.items())},
                 serve_map_frame_samples={lv: len(v) for lv, v in sorted(frame_ms.items())},
                 serve_control_tick_ms=float(np.median(tick_ms)),
                 serve_control_tick_max_ms=float(np.max(tick_ms)), peak_allocated_gib=mem)
    log(f"# phase 7: serve_control_tick reproduces the replay's commands over {ticks} ticks; "
        f"median ms (host wall, synchronised): serve_init {stats['serve_init_ms']:.1f} "
        f"(first {init_ms:.1f}), build_plan_cache {stats['build_plan_cache_ms']:.1f} "
        f"(its {plancache.num_rows(S)} rows one at a time: {looped_ms:.1f}, bitwise equal), "
        f"serve_map_frame by level {json.dumps(stats['serve_map_frame_ms'])}, "
        f"serve_control_tick {stats['serve_control_tick_ms']:.2f} (max "
        f"{stats['serve_control_tick_max_ms']:.2f}); peak allocated {mem:.2f} GiB")
    return launches, stats


def cuda_ms_once(fn):
    """(fn()'s result, ms of that one call by CUDA events): for a plain
    version too slow to repeat."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def chain_bound_ms(table_bytes, steps, load_clocks):
    """Least ms of a one-thread chase: ``steps`` dependent steps of one
    load-to-use latency plus three dependent integer operations (xor,
    multiply-add, mask), and ``table_bytes`` into and out of one SM's shared
    memory at its bank rate."""
    return 1e3 * (steps * (load_clocks + 3 * DEP_OP_CLOCKS) / SM_CLOCK_HZ
                  + table_bytes / SM_SMEM_BYTES_PER_S)


def phase_probes(device):
    import contextlib
    import io

    import torch
    from aosx_torch import probes
    from aosx_torch.cuda_build import timed_ms

    ref = json.loads(PROBES_REFERENCE.read_text())
    seed = probes.seed_tensor(device, ref["seed"])

    def sha(tn):
        return hashlib.sha256(tn.cpu().numpy().astype("<i4").tobytes()).hexdigest()

    def check(name, equal, **against_ref):
        bad = {k: v for k, v in against_ref.items() if v != ref[k]}
        if not equal or bad:
            raise AssertionError(f"{name}: kernel == plain {equal}; differs from "
                                 f"tests/torch_reference/probes.json in {bad}")

    def max_err(pairs):
        return float(max((a.double() - b.double()).abs().max() for a, b in pairs))

    # the shared-memory load-to-use latency of P1's u16 and P2's i32 loads,
    # the least of REPS measurements: the latency term of their bounds
    lat16, lat32 = (min(probes.shared_load_clocks(device, wide=wide) for _ in range(REPS))
                    for wide in (False, True))
    log(f"# phase 8: shared-memory load-to-use latency, a dependent chase of "
        f"{probes.LAT_LOADS} loads: u16 {lat16:.3f} clocks, u32 {lat32:.3f} clocks")

    # P1: the table in shared memory (the design chase_rw launches), then the
    # global-memory form; each call behind a busy card
    (c_k, tab_k), ms1 = timed_ms(lambda: probes.chase_rw(seed), device, REPS)
    (c_g, tab_g), ms1g = timed_ms(lambda: probes.chase_rw(seed, shared=False), device, REPS)
    (c_p, tab_p), ms1p = cuda_ms_once(lambda: probes.chase_rw_plain(seed))
    pairs1 = ((c_k, c_p), (tab_k, tab_p), (c_g, c_p), (tab_g, tab_p))
    eq1 = all(torch.equal(a, b) for a, b in pairs1)
    check("P1", eq1, p1_c=int(c_k), p1_table_sha256=sha(tab_k))
    # u16 iota into shared memory, the u16 table out of it
    b1 = chain_bound_ms(2 * 2 * probes.P1_N, probes.P1_STEPS, lat16)
    assert_under_bound("P1 chase_rw", ms1, b1)
    assert_under_bound("P1 chase_rw, global table", ms1g, b1)
    log(f"# phase 8: P1 chase_rw N={probes.P1_N}, {probes.P1_STEPS} steps: c = {int(c_k)}, "
        f"shared-memory u16 table {ms1:.4f} ms ({1e6 * ms1 / probes.P1_STEPS:.2f} ns/step, "
        f"{SM_CLOCK_HZ * 1e-3 * ms1 / probes.P1_STEPS:.1f} clocks at 1.98 GHz), global table "
        f"{ms1g:.4f} ms ({1e6 * ms1g / probes.P1_STEPS:.2f} ns/step); bound {b1:.4f} ms (a "
        f"u16 shared load of {lat16:.3f} clocks + 3 x {DEP_OP_CLOCKS:g} a step): "
        f"{100 * b1 / ms1:.1f} % and {100 * b1 / ms1g:.1f} %; plain {ms1p:.1f} ms; c and "
        f"table bitwise equal {eq1}")

    # P2
    c2, ms2 = timed_ms(lambda: probes.chase_ro(seed), device, REPS)
    c2p, ms2p = cuda_ms_once(lambda: probes.chase_ro_plain(seed))
    eq2 = torch.equal(c2, c2p)
    check("P2", eq2, p2_c=int(c2))
    b2 = chain_bound_ms(4 * probes.P2_N, probes.P2_STEPS, lat32)
    assert_under_bound("P2 chase_ro", ms2, b2)
    log(f"# phase 8: P2 chase_ro {probes.P2_N}-entry shared table, {probes.P2_STEPS} steps: "
        f"c = {int(c2)}, kernel {ms2:.4f} ms ({1e6 * ms2 / probes.P2_STEPS:.2f} ns/step; bound "
        f"{b2:.4f} ms, {100 * b2 / ms2:.1f} %), plain {ms2p:.1f} ms, bitwise equal {eq2}")

    # P3 on the probe's input and on random i32 input, and torch.gather
    # alone for the probe's 64 rounds (the library call)
    def p3(name, x, idx):
        out_k, ms = timed_ms(lambda: probes.gather_rows(x, idx), device, REPS)
        out_p, ms_p = cuda_ms(lambda: probes.gather_rows_plain(x, idx), REPS)
        n_gather = x.numel() * probes.P3_ROUNDS
        # x and idx read once, acc written once; per gathered element an add
        # and a mask (INT32: with t = idx + acc carried, the index add and the
        # accumulate are one add) and one 4-byte word from the banks,
        # conflict-free
        b_ops, _ = bound(3 * 4 * x.numel(), int32_ops=2.0 * n_gather)
        b_banks = 1e3 * 4 * n_gather / SMEM_BYTES_PER_S
        b = max(b_ops, b_banks)
        assert_under_bound(f"P3 gather_rows, {name}", ms, b)
        # diagnostic, not the bound: the wavefronts a warp-wide load takes on
        # these indices (from the plain version's rounds) in the kernel's
        # layout and in the identity layout, and the bank time they force
        wf = probes.gather_wavefronts(x, idx)
        wf_id = probes.gather_wavefronts(x, idx, layout=lambda a: a)
        log(f"# phase 8: P3 gather_rows {name} {tuple(x.shape)} x {probes.P3_ROUNDS} rounds: "
            f"kernel {ms:.4f} ms ({1e6 * ms / n_gather:.5f} ns/element), plain {ms_p:.3f} ms, "
            f"bound {b:.4f} ms ({100 * b / ms:.1f} %; INT32 {b_ops:.4f}, conflict-free banks "
            f"{b_banks:.4f}); wavefronts a warp-load {wf:.4f} in the kernel's layout "
            f"({wf * b_banks:.4f} ms of banks), {wf_id:.4f} in the identity layout "
            f"({wf_id * b_banks:.4f} ms); all {out_k.numel()} outputs bitwise equal "
            f"{torch.equal(out_k, out_p)}")
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"P3 {name}: kernel != plain")
        return out_k, out_p, ms, ms_p, b

    x, idx = probes.gather_rows_inputs(device)
    out_k, out_p, ms3, ms3p, b3 = p3("probe input", x, idx)
    check("P3", True, p3_sum=int(out_k.sum(dtype=torch.int64)), p3_first4=out_k[0, :4].tolist(),
          p3_sha256=sha(out_k))
    xr, idxr = probes.gather_rows_random_inputs(device)
    out_r, out_rp, ms3r, ms3rp, _ = p3("random input", xr, idxr)
    index = ((idx + out_p) & (probes.P3_COLS - 1)).long()

    def gathers():
        for _ in range(probes.P3_ROUNDS):
            torch.gather(x, 1, index)

    _, ms3lib = timed_ms(gathers, device, REPS)
    log(f"# phase 8: P3 library call torch.gather x {probes.P3_ROUNDS} {ms3lib:.4f} ms")

    # the probe entry point, with the counts set to 0 just before it
    wrappers = (probes.chase_rw, probes.chase_ro, probes.gather_rows)
    for w in wrappers:
        w.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        probes.main([])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    for line in text.getvalue().strip().splitlines():
        log(f"# phase 8: probes.main | {line}")
    log(f"# phase 8: launches on the probe entry point {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the probe entry point")
    return dict(
        chase_rw=dict(launches=launches["chase_rw"], max_abs_err=max_err(pairs1), ms=ms1,
                      plain_ms=ms1p, bound_ms=b1, bound_by="operations", library_ms=None,
                      global_ms=ms1g, ns_per_step=1e6 * ms1 / probes.P1_STEPS),
        chase_ro=dict(launches=launches["chase_ro"], max_abs_err=max_err(((c2, c2p),)),
                      ms=ms2, plain_ms=ms2p, bound_ms=b2, bound_by="operations",
                      library_ms=None, ns_per_step=1e6 * ms2 / probes.P2_STEPS),
        gather_rows=dict(launches=launches["gather_rows"],
                         max_abs_err=max_err(((out_k, out_p), (out_r, out_rp))), ms=ms3,
                         plain_ms=ms3p, bound_ms=b3, bound_by="operations", library_ms=ms3lib,
                         random_ms=ms3r, random_plain_ms=ms3rp))


MC_INT_FIELDS = ("completed", "steps_to_complete", "final_status", "waypoints", "guards",
                 "feasible")
MC_FLOAT_FIELDS = ("travel_distance", "final_dist_to_origin")


def phase_monte_carlo(device, total=MC_TOTAL, lanes=MC_BATCH, refill=MC_REFILL,
                      budget=MC_BUDGET, chunk=MC_CHUNK, rerun_ids=MC_RERUN_IDS,
                      sweep_seeds=MC_SWEEP_SEEDS, sweep_batch=MC_SWEEP_BATCH,
                      uncached=MC_UNCACHED, batched_keys=MC_BATCHED_KEYS,
                      batched_steps=MC_BATCHED_STEPS):
    import torch
    from aosx_torch.config import MC_STATICS as S, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.orchards import OrchardSpec, make_orchard_np
    from aosx_torch.parallel import batch, sweep
    from aosx_torch.perceive import ror_cuda, skeleton_cuda
    from aosx_torch import tree
    from aosx_torch.plan import plancache

    ref = json.loads(MC_REFERENCE.read_text())
    spec = OrchardSpec(**ref["spec"])
    params = params_as_f32(AosParams(), device)
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint, ror_cuda.ror_counts)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the first refill group (rollout ids 0 .. refill - 1) built both ways:
    # its worlds one at a time through unbatched calls, then in one batched
    # prepare_world (its kernel launches counted), bitwise equal; then the
    # group's plan caches one world and one row at a time through unbatched
    # calls, and in one batched build_plan_cache: bitwise equal
    clouds0 = [batch.cloud_tensors(make_orchard_np(spec, seed=i), S, device)
               for i in range(refill)]
    group0 = tree.stack(clouds0)
    looped_w, prepare_ms = timed(lambda: batch.looped_worlds(clouds0, params, S, "sorted"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    group, world_group_ms = timed(lambda: batch._world(group0, params, S, "sorted"))
    per_group = read_counts(kernels)
    world_mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    assert_trees_equal(looped_w, group, "phase 9: the first refill group's worlds, batched "
                       "against one at a time")
    del looped_w
    worlds = [tree.lane(group, i) for i in range(refill)]
    looped, looped_ms = timed(lambda: [looped_cache(w, params, S) for w in worlds])
    peak_before = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cache_b, group_ms = timed(lambda: plancache.build_plan_cache(group, params, S))
    group_mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    _, feas_ms = timed(lambda: plancache.tour_feasibility(cache_b, group.waypoints, params, S))
    for i, want in enumerate(looped):
        assert_caches_bitwise(want, tree.lane(cache_b, i),
                              f"phase 9: world {i} of the first refill group")
    begin_looped = (prepare_ms + looped_ms) / refill
    begin_batched = (world_group_ms + group_ms + feas_ms) / refill
    log(f"# phase 9: the first refill group ({refill} MC_STATICS worlds, {S.grid_h}x{S.grid_w}): "
        f"prepare_world one world at a time {prepare_ms:.0f} ms ({prepare_ms / refill:.1f} a "
        f"world), in one batched prepare_world {world_group_ms:.0f} ms "
        f"({world_group_ms / refill:.1f} a world, launches {per_group}, peak allocated "
        f"{world_mem:.3f} GiB), bitwise equal; plan caches one world and one row at a time "
        f"{looped_ms:.0f} ms ({looped_ms / refill:.0f} a world), in one batched "
        f"build_plan_cache over {refill} x {plancache.num_rows(S)} rows {group_ms:.0f} ms "
        f"({group_ms / refill:.1f} a world, peak allocated {group_mem:.3f} GiB), bitwise equal; "
        f"tour_feasibility {feas_ms:.1f} ms; begin a world looped {begin_looped:.0f} ms, "
        f"batched {begin_batched:.1f} ms")
    del looped, group, cache_b, worlds

    # the main path: the sustained harness, counts set to 0 just before it
    started = []

    def clouds(i):
        started.append(i)
        return make_orchard_np(spec, seed=i)

    zero_counts(kernels)
    (res, stats), wall_ms = timed(lambda: batch.sustained_rollouts(
        total, lanes, spec, params, S, budget, chunk_steps=chunk, refill=refill,
        ror_method="sorted", cached=True, clouds=clouds, device=device))
    launches = read_counts(kernels)
    n_groups = stats["begin_calls"]
    lane_ticks = stats["chunk_calls"] * lanes * chunk
    log(f"# phase 9: sustained_rollouts total={total} lanes={lanes} refill={refill} "
        f"budget={budget} chunk={chunk}, cached, ror_method='sorted': "
        f"{stats['rollouts_per_sec']:.3f} rollouts/s over {stats['elapsed_s']:.1f} s from the "
        f"first chunk ({wall_ms / 1e3:.1f} s with the initial fill: "
        f"{1e3 * total / wall_ms:.3f} rollouts/s); begin {n_groups} groups, "
        f"{1e3 * stats['begin_s'] / n_groups:.0f} ms a group, "
        f"{1e3 * stats['begin_s'] / total:.0f} ms a world; chunk {stats['chunk_calls']} calls, "
        f"{1e3 * stats['chunk_s'] / stats['chunk_calls']:.0f} ms a call, "
        f"{1e6 * stats['chunk_s'] / lane_ticks:.2f} us a lane-tick; launches {launches}")
    if sorted(started) != list(range(total)):
        raise AssertionError(f"rollouts started: {sorted(started)}")
    if any(v.shape[0] != total or v.dtype == object for v in res.values()):
        raise AssertionError("a rollout was not recorded")
    if n_groups != lanes // refill + (total - lanes) // refill:
        raise AssertionError(f"begin_calls {n_groups}")
    if on_card:
        assert_group_launches(per_group, 1, S, "the first refill group's world build")
        assert_group_launches(launches, n_groups, S, "the Monte-Carlo path")
        log(f"# phase 9: each of the {n_groups} group builds ({total} worlds) launches K2 once "
            f"(every world's thinning to its fixpoint) and K1 once (every world's flood, "
            f"{launches['jfa_flood.passes'] // n_groups} passes)")

    # every record against the JAX reference
    differ, worst, bad = [], 0.0, []
    for i in range(total):
        want = ref["records"][i]
        got = {k: res[k][i].item() for k in res}
        ints_ok = all(got[k] == want[k] for k in MC_INT_FIELDS)
        err = max(abs(got[k] - want[k]) for k in MC_FLOAT_FIELDS)
        if ints_ok and all(abs(got[k] - want[k]) <= MC_FLOAT_BOUND_M[k] for k in MC_FLOAT_FIELDS):
            worst = max(worst, err)
            continue
        differ.append(i)
        # which plan-cache rows of this world differ from JAX's in length
        _, cache_i, _, _ = batch._begin_cached(
            batch.cloud_tensors(make_orchard_np(spec, seed=i), S, device), params, S, budget,
            "sorted")
        rows = [r for r, (a, b) in enumerate(zip(cache_i.plan_count.tolist(),
                                                 want["cache_count"])) if a != b]
        log(f"# phase 9: rollout {i} differs from the JAX reference in "
            f"{ {k: (got[k], want[k]) for k in got if got[k] != want[k]} } (port, JAX); "
            f"cache rows of another plan length: {rows}; "
            f"{MC_NAMED_RECORDS.get(i, 'cause not named')}")
        if (any(got[k] != want[k] for k in MC_INT_FIELDS if k != "steps_to_complete")
                or abs(got["steps_to_complete"] - want["steps_to_complete"]) > MC_DRIFT_STEPS
                or err > MC_DRIFT_TRAVEL_M):
            bad.append(i)
    comp = res["completed"]
    log(f"# phase 9: {total - len(differ)} of {total} records equal the JAX reference (int/bool "
        f"bitwise, travel and distance to origin within {worst:.3g} m, bounds "
        f"{json.dumps(MC_FLOAT_BOUND_M)}); "
        f"{len(differ)} differ (bound {MC_RECORD_BOUND}): {differ}; "
        f"completed {int(comp.sum())}, infeasible {int((res['feasible'] == 0).sum())}, "
        f"guard-flagged {int((res['guards'] != 0).sum())}, out of budget "
        f"{int((~comp & (res['guards'] == 0)).sum())}")
    if len(differ) > MC_RECORD_BOUND or bad:
        raise AssertionError(f"{len(differ)} records differ from the JAX reference; beyond "
                             f"the drift bounds: {bad}")
    if int(comp.sum()) == 0:
        raise AssertionError("no rollout completed")

    # lanes, neighbours and refill change nothing: the same rollouts again
    # through a harness of their own, as many lanes as rollouts (a width
    # whose chunk XLA:CPU rounds as it rounds 64 lanes: every lane in its
    # vectorized loop, ops.vector_lanes)
    (again, _), again_ms = timed(lambda: batch.sustained_rollouts(
        len(rerun_ids), len(rerun_ids), spec, params, S, budget, chunk_steps=chunk,
        refill=len(rerun_ids), ror_method="sorted", cached=True,
        clouds=lambda j: make_orchard_np(spec, seed=rerun_ids[j]), device=device))
    for j, i in enumerate(rerun_ids):
        bad = [k for k in res if again[k][j].tobytes() != res[k][i].tobytes()]
        if bad:
            raise AssertionError(f"rollout {i} in a harness of {len(rerun_ids)} lanes differs from "
                                 f"its record in {bad}: "
                                 f"{ {k: (again[k][j].item(), res[k][i].item()) for k in bad} }")
    log(f"# phase 9: rollouts {list(rerun_ids)} again through {len(rerun_ids)} lanes of their own "
        f"(no refill) equal their records bitwise; {again_ms / 1e3:.1f} s")

    # a 2 x 2 sweep on the same numpy clouds; configuration 0 is the default
    # parameters
    stacked, configs = sweep.grid_params(device=device, docking_radius=[0.7, 0.4],
                                         heuristic_weight=[3.0, 1.0])
    (sres, sstats), sweep_ms = timed(lambda: sweep.sweep_rollouts(
        stacked, configs, sweep_seeds, spec, S, budget, batch=sweep_batch, chunk_steps=chunk,
        ror_method="sorted", cached=True, clouds=lambda k: make_orchard_np(spec, seed=k),
        device=device))
    table, agg = sweep.summarize_sweep(sres, len(configs), sweep_seeds)
    bad = [k for k in res if table[k][0].tobytes() != res[k][:sweep_seeds].tobytes()]
    if bad:
        raise AssertionError(f"sweep configuration 0 differs from the unswept records in {bad}")
    log(f"# phase 9: sweep {configs} x {sweep_seeds} orchards through {sweep_batch} lanes in "
        f"{sweep_ms / 1e3:.1f} s ({sstats['rollouts_per_sec']:.3f} rollouts/s from the first "
        f"chunk): configuration 0 equals the unswept records bitwise; completion rate "
        f"{agg['completion_rate'].tolist()}, mean travel {np.round(agg['travel_mean'], 2).tolist()}")
    # the uncached harness (lane-aware engine.step chunks) against the cached
    # one on the same clouds and budget, bitwise
    unc_total, unc_lanes, unc_refill, unc_budget = uncached
    unc_clouds = lambda i: make_orchard_np(spec, seed=i)  # noqa: E731
    kw = dict(chunk_steps=chunk, refill=unc_refill, ror_method="sorted", clouds=unc_clouds,
              device=device)
    (cres, cstats), _ = timed(lambda: batch.sustained_rollouts(
        unc_total, unc_lanes, spec, params, S, unc_budget, cached=True, **kw))
    (ures, ustats), unc_ms = timed(lambda: batch.sustained_rollouts(
        unc_total, unc_lanes, spec, params, S, unc_budget, cached=False, classify=True, **kw))
    bad = [k for k in cres if cres[k].tobytes() != ures[k].tobytes()]
    if bad:
        raise AssertionError(f"uncached records differ from the cached ones in {bad}")
    unc_ticks = ustats["chunk_calls"] * unc_lanes * chunk
    log(f"# phase 9: uncached sustained_rollouts total={unc_total} lanes={unc_lanes} "
        f"refill={unc_refill} budget={unc_budget}: records bitwise equal to the cached run's; "
        f"{ustats['rollouts_per_sec']:.3f} rollouts/s ({unc_ms / 1e3:.1f} s with the fill); "
        f"begin {1e3 * ustats['begin_s'] / ustats['begin_calls']:.0f} ms a group; chunk "
        f"{1e3 * ustats['chunk_s'] / ustats['chunk_calls']:.0f} ms a call, "
        f"{1e6 * ustats['chunk_s'] / unc_ticks:.0f} us a lane-tick (cached on the same run: "
        f"{1e6 * cstats['chunk_s'] / (cstats['chunk_calls'] * unc_lanes * chunk):.1f})")

    # batched_rollouts (one begin, one lane-aware episode) against the same
    # keys one at a time
    from aosx_torch import prng

    keys = prng.split(prng.prng_key(0, torch.device("cpu")), batched_keys)
    n_steps = batched_steps
    got, br_ms = timed(lambda: batch.batched_rollouts(keys, spec, params, S, n_steps,
                                                      device=device))
    for i, k in enumerate(keys):
        one = batch.rollout_one(k, spec, params, S, n_steps, device=device)
        bad = [f for f in one if one[f].cpu().numpy().tobytes() != got[f][i].cpu().numpy().tobytes()]
        if bad:
            raise AssertionError(f"batched_rollouts lane {i} differs from its key alone in {bad}")
    log(f"# phase 9: batched_rollouts on {len(keys)} keys x {n_steps} ticks in {br_ms / 1e3:.1f} "
        f"s, every lane bitwise equal to its key's rollout_one")

    mem = (max(peak_before, torch.cuda.max_memory_allocated()) / 2**30 if on_card
           else float("nan"))
    log(f"# phase 9: peak allocated {mem:.2f} GiB")
    return launches, dict(
        rollouts_per_sec=stats["rollouts_per_sec"], rollouts_per_sec_with_fill=1e3 * total / wall_ms,
        elapsed_s=stats["elapsed_s"], begin_calls=n_groups, chunk_calls=stats["chunk_calls"],
        begin_group_ms=1e3 * stats["begin_s"] / n_groups, begin_world_ms=1e3 * stats["begin_s"] / total,
        chunk_call_ms=1e3 * stats["chunk_s"] / stats["chunk_calls"],
        lane_tick_us=1e6 * stats["chunk_s"] / lane_ticks, prepare_world_ms=prepare_ms / refill,
        prepare_world_group_ms=world_group_ms, prepare_world_group_peak_gib=world_mem,
        build_plan_cache_group_ms=group_ms, build_plan_cache_looped_world_ms=looped_ms / refill,
        uncached_rollouts_per_sec=ustats["rollouts_per_sec"],
        uncached_lane_tick_us=1e6 * ustats["chunk_s"] / unc_ticks,
        uncached_begin_group_ms=1e3 * ustats["begin_s"] / ustats["begin_calls"],
        batched_rollouts_s=br_ms / 1e3,
        begin_world_looped_ms=begin_looped, begin_world_batched_ms=begin_batched,
        group_peak_allocated_gib=group_mem, rerun_s=again_ms / 1e3,
        records_differing=len(differ), float_err_m=worst, completed=int(comp.sum()),
        infeasible=int((res["feasible"] == 0).sum()), flagged=int((res["guards"] != 0).sum()),
        sweep_s=sweep_ms / 1e3, peak_allocated_gib=mem, launches_per_group=per_group)


MC_HARNESS_REFERENCE = REFERENCE.with_name("mc_harness_ref.json")


def mc_group_kernels(device, S, spec, keys, name):
    """K1 and K2 on one refill group of population keys as the world build
    runs them: the group's opened grids through K2 and its skeletons' floods
    over the merged seeds through K1, each in one launch, against the plain
    batched versions (and K2's single-world runs), bitwise; ms a group of
    each and its bound. These launches are not the main path's."""
    import torch
    from aosx_torch.config import AosParams, params_as_f32
    from aosx_torch.cuda_build import timed_ms
    from aosx_torch.gvd import jfa_pass_cuda, voronoi
    from aosx_torch.gvd.graph import merge_seeds
    from aosx_torch.orchards import make_orchard
    from aosx_torch.perceive import points, raster, skeleton, skeleton_cuda
    from aosx_torch.perceive.pipeline import perceive

    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    pc, poly = make_orchard(keys, spec, S, device)
    xy, keep, bounds, _ = points.preprocess(pc, poly, params, excl, S, ror_method="sorted")
    opened = skeleton.morph_open(raster.inflate(raster.generate_grid(xy, keep, bounds, S), S))
    occ, hc, wc = opened.occ.contiguous(), opened.h_cells, opened.w_cells
    G, H, W = occ.shape
    stats, k2_launches, k2_err = check_k2_group(name, occ, hc, wc, S.skeleton_max_iters)
    (skel, _), k2_ms = timed_ms(lambda: skeleton_cuda.zhang_suen_fixpoint(
        occ, hc, wc, S.skeleton_max_iters), device, REPS)
    _, k2_plain_ms = cuda_ms(lambda: skeleton_cuda.zhang_suen_fixpoint_plain(
        occ, hc, wc, S.skeleton_max_iters), 2)
    its = [st[0] for st in stats]
    k2_bound, _ = k2_group_bound(skel, its)

    out = perceive(pc, poly, params, excl, S, ror_method="sorted")
    seeds = merge_seeds(out.seeds, params, S)
    grid = out.skeleton
    n = seeds.xy.shape[-2]
    steps = voronoi._passes(S)
    rounding = voronoi.pass_roundings(S, steps, tuple(grid.occ.shape[-2:]))
    owner0, table = voronoi._jfa_init(grid, seeds, S)
    args = (n, grid.origin_x, grid.origin_y, S.resolution)
    ref, k1_plain_ms = cuda_ms(lambda: jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, *args,
                                                                     rounding), 2)
    zero_counts([jfa_pass_cuda.jfa_flood])
    got = jfa_pass_cuda.jfa_flood(owner0.clone(), table, steps, *args, want_positions=True,
                                  rounding=rounding)
    k1_launches = jfa_pass_cuda.jfa_flood.launches
    k1_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    if ((device.type == "cuda" and k1_launches != 1)
            or not all(torch.equal(a, b) for a, b in zip(got, ref))):
        raise AssertionError(f"K1 on the {name} group: {k1_launches} launch(es), owner / ox / oy "
                             f"differ from the plain batched flood (max abs err {k1_err})")
    _, k1_ms = timed_ms(lambda o: jfa_pass_cuda.jfa_flood(o, table, steps, *args,
                                                         rounding=rounding),
                        device, REPS, owner0.clone)
    k1_bound, *_ = k1_group_bound(owner0, table, steps, args, rounding)
    log(f"# phase 9b: the first {name} refill group ({G} worlds, {H}x{W}, population keys): "
        f"K2 {k2_launches} launch, iterations {its}, {k2_ms:.4f} ms a group (plain batched "
        f"{k2_plain_ms:.2f} ms), bound {k2_bound:.5f} ms ({100 * k2_bound / k2_ms:.1f} %); K1 "
        f"{k1_launches} launch, {len(steps)} passes, {k1_ms:.4f} ms a group (plain batched "
        f"{k1_plain_ms:.2f} ms), bound {k1_bound:.5f} ms ({100 * k1_bound / k1_ms:.1f} %); "
        f"both bitwise their plain versions (K1: owner, ox and oy; K2: planes and per-world "
        f"counts, and each world alone)")
    assert_under_bound(f"K2 {name} group", k2_ms, k2_bound)
    assert_under_bound(f"K1 {name} group", k1_ms, k1_bound)
    return dict(k1_ms=k1_ms, k1_plain_ms=k1_plain_ms, k1_bound_ms=k1_bound, k1_err=k1_err,
                k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_bound_ms=k2_bound, k2_err=k2_err,
                k2_iterations=its)


def phase_realism(device, total=MC_TOTAL, lanes=MC_BATCH, refill=MC_REFILL, budget=MC_BUDGET,
                  chunk=MC_CHUNK):
    """Phase 9b: the realism Monte-Carlo (curved rows, 15 % tree dropout,
    MC_REALISM_STATICS) through the harness's normal entry point on
    population keys, every record against aosx's own harness on the same
    keys (mc_harness_ref.json); K1 and K2 on its first refill group and on
    the straight population's, against their plain versions."""
    import torch
    from aosx_torch import prng
    from aosx_torch.config import MC_REALISM_STATICS, MC_STATICS, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.orchards import OrchardSpec
    from aosx_torch.parallel import batch
    from aosx_torch.perceive import ror_cuda, skeleton_cuda

    ref = json.loads(MC_HARNESS_REFERENCE.read_text())
    pops = ref["populations"]
    entry = pops["realism"]["phase9"]
    if ([entry["lanes"], entry["refill"], len(entry["ids"]), ref["steps_budget"],
         ref["chunk_steps"]] != [lanes, refill, total, budget, chunk]
            or entry["ids"] != list(range(total))):
        raise AssertionError("phase 9b: the reference was made at another shape")
    S = MC_REALISM_STATICS
    spec = OrchardSpec(**pops["realism"]["spec"])
    params = params_as_f32(AosParams(), device)
    keys = prng.split(prng.prng_key(ref["population"]["seed"], torch.device("cpu")),
                      ref["population"]["size"])[:total]
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint, ror_cuda.ror_counts)

    groups = {name: mc_group_kernels(device, st, OrchardSpec(**pops[name]["spec"]),
                                     keys[:refill], name)
              for name, st in (("straight", MC_STATICS), ("realism", S))}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the main path, counts set to 0 just before it
    zero_counts(kernels)
    sync()
    t0 = time.perf_counter()
    res, stats = batch.sustained_rollouts(total, lanes, spec, params, S, budget,
                                          chunk_steps=chunk, refill=refill, ror_method="sorted",
                                          cached=True, classify=True, keys=keys, device=device)
    sync()
    wall_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    n_groups = stats["begin_calls"]
    if n_groups != lanes // refill + (total - lanes) // refill:
        raise AssertionError(f"phase 9b: begin_calls {n_groups}")
    if device.type == "cuda":
        assert_group_launches(launches, n_groups, S, "the realism Monte-Carlo path")
    if launches["ror_counts"] != 0:
        raise AssertionError(f"phase 9b: K3 launched on a sorted-ROR path: {launches}")

    differ = {}
    for i, want in enumerate(entry["records"]):
        got = {k: res[k][i].item() for k in res}
        if got.keys() != want.keys() or any(
                np.float32(got[k]).tobytes() != np.float32(want[k]).tobytes()
                if k in MC_FLOAT_FIELDS else got[k] != want[k] for k in want):
            differ[i] = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    comp = res["completed"].astype(bool)
    flagged = res["guards"] != 0
    infeasible = ~comp & ~flagged & (res["feasible"] == 0)
    residual = ~comp & ~flagged & (res["feasible"] == 1)
    lane_ticks = stats["chunk_calls"] * lanes * chunk
    log(f"# phase 9b: sustained_rollouts total={total} lanes={lanes} refill={refill} "
        f"budget={budget} chunk={chunk}, cached, classify, MC_REALISM_STATICS, population keys "
        f"0-{total - 1}: {stats['rollouts_per_sec']:.3f} rollouts/s over "
        f"{stats['elapsed_s']:.1f} s from the first chunk ({wall_s:.1f} s with the initial "
        f"fill); chunk {stats['chunk_calls']} calls, "
        f"{1e3 * stats['chunk_s'] / stats['chunk_calls']:.0f} ms a call, "
        f"{1e6 * stats['chunk_s'] / lane_ticks:.2f} us a lane-tick; begin {n_groups} groups, "
        f"{1e3 * stats['begin_s'] / n_groups:.0f} ms a group; launches {launches}")
    log(f"# phase 9b: completed {int(comp.sum())}, infeasible {int(infeasible.sum())} "
        f"{np.nonzero(infeasible)[0].tolist()}, residual (out of budget, feasible) "
        f"{int(residual.sum())} {np.nonzero(residual)[0].tolist()}, guard-flagged "
        f"{int(flagged.sum())}; completed but infeasible "
        f"{int((comp & (res['feasible'] == 0)).sum())}")
    log(f"# phase 9b: {total - len(differ)} of {total} records bitwise equal to aosx's own harness "
        f"on the same keys (every field, feasible included); differ: {differ}")
    if differ:
        raise AssertionError(f"phase 9b: {len(differ)} realism records differ from the JAX "
                             f"harness's")
    if not comp.any() or not infeasible.any() or not residual.any():
        raise AssertionError("phase 9b: the realism lanes did not part ways (completed, "
                             "infeasible, out of budget)")
    return launches, dict(
        rollouts_per_sec=stats["rollouts_per_sec"], elapsed_s=stats["elapsed_s"], wall_s=wall_s,
        chunk_calls=stats["chunk_calls"],
        chunk_call_ms=1e3 * stats["chunk_s"] / stats["chunk_calls"],
        lane_tick_us=1e6 * stats["chunk_s"] / lane_ticks, begin_calls=n_groups,
        begin_group_ms=1e3 * stats["begin_s"] / n_groups, completed=int(comp.sum()),
        infeasible=int(infeasible.sum()), residual=int(residual.sum()),
        flagged=int(flagged.sum()), records_differing=len(differ), groups=groups)


# ---------------------------------------------------------------------------
# phase 10: the operator's surface
# ---------------------------------------------------------------------------

HOST_REFERENCE = REFERENCE.with_name("host_np_seed0.json")
DASHBOARD_REFERENCE = REFERENCE.with_name("dashboard_np.json")
# scratch files of phase 10 (maps, dashboard outputs), removed at its end
WORK = ROOT / "_archive" / "chip_smoke_phase10"
# The dashboard's reports on the card against the JAX package's on the CPU:
# every key equal, position and travel included (the report rounds them to
# 1 mm and 1 cm), as tests/test_torch_dashboard.py requires on the CPU


def msg_from_arrays(a, prefix, origin, resolution):
    """A graph message dict from its saved arrays (make_host_reference.py)."""
    nodes = a[f"{prefix}nodes"]
    return dict(resolution=resolution, origin_x=origin[0], origin_y=origin[1],
                num_nodes=len(nodes), num_edges=len(a[f"{prefix}edge_lengths"]),
                nodes=[dict(x=float(x), y=float(y), z=0.0) for x, y in nodes],
                **{k: a[f"{prefix}{k}"].reshape(-1).tolist() for k in
                   ("node_labels", "node_cluster_indices", "node_label_clusters",
                    "node_label_types", "node_label_counts", "edges", "edge_lengths",
                    "edge_clearances")})


def phase_host_surface(device, bench_spec):
    """Phase 10 (a), at BENCH_STATICS on the bench orchard: make_orchard,
    the PCD round trip through the native reader, clearances, the ROS
    messages and the next-waypoint service, against the CPU port and the JAX
    package's references (tests/torch_reference/host_np_seed0.json, .npz)."""
    import torch
    from aosx_torch import prng
    from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.gvd.clearance import edge_clearances, obstacle_distance_field
    from aosx_torch.gvd.graph import build_gvd_graph
    from aosx_torch.io import pcd, ros_msgs
    from aosx_torch.native import binding
    from aosx_torch.orchards import make_orchard, make_orchard_np
    from aosx_torch.perceive import perceive, skeleton_cuda
    from aosx_torch.plan.astar import cost_matrix
    from aosx_torch.plan.mission import (build_waypoints, force_next_waypoint,
                                         plan_current_path, trim_distance_plane)
    from aosx_torch.types import MissionState

    ref = json.loads(HOST_REFERENCE.read_text())
    arrays = np.load(HOST_REFERENCE.with_suffix(".npz"))
    stats = {}
    t_phase = time.time()

    # make_orchard on the card, on the CPU, and the JAX package's on the CPU:
    # the same bits (its transcendentals are XLA:CPU's, emulated in f32math)
    t0 = time.time()
    card, card_poly = make_orchard(prng.prng_key(0, device), bench_spec, S)
    cpu, cpu_poly = make_orchard(prng.prng_key(0, "cpu"), bench_spec, S)
    if not all(torch.equal(a.cpu(), b) for a, b in ((card.xyz, cpu.xyz), (card.valid, cpu.valid),
                                                     (card_poly.pts, cpu_poly.pts))):
        raise AssertionError("make_orchard: the card's cloud differs from the CPU port's")
    jo = ref["make_orchard"]
    got = (int(card.valid.sum()),
           hashlib.sha256(card.xyz.cpu().numpy().tobytes()).hexdigest(),
           hashlib.sha256(card.valid.cpu().numpy().tobytes()).hexdigest())
    if got != (jo["valid"], jo["xyz_sha256"], jo["valid_sha256"]):
        raise AssertionError(f"make_orchard differs from the JAX package's: {got} vs {jo}")
    _, stats["make_orchard_ms"] = cuda_ms(
        lambda: make_orchard(prng.prng_key(0, device), bench_spec, S), REPS)
    log(f"# phase 10: make_orchard at BENCH_STATICS ({got[0]} points): the card's cloud == the "
        f"CPU port's == the JAX package's (sha256 of xyz and mask); "
        f"{stats['make_orchard_ms']:.3f} ms (CUDA events, median of {REPS}); "
        f"{time.time() - t0:.1f} s")

    # the bench cloud through a PCD file, read by the native reader and by numpy
    t0 = time.time()
    WORK.mkdir(parents=True, exist_ok=True)
    xyz_np = make_orchard_np(bench_spec, seed=0)[0].astype(np.float32)
    path = str(WORK / "bench.pcd")
    pcd.save_pcd(path, xyz_np)
    calls = binding.load_pcd_xyz.calls
    back = pcd.load_pcd(path)
    if binding.load_pcd_xyz.calls != calls + 1:
        raise AssertionError("load_pcd did not take the native reader")
    def load_numpy(path):
        # the reader load_pcd takes where the native library cannot be built
        available = binding.available
        binding.available = lambda: False
        try:
            return pcd.load_pcd(path)
        finally:
            binding.available = available

    back_np = load_numpy(path)
    if not (np.array_equal(back, xyz_np) and np.array_equal(back_np, xyz_np)):
        raise AssertionError("PCD round trip differs")
    native_ms = float(np.median([host_ms(lambda: pcd.load_pcd(path))[1] for _ in range(REPS)]))
    numpy_ms = float(np.median([host_ms(lambda: load_numpy(path))[1]
                                for _ in range(REPS)]))
    stats.update(pcd_native_ms=native_ms, pcd_numpy_ms=numpy_ms)
    log(f"# phase 10: save_pcd + load_pcd of {len(xyz_np)} points bitwise through the native "
        f"reader ({native_ms:.3f} ms host wall, median of {REPS}) and numpy ({numpy_ms:.3f} "
        f"ms); {time.time() - t0:.1f} s")

    # clearances: the graph with compute_clearances on the card
    t0 = time.time()
    params = params_as_f32(AosParams(), device)
    pc, poly = cloud(S, bench_spec, 0, device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    out = perceive(pc, poly, params, excl, S, ror_method="sorted")
    skel = out.skeleton
    skel_sha = hashlib.sha256(skel.occ.cpu().numpy().tobytes()).hexdigest()
    if skel_sha != ref["skeleton_sha256"]:
        raise AssertionError("bench skeleton differs from the JAX reference")
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint)
    zero_counts(kernels)
    graph = build_gvd_graph(out.seeds, out.rows_sorted, skel, params, S, compute_clearances=True)
    counts = read_counts(kernels)
    if counts["jfa_flood"] != 1 or counts["zhang_suen_fixpoint"] != 0:
        raise AssertionError(f"build_gvd_graph launched {counts}")
    field, stats["distance_field_ms"] = cuda_ms(lambda: obstacle_distance_field(skel, S), REPS)
    skel_cpu = grid_on_cpu(skel)
    field_cpu = obstacle_distance_field(skel_cpu, S)
    if not torch.equal(field.cpu(), field_cpu):
        raise AssertionError("distance field: card differs from the CPU port")
    field_sha = hashlib.sha256(field.cpu().numpy().tobytes()).hexdigest()
    if field_sha != ref["distance_field"]["sha256"]:
        raise AssertionError("distance field differs from the JAX reference")
    args = (graph.nodes.cpu(), graph.edges.cpu(), graph.edge_valid.cpu())
    if not torch.equal(graph.edge_clearances.cpu(),
                       edge_clearances(field_cpu, skel_cpu, *args, S)):
        raise AssertionError("edge clearances: card differs from the CPU port")
    # JAX's clearances, on JAX's graph (its message) and the card's field
    jn, je = arrays["msg_nodes"], arrays["msg_edges"].reshape(-1, 2)
    N, E = S.max_nodes, S.max_edges
    pos = torch.zeros((N, 2), dtype=torch.float32)
    pos[:len(jn)] = torch.from_numpy(jn)
    edges = torch.full((E, 2), -1, dtype=torch.int32)
    edges[:len(je)] = torch.from_numpy(je)
    ev = torch.arange(E) < len(je)
    jc = edge_clearances(field, skel, pos.to(device), edges.to(device), ev.to(device), S)
    differ = int((jc[:len(je)].cpu().numpy() != arrays["msg_edge_clearances"]).sum())
    if differ:
        raise AssertionError(f"clearances of JAX's graph differ from JAX's on {differ} edges")
    stats["clearance_edges"] = int(graph.num_edges)
    log(f"# phase 10: build_gvd_graph(compute_clearances=True) at BENCH_STATICS: 1 flood; "
        f"distance field {stats['distance_field_ms']:.3f} ms (CUDA events, plain PyTorch), "
        f"card == CPU port == JAX's (sha256); the card's {int(graph.num_edges)} clearances == "
        f"the CPU port's; on JAX's graph, JAX's {len(je)} clearances bitwise; "
        f"{time.time() - t0:.1f} s")

    # the ROS messages
    t0 = time.time()
    origin = ref["graph"]["origin"]
    msg = ros_msgs.gvd_graph_to_msg(graph, S.resolution, float(skel.origin_x),
                                    float(skel.origin_y))
    if [msg["origin_x"], msg["origin_y"]] != origin or \
            (msg["num_nodes"], msg["num_edges"]) != (ref["graph"]["nodes"], ref["graph"]["edges"]):
        raise AssertionError("graph message header differs from JAX's")
    jmsg = msg_from_arrays(arrays, "msg_", origin, S.resolution)
    differ = {k: int(np.sum(np.asarray(msg[k]) != np.asarray(jmsg[k]))) for k in
              ("node_labels", "node_cluster_indices", "node_label_clusters", "node_label_types",
               "node_label_counts", "edges")}
    same_nodes = np.array_equal(arrays["msg_nodes"], np.array(
        [[p["x"], p["y"]] for p in msg["nodes"]], np.float32).reshape(-1, 2))
    len_ulp = ulp_distance(arrays["msg_edge_lengths"], np.asarray(msg["edge_lengths"], np.float32))
    if any(differ.values()) or not same_nodes or len_ulp > ULP_BOUND:
        raise AssertionError(f"graph message differs from JAX's: {differ}, nodes equal "
                             f"{same_nodes}, lengths {len_ulp} ulp")
    omsg = ros_msgs.occupancy_grid_to_msg(out.occupancy, S.resolution)
    osha = hashlib.sha256(np.asarray(omsg["data"], np.int8).tobytes()).hexdigest()
    if (omsg["info"]["width"], omsg["info"]["height"], osha) != (
            ref["occupancy_msg"]["width"], ref["occupancy_msg"]["height"],
            ref["occupancy_msg"]["data_sha256"]):
        raise AssertionError("occupancy message differs from JAX's")
    back = ros_msgs.msg_to_gvd_graph(msg, S, device)
    e = int(graph.num_edges)
    same = all(torch.equal(getattr(back, f), getattr(graph, f)) for f in
               ("nodes", "node_valid", "node_labels", "label_node", "edges", "edge_valid",
                "num_nodes", "num_edges"))
    if not (same and torch.equal(back.edge_lengths[:e], graph.edge_lengths[:e])):
        raise AssertionError("msg_to_gvd_graph does not give back the graph")
    log(f"# phase 10: gvd_graph_to_msg ({msg['num_nodes']} nodes, {e} edges) == JAX's (ints "
        f"bitwise, lengths within {len_ulp:g} ulp), occupancy_grid_to_msg == JAX's (sha256), "
        f"msg_to_gvd_graph gives the graph back; {time.time() - t0:.1f} s")

    # the next-waypoint service on JAX's graph, from its message
    t0 = time.time()
    jgraph = ros_msgs.msg_to_gvd_graph(jmsg, S, device)
    costmat, wp = cost_matrix(jgraph, S), build_waypoints(jgraph, params, S)
    trim = trim_distance_plane(skel, S)
    st = dataclasses.replace(MissionState.initial(device),
                             initial_reached=torch.tensor(True, device=device))
    worst = 0.0
    for i, want in enumerate(ref["service"]["calls"]):
        here = torch.tensor(want["here"], dtype=torch.float32, device=device)
        st, wp, from_here = force_next_waypoint(st, wp, params)
        path, ok = plan_current_path(st, wp, jgraph, costmat, skel, params, S, trim_plane=trim,
                                     use_current_position=here)
        got = dict(here=want["here"], from_here=bool(from_here), ok=bool(ok),
                   path_count=int(path.count), wp_count=int(wp.count),
                   mission={f.name: int(getattr(st, f.name)) for f in dataclasses.fields(st)})
        if got != want:
            raise AssertionError(f"service call {i}: {got} != JAX's {want}")
        n = got["path_count"]
        for k, a in (("xy", path.xy), ("yaw", path.yaw)):
            d = ulp_distance(arrays[f"path{i}_{k}"][:n], a.cpu().numpy()[:n])
            worst = max(worst, d)
            if d > ULP_BOUND:
                raise AssertionError(f"service call {i}: path {k} {d} ulp from JAX's")
        pmsg = ros_msgs.path_to_msg(path)
        if len(pmsg["poses"]) != n:
            raise AssertionError("path message length")
    log(f"# phase 10: force_next_waypoint + plan_current_path(use_current_position=) x "
        f"{len(ref['service']['calls'])} on JAX's graph: states, flags and counts == JAX's, paths "
        f"within {worst:g} ulp <= {ULP_BOUND}; {time.time() - t0:.1f} s")
    stats["host_surface_s"] = time.time() - t_phase
    return stats


def grid_on_cpu(grid):
    """A GridWorld's copy on the CPU."""
    from aosx_torch.types import GridWorld

    return GridWorld(**{f: getattr(grid, f).cpu() for f in
                        ("occ", "origin_x", "origin_y", "h_cells", "w_cells")})


def phase_dashboard(device):
    """Phase 10 (b): the dashboard at TEST_STATICS on the card, as an operator
    runs it, against the JAX package's reports
    (tests/torch_reference/dashboard_np.json)."""
    import shutil

    import torch
    from aosx_torch import dashboard
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.io.checkpoint import load_state
    from aosx_torch.io.pcd import save_pcd
    from aosx_torch.orchards import OrchardSpec, make_orchard_np
    from aosx_torch.perceive import skeleton_cuda
    from aosx_torch.tree import leaves
    from torch_reference.make_dashboard_reference import RUNS, expand, write_maps

    ref = json.loads(DASHBOARD_REFERENCE.read_text())["runs"]
    WORK.mkdir(parents=True, exist_ok=True)
    paths = write_maps(WORK, make_orchard_np, OrchardSpec, save_pcd)
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint)
    walls, reports = {}, {}

    def check(name, report):
        want = ref[name]["report"]
        if report != want:
            raise AssertionError(f"dashboard {name}: {report} != JAX's {want}")
        reports[name] = report

    # 1. the operator's own command, in a process of its own
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "aosx_torch.dashboard",
                        *expand(RUNS["orchard_seed1_300"], paths), "--out",
                        str(WORK / "orchard")], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"python -m aosx_torch.dashboard failed:\n{r.stderr[-4000:]}")
    check("orchard_seed1_300", json.JSONDecoder().raw_decode(r.stdout[r.stdout.index("{"):])[0])
    if "render skipped: matplotlib is not installed" not in r.stdout and \
            not (WORK / "orchard" / "episode.png").exists():
        raise AssertionError("dashboard wrote no figure and did not say it skipped it")
    walls["orchard_seed1_300"] = time.time() - t0

    # 2-3. in process: the PCD map, then the growing map through both
    # serving loops, counting the kernels' launches
    for name in ("pcd_300", "seq_cached_2400", "seq_serve_2400"):
        t0 = time.time()
        zero_counts(kernels)
        out = WORK / name
        report, final = dashboard.main([*expand(RUNS[name], paths), "--out", str(out)])
        torch.cuda.synchronize()
        walls[name] = time.time() - t0
        counts = read_counts(kernels)
        levels = report.get("incremental_levels")
        if levels is None:   # one world and its owner plane for the figure
            want = {"zhang_suen_fixpoint": 1, "jfa_flood": 2}
        else:                # the first frame's world, then each frame's rebuilds
            want = {"zhang_suen_fixpoint": 1 + sum(v >= 1 for v in levels),
                    "jfa_flood": 1 + sum(v >= 2 for v in levels)}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"dashboard {name}: launches {counts}, worlds built want {want}")
        check(name, report)
        back = load_state(str(out / "episode_state"), final)
        if not all(torch.equal(a, b) for a, b in zip(leaves(final), leaves(back))):
            raise AssertionError(f"dashboard {name}: episode_state.npz does not load back")
        log(f"# phase 10: dashboard {name}: {json.dumps(reports[name])}; launches "
            f"{ {k: counts[k] for k in want} }; {walls[name]:.1f} s host wall")
    a, b = reports["seq_cached_2400"], reports["seq_serve_2400"]
    if not (a["status"] == b["status"] == "Exploration Complete"
            and (a["exploration_completed"], a["travel_distance"])
            == (b["exploration_completed"], b["travel_distance"])):
        raise AssertionError(f"--cached and --serve disagree: {a} vs {b}")
    log(f"# phase 10: python -m aosx_torch.dashboard --steps 300 --seed 1: "
        f"{json.dumps(reports['orchard_seed1_300'])}; {walls['orchard_seed1_300']:.1f} s "
        f"host wall (a process of its own); every report == JAX's, key for key")
    shutil.rmtree(WORK)
    return {f"dashboard_{k}_s": v for k, v in walls.items()}


# ---------------------------------------------------------------------------
# phase 11: row-sharded stencils and meshes
# ---------------------------------------------------------------------------

MESH_BANDS = 4
MESH_TOTAL, MESH_LANES, MESH_REFILL, MESH_BUDGET, MESH_CHUNK = 8, 4, 2, 300, 150


def assert_trees_equal(ref, got, what):
    """Every leaf bitwise equal (dtype, shape and bytes)."""
    r, g = tree_leaves(ref), tree_leaves(got)
    if r.keys() != g.keys():
        raise AssertionError(f"{what}: leaves {sorted(r.keys() ^ g.keys())}")
    bad = [k for k, a in r.items()
           if a.dtype != g[k].dtype or a.shape != g[k].shape or a.tobytes() != g[k].tobytes()]
    if bad:
        raise AssertionError(f"{what}: leaves differ: {bad[:12]}")
    return len(r)


def mesh_bench(device, bench_spec, devices, name):
    """(a) for one mesh: the banded world and flood at BENCH_STATICS against
    the single-device ones; host ms of each stage. Returns its numbers. The
    banded flood rounds every pass as aosx's jump_flood_sharded, the XLA
    lowering, so the single-device path runs with jfa_pass_pallas off, the
    rounding it then has."""
    import torch
    from aosx_torch import engine
    from aosx_torch.config import BENCH_STATICS, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.gvd.graph import merge_seeds
    from aosx_torch.gvd.voronoi import jump_flood
    from aosx_torch.parallel.spatial import (Mesh, inflate_sharded, jump_flood_sharded,
                                             skeletonize_sharded)
    from aosx_torch.perceive import points, raster, ror_cuda, skeleton, skeleton_cuda

    S = dataclasses.replace(BENCH_STATICS, jfa_pass_pallas=False)
    kernels = (jfa_pass_cuda.jfa_flood, skeleton_cuda.zhang_suen_fixpoint, ror_cuda.ror_counts)
    mesh = Mesh(devices, ("space",))
    pc, poly = cloud(S, bench_spec, 0, device)
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    # once untimed: the first call after the kernels load pays their set-up
    engine.prepare_world_full(pc, poly, params, excl, S, ror_method="sorted")
    zero_counts(kernels)
    (world, out, _), single_ms = host_ms(lambda: engine.prepare_world_full(
        pc, poly, params, excl, S, ror_method="sorted"))
    single = read_counts(kernels)
    assert_group_launches(single, 1, S, f"phase 11 {name}: the single-device world")
    # the banded path, counts set to 0 just before it and read just after
    zero_counts(kernels)
    (world_m, out_m, _), mesh_ms = host_ms(lambda: engine.prepare_world_full(
        pc, poly, params, excl, S, ror_method="sorted", stencil_mesh=mesh))
    banded = read_counts(kernels)
    if banded["jfa_flood"] or banded["zhang_suen_fixpoint"] or banded["ror_counts"]:
        raise AssertionError(f"phase 11 {name}: the banded world launched {banded}")
    leaves = assert_trees_equal((world, out), (world_m, out_m),
                                f"phase 11 {name}: prepare_world_full(stencil_mesh=)")

    # stage by stage: host ms of the banded stage beside the single-device one
    xy, keep, bounds, _ = points.preprocess(pc, poly, params, excl, S, ror_method="sorted")
    grid = raster.generate_grid(xy, keep, bounds, S)
    inflated = raster.inflate(grid, S)
    merged = merge_seeds(out.seeds, params, S)
    pairs = {
        "inflate": (lambda: raster.inflate(grid, S).occ,
                    lambda: inflate_sharded(grid, S, mesh).occ),
        "skeletonize": (lambda: skeleton.skeletonize(inflated, S).occ,
                        lambda: skeletonize_sharded(inflated, S, mesh).occ),
        "jump_flood": (lambda: jump_flood(out.skeleton, merged, S),
                       lambda: jump_flood_sharded(out.skeleton, merged, S, mesh)),
    }
    times = {}
    for stage, (one, banded_fn) in pairs.items():
        want, t_one = host_ms(one)
        got, t_band = host_ms(banded_fn)
        if not torch.equal(want.to(got.device), got):
            raise AssertionError(f"phase 11 {name}: {stage} on bands differs from the single "
                                 f"device in {int((want.to(got.device) != got).sum())} cells")
        times[stage] = (t_one, t_band)
    log(f"# phase 11 (a) {name}: BENCH_STATICS {S.grid_h}x{S.grid_w} over "
        f"{[str(d) for d in mesh.devices]}: prepare_world_full(stencil_mesh=) == single device "
        f"({leaves} leaves bitwise); host ms single / banded: world {single_ms:.1f} / "
        f"{mesh_ms:.1f}, " + ", ".join(f"{k} {a:.1f} / {b:.1f}" for k, (a, b) in times.items())
        + f"; launches single {single}, banded {banded}")
    out_stats = {f"{name}_world_ms": [single_ms, mesh_ms]}
    out_stats.update({f"{name}_{k}_ms": list(v) for k, v in times.items()})
    return out_stats


def phase_mesh(device, bench_spec):
    import torch
    from aosx_torch import engine, serving
    from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
    from aosx_torch.oracle import perceive as op
    from aosx_torch.orchards import OrchardSpec, make_orchard_np
    from aosx_torch.parallel import batch
    from aosx_torch.parallel.spatial import Mesh
    from aosx_torch.perceive import points, raster, skeleton

    # (a) BENCH_STATICS, 4 bands on the card, and over distinct cards if any
    stats = mesh_bench(device, bench_spec, (device,) * MESH_BANDS, "one_card")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = max(k for k in (2, 4, 5, 8) if k <= n_cards and 2000 % k == 0)
        stats.update(mesh_bench(device, bench_spec,
                                tuple(torch.device("cuda", i) for i in range(n)), "cards"))

    # (b) TEST_STATICS: serving with a 2-band mesh
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    spec = OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0))
    xyz, poly_np = make_orchard_np(spec, seed=5)
    xyz = xyz[np.random.default_rng(0).permutation(len(xyz))].astype(np.float32)
    frames = []
    for frac in (0.55, 0.8, 1.0):
        n = int(len(xyz) * frac)
        frames.append(batch.cloud_tensors((xyz[:n], poly_np), S, device)[0])
    poly = batch.cloud_tensors((xyz[:1], poly_np), S, device)[1]
    mesh2 = Mesh((device,) * 2, ("space",))
    t0 = time.perf_counter()
    sv = serving.serve_init(frames[0], poly, params, excl, S)
    sv_m = serving.serve_init(frames[0], poly, params, excl, S, stencil_mesh=mesh2)
    assert_trees_equal(sv, sv_m, "phase 11: serve_init(stencil_mesh=)")
    levels = []
    for f, pc in enumerate(frames[1:], 1):
        sv, lv = serving.serve_map_frame(sv, pc, poly, params, excl, S)
        sv_m, lv_m = serving.serve_map_frame(sv_m, pc, poly, params, excl, S, stencil_mesh=mesh2)
        if int(lv) != int(lv_m):
            raise AssertionError(f"phase 11: frame {f} level {int(lv_m)} with the mesh, "
                                 f"{int(lv)} without")
        assert_trees_equal(sv, sv_m, f"phase 11: serve_map_frame {f} (stencil_mesh=)")
        levels.append(int(lv))
    serve_s = time.perf_counter() - t0
    log(f"# phase 11 (b): TEST_STATICS serve_init + {len(levels)} map frames (levels {levels}) "
        f"with a 2-band mesh == without, every state leaf bitwise ({serve_s:.1f} s for both)")

    # sustained rollouts with the lanes over a 2-device mesh, default keys
    kw = dict(chunk_steps=MESH_CHUNK, refill=MESH_REFILL, seed=0, ror_method="sorted",
              cached=True, device=device)
    t0 = time.perf_counter()
    want, wstats = batch.sustained_rollouts(MESH_TOTAL, MESH_LANES, spec, params, S,
                                            MESH_BUDGET, **kw)
    got, gstats = batch.sustained_rollouts(MESH_TOTAL, MESH_LANES, spec, params, S,
                                           MESH_BUDGET, mesh=Mesh((device,) * 2, ("data",)),
                                           **kw)
    assert_trees_equal(want, got, "phase 11: sustained_rollouts(mesh=)")
    if (wstats["chunk_calls"], wstats["begin_calls"]) != (gstats["chunk_calls"],
                                                          gstats["begin_calls"]):
        raise AssertionError(f"phase 11: harness calls {gstats} vs {wstats}")
    mc_s = time.perf_counter() - t0
    log(f"# phase 11 (b): sustained_rollouts of {MESH_TOTAL} rollouts (seed 0 keys, "
        f"make_orchard on the card) through {MESH_LANES} lanes over a 2-device mesh == "
        f"mesh=None, per lane bitwise; completed {int(got['completed'].sum())}; "
        f"{mc_s:.1f} s for both")

    # the card pipeline's grids against the port's NumPy oracle
    xyz_o, poly_o = make_orchard_np(OrchardSpec(n_rows=3, row_len=12.0), seed=3)
    xyz_o, poly_o = xyz_o.astype(np.float32), poly_o.astype(np.float32)
    x64, p64 = xyz_o.astype(np.float64), poly_o.astype(np.float64)
    ores = op.perceive(x64, p64)
    keep = op.radius_outlier_removal(x64)
    pts = op.preprocess_points(x64[keep], p64, (-0.4, 0.5), (-5.0, 72.0, -10.0, 20.0),
                               np.zeros((0, 3)))
    raw_o = op.generate_occupancy_grid(pts, op.active_bounds(p64, None), S.resolution)
    infl_o = op.apply_inflation(raw_o, 0.8)
    pc, poly = batch.cloud_tensors((xyz_o, poly_o), S, device)
    xy, keep_t, bounds, _ = points.preprocess(pc, poly, params, excl, S)
    grid = raster.generate_grid(xy, keep_t, bounds, S)
    inflated = raster.inflate(grid, S)
    planes = {"raw": (grid, raw_o), "inflated": (inflated, infl_o),
              "occupancy": (raster.mark_borders(inflated), ores.occupancy),
              "skeleton": (skeleton.skeletonize(inflated, S), ores.skeleton)}
    for name, (g, o) in planes.items():
        live = g.occ[:int(g.h_cells), :int(g.w_cells)].cpu().numpy()
        if live.shape != o.data.shape or not (live == (o.data == 100)).all():
            raise AssertionError(f"phase 11: the card's {name} grid differs from the oracle's")
    try:
        import cv2  # noqa: F401
        from aosx_torch.oracle import gvd as og
        ref = og.gvd_graph(ores.seeds, ores.skeleton, ores.rows_sorted)
        world = engine.prepare_world(pc, poly, params, excl, S, ror_method="exact")
        nodes = world.graph.nodes[:int(world.graph.num_nodes)].cpu().numpy()
        d = np.linalg.norm(nodes[None] - np.asarray(ref.nodes)[:, None], axis=2).min(1)
        misses = int((d > 3 * S.resolution).sum())
        if misses > max(1, int(0.02 * len(ref.nodes))):
            raise AssertionError(f"phase 11: {misses} Subdiv2D nodes without a port node")
        subdiv = f"the Subdiv2D graph's {len(ref.nodes)} nodes covered but {misses}"
    except ImportError:
        subdiv = "no OpenCV here, so no Subdiv2D graph (morph_open took its NumPy branch)"
    log(f"# phase 11 (b): the card's raw, inflated, occupancy and skeleton grids == the port's "
        f"oracle at {S.grid_h}x{S.grid_w} (live {int(grid.h_cells)}x{int(grid.w_cells)}); "
        f"{subdiv}")
    stats.update(serve_mesh_s=serve_s, sustained_mesh_s=mc_s)
    return stats


def main():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs "
                         "a CUDA card and has no CPU fallback")
    from aosx_torch.orchards import OrchardSpec

    device = torch.device("cuda", 0)
    bench_spec = OrchardSpec(**json.loads(REFERENCE.read_text())["spec"])
    started = time.time()

    def phase(n, fn, *args):
        # the script is mostly host-bound: each phase's wall time, so that a
        # slow run shows where it was slow
        t0 = time.time()
        out = fn(*args)
        log(f"# phase {n}: took {time.time() - t0:.1f} s of host wall "
            f"({time.time() - started:.1f} s since the start)")
        return out

    card = phase_environment()
    phase(1, phase_build)
    k1 = phase(2, phase_k1, device, card)
    k2 = phase(3, phase_k2, device, bench_spec)
    phase(4, phase_xla_f32, device)
    phase(4, phase_test_slice, device)
    phase(4, phase_compact_cells, device)
    launches, stages = phase(5, phase_bench_slice, device, bench_spec)
    k3 = phase(6, phase_k3, device, bench_spec)
    serve_launches, serve_stats = phase(7, phase_serving, device)
    probe_rows = phase(8, phase_probes, device)
    mc_launches, mc_stats = phase(9, phase_monte_carlo, device)
    realism_launches, realism_stats = phase("9b", phase_realism, device)
    host_stats = phase(10, phase_host_surface, device, bench_spec)
    host_stats.update(phase(10, phase_dashboard, device))
    mesh_stats = phase(11, phase_mesh, device, bench_spec)

    def row(name, source, replaces, k):
        # launches: on the serving path (phase 7); launches_stage_full: on
        # stage_full (phase 5); launches_mc: on the Monte-Carlo path (phase
        # 9); launches_mc_realism: on the realism Monte-Carlo path (phase
        # 9b). No single PyTorch call computes any of the three functions,
        # hence library_ms null
        # K1: ms, plain_ms and bound_ms are a pass's share of a flood
        # (launches: whole floods; the passes they ran beside them); K2: an
        # iteration's share of a thinning (launches: whole thinnings); both
        # at BENCH_STATICS, with MC_STATICS under "mc"
        core = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        extra = {key: v for key, v in k.items() if key not in core}
        for path, counts in (("", serve_launches), ("_stage_full", launches),
                             ("_mc", mc_launches), ("_mc_realism", realism_launches)):
            if f"{name}.passes" in counts:
                extra[f"passes{path}"] = counts[f"{name}.passes"]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=serve_launches[name], launches_stage_full=launches.get(name, 0),
                    launches_mc=mc_launches[name],
                    launches_mc_realism=realism_launches[name],
                    max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None, **extra)

    def probe_row(name, line, k):
        # launches: on the probe entry point (phase 8). P1 and P2 are bound by
        # a chain of dependent operations at their latency, not by a rate
        return dict(name=name, route="cuda", source="aosx_torch/csrc/probe_prims.cu",
                    replaces=f"benchmarks/probe_pallas_prims.py:{line}", **k)

    kernels = [
        row("jfa_flood", "aosx_torch/csrc/jfa_pass.cu", "aosx/gvd/jfa_pass_pallas.py:189", k1),
        row("zhang_suen_fixpoint", "aosx_torch/csrc/zhang_suen.cu",
            "aosx/perceive/skeleton_pallas.py:146", k2),
        row("ror_counts", "aosx_torch/csrc/ror_counts.cu", "aosx/perceive/ror_pallas.py:51", k3),
        probe_row("chase_rw", 57, probe_rows["chase_rw"]),
        probe_row("chase_ro", 90, probe_rows["chase_ro"]),
        probe_row("gather_rows", 117, probe_rows["gather_rows"]),
    ]
    # K1's and K2's time on a refill group of each Monte-Carlo population
    # (phase 9b), a group's flood or thinning, beside its plain version and
    # bound
    for krow, key in ((kernels[0], "k1"), (kernels[1], "k2")):
        for pop, g in realism_stats["groups"].items():
            krow.update({f"group_{pop}_ms": g[f"{key}_ms"],
                         f"group_{pop}_plain_ms": g[f"{key}_plain_ms"],
                         f"group_{pop}_bound_ms": g[f"{key}_bound_ms"]})
    log(f"# stages: {json.dumps(stages)}")
    log(f"# serving: {json.dumps(serve_stats)}")
    log(f"# monte carlo: {json.dumps(mc_stats)}")
    log(f"# monte carlo, realism: {json.dumps(realism_stats)}")
    log(f"# operator's surface: {json.dumps(host_stats)}")
    log(f"# meshes: {json.dumps(mesh_stats)}")
    log(f"# K3 uniform cloud: kernel {k3['uniform_ms']:.3f} ms, plain {k3['uniform_plain_ms']:.3f} ms")
    # the card's name and power limit again, beside the numbers
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
