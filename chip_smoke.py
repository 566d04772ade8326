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
           and P1-P3 (probe_prims) with nvcc, one process each, all started
           together
  phase 2  K1: a full jump flood at 2000 x 2048, S = 4096, through the
           kernel and through the plain PyTorch pass; bitwise equal
  phase 3  K2: Zhang-Suen to the fixpoint on the bench orchard's inflated
           grid, through the kernel and the plain iteration; bitwise equal
  phase 4  the slice at TEST_STATICS (stage_full + 20 ticks), CUDA against
           the port on the CPU
  phase 5  stage_full at BENCH_STATICS on CUDA: the kernels' launch counts,
           guard bits, and the JAX package's full-size reference summary
           (tests/torch_reference/bench_np_seed0.json); per-stage times
  phase 6  K3: all-pairs ROR counts of 131,072 points (the bench orchard,
           parked as ror_counts parks it, and a uniform cloud at its
           density) through the kernel and the plain version; bitwise equal
  phase 7  the serving loop at BENCH_STATICS with ror_method="pallas" over
           seven map frames (levels 0, 2, 2, 2, 2, 0, 3), 20 ticks each, then
           serve_control_tick fed the replay's poses: held against the JAX
           package's summary (tests/torch_reference/serving_np_seed0.json),
           frame 0's raw A* paths bitwise, each plan-cache length that
           differs from JAX's excused only by an f32 regression split that
           is not the exact (f64) one; launches of K1, K2 and K3, and the
           serving latencies
  phase 8  the probes P1 (scalar read+write chase), P2 (scalar read-only
           chase) and P3 (row gather) through the kernels and their plain
           versions, bitwise equal, and against the constants of the TPU
           probe bodies (tests/torch_reference/probes.json); ns a step and
           a gathered element, torch.gather's time for P3, the bounds; then
           the probe entry point (python3 -m aosx_torch.probes) for the
           launch counts
  phase 9  Monte-Carlo at MC_STATICS: 128 rollouts of 1,200 ticks through 64
           lanes with refill groups of 32 (plan-cached), each record held
           against the JAX package's (tests/torch_reference/mc_np_seed0.json);
           8 of them again alone, bitwise equal to their lane's record; a
           2 x 2 parameter sweep whose first configuration equals the unswept
           records; launches of K1 and K2 per world build; rollouts/s

Every phase raises on failure, so the exit code is not 0 and no result is
printed. There is no CPU fallback: without a CUDA device the run fails.
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches, its error against the plain version, its
time, the plain version's, and the least time the card could take.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import hashlib
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
# The JAX reference's XLA:CPU build contracts the flood's cell coordinate
# and squared distance into fused multiply-adds; K1 and its plain version
# round each operation (and agree bitwise). Near-ties then resolve
# differently, and a flip can change a later pass's propagation: 5 of the
# 4,096,000 owner cells differ on the bench orchard, measured against the
# port on the CPU (the JAX package's own Pallas-interpret and dynamic-shift
# lowerings differ in 12). Node, edge and waypoint counts agree exactly.
OWNER_CELL_BOUND = 32
TEST_TICKS = 20
TEST_V_DT = 0.5
REPS = 5
# K3 runs the fused multiply-add chains XLA:CPU runs for the JAX reference
# (aosx_torch/perceive/ror_cuda.py), so the frame-0 counts should agree
# exactly; a contraction that XLA chose differently in some context would
# flip pairs whose d2 lies within rounding of r^2: at most this many valid
# points of the bench cloud may count differently
ROR_POINT_BOUND = 16
# The tick yaws of a frame can sit near 0 while their differences come from
# positions (1 ulp of y ~ 6 m, 4.8e-7 m, over a look-ahead of 0.5-1 m), so
# the 4-ulp bound holds yaw in ulp of its range's top, pi: 9.5e-7 rad
YAW_BOUND_RAD = ULP_BOUND * float(np.spacing(np.float32(np.pi)))
SERVE_REPS = 3
PROBES_REFERENCE = REFERENCE.with_name("probes.json")
MC_REFERENCE = REFERENCE.with_name("mc_np_seed0.json")
MC_TOTAL, MC_BATCH, MC_REFILL, MC_BUDGET, MC_CHUNK = 128, 64, 32, 1200, 150
MC_RERUN_IDS = (0, 1, 2, 3, 124, 125, 126, 127)
MC_SWEEP_SEEDS, MC_SWEEP_BATCH = 8, 16
# A rollout's travel is a sequential f32 sum of up to 1,200 segments of about
# 0.12 m, some 100 m in all (ulp 7.6e-6 m), and a lane retires on its way
# back, 20 m from the origin. XLA:CPU contracts a segment's x*x + y*y into a
# fused multiply-add where the port rounds each operation, and the pose
# carries the 4-ulp plan-point bound of the CPU parity tests, so the sums
# drift apart by ulps of the total: the bound on both floats is 1e-3 m, what
# the JAX package's own tests allow between its chunked and one-shot sums
# (tests/test_parallel.py). Measured: 5.7e-4 m at most on the records that
# keep it (the port on the CPU; the card's figure is in PERF.md).
MC_FLOAT_BOUND_M = 1e-3
# Records beyond that bound. The follower steers at the plan point ten past
# the nearest one, an argmin over points 0.05 m apart, so a 1-ulp difference
# in a plan point or the pose can move the look-ahead by a point and the
# travelled path by millimetres to centimetres; a plan-cache row whose
# linearize split or A* tie differs (ROADMAP section 3) moves it more. Each
# such record is printed with both sides and the cache rows whose plan
# lengths differ from JAX's. Measured: 15 of 128 (the port on the CPU; the
# card's figure is in PERF.md), one of them with steps_to_complete 5 ticks
# apart, the largest travel difference 0.29 m.
MC_RECORD_BOUND = 32
# ... and even those agree in every other int and bool field, within these
MC_DRIFT_TRAVEL_M = 1.0
MC_DRIFT_STEPS = 20

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
SMEM_BYTES_PER_S = 32 * 4 * 132 * SM_CLOCK_HZ
# load-to-use latencies in SM clocks, assumed from Luo et al., "Benchmarking
# and Dissecting the Nvidia Hopper GPU Architecture via Microbenchmarking"
# (2024), H100: L1 hit 40.7, shared memory 29.0 (L2 hit 263, for scale); a
# dependent integer operation (multiply-add, logic) issues after 4 clocks
L1_HIT_CLOCKS = 40.7
SMEM_CLOCKS = 29.0
INT_DEP_CLOCKS = 4.0


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


def assert_trees_match(ref, got, what):
    """int/bool leaves bitwise, f32 leaves within ULP_BOUND."""
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

    r = dict(leaves(to_numpy(ref)))
    g = dict(leaves(to_numpy(got)))
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


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from aosx_torch import cuda_build

    names = ("jfa_pass", "zhang_suen", "ror_counts", "probe_prims")

    def one(name):
        t0 = time.time()
        return cuda_build.build(name), time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(one, names)))
    for name, (so, seconds) in built.items():
        cuda_build.load(name)
        report = so.with_suffix(".log")
        regs = [ln.strip() for ln in report.read_text().splitlines()
                if "registers" in ln] if report.exists() else []
        log(f"# phase 1: built {name} in {seconds:.2f} s ({so.name}); {' | '.join(regs)}")
    log(f"# phase 1: all kernels built in {time.time() - t0:.2f} s")


def flood_passes(init, grid, S, s, pass_fn):
    """The passes of voronoi.jump_flood from its initial planes, through the
    pass function given (kernel or plain)."""
    from aosx_torch.gvd import voronoi

    state = init
    for step in voronoi._passes(s):
        state = pass_fn(*state, step, S, grid.origin_x, grid.origin_y, s.resolution)
    return state


def phase_k1(device):
    import torch
    from aosx_torch.config import BENCH_STATICS as S
    from aosx_torch.gvd import jfa_pass_cuda, voronoi
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
    npass = len(voronoi._passes(S))
    init = voronoi._jfa_init(grid, seeds, S)
    st_k, ms_k = cuda_ms(lambda: flood_passes(init, grid, n, S, jfa_pass_cuda.jfa_pass), REPS)
    st_p, ms_p = cuda_ms(lambda: flood_passes(init, grid, n, S, jfa_pass_cuda.jfa_pass_plain), REPS)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(st_k, st_p))
    equal = all(torch.equal(a, b) for a, b in zip(st_k, st_p))
    log(f"# phase 2: K1 jump flood {S.grid_h}x{S.grid_w} S={n} ({npass} passes): "
        f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bitwise equal {equal}, "
        f"owned cells {int((st_k[0] < n).sum())}")
    if not equal:
        raise AssertionError(f"K1 differs from its plain version (max abs err {err})")
    # one pass reads the owner/ox/oy planes once and writes them once (24 B a
    # cell); per cell 4 FP32 ops for the coordinates, 6 for each of the 9
    # candidates (2 sub, 2 mul, 1 add, 1 compare) and an INT32 tie compare each
    cells = S.grid_h * S.grid_w
    b_ms, b_by = bound(24 * cells, fp32_ops=58 * cells, int32_ops=9 * cells)
    return dict(max_abs_err=err, ms=ms_k / npass, plain_ms=ms_p / npass,
                flood_ms=ms_k, flood_plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by)


def thin(grid, s, iteration):
    """skeleton.zhang_suen with the iteration function given. Returns (occ,
    iterations run)."""
    occ = grid.occ
    for it in range(1, s.skeleton_max_iters + 1):
        occ, changed = iteration(occ, grid.h_cells, grid.w_cells)
        if int(changed) == 0:
            return occ, it
    return occ, s.skeleton_max_iters


def phase_k2(device, bench_spec):
    import torch
    from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
    from aosx_torch.perceive import points, raster, skeleton, skeleton_cuda

    pc, poly = cloud(S, bench_spec, 0, device)
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    xy, keep, bounds, _ = points.preprocess(pc, poly, params, excl, S, ror_method="sorted")
    opened = skeleton.morph_open(raster.inflate(raster.generate_grid(xy, keep, bounds, S), S))
    (occ_k, it_k), ms_k = cuda_ms(lambda: thin(opened, S, skeleton_cuda.zhang_suen_iteration), REPS)
    (occ_p, it_p), ms_p = cuda_ms(
        lambda: thin(opened, S, skeleton_cuda.zhang_suen_iteration_plain), REPS)
    equal = torch.equal(occ_k, occ_p) and it_k == it_p
    err = float((occ_k.int() - occ_p.int()).abs().max())
    log(f"# phase 3: K2 Zhang-Suen on the bench inflated grid {S.grid_h}x{S.grid_w}: "
        f"{it_k} iterations, kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bitwise equal {equal}, "
        f"skeleton cells {int(occ_k.sum())}")
    if not equal:
        raise AssertionError(f"K2 differs from its plain version ({it_k} vs {it_p} iterations)")
    # one iteration reads the u8 plane once and writes it once (2 B a cell);
    # only set cells run the stencil, at most 2 x 49 INT32 ops each (A: 8 x
    # 4, B: 7, the products and the tests: 10), counted on the first
    # iteration's input, which has the most
    cells = S.grid_h * S.grid_w
    b_ms, b_by = bound(2 * cells, int32_ops=98 * int(opened.occ.sum()))
    return dict(max_abs_err=err, ms=ms_k / it_k, plain_ms=ms_p / it_p,
                fixpoint_ms=ms_k, fixpoint_plain_ms=ms_p, iterations=it_k,
                bound_ms=b_ms, bound_by=b_by)


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
    kernels = (jfa_pass_cuda.jfa_pass, skeleton_cuda.zhang_suen_iteration)

    def stage_full():
        out = perceive(pc, poly, params, excl, S, ror_method="sorted")
        world = engine.world_from_perceive(out, params, S)
        _, metrics = engine.step(engine.initial_state(world, S), world, params, S)
        return out, world, metrics

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out, world, metrics = stage_full()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {k.__name__: k.launches for k in kernels}
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
        owner_sha256=hashlib.sha256(owner.cpu().numpy().astype("<i4").tobytes()).hexdigest())
    log(f"# phase 5: {json.dumps(got)}")
    wxy = world.waypoints.xy.cpu().numpy()[:got["waypoints"]]
    diffs = {k: (got[k], ref[k]) for k in got if got[k] != ref[k] and k != "owner_sha256"}
    if diffs:
        raise AssertionError(f"BENCH_STATICS slice differs from the JAX reference: {diffs}")
    owner_cells = 0
    if got["owner_sha256"] != ref["owner_sha256"]:
        ref_owner = np.load(REFERENCE.with_name("bench_np_seed0_owner.npz"))["owner"]
        owner_cells = int((owner.cpu().numpy() != ref_owner).sum())
        log(f"# phase 5: owner plane differs from the JAX reference in {owner_cells} of "
            f"{ref_owner.size} cells (bound {OWNER_CELL_BOUND})")
    if owner_cells > OWNER_CELL_BOUND:
        raise AssertionError(f"owner plane differs in {owner_cells} cells")
    wp_ulp = ulp_distance(np.asarray(ref["waypoints_xy"], np.float32), wxy)
    if wp_ulp > ULP_BOUND:
        raise AssertionError(f"waypoint xy differ from the reference by {wp_ulp} ulp")
    assert got["seeds"] > 0 and got["rows"] > 0 and got["nodes"] > 0
    assert got["waypoints"] >= 4 and got["plan_len"] > 0
    if int(world.guards) != 0:
        raise AssertionError(f"world guard bits {int(world.guards)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # per-stage medians; a stage's time includes its host synchronisations
    _, t_perceive = cuda_ms(lambda: perceive(pc, poly, params, excl, S), REPS)
    _, t_world = cuda_ms(lambda: engine.world_from_perceive(out, params, S), REPS)
    _, t_step = cuda_ms(lambda: engine.step(engine.initial_state(world, S), world, params, S), REPS)
    _, t_total = cuda_ms(stage_full, REPS)
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"# phase 5: median ms (CUDA events, {REPS} reps): perceive {t_perceive:.2f}, "
        f"graph+costs+waypoints+trim {t_world:.2f}, step {t_step:.2f}, stage_full {t_total:.2f}; "
        f"matches the JAX reference (counts, skeleton hash; owner plane within "
        f"{owner_cells} cells; waypoints within {wp_ulp:g} ulp); "
        f"peak allocated {mem:.2f} GiB")
    return launches, dict(perceive_ms=t_perceive, world_ms=t_world, step_ms=t_step,
                          stage_full_ms=t_total)


def phase_k3(device, bench_spec):
    import torch
    from aosx_torch.config import BENCH_STATICS as S, AosParams
    from aosx_torch.perceive import points, ror_cuda

    r2 = torch.tensor(AosParams().ror_radius, dtype=torch.float32, device=device) ** 2
    pc, _ = cloud(S, bench_spec, 0, device)
    n = S.max_points
    n_valid = int(pc.valid.sum())
    # a uniform cloud at the orchard's density: its bounding box stretched
    # along x to hold n points
    xyz = pc.xyz[pc.valid].cpu().numpy()
    lo, hi = xyz.min(0), xyz.max(0)
    hi_x = lo[0] + (hi[0] - lo[0]) * n / n_valid
    rng = np.random.default_rng(1)
    uniform = np.stack([rng.uniform(lo[0], hi_x, n), rng.uniform(lo[1], hi[1], n),
                        rng.uniform(lo[2], hi[2], n)], 1).astype(np.float32)
    clouds = (("bench orchard", points.pad_to_block(points.park(pc.xyz, pc.valid), 2048)),
              ("uniform", torch.from_numpy(uniform).to(device)))
    out = {}
    for name, pts in clouds:
        got, ms_k = cuda_ms(lambda: ror_cuda.ror_counts(pts, r2), REPS)
        ref, ms_p = cuda_ms(lambda: ror_cuda.ror_counts_plain(pts, r2), 2)
        equal = torch.equal(got, ref)
        err = float((got.double() - ref.double()).abs().max())
        log(f"# phase 6: K3 ROR counts, {name} cloud, N = {pts.shape[0]}, r = 0.2: kernel "
            f"{ms_k:.3f} ms, plain {ms_p:.3f} ms, bitwise equal {equal}, mean count "
            f"{float(got.float().mean()):.2f}")
        if not equal:
            raise AssertionError(f"K3 differs from its plain version on the {name} cloud "
                                 f"(max abs err {err})")
        out[name] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err)
    # N^2 pairs of 6 FP32 instructions (1 mul + 2 fma for a.b, the sum of
    # norms, 1 fma for the difference, the compare) and an INT32 add each,
    # 7 to dispatch; the input is read once (12 B a point), the counts
    # written once (4 B)
    m = clouds[0][1].shape[0]
    b_ms, b_by = bound(16 * m, fp32_ops=6.0 * m * m, int32_ops=1.0 * m * m)
    bench = out["bench orchard"]
    log(f"# phase 6: K3 bound {b_ms:.3f} ms ({b_by}); kernel at {100 * b_ms / bench['ms']:.1f} % "
        f"of it on the bench cloud")
    return dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), ms=bench["ms"],
                plain_ms=bench["plain_ms"], uniform_ms=out["uniform"]["ms"],
                uniform_plain_ms=out["uniform"]["plain_ms"], bound_ms=b_ms, bound_by=b_by)


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
    # plan-cache rows: success of every row bitwise, and the plan length of
    # every row, with one exception. linearize's f32 regression split is
    # ill-conditioned far from the origin (ROADMAP section 3), so a row's
    # length may differ from JAX's only where the port's split is not the
    # exact one (linearize_f64.py, on the port's own raw path), and never
    # on a row the run adopts. Frame 0's raw A* paths must match JAX's
    # (raw_path_match).
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
        if kind is None:
            bad.append(f"frame 0 cache row {r}: raw A* path differs from JAX's")
        if kind == "tie":
            ties.append(f"row {r}: port {len(a)} points, {route_length(a, a):.6f} m; "
                        f"JAX {len(b)} points, {route_length(a, b):.6f} m")
    split_rows = [r for r, (raw, _, _) in enumerate(rows0) if int(raw.count) > 4]
    exact_rows = [r for r in split_rows if rows0[r][1] == rows0[r][2]]
    excused = {}

    def check_world(what, got, want, state, wp_base):
        for k, v in want.items():
            if k == "metrics" or k not in got:
                continue
            if k == "cache_count":
                for r, (a, b) in enumerate(zip(got[k], v)):
                    if a == b:
                        continue
                    rows = witness(state, wp_base)
                    if r in adopted or r >= len(rows) or rows[r][1] == rows[r][2]:
                        bad.append(f"{what} cache row {r} count: {a} vs {b}")
                    else:
                        excused.setdefault(r, (a, b, rows[r][1], rows[r][2]))
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
                if d > ULP_BOUND:
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
        f"{owner_cells} of {owner.numel()} cells (bound {OWNER_CELL_BOUND}); tick xy within "
        f"{worst_ulp:g} ulp (bound {ULP_BOUND}), yaw within {worst_yaw:.3g} rad (bound "
        f"{YAW_BOUND_RAD:.3g})")
    log(f"# phase 7: plan cache: frame 0 raw A* paths against JAX's, rows by kind: "
        f"{json.dumps({str(k): v for k, v in raw_match.items()})}; of its "
        f"{len(split_rows)} rows of more than 4 points the port's f32 split is the "
        f"exact (f64) one on {len(exact_rows)}; plan lengths equal JAX's on every row but "
        f"{len(excused)}, each one whose f32 split is not the exact one (none adopted)"
        + (":" if excused else ""))
    for t in ties:
        log(f"#   tie {t}")
    for r, (a, b, port, f64) in sorted(excused.items()):
        log(f"#   row {r}: length port {a}, JAX {b}; breakpoints port {port}, f64 {f64}")
    if ror_points > ROR_POINT_BOUND:
        bad.append(f"frame 0 ROR counts differ at {ror_points} points")
    if owner_cells > OWNER_CELL_BOUND:
        bad.append(f"frame 0 owner plane differs in {owner_cells} cells")
    if bad:
        raise AssertionError("serving differs from the JAX reference: " + "; ".join(bad))


def phase_serving(device):
    import dataclasses

    import torch
    from aosx_torch import serving
    from aosx_torch.config import BENCH_STATICS as S, AosParams, params_as_f32
    from aosx_torch.engine import stack_metrics
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.perceive import ror_cuda, skeleton_cuda
    from aosx_torch.plan import plancache

    ref = json.loads(SERVING_REFERENCE.read_text())
    frames, poly = serving_frames(ref, S, device)
    params = params_as_f32(AosParams(), device)
    excl = torch.zeros((S.max_exclusions, 3), device=device)
    kernels = (jfa_pass_cuda.jfa_pass, skeleton_cuda.zhang_suen_iteration, ror_cuda.ror_counts)
    ticks, v_dt = ref["ticks"], ref["v_dt"]
    torch.cuda.reset_peak_memory_stats()

    # the main path: serve_init, then per map frame serve_map_frame and the
    # control ticks (incremental.serve_frames written out, to keep the state
    # each frame's ticks start from)
    for k in kernels:
        k.launches = 0
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
    launches = {k.__name__: k.launches for k in kernels}
    levels = [f["level"] for f in got_frames]
    log(f"# phase 7: serving {len(frames)} frames x {ticks} ticks, ror_method='pallas': levels "
        f"{levels}, launches {launches}")

    compare_serving(ref, sv0, frame_states, got_frames, per_frame_metrics, params, S)
    if sorted(set(levels)) != [0, 2, 3]:
        raise AssertionError(f"levels {levels} do not cover 0, 2 and 3")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")

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
    reuse_reps = [host_ms(lambda: serving.serve_map_frame(sv, frames[-1], poly, params, excl, S,
                                                          ror_method="pallas"))[1]
                  for _ in range(REPS)]
    frame_ms.setdefault(0, []).extend(reuse_reps)
    mem = torch.cuda.max_memory_allocated() / 2**30
    stats = dict(serve_init_ms=float(np.median(init_reps)), serve_init_first_ms=init_ms,
                 build_plan_cache_ms=float(np.median(cache_reps)),
                 serve_map_frame_ms={lv: float(np.median(v)) for lv, v in sorted(frame_ms.items())},
                 serve_map_frame_samples={lv: len(v) for lv, v in sorted(frame_ms.items())},
                 serve_control_tick_ms=float(np.median(tick_ms)),
                 serve_control_tick_max_ms=float(np.max(tick_ms)), peak_allocated_gib=mem)
    log(f"# phase 7: serve_control_tick reproduces the replay's commands over {ticks} ticks; "
        f"median ms (host wall, synchronised): serve_init {stats['serve_init_ms']:.1f} "
        f"(first {init_ms:.1f}), build_plan_cache {stats['build_plan_cache_ms']:.1f}, "
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


def chain_bound_ms(stores, steps, load_clocks):
    """Least ms of a one-thread chase: ``stores`` independent table stores at
    one a clock, then ``steps`` dependent steps of one load-to-use latency
    plus three dependent integer operations (multiply-add, mask, xor)."""
    return 1e3 * (stores + steps * (load_clocks + 3 * INT_DEP_CLOCKS)) / SM_CLOCK_HZ


def phase_probes(device):
    import contextlib
    import io

    import torch
    from aosx_torch import probes

    ref = json.loads(PROBES_REFERENCE.read_text())
    seed = probes.seed_tensor(device, ref["seed"])

    def sha(tn):
        return hashlib.sha256(tn.cpu().numpy().astype("<i4").tobytes()).hexdigest()

    def check(name, equal, **against_ref):
        bad = {k: v for k, v in against_ref.items() if v != ref[k]}
        if not equal or bad:
            raise AssertionError(f"{name}: kernel == plain {equal}; differs from "
                                 f"tests/torch_reference/probes.json in {bad}")

    # P1: table in global memory, then the same chain from shared memory
    (c_k, tab_k), ms1 = cuda_ms(lambda: probes.chase_rw(seed), REPS)
    (c_s, tab_s), ms1s = cuda_ms(lambda: probes.chase_rw(seed, shared=True), REPS)
    (c_p, tab_p), ms1p = cuda_ms_once(lambda: probes.chase_rw_plain(seed))
    eq1 = (torch.equal(c_k, c_p) and torch.equal(tab_k, tab_p) and torch.equal(c_s, c_p)
           and torch.equal(tab_s, tab_p))
    err1 = float(max((c_k.double() - c_p.double()).abs().max(),
                     (tab_k.double() - tab_p.double()).abs().max(),
                     (tab_s.double() - tab_p.double()).abs().max()))
    check("P1", eq1, p1_c=int(c_k), p1_table_sha256=sha(tab_k))
    b1 = chain_bound_ms(probes.P1_N, probes.P1_STEPS, L1_HIT_CLOCKS)
    b1s = chain_bound_ms(probes.P1_N, probes.P1_STEPS, SMEM_CLOCKS)
    log(f"# phase 8: P1 chase_rw N={probes.P1_N}, {probes.P1_STEPS} steps: c = {int(c_k)}, "
        f"kernel {ms1:.3f} ms ({1e6 * ms1 / probes.P1_STEPS:.1f} ns/step, global table; bound "
        f"{b1:.3f} ms at an L1 hit a step), shared-memory u16 table {ms1s:.3f} ms "
        f"({1e6 * ms1s / probes.P1_STEPS:.1f} ns/step; bound {b1s:.3f} ms), plain {ms1p:.1f} ms, "
        f"c and table bitwise equal {eq1}")

    # P2
    c2, ms2 = cuda_ms(lambda: probes.chase_ro(seed), REPS)
    c2p, ms2p = cuda_ms_once(lambda: probes.chase_ro_plain(seed))
    eq2 = torch.equal(c2, c2p)
    check("P2", eq2, p2_c=int(c2))
    b2 = chain_bound_ms(probes.P2_N, probes.P2_STEPS, SMEM_CLOCKS)
    log(f"# phase 8: P2 chase_ro {probes.P2_N}-entry shared table, {probes.P2_STEPS} steps: "
        f"c = {int(c2)}, kernel {ms2:.3f} ms ({1e6 * ms2 / probes.P2_STEPS:.1f} ns/step; bound "
        f"{b2:.3f} ms), plain {ms2p:.1f} ms, bitwise equal {eq2}")

    # P3, and torch.gather alone for its 64 rounds (the library call)
    x, idx = probes.gather_rows_inputs(device)
    out_k, ms3 = cuda_ms(lambda: probes.gather_rows(x, idx), REPS)
    out_p, ms3p = cuda_ms(lambda: probes.gather_rows_plain(x, idx), REPS)
    index = ((idx + out_p) & (probes.P3_COLS - 1)).long()

    def gathers():
        for _ in range(probes.P3_ROUNDS):
            torch.gather(x, 1, index)

    _, ms3lib = cuda_ms(gathers, REPS)
    eq3 = torch.equal(out_k, out_p)
    err3 = float((out_k.double() - out_p.double()).abs().max())
    check("P3", eq3, p3_sum=int(out_k.sum(dtype=torch.int64)), p3_first4=out_k[0, :4].tolist(),
          p3_sha256=sha(out_k))
    n_gather = x.numel() * probes.P3_ROUNDS
    # x and idx read once, acc written once; per gathered element an index
    # add, a mask and the accumulate (INT32) and one 4-byte shared-memory read
    b3_ops, _ = bound(3 * 4 * x.numel(), int32_ops=3.0 * n_gather)
    b3 = max(b3_ops, 1e3 * 4 * n_gather / SMEM_BYTES_PER_S)
    log(f"# phase 8: P3 gather_rows {tuple(x.shape)} x {probes.P3_ROUNDS} rounds: kernel "
        f"{ms3:.4f} ms ({1e6 * ms3 / n_gather:.5f} ns/element), plain {ms3p:.3f} ms, "
        f"torch.gather x {probes.P3_ROUNDS} {ms3lib:.3f} ms, bound {b3:.4f} ms (INT32 "
        f"{b3_ops:.4f}, shared-memory banks {1e3 * 4 * n_gather / SMEM_BYTES_PER_S:.4f}), "
        f"all {out_k.numel()} outputs bitwise equal {eq3}")

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
        chase_rw=dict(launches=launches["chase_rw"], max_abs_err=err1, ms=ms1, plain_ms=ms1p,
                      bound_ms=b1, bound_by="operations", library_ms=None, shared_ms=ms1s,
                      shared_bound_ms=b1s, ns_per_step=1e6 * ms1 / probes.P1_STEPS),
        chase_ro=dict(launches=launches["chase_ro"],
                      max_abs_err=float((c2.double() - c2p.double()).abs().max()), ms=ms2,
                      plain_ms=ms2p, bound_ms=b2, bound_by="operations", library_ms=None,
                      ns_per_step=1e6 * ms2 / probes.P2_STEPS),
        gather_rows=dict(launches=launches["gather_rows"], max_abs_err=err3, ms=ms3,
                         plain_ms=ms3p, bound_ms=b3, bound_by="operations", library_ms=ms3lib,
                         ns_per_element=1e6 * ms3 / n_gather))


MC_INT_FIELDS = ("completed", "steps_to_complete", "final_status", "waypoints", "guards",
                 "feasible")
MC_FLOAT_FIELDS = ("travel_distance", "final_dist_to_origin")


def mc_single(cloud, params, S, device, budget, chunk):
    """One rollout alone: plancache.episode_cached written out (world, cache,
    feasibility, then single-lane ticks) and folded into the record the
    harness keeps, stopped where the harness retires a lane: at the first
    chunk boundary with exploration_completed set, or at the budget."""
    from aosx_torch.parallel import batch

    lite, cache, st, acc = batch.rollout_begin_cached(cloud, params, S, budget, device=device)
    for off in range(0, budget, chunk):
        st, acc = batch.rollout_chunk_cached(lite, cache, st, acc, params, S, chunk, off)
        if bool(st.mission.exploration_completed):
            break
    return {k: v.cpu().numpy() for k, v in batch.rollout_finish(st, acc, S).items()}


def phase_monte_carlo(device, total=MC_TOTAL, lanes=MC_BATCH, refill=MC_REFILL,
                      budget=MC_BUDGET, chunk=MC_CHUNK, rerun_ids=MC_RERUN_IDS,
                      sweep_seeds=MC_SWEEP_SEEDS, sweep_batch=MC_SWEEP_BATCH):
    import torch
    from aosx_torch.config import MC_STATICS as S, AosParams, params_as_f32
    from aosx_torch.gvd import jfa_pass_cuda
    from aosx_torch.orchards import OrchardSpec, make_orchard_np
    from aosx_torch.parallel import batch, sweep
    from aosx_torch.perceive import ror_cuda, skeleton_cuda
    from aosx_torch.plan import plancache
    from aosx_torch.plan.linearize import linearize
    from aosx_torch.plan.mission import plan_current_path
    from aosx_torch.types import MissionState

    ref = json.loads(MC_REFERENCE.read_text())
    spec = OrchardSpec(**ref["spec"])
    params = params_as_f32(AosParams(), device)
    kernels = (jfa_pass_cuda.jfa_pass, skeleton_cuda.zhang_suen_iteration, ror_cuda.ror_counts)
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

    # one world build alone: its kernel launches, and where begin's time goes
    for k in kernels:
        k.launches = 0
    world, world_ms = timed(lambda: batch._world(make_orchard_np(spec, seed=0), params, S,
                                                 "sorted", device))
    per_world = {k.__name__: k.launches for k in kernels}
    cache, cache_ms = timed(lambda: plancache.build_plan_cache(world, params, S))
    tour = int(world.waypoints.count)
    W = S.max_waypoints
    # rows 1 + tour .. W plan a target outside the tour: their search is
    # disabled, and they still pay the rest of plan_current_path and a
    # linearize; row W is one of them
    dead = W - tour

    def dead_row():
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        def flag(v):
            return torch.tensor(v, device=device)

        m = MissionState(target_wp=i32(W - 1), prev_wp=i32(W - 2), initial_reached=flag(True),
                         exploration_completed=flag(False), waiting_for_docking=flag(False),
                         status=i32(0), origin_appended=flag(False))
        raw, _ = plan_current_path(m, world.waypoints, world.graph, world.costmat,
                                   world.skeleton, params, S, trim_plane=world.trim_skel,
                                   astar_enabled=flag(False))
        return linearize(raw, params, S)

    dead_ms = float(np.median([timed(dead_row)[1] for _ in range(3)]))
    log(f"# phase 9: one MC_STATICS world ({S.grid_h}x{S.grid_w}): prepare_world "
        f"{world_ms:.0f} ms with launches {per_world}, build_plan_cache {cache_ms:.0f} ms for "
        f"{plancache.num_rows(S)} rows; tour {tour}, so {dead} rows are dead at "
        f"{dead_ms:.1f} ms each: {dead * dead_ms:.0f} ms, "
        f"{100 * dead * dead_ms / (world_ms + cache_ms):.0f} % of a world's begin")

    # the main path: the sustained harness, counts set to 0 just before it
    started = []

    def clouds(i):
        started.append(i)
        return make_orchard_np(spec, seed=i)

    for k in kernels:
        k.launches = 0
    (res, stats), wall_ms = timed(lambda: batch.sustained_rollouts(
        total, lanes, spec, params, S, budget, chunk_steps=chunk, refill=refill,
        ror_method="sorted", cached=True, clouds=clouds, device=device))
    launches = {k.__name__: k.launches for k in kernels}
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
        if launches["jfa_pass"] != total * per_world["jfa_pass"]:
            raise AssertionError(f"K1 launches {launches['jfa_pass']} for {total} worlds of "
                                 f"{per_world['jfa_pass']} passes")
        if launches["zhang_suen_iteration"] <= 0:
            raise AssertionError("K2 was not launched on the Monte-Carlo path")
        log(f"# phase 9: a world build launches K1 {launches['jfa_pass'] / total:.1f} times "
            f"(alone: {per_world['jfa_pass']}) and K2 "
            f"{launches['zhang_suen_iteration'] / total:.2f} times (alone: "
            f"{per_world['zhang_suen_iteration']}; it ends on the data)")

    # every record against the JAX reference
    differ, worst, bad = [], 0.0, []
    for i in range(total):
        want = ref["records"][i]
        got = {k: res[k][i].item() for k in res}
        ints_ok = all(got[k] == want[k] for k in MC_INT_FIELDS)
        err = max(abs(got[k] - want[k]) for k in MC_FLOAT_FIELDS)
        if ints_ok and err <= MC_FLOAT_BOUND_M:
            worst = max(worst, err)
            continue
        differ.append(i)
        # which plan-cache rows of this world differ from JAX's in length
        _, cache_i, _, _ = batch.rollout_begin_cached(make_orchard_np(spec, seed=i), params, S,
                                                      budget, device=device)
        rows = [r for r, (a, b) in enumerate(zip(cache_i.plan_count.tolist(),
                                                 want["cache_count"])) if a != b]
        log(f"# phase 9: rollout {i} differs from the JAX reference in "
            f"{ {k: (got[k], want[k]) for k in got if got[k] != want[k]} } (port, JAX); "
            f"cache rows of another plan length: {rows}")
        if (any(got[k] != want[k] for k in MC_INT_FIELDS if k != "steps_to_complete")
                or abs(got["steps_to_complete"] - want["steps_to_complete"]) > MC_DRIFT_STEPS
                or err > MC_DRIFT_TRAVEL_M):
            bad.append(i)
    comp = res["completed"]
    log(f"# phase 9: {total - len(differ)} of {total} records equal the JAX reference (int/bool "
        f"bitwise, travel and distance to origin within {worst:.3g} m, bound {MC_FLOAT_BOUND_M}); "
        f"{len(differ)} differ (bound {MC_RECORD_BOUND}): {differ}; "
        f"completed {int(comp.sum())}, infeasible {int((res['feasible'] == 0).sum())}, "
        f"guard-flagged {int((res['guards'] != 0).sum())}, out of budget "
        f"{int((~comp & (res['guards'] == 0)).sum())}")
    if len(differ) > MC_RECORD_BOUND or bad:
        raise AssertionError(f"{len(differ)} records differ from the JAX reference; beyond "
                             f"the drift bounds: {bad}")
    if int(comp.sum()) == 0:
        raise AssertionError("no rollout completed")

    # lanes and refill change nothing: rollouts again, alone
    t0 = time.perf_counter()
    for i in rerun_ids:
        alone = mc_single(make_orchard_np(spec, seed=i), params, S, device, budget, chunk)
        bad = [k for k in res if alone[k].tobytes() != res[k][i].tobytes()]
        if bad:
            raise AssertionError(f"rollout {i} alone differs from its lane's record in {bad}: "
                                 f"{ {k: (alone[k].item(), res[k][i].item()) for k in bad} }")
    sync()
    single_s = (time.perf_counter() - t0) / len(rerun_ids)
    log(f"# phase 9: rollouts {list(rerun_ids)} alone (single-lane ticks up to the chunk "
        f"boundary their lane retired at) equal "
        f"their lane's record bitwise; {single_s:.1f} s a rollout alone")

    # a 2 x 2 sweep; configuration 0 is the default parameters
    stacked, configs = sweep.grid_params(device=device, docking_radius=[0.7, 0.4],
                                         heuristic_weight=[3.0, 1.0])
    (sres, sstats), sweep_ms = timed(lambda: sweep.sweep_rollouts(
        stacked, configs, sweep_seeds, spec, S, budget, batch=sweep_batch, chunk_steps=chunk,
        ror_method="sorted", cached=True, device=device))
    table, agg = sweep.summarize_sweep(sres, len(configs), sweep_seeds)
    bad = [k for k in res if table[k][0].tobytes() != res[k][:sweep_seeds].tobytes()]
    if bad:
        raise AssertionError(f"sweep configuration 0 differs from the unswept records in {bad}")
    log(f"# phase 9: sweep {configs} x {sweep_seeds} orchards through {sweep_batch} lanes in "
        f"{sweep_ms / 1e3:.1f} s ({sstats['rollouts_per_sec']:.3f} rollouts/s from the first "
        f"chunk): configuration 0 equals the unswept records bitwise; completion rate "
        f"{agg['completion_rate'].tolist()}, mean travel {np.round(agg['travel_mean'], 2).tolist()}")
    mem = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    log(f"# phase 9: peak allocated {mem:.2f} GiB")
    return launches, dict(
        rollouts_per_sec=stats["rollouts_per_sec"], rollouts_per_sec_with_fill=1e3 * total / wall_ms,
        elapsed_s=stats["elapsed_s"], begin_calls=n_groups, chunk_calls=stats["chunk_calls"],
        begin_group_ms=1e3 * stats["begin_s"] / n_groups, begin_world_ms=1e3 * stats["begin_s"] / total,
        chunk_call_ms=1e3 * stats["chunk_s"] / stats["chunk_calls"],
        lane_tick_us=1e6 * stats["chunk_s"] / lane_ticks, prepare_world_ms=world_ms,
        build_plan_cache_ms=cache_ms, dead_rows=dead, dead_row_ms=dead_ms, single_rollout_s=single_s,
        records_differing=len(differ), float_err_m=worst, completed=int(comp.sum()),
        infeasible=int((res["feasible"] == 0).sum()), flagged=int((res["guards"] != 0).sum()),
        sweep_s=sweep_ms / 1e3, peak_allocated_gib=mem, launches_per_world=per_world)


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
    phase_environment()
    phase_build()
    k1 = phase_k1(device)
    k2 = phase_k2(device, bench_spec)
    phase_test_slice(device)
    launches, stages = phase_bench_slice(device, bench_spec)
    k3 = phase_k3(device, bench_spec)
    serve_launches, serve_stats = phase_serving(device)
    probe_rows = phase_probes(device)
    mc_launches, mc_stats = phase_monte_carlo(device)

    def row(name, source, replaces, k):
        # launches: on the serving path (phase 7); launches_stage_full: on
        # stage_full (phase 5); launches_mc: on the Monte-Carlo path (phase
        # 9). No single PyTorch call computes any of the three functions,
        # hence library_ms null
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=serve_launches[name], launches_stage_full=launches.get(name, 0),
                    launches_mc=mc_launches[name],
                    max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None)

    def probe_row(name, line, k):
        # launches: on the probe entry point (phase 8). P1 and P2 are bound by
        # a chain of dependent operations at their latency, not by a rate
        return dict(name=name, route="cuda", source="aosx_torch/csrc/probe_prims.cu",
                    replaces=f"benchmarks/probe_pallas_prims.py:{line}", **k)

    kernels = [
        row("jfa_pass", "aosx_torch/csrc/jfa_pass.cu", "aosx/gvd/jfa_pass_pallas.py:189", k1),
        row("zhang_suen_iteration", "aosx_torch/csrc/zhang_suen.cu",
            "aosx/perceive/skeleton_pallas.py:146", k2),
        row("ror_counts", "aosx_torch/csrc/ror_counts.cu", "aosx/perceive/ror_pallas.py:51", k3),
        probe_row("chase_rw", 57, probe_rows["chase_rw"]),
        probe_row("chase_ro", 90, probe_rows["chase_ro"]),
        probe_row("gather_rows", 117, probe_rows["gather_rows"]),
    ]
    log(f"# stages: {json.dumps(stages)}")
    log(f"# serving: {json.dumps(serve_stats)}")
    log(f"# monte carlo: {json.dumps(mc_stats)}")
    log(f"# K3 uniform cloud: kernel {k3['uniform_ms']:.3f} ms, plain {k3['uniform_plain_ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
