#!/usr/bin/env python3
"""GPU smoke run of aosx_torch, the PyTorch/CUDA port of aosx.

Drives the port's main path (bench.py's stage_full: perceive -> GVD graph ->
cost matrix -> waypoints + trim plane -> one engine.step) on one CUDA card
and checks every hand-written kernel on it:

  phase 0  environment: the card's name and power limit, torch and CUDA
  phase 1  build kernels K1 (jfa_pass) and K2 (zhang_suen) with nvcc
  phase 2  K1: a full jump flood at 2000 x 2048, S = 4096, through the
           kernel and through the plain PyTorch pass; bitwise equal
  phase 3  K2: Zhang-Suen to the fixpoint on the bench orchard's inflated
           grid, through the kernel and the plain iteration; bitwise equal
  phase 4  the slice at TEST_STATICS (stage_full + 20 ticks), CUDA against
           the port on the CPU
  phase 5  the slice at BENCH_STATICS on CUDA: the kernels' launch counts,
           guard bits, and the JAX package's full-size reference summary
           (tests/torch_reference/bench_np_seed0.json); per-stage times

Every phase raises on failure, so the exit code is not 0 and no result is
printed. There is no CPU fallback: without a CUDA device the run fails.
The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on the main path, its error against the plain
version and both times.

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


def cloud(statics, spec, seed, device):
    """make_orchard_np's cloud padded to statics.max_points, and its polygon."""
    import torch
    from aosx_torch.orchards import make_orchard_np
    from aosx_torch.types import PointCloud, Polygon

    xyz, poly = make_orchard_np(spec, seed=seed)
    buf = np.zeros((statics.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(statics.max_points, bool)
    valid[:len(xyz)] = True
    pc = PointCloud(xyz=torch.from_numpy(buf).to(device), valid=torch.from_numpy(valid).to(device))
    return pc, Polygon.from_array(poly, statics, device)


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
    from aosx_torch import cuda_build

    out = {}
    for name in ("jfa_pass", "zhang_suen"):
        t0 = time.time()
        so = cuda_build.build(name)
        cuda_build.load(name)
        out[name] = time.time() - t0
        report = so.with_suffix(".log")
        regs = [ln.strip() for ln in report.read_text().splitlines()
                if "registers" in ln] if report.exists() else []
        log(f"# phase 1: built {name} in {out[name]:.2f} s ({so.name}); {' | '.join(regs)}")
    return out


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
    return dict(max_abs_err=err, ms=ms_k / npass, plain_ms=ms_p / npass,
                flood_ms=ms_k, flood_plain_ms=ms_p)


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
    return dict(max_abs_err=err, ms=ms_k / it_k, plain_ms=ms_p / it_p,
                fixpoint_ms=ms_k, fixpoint_plain_ms=ms_p, iterations=it_k)


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


def main():
    sys.path.insert(0, str(ROOT))
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
    kernels = [
        dict(name="jfa_pass", route="cuda", source="aosx_torch/csrc/jfa_pass.cu",
             replaces="aosx/gvd/jfa_pass_pallas.py:189", launches=launches["jfa_pass"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="zhang_suen_iteration", route="cuda", source="aosx_torch/csrc/zhang_suen.cu",
             replaces="aosx/perceive/skeleton_pallas.py:146",
             launches=launches["zhang_suen_iteration"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"]),
    ]
    log(f"# stages: {json.dumps(stages)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
