"""Full-size reference summary of the JAX package's main path.

Runs ``aosx``'s bench.py ``stage_full`` composition (perceive -> GVD graph
-> cost matrix -> waypoints + trim plane -> one ``engine.step``) at
BENCH_STATICS on the CPU, on the numpy bench orchard (bench.py's OrchardSpec,
``make_orchard_np(spec, seed=0)`` padded to max_points), and writes
``bench_np_seed0.json`` beside this file: counts, guard bits, sha256 of the
skeleton u8 plane and of the Voronoi owner i32 plane, the waypoint xy, and
the robot's xy and yaw after the step; the owner plane itself goes to ``bench_np_seed0_owner.npz``, so that a run
whose plane differs can count the cells that differ. ``chip_smoke.py``
holds the PyTorch port on the GPU to this summary.

The flood runs in BENCH_STATICS' own lowering: the banded Pallas pass kernel
for every pass of step <= 128 (``aosx.gvd.jfa_pass_pallas``, switched to
interpret mode around the jit, as ``aosx``'s tests run it on the CPU), the
static-shift XLA pass for steps 1024, 512 and 256. The lowerings do not give
the same owners on XLA:CPU: their squared distances are contracted into
fused multiply-adds differently (``aosx_torch/gvd/voronoi.py``), and the
Pallas kernel's owner and position planes are built by fusions that round
apart (``tests/torch_reference/owner_cells.py``).

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference/make_bench_reference.py
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx import engine  # noqa: E402
from aosx.config import BENCH_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.gvd import jfa_pass_pallas  # noqa: E402
from aosx.gvd.graph import build_gvd_graph, merge_seeds  # noqa: E402
from aosx.gvd.voronoi import jump_flood  # noqa: E402
from aosx.orchards import OrchardSpec, make_orchard_np  # noqa: E402
from aosx.perceive import perceive  # noqa: E402
from aosx.plan.astar import cost_matrix  # noqa: E402
from aosx.plan.mission import build_waypoints, trim_distance_plane  # noqa: E402
from aosx.types import PointCloud, Polygon  # noqa: E402

# bench.py's orchard: 20 rows of 180 m, 9 m apart
BENCH_SPEC = dict(n_rows=20, row_len=180.0, row_spacing=9.0, tree_spacing=1.0,
                  trunk_pts=24, noise_pts=512, origin=(8.0, 8.0), jitter=0.15,
                  polygon_pad=2.0)
OUT = pathlib.Path(__file__).resolve().parent / "bench_np_seed0.json"
OWNER_OUT = OUT.with_name("bench_np_seed0_owner.npz")


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def main():
    s = BENCH_STATICS
    xyz, poly = make_orchard_np(OrchardSpec(**BENCH_SPEC), seed=0)
    buf = np.zeros((s.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(s.max_points, bool)
    valid[:len(xyz)] = True
    pc = PointCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid))
    polygon = Polygon.from_array(poly, s)
    params = params_as_f32(AosParams())
    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    @jax.jit
    def stage_full(pc, poly, params, excl):
        out = perceive(pc, poly, params, excl, s, ror_method="sorted")
        g = build_gvd_graph(out.seeds, out.rows_sorted, out.skeleton, params, s)
        cm = cost_matrix(g, s)
        wp = build_waypoints(g, params, s)
        world = engine.World(skeleton=out.skeleton, occupancy=out.occupancy, graph=g,
                             costmat=cm, waypoints=wp,
                             guards=out.guards | g.guards | cm.guards,
                             trim_skel=trim_distance_plane(out.skeleton, s))
        state, metrics = engine.step(engine.initial_state(world, s), world, params, s)
        owner = jump_flood(out.skeleton, merge_seeds(out.seeds, params, s), s)
        return out, world, metrics, owner, state.robot

    t0 = time.time()
    jfa_pass_pallas.INTERPRET = True
    try:
        out, world, metrics, owner, robot = jax.block_until_ready(
            stage_full(pc, polygon, params, excl))
    finally:
        jfa_pass_pallas.INTERPRET = False
    seconds = time.time() - t0
    wp = world.waypoints
    n_wp = int(wp.count)
    summary = dict(
        source="aosx stage_full (bench.py) at BENCH_STATICS (the Pallas JFA pass in "
               "interpret mode for steps <= 128), JAX on the CPU",
        spec=BENCH_SPEC,
        seed=0,
        n_points=int(len(xyz)),
        seeds=int(np.asarray(out.seeds.valid).sum()),
        rows=int(np.asarray(out.rows.valid).sum()),
        nodes=int(world.graph.num_nodes),
        edges=int(world.graph.num_edges),
        waypoints=n_wp,
        plan_len=int(metrics["plan_len"]),
        mod=int(metrics["mod"]),
        status=int(metrics["status"]),
        guards=int(metrics["guards"]),
        skeleton_sha256=sha256(out.skeleton.occ),
        owner_sha256=sha256(np.asarray(owner).astype("<i4")),
        waypoints_xy=[[float(x), float(y)] for x, y in np.asarray(wp.xy)[:n_wp]],
        robot_xy=[float(v) for v in np.asarray(robot.xy)],
        robot_yaw=float(robot.yaw),
        jax_cpu_seconds=round(seconds, 1),
    )
    OUT.write_text(json.dumps(summary, indent=1) + "\n")
    np.savez_compressed(OWNER_OUT, owner=np.asarray(owner).astype("<i4"))
    print(json.dumps({k: v for k, v in summary.items() if k != "waypoints_xy"}))


if __name__ == "__main__":
    main()
