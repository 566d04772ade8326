"""Full-size references of the JAX package's host surface at BENCH_STATICS.

On the bench orchard (bench.py's spec, seed 0) on the CPU, in BENCH_STATICS'
own flood lowering (the Pallas JFA pass for steps <= 128 in interpret mode,
``aosx.gvd.jfa_pass_pallas.INTERPRET`` set for the whole run, as in
``make_bench_reference.py``; the lowerings do not give the same owners):

- ``make_orchard(PRNGKey(0), spec, BENCH_STATICS)``: its valid count and
  the sha256 of its xyz and valid buffers;
- ``perceive`` (ror_method="sorted", as stage_full) and
  ``build_gvd_graph(..., compute_clearances=True)``: the skeleton's sha256,
  the obstacle distance field's sha256 and f64 sum, and the graph;
- ``gvd_graph_to_msg`` and ``occupancy_grid_to_msg`` of that world: the
  graph message's arrays and the occupancy message's sha256;
- the /aos/next_waypoint service on that world from a mission at the
  initial waypoint: SERVICE_CALLS times ``force_next_waypoint`` and then
  ``plan_current_path(use_current_position=)`` from 0.3 m beside the
  robot's current waypoint, each call's mission state, flag and path.

It writes ``host_np_seed0.json`` (scalars, hashes, the service's states)
and ``host_np_seed0.npz`` (the graph message's and the service paths'
arrays) beside this file; ``chip_smoke.py`` (phase 10) holds the port on the
card to them.

Run from the repository root (about 1-2 minutes):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_host_reference.py
"""

from __future__ import annotations

import dataclasses
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

from aosx.config import BENCH_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.gvd import jfa_pass_pallas  # noqa: E402
from aosx.gvd.clearance import obstacle_distance_field  # noqa: E402
from aosx.gvd.graph import build_gvd_graph  # noqa: E402
from aosx.io import ros_msgs  # noqa: E402
from aosx.orchards import OrchardSpec, make_orchard, make_orchard_np  # noqa: E402
from aosx.perceive import perceive  # noqa: E402
from aosx.plan.astar import cost_matrix  # noqa: E402
from aosx.plan.mission import (build_waypoints, force_next_waypoint,  # noqa: E402
                               plan_current_path, trim_distance_plane)
from aosx.types import MissionState, PointCloud, Polygon  # noqa: E402

BENCH_SPEC = dict(n_rows=20, row_len=180.0, row_spacing=9.0, tree_spacing=1.0,
                  trunk_pts=24, noise_pts=512, origin=(8.0, 8.0), jitter=0.15,
                  polygon_pad=2.0)
SERVICE_CALLS = 6
SERVICE_OFFSET_M = 0.3
OUT = pathlib.Path(__file__).resolve().with_name("host_np_seed0.json")
ARRAYS = OUT.with_suffix(".npz")
# the graph message's array fields
MSG_ARRAYS = ("node_labels", "node_cluster_indices", "node_label_clusters", "node_label_types",
              "node_label_counts", "edges", "edge_lengths", "edge_clearances")


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def msg_arrays(msg: dict) -> dict:
    """The graph message's list fields as arrays (nodes as [n, 2] f32)."""
    out = {"nodes": np.array([[p["x"], p["y"]] for p in msg["nodes"]], np.float32).reshape(-1, 2)}
    for k in MSG_ARRAYS:
        out[k] = np.asarray(msg[k], np.float32 if k in ("edge_lengths", "edge_clearances")
                            else np.int32)
    return out


def main():
    s = BENCH_STATICS
    spec = OrchardSpec(**BENCH_SPEC)
    params = params_as_f32(AosParams())
    t0 = time.time()

    pc_dev, _ = jax.jit(lambda k: make_orchard(k, spec, s))(jax.random.PRNGKey(0))
    orchard = dict(valid=int(np.asarray(pc_dev.valid).sum()),
                   xyz_sha256=sha256(np.asarray(pc_dev.xyz)),
                   valid_sha256=sha256(np.asarray(pc_dev.valid)))

    xyz, poly = make_orchard_np(spec, seed=0)
    buf = np.zeros((s.max_points, 3), np.float32)
    buf[:len(xyz)] = xyz
    valid = np.zeros(s.max_points, bool)
    valid[:len(xyz)] = True
    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    @jax.jit
    def world(pc, poly):
        out = perceive(pc, poly, params, excl, s, ror_method="sorted")
        g = build_gvd_graph(out.seeds, out.rows_sorted, out.skeleton, params, s,
                            compute_clearances=True)
        return (out, g, obstacle_distance_field(out.skeleton, s), cost_matrix(g, s),
                build_waypoints(g, params, s), trim_distance_plane(out.skeleton, s))

    out, graph, field, costmat, wp, trim = world(
        PointCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)), Polygon.from_array(poly, s))
    skel = out.skeleton
    gmsg = ros_msgs.gvd_graph_to_msg(graph, s.resolution, float(skel.origin_x),
                                     float(skel.origin_y))
    omsg = ros_msgs.occupancy_grid_to_msg(out.occupancy, s.resolution)

    @jax.jit
    def service(st, wp, here):
        st, wp, from_here = force_next_waypoint(st, wp, params)
        path, ok = plan_current_path(st, wp, graph, costmat, skel, params, s,
                                     use_current_position=here, trim_plane=trim)
        return st, wp, from_here, path, ok

    st = dataclasses.replace(MissionState.initial(), initial_reached=jnp.bool_(True))
    calls, arrays = [], {}
    n_wp = int(wp.count)
    for i in range(SERVICE_CALLS):
        here = (np.asarray(wp.xy)[min(i, n_wp - 1)] + np.float32(SERVICE_OFFSET_M)).astype(
            np.float32)
        st, wp, from_here, path, ok = service(st, wp, jnp.asarray(here))
        calls.append(dict(here=here.tolist(), from_here=bool(from_here), ok=bool(ok),
                          path_count=int(path.count), wp_count=int(wp.count),
                          mission={f.name: int(getattr(st, f.name))
                                   for f in dataclasses.fields(st)}))
        arrays[f"path{i}_xy"] = np.asarray(path.xy)
        arrays[f"path{i}_yaw"] = np.asarray(path.yaw)
    arrays.update({f"msg_{k}": v for k, v in msg_arrays(gmsg).items()})
    seconds = time.time() - t0

    summary = dict(
        source="aosx at BENCH_STATICS (the Pallas JFA pass in interpret mode for steps "
               "<= 128), JAX on the CPU",
        spec=BENCH_SPEC, seed=0, n_points=int(len(xyz)),
        make_orchard=orchard,
        skeleton_sha256=sha256(skel.occ),
        distance_field=dict(sha256=sha256(field), sum=float(np.asarray(field, np.float64).sum())),
        graph=dict(nodes=gmsg["num_nodes"], edges=gmsg["num_edges"],
                   origin=[gmsg["origin_x"], gmsg["origin_y"]]),
        occupancy_msg=dict(width=omsg["info"]["width"], height=omsg["info"]["height"],
                           data_sha256=sha256(np.asarray(omsg["data"], np.int8))),
        service=dict(offset_m=SERVICE_OFFSET_M, calls=calls),
        jax_cpu_seconds=round(seconds, 1),
    )
    OUT.write_text(json.dumps(summary, indent=1) + "\n")
    np.savez_compressed(ARRAYS, **arrays)
    print(json.dumps({k: v for k, v in summary.items() if k != "service"}))
    print(json.dumps(calls))


if __name__ == "__main__":
    jfa_pass_pallas.INTERPRET = True
    main()
