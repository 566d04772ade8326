"""Operator's dashboard (mirror of ``aosx/dashboard.py``), the replacement
of the reference's RViz panel (src/ui/aos_panel_plugin*.cpp):

- status tab        -> episode_report(): control-mode text, position,
                       cluster/waypoint progress with the panel's formula
                       (aos_panel_plugin_ros2.cpp:232-244)
- parameters tab    -> params_get/params_set on the aos_planner_params.yaml
                       schema (round-tripped structurally)
- map save chain    -> save_map(): the final state + cluster info

Run: python -m aosx_torch.dashboard [--steps N] [--pcd file] [--out dir]
     python -m aosx_torch.dashboard --pcd-seq 'maps/frame_*.pcd' [--cached | --serve]

Everything runs on the CUDA card unless ``--device cpu`` asks for the CPU;
without a card the command fails rather than moving to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

MODE_TEXT = {0: "Path Following", 1: "Precise Approach", 2: "Semi-Precise Approach",
             3: "Stopped/Arrived"}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def panel_total_waypoints(n_clusters: int) -> int:
    """The panel's progress denominator (aos_panel_plugin_ros2.cpp:232-244):
    2 waypoints per cluster plus 3 on the last."""
    if n_clusters <= 0:
        return 0
    return 2 * (n_clusters - 1) + 3


def episode_report(final, metrics, statics) -> dict:
    from .guards import describe
    from .types import STATUS_STRINGS

    status = int(_np(metrics["status"])[-1])
    mod = int(_np(metrics["mod"])[-1])
    xy = _np(final.robot.xy)
    target = int(final.mission.target_wp)
    n_wp = int(final.wp.count)
    report = dict(
        status=STATUS_STRINGS.get(status, str(status)),
        control_mode=MODE_TEXT.get(mod, str(mod)),
        position=[round(float(xy[0]), 3), round(float(xy[1]), 3)],
        waypoint_progress=f"{max(target, 0)}/{n_wp}",
        cluster_index=int(_np(metrics["cluster_idx"])[-1]) if "cluster_idx" in metrics else None,
        exploration_completed=bool(final.mission.exploration_completed),
        docking=bool(final.mission.waiting_for_docking),
        travel_distance=round(float(np.sum(np.sqrt(np.sum(
            np.diff(_np(metrics["xy"]), axis=0) ** 2, axis=1)))), 2),
    )
    if "guards" in metrics:
        tripped = describe(int(_np(metrics["guards"]).ravel()[-1]))
        if tripped:
            report["approximation_guards"] = tripped
    return report


def params_get(yaml_path: str, node: str = "aos_seed_gen_node"):
    from .config import load_yaml

    return load_yaml(yaml_path, node)


def params_set(yaml_path: str, updates: dict, node: str = "/**"):
    """Structural YAML patch (the panel regex-patches in place,
    aos_panel_plugin_params.cpp:59-125; the document is round-tripped)."""
    import yaml

    with open(yaml_path) as f:
        doc = yaml.safe_load(f) or {}
    doc.setdefault(node, {}).setdefault("ros__parameters", {}).update(updates)
    with open(yaml_path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)


def save_map(out_dir: str, world, final_state, rows_sorted=None):
    from .io.checkpoint import save_cluster_info, save_state

    os.makedirs(out_dir, exist_ok=True)
    save_state(os.path.join(out_dir, "episode_state"), final_state)
    if rows_sorted is not None:
        save_cluster_info(os.path.join(out_dir, "cluster_info"), world.graph, rows_sorted)


def _serve_loop(frames, poly, params, excl, S, steps_per_frame):
    """Drive the live serving API (``serving``) over recorded map snapshots,
    one message at a time: serve_init on the first frame, then per frame
    serve_map_frame and steps_per_frame serve_control_tick calls. The
    odometry is simulated by the replay's unicycle follower, fed from each
    tick's published command, so the decisions match the --cached replay
    of the same frames. Returns (final CachedEngineState, flat metrics
    dict, IncrementalState, levels list)."""
    from . import engine, serving
    from .types import Path

    dev = frames.xyz.device
    sv = serving.serve_init(engine.frame(frames, 0), poly, params, excl, S, ror_method="exact")
    xy = torch.zeros(2, dtype=torch.float32, device=dev)
    yaw = torch.zeros((), dtype=torch.float32, device=dev)
    follow = torch.zeros((), dtype=torch.int32, device=dev)
    zero_yaws = torch.zeros((S.max_plan,), dtype=torch.float32, device=dev)
    last_adopted = None
    levels, rows = [], []
    for f in range(frames.xyz.shape[0]):
        sv, level = serving.serve_map_frame(sv, engine.frame(frames, f), poly, params, excl, S,
                                            ror_method="exact")
        levels.append(int(level))
        for _ in range(steps_per_frame):
            sv, cmd = serving.serve_control_tick(sv, xy, yaw, params, S)
            adopted = int(cmd["adopted"])
            if adopted != last_adopted:
                follow = torch.zeros_like(follow)
                last_adopted = adopted
            # the replay's motion: the published plan with zero yaws (the
            # follower never reads them); `follow` is the monotone progress
            # index, reset whenever the adopted plan changes
            robot = engine._move_robot(
                engine.Robot(xy=cmd["xy"], yaw=cmd["yaw"], follow_i=follow), cmd["mod"],
                Path(xy=cmd["plan_xy"], yaw=zero_yaws, count=cmd["plan_len"]),
                cmd["goal_xy"], cmd["goal_yaw"])
            xy, yaw, follow = robot.xy, robot.yaw, robot.follow_i
            rows.append({k: cmd[k] for k in ("mod", "status", "cluster_idx", "guards")}
                        | {"xy": xy, "yaw": yaw})
    metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return sv.st, metrics, sv.inc, levels


def _pcd_buffers(files, S):
    """Padded (xyz [F, max_points, 3] f32, valid [F, max_points]) of PCD maps."""
    from .io.pcd import load_pcd

    bufs = np.zeros((len(files), S.max_points, 3), np.float32)
    valids = np.zeros((len(files), S.max_points), bool)
    for f, path in enumerate(files):
        xyz = load_pcd(path)
        n = min(len(xyz), S.max_points)
        bufs[f, :n] = xyz[:n]
        valids[f, :n] = True
    return bufs, valids


def _save_figure(out_dir, world, final, metrics, S, perceive_out, owner, show_cells):
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("render skipped: matplotlib is not installed")
        return
    from .io.render import save_episode_figure

    save_episode_figure(os.path.join(out_dir, "episode.png"), world, state=final,
                        metrics=metrics, resolution=S.resolution, seeds=perceive_out.seeds,
                        rows=perceive_out.rows_sorted, owner=owner, show_cells=show_cells)
    print(f"figure: {out_dir}/episode.png")


def main(argv=None):
    """The command line (``argv`` or ``sys.argv``). Prints the report as
    JSON, writes the final state and the figure to ``--out``, and returns
    (report, final state)."""
    from . import engine, incremental
    from .config import TEST_STATICS as S, AosParams, params_as_f32
    from .orchards import OrchardSpec, make_orchard
    from .prng import prng_key
    from .types import PointCloud, Polygon

    ap = argparse.ArgumentParser(prog="python -m aosx_torch.dashboard")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--pcd", type=str, default=None, help="replay a PCD map")
    ap.add_argument("--pcd-seq", type=str, default=None,
                    help="comma-separated PCD files or a glob: snapshots of a growing SLAM map, "
                         "replayed through the exact incremental engine (incremental). "
                         "Index-stable append-only sequences reuse unchanged work; anything "
                         "else falls back to from-scratch frames (level 3)")
    ap.add_argument("--polygon", type=str, default=None, help="polygon JSON (xy pairs)")
    ap.add_argument("--params", type=str, default=None, help="aos_planner_params.yaml")
    ap.add_argument("--out", type=str, required=True, help="output directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a CUDA card; cpu runs on the CPU")
    ap.add_argument("--cells", action="store_true",
                    help="overlay the Voronoi ownership cells in the figure")
    ap.add_argument("--cached", action="store_true",
                    help="with --pcd-seq: the full serving loop (incremental world gates + "
                         "per-world plan cache, replan-free ticks), with the same metrics as "
                         "the replan-every-tick engine")
    ap.add_argument("--serve", action="store_true",
                    help="with --pcd-seq: drive the live serving API (serving.serve_init/"
                         "serve_map_frame/serve_control_tick) message by message, with the "
                         "robot's odometry simulated by the replay's unicycle follower")
    args = ap.parse_args(argv)
    if args.serve and not args.pcd_seq:
        ap.error("--serve requires --pcd-seq (the live serving loop runs over a map-frame "
                 "sequence)")
    if args.cached and not args.pcd_seq:
        ap.error("--cached requires --pcd-seq")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("aosx_torch.dashboard: no CUDA card is available; pass --device cpu "
                         "to run on the CPU")
    dev = torch.device(args.device)

    params = params_as_f32(AosParams() if args.params is None else params_get(args.params)[0],
                           dev)
    excl = torch.zeros((S.max_exclusions, 3), dtype=torch.float32, device=dev)

    def load_polygon():
        if args.polygon:
            with open(args.polygon) as f:
                return Polygon.from_array(np.asarray(json.load(f), np.float32), S, dev)
        return Polygon.from_array(np.zeros((0, 2), np.float32), S, dev)

    if args.pcd_seq:
        import glob

        if any(ch in args.pcd_seq for ch in "*?["):
            files = sorted(glob.glob(args.pcd_seq))
        else:
            files = [p for p in args.pcd_seq.split(",") if p]
        if not files:
            raise SystemExit(f"--pcd-seq matched no files: {args.pcd_seq}")
        bufs, valids = _pcd_buffers(files, S)
        frames = PointCloud(xyz=torch.from_numpy(bufs).to(dev),
                            valid=torch.from_numpy(valids).to(dev))
        poly = load_polygon()
        steps_per_frame = max(args.steps // len(files), 1)
        if args.serve:
            final, metrics, inc, levels = _serve_loop(frames, poly, params, excl, S,
                                                      steps_per_frame)
        else:
            replay = (incremental.replay_episode_incremental_cached if args.cached
                      else incremental.replay_episode_incremental)
            final, metrics, inc = replay(frames, poly, params, excl, S, steps_per_frame,
                                         ror_method="exact", return_inc=True)
            levels = [int(v) for v in _np(metrics.pop("inc_level"))]
            metrics = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in metrics.items()}
        # the replay's final IncrementalState holds the last frame's world
        world, perceive_out = inc.world, inc.out
        owner = engine.owner_plane(perceive_out, params, S) if args.cells else None
        report = episode_report(final, metrics, S)
        report["incremental_levels"] = levels
    else:
        if args.pcd:
            bufs, valids = _pcd_buffers([args.pcd], S)
            pc = PointCloud(xyz=torch.from_numpy(bufs[0]).to(dev),
                            valid=torch.from_numpy(valids[0]).to(dev))
            poly = load_polygon()
        else:
            spec = OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0))
            pc, poly = make_orchard(prng_key(args.seed, dev), spec, S)
        world, perceive_out, owner = engine.prepare_world_full(
            pc, poly, params, excl, S, ror_method="exact", with_owner=True)
        final, metrics = engine.episode(world, params, S, args.steps)
        report = episode_report(final, metrics, S)

    print(json.dumps(report, indent=2))
    os.makedirs(args.out, exist_ok=True)
    save_map(args.out, world, final)
    _save_figure(args.out, world, final, metrics, S, perceive_out, owner, args.cells)
    return report, final


if __name__ == "__main__":
    main()
