"""Full-size reference summary of the JAX package's live serving loop.

Runs ``aosx.serving.serve_init`` on the first frame and then, per frame,
``serving.serve_map_frame`` followed by 20 ``plancache.step_cached`` ticks at
``v_dt`` = 0.5 m/tick: the ``incremental.serve_frames`` composition that
``replay_episode_incremental_cached`` times, written out here only to pass
``v_dt`` (the JAX ``serve_frames`` ticks at step_cached's default 0.12). It
runs at BENCH_STATICS on the CPU with ``ror_method="pallas"``: the bench
orchard (``make_orchard_np(spec, seed=0)``, bench.py's OrchardSpec) shuffled
with ``np.random.default_rng(0)`` as ``tests/helpers.py::frames_growing``
does, revealed in the fractions 0.80, 0.85, 0.90, 0.95, 1.00, then 1.00
again (an empty delta: level 0), then 1.00 with one valid point moved by
1 cm (a broken append-only contract: level 3, a from-scratch rebuild).

``points.ror_counts(method="pallas")`` imports the Pallas ROR kernel at call
time, so this script swaps ``aosx.perceive.ror_pallas.ror_counts_pallas`` for
its interpret-mode form before tracing; no file of the package changes. The
flood runs in BENCH_STATICS' own lowering, the Pallas JFA pass for steps <=
128 in interpret mode (``aosx.gvd.jfa_pass_pallas.INTERPRET``, set for the
whole run), as in ``make_bench_reference.py``.

Writes ``serving_np_seed0.json`` beside this file (per-frame levels, world
counts, skeleton sha256, plan-cache row success/counts, adopted rows and
every tick metric) and ``serving_np_seed0_frame0.npz`` (frame 0's ROR counts,
valid mask and Voronoi owner plane, and the raw A* path of every plan-cache
row of frame 0's world: ``build_plan_cache`` run once more with
``linearize`` swapped for a pad, checked by linearizing those paths again).
``chip_smoke.py`` phase 7 holds the PyTorch port on the GPU to this summary.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference/make_serving_reference.py
"""

from __future__ import annotations

import functools
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

from aosx import serving  # noqa: E402
from aosx.config import BENCH_STATICS, AosParams, params_as_f32  # noqa: E402
from aosx.gvd import jfa_pass_pallas  # noqa: E402
from aosx.gvd.graph import merge_seeds  # noqa: E402
from aosx.gvd.voronoi import jump_flood  # noqa: E402
from aosx.orchards import OrchardSpec, make_orchard_np  # noqa: E402
from aosx.perceive import ror_pallas  # noqa: E402
from aosx.plan import plancache  # noqa: E402
from aosx.plan.linearize import linearize  # noqa: E402
from aosx.types import Path, PointCloud, Polygon  # noqa: E402

BENCH_SPEC = json.loads((pathlib.Path(__file__).resolve().parent
                         / "bench_np_seed0.json").read_text())["spec"]
FRACS = (0.80, 0.85, 0.90, 0.95, 1.00, 1.00, 1.00)
MOVED_FRAME = 6          # this frame moves one valid point by MOVE_M in x
MOVED_POINT = 0
MOVE_M = 0.01
TICKS = 20
V_DT = 0.5
OUT = pathlib.Path(__file__).resolve().parent / "serving_np_seed0.json"
NPZ_OUT = OUT.with_name("serving_np_seed0_frame0.npz")


def frames(n_points_out=None):
    """(bufs [F, N, 3] f32, valids [F, N] bool, polygon, cloud size)."""
    s = BENCH_STATICS
    xyz, poly = make_orchard_np(OrchardSpec(**BENCH_SPEC), seed=0)
    xyz = xyz[np.random.default_rng(0).permutation(len(xyz))]
    bufs = np.zeros((len(FRACS), s.max_points, 3), np.float32)
    valids = np.zeros((len(FRACS), s.max_points), bool)
    for f, frac in enumerate(FRACS):
        n = int(len(xyz) * frac)
        bufs[f, :n] = xyz[:n]
        valids[f, :n] = True
    bufs[MOVED_FRAME, MOVED_POINT, 0] += np.float32(MOVE_M)
    return bufs, valids, poly, len(xyz)


def raw_as_plan(raw, params, s):
    """Stand-in for linearize inside build_plan_cache: the raw path itself,
    zero-padded to max_plan points."""
    pad = s.max_plan - raw.xy.shape[0]
    return Path(xy=jnp.pad(raw.xy, ((0, pad), (0, 0))), yaw=jnp.pad(raw.yaw, (0, pad)),
                count=raw.count)


def raw_rows(world, params, s):
    """(raw xy [R, max_path, 2], raw count [R]) of every plan-cache row:
    aosx.plan.plancache.build_plan_cache with linearize swapped for a pad.
    The params are an argument of the jit, as serve_init receives them: a
    closed-over num0 would be folded into the A* arithmetic."""
    plancache.linearize = raw_as_plan
    try:
        cache = jax.jit(lambda w, p: plancache.build_plan_cache(w, p, s))(world, params)
    finally:
        plancache.linearize = linearize
    return np.asarray(cache.plan_xy[:, :s.max_path]), np.asarray(cache.plan_count)


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def main():
    s = BENCH_STATICS
    ror_pallas.ror_counts_pallas = functools.partial(ror_pallas.ror_counts_pallas,
                                                     interpret=True)
    bufs, valids, poly, n_cloud = frames()
    polygon = Polygon.from_array(poly, s)
    params = params_as_f32(AosParams())
    excl = jnp.zeros((s.max_exclusions, 3), jnp.float32)

    @jax.jit
    def init(pc):
        sv = serving.serve_init(pc, polygon, params, excl, s, ror_method="pallas")
        owner = jump_flood(sv.inc.out.skeleton, merge_seeds(sv.inc.out.seeds, params, s), s)
        return sv, owner

    @jax.jit
    def serve(sv, fr):
        def frame_body(sv, pc_f):
            sv, level = serving.serve_map_frame(sv, pc_f, polygon, params, excl, s,
                                                ror_method="pallas")
            out, world = sv.inc.out, sv.inc.world
            extras = dict(
                level=level, adopted_at_frame=sv.st.adopted,
                seeds=jnp.sum(out.seeds.valid.astype(jnp.int32)),
                rows=jnp.sum(out.rows.valid.astype(jnp.int32)),
                nodes=world.graph.num_nodes, edges=world.graph.num_edges,
                waypoints=world.waypoints.count, tour=sv.st.wp.count,
                world_guards=world.guards, skeleton=out.skeleton.occ,
                cache_success=sv.cache.success, cache_count=sv.cache.plan_count)

            def tick(st, _):
                return plancache.step_cached(st, sv.lite, sv.cache, params, s,
                                             v_dt=jnp.float32(V_DT))

            st, metrics = jax.lax.scan(tick, sv.st, None, length=TICKS)
            metrics["adopted"] = jnp.broadcast_to(st.adopted, (TICKS,))
            return serving.ServeState(inc=sv.inc, cache=sv.cache, st=st,
                                      lite=sv.lite), (metrics, extras)

        return jax.lax.scan(frame_body, sv, fr)

    t0 = time.time()
    pc0 = PointCloud(xyz=jnp.asarray(bufs[0]), valid=jnp.asarray(valids[0]))
    sv0, owner = jax.block_until_ready(init(pc0))
    t1 = time.time()
    fr = PointCloud(xyz=jnp.asarray(bufs), valid=jnp.asarray(valids))
    sv, (metrics, extras) = jax.block_until_ready(serve(sv0, fr))
    t2 = time.time()
    raw_xy, raw_count = raw_rows(sv0.inc.world, params, s)
    relin = jax.jit(lambda xy, c: jax.lax.map(
        lambda r: linearize(Path(xy=r[0], yaw=jnp.zeros(s.max_path), count=r[1]),
                            params, s).count, (xy, c)))(raw_xy, raw_count)
    # serve_init's cache holds one more row, the carry row
    if not np.array_equal(np.asarray(relin), np.asarray(sv0.cache.plan_count)[:len(relin)]):
        raise SystemExit("the raw paths do not linearize to frame 0's plan cache")

    inc0 = sv0.inc
    per_frame = []
    for f in range(len(FRACS)):
        e = {k: np.asarray(v[f]) for k, v in extras.items()}
        per_frame.append(dict(
            level=int(e["level"]), adopted_at_frame=int(e["adopted_at_frame"]),
            seeds=int(e["seeds"]), rows=int(e["rows"]), nodes=int(e["nodes"]),
            edges=int(e["edges"]), waypoints=int(e["waypoints"]), tour=int(e["tour"]),
            world_guards=int(e["world_guards"]),
            skeleton_sha256=sha256(e["skeleton"]),
            cache_success=[bool(x) for x in e["cache_success"]],
            cache_count=[int(x) for x in e["cache_count"]],
            metrics={k: np.asarray(v[f]).tolist() for k, v in metrics.items()}))
    summary = dict(
        source="aosx serving.serve_init + serve_map_frame + 20 step_cached ticks per frame "
               "(v_dt 0.5) at BENCH_STATICS (the Pallas JFA pass in interpret mode for "
               "steps <= 128), "
               "ror_method='pallas' (K3 in interpret mode), JAX on the CPU",
        spec=BENCH_SPEC, seed=0, n_points=n_cloud, fracs=list(FRACS),
        moved=dict(frame=MOVED_FRAME, point=MOVED_POINT, dx_m=MOVE_M),
        ticks=TICKS, v_dt=V_DT,
        init=dict(
            seeds=int(np.asarray(inc0.out.seeds.valid).sum()),
            rows=int(np.asarray(inc0.out.rows.valid).sum()),
            nodes=int(inc0.world.graph.num_nodes), edges=int(inc0.world.graph.num_edges),
            waypoints=int(inc0.world.waypoints.count), world_guards=int(inc0.world.guards),
            keep=int(np.asarray(inc0.keep).sum()),
            skeleton_sha256=sha256(inc0.out.skeleton.occ),
            cache_success=[bool(x) for x in np.asarray(sv0.cache.success)],
            cache_count=[int(x) for x in np.asarray(sv0.cache.plan_count)],
            adopted=int(sv0.st.adopted)),
        frames=per_frame,
        jax_cpu_seconds=dict(serve_init=round(t1 - t0, 1), frames=round(t2 - t1, 1)),
    )
    OUT.write_text(json.dumps(summary) + "\n")
    np.savez_compressed(NPZ_OUT, cnt=np.asarray(inc0.cnt), valid=np.asarray(inc0.valid),
                        owner=np.asarray(owner).astype("<i4"), raw_xy=raw_xy,
                        raw_count=raw_count)
    print(json.dumps(dict(levels=[p["level"] for p in per_frame],
                          nodes=[p["nodes"] for p in per_frame],
                          seconds=summary["jax_cpu_seconds"])))


if __name__ == "__main__":
    jfa_pass_pallas.INTERPRET = True
    main()
