"""Monte-Carlo planner evaluation over many orchards (mirror of
``aosx/parallel/batch.py``): one-shot rollouts, chunked rollouts with an
in-loop summary accumulator, plan-cached rollouts, and the sustained
lane-refill harness.

What differs from the JAX package, and why:

- **Clouds, not keys.** ``aosx`` draws each orchard from ``jax.random``
  inside the rollout; its normals go through XLA's erf_inv and cannot be
  reproduced bit for bit here. Where ``aosx`` takes ``key``/``keys``/``seed``
  the port takes a cloud ``(xyz float32 [n, 3], polygon [4, 2])`` or, in the
  harness, ``clouds``: a callable rollout id -> cloud (default
  ``make_orchard_np(spec, seed=seed + id)``). Parity tests hand both
  packages the same clouds.
- **Lanes.** ``aosx`` vmaps begin/chunk/finish over lanes. Here ``begin``
  builds the worlds of a group one after the other (the world build's loops
  are data-dependent) and stacks them on a leading lane axis; the full World
  of a cached lane is dropped right after its plan cache is built. The
  cached chunk is lane-batched: ``chunk_steps`` calls of
  ``plancache.step_cached`` on [L, ...] leaves. The uncached chunk
  (``engine.step``: per-tick A* and linearize loops that end on the data)
  runs its lanes one after the other; it is right and slow.
- **No compile, no warm-up.** There is nothing to trace, so the harness
  times from its first chunk call. ``width_valve``, ``host_jit`` and the
  sync-debug switch guard against faults of the TPU toolchain and have no
  counterpart; ``sharded_rollouts`` and ``mesh=`` are not ported (one card
  has nothing to shard over).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import engine, tree
from ..config import AosParams, Statics
from ..convert import to_numpy
from ..orchards import OrchardSpec, make_orchard_np
from ..plan import plancache
from ..types import PointCloud, Polygon


def default_device() -> torch.device:
    """The card. Entry points run there unless the caller passes a device."""
    return torch.device("cuda", 0)


def cloud_tensors(cloud, s: Statics, device):
    """(PointCloud padded to s.max_points, Polygon) on ``device`` from a
    cloud (xyz [n, 3], polygon [k, 2])."""
    xyz, poly = cloud
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    assert n <= s.max_points, (n, s.max_points)
    buf = np.zeros((s.max_points, 3), np.float32)
    buf[:n] = xyz
    valid = np.zeros(s.max_points, bool)
    valid[:n] = True
    pc = PointCloud(xyz=torch.from_numpy(buf).to(device), valid=torch.from_numpy(valid).to(device))
    return pc, Polygon.from_array(poly, s, device)


def _world(cloud, params: AosParams, s: Statics, ror_method: str, device):
    pc, poly = cloud_tensors(cloud, s, device)
    excl = torch.zeros((s.max_exclusions, 3), dtype=torch.float32, device=device)
    return engine.prepare_world(pc, poly, params, excl, s, ror_method=ror_method)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _norm(xy):
    return torch.sqrt(xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1])


def _invalidate_flagged(summary, s: Statics):
    """With exact_fallbacks=False the overflow-correcting fallbacks are
    skipped, so a guard-flagged lane may carry degraded results: force it to
    completed=False / final_status=Failed(1) so no aggregate can count it.
    Exact mode keeps guards informational."""
    if s.exact_fallbacks:
        return summary
    ok = summary["guards"] == 0
    out = dict(summary)
    out["completed"] = summary["completed"] & ok
    out["final_status"] = torch.where(ok, summary["final_status"], 1).to(torch.int32)
    return out


def rollout_summary(final, metrics, s: Statics):
    """Small per-orchard result from an episode's stacked per-step metrics."""
    done = metrics["completed"]
    n = done.shape[0]
    dev = done.device
    first_done = torch.where(done, torch.arange(n, device=dev), n).min().to(torch.int32)
    seg = metrics["xy"][1:] - metrics["xy"][:-1]
    # bitwise OR over the steps, bit by bit
    bit = torch.arange(31, dtype=torch.int32, device=dev)
    guards = ((((metrics["guards"][:, None] >> bit) & 1) != 0).any(dim=0).to(torch.int32)
              << bit).sum(dtype=torch.int32)
    return _invalidate_flagged(dict(
        completed=final.mission.exploration_completed,
        steps_to_complete=first_done,
        final_status=metrics["status"][-1],
        travel_distance=_norm(seg).sum(),
        final_dist_to_origin=_norm(final.robot.xy),
        waypoints=final.wp.count,
        guards=guards,
        feasible=_i32(-1, dev),  # one-shot path: not classified
    ), s)


def rollout_one(cloud, params: AosParams, s: Statics, n_steps: int,
                ror_method: str = "sorted", v_dt=None, device=None):
    """One orchard: perceive -> GVD -> closed loop of n_steps ticks. v_dt:
    per-tick travel of the stand-in robot (engine.episode's default 0.12)."""
    device = default_device() if device is None else device
    world = _world(cloud, params, s, ror_method, device)
    kw = {} if v_dt is None else {"v_dt": v_dt}
    final, metrics = engine.episode(world, params, s, n_steps, **kw)
    return rollout_summary(final, metrics, s)


def batched_rollouts(clouds, params, s, n_steps, ror_method="sorted", v_dt=None, device=None):
    """rollout_one over a sequence of clouds, one after the other; every
    field gains a leading axis."""
    return tree.stack([rollout_one(c, params, s, n_steps, ror_method, v_dt, device)
                       for c in clouds])


# ---------------------------------------------------------------------------
# chunked rollouts: the episode split into step chunks, the summary folded
# into an accumulator so that nothing is stacked per step
# ---------------------------------------------------------------------------


def _acc_init(s: Statics, n_steps_total: int, device):
    return dict(
        first_done=_i32(n_steps_total, device),
        travel=torch.zeros((), dtype=torch.float32, device=device),
        last_xy=torch.zeros(2, dtype=torch.float32, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        last_status=_i32(0, device),
        guards=_i32(0, device),
        # -1 not classified, 0 infeasible (stalls under the reference's own
        # semantics), 1 feasible (plancache.tour_feasibility)
        feasible=_i32(-1, device),
    )


def _fold(acc, m, tick):
    """One tick's metrics folded into the accumulator; ``tick`` is the
    tick's index in its episode (i32, per lane). travel adds one segment a
    tick, sequentially, in f32."""
    xy = m["xy"]
    seg = _norm(xy - acc["last_xy"])
    return dict(
        first_done=torch.minimum(acc["first_done"],
                                 torch.where(m["completed"], tick, acc["first_done"])),
        travel=acc["travel"] + torch.where(acc["has_prev"], seg, 0.0),
        last_xy=xy,
        has_prev=torch.ones_like(acc["has_prev"]),
        last_status=m["status"],
        guards=acc["guards"] | m["guards"],
        feasible=acc["feasible"],
    )


def rollout_begin(cloud, params: AosParams, s: Statics, n_steps_total: int,
                  ror_method: str = "sorted", classify: bool = False, device=None):
    """World + initial state + summary accumulator for one orchard.
    classify=True also builds the plan cache for its tour_feasibility."""
    device = default_device() if device is None else device
    world = _world(cloud, params, s, ror_method, device)
    acc = _acc_init(s, n_steps_total, device)
    if classify:
        cache = plancache.build_plan_cache(world, params, s)
        feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
        acc["feasible"] = feas["feasible"].to(torch.int32)
    return world, engine.initial_state(world, s), acc


def rollout_chunk(world, st, acc, params, s: Statics, n: int, offset):
    """Advance one rollout (no lane axis) by n control ticks of engine.step,
    folding first completion step, sequential travel and last status into
    the accumulator."""
    offset = torch.as_tensor(offset, dtype=torch.int32, device=st.t.device)
    for i in range(n):
        st, m = engine.step(st, world, params, s)
        acc = _fold(acc, m, offset + i)
    return st, acc


def rollout_finish(st, acc, s: Statics):
    """rollout_summary's fields from a final state and its accumulator, with
    or without a lane axis (travel is accumulated sequentially, so it can
    differ from rollout_summary's stacked sum by rounding)."""
    return _invalidate_flagged(dict(
        completed=st.mission.exploration_completed,
        steps_to_complete=acc["first_done"],
        final_status=acc["last_status"],
        travel_distance=acc["travel"],
        final_dist_to_origin=_norm(st.robot.xy),
        waypoints=st.wp.count,
        guards=acc["guards"],
        feasible=acc["feasible"],
    ), s)


# ---------------------------------------------------------------------------
# plan-cached rollouts: the per-tick A* + linearization are precomputed once
# per world in begin; the chunk carries only (WorldLite, PlanCache, state)
# ---------------------------------------------------------------------------


def rollout_begin_cached(cloud, params: AosParams, s: Statics, n_steps_total: int,
                         ror_method: str = "sorted", device=None):
    """rollout_begin + plan-cache build; returns (lite, cache, state, acc).
    The full World is a temporary of this function. The feasibility class is
    free here (a few reductions over the cache)."""
    device = default_device() if device is None else device
    world = _world(cloud, params, s, ror_method, device)
    cache = plancache.build_plan_cache(world, params, s)
    acc = _acc_init(s, n_steps_total, device)
    feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
    acc["feasible"] = feas["feasible"].to(torch.int32)
    # step_cached never reads the per-point yaw rows (a serving payload)
    cache = dataclasses.replace(cache, plan_yaw=cache.plan_yaw[:, :0])
    return plancache.world_lite(world), cache, plancache.initial_cached_state(world, s), acc


def rollout_chunk_cached(lite, cache, st, acc, params, s: Statics, n: int, offset):
    """rollout_chunk through plancache.step_cached. Every leaf may carry a
    leading lane axis [L] (offset then [L] too, each lane's age)."""
    offset = torch.as_tensor(offset, dtype=torch.int32, device=st.t.device)
    for i in range(n):
        st, m = plancache.step_cached(st, lite, cache, params, s)
        acc = _fold(acc, m, offset + i)
    return st, acc


# ---------------------------------------------------------------------------
# sustained rollouts: lane refill at chunk boundaries. A fixed batch of lanes
# is kept full from a host-side queue: at every chunk boundary finished lanes
# (completed or out of budget) are recorded and overwritten with freshly
# built worlds in fixed-size groups. Every started rollout is recorded
# exactly once.
# ---------------------------------------------------------------------------


def sustained_rollouts(total: int, batch: int, spec: OrchardSpec, params: AosParams,
                       s: Statics, steps_budget: int, *, chunk_steps: int = 150,
                       refill: int | None = None, seed: int = 0,
                       ror_method: str = "sorted", cached: bool = False, on_progress=None,
                       params_queue: AosParams | None = None, clouds=None,
                       classify: bool | None = None, device=None):
    """Run ``total`` full rollouts through ``batch`` lanes with refill.

    Returns (results, stats): ``results`` is a dict of numpy arrays indexed
    by rollout id (rollout_finish's fields); ``stats`` has elapsed_s (from
    the first chunk call), chunk_calls, begin_calls and rollouts_per_sec,
    and also begin_s and chunk_s, the host seconds spent in each (begin_s
    includes the initial fill, which elapsed_s does not). A lane is retired
    at the first chunk boundary at or after completion; post-completion ticks
    are no-ops for every summary field, so a retired lane's record equals
    the fixed-budget rollout's. ``refill`` is the lane-group size of world
    rebuilds.

    ``clouds``: rollout id -> (xyz [n, 3], polygon [k, 2]); default
    ``make_orchard_np(spec, seed=seed + id)``. ``params_queue``: an AosParams
    whose leaves carry a leading [total] axis; rollout id i runs with row i
    (``params`` is then ignored). ``classify``: compute ``feasible``
    (default: True when cached, where it is free; False when uncached, where
    it costs a plan-cache build per world)."""
    device = default_device() if device is None else device
    if classify is None:
        classify = cached
    refill = refill or max(1, min(batch // 2, 64))
    assert total >= batch, (total, batch)
    # every queued rollout must eventually start: refill groups are fixed-size
    assert (total - batch) % refill == 0, (total, batch, refill)
    # lanes retire only at chunk boundaries; a non-divisible budget would let
    # lanes overrun it
    assert steps_budget % chunk_steps == 0, (steps_budget, chunk_steps)
    assert batch % refill == 0, (batch, refill)
    if clouds is None:
        def clouds(i):
            return make_orchard_np(spec, seed=seed + i)

    swept = params_queue is not None
    if swept:
        qlen = tree.leaves(params_queue)[0].shape[0]
        assert qlen == total, (qlen, total)

    def _q(lo, hi):
        """Params rows of rollout ids [lo, hi): queue rows if swept."""
        return tree.lane(params_queue, slice(lo, hi)) if swept else params

    def begin(lo, hi):
        """Lane-stacked (world, state, acc) of rollout ids [lo, hi), built
        one after the other."""
        group = []
        for i in range(lo, hi):
            p = tree.lane(params_queue, i) if swept else params
            if cached:
                lite, cache, st, acc = rollout_begin_cached(
                    clouds(i), p, s, steps_budget, ror_method=ror_method, device=device)
                group.append(((lite, cache), st, acc))
            else:
                group.append(rollout_begin(clouds(i), p, s, steps_budget,
                                           ror_method=ror_method, classify=classify,
                                           device=device))
        return tree.stack(group)

    def chunk(world_b, st_b, acc_b, ages, params_b):
        off = torch.from_numpy(ages).to(device)
        if cached:
            return rollout_chunk_cached(world_b[0], world_b[1], st_b, acc_b, params_b, s,
                                        chunk_steps, off)
        out = []
        for ln in range(batch):
            w, st, acc = tree.lane((world_b, st_b, acc_b), ln)
            p = tree.lane(params_b, ln) if swept else params
            out.append(rollout_chunk(w, st, acc, p, s, chunk_steps, off[ln]))
        return tree.stack(out)

    results: dict[str, list] = {}
    recorded = np.zeros(batch, bool)        # lane's current rollout recorded?
    ages = np.zeros(batch, np.int32)        # control ticks run by lane's rollout
    rid = np.arange(batch, dtype=np.int64)  # lane -> rollout id
    n_recorded = 0
    next_id = batch
    n_chunk_calls = 0
    n_begin_calls = 0
    begin_s = chunk_s = 0.0

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        # initial fill, in refill-sized groups
        t_fill = time.perf_counter()
        parts = [begin(i, i + refill) for i in range(0, batch, refill)]
        n_begin_calls += len(parts)
        world_b, st_b, acc_b = tree.cat(parts)
        # per-lane params (only when swept), scattered alongside the lane
        # state at refill so that a lane's chunk runs its rollout's own row
        params_b = _q(0, batch)
        _sync()
        begin_s += time.perf_counter() - t_fill

        t0 = time.perf_counter()
        while n_recorded < total:
            tc = time.perf_counter()
            st_b, acc_b = chunk(world_b, st_b, acc_b, ages, params_b)
            comp = st_b.mission.exploration_completed.cpu().numpy()
            chunk_s += time.perf_counter() - tc
            n_chunk_calls += 1
            ages += chunk_steps
            finished = (comp | (ages >= steps_budget)) & ~recorded
            if finished.any():
                summ = to_numpy(rollout_finish(st_b, acc_b, s))
                for ln in np.nonzero(finished)[0]:
                    for k, v in summ.items():
                        results.setdefault(k, [None] * total)[rid[ln]] = v[ln]
                    recorded[ln] = True
                    n_recorded += 1
            # refill retired lanes in fixed-size groups while work remains
            while recorded.sum() >= refill and next_id + refill <= total:
                idx = np.nonzero(recorded)[0][:refill]
                tb = time.perf_counter()
                new = begin(next_id, next_id + refill)
                n_begin_calls += 1
                idx_dev = torch.from_numpy(idx).to(device)
                world_b, st_b, acc_b = tree.scatter((world_b, st_b, acc_b), idx_dev, new)
                if swept:
                    params_b = tree.scatter(params_b, idx_dev, _q(next_id, next_id + refill))
                _sync()
                begin_s += time.perf_counter() - tb
                ages[idx] = 0
                recorded[idx] = False
                rid[idx] = np.arange(next_id, next_id + refill)
                next_id += refill
            if on_progress is not None:
                on_progress(n_recorded, total, time.perf_counter() - t0)
        elapsed = time.perf_counter() - t0

    results_np = {k: np.stack(v) for k, v in results.items()}
    stats = dict(
        elapsed_s=elapsed,
        chunk_calls=n_chunk_calls,
        begin_calls=n_begin_calls,
        rollouts_per_sec=total / elapsed,
        begin_s=begin_s,
        chunk_s=chunk_s,
    )
    return results_np, stats
