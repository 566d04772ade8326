"""Monte-Carlo planner evaluation over many orchards (mirror of
``aosx/parallel/batch.py``): one-shot rollouts, chunked rollouts with an
in-loop summary accumulator, plan-cached rollouts, the sustained lane-refill
harness, and rollouts whose lanes are split over the devices of a mesh.

What differs from the JAX package, and why:

- **Keys, as in ``aosx``.** Rollout id ``i`` runs
  ``orchards.make_orchard(keys[i], spec, s, device)``, with ``aosx``'s
  default ``keys = prng.split(prng.prng_key(seed), total)``: the port draws
  the JAX package's clouds bit for bit (``prng``, ``f32math``), so the same
  call evaluates the same worlds in both packages. The harness also takes
  ``clouds``, a callable rollout id -> cloud ``(xyz float32 [n, 3],
  polygon [k, 2])``, in place of the keys.
- **Lanes.** ``aosx`` vmaps begin/chunk/finish over lanes; here they run
  as one batched call over a leading lane axis. A group's ``begin``
  (``_begin_group``, ``rollout_begin_group``, the uncached ``_begin``)
  draws its orchards from the group's keys in one ``make_orchard``, builds
  its worlds in one ``engine.prepare_world`` (K1, K2 and K3 launched once a
  group; every loop that ends on the data runs while any world is active,
  each world masked with its own condition), then, when cached, the
  group's plan caches in one ``build_plan_cache`` over worlds x rows x A*
  candidates; the full Worlds are dropped right after. The chunk is
  lane-batched too: ``chunk_steps`` calls of ``plancache.step_cached``
  (cached) or of the lane-aware ``engine.step`` (uncached) on [L, ...]
  leaves, rounded as XLA:CPU compiles ``aosx``'s chunk under ``jax.vmap``
  over the L lanes (``engine.vmap_forms``): a record has the bits of
  ``aosx``'s harness at that lane count (a block's, with a mesh), which
  one rollout alone (a scan) can miss by an ulp. On the card the cached
  chunk's ticks are replays of one CUDA graph of the whole tick
  (``rollout_chunk_cached``), the same kernels in the same order.
  ``batched_rollouts``
  begins all its keys in one call and runs one lane-aware episode.
  ``looped_worlds`` builds a group one world at a time through unbatched
  calls: the reference the tests and the smoke run hold the batched build
  against, not a path of the harness.
- **Meshes.** ``sharded_rollouts`` and ``sustained_rollouts(mesh=)`` split
  the lanes into one block per device of a ``parallel.spatial.Mesh``; block
  ``k`` is built, stepped and read on ``mesh.devices[k]``. Lanes are
  independent, so every lane's record is bitwise the one of ``mesh=None``.
- **No compile, no warm-up.** There is nothing to trace, so the harness
  times from its first chunk call; on the card that call also captures
  its tick's CUDA graph (one tick run and one capture, once a shape).
  ``width_valve``, ``host_jit`` and the
  sync-debug switch guard against faults of the TPU toolchain and have no
  counterpart.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import engine, prng, profiling, tree
from ..config import AosParams, Statics
from ..convert import to_numpy
from ..ops import (capture_graph, copy_leaves, norm2, norm2_lanes, sum_xla,
                   vector_lanes)
from ..orchards import OrchardSpec, make_orchard
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


def to_device(t, device):
    """Every tensor leaf of ``t`` on ``device`` (other leaves as they are)."""
    return tree.tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x, t)


def _world(orchard, params: AosParams, s: Statics, ror_method: str):
    """The World of an orchard (PointCloud, Polygon), on the orchard's device."""
    pc, poly = orchard
    excl = torch.zeros((s.max_exclusions, 3), dtype=torch.float32, device=pc.xyz.device)
    return engine.prepare_world(pc, poly, params, excl, s, ror_method=ror_method)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


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
    """Small per-orchard result from an episode's stacked per-step metrics
    ([n_steps, *B, ...] for lanes B). travel sums a lane's segments in
    XLA:CPU's order for ``jnp.sum`` (``ops.sum_xla``), so a lane's record
    is the reference's bits, alone or beside others, on every device."""
    done = metrics["completed"]
    n = done.shape[0]
    dev = done.device
    steps = torch.arange(n, device=dev).reshape((n,) + (1,) * (done.dim() - 1))
    first_done = torch.where(done, steps, n).min(dim=0).values.to(torch.int32)
    seg = metrics["xy"][1:] - metrics["xy"][:-1]
    # bitwise OR over the steps, bit by bit
    bit = torch.arange(31, dtype=torch.int32, device=dev)
    guards = ((((metrics["guards"][..., None] >> bit) & 1) != 0).any(dim=0).to(torch.int32)
              << bit).sum(dim=-1, dtype=torch.int32)
    return _invalidate_flagged(dict(
        completed=final.mission.exploration_completed,
        steps_to_complete=first_done,
        final_status=metrics["status"][-1],
        travel_distance=sum_xla(norm2(seg).movedim(0, -1)),
        final_dist_to_origin=norm2(final.robot.xy),
        waypoints=final.wp.count,
        guards=guards,
        feasible=torch.full(done.shape[1:], -1, dtype=torch.int32, device=dev),
    ), s)


def rollout_one(key, spec: OrchardSpec, params: AosParams, s: Statics, n_steps: int,
                ror_method: str = "sorted", v_dt=None, device=None):
    """One procedural orchard drawn from ``key``: generate -> perceive -> GVD
    -> closed loop of n_steps ticks; keys [B, 2] run B of them as lanes of
    one call. v_dt: per-tick travel of the stand-in robot (engine.episode's
    default 0.12)."""
    device = default_device() if device is None else device
    world = _world(make_orchard(key, spec, s, device), params, s, ror_method)
    kw = {} if v_dt is None else {"v_dt": v_dt}
    final, metrics = engine.episode(world, params, s, n_steps, **kw)
    return rollout_summary(final, metrics, s)


def batched_rollouts(keys, spec, params, s, n_steps, ror_method="sorted", v_dt=None,
                     device=None):
    """rollout_one over keys [B, 2] as one batched call (the orchards, the
    worlds, and one lane-aware episode); every field gains a leading axis,
    each lane bitwise the key's rollout alone."""
    return rollout_one(torch.as_tensor(keys, dtype=torch.int64), spec, params, s, n_steps,
                       ror_method, v_dt, device)


def sharded_rollouts(keys, spec, params, s, n_steps, mesh, ror_method="sorted"):
    """The keys split into one block per device of ``mesh`` (a
    ``parallel.spatial.Mesh``), each block's rollouts run on its device.
    Returns (out, total_done): every field of all blocks joined on
    ``mesh.devices[0]``, and the completed count summed over the blocks."""
    n = len(mesh.devices)
    assert keys.shape[0] % n == 0, (keys.shape, n)
    per = keys.shape[0] // n
    outs = [to_device(batched_rollouts(keys[k * per:(k + 1) * per], spec,
                                       to_device(params, dev), s, n_steps, ror_method,
                                       device=dev), mesh.devices[0])
            for k, dev in enumerate(mesh.devices)]
    total_done = torch.stack([o["completed"].to(torch.int32).sum(dtype=torch.int32)
                              for o in outs]).sum(dtype=torch.int32)
    return tree.cat(outs), total_done


# ---------------------------------------------------------------------------
# chunked rollouts: the episode split into step chunks, the summary folded
# into an accumulator so that nothing is stacked per step
# ---------------------------------------------------------------------------


def _acc_init(s: Statics, n_steps_total: int, device, lanes_=()):
    def full(shape, v, dtype):
        return torch.full(lanes_ + shape, v, dtype=dtype, device=device)

    return dict(
        first_done=full((), n_steps_total, torch.int32),
        travel=full((), 0.0, torch.float32),
        last_xy=full((2,), 0.0, torch.float32),
        has_prev=full((), False, torch.bool),
        last_status=full((), 0, torch.int32),
        guards=full((), 0, torch.int32),
        # -1 not classified, 0 infeasible (stalls under the reference's own
        # semantics), 1 feasible (plancache.tour_feasibility)
        feasible=full((), -1, torch.int32),
    )


def _fold(acc, m, tick, vmap_lanes: int = 0):
    """One tick's metrics folded into the accumulator; ``tick`` is the
    tick's index in its episode (i32, per lane). travel adds one segment a
    tick, sequentially, in f32; under vmap over L >= 2 lanes XLA:CPU
    computes the segment of the leading ``ops.vector_lanes(L, "travel")``
    lanes unfused."""
    xy = m["xy"]
    seg = (norm2(xy - acc["last_xy"]) if vmap_lanes < 2
           else norm2_lanes(xy - acc["last_xy"], vector_lanes(vmap_lanes, "travel")))
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


def _begin(orchard, params: AosParams, s: Statics, n_steps_total: int, ror_method: str,
           classify: bool):
    """(world, state, acc) of an orchard, or of a group of orchards with a
    leading [G] axis on every leaf, built in one call."""
    world = _world(orchard, params, s, ror_method)
    acc = _acc_init(s, n_steps_total, orchard[0].xyz.device, orchard[0].xyz.shape[:-2])
    if classify:
        cache = plancache.build_plan_cache(world, params, s)
        feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
        acc["feasible"] = feas["feasible"].to(torch.int32)
    return world, engine.initial_state(world, s), acc


def rollout_begin(key, spec: OrchardSpec, params: AosParams, s: Statics, n_steps_total: int,
                  ror_method: str = "sorted", classify: bool = False, device=None):
    """World + initial state + summary accumulator for the orchard of
    ``key`` (or, for keys [G, 2], of the group in one call).
    classify=True also builds the plan cache for its tour_feasibility."""
    device = default_device() if device is None else device
    return _begin(make_orchard(key, spec, s, device), params, s, n_steps_total, ror_method,
                  classify)


def _lane_count(st):
    """L for a state with a leading lane axis [L], else 0: the lane count
    of the vmapped program whose rounding a chunk follows."""
    return st.t.shape[0] if st.t.dim() == 1 else 0


def rollout_chunk(world, st, acc, params, s: Statics, n: int, offset):
    """Advance rollouts by n control ticks of engine.step, folding first
    completion step, sequential travel and last status into the
    accumulator. Every leaf may carry a leading lane axis [L] (offset then
    [L] too, each lane's age); the lanes step together, rounded as
    ``aosx``'s harness rounds its chunk, ``jax.vmap`` over the L lanes
    (``engine.step``'s vmap_lanes)."""
    offset = torch.as_tensor(offset, dtype=torch.int32, device=st.t.device)
    vmap_lanes = _lane_count(st)
    for i in range(n):
        st, m = engine.step(st, world, params, s, vmap_lanes=vmap_lanes)
        acc = _fold(acc, m, offset + i, vmap_lanes)
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
        final_dist_to_origin=norm2(st.robot.xy),
        waypoints=st.wp.count,
        guards=acc["guards"],
        feasible=acc["feasible"],
    ), s)


# ---------------------------------------------------------------------------
# plan-cached rollouts: the per-tick A* + linearization are precomputed once
# per world in begin; the chunk carries only (WorldLite, PlanCache, state)
# ---------------------------------------------------------------------------


def looped_worlds(orchards, params: AosParams, s: Statics, ror_method: str,
                  lane_params: bool = False):
    """The worlds of a group of orchards built one at a time through
    unbatched ``prepare_world`` calls and stacked: what the batched build
    equals bit for bit. ``orchards`` is a list of single orchards. Used by
    the tests and the smoke run, never by the harness."""
    return tree.stack([_world(o, tree.lane(params, i) if lane_params else params, s, ror_method)
                       for i, o in enumerate(orchards)])


def _begin_group(orchard, params: AosParams, s: Statics, n_steps_total: int,
                 ror_method: str):
    """(lite, cache, state, acc) of a group of orchards (every leaf of
    ``orchard`` with a leading [G] axis), every leaf with the [G] axis: what
    ``jax.vmap(rollout_begin_cached)`` gives.

    One call builds the group: its worlds in one ``prepare_world`` (K1, K2
    and K3 launched once a group), its plan caches in one
    ``build_plan_cache`` (one batched plan_current_path and one linearize
    over worlds x rows x A* candidates) and one ``tour_feasibility``, its
    initial states and accumulators. ``params``: one AosParams for the
    group, or one whose leaves carry the [G] axis. The full Worlds are
    temporaries of this function. One ``begin`` span (``profiling``)."""
    with profiling.span("begin"):
        return _build_group(orchard, params, s, n_steps_total, ror_method)


def _build_group(orchard, params: AosParams, s: Statics, n_steps_total: int,
                 ror_method: str):
    """``_begin_group`` without its span, for a caller whose ``begin`` span
    also covers the orchards (``rollout_begin_group``)."""
    device = orchard[0].xyz.device
    G = orchard[0].xyz.shape[:-2]
    world = _world(orchard, params, s, ror_method)
    cache = plancache.build_plan_cache(world, params, s)
    feas = plancache.tour_feasibility(cache, world.waypoints, params, s)
    acc = _acc_init(s, n_steps_total, device, G)
    acc["feasible"] = feas["feasible"].to(torch.int32)
    # step_cached never reads the per-point yaw rows (a serving payload)
    cache = dataclasses.replace(cache, plan_yaw=cache.plan_yaw[..., :0])
    return (plancache.world_lite(world), cache, plancache.initial_cached_state(world, s), acc)


def _begin_cached(orchard, params: AosParams, s: Statics, n_steps_total: int,
                  ror_method: str):
    """The group begin of one orchard, without the group axis."""
    one = tree.tree_map(lambda x: x[None], orchard)
    return tree.lane(_begin_group(one, params, s, n_steps_total, ror_method), 0)


def rollout_begin_cached(key, spec: OrchardSpec, params: AosParams, s: Statics,
                         n_steps_total: int, ror_method: str = "sorted", device=None):
    """rollout_begin + plan-cache build; returns (lite, cache, state, acc).
    The full World is a temporary of this function. The feasibility class is
    free here (a few reductions over the cache). A group of one: see
    ``rollout_begin_group``."""
    device = default_device() if device is None else device
    return _begin_cached(make_orchard(key, spec, s, device), params, s, n_steps_total,
                         ror_method)


def rollout_begin_group(keys, spec: OrchardSpec, params: AosParams, s: Statics,
                        n_steps_total: int, ror_method: str = "sorted", device=None):
    """rollout_begin_cached over keys [G, 2] as one group (the refill group
    of ``sustained_rollouts``) in one call: every leaf gains a leading [G]
    axis, each lane bitwise the single key's begin."""
    device = default_device() if device is None else device
    with profiling.span("begin"):
        with profiling.span("begin.orchard"):
            orchard = make_orchard(torch.as_tensor(keys, dtype=torch.int64), spec, s, device)
        return _build_group(orchard, params, s, n_steps_total, ror_method)


def _tick(st, acc, tick, lite, cache, params, s: Statics, vmap_lanes: int):
    """One cached tick: ``plancache.step_cached``, its metrics folded into
    the accumulator at episode tick ``tick``. Returns (state, acc)."""
    st, m = plancache.step_cached(st, lite, cache, params, s, vmap_lanes=vmap_lanes)
    with profiling.span("tick.fold"):
        acc = _fold(acc, m, tick, vmap_lanes)
    return st, acc


def _tensors(t):
    """The tensor leaves of a tree, in the tree's order."""
    return [x for x in tree.leaves(t) if torch.is_tensor(x)]


def _rebuild(like, tensors):
    """The tree ``like`` with its tensor leaves replaced, in order, by
    ``tensors`` (its other leaves kept)."""
    it = iter(tensors)
    return tree.tree_map(lambda x: next(it) if torch.is_tensor(x) else x, like)


def tick_flat(carry, fixed, like, s: Statics, vmap_lanes: int):
    """The cached tick over flat tensors, in place. ``carry`` holds the
    tensor leaves of (state, acc, tick index) and ``fixed`` those of the
    read-only (lite, cache, params); ``like`` is a tree
    (state, acc, tick, lite, cache, params) of their structure, whose
    tensor leaves are not read. One ``_tick``; its new state and acc are
    then written into carry's tensors (one multi-tensor copy a dtype,
    ``ops.copy_leaves``) and the tick index is advanced by one. A leaf
    the tick passed through unchanged is not copied; a new leaf that
    shares memory with an input is cloned first, so that no copy reads
    what another writes. What a CUDA graph of the chunk captures
    (``rollout_chunk_cached``)."""
    st, acc, tick = _rebuild(like[:3], carry)
    st, acc = _tick(st, acc, tick, *_rebuild(like[3:], fixed), s, vmap_lanes)
    inputs = {x.untyped_storage().data_ptr() for x in carry + fixed if x.numel()}
    dst, src = [], []
    for d, x in zip(carry[:-1], _tensors((st, acc)), strict=True):
        if not x.numel() or (x.data_ptr() == d.data_ptr() and x.stride() == d.stride()):
            continue
        dst.append(d)
        src.append(x.clone() if x.untyped_storage().data_ptr() in inputs else x)
    copy_leaves(dst, src)
    tick.add_(1)


# the cached tick's CUDA graphs, one a key (``_graph_key``)
_TICK_GRAPHS: dict = {}


def _graph_key(like, s: Statics, vmap_lanes: int):
    """What a tick's graph is made for: the device, ``s``, the lanes, and
    the structure of ``like`` with every tensor leaf's shape and dtype and
    every other leaf's value."""
    sig = tree.tree_map(lambda x: ("tensor", tuple(x.shape), x.dtype) if torch.is_tensor(x)
                        else x, like)
    return (like[0].t.device, s, vmap_lanes, repr(sig))


def _graphable(like) -> bool:
    """Whether the cached ticks of ``like`` (tick_flat's tree) run as
    replays of one CUDA graph: every tensor on one card, and a lane axis on
    the state, so that every row select gathers by a lane index (a 0-d
    index reads it on the host, ``ops.take_row``)."""
    dev = like[0].t.device
    return (dev.type == "cuda" and _lane_count(like[0]) > 0
            and all(x.device == dev for x in _tensors(like)))


def _graphed_ticks(like, s: Statics, n: int, vmap_lanes: int):
    """n cached ticks of ``like`` (tick_flat's tree) as n replays of the
    CUDA graph of one ``tick_flat``, captured at the first call for each
    key (``_graph_key``). Every input is copied into the graph's own
    tensors at the call's start (nothing is captured by address); between
    replays the state stays there. Returns clones of the final (state,
    acc). One ``tick`` span a replay; ``tick.graphed`` and
    ``graph.replay`` count them."""
    key = _graph_key(like, s, vmap_lanes)
    entry = _TICK_GRAPHS.get(key)
    if entry is None:
        static = tree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, like)
        carry, fixed = _tensors(static[:3]), _tensors(static[3:])
        graph, _ = capture_graph(lambda: tick_flat(carry, fixed, static, s, vmap_lanes),
                                 like[0].t.device)
        entry = _TICK_GRAPHS[key] = (graph, carry, fixed)
    graph, carry, fixed = entry
    copy_leaves(carry + fixed, _tensors(like[:3]) + _tensors(like[3:]))
    for _ in range(n):
        with profiling.span("tick"):
            graph.replay()
    profiling.count("graph.replay", n)
    profiling.count("tick.graphed", n)
    return _rebuild(like[:2], [x.clone() for x in carry[:-1]])


def rollout_chunk_cached(lite, cache, st, acc, params, s: Statics, n: int, offset):
    """rollout_chunk through plancache.step_cached. Every leaf may carry a
    leading lane axis [L] (offset then [L] too, each lane's age), rounded
    as ``jax.vmap`` over the L lanes. A ``chunk`` span of ``tick`` spans
    (``profiling``).

    On the card, with a lane axis, the n ticks are n replays of one CUDA
    graph of the whole tick (``_graphed_ticks``): the same kernels, so the
    same bits, without the host launching each tick's hundreds of small
    operations one by one. Elsewhere (the CPU, one rollout without a lane
    axis) the ticks run as they are, each with its stage spans."""
    with profiling.span("chunk"):
        offset = torch.as_tensor(offset, dtype=torch.int32, device=st.t.device)
        vmap_lanes = _lane_count(st)
        like = (st, acc, offset, lite, cache, params)
        if _graphable(like):
            return _graphed_ticks(like, s, n, vmap_lanes)
        for i in range(n):
            with profiling.span("tick"):
                st, acc = _tick(st, acc, offset + i, lite, cache, params, s, vmap_lanes)
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
                       params_queue: AosParams | None = None, keys=None,
                       classify: bool | None = None, mesh=None, clouds=None, device=None):
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

    ``keys``: the per-rollout keys (int64 [total, 2]; default, as in
    ``aosx``, ``prng.split(prng.prng_key(seed), total)``); rollout id i runs
    ``make_orchard(keys[i], spec, s)``. ``clouds``, in place of the keys:
    rollout id -> (xyz [n, 3], polygon [k, 2]). ``params_queue``: an
    AosParams whose leaves carry a leading [total] axis; rollout id i runs
    with row i (``params`` is then ignored). ``classify``: compute
    ``feasible`` (default: True when cached, where it is free; False when
    uncached, where it costs a plan-cache build per world).

    ``mesh`` (a ``parallel.spatial.Mesh``): the lanes split into one block
    per device, lane ``ln`` in block ``ln // (batch / n_dev)``; a block's
    worlds are built, stepped and read on its device. The queue logic is the
    same and every record is bitwise the one of ``mesh=None``. batch must
    divide by the mesh's device count."""
    if mesh is not None:
        devices = tuple(mesh.devices)
        device = devices[0] if device is None else device
    else:
        device = default_device() if device is None else device
        devices = (device,)
    n_dev = len(devices)
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
    assert batch % n_dev == 0, (batch, n_dev)
    per = batch // n_dev
    if clouds is None:
        if keys is None:
            keys = prng.split(prng.prng_key(seed, torch.device("cpu")), total)
        keys = torch.as_tensor(keys, dtype=torch.int64)
        assert keys.shape[0] == total, (keys.shape, total)

        def orchards(ids, dev):
            return make_orchard(keys[torch.as_tensor(list(ids), dtype=torch.int64)], spec, s,
                                dev)
    else:
        assert keys is None, "pass keys or clouds, not both"

        def orchards(ids, dev):
            return tree.stack([cloud_tensors(clouds(int(i)), s, dev) for i in ids])

    swept = params_queue is not None
    if swept:
        qlen = tree.leaves(params_queue)[0].shape[0]
        assert qlen == total, (qlen, total)

    def _params(i, dev):
        """Params of rollout id i (an int) or ids i (a slice or an index
        tensor) on ``dev``."""
        return to_device(tree.lane(params_queue, i) if swept else params, dev)

    def build(ids, dev):
        """(world, state, acc) of rollout ids ``ids`` (a group), built on
        ``dev`` in one call, every leaf with the group's leading axis."""
        group = orchards(ids, dev)
        p = _params(torch.as_tensor(list(ids)), dev)
        if cached:
            lite, cache, st, acc = _begin_group(group, p, s, steps_budget, ror_method)
            return (lite, cache), st, acc
        return _begin(group, p, s, steps_budget, ror_method, classify)

    def chunk(blk, ages_blk, dev):
        world_b, st_b, acc_b, params_b = blk
        off = torch.from_numpy(ages_blk).to(dev)
        if cached:
            return rollout_chunk_cached(world_b[0], world_b[1], st_b, acc_b, params_b, s,
                                        chunk_steps, off)
        return rollout_chunk(world_b, st_b, acc_b, params_b, s, chunk_steps, off)

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
        for dev in set(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    with torch.no_grad():
        # initial fill: lane ln runs rollout id ln, on its block's device.
        # The harness counts it as batch / refill begin calls, as aosx does
        t_fill = time.perf_counter()
        blocks = []
        for k, dev in enumerate(devices):
            lanes = range(k * per, (k + 1) * per)
            world_b, st_b, acc_b = tree.cat([build(lanes[j:j + refill], dev)
                                             for j in range(0, per, refill)])
            # per-lane params (only when swept), scattered alongside the lane
            # state at refill so that a lane's chunk runs its rollout's own row
            blocks.append([world_b, st_b, acc_b, _params(slice(lanes[0], lanes[-1] + 1), dev)])
        n_begin_calls += batch // refill
        _sync()
        begin_s += time.perf_counter() - t_fill

        t0 = time.perf_counter()
        while n_recorded < total:
            tc = time.perf_counter()
            comp = []
            for k, dev in enumerate(devices):
                blk = blocks[k]
                blk[1], blk[2] = chunk(blk, ages[k * per:(k + 1) * per], dev)
                profiling.count("host_read.completion")
                comp.append(blk[1].mission.exploration_completed.cpu().numpy())
            comp = np.concatenate(comp)
            chunk_s += time.perf_counter() - tc
            n_chunk_calls += 1
            ages += chunk_steps
            finished = (comp | (ages >= steps_budget)) & ~recorded
            if finished.any():
                parts = [to_numpy(rollout_finish(b[1], b[2], s)) for b in blocks]
                summ = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
                for ln in np.nonzero(finished)[0]:
                    for k, v in summ.items():
                        results.setdefault(k, [None] * total)[rid[ln]] = v[ln]
                    recorded[ln] = True
                    n_recorded += 1
            # refill retired lanes in fixed-size groups while work remains
            while recorded.sum() >= refill and next_id + refill <= total:
                idx = np.nonzero(recorded)[0][:refill]
                ids = np.arange(next_id, next_id + refill)
                tb = time.perf_counter()
                for k, dev in enumerate(devices):
                    mine = (idx // per) == k
                    if not mine.any():
                        continue
                    new = build(ids[mine], dev)
                    local = torch.from_numpy(idx[mine] % per).to(dev)
                    blk = blocks[k]
                    blk[0], blk[1], blk[2] = tree.scatter(tuple(blk[:3]), local, new)
                    if swept:
                        blk[3] = tree.scatter(blk[3], local, to_device(
                            tree.lane(params_queue, torch.from_numpy(ids[mine])), dev))
                n_begin_calls += 1
                _sync()
                begin_s += time.perf_counter() - tb
                ages[idx] = 0
                recorded[idx] = False
                rid[idx] = ids
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
