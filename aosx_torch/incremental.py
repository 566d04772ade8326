"""Exact incremental map update (mirror of ``aosx/incremental.py``).

The reference recomputes the whole perceive -> GVD -> plan world on every
map callback (aos_gvd_node.cpp:152-177). A growing SLAM map is append-only,
and three exact facts let most frames reuse work:

1. ROR counts are monotone under appended points: one O(N*D) cross pass
   between the delta and the full set replaces the O(N^2) pass, and the keep
   mask can only gain points.
2. The inflated plane is recomputed exactly from the raw scatter grid.
3. Everything downstream of the skeleton is a pure function of (skeleton,
   polygon, params), so equality gates give exact reuse:
     inflated unchanged  -> reuse the whole previous World    (level 0)
     skeleton unchanged  -> reuse rows/seeds/graph/costs/tour (level 1)
     else                -> recompute downstream               (level 2)
   and a from-scratch fallback (level 3) when the append-only contract is
   broken (points removed or moved, as by a SLAM loop closure), the delta
   exceeds max_delta_points, or the carried (poly, params, exclusions)
   differ from the incoming ones.

Every level gives the same state as ``perceive_init`` on the same frame.
The gates are Python branches on the same predicates, in the same order, as
the JAX package's ``lax.cond`` nest; the delta cross pass uses the
elementwise (a-b)^2 formula of ``points.ror_counts(method='exact')``.
With ``stencil_mesh`` (a ``parallel.spatial.Mesh``) the inflation, the
skeletonization and the flood run on row bands over the mesh's devices,
bitwise equal to the single-device stages, so every gate compares the same
planes and takes the same level.
"""

from __future__ import annotations

import dataclasses

import torch

from . import engine
from .config import AosParams, Statics
from .engine import World
from .geom import active_bounds
from .ops import scatter_set
from .perceive import points as _points
from .perceive import raster as _raster
from .perceive import skeleton as _skeleton
from .perceive.pipeline import PerceiveOut, perceive_tail
from .plan.mission import rebuild_waypoints
from .types import GridWorld, PointCloud, Polygon


@dataclasses.dataclass(frozen=True)
class IncrementalState:
    """Carried across map frames: the raw point buffer as last seen (valid
    is post-isfinite), the preprocessing intermediates the delta pass
    updates, the pre-border inflated grid (the level-0 gate plane), the
    config it was built with, the preprocess-era guard bits and the world."""

    xyz: torch.Tensor        # [N,3] f32
    valid: torch.Tensor      # [N] bool (post-isfinite)
    cnt: torch.Tensor        # [N] i32 ROR neighbour counts (meaningful where valid)
    keep: torch.Tensor       # [N] bool final preprocess keep mask
    inflated: GridWorld      # dilated, pre-borders
    cfg: tuple[Polygon, AosParams, torch.Tensor]  # (poly, params, exclusions)
    pre_guards: torch.Tensor  # i32 preprocess-era guard bits only (GUARD_ROR_SPAN)
    out: PerceiveOut
    world: World


# update levels (returned for observability, tests and metrics)
LEVEL_REUSE_WORLD = 0
LEVEL_REUSE_DOWNSTREAM = 1
LEVEL_DOWNSTREAM = 2
LEVEL_FULL = 3

# delta rows and full-set columns of one cross-pass tile
_DCHUNK = 1024
_COL_BLOCK = 8192


def _level(v: int, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _downstream(skel, inflated, poly, params: AosParams, s: Statics, pre_guards,
                stencil_mesh=None, stencil_axis: str = "space"):
    """The perceive tail + world assembly, identical by construction to
    perceive composed with engine.prepare_world_full."""
    occupancy = _raster.mark_borders(inflated)
    out = perceive_tail(skel, occupancy, poly, params, s, pre_guards)
    return out, engine.world_from_perceive(out, params, s, stencil_mesh=stencil_mesh,
                                           stencil_axis=stencil_axis)


def _inflate(grid, s: Statics, stencil_mesh, stencil_axis):
    if stencil_mesh is None:
        return _raster.inflate(grid, s)
    from .parallel.spatial import inflate_sharded

    return inflate_sharded(grid, s, stencil_mesh, stencil_axis)


def _skeletonize(inflated, s: Statics, stencil_mesh, stencil_axis):
    if stencil_mesh is None:
        return _skeleton.skeletonize(inflated, s)
    from .parallel.spatial import skeletonize_sharded

    return skeletonize_sharded(inflated, s, stencil_mesh, stencil_axis)


def perceive_init(pc: PointCloud, poly: Polygon, params: AosParams, exclusions,
                  s: Statics, *, ror_method: str = "exact", stencil_mesh=None,
                  stencil_axis: str = "space") -> IncrementalState:
    """Full from-scratch pass, keeping the incremental intermediates.
    stencil_mesh: optional mesh for the grid stencils and the flood."""
    xy, keep, cnt, valid, bounds, guards = _points.preprocess_full(
        pc, poly, params, exclusions, s, ror_method=ror_method)
    grid = _raster.generate_grid(xy, keep, bounds, s)
    inflated = _inflate(grid, s, stencil_mesh, stencil_axis)
    skel = _skeletonize(inflated, s, stencil_mesh, stencil_axis)
    out, world = _downstream(skel, inflated, poly, params, s, guards, stencil_mesh,
                             stencil_axis)
    return IncrementalState(xyz=pc.xyz, valid=valid, cnt=cnt, keep=keep, inflated=inflated,
                            cfg=(poly, params, exclusions), pre_guards=guards, out=out,
                            world=world)


def _cfg_leaves(cfg):
    poly, params, exclusions = cfg
    return ([poly.pts, poly.count]
            + [getattr(params, f.name) for f in dataclasses.fields(params)]
            + [exclusions])


def _cfg_same(cfg_old, cfg_new):
    """Every leaf of the carried config equals the incoming one.

    Returns the Python literal False on a STATIC mismatch (a leaf's shape
    or dtype differs, e.g. another exclusion-buffer size): the caller then
    takes the from-scratch path. Otherwise a bool tensor."""
    old_l = [torch.as_tensor(a) for a in _cfg_leaves(cfg_old)]
    new_l = [torch.as_tensor(b) for b in _cfg_leaves(cfg_new)]
    if any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(old_l, new_l)):
        return False
    return torch.stack([(a == b.to(a.device)).all() for a, b in zip(old_l, new_l)]).all()


def _cross_counts(all_pts, all_valid, dpts, dvalid, dcount: int, r2):
    """Counts of within-radius pairs between the delta set and the full set.

    Returns (cnt_delta [D]: per delta point, matches against ALL valid
    points incl. itself; contrib [N]: per full-buffer point, matches against
    valid delta points). Only the ceil(dcount / _DCHUNK) delta chunks that
    hold delta points are visited; rows of other chunks keep count 0. Every
    sum is an integer sum, so the tiling cannot change a value."""
    N = all_pts.shape[0]
    D = dpts.shape[0]
    dev = all_pts.device
    cnt_delta = torch.zeros(D, dtype=torch.int32, device=dev)
    contrib = torch.zeros(N, dtype=torch.int32, device=dev)
    for r0 in range(0, min(dcount, D), _DCHUNK):
        rows = dpts[r0:r0 + _DCHUNK]
        rmask = dvalid[r0:r0 + _DCHUNK]
        for c0 in range(0, N, _COL_BLOCK):
            d2 = _points._d2(rows[:, None, :], all_pts[None, c0:c0 + _COL_BLOCK, :])
            hit = (d2 <= r2) & rmask[:, None] & all_valid[None, c0:c0 + _COL_BLOCK]
            cnt_delta[r0:r0 + _DCHUNK] += hit.sum(dim=1, dtype=torch.int32)
            contrib[c0:c0 + _COL_BLOCK] += hit.sum(dim=0, dtype=torch.int32)
    return cnt_delta, contrib


def perceive_update(st: IncrementalState, pc: PointCloud, poly: Polygon, params: AosParams,
                    exclusions, s: Statics, *, ror_method: str = "exact", stencil_mesh=None,
                    stencil_axis: str = "space"):
    """One incremental map frame. pc is the FULL current snapshot
    (index-stable buffer); the delta is the mask difference against the
    carried state. Returns (new state, level i32 tensor)."""
    N = st.xyz.shape[0]
    D = s.max_delta_points
    dev = st.xyz.device
    xyz_new = pc.xyz
    valid_new = pc.valid & torch.isfinite(xyz_new).all(dim=1)

    removed = (st.valid & ~valid_new).any()
    moved = (st.valid[:, None] & (xyz_new != st.xyz)).any()
    delta_mask = valid_new & ~st.valid
    dcount = delta_mask.sum(dtype=torch.int32)
    cfg = (poly, params, exclusions)
    cfg_same = _cfg_same(st.cfg, cfg)
    if cfg_same is False or bool(removed | moved | (dcount > D) | ~cfg_same):
        return (perceive_init(pc, poly, params, exclusions, s, ror_method=ror_method,
                              stencil_mesh=stencil_mesh, stencil_axis=stencil_axis),
                _level(LEVEL_FULL, dev))
    n_delta = int(dcount)
    if n_delta == 0:
        # nothing added, removed or moved: the carried state is the exact
        # result for this frame
        return st, _level(LEVEL_REUSE_WORLD, dev)

    # compact the delta into [D] slots (an overflow took the full branch)
    pos = torch.cumsum(delta_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(delta_mask & (pos < D), pos, D)
    dpts = scatter_set(D, 0.0, slot, xyz_new)
    dpos = scatter_set(D, N, slot, torch.arange(N, dtype=torch.int32, device=dev))
    dvalid = torch.arange(D, device=dev) < dcount

    r2 = torch.as_tensor(params.ror_radius, dtype=torch.float32, device=dev) ** 2
    cnt_delta, contrib = _cross_counts(xyz_new, valid_new, dpts, dvalid, n_delta, r2)
    # old points gain the delta neighbours; delta points get their full
    # count (cnt_delta includes self at d2 = 0, hence minus 1)
    cnt = torch.cat([st.cnt + contrib, torch.zeros(1, dtype=torch.int32, device=dev)])
    cnt[dpos.long()] = cnt_delta - 1
    cnt = cnt[:N]

    bounds = active_bounds(
        poly, (params.clipping_minx, params.clipping_maxx,
               params.clipping_miny, params.clipping_maxy),
        params.polygon_margin)
    keep = valid_new & (cnt >= params.ror_min_neighbors)
    keep &= _points.static_keep_mask(xyz_new, params, exclusions, bounds)

    grid = _raster.generate_grid(xyz_new[:, :2], keep, bounds, s)
    inflated = _inflate(grid, s, stencil_mesh, stencil_axis)
    carried = dataclasses.replace(st, xyz=xyz_new, valid=valid_new, cnt=cnt, keep=keep,
                                  inflated=inflated)
    if not bool((inflated.occ != st.inflated.occ).any()):
        return carried, _level(LEVEL_REUSE_WORLD, dev)

    skel = _skeletonize(inflated, s, stencil_mesh, stencil_axis)
    if bool((skel.occ == carried.out.skeleton.occ).all()):
        # the skeleton is the same, so graph and plans are; the inflated
        # occupancy plane did change, so refresh it wherever it rides
        occupancy = _raster.mark_borders(inflated)
        return (dataclasses.replace(
            carried, out=dataclasses.replace(carried.out, occupancy=occupancy),
            world=dataclasses.replace(carried.world, occupancy=occupancy)),
            _level(LEVEL_REUSE_DOWNSTREAM, dev))
    # seed with the preprocess-era bits only: the previous skeleton's
    # cluster bits must not carry over into this frame's world
    out, world = _downstream(skel, inflated, poly, params, s, carried.pre_guards,
                             stencil_mesh, stencil_axis)
    return dataclasses.replace(carried, out=out, world=world), _level(LEVEL_DOWNSTREAM, dev)


def replay_episode_incremental(pc_frames: PointCloud, poly: Polygon, params: AosParams,
                               exclusions, s: Statics, steps_per_frame: int, *,
                               ror_method: str = "exact", return_inc: bool = False):
    """engine.replay_episode with the incremental world update. Per-frame
    metrics additionally carry ``inc_level`` ([F] i32)."""
    inc = perceive_init(engine.frame(pc_frames, 0), poly, params, exclusions, s,
                        ror_method=ror_method)
    st = engine.initial_state(inc.world, s)
    per_frame, levels = [], []
    for f in range(pc_frames.xyz.shape[0]):
        inc, level = perceive_update(inc, engine.frame(pc_frames, f), poly, params,
                                     exclusions, s, ror_method=ror_method)
        mission, wp = rebuild_waypoints(st.mission, st.wp, inc.world.graph, params, s)
        st = dataclasses.replace(st, mission=mission, wp=wp)
        per_step = []
        for _ in range(steps_per_frame):
            st, m = engine.step(st, inc.world, params, s)
            per_step.append(m)
        per_frame.append(engine.stack_metrics(per_step))
        levels.append(level)
    metrics = engine.stack_metrics(per_frame)
    metrics["inc_level"] = torch.stack(levels)
    return (st, metrics, inc) if return_inc else (st, metrics)


def serve_frames(sv, pc_frames: PointCloud, poly: Polygon, params: AosParams, exclusions,
                 s: Statics, steps_per_frame: int, *, ror_method: str = "exact"):
    """The production serving loop from an existing ServeState: per frame,
    serving.serve_map_frame (incremental gates, plan cache rebuilt only at
    level >= 2), then steps_per_frame plan-cached control ticks. Returns
    (ServeState, metrics) with metrics["inc_level"] the [F] levels."""
    from . import serving
    from .plan import plancache

    per_frame, levels = [], []
    for f in range(pc_frames.xyz.shape[0]):
        sv, level = serving.serve_map_frame(sv, engine.frame(pc_frames, f), poly, params,
                                            exclusions, s, ror_method=ror_method)
        st = sv.st
        per_step = []
        for _ in range(steps_per_frame):
            st, m = plancache.step_cached(st, sv.lite, sv.cache, params, s)
            per_step.append(m)
        sv = dataclasses.replace(sv, st=st)
        per_frame.append(engine.stack_metrics(per_step))
        levels.append(level)
    metrics = engine.stack_metrics(per_frame)
    metrics["inc_level"] = torch.stack(levels)
    return sv, metrics


def replay_episode_incremental_cached(pc_frames: PointCloud, poly: Polygon,
                                      params: AosParams, exclusions, s: Statics,
                                      steps_per_frame: int, *, ror_method: str = "exact",
                                      return_inc: bool = False):
    """replay_episode_incremental with replan-free control ticks: serve_init
    on frame 0, then serve_frames over every frame (the full production
    serving loop over a recorded sequence)."""
    from . import serving

    sv0 = serving.serve_init(engine.frame(pc_frames, 0), poly, params, exclusions, s,
                             ror_method=ror_method)
    sv, metrics = serve_frames(sv0, pc_frames, poly, params, exclusions, s, steps_per_frame,
                               ror_method=ror_method)
    return (sv.st, metrics, sv.inc) if return_inc else (sv.st, metrics)
