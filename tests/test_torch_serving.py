"""The live serving path at TEST_STATICS: incremental map frames
(``incremental``), the plan cache across rebuilds and control ticks
(``serving``), and state checkpoints (``io.checkpoint``), on the growing
map of tests/helpers.py::frames_growing([0.55, 0.8, 1.0]).

The JAX side runs once per ``ror_method``: ``serving.serve_init`` on frame
0, then ``incremental.serve_frames`` one frame at a time with 30 ticks each
(``replay_episode_incremental_cached`` is exactly serve_init followed by
serve_frames over all frames), keeping the ServeState after every frame.
With ``ror_method="pallas"`` the JAX package's Pallas ROR kernel runs in
interpret mode (monkeypatched for the run; no file changes), the port's
through K3's plain version. That run is stored
(``tests/torch_reference/make_serving_replay_reference.py`` writes
``serving_replay_ref.npz``); the tests rebuild its pytree from
``jax.eval_shape`` of the same function, and the port runs live.

Every leaf is bitwise, for both methods: int and bool leaves, levels
included, and every float leaf, the plan cache, the ticks' poses, the
robot's pose and goal, the graph's ``edge_lengths`` and the A* costs made of
them included."""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import frames_growing

from aosx import incremental as jinc, serving as jserving
from aosx.config import TEST_STATICS as JS, AosParams as JParams, params_as_f32 as jparams
from aosx.io.checkpoint import save_state as jsave_state
from aosx.perceive import ror_pallas
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import engine, incremental, serving
from aosx_torch.config import TEST_STATICS as S, AosParams, params_as_f32
from aosx_torch.convert import to_numpy, to_torch
from aosx_torch.guards import GUARD_NONFINITE
from aosx_torch.io.checkpoint import load_state, save_state
from aosx_torch.types import PointCloud, Polygon
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

FRACS = [0.55, 0.8, 1.0]
T = 30
CMD_KEYS = ("mod", "status", "target_wp", "cluster_idx", "waiting", "completed", "plan_len",
            "nonfinite", "guards")
METHODS = ("exact", "pallas")


def _serve_fn(poly, params, excl, method):
    """frames -> (ServeState after serve_init, metrics [F, T] with inc_level
    [F], ServeStates after each frame stacked [F, ...])."""
    tm = jax.tree_util.tree_map

    def run(fr):
        sv0 = jserving.serve_init(tm(lambda x: x[0], fr), poly, params, excl, JS,
                                  ror_method=method)

        def one_frame(sv, pc_f):
            sv, m = jinc.serve_frames(sv, tm(lambda x: x[None], pc_f), poly, params, excl, JS,
                                      T, ror_method=method)
            return sv, (tm(lambda x: x[0], m), sv)

        _, (metrics, svs) = jax.lax.scan(one_frame, sv0, fr)
        return sv0, metrics, svs

    return run


def _jax_serve(frames, poly, params, excl, method):
    """_serve_fn's result, jitted."""
    return jax.jit(_serve_fn(poly, params, excl, method))(frames)


def _jax_inputs():
    bufs, valids, poly = frames_growing(FRACS, JS)
    jpoly = JPolygon.from_array(poly.astype(np.float32), JS)
    jp = jparams(JParams())
    jexcl = jnp.zeros((JS.max_exclusions, 3), jnp.float32)
    frames = JCloud(xyz=jnp.asarray(bufs), valid=jnp.asarray(valids))
    return bufs, valids, poly, jpoly, jp, jexcl, frames


def jax_serve_run(method):
    """The JAX side for ``method`` as a function of nothing: _jax_serve on
    the test's frames (the Pallas ROR kernel in interpret mode while it
    runs); make_serving_replay_reference.py stores its result."""
    _, _, _, jpoly, jp, jexcl, frames = _jax_inputs()

    def run():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ror_pallas, "ror_counts_pallas",
                       functools.partial(ror_pallas.ror_counts_pallas, interpret=True))
            return _jax_serve(frames, jpoly, jp, jexcl, method)

    return run


def _stored_jax_serve(method):
    """The stored JAX side for ``method``, as the pytree _jax_serve returns
    (its structure from jax.eval_shape, no compile)."""
    _, _, _, jpoly, jp, jexcl, frames = _jax_inputs()
    shapes = jax.eval_shape(_serve_fn(jpoly, jp, jexcl, method), frames)
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    data = np.load(REPLAY_REF)
    stored = [data[f"{method}/{i}"] for i in range(len(leaves))]
    for leaf, s in zip(leaves, stored):
        assert s.shape == leaf.shape and s.dtype == leaf.dtype, (leaf, s.shape, s.dtype)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(s) for s in stored])


REPLAY_REF = (pathlib.Path(__file__).resolve().parent / "torch_reference"
              / "serving_replay_ref.npz")


@pytest.fixture(scope="module")
def setup():
    bufs, valids, poly, jpoly, jp, jexcl, frames = _jax_inputs()
    jax_runs = {method: _stored_jax_serve(method) for method in METHODS}

    pt = params_as_f32(AosParams(), "cpu")
    args = (Polygon.from_array(poly.astype(np.float32), S, "cpu"), pt,
            torch.zeros((S.max_exclusions, 3)))
    tframes = PointCloud(xyz=torch.from_numpy(bufs), valid=torch.from_numpy(valids))
    port = {m: incremental.replay_episode_incremental_cached(tframes, *args, S, T,
                                                             ror_method=m, return_inc=True)
            for m in METHODS}
    return dict(bufs=bufs, valids=valids, jpoly=jpoly, jp=jp, jexcl=jexcl, jax=jax_runs,
                args=args, frames=tframes, port=port)


def _frame(setup, f):
    return engine.frame(setup["frames"], f)


def _jstate(setup, method, f):
    """The JAX ServeState after frame f."""
    return jax.tree_util.tree_map(lambda x: x[f], setup["jax"][method][2])


@pytest.mark.parametrize("method", METHODS)
def test_replay_matches_jax(setup, method):
    """replay_episode_incremental_cached: levels and every per-tick metric."""
    _, jm, _ = setup["jax"][method]
    _, m, _ = setup["port"][method]
    assert set(jm) == set(m)
    assert_same(jm["inc_level"], m["inc_level"])
    for k in jm:
        assert_same(jm[k], m[k])
    levels = m["inc_level"].tolist()
    assert levels[0] == incremental.LEVEL_REUSE_WORLD
    assert incremental.LEVEL_DOWNSTREAM in levels[1:]
    assert bool(m["completed"].any()) or bool((m["target_wp"] >= 0).any())


def _counts_of_valid(inc):
    """An IncrementalState as nested dicts, ROR counts zeroed where the
    point is invalid: parked points' dot-formula counts are junk (d2 cancels
    at 1e9), computed differently by XLA and by K3's plain version."""
    d = to_numpy(inc)
    d["cnt"] = np.where(d["valid"], d["cnt"], 0)
    return d


@pytest.mark.parametrize("method", METHODS)
def test_incremental_states_match_jax(setup, method):
    """perceive_init on frame 0, then perceive_update per frame: the same
    levels as the JAX package and leaf-for-leaf equal IncrementalStates
    (with 'pallas', the ROR counts of valid points)."""
    _, jm, _ = setup["jax"][method]
    prep = _counts_of_valid if method == "pallas" else to_numpy
    inc = incremental.perceive_init(_frame(setup, 0), *setup["args"], S, ror_method=method)
    assert_same(prep(setup["jax"][method][0].inc), prep(inc))
    for f in range(len(FRACS)):
        inc, level = incremental.perceive_update(inc, _frame(setup, f), *setup["args"], S,
                                                 ror_method=method)
        assert int(level) == int(jm["inc_level"][f])
        assert_same(prep(_jstate(setup, method, f).inc), prep(inc))


def test_incremental_equals_from_scratch_replay(setup):
    """With ror_method='exact' the incremental serving loop equals the
    port's from-scratch engine.replay_episode in every metric."""
    _, m, inc = setup["port"]["exact"]
    ref_final, ref = engine.replay_episode(setup["frames"], *setup["args"], S, T,
                                           ror_method="exact")
    assert set(ref) == set(m) - {"inc_level"}
    assert_same(ref, {k: v for k, v in m.items() if k != "inc_level"})
    world = engine.prepare_world(_frame(setup, len(FRACS) - 1), *setup["args"], S,
                                 ror_method="exact")
    assert_same(world, inc.world)


def test_cached_replay_equals_replanning_replay(setup):
    """The plan cache changes nothing: replay_episode_incremental (a replan
    and linearize every tick) gives the cached replay's metrics and levels
    bitwise, across the cache rebuilds of the level-2 frames."""
    final_c, m, _ = setup["port"]["exact"]
    final, ref = incremental.replay_episode_incremental(setup["frames"], *setup["args"], S, T)
    assert_same(ref, m)
    assert_same([final.robot, final.mission, final.control, final.wp, final.last_mod, final.t],
                [final_c.robot, final_c.mission, final_c.control, final_c.wp, final_c.last_mod,
                 final_c.t])


def _pose_before(m, i):
    """The pose the replay's tick i acted on (the previous tick's output, or
    the initial pose)."""
    if i == 0:
        return np.zeros(2, np.float32), np.float32(0.0)
    xy = to_numpy(m["xy"]).reshape(-1, 2)
    yaw = to_numpy(m["yaw"]).reshape(-1)
    return xy[i - 1], yaw[i - 1]


def _drive(setup, m, frames_idx, sv=None):
    """Serve the given frames through serve_map_frame and serve_control_tick
    fed the replay's recorded poses. Returns (state, stacked commands)."""
    if sv is None:
        sv = serving.serve_init(_frame(setup, 0), *setup["args"], S)
    cmds = []
    for f in frames_idx:
        sv, level = serving.serve_map_frame(sv, _frame(setup, f), *setup["args"], S)
        assert int(level) == int(to_numpy(m["inc_level"])[f])
        for t in range(T):
            sv, cmd = serving.serve_control_tick(sv, *_pose_before(m, f * T + t), setup["args"][1],
                                                 S)
            cmds.append(cmd)
    return sv, engine.stack_metrics(cmds)


def _assert_cmds_match(m, cmds, frames_idx):
    for k in CMD_KEYS:
        ref = np.concatenate([to_numpy(m[k])[f] for f in frames_idx])
        assert_same(ref, cmds[k])
    # the command echoes the MEASURED pose it acted on
    ticks = [f * T + t for f in frames_idx for t in range(T)]
    assert_same(np.stack([_pose_before(m, i)[0] for i in ticks]), cmds["xy"])


def test_serve_control_tick_reproduces_replay(setup):
    """Fed the replay's own poses, the streaming API publishes the replay's
    decisions bit for bit, and the published plan is the adopted row."""
    final, m, _ = setup["port"]["exact"]
    sv, cmds = _drive(setup, m, range(len(FRACS)))
    _assert_cmds_match(m, cmds, range(len(FRACS)))
    assert_same([final.mission, final.adopted], [sv.st.mission, sv.st.adopted])
    a = int(sv.st.adopted)
    assert torch.equal(cmds["plan_xy"][-1].view(torch.int32), sv.cache.plan_xy[a].view(torch.int32))
    assert torch.equal(cmds["plan_yaw"][-1].view(torch.int32),
                       sv.cache.plan_yaw[a].view(torch.int32))


def test_checkpoint_round_trip_continues_exactly(setup, tmp_path):
    """A survey checkpointed after frame 1 and resumed from disk continues
    exactly like the uninterrupted one."""
    _, m, _ = setup["port"]["exact"]
    sv_mid, _ = _drive(setup, m, range(2))
    path = str(tmp_path / "survey.ckpt")
    save_state(path, sv_mid)
    sv_loaded = load_state(path, like=sv_mid)
    assert_same(sv_mid, sv_loaded)
    _, cmds_cont = _drive(setup, m, [2], sv=sv_mid)
    _, cmds_res = _drive(setup, m, [2], sv=sv_loaded)
    assert_same(cmds_cont, cmds_res)


def test_jax_checkpoint_resumes_in_port(setup, tmp_path):
    """A ServeState saved by the JAX package after frame 1 loads through the
    port's load_state (which pins the leaf order) and the port continues
    frame 2 with the JAX replay's commands."""
    _, jm, _ = setup["jax"]["exact"]
    path = str(tmp_path / "jax_survey.ckpt")
    jsave_state(path, _jstate(setup, "exact", 1))
    _, port_m, _ = setup["port"]["exact"]
    like, _ = _drive(setup, port_m, range(2))
    sv = load_state(path, like=like)
    assert_same(to_torch(_jstate(setup, "exact", 1), serving.ServeState, "cpu"), sv)
    assert_same(_jstate(setup, "exact", 1), sv)
    _, cmds = _drive(setup, jm, [2], sv=sv)
    _assert_cmds_match(jm, cmds, [2])


def _moved_frame(setup, dx):
    f = len(FRACS) - 1
    xyz = setup["frames"].xyz[f].clone()
    first = int(torch.nonzero(setup["frames"].valid[f])[0])
    xyz[first, 0] += dx
    return PointCloud(xyz=xyz, valid=setup["frames"].valid[f])


def test_moved_point_takes_level_full(setup):
    """A SLAM loop closure moves a point: the append-only contract is broken,
    the frame takes LEVEL_FULL and equals a from-scratch pass; the same
    frame again is an empty delta, LEVEL_REUSE_WORLD."""
    _, _, inc = setup["port"]["exact"]
    pc = _moved_frame(setup, 0.25)
    st, level = incremental.perceive_update(inc, pc, *setup["args"], S)
    assert int(level) == incremental.LEVEL_FULL
    assert_same(incremental.perceive_init(pc, *setup["args"], S), st)
    st2, level = incremental.perceive_update(st, pc, *setup["args"], S)
    assert int(level) == incremental.LEVEL_REUSE_WORLD and st2 is st


def test_config_change_takes_level_full(setup):
    """An exclusion disc added mid-survey with no new points: LEVEL_FULL,
    equal to a from-scratch pass with the new config, which the new state
    carries (the same config again is LEVEL_REUSE_WORLD)."""
    _, _, inc = setup["port"]["exact"]
    f = len(FRACS) - 1
    pc = _frame(setup, f)
    poly, params, excl = setup["args"]
    st, level = incremental.perceive_update(inc, pc, poly, params, excl, S)
    assert int(level) == incremental.LEVEL_REUSE_WORLD
    first = int(torch.nonzero(pc.valid)[0])
    excl_new = excl.clone()
    excl_new[0] = torch.tensor([float(pc.xyz[first, 0]), float(pc.xyz[first, 1]), 1.0])
    st_e, level = incremental.perceive_update(inc, pc, poly, params, excl_new, S)
    assert int(level) == incremental.LEVEL_FULL
    assert_same(incremental.perceive_init(pc, poly, params, excl_new, S), st_e)
    assert int(st_e.keep.sum()) < int(inc.keep.sum())
    _, level = incremental.perceive_update(st_e, pc, poly, params, excl_new, S)
    assert int(level) == incremental.LEVEL_REUSE_WORLD
    # a changed params leaf invalidates the world too
    params_new = params_as_f32(dataclasses.replace(AosParams(), proximity_edge_dist=0.25), "cpu")
    _, level = incremental.perceive_update(inc, pc, poly, params_new, excl, S)
    assert int(level) == incremental.LEVEL_FULL


@pytest.fixture(scope="module")
def jax_tick(setup):
    """The JAX package's serve_control_tick, compiled once; host_jit, since
    it is called once per case (serving.host_jit's docstring)."""
    return jserving.host_jit(lambda sv, xy, yaw: jserving.serve_control_tick(
        sv, xy, yaw, setup["jp"], JS))


@pytest.mark.parametrize("pose,flagged", [((np.nan, 1.0, 0.0), True),
                                          ((1.0, -np.inf, 0.0), True),
                                          ((1.0, 2.0, np.inf), False)])
def test_nonfinite_pose_sets_guard_like_jax(setup, jax_tick, pose, flagged):
    """GUARD_NONFINITE: a non-finite measured position fed to
    serve_control_tick sets the bit in both packages, with equal commands.
    A non-finite yaw alone reaches no output the guard counts (robot and
    goal xy, the plan), in either package."""
    jsv = _jstate(setup, "exact", 2)
    xy, yaw = np.float32(pose[:2]), np.float32(pose[2])
    _, jcmd = jax_tick(jsv, jnp.asarray(xy), jnp.asarray(yaw))
    sv = to_torch(jsv, serving.ServeState, "cpu")
    _, cmd = serving.serve_control_tick(sv, xy, yaw, setup["args"][1], S)
    assert bool(int(cmd["guards"]) & GUARD_NONFINITE) == flagged
    assert int(jcmd["guards"]) == int(cmd["guards"])
    assert_same({k: jcmd[k] for k in CMD_KEYS}, {k: cmd[k] for k in CMD_KEYS})
    # a finite pose keeps the bit off
    _, cmd = serving.serve_control_tick(sv, np.float32([1.0, 2.0]), np.float32(0.0),
                                        setup["args"][1], S)
    assert not int(cmd["guards"]) & GUARD_NONFINITE
