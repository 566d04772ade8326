"""The cached Monte-Carlo tick as one CUDA graph
(``parallel.batch.rollout_chunk_cached`` on the card with a lane axis), at
the smallest Monte-Carlo size the port's tests use: refill groups of 4
DRYRUN_STATICS worlds, tiled to 8 lanes.

- On the CPU: the flat-tensor tick with its carry (``batch.tick_flat``, what
  the graph captures), run as it is, equals the ``step_cached`` + ``_fold``
  loop leaf for leaf, and the chunk there counts no graphed tick.
- On the card: the graphed chunk equals the eager ticks leaf for leaf over
  two calls; a call with other inputs of the same shapes gives their own
  eager answer (nothing captured by address); one capture, then none; every
  tick counted as graphed; a rollout without a lane axis stays eager."""

import dataclasses

import pytest
import torch

from aosx_torch import profiling, prng, tree
from aosx_torch.config import DRYRUN_STATICS as S, AosParams, params_as_f32
from aosx_torch.orchards import OrchardSpec
from aosx_torch.parallel import batch
from aosx_torch.plan import plancache
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SPEC = OrchardSpec(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0, trunk_pts=10,
                   noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
BUDGET, LANES = 60, 8


def _group(key_seed, dev):
    """(lite, cache, st, acc, params) of a group of 4 worlds tiled to 8 lanes."""
    params = params_as_f32(AosParams(), dev)
    keys = prng.split(prng.prng_key(key_seed, CPU), 4)
    begun = batch.rollout_begin_group(keys, SPEC, params, S, BUDGET, ror_method="exact",
                                      device=dev)
    return tree.cat([begun] * (LANES // 4)) + (params,)


def _eager(lite, cache, st, acc, params, n, offset):
    """n ticks of step_cached + _fold, one at a time."""
    for i in range(n):
        st, m = plancache.step_cached(st, lite, cache, params, S, vmap_lanes=LANES)
        acc = batch._fold(acc, m, offset + i, LANES)
    return st, acc


def _assert_bitwise(a, b):
    a, b = tree.leaves(a), tree.leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        x = x.view(torch.int32) if x.is_floating_point() else x
        y = y.view(torch.int32) if y.is_floating_point() else y
        assert torch.equal(x.cpu(), y.cpu())


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def cpu_group():
    return _group(5, CPU)


def test_flat_tick_equals_the_step_and_fold_loop(cpu_group):
    lite, cache, st, acc, params = cpu_group
    offset = torch.arange(LANES, dtype=torch.int32) * 3
    want = _eager(lite, cache, st, acc, params, 10, offset)
    like = tree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                         (st, acc, offset, lite, cache, params))
    carry, fixed = batch._tensors(like[:3]), batch._tensors(like[3:])
    for _ in range(10):
        batch.tick_flat(carry, fixed, like, S, LANES)
    _assert_bitwise(batch._rebuild(like[:2], carry[:-1]), want)
    assert torch.equal(carry[-1], offset + 10)
    # the read-only inputs stay as they were
    _assert_bitwise(like[3:], (lite, cache, params))


def test_cpu_chunk_counts_no_graphed_tick(cpu_group):
    lite, cache, st, acc, params = cpu_group
    offset = torch.zeros(LANES, dtype=torch.int32)
    before = profiling.counters()
    got = batch.rollout_chunk_cached(lite, cache, st, acc, params, S, 3, offset)
    moved = _delta(profiling.counters(), before)
    assert "tick.graphed" not in moved and "graph.capture" not in moved
    _assert_bitwise(got, _eager(lite, cache, st, acc, params, 3, offset))


@pytest.mark.cuda
def test_graphed_chunk_is_the_eager_chunk(cuda_device, monkeypatch):
    monkeypatch.setattr(batch, "_TICK_GRAPHS", {})
    lite, cache, st, acc, params = _group(5, cuda_device)
    offset = torch.arange(LANES, dtype=torch.int32, device=cuda_device)
    ref_st, ref_acc = st, acc
    for call in range(2):
        before = profiling.counters()
        st, acc = batch.rollout_chunk_cached(lite, cache, st, acc, params, S, 5,
                                             offset + 5 * call)
        moved = _delta(profiling.counters(), before)
        ref_st, ref_acc = _eager(lite, cache, ref_st, ref_acc, params, 5, offset + 5 * call)
        _assert_bitwise((st, acc), (ref_st, ref_acc))
        assert moved.get("graph.capture", 0) == (1 if call == 0 else 0), moved
        assert moved.get("tick.graphed", 0) == 5, moved
        assert moved.get("graph.replay", 0) == 5, moved

    # other worlds, states and params of the same shapes: their own answer
    lite2, cache2, st2, acc2, params2 = _group(11, cuda_device)
    params2 = dataclasses.replace(
        params2, docking_radius=torch.tensor(0.9, dtype=torch.float32, device=cuda_device))
    before = profiling.counters()
    got = batch.rollout_chunk_cached(lite2, cache2, st2, acc2, params2, S, 5, offset)
    moved = _delta(profiling.counters(), before)
    assert moved.get("graph.capture", 0) == 0 and moved.get("tick.graphed", 0) == 5, moved
    _assert_bitwise(got, _eager(lite2, cache2, st2, acc2, params2, 5, offset))


@pytest.mark.cuda
def test_one_rollout_without_lanes_stays_eager(cuda_device):
    lite, cache, st, acc, params = _group(5, cuda_device)
    one = tree.lane((lite, cache, st, acc), 0)
    before = profiling.counters()
    st1, acc1 = batch.rollout_chunk_cached(*one, params, S, 3, 0)
    moved = _delta(profiling.counters(), before)
    assert moved.get("tick.graphed", 0) == 0, moved
    ref = one[2], one[3]
    for i in range(3):
        s_, m = plancache.step_cached(ref[0], one[0], one[1], params, S)
        ref = s_, batch._fold(ref[1], m, torch.tensor(i, dtype=torch.int32,
                                                      device=cuda_device), 0)
    _assert_bitwise((st1, acc1), ref)
