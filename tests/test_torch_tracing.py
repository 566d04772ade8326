"""The port's spans and counters (``aosx_torch.profiling``) on the CPU, at
the smallest Monte-Carlo size the port's tests use: a refill group of 2
DRYRUN_STATICS worlds (``parallel.batch.rollout_begin_group``), tiled to 4
lanes, stepped a few cached ticks (``rollout_chunk_cached``).

- With no profiler recording, a span enters no profiler event.
- Under ``profiling.trace`` the spans of a group build and a chunk nest as
  the program places them, as host-side operator events (no user
  annotation, so nothing of them is mirrored on a device's timeline), and
  ``span_totals`` sums them with their self time.
- Every output is bitwise the same with the profiler on and off.
- The cached ticks at 4 lanes read nothing on the host.
- A group build's loop trips are ``CHECK_EVERY`` x its condition reads
  less one read a call, site by site; the counters carry the kernel
  wrappers' launches."""

import pytest
import torch

from aosx_torch import ops, profiling, prng, tree
from aosx_torch.config import DRYRUN_STATICS as S, AosParams, params_as_f32
from aosx_torch.gvd import jfa_pass_cuda
from aosx_torch.orchards import OrchardSpec
from aosx_torch.parallel import batch
from aosx_torch.perceive import ror_cuda, skeleton_cuda
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SPEC = OrchardSpec(n_rows=2, row_len=4.0, row_spacing=2.0, tree_spacing=1.0, trunk_pts=10,
                   noise_pts=16, origin=(2.0, 2.0), polygon_pad=1.0)
BUDGET, TICKS = 60, 3

# each span's parent, as the program nests them
PARENT = {
    "begin": None, "begin.orchard": "begin",
    "perceive": "begin", "perceive.points": "perceive", "perceive.raster": "perceive",
    "perceive.skeleton": "perceive", "perceive.rows": "perceive", "perceive.seeds": "perceive",
    "gvd": "begin", "gvd.flood": "gvd",
    "plan_cache": "begin", "plan_cache.astar": "plan_cache",
    "plan_cache.linearize": "plan_cache", "feasibility": "begin",
    "chunk": None, "tick": "chunk", "tick.control": "tick", "tick.mission": "tick",
    "tick.move": "tick", "tick.metrics": "tick", "tick.fold": "tick",
}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _run():
    """(outputs, counter deltas of the build, of the chunk): a group of 2
    begun, tiled to 4 lanes, TICKS cached ticks."""
    params = params_as_f32(AosParams(), CPU)
    keys = prng.split(prng.prng_key(5, CPU), 8)[:2]
    c0 = profiling.counters()
    lite, cache, st, acc = batch.rollout_begin_group(keys, SPEC, params, S, BUDGET,
                                                     ror_method="exact", device=CPU)
    c1 = profiling.counters()
    lite, cache, st, acc = tree.cat([(lite, cache, st, acc)] * 2)
    st, acc = batch.rollout_chunk_cached(lite, cache, st, acc, params, S, TICKS,
                                         torch.zeros(4, dtype=torch.int32))
    c2 = profiling.counters()
    return (lite, cache, st, acc), _delta(c1, c0), _delta(c2, c1)


@pytest.fixture(scope="module")
def plain():
    return _run()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(outputs, the program's profiler events as (start, end, name), the
    span totals the run added)."""
    before = profiling.span_totals()
    with profiling.trace(str(tmp_path_factory.mktemp("trace"))) as prof:
        out = _run()[0]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX)]
    after = profiling.span_totals()
    added = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in ("count", "seconds",
                                                                    "self_seconds")}
             for k, v in after.items()}
    return out, events, added


def test_no_profiler_enters_no_profiler_event(monkeypatch):
    entered = []

    class Recorder:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Recorder)
    before = profiling.span_totals()
    assert not torch._C._autograd._profiler_enabled()
    params = params_as_f32(AosParams(), CPU)
    keys = prng.split(prng.prng_key(5, CPU), 8)[:2]
    lite, cache, st, acc = batch.rollout_begin_group(keys, SPEC, params, S, BUDGET,
                                                     ror_method="exact", device=CPU)
    batch.rollout_chunk_cached(lite, cache, st, acc, params, S, 1,
                               torch.zeros(2, dtype=torch.int32))
    assert entered == []
    assert profiling.span("begin") is profiling.span("tick")
    assert profiling.span_totals() == before


def test_spans_nest_as_the_program_places_them(traced):
    _, events, _ = traced
    spans = sorted(((e.start_ns(), -e.duration_ns(), e.name()[len(profiling.PREFIX):],
                     e.start_ns() + e.duration_ns()) for e in events))
    assert {n for _, _, n, _ in spans} == set(PARENT)
    # each span's innermost enclosing span on the host thread
    stack, parents = [], {}
    for a, _, name, b in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        parents.setdefault(name, set()).add(stack[-1][0] if stack else None)
        stack.append((name, b))
    assert parents == {k: {v} for k, v in PARENT.items()}
    names = [n for _, _, n, _ in spans]
    assert names.count("begin") == names.count("chunk") == 1
    assert names.count("tick") == names.count("tick.fold") == TICKS


def test_spans_are_operator_events_not_user_annotations(traced):
    _, events, _ = traced
    assert events and not any(e.is_user_annotation() for e in events)


def test_span_totals_count_host_and_self_seconds(traced):
    _, _, added = traced
    assert added["tick"]["count"] == TICKS and added["begin"]["count"] == 1
    for name, parent in PARENT.items():
        assert 0 <= added[name]["self_seconds"] <= added[name]["seconds"] + 1e-9
        kids = [k for k, p in PARENT.items() if p == name]
        if kids:
            inner = sum(added[k]["seconds"] for k in kids)
            assert added[name]["self_seconds"] == pytest.approx(added[name]["seconds"] - inner,
                                                                abs=1e-6)


def test_outputs_bitwise_with_profiler_on_and_off(plain, traced):
    a, b = tree.leaves(plain[0]), tree.leaves(traced[0])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.view(torch.int32) if x.is_floating_point() else x
        y = y.view(torch.int32) if y.is_floating_point() else y
        assert torch.equal(x, y)


def test_cached_ticks_read_nothing_on_the_host(plain):
    _, build, chunk = plain
    assert any(k.startswith("host_read.") for k in build)
    assert not [k for k in chunk if k.startswith("host_read.")], chunk


def test_group_build_trips_are_check_every_times_reads(plain):
    _, build, _ = plain
    sites = {k[len("loop_calls."):] for k in build if k.startswith("loop_calls.")}
    assert {"astar", "linearize", "merge_seeds", "greedy_dedupe"} <= sites
    for site in sites:
        reads = build["host_read." + site]
        assert build.get("loop_iters." + site, 0) == ops.CHECK_EVERY * (
            reads - build["loop_calls." + site]), site
    assert build["loop_iters.astar"] > 0


def test_while_loop_counts_reads_trips_and_calls():
    before = profiling.counters()
    out = ops.while_loop(lambda n: n > 0, lambda n: n - 1, torch.tensor(10), "unit")
    got = _delta(profiling.counters(), before)
    # 10 -> -2 in 3 rounds of 4: three reads that go on, one that stops
    assert int(out) == -2
    assert got == {"host_read.unit": 4, "loop_iters.unit": 12, "loop_calls.unit": 1}


def test_take_row_counts_a_0d_index_as_a_host_read():
    arr = torch.arange(12.0).reshape(4, 3)
    before = profiling.counters()
    ops.take_row(arr, torch.tensor(2))
    ops.take_row(arr[None].expand(2, 4, 3), torch.tensor([1, 3]))
    assert _delta(profiling.counters(), before) == {"host_read.take_row": 1}


def test_counters_carry_the_kernel_wrappers_launches(monkeypatch):
    monkeypatch.setattr(jfa_pass_cuda.jfa_flood, "launches", 7)
    monkeypatch.setattr(jfa_pass_cuda.jfa_flood, "passes", 70)
    monkeypatch.setattr(skeleton_cuda.zhang_suen_fixpoint, "launches", 5)
    monkeypatch.setattr(ror_cuda.ror_counts, "launches", 3)
    c = profiling.counters()
    assert (c["launches.jfa_flood"], c["passes.jfa_flood"], c["launches.zhang_suen_fixpoint"],
            c["launches.ror_counts"]) == (7, 70, 5, 3)


@pytest.mark.cuda
def test_card_graph_counts_one_capture_and_each_replay(cuda_device):
    fn = ops.card_graph(lambda x: x * 2 + 1)
    x = torch.arange(8.0, device=cuda_device)
    before = profiling.counters()
    for _ in range(3):
        fn(x)
    assert _delta(profiling.counters(), before) == {"graph.capture": 1, "graph.replay": 3}
