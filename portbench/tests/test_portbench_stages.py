"""The traced slice by the program's stages (``harness.stages``) on
hand-made profiler events, and the stage table of a small cell on the CPU.

- The program's spans, as the program marks them (host-side operator
  events, nothing mirrored on the device), leave every field of
  ``harness.trace.reduce`` and its breakdown as they were.
- ``reduce_stages``: a child's time comes off its parent's self time; a
  kernel whose device start falls in a later span counts for the span that
  launched it, and a CUDA graph's kernels for the span of the graph's
  launch; a gap inside ``tick.move`` goes to ``tick.move``; a user
  annotation mirrored on the device is no device operation."""

import dataclasses

import pytest
from torch.autograd import DeviceType

from portbench.harness import stages, trace
from portbench.tests.smallcells import cells, run_small


@dataclasses.dataclass
class Ev:
    """The parts of a ``_KinetoEvent`` the reducers read."""

    n: str
    a: int
    b: int
    cuda: bool = False
    corr: int = 0
    user: bool = False

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def correlation_id(self):
        return self.corr

    def is_user_annotation(self):
        return self.user


def driver_events():
    """A slice of one chunk call: the driver's spans, launches, kernels."""
    return [
        Ev(trace.WINDOW, 0, 1000, user=True),
        Ev("portbench.chunk", 50, 700, user=True),
        Ev("portbench.chunk", 400, 700, cuda=True, user=True),   # its mirror on the device
        Ev("aten::add", 155, 170), Ev("cudaLaunchKernel", 160, 165, corr=1),
        Ev("aten::mul", 305, 318), Ev("cudaLaunchKernel", 310, 315, corr=2),
        Ev("cudaGraphLaunch", 320, 330, corr=3),
        Ev("aten::sub", 615, 630), Ev("cudaLaunchKernel", 620, 625, corr=4),
        Ev("add_kernel", 400, 420, cuda=True, corr=1),
        Ev("mul_kernel", 430, 440, cuda=True, corr=2),
        Ev("graph_kernel_a", 450, 460, cuda=True, corr=3),
        Ev("graph_kernel_b", 460, 470, cuda=True, corr=3),
        Ev("sub_kernel", 650, 660, cuda=True, corr=4),
    ]


def program_events():
    return [Ev("aosx_torch.chunk", 60, 690), Ev("aosx_torch.tick", 100, 600),
            Ev("aosx_torch.tick.mission", 150, 300), Ev("aosx_torch.tick.move", 300, 550)]


def test_program_spans_leave_the_reduced_fields_as_they_were():
    a = trace.reduce(driver_events())
    b = trace.reduce(driver_events() + program_events())
    for f in dataclasses.fields(trace.TraceSummary):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.breakdown() == b.breakdown()


@pytest.mark.parametrize("mirrored", [False, True])
def test_reduce_stages_by_launch_and_by_gap(mirrored):
    ev = driver_events() + program_events()
    if mirrored:
        # a program that marked its spans as user annotations
        ev += [Ev("aosx_torch.tick.mission", 400, 420, cuda=True, user=True),
               Ev("aosx_torch.tick.move", 430, 470, cuda=True, user=True)]
    st = stages.reduce_stages(ev)
    ns = 1e-9
    want_spans = {"chunk": (1, 630, 630 - 500), "tick": (1, 500, 500 - 150 - 250),
                  "tick.mission": (1, 150, 150), "tick.move": (1, 250, 250)}
    assert set(st.program_spans) == set(want_spans)
    for k, (c, s, own) in want_spans.items():
        assert st.program_spans[k][0] == c
        assert st.program_spans[k][1:] == pytest.approx((s * ns, own * ns)), k
    # add_kernel starts on the device inside tick.move's host interval but
    # was launched in tick.mission; the graph's two kernels go with its launch
    assert {k: v[0] for k, v in st.ops_by_program_span.items()} == {
        "tick.mission": 1, "tick.move": 3, "chunk": 1}
    assert st.ops_by_program_span["tick.move"][1] == pytest.approx(30 * ns)
    # busy [400, 420], [430, 440], [450, 470], [650, 660]: the gaps' midpoints
    # 200, 425, 445, 560 and 830
    want_idle = {"tick.mission": 400, "tick.move": 20, "tick": 180, stages.OUTSIDE: 340}
    assert set(st.idle_by_stage) == set(want_idle)
    for k, v in want_idle.items():
        assert st.idle_by_stage[k] == pytest.approx(v * ns), k


@pytest.mark.parametrize("cell", cells())
def test_stage_table_of_a_small_cell(cell):
    from portbench import stage_table
    from portbench.harness import spec

    drv = spec.driver(spec.traffic(cell_traffic(cell))["driver"])
    with stage_table.recording(drv) as got:
        result, _, _ = run_small(cell, trace=True)
    assert result["correct"]
    tab = stage_table.table(got)
    assert tab["groups"] >= 1 and tab["chunk_calls"] >= 1
    assert {"begin", "perceive", "gvd", "plan_cache", "chunk", "tick"} <= set(tab["program_spans"])
    assert 0.9 <= tab["begin_children_cover"] <= 1.0
    assert 0.9 <= tab["chunk_ticks_cover"] <= 1.0
    assert not [k for k in tab["counters"] if k.startswith("graph.capture")]
    assert tab["counters_a_group"]["loop_iters.astar"] > 0
    metrics = result["metrics"]
    for name in ("perceive_ms.mc", "gvd_ms.mc", "plan_cache_ms.mc", "host_reads_per_group.mc",
                 "astar_iters_per_group.mc"):
        assert metrics[name]["value"] > 0, name
    assert metrics["astar_iters_per_group.mc"]["value"] == pytest.approx(
        tab["counters_a_group"]["loop_iters.astar"])


def cell_traffic(cell):
    from portbench.harness import spec

    return spec.workload(spec.load_benchmark(), cell)["traffic"]
