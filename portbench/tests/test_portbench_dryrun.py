"""Every cell of BENCHMARK.json through the run's code path on the CPU, at
a small size with the plain kernels: the contract's last line, correct."""

import json

import pytest

from portbench.harness import runner, spec
from portbench.tests.smallcells import cells, run_small

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_prints_the_contract_line(cell, trace):
    result, checks, _ = run_small(cell, trace=bool(trace))
    line = json.loads(runner.result_line(result, checks))
    assert list(line)[-1] == "checks"
    assert all(k in line for k in KEYS)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] >= 0
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.metrics_for(bench, cell, bool(trace))}
    assert set(line["metrics"]) <= want
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]


def test_every_cell_reports_setup_and_a_per_layer_metric():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench, w["name"], True)
        for m in spec.metrics_for(bench, w["name"], True):
            assert m["moves"] in e2e
            spec.reader(m["name"])
