"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout, and
the files it names by name. A workload names a configuration (a JSON file
under ``configs/``) and a traffic mix (a JSON file under ``traffic/``); the
traffic mix names the driver (a module under ``drivers/``) that reads it.
Per-layer metrics are readers under ``metrics/``, one file a metric, found
by the metric's name. Nothing here lists a cell, a mix or a metric: a new
cell is a new entry in ``BENCHMARK.json`` and new data files."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

PORTBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((PORTBENCH / "traffic" / f"{name}.json").read_text())


def driver(name: str):
    """The driver module that generates a traffic mix's load."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on. A metric without a
    ``workloads`` key is reported wherever the metric it moves is (for a
    per-layer metric) or everywhere (for an end-to-end metric)."""
    def in_cell(m, e2e_names):
        if "workloads" in m:
            return cell in m["workloads"]
        return e2e_names is None or m["moves"] in e2e_names

    e2e = [m for m in bench["end_to_end"] if in_cell(m, None)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if in_cell(m, names)]


def reader(name: str):
    """The ``read(obs)`` function of per-layer metric ``name``
    (``metrics/<name>.py``; the name may hold dots, so it is loaded by
    path)."""
    path = PORTBENCH / "metrics" / f"{name}.py"
    mod_name = "portbench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
