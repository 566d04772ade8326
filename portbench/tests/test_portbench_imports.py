"""What the run loads and what the reference loads: no module whose
top-level name (the part before the first dot, compared whole) is JAX's or
the JAX package's, and in the reference none of the program's."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN_SIDE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from portbench.harness import runner, spec
from portbench.tests.smallcells import cells, run_small
import portbench.control
bench = spec.load_benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
for c in cells():
    result, checks, _ = run_small(c, trace=True, seconds=1.0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_SIDE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from portbench.tests.smallcells import small, cells
from portbench.reference import sustained_rollouts_check
from portbench.tests.tables import plain_tables
for c in cells():
    _, _, cfg, tr = small(c)
    sustained_rollouts_check.run_reference(cfg, 5, np.arange(8, 10), plain_tables(2),
                                           torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                       env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    top = _loaded(RUN_SIDE)
    assert "aosx_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "aosx"}, top


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded(REFERENCE_SIDE)
    assert not top & {"jax", "jaxlib", "flax", "aosx", "aosx_torch"}, top


def test_no_card_no_result():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([*bench["command"], "--workload", bench["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([*bench["command"], "--workload", bench["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
