"""The port's operator dashboard (``python -m aosx_torch.dashboard``) on the
CPU against the JAX package's reports (tests/torch_reference/dashboard_np.json,
written by make_dashboard_reference.py for the same arguments and maps).

Runs ``main(argv)`` with ``--device cpu`` on the verify recipe's PCD map (60
ticks) and on its three growing snapshots through the cached replay and the
live serving loop (90 ticks each): every key of each report equals the JAX
report's, position and travel included. Also: the maps the port writes are
the JAX package's byte for byte, episode_state.npz loads back into the final
state, the command refuses to run without a card unless --device cpu asks
for the CPU, and the profiling helpers work on CPU tensors."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from aosx.io.pcd import save_pcd as jsave_pcd
from aosx.orchards import OrchardSpec as JSpec, make_orchard_np as jmake_np
from aosx_torch import dashboard, profiling
from aosx_torch.io.checkpoint import load_state
from aosx_torch.io.pcd import save_pcd
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.tree import leaves
from torch_helpers import one_torch_thread  # noqa: F401
from torch_reference.make_dashboard_reference import RUNS, expand, write_maps

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "tests/torch_reference/dashboard_np.json").read_text())


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    (d / "jax").mkdir()
    paths = write_maps(d, make_orchard_np, OrchardSpec, save_pcd)
    write_maps(d / "jax", jmake_np, JSpec, jsave_pcd)
    return d, paths


def test_maps_equal_the_jax_packages(maps):
    d, _ = maps
    names = sorted(p.name for p in (d / "jax").iterdir())
    assert len(names) == 5
    for name in names:
        assert (d / name).read_bytes() == (d / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("run", ["pcd_60", "seq_cached_90", "seq_serve_90"])
def test_report_matches_jax(maps, tmp_path, run, capsys):
    _, paths = maps
    out = tmp_path / "out"
    report, final = dashboard.main([*expand(RUNS[run], paths), "--device", "cpu",
                                    "--out", str(out)])
    printed = capsys.readouterr().out
    assert json.loads(printed[:printed.index("}\n") + 1]) == report
    assert report == REFERENCE["runs"][run]["report"]
    assert (out / "episode.png").exists()
    back = load_state(str(out / "episode_state"), final)
    assert all(torch.equal(a, b) for a, b in zip(leaves(final), leaves(back)))


def test_serve_and_cached_agree(maps):
    """The two serving variants reach the same completion and travel (as in
    the JAX package, where the figures are bit-identical by test)."""
    a = REFERENCE["runs"]["seq_cached_2400"]["report"]
    b = REFERENCE["runs"]["seq_serve_2400"]["report"]
    assert a["status"] == b["status"] == "Exploration Complete"
    assert (a["travel_distance"], a["incremental_levels"]) == \
        (b["travel_distance"], b["incremental_levels"])


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "aosx_torch.dashboard", "--steps", "5",
                        "--out", str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert not (tmp_path / "episode_state.npz").exists()


def test_serving_flags_need_a_sequence(tmp_path):
    for flag in ("--serve", "--cached"):
        with pytest.raises(SystemExit) as e:
            dashboard.main(["--device", "cpu", "--out", str(tmp_path), flag])
        assert e.value.code == 2


def test_figure_skipped_only_without_matplotlib(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    dashboard._save_figure("unused", None, None, None, None, None, None, False)
    assert "render skipped: matplotlib is not installed" in capsys.readouterr().out


def test_panel_total_waypoints():
    assert [dashboard.panel_total_waypoints(n) for n in (0, 1, 2, 5)] == [0, 3, 5, 11]


def test_profiling_on_cpu(tmp_path, capsys):
    x = torch.arange(1000, dtype=torch.float32)
    assert profiling.nan_guard(x, "x") is x and capsys.readouterr().out == ""
    bad = torch.tensor([1.0, float("nan")])
    assert profiling.nan_guard(bad, "bad") is bad
    assert "NaN/Inf detected in bad" in capsys.readouterr().out
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.sort(-x)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any("sort" in e.key for e in prof.key_averages())
