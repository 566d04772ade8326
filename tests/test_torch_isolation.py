"""The port stands alone: it imports with jax blocked (and with pyyaml,
matplotlib and OpenCV blocked, which the card's machine lacks), names neither
jax nor the JAX package, imports no ``torch.distributed`` at module level,
and its GPU smoke run refuses to run without a card."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "aosx_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py"
)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.update(extra)
    return env


def test_port_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['aosx'] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert {"aosx_torch.engine", "aosx_torch.gvd.jfa_pass_cuda", "aosx_torch.serving",
            "aosx_torch.incremental", "aosx_torch.plan.plancache",
            "aosx_torch.perceive.ror_cuda", "aosx_torch.io.checkpoint",
            "aosx_torch.parallel.batch", "aosx_torch.parallel.sweep", "aosx_torch.probes",
            "aosx_torch.tree", "aosx_torch.dashboard", "aosx_torch.geo",
            "aosx_torch.profiling", "aosx_torch.prng", "aosx_torch.f32math",
            "aosx_torch.gvd.clearance",
            "aosx_torch.io.pcd", "aosx_torch.io.ros_msgs", "aosx_torch.io.render",
            "aosx_torch.native.binding", "aosx_torch.native.build",
            "aosx_torch.oracle.perceive", "aosx_torch.oracle.gvd", "aosx_torch.oracle.plan",
            "aosx_torch.parallel.spatial"} <= set(MODULES)


def test_port_imports_with_yaml_and_matplotlib_blocked():
    """The card's machine has neither pyyaml nor matplotlib nor OpenCV: the
    modules that use them (config, io.render, dashboard, oracle) import them
    only when called."""
    code = ("import sys, importlib\n"
            "for m in ('jax', 'aosx', 'yaml', 'matplotlib', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'aosx_torch.dashboard' in sys.modules\n"
            "assert 'aosx_torch.oracle.gvd' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_or_aosx_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "aosx"}, roots


def test_no_torch_distributed_at_module_level():
    """The mesh of parallel/spatial.py is a tuple of devices driven from one
    process: no module of the port (nor chip_smoke.py) imports
    torch.distributed when it is imported."""
    bad = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [f"{node.module}.{a.name}" for a in node.names]
            if any(n == "torch.distributed" or n.startswith("torch.distributed.")
                   for n in names):
                bad.append(str(path.relative_to(ROOT)))
    assert not bad, bad


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
