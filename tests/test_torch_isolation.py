"""The port stands alone: it imports with jax blocked, names neither jax nor
the JAX package, and its GPU smoke run refuses to run without a card."""

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
            "aosx_torch.tree"} <= set(MODULES)


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


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
