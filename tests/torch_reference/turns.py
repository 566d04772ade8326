"""What the kernel-turns scripts (``probe_turns.py``, ``ror_turns.py``,
``k1_turns.py``) share: another checkout's ``aosx_torch`` loaded beside this one's, and
functions timed on one card in turns between the checkouts, their results
held bitwise between them."""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aosx_torch.cuda_build import timed_ms  # noqa: E402


def load_other(root: pathlib.Path, module: str, alias: str = "aosx_torch_other"):
    """``aosx_torch.<module>`` of the checkout at ``root``, its package
    imported as ``alias`` (its kernels build into its own ``_build``)."""
    pkg = root.resolve() / "aosx_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.{module}")


def in_turns(cases, sides, order, device, reps, note=lambda name, ms: "", apart=()):
    """Time ``fn(sides[side])`` for each ``(name, fn)`` of ``cases`` and each
    side in ``order`` (e.g. other, this, this, other), each the median of
    ``reps`` calls with the card kept busy ahead (``timed_ms``); a case
    ``(name, fn, setup)`` times ``fn(sides[side], setup())`` with a fresh
    ``setup()`` made outside the timed window. Every side's result must be
    bitwise that of its own other turns and, unless ``name`` is in
    ``apart``, that of the first side in ``order``. Prints a line a turn,
    ``note(name, ms)`` at its end; returns ``{name: {side: [ms, ...]}}``."""
    summary = {}
    for name, fn, *setup in cases:
        results, times = {}, {s: [] for s in dict.fromkeys(order)}
        for side in order:
            out, ms = timed_ms(lambda *a: fn(sides[side], *a), device, reps, *setup)
            out = out if isinstance(out, tuple) else (out,)
            if side in results and not all(torch.equal(a, b) for a, b in zip(out, results[side])):
                raise AssertionError(f"{name}: {side} differs between its own calls")
            results[side] = out
            times[side].append(ms)
            print(f"{name}: {side} {ms:.4f} ms{note(name, ms)}", flush=True)
        first = results[order[0]]
        for side, out in results.items() if name not in apart else ():
            if not all(torch.equal(a, b) for a, b in zip(out, first)):
                raise AssertionError(f"{name}: {side} differs from {order[0]}")
        summary[name] = times
    return summary
