"""P1 and P3 of this checkout beside those of another checkout of the
repository, timed in turns on one card: a before/after measurement of a
change to ``aosx_torch/csrc/probe_prims.cu``.

Loads the other checkout's ``aosx_torch`` under another name (its kernels
build into its own ``_build``), then times, in the order other, this, this,
other: P1 (``chase_rw``) with the table in shared memory and in global
memory, and P3 (``gather_rows``) on the probe's input and on
``gather_rows_random_inputs``. Each time is the median of ``--reps`` calls
by CUDA events with the card kept busy ahead of every call
(``cuda_build.timed_ms``). Every result must be bitwise equal between the two
checkouts. Prints one line per kernel and turn, then a JSON summary.

Run from the repository root on a machine with the card, the other checkout
unpacked with ``git archive`` into a directory that .gitignore lists:

    python3 tests/torch_reference/probe_turns.py _archive/parent [--reps 9]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aosx_torch import probes  # noqa: E402
from aosx_torch.cuda_build import timed_ms  # noqa: E402


def load_other(root: pathlib.Path):
    """The ``aosx_torch.probes`` module of the checkout at ``root``."""
    pkg = root.resolve() / "aosx_torch"
    spec = importlib.util.spec_from_file_location(
        "aosx_torch_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["aosx_torch_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("aosx_torch_other.probes")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    sides = {"other": load_other(args.other), "this": probes}
    seed = probes.seed_tensor(device)
    probe_in = probes.gather_rows_inputs(device)
    random_in = probes.gather_rows_random_inputs(device)
    cases = [
        ("P1 shared-memory table", lambda m: m.chase_rw(seed, shared=True)),
        ("P1 global-memory table", lambda m: m.chase_rw(seed, shared=False)),
        ("P3 probe input", lambda m: m.gather_rows(*probe_in)),
        ("P3 random input", lambda m: m.gather_rows(*random_in)),
    ]
    print(f"# {torch.cuda.get_device_name(device)}", flush=True)
    summary = {}
    for name, fn in cases:
        results, times = {}, []
        for side in ("other", "this", "this", "other"):
            out, ms = timed_ms(lambda: fn(sides[side]), device, args.reps)
            out = out if isinstance(out, tuple) else (out,)
            if side in results and not all(torch.equal(a, b) for a, b in zip(out, results[side])):
                raise AssertionError(f"{name}: {side} differs between its own calls")
            results[side] = out
            times.append((side, ms))
            print(f"{name}: {side} {ms:.4f} ms", flush=True)
        if not all(torch.equal(a, b) for a, b in zip(results["other"], results["this"])):
            raise AssertionError(f"{name}: the two checkouts differ")
        summary[name] = {s: [ms for side, ms in times if side == s] for s in ("other", "this")}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
