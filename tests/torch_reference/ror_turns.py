"""K3 (``ror_counts``) of this checkout beside that of other checkouts of
the repository, timed in turns on one card: a before/after measurement of a
change to ``aosx_torch/csrc/ror_counts.cu``.

Loads each other checkout's ``aosx_torch`` under another name (its kernels
build into its own ``_build``), then times K3 in the order others, this,
this, others reversed on the three inputs of ``chip_smoke.py`` phase 6: the
bench cloud and the uniform cloud (131,072 points each) and the group of 32
Monte-Carlo clouds of 4,096 points in one launch. Each time is the median
of ``--reps`` calls by CUDA events with the card kept busy ahead of every
call (``cuda_build.timed_ms``), printed with its share of K3's bound
(``chip_smoke.k3_bound``: the n (n + 1) / 2 pairs a world). The counts must
be bitwise equal between all checkouts. Several others time a sweep, e.g.
copies of this tree with other ``ROWS`` and ``THREADS`` in
``ror_counts.cu``. Prints the card's name and power limit, then a JSON
summary.

Run from the repository root on a machine with the card, each other checkout
unpacked with ``git archive`` into a directory that .gitignore lists:

    python3 tests/torch_reference/ror_turns.py _archive/parent [more ...] [--reps 9]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from turns import in_turns, load_other

import chip_smoke
from aosx_torch.orchards import OrchardSpec
from aosx_torch.perceive import ror_cuda


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=pathlib.Path, nargs="+")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    card = chip_smoke.phase_environment()
    sides = {"this": ror_cuda.ror_counts}
    others = [str(root) for root in args.others]
    for i, root in enumerate(args.others):
        sides[str(root)] = load_other(root, "perceive.ror_cuda", f"aosx_torch_other{i}").ror_counts
    bench_spec = OrchardSpec(**json.loads(chip_smoke.REFERENCE.read_text())["spec"])
    clouds, r2 = chip_smoke.k3_clouds(device, bench_spec)
    group, r2_group = chip_smoke.k3_group(device)
    inputs = {name: (pts, r2) for name, pts in clouds}
    inputs[f"group of {group.shape[0]}"] = (group, r2_group)
    bounds = {name: chip_smoke.k3_bound(pts.shape[0] if pts.dim() == 3 else 1, pts.shape[-2])[0]
              for name, (pts, _) in inputs.items()}
    cases = [(name, lambda fn, x=x: fn(*x)) for name, x in inputs.items()]
    summary = in_turns(
        cases, sides, [*others, "this", "this", *reversed(others)], device, args.reps,
        note=lambda name, ms: f", {100 * bounds[name] / ms:.1f} % of the bound "
                              f"{bounds[name]:.4f} ms")
    print(card, flush=True)
    print(json.dumps({name: dict(bound_ms=bounds[name], **t) for name, t in summary.items()}))


if __name__ == "__main__":
    main()
