"""K1 (``jfa_flood``) of this checkout beside that of other checkouts of
the repository, timed in turns on one card: a before/after measurement of a
change to ``aosx_torch/csrc/jfa_pass.cu``.

Loads each other checkout's ``aosx_torch`` under another name (its kernels
build into its own ``_build``), then times a whole flood in the order
others, this, this, others reversed on ``chip_smoke.py`` phase 2's inputs (``k1_case``: a full
grid with max_seeds random seeds) at BENCH_STATICS (2000 x 2048) and
MC_STATICS (384 x 512), each in two lowerings' roundings, every checkout
its own (``voronoi.pass_roundings`` of its own ``aosx_torch``): the static
shifts' ("xla") and the Pallas lowering's, where ``aosx`` would run a pass
through its Pallas kernel (the preset with ``jfa_pass_pallas`` on); the
BENCH flood in the Pallas roundings over a plane without owners (loads,
stores and barriers alone); and a group of 32 MC_STATICS floods in one call
(``chip_smoke.k1_group_case``, phase 2's world axis). A
checkout that predates the roundings runs its one rounding ("xla") in both
cases. Where every checkout folds the three planes as this one does, the
results must be bitwise between all checkouts; otherwise (a checkout whose
flood carries the owner plane alone, or that predates the roundings) the
cases are timed side by side but not compared. Each time is
the median of ``--reps`` floods by CUDA events with the card kept busy ahead
of every call (``cuda_build.timed_ms``), the owner plane cloned outside the
timed window, printed with its share of the flood's bound
(``chip_smoke.k1_ops_by_pass`` beside the plane in and out). Prints the
card's name and power limit, then a JSON summary.

Run from the repository root on a machine with the card, each other checkout
unpacked with ``git archive`` into a directory that .gitignore lists:

    python3 tests/torch_reference/k1_turns.py _archive/parent [more ...] [--reps 9]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import pathlib

import numpy as np
import torch

from turns import in_turns, load_other

import chip_smoke
from aosx_torch.config import BENCH_STATICS, MC_STATICS
from aosx_torch.gvd import jfa_pass_cuda, voronoi


def flood_bound(S, owner0, table, steps, rounding, args):
    """K1's bound for one flood (ms): the plane in and out with the table, or
    the passes' operations counted on this flood's states."""
    n = S.max_seeds
    *before, _ = jfa_pass_cuda.jfa_states_plain(owner0, table, steps, *args, rounding)
    ops = float(np.sum(chip_smoke.k1_ops_by_pass(before, steps, n, S.grid_h + S.grid_w,
                                                  rounding)))
    return max(chip_smoke.bound(8 * S.grid_h * S.grid_w + 8 * (n + 1))[0], ops)


def flood_case(sides, lowerings, statics, table, steps, fargs):
    """``fn(flood, owner)``: a flood of ``steps`` through one side's
    ``jfa_flood``, each side in its own roundings of the lowering
    ``statics`` asks (``voronoi.pass_roundings`` of its own ``aosx_torch``)."""
    roundings = {side: lowerings[side].pass_roundings(statics, steps)
                 for side in sides if hasattr(lowerings[side], "pass_roundings")}

    def fn(flood, o):
        if "rounding" in inspect.signature(flood).parameters:
            side = next(k for k, v in sides.items() if v is flood)
            return flood(o, table, steps, *fargs, rounding=roundings[side])
        return flood(o, table, steps, *fargs)

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=pathlib.Path, nargs="+")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    card = chip_smoke.phase_environment()
    sides = {"this": jfa_pass_cuda.jfa_flood}
    lowerings = {"this": voronoi}
    for i, root in enumerate(args.others):
        sides[str(root)] = load_other(root, "gvd.jfa_pass_cuda",
                                      f"aosx_torch_other{i}").jfa_flood
        lowerings[str(root)] = importlib.import_module(f"aosx_torch_other{i}.gvd.voronoi")
    # checkouts whose floods may part from this one's: no roundings, or
    # another table of them (an owner plane carried alone)
    plain = {name for name, fn in sides.items()
             if "rounding" not in inspect.signature(fn).parameters
             or getattr(lowerings[name], "ROUNDINGS", None) != voronoi.ROUNDINGS}
    cases, bounds, apart = [], {}, set()
    for preset, S in (("BENCH_STATICS", BENCH_STATICS), ("MC_STATICS", MC_STATICS)):
        grid, seeds = chip_smoke.k1_case(S, device)
        owner0, table = voronoi._jfa_init(grid, seeds, S)
        steps = voronoi._passes(S)
        pallas = dataclasses.replace(S, jfa_pass_pallas=True, jfa_dynamic_shifts=False)
        n = S.max_seeds
        fargs = (n, grid.origin_x, grid.origin_y, S.resolution)
        static = dataclasses.replace(S, jfa_pass_pallas=False, jfa_dynamic_shifts=False)
        for rname, statics in (("xla", static), ("pallas", pallas)):
            name = f"{preset} {rname}"
            bounds[name] = flood_bound(S, owner0, table, steps,
                                       voronoi.pass_roundings(statics, steps), fargs)
            if plain:
                apart.add(name)
            fn = flood_case(sides, lowerings, statics, table, steps, fargs)
            cases.append((name, fn, owner0.clone))
            if preset == "BENCH_STATICS" and rname == "pallas":
                # the same flood over a plane without owners: no candidate
                # is folded
                empty = f"{name}, no owners"
                bounds[empty] = chip_smoke.bound(8 * S.grid_h * S.grid_w + 8 * (n + 1))[0]
                if plain:
                    apart.add(empty)
                cases.append((empty, fn, lambda o=owner0, n=n: torch.full_like(o, n)))
    # a refill group's worth of MC floods in one call
    S = MC_STATICS
    grid, seeds = chip_smoke.k1_group_case(S, chip_smoke.WORLDS, device)
    owner0, table = voronoi._jfa_init(grid, seeds, S)
    steps = voronoi._passes(S)
    fargs = (S.max_seeds, grid.origin_x, grid.origin_y, S.resolution)
    name = f"MC_STATICS group of {chip_smoke.WORLDS}"
    bounds[name] = chip_smoke.k1_group_bound(owner0, table, steps, fargs,
                                             voronoi.pass_roundings(S, steps))[0]
    if plain:
        apart.add(name)
    cases.append((name, flood_case(sides, lowerings, S, table, steps, fargs), owner0.clone))
    others = [str(root) for root in args.others]
    summary = in_turns(
        cases, sides, [*others, "this", "this", *reversed(others)], device, args.reps,
        note=lambda name, ms: f", {100 * bounds[name] / ms:.1f} % of the bound "
                              f"{bounds[name]:.4f} ms", apart=apart)
    print(card, flush=True)
    print(json.dumps({name: dict(bound_ms=bounds[name], **t) for name, t in summary.items()}))


if __name__ == "__main__":
    main()
