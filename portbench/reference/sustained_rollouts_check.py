"""The comparison that decides ``correct`` in the sustained Monte-Carlo
cells, against the reference of this folder, which shares no code with the
program.

From the seed's population keys of the compared rollouts the reference
draws each orchard (``orchard``), grows its grids and counts its rows
(``world``). From each world's tour and plan table, as the program's world
build gave them, it runs the rollout (``rollout``) and classifies the
tour's feasibility. The graph and A* that made the tour and the plans are
not worked out again: the tour's length is held to the rows the reference
finds instead, and each leg's plan to its target (the feasibility class).

Compared, each number against the configuration's ``limits``:

- ``answers_off``: compared rollouts whose completed, first completed
  tick, final status, tour length or guards differ, or whose world's
  feasibility class or row count (the program's labelled clusters)
  differs;
- ``record_gap``: the widest gap of travel or final distance, relative to
  the reference's value (at least 1 m).

Each of the two separates sound runs from the control (section 4 of
PERF.md); the tour's geometry (where the graph put each waypoint) has no
number of its own."""

from __future__ import annotations

import numpy as np

from . import keys as K
from . import orchard as O
from . import rollout as RO
from . import world as WO

DISCRETE = ("completed", "steps_to_complete", "final_status", "waypoints", "guards")
FLOATS = ("travel_distance", "final_dist_to_origin")


def run_reference(cfg: dict, seed: int, ids, tables: dict, device, dtype=None) -> dict:
    """What the reference makes of rollouts ``ids`` of the seed's
    population, given their worlds' tour and plan tables, with every float
    in ``dtype`` (float32 by default, the configuration's precision)."""
    import torch

    dtype = dtype or getattr(torch, cfg["precision"])
    p = cfg["semantics"]
    ids = np.asarray(ids)
    keys = K.population_keys(seed, int(ids.max()) + 1)[ids]
    n_rows = []
    with torch.no_grad():
        tab = {k: (v.to(device=device, dtype=dtype) if v.is_floating_point() else v.to(device))
               for k, v in tables.items()}
        feasible = RO.feasibility(tab, p).cpu().numpy()
        records = RO.simulate(tab, p, int(cfg["steps_budget"]), int(cfg["chunk_steps"]),
                              dtype, device)
        for g, key in enumerate(keys):
            pts, poly = O.orchard(key, cfg["orchard"], dtype, device)
            skel, frame = WO.grids(pts, poly, p)
            n_rows.append(len(WO.rows(skel, frame, poly, p)))
    return {"records": records, "feasible": feasible, "rows": np.asarray(n_rows)}


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers (name -> value) of ``got`` (records, feasible,
    rows) against the reference's."""
    off = (np.asarray(got["feasible"]) != ref["feasible"]) | (
        np.asarray(got["rows"]) != ref["rows"])
    gap = 0.0
    for g, (a, b) in enumerate(zip(got["records"], ref["records"])):
        off[g] |= any(a[k] != b[k] for k in DISCRETE)
        for k in FLOATS:
            d = abs(float(a[k]) - float(b[k]))
            gap = max(gap, d / max(abs(float(b[k])), 1.0) if np.isfinite(d) else np.inf)
    return {"answers_off": int(off.sum()), "record_gap": float(gap)}


def program_outputs(produced: dict) -> dict:
    """The program's side of the comparison: its records, feasibility
    classes and labelled-cluster counts."""
    return {"records": produced["records"], "feasible": produced["feasible"],
            "rows": produced["cluster_total"]}


def control(ctx, produced: dict, dtype) -> dict:
    """The control's compared numbers: the reference in ``dtype`` in the
    program's place, against the reference."""
    ref = run_reference(ctx.config, ctx.seed, produced["ids"], produced["tables"], ctx.device)
    low = run_reference(ctx.config, ctx.seed, produced["ids"], produced["tables"], ctx.device,
                        dtype)
    return compare(low, ref)


def check(ctx, produced: dict) -> dict:
    """name -> (value, limit) for a run's compared rollouts."""
    ref = run_reference(ctx.config, ctx.seed, produced["ids"], produced["tables"], ctx.device)
    got = compare(program_outputs(produced), ref)
    limits = ctx.config["limits"]
    return {k: (v, limits[k]) for k, v in got.items()}
