"""Readings that set the limits of the comparison that decides ``correct``,
at a cell's own size; the benchmark's own runs do not make them.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--seconds 8]
    python3 portbench/control.py --workload <name> --seeds 11,12,13 --fault half_lanes

Without ``--fault``: the control. Each seed runs the cell (set-up, a short
window, the compared outputs collected), then the reference, put in the
program's place, computed in bfloat16 (the nearest precision below the
configuration's float32), is judged against the
reference by the run's comparison; it has to come out as not correct. The
program's own numbers of that run are printed beside it (sound readings).
With ``--fault``: the run with that fault planted in its timed path, judged
as a run is. One JSON line a seed."""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(bench, cell, seed: int, seconds: float, device, dtype=None, fault=None,
             config=None, traffic=None) -> dict:
    """One seed's readings: {"program": ..., "control": ...} without a
    fault, {"fault": ...} with one; each maps a compared number to its
    value."""
    from portbench.harness import runner, spec

    traffic = traffic if traffic is not None else spec.traffic(cell["traffic"])
    mod = spec.driver(traffic["driver"])
    out = {}

    def both(ctx, produced):
        out["control"] = mod.control(ctx, produced, dtype)
        return mod.check(ctx, produced)

    _, checks, _ = runner.run_cell(bench, cell, seed, seconds, False, time.perf_counter(),
                                   device, config, traffic, fault,
                                   check=None if fault else both)
    out["fault" if fault else "program"] = {k: v for k, (v, _) in checks.items()}
    return out


def main(argv) -> int:
    import argparse

    import torch

    from portbench.harness import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    limits = spec.config(bench, cell["config"])["limits"]
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(bench, cell, seed, args.seconds, device, torch.bfloat16, args.fault)
        judged = got.get("control", got.get("fault"))
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "seconds": time.perf_counter() - t0, **got,
                          "fails": [k for k, v in judged.items() if v > limits[k]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
