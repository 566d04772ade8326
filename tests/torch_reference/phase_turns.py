"""The host-bound paths of chip_smoke.py, stage_full (phase 5), serving
(phase 7) and Monte-Carlo (phase 9), of this checkout beside those of another
checkout of the repository, run in turns on one card: a before/after
measurement of a change that may move them.

Runs each checkout's own ``chip_smoke.phase_build``, ``phase_bench_slice``,
``phase_serving`` and ``phase_monte_carlo`` in a process of its own from that
checkout's root, in the order other, this, this, other, since host-bound
times differ by up to 2x between machines. Each turn's full log goes to ``phase_turns_<n>.log`` in
the output directory; prints one line per turn (stage_full;
serve_init, build_plan_cache, serve_control_tick median and max;
rollouts/s, a refill group's begin, the uncached lane-tick; the phases' host
wall) and a JSON summary. ``--phases 9`` runs phase 9 alone.

Run from the repository root on a machine with the card, the other checkout
unpacked with ``git archive`` into a directory that .gitignore lists:

    python3 tests/torch_reference/phase_turns.py _archive/parent [--phases 5,7,9]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

TURN = """
import json, sys, time, torch
import chip_smoke as c
sys.path.insert(0, "tests")
from aosx_torch.orchards import OrchardSpec
d = torch.device("cuda", 0)
c.phase_environment()
c.phase_build()
out = {{}}
if 5 in {phases}:
    spec = OrchardSpec(**json.loads(c.REFERENCE.read_text())["spec"])
    t0 = time.time(); _, out["stages"] = c.phase_bench_slice(d, spec); out["phase5_s"] = time.time() - t0
if 7 in {phases}:
    t0 = time.time(); _, out["serve"] = c.phase_serving(d); out["phase7_s"] = time.time() - t0
if 9 in {phases}:
    t0 = time.time(); _, out["mc"] = c.phase_monte_carlo(d); out["phase9_s"] = time.time() - t0
print("TURN " + json.dumps(out))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--phases", default="7,9", help="comma-separated, of 5, 7 and 9")
    args = ap.parse_args(argv)
    phases = sorted({int(x) for x in args.phases.split(",")})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    turns = []
    for n, (side, root) in enumerate([("other", args.other.resolve()), ("this", ROOT),
                                      ("this", ROOT), ("other", args.other.resolve())]):
        r = subprocess.run([sys.executable, "-c", TURN.format(phases=phases)], cwd=root,
                           capture_output=True, text=True)
        (out_dir / f"phase_turns_{n}.log").write_text(r.stdout + r.stderr)
        if n == 0:
            print(r.stdout.splitlines()[0], flush=True)       # the card's name and power limit
        if r.returncode != 0:
            raise SystemExit(f"turn {n} ({side}) failed:\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout[r.stdout.rindex("TURN ") + 5:])
        turns.append(dict(side=side, **res))
        parts = []
        if "stages" in res:
            parts.append(f"stage_full {res['stages']['stage_full_ms']} ms; phase 5 "
                         f"{res['phase5_s']:.1f} s")
        if "serve" in res:
            sv = res["serve"]
            parts.append(f"serve_init {sv['serve_init_ms']} ms, build_plan_cache "
                         f"{sv['build_plan_cache_ms']} ms, serve_control_tick median "
                         f"{sv['serve_control_tick_ms']} ms, max {sv['serve_control_tick_max_ms']} "
                         f"ms; phase 7 {res['phase7_s']:.1f} s")
        if "mc" in res:
            mc = res["mc"]
            parts.append(f"{mc['rollouts_per_sec']} rollouts/s; begin {mc['begin_group_ms']:.0f} "
                         f"ms a group; chunk {mc['chunk_call_ms']:.0f} ms a call; uncached "
                         f"lane-tick {mc['uncached_lane_tick_us']} us; phase 9 "
                         f"{res['phase9_s']:.1f} s")
        print(f"turn {n} {side}: " + "; ".join(parts), flush=True)
    print(json.dumps(turns))


if __name__ == "__main__":
    main()
