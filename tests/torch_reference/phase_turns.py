"""The host-bound paths of chip_smoke.py, serving (phase 7) and Monte-Carlo
(phase 9), of this checkout beside those of another checkout of the
repository, run in turns on one card: a before/after measurement of a change
that may move them.

Runs each checkout's own ``chip_smoke.phase_build``, ``phase_serving`` and
``phase_monte_carlo`` in a process of its own from that checkout's root, in
the order other, this, this, other, since host-bound times differ by up to 2x
between machines. Each turn's full log goes to
``chiprun_out/phase_turns_<n>.log``; prints one line per turn (serve_control_tick
median and max, rollouts/s, the phases' host wall) and a JSON summary.

Run from the repository root on a machine with the card, the other checkout
unpacked with ``git archive`` into a directory that .gitignore lists:

    python3 tests/torch_reference/phase_turns.py _archive/parent
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
d = torch.device("cuda", 0)
c.phase_build()
t0 = time.time(); _, serve = c.phase_serving(d); p7 = time.time() - t0
t0 = time.time(); _, mc = c.phase_monte_carlo(d); p9 = time.time() - t0
print("TURN " + json.dumps(dict(serve=serve, mc=mc, phase7_s=p7, phase9_s=p9)))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path)
    args = ap.parse_args(argv)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    turns = []
    for n, (side, root) in enumerate([("other", args.other.resolve()), ("this", ROOT),
                                      ("this", ROOT), ("other", args.other.resolve())]):
        r = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                           text=True)
        (out_dir / f"phase_turns_{n}.log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise SystemExit(f"turn {n} ({side}) failed:\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout[r.stdout.rindex("TURN ") + 5:])
        turns.append(dict(side=side, **res))
        print(f"turn {n} {side}: serve_control_tick median "
              f"{res['serve']['serve_control_tick_ms']} ms, max "
              f"{res['serve']['serve_control_tick_max_ms']} ms; "
              f"{res['mc']['rollouts_per_sec']} rollouts/s; phase 7 {res['phase7_s']:.1f} s, "
              f"phase 9 {res['phase9_s']:.1f} s", flush=True)
    print(json.dumps(turns))


if __name__ == "__main__":
    main()
