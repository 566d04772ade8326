"""Operations a tick and a linearize call dispatch, in this checkout and in
another one: the launch counts behind the host-bound times of
``chip_smoke.py``'s phase 9 (the cached and the uncached tick) and phase 7
(a batched linearize), counted on the CPU with a TorchDispatchMode.

Counts every aten operation that runs a kernel (views, selects and other
metadata operations left out), for:

- one cached tick (``plancache.step_cached``) of the Monte-Carlo orchard at
  MC_STATICS, after 30 ticks, one lane;
- one uncached tick (``engine.step``) of the test orchard at TEST_STATICS,
  averaged over 20 ticks;
- one ``linearize`` call over the 73 BENCH raw A* paths of
  serving_np_seed0_frame0.npz.

Run from the repository root (torch on the CPU; a few seconds a checkout):

    python tests/torch_reference/op_counts.py [other_checkout]
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

COUNT = r"""
import json, sys
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
sys.path.insert(0, "tests")
from aosx_torch import engine
from aosx_torch.config import BENCH_STATICS, MC_STATICS, TEST_STATICS, AosParams, params_as_f32
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.parallel import batch
from aosx_torch.plan import plancache
from aosx_torch.plan.linearize import linearize
from aosx_torch.types import Path, PointCloud, Polygon
from torch_helpers import orchard_buffers

META = {"view.dtype", "detach", "view", "select.int", "lift_fresh", "alias", "unsqueeze",
        "slice.Tensor", "expand", "unbind.int", "_unsafe_view", "squeeze.dim", "t", "permute",
        "reshape", "_local_scalar_dense", "scalar_tensor"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func).replace("aten.", "").replace(".default", "")
        self.n += name not in META
        return func(*args, **(kwargs or {}))


def counted(fn):
    with Count() as c:
        out = fn()
    return c.n, out


cpu = torch.device("cpu")
params = params_as_f32(AosParams(), "cpu")
spec = OrchardSpec(n_rows=4, row_len=12.0, row_spacing=3.5, tree_spacing=1.0, trunk_pts=16,
                   noise_pts=64, origin=(4.0, 3.0), polygon_pad=1.5)
lite, cache, st, acc = batch._begin_cached(
    batch.cloud_tensors(make_orchard_np(spec, seed=0), MC_STATICS, cpu), params, MC_STATICS,
    300, "sorted")
for _ in range(30):
    st, _ = plancache.step_cached(st, lite, cache, params, MC_STATICS)
cached, _ = counted(lambda: plancache.step_cached(st, lite, cache, params, MC_STATICS))

S = TEST_STATICS
buf, valid, poly = orchard_buffers(S, seed=0)
world = engine.prepare_world(PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
                             Polygon.from_array(poly, S, "cpu"), params,
                             torch.zeros((S.max_exclusions, 3)), S)
est = engine.initial_state(world, S)
total = 0
for _ in range(20):
    n, (est, _) = counted(lambda: engine.step(est, world, params, S, v_dt=0.5))
    total += n

d = np.load("tests/torch_reference/serving_np_seed0_frame0.npz")
path = Path(xy=torch.from_numpy(d["raw_xy"]), yaw=torch.zeros(d["raw_xy"].shape[:2]),
            count=torch.from_numpy(d["raw_count"]))
lin, _ = counted(lambda: linearize(path, params, BENCH_STATICS))
print("COUNTS " + json.dumps(dict(cached_tick=cached, uncached_tick=total / 20,
                                  linearize_73_bench_rows=lin)))
"""


def counts(root: pathlib.Path) -> dict:
    r = subprocess.run([sys.executable, "-c", COUNT], cwd=root, capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{root}: {r.stderr[-2000:]}")
    return json.loads(r.stdout[r.stdout.rindex("COUNTS ") + 7:])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = {"this": counts(ROOT)}
    if argv:
        out["other"] = counts(pathlib.Path(argv[0]).resolve())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
