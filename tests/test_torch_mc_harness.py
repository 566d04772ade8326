"""The port's Monte-Carlo harness against the JAX package's own, record for
record: ``aosx_torch.parallel.batch.sustained_rollouts`` on the CPU, cached,
on population keys (``prng.split(prng.prng_key(0), 4096)[ids]``), against
``aosx.parallel.batch.sustained_rollouts`` on the same keys
(tests/torch_reference/mc_harness_ref.json, written by
make_mc_harness_reference.py), every field of every record bitwise,
``feasible`` included.

Eight lanes, ids 0, 1, 2, 5, 7, 13, 23 and 58, no refill, for both
populations of ``benchmarks/bench_sustained.py``: the straight orchards at
MC_STATICS and the realism orchards (0.8 m bow, 15 % tree dropout) at
MC_REALISM_STATICS, whose lanes run out their budget or are infeasible
(ids 1, 2 and 13 here). ``aosx`` steps the lanes under ``jax.vmap``, and
XLA:CPU rounds a vmapped chunk otherwise than one rollout's scan: the
follower's y move is fused, and the travel segment, the control goal
distance and the mission target distance of the lanes in its vectorized
loop are not (``ops.vector_lanes``). While the port's chunk followed the
scan, straight ids 2 and 7 and realism ids 0 and 1 were 1 ulp off in
travel_distance and realism id 7 3 ulp off in final_dist_to_origin.
``tests/test_torch_mc_realism.py`` holds the one-lane harness."""

import json

import pytest

from torch_helpers import MC_HARNESS_REFERENCE, assert_records, mc_harness_run
from torch_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    return json.loads(MC_HARNESS_REFERENCE.read_text())


@pytest.mark.parametrize("population", ["straight", "realism"])
def test_eight_lanes_match_aosx_harness(reference, population):
    got, want = mc_harness_run(reference, population, "lanes8")
    assert_records(got, want, reference["populations"][population]["lanes8"]["ids"])
    if population == "straight":
        assert all(r["completed"] for r in got)
    else:
        # the realism lanes part ways: completed, infeasible, out of budget
        assert {r["feasible"] for r in got} == {0, 1}
        assert any(r["completed"] for r in got) and not all(r["completed"] for r in got)
