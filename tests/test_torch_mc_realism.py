"""The realism Monte-Carlo configuration (``benchmarks/bench_sustained.py
... cached realism``: curved rows with a 0.8 m bow, 15 % tree dropout) in
the port against the JAX package.

- Worlds leaf for leaf: the perceive output, the world and the owner plane
  of ``engine.prepare_world_full`` on population keys, against the digests
  of ``aosx``'s jitted build (tests/torch_reference/realism_worlds_ref.json,
  make_realism_worlds_reference.py): at MC_REALISM_STATICS ids 0, 1 (an
  infeasible tour), 5 (a lane that runs out its budget) and 13, with each
  world's plan cache and tour feasibility; at MC_STATICS' caps ids 2 and 7,
  whose long ridge candidates raise GUARD_EDGE_COARSE in both packages.
- The one-lane harness: ids 2 and 7 through one lane, refilled once, every
  record field bitwise ``aosx``'s harness at one lane, for both populations
  (mc_harness_ref.json; a vmap over one lane rounds as one rollout's
  scan)."""

import json
import pathlib

import pytest
import torch

from aosx_torch import engine, prng
from aosx_torch.config import MC_REALISM_STATICS, MC_STATICS, AosParams, params_as_f32
from aosx_torch.guards import GUARD_EDGE_COARSE
from aosx_torch.orchards import OrchardSpec, make_orchard
from aosx_torch.plan import plancache
from torch_helpers import MC_HARNESS_REFERENCE, assert_records, leaf_digests, mc_harness_run
from torch_helpers import one_torch_thread  # noqa: F401

REFERENCE = pathlib.Path(__file__).resolve().parent / "torch_reference" / "realism_worlds_ref.json"
STATICS = {"MC_STATICS": MC_STATICS, "MC_REALISM_STATICS": MC_REALISM_STATICS}
CPU = torch.device("cpu")
CASES = ["MC_REALISM_STATICS/0", "MC_REALISM_STATICS/1", "MC_REALISM_STATICS/5",
         "MC_REALISM_STATICS/13", "MC_STATICS/2", "MC_STATICS/7"]


@pytest.fixture(scope="module")
def reference():
    return json.loads(REFERENCE.read_text())


@pytest.mark.parametrize("case", CASES)
def test_realism_world_matches_jax(reference, case):
    want = reference["cases"][case]
    S = STATICS[want["statics"]]
    key = prng.split(prng.prng_key(reference["population"]["seed"], CPU),
                     reference["population"]["size"])[want["id"]]
    pc, poly = make_orchard(key, OrchardSpec(**reference["spec"]), S, CPU)
    params = params_as_f32(AosParams(), CPU)
    world, out, owner = engine.prepare_world_full(pc, poly, params,
                                                  torch.zeros((S.max_exclusions, 3)), S,
                                                  with_owner=True)
    got = dict(perceive=leaf_digests(out), world=leaf_digests(world), owner=leaf_digests(owner))
    if "cache" in want["digests"]:
        cache = plancache.build_plan_cache(world, params, S)
        got.update(cache=leaf_digests(cache), feasibility=leaf_digests(
            plancache.tour_feasibility(cache, world.waypoints, params, S)))
    assert got.keys() == want["digests"].keys()
    for part in got:
        bad = sorted(k for k in want["digests"][part]
                     if got[part].get(k) != want["digests"][part][k])
        assert got[part].keys() == want["digests"][part].keys(), part
        assert not bad, f"{part}: leaves differ from aosx's: {bad}"
    assert int(world.guards) == want["guards"]
    assert bool(int(world.guards) & GUARD_EDGE_COARSE) == (want["statics"] == "MC_STATICS")


@pytest.mark.parametrize("population", ["straight", "realism"])
def test_one_lane_matches_aosx_harness(population):
    ref = json.loads(MC_HARNESS_REFERENCE.read_text())
    got, want = mc_harness_run(ref, population, "lane1")
    assert_records(got, want, ref["populations"][population]["lane1"]["ids"])
