"""Monte-Carlo worlds of tests/torch_reference/make_mc_reference.py
(``make_orchard_np(MC_SPEC, seed=i)`` at MC_STATICS) against the JAX package,
bitwise: the perceive output (the seed set included) and the world of
``prepare_world_full``, and the harness's record against the reference's
``mc_np_seed0.json``.

Cases: world 106, where an endpoint-ray sample at y = 9.9 m lies on a cell
edge (XLA compiles aosx's division by the resolution as a product with its
f32 reciprocal, and a division puts the sample into a skeleton cell); world
125, where the same product decides a point's occupancy cell; world 67, where
two nodes' distances to a label's endpoint, 9e-8 m apart, tie in f32 as
XLA:CPU rounds them (one fused multiply-add), so the lower index wins; worlds
102 and 118, where two seeds tie exactly at a cell (102: seeds 85 and 88 at
(248, 352) in pass 7; 118: pass 6) and the flood's x plane, whose fold
rounds every d2 as fma(dy, dy, dx * dx), takes the other seed than its owner
plane: the position the cell carries on is then no seed's, and it wins 73
(992) cells of the owner plane, and in world 102 the record (its
steps_to_complete 5 ticks and its travel 0.38 m apart from a flood that
keeps each cell's position its owner's seed); worlds 7 and 74, where the
owner plane parted from JAX's in one cell while the port rounded the last
pass of an MC_STATICS flood otherwise than the JAX package's CPU lowering of
it; and world 0, bitwise before these repairs. JAX's world build is one jit
shared by every case, with ``jfa_dynamic_shifts=True`` as the reference
builds it (a whole static-shift flood does not finish on XLA:CPU), and
returns the owner plane of ``with_owner`` too."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx import engine as jengine
from aosx.config import MC_STATICS, AosParams as JParams, params_as_f32 as jparams
from aosx.types import PointCloud as JCloud, Polygon as JPolygon
from aosx_torch import engine
from aosx_torch.config import MC_STATICS as S, AosParams, params_as_f32
from aosx_torch.orchards import OrchardSpec, make_orchard_np
from aosx_torch.parallel.batch import sustained_rollouts
from aosx_torch.types import PointCloud, Polygon
from torch_helpers import assert_same, one_torch_thread, orchard_buffers  # noqa: F401

REFERENCE = pathlib.Path(__file__).resolve().parent / "torch_reference" / "mc_np_seed0.json"
WORLDS = (0, 7, 67, 74, 102, 106, 118, 125)


@pytest.fixture(scope="module")
def reference():
    return json.loads(REFERENCE.read_text())


@pytest.fixture(scope="module")
def jax_world():
    JS = dataclasses.replace(MC_STATICS, jfa_dynamic_shifts=True)
    excl = jnp.zeros((JS.max_exclusions, 3), jnp.float32)
    build = jax.jit(lambda pc, poly, p: jengine.prepare_world_full(pc, poly, p, excl, JS,
                                                                  with_owner=True))
    return lambda buf, valid, poly: build(JCloud(xyz=jnp.asarray(buf), valid=jnp.asarray(valid)),
                                          JPolygon.from_array(poly, JS), jparams(JParams()))


@pytest.mark.parametrize("world", WORLDS)
def test_mc_world_matches_jax(jax_world, reference, world):
    buf, valid, poly = orchard_buffers(S, seed=world, spec=OrchardSpec(**reference["spec"]))
    jw, jout, jowner = jax_world(buf, valid, poly)
    w, out, owner = engine.prepare_world_full(
        PointCloud(xyz=torch.from_numpy(buf), valid=torch.from_numpy(valid)),
        Polygon.from_array(poly, S, "cpu"), params_as_f32(AosParams(), "cpu"),
        torch.zeros((S.max_exclusions, 3)), S, with_owner=True)
    assert_same(jout, out)
    assert_same(jw, w)
    assert np.array_equal(owner.numpy(), np.asarray(jowner))
    assert int(w.waypoints.count) >= 4


def test_mc_records_match_reference(reference):
    """The cached harness over the six worlds in one refill group (one
    batched world build), each record every field of JAX's (world 102's
    too)."""
    spec = OrchardSpec(**reference["spec"])
    results, _ = sustained_rollouts(
        len(WORLDS), len(WORLDS), spec, params_as_f32(AosParams(), "cpu"), S,
        reference["steps_budget"], chunk_steps=reference["chunk_steps"], cached=True,
        clouds=lambda i: make_orchard_np(spec, seed=WORLDS[i]), device=torch.device("cpu"))
    for i, w in enumerate(WORLDS):
        want = reference["records"][w]
        got = {k: np.asarray(v)[i].item() for k, v in results.items()}
        assert {"travel_distance", "final_dist_to_origin", "steps_to_complete"} <= got.keys()
        assert got == {k: want[k] for k in got}, w
        assert got["completed"]
