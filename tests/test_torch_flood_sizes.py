"""The port's jump flood against the JAX package's at the grid sizes whose
Pallas lowering differs: one row band (nb = 1, where XLA removes the Pallas
grid loop and fuses a pass into its consumers: ``voronoi.CHAINS``), bands
of 8 rows, two and three bands, and the sizes with static XLA passes among
the Pallas ones, each in ``Statics.for_grid``'s lowering.

The planes are seeds in swapped pairs about cell corners (every cell on a
pair's 45-degree line sees the two at swapped offsets, so the forms of d2
decide it; at these resolutions, near ties). 64 x 128 (one band) runs JAX
live: the whole jitted flood, the Pallas pass in interpret mode as
``aosx``'s tests run it. 64 x 256 and 96 x 128 (one band at 0.1 m) hold
the chain's two versions of a cell's y (``voronoi.CHAIN_VERSIONS``); banded
grids 128 to 447 wide against 448 and wider hold the cells' x rounded twice
or once (``voronoi.SPLIT_X_MAX_W``). The larger sizes are held against
``tests/torch_reference/make_flood_sizes_reference.py``'s stored JAX floods
(their owner plane, and the three carried planes of the same flood with its
last pass keeping x and y); the port runs live.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from aosx_torch.config import Statics
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.types import GridWorld, SeedSet
from torch_helpers import one_torch_thread  # noqa: F401

REF_DIR = pathlib.Path(__file__).parent / "torch_reference"
sys.path.insert(0, str(REF_DIR))
import make_flood_sizes_reference as ref  # noqa: E402
from flood_planes import unpack  # noqa: E402

STORED = [n for n in ref.SIZES]


def _port(xy, H, W):
    i32 = dict(dtype=torch.int32)
    grid = GridWorld(torch.zeros((H, W), dtype=torch.uint8), torch.tensor(ref.ORIGIN),
                     torch.tensor(ref.ORIGIN), torch.tensor(H, **i32), torch.tensor(W, **i32))
    seeds = SeedSet(torch.from_numpy(xy), torch.ones(len(xy), dtype=torch.bool),
                    torch.zeros(len(xy), dtype=torch.int8))
    return grid, seeds


def _planes_rounding(s, steps, shape):
    """pass_roundings with the last pass keeping its x and y planes as the
    jit's outputs: over more bands than one the loop body's fusions
    ("pallas"); over one band, three fusions that write the outputs, which
    that jit's LLVM IR rounds as the XLA lowering's ("xla": the x plane's
    fusion loads every candidate's y first)."""
    rounding = voronoi.pass_roundings(s, steps, shape)
    rounding[-1] = {"pallas_last": "xla" if voronoi.pallas_bands(shape[0], steps[-1]) == 1
                    else "pallas", "pallas_last_narrow": "pallas_narrow"}[rounding[-1]]
    return rounding


@pytest.mark.parametrize("name", STORED)
def test_flood_matches_stored_jax(name):
    """At each size: the port's flood == JAX's jitted jump_flood in every
    cell (up to 1000 x 1024 through jump_flood itself; every size through
    its plain K1, the passes but the last once, then the last pass as the
    flood's, its owner plane alone), and the port's carried owner, x and y
    planes == those of JAX's flood jitted with its carried planes returned
    (the same passes, then the last one keeping its planes), bitwise."""
    H, W, res = ref.SIZES[name]
    data = dict(np.load(REF_DIR / f"flood_sizes_{name}.npz"))
    xy = data["xy"]
    S = len(xy)
    s = Statics.for_grid(H, W, res)
    grid, seeds = _port(xy, H, W)
    want = unpack("owner/", data, xy, (H, W))[0]
    if H * W <= 1024 * 1024:
        assert np.array_equal(voronoi.jump_flood(grid, seeds, s).numpy(), want)
    steps = voronoi._passes(s)
    rounding = voronoi.pass_roundings(s, steps, (H, W))
    args = (S, ref.ORIGIN, ref.ORIGIN, res)
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    before = jfa_pass_cuda.jfa_flood_plain(owner0, table, steps[:-1], *args, rounding[:-1])
    last = jfa_pass_cuda.jfa_pass_plain(*before, steps[-1], *args, rounding[-1])[0]
    assert np.array_equal(torch.where(last < S, last, -1).numpy(), want)
    got = jfa_pass_cuda.jfa_pass_plain(*before, steps[-1], *args,
                                       _planes_rounding(s, steps, (H, W))[-1])
    for a, b in zip(got, unpack("planes/", data, xy, (H, W))[0]):
        assert np.array_equal(a.numpy().view(np.int32), b.view(np.int32))


@pytest.fixture(scope="module")
def one_band():
    """64 x 128 in for_grid's lowering: JAX's whole jitted flood (interpret
    mode) of a plane of swapped pairs other than the stored one."""
    import jax

    from aosx.config import Statics as JStatics
    from aosx.gvd import jfa_pass_pallas as jpp, voronoi as jvoronoi

    H, W, res = ref.SIZES["64x128"]
    xy = ref.swapped_pairs(128, H, W, res, ref.ORIGIN, seed=1)
    js = JStatics.for_grid(H, W, res)
    grid = ref.GridWorld(jax.numpy.zeros((H, W), jax.numpy.uint8), np.float32(ref.ORIGIN),
                         np.float32(ref.ORIGIN), np.int32(H), np.int32(W))
    seeds = ref.SeedSet(jax.numpy.asarray(xy), jax.numpy.ones(len(xy), bool),
                        jax.numpy.zeros(len(xy), jax.numpy.int8))
    jpp.INTERPRET = True
    try:
        want = np.asarray(jax.jit(lambda g, se: jvoronoi.jump_flood(g, se, js))(grid, seeds))
    finally:
        jpp.INTERPRET = False
    return dict(xy=xy, want=want, s=Statics.for_grid(H, W, res), H=H, W=W, res=res)


def test_one_band_flood_matches_live_jax(one_band):
    """One band (64 x 128): every Pallas pass runs over one band, XLA fuses
    the step-1 pass and the passes at steps 64 to 8 into a chain, and the
    port's jump_flood == JAX's in every cell."""
    c = one_band
    grid, seeds = _port(c["xy"], c["H"], c["W"])
    got = voronoi.jump_flood(grid, seeds, c["s"]).numpy()
    assert int((got != c["want"]).sum()) == 0
    assert voronoi.pass_roundings(c["s"], voronoi._passes(c["s"])) == [
        "band_window", "chain", "chain", "chain", "chain", "band", "band", "pallas_last"]


@pytest.mark.parametrize("fused", [False, True])
def test_one_band_chain_decides_ties(one_band, fused):
    """The chain is what decides: with every pass folded from the carried
    planes alone (each chain key replaced by "band", no own candidate
    recomputed), the flood parts from JAX's in some cells; with the chain,
    in none."""
    c = one_band
    grid, seeds = _port(c["xy"], c["H"], c["W"])
    steps = voronoi._passes(c["s"])
    rounding = voronoi.pass_roundings(c["s"], steps)
    if not fused:
        rounding = ["band" if r in voronoi.CHAINS else r for r in rounding]
    owner0, table = voronoi._jfa_init(grid, seeds, c["s"])
    got = jfa_pass_cuda.jfa_flood(owner0, table, steps, len(c["xy"]), ref.ORIGIN, ref.ORIGIN,
                                  c["res"], rounding=rounding)
    off = int((torch.where(got < len(c["xy"]), got, -1).numpy() != c["want"]).sum())
    assert off == 0 if fused else off > 0


@pytest.mark.parametrize("H", [8, 64, 72, 96, 100, 104, 112, 136, 192, 2000])
def test_band_height_is_the_pallas_kernels(H):
    """The port's copy of the Pallas pass's band rule equals aosx's
    _band_height at every halo of steps 1 to 128."""
    from aosx.gvd import jfa_pass_pallas as jpp

    for step in (1, 2, 4, 8, 16, 32, 64, 128):
        hp = max(8, ((step + 7) // 8) * 8)
        assert voronoi.band_height(H, hp) == jpp._band_height(H, hp)
        assert voronoi.pallas_bands(H, step) == H // jpp._band_height(H, hp)


def test_chain_keys_follow_the_bands():
    """pass_roundings over grids whose passes mix one band and more: 104 x
    256 runs its step-128 pass over 13 bands (a loop), so its chain starts
    again after it, from slices; a static XLA pass joins a one-band chain
    (64 x 512) but not a banded flood (1000 x 1024)."""
    def keys(H, W):
        s = dataclasses.replace(Statics.for_grid(H, W), resolution=0.125)
        return voronoi.pass_roundings(s, voronoi._passes(s))

    assert keys(104, 256) == ["band", "pallas_narrow", "band_slice", "chain", "chain", "chain",
                              "band", "band", "pallas_last"]
    assert keys(64, 512)[:3] == ["band_window", "chain", "chain"]
    assert keys(1000, 1024)[:3] == ["pallas", "xla", "xla"]


def test_chain_passes_run_only_in_a_flood():
    """A chain's pass folds from the chain's recomputed triples, so
    jfa_pass_plain refuses one; jfa_states_plain carries them from pass to
    pass and yields the planes before every pass and after the last, the
    last equal to jfa_flood_plain's and to K1's plain flood in jfa_flood."""
    H, W, res = ref.SIZES["64x128"]
    xy = ref.swapped_pairs(64, H, W, res, ref.ORIGIN, seed=2)
    s = Statics.for_grid(H, W, res)
    grid, seeds = _port(xy, H, W)
    steps = voronoi._passes(s)
    rounding = voronoi.pass_roundings(s, steps)
    args = (len(xy), ref.ORIGIN, ref.ORIGIN, res)
    owner0, table = voronoi._jfa_init(grid, seeds, s)
    states = list(jfa_pass_cuda.jfa_states_plain(owner0, table, steps, *args, rounding))
    assert len(states) == len(steps) + 1 and torch.equal(states[0][0], owner0)
    with pytest.raises(ValueError, match="chain"):
        jfa_pass_cuda.jfa_pass_plain(*states[1], steps[1], *args, rounding[1])
    flood = jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, *args, rounding)
    got = jfa_pass_cuda.jfa_flood(owner0, table, steps, *args, want_positions=True,
                                  rounding=rounding)
    for a, b, c in zip(states[-1], flood, got):
        assert torch.equal(a, b) and torch.equal(a, c)
