"""The port's on-device orchard generator (``orchards.make_orchard``, drawing
from ``aosx_torch/prng.py`` and ``aosx_torch/f32math.py``) against
``aosx.orchards.make_orchard`` and ``jax.random``
(jax_threefry_partitionable=True), all bitwise:

- keys, ``split``, 32-bit random bits and f32 ``uniform`` (its f * (max -
  min) + min fused) over several seeds and shapes;
- XLA:CPU's f32 log, log1p and erfinv, and glibc's sinf and cosf (which
  XLA:CPU calls), over millions of arguments each, and ``normal``;
- the generator's cloud, validity mask and polygon on the dashboard's
  orchard, bowed rows and dropped trees, seeds 0-2.

The card against the CPU port is held by chip_smoke.py's phase 10 (this
module imports JAX, which the card's machine lacks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import TEST_STATICS as JS
from aosx.orchards import OrchardSpec as JSpec, make_orchard as jmake
from aosx_torch import f32math, prng
from aosx_torch.config import TEST_STATICS as S
from aosx_torch.orchards import OrchardSpec, make_orchard
from torch_helpers import one_torch_thread  # noqa: F401

DASH = OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0))
SPECS = {"dashboard": DASH, "curved": dataclasses.replace(DASH, row_curve=0.6),
         "dropout": OrchardSpec(dropout=0.15)}


def _same(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape
    same = ref.view(np.uint32) == got.view(np.uint32) if ref.dtype == np.float32 else ref == got
    bad = ~(same | (np.isnan(ref) & np.isnan(got)))
    assert not bad.any(), f"{int(bad.sum())} of {ref.size} differ"


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1])
def test_keys_bits_and_uniform_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed, "cpu")
    assert np.array_equal(np.asarray(jk).astype(np.int64), k.numpy())
    assert np.array_equal(np.asarray(jax.random.split(jk, 7)).astype(np.int64),
                          prng.split(k, 7).numpy())
    assert np.array_equal(np.asarray(jax.random.bits(jk, (5, 301))).astype(np.int64),
                          prng.bits(k, (5, 301)).numpy())
    for lo, hi in ((0.0, 1.0), (0.0, 2 * np.pi), (-0.2, 0.4), (0.0, 0.15),
                   (np.array([1.0, 2.0, -0.3]), np.array([19.0, 16.0, 0.4]))):
        ref = jax.random.uniform(jk, (999, 3), minval=jnp.asarray(lo, jnp.float32),
                                 maxval=jnp.asarray(hi, jnp.float32))
        got = prng.uniform(k, (999, 3), lo, hi)
        assert np.array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))


RNG = np.random.default_rng(1)
TRANSCENDENTALS = {
    "log": (jnp.log, f32math.log_f32, np.concatenate([
        RNG.uniform(1e-7, 1.0, 400_000), RNG.uniform(0.5, 2.0, 400_000),
        10 ** RNG.uniform(-37, 38, 400_000)])),
    "log1p": (jnp.log1p, f32math.log1p_f32, np.concatenate([
        RNG.uniform(-0.999, 0.0, 400_000), RNG.uniform(-0.42, 0.42, 400_000),
        RNG.uniform(0, 100, 200_000)])),
    "erfinv": (jax.lax.erf_inv, f32math.erfinv_f32, np.concatenate([
        RNG.uniform(-1, 1, 600_000), 1 - 10 ** RNG.uniform(-7.2, 0, 200_000),
        -1 + 10 ** RNG.uniform(-7.2, 0, 200_000)])),
    "sin": (jnp.sin, f32math.sin_f32, np.concatenate([
        RNG.uniform(0, 2 * np.pi, 600_000), RNG.uniform(-119, 119, 400_000),
        RNG.uniform(-1e-3, 1e-3, 20_000)])),
    "cos": (jnp.cos, f32math.cos_f32, np.concatenate([
        RNG.uniform(0, 2 * np.pi, 600_000), RNG.uniform(-119, 119, 400_000),
        RNG.uniform(-1e-3, 1e-3, 20_000)])),
}


@pytest.mark.parametrize("name", list(TRANSCENDENTALS))
def test_f32_transcendentals_match_xla(name):
    jf, tf, xs = TRANSCENDENTALS[name]
    xs = xs.astype(np.float32)
    if name == "erfinv":
        xs = xs[np.abs(xs) < 1]
    _same(jax.jit(jf)(jnp.asarray(xs)), tf(torch.from_numpy(xs)).numpy())


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_normal_matches_jax(seed):
    _same(jax.random.normal(jax.random.PRNGKey(seed), (300_000,)),
          (prng.SQRT2 * prng.erfinv_uniform(prng.prng_key(seed, "cpu"), (300_000,))).numpy())


def _both(spec, seed):
    jpc, jpoly = jax.jit(lambda key: jmake(key, JSpec(**dataclasses.asdict(spec)), JS))(
        jax.random.PRNGKey(seed))
    pc, poly = make_orchard(prng.prng_key(seed, "cpu"), spec, S)
    return jpc, jpoly, pc, poly


@pytest.mark.parametrize("spec", list(SPECS))
def test_make_orchard_matches_jax(spec):
    for seed in range(3):
        jpc, jpoly, pc, poly = _both(SPECS[spec], seed)
        assert np.array_equal(np.asarray(jpc.valid), pc.valid.numpy())
        assert np.array_equal(np.asarray(jpoly.pts), poly.pts.numpy())
        assert int(jpoly.count) == int(poly.count)
        _same(jpc.xyz, pc.xyz.numpy())
