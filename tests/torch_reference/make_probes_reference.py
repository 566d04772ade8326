"""Reference results of the TPU probe kernels P1-P3 (and the XLA baseline P4).

Runs the three Pallas kernel bodies of ``benchmarks/probe_pallas_prims.py``
(``smem_kernel``, ``vmem_kernel``, ``taa_kernel``) on the CPU in Pallas
interpret mode, each through a ``pl.pallas_call`` with the probe's own specs
plus ``interpret=True``, and P4's flat gather as the same jnp expressions,
and writes ``probes.json`` beside this file: P1's and P2's final ``c``, P3's
output sum, first four values and sha256, P4's sum and sha256, and the
sha256 of P1's final table. The Pallas body does not return that table, so
it comes from a numpy transcription of the body, which must reproduce the
body's ``c``. ``chip_smoke.py`` and ``tests/test_torch_probes.py`` hold the
port's kernels and plain versions to these constants.

The probe module sets ``JAX_COMPILATION_CACHE_DIR`` with ``setdefault`` when
it is imported: set the variable first to keep the cache elsewhere.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference/make_probes_reference.py
    (--out FILE writes elsewhere; --npz FILE also saves the full arrays)
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "probes.json"
SEED = 3


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def chase_rw_numpy(n, steps, seed):
    """smem_kernel transcribed: (c, final table), i32 with wrapping."""
    parent = np.arange(n, dtype=np.int64)
    c = seed & 0xFFFFFFFF
    for i in range(steps):
        j = ((c * 1103515245 + 12345) & 0xFFFFFFFF) & (n - 1)
        v = int(parent[j])
        parent[(j + 1) & (n - 1)] = v
        c = (v ^ i) & 0xFFFFFFFF
    return np.array(c, np.uint32).astype(np.int32), parent.astype(np.uint32).astype(np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--npz", default=None)
    args = ap.parse_args()

    spec = importlib.util.spec_from_file_location(
        "probe_pallas_prims", ROOT / "benchmarks" / "probe_pallas_prims.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    seed = jnp.array([SEED], jnp.int32)
    p1 = pl.pallas_call(
        probe.smem_kernel, out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        in_specs=[smem], out_specs=smem,
        scratch_shapes=[pltpu.SMEM((probe.N,), jnp.int32)], interpret=True)
    p2 = pl.pallas_call(
        probe.vmem_kernel, out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        in_specs=[smem], out_specs=smem,
        scratch_shapes=[pltpu.VMEM((32, 128), jnp.int32)], interpret=True)
    x = jnp.arange(512 * 2048, dtype=jnp.int32).reshape(512, 2048) & 1023
    idx = (x * 7 + 13) & 2047
    p3 = pl.pallas_call(
        probe.taa_kernel, out_shape=jax.ShapeDtypeStruct((512, 2048), jnp.int32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True)

    c1 = np.asarray(jax.jit(p1)(seed))
    c2 = np.asarray(jax.jit(p2)(seed))
    out3 = np.asarray(jax.jit(p3)(x, idx))

    # P4 (no pallas_call in the probe script): the body of its jitted loop
    cells = 2000 * 2048
    occ = (jnp.arange(cells, dtype=jnp.int32) & 7).astype(jnp.uint8)
    idx4 = (jnp.arange(262144, dtype=jnp.int32) * 48271) % cells

    @jax.jit
    def p4(occ, idx):
        def body(r, acc):
            return (acc + occ[(idx + acc.astype(jnp.int32)) % cells]
                    .astype(jnp.int32)).astype(jnp.int32)
        return jax.lax.fori_loop(0, 16, body, jnp.zeros_like(idx))
    out4 = np.asarray(p4(occ, idx4))

    c1_np, table = chase_rw_numpy(probe.N, probe.NITER, SEED)
    if int(c1_np) != int(c1[0]):
        raise SystemExit(f"numpy transcription of P1 gives {int(c1_np)}, the body {int(c1[0])}")

    ref = dict(
        seed=SEED, jax=jax.__version__,
        p1_c=int(c1[0]), p1_table_sha256=sha256(table.astype("<i4")),
        p2_c=int(c2[0]),
        p3_sum=int(out3.astype(np.int64).sum()), p3_first4=out3[0, :4].tolist(),
        p3_sha256=sha256(out3.astype("<i4")),
        p4_sum=int(out4.astype(np.int64).sum()), p4_sha256=sha256(out4.astype("<i4")),
    )
    pathlib.Path(args.out).write_text(json.dumps(ref, indent=1) + "\n")
    if args.npz:
        np.savez_compressed(args.npz, p1_c=c1, p1_table=table, p2_c=c2, p3=out3, p4=out4,
                            p4_idx=np.asarray(idx4))
    print(json.dumps(ref))


if __name__ == "__main__":
    main()
