"""Stored JAX side of ``tests/test_torch_serving.py``: the JAX package's
serving loop at TEST_STATICS on the growing map of
tests/helpers.py::frames_growing([0.55, 0.8, 1.0]), for each ``ror_method``
("exact", and "pallas" with the JAX package's Pallas ROR kernel in interpret
mode, monkeypatched for the run; no file changes): ``serving.serve_init`` on
frame 0, then ``incremental.serve_frames`` one frame at a time with 30 ticks
each, jitted as one function (``test_torch_serving._jax_serve``). The result
(ServeState after serve_init, the metrics [F, T] with inc_level [F], the
ServeStates after each frame) is written leaf by leaf, in
``jax.tree_util`` order, to ``serving_replay_ref.npz`` beside this file; the
test rebuilds the pytree from the same function's ``jax.eval_shape``.

Run from the repository root (about 2 minutes):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_serving_replay_reference.py
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE.parent))

import jax  # noqa: E402

import test_torch_serving as tts  # noqa: E402

OUT = HERE / "serving_replay_ref.npz"


def main():
    out = {}
    for method in tts.METHODS:
        t = time.time()
        run = tts.jax_serve_run(method)
        leaves = jax.tree_util.tree_leaves(run())
        for i, leaf in enumerate(leaves):
            out[f"{method}/{i}"] = np.asarray(leaf)
        print(f"{method}: {len(leaves)} leaves, {time.time() - t:.1f} s", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
