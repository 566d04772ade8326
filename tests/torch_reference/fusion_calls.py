"""How many calls of its outlined functions XLA:CPU's last fusion of the
whole static-shift jump flood makes for one output cell, at MC_STATICS.

``aosx``'s ``jump_flood`` with static shifts (MC_STATICS' own lowering) is
jitted as a whole and compiled, not run, with ``XLA_FLAGS=--xla_dump_to``;
the script then reads the optimized HLO for the ENTRY's root fusion (the
last pass's owner plane) and that fusion's optimized LLVM IR, and counts,
over the IR's call graph, the calls one iteration of the kernel's cell loop
makes (every call site counted once a call of its function; the outlined
functions recompute the earlier passes and share nothing between calls).
A count far beyond what a CPU can make says that the whole jit has no
result on XLA:CPU, which is why the JAX package runs MC_STATICS on CPU
devices with dynamic shifts and why the Monte-Carlo reference is built so.

Run from the repository root (about a minute, most of it the compile):

    JAX_PLATFORMS=cpu python tests/torch_reference/fusion_calls.py [DUMP_DIR]

DUMP_DIR defaults to ``_archive/fusion_calls`` (listed in .gitignore).
"""

from __future__ import annotations

import functools
import os
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
DUMP = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "_archive" / "fusion_calls"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={DUMP}").strip()
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aosx.config import MC_STATICS  # noqa: E402
from aosx.gvd.voronoi import jump_flood  # noqa: E402
from aosx.types import GridWorld, SeedSet  # noqa: E402


def compile_flood():
    s = MC_STATICS
    S = 2 * s.max_seeds
    grid = GridWorld(jnp.zeros((s.grid_h, s.grid_w), jnp.uint8), jnp.float32(0.0),
                     jnp.float32(0.0), jnp.int32(s.grid_h), jnp.int32(s.grid_w))
    seeds = SeedSet(jnp.zeros((S, 2), jnp.float32), jnp.zeros(S, bool), jnp.zeros(S, jnp.int8))
    jax.jit(lambda g, se: jump_flood(g, se, s)).lower(grid, seeds).compile()


def root_fusion(hlo: str) -> str:
    entry = hlo[hlo.index("\nENTRY "):]
    return re.search(r"ROOT %([\w.\-]+) = \S+ fusion\(", entry).group(1)


def calls_a_cell(ll: str, kernel: str) -> int:
    funcs, cur = {}, None
    for line in ll.splitlines():
        m = re.match(r"define .*?@([\w.]+)\(", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if line == "}":
            cur = None
        elif cur is not None:
            cur += re.findall(r"call [^@]*@(fused_computation[\w.]*)\(", line)
    sys.setrecursionlimit(100000)

    @functools.lru_cache(maxsize=None)
    def calls(f):
        return sum(1 + calls(c) for c in funcs.get(f, []))

    return len(funcs) - 1, calls(kernel)


def main():
    compile_flood()
    hlo_path = max(DUMP.glob("*jit__lambda*.cpu_after_optimizations.txt"),
                   key=lambda p: p.stat().st_mtime)
    module = hlo_path.name.split(".cpu_after_optimizations")[0]
    root = root_fusion(hlo_path.read_text())
    ll_path = DUMP / f"{module}.{root}_kernel_module.ir-with-opt.ll"
    outlined, n = calls_a_cell(ll_path.read_text(), root)
    print(f"MC_STATICS {MC_STATICS.grid_h} x {MC_STATICS.grid_w}, static shifts: root fusion "
          f"{root}, {outlined} outlined functions, {n:.3g} calls a cell")


if __name__ == "__main__":
    main()
