"""Kernel K1's CUDA source (``aosx_torch/csrc/jfa_pass.cu``) run on the host.

The card is not needed: g++ compiles the source as C++ against stand-ins for
the CUDA headers (the rounding intrinsics as correctly rounded host float
operations, no contraction; the funnel shift, the float-to-bits moves and
the vector types as plain integer code and structs; the shared-memory table
through a pointer; a grid barrier as nothing), and a small program
runs ``flood_kernel`` as one block of one thread, which walks every 4-cell
quad of every pass in order. Its owner plane must equal the plain flood
(``jfa_pass_cuda.jfa_flood_plain``) bitwise, in every rounding of
``voronoi.ROUNDINGS`` and through the chains of ``voronoi.CHAINS``, with the
table in shared memory (the versions compiled for each owner-fold form) and
in device memory (the generic version): the fold logic of the kernel, its
skips, its u16 words and its unaligned candidate rows, checked where the
kernel itself cannot run.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aosx_torch.config import BENCH_STATICS
from aosx_torch.gvd import jfa_pass_cuda, voronoi
from aosx_torch.types import GridWorld, SeedSet

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "aosx_torch" / "csrc" / "jfa_pass.cu"
# the H100's shared memory a block may opt in to: the largest seed table the
# entry point stages there
H100_SHARED_OPTIN = 232448

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __shared__
#define __launch_bounds__(...)
#define __grid_constant__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct dim3 { dim3(int = 1, int = 1, int = 1) {} };
struct Index { int x; };
static Index threadIdx, blockIdx, blockDim;
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (shift & 31));
}
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline void __syncthreads() {}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess, cudaErrorInvalidValue, cudaErrorInvalidConfiguration,
       cudaFuncAttributeMaxDynamicSharedMemorySize, cudaDevAttrMultiProcessorCount,
       cudaDevAttrMaxSharedMemoryPerBlockOptin };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline int cudaGetLastError() { return 0; }
inline int cudaFuncGetAttributes(cudaFuncAttributes*, const void*) { return 1; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 1; }
inline int cudaGetDevice(int*) { return 1; }
inline int cudaDeviceGetAttribute(int*, int, int) { return 1; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t) { return 1; }
inline int cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) { return 1; }
using std::max;
using std::min;
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
namespace cooperative_groups {
struct grid_group { void sync() {} };
inline grid_group this_grid() { return {}; }
}
"""

RUNNER = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "cuda_runtime.h"
namespace { float2 table_s[1 << 16]; }
#include "jfa_pass.cu"
// argv: input (H W S n want shared, steps[n], codes[6 n] as i32; origin x, y,
// res as f32; owner i32 [H, W]; table f32 [S + 1, 2]), output (owner i32
// [H, W], then with want the closing positions x, y f32 [H, W] each); or
// "refuse" S: print jfa_flood's return code for a one-world 8 x 8 call with S
// seeds and no steps
int main(int argc, char** argv) {
  if (argc == 3 && std::strcmp(argv[1], "refuse") == 0) {
    int launches = 0;
    std::printf("%d\n", jfa_flood(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, 8, 8,
                                  std::atoi(argv[2]), 0.1f, nullptr, nullptr, &launches,
                                  nullptr));
    return 0;
  }
  FILE* f = std::fopen(argv[1], "rb");
  int h[6];
  if (std::fread(h, 4, 6, f) != 6) return 1;
  const int H = h[0], W = h[1], S = h[2], n = h[3], want = h[4], shared = h[5];
  Steps s;
  s.n = n;
  float org[3];
  const size_t cells = (size_t)H * W;
  std::vector<int32_t> in(cells), out(cells), pa(cells), pb(cells), chain(12 * cells);
  std::vector<uint16_t> ua(cells), ub(cells);
  std::vector<float> ox(cells), oy(cells);
  std::vector<float2> tab(S + 1);
  std::vector<int32_t> codes(6 * (size_t)n);
  if (std::fread(s.v, 4, n, f) != (size_t)n || std::fread(codes.data(), 4, 6 * n, f) != 6 * (size_t)n ||
      std::fread(org, 4, 3, f) != 3 || std::fread(in.data(), 4, cells, f) != cells ||
      std::fread(tab.data(), 8, S + 1, f) != (size_t)S + 1)
    return 1;
  std::fclose(f);
  for (int i = 0; i < n; ++i) {
    for (int q = 0; q < 5; ++q) s.forms[i][q] = codes[6 * i + q];
    s.own[i] = codes[6 * i + 5];
  }
  blockDim.x = 1;
  (shared ? flood_kernel<true> : flood_kernel<false>)(
      in.data(), out.data(), ua.data(), ub.data(), pa.data(), pb.data(), chain.data(), tab.data(),
      &org[0], &org[1], s, H, W, S, org[2], want ? ox.data() : nullptr,
      want ? oy.data() : nullptr, 1);
  FILE* o = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, cells, o);
  if (want) {
    std::fwrite(ox.data(), 4, cells, o);
    std::fwrite(oy.data(), 4, cells, o);
  }
  std::fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner built with g++ from the kernel's source."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host runner")
    d = tmp_path_factory.mktemp("k1_host")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)
    (d / "runner.cpp").write_text(RUNNER)
    exe = d / "runner"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-w", f"-I{d}", f"-I{SOURCE.parent}", str(d / "runner.cpp"), "-o", str(exe)],
                   check=True, capture_output=True)

    def run(owner, table, steps, S, origin, res, rounding, want_positions=True, shared=None):
        """The kernel's flood: owner, or (owner, ox, oy) with want_positions.
        shared: the kernel whose table lies in shared memory (the versions
        compiled for each owner-fold form) or in device memory (generic);
        None: the one the entry point takes for S on the H100."""
        H, W = owner.shape
        if shared is None:
            shared = 8 * (S + 1) <= H100_SHARED_OPTIN
        forms = [c for r in rounding for c in jfa_pass_cuda.form_codes(r)]
        src, out = d / "in.bin", d / "out.bin"
        with open(src, "wb") as f:
            np.array([H, W, S, len(steps), int(want_positions), int(shared)], np.int32).tofile(f)
            np.array(list(steps) + forms, np.int32).tofile(f)
            np.array([*origin, res], np.float32).tofile(f)
            owner.numpy().astype(np.int32).tofile(f)
            table.numpy().astype(np.float32).tofile(f)
        subprocess.run([str(exe), str(src), str(out)], check=True)
        raw = np.fromfile(out, np.int32)
        o = raw[:H * W].reshape(H, W)
        if not want_positions:
            return o
        xy = raw[H * W:].view(np.float32).reshape(2, H, W)
        return o, xy[0], xy[1]

    def refuse(S):
        """jfa_flood's return code for a call with S seeds and no passes."""
        r = subprocess.run([str(exe), "refuse", str(S)], check=True, capture_output=True,
                           text=True)
        return int(r.stdout)

    run.refuse = refuse
    return run


def _random_case(seed, S=64, H=96, W=128):
    """Owners anywhere (some none) over seeds on a coarse lattice of
    coordinates, so that distances tie and near-tie often."""
    rng = np.random.default_rng(seed)
    grid = np.float32([1.1, 2.3, 3.7, 4.9, 6.1, 7.3, 8.5])
    table = np.concatenate([rng.choice(grid, (S, 2)), [[1e9, 1e9]]]).astype(np.float32)
    owner = rng.integers(0, S + 1, (H, W)).astype(np.int32)
    return torch.from_numpy(owner), torch.from_numpy(table), S


STEPS = [1, 64, 32, 16, 8, 4, 2, 1, 3, 5]
ROUNDING_MIXES = {
    "xla": ["xla"] * 10,
    "pallas": ["pallas"] * 10,
    "pallas_last": ["pallas_last"] * 10,
    "mixed": ["pallas", "xla"] * 4 + ["pallas", "pallas_last"],
    # one-band chains (voronoi.CHAINS): from a step-1 window and from slices
    "chain": ["band_window", "chain", "chain", "chain", "chain", "band", "band_slice", "chain",
              "chain", "pallas_last"],
}


def _assert_planes(got, want):
    """Owner planes equal, and the position planes bitwise."""
    assert np.array_equal(got[0], want[0].numpy())
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.view(np.uint32), w.numpy().view(np.uint32))


@pytest.mark.parametrize("mix", ROUNDING_MIXES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_source_matches_plain_flood(host_kernel, mix, seed):
    """The passes of STEPS over a random plane, each in its rounding of the
    mix: the kernel's source == jfa_flood_plain, the owner plane and the
    carried x and y planes, and the owner plane alone where the last pass
    folds nothing else."""
    owner, table, S = _random_case(seed)
    rounding = ROUNDING_MIXES[mix]
    got = host_kernel(owner, table, STEPS, S, (0.35, -0.45), 0.1, rounding)
    want = jfa_pass_cuda.jfa_flood_plain(owner, table, STEPS, S, 0.35, -0.45, 0.1, rounding)
    _assert_planes(got, want)
    # the positions leave their owners' seeds (the planes fold apart)
    assert not np.array_equal(got[1], table.numpy()[got[0], 0])
    alone = host_kernel(owner, table, STEPS, S, (0.35, -0.45), 0.1, rounding, False)
    assert np.array_equal(alone, want[0].numpy())


def test_k1_source_matches_plain_on_a_bench_window(host_kernel):
    """The bench orchard's seeds of a 192 x 256 window of its grid, at its
    origin and resolution, flooded with BENCH_STATICS' pass roundings."""
    inp = np.load(pathlib.Path(__file__).parent / "torch_reference"
                  / "bench_np_seed0_flood_in.npz")
    H, W = 192, 256
    org = (float(inp["origin"][0]), float(inp["origin"][1]))
    grid = GridWorld(torch.zeros((H, W), dtype=torch.uint8), torch.tensor(org[0]),
                     torch.tensor(org[1]), torch.tensor(H, dtype=torch.int32),
                     torch.tensor(W, dtype=torch.int32))
    xy = inp["seeds_xy"]
    inside = (inp["seeds_valid"] & (xy[:, 0] < org[0] + W * 0.1)
              & (xy[:, 1] < org[1] + H * 0.1))
    seeds = SeedSet(torch.from_numpy(xy), torch.from_numpy(inside),
                    torch.zeros(len(xy), dtype=torch.int8))
    owner0, table = voronoi._jfa_init(grid, seeds, BENCH_STATICS)
    steps = [1, 128, 64, 32, 16, 8, 4, 2, 1]
    rounding = voronoi.pass_roundings(BENCH_STATICS, steps)
    S = len(xy)
    got = host_kernel(owner0, table, steps, S, org, BENCH_STATICS.resolution, rounding)
    want = jfa_pass_cuda.jfa_flood_plain(owner0, table, steps, S, *org,
                                         BENCH_STATICS.resolution, rounding)
    assert int((want[0] < S).sum()) > H * W // 2
    _assert_planes(got, want)


@pytest.mark.parametrize("mix", ROUNDING_MIXES)
def test_k1_source_with_table_in_device_memory(host_kernel, mix):
    """The kernel a table too large for shared memory takes (every pass in
    the generic forms, the table read from device memory), on STEPS in each
    mix: == jfa_flood_plain in all three planes."""
    owner, table, S = _random_case(0)
    rounding = ROUNDING_MIXES[mix]
    got = host_kernel(owner, table, STEPS, S, (0.35, -0.45), 0.1, rounding, shared=False)
    want = jfa_pass_cuda.jfa_flood_plain(owner, table, STEPS, S, 0.35, -0.45, 0.1, rounding)
    _assert_planes(got, want)


# a plane whose width holds an odd number of quads (52 = 4 x 13), and every
# step from 1 to 8 (the candidate rows' column offsets in each residue mod 4)
# and one larger than the plane, from which every neighbour lies outside
ODD_QUADS = dict(S=64, H=40, W=52)
ODD_STEPS = [1, 2, 3, 4, 5, 6, 7, 8, 61]
ODD_MIXES = {
    "plain": ["pallas", "xla", "pallas", "pallas_last"],
    "chain": ["band_window", "chain", "band", "pallas_last"],
}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mix", ODD_MIXES)
@pytest.mark.parametrize("step", ODD_STEPS)
def test_k1_source_steps_on_odd_quads(host_kernel, step, mix, sparse):
    """Floods of [step, 3, step, step] in each mix (the step's unaligned rows
    read from the caller's i32 plane, then from the u16 words) and single
    passes at the step in every rounding but a chain's (the i32 plane in,
    plain owners out), on a plane of 13 quads a row, owned everywhere or
    (sparse) in 3 % of its cells, so that whole quads see no owner: == the
    plain version, owner, x and y planes, and the owner plane alone."""
    owner, table, S = _random_case(step, **ODD_QUADS)
    if sparse:
        rng = np.random.default_rng(100 + step)
        owner[torch.from_numpy(rng.random(tuple(owner.shape)) > 0.03)] = S
    steps = [step, 3, step, step]
    rounding = ODD_MIXES[mix]
    want = jfa_pass_cuda.jfa_flood_plain(owner, table, steps, S, 0.35, -0.45, 0.1, rounding)
    _assert_planes(host_kernel(owner, table, steps, S, (0.35, -0.45), 0.1, rounding), want)
    alone = host_kernel(owner, table, steps, S, (0.35, -0.45), 0.1, rounding, False)
    assert np.array_equal(alone, want[0].numpy())
    if mix != "plain":
        return
    for r in (r for r in voronoi.ROUNDINGS if r not in voronoi.CHAINS):
        want = jfa_pass_cuda.jfa_flood_plain(owner, table, [step], S, 0.35, -0.45, 0.1, [r])
        _assert_planes(host_kernel(owner, table, [step], S, (0.35, -0.45), 0.1, [r]), want)


@pytest.mark.parametrize("shared", [False, True])
def test_k1_source_at_the_seed_cap(host_kernel, shared):
    """S = 32767, the most a u16 owner word holds (its table does not fit
    the H100's shared memory: the entry point takes the device-memory
    kernel; the shared one is run here too), owners drawn over all of them:
    == jfa_flood_plain in all three planes, in the Pallas roundings."""
    S = jfa_pass_cuda.MAX_SEEDS
    assert S == 32767
    owner, table, _ = _random_case(5, S=S, H=64, W=128)
    # most seeds anywhere on the plane, a third of them on the lattice (ties)
    rng = np.random.default_rng(6)
    spread = rng.uniform(0.0, [12.8, 6.4], (S, 2)).astype(np.float32)
    table[:S] = torch.where(torch.arange(S)[:, None] % 3 == 0, table[:S],
                            torch.from_numpy(spread))
    owner[0, :4] = torch.tensor([S - 1, S - 2, S, 0], dtype=torch.int32)
    rounding = ROUNDING_MIXES["mixed"]
    got = host_kernel(owner, table, STEPS, S, (0.35, -0.45), 0.1, rounding, shared=shared)
    want = jfa_pass_cuda.jfa_flood_plain(owner, table, STEPS, S, 0.35, -0.45, 0.1, rounding)
    _assert_planes(got, want)
    assert int(want[0].max()) > 32000


def test_k1_entry_refuses_more_seeds_than_a_word_holds(host_kernel):
    """jfa_flood returns cudaErrorInvalidValue (1) for S = 32768 (and S < 0)
    and takes S = 32767 (no passes: nothing launched)."""
    assert host_kernel.refuse(32768) == 1
    assert host_kernel.refuse(32767) == 0
    assert host_kernel.refuse(-1) == 1
