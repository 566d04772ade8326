// Primitive-cost probes P1-P3: what a dependent scalar step and a
// data-dependent gather cost on Hopper.
//
// They replace the three TPU probe kernels of
// benchmarks/probe_pallas_prims.py: p1 (body smem_kernel: a sequential scalar
// read+write chase over an SMEM table), p2 (body vmem_kernel: a scalar
// read-only chase over a VMEM table) and p3 (body taa_kernel: rounds of
// take_along_axis inside the kernel). On the TPU they asked whether Mosaic
// allows scalar dynamic indexing and in-kernel gathers at all; on Hopper both
// are ordinary, and the question becomes their price, which a union-find or a
// crossing-filter kernel needs to know. Semantics are those of the plain
// PyTorch versions in aosx_torch/probes.py (chase_rw_plain, chase_ro_plain,
// gather_rows_plain); every value is a 32-bit integer with wrapping
// arithmetic, done in unsigned so the wrap is defined, so results are bitwise
// equal.
//
// Bounds on the H100.
//  P1, P2: latency. One thread runs a chain in which every load's address
//   depends on the previous load's value, so the least time is
//   steps x (one load-to-use latency + the multiply-add-and-xor between two
//   loads) at the SM clock; bytes and operation rates are nowhere near.
//   P1's table is 256 KB as i32, more than the 227 KB of shared memory a block
//   can have, so it lives in global memory and its loads are served by L1/L2
//   (it is also where a union-find over 65,536 skeleton cells would live);
//   the second entry point probe_chase_rw_smem keeps it in 128 KB of dynamic
//   shared memory as u16 (every value is below 65,536) to read the
//   shared-memory latency on the same chain. P2's 4,096-entry table is 16 KB
//   of static shared memory.
//  P3: operations of the shared-memory pipe. 512 x 2048 x 64 gathers of 4
//   bytes against 32 banks x 4 bytes a clock an SM; the 16 MB of global
//   traffic (x, idx in, out) take 5 us. A data-dependent index spreads a
//   warp's 32 lanes over the banks at random, so some banks are hit twice or
//   more and the gather replays: that is why it falls short of the bank rate.
//
// Design. P1/P2: one thread of one block. P3: one block per row, the row of
// x staged once in shared memory (8 KB), each thread's acc in a register, the
// 64 rounds in order inside the thread (a round's index depends on the
// thread's own acc only, so no barrier after the staging one).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned LCG_A = 1103515245u;
constexpr unsigned LCG_C = 12345u;

constexpr int P2_N = 4096;

constexpr int P3_COLS = 2048;
constexpr int P3_THREADS = 256;
constexpr int P3_PER_THREAD = P3_COLS / P3_THREADS;

__global__ void chase_rw_kernel(int32_t* __restrict__ table, int32_t* __restrict__ out, int n,
                                int steps, const int32_t* __restrict__ seed) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int32_t* parent = table;
  for (int i = 0; i < n; ++i) parent[i] = i;
  const unsigned mask = (unsigned)n - 1u;
  unsigned c = (unsigned)seed[0];
  for (int i = 0; i < steps; ++i) {
    const unsigned j = (c * LCG_A + LCG_C) & mask;
    const unsigned v = (unsigned)parent[j];
    parent[(j + 1u) & mask] = (int32_t)v;
    c = v ^ (unsigned)i;
  }
  out[0] = (int32_t)c;
}

// The same chain with the table in dynamic shared memory as u16 (n <= 65,536
// keeps every value below 2^16); the table is copied out at the end.
__global__ void chase_rw_smem_kernel(int32_t* __restrict__ table, int32_t* __restrict__ out,
                                     int n, int steps, const int32_t* __restrict__ seed) {
  extern __shared__ uint16_t parent_s[];
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint16_t* parent = parent_s;
  for (int i = 0; i < n; ++i) parent[i] = (uint16_t)i;
  const unsigned mask = (unsigned)n - 1u;
  unsigned c = (unsigned)seed[0];
  for (int i = 0; i < steps; ++i) {
    const unsigned j = (c * LCG_A + LCG_C) & mask;
    const unsigned v = parent[j];
    parent[(j + 1u) & mask] = (uint16_t)v;
    c = v ^ (unsigned)i;
  }
  out[0] = (int32_t)c;
  for (int i = 0; i < n; ++i) table[i] = (int32_t)parent[i];
}

__global__ void chase_ro_kernel(int32_t* __restrict__ out, int steps,
                                const int32_t* __restrict__ seed) {
  __shared__ int32_t tab_s[P2_N];
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  volatile int32_t* tab = tab_s;  // tab[j] == j: keep the loads from being folded away
  for (int i = 0; i < P2_N; ++i) tab[i] = i;
  unsigned c = (unsigned)seed[0];
  for (int i = 0; i < steps; ++i) {
    const unsigned j = (c * LCG_A + LCG_C) & (unsigned)(P2_N - 1);
    c = (unsigned)tab[j] ^ (unsigned)i;
  }
  out[0] = (int32_t)c;
}

__global__ void __launch_bounds__(P3_THREADS)
gather_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int rounds) {
  __shared__ int32_t xs[P3_COLS];
  const size_t row = (size_t)blockIdx.x * P3_COLS;
  unsigned base[P3_PER_THREAD], acc[P3_PER_THREAD];
#pragma unroll
  for (int k = 0; k < P3_PER_THREAD; ++k) {
    const int col = threadIdx.x + k * P3_THREADS;
    xs[col] = x[row + col];
    base[k] = (unsigned)idx[row + col];
    acc[k] = 0u;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < P3_PER_THREAD; ++k)
      acc[k] += (unsigned)xs[(base[k] + acc[k]) & (unsigned)(P3_COLS - 1)];
  }
#pragma unroll
  for (int k = 0; k < P3_PER_THREAD; ++k)
    out[row + threadIdx.x + k * P3_THREADS] = (int32_t)acc[k];
}

}  // namespace

// P1. table: i32 [n] scratch (holds the final table on return), out: i32 [1],
// seed: i32 [1] on the device; n a power of two.
extern "C" int probe_chase_rw(void* table, void* out, int n, int steps, const void* seed,
                              void* stream) {
  if (n <= 0 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  chase_rw_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), static_cast<int32_t*>(out), n, steps,
      static_cast<const int32_t*>(seed));
  return (int)cudaGetLastError();
}

// P1 with the table in shared memory (u16); n a power of two, n <= 65,536.
extern "C" int probe_chase_rw_smem(void* table, void* out, int n, int steps,
                                   const void* seed, void* stream) {
  if (n <= 0 || n > 65536 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int bytes = n * (int)sizeof(uint16_t);
  cudaError_t e = cudaFuncSetAttribute(chase_rw_smem_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  chase_rw_smem_kernel<<<1, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), static_cast<int32_t*>(out), n, steps,
      static_cast<const int32_t*>(seed));
  return (int)cudaGetLastError();
}

// P2. out: i32 [1]; the 4,096-entry table lives in the kernel.
extern "C" int probe_chase_ro(void* out, int steps, const void* seed, void* stream) {
  chase_ro_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), steps, static_cast<const int32_t*>(seed));
  return (int)cudaGetLastError();
}

// P3. x, idx, out: i32 [rows, 2048] contiguous.
extern "C" int probe_gather_rows(const void* x, const void* idx, void* out, int rows,
                                 int rounds, void* stream) {
  if (rows <= 0) return 0;
  gather_rows_kernel<<<rows, P3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rounds);
  return (int)cudaGetLastError();
}
