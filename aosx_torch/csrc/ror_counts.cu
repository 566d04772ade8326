// All-pairs radius-outlier-removal neighbour counts, self included.
//
// Replaces the TPU kernel aosx/perceive/ror_pallas.py::ror_counts_pallas
// (kernel body _kernel), which keeps the whole [8, N] point array in VMEM,
// computes each [1024, 2048] dot tile on the MXU at HIGHEST precision and
// fuses the threshold and the row sum. Semantics are those of the plain
// PyTorch version aosx_torch/perceive/ror_cuda.py::ror_counts_plain: for
// every point a of the [N, 3] f32 buffer,
//
//   count(a) = #{ b : d2(a, b) <= r2 },   d2 = (|a|^2 + |b|^2) - 2 (a.b)
//   |a|^2 = fma(z, z, fma(y, y, x*x)),    a.b = fma(z, z', fma(y, y', x*x'))
//
// the chains of fused multiply-adds that XLA:CPU runs for the reference (the
// JAX kernel in interpret mode). At orchard coordinates |a|^2 ~ 3.6e4 has an
// f32 ulp a tenth of r2 = 0.04, so another rounding order moves thousands of
// counts. The file is built with -fmad=false and spells every operation
// (__fmul_rn, __fmaf_rn, __fadd_rn), so the counts equal the plain
// version's bitwise, those of parked points too (their d2 cancels
// catastrophically, but the same way in both). 2 (a.b) is exact, so
// fma(-2, a.b, s) rounds like s - 2 (a.b).
//
// World axis: a group of G clouds [G, n, 3] (each with its own r2) is one
// launch, the world blockIdx.y, as jax.vmap of the TPU kernel adds a grid
// dimension; a single cloud is G = 1.
//
// Design: one thread per row point, its count held in a register. A block of
// THREADS rows walks all N columns in tiles of TILE points; each tile is
// staged in shared memory as float4 (x, y, z, |b|^2), so a pair costs one
// broadcast 16-byte shared load and seven arithmetic instructions. No tensor
// cores (no TF32), no library.
//
// Bound on the H100: operations. The inputs are 12 bytes a point and the
// output 4 (2 MB at N = 131,072, under a microsecond at 3.35 TB/s), while
// each of the N^2 pairs takes 6 FP32 instructions (1 mul + 2 fma for the
// dot, 1 add of the norms, 1 fma for the difference, 1 compare) and 1 INT32
// add to the count: 1.2e11 at N = 131,072. FP32 instructions issue at half
// the 67 TFLOP/s rate that counts an FMA as two (3.35e13/s), INT32 at half
// that again, so the ceiling is about 4.1 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 1024;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

__global__ void __launch_bounds__(THREADS)
ror_counts_kernel(const float* __restrict__ xyz_all, const float* __restrict__ r2_all,
                  int32_t* __restrict__ out_all, int n) {
  __shared__ float4 tile[TILE];
  const size_t world = blockIdx.y;
  const float* __restrict__ xyz = xyz_all + world * 3 * (size_t)n;
  const float* __restrict__ r2p = r2_all + world;
  int32_t* __restrict__ out = out_all + world * (size_t)n;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool row_ok = i < n;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (row_ok) {
    ax = xyz[3 * (size_t)i];
    ay = xyz[3 * (size_t)i + 1];
    az = xyz[3 * (size_t)i + 2];
  }
  const float asq = dot3(ax, ay, az, ax, ay, az);
  const float r2 = *r2p;
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int len = min(TILE, n - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += THREADS) {
      const size_t j = 3 * (size_t)(t0 + k);
      const float bx = xyz[j], by = xyz[j + 1], bz = xyz[j + 2];
      tile[k] = make_float4(bx, by, bz, dot3(bx, by, bz, bx, by, bz));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      const float4 b = tile[k];
      const float dot = dot3(ax, ay, az, b.x, b.y, b.z);
      const float d2 = __fmaf_rn(-2.0f, dot, __fadd_rn(asq, b.w));
      cnt += (d2 <= r2);
    }
  }
  if (row_ok) out[i] = cnt;
}

}  // namespace

// xyz: f32 [worlds, n, 3] contiguous; r2: f32 [worlds] on the device; out:
// i32 [worlds, n]. One launch for every world (worlds <= 65,535).
extern "C" int ror_counts(const void* xyz, const void* r2, void* out, int n, int worlds,
                          void* stream) {
  if (n <= 0 || worlds <= 0) return 0;
  if (worlds > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + THREADS - 1) / THREADS, worlds);
  ror_counts_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(xyz),
                                              static_cast<const float*>(r2),
                                              static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
