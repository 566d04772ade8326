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
// fma(-2, a.b, s) rounds like s - 2 (a.b). No tensor cores: a product over
// K = 3 in TF32, or in any library's order, is not these FMA chains.
//
// Symmetry: fma, * and + commute exactly, so d2(a, b) == d2(b, a) bit for
// bit, and d2(a, a) == 0. Each unordered pair is evaluated once and its
// verdict credited to both ends.
//
// Design. The points are cut into tiles of TILE = THREADS x ROWS. A block
// takes one tile pair (I, J), J >= I, numbered p = J (J + 1) / 2 + I on
// blockIdx.x (the world on blockIdx.y, as jax.vmap of the TPU kernel adds a
// grid dimension; a single cloud is one world). Each thread holds ROWS
// points of tile I in registers, (x, y, z, |a|^2), and tile J is staged in
// shared memory as float4 (x, y, z, |b|^2): one broadcast 16-byte load of a
// column feeds ROWS pairs. For each group of 32 columns a thread sets bit k
// of a word per row where column k is within reach (a compare and a
// predicated add a pair), and the row's count adds the word's __popc. In an
// off-diagonal tile (I < J) the column's count comes from the same words:
// the warp transposes each row slot's 32 x 32 bit matrix with five
// shuffles, so that lane k holds column k's bits, and adds their __popc
// into a shared-memory count of the column. (A __ballot_sync a pair, lane k
// keeping column k's word, costs a vote and a select a pair more and ran
// 1.5-1.6x slower on the H100: PERF.md section 6.) A diagonal tile
// evaluates every ordered pair of the tile, self included, and credits rows
// only. The block then adds its row and column counts into the output with
// one atomicAdd a point; the output is zeroed by cudaMemsetAsync on the
// same stream first. Integer adds are exact and order-free, so the counts
// are deterministic. Slots past n (the last tile's tail) hold NaN, whose
// every pair compares false: the column loops run a compile-time trip count
// with no tail.
//
// Bound on the H100: operations, the least work of the all-pairs function
// the TPU kernel defines, which compares every pair's d2 with r2 (a
// schedule that skipped far pairs or the unused parked points would need
// less). The inputs are 12 bytes a point and the output 4 (2 MB at
// N = 131,072, under a microsecond at 3.35 TB/s), while each of the
// N (N + 1) / 2 distinct and self pairs takes 6 FP32 instructions (1 mul +
// 2 fma for the dot, 1 add of the norms, 1 fma for the difference, 1
// compare) and 1 INT32 add: 7 x 8.59e9 = 6.0e10 instructions at N = 131,072.
// An SM's four sub-partitions dispatch one warp instruction a clock, 132 x
// 128 lanes at 1.98 GHz = 3.35e13/s, so the least time is about 1.80 ms
// (chip_smoke.py, phase 6; the bit words, transposes and atomics are not
// charged).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tile, by a sweep on the H100 (PERF.md section 6): a sweep edits these
// in a copy of the tree and times it against this one with
// tests/torch_reference/ror_turns.py.
constexpr int ROWS = 4;
constexpr int THREADS = 128;
constexpr int TILE = THREADS * ROWS;
static_assert(THREADS % 32 == 0 && TILE % 32 == 0, "whole warps, whole groups of 32 columns");

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// point i as (x, y, z, |p|^2), or all NaN past the cloud's end
__device__ __forceinline__ float4 load_point(const float* __restrict__ xyz, int i, int n) {
  if (i >= n) {
    const float nan = __int_as_float(0x7fffffff);
    return make_float4(nan, nan, nan, nan);
  }
  const float x = xyz[3 * (size_t)i], y = xyz[3 * (size_t)i + 1], z = xyz[3 * (size_t)i + 2];
  return make_float4(x, y, z, dot3(x, y, z, x, y, z));
}

__device__ __forceinline__ bool within(const float4& a, const float4& b, float r2) {
  const float dot = dot3(a.x, a.y, a.z, b.x, b.y, b.z);
  return __fmaf_rn(-2.0f, dot, __fadd_rn(a.w, b.w)) <= r2;
}

// A warp's 32 x 32 bit matrix, lane l holding row l (bit c its column c),
// is transposed in five butterfly stages that swap the off-diagonal blocks
// of 16, 8, 4, 2 and 1: at stage s a lane keeps the bits of keep[s] and
// takes the others from lane ^ (16 >> s), rotated by shift[s]. Both are
// the lane's own, computed once.
struct Butterfly {
  unsigned keep[5];
  int shift[5];
};

__device__ __forceinline__ Butterfly butterfly(int lane) {
  Butterfly bf;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const unsigned low = s == 0 ? 0x0000ffffu : s == 1 ? 0x00ff00ffu : s == 2 ? 0x0f0f0f0fu
                       : s == 3 ? 0x33333333u : 0x55555555u;
    const bool up = lane & j;
    bf.keep[s] = up ? ~low : low;
    bf.shift[s] = up ? 32 - j : j;
  }
  return bf;
}

// lane l's row of the matrix in, its column l out (bit r from lane r)
__device__ __forceinline__ unsigned transpose32(unsigned x, const Butterfly& bf) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, 16 >> s);
    const unsigned moved = __funnelshift_l(y, y, bf.shift[s]);
    x = (x & bf.keep[s]) | (moved & ~bf.keep[s]);
  }
  return x;
}

// the tile pair (I, J), J >= I, numbered p = J (J + 1) / 2 + I
__device__ __forceinline__ void tile_pair(long long p, int& I, int& J) {
  long long j = (long long)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  J = (int)j;
  I = (int)(p - j * (j + 1) / 2);
}

__global__ void __launch_bounds__(THREADS)
ror_counts_kernel(const float* __restrict__ xyz_all, const float* __restrict__ r2_all,
                  int32_t* __restrict__ out_all, int n) {
  __shared__ float4 cols[TILE];
  __shared__ int col_cnt[TILE];
  const size_t world = blockIdx.y;
  const float* __restrict__ xyz = xyz_all + world * 3 * (size_t)n;
  int32_t* __restrict__ out = out_all + world * (size_t)n;
  const float r2 = r2_all[world];
  int I, J;
  tile_pair(blockIdx.x, I, J);
  const Butterfly bf = butterfly(threadIdx.x & 31);

  float4 a[ROWS];
  int cnt[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    a[r] = load_point(xyz, I * TILE + r * THREADS + threadIdx.x, n);
    cnt[r] = 0;
  }
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    cols[k] = load_point(xyz, J * TILE + k, n);
    col_cnt[k] = 0;
  }
  __syncthreads();

  const bool diag = I == J;
  for (int k0 = 0; k0 < TILE; k0 += 32) {
    unsigned bits[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) bits[r] = 0u;
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
      const float4 b = cols[k0 + kk];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (within(a[r], b, r2)) bits[r] |= 1u << kk;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cnt[r] += __popc(bits[r]);
    if (!diag) {
      int c = 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) c += __popc(transpose32(bits[r], bf));
      atomicAdd(&col_cnt[k0 + (threadIdx.x & 31)], c);
    }
  }
  if (!diag) {
    __syncthreads();
    for (int k = threadIdx.x; k < TILE; k += THREADS) {
      const int j = J * TILE + k;
      const int c = col_cnt[k];
      if (j < n && c != 0) atomicAdd(&out[j], c);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = I * TILE + r * THREADS + threadIdx.x;
    if (i < n && cnt[r] != 0) atomicAdd(&out[i], cnt[r]);
  }
}

}  // namespace

// xyz: f32 [worlds, n, 3] contiguous; r2: f32 [worlds] on the device; out:
// i32 [worlds, n], zeroed here on the stream. One launch for every world
// (worlds <= 65,535; t (t + 1) / 2 tile pairs <= 2^31 - 1 for t = ceil(n / TILE)).
extern "C" int ror_counts(const void* xyz, const void* r2, void* out, int n, int worlds,
                          void* stream) {
  if (n <= 0 || worlds <= 0) return 0;
  if (worlds > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + (long long)TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  if (pairs > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)worlds * n, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)pairs, worlds);
  ror_counts_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(xyz),
                                              static_cast<const float*>(r2),
                                              static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
