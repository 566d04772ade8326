// One Zhang-Suen thinning iteration (both sub-iterations) on a u8 grid.
//
// Replaces the TPU kernel aosx/perceive/skeleton_pallas.py::zhang_suen_pallas
// (kernel body _make_iteration, stencil _subiter_band), which thins row bands
// with a 4-row halo DMA'd into VMEM. Semantics are those of
// aosx/perceive/skeleton.py::zhang_suen and of the plain PyTorch version
// aosx_torch/perceive/skeleton_cuda.py::zhang_suen_iteration_plain:
// neighbours outside the [H, W] buffer read 0; a cell is deleted only when it
// is 1 and lies in the interior of the live region, 1 <= y < h_cells - 1 and
// 1 <= x < w_cells - 1, so the outer ring of the live region never changes.
//
// Design: two launches, one thread per cell. Sub-iteration 0 reads `in` and
// writes `tmp`; sub-iteration 1 reads `tmp` and writes `out`, and counts the
// cells where `out` differs from `in` into a device int32 (one atomicAdd per
// block after __syncthreads_count). Global memory is the ping-pong buffer, so
// no halo logic is needed.
//
// Bound on the H100: memory. One iteration moves about 4 bytes per cell (read
// in, write tmp, read tmp and in, write out; the 3x3 stencil reads hit L1/L2),
// 16 MB at 2000 x 2048, a few microseconds at 3.35 TB/s; at that size the two
// launches cost as much as the traffic. The bounds (h_cells, w_cells) are read
// from device memory, so the host never waits on them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ uint8_t at(const uint8_t* __restrict__ p, int y, int x,
                                      int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? p[(size_t)y * W + x] : 0;
}

template <int PHASE>
__global__ void subiter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                               const uint8_t* __restrict__ orig,
                               const int32_t* __restrict__ bounds,
                               int32_t* __restrict__ changed, int H, int W) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  int chg = 0;
  if (x < W && y < H) {
    const int hc = bounds[0];
    const int wc = bounds[1];
    const size_t i = (size_t)y * W + x;
    const uint8_t p = in[i];
    uint8_t r = p;
    if (p == 1 && y >= 1 && y < hc - 1 && x >= 1 && x < wc - 1) {
      // p2..p9: N, NE, E, SE, S, SW, W, NW with row y-1 as "N"
      const uint8_t p2 = at(in, y - 1, x, H, W);
      const uint8_t p3 = at(in, y - 1, x + 1, H, W);
      const uint8_t p4 = at(in, y, x + 1, H, W);
      const uint8_t p5 = at(in, y + 1, x + 1, H, W);
      const uint8_t p6 = at(in, y + 1, x, H, W);
      const uint8_t p7 = at(in, y + 1, x - 1, H, W);
      const uint8_t p8 = at(in, y, x - 1, H, W);
      const uint8_t p9 = at(in, y - 1, x - 1, H, W);
      const uint8_t seq[9] = {p2, p3, p4, p5, p6, p7, p8, p9, p2};
      int A = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) A += (seq[k] == 0) & (seq[k + 1] == 1);
      const int B = (int)p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
      uint8_t m1, m2;
      if (PHASE == 0) {
        m1 = (uint8_t)(p2 * p4 * p6);
        m2 = (uint8_t)(p4 * p6 * p8);
      } else {
        m1 = (uint8_t)(p2 * p4 * p8);
        m2 = (uint8_t)(p2 * p6 * p8);
      }
      if (A == 1 && B >= 2 && B <= 6 && m1 == 0 && m2 == 0) r = 0;
    }
    out[i] = r;
    if (PHASE == 1) chg = (r != orig[i]);
  }
  if (PHASE == 1) {
    const int n = __syncthreads_count(chg);
    if (threadIdx.x == 0 && threadIdx.y == 0 && n > 0) atomicAdd(changed, n);
  }
}

}  // namespace

// in, tmp, out: u8 [H, W]; bounds: i32 [2] = (h_cells, w_cells);
// changed: i32 scalar, set to the number of cells where out != in.
extern "C" int zhang_suen_iteration(const void* in, void* tmp, void* out,
                                    const void* bounds, void* changed,
                                    int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  subiter_kernel<0><<<grid, block, 0, st>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(tmp), nullptr,
      static_cast<const int32_t*>(bounds), nullptr, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  subiter_kernel<1><<<grid, block, 0, st>>>(
      static_cast<const uint8_t*>(tmp), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(in), static_cast<const int32_t*>(bounds),
      static_cast<int32_t*>(changed), H, W);
  return (int)cudaGetLastError();
}
