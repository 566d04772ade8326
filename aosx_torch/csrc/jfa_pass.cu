// One Jacobi jump-flood pass at offset `step` over the carried planes
// (owner i32, ox f32, oy f32) of a [H, W] grid.
//
// Replaces the TPU kernel aosx/gvd/jfa_pass_pallas.py::jfa_pass (body built
// by _make_pass), which runs passes with step <= 128 over row bands with a
// halo DMA'd into VMEM. Semantics are those of aosx/gvd/voronoi.py's Jacobi
// pass and of the plain PyTorch version
// aosx_torch/gvd/jfa_pass_cuda.py::jfa_pass_plain: every cell recomputes d2 to
// its own owner, then folds the 8 neighbours at (y - dys*step, x - dxs*step),
// in the (dys, dxs) order of voronoi.jacobi_fold, with a lexicographic min on
// (d2, owner index). Neighbours outside the grid read owner S and position
// 1e9; owners >= S never win (their d2 is 3.4e38). Cell coordinates are
// origin + (float)index * res.
//
// Design: one thread per cell, reading the pass-start planes and writing the
// other buffer of a ping-pong pair, which makes the pass Jacobi. There is no
// band and no halo, so every step (1 .. 1024) runs here. The file is built
// with -fmad=false and uses __fmul_rn/__fadd_rn so that no multiply-add is
// contracted: d2 rounds exactly as the plain version's separate ops, and
// owners agree bit for bit at near-ties.
//
// Bound on the H100: memory. A pass reads 12 bytes per cell for the cell
// itself plus 8 neighbour triples (coalesced along x, and mostly L2 hits for
// small steps) and writes 12 bytes: about 100 MB of compulsory traffic per
// pass at 2000 x 2048, some 30 us at 3.35 TB/s; 12 passes per flood.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kInf = 3.4e38f;
constexpr float kFar = 1e9f;

__device__ __forceinline__ float dist2(float px, float py, float cx, float cy) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__global__ void jfa_pass_kernel(const int32_t* __restrict__ o0, const float* __restrict__ x0,
                                const float* __restrict__ y0, int32_t* __restrict__ o1,
                                float* __restrict__ x1, float* __restrict__ y1,
                                const float* __restrict__ origin, int H, int W, int step,
                                int S, float res) {
  const int ix = blockIdx.x * BX + threadIdx.x;
  const int iy = blockIdx.y * BY + threadIdx.y;
  if (ix >= W || iy >= H) return;
  const float cellx = __fadd_rn(origin[0], __fmul_rn((float)ix, res));
  const float celly = __fadd_rn(origin[1], __fmul_rn((float)iy, res));
  const size_t i = (size_t)iy * W + ix;
  int o = o0[i];
  float x = x0[i];
  float y = y0[i];
  float d2 = (o < S) ? dist2(x, y, cellx, celly) : kInf;
#pragma unroll
  for (int dys = -1; dys <= 1; ++dys) {
#pragma unroll
    for (int dxs = -1; dxs <= 1; ++dxs) {
      if (dys == 0 && dxs == 0) continue;
      const int ny = iy - dys * step;
      const int nx = ix - dxs * step;
      int no = S;
      float nxv = kFar;
      float nyv = kFar;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
        const size_t j = (size_t)ny * W + nx;
        no = o0[j];
        nxv = x0[j];
        nyv = y0[j];
      }
      const float nd = (no < S) ? dist2(nxv, nyv, cellx, celly) : kInf;
      if (nd < d2 || (nd == d2 && no < o)) {
        o = no;
        x = nxv;
        y = nyv;
        d2 = nd;
      }
    }
  }
  o1[i] = o;
  x1[i] = x;
  y1[i] = y;
}

}  // namespace

// owner/ox/oy: pass-start planes [H, W]; out_*: the other buffers;
// origin: f32 [2] = (origin_x, origin_y) on the device.
extern "C" int jfa_pass(const void* owner, const void* ox, const void* oy, void* out_owner,
                        void* out_ox, void* out_oy, const void* origin, int H, int W,
                        int step, int S, float res, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  jfa_pass_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(owner), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<int32_t*>(out_owner),
      static_cast<float*>(out_ox), static_cast<float*>(out_oy),
      static_cast<const float*>(origin), H, W, step, S, res);
  return (int)cudaGetLastError();
}
