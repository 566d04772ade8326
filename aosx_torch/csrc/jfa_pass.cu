// The Jacobi jump flood over an owner plane (i32 [H, W], S = no owner): every
// pass of a flood from one call, carrying owners only.
//
// Replaces the TPU kernel aosx/gvd/jfa_pass_pallas.py::jfa_pass (body built
// by _make_pass), which runs one pass with step <= 128 over row bands of the
// three carried planes (owner, ox, oy) with a halo DMA'd into VMEM. Semantics
// are those of aosx/gvd/voronoi.py's Jacobi pass and of the plain PyTorch
// versions aosx_torch/gvd/jfa_pass_cuda.py::jfa_pass_plain / jfa_flood_plain:
// every cell recomputes d2 to its own owner, then folds the 8 neighbours at
// (y - dys*step, x - dxs*step), in the (dys, dxs) order of
// voronoi.jacobi_fold, with a lexicographic min on (d2, owner index).
// Neighbours outside the grid read owner S; owners >= S never win (their d2 is
// 3.4e38). Cell coordinates are fma((float)index, res, origin) and d2 is
// fma(dx, dx, dy * dy): each rounded once, as XLA:CPU fuses the reference's
// expressions in its XLA lowering. The passes that aosx runs through the TPU
// kernel round d2 as XLA:CPU builds that kernel's owner plane inside a jit:
// a rounding a direction, the same in every cell and band (Rounding below,
// aosx_torch/gvd/voronoi.py's ROUNDINGS). The call gives each pass its code.
//
// Bound on the H100. The carried positions are redundant: the flood starts
// with (ox, oy) = table[owner] for table = seeds.xy with a row (1e9, 1e9)
// appended, and a pass only copies triples, so the invariant holds after every
// pass. Carrying the owner alone, a pass has to read and write 8 bytes a cell
// (24 with the positions), and the two planes of the ping-pong pair (32.8 MB at
// 2000 x 2048) stay in the 50 MB L2 from pass to pass, so a flood's compulsory
// device-memory traffic is the plane once in and once out. Its arithmetic is an
// FP32 FMA for each row's and each column's coordinate (H + W a pass; this
// kernel forms cy once a 4-cell thread and cx once a cell) and 4 or 5 for each
// distinct owner among a cell's nine candidates. Both together bound a flood
// of 12 passes at 2000 x 2048 at a few hundredths of a millisecond. The kernel takes 0.45 ms
// there (measured on an H100), and 0.27 ms of it over a plane without owners,
// where every fold is skipped: what it pays for is mostly the nine owner reads
// a cell, 16-byte loads from L2 (about 150 MB a pass), with their index
// arithmetic, which a bound that reads every input once does not count.
//
// Design.
//   - The seed table (8 (S + 1) bytes: 32 KB at S = 4096, 128 KB at 16,384)
//     is staged into dynamic shared memory by every block; a candidate's
//     position is a gather from it (a warp's neighbours mostly share an owner,
//     which is a broadcast), and a neighbour without an owner needs none.
//   - A thread takes 4 adjacent cells of a row: its own owners are one 16-byte
//     load, and so is each neighbour row whenever step % 4 == 0 (every pass
//     but steps 1 and 2); all nine loads are started before the first fold, so
//     that a thread has them in flight together. Blocks are persistent (a
//     grid-stride loop over the 4-cell groups), so the table is staged once a
//     block, not once a tile.
//   - One call runs every pass of a flood: one cooperative launch with a grid
//     barrier between passes (a launch a pass from the same call measured 7 %
//     slower at 2000 x 2048 and 19 % at 384 x 512 on an H100).
//   - World axis: a group of G planes [G, H, W] with tables [G, S + 1, 2] and
//     origins [G] is one launch, as jax.vmap of the TPU kernel adds a grid
//     dimension, every world running the same pass list. The co-resident
//     blocks are divided evenly among the worlds; a block stages its own
//     world's table and walks that world's plane only. A group of more worlds
//     than co-resident blocks is launched in chunks (the entry point counts
//     its launches). One plane is G = 1.
//   - In a Pallas-rounded pass the d2 of one owner depends on the direction,
//     so a neighbour with the cell's current owner cannot simply be skipped.
//     The fold is a lexicographic min over the candidates' (d2, owner), which
//     no order changes, so the pass folds the candidates of each form apart,
//     each fold skipping an owner it holds (same owner, same position, same
//     form: the same d2), and takes the smaller of the two results. The cell's
//     own owner is in the alt fold; its d2 in the other form is computed with
//     it (a mul and an FMA or add), so that an X neighbour with the cell's
//     owner needs no gather. It folds a thread's 4 cells one at a time, so
//     that only one cell's two folds hold registers. The pass is a template on
//     the rounding; each pass of the launch picks its instance.
//   - Built with -fmad=false and written with __fsub_rn/__fmul_rn/__fmaf_rn so
//     that the compiler contracts nothing on its own: the cell coordinates and
//     d2 round exactly as the plain version's (ops.fma where the reference
//     is fused, separate operations elsewhere), and owners agree bit for bit
//     at near-ties.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kMaxSteps = 32;
constexpr int kMaxThreads = 1024;

// A pass's rounding of d2 for dx = px - cx, dy = py - cy. X is
// fma(dx, dx, dy * dy) for every candidate. The Pallas roundings give the
// cell's own owner and some neighbours m of fold order (dys, dxs) = (-1, -1),
// (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1) another form,
// "alt":
//   kPallas: alt = fma(dy, dy, dx * dx) for m = 0, 1;
//   kPallasLast (a flood's last pass, whose position planes XLA drops):
//     alt = dx * dx + dy * dy, each product rounded, for m = 0, 1, 2, 4.
enum Rounding { kXla = 0, kPallas = 1, kPallasLast = 2 };

__host__ __device__ constexpr bool takes_alt(int R, int m) {
  return R == kPallas ? m <= 1 : R == kPallasLast ? (m <= 2 || m == 4) : false;
}

struct Steps {
  int n;
  int v[kMaxSteps];
  int rounding[kMaxSteps];
};

// fma(dx, dx, dy * dy): the fused multiply-add XLA:CPU makes of the
// reference's (px - cx)^2 + (py - cy)^2, and the plain version's ops.fma
__device__ __forceinline__ float dist2(float2 p, float cx, float cy) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
}

// d2 in the alt form of rounding R
template <int R>
__device__ __forceinline__ float dist2_alt(float2 p, float cx, float cy) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  return R == kPallas ? __fmaf_rn(dy, dy, __fmul_rn(dx, dx))
                      : __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// d2 in both forms of rounding R: x = fma(dx, dx, dy * dy), y = alt
template <int R>
__device__ __forceinline__ float2 dist2_both(float2 p, float cx, float cy) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  const float dy2 = __fmul_rn(dy, dy);
  const float alt = R == kPallas ? __fmaf_rn(dy, dy, __fmul_rn(dx, dx))
                                 : __fadd_rn(__fmul_rn(dx, dx), dy2);
  return make_float2(__fmaf_rn(dx, dx, dy2), alt);
}

// Fold candidate owner `no` into the state (o, d2) of the cell at (cx, cy).
// Two candidates change nothing and cost neither a gather nor arithmetic: the
// cell's owner itself (its d2 is the state's, bit for bit), and "no owner"
// (d2 = 3.4e38 loses to every owner and ties only with an unowned cell, whose
// owner S is no higher: owners lie in 0..S).
__device__ __forceinline__ void fold(int no, int S, const float2* __restrict__ table, float cx,
                                     float cy, int& o, float& d2) {
  if (no == o || no >= S) return;
  const float nd = dist2(table[no], cx, cy);
  if (nd < d2 || (nd == d2 && no < o)) {
    o = no;
    d2 = nd;
  }
}

// The same for the alt fold of Pallas rounding R.
template <int R>
__device__ __forceinline__ void fold_alt(int no, int S, const float2* __restrict__ table,
                                         float cx, float cy, int& o, float& d2) {
  if (no == o || no >= S) return;
  const float nd = dist2_alt<R>(table[no], cx, cy);
  if (nd < d2 || (nd == d2 && no < o)) {
    o = no;
    d2 = nd;
  }
}

// The same for the X fold of a Pallas rounding, which starts empty (o = S,
// d2 = 3.4e38): a neighbour with the cell's own owner `own` takes `own_x`, the
// X form of that owner's d2, without a gather.
__device__ __forceinline__ void fold_x(int no, int S, const float2* __restrict__ table, float cx,
                                       float cy, int own, float own_x, int& o, float& d2) {
  if (no == o || no >= S) return;
  const float nd = no == own ? own_x : dist2(table[no], cx, cy);
  if (nd < d2 || (nd == d2 && no < o)) {
    o = no;
    d2 = nd;
  }
}

// Component k of a 4-cell group.
__device__ __forceinline__ int lane(int4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One pass at offset `step` in rounding R: src -> dst, over the 4-cell groups
// this thread owns. out_x/out_y, when not null, receive the new owners'
// positions.
template <int R>
__device__ __forceinline__ void pass(const int32_t* src, int32_t* dst,
                                     const float2* __restrict__ table, float ox0, float oy0,
                                     int H, int W, int S, float res, int step,
                                     float* __restrict__ out_x, float* __restrict__ out_y,
                                     int blk, int nblk) {
  const int wq = W >> 2;
  const long groups = (long)H * wq;
  const bool wide = (step & 3) == 0;
  for (long g = (long)blk * blockDim.x + threadIdx.x; g < groups;
       g += (long)nblk * blockDim.x) {
    const int iy = (int)(g / wq);
    const int x0 = (int)(g - (long)iy * wq) << 2;
    // every load of the group first, so that all nine are in flight together;
    // a neighbour outside the grid reads owner S, which never wins
    const int4 own = *reinterpret_cast<const int4*>(src + (size_t)iy * W + x0);
    int4 nb[8];
    int n = 0;
#pragma unroll
    for (int dys = -1; dys <= 1; ++dys) {
      const int ny = iy - dys * step;
      const bool row_in = ny >= 0 && ny < H;
      const int32_t* row = src + (size_t)(row_in ? ny : 0) * W;
#pragma unroll
      for (int dxs = -1; dxs <= 1; ++dxs) {
        if (dys == 0 && dxs == 0) continue;
        const int nx0 = x0 - dxs * step;
        if (wide) {
          // the 4 neighbours are one aligned group, inside the row or outside
          nb[n] = (row_in && nx0 >= 0 && nx0 < W) ? *reinterpret_cast<const int4*>(row + nx0)
                                                  : make_int4(S, S, S, S);
        } else {
          nb[n].x = (row_in && nx0 >= 0 && nx0 < W) ? row[nx0] : S;
          nb[n].y = (row_in && nx0 + 1 >= 0 && nx0 + 1 < W) ? row[nx0 + 1] : S;
          nb[n].z = (row_in && nx0 + 2 >= 0 && nx0 + 2 < W) ? row[nx0 + 2] : S;
          nb[n].w = (row_in && nx0 + 3 >= 0 && nx0 + 3 < W) ? row[nx0 + 3] : S;
        }
        ++n;
      }
    }
    const float cy = __fmaf_rn((float)iy, res, oy0);
    int o[4] = {own.x, own.y, own.z, own.w};
    if (R != kXla) {
      // a cell at a time, so that only one cell's two folds are live
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float cx = __fmaf_rn((float)(x0 + k), res, ox0);
        // the alt fold starts from the cell's own owner, the X fold empty;
        // own_x: the X form of the own owner's d2
        const int own_k = o[k];
        int oa = own_k, ox = S;
        float da = kInf, dx = kInf, own_x = kInf;
        if (own_k < S) {
          const float2 both = dist2_both<R>(table[own_k], cx, cy);
          da = both.y;
          own_x = both.x;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int no = lane(nb[m], k);
          if (takes_alt(R, m))
            fold_alt<R>(no, S, table, cx, cy, oa, da);
          else
            fold_x(no, S, table, cx, cy, own_k, own_x, ox, dx);
        }
        // the smaller (d2, owner) of the two folds
        o[k] = (dx < da || (dx == da && ox < oa)) ? ox : oa;
      }
    } else {
      float cx[4], d2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cx[k] = __fmaf_rn((float)(x0 + k), res, ox0);
        d2[k] = (o[k] < S) ? dist2(table[o[k]], cx[k], cy) : kInf;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        fold(nb[m].x, S, table, cx[0], cy, o[0], d2[0]);
        fold(nb[m].y, S, table, cx[1], cy, o[1], d2[1]);
        fold(nb[m].z, S, table, cx[2], cy, o[2], d2[2]);
        fold(nb[m].w, S, table, cx[3], cy, o[3], d2[3]);
      }
    }
    *reinterpret_cast<int4*>(dst + (size_t)iy * W + x0) = make_int4(o[0], o[1], o[2], o[3]);
    if (out_x != nullptr) {
      float2 p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = table[min(o[k], S)];
      *reinterpret_cast<float4*>(out_x + (size_t)iy * W + x0) =
          make_float4(p[0].x, p[1].x, p[2].x, p[3].x);
      *reinterpret_cast<float4*>(out_y + (size_t)iy * W + x0) =
          make_float4(p[0].y, p[1].y, p[2].y, p[3].y);
    }
  }
}

// Every pass of `steps`, pass p reading plane p % 2 and writing the other
// (plane 0 = a), with a grid barrier between passes: a cooperative launch.
// Block k works on world k / per_world of the launch, as its (k % per_world)-th
// block.
__global__ void __launch_bounds__(kMaxThreads)
flood_kernel(int32_t* a_all, int32_t* b_all, const float2* __restrict__ table_all,
             const float* __restrict__ origin_x, const float* __restrict__ origin_y,
             Steps steps, int H, int W, int S, float res, float* out_x_all, float* out_y_all,
             int per_world) {
  extern __shared__ float2 table[];
  const int world = blockIdx.x / per_world;
  const int blk = blockIdx.x - world * per_world;
  const size_t plane = (size_t)world * H * W;
  const float2* __restrict__ table_g = table_all + (size_t)world * (S + 1);
  int32_t* a = a_all + plane;
  int32_t* b = b_all + plane;
  float* out_x = out_x_all != nullptr ? out_x_all + plane : nullptr;
  float* out_y = out_y_all != nullptr ? out_y_all + plane : nullptr;
  for (int i = threadIdx.x; i <= S; i += blockDim.x) table[i] = table_g[i];
  __syncthreads();
  const float ox0 = origin_x[world], oy0 = origin_y[world];
  for (int p = 0; p < steps.n; ++p) {
    if (p > 0) cg::this_grid().sync();
    const bool closing = p + 1 == steps.n;
    int32_t* src = (p & 1) ? b : a;
    int32_t* dst = (p & 1) ? a : b;
    float* px = closing ? out_x : nullptr;
    float* py = closing ? out_y : nullptr;
    const int r = steps.rounding[p];
    if (r == kPallas)
      pass<kPallas>(src, dst, table, ox0, oy0, H, W, S, res, steps.v[p], px, py, blk, per_world);
    else if (r == kPallasLast)
      pass<kPallasLast>(src, dst, table, ox0, oy0, H, W, S, res, steps.v[p], px, py, blk,
                        per_world);
    else
      pass<kXla>(src, dst, table, ox0, oy0, H, W, S, res, steps.v[p], px, py, blk, per_world);
  }
}

// An error code for the caller, with the runtime's last-error state cleared so
// that the next launch's cudaGetLastError() does not report it again.
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

}  // namespace

// owner_a: the flood's initial owner planes i32 [worlds, H, W], owners in
// 0..S; they are one plane of the ping-pong pair and are overwritten.
// owner_b: the other planes. The result is in owner_a when n_steps is even,
// else in owner_b. table: f32 [worlds, S + 1, 2], row S of each = (1e9, 1e9).
// origin_x, origin_y: f32 [worlds] on the device. steps: n_steps (<= 32) pass
// offsets on the host, rounding: their Rounding codes on the host. out_ox, out_oy: f32 [worlds, H, W] for the closing
// pass's positions, or both null. W % 4 == 0. One cooperative launch for the
// group, or one for each chunk of worlds where the group has more worlds than
// co-resident blocks; *launches receives their number. An error where the
// card refuses a launch.
extern "C" int jfa_flood(void* owner_a, void* owner_b, const void* table, const void* origin_x,
                         const void* origin_y, const int* steps, const int* rounding,
                         int n_steps, int worlds, int H, int W, int S, float res, void* out_ox,
                         void* out_oy, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (n_steps < 0 || n_steps > kMaxSteps || worlds < 0 || H < 1 || W < 4 || (W & 3) != 0 ||
      S < 0 || (out_ox == nullptr) != (out_oy == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_steps == 0 || worlds == 0) return 0;
  Steps s;
  s.n = n_steps;
  for (int i = 0; i < n_steps; ++i) {
    if (steps[i] < 1 || rounding[i] < kXla || rounding[i] > kPallasLast)
      return (int)cudaErrorInvalidValue;
    s.v[i] = steps[i];
    s.rounding[i] = rounding[i];
  }
  // a small table leaves room for many small blocks, which a small grid needs
  // to fill the card; a large one is staged by few large blocks
  const size_t smem = sizeof(float2) * ((size_t)S + 1);
  const int threads = smem > 8192 ? 1024 : 256;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return fail(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return fail(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return fail(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_kernel, threads, smem);
  if (e != cudaSuccess) return fail(e);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the co-resident blocks shared evenly among the worlds of a launch, and no
  // more for a world than its 4-cell groups fill
  const long resident = (long)sms * per_sm;
  const long groups = (long)H * (W >> 2);
  const int chunk = (int)min((long)worlds, resident);
  const int per_world = (int)max(1L, min(resident / chunk, (groups + threads - 1) / threads));
  const size_t plane = (size_t)H * W;
  for (int w0 = 0; w0 < worlds; w0 += chunk) {
    const int n = min(chunk, worlds - w0);
    int32_t* a = static_cast<int32_t*>(owner_a) + w0 * plane;
    int32_t* b = static_cast<int32_t*>(owner_b) + w0 * plane;
    const float2* tab = static_cast<const float2*>(table) + (size_t)w0 * (S + 1);
    const float* gx = static_cast<const float*>(origin_x) + w0;
    const float* gy = static_cast<const float*>(origin_y) + w0;
    float* px = out_ox != nullptr ? static_cast<float*>(out_ox) + w0 * plane : nullptr;
    float* py = out_oy != nullptr ? static_cast<float*>(out_oy) + w0 * plane : nullptr;
    void* args[] = {(void*)&a,   (void*)&b,   (void*)&tab, (void*)&gx, (void*)&gy,
                    (void*)&s,   (void*)&H,   (void*)&W,   (void*)&S,  (void*)&res,
                    (void*)&px,  (void*)&py,  (void*)&per_world};
    e = cudaLaunchCooperativeKernel((const void*)flood_kernel, dim3(n * per_world),
                                    dim3(threads), args, smem, st);
    if (e != cudaSuccess) return fail(e);
    ++*launches;
  }
  return (int)cudaGetLastError();
}
