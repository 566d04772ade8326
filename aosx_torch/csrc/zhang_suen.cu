// Zhang-Suen thinning of a u8 {0,1} grid to the fixpoint, in one launch.
//
// Replaces the TPU kernel aosx/perceive/skeleton_pallas.py::zhang_suen_pallas
// (kernel body _make_iteration, stencil _subiter_band), which thins row bands
// with a 4-row halo DMA'd into VMEM, one pallas_call an iteration inside a
// while_loop. Semantics are those of aosx/perceive/skeleton.py::zhang_suen and
// of the plain PyTorch version
// aosx_torch/perceive/skeleton_cuda.py::zhang_suen_fixpoint_plain: neighbours
// outside the [H, W] buffer read 0; a cell is deleted only when it is 1 and
// lies in the interior of the live region, 1 <= y < h_cells - 1 and
// 1 <= x < w_cells - 1; an iteration is both sub-iterations; the loop stops
// after the first iteration that changes nothing, or after max_iters.
//
// Bound on the H100. The plane holds one bit of information a cell, and a
// thinning takes 10 to 20 iterations. Device memory has to see the u8 plane
// once in and once out (8 MB at 2000 x 2048, 2.4 us at 3.35 TB/s), and an
// iteration is a few tens of logic operations a word of 32 cells, well under a
// microsecond for the whole card: bytes and operations bound a thinning at a
// few microseconds. The kernel takes more than ten times that, and what it
// pays for is latency, which the bound does not count: each iteration depends
// on the whole of the one before, the stopping rule needs every band's changed
// count and a band its neighbours' new edge rows, so an iteration ends in a
// grid-wide barrier and a round trip through L2.
//
// Design.
//   - Bit-packed state: 32 cells of a row to a uint32 (bit b of word j is cell
//     x = 32 j + b). 2000 x 2048 is 512 KB, 384 x 512 is 24 KB.
//   - One persistent cooperative launch. Each block owns a band of rows and
//     keeps it, with two halo rows above and below, in shared memory for every
//     iteration (two copies: a sub-iteration reads one and writes the other).
//     The u8 plane is read once (warp ballots pack it) and written once.
//   - Bit-sliced stencil: a thread computes a word, 32 cells, a step. The
//     eight neighbour planes are the three rows' words shifted by a bit with
//     the carry bits of the words beside them; B in 2..6 is an adder tree
//     over the planes, A == 1 a saturating two-bit counter over the ring's
//     eight ~p_k & p_k+1 planes, the interior a word mask from the device
//     bounds. Words that are 0 are skipped.
//   - One barrier an iteration, not two: sub-iteration 0 also runs over one
//     halo row each side (the neighbour computes the same words), so
//     sub-iteration 1 of the band needs no exchange. After an iteration a
//     block publishes its band's first and last two rows to a global buffer
//     (one for even and one for odd iterations, so that a fast block cannot
//     overwrite rows its neighbour still has to read), the grid synchronises,
//     and each block reads its neighbours' edge rows. (Two barriers an
//     iteration with one-row halos measured 0.111 ms a thinning at 2000 x 2048
//     where this takes less; PERF.md has both.)
//   - The cells an iteration deleted (__popc of the deleted words, summed over
//     a warp, one atomic a warp that deleted any) go to a slot of their own for
//     each iteration; every block reads the slot after the barrier and all
//     stop together when it is 0. No host read anywhere.
//   - World axis: a group of G planes [G, H, W] with per-world bounds is one
//     launch, as jax.vmap of the TPU kernel's loop adds a grid dimension.
//     Each world gets the same number of bands (blocks), at most the SMs
//     divided among the worlds; a world's blocks exchange edge rows only
//     among themselves. The stopping rule is per world: a world stops at its
//     own fixpoint or at max_iters, and its blocks then keep meeting the
//     grid barrier without working (their state stays as it is) until every
//     world of the launch has stopped, which a per-iteration total of the
//     group's deleted cells tells every block at once. A group of more worlds
//     than SMs is launched in chunks of at most one world an SM (the entry
//     point counts its launches; a plane too high for one block is refused).
//     One plane is G = 1.
//   - The grid is at most one block an SM (the barrier's latency grows with
//     the blocks that meet at it: 250 and 264 blocks measured slower at 2000 x
//     2048, and so did 66), which must be co-resident or the barrier never completes: the
//     entry point asks the occupancy of this kernel with the shared memory it
//     requests, and returns an error where a band does not fit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// bits of word j that lie in columns [1, wc - 1)
__device__ __forceinline__ uint32_t column_mask(int j, int wc) {
  const int lo = max(1, 32 * j) - 32 * j;
  const int hi = min(wc - 1, 32 * j + 32) - 32 * j;
  if (hi <= lo) return 0u;
  const uint32_t ones = (hi - lo == 32) ? kFull : ((1u << (hi - lo)) - 1u);
  return ones << lo;
}

__device__ __forceinline__ void full_add(uint32_t a, uint32_t b, uint32_t c, uint32_t& s,
                                         uint32_t& carry) {
  const uint32_t ab = a ^ b;
  s = ab ^ c;
  carry = (a & b) | (c & ab);
}

// Word j of a row after sub-iteration PHASE. `mid` points at the row in a
// band's copy, with the rows above and below it wd words before and after.
template <int PHASE>
__device__ __forceinline__ uint32_t subiter_word(const uint32_t* __restrict__ mid, int j, int wd,
                                                 uint32_t interior) {
  const uint32_t c = mid[j];
  const uint32_t live = c & interior;
  if (live == 0u) return c;
  const uint32_t* up = mid - wd;
  const uint32_t* dn = mid + wd;
  const bool has_l = j > 0, has_r = j + 1 < wd;
  const uint32_t ul = has_l ? up[j - 1] : 0u, uc = up[j], ur = has_r ? up[j + 1] : 0u;
  const uint32_t ml = has_l ? mid[j - 1] : 0u, mr = has_r ? mid[j + 1] : 0u;
  const uint32_t dl = has_l ? dn[j - 1] : 0u, dc = dn[j], dr = has_r ? dn[j + 1] : 0u;
  // p2..p9: N, NE, E, SE, S, SW, W, NW with row y-1 as "N"; the cell at x+1 is
  // the next higher bit
  const uint32_t p2 = uc;
  const uint32_t p3 = (uc >> 1) | (ur << 31);
  const uint32_t p4 = (c >> 1) | (mr << 31);
  const uint32_t p5 = (dc >> 1) | (dr << 31);
  const uint32_t p6 = dc;
  const uint32_t p7 = (dc << 1) | (dl >> 31);
  const uint32_t p8 = (c << 1) | (ml >> 31);
  const uint32_t p9 = (uc << 1) | (ul >> 31);
  // B = p2 + ... + p9 as bit planes b3 b2 b1 b0
  uint32_t s1, c1, s2, c2, b0, c4, s5, c5;
  full_add(p2, p3, p4, s1, c1);
  full_add(p5, p6, p7, s2, c2);
  const uint32_t s3 = p8 ^ p9, c3 = p8 & p9;
  full_add(s1, s2, s3, b0, c4);
  full_add(c1, c2, c3, s5, c5);
  const uint32_t b1 = s5 ^ c4, c6 = s5 & c4;
  const uint32_t b2 = c5 ^ c6, b3 = c5 & c6;
  const uint32_t b_ok = (b1 | b2) & ~b3 & ~(b2 & b1 & b0);
  // A == 1: exactly one 0 -> 1 step around the ring
  uint32_t one = 0u, two = 0u, t;
#define AOSX_RING(a, b) \
  t = ~(a) & (b);       \
  two |= one & t;       \
  one |= t;
  AOSX_RING(p2, p3) AOSX_RING(p3, p4) AOSX_RING(p4, p5) AOSX_RING(p5, p6)
  AOSX_RING(p6, p7) AOSX_RING(p7, p8) AOSX_RING(p8, p9) AOSX_RING(p9, p2)
#undef AOSX_RING
  const uint32_t m = (PHASE == 0) ? (~(p2 & p4 & p6) & ~(p4 & p6 & p8))
                                  : (~(p2 & p4 & p8) & ~(p2 & p6 & p8));
  return c & ~(live & b_ok & one & ~two & m);
}

constexpr int kHalo = 2;  // halo rows above and below a band

// Sub-iteration PHASE over local rows [first, last) of a band's copy `src`
// (local row kHalo is the band's row 0, global row r0) into `dst`. Returns
// this thread's deleted cells in the band's own rows.
template <int PHASE>
__device__ __forceinline__ int subiter_rows(const uint32_t* __restrict__ src,
                                            uint32_t* __restrict__ dst, int first, int last,
                                            int r0, int nrows, int wd, int hc, int wc) {
  int deleted = 0;
  for (int i = first * wd + threadIdx.x; i < last * wd; i += blockDim.x) {
    const int lr = i / wd, j = i - lr * wd;
    const int y = r0 - kHalo + lr;
    const uint32_t interior = (y >= 1 && y < hc - 1) ? column_mask(j, wc) : 0u;
    const uint32_t old = src[i];
    const uint32_t q = subiter_word<PHASE>(src + (size_t)lr * wd, j, wd, interior);
    dst[i] = q;
    if (lr >= kHalo && lr < kHalo + nrows) deleted += __popc(old ^ q);
  }
  return deleted;
}

__global__ void __launch_bounds__(kMaxThreads)
fixpoint_kernel(const uint8_t* __restrict__ in_all, uint8_t* __restrict__ out_all,
                const int32_t* __restrict__ h_cells, const int32_t* __restrict__ w_cells,
                int32_t* __restrict__ stats, int32_t* counts_all, int32_t* totals, uint32_t* edges,
                int H, int W, int rows, int bands, int max_iters) {
  extern __shared__ uint32_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int wd = (W + 31) / 32;
  const int world = blockIdx.x / bands;
  const int b = blockIdx.x - world * bands;
  const uint8_t* __restrict__ in = in_all + (size_t)world * H * W;
  uint8_t* __restrict__ out = out_all + (size_t)world * H * W;
  int32_t* counts = counts_all + (size_t)world * max_iters;
  const int r0 = b * rows;
  const int nrows = min(rows, H - r0);
  const int local = nrows + 2 * kHalo;
  uint32_t* cur = smem;                                     // the iteration's start and end
  uint32_t* mid = smem + (size_t)(rows + 2 * kHalo) * wd;   // after sub-iteration 0
  const int hc = h_cells[world], wc = w_cells[world];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  // pack rows r0 - 2 .. r0 + nrows + 1 (the band and its halo) from the u8
  // plane: a warp a word, a lane a cell, eight words' loads in flight
  constexpr int kUnroll = 8;
  for (int base = warp * kUnroll; base < local * wd; base += nwarps * kUnroll) {
    bool set[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u;
      const int lr = i / wd, j = i - lr * wd;
      const int y = r0 - kHalo + lr, x = 32 * j + lane;
      set[u] = (i < local * wd && y >= 0 && y < H && x < W) ? in[(size_t)y * W + x] != 0 : false;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t word = __ballot_sync(kFull, set[u]);
      if (lane == 0 && base + u < local * wd) cur[base + u] = word;
    }
  }
  __syncthreads();

  // edge rows a block publishes: [parity][block][top 2 rows, bottom 2 rows][wd]
  const size_t per_block = (size_t)2 * kHalo * wd;
  // `done` is the same for every thread of a block (all read the same count)
  bool done = false;
  int iters = 0, last = 0;
  for (int it = 0; it < max_iters; ++it) {
    uint32_t* parity = edges + (size_t)(it & 1) * gridDim.x * per_block;
    uint32_t* mine = parity + (size_t)blockIdx.x * per_block;
    if (!done) {
      // sub-iteration 0 also over one halo row each side (the neighbours
      // compute the same words), so that sub-iteration 1 of the band needs no
      // exchange
      int deleted = subiter_rows<0>(cur, mid, 1, local - 1, r0, nrows, wd, hc, wc);
      __syncthreads();
      deleted += subiter_rows<1>(mid, cur, kHalo, kHalo + nrows, r0, nrows, wd, hc, wc);
      deleted = __reduce_add_sync(kFull, deleted);
      if (lane == 0 && deleted > 0) {
        atomicAdd(counts + it, deleted);
        atomicAdd(totals + it, deleted);
      }
      __syncthreads();
      // publish the band's first and last two rows (a band of one row, which
      // only a world's last block can have, has an empty second row)
      for (int i = threadIdx.x; i < kHalo * wd; i += blockDim.x) {
        const int k = i / wd, j = i - k * wd;
        mine[i] = (k < nrows) ? cur[(size_t)(kHalo + k) * wd + j] : 0u;
        const int kb = nrows - kHalo + k;
        mine[kHalo * wd + i] = (kb >= 0) ? cur[(size_t)(kHalo + kb) * wd + j] : 0u;
      }
    }
    grid.sync();
    // the iteration's changed counts (the world's and the launch's) and the
    // halo rows in one round trip: the last two rows of the world's block
    // above, the first two of its block below
    const int group_deleted = __ldcg(totals + it);
    if (!done) {
      last = __ldcg(counts + it);
      for (int i = threadIdx.x; i < kHalo * wd; i += blockDim.x) {
        cur[i] = (b > 0) ? __ldcg(mine - per_block + kHalo * wd + i) : 0u;
        cur[(size_t)(kHalo + nrows) * wd + i] =
            (b + 1 < bands) ? __ldcg(mine + per_block + i) : 0u;
      }
      __syncthreads();
      iters = it + 1;
      done = last == 0;
    }
    if (group_deleted == 0) break;
  }

  for (int i = warp; i < nrows * wd; i += nwarps) {
    const int r = i / wd, j = i - r * wd;
    const int x = 32 * j + lane;
    if (x < W) out[(size_t)(r0 + r) * W + x] = (cur[(size_t)(kHalo + r) * wd + j] >> lane) & 1u;
  }
  if (b == 0 && threadIdx.x == 0) {
    stats[2 * world] = iters;
    stats[2 * world + 1] = last;
  }
}

// An error code for the caller, with the runtime's last-error state cleared so
// that the next launch's cudaGetLastError() does not report it again.
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

}  // namespace

// in, out: u8 [worlds, H, W] holding only 0 and 1; h_cells, w_cells: i32
// [worlds] on the device; stats: i32 [worlds, 2] = iterations run, the last
// iteration's changed cells, per world; scratch: i32 [min(worlds, SMs) *
// max_iters + max_iters + 8 * SMs of the device * ceil(W / 32)] (the
// per-world and per-iteration changed counts, the launch's per-iteration
// totals, then the bands' edge rows). Cooperative launches of at most a block
// an SM, each world the same number of bands: one launch for the group when
// it has at most one world an SM, else one for each chunk of that many
// worlds; *launches receives their number. An error where the card refuses
// a launch or a band does not fit a block.
extern "C" int zhang_suen_fixpoint(const void* in, void* out, const void* h_cells,
                                   const void* w_cells, void* stats, void* scratch, int worlds,
                                   int H, int W, int max_iters, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (H < 1 || W < 1 || max_iters < 0 || worlds < 0) return (int)cudaErrorInvalidValue;
  if (worlds == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return fail(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return fail(e);
  // the SMs shared among the worlds of a launch; a band is at least as high
  // as its halo, so that a block's halo rows all come from the one block
  // above or below
  const int chunk = min(worlds, sms);
  const int per_world = sms / chunk;
  const int wd = (W + 31) / 32;
  const int rows = max(kHalo, (H + per_world - 1) / per_world);
  const int bands = (H + rows - 1) / rows;
  const long words = (long)(rows + 2) * wd;
  const int threads = (int)min((long)kMaxThreads, max(32L, (words + 31) / 32 * 32));
  const size_t smem = 2 * (size_t)(rows + 2 * kHalo) * wd * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return fail(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixpoint_kernel, threads, smem);
  if (e != cudaSuccess) return fail(e);
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* totals = counts + (size_t)chunk * max_iters;
  uint32_t* edges = reinterpret_cast<uint32_t*>(totals + max_iters);
  const size_t plane = (size_t)H * W;
  for (int w0 = 0; w0 < worlds; w0 += chunk) {
    const int n = min(chunk, worlds - w0);
    if (max_iters > 0) {
      e = cudaMemsetAsync(counts, 0, sizeof(int32_t) * ((size_t)chunk * max_iters + max_iters),
                          st);
      if (e != cudaSuccess) return fail(e);
    }
    const uint8_t* in_n = static_cast<const uint8_t*>(in) + w0 * plane;
    uint8_t* out_n = static_cast<uint8_t*>(out) + w0 * plane;
    const int32_t* hc_n = static_cast<const int32_t*>(h_cells) + w0;
    const int32_t* wc_n = static_cast<const int32_t*>(w_cells) + w0;
    int32_t* stats_n = static_cast<int32_t*>(stats) + 2 * (size_t)w0;
    void* args[] = {(void*)&in_n,   (void*)&out_n,  (void*)&hc_n,     (void*)&wc_n,
                    (void*)&stats_n, (void*)&counts, (void*)&totals, (void*)&edges,
                    (void*)&H,      (void*)&W,      (void*)&rows,     (void*)&bands,
                    (void*)&max_iters};
    e = cudaLaunchCooperativeKernel((const void*)fixpoint_kernel, dim3(n * bands),
                                    dim3(threads), args, smem, st);
    if (e != cudaSuccess) return fail(e);
    ++*launches;
  }
  return (int)cudaGetLastError();
}
