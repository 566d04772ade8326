// The Jacobi jump flood over an owner plane (i32 [H, W], S = no owner): every
// pass of a flood from one call, carrying the flood's owner, x and y planes.
//
// Replaces the TPU kernel aosx/gvd/jfa_pass_pallas.py::jfa_pass (line 189;
// body built by _make_pass), which runs one pass with step <= 128 over row
// bands of the three carried planes (owner, ox, oy) with a halo DMA'd into
// VMEM. Semantics are those of aosx/gvd/voronoi.py's Jacobi pass and of the
// plain PyTorch versions aosx_torch/gvd/jfa_pass_cuda.py::jfa_pass_plain /
// jfa_flood_plain: each of the three planes is a lexicographic (d2, owner) min
// over the cell's own triple (owner, x, y) and the 8 neighbour triples at
// (y - dys*step, x - dxs*step), in the (dys, dxs) order of voronoi.jacobi_fold,
// d2 measured from the candidate's carried position; the owner plane takes
// its winner's owner, the x plane its winner's x, the y plane its winner's y.
// Neighbours outside the grid read owner S; owners >= S never win (their d2 is
// 3.4e38). Cell coordinates are fma((float)index, res, origin), a cell's x
// rounded twice where the pass says so (kSplitXBit). Each plane
// rounds each candidate's d2 in one of three forms, as XLA:CPU builds that
// plane's fusion in the lowering aosx runs the pass in (voronoi.ROUNDINGS; the
// call gives each pass its forms, Steps::forms): planes rounded apart can take
// different seeds at an exact tie, and a cell's position then leaves its
// owner's seed.
//
// Design.
//   - A position only ever holds a seed's coordinate (or row S's 1e9), so it
//     is carried as seed indices: a position word, the x's seed in bits 0-15
//     and the y's in 16-31 (S <= 65535), read through the seed table in
//     shared memory (8 (S + 1) bytes: 32 KB at S = 4096), staged once a block.
//   - Nearly every cell's position is its owner's seed. The owner word carries
//     a flag (bit 16) where it is not, and only such a cell stores its
//     position word, in a second ping-pong pair of planes: a pass reads and
//     writes the owner words as before, and a flagged cell's word besides.
//   - The owner plane's fold also keeps the least d2 of a triple other than
//     its winner. The forms of one position's d2 differ by a few ulps, so
//     where no other triple comes within 2^-18 of the winner every plane's
//     fold takes the winner's triple; only at such a near tie are the x and y
//     planes folded in full (xy_folds, out of line, their candidates read
//     again). A neighbour carrying the cell's own triple where the owner fold
//     asks the own's form of it is skipped (same d2, no change); a held owner
//     is no longer skipped, as its position may differ.
//   - A thread takes a cell, its nine owner loads started before the fold;
//     blocks are persistent (a grid-stride loop over the cells), so the table
//     is staged once a block. One call runs every pass of a flood: one
//     cooperative launch with a grid barrier between passes. The flood's last
//     pass folds the owner plane alone unless the caller asks for positions,
//     and writes plain owners.
//   - World axis: a group of G planes [G, H, W] with tables [G, S + 1, 2] and
//     origins [G] is one launch, as jax.vmap of the TPU kernel adds a grid
//     dimension, every world running the same pass list. The co-resident
//     blocks are divided evenly among the worlds; a block stages its own
//     world's table and walks that world's plane only. A group of more worlds
//     than co-resident blocks is launched in chunks (the entry point counts
//     its launches). One plane is G = 1.
//   - A chain (voronoi.CHAINS: a Pallas pass over one row band, which XLA
//     fuses into its consumer and recomputes there) is made in two versions
//     (voronoi.CHAIN_VERSIONS): "p", the cells' y rounded once, the carried
//     planes; "s", the y rounded twice, a second owner and position
//     ping-pong pair that the next chain pass reads for the two neighbours
//     in the cell's row. Each version carries two more triples a cell, "a"
//     and "b", which its folds may start from instead of the cell's own
//     carried triple, as an owner and a position word each in planes of
//     their own; a cell reads and writes only its own, so they need no
//     second copy. A chain pass folds each version's five outputs (owner,
//     x, y planes, a, b) in full, out of line (chain_cell): chains occur
//     only on grids of at most 104 rows.
//   - Built with -fmad=false and written with __fsub_rn/__fmul_rn/__fmaf_rn so
//     that the compiler contracts nothing on its own: the cell coordinates and
//     every form of d2 round exactly as the plain version's (ops.fma where the
//     reference is fused, separate operations elsewhere), and all three planes
//     agree bit for bit at exact and near ties.
//
// Bound on the H100 (chip_smoke.py's k1_ops_by_pass). A flood must read the
// owner plane once and write it once (8 B a cell) and read the table: the
// carried positions start as the owners' seeds and are the kernel's own state
// from pass to pass. Its arithmetic is H + W FP32 FMAs a pass for the
// coordinates and, for each distinct candidate (owner and position) among a
// cell's nine, 2 subtractions, the products and an FMA or add for each form
// the owner plane's fold asks, with a compare (the x and y planes' folds take
// its winner but at near ties): a few hundredths of a millisecond a flood at
// 2000 x 2048. The kernel's time goes to the nine
// owner loads a cell from L2 and their index arithmetic, which a bound that
// reads every input once does not count (PERF.md section 6).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kMaxSteps = 32;
// threads a block where the table is large (a small one takes 256)
constexpr int kMaxThreads = 1024;
// an owner or a position index (a seed, or S for "none") takes 16 bits
constexpr int kMaxSeeds = 0xffff;
// the owner word's flag of a cell whose position is not its owner's seed
constexpr int kPhantom = 1 << 16;

// A pass's forms: for each fold (the owner, x and y planes, and a chain's
// triples a and b), 2 bits per candidate m = 0 (the own triple) .. 8 (the
// neighbours in jacobi_fold's order), bits 2m and 2m + 1: 0 = fma(dx, dx,
// dy * dy), 1 = fma(dy, dy, dx * dx), 2 = dx * dx + dy * dy with both
// products rounded. own: the triple each fold starts from, 2 bits a fold
// (0 the carried planes, 1 a, 2 b), and bit kChainBit where the pass is a
// chain pass (voronoi.CHAINS: its five folds out of line, a and b written).
constexpr int kFolds = 5;
constexpr int kChainBit = 1 << 10;
// own's flag of a pass whose cells' x is rounded twice, the product and then
// the sum (voronoi.SPLIT_X); else once, fma((float)x, res, origin)
constexpr int kSplitXBit = 1 << 11;
// a chain's planes a world: the triples a and b of its two versions (an
// owner and a position plane each), the "s" version's owner and position
// ping-pong pairs
constexpr int kChainPlanes = 12;
struct Steps {
  int n;
  int v[kMaxSteps];
  int forms[kMaxSteps][kFolds];
  int own[kMaxSteps];
};

// A position word: the seed whose x the cell carries in bits 0-15, the seed
// whose y it carries in bits 16-31 (table row S: no owner, (1e9, 1e9)).
__device__ __forceinline__ uint32_t pack(int ix, int iy) {
  return (uint32_t)ix | ((uint32_t)iy << 16);
}

// The position word of the cell (y, x) of a position plane: out of line, as
// it is read only for the rare flagged cells, so that its index arithmetic
// holds no registers in the loop.
__device__ __noinline__ uint32_t stored_position(const int32_t* pos, int y, int x, int W) {
  return (uint32_t)pos[(size_t)y * W + x];
}

// The position of the candidate at (y, x) whose owner word is w: its owner's
// seed, or the stored word where the flag says it is not.
__device__ __forceinline__ uint32_t position(int w, const int32_t* pos, int y, int x, int W) {
  return (w & kPhantom) ? stored_position(pos, y, x, W) : pack(w & 0xffff, w & 0xffff);
}

// d2 of the position p from the cell (cx, cy) in the three forms
struct D2 {
  float f[3];
};

__device__ __forceinline__ D2 dist2_forms(uint32_t p, const float2* __restrict__ table, float cx,
                                          float cy) {
  const float dx = __fsub_rn(table[p & 0xffff].x, cx);
  const float dy = __fsub_rn(table[p >> 16].y, cy);
  const float dx2 = __fmul_rn(dx, dx);
  const float dy2 = __fmul_rn(dy, dy);
  return D2{{__fmaf_rn(dx, dx, dy2), __fmaf_rn(dy, dy, dx2), __fadd_rn(dx2, dy2)}};
}

// d2 in the form of candidate m of a plane's forms (selects, no indexing, so
// that D2 stays in registers)
__device__ __forceinline__ float in_form(const D2& d, int forms, int m) {
  const int c = (forms >> (2 * m)) & 3;
  return c == 0 ? d.f[0] : c == 1 ? d.f[1] : d.f[2];
}

// One plane's fold state: the (d2, owner) minimum so far and its position.
struct Best {
  int o;
  uint32_t p;
  float d;
};

__device__ __forceinline__ void take(Best& b, int no, uint32_t np, float nd) {
  if (nd < b.d || (nd == b.d && no < b.o)) {
    b.o = no;
    b.p = np;
    b.d = nd;
  }
}

// The bits m (candidates 0..8) at which a plane's forms ask the form of its
// candidate 0, the cell's own triple: a neighbour carrying that same triple
// there has the own's d2 in that fold and cannot win it.
__device__ __forceinline__ int same_as_own(int forms) {
  int bits = 0;
#pragma unroll
  for (int m = 0; m < 9; ++m) bits |= (((forms >> (2 * m)) & 3) == (forms & 3)) << m;
  return bits;
}

// The x and y planes' folds of the cell (y, x) in the forms fx, fy, each a
// lexicographic (d2, owner) min over the cell's own triple and its 8
// neighbours, read again from src: the position word that takes the x plane
// winner's x and the y plane winner's y. Out of line, for the rare cells
// where the owner plane's fold finds a near tie.
__device__ __noinline__ uint32_t xy_folds(const int32_t* src, const int32_t* pos_src,
                                          const float2* __restrict__ table, float cx, float cy,
                                          int y, int x, int H, int W, int S, int step, int fx,
                                          int fy) {
  const int w0 = src[(size_t)y * W + x];
  const int own = w0 & 0xffff;
  const uint32_t ownp = position(w0, pos_src, y, x, W);
  const D2 od = own < S ? dist2_forms(ownp, table, cx, cy) : D2{{kInf, kInf, kInf}};
  Best b1{own, ownp, in_form(od, fx, 0)};
  Best b2{own, ownp, in_form(od, fy, 0)};
  int m = 1;
  for (int dys = -1; dys <= 1; ++dys) {
    for (int dxs = -1; dxs <= 1; ++dxs) {
      if (dys == 0 && dxs == 0) continue;
      const int ny = y - dys * step, nx = x - dxs * step;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
        const int w = src[(size_t)ny * W + nx];
        const int o = w & 0xffff;
        if (o < S) {
          const uint32_t p = position(w, pos_src, ny, nx, W);
          const D2 d = dist2_forms(p, table, cx, cy);
          take(b1, o, p, in_form(d, fx, m));
          take(b2, o, p, in_form(d, fy, m));
        }
      }
      ++m;
    }
  }
  return (b1.p & 0xffffu) | (b2.p & 0xffff0000u);
}

// A chain pass at the cell (iy, x) (voronoi.CHAINS), in both versions v
// (0: "p", the y cy[0]; 1: "s", cy[1]): each of the five folds (owner, x and
// y planes, then the triples a and b) in full, from the triple own says (the
// carried triple, or v's a or b), over the 8 neighbours' carried triples, the
// two in the cell's row read from the "s" planes (ssrc, spos_src) unless the
// pass starts the chain. Writes each version's owner word (and position word
// where flagged): "p" to dst, "s" to sdst; and its a and b triples in place
// (tri: 8 planes, a and b of "p", then of "s", an owner and a position plane
// each).
__device__ __noinline__ void chain_cell(const int32_t* src, int32_t* dst, const int32_t* pos_src,
                                        int32_t* pos_dst, const int32_t* ssrc, int32_t* sdst,
                                        const int32_t* spos_src, int32_t* spos_dst, int32_t* tri,
                                        const float2* __restrict__ table, float cx, const float* cy,
                                        int iy, int x, int H, int W, int S, int step,
                                        const int* forms, int own, bool start) {
  const size_t c = (size_t)iy * W + x;
  const size_t hw = (size_t)H * W;
  const int w0 = src[c];
  int no[8];
  uint32_t np[8];
  int m = 0;
  for (int dys = -1; dys <= 1; ++dys) {
    for (int dxs = -1; dxs <= 1; ++dxs) {
      if (dys == 0 && dxs == 0) continue;
      const int ny = iy - dys * step, nx = x - dxs * step;
      no[m] = S;
      np[m] = 0;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
        const bool row = dys == 0 && !start;
        const int w = (row ? ssrc : src)[(size_t)ny * W + nx];
        no[m] = w & 0xffff;
        if (no[m] < S) np[m] = position(w, row ? spos_src : pos_src, ny, nx, W);
      }
      ++m;
    }
  }
  for (int v = 0; v < 2; ++v) {
    int32_t* t = tri + 4 * v * hw;
    int oo[3] = {w0 & 0xffff, t[c], t[2 * hw + c]};
    uint32_t pp[3] = {position(w0, pos_src, iy, x, W), (uint32_t)t[hw + c],
                      (uint32_t)t[3 * hw + c]};
    Best r[kFolds];
    for (int f = 0; f < kFolds; ++f) {
      const int s = (own >> (2 * f)) & 3;
      const int fw = forms[f];
      Best b{oo[s], pp[s],
             oo[s] < S ? in_form(dist2_forms(pp[s], table, cx, cy[v]), fw, 0) : kInf};
      for (int k = 0; k < 8; ++k)
        if (no[k] < S)
          take(b, no[k], np[k], in_form(dist2_forms(np[k], table, cx, cy[v]), fw, k + 1));
      r[f] = b;
    }
    const uint32_t rp = (r[1].p & 0xffffu) | (r[2].p & 0xffff0000u);
    int32_t* d = v ? sdst : dst;
    int32_t* pd = v ? spos_dst : pos_dst;
    if (rp != pack(r[0].o, r[0].o)) {
      d[c] = r[0].o | kPhantom;
      pd[c] = (int)rp;
    } else {
      d[c] = r[0].o;
    }
    t[c] = r[3].o;
    t[hw + c] = (int)r[3].p;
    t[2 * hw + c] = r[4].o;
    t[3 * hw + c] = (int)r[4].p;
  }
}

// One pass at offset `step` with the plane forms fo, fx, fy: the owner words
// src -> dst over the cells this thread owns. An owner word is the owner
// (bits 0-15) and the kPhantom flag of a cell whose position is not its
// owner's seed; only such a cell's position word is stored (pos_src,
// pos_dst). kPos: carry the x and y planes too (the owner fold's winner's
// position, or at a near tie xy_folds'), as flagged words or, in the closing
// pass where out_x is not null, as coordinates to out_x/out_y; without kPos
// only the owner plane is folded (a flood's last pass). The closing pass
// writes plain owners.
template <bool kPos>
__device__ __forceinline__ void pass(const int32_t* src, int32_t* dst, const int32_t* pos_src,
                                     int32_t* pos_dst, const float2* __restrict__ table,
                                     float ox0, float oy0, int H, int W, int S, float res,
                                     int step, int fo, int fx, int fy, bool split_x, bool closing,
                                     float* __restrict__ out_x, float* __restrict__ out_y,
                                     int blk, int nblk) {
  const long cells = (long)H * W;
  const int so = same_as_own(fo);
  for (long c = (long)blk * blockDim.x + threadIdx.x; c < cells;
       c += (long)nblk * blockDim.x) {
    const int iy = (int)(c / W);
    const int x = (int)(c - (long)iy * W);
    // every owner load of the cell first, so that all nine are in flight
    // together; a neighbour outside the grid reads owner S, which never wins
    int nb[9];
    nb[0] = src[c];
    int n = 1;
#pragma unroll
    for (int dys = -1; dys <= 1; ++dys) {
      const int ny = iy - dys * step;
      const bool row_in = ny >= 0 && ny < H;
#pragma unroll
      for (int dxs = -1; dxs <= 1; ++dxs) {
        if (dys == 0 && dxs == 0) continue;
        const int nx = x - dxs * step;
        nb[n++] = (row_in && nx >= 0 && nx < W) ? src[(size_t)ny * W + nx] : S;
      }
    }
    const float cy = __fmaf_rn((float)iy, res, oy0);
    const float cx =
        split_x ? __fadd_rn(__fmul_rn((float)x, res), ox0) : __fmaf_rn((float)x, res, ox0);
    const int own = nb[0] & 0xffff;
    const uint32_t ownp = position(nb[0], pos_src, iy, x, W);
    // The owner plane's fold, with the least d2 of a triple other than the
    // held one (sec): where no other triple comes within 2^-18 of the
    // winner's d2, no form can reorder them (the forms of one position lie
    // within a few ulps of each other), so the x and y planes' folds take the
    // winner's triple too; else they are folded in full (xy_folds).
    Best b0{own, ownp, own < S ? in_form(dist2_forms(ownp, table, cx, cy), fo, 0) : kInf};
    float sec = kInf;
    int m = 1;
#pragma unroll
    for (int dys = -1; dys <= 1; ++dys) {
#pragma unroll
      for (int dxs = -1; dxs <= 1; ++dxs) {
        if (dys == 0 && dxs == 0) continue;
        const int w = nb[m];
        const int o = w & 0xffff;
        // a neighbour carrying the cell's own triple where the fold asks the
        // own's form of it has the own's d2: it changes nothing
        if (o < S) {
          const uint32_t p = position(w, pos_src, iy - dys * step, x - dxs * step, W);
          if (!(o == own && p == ownp && ((so >> m) & 1))) {
            const float d = in_form(dist2_forms(p, table, cx, cy), fo, m);
            const bool held = o == b0.o && p == b0.p;
            if (d < b0.d || (d == b0.d && o < b0.o)) {
              if (!held) sec = fminf(sec, b0.d);
              b0 = Best{o, p, d};
            } else if (!held) {
              sec = fminf(sec, d);
            }
          }
        }
        ++m;
      }
    }
    uint32_t rp = b0.p;
    if (kPos && b0.o < S && !(sec > __fmul_rn(b0.d, 1.0f + 0x1p-18f)))
      rp = xy_folds(src, pos_src, table, cx, cy, iy, x, H, W, S, step, fx, fy);
    if (closing) {
      dst[c] = b0.o;
      if (kPos && out_x != nullptr) {
        out_x[c] = table[rp & 0xffff].x;
        out_y[c] = table[rp >> 16].y;
      }
    } else if (rp != pack(b0.o, b0.o)) {
      dst[c] = b0.o | kPhantom;
      pos_dst[c] = (int)rp;
    } else {
      dst[c] = b0.o;
    }
  }
}

// Every pass of `steps`, pass p reading the planes p % 2 and writing the
// others (owner plane 0 = a, position plane 0 = pa), with a grid barrier
// between passes: a cooperative launch. Block k works on world k / per_world
// of the launch, as its (k % per_world)-th block.
__global__ void __launch_bounds__(kMaxThreads)
flood_kernel(int32_t* a_all, int32_t* b_all, int32_t* pa_all, int32_t* pb_all,
             int32_t* chain_all, const float2* __restrict__ table_all,
             const float* __restrict__ origin_x, const float* __restrict__ origin_y,
             const __grid_constant__ Steps steps,
             int H, int W, int S, float res, float* out_x_all, float* out_y_all, int per_world) {
  extern __shared__ float2 table[];
  const int world = blockIdx.x / per_world;
  const int blk = blockIdx.x - world * per_world;
  const size_t plane = (size_t)world * H * W;
  const float2* __restrict__ table_g = table_all + (size_t)world * (S + 1);
  int32_t* a = a_all + plane;
  int32_t* b = b_all + plane;
  int32_t* pa = pa_all != nullptr ? pa_all + plane : nullptr;
  int32_t* pb = pb_all != nullptr ? pb_all + plane : nullptr;
  float* out_x = out_x_all != nullptr ? out_x_all + plane : nullptr;
  float* out_y = out_y_all != nullptr ? out_y_all + plane : nullptr;
  // a chain's planes (kChainPlanes a world): the triples a and b of "p" and
  // of "s" (an owner and a position plane each), then the "s" owner words'
  // and position words' ping-pong pairs
  int32_t* chain = chain_all != nullptr ? chain_all + kChainPlanes * plane : nullptr;
  for (int i = threadIdx.x; i <= S; i += blockDim.x) table[i] = table_g[i];
  __syncthreads();
  const float ox0 = origin_x[world], oy0 = origin_y[world];
  for (int p = 0; p < steps.n; ++p) {
    if (p > 0) cg::this_grid().sync();
    const bool closing = p + 1 == steps.n;
    int32_t* src = (p & 1) ? b : a;
    int32_t* dst = (p & 1) ? a : b;
    const int32_t* psrc = (p & 1) ? pb : pa;
    int32_t* pdst = (p & 1) ? pa : pb;
    const int k = steps.v[p];
    const int fo = steps.forms[p][0], fx = steps.forms[p][1], fy = steps.forms[p][2];
    const bool split_x = (steps.own[p] & kSplitXBit) != 0;
    if (steps.own[p] & kChainBit) {
      // a chain pass (never the closing one): every fold of a cell out of
      // line, both versions; a chain's first pass reads the carried planes
      // alone
      const long cells = (long)H * W;
      const size_t hw = (size_t)H * W;
      const bool start = p == 0 || !(steps.own[p - 1] & kChainBit);
      int32_t* ms = chain + 8 * hw;
      const int32_t* ssrc = ms + ((p & 1) ? hw : 0);
      int32_t* sdst = ms + ((p & 1) ? 0 : hw);
      const int32_t* spsrc = ms + 2 * hw + ((p & 1) ? hw : 0);
      int32_t* spdst = ms + 2 * hw + ((p & 1) ? 0 : hw);
      for (long c = (long)blk * blockDim.x + threadIdx.x; c < cells;
           c += (long)per_world * blockDim.x) {
        const int iy = (int)(c / W);
        const int x = (int)(c - (long)iy * W);
        const float cy[2] = {__fmaf_rn((float)iy, res, oy0),
                             __fadd_rn(__fmul_rn((float)iy, res), oy0)};
        chain_cell(src, dst, psrc, pdst, ssrc, sdst, spsrc, spdst, chain, table,
                   __fmaf_rn((float)x, res, ox0), cy, iy, x, H, W, S, k, steps.forms[p],
                   steps.own[p], start);
      }
    } else if (closing && out_x == nullptr)
      // the owner plane alone
      pass<false>(src, dst, psrc, pdst, table, ox0, oy0, H, W, S, res, k, fo, fx, fy, split_x,
                  true, nullptr, nullptr, blk, per_world);
    else
      pass<true>(src, dst, psrc, pdst, table, ox0, oy0, H, W, S, res, k, fo, fx, fy, split_x,
                 closing, out_x, out_y, blk, per_world);
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
// else in owner_b. pos_a, pos_b: i32 [worlds, H, W] scratch for the position
// words (null where n_steps is 1). table: f32 [worlds, S + 1, 2], row S of
// each = (1e9, 1e9). origin_x, origin_y: f32 [worlds] on the device. steps:
// n_steps (<= 32) pass offsets on the host, forms: their plane forms on the
// host, 5 a pass (Steps::forms), then the pass's own word (Steps::own).
// chain: i32 [worlds, kChainPlanes, H, W] for a chain's planes, or null
// where no pass is a chain pass. out_ox,
// out_oy: f32 [worlds, H, W] for the closing pass's positions, or both null
// (the closing pass then folds the owner plane alone). W % 4 == 0, S <= 65535. One cooperative launch for
// the group, or one for each chunk of worlds where the group has more worlds
// than co-resident blocks; *launches receives their number. An error where
// the card refuses a launch.
extern "C" int jfa_flood(void* owner_a, void* owner_b, void* pos_a, void* pos_b,
                         void* chain, const void* table, const void* origin_x,
                         const void* origin_y, const int* steps, const int* forms, int n_steps,
                         int worlds, int H, int W, int S, float res, void* out_ox, void* out_oy,
                         int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (n_steps < 0 || n_steps > kMaxSteps || worlds < 0 || H < 1 || W < 4 || (W & 3) != 0 ||
      S < 0 || S > kMaxSeeds || (out_ox == nullptr) != (out_oy == nullptr) ||
      (n_steps > 1 && (pos_a == nullptr || pos_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_steps == 0 || worlds == 0) return 0;
  Steps s;
  s.n = n_steps;
  for (int i = 0; i < n_steps; ++i) {
    if (steps[i] < 1) return (int)cudaErrorInvalidValue;
    s.v[i] = steps[i];
    for (int q = 0; q < kFolds; ++q) {
      const int f = forms[(kFolds + 1) * i + q];
      if (f < 0 || f >= (1 << 18)) return (int)cudaErrorInvalidValue;
      for (int m = 0; m < 9; ++m)
        if (((f >> (2 * m)) & 3) == 3) return (int)cudaErrorInvalidValue;
      s.forms[i][q] = f;
    }
    const int own = forms[(kFolds + 1) * i + kFolds];
    if (own & ~(kChainBit | kSplitXBit | 0x3ff)) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < kFolds; ++q)
      if (((own >> (2 * q)) & 3) == 3) return (int)cudaErrorInvalidValue;
    // a chain pass needs the triples' planes and is never the closing pass;
    // a plain pass folds from the carried planes alone
    if ((own & kChainBit) && (chain == nullptr || i + 1 == n_steps))
      return (int)cudaErrorInvalidValue;
    if (!(own & kChainBit) && (own & 0x3ff)) return (int)cudaErrorInvalidValue;
    if ((own & kChainBit) && (own & kSplitXBit)) return (int)cudaErrorInvalidValue;
    s.own[i] = own;
  }
  // a small table leaves room for many small blocks, which a small grid needs
  // to fill the card; a large one is staged by few large blocks
  const size_t smem = sizeof(float2) * ((size_t)S + 1);
  const int threads = smem > 8192 ? kMaxThreads : 256;
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
  // more for a world than its cells fill
  const long resident = (long)sms * per_sm;
  const long cells = (long)H * W;
  const int chunk = (int)min((long)worlds, resident);
  const int per_world = (int)max(1L, min(resident / chunk, (cells + threads - 1) / threads));
  const size_t plane = (size_t)H * W;
  for (int w0 = 0; w0 < worlds; w0 += chunk) {
    const int n = min(chunk, worlds - w0);
    int32_t* a = static_cast<int32_t*>(owner_a) + w0 * plane;
    int32_t* b = static_cast<int32_t*>(owner_b) + w0 * plane;
    int32_t* pa = pos_a != nullptr ? static_cast<int32_t*>(pos_a) + w0 * plane : nullptr;
    int32_t* pb = pos_b != nullptr ? static_cast<int32_t*>(pos_b) + w0 * plane : nullptr;
    int32_t* ch = chain != nullptr ? static_cast<int32_t*>(chain) + kChainPlanes * w0 * plane
                                   : nullptr;
    const float2* tab = static_cast<const float2*>(table) + (size_t)w0 * (S + 1);
    const float* gx = static_cast<const float*>(origin_x) + w0;
    const float* gy = static_cast<const float*>(origin_y) + w0;
    float* px = out_ox != nullptr ? static_cast<float*>(out_ox) + w0 * plane : nullptr;
    float* py = out_oy != nullptr ? static_cast<float*>(out_oy) + w0 * plane : nullptr;
    void* args[] = {(void*)&a,  (void*)&b,  (void*)&pa,  (void*)&pb, (void*)&ch,
                    (void*)&tab, (void*)&gx, (void*)&gy, (void*)&s,  (void*)&H,
                    (void*)&W,  (void*)&S,  (void*)&res, (void*)&px, (void*)&py,
                    (void*)&per_world};
    e = cudaLaunchCooperativeKernel((const void*)flood_kernel, dim3(n * per_world),
                                    dim3(threads), args, smem, st);
    if (e != cudaSuccess) return fail(e);
    ++*launches;
  }
  return (int)cudaGetLastError();
}
