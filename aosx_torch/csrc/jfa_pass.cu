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
// Design (for the H100; PERF.md section 6). A pass is bound by the
// instructions it issues for each (cell, candidate) and by the latency of
// its loads, not by bytes (the plane fits L2), so the design cuts both.
//   - Words. The flood reads the caller's i32 owner plane in its first pass
//     and writes plain i32 owners to a new plane in its closing pass; between
//     them the owner words live in a u16 ping-pong pair: the owner in bits
//     0-14 (S <= 32767) and, in bit 15, the flag of a cell whose position is
//     not its owner's seed. A position only ever holds a seed's coordinate (or
//     row S's 1e9), so it is carried as seed indices: a position word, the
//     x's seed in bits 0-15 and the y's in 16-31, stored (i32 ping-pong pair)
//     only for a flagged cell.
//   - Quads. A thread takes 4 consecutive cells of one row (W % 4 == 0), its
//     row and quad from a 32-bit tile index stepped without a division. Each
//     of the nine candidate rows of a quad is one 8-byte load (16 bytes from
//     the i32 plane) where the column offset is a multiple of 4, else two
//     aligned loads joined with a funnel shift. No branch: the loads are
//     predicated (aligned quads lie wholly inside or outside the grid) and the
//     join selects by the offset's residue, the same for every thread of a
//     pass, so all nine rows' loads of a quad are in flight together.
//   - The fast fold. A quad none of whose 36 candidate words is flagged has
//     every position at its owner's seed, so an owner names its triple. Its
//     four cells are folded side by side, candidate by candidate, with no
//     branch: (d2, owner) as one 64-bit key (d2 >= +0 in the high word), the
//     seed table read through its 32-bit shared address, each candidate's d2
//     in its one form: the hot pass is compiled for each owner-fold form word
//     of voronoi.ROUNDINGS ("xla", "pallas", "pallas_last"; a generic version
//     selects at run time: the first pass, and a table in device memory). The
//     staged table's row S is NaN, so a candidate without an owner never wins
//     and never lowers sec with no test. A neighbour carrying the own triple
//     is folded like any other (same d2 in the own's form: no change). A quad
//     whose nine rows hold no owner keeps none without a fold; a quad with a
//     flagged word is folded cell by cell in full (cell_general, out of line).
//   - Near ties. The owner plane's fold also keeps the least d2 of a triple
//     other than its winner (sec). The forms of one position's d2 differ by a
//     few ulps, so where no other triple comes within 2^-18 of the winner
//     every plane's fold takes the winner's triple; only at such a near tie
//     are the x and y planes folded in full (xy_folds, out of line, their
//     candidates read again).
//   - Launch. 256 threads a block, at most 128 registers a thread (two
//     blocks an SM), as many co-resident blocks as the occupancy calculator
//     allows for the table, persistent (a grid-stride loop over the quads),
//     so the table (8 (S + 1) bytes: 32 KB at S = 4096) is staged in shared
//     memory once a block; a table too large for it (S above 29,055 on the
//     H100) is read from device memory by a second kernel. One call runs
//     every pass of a flood: one cooperative launch with a grid barrier
//     between passes. The flood's last pass folds the owner plane alone
//     unless the caller asks for positions.
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
//     ping-pong pair (i32 words of the same layout) that the next chain pass
//     reads for the two neighbours in the cell's row. Each version carries
//     two more triples a cell, "a" and "b", which its folds may start from
//     instead of the cell's own carried triple, as an owner and a position
//     word each in planes of their own; a cell reads and writes only its
//     own, so they need no second copy. A chain pass folds each version's
//     five outputs (owner, x, y planes, a, b) in full, out of line
//     (chain_cell, a cell a thread): chains occur only on grids of at most
//     104 rows.
//   - Built with -fmad=false and written with __fsub_rn/__fmul_rn/__fmaf_rn so
//     that the compiler contracts nothing on its own: the cell coordinates and
//     every form of d2 round exactly as the plain version's (ops.fma where the
//     reference is fused, separate operations elsewhere), and all three planes
//     agree bit for bit at exact and near ties.
//
// Bound on the H100 (chip_smoke.py's k1_ops_by_pass). A flood must read the
// i32 owner plane once and write it once (8 B a cell) and read the table: the
// carried positions start as the owners' seeds and, like the u16 words, are
// the kernel's own state from pass to pass. Its arithmetic is H + W FP32 FMAs
// a pass for the coordinates and, for each distinct candidate (owner and
// position) among a cell's nine, 2 subtractions, the products and an FMA or
// add for each form the owner plane's fold asks, with a compare (the x and y
// planes' folds take its winner but at near ties): a few hundredths of a
// millisecond a flood at 2000 x 2048. The kernel folds every (cell,
// candidate), about 16 instructions each, where the bound counts each
// distinct candidate once, and each thread waits on its quad's loads from L2
// once a quad: a BENCH flood takes some 40 us a pass, 17 of them over a plane
// without owners (PERF.md section 6).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kMaxSteps = 32;
// threads a block, and the blocks an SM the registers must leave room for
// (65,536 / (256 x 2): at most 128 registers a thread; the generic kernel of
// a table in device memory, off every configuration's path, takes what it
// needs)
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
// an owner (a seed, or S for "none") takes 15 bits of a u16 owner word
constexpr int kMaxSeeds = 0x7fff;
constexpr uint32_t kOwner = 0x7fff;
// the owner word's flag of a cell whose position is not its owner's seed
constexpr uint32_t kPhantom = 0x8000;

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
// The owner-fold form words the hot pass is compiled for (voronoi.ROUNDINGS'
// "xla", "band" and "chain": xxxxxxxxx; "pallas": yyyxxxxxx; "pallas_last":
// uuuuxuxxx), and kFormsAny for a word read at run time.
constexpr int kFormsX = 0;
constexpr int kFormsPallas = 0x15;
constexpr int kFormsPallasLast = 0x8aa;
constexpr int kFormsAny = -1;
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

// A thread's tiles (quads, or a chain pass's cells): its first (row r, tile q
// of the row) and the step to its next (dr rows and dq tiles: the stride over
// the tiles split once, so that no tile index is divided in the loop).
struct Tiles {
  int r, q, dr, dq;
};

// An owner-word plane read one word at a time (out of line code): the
// caller's i32 plane, which the first pass reads, a chain's i32 "s" planes
// or the u16 scratch; every word is the owner in bits 0-14 and kPhantom.
struct Words {
  const void* p;
  bool wide;
  __device__ __forceinline__ uint32_t operator[](int i) const {
    return wide ? (uint32_t) static_cast<const int32_t*>(p)[i]
                : (uint32_t) static_cast<const uint16_t*>(p)[i];
  }
};

// A position word: the seed whose x the cell carries in bits 0-15, the seed
// whose y it carries in bits 16-31 (row S of the caller's table: no owner,
// (1e9, 1e9)).
__device__ __forceinline__ uint32_t pack(uint32_t ix, uint32_t iy) { return ix | (iy << 16); }

// The position word at index i of a position plane: out of line, as it is
// read only for the rare flagged cells, so that its index arithmetic holds no
// registers in the loop.
__device__ __noinline__ uint32_t stored_position(const int32_t* pos, int i) {
  return (uint32_t)pos[i];
}

// The position of the candidate at index i whose owner word is w: its
// owner's seed, or the stored word where the flag says it is not.
__device__ __forceinline__ uint32_t position(uint32_t w, const int32_t* pos, int i) {
  return (w & kPhantom) ? stored_position(pos, i) : pack(w & kOwner, w & kOwner);
}

// d2 of the offsets (dx, dy) in form c (Steps::forms): one form where c is
// a constant, else all three and a select (no branch)
__device__ __forceinline__ float d2_in(int c, float dx, float dy) {
  const float dx2 = __fmul_rn(dx, dx), dy2 = __fmul_rn(dy, dy);
  const float fx = __fmaf_rn(dx, dx, dy2), fy = __fmaf_rn(dy, dy, dx2), fu = __fadd_rn(dx2, dy2);
  return c == 0 ? fx : c == 1 ? fy : fu;
}

// A (d2, owner) pair as one key whose unsigned order is the folds'
// lexicographic order: d2 >= +0 (a sum of squares) in the high word, so its
// bits order as its value, the owner in the low word.
__device__ __forceinline__ unsigned long long key_of(float d, int o) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (uint32_t)o;
}

__device__ __forceinline__ float d2_of(unsigned long long k) {
  return __uint_as_float((uint32_t)(k >> 32));
}

// The seed table of the fast fold: staged in shared memory and read by its
// 32-bit shared address, kept in a register, or read from device memory.
// kNoneNaN: the staged copy's row S holds NaN, so that a candidate without an
// owner has d2 NaN, whose key orders above every other (it never wins) and
// which fminf passes over (it never lowers sec), with no test of its owner.
struct SharedTable {
  static constexpr bool kNoneNaN = true;
#ifdef __CUDA_ARCH__
  uint32_t base;
  __device__ __forceinline__ explicit SharedTable(const float2* t)
      : base((uint32_t)__cvta_generic_to_shared(t)) {}
  __device__ __forceinline__ float2 operator[](uint32_t i) const {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(base + 8 * i));
    return v;
  }
#else
  const float2* p;
  explicit SharedTable(const float2* t) : p(t) {}
  float2 operator[](uint32_t i) const { return p[i]; }
#endif
};

struct GlobalTable {
  static constexpr bool kNoneNaN = false;
  const float2* p;
  __device__ __forceinline__ explicit GlobalTable(const float2* t) : p(t) {}
  __device__ __forceinline__ float2 operator[](uint32_t i) const { return p[i]; }
};

// d2 of the position p from the cell (cx, cy) in the three forms
struct D2 {
  float f[3];
};

__device__ __forceinline__ D2 dist2_forms(uint32_t p, const float2* __restrict__ table, float cx,
                                          float cy) {
  const float dx = __fsub_rn(table[p & 0xffff].x, cx);
  const float dy = __fsub_rn(table[p >> 16].y, cy);
  return D2{{d2_in(0, dx, dy), d2_in(1, dx, dy), d2_in(2, dx, dy)}};
}

// d2 in the form of candidate m of a plane's forms (selects, no indexing,
// so that D2 stays in registers)
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

// The x and y planes' folds of the cell (y, x) in the forms fx, fy, each a
// lexicographic (d2, owner) min over the cell's own triple and its 8
// neighbours, read again from src: the position word that takes the x plane
// winner's x and the y plane winner's y. Out of line, for the rare cells
// where the owner plane's fold finds a near tie.
__device__ __noinline__ uint32_t xy_folds(Words src, const int32_t* pos_src,
                                          const float2* __restrict__ table, float cx, float cy,
                                          int y, int x, int H, int W, int S, int step, int fx,
                                          int fy) {
  const uint32_t w0 = src[y * W + x];
  const int own = w0 & kOwner;
  const uint32_t ownp = position(w0, pos_src, y * W + x);
  const D2 od = own < S ? dist2_forms(ownp, table, cx, cy) : D2{{kInf, kInf, kInf}};
  Best b1{own, ownp, in_form(od, fx, 0)};
  Best b2{own, ownp, in_form(od, fy, 0)};
  int m = 1;
  for (int dys = -1; dys <= 1; ++dys) {
    for (int dxs = -1; dxs <= 1; ++dxs) {
      if (dys == 0 && dxs == 0) continue;
      const int ny = y - dys * step, nx = x - dxs * step;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
        const uint32_t w = src[ny * W + nx];
        const int o = w & kOwner;
        if (o < S) {
          const uint32_t p = position(w, pos_src, ny * W + nx);
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
__device__ __noinline__ void chain_cell(Words src, uint16_t* dst, const int32_t* pos_src,
                                        int32_t* pos_dst, Words ssrc, int32_t* sdst,
                                        const int32_t* spos_src, int32_t* spos_dst, int32_t* tri,
                                        const float2* __restrict__ table, float cx, const float* cy,
                                        int iy, int x, int H, int W, int S, int step,
                                        const int* forms, int own, bool start) {
  const int c = iy * W + x;
  const size_t hw = (size_t)H * W;
  const uint32_t w0 = src[c];
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
        const uint32_t w = (row ? ssrc : src)[ny * W + nx];
        no[m] = w & kOwner;
        if (no[m] < S) np[m] = position(w, row ? spos_src : pos_src, ny * W + nx);
      }
      ++m;
    }
  }
  for (int v = 0; v < 2; ++v) {
    int32_t* t = tri + 4 * v * hw;
    int oo[3] = {(int)(w0 & kOwner), t[c], t[2 * hw + c]};
    uint32_t pp[3] = {position(w0, pos_src, c), (uint32_t)t[hw + c], (uint32_t)t[3 * hw + c]};
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
    const uint32_t word = r[0].o | (rp != pack(r[0].o, r[0].o) ? kPhantom : 0u);
    if (word & kPhantom) (v ? spos_dst : pos_dst)[c] = (int)rp;
    if (v)
      sdst[c] = (int)word;
    else
      dst[c] = (uint16_t)word;
    t[c] = r[3].o;
    t[hw + c] = (int)r[3].p;
    t[2 * hw + c] = r[4].o;
    t[3 * hw + c] = (int)r[4].p;
  }
}

// One cell's fold in full, as a pass with the owner forms fo folds it
// (Steps::forms), its 9 candidates' words read from src and, where flagged,
// their position words from pos_src: the owner plane's winner, and the
// position word the x and y planes carry (the winner's, or at a near tie
// xy_folds'; the winner's alone without with_pos). Out of line, for the rare
// quads whose words carry a flag.
struct Cell {
  int o;
  uint32_t p;
};

__device__ __noinline__ Cell cell_general(Words src, const int32_t* pos_src,
                                          const float2* __restrict__ table, float cx, float cy,
                                          int y, int x, int H, int W, int S, int step, int fo,
                                          int fx, int fy, bool with_pos) {
  const uint32_t w0 = src[y * W + x];
  const int own = w0 & kOwner;
  const uint32_t ownp = position(w0, pos_src, y * W + x);
  Best b0{own, ownp, own < S ? in_form(dist2_forms(ownp, table, cx, cy), fo, 0) : kInf};
  float sec = kInf;
  int m = 1;
  for (int dys = -1; dys <= 1; ++dys) {
    for (int dxs = -1; dxs <= 1; ++dxs) {
      if (dys == 0 && dxs == 0) continue;
      const int ny = y - dys * step, nx = x - dxs * step;
      const uint32_t w = ny >= 0 && ny < H && nx >= 0 && nx < W ? src[ny * W + nx] : (uint32_t)S;
      const int o = w & kOwner;
      if (o < S) {
        const uint32_t p = position(w, pos_src, ny * W + nx);
        // a neighbour carrying the cell's own triple where the fold asks
        // the own's form of it has the own's d2: it changes nothing
        if (!(o == own && p == ownp && ((fo >> (2 * m)) & 3) == (fo & 3))) {
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
  if (with_pos && b0.o < S && !(sec > __fmul_rn(b0.d, 1.0f + 0x1p-18f)))
    rp = xy_folds(src, pos_src, table, cx, cy, y, x, H, W, S, step, fx, fy);
  return Cell{b0.o, rp};
}

// The words of the 4 cells at the aligned column a of a row, two to a 32-bit
// register: one 8-byte load of the u16 plane, or one 16-byte load of the
// caller's i32 plane (owners below 2^15, no flags) packed.
__device__ __forceinline__ uint2 load_quad(const uint16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint2 load_quad(const int32_t* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  return make_uint2((uint32_t)v.x | ((uint32_t)v.y << 16), (uint32_t)v.z | ((uint32_t)v.w << 16));
}

// The words of the cells at columns c .. c + 3 of row ny (the word `none`
// outside the grid): the aligned quad where c % 4 == 0, else the two aligned
// quads around them joined by a funnel shift. No branch: the loads are
// predicated and the join selects by c % 4 (the same for every thread of a
// pass), so that the loads of all nine rows of a quad are in flight together.
template <class Src>
__device__ __forceinline__ uint2 quad_row(const Src* src, int ny, int c, int H, int W,
                                          uint32_t none) {
  const bool in_rows = ny >= 0 && ny < H;
  const Src* row = src + (in_rows ? ny : 0) * W;
  const int a = c & ~3, s = c & 3;
  uint2 lo = make_uint2(none, none), hi = lo;
  if (in_rows && a >= 0 && a < W) lo = load_quad(row + a);
  if (in_rows && s != 0 && a >= -4 && a + 4 < W) hi = load_quad(row + a + 4);
  const bool half = s >= 2;
  const uint32_t shift = (s & 1) * 16;
  const uint32_t w0 = half ? lo.y : lo.x, w1 = half ? hi.x : lo.y, w2 = half ? hi.y : hi.x;
  return make_uint2(__funnelshift_r(w0, w1, shift), __funnelshift_r(w1, w2, shift));
}

// The nine candidate rows of the quad at (iy, x0) in jacobi_fold's order,
// the own row first.
template <class Src>
__device__ __forceinline__ void load_rows(uint2 (&nb)[9], const Src* src, int iy, int x0,
                                          int step, int H, int W, uint32_t none) {
  nb[0] = load_quad(src + iy * W + x0);
  int n = 1;
#pragma unroll
  for (int dys = -1; dys <= 1; ++dys)
#pragma unroll
    for (int dxs = -1; dxs <= 1; ++dxs)
      if (dys != 0 || dxs != 0)
        nb[n++] = quad_row(src, iy - dys * step, x0 - dxs * step, H, W, none);
}

// The word of cell j (0..3) of a candidate row
__device__ __forceinline__ uint32_t word_of(uint2 v, int j) {
  return ((j < 2 ? v.x : v.y) >> (16 * (j & 1))) & 0xffffu;
}

// One pass at offset `step` over the quads of this thread's tiles: the owner
// words src -> dst (u16), or plain owners to out in the closing pass. The
// owner plane's fold in the forms kForms (kFormsAny: the word fo_any); kPos:
// carry the x and y planes too (the owner fold's winner's position, or at a
// near tie xy_folds'), as flagged words and position words (pos_dst) or, in
// the closing pass, as coordinates to out_x/out_y; without kPos only the
// owner plane is folded (a flood's last pass without positions).
//
// A quad none of whose candidate words is flagged takes the fast fold, in
// which every candidate's position is its owner's seed, so that the owner
// names the triple: the four cells' folds side by side, candidate by
// candidate, without a branch, (d2, owner) compared as one key. A neighbour
// carrying the own triple is folded like any other (its d2 in the own's form
// is the own's: no change), a candidate without an owner takes d2 = NaN from
// the staged table (Table::kNoneNaN) or 3.4e38: it never wins and never
// lowers sec. A quad whose nine rows hold no owner keeps none; a quad with a
// flagged word goes through cell_general. table_g: the caller's table, whose
// row S the closing pass writes as none's position.
template <class Src, class Table, bool kPos, int kForms>
__device__ __forceinline__ void pass(const Src* src, uint16_t* dst, int32_t* out,
                                     const int32_t* pos_src, int32_t* pos_dst, Table tab,
                                     const float2* __restrict__ table,
                                     const float2* __restrict__ table_g, float ox0, float oy0,
                                     int H, int W, int S, float res, int step, int fo_any, int fx,
                                     int fy,
                                     bool split_x, bool closing, float* __restrict__ out_x,
                                     float* __restrict__ out_y, Tiles t) {
  const int fo = kForms == kFormsAny ? fo_any : kForms;
  const int c0 = fo & 3;
  const uint32_t none = pack(S, S);
  const Words words{src, sizeof(Src) == 4};
  const int quads = W >> 2;
  for (int iy = t.r, q = t.q; iy < H;) {
    const int x0 = 4 * q;
    uint2 cur[9];
    load_rows(cur, src, iy, x0, step, H, W, none);
    const float cy = __fmaf_rn((float)iy, res, oy0);
    float cx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + j;
      cx[j] = split_x ? __fadd_rn(__fmul_rn((float)x, res), ox0) : __fmaf_rn((float)x, res, ox0);
    }
    uint32_t flags = 0, owned = 0;
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      flags |= cur[m].x | cur[m].y;
      owned |= (cur[m].x ^ none) | (cur[m].y ^ none);
    }
    int owners[4];
    uint32_t rps[4];
    if (flags & (kPhantom * 0x10001u)) {
      for (int j = 0; j < 4; ++j) {
        const Cell r = cell_general(words, pos_src, table, cx[j], cy, iy, x0 + j, H, W, S, step,
                                    fo, fx, fy, kPos);
        owners[j] = r.o;
        rps[j] = r.p;
      }
    } else if (owned == 0) {
      // no owner in any candidate: every cell keeps none
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        owners[j] = S;
        rps[j] = none;
      }
    } else {
      // the fast fold; sec: the least d2 of a triple other than the held
      // one. Where no other triple comes within 2^-18 of the winner's d2,
      // no form can reorder them (the forms of one position lie within a
      // few ulps of each other), so the x and y planes' folds take the
      // winner's triple too; else they are folded in full (xy_folds)
      unsigned long long best[4];
      float sec[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int own = word_of(cur[0], j);
        const float2 s = tab[own];
        const float d = d2_in(c0, __fsub_rn(s.x, cx[j]), __fsub_rn(s.y, cy));
        best[j] = key_of(own < S ? d : kInf, own);
        sec[j] = kInf;
      }
#pragma unroll
      for (int m = 1; m < 9; ++m) {
        const int c = (fo >> (2 * m)) & 3;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = word_of(cur[m], j);
          const float2 s = tab[o];
          float d = d2_in(c, __fsub_rn(s.x, cx[j]), __fsub_rn(s.y, cy));
          if (!Table::kNoneNaN) d = o < S ? d : kInf;
          const unsigned long long k = key_of(d, o);
          const bool better = k < best[j];
          if (kPos) {
            const bool held = o == (int)(uint32_t)best[j];
            const float lost = fminf(sec[j], better ? d2_of(best[j]) : d);
            sec[j] = held ? sec[j] : lost;
          }
          best[j] = better ? k : best[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bo = (int)(uint32_t)best[j];
        uint32_t rp = pack(bo, bo);
        if (kPos && bo < S && !(sec[j] > __fmul_rn(d2_of(best[j]), 1.0f + 0x1p-18f)))
          rp = xy_folds(words, pos_src, table, cx[j], cy, iy, x0 + j, H, W, S, step, fx, fy);
        owners[j] = bo;
        rps[j] = rp;
      }
    }
    const int i0 = iy * W + x0;
    if (closing) {
      *reinterpret_cast<int4*>(out + i0) = make_int4(owners[0], owners[1], owners[2], owners[3]);
      if (kPos) {
        float px[4], py[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          px[j] = table_g[rps[j] & 0xffff].x;
          py[j] = table_g[rps[j] >> 16].y;
        }
        *reinterpret_cast<float4*>(out_x + i0) = make_float4(px[0], px[1], px[2], px[3]);
        *reinterpret_cast<float4*>(out_y + i0) = make_float4(py[0], py[1], py[2], py[3]);
      }
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool flag = kPos && rps[j] != pack(owners[j], owners[j]);
        if (flag) pos_dst[i0 + j] = (int)rps[j];
        w[j] = (uint32_t)owners[j] | (flag ? kPhantom : 0u);
      }
      *reinterpret_cast<uint2*>(dst + i0) = make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
    }
    // the next tile
    q += t.dq;
    iy += t.dr;
    if (q >= quads) {
      q -= quads;
      ++iy;
    }
  }
}

// A pass that is not a chain pass, through the version of `pass` compiled
// for its source's type, kPos and its owner-fold forms (kShared: the table
// lies in shared memory; a table in device memory, and the first pass, from
// the caller's i32 plane, take the generic forms).
template <bool kShared, class Src, bool kPos>
__device__ __forceinline__ void dispatch(const Src* src, uint16_t* dst, int32_t* out,
                                         const int32_t* pos_src, int32_t* pos_dst,
                                         const float2* __restrict__ table,
                                         const float2* __restrict__ table_g, float ox0, float oy0,
                                         int H, int W, int S, float res, int step, int fo, int fx,
                                         int fy, bool split_x, bool closing, float* out_x,
                                         float* out_y, Tiles t) {
  using Table = std::conditional_t<kShared, SharedTable, GlobalTable>;
#define K1_PASS(F)                                                                              \
  pass<Src, Table, kPos, F>(src, dst, out, pos_src, pos_dst, Table(table), table, table_g, ox0, \
                            oy0, H, W, S, res, step, fo, fx, fy, split_x, closing, out_x, out_y, t)
  if constexpr (!kShared || sizeof(Src) == 4) {
    K1_PASS(kFormsAny);
  } else {
    if (fo == kFormsX)
      K1_PASS(kFormsX);
    else if (fo == kFormsPallas)
      K1_PASS(kFormsPallas);
    else if (fo == kFormsPallasLast)
      K1_PASS(kFormsPallasLast);
    else
      K1_PASS(kFormsAny);
  }
#undef K1_PASS
}

// Every pass of `steps`: pass 0 reads the caller's owner planes in_all (i32),
// pass p > 0 the u16 words of pass p - 1 (ua_all, ub_all: pass p writes
// ua_all where p is even, else ub_all), and the closing pass writes plain
// owners to out_all; position words likewise (pa_all, pb_all), with a grid
// barrier between passes: a cooperative launch. Block k works on world
// k / per_world of the launch, as its (k % per_world)-th block. kShared: the
// world's table staged in shared memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, kShared ? kMinBlocks : 1)
flood_kernel(const int32_t* in_all, int32_t* out_all, uint16_t* ua_all, uint16_t* ub_all,
             int32_t* pa_all, int32_t* pb_all, int32_t* chain_all,
             const float2* __restrict__ table_all, const float* __restrict__ origin_x,
             const float* __restrict__ origin_y, const __grid_constant__ Steps steps, int H,
             int W, int S, float res, float* out_x_all, float* out_y_all, int per_world) {
  extern __shared__ float2 table_s[];
  const int world = blockIdx.x / per_world;
  const int blk = blockIdx.x - world * per_world;
  const size_t plane = (size_t)world * H * W;
  const float2* __restrict__ table_g = table_all + (size_t)world * (S + 1);
  const int32_t* in = in_all + plane;
  int32_t* out = out_all + plane;
  uint16_t* ua = ua_all != nullptr ? ua_all + plane : nullptr;
  uint16_t* ub = ub_all != nullptr ? ub_all + plane : nullptr;
  int32_t* pa = pa_all != nullptr ? pa_all + plane : nullptr;
  int32_t* pb = pb_all != nullptr ? pb_all + plane : nullptr;
  float* out_x = out_x_all != nullptr ? out_x_all + plane : nullptr;
  float* out_y = out_y_all != nullptr ? out_y_all + plane : nullptr;
  // a chain's planes (kChainPlanes a world): the triples a and b of "p" and
  // of "s" (an owner and a position plane each), then the "s" owner words'
  // and position words' ping-pong pairs
  int32_t* chain = chain_all != nullptr ? chain_all + kChainPlanes * plane : nullptr;
  const float2* __restrict__ table = kShared ? table_s : table_g;
  if (kShared) {
    // row S (none) as NaN: SharedTable::kNoneNaN
    for (int i = threadIdx.x; i <= S; i += blockDim.x)
      table_s[i] = i < S ? table_g[i] : make_float2(__int_as_float(0x7fffffff),
                                                    __int_as_float(0x7fffffff));
    __syncthreads();
  }
  const float ox0 = origin_x[world], oy0 = origin_y[world];
  // this thread's tiles: quad t of the plane is row t / quads, quad t % quads;
  // a chain pass walks cells (cell t: row t / W, column t % W)
  const int quads = W >> 2;
  const int first = blk * blockDim.x + threadIdx.x, stride = per_world * blockDim.x;
  const Tiles tiles{first / quads, first % quads, stride / quads, stride % quads};
  const Tiles cells{first / W, first % W, stride / W, stride % W};
  for (int p = 0; p < steps.n; ++p) {
    if (p > 0) cg::this_grid().sync();
    const bool closing = p + 1 == steps.n;
    const uint16_t* usrc = (p & 1) ? ua : ub;
    uint16_t* udst = (p & 1) ? ub : ua;
    const int32_t* psrc = (p & 1) ? pa : pb;
    int32_t* pdst = (p & 1) ? pb : pa;
    const int k = steps.v[p];
    const int fo = steps.forms[p][0], fx = steps.forms[p][1], fy = steps.forms[p][2];
    const bool split_x = (steps.own[p] & kSplitXBit) != 0;
    // with positions: every pass but a closing one that folds the owner
    // plane alone
    const bool pos = !closing || out_x != nullptr;
    if (steps.own[p] & kChainBit) {
      // a chain pass (never the closing one): every fold of a cell out of
      // line, both versions; a chain's first pass reads the carried planes
      // alone
      const size_t hw = (size_t)H * W;
      const bool start = p == 0 || !(steps.own[p - 1] & kChainBit);
      int32_t* ms = chain + 8 * hw;
      const Words src = p == 0 ? Words{in, true} : Words{usrc, false};
      const Words ssrc{ms + ((p & 1) ? hw : 0), true};
      int32_t* sdst = ms + ((p & 1) ? 0 : hw);
      const int32_t* spsrc = ms + 2 * hw + ((p & 1) ? hw : 0);
      int32_t* spdst = ms + 2 * hw + ((p & 1) ? 0 : hw);
      for (int iy = cells.r, x = cells.q; iy < H;) {
        const float cy[2] = {__fmaf_rn((float)iy, res, oy0),
                             __fadd_rn(__fmul_rn((float)iy, res), oy0)};
        chain_cell(src, udst, psrc, pdst, ssrc, sdst, spsrc, spdst, chain, table,
                   __fmaf_rn((float)x, res, ox0), cy, iy, x, H, W, S, k, steps.forms[p],
                   steps.own[p], start);
        x += cells.dq;
        iy += cells.dr;
        if (x >= W) {
          x -= W;
          ++iy;
        }
      }
    } else if (p == 0) {
      if (pos)
        dispatch<kShared, int32_t, true>(in, udst, out, psrc, pdst, table, table_g, ox0, oy0, H, W,
                                         S, res, k, fo, fx, fy, split_x, closing, out_x, out_y,
                                         tiles);
      else
        dispatch<kShared, int32_t, false>(in, udst, out, psrc, pdst, table, table_g, ox0, oy0, H, W,
                                          S, res, k, fo, fx, fy, split_x, closing, out_x, out_y,
                                          tiles);
    } else if (pos) {
      dispatch<kShared, uint16_t, true>(usrc, udst, out, psrc, pdst, table, table_g, ox0, oy0, H, W,
                                        S, res, k, fo, fx, fy, split_x, closing, out_x, out_y,
                                        tiles);
    } else {
      dispatch<kShared, uint16_t, false>(usrc, udst, out, psrc, pdst, table, table_g, ox0, oy0, H,
                                         W, S, res, k, fo, fx, fy, split_x, closing, out_x, out_y,
                                         tiles);
    }
  }
}

// An error code for the caller, with the runtime's last-error state cleared so
// that the next launch's cudaGetLastError() does not report it again.
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// The launch a flood with S seeds takes on the current device: the kernel
// (the table in shared memory where the card's opt-in limit holds it, else in
// device memory), its dynamic shared memory, the SMs and the co-resident
// blocks an SM. Kept for the last (device, S) of the calling thread, so that
// a flood costs the host one launch and no queries.
struct Launch {
  int dev = -1, S = -1;
  const void* kernel = nullptr;
  size_t smem = 0;
  int sms = 0, per_sm = 0;
};

cudaError_t launch_for(int S, Launch* out) {
  thread_local Launch last;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (last.dev == dev && last.S == S) {
    *out = last;
    return cudaSuccess;
  }
  Launch l;
  l.dev = dev;
  l.S = S;
  int optin = 0;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (e = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const size_t table = sizeof(float2) * ((size_t)S + 1);
  const bool shared = table <= (size_t)optin;
  l.kernel = shared ? (const void*)flood_kernel<true> : (const void*)flood_kernel<false>;
  l.smem = shared ? table : 0;
  // the kernel may take up to the opt-in limit, whichever table a launch stages
  if (shared && table > 48 * 1024 &&
      (e = cudaFuncSetAttribute(flood_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, l.kernel, kThreads,
                                                         l.smem)) != cudaSuccess)
    return e;
  last = l;
  *out = l;
  return cudaSuccess;
}

}  // namespace

// The launch a flood with S seeds gets: threads a block, co-resident blocks
// an SM, the kernel's registers a thread and local (spill) bytes a thread,
// and whether the table is staged in shared memory (1) or read from device
// memory (0). An error where the card refuses.
extern "C" int jfa_flood_config(int S, int* threads, int* blocks_per_sm, int* registers,
                                int* local_bytes, int* shared_table) {
  if (S < 0 || S > kMaxSeeds) return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = launch_for(S, &l);
  if (e != cudaSuccess) return fail(e);
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, l.kernel)) != cudaSuccess) return fail(e);
  *threads = kThreads;
  *blocks_per_sm = l.per_sm;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_table = l.smem > 0;
  return 0;
}

// owner: the flood's initial owner planes i32 [worlds, H, W], owners in
// 0..S, read only. out: i32 [worlds, H, W], the flood's owner planes.
// words_a, words_b: u16 [worlds, H, W] scratch for the owner words between
// passes, pos_a, pos_b: i32 [worlds, H, W] scratch for the position words
// (all four null where n_steps is 1). table: f32 [worlds, S + 1, 2], row S of
// each = (1e9, 1e9). origin_x, origin_y: f32 [worlds] on the device. steps:
// n_steps (<= 32) pass offsets on the host, forms: their plane forms on the
// host, 5 a pass (Steps::forms), then the pass's own word (Steps::own).
// chain: i32 [worlds, kChainPlanes, H, W] for a chain's planes, or null
// where no pass is a chain pass. out_ox, out_oy: f32 [worlds, H, W] for the
// closing pass's positions, or both null (the closing pass then folds the
// owner plane alone). W % 4 == 0, H * W < 2^31, S <= 32767, owner, out and
// the position planes 16-byte aligned. One cooperative launch for the group,
// or one for each chunk of worlds where the group has more worlds than
// co-resident blocks; *launches receives their number. An error where the
// arguments are out of range or the card refuses a launch.
extern "C" int jfa_flood(const void* owner, void* out, void* words_a, void* words_b, void* pos_a,
                         void* pos_b, void* chain, const void* table, const void* origin_x,
                         const void* origin_y, const int* steps, const int* forms, int n_steps,
                         int worlds, int H, int W, int S, float res, void* out_ox, void* out_oy,
                         int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (n_steps < 0 || n_steps > kMaxSteps || worlds < 0 || H < 1 || W < 4 || (W & 3) != 0 ||
      (long long)H * W >= (1LL << 31) || S < 0 || S > kMaxSeeds ||
      (out_ox == nullptr) != (out_oy == nullptr) ||
      (n_steps > 1 && (words_a == nullptr || words_b == nullptr || pos_a == nullptr ||
                       pos_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_steps == 0 || worlds == 0) return 0;
  Steps s;
  s.n = n_steps;
  for (int i = 0; i < n_steps; ++i) {
    if (steps[i] < 1 || steps[i] > (1 << 30)) return (int)cudaErrorInvalidValue;
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
  Launch l;
  cudaError_t e = launch_for(S, &l);
  if (e != cudaSuccess) return fail(e);
  if (l.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the co-resident blocks shared evenly among the worlds of a launch, and no
  // more for a world than its quads fill (its cells, where a chain pass takes
  // a cell a thread)
  bool chained = false;
  for (int i = 0; i < n_steps; ++i) chained |= (s.own[i] & kChainBit) != 0;
  const long resident = (long)l.sms * l.per_sm;
  const long work = chained ? (long)H * W : (long)H * W / 4;
  const int chunk = (int)min((long)worlds, resident);
  const int per_world = (int)max(1L, min(resident / chunk, (work + kThreads - 1) / kThreads));
  const size_t plane = (size_t)H * W;
  for (int w0 = 0; w0 < worlds; w0 += chunk) {
    const int n = min(chunk, worlds - w0);
    const int32_t* in = static_cast<const int32_t*>(owner) + w0 * plane;
    int32_t* o = static_cast<int32_t*>(out) + w0 * plane;
    uint16_t* ua = words_a != nullptr ? static_cast<uint16_t*>(words_a) + w0 * plane : nullptr;
    uint16_t* ub = words_b != nullptr ? static_cast<uint16_t*>(words_b) + w0 * plane : nullptr;
    int32_t* pa = pos_a != nullptr ? static_cast<int32_t*>(pos_a) + w0 * plane : nullptr;
    int32_t* pb = pos_b != nullptr ? static_cast<int32_t*>(pos_b) + w0 * plane : nullptr;
    int32_t* ch = chain != nullptr ? static_cast<int32_t*>(chain) + kChainPlanes * w0 * plane
                                   : nullptr;
    const float2* tab = static_cast<const float2*>(table) + (size_t)w0 * (S + 1);
    const float* gx = static_cast<const float*>(origin_x) + w0;
    const float* gy = static_cast<const float*>(origin_y) + w0;
    float* px = out_ox != nullptr ? static_cast<float*>(out_ox) + w0 * plane : nullptr;
    float* py = out_oy != nullptr ? static_cast<float*>(out_oy) + w0 * plane : nullptr;
    void* args[] = {(void*)&in,  (void*)&o,  (void*)&ua, (void*)&ub,  (void*)&pa,
                    (void*)&pb,  (void*)&ch, (void*)&tab, (void*)&gx, (void*)&gy,
                    (void*)&s,   (void*)&H,  (void*)&W,  (void*)&S,   (void*)&res,
                    (void*)&px,  (void*)&py, (void*)&per_world};
    e = cudaLaunchCooperativeKernel(l.kernel, dim3(n * per_world), dim3(kThreads), args, l.smem,
                                    st);
    if (e != cudaSuccess) return fail(e);
    ++*launches;
  }
  return (int)cudaGetLastError();
}
