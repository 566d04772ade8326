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
//   steps x (one load-to-use latency + the xor, multiply-add and mask between
//   two loads) at the SM clock; bytes and operation rates are nowhere near.
//   No memory that holds P1's 65,536 entries answers sooner than shared
//   memory, the counterpart of the TPU kernel's SMEM.
//   The load-to-use latency is measured on the card by smem_latency_kernel,
//   a chase with nothing but the loads on the chain.
//  P3: the shared-memory banks and the integer pipe. 512 x 2048 x 64 gathers
//   of 4 bytes against 32 banks x 4 bytes a clock an SM; the 12 MB of global
//   traffic (x, idx in, out) take 4 us.
//
// Design.
//  P1 (chase_rw_smem_kernel, n <= 65,536): the table lives in dynamic shared
//   memory as u16 (every value is a value the table started with, below n),
//   128 KB at n = 65,536, where an i32 table (256 KB) would not fit the
//   227 KB a block can have. All threads of the block write the iota with
//   16-byte stores, one thread runs the chain, and all threads copy the table
//   out widened to i32 with 16-byte stores. The chain issues step i+1's load
//   before step i's store, so that the store never queues ahead of a load in
//   the shared-memory pipe. When
//   step i+1 reads the entry step i writes, its load saw the old value; the
//   mask m (all ones then, else zero), known before the load returns, folds
//   the forward into the xor that step i+1 needs anyway:
//   c = (loaded & ~m) ^ ((v & m) ^ (i+1)), one logic operation on the chain.
//   The chain is then a shared load, that operation, a multiply-add and a
//   mask (the byte offset is (c * 2A + 2C) & 2(n-1)): about 40 clocks a step
//   on the H100. The loop is unrolled.
//   chase_rw_kernel keeps the table in global memory (n > 65,536, and the
//   timed global form): a union-find's parent array over more cells than
//   shared memory holds lives there, and its loads behave like L2 hits
//   because every step also stores.
//  P2: one thread of one block, a 16 KB static shared table.
//  P3: one block of 512 threads a row. x and idx come in with 16-byte loads (a
//   thread owns columns 4q..4q+3, q its index), x is staged in shared memory
//   through the layout a -> a ^ (a >> 6): in the identity layout addresses
//   that differ by a multiple of 32 words fall into one bank, so an index
//   pattern with a power-of-two stride (64, 128, ... 1024 words) serialises a
//   warp's load; the xor folds address bits 6-10 into the bank bits, which
//   spreads those strides over distinct banks and keeps each aligned group of
//   32 words in 32 banks. Each thread carries t = idx + acc (wrapping) for its
//   4 columns: a round is t += xs[layout(t & 2047)], so the index add and the
//   accumulate are one add, and acc = t - idx at the end; a gather is then a
//   shift, a mask, the layout's shift and xor (byte offsets, p3_offset), the
//   shared load and the add. The chains are independent, so no barrier
//   follows the staging one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned LCG_A = 1103515245u;
constexpr unsigned LCG_C = 12345u;

constexpr int P1_THREADS = 1024;

constexpr int P2_N = 4096;

constexpr int P3_COLS = 2048;
constexpr int P3_THREADS = P3_COLS / 4;  // a thread owns 4 columns

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

__device__ __forceinline__ unsigned load_u16(const unsigned char* base, unsigned byte) {
  return *reinterpret_cast<const uint16_t*>(base + byte);
}

__device__ __forceinline__ void store_u16(unsigned char* base, unsigned byte, unsigned v) {
  *reinterpret_cast<uint16_t*>(base + byte) = (uint16_t)v;
}

// The chain of P1 over a u16 table at `tab` (byte offsets), load ahead of
// store. Returns the final c.
__device__ unsigned chase_smem_chain(unsigned char* tab, unsigned n, int steps, unsigned c) {
  if (steps <= 0) return c;
  const unsigned a2 = 2u * LCG_A, c2 = 2u * LCG_C, mask2 = 2u * (n - 1u);
  // step 0: its load, nothing pending before it (m = 0, w = 0 ^ 0)
  unsigned jb = (c * a2 + c2) & mask2;
  unsigned vl = load_u16(tab, jb);
  unsigned m = 0u, w = 0u;
  int i = 0;
#pragma unroll 8
  for (; i < steps - 1; ++i) {
    // c_i = v_i ^ i, forwarded where m: (vl & ~m) ^ w as ONE lop3 (0x9A).
    // Written in C, the compiler splits w back into v & m and i + 1 and puts
    // two logic operations on the chain (46 clocks a step, not 40)
    asm("lop3.b32 %0, %1, %2, %3, 0x9A;" : "=r"(c) : "r"(vl), "r"(m), "r"(w));
    const unsigned v = c ^ (unsigned)i;     // v_i
    const unsigned sb = (jb + 2u) & mask2;  // step i stores v_i here
    jb = (c * a2 + c2) & mask2;             // step i+1's address
    vl = load_u16(tab, jb);                 // issued before step i's store
    store_u16(tab, sb, v);
    m = jb == sb ? ~0u : 0u;
    w = (v & m) ^ (unsigned)(i + 1);
  }
  c = (vl & ~m) ^ w;
  store_u16(tab, (jb + 2u) & mask2, c ^ (unsigned)i);
  return c;
}

__global__ void __launch_bounds__(P1_THREADS)
chase_rw_smem_kernel(int32_t* __restrict__ table, int32_t* __restrict__ out, int n, int steps,
                     const int32_t* __restrict__ seed) {
  extern __shared__ __align__(16) unsigned char tab_s[];
  const int tid = threadIdx.x;
  const unsigned c0 = tid == 0 ? (unsigned)seed[0] : 0u;
  // iota, eight u16 entries a 16-byte store
  const int n8 = n >> 3;
  uint4* tab8 = reinterpret_cast<uint4*>(tab_s);
  for (int k = tid; k < n8; k += P1_THREADS) {
    const unsigned e = 8u * (unsigned)k;
    tab8[k] = make_uint4(e | (e + 1u) << 16, (e + 2u) | (e + 3u) << 16,
                         (e + 4u) | (e + 5u) << 16, (e + 6u) | (e + 7u) << 16);
  }
  uint16_t* tab16 = reinterpret_cast<uint16_t*>(tab_s);
  for (int i = 8 * n8 + tid; i < n; i += P1_THREADS) tab16[i] = (uint16_t)i;
  __syncthreads();
  if (tid == 0) out[0] = (int32_t)chase_smem_chain(tab_s, (unsigned)n, steps, c0);
  __syncthreads();
  // the table out, widened to i32: eight entries in, two 16-byte stores out
  int4* table4 = reinterpret_cast<int4*>(table);
  for (int k = tid; k < n8; k += P1_THREADS) {
    const uint4 w = tab8[k];
    table4[2 * k] = make_int4(w.x & 0xFFFF, w.x >> 16, w.y & 0xFFFF, w.y >> 16);
    table4[2 * k + 1] = make_int4(w.z & 0xFFFF, w.z >> 16, w.w & 0xFFFF, w.w >> 16);
  }
  for (int i = 8 * n8 + tid; i < n; i += P1_THREADS) table[i] = tab16[i];
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

// The load-to-use latency of shared memory in SM clocks: one thread follows a
// cycle through a table of T whose entries are the shared-window addresses of
// other entries (entry i points at entry (i + stride) & (n-1)), so that a
// load's address is the previous load's value as it is, with no operation
// between two loads (LDS.U16 R, [R] or LDS R, [R]). out[0] = the clocks of
// `loads` loads (a multiple of LAT_UNROLL), out[1] = the index reached.
constexpr int LAT_UNROLL = 32;

template <typename T>
__global__ void smem_latency_kernel(unsigned* __restrict__ out, int n, int stride, int loads) {
  extern __shared__ __align__(16) unsigned char lat_s[];
  T* tab = reinterpret_cast<T*>(lat_s);
  if (threadIdx.x != 0) return;
  const unsigned base = (unsigned)__cvta_generic_to_shared(tab);
  for (int i = 0; i < n; ++i)
    tab[i] = (T)(base + (unsigned)sizeof(T) * ((unsigned)(i + stride) & (unsigned)(n - 1)));
  unsigned p = base;
  const long long t0 = clock64();
  for (int k = 0; k < loads; k += LAT_UNROLL) {
#pragma unroll
    for (int u = 0; u < LAT_UNROLL; ++u) {
      if constexpr (sizeof(T) == 2) {
        asm volatile("ld.shared.u16 %0, [%0];" : "+r"(p));
      } else {
        asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
      }
    }
  }
  const long long t1 = clock64();
  out[0] = (unsigned)(t1 - t0);
  out[1] = (p - base) / (unsigned)sizeof(T);
}

// P3's staged-row layout, as the byte offset in xs of column t & 2047:
// 4 * layout(a) with layout(a) = a ^ (a >> 6), a bijection of [0, 2048) (bits
// 5-10 kept, bits 0-4 xored with bits 6-10; probes.gather_layout is its plain
// version). On byte offsets, (t << 2) & 0x1FFC is the column's own offset and
// (t >> 4) & 0x7C brings its bits 6-10 to word bits 0-4, so the shared load
// takes the offset as it is
__device__ __forceinline__ unsigned p3_offset(unsigned t) {
  return ((t << 2) & (4u * (P3_COLS - 1))) ^ ((t >> 4) & 0x7Cu);
}

__device__ __forceinline__ int32_t& p3_word(int32_t* xs, unsigned t) {
  return *reinterpret_cast<int32_t*>(reinterpret_cast<unsigned char*>(xs) + p3_offset(t));
}

__global__ void __launch_bounds__(P3_THREADS)
gather_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int rounds) {
  __shared__ int32_t xs[P3_COLS];
  const size_t row = (size_t)blockIdx.x * P3_COLS;
  const int q = threadIdx.x;  // columns 4q .. 4q+3
  const int4 xv = reinterpret_cast<const int4*>(x + row)[q];
  const int4 iv = reinterpret_cast<const int4*>(idx + row)[q];
  const unsigned col = 4u * (unsigned)q;
  p3_word(xs, col) = xv.x;
  p3_word(xs, col + 1u) = xv.y;
  p3_word(xs, col + 2u) = xv.z;
  p3_word(xs, col + 3u) = xv.w;
  const unsigned base[4] = {(unsigned)iv.x, (unsigned)iv.y, (unsigned)iv.z, (unsigned)iv.w};
  unsigned t[4] = {base[0], base[1], base[2], base[3]};
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] += (unsigned)p3_word(xs, t[k]);
  }
  reinterpret_cast<int4*>(out + row)[q] =
      make_int4((int)(t[0] - base[0]), (int)(t[1] - base[1]), (int)(t[2] - base[2]),
                (int)(t[3] - base[3]));
}

}  // namespace

// P1 with the table in global memory. table: i32 [n] scratch (holds the final
// table on return), out: i32 [1], seed: i32 [1] on the device; n a power of
// two.
extern "C" int probe_chase_rw(void* table, void* out, int n, int steps, const void* seed,
                              void* stream) {
  if (n <= 0 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  chase_rw_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), static_cast<int32_t*>(out), n, steps,
      static_cast<const int32_t*>(seed));
  return (int)cudaGetLastError();
}

// P1 with the table in shared memory (u16); the same arguments, n a power of
// two and at most 65,536 (a larger one does not fit shared memory:
// cudaFuncSetAttribute refuses it); table 16-byte aligned.
extern "C" int probe_chase_rw_smem(void* table, void* out, int n, int steps,
                                   const void* seed, void* stream) {
  if (n <= 0 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int bytes = ((n * (int)sizeof(uint16_t)) + 15) & ~15;
  cudaError_t e = cudaFuncSetAttribute(chase_rw_smem_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  chase_rw_smem_kernel<<<1, P1_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
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

// The shared-memory latency probe. out: u32 [2] on the device; n a power of
// two, at most 4,096 (so that a u16 entry holds a shared-window address);
// wide: u32 entries instead of u16.
extern "C" int probe_smem_latency(void* out, int n, int stride, int loads, int wide,
                                  void* stream) {
  if (n <= 0 || n > 4096 || (n & (n - 1)) != 0 || loads <= 0 || loads % LAT_UNROLL != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  if (wide) {
    smem_latency_kernel<uint32_t><<<1, 32, n * 4, st>>>(o, n, stride, loads);
  } else {
    smem_latency_kernel<uint16_t><<<1, 32, n * 2, st>>>(o, n, stride, loads);
  }
  return (int)cudaGetLastError();
}

// P3. x, idx, out: i32 [rows, 2048] contiguous, 16-byte aligned.
extern "C" int probe_gather_rows(const void* x, const void* idx, void* out, int rows,
                                 int rounds, void* stream) {
  if (rows <= 0) return 0;
  gather_rows_kernel<<<rows, P3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rounds);
  return (int)cudaGetLastError();
}
