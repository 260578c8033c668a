// Brute-force binary-descriptor matching for NVIDIA Hopper (sm_90a), on the
// int8 tensor cores.
//
// Replaces the TPU kernel coxgraph_tpu/ops/pallas_kernels.py::_match_kernel
// (launched by hamming_match_topk) and serves the port's match_descriptors
// (loop detection's scoring and verification). Its plain torch version is
// coxgraph_tpu_torch/ops/cuda_hamming.py::match_topk_reference, the oracle.
//
// Function. For one pair (query q, database row j) the distance between query
// row i and database column c is the Hamming distance of two packed 256-bit
// BRIEF descriptors, replaced by `big` when either side is invalid. Per row:
//   * d1 = min_c D[i, c], i1 = the lowest c reaching it;
//   * d2 = min(excl, min over c != i1 of D[i, c]);
// per column (best_a): the lowest row reaching the column minimum.
//
// Encoding. Each bit becomes one int8, +1 for a set bit and -1 for a clear
// one, so dot(a, b) = 256 - 2 d and d = (256 - dot) / 2: a 256-deep s8 x s8
// product with s32 sums. The packed words are expanded four bits to four
// bytes in four integer operations (expand4): the query rows into
// registers, the database columns into shared memory. A descriptor's 32
// bytes become 256, once per descriptor per CTA: 1/Ka of the per-distance
// work. An invalid descriptor's int8 row is zero, so every dot product with
// it is 0.
//
// Keys. The row key of (i, c) is (d << 16) | c, the column key (d << 16) | i.
// With the +-1 encoding each is one IMAD on the s32 sum:
//   key = dot * (-32768) + K,  K = (256 << 15) | index,
// and the masks live in the constant K alone: an invalid column's row-key
// constant is (big << 16) | c and its int8 row is zero, so its key is that
// constant whatever the query row; an invalid query row's int8 row is zero
// and its column-key constant (big << 16) | i; a padding row's or column's
// constant is INT_MAX. The keys are exact and order like (d, index) because
// d <= max(256, big) < 2^15 and index < 2^16 (the wrapper checks Ka < 65536,
// Kb <= 1024 and big < 2^15), so a key is a non-negative int32.
//   * Row top-2: m2 = min(m2, max(m1, k)), m1 = min(m1, k), two keys at a
//     time with one 3-input min (Hopper's DPX __vimin3_s32). Keys are unique
//     per row, so m1 gives d1 and i1 (ties to the lowest column) and the
//     distance in m2 is d2 exactly, ties included.
//   * Column minimum: one min per distance, the keys' minimum over the rows
//     of a warp, then a shared atomicMin per column and CTA.
//   * Closed forms: an invalid row's outputs are d1 = big, i1 = 0,
//     d2 = min(excl, big) when Kb > 1 and excl when Kb = 1; an invalid
//     column's best_a is 0 (every entry of the column is big).
//
// Tiling (wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8; both operands are
// K-major, as descriptors are). A CTA of three warpgroups takes one database
// row j and, when b is shared by the queries and the launch still gives every
// SM a CTA, two queries (the detector's scoring launches: 64 x 4 or 128 x 2
// CTAs; 13% and 17% faster than one query per CTA on an H100 SXM,
// tools/time_k2_variants.py); it unpacks up to 512 database columns at a time
// into shared memory once for both, as 8-column x 16-byte core matrices without
// swizzle (LBO 128 B between the two halves of a k32 step, SBO 2 KB between
// 8-column groups). A warpgroup takes a unit of 128 query rows (two m64 tiles)
// and holds their A fragments, the whole 256-deep descriptor, in 64 registers
// per thread (the m16n8k32 fragment layout, which wgmma takes for A in
// registers); it walks the chunk in 32-column groups: 16 wgmma issued back to
// back and committed, a wait, then the epilogue on the 32 s32 sums per thread.
// The three warpgroups run out of step, so one's epilogue runs under another's
// wgmma. (Two accumulator sets per warpgroup would overlap within it, but ptxas
// then serializes every wgmma: it cannot follow which set a pending group
// owns.) Kb > 512 is split into equal chunks, a row's top-2 kept in shared
// memory between chunks.
//   Column minimum: a thread first takes the minimum over its four rows;
//   then the warp transposes its 8 x 32 partials through 1 KB of shared
//   memory (two 16-byte stores per lane, conflict-free reads), and each lane
//   folds one column into the CTA's column key with one shared atomicMin —
//   far cheaper than a three-level shuffle tree per column.
//   Shared memory: chunk x 256 B of B (128 KB at 512) + 12 B per chunk
//   column (constants, two queries' keys) + 16 B per CTA row + 12 KB of
//   transpose scratch: <= 154 KB, one CTA (384 threads, <= 168 registers)
//   per SM.
//   Launches with fewer CTAs than SMs (verification: 2-16 pairs with b per
//   query; hamming_match_topk's one pair) spread the rows of each pair over
//   CTAs; each CTA atomicMin's its column keys into best_a in global memory
//   (min is order-free, so the result is deterministic) and a second kernel
//   turns the keys into row indices.
//
// What bounds it. At the endurance launch (8 queries x 64 slots x 384^2 =
// 75.5 M distances) the int8 tensor cores need 75.5 M x 512 operations at
// 1,979 TOP/s = 19.5 us. The epilogue is a second floor of the same size:
// ~6 integer operations per distance (two IMADs for the keys, ~2.5 for the
// row top-2, ~1 for the column minimum, the transpose) at 64 per clock per
// SM on 132 SMs at 1.98 GHz is ~25 us of issue, and one CTA of 12 warps per
// SM hides its latency only in part. The unpack of B (4 integer operations
// per 4 bytes, ~3.5 us of the endurance launch on an H100 SXM) is the third.
// Bytes are small (6 MB).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 12;         // three warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kUnitRows = 128;     // query rows per warpgroup unit: 2 x m64
constexpr int kN = 32;             // database columns per wgmma (m64n32k32)
constexpr int kMaxChunk = 512;     // database columns unpacked at a time
constexpr int kMaxRows = 512;      // query rows per CTA and query
constexpr int kMaxGroup = 2;       // queries per CTA sharing a database row
constexpr int kSteps = 8;          // 32-deep k-steps of a 256-bit descriptor
constexpr int kUnpack = 8;         // unpack items whose loads are in flight
// B in shared memory: 8-column x 16-byte core matrices, K-major, no swizzle
constexpr uint32_t kLbo = 128;     // between the two 16-byte halves of a k32
constexpr uint32_t kSbo = 2048;    // between 8-column groups (256 B x 8)

struct Args {
  const uint32_t* a;        // (n_q, ka, 8) words
  const uint8_t* a_valid;   // (n_q, ka) or null
  const uint32_t* b;        // (n_q or 1, cap, kb, 8) words
  const uint8_t* b_valid;   // (n_q or 1, cap, kb) or null
  int32_t* d1;              // (n_q, cap, ka)
  int32_t* i1;
  int32_t* d2;
  int32_t* best_a;          // (n_q, cap, kb) or null
  int n_q, cap, ka, kb, b_batched, big, excl;
  int group;                // queries per CTA (1 when b is per query)
  int rows;                 // query rows per CTA (a multiple of 128)
  int chunk;                // database columns per chunk (a multiple of 32)
  int split;                // rows of a pair spread over several CTAs
};

// one DPX instruction on sm_90
__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

// the four bits of w at `shift` as four int8: +1 for a set bit, -1 else
__device__ __forceinline__ uint32_t expand4(uint32_t w, int shift) {
  const uint32_t u = (((w >> shift) & 0xFu) * 0x00204081u) & 0x01010101u;
  return u * 0xFFFFFF02u + 0xFFFFFFFFu;   // ~(u * 0xFE), bytewise
}

// key = (d << 16) | index from the s32 sum and the index's constant
__device__ __forceinline__ int key_of(int dot, int k) {
  return dot * -32768 + k;
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void reg_fence(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor of B at byte address `addr`
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((kLbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((kSbo >> 4) & 0x3FFF) << 32;   // layout 0: no swizzle
}

// d (64 x 32 s32) = A (64 x 32 s8, this warp's 16 rows in registers, the
// m16n8k32 fragment layout) x B^T (32 x 32 s8 in shared memory) [+ d]
__device__ __forceinline__ void wgmma_n32(int (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// the 16 wgmma of one 32-column group, committed as two groups (one per
// m64 tile, eight k-steps each), so that tile 0's epilogue can run while
// tile 1's products are in flight
__device__ __forceinline__ void issue(int (&acc)[2][16],
                                      const uint32_t (&af)[2][kSteps][4],
                                      uint64_t desc) {
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      wgmma_n32(acc[m], af[m][s], desc + (uint64_t)(s * 256 >> 4), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
}

// waits until at most N committed groups are pending, then releases acc
template <int N>
__device__ __forceinline__ void wait(int (&acc)[16]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  reg_fence(acc);
}

struct RowState {
  int m1[2][2], m2[2][2];   // row top-2 keys [m64 tile][half]
  int rk[2][2];             // column-key constants of the rows
};

// row top-2 of m64 tile M's rows over one 32-column group, and the column
// minimum over its two rows of the thread folded into part: acc[4 i + 2 h
// + e] is row 64 M + 16 warp + 8 h + g of the unit, column 32 n + 8 i +
// 2 t + e of the chunk
template <bool kCols, int M>
__device__ __forceinline__ void tile_epilogue(const int (&acc)[16],
                                              RowState& st, const int* scol,
                                              int n, int t, int (&part)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int2 cc =
        *reinterpret_cast<const int2*>(scol + kN * n + 8 * i + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = key_of(acc[4 * i + 2 * h], cc.x);
      const int k1 = key_of(acc[4 * i + 2 * h + 1], cc.y);
      const int lo = min(k0, k1);
      st.m2[M][h] = min3(st.m2[M][h], max(st.m1[M][h], lo), max(k0, k1));
      st.m1[M][h] = min(st.m1[M][h], lo);
    }
    if (kCols) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = min(key_of(acc[4 * i + e], st.rk[M][0]),
                          key_of(acc[4 * i + 2 + e], st.rk[M][1]));
        part[2 * i + e] = M == 0 ? k : min(part[2 * i + e], k);
      }
    }
  }
}

// the column minimum over the warp's 32 rows, folded into the CTA's keys:
// the warp transposes its 8 x 32 partials through its scratch; lane l then
// takes column l of the group from the eight row groups g (conflict-free:
// word 32 g + 8 t + 2 i + e) and folds it in with one atomicMin
__device__ __forceinline__ void fold_columns(const int (&part)[8],
                                             int* skey, int* scratch, int n,
                                             int lane) {
  int4* mine = reinterpret_cast<int4*>(scratch) + 2 * lane;
  mine[0] = make_int4(part[0], part[1], part[2], part[3]);
  mine[1] = make_int4(part[4], part[5], part[6], part[7]);
  __syncwarp();
  const int* col =
      scratch + 8 * ((lane >> 1) & 3) + 2 * (lane >> 3) + (lane & 1);
  int k = min3(col[0], col[32], col[64]);
  k = min3(k, col[96], col[128]);
  k = min3(k, col[160], col[192]);
  k = min(k, col[224]);
  atomicMin(&skey[kN * n + lane], k);
  __syncwarp();   // the scratch is written again by the next group
}

template <bool kCols>
__global__ void __launch_bounds__(kThreads, 1)
    hamming_wgmma_kernel(const Args p) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* sb = smem;                                    // (chunk, 256 B)
  int* scol = reinterpret_cast<int*>(sb + p.chunk * 16);    // (chunk,)
  int* skey = scol + p.chunk;                          // (group, chunk)
  int* sm1 = skey + p.group * p.chunk;                 // (group, rows)
  int* sm2 = sm1 + p.group * p.rows;                   // (group, rows)
  int* scratch = sm2 + p.group * p.rows;               // (warps, 256)
  const uint32_t sb_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(sb));

  // this CTA: database row j against queries q0 .. q0 + nqg - 1
  const int j = blockIdx.x % p.cap;
  const int q0 = blockIdx.x / p.cap * p.group;
  const int nqg = min(p.group, p.n_q - q0);
  const size_t brow = p.b_batched ? (size_t)q0 * p.cap + j : (size_t)j;
  const int row0 = blockIdx.y * p.rows;
  const int row_end = min(p.ka, row0 + p.rows);
  const int row_units = (row_end - row0 + kUnitRows - 1) / kUnitRows;
  // warp indices broadcast from lane 0, so that the compiler sees them
  // warp-uniform (wgmma in a path it deems divergent is serialized)
  const int warp = __shfl_sync(0xFFFFFFFFu, (int)threadIdx.x >> 5, 0);
  const int wg = warp >> 2;          // warpgroup
  const int wq = warp & 3;           // warp in the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // fragment row group
  const int t = lane & 3;            // thread in group
  const int n_chunks = (p.kb + p.chunk - 1) / p.chunk;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * p.chunk;
    const int kc = min(p.chunk, p.kb - c0);
    const int ng = (kc + kN - 1) / kN;    // 32-column groups
    const bool last = ch == n_chunks - 1;
    __syncthreads();   // the previous chunk's operands and keys are read

    // ---- unpack: one 16-byte core-matrix row per item --------------------
    // item it: column c = 8 (it / 128) + it % 8, k-chunk kc16 = (it / 8) % 16
    // (bits 16 kc16 .. 16 kc16 + 15), at byte 16 it of the operand
    for (int base = threadIdx.x; base < ng * kN * 16;
         base += kUnpack * kThreads) {
      uint32_t w[kUnpack];
      bool live[kUnpack];
#pragma unroll
      for (int u = 0; u < kUnpack; ++u) {
        const int it = base + u * kThreads;
        const int c = (it >> 7) * 8 + (it & 7);
        const size_t col = brow * p.kb + c0 + c;
        live[u] = it < ng * kN * 16 && c < kc &&
                  (p.b_valid == nullptr || p.b_valid[col]);
        w[u] = live[u] ? p.b[col * 8 + ((it >> 4) & 7)] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnpack; ++u) {
        const int it = base + u * kThreads;
        const int sh = (it & 8) ? 16 : 0;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (live[u]) {
          v.x = expand4(w[u], sh);
          v.y = expand4(w[u], sh + 4);
          v.z = expand4(w[u], sh + 8);
          v.w = expand4(w[u], sh + 12);
        }
        if (it < ng * kN * 16) sb[it] = v;
      }
    }
    for (int c = threadIdx.x; c < ng * kN; c += kThreads) {
      int k = INT_MAX;
      if (c < kc) {
        const size_t col = brow * p.kb + c0 + c;
        const bool ok = p.b_valid == nullptr || p.b_valid[col];
        k = ok ? ((256 << 15) | (c0 + c)) : ((p.big << 16) | (c0 + c));
      }
      scol[c] = k;
      for (int qi = 0; qi < p.group; ++qi) skey[qi * p.chunk + c] = INT_MAX;
    }
    // the generic-proxy writes of B must be visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- units: (query of the group, 128 rows), one per warpgroup --------
    for (int unit = wg; unit < nqg * row_units; unit += kWarps / 4) {
      const int qi = unit / row_units;
      const int q = q0 + qi;
      const int rbase = row0 + (unit - qi * row_units) * kUnitRows;
      int* skey_q = skey + qi * p.chunk;
      int* sm1_q = sm1 + qi * p.rows - row0;
      int* sm2_q = sm2 + qi * p.rows - row0;
      uint32_t af[2][kSteps][4];   // A fragments [m64 tile][k-step][reg]
      RowState st;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 64 * m + 16 * wq + 8 * h + g;
          uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
          bool ok = false;
          st.rk[m][h] = INT_MAX;
          if (r < row_end) {
            const size_t ar = (size_t)q * p.ka + r;
            const uint4* pa = reinterpret_cast<const uint4*>(p.a) + 2 * ar;
            w0 = pa[0];
            w1 = pa[1];
            ok = p.a_valid == nullptr || p.a_valid[ar];
            st.rk[m][h] = ok ? ((256 << 15) | r) : ((p.big << 16) | r);
          }
          const uint32_t keep = ok ? 0xFFFFFFFFu : 0u;
          const uint32_t w[kSteps] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            af[m][s][h] = expand4(w[s], 4 * t) & keep;
            af[m][s][2 + h] = expand4(w[s], 16 + 4 * t) & keep;
          }
          const bool carry = ch > 0 && t == 0 && r < row_end;
          st.m1[m][h] = carry ? sm1_q[r] : INT_MAX;
          st.m2[m][h] = carry ? sm2_q[r] : INT_MAX;
        }
      }

      // one 32-column group at a time: 16 wgmma back to back, then the
      // epilogue; the other warpgroup's epilogue runs under these wgmma
      const uint64_t desc0 = b_desc(sb_addr);
      const uint64_t group_step = (uint64_t)(kN / 8 * kSbo >> 4);
      int acc[2][16];
      int part[8];   // column minimum over this thread's four rows
      for (int n = 0; n < ng; ++n) {
        issue(acc, af, desc0 + n * group_step);
        wait<1>(acc[0]);
        tile_epilogue<kCols, 0>(acc[0], st, scol, n, t, part);
        wait<0>(acc[1]);
        tile_epilogue<kCols, 1>(acc[1], st, scol, n, t, part);
        if (kCols) fold_columns(part, skey_q, scratch + 256 * warp, n, lane);
      }

      // the four lanes of a quad hold one row's top-2 over their columns
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m1 = st.m1[m][h], m2 = st.m2[m][h];
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const int o1 = __shfl_xor_sync(0xFFFFFFFFu, m1, off);
            const int o2 = __shfl_xor_sync(0xFFFFFFFFu, m2, off);
            m2 = min3(max(m1, o1), m2, o2);
            m1 = min(m1, o1);
          }
          const int r = rbase + 64 * m + 16 * wq + 8 * h + g;
          if (t != 0 || r >= row_end) continue;
          if (!last) {
            sm1_q[r] = m1;
            sm2_q[r] = m2;
            continue;
          }
          const size_t o = ((size_t)q * p.cap + j) * p.ka + r;
          const bool ok =
              p.a_valid == nullptr || p.a_valid[(size_t)q * p.ka + r];
          p.d1[o] = ok ? m1 >> 16 : p.big;
          p.i1[o] = ok ? m1 & 0xFFFF : 0;
          const int d2 = ok ? m2 >> 16 : p.big;
          p.d2[o] = p.kb > 1 ? min(p.excl, d2) : p.excl;
        }
      }
    }

    // ---- the chunk's column results ------------------------------------
    if (kCols) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < nqg * kc; idx += kThreads) {
        const int qi = idx / kc;
        const int c = idx - qi * kc;
        const bool ok =
            p.b_valid == nullptr || p.b_valid[brow * p.kb + c0 + c];
        const int key = skey[qi * p.chunk + c];
        int32_t* out =
            p.best_a + ((size_t)(q0 + qi) * p.cap + j) * p.kb + c0 + c;
        if (!p.split) {
          *out = ok ? (key & 0xFFFF) : 0;
        } else {
          atomicMin(reinterpret_cast<unsigned int*>(out),
                    ok ? (unsigned int)key : 0u);
        }
      }
    }
  }
}

// best_a's column keys (split launches) → row indices
__global__ void keys_to_rows_kernel(int32_t* best_a, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    best_a[i] &= 0xFFFF;
  }
}

}  // namespace

extern "C" {

// Launches the matcher on `stream` and returns the first CUDA error (0 on
// success). a (n_q, ka, 8) and b (n_q or 1, cap, kb, 8) hold 32-bit words,
// 16-byte aligned; a_valid (n_q, ka) / b_valid (n_q or 1, cap, kb) are
// bytes, or null for all valid; best_a may be null (not computed).
// Outputs d1, i1, d2 are (n_q, cap, ka) int32, best_a (n_q, cap, kb).
// Requires ka < 65536, kb <= 1024, 0 <= big < 2^15. Allocates nothing and
// does not synchronise.
int cox_hamming_topk(const void* a, const void* a_valid, const void* b,
                     const void* b_valid, void* d1, void* i1, void* d2,
                     void* best_a, int n_q, int cap, int ka, int kb,
                     int b_batched, int big, int excl, void* stream) {
  if (n_q <= 0 || cap <= 0 || ka <= 0 || kb <= 0) return (int)cudaSuccess;
  int dev = 0, n_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  // queries per CTA: two share the unpacked database row when b is shared
  // and the CTAs still give every SM one; rows per CTA: all of a query's
  // when the CTAs give every SM one, else spread so that about that many run
  const int pairs = n_q * cap;
  int group = 1;
  if (!b_batched && n_q >= kMaxGroup &&
      cap * ((n_q + kMaxGroup - 1) / kMaxGroup) >= n_sms)
    group = kMaxGroup;
  const int ctas = cap * ((n_q + group - 1) / group);
  const int units = (ka + kUnitRows - 1) / kUnitRows;
  int split = (n_sms + ctas - 1) / ctas;
  split = split < 1 ? 1 : (split > units ? units : split);
  int rows = kUnitRows * ((units + split - 1) / split);
  if (rows > kMaxRows) rows = kMaxRows;
  split = (ka + rows - 1) / rows;
  // columns per chunk: Kb in equal parts of at most kMaxChunk, rounded to
  // whole 32-column groups
  const int n_chunks = (kb + kMaxChunk - 1) / kMaxChunk;
  const int chunk = kN * ((kb + kN * n_chunks - 1) / (kN * n_chunks));
  const size_t smem = (size_t)chunk * (256 + 4 + 4 * group) +
                      (size_t)group * rows * 8 + kWarps * 1024;
  const size_t smem_max = (size_t)kMaxChunk * (260 + 4 * kMaxGroup) +
                          (size_t)kMaxGroup * kMaxRows * 8 + kWarps * 1024;

  static bool attr_set[64] = {};
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(hamming_wgmma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hamming_wgmma_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_max);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_cols = (size_t)pairs * kb;
  const bool spread = split > 1 && best_a != nullptr;
  if (spread) {
    // column keys start above every key: unsigned 0xFFFFFFFF
    err = cudaMemsetAsync(best_a, 0xFF, n_cols * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
  }
  Args args;
  args.a = static_cast<const uint32_t*>(a);
  args.a_valid = static_cast<const uint8_t*>(a_valid);
  args.b = static_cast<const uint32_t*>(b);
  args.b_valid = static_cast<const uint8_t*>(b_valid);
  args.d1 = static_cast<int32_t*>(d1);
  args.i1 = static_cast<int32_t*>(i1);
  args.d2 = static_cast<int32_t*>(d2);
  args.best_a = static_cast<int32_t*>(best_a);
  args.n_q = n_q;
  args.cap = cap;
  args.ka = ka;
  args.kb = kb;
  args.b_batched = b_batched;
  args.big = big;
  args.excl = excl;
  args.group = group;
  args.rows = rows;
  args.chunk = chunk;
  args.split = spread ? 1 : 0;
  const dim3 grid(ctas, split);
  if (best_a != nullptr)
    hamming_wgmma_kernel<true><<<grid, kThreads, smem, st>>>(args);
  else
    hamming_wgmma_kernel<false><<<grid, kThreads, smem, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || !spread) return (int)err;
  const size_t blocks = (n_cols + 255) / 256;
  keys_to_rows_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                        st>>>(static_cast<int32_t*>(best_a), n_cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
