// The ESDF's Jacobi distance sweeps over a layer's live blocks for NVIDIA
// Hopper (sm_90a): one init kernel a build, then one kernel a sweep.
//
// No TPU kernel is replaced: the JAX package's sweeps
// (coxgraph_tpu/ops/esdf.py::_esdf_sweeps) are XLA. These kernels replace
// the port's plain torch sweeps (coxgraph_tpu_torch/ops/esdf.py::
// _esdf_sweeps), which run every sweep over all max_blocks slots as ~70
// launches of full-pool temporaries (index_select, select, cat, clamp, add,
// minimum, maximum, where), and give the same dist and observed bit for
// bit, all max_blocks rows.
//
//   1. esdf_init_kernel, one CTA of v x v threads per slot (a thread per
//      column (j, k), i in a loop), num_blocks = n read on the device. Rows
//      >= n are dead: dist := max_distance, observed := false, as the plain
//      sweeps leave them. A live row gets observed = weight > 1e-6, its
//      frozen band = observed & |sdf| < truncation, and its start field
//      init = band ? sdf : (sdf >= 0 ? md : -md), md where unobserved
//      (clamped into dist at once when there are no sweeps); the band as
//      one bit per voxel, bit i of the column's word; and its 27
//      neighbour slots (offset (dx, dy, dz) at (dx+1)*9 + (dy+1)*3 + dz+1)
//      from block_index, -1 where the neighbour block is outside the grid,
//      unallocated or at a slot >= n. A dead row holds md in every sweep
//      of the plain version, so a dead neighbour reads as none does, and
//      dead rows need no sweeping.
//   2. esdf_sweep_kernel<kFull>, a persistent grid that walks the live
//      rows b < n (n read on the device, no host read): the CTA loads its
//      block into the middle of a (v+2)^3 box in shared memory with the
//      halo its connectivity reads (the six face planes; with kFull also
//      the 12 edges and 8 corners), md where the neighbour is none, then
//      each thread relaxes its column: pos = min(md, min_a(max(dn_a, 0) +
//      s_a)), neg = max(-md, max_a(min(dn_a, 0) - s_a)), d' = d >= 0 ?
//      min(d, pos) : max(d, neg), band voxels kept, written to the other
//      buffer of a ping-pong pair; the last sweep writes clamp(d', -md,
//      md) into dist. The steps s_a are the plain version's f32 values,
//      passed in. Every operation is a select, min, max, add or subtract of
//      f32 values, with torch.minimum / maximum / clamp's NaN propagation
//      (never fminf / fmaxf, which drop NaN); the file is built with
//      -fmad=false. Reads of a sweep come only from the previous sweep's
//      buffer, so the Jacobi order of the plain version holds.
//
// What bounds it: bytes. A sweep must read and write each live row once
// (v^3 f32 = 16 KB at v = 16) and read its face planes; at L live rows and
// S sweeps the build moves ~32 KB x L x S (2.7 GB at L = 1,000 and
// client_vga's 84 sweeps: ~0.8 ms at 3.35 TB/s), and the live rows'
// ping-pong pair (32 MB at L = 1,000) fits the 50 MB L2. The plain version moved every slot
// through ~70 full-pool temporaries a sweep (~15-20 GB a sweep, ~518 ms a
// build at client_vga's shapes). Here a sweep is one launch over the live
// rows only, coalesced loads of the block (one 4*v^2-byte plane per i),
// the halo from the neighbours' rows, one coalesced store; a build is
// 1 + S launches (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxV = 16;       // v * v threads a CTA, (v + 2)^3 floats of box
constexpr int kNbr = 27;        // neighbour slots a live row, centre included
constexpr int kMaxSteps = 26;

struct InitArgs {
  const float* sdf;              // (B, v^3)
  const float* weight;           // (B, v^3)
  const int32_t* block_index;    // (g, g, g)
  const int32_t* block_coords;   // (B, 3)
  const int32_t* num_blocks;     // ()
  float* field;                  // (B, v^3) the first sweep's input, live rows
  float* dist;                   // (B, v^3) the result: dead rows here
  uint8_t* observed;             // (B, v^3) bool
  uint32_t* band;                // (B, v^2) bit i of word j*v + k: (i, j, k)
  int32_t* nbr;                  // (B, 27)
  int B, v, gd;
  float md, truncation, min_weight;
  int clamp_field;               // no sweeps: field is dist, clamped
};

struct SweepArgs {
  const float* src;              // (B, v^3) the previous sweep's field
  float* dst;                    // (B, v^3)
  const uint32_t* band;
  const int32_t* nbr;
  const int32_t* num_blocks;
  int B, v;
  float md;
  int last;                      // dst is dist: clamp into [-md, md]
  float step[kMaxSteps];         // per offset, in (dx, dy, dz) order
};

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  if (x != x) return x;
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// torch.clamp(x, min=0.0) and torch.clamp(x, max=0.0)
__device__ __forceinline__ float clamp_min0(float x) {
  return x != x ? x : (x < 0.0f ? 0.0f : x);
}
__device__ __forceinline__ float clamp_max0(float x) {
  return x != x ? x : (x > 0.0f ? 0.0f : x);
}

__device__ __forceinline__ int live_count(const int32_t* num_blocks, int B) {
  const int n = *num_blocks;
  return n < 0 ? 0 : (n > B ? B : n);
}

__global__ void esdf_init_kernel(const InitArgs p) {
  const int v = p.v, v2 = v * v;
  const int b = blockIdx.x;
  const int j = threadIdx.y, k = threadIdx.x, t = j * v + k;
  const int n = live_count(p.num_blocks, p.B);
  const int64_t row = (int64_t)b * v2 * v;
  if (b >= n) {
    for (int i = 0; i < v; ++i) {
      const int64_t e = row + (i * v + j) * v + k;
      p.dist[e] = p.md;
      p.observed[e] = 0;
    }
    return;
  }
  uint32_t bits = 0;
  for (int i = 0; i < v; ++i) {
    const int64_t e = row + (i * v + j) * v + k;
    const float s = p.sdf[e];
    const bool obs = p.weight[e] > p.min_weight;
    const bool frozen = obs && fabsf(s) < p.truncation;
    float x = frozen ? s : (s >= 0.0f ? p.md : -p.md);
    if (!obs) x = p.md;
    if (p.clamp_field) x = clamp_nan(x, -p.md, p.md);
    p.field[e] = x;
    p.observed[e] = obs;
    bits |= (uint32_t)frozen << i;
  }
  p.band[(int64_t)b * v2 + t] = bits;
  const int h = p.gd / 2;
  const int32_t* c = p.block_coords + 3 * (int64_t)b;
  for (int q = t; q < kNbr; q += v2) {
    const int x = c[0] + q / 9 - 1, y = c[1] + (q / 3) % 3 - 1,
              z = c[2] + q % 3 - 1;
    int slot = -1;
    if (x >= -h && x < h && y >= -h && y < h && z >= -h && z < h)
      slot = p.block_index[((int64_t)(x + h) * p.gd + (y + h)) * p.gd +
                           (z + h)];
    p.nbr[(int64_t)b * kNbr + q] = (slot >= 0 && slot < n) ? slot : -1;
  }
}

// The value at local voxel (i, j, k) of neighbour slot `slot` of the
// sweep's read-only input, md if none.
__device__ __forceinline__ float neighbour_voxel(const float* src, int slot,
                                                 int v, int i, int j, int k,
                                                 float md) {
  return slot >= 0
             ? __ldg(src + (int64_t)slot * v * v * v + (i * v + j) * v + k)
             : md;
}

template <bool kFull>
__global__ void esdf_sweep_kernel(const SweepArgs p) {
  extern __shared__ float box[];   // (v + 2)^3, the block at (1..v)^3
  const int v = p.v, v2 = v * v, w = v + 2;
  const int j = threadIdx.y, k = threadIdx.x, t = j * v + k;
  const int n = live_count(p.num_blocks, p.B);
  const float md = p.md;
  const float* src = p.src;
  const auto at = [&](int x, int y, int z) -> float& {
    return box[(x * w + y) * w + z];
  };

  for (int b = blockIdx.x; b < n; b += gridDim.x) {
    // every thread reads the slots it needs from the table (one cached
    // line a row), so all of the box's loads are in flight at once
    const int32_t* nb = p.nbr + (int64_t)b * kNbr;
    const float* own = src + (int64_t)b * v2 * v;
#pragma unroll 4
    for (int i = 0; i < v; ++i)
      at(i + 1, j + 1, k + 1) = __ldg(own + (i * v + j) * v + k);
    // the six face planes: thread (j, k) takes (j, k) of the x faces and
    // (i = j, k) / (i = j, j = k) of the y / z faces
    at(0, j + 1, k + 1) = neighbour_voxel(src, nb[4], v, v - 1, j, k, md);
    at(v + 1, j + 1, k + 1) = neighbour_voxel(src, nb[22], v, 0, j, k, md);
    at(j + 1, 0, k + 1) = neighbour_voxel(src, nb[10], v, j, v - 1, k, md);
    at(j + 1, v + 1, k + 1) = neighbour_voxel(src, nb[16], v, j, 0, k, md);
    at(j + 1, k + 1, 0) = neighbour_voxel(src, nb[12], v, j, k, v - 1, md);
    at(j + 1, k + 1, v + 1) = neighbour_voxel(src, nb[14], v, j, k, 0, md);
    if (kFull) {
      // 12 edges of v voxels: edge e runs along axis e / 4 at the signs
      // (bit 1, bit 0) of e on the other two axes, in order
      for (int q = t; q < 12 * v; q += v2) {
        const int e = q / v, r = q % v, axis = e >> 2;
        const int sa = (e & 2) ? 1 : -1, sb = (e & 1) ? 1 : -1;
        // per axis: the block offset, the neighbour's local voxel and
        // the box coordinate
        const int da = axis == 0 ? 0 : sa;
        const int db = axis == 2 ? sb : (axis == 0 ? sa : 0);
        const int dc = axis == 2 ? 0 : sb;
        const int slot = nb[(da + 1) * 9 + (db + 1) * 3 + dc + 1];
        const int lx = da == 0 ? r : (da < 0 ? v - 1 : 0);
        const int ly = db == 0 ? r : (db < 0 ? v - 1 : 0);
        const int lz = dc == 0 ? r : (dc < 0 ? v - 1 : 0);
        at(da == 0 ? r + 1 : (da < 0 ? 0 : v + 1),
           db == 0 ? r + 1 : (db < 0 ? 0 : v + 1),
           dc == 0 ? r + 1 : (dc < 0 ? 0 : v + 1)) =
            neighbour_voxel(src, slot, v, lx, ly, lz, md);
      }
      for (int q = t; q < 8; q += v2) {
        const int dx = (q & 4) ? 1 : -1, dy = (q & 2) ? 1 : -1,
                  dz = (q & 1) ? 1 : -1;
        const int slot = nb[(dx + 1) * 9 + (dy + 1) * 3 + dz + 1];
        at(dx < 0 ? 0 : v + 1, dy < 0 ? 0 : v + 1, dz < 0 ? 0 : v + 1) =
            neighbour_voxel(src, slot, v, dx < 0 ? v - 1 : 0,
                            dy < 0 ? v - 1 : 0, dz < 0 ? v - 1 : 0, md);
      }
    }
    __syncthreads();

    const uint32_t frozen = p.band[(int64_t)b * v2 + t];
    float* out = p.dst + (int64_t)b * v2 * v;
    for (int i = 0; i < v; ++i) {
      const int c = ((i + 1) * w + j + 1) * w + k + 1;
      const float d = box[c];
      float r = d;                       // band voxels keep init
      if (!((frozen >> i) & 1u)) {
        float pos = md, neg = -md;
        int a = 0;                       // offsets in (dx, dy, dz) order
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dz = -1; dz <= 1; ++dz) {
              const int taxi = (dx != 0) + (dy != 0) + (dz != 0);
              if (taxi == 0 || (!kFull && taxi != 1)) continue;
              const float dn = box[c + (dx * w + dy) * w + dz];
              const float s = p.step[a++];
              pos = min_nan(pos, clamp_min0(dn) + s);
              neg = max_nan(neg, clamp_max0(dn) - s);
            }
        r = d >= 0.0f ? min_nan(d, pos) : max_nan(d, neg);
      }
      if (p.last) r = clamp_nan(r, -md, md);
      out[(i * v + j) * v + k] = r;
    }
    __syncthreads();   // the box is refilled for the next row
  }
}

template <bool kFull>
int launch_sweeps(SweepArgs a, float* dist, float* tmp, int n_iters,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * (a.v + 2) * (a.v + 2) * (a.v + 2);
  // the persistent grid: every CTA the device holds at once, at most B
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, esdf_sweep_kernel<kFull>, a.v * a.v, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > a.B) grid = a.B;
  const dim3 block(a.v, a.v);
  for (int it = 0; it < n_iters; ++it) {
    // sweep it reads field it and writes field it + 1; field n_iters is
    // dist, and the fields alternate between dist and tmp
    a.src = ((n_iters - it) % 2 == 0) ? dist : tmp;
    a.dst = ((n_iters - it - 1) % 2 == 0) ? dist : tmp;
    a.last = it == n_iters - 1;
    esdf_sweep_kernel<kFull><<<grid, block, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches the ESDF build of one layer on `stream` (1 + n_iters launches)
// and returns cudaGetLastError() (0 on success). Allocates nothing and
// does not synchronise. dist (B, v^3) f32 and observed (B, v^3) bool are
// written in every row; tmp (B, v^3) f32 (unused, may be null, when
// n_iters is 0), band (B, v^2) u32 and nbr (B, 27) i32 are scratch whose
// live rows are written before they are read. `steps` is a host array of
// the f32 steps of ops/esdf.py's _neighbor_offsets: when full, its 26
// offsets in the sweep's lexicographic (dx, dy, dz) order; else its 6
// faces, whose steps are all the voxel size.
// 1 <= v <= 16, else cudaErrorInvalidValue.
int cox_esdf_build(const float* sdf, const float* weight,
                   const int32_t* block_index, const int32_t* block_coords,
                   const int32_t* num_blocks, float* dist, uint8_t* observed,
                   float* tmp, uint32_t* band, int32_t* nbr, int B, int v,
                   int gd, int n_iters, int full, float md, float truncation,
                   float min_weight, const float* steps, void* stream) {
  if (B <= 0 || v < 1 || v > kMaxV || gd <= 0 || gd % 2 || n_iters < 0 ||
      (n_iters > 0 && tmp == nullptr) || steps == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* field = (n_iters % 2 == 0) ? dist : tmp;
  const InitArgs ia{sdf, weight, block_index, block_coords, num_blocks,
                    field, dist, observed, band, nbr, B, v, gd, md,
                    truncation, min_weight, n_iters == 0};
  esdf_init_kernel<<<B, dim3(v, v), 0, s>>>(ia);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_iters == 0) return 0;

  SweepArgs a{};
  a.band = band;
  a.nbr = nbr;
  a.num_blocks = num_blocks;
  a.B = B;
  a.v = v;
  a.md = md;
  const int n_steps = full ? 26 : 6;
  for (int q = 0; q < n_steps; ++q) a.step[q] = steps[q];
  return full ? launch_sweeps<true>(a, dist, tmp, n_iters, s)
              : launch_sweeps<false>(a, dist, tmp, n_iters, s);
}

}  // extern "C"
