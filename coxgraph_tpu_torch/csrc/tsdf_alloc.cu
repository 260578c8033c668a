// The allocation pass of the projective TSDF integrator for NVIDIA Hopper
// (sm_90a), in two kernels.
//
// No TPU kernel is replaced: the JAX package's pass
// (coxgraph_tpu/ops/tsdf.py::_alloc_candidates_soa, then
// coxgraph_tpu/core/voxel.py::allocate_and_slots) is XLA. These kernels
// replace the port's chain of small torch ops that computes the same pass
// (coxgraph_tpu_torch/ops/cuda_alloc.py::alloc_pass_reference, ~180 launches
// a frame) and give its integers bit for bit: submap k's block_index,
// block_coords and num_blocks, and the (slots, slot_mask) returned.
//
//   1. tsdf_alloc_mark_kernel, one thread per band sample x decimated pixel:
//      the candidate's grid cell in the plain version's f32 arithmetic, op
//      for op (decimate's top-left sample, linspace's band offsets
//      lo * (1 - s) + hi * s with the stop appended, (x - cx) * f32(1/fx),
//      the rotation as geometry.quat_to_matrix builds it, the sums left to
//      right, floor(p * f32(1/voxel_size)), floor division by v); the file
//      is built with -fmad=false, so no a*b + c is contracted. A valid
//      candidate sets its cell's byte in a scratch map of the g^3 cells and
//      its 64-cell group's byte in a summary.
//   2. tsdf_alloc_compact_kernel, one CTA of 1024 threads: thread t owns
//      the groups [t * gpt, (t + 1) * gpt), so ascending threads hold
//      ascending cells. It counts its marked cells (visiting only groups
//      the summary marks), a block-wide prefix sum ranks them, and the
//      first n_lanes = min(max_touched_blocks, max_blocks) in cell order
//      are voxel.candidate_cells' "K smallest unique valid ids". Each
//      thread clears the marks it read, so the scratch is zero again for
//      the next frame. Then voxel.allocate_cells in place on submap k (k
//      read on the device): look the lanes' cells up in block_index, rank
//      the new ones with a second prefix sum, give them num_blocks[k] +
//      rank while that is below max_blocks, write their block_coords rows
//      and num_blocks[k], and write slots / slot_mask in cell order
//      (masked lanes clamped to max_blocks - 1). The live slots are also
//      ORed into the window's touched bitmap when one is given.
//
// What bounds it: latency, not bytes. A 640x480 frame at stride 4 and 3
// band samples has 57,600 candidates, but the bytes the pass must move are
// the 19,200 sampled depths, the pose, the live lanes' block_index entries
// and the slots: ~88 KB, 0.03 us at 3.35 TB/s. The plain version spent
// 0.33 ms of device time on 180 launches (two radix sorts and copies of
// submap k's 1 MiB block_index among them). Here the mark kernel is one
// short wave (~2 us) and the compaction one CTA (~8-9 us on an H100)
// whose time goes to its chain of dependent L2 round trips: the summary
// (4 KiB at 64^3), the 64-byte groups that hold a candidate, the staged
// lanes, their block_index entries, with a CTA-wide prefix sum between;
// the pass takes ~11 us a frame in 2 launches (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMarkThreads = 256;
constexpr int kCompactThreads = 1024;    // one CTA: 32 warps
constexpr int kGroup = 64;               // grid cells per summary byte

struct MarkArgs {
  const float* depth;      // (H, W)
  const float* T_sm_cam;   // (7,) q(w, x, y, z), t
  uint8_t* cells;          // one byte per grid cell
  uint8_t* groups;         // one byte per kGroup cells
  int n, hs, ws, width, stride, band, gd, half, vps;
  float band_lo, band_hi, band_step;
  float cx, cy, inv_fx, inv_fy, min_range, max_range, inv_voxel;
};

struct CompactArgs {
  uint8_t* cells;
  uint8_t* groups;
  int32_t* block_index;    // (S, g^3)
  int32_t* block_coords;   // (S * mb, 3)
  int32_t* num_blocks;     // (S,)
  const int32_t* k;        // () active submap
  int32_t* slots;          // (n_lanes,)
  uint8_t* mask;           // (n_lanes,)
  uint8_t* touched;        // (mb + 1,) or null
  int g3, gd, half, mb, n_lanes, gpt;
};

// torch.div(a, b, rounding_mode="floor") for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int block_of(float p, float inv_voxel, int vps) {
  return floor_div((int)floorf(p * inv_voxel), vps);
}

__global__ void __launch_bounds__(kMarkThreads)
    tsdf_alloc_mark_kernel(const MarkArgs p) {
  const int t = blockIdx.x * kMarkThreads + threadIdx.x;
  if (t >= p.n) return;
  const int hw = p.hs * p.ws;
  const int b = t / hw;
  const int i = (t - b * hw) / p.ws;
  const int j = t - b * hw - i * p.ws;
  const int y = i * p.stride, x = j * p.stride;   // always inside the image
  const float d = p.depth[y * p.width + x];
  if (!(d > p.min_range && d < p.max_range)) return;
  const float s = (float)b * p.band_step;
  const float ks = (b > 0 && b == p.band - 1)
                       ? p.band_hi
                       : p.band_lo * (1.0f - s) + p.band_hi * s;
  const float dd = d + ks;
  if (!(dd > p.min_range)) return;
  const float dx = (((float)x - p.cx) * p.inv_fx) * dd;
  const float dy = (((float)y - p.cy) * p.inv_fy) * dd;

  const float* T = p.T_sm_cam;
  const float qw = T[0], qx = T[1], qy = T[2], qz = T[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wz),
              r02 = 2.0f * (xz + wy);
  const float r10 = 2.0f * (xy + wz), r11 = 1.0f - 2.0f * (xx + zz),
              r12 = 2.0f * (yz - wx);
  const float r20 = 2.0f * (xz - wy), r21 = 2.0f * (yz + wx),
              r22 = 1.0f - 2.0f * (xx + yy);
  const float px = r00 * dx + r01 * dy + r02 * dd + T[4];
  const float py = r10 * dx + r11 * dy + r12 * dd + T[5];
  const float pz = r20 * dx + r21 * dy + r22 * dd + T[6];

  const int bx = block_of(px, p.inv_voxel, p.vps);
  const int by = block_of(py, p.inv_voxel, p.vps);
  const int bz = block_of(pz, p.inv_voxel, p.vps);
  if (bx < -p.half || bx >= p.half || by < -p.half || by >= p.half ||
      bz < -p.half || bz >= p.half)
    return;
  const int cell = ((bx + p.half) * p.gd + (by + p.half)) * p.gd +
                   (bz + p.half);
  p.cells[cell] = 1;            // every writer stores the same byte
  p.groups[cell / kGroup] = 1;
}

// Exclusive prefix sum of x over the CTA → (this thread's offset, the
// CTA's total). `sums` is 32 ints of shared memory, free again on return.
__device__ __forceinline__ int cta_exclusive_scan(int x, int* total,
                                                  int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int offset = (warp ? sums[warp - 1] : 0) + incl - x;
  *total = sums[31];
  __syncthreads();
  return offset;
}

__device__ __forceinline__ int marked_in_group(const uint8_t* cells, int g) {
  const uint4* c = reinterpret_cast<const uint4*>(cells + kGroup * g);
  int n = 0;
#pragma unroll
  for (int q = 0; q < kGroup / 16; ++q) {
    const uint4 w = c[q];        // bytes are 0 or 1: one bit each
    n += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
  }
  return n;
}

__global__ void __launch_bounds__(kCompactThreads)
    tsdf_alloc_compact_kernel(const CompactArgs p) {
  __shared__ int sums[32];
  const int kk = *p.k;
  const int nb = p.num_blocks[kk];      // read before thread 0 writes it
  const int g0 = threadIdx.x * p.gpt, g1 = g0 + p.gpt;

  // 1. rank this thread's marked cells among all of them, in cell order
  int count = 0;
  for (int g = g0; g < g1; ++g)
    if (p.groups[g]) count += marked_in_group(p.cells, g);
  int n_marked;
  int pos = cta_exclusive_scan(count, &n_marked, sums);

  // 2. the first n_lanes cells go to their lanes (staged in slots, read
  // back after the barrier); every mark read is cleared
  for (int g = g0; g < g1; ++g) {
    if (!p.groups[g]) continue;
    uint4* c = reinterpret_cast<uint4*>(p.cells + kGroup * g);
#pragma unroll
    for (int q = 0; q < kGroup / 16; ++q) {
      const uint4 w = c[q];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        for (uint32_t bits = words[e]; bits; bits &= bits - 1) {
          const int byte = (__ffs(bits) - 1) >> 3;
          if (pos < p.n_lanes)
            p.slots[pos] = kGroup * g + 16 * q + 4 * e + byte;
          ++pos;
        }
      }
      c[q] = make_uint4(0u, 0u, 0u, 0u);
    }
    p.groups[g] = 0;
  }
  __syncthreads();

  // 3. allocate_cells over the lanes: thread t owns lanes [l0, l1)
  const int n_live = n_marked < p.n_lanes ? n_marked : p.n_lanes;
  const int lpt = (p.n_lanes + kCompactThreads - 1) / kCompactThreads;
  const int l0 = threadIdx.x * lpt;
  const int l1 = l0 + lpt < p.n_lanes ? l0 + lpt : p.n_lanes;
  int32_t* bi = p.block_index + (int64_t)kk * p.g3;
  int n_new = 0;
  for (int l = l0; l < l1 && l < n_live; ++l) n_new += bi[p.slots[l]] < 0;
  int new_total;
  int rank = cta_exclusive_scan(n_new, &new_total, sums);
  for (int l = l0; l < l1; ++l) {
    int slot = p.mb;
    if (l < n_live) {
      const int cell = p.slots[l];
      slot = bi[cell];
      if (slot < 0) {
        slot = nb + rank++;
        if (slot < p.mb) {
          bi[cell] = slot;
          int32_t* bc = p.block_coords + 3 * ((int64_t)kk * p.mb + slot);
          bc[0] = cell / (p.gd * p.gd) - p.half;
          bc[1] = (cell / p.gd) % p.gd - p.half;
          bc[2] = cell % p.gd - p.half;
        }
      }
    }
    const bool live = slot >= 0 && slot < p.mb;
    p.slots[l] = live ? slot : p.mb - 1;
    p.mask[l] = live;
    if (live && p.touched) p.touched[slot] = 1;
  }
  if (threadIdx.x == 0) {
    const int room = p.mb - nb > 0 ? p.mb - nb : 0;
    p.num_blocks[kk] = nb + (new_total < room ? new_total : room);
  }
}

}  // namespace

extern "C" {

// Launches the pass's two kernels on `stream` and returns
// cudaGetLastError() (0 on success). Allocates nothing and does not
// synchronise. `marks` is a zeroed scratch of `marks_bytes` bytes laid
// out as the wrapper's cuda_alloc.marks_layout: round_up(g^3, 64) cell
// bytes, then 1024 * gpt summary bytes (another size is
// cudaErrorInvalidValue); the launch leaves it zeroed. `touched` may be
// null.
int cox_tsdf_alloc(const float* depth, const float* T_sm_cam, uint8_t* marks,
                   int64_t marks_bytes, int32_t* block_index,
                   int32_t* block_coords,
                   int32_t* num_blocks, const int32_t* k, int32_t* slots,
                   uint8_t* mask, uint8_t* touched, int height, int width,
                   int stride, int band, int gd, int mb, int vps, int n_lanes,
                   float band_lo, float band_hi, float band_step, float cx,
                   float cy, float inv_fx, float inv_fy, float min_range,
                   float max_range, float inv_voxel, void* stream) {
  if (stride <= 0 || band <= 0 || gd <= 0 || gd % 2 || mb <= 0 || vps <= 0 ||
      n_lanes <= 0 || height <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const int g3 = gd * gd * gd;
  const int n_groups = (g3 + kGroup - 1) / kGroup;
  const int gpt = (n_groups + kCompactThreads - 1) / kCompactThreads;
  if (marks_bytes != (int64_t)n_groups * kGroup + kCompactThreads * gpt)
    return (int)cudaErrorInvalidValue;
  const int hs = (height + stride - 1) / stride;
  const int ws = (width + stride - 1) / stride;
  const cudaStream_t s = (cudaStream_t)stream;
  uint8_t* groups = marks + (int64_t)n_groups * kGroup;

  const MarkArgs m{depth, T_sm_cam, marks, groups, band * hs * ws, hs, ws,
                   width, stride, band, gd, gd / 2, vps, band_lo, band_hi,
                   band_step, cx, cy, inv_fx, inv_fy, min_range, max_range,
                   inv_voxel};
  tsdf_alloc_mark_kernel<<<(m.n + kMarkThreads - 1) / kMarkThreads,
                           kMarkThreads, 0, s>>>(m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const CompactArgs c{marks, groups, block_index, block_coords, num_blocks,
                      k, slots, mask, touched, g3, gd, gd / 2, mb, n_lanes,
                      gpt};
  tsdf_alloc_compact_kernel<<<1, kCompactThreads, 0, s>>>(c);
  return (int)cudaGetLastError();
}

}  // extern "C"
