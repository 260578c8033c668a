// Projective TSDF + colour block update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel coxgraph_tpu/ops/pallas_tsdf.py::_kernel_ws
// (launched by tsdf_update_blocks_ws). Its semantics are those of the f32
// XLA path coxgraph_tpu/ops/tsdf.py::_update_xla, and its arithmetic is
// that of the plain torch twin
// coxgraph_tpu_torch/ops/cuda_tsdf.py::update_blocks_reference, operation
// for operation, so the two agree bit for bit:
//   * voxel centres are block_origin + (i + 0.5) * voxel_size, per voxel;
//   * the camera pose is a 7-float device quaternion + translation, applied
//     in the two-cross-product form v + 2 (qw (q x v) + q x (q x v)) + t;
//   * u = x / max(z, 1e-6) * fx + cx, rounded half-to-even
//     (__float2int_rn, as torch.round; never roundf);
//   * the drop-off divides by tau/2 as XLA does: a multiply by the f32
//     reciprocal, passed in as inv_half_tau;
//   * the file is built with -fmad=false: nvcc would otherwise contract
//     a*b + c into one fused multiply-add and round differently.
// The TPU kernel's bf16 hi/lo depth split, stride-pyramid atlas and
// tile-aligned working set existed only for TPU layout rules; here each
// voxel gathers its depth and colour pixel directly.
//
// What bounds it: bytes. Each live lane's block moves its 5 pool rows
// (sdf, weight, r, g, b: 5 x v^3 f32) in and out once, 160 KiB at 16^3,
// and the depth and colour images (4.9 MB at 640x480) are read once. At
// the 640x480 / 5 cm / 16^3 bench point a frame has 59-187 live lanes of
// 512 (median 151, chip_smoke.py phase 4); at the compared frame's 165,
// 27 MB of rows and 9.5 us at 3.35 TB/s.
//
// Design: work items (lane, chunk of kThreads * V voxels of its rows). A
// persistent grid of as many CTAs as the card holds at once walks them
// (item = blockIdx.x, + gridDim.x, ...); the grid follows from the lane
// count and the card, never from the live count, which stays on the
// device. A masked lane's items are skipped before any load or store.
// Each thread takes V consecutive voxels of a row (V = 2 where a row is a
// multiple of 8 bytes, even v; else 1, chosen by shape in the wrapper):
// it issues its five row loads first, then projects its voxels and
// gathers their depth and colour pixels from L2 while the loads are in
// flight, then updates and stores. Pool row k * max_blocks + slot is
// updated in place. Live slots are unique within a launch
// (voxel.allocate_cells guarantees it), so no atomics are needed; masked
// lanes, clamped to max_blocks - 1, may share a live lane's row and never
// write.
//
// On an H100 (PERF.md, tools/time_k1_variants.py) this design reads ~17.5
// us per launch with the rows cold in HBM and ~14.5 us with them in L2;
// 256 threads per CTA read ~0.7 us more cold, one CTA per item on a
// static grid ~0.8 us more, 1 voxel per thread ~2 us more, and 4 voxels
// per thread in 16-byte accesses (since removed) ~1 us more. Rows brought
// through shared memory by 1-D bulk copies (TMA) read ~1.3 us more than
// registers: the register loads already keep each CTA's rows in flight,
// and the copies add a CTA-wide wait before the bulk stores. Even with
// the rows in L2 the kernel stays near 14.5 us: its time goes to the
// divergent pixel gathers (~3.5 us) and to the latency of each item's
// chain mask -> slot -> rows and block origin -> projection -> gathers ->
// update.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // threads per CTA

struct Args {
  float* sdf_pool;               // (S*mb, v3)
  float* w_pool;                 // (S*mb, v3)
  float* c_pool;                 // (S*mb, 3*v3) planar rgb
  const int32_t* block_coords;   // (S*mb, 3)
  const int32_t* k;              // () active submap
  const int32_t* slots;          // (K,) clamped pool slots
  const uint8_t* mask;           // (K,) live lanes
  const float* depth;            // (H, W)
  const float* color;            // (3, H, W) or null
  const float* T_cam_sm;         // (7,) q(w,x,y,z), t
  int n_items, chunks, mb, vps, height, width;
  float fx, fy, cx, cy, min_range, max_range, tau, inv_half_tau;
  float max_weight, voxel_size, block_size;
  int use_dropoff, use_distance_weight;
};

// V consecutive f32 in one access of 4 * V bytes
template <int V>
__device__ __forceinline__ void load(const float* src, float (&x)[V]) {
  static_assert(V == 1 || V == 2, "1 or 2 voxels a thread");
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *src;
  }
}

template <int V>
__device__ __forceinline__ void store(float* dst, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *dst = x[0];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    tsdf_update_blocks_kernel(const Args p) {
  constexpr int kChunk = kThreads * V;     // voxels of a work item
  const int v3 = p.vps * p.vps * p.vps;
  const int64_t hw = (int64_t)p.height * p.width;
  const float qw = p.T_cam_sm[0], qx = p.T_cam_sm[1], qy = p.T_cam_sm[2],
              qz = p.T_cam_sm[3];
  const float tx = p.T_cam_sm[4], ty = p.T_cam_sm[5], tz = p.T_cam_sm[6];
  const bool with_color = p.color != nullptr;
  const int64_t plane_size = with_color ? hw : 0;
  const float* plane[3] = {p.color, p.color + plane_size,
                           p.color + 2 * plane_size};
  const int k = *p.k;

  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int lane = item / p.chunks;
    if (!p.mask[lane]) continue;
    const int c0 = (item - lane * p.chunks) * kChunk;
    const int i = c0 + threadIdx.x * V;      // this thread's first voxel
    if (i >= v3) continue;                   // v3 % V == 0: all V are in

    const int64_t row = (int64_t)k * p.mb + p.slots[lane];
    float* rows[5] = {p.sdf_pool + row * v3 + i, p.w_pool + row * v3 + i,
                      p.c_pool + row * 3 * v3 + i,
                      p.c_pool + (row * 3 + 1) * v3 + i,
                      p.c_pool + (row * 3 + 2) * v3 + i};

    // 1. the row loads first, in flight during the gathers
    float s[V], w[V], c[3][V];
    load<V>(rows[0], s);
    load<V>(rows[1], w);
    if (with_color) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) load<V>(rows[2 + ch], c[ch]);
    }

    // 2. project the V voxels and gather their pixels; the first voxel's
    // (ix, iy, iz) is divided out once, the next ones step along iz
    // (rows are C-order: i = (ix * v + iy) * v + iz)
    const float ox = (float)p.block_coords[row * 3 + 0] * p.block_size;
    const float oy = (float)p.block_coords[row * 3 + 1] * p.block_size;
    const float oz = (float)p.block_coords[row * 3 + 2] * p.block_size;
    const int q = i / p.vps;
    int ix = q / p.vps, iy = q - ix * p.vps, iz = i - q * p.vps;
    int lin[V];      // pixel index, -1 off the image
    float d[V], z[V], ci[3][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j > 0 && ++iz == p.vps) {
        iz = 0;
        if (++iy == p.vps) {
          iy = 0;
          ++ix;
        }
      }
      const float px = ox + ((float)ix + 0.5f) * p.voxel_size;
      const float py = oy + ((float)iy + 0.5f) * p.voxel_size;
      const float pz = oz + ((float)iz + 0.5f) * p.voxel_size;

      // quat_rotate: uv = qv x p, uuv = qv x uv
      const float uv0 = qy * pz - qz * py;
      const float uv1 = qz * px - qx * pz;
      const float uv2 = qx * py - qy * px;
      const float uuv0 = qy * uv2 - qz * uv1;
      const float uuv1 = qz * uv0 - qx * uv2;
      const float uuv2 = qx * uv1 - qy * uv0;
      const float x = px + 2.0f * (qw * uv0 + uuv0) + tx;
      const float y = py + 2.0f * (qw * uv1 + uuv1) + ty;
      z[j] = pz + 2.0f * (qw * uv2 + uuv2) + tz;

      const float zs = fmaxf(z[j], 1e-6f);
      const float u = x / zs * p.fx + p.cx;
      const float v = y / zs * p.fy + p.cy;
      const int ui = __float2int_rn(u);
      const int vi = __float2int_rn(v);
      const bool in_img = (z[j] > p.min_range) && (ui >= 0) &&
                          (ui < p.width) && (vi >= 0) && (vi < p.height);
      lin[j] = in_img ? vi * p.width + ui : -1;
      d[j] = p.depth[in_img ? lin[j] : 0];
      if (with_color) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          ci[ch][j] = plane[ch][in_img ? lin[j] : 0];
      }
    }

    // 3. update in registers, then store
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool has_depth =
          lin[j] >= 0 && (d[j] > p.min_range) && (d[j] < p.max_range);
      const float sdf = d[j] - z[j];
      const bool observed = has_depth && (sdf > -p.tau);
      float w_obs = 1.0f;
      if (p.use_distance_weight) w_obs = w_obs / fmaxf(d[j] * d[j], 1.0f);
      if (p.use_dropoff)
        w_obs = w_obs *
                fminf(fmaxf((sdf + p.tau) * p.inv_half_tau, 0.0f), 1.0f);
      w_obs = observed ? w_obs : 0.0f;
      const float sdf_obs = fminf(fmaxf(sdf, -p.tau), p.tau);

      const float old_w = w[j];
      const float new_w = fminf(old_w + w_obs, p.max_weight);
      const float denom = fmaxf(new_w, 1e-9f);
      s[j] = new_w > 0.0f ? (old_w * s[j] + w_obs * sdf_obs) / denom : s[j];
      w[j] = new_w;
      if (with_color) {
        const float near = w_obs * (fabsf(sdf) < p.tau ? 1.0f : 0.0f);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          c[ch][j] = new_w > 0.0f
                         ? (old_w * c[ch][j] + near * ci[ch][j]) / denom
                         : c[ch][j];
      }
    }
    store<V>(rows[0], s);
    store<V>(rows[1], w);
    if (with_color) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) store<V>(rows[2 + ch], c[ch]);
    }
  }
}

template <int V>
cudaError_t launch(Args p, cudaStream_t stream) {
  const int v3 = p.vps * p.vps * p.vps;
  p.chunks = (v3 + kThreads * V - 1) / (kThreads * V);
  p.n_items *= p.chunks;
  // the persistent grid: the CTAs resident at once on this device
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < 64 ? resident[dev] : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tsdf_update_blocks_kernel<V>, kThreads, 0);
    if (err != cudaSuccess) return err;
    n = sms * per_sm;
    if (dev < 64) resident[dev] = n;
  }
  const int grid = p.n_items < n ? p.n_items : n;
  tsdf_update_blocks_kernel<V><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the block update on `stream` and returns cudaGetLastError()
// (0 on success). Allocates nothing and does not synchronise. `vec` is the
// voxels per thread, 1 or 2, dividing v^3 (the pools then 4 * vec-byte
// aligned); anything else is cudaErrorInvalidValue.
int cox_tsdf_update_blocks(
    float* sdf_pool, float* w_pool, float* c_pool,
    const int32_t* block_coords, const int32_t* k, const int32_t* slots,
    const uint8_t* mask, const float* depth, const float* color,
    const float* T_cam_sm, int n_lanes, int mb, int vps, int vec,
    int height, int width, float fx, float fy, float cx, float cy,
    float min_range, float max_range, float tau, float inv_half_tau,
    float max_weight, float voxel_size, float block_size, int use_dropoff,
    int use_distance_weight, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  const int v3 = vps * vps * vps;
  if (vps <= 0 || !(vec == 1 || vec == 2) || v3 % vec != 0)
    return (int)cudaErrorInvalidValue;
  const Args p{sdf_pool, w_pool, c_pool, block_coords, k, slots, mask,
               depth, color, T_cam_sm, n_lanes, 0, mb, vps, height, width,
               fx, fy, cx, cy, min_range, max_range, tau, inv_half_tau,
               max_weight, voxel_size, block_size, use_dropoff,
               use_distance_weight};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec == 2 ? launch<2>(p, s) : launch<1>(p, s));
}

const char* cox_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
