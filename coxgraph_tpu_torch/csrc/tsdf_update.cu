// Projective TSDF + colour block update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel coxgraph_tpu/ops/pallas_tsdf.py::_kernel_ws
// (launched by tsdf_update_blocks_ws). Its semantics are those of the f32
// XLA path coxgraph_tpu/ops/tsdf.py::_update_xla, and its arithmetic is
// that of the plain torch twin
// coxgraph_tpu_torch/ops/cuda_tsdf.py::update_blocks_reference, operation
// for operation, so the two agree bit for bit:
//   * voxel centres are block_origin + (i + 0.5) * voxel_size;
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
// Grid: one CTA per touched-block lane; a masked lane returns at once. The
// threads of a CTA stride over the block's v^3 voxels, so neighbouring
// threads read and write neighbouring voxels of a pool row (coalesced).
// Pool row (k * max_blocks + slot) of sdf, weight and the three planar
// colour rows is updated in place. Live slots are unique within a launch
// (voxel.allocate_cells guarantees it), so no atomics are needed.
//
// What bounds it: at the 640x480 / 5 cm / 16^3 bench point a frame touches
// ~350 live blocks; each moves 5 rows x 16 KiB in and out, ~56 MB per frame,
// ~17 us of HBM time at 3.35 TB/s. The depth (1.2 MB) and colour (3.7 MB)
// images stay in the 50 MB L2. The kernel is memory-bound, and the torch
// allocation pass (sorts, cumsum) and launch overhead, not this kernel, are
// expected to set the frame time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tsdf_update_blocks_kernel(
    float* __restrict__ sdf_pool,            // (S*mb, v3)
    float* __restrict__ w_pool,              // (S*mb, v3)
    float* __restrict__ c_pool,              // (S*mb, 3*v3) planar rgb
    const int32_t* __restrict__ block_coords,  // (S*mb, 3)
    const int32_t* __restrict__ k_ptr,       // () active submap
    const int32_t* __restrict__ slots,       // (K,) clamped pool slots
    const uint8_t* __restrict__ mask,        // (K,) live lanes
    const float* __restrict__ depth,         // (H, W)
    const float* __restrict__ color,         // (3, H, W) or null
    const float* __restrict__ T_cam_sm,      // (7,) q(w,x,y,z), t
    int mb, int vps, int height, int width,
    float fx, float fy, float cx, float cy,
    float min_range, float max_range, float tau, float inv_half_tau,
    float max_weight, float voxel_size, float block_size,
    int use_dropoff, int use_distance_weight) {
  const int lane = blockIdx.x;
  if (!mask[lane]) return;

  const int64_t row = (int64_t)(*k_ptr) * mb + slots[lane];
  const int v3 = vps * vps * vps;
  const int64_t hw = (int64_t)height * width;
  float* srow = sdf_pool + row * v3;
  float* wrow = w_pool + row * v3;
  float* crow = c_pool + row * 3 * v3;

  const float ox = (float)block_coords[row * 3 + 0] * block_size;
  const float oy = (float)block_coords[row * 3 + 1] * block_size;
  const float oz = (float)block_coords[row * 3 + 2] * block_size;
  const float qw = T_cam_sm[0], qx = T_cam_sm[1], qy = T_cam_sm[2],
              qz = T_cam_sm[3];
  const float tx = T_cam_sm[4], ty = T_cam_sm[5], tz = T_cam_sm[6];

  for (int i = threadIdx.x; i < v3; i += blockDim.x) {
    const int ix = i / (vps * vps);
    const int iy = (i / vps) % vps;
    const int iz = i % vps;
    const float px = ox + ((float)ix + 0.5f) * voxel_size;
    const float py = oy + ((float)iy + 0.5f) * voxel_size;
    const float pz = oz + ((float)iz + 0.5f) * voxel_size;

    // quat_rotate: uv = qv x p, uuv = qv x uv
    const float uv0 = qy * pz - qz * py;
    const float uv1 = qz * px - qx * pz;
    const float uv2 = qx * py - qy * px;
    const float uuv0 = qy * uv2 - qz * uv1;
    const float uuv1 = qz * uv0 - qx * uv2;
    const float uuv2 = qx * uv1 - qy * uv0;
    const float x = px + 2.0f * (qw * uv0 + uuv0) + tx;
    const float y = py + 2.0f * (qw * uv1 + uuv1) + ty;
    const float z = pz + 2.0f * (qw * uv2 + uuv2) + tz;

    const float zs = fmaxf(z, 1e-6f);
    const float u = x / zs * fx + cx;
    const float v = y / zs * fy + cy;
    const int ui = __float2int_rn(u);
    const int vi = __float2int_rn(v);
    const bool in_img = (z > min_range) && (ui >= 0) && (ui < width) &&
                        (vi >= 0) && (vi < height);
    const int64_t lin = in_img ? (int64_t)vi * width + ui : 0;
    const float d = depth[lin];
    const bool has_depth = in_img && (d > min_range) && (d < max_range);

    const float sdf = d - z;
    const bool observed = has_depth && (sdf > -tau);
    float w_obs = 1.0f;
    if (use_distance_weight) w_obs = w_obs / fmaxf(d * d, 1.0f);
    if (use_dropoff)
      w_obs = w_obs * fminf(fmaxf((sdf + tau) * inv_half_tau, 0.0f), 1.0f);
    w_obs = observed ? w_obs : 0.0f;
    const float sdf_obs = fminf(fmaxf(sdf, -tau), tau);

    const float old_s = srow[i];
    const float old_w = wrow[i];
    const float new_w = fminf(old_w + w_obs, max_weight);
    const float denom = fmaxf(new_w, 1e-9f);
    srow[i] = new_w > 0.0f ? (old_w * old_s + w_obs * sdf_obs) / denom
                           : old_s;
    wrow[i] = new_w;

    if (color != nullptr) {
      const float near = w_obs * (fabsf(sdf) < tau ? 1.0f : 0.0f);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float oc = crow[ch * v3 + i];
        const float ci = color[ch * hw + lin];
        crow[ch * v3 + i] =
            new_w > 0.0f ? (old_w * oc + near * ci) / denom : oc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the block update on `stream` and returns cudaGetLastError()
// (0 on success). Allocates nothing and does not synchronise.
int cox_tsdf_update_blocks(
    float* sdf_pool, float* w_pool, float* c_pool,
    const int32_t* block_coords, const int32_t* k, const int32_t* slots,
    const uint8_t* mask, const float* depth, const float* color,
    const float* T_cam_sm, int n_lanes, int mb, int vps, int height,
    int width, float fx, float fy, float cx, float cy, float min_range,
    float max_range, float tau, float inv_half_tau, float max_weight,
    float voxel_size, float block_size, int use_dropoff,
    int use_distance_weight, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  const int v3 = vps * vps * vps;
  int threads = v3 < 256 ? ((v3 + 31) / 32) * 32 : 256;
  tsdf_update_blocks_kernel<<<n_lanes, threads, 0,
                              (cudaStream_t)stream>>>(
      sdf_pool, w_pool, c_pool, block_coords, k, slots, mask, depth, color,
      T_cam_sm, mb, vps, height, width, fx, fy, cx, cy, min_range,
      max_range, tau, inv_half_tau, max_weight, voxel_size, block_size,
      use_dropoff, use_distance_weight);
  return (int)cudaGetLastError();
}

const char* cox_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
