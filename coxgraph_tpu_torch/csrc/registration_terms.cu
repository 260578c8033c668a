// The Gauss-Newton terms of dense registration pairs for NVIDIA Hopper
// (sm_90a): one CTA a pair, one launch a call.
//
// No TPU kernel is replaced: the JAX package computes these terms with XLA
// (coxgraph_tpu/ops/registration.py::registration_normal_eq and the
// batched pass of coxgraph_tpu/server/global_opt.py). The kernel replaces
// the port's plain torch composition (coxgraph_tpu_torch/ops/
// registration.py::pair_terms), ~650 launches a call over (P, Q) and
// (P, Q, 3) temporaries and a (P, Q, 12) Jacobian, and gives its outputs
// up to the order of the sums over the points.
//
// Pair p (CTA p) samples the pool rows of table row j = pair_j[p] (row 0
// when pair_j is null) at its Q points; each of the CTA's threads takes the
// points t, t + 128, ... and repeats the plain arithmetic in the plain
// order, under -fmad=false:
//   p_B = R_B^-1 (R_A p + t_A) - R_B^-1 t_B, quat_rotate's two-cross form,
//     with the poses as the wrapper renormalized them;
//   the trilinear base voxel floor(p_B * (1/s) - 0.5) and its fraction;
//   the 8 corners in (dx, dy, dz) order: block = floor(voxel / v), the
//     table's row at the block's clamped grid slot (-1 outside the grid),
//     the sdf and weight of row j*R + that row (truncation and 0 where
//     there is none), acc += ((a0 a1) a2) s and the three gradient sums
//     +/- (o0 o1) s, valid &= row found & weight > 0;
//   valid &= mask_A; r = acc - sdf_A; g = grad * (1/s);
//     h = conj(q_A) (q_B g); J = [p x h, h, g x p_B, -g];
//     w = min(delta * (1 / max(|r|, 1e-9)), 1), as torch's `delta / x` is
//     its reciprocal times delta.
// So a point's validity, residual, Jacobian and weight are the plain
// version's bit for bit. A valid point adds (w J_a) J_c to the 78 upper
// entries of H, r (w J_a) to b and (w r) r to the cost; the thread's sums
// are reduced over the warp by a fixed xor butterfly, then over the warps
// in warp order: no atomics, so two calls on one input give the same bits,
// and H, b and cost differ from the plain einsum and sum only by the order
// of the sums. The cost-only instantiation (H and b null) keeps the cost
// and the count alone and skips J.
//
// What bounds it: bytes. Each point reads 12 B of position, 4 of sdf_A and
// 1 of mask, and up to 8 corners x (4 B of table + 4 of sdf + 4 of weight),
// most of them in the lines its neighbouring corners share: at 1,082 pairs
// x 2,048 points, 37.7 MB read once and ~213 MB of corner reads requested,
// 0.01-0.08 ms at 3.35 TB/s; ~200 f32 operations a point are far below the
// card's rate. The plain composition moved ~9 ms of temporaries a call.
// The kernel keeps every intermediate in registers and issues each point's
// 8 table reads, then its 16 field reads, together, so a pair's loads are
// in flight at once; four warps a CTA and the register sums (92 a thread)
// leave room for three CTAs an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 78;             // the upper triangle of the 12 x 12 H
constexpr int kSums = kH + 12 + 1; // H, b, cost (the count apart)

struct Args {
  const float* sdf;        // (S*R, v^3) pool rows of every table row
  const float* weight;     // (S*R, v^3)
  const int32_t* table;    // (S, gd^3) rows in [0, R) or -1
  const int64_t* pair_j;   // (P,) table row of each pair, or null: row 0
  const float* pts;        // (P, Q, 3) the points, in A's frame
  const float* sdf_a;      // (P, Q)
  const uint8_t* mask_a;   // (P, Q) bool
  const float* ta;         // (P, 7) [qw qx qy qz tx ty tz], renormalized
  const float* tb;         // (P, 7)
  float* H;                // (P, 12, 12), null in the cost-only form
  float* b;                // (P, 12), null in the cost-only form
  float* cost;             // (P,)
  int32_t* n_valid;        // (P,)
  int P, Q, S, R, v, gd;
  float inv_s, truncation, delta;
};

// geometry.py's _cross(a, b): [a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0]
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// geometry.py's quat_rotate: v + 2 (qw (qv x v) + qv x (qv x v))
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross(qv, v, uv);
  cross(qv, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

// torch.div(a, n, rounding_mode="floor") for n > 0
__device__ __forceinline__ int floor_div(int a, int n) {
  const int q = a / n;
  return (a % n != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads, kFull ? 3 : 8)
registration_terms_kernel(const Args a) {
  __shared__ float part[kWarps][kFull ? kSums : 1];
  __shared__ int part_n[kWarps];
  const int pair = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the pair's poses: q_A, t_A; inverse(T_B) = (conj(q_B), -(conj(q_B) t_B))
  float qa[4], ta[3], qb[4], qi[4], ti[3], qca[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k] = __ldg(a.ta + 7 * (int64_t)pair + k);
    qb[k] = __ldg(a.tb + 7 * (int64_t)pair + k);
  }
  float tb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ta[k] = __ldg(a.ta + 7 * (int64_t)pair + 4 + k);
    tb[k] = __ldg(a.tb + 7 * (int64_t)pair + 4 + k);
  }
  qi[0] = qb[0];
  qca[0] = qa[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    qi[k] = -qb[k];
    qca[k] = -qa[k];
  }
  quat_rotate(qi, tb, ti);
#pragma unroll
  for (int k = 0; k < 3; ++k) ti[k] = -ti[k];

  const int64_t j = a.pair_j == nullptr ? 0 : a.pair_j[pair];
  const bool row_ok = j >= 0 && j < a.S;
  const int v = a.v, gd = a.gd, h = gd / 2;
  const int64_t v3 = (int64_t)v * v * v;
  const int32_t* table = a.table + (row_ok ? j : 0) * (int64_t)gd * gd * gd;
  const int64_t row0 = (row_ok ? j : 0) * (int64_t)a.R;

  float hs[kFull ? kH : 1], bs[kFull ? 12 : 1];
#pragma unroll
  for (int k = 0; k < (kFull ? kH : 1); ++k) hs[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < (kFull ? 12 : 1); ++k) bs[k] = 0.0f;
  float cost = 0.0f;
  int n = 0;

  const int64_t base = (int64_t)pair * a.Q;
  for (int q = t; q < a.Q; q += kThreads) {
    const int64_t e = base + q;
    const float p[3] = {__ldg(a.pts + 3 * e), __ldg(a.pts + 3 * e + 1),
                        __ldg(a.pts + 3 * e + 2)};
    float pw[3], pb[3];
    quat_rotate(qa, p, pw);
#pragma unroll
    for (int k = 0; k < 3; ++k) pw[k] = pw[k] + ta[k];
    quat_rotate(qi, pw, pb);
#pragma unroll
    for (int k = 0; k < 3; ++k) pb[k] = pb[k] + ti[k];

    int v0[3];
    float f[3], g1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = pb[k] * a.inv_s - 0.5f;
      v0[k] = (int)floorf(x);
      f[k] = x - (float)v0[k];
      g1[k] = 1.0f - f[k];
    }

    // the 8 corners' pool rows first, so their reads are in flight together
    int64_t flat[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d[3] = {c >> 2, (c >> 1) & 1, c & 1};
      int blk[3], lv[3];
      bool in_grid = row_ok;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int vc = v0[k] + d[k];
        blk[k] = floor_div(vc, v);
        lv[k] = vc - blk[k] * v;
        in_grid = in_grid && blk[k] >= -h && blk[k] < h;
      }
      int row = -1;
      if (in_grid)
        row = __ldg(table + ((int64_t)(blk[0] + h) * gd + (blk[1] + h)) * gd +
                    (blk[2] + h));
      flat[c] = row >= 0
                    ? (row0 + row) * v3 + (lv[0] * v + lv[1]) * v + lv[2]
                    : -1;
    }
    float s[8], w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[c] = flat[c] >= 0 ? __ldg(a.sdf + flat[c]) : a.truncation;
      w[c] = flat[c] >= 0 ? __ldg(a.weight + flat[c]) : 0.0f;
    }

    float acc = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
    bool valid = true;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d[3] = {c >> 2, (c >> 1) & 1, c & 1};
      float wt[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) wt[k] = d[k] ? f[k] : g1[k];
      acc = acc + wt[0] * wt[1] * wt[2] * s[c];
      const float t0 = wt[1] * wt[2] * s[c];
      const float t1 = wt[0] * wt[2] * s[c];
      const float t2 = wt[0] * wt[1] * s[c];
      grad[0] = d[0] ? grad[0] + t0 : grad[0] - t0;
      grad[1] = d[1] ? grad[1] + t1 : grad[1] - t1;
      grad[2] = d[2] ? grad[2] + t2 : grad[2] - t2;
      valid = valid && flat[c] >= 0 && w[c] > 0.0f;
    }
    valid = valid && a.mask_a[e] != 0;
    if (!valid) continue;

    const float r = acc - __ldg(a.sdf_a + e);
    // torch.clamp keeps a NaN
    float ar = fabsf(r);
    ar = ar != ar ? ar : fmaxf(ar, 1e-9f);
    float wh = (1.0f / ar) * a.delta;
    wh = wh != wh ? wh : fminf(wh, 1.0f);
    cost += wh * r * r;
    ++n;
    if constexpr (kFull) {
      float g[3], hb[3], hv[3], J[12];
#pragma unroll
      for (int k = 0; k < 3; ++k) g[k] = grad[k] * a.inv_s;
      quat_rotate(qb, g, hb);
      quat_rotate(qca, hb, hv);
      cross(p, hv, J);
#pragma unroll
      for (int k = 0; k < 3; ++k) J[3 + k] = hv[k];
      cross(g, pb, J + 6);
#pragma unroll
      for (int k = 0; k < 3; ++k) J[9 + k] = -g[k];
      int m = 0;
#pragma unroll
      for (int x = 0; x < 12; ++x) {
        const float wj = wh * J[x];
        bs[x] += r * wj;
#pragma unroll
        for (int y = x; y < 12; ++y) hs[m++] += wj * J[y];
      }
    }
  }

  // the CTA's sums: the warp's by a fixed butterfly, then warp by warp
#pragma unroll
  for (int k = 0; k < (kFull ? kH : 0); ++k) hs[k] = warp_sum(hs[k]);
#pragma unroll
  for (int k = 0; k < (kFull ? 12 : 0); ++k) bs[k] = warp_sum(bs[k]);
  cost = warp_sum(cost);
  n = warp_sum(n);
  if (lane == 0) {
    if constexpr (kFull) {
#pragma unroll
      for (int k = 0; k < kH; ++k) part[warp][k] = hs[k];
#pragma unroll
      for (int k = 0; k < 12; ++k) part[warp][kH + k] = bs[k];
      part[warp][kSums - 1] = cost;
    } else {
      part[warp][0] = cost;
    }
    part_n[warp] = n;
  }
  __syncthreads();

  const int n_sums = kFull ? kSums : 1;
  if (t < n_sums) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][t];
    if (t == n_sums - 1) {
      a.cost[pair] = 0.5f * sum;
    } else if (t >= kH) {
      a.b[12 * (int64_t)pair + (t - kH)] = sum;
    } else {
      // t -> (x, y), x <= y, in the accumulation's row-major order
      int x = 0, m = t;
      while (m >= 12 - x) {
        m -= 12 - x;
        ++x;
      }
      const int y = x + m;
      float* Hp = a.H + 144 * (int64_t)pair;
      Hp[12 * x + y] = sum;
      Hp[12 * y + x] = sum;
    }
  }
  if (t == kThreads - 1) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part_n[w];
    a.n_valid[pair] = sum;
  }
}

}  // namespace

extern "C" {

// Launches the terms of P registration pairs on `stream` (one launch) and
// returns cudaGetLastError() (0 on success). Allocates nothing and does not
// synchronise. H (P, 12, 12) and b (P, 12) are written in full, or both
// are null for the cost-only form; cost (P,) and n_valid (P,) always. A
// pair whose pair_j lies outside [0, S) finds no block and contributes
// nothing. P >= 1, Q >= 0, S, R, v >= 1 and an even gd >= 2, else
// cudaErrorInvalidValue.
int cox_registration_terms(const float* sdf, const float* weight,
                           const int32_t* table, const int64_t* pair_j,
                           const float* pts, const float* sdf_a,
                           const uint8_t* mask_a, const float* ta,
                           const float* tb, float* H, float* b, float* cost,
                           int32_t* n_valid, int P, int Q, int S, int R,
                           int v, int gd, float inv_s, float truncation,
                           float delta, void* stream) {
  if (P < 1 || Q < 0 || S < 1 || R < 1 || v < 1 || gd < 2 || gd % 2 ||
      (H == nullptr) != (b == nullptr) || cost == nullptr ||
      n_valid == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{sdf, weight, table, pair_j, pts, sdf_a, mask_a, ta, tb,
               H, b, cost, n_valid, P, Q, S, R, v, gd, inv_s, truncation,
               delta};
  const cudaStream_t s = (cudaStream_t)stream;
  if (H != nullptr)
    registration_terms_kernel<true><<<P, kThreads, 0, s>>>(a);
  else
    registration_terms_kernel<false><<<P, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
