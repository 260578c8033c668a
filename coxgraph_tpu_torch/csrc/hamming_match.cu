// Brute-force binary-descriptor matching for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel coxgraph_tpu/ops/pallas_kernels.py::_match_kernel
// (launched by hamming_match_topk) and serves the port's match_descriptors
// (coxgraph_tpu/ops/features.py:217-237) on the loop-detection path. Its
// plain torch version is
// coxgraph_tpu_torch/ops/cuda_hamming.py::match_topk_reference.
//
// For one pair (query q, database row j) the distance between query row i
// and database column c is the Hamming distance of two 256-bit BRIEF
// descriptors, 8 x __popc(a ^ b), replaced by `big` when either side is
// invalid. Per query row the kernel keeps the two best columns online, with
// the reference's tie rules:
//   * d1 = min_c D[i, c], i1 = the lowest c reaching it (a strict < update);
//   * d2 = min(excl, min over c != i1 of D[i, c]) -- what setting column i1
//     to `excl` and taking the minimum gives;
// and per column the lowest row reaching the column minimum (best_a), by a
// shared-memory atomicMin on the key (dist << 16) | row, which is exact and
// deterministic because dist < 2^15 and row < 2^16 (checked by the wrapper).
//
// Grid: one CTA per pair. The pair's Kb x 8 words of b are staged in shared
// memory once; each thread owns a row of a (8 words in registers) and walks
// all columns, so every b word is a broadcast read. Rows beyond the block
// size loop. For the column minimum a warp first reduces its 32 keys with
// one redux.sync (__reduce_min_sync), then lane 0 does the shared atomicMin.
//
// What bounds it: the popcounts. At the endurance point (8 queries x 512
// database rows x 384^2 descriptor pairs = 604 M pairs) it issues 4.83 G
// __popc; at 16 per clock per SM that is ~1.15 ms on 132 SMs at 1.98 GHz.
// Bytes are small (6 MB of database descriptors, 25 MB of outputs). The same
// distances as a +-1 bf16 matmul would need ~0.31 ms of tensor-core time;
// this simple kernel does not use the tensor cores.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) hamming_topk_kernel(
    const uint4* __restrict__ a, const uint8_t* __restrict__ a_valid,
    const uint4* __restrict__ b, const uint8_t* __restrict__ b_valid,
    int32_t* __restrict__ d1_out, int32_t* __restrict__ i1_out,
    int32_t* __restrict__ d2_out, int32_t* __restrict__ best_a_out,
    int cap, int ka, int kb, int b_batched, int big, int excl) {
  extern __shared__ uint4 smem[];
  uint4* sb = smem;                                     // (kb, 2) uint4
  int* skey = reinterpret_cast<int*>(sb + 2 * kb);      // (kb,)
  uint8_t* sval = reinterpret_cast<uint8_t*>(skey + kb);  // (kb,)

  const int pair = blockIdx.x;  // q * cap + j
  const int q = pair / cap;
  const int j = pair - q * cap;
  const size_t brow = b_batched ? (size_t)pair : (size_t)j;
  const uint4* gb = b + brow * (size_t)kb * 2;
  for (int c = threadIdx.x; c < 2 * kb; c += blockDim.x) sb[c] = gb[c];
  for (int c = threadIdx.x; c < kb; c += blockDim.x) {
    skey[c] = INT_MAX;
    sval[c] = b_valid == nullptr ? 1 : b_valid[brow * kb + c];
  }
  __syncthreads();

  const bool want_cols = best_a_out != nullptr;
  const int lane = threadIdx.x & 31;
  const int ka_round = (ka + blockDim.x - 1) / blockDim.x * blockDim.x;
  const size_t out_row = (size_t)pair * ka;
  for (int i = threadIdx.x; i < ka_round; i += blockDim.x) {
    // every lane of a warp stays in the loop (for the warp reduction);
    // lanes past the last row carry no row
    const bool row = i < ka;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    bool av = false;
    if (row) {
      const size_t ar = (size_t)q * ka + i;
      a0 = a[2 * ar];
      a1 = a[2 * ar + 1];
      av = a_valid == nullptr || a_valid[ar] != 0;
    }
    int d1 = INT_MAX, i1 = 0, d2 = excl;
    for (int c = 0; c < kb; ++c) {
      const uint4 b0 = sb[2 * c];
      const uint4 b1 = sb[2 * c + 1];
      int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
              __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
              __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
              __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      d = (av && sval[c] != 0) ? d : big;
      if (d < d1) {
        d2 = min(d2, d1);
        d1 = d;
        i1 = c;
      } else {
        d2 = min(d2, d);
      }
      if (want_cols) {
        const int key = __reduce_min_sync(0xffffffffu,
                                          row ? ((d << 16) | i) : INT_MAX);
        if (lane == 0) atomicMin(&skey[c], key);
      }
    }
    if (row) {
      d1_out[out_row + i] = d1;
      i1_out[out_row + i] = i1;
      d2_out[out_row + i] = d2;
    }
  }
  if (want_cols) {
    __syncthreads();
    for (int c = threadIdx.x; c < kb; c += blockDim.x)
      best_a_out[(size_t)pair * kb + c] = skey[c] & 0xffff;
  }
}

}  // namespace

extern "C" {

// Launches the matcher on `stream` and returns cudaGetLastError() (0 on
// success). a (n_q, ka, 8) and b (n_q or 1, cap, kb, 8) hold 32-bit words,
// 16-byte aligned; a_valid (n_q, ka) / b_valid (n_q or 1, cap, kb) are
// bytes, or null for all valid; best_a may be null (not computed).
// Outputs d1, i1, d2 are (n_q, cap, ka) int32, best_a (n_q, cap, kb).
// Allocates nothing and does not synchronise.
int cox_hamming_topk(const void* a, const void* a_valid, const void* b,
                     const void* b_valid, void* d1, void* i1, void* d2,
                     void* best_a, int n_q, int cap, int ka, int kb,
                     int b_batched, int big, int excl, void* stream) {
  if (n_q <= 0 || cap <= 0 || ka <= 0 || kb <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kb * (2 * sizeof(uint4) + sizeof(int) + 1);
  hamming_topk_kernel<<<n_q * cap, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint8_t*>(a_valid),
      static_cast<const uint4*>(b), static_cast<const uint8_t*>(b_valid),
      static_cast<int32_t*>(d1), static_cast<int32_t*>(i1),
      static_cast<int32_t*>(d2), static_cast<int32_t*>(best_a), cap, ka, kb,
      b_batched, big, excl);
  return (int)cudaGetLastError();
}

}  // extern "C"
