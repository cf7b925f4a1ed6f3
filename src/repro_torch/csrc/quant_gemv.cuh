// The split-K skeleton of the two quantized-matmul decode kernels
// (axllm_matmul_gemv_launch in axllm_matmul.cu, reuse_matmul_gemv_launch in
// reuse_matmul.cu): y[M,N] = x[M,K] @ deq(codes) for M <= 16.
//
// At decode the work is a few MFLOP against K*N code bytes, so the bound is
// the bytes (1.5 MB at K768 N2048 int8: 0.0005 ms on an H100), and what a
// kernel can do about it is keep many bytes in flight on every SM and
// launch once. Both kernels cut [K, N] into column tiles times K splits,
// enough blocks to fill the card (the host's plan, kernels/axllm_matmul.py
// gemv_plan), and each block issues every 16-byte cp.async of its codes
// before it reads any of them.
//
// The K splits merge in the same launch, in a fixed order: each block
// writes its f32 partial [MT, BN] to an L2-resident scratch, and the last
// block of its tile to arrive (an atomic counter per tile, which that block
// resets to 0 for the next launch) sums splits z = 0 .. S-1 in order and
// writes y in the caller's dtype. No atomics on y, so the bits do not
// change from run to run. This is the merge of decode_attention_body.cuh. A
// thread-block cluster reducing through distributed shared memory was the
// other way; it caps a tile at 8 splits (16 non-portable), too few for
// K2048 N768 or for the reuse kernel's 256-column tiles at N256 to fill 132
// SMs, and the counter merge costs one L2 round trip of 4 to 32 partials.
//
// Scale groups. A split never straddles a group boundary: either it holds
// whole groups and scales each group's sum itself, or it lies inside one
// group (per-channel and per-tensor: the only group) and writes its sum
// unscaled; the merge then adds the group's splits in order and scales
// their total. Either way the scale multiplies a group sum, once.
// ref.quant_gemv_split_ref computes the same association.
#pragma once

#include "common.cuh"

namespace gemv {

constexpr int kThreads = 256;

struct SplitPlan {
  int K, k_per_split, splits, group_rows;

  // the split lies inside a scale group: its sum leaves unscaled
  __device__ __forceinline__ bool defer() const {
    return k_per_split < group_rows;
  }
  __device__ __forceinline__ int group_of(int z) const {
    return z * k_per_split / group_rows;
  }
};

// Host check of a plan: the splits cover [0, K) exactly once and no split
// straddles a group boundary.
inline bool plan_ok(const SplitPlan& p, int n_scale_rows) {
  if (p.K <= 0 || p.k_per_split <= 0 || p.splits < 1 || p.splits > 65535 ||
      (long long)p.splits * p.k_per_split < p.K ||
      (long long)(p.splits - 1) * p.k_per_split >= p.K)
    return false;
  if (n_scale_rows == 1 || p.splits == 1) return true;
  return p.k_per_split % p.group_rows == 0 ||
         p.group_rows % p.k_per_split == 0;
}

__device__ __forceinline__ void store_out(void* y, size_t i, float v,
                                          bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);  // to nearest even
  else
    static_cast<float*>(y)[i] = v;
}

// After every thread of the block wrote its partial: whether this block is
// the last of `splits` to arrive at `counter`. Call from all threads.
__device__ __forceinline__ bool arrive_last(int* counter, int splits) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The fixed-order totals of a thread's R outputs: output r's partial of
// split z at part[z * z_stride + r * r_stride]; a deferred split's group
// total is scaled by scale[g * N + n] at the group's last split. Four
// splits' loads are in flight at a time.
template <int R>
__device__ __forceinline__ void merge(const float* part, size_t z_stride,
                                      size_t r_stride, const SplitPlan& p,
                                      const float* __restrict__ scale, int n,
                                      int N, float (&total)[R]) {
  constexpr int U = 4;
  float group[R];
#pragma unroll
  for (int r = 0; r < R; ++r) total[r] = group[r] = 0.f;
  const bool defer = p.defer();
  auto add = [&](int z, const float (&v)[R]) {
    if (!defer) {
#pragma unroll
      for (int r = 0; r < R; ++r) total[r] += v[r];
      return;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) group[r] += v[r];
    const int g = p.group_of(z);
    if (z == p.splits - 1 || p.group_of(z + 1) != g) {
      const float s = scale[(size_t)g * N + n];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        total[r] += group[r] * s;
        group[r] = 0.f;
      }
    }
  };
  int z = 0;
  for (; z + U <= p.splits; z += U) {
    float v[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[u][r] = __ldcg(part + (size_t)(z + u) * z_stride + r * r_stride);
#pragma unroll
    for (int u = 0; u < U; ++u) add(z + u, v[u]);
  }
  for (; z < p.splits; ++z) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = __ldcg(part + (size_t)z * z_stride + r * r_stride);
    add(z, v);
  }
}

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Sets a kernel's dynamic shared-memory limit when a launch needs more than
// it was set to (once per size, not once per call: decode is host-bound).
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace gemv
