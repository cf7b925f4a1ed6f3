// The one-token decode attention (flash-decode) body shared by the dense
// and the paged decode kernels (decode_attention.cu,
// paged_decode_attention.cu). The two differ only in where key position j
// of row b lives, which a row-address policy gives:
//
//   struct Rows {
//     __device__ int limit() const;               // positions a row can hold
//     __device__ size_t row(int b, int hk, int j) const;  // [.., Hk] row
//   };
//
// row() indexes the [.., Hk, D] K/V tensors (times D) and the [.., Hk, 1]
// int8 scales. One block serves all H/Hk query heads of KV head hk of row
// b, so a GQA group streams its keys and values once. The valid length is
// clamped to [0, limit()]: stopped and free serving rows keep advancing
// their cursor past the end. The loop stops at that length (it reads only
// the valid entries); each warp runs an f32 online softmax over every
// kDecodeWarps-th key, and the warps' partial (max, sum, acc) merge in
// shared memory. int8 entries are dequantized in the load. A row with
// length 0 gives exactly 0 (l == 0 -> acc / max(l, 1e-30) == 0).
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int kDecodeWarps = 8;
constexpr int kDecodeMaxRep = 8;  // query heads per KV head (H / Hk)

template <typename TQ, typename TKV, int D, typename Rows>
__device__ __forceinline__ void decode_attention_body(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ length,
    TQ* __restrict__ out, int H, int Hk, float sm_scale, const Rows& rows) {
  constexpr int E = D / 32;  // head-dim elements per lane
  constexpr int W = kDecodeWarps, R = kDecodeMaxRep;
  __shared__ float sm_m[W][R];
  __shared__ float sm_l[W][R];
  __shared__ float sm_acc[W][R][D];

  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int rep = H / Hk;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int len = min(max(length[b], 0), rows.limit());

  float qr[R][E], acc[R][E], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = r < rep
          ? to_f32(q[((size_t)b * H + hk * rep + r) * D + lane * E + e])
          : 0.f;
    }
  }

  for (int j = warp; j < len; j += W) {
    const size_t row = rows.row(b, hk, j);
    const float ks = k_scale ? k_scale[row] : 1.f;
    const float vs = v_scale ? v_scale[row] : 1.f;
    float kv[E], vv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kv[e] = to_f32(k[row * D + lane * E + e]) * ks;
      vv[e] = to_f32(v[row * D + lane * E + e]) * vs;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rep) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qr[r][e], kv[e], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= sm_scale;
      const float m_new = fmaxf(m[r], s);
      const float corr = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = acc[r][e] * corr + p * vv[e];
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();

  for (int r = warp; r < rep; r += W) {
    float mx = kNegInf;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
    for (int w = 0; w < W; ++w) {
      const float f = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] += sm_acc[w][r][lane * E + e] * f;
    }
    const float denom = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[((size_t)b * H + hk * rep + r) * D + lane * E + e] =
          from_f32<TQ>(o[e] / denom);
  }
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls launch(TypeTag<TQ>, TypeTag<TKV>, std::integral_constant<int, D>)
// for q in f32 (q_bf16 = 0) or bf16, KV in q's type or int8 (kv_int8 = 1),
// and head dim D in {32, 64, 128}; returns the launch's cudaError_t.
template <typename TQ, typename TKV, typename F>
int decode_dispatch_d(int D, F& launch) {
  switch (D) {
    case 32:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{}, std::integral_constant<int, 32>{});
      break;
    case 64:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{}, std::integral_constant<int, 64>{});
      break;
    case 128:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{},
             std::integral_constant<int, 128>{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int decode_dispatch(int q_bf16, int kv_int8, int D, F launch) {
  if (q_bf16)
    return kv_int8 ? decode_dispatch_d<__nv_bfloat16, int8_t>(D, launch)
                   : decode_dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, launch);
  return kv_int8 ? decode_dispatch_d<float, int8_t>(D, launch)
                 : decode_dispatch_d<float, float>(D, launch);
}
