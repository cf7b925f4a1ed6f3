// One-token decode attention (flash-decode) with GQA and an optional int8
// KV cache, for Hopper.
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// decode_attention.py:71; body _decode_kernel :28). q [B,H,d] attends to
// the first length[b] positions of a dense cache [B,S,Hk,d] (bf16/f32, or
// int8 codes times per-(position, head) f32 scales [B,S,Hk,1]). The valid
// length is clamped to [0, S] here: stopped and free serving slots keep
// advancing their cursor past the cache end. A row with length 0 gives
// exactly 0 (the online softmax's l == 0 -> acc / max(l, 1e-30) == 0).
//
// What bounds it on an H100: bytes. Per step it reads each valid KV entry
// once for O(d) operations. The design reads only the valid prefix (the
// loop stops at the clamped length instead of masking the whole cache),
// and one block serves all H/Hk query heads of a KV head, so a GQA group
// streams its keys and values once. Each warp runs an online softmax over
// every WARPS-th key; the warps' partial (max, sum, acc) are merged in
// shared memory. The dequantization of int8 entries is fused into the
// load.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRep = 8;  // query heads per KV head (H / Hk)

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ length, TQ* __restrict__ out,
                        int S, int H, int Hk, float sm_scale) {
  constexpr int E = D / 32;  // head-dim elements per lane
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][D];

  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int rep = H / Hk;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int len = min(max(length[b], 0), S);

  float qr[kMaxRep][E], acc[kMaxRep][E], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
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

  for (int j = warp; j < len; j += kWarps) {
    const size_t row = ((size_t)b * S + j) * Hk + hk;
    const float ks = k_scale ? k_scale[row] : 1.f;
    const float vs = v_scale ? v_scale[row] : 1.f;
    float kv[E], vv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kv[e] = to_f32(k[row * D + lane * E + e]) * ks;
      vv[e] = to_f32(v[row * D + lane * E + e]) * vs;
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
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
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();

  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
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

template <typename TQ, typename TKV>
int launch_d(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* length, void* out, int B, int S,
             int H, int Hk, int D, float sm_scale, cudaStream_t stream) {
  const dim3 grid(B * Hk), block(kWarps * 32);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  TQ* ot = static_cast<TQ*>(out);
  switch (D) {
    case 32:
      decode_attention_kernel<TQ, TKV, 32><<<grid, block, 0, stream>>>(
          qt, kt, vt, ks, vs, length, ot, S, H, Hk, sm_scale);
      break;
    case 64:
      decode_attention_kernel<TQ, TKV, 64><<<grid, block, 0, stream>>>(
          qt, kt, vt, ks, vs, length, ot, S, H, Hk, sm_scale);
      break;
    case 128:
      decode_attention_kernel<TQ, TKV, 128><<<grid, block, 0, stream>>>(
          qt, kt, vt, ks, vs, length, ot, S, H, Hk, sm_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [B,H,D] f32 (q_bf16 = 0) or bf16; k/v: [B,S,Hk,D] in q's type, or
// int8 (kv_int8 = 1) with k_scale/v_scale [B,S,Hk,1] f32; length: [B] int32.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const float* k_scale,
                                       const float* v_scale, const int* length,
                                       void* out, int B, int S, int H, int Hk,
                                       int D, int q_bf16, int kv_int8,
                                       float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || H / Hk > kMaxRep ||
      (kv_int8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_int8)
      return launch_d<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, length,
                                             out, B, S, H, Hk, D, sm_scale, s);
    return launch_d<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, length, out, B, S, H, Hk, D, sm_scale, s);
  }
  if (kv_int8)
    return launch_d<float, int8_t>(q, k, v, k_scale, v_scale, length, out, B,
                                   S, H, Hk, D, sm_scale, s);
  return launch_d<float, float>(q, k, v, nullptr, nullptr, length, out, B, S,
                                H, Hk, D, sm_scale, s);
}
