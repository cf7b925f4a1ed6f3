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
// once for O(d) operations. The body (decode_attention_body.cuh, shared
// with the paged kernel) reads only the valid prefix, streams each GQA
// group's keys and values once, and fuses the int8 dequantization into
// the load.

#include "decode_attention_body.cuh"

namespace {

// Position j of row b in a dense [B, S, Hk, ...] cache.
struct DenseRows {
  int S, Hk;
  __device__ int limit() const { return S; }
  __device__ size_t row(int b, int hk, int j) const {
    return ((size_t)b * S + j) * Hk + hk;
  }
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ length, TQ* __restrict__ out,
                        int S, int H, int Hk, float sm_scale) {
  decode_attention_body<TQ, TKV, D>(q, k, v, k_scale, v_scale, length, out, H,
                                    Hk, sm_scale, DenseRows{S, Hk});
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
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk || H / Hk > kDecodeMaxRep ||
      (kv_int8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = kv_int8 ? k_scale : nullptr;
  const float* vs = kv_int8 ? v_scale : nullptr;
  return decode_dispatch(q_bf16, kv_int8, D, [&](auto tq, auto tkv, auto d) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    decode_attention_kernel<TQ, TKV, decltype(d)::value>
        <<<B * Hk, kDecodeWarps * 32, 0, s>>>(
            static_cast<const TQ*>(q), static_cast<const TKV*>(k),
            static_cast<const TKV*>(v), ks, vs, length, static_cast<TQ*>(out),
            S, H, Hk, sm_scale);
  });
}
