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
// group's keys and values once in 16-byte loads through a cp.async ring,
// fuses the int8 dequantization, and splits each row's keys across
// blocks (merged in the same launch) so that the loads of the whole card
// are in flight at once, whatever the rows' lengths.

#include "decode_attention_body.cuh"

namespace {

// Position j of row b in a dense [B, S, Hk, ...] cache.
struct DenseRows {
  int S, Hk;
  __device__ int limit() const { return S; }
  __device__ void stage(int, int, int, int*) const {}
  __device__ size_t row(int b, int hk, int j, const int*) const {
    return ((size_t)b * S + j) * Hk + hk;
  }
};

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ length, TQ* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters,
                        int S, int H, int Hk, int split_len,
                        float scale_log2) {
  decode_attention_body<TQ, TKV, D, R>(q, k, v, k_scale, v_scale, length, out,
                                       part, counters, H, Hk, split_len,
                                       scale_log2, DenseRows{S, Hk});
}

}  // namespace

// q/out: [B,H,D] f32 (q_bf16 = 0) or bf16; k/v: [B,S,Hk,D] in q's type, or
// int8 (kv_int8 = 1) with k_scale/v_scale [B,S,Hk,1] f32; length: [B] int32.
// The keys split into n_split ranges of split_len (n_split * split_len >=
// S); with n_split > 1, part is an f32 scratch of rows*n_split*gs*(D+1)
// floats and counters rows int32 zeros (left zero), where rows = B*Hk*n_grp
// and n_grp, gs = decode_groups(H/Hk), decode_group_size(H/Hk). Any ratio
// H/Hk; D in {16, 32, 64, 128}.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* length, void* out, float* part,
    int* counters, int B, int S, int H, int Hk, int D, int q_bf16,
    int kv_int8, int n_split, int split_len, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || H % Hk ||
      !decode_split_ok(S, n_split, split_len, part, counters) ||
      (kv_int8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = kv_int8 ? k_scale : nullptr;
  const float* vs = kv_int8 ? v_scale : nullptr;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  return decode_dispatch(
      q_bf16, kv_int8, H / Hk, D, [&](auto tq, auto tkv, auto d, auto r) {
        using TQ = typename decltype(tq)::type;
        using TKV = typename decltype(tkv)::type;
        decode_attention_kernel<TQ, TKV, decltype(d)::value,
                                decltype(r)::value>
            <<<dim3(B * Hk * decode_groups(H / Hk), n_split), kDecodeThreads,
               0, s>>>(
                static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                static_cast<const TKV*>(v), ks, vs, length,
                static_cast<TQ*>(out), part, counters, S, H, Hk, split_len,
                scale_log2);
      });
}
