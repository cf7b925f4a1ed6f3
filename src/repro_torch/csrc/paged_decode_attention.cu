// One-token decode attention through a block-paged KV pool (flash-decode
// through block tables), with GQA and an optional int8 KV pool, for Hopper.
//
// Replaces the TPU kernel paged_decode_attention_pallas (src/repro/kernels/
// paged_decode_attention.py:81; body _paged_decode_kernel :33). q [B,H,d]
// attends to the first length[b] positions of row b's logical sequence,
// whose position p lives in pool block block_tables[b, p / bs] at offset
// p % bs of k/v [NB,bs,Hk,d] (bf16/f32, or int8 codes times f32 scales
// [NB,bs,Hk,1] read through the same table). Identical prompt prefixes
// share pool blocks, so this is the KV side of the paper's computation
// reuse. The length is clamped to [0, MB*bs]: stopped serving rows keep
// advancing their cursor past their table. Table entries past the length
// are never read (trash block 0 by convention); a row with length 0 gives
// exactly 0 (l == 0 -> acc / max(l, 1e-30) == 0).
//
// What bounds it on an H100: bytes. Each valid KV entry is read once per
// GQA group for O(d) operations. The body is the dense decode kernel's
// (decode_attention_body.cuh); only the row address differs: the table
// lookup adds one cached 4-byte load per key. The TPU kernel gathers a
// whole block per grid step through scalar prefetch; here each key's row
// address is computed from the table in the loop.

#include "decode_attention_body.cuh"

namespace {

// Position j of row b: offset j % bs of pool block tables[b, j / bs]
// (clamped into the pool) of a [NB, bs, Hk, ...] pool.
struct PagedRows {
  const int* tables;
  int Hk, NB, bs, MB;
  __device__ int limit() const { return MB * bs; }
  __device__ size_t row(int b, int hk, int j) const {
    const int blk = min(max(tables[(size_t)b * MB + j / bs], 0), NB - 1);
    return ((size_t)blk * bs + j % bs) * Hk + hk;
  }
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ length, TQ* __restrict__ out,
                    int H, int Hk, int NB, int bs, int MB, float sm_scale) {
  decode_attention_body<TQ, TKV, D>(q, k, v, k_scale, v_scale, length, out, H,
                                    Hk, sm_scale,
                                    PagedRows{block_tables, Hk, NB, bs, MB});
}

}  // namespace

// q/out: [B,H,D] f32 (q_bf16 = 0) or bf16; k/v: [NB,bs,Hk,D] pools in q's
// type, or int8 (kv_int8 = 1) with k_scale/v_scale [NB,bs,Hk,1] f32;
// block_tables: [B,MB] int32 pool block ids; length: [B] int32.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* block_tables, const int* length,
    void* out, int B, int H, int Hk, int D, int NB, int bs, int MB,
    int q_bf16, int kv_int8, float sm_scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk || H / Hk > kDecodeMaxRep || NB <= 0 ||
      bs <= 0 || MB <= 0 || (kv_int8 && (!k_scale || !v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = kv_int8 ? k_scale : nullptr;
  const float* vs = kv_int8 ? v_scale : nullptr;
  return decode_dispatch(q_bf16, kv_int8, D, [&](auto tq, auto tkv, auto d) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    paged_decode_kernel<TQ, TKV, decltype(d)::value>
        <<<B * Hk, kDecodeWarps * 32, 0, s>>>(
            static_cast<const TQ*>(q), static_cast<const TKV*>(k),
            static_cast<const TKV*>(v), ks, vs, block_tables, length,
            static_cast<TQ*>(out), H, Hk, NB, bs, MB, sm_scale);
  });
}
