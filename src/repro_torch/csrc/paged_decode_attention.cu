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
// (decode_attention_body.cuh: split-KV, 16-byte cp.async loads, merge in
// the same launch); only the row address differs. The TPU kernel gathers
// a whole block per grid step through scalar prefetch; here each block
// stages the table entries of its key range in shared memory, one read
// per bs-key block, so a key's row address costs no global load.

#include "decode_attention_body.cuh"

namespace {

// Position j of row b: offset j % bs of pool block tables[b, j / bs]
// (clamped into the pool) of a [NB, bs, Hk, ...] pool. stage() copies the
// table entries of keys [j0, j1) into tab, entry j / bs at (j / bs) %
// kDecodeTable: a split spans at most kDecodeTable blocks (the host keeps
// split_len <= (kDecodeTable - 1) * bs).
struct PagedRows {
  const int* tables;
  int Hk, NB, bs, MB;
  __device__ int limit() const { return MB * bs; }
  __device__ void stage(int b, int j0, int j1, int* tab) const {
    if (j0 >= j1) return;
    const int first = j0 / bs, n = (j1 - 1) / bs - first + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tab[(first + i) % kDecodeTable] =
          min(max(tables[(size_t)b * MB + first + i], 0), NB - 1);
  }
  __device__ size_t row(int b, int hk, int j, const int* tab) const {
    return ((size_t)tab[(j / bs) % kDecodeTable] * bs + j % bs) * Hk + hk;
  }
};

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ length, TQ* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int H, int Hk, int NB, int bs, int MB, int split_len,
                    float scale_log2) {
  decode_attention_body<TQ, TKV, D, R>(
      q, k, v, k_scale, v_scale, length, out, part, counters, H, Hk,
      split_len, scale_log2, PagedRows{block_tables, Hk, NB, bs, MB});
}

}  // namespace

// q/out: [B,H,D] f32 (q_bf16 = 0) or bf16; k/v: [NB,bs,Hk,D] pools in q's
// type, or int8 (kv_int8 = 1) with k_scale/v_scale [NB,bs,Hk,1] f32;
// block_tables: [B,MB] int32 pool block ids; length: [B] int32. The keys
// split, and the query heads group, as in decode_attention_launch
// (n_split * split_len >= MB * bs, split_len <= (kDecodeTable - 1) * bs).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* block_tables, const int* length,
    void* out, float* part, int* counters, int B, int H, int Hk, int D,
    int NB, int bs, int MB, int q_bf16, int kv_int8, int n_split,
    int split_len, float sm_scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk || NB <= 0 ||
      bs <= 0 || MB <= 0 ||
      !decode_split_ok(MB * bs, n_split, split_len, part, counters) ||
      (long long)split_len > (long long)(kDecodeTable - 1) * bs ||
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
        paged_decode_kernel<TQ, TKV, decltype(d)::value, decltype(r)::value>
            <<<dim3(B * Hk * decode_groups(H / Hk), n_split), kDecodeThreads,
               0, s>>>(
                static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                static_cast<const TKV*>(v), ks, vs, block_tables, length,
                static_cast<TQ*>(out), part, counters, H, Hk, NB, bs, MB,
                split_len, scale_log2);
      });
}
