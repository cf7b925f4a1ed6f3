// The one-token decode attention (flash-decode) body shared by the dense
// and the paged decode kernels (decode_attention.cu,
// paged_decode_attention.cu). The two differ only in where key position j
// of row b lives, which a row-address policy gives:
//
//   struct Rows {
//     __device__ int limit() const;               // positions a row can hold
//     // before a block reads keys [j0, j1) of row b (all its threads call
//     // it, a __syncthreads follows): stage what row() needs in `tab`
//     __device__ void stage(int b, int j0, int j1, int* tab) const;
//     __device__ size_t row(int b, int hk, int j, const int* tab) const;
//   };
//
// row() indexes the [.., Hk, D] K/V tensors (times D) and the [.., Hk, 1]
// int8 scales. The valid length is clamped to [0, limit()]: stopped and
// free serving rows keep advancing their cursor past the end.
//
// Query-head groups. A block holds at most kDecodeMaxRep query heads in
// registers, so the rep = H/Hk query heads of a KV head split into
// n_grp = ceil(rep / kDecodeMaxRep) groups of gs = ceil(rep / n_grp) (the
// last may be smaller; decode_groups). Each group's blocks read the same
// KV rows: a ratio of 16 reads them twice, but q is never copied.
//
// Split-KV. The grid is (B * Hk * n_grp, n_split): block ((b * Hk + hk) *
// n_grp + g, s) serves query heads g * gs .. of KV head hk of row b (a
// GQA group streams its keys and values once, its query heads in
// registers) over keys [s * split_len, (s + 1) * split_len) of the
// clamped length. The host
// picks n_split and split_len from shapes alone (never from `length`, which
// lives on the device): enough blocks to fill the card. A split that
// starts past its row's length reads nothing and writes an empty partial.
//
// Loads. Each of the 4 warps walks every 4th warp tile of the block's
// range, 16 bytes per lane per load (8 lanes per bf16 row of d = 64, 4 per
// int8 row), through a 2-stage cp.async ring in shared memory per warp:
// the next tile's K, V (and int8 scales) are in flight while the warp
// computes the current one, and no register holds them in flight. Paged
// rows read their block table once per bs-key block: the block stages the
// table entries of its range in shared memory (clamped into the pool).
//
// Scores. A warp computes a whole tile of scores (partial dot products
// over each lane's 16 bytes, summed over the row's lanes by shuffles) in
// log2 units (q is pre-scaled by sm_scale * log2(e)), then takes one max,
// one rescale and one exp2f per score. int8 entries are dequantized after
// the load.
//
// Merge. The warps' (max, sum, acc) merge in shared memory into the
// block's partial. With one split the block writes the output; otherwise
// it writes its normalized partial and log2-sum-exp (-1e30 if empty) to
// an f32 scratch, and the last of the row's splits to arrive (an atomic
// counter per (b, hk, group), which it resets to 0 for the next launch) merges
// them in the same launch; an empty partial weighs exactly 0. A row with
// length 0 gives exactly 0 (every split empty: 0 / max(0, 1e-30) == 0).
// The merges give each lane D / 32 output elements, or one element to each
// of the first D lanes at D = 16.
//
// Decode stays on the CUDA cores: H/Hk = 3 query rows per KV head are far
// below wgmma's 64 rows, and the bound is the bytes of the valid KV.
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeMaxRep = 8;   // query heads a block holds (a group)
constexpr int kDecodeStages = 2;   // cp.async ring depth per warp
constexpr int kDecodeTable = 256;  // staged block-table entries (paged)

// Query-head groups of a KV head with rep = H / Hk query heads.
__host__ __device__ inline int decode_groups(int rep) {
  return (rep + kDecodeMaxRep - 1) / kDecodeMaxRep;
}
__host__ __device__ inline int decode_group_size(int rep) {
  const int n = decode_groups(rep);
  return (rep + n - 1) / n;
}

// One warp tile of keys: each lane loads 16 bytes of a key row per load.
template <typename TKV, int D, int R>
struct DecodeTile {
  static constexpr int kVec = 16 / sizeof(TKV);     // elements per load
  static constexpr int kLanes = D / kVec;           // lanes per key row
  static constexpr int kKeysPerLoad = 32 / kLanes;
  // loads per tensor: up to 32 elements of a tensor per lane in flight,
  // half that with 8 query heads in registers
  static constexpr int kLoads =
      (32 / kVec < 4 ? 32 / kVec : 4) / (R > 4 && kVec < 16 ? 2 : 1);
  static constexpr int kKeys = kKeysPerLoad * kLoads;
  // K, V chunks [kLoads][32 lanes][16 B], then the K and V scales [kKeys]
  static constexpr int kStage = 2 * kLoads * 512 + 2 * kKeys * 4;
};

// 16 bytes of TKV as f32
template <typename TKV>
__device__ __forceinline__ void unpack16(const uint8_t* src,
                                         float (&f)[16 / sizeof(TKV)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const TKV* x = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(TKV); ++e) f[e] = to_f32(x[e]);
}

template <typename TQ, typename TKV, int D, int R, typename Rows>
__device__ __forceinline__ void decode_attention_body(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ length,
    TQ* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
    int H, int Hk, int split_len, float scale_log2, const Rows& rows) {
  using Tl = DecodeTile<TKV, D, R>;
  constexpr int W = kDecodeWarps, U = Tl::kLoads, L = Tl::kLanes;
  constexpr int KPL = Tl::kKeysPerLoad, KEYS = Tl::kKeys, VEC = Tl::kVec;
  // output elements per lane in the merges: D / 32, or 1 on D lanes
  constexpr int E = D >= 32 ? D / 32 : 1;
  constexpr int kRing = kDecodeStages * W * Tl::kStage;
  constexpr int kMerge = W * R * (D + 2) * 4;
  __shared__ __align__(16) uint8_t smem[kRing > kMerge ? kRing : kMerge];
  __shared__ int tab[kDecodeTable];
  __shared__ int last;

  const int rep = H / Hk, n_grp = decode_groups(rep);
  const int gs = decode_group_size(rep);
  const int row_id = blockIdx.x, bhk = row_id / n_grp, qg = row_id % n_grp;
  const int b = bhk / Hk, hk = bhk % Hk;
  const int h0 = hk * rep + qg * gs;           // this block's first head
  const int nr = min(gs, rep - qg * gs);       // and its number of heads
  const int split = blockIdx.y, n_split = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool out_lane = lane * E < D;          // holds output elements
  const int len = min(max(length[b], 0), rows.limit());
  const int j0 = split * split_len, j1 = min(j0 + split_len, len);
  rows.stage(b, j0, j1, tab);
  __syncthreads();

  // lane: elements sub * VEC .. + VEC of key grp (+ KPL per load)
  const int sub = lane % L, grp = lane / L;
  float qr[R][VEC], acc[R][VEC], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = r < nr ? to_f32(q[((size_t)b * H + h0 + r) * D +
                                   sub * VEC + e]) * scale_log2
                        : 0.f;
    }
  }

  const int n_tiles = j1 > j0 ? (j1 - j0 + KEYS - 1) / KEYS : 0;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + W - 1) / W : 0;
  uint8_t* ring = smem + warp * kDecodeStages * Tl::kStage;
  auto issue = [&](int i) {   // this warp's tile i into stage i % 2
    const int jt = j0 + (warp + i * W) * KEYS;
    uint8_t* st = ring + (i % kDecodeStages) * Tl::kStage;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jt + u * KPL + grp;
      const bool ok = j < j1;
      const size_t row = rows.row(b, hk, ok ? j : j0, tab);
      cp_async16(st + (u * 32 + lane) * 16, k + row * D + sub * VEC, ok);
      cp_async16(st + U * 512 + (u * 32 + lane) * 16, v + row * D + sub * VEC,
                 ok);
      if (k_scale != nullptr && sub == 0) {
        float* sc = reinterpret_cast<float*>(st + 2 * U * 512);
        cp_async4(sc + u * KPL + grp, k_scale + row, ok);
        cp_async4(sc + KEYS + u * KPL + grp, v_scale + row, ok);
      }
    }
    cp_async_commit();
  };

  if (my_tiles > 0) issue(0);
  for (int i = 0; i < my_tiles; ++i) {
    __syncwarp();   // the stage issue() refills was read at i - 1
    if (i + 1 < my_tiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();   // every lane's copies (the scales) have landed
    const uint8_t* st = ring + (i % kDecodeStages) * Tl::kStage;
    const float* sc = reinterpret_cast<const float*>(st + 2 * U * 512);
    const int jt = j0 + (warp + i * W) * KEYS;

    float s[R][U], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack16<TKV>(st + (u * 32 + lane) * 16, kf);
      unpack16<TKV>(st + U * 512 + (u * 32 + lane) * 16, vf[u]);
      const float ks = k_scale != nullptr ? sc[u * KPL + grp] : 1.f;
      if (k_scale != nullptr) {
        const float vs = sc[KEYS + u * KPL + grp];
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[u][e] *= vs;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qr[r][e], kf[e], d);
        s[r][u] = d * ks;
      }
    }
    // whole-row dot products: sum over the row's L lanes
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          s[r][u] += __shfl_xor_sync(0xffffffffu, s[r][u], o);
        if (jt + u * KPL + grp >= j1) s[r][u] = kNegInf;
      }
      // one max over the warp's tile (every key group), one rescale
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[r][u]);
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // a tile holds at least one valid key, so m_new is finite here and
      // a masked score's exp2f(-1e30 - m_new) is 0
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[r][u] - m_new);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[u][e], acc[r][e]);
      }
    }
  }

  // the warp's key groups share m: sum their l and acc
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  __syncthreads();   // every warp is done with its ring: reuse it
  float* sm_m = reinterpret_cast<float*>(smem);   // [W][R]
  float* sm_l = sm_m + W * R;                      // [W][R]
  float* sm_acc = sm_l + W * R;                    // [W][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) break;
    if (lane < L) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(warp * R + r) * D + sub * VEC + e] = acc[r][e];
    }
    if (lane == 0) {
      sm_m[warp * R + r] = m[r];
      sm_l[warp * R + r] = l[r];
    }
  }
  __syncthreads();

  const size_t slot = (size_t)row_id * n_split;
  float* part_lse = part + (size_t)gridDim.x * n_split * gs * D;
  for (int r = warp; r < nr; r += W) {
    float mx = kNegInf;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, sm_m[w * R + r]);
    float lsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
    for (int w = 0; w < W; ++w) {
      // a warp without keys has l == 0 and acc == 0
      const float f = exp2f(sm_m[w * R + r] - mx);
      lsum += sm_l[w * R + r] * f;
      if (out_lane) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] += sm_acc[(w * R + r) * D + lane * E + e] * f;
      }
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (n_split == 1) {
      if (out_lane) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[((size_t)b * H + h0 + r) * D + lane * E + e] =
              from_f32<TQ>(o[e] * inv);
      }
    } else {
      if (out_lane) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          part[((slot + split) * gs + r) * D + lane * E + e] = o[e] * inv;
      }
      if (lane == 0)
        part_lse[(slot + split) * gs + r] =
            lsum > 0.f ? mx + log2f(lsum) : kNegInf;
    }
  }
  if (n_split == 1) return;

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[row_id], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last split of (b, hk, group) to arrive merges every split's partial
  for (int r = warp; r < nr; r += W) {
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(part_lse + (slot + s) * gs + r));
    float wsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float lse = __ldcg(part_lse + (slot + s) * gs + r);
      const float w = lse == kNegInf ? 0.f : exp2f(lse - mx);
      wsum += w;
      if (out_lane) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = fmaf(
              w, __ldcg(part + ((slot + s) * gs + r) * D + lane * E + e),
              o[e]);
      }
    }
    const float inv = 1.f / fmaxf(wsum, 1e-30f);
    if (out_lane) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        out[((size_t)b * H + h0 + r) * D + lane * E + e] =
            from_f32<TQ>(o[e] * inv);
    }
  }
  if (threadIdx.x == 0) counters[row_id] = 0;
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls launch(TypeTag<TQ>, TypeTag<TKV>, std::integral_constant<int, D>,
// std::integral_constant<int, R>) for q in f32 (q_bf16 = 0) or bf16, KV in
// q's type or int8 (kv_int8 = 1), head dim D in {16, 32, 64, 128} and R = 4
// query heads of a group in registers (gs <= 4) or 8; returns the
// launch's cudaError_t.
template <typename TQ, typename TKV, int R, typename F>
int decode_dispatch_d(int D, F& launch) {
  switch (D) {
    case 16:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{}, std::integral_constant<int, 16>{},
             std::integral_constant<int, R>{});
      break;
    case 32:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{}, std::integral_constant<int, 32>{},
             std::integral_constant<int, R>{});
      break;
    case 64:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{}, std::integral_constant<int, 64>{},
             std::integral_constant<int, R>{});
      break;
    case 128:
      launch(TypeTag<TQ>{}, TypeTag<TKV>{},
             std::integral_constant<int, 128>{},
             std::integral_constant<int, R>{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, typename F>
int decode_dispatch_r(int gs, int D, F& launch) {
  return gs <= 4 ? decode_dispatch_d<TQ, TKV, 4>(D, launch)
                 : decode_dispatch_d<TQ, TKV, kDecodeMaxRep>(D, launch);
}

// rep = H / Hk query heads per KV head, any count: the blocks hold its
// groups (decode_group_size(rep) heads each)
template <typename F>
int decode_dispatch(int q_bf16, int kv_int8, int rep, int D, F launch) {
  const int gs = decode_group_size(rep);
  if (q_bf16)
    return kv_int8
        ? decode_dispatch_r<__nv_bfloat16, int8_t>(gs, D, launch)
        : decode_dispatch_r<__nv_bfloat16, __nv_bfloat16>(gs, D, launch);
  return kv_int8 ? decode_dispatch_r<float, int8_t>(gs, D, launch)
                 : decode_dispatch_r<float, float>(gs, D, launch);
}

// Checks shared by the two launch functions: the splits cover every
// position a row can hold, and a split has its scratch and counters.
inline bool decode_split_ok(int limit, int n_split, int split_len,
                            const float* part, const int* counters) {
  return n_split >= 1 && n_split <= 65535 && split_len >= 1 &&
         (long long)n_split * split_len >= limit &&
         (n_split == 1 || (part != nullptr && counters != nullptr));
}
