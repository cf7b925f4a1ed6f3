// Causal or non-causal GQA flash attention (forward) for Hopper, two
// entry points: a tensor-core kernel for bf16 at head dim 64 or 128
// (flash_attention_wgmma_launch, the serving path's prefill) and a SIMT
// kernel for the rest (flash_attention_launch: f32, and head dims 16 and
// 32).
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py:81; body _flash_kernel :34). q [B,Sq,H,d] attends to
// k/v [B,Sk,Hk,d]; causal queries sit at the last Sq key positions
// (query i sees keys 0..i+Sk-Sq, so a causal call needs Sq <= Sk), and a
// non-causal query sees every key whatever Sq is (whisper's
// cross-attention: a decoder prompt longer than the frames has Sq > Sk;
// the offset Sk-Sq enters only the causal mask). Query head h reads KV head
// h / (H/Hk). Online softmax in f32; the Sq x Sk scores never reach device
// memory. Ragged edges (Sq or Sk not a multiple of the tile) are masked
// here, so no caller pads. Both kernels skip key tiles that lie wholly
// above a query tile's causal diagonal (about half the work of a causal
// prefill) and mask only the tiles that cross it or the end of the keys.
//
// What bounds it on an H100: at the prefill wave's shapes (Sq = Sk = 512,
// d = 64) the bytes by the card's peaks (12.6 MB against 3.2 GFLOP), but
// only on the tensor cores: on the SIMT cores the f32 operations alone
// need 0.048 ms. The tensor-core kernel (fa:: below):
//   * one block per 64 query rows of one head: a consumer warpgroup and a
//     producer warp. The producer loads the Q tile once and keeps a ring
//     of two K/V stages in flight, all by TMA through 4-D tensor maps over
//     (d, heads, seq, batch) with a box of one head, into 128-byte
//     swizzled shared memory; TMA reads rows past Sq or Sk as zeros;
//   * per key tile S = Q K^T is one chain of wgmma (K K-major in shared
//     memory); the online softmax runs on the accumulator fragment in
//     registers (row max and sum over the 4 threads of a row by shuffles,
//     exp2f with the scale and log2(e) folded into one multiply, one
//     rescale of O per tile); P is rounded to bf16 in registers and is
//     the A operand of O += P V, V the transposed (MN-major) B operand;
//   * every row, the padding rows past Sq too, sees key 0 in its first
//     key tile (causal: Sq <= Sk, queries at the last Sq positions;
//     non-causal: every key), so its max
//     is finite from then on and a masked score (-1e30) weighs exactly 0;
//   * the grid: one block per query tile of 64 rows (the smallest wgmma
//     M) and head, the heaviest causal tiles first: 768 blocks at the
//     prefill wave (B8 Sq512 H12), 96 at B2 Sq256. Splitting a query
//     tile's keys across blocks would fill more SMs at the second, but no
//     caller has Sq << Sk (prefill has Sq == Sk), and on an H100 a two-way
//     split with a merge in the same launch ran slower there, so the
//     kernel does not split.
// The only rounding the f32 SIMT path does not have is P in bf16 before
// P V (kernels/ref.py flash_attention_tc_ref emulates it).

#include "sm90.cuh"

namespace {

// The SIMT kernel: one query row per thread in registers, each K/V tile
// staged once in shared memory (as f32) for all 128 query rows of the
// block, scores in shared memory, every product an f32 fmaf.
constexpr int kBQ = 128;  // query rows per block, one per thread
constexpr int kBKV = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hk, int causal, float sm_scale) {
  __shared__ __align__(16) float ks[kBKV][D];
  __shared__ __align__(16) float vs[kBKV][D];
  __shared__ float ss[kBKV][kBQ];  // this tile's scores, column per thread

  const int t = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + t;
  const int off = Sk - Sq;
  const int qpos = qi + off;
  const bool q_valid = qi < Sq;

  float qr[D], acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    qr[e] = q_valid ? to_f32(q[(((size_t)b * Sq + qi) * H + h) * D + e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  // keys past the last query row's diagonal are masked for every row here
  const int k_end = causal ? min(Sk, min(q0 + kBQ, Sq) + off) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += kBKV) {
    for (int i = t; i < kBKV * D; i += kBQ) {
      const int j = i / D, e = i % D;
      const int kp = k0 + j;
      const size_t idx = (((size_t)b * Sk + kp) * Hk + hk) * D + e;
      ks[j][e] = kp < Sk ? to_f32(k[idx]) : 0.f;
      vs[j][e] = kp < Sk ? to_f32(v[idx]) : 0.f;
    }
    __syncthreads();

    float tile_max = kNegInf;
    for (int j = 0; j < kBKV; ++j) {
      const int kp = k0 + j;
      const bool valid = kp < Sk && (!causal || qpos >= kp);
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float s = 0.f;
#pragma unroll
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 kk = kr[e4];
        s = fmaf(qr[4 * e4], kk.x, s);
        s = fmaf(qr[4 * e4 + 1], kk.y, s);
        s = fmaf(qr[4 * e4 + 2], kk.z, s);
        s = fmaf(qr[4 * e4 + 3], kk.w, s);
      }
      s = valid ? s * sm_scale : kNegInf;
      ss[j][t] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] *= corr;
    for (int j = 0; j < kBKV; ++j) {
      const int kp = k0 + j;
      const bool valid = kp < Sk && (!causal || qpos >= kp);
      // masked entries add nothing, also in a fully masked tile where
      // m_new is still the sentinel and exp(s - m_new) would be 1
      const float p = valid ? expf(ss[j][t] - m_new) : 0.f;
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 vv = vr[e4];
        acc[4 * e4] = fmaf(p, vv.x, acc[4 * e4]);
        acc[4 * e4 + 1] = fmaf(p, vv.y, acc[4 * e4 + 1]);
        acc[4 * e4 + 2] = fmaf(p, vv.z, acc[4 * e4 + 2]);
        acc[4 * e4 + 3] = fmaf(p, vv.w, acc[4 * e4 + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < D; ++e) o[e] = from_f32<T>(acc[e] / denom);
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hk, int D, int causal, float sm_scale,
             cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 16:
      flash_attention_kernel<T, 16><<<grid, kBQ, 0, stream>>>(
          qt, kt, vt, ot, Sq, Sk, H, Hk, causal, sm_scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<grid, kBQ, 0, stream>>>(
          qt, kt, vt, ot, Sq, Sk, H, Hk, causal, sm_scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kBQ, 0, stream>>>(
          qt, kt, vt, ot, Sq, Sk, H, Hk, causal, sm_scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kBQ, 0, stream>>>(
          qt, kt, vt, ot, Sq, Sk, H, Hk, causal, sm_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: [B,Sq,H,D]; k/v: [B,Sk,Hk,D]; all f32 (bf16 = 0) or all bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hk, int D, int bf16,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sk < Sq) || Hk <= 0 ||
      H % Hk || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hk, D, causal,
                                   sm_scale, s);
  return launch_t<float>(q, k, v, out, B, Sq, Sk, H, Hk, D, causal, sm_scale,
                         s);
}

namespace fa {

constexpr int kBM = 64;                    // query rows: one warpgroup
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;                 // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// Keys per K/V tile: 128 at d = 64; 64 at d = 128, whose tiles are twice
// as wide (the S accumulator and the ring stay the same size). Tiles are
// kept as 64-column (128-byte) chunks, each [rows][64] bf16 swizzled.
template <int D>
struct Tile {
  static constexpr int kBN = D == 64 ? 128 : 64;
  static constexpr int kChunks = D / 64;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;   // one K (or V) tile
  static constexpr size_t kSmem = 1024 + kQBytes +
                                  (size_t)kStages * 2 * kKVBytes +
                                  (2 * kStages + 1) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int Hk, int causal, float scale_log2) {
  using T = Tile<D>;
  constexpr int BN = T::kBN;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_tile = smem;
  uint8_t* kv_ring = q_tile + T::kQBytes;   // stage s: K tile, then V tile
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv_ring + kStages * 2 * T::kKVBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const uint32_t q_bar = smem_u32(bars + 2 * kStages);

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = qt * kBM, off = Sk - Sq;
  // this query tile's key tiles: up to its last row's diagonal
  const int k_end = causal ? min(Sk, min(q0 + kBM, Sq) + off) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform role, so that ptxas does not serialize the wgmmas
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 1) {   // the producer warp: TMA loads only
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_4d(smem_u32(q_tile + c * kBM * 128), &map_q, q_bar, c * 64,
                    h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) + 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * T::kKVBytes);
        uint8_t* kt = kv_ring + 2 * s * T::kKVBytes;
        const int row = i * BN;
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load_4d(smem_u32(kt + c * BN * 128), &map_k, full0 + 8 * s,
                      c * 64, hk, row, b);
          tma_load_4d(smem_u32(kt + T::kKVBytes + c * BN * 128), &map_v,
                      full0 + 8 * s, c * 64, hk, row, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup. Thread (warp w, lane l) holds rows r and r + 8
  // of the tile, r = 16 w + l / 4: accumulator i is row r + 8 ((i / 2) % 2)
  const int lane = tid & 31;
  const int r_lo = (tid >> 5) * 16 + (lane >> 2);
  float o[D / 2], sacc[BN / 2];
  uint32_t p[BN / 4];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) sacc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint8_t* ktile = kv_ring + 2 * s * T::kKVBytes;
    const uint8_t* vtile = ktile + T::kKVBytes;

    // S = Q K^T over d in steps of 16 (32 bytes within a 128-byte row)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) keep(sacc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, w = kk % 4;
      wgmma_ss<BN>(sacc, sw128_desc(smem_u32(q_tile + c * kBM * 128)) + 2 * w,
                   sw128_desc(smem_u32(ktile + c * BN * 128)) + 2 * w,
                   kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) keep(sacc[j]);

    // scores in log2 units; mask only a tile that crosses the diagonal of
    // the tile's first row or the end of the keys
    const bool masked = (kt + 1) * BN > Sk ||
                        (causal && (kt + 1) * BN - 1 > q0 + off);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      float x = sacc[j] * scale_log2;
      if (masked) {
        const int kp = kt * BN + 8 * (j / 4) + 2 * (lane & 3) + (j & 1);
        const int qp = q0 + r_lo + 8 * ((j / 2) & 1) + off;
        if (kp >= Sk || (causal && kp > qp)) x = kNegInf;
      }
      sacc[j] = x;
      mx[(j / 2) & 1] = fmaxf(mx[(j / 2) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);   // finite: key 0 is seen
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 2; j += 2) {
      const int r = (j / 2) & 1;
      const float p0 = exp2f(sacc[j] - m[r]);
      const float p1 = exp2f(sacc[j + 1] - m[r]);
      l[r] += p0 + p1;
      const __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
      p[j / 2] = *reinterpret_cast<const uint32_t*>(&pk);
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j / 2) & 1];

    // O += P V over the tile's keys in steps of 16 (16 rows of V)
#pragma unroll
    for (int j = 0; j < D / 2; ++j) keep(o[j]);
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) keep(p[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma_rs<D>(o, a, sw128_desc_mn(smem_u32(vtile + kk * 16 * 128),
                                      BN * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < D / 2; ++j) keep(o[j]);
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) keep(p[j]);
    mbar_arrive(empty0 + 8 * s);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = (j / 2) & 1, row = q0 + r_lo + 8 * r;
    if (row >= Sq) continue;
    const int col = 8 * (j / 4) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * Sq + row) * H + h) * D + col) =
        __floats2bfloat162_rn(o[j] * inv[r], o[j + 1] * inv[r]);
  }
}

// a [B, S, heads, D] bf16 tensor read in boxes of one head's `rows` x 64
// columns, 128-byte swizzled; rows past S read as zero
inline bool head_map(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hk, int causal, float sm_scale,
           cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, q, B, Sq, H, D, kBM) ||
      !head_map(&mk, k, B, Sk, Hk, D, T::kBN) ||
      !head_map(&mv, v, B, Sk, Hk, D, T::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wgmma_kernel<D>;
  // the dynamic shared memory limit, raised once per instantiation (a
  // process-wide function attribute; its first call's result is kept)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hk, causal,
      sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa

// The tensor-core path. q/out: [B,Sq,H,D] bf16; k/v: [B,Sk,Hk,D] bf16; D in
// {64, 128}; 16-byte aligned bases.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int H, int Hk,
                                            int D, int causal, float sm_scale,
                                            void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sk < Sq) || Hk <= 0 ||
      H % Hk || B * H > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return fa::launch<64>(q, k, v, out, B, Sq, Sk, H, Hk, causal, sm_scale, s);
  if (D == 128)
    return fa::launch<128>(q, k, v, out, B, Sq, Sk, H, Hk, causal, sm_scale,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
