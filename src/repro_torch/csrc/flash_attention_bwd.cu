// Backward of causal or non-causal GQA flash attention for Hopper: dQ, dK
// and dV of O = softmax(scale Q K^T) V, from Q, K, V, the forward's O and
// dO. SIMT, every sum in f32, bf16 or f32 in and out.
//
// Replaces no TPU kernel: flash_attention_pallas (src/repro/kernels/
// flash_attention.py:81) has no VJP, and jax.grad of it raises, so the JAX
// package trains through the plain jnp attention (src/repro/kernels/
// ops.py:244-256). On the card the forward is the kernel of
// csrc/flash_attention.cu, and a plain version may not stand on the
// card's path, so its gradient is this kernel (kernels/flash_attention.py
// FlashAttentionFn; plain version kernels/ref.py flash_attention_bwd_ref).
//
// Layouts as the forward: q, o, do, dq [B,Sq,H,D]; k, v, dk, dv
// [B,Sk,Hk,D]; query head h reads KV head h / (H/Hk); causal queries sit
// at the last Sq keys (query i sees keys 0..i+Sk-Sq, Sq <= Sk), and a
// non-causal call takes any Sq. The Sq x Sk scores and probabilities
// never reach device memory: each kernel recomputes its tile of them.
//
// Three launches on the caller's stream, each output written by exactly
// one block in a fixed order (no atomics), so a second call gives the same
// bits:
//   1. stats: per query row, lse = log-sum-exp of its scaled, masked
//      scores (recomputed from Q and K, so the two forward kernels stay
//      untouched) and D = rowsum(dO * O), into an f32 scratch [2,B,H,Sq];
//   2. dQ: one block per 64 query rows of one head, looping over the key
//      tiles up to the tile's causal end: P = exp(S - lse), dP = dO V^T,
//      dS = P (dP - D), dQ += dS K, scaled once at the end;
//   3. dK, dV: one block per 64 keys of one KV head, looping over the
//      group's H/Hk query heads and, for each, its query tiles from the
//      first one that sees the tile's first key: dV += P^T dO, dK += dS^T
//      Q (scaled at the end). The GQA sum over query heads is this loop.
//
// What bounds it on an H100: on the SIMT cores, the operations. At a
// training step's shapes (B8 S256 H12 Hk4 d64 causal, bf16) the function
// moves 16.8 MB and needs 2.0 GFLOP (S, dP, dQ, dK, dV: 10 d a query-key
// pair and head), 0.005 ms at the HBM rate and 0.002 ms on the tensor
// cores; this kernel does 2.4 GFLOP (S once more for the statistics) as
// f32 FMAs, 0.036 ms at the SIMT cores' peak. Tiles live in shared memory
// as f32, rows padded to D+1 floats so that the 32 lanes of a warp,
// reading 32 rows at one column, hit 32 banks. A score tile is 64 x 32:
// warp w holds rows w, w+8, .., w+56 and its lane the column, so a row's
// max and sum are warp shuffles; each product's output rows are split
// over the threads by column (e = thread % D). It is a first, simple
// kernel: the tensor-core form (wgmma for S, dP and the three products)
// is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // query rows (stats, dQ) or keys (dK/dV)
constexpr int kCols = 32;             // keys (dQ), queries (dK/dV): a lane each
constexpr int kPer = kTile / kWarps;  // score-tile rows per thread
constexpr int kSp = kCols + 1;        // padded row of a score tile

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// rows [r0, r0 + n) of head hx of a [B, S, Hx, D] tensor into dst [n][D+1]
// as f32; rows past S read as zeros
template <typename T, int D>
__device__ void load_rows(float* dst, const T* __restrict__ src, int b, int S,
                          int Hx, int hx, int r0, int n) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, e = i % D, s = r0 + r;
    dst[r * (D + 1) + e] =
        s < S ? to_f32(src[(((size_t)b * S + s) * Hx + hx) * D + e]) : 0.f;
  }
}

// acc[i] = A[w + kWarps i] . B[lane]: A [kTile][D+1], B [kCols][D+1]
template <int D>
__device__ __forceinline__ void dots(const float* A, const float* B,
                                     float acc[kPer]) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* br = B + lane * (D + 1);
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    const float bv = br[e];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      acc[i] = fmaf(A[(w + kWarps * i) * (D + 1) + e], bv, acc[i]);
  }
}

// 1. lse and D of every query row of a 64-row tile of head (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ delta,
                       int Sq, int Sk, int H, int Hk, int causal,
                       float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][D+1]
  float* ks = qs + kTile * (D + 1);       // [kCols][D+1]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hk);
  const int q0 = blockIdx.x * kTile, off = Sk - Sq;
  const int k_end = causal ? min(Sk, min(q0 + kTile, Sq) + off) : Sk;
  load_rows<T, D>(qs, q, b, Sq, H, h, q0, kTile);

  float m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) m[i] = kNegInf, l[i] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();                      // ks free (and qs loaded)
    load_rows<T, D>(ks, k, b, Sk, Hk, hk, k0, kCols);
    __syncthreads();
    float s[kPer];
    dots<D>(qs, ks, s);
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + w + kWarps * i + off;
      const bool valid = kp < Sk && (!causal || qpos >= kp);
      const float x = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      // masked entries add nothing, also while m_new is the sentinel
      const float p = valid ? expf(x - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(p);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + w + kWarps * i;
    if (qi >= Sq) continue;               // warp-uniform
    const size_t row = ((size_t)b * Sq + qi) * H + h;
    float acc = 0.f;
    for (int e = lane; e < D; e += 32)
      acc = fmaf(to_f32(dout[row * D + e]), to_f32(o[row * D + e]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const size_t at = ((size_t)b * H + h) * Sq + qi;
      lse[at] = m[i] + logf(l[i]);
      delta[at] = acc;
    }
  }
}

// 2. dQ of a 64-row query tile of head (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Hk, int causal, float scale) {
  constexpr int kGroups = kThreads / D;   // row groups of the dQ product
  constexpr int kRows = kTile / kGroups;  // dQ rows per thread
  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][D+1]
  float* dos = qs + kTile * (D + 1);      // [kTile][D+1]
  float* ks = dos + kTile * (D + 1);      // [kCols][D+1]
  float* vs = ks + kCols * (D + 1);       // [kCols][D+1]
  float* dss = vs + kCols * (D + 1);      // [kTile][kSp]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = threadIdx.x % D, g = threadIdx.x / D;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hk);
  const int q0 = blockIdx.x * kTile, off = Sk - Sq;
  const int k_end = causal ? min(Sk, min(q0 + kTile, Sq) + off) : Sk;
  load_rows<T, D>(qs, q, b, Sq, H, h, q0, kTile);
  load_rows<T, D>(dos, dout, b, Sq, H, h, q0, kTile);

  float row_lse[kPer], row_d[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + w + kWarps * i;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    row_lse[i] = qi < Sq ? lse[at] : 0.f;
    row_d[i] = qi < Sq ? delta[at] : 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();                      // ks, vs, dss free
    load_rows<T, D>(ks, k, b, Sk, Hk, hk, k0, kCols);
    load_rows<T, D>(vs, v, b, Sk, Hk, hk, k0, kCols);
    __syncthreads();
    float s[kPer], dp[kPer];
    dots<D>(qs, ks, s);
    dots<D>(dos, vs, dp);
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qi = q0 + w + kWarps * i;
      const bool valid =
          qi < Sq && kp < Sk && (!causal || qi + off >= kp);
      const float p = valid ? expf(s[i] * scale - row_lse[i]) : 0.f;
      dss[(w + kWarps * i) * kSp + lane] = p * (dp[i] - row_d[i]);
    }
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      const float kv = ks[j * (D + 1) + e];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(dss[(g + kGroups * r) * kSp + j], kv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + g + kGroups * r;
    if (qi < Sq)
      dq[(((size_t)b * Sq + qi) * H + h) * D + e] = from_f32<T>(acc[r] * scale);
  }
}

// 3. dK and dV of a 64-key tile of KV head (b, hk)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int Hk,
                     int causal, float scale) {
  constexpr int kGroups = kThreads / D;   // key groups of the products
  constexpr int kRows = kTile / kGroups;  // dK (and dV) rows per thread
  extern __shared__ float smem[];
  float* ks = smem;                       // [kTile][D+1]
  float* vs = ks + kTile * (D + 1);       // [kTile][D+1]
  float* qs = vs + kTile * (D + 1);       // [kCols][D+1]
  float* dos = qs + kCols * (D + 1);      // [kCols][D+1]
  float* ps = dos + kCols * (D + 1);      // [kTile][kSp]: P^T
  float* dss = ps + kTile * kSp;          // [kTile][kSp]: dS^T
  float* lse_s = dss + kTile * kSp;       // [kCols]
  float* d_s = lse_s + kCols;             // [kCols]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = threadIdx.x % D, g = threadIdx.x / D;
  const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk, rep = H / Hk;
  const int k0 = blockIdx.x * kTile, off = Sk - Sq;
  load_rows<T, D>(ks, k, b, Sk, Hk, hk, k0, kTile);
  load_rows<T, D>(vs, v, b, Sk, Hk, hk, k0, kTile);
  // the first query that sees key k0
  const int q_start = causal ? max(0, k0 - off) : 0;

  float acc_k[kRows], acc_v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_k[r] = 0.f, acc_v[r] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    for (int qt = q_start; qt < Sq; qt += kCols) {
      __syncthreads();                    // qs, dos, ps, dss, lse_s free
      load_rows<T, D>(qs, q, b, Sq, H, h, qt, kCols);
      load_rows<T, D>(dos, dout, b, Sq, H, h, qt, kCols);
      if (threadIdx.x < kCols) {
        const int qi = qt + threadIdx.x;
        const size_t at = ((size_t)b * H + h) * Sq + qi;
        lse_s[threadIdx.x] = qi < Sq ? lse[at] : 0.f;
        d_s[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[kPer], dp[kPer];
      dots<D>(ks, qs, s);                 // rows: keys; lane: query
      dots<D>(vs, dos, dp);
      const int qi = qt + lane;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int kp = k0 + w + kWarps * i;
        const bool valid =
            qi < Sq && kp < Sk && (!causal || qi + off >= kp);
        const float p = valid ? expf(s[i] * scale - lse_s[lane]) : 0.f;
        ps[(w + kWarps * i) * kSp + lane] = p;
        dss[(w + kWarps * i) * kSp + lane] = p * (dp[i] - d_s[lane]);
      }
      __syncthreads();
      for (int j = 0; j < kCols; ++j) {
        const float qv = qs[j * (D + 1) + e];
        const float dov = dos[j * (D + 1) + e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int key = g + kGroups * r;
          acc_v[r] = fmaf(ps[key * kSp + j], dov, acc_v[r]);
          acc_k[r] = fmaf(dss[key * kSp + j], qv, acc_k[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kp = k0 + g + kGroups * r;
    if (kp < Sk) {
      const size_t at = (((size_t)b * Sk + kp) * Hk + hk) * D + e;
      dk[at] = from_f32<T>(acc_k[r] * scale);
      dv[at] = from_f32<T>(acc_v[r]);
    }
  }
}

template <int D>
constexpr size_t stats_smem() {
  return (size_t)(kTile + kCols) * (D + 1) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return ((size_t)(2 * kTile + 2 * kCols) * (D + 1) + kTile * kSp) *
         sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return ((size_t)(2 * kTile + 2 * kCols) * (D + 1) + 2 * kTile * kSp +
          2 * kCols) * sizeof(float);
}

template <typename T, int D>
int launch_t(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* stats,
             int B, int Sq, int Sk, int H, int Hk, int causal, float scale,
             cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lse = stats;
  float* delta = stats + (size_t)B * H * Sq;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_stats_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  stats_smem<D>())) ||
      (err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dq_smem<D>())) ||
      (err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dkv_smem<D>())))
    return static_cast<int>(err);
  const dim3 q_grid((Sq + kTile - 1) / kTile, B * H);
  flash_bwd_stats_kernel<T, D>
      <<<q_grid, kThreads, stats_smem<D>(), stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, Sq, Sk, H, Hk,
      causal, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<q_grid, kThreads, dq_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, H, Hk,
      causal, scale);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const dim3 kv_grid((Sk + kTile - 1) / kTile, B * Hk);
  flash_bwd_dkv_kernel<T, D>
      <<<kv_grid, kThreads, dkv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, Hk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* stats,
             int B, int Sq, int Sk, int H, int Hk, int D, int causal,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_t<T, 16>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                             H, Hk, causal, scale, s);
    case 32:
      return launch_t<T, 32>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                             H, Hk, causal, scale, s);
    case 64:
      return launch_t<T, 64>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                             H, Hk, causal, scale, s);
    case 128:
      return launch_t<T, 128>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                              H, Hk, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/o/dout/dq: [B,Sq,H,D]; k/v/dk/dv: [B,Sk,Hk,D]; all f32 (bf16 = 0) or
// all bf16; stats: f32 scratch [2,B,H,Sq] (lse, then D).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
    int Sq, int Sk, int H, int Hk, int D, int bf16, int causal, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sk < Sq) || Hk <= 0 ||
      H % Hk || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, st, B, Sq,
                                   Sk, H, Hk, D, causal, scale, s);
  return launch_d<float>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Sk, H, Hk,
                         D, causal, scale, s);
}
