// Fused AxLLM dequant-matmul for Hopper: y[M,N] f32 = x[M,K] @ deq(codes).
//
// Replaces the TPU kernel axllm_matmul_pallas (src/repro/kernels/
// axllm_matmul.py:104; body _axllm_kernel :81, _dequant_tile :47,
// _unpack_nibbles :71). Codes are int8 [K,N] or two int4 per byte uint8
// [K,N/2] (low nibble = even column). A weight is
//   w[k,n] = level(code) * scale[k / group_rows, n]
// where level is the code itself (affine; the wrapper folds 1/qmax into
// the scale) or codebook[code + n_levels/2] (a 16- or 256-entry table held
// in shared memory, the on-chip Result Cache). Sums run in f32.
//
// What bounds it on an H100: on the decode path (M = n_slots = 8) the
// work is a few MFLOP against K*N code bytes, so the bound is the bytes:
// the int8 codes are the smallest form the weights take in device memory
// and are read exactly once per output tile. At prefill (M ~ 4096) the
// bound is the operations. The design keeps the dequantized tile in shared
// memory only, never in device memory, and picks a 16-row tile for skinny
// M so decode pays no 64-row padding. Each tile's global loads are all
// issued, predicated and unbranched, before any is used, so a tile costs
// one memory round trip (a load consumed inside a branch right after its
// issue serialized them all: 109 us for M8 K768 N2048 on an H100). It is
// a plain SIMT tile loop (no tensor cores, no TMA, one block per 64
// columns): a correct first kernel; wgmma tiling and split-K for skinny M
// are later work.

#include "common.cuh"

namespace {

constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 64;       // reduction depth per tile
constexpr int kThreads = 256; // 16 x 16 threads, each TM x TN outputs
// each thread loads the weight tile's column tid % kBN, every kRowStep-th row
constexpr int kRowStep = kThreads / kBN;
constexpr int kWPer = kBK * kBN / kThreads;

template <typename TX, int BM, bool PACKED>
__global__ void __launch_bounds__(kThreads)
axllm_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scale,
                    const float* __restrict__ codebook, float* __restrict__ y,
                    int M, int K, int N, int n_levels, int group_rows) {
  constexpr int TM = BM / 16;
  constexpr int TN = kBN / 16;
  constexpr int kXPer = BM * kBK / kThreads;
  __shared__ float xs[kBK][BM + 1];  // x tile, transposed; +1 avoids bank
                                     // conflicts on the transposing store
  __shared__ float ws[kBK][kBN];     // dequantized weight tile
  __shared__ float cb[256];          // codebook (Result Cache)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const bool use_cb = codebook != nullptr;
  const int offset = n_levels / 2;
  if (use_cb) {
    for (int i = tid; i < n_levels; i += kThreads) cb[i] = codebook[i];
  }
  // this thread's weight-tile column, and its scale when one row of
  // scales covers all of K (per-channel / per-tensor)
  const int wc = tid % kBN, wr0 = tid / kBN;
  const int wn = n0 + wc;
  const bool wn_ok = wn < N;
  const bool one_scale_row = group_rows >= K;
  const float col_scale = (wn_ok && one_scale_row) ? scale[wn] : 0.f;
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // Issue every global load of the tile before using any of them. Out of
    // range elements load element 0 (always valid) and are zeroed only at
    // the shared-memory store, so no load sits in a branch or is followed
    // by a write to its register, and a tile costs one memory round trip.
    TX xraw[kXPer];
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / kBK, k = k0 + i % kBK;
      xraw[j] = x[(m < M && k < K) ? (size_t)m * K + k : 0];
    }
    uint8_t raw[kWPer];
    float sc[kWPer];
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int k = k0 + wr0 + j * kRowStep;
      const bool ok = wn_ok && k < K;
      const size_t at = PACKED ? (size_t)k * (N / 2) + wn / 2
                               : (size_t)k * N + wn;
      raw[j] = codes[ok ? at : 0];
      sc[j] = one_scale_row
                  ? col_scale
                  : scale[ok ? (size_t)(k / group_rows) * N + wn : 0];
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / kBK, k = k0 + i % kBK;
      xs[i % kBK][i / kBK] = (m < M && k < K) ? to_f32(xraw[j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int k = k0 + wr0 + j * kRowStep;
      int code;
      if (PACKED) {  // low nibble = even column
        const int nib = (wn & 1) ? (raw[j] >> 4) : (raw[j] & 0xF);
        code = nib >= 8 ? nib - 16 : nib;
      } else {
        code = static_cast<int8_t>(raw[j]);
      }
      const float level = use_cb ? cb[code + offset] : (float)code;
      ws[wr0 + j * kRowStep][wc] = (wn_ok && k < K) ? level * sc[j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <typename TX, bool PACKED>
void launch(const void* x, const void* codes, const float* scale,
            const float* codebook, float* y, int M, int K, int N,
            int n_levels, int group_rows, cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const uint8_t* ct = static_cast<const uint8_t*>(codes);
  dim3 grid((N + kBN - 1) / kBN);
  if (M <= 16) {  // decode: one 16-row tile covers every slot
    grid.y = (M + 15) / 16;
    axllm_matmul_kernel<TX, 16, PACKED><<<grid, kThreads, 0, stream>>>(
        xt, ct, scale, codebook, y, M, K, N, n_levels, group_rows);
  } else {
    grid.y = (M + 63) / 64;
    axllm_matmul_kernel<TX, 64, PACKED><<<grid, kThreads, 0, stream>>>(
        xt, ct, scale, codebook, y, M, K, N, n_levels, group_rows);
  }
}

template <typename TX>
void launch_x(const void* x, const void* codes, const float* scale,
              const float* codebook, float* y, int M, int K, int N,
              int packed, int n_levels, int group_rows, cudaStream_t stream) {
  if (packed)
    launch<TX, true>(x, codes, scale, codebook, y, M, K, N, n_levels,
                     group_rows, stream);
  else
    launch<TX, false>(x, codes, scale, codebook, y, M, K, N, n_levels,
                      group_rows, stream);
}

}  // namespace

// x: [M,K] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); codes: [K,N] int8 or
// [K,N/2] uint8 (packed = 1); scale: [n_scale_rows, N] f32 with n_scale_rows
// dividing K; codebook: [n_levels] f32 or NULL; y: [M,N] f32.
extern "C" int axllm_matmul_launch(const void* x, int x_bf16, const void* codes,
                                   const float* scale, const float* codebook,
                                   float* y, int M, int K, int N, int packed,
                                   int n_levels, int n_scale_rows,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_scale_rows <= 0 || K % n_scale_rows ||
      n_levels > 256 || (packed && N % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_rows = K / n_scale_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch_x<__nv_bfloat16>(x, codes, scale, codebook, y, M, K, N, packed,
                            n_levels, group_rows, s);
  else
    launch_x<float>(x, codes, scale, codebook, y, M, K, N, packed, n_levels,
                    group_rows, s);
  return static_cast<int>(cudaGetLastError());
}
