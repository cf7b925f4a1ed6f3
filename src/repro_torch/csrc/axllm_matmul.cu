// Fused AxLLM dequant-matmul for Hopper: y[M,N] = x[M,K] @ deq(codes).
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
// Three kernels; the wrapper (kernels/axllm_matmul.py, matmul_path) picks
// one by shape, type and alignment before the launch:
//
// 1. Tensor cores (axllm_matmul_wgmma_launch, quant_gemm_sm90.cuh): bf16
//    activations, every alphabet (affine int8, int4, int4 packed; the
//    codebooks NF4, packed or not, and identity-8, each level split into
//    three bf16 terms), one scale row or groups of a multiple of 64 rows,
//    and M above the decode kernel's 16 rows (where it measured faster
//    than the tiles below at every M): the prefill waves. Bound there by
//    the operations (M4096 K768 N2048: 12.9 GFLOP, 0.013 ms at the bf16
//    peak); TMA keeps the x and code tiles in flight, the codes become
//    bf16 only in shared memory, and wgmma runs the product, the scale
//    applied once per group sum (within 1e-5 of the per-product scale of
//    the plain version). It writes f32 or the caller's bf16.
//
// 2. Decode (axllm_matmul_gemv_launch, below, on quant_gemv.cuh): M <= 16,
//    f32 or bf16 x, every alphabet, codes 16-byte aligned with N a
//    multiple of 16 (32 packed). Bound by the code bytes (M8 K768 N2048:
//    1.5 MB, 0.0005 ms). A block takes 32 columns and one K split of the
//    host's plan (at least one block per SM at every full-width
//    projection); it issues all its codes as 16-byte cp.async and stages
//    x's [M, split] once in shared memory, both before any FMA. Its 8 warps
//    walk interleaved K rows of the 32 columns (a byte and a broadcast x
//    read per 8 or 16 FMAs, every operand in shared memory), sum across
//    warps in a fixed order, scale each group sum once, and merge the
//    splits in the same launch (quant_gemv.cuh). The M tile is 8 rows
//    where M <= 8, else 16. It writes f32 or the caller's bf16 itself.
//
// 3. SIMT tiles (axllm_matmul_launch, below): everything else, which is
//    f32 activations above M = 16, group sizes that 64 does not divide,
//    rows TMA cannot address, and small M with codes the decode kernel
//    cannot read in 16-byte vectors. The int8 codes are read exactly once
//    per output tile, the dequantized tile lives in shared memory only,
//    and a 16-row tile for skinny M pays no 64-row padding.
//    Each tile's global loads are all issued, predicated and unbranched,
//    before any is used, so a tile costs one memory round trip (a load
//    consumed inside a branch right after its issue serialized them all:
//    109 us for M8 K768 N2048 on an H100). It writes f32.

#include "common.cuh"
#include "quant_gemm_sm90.cuh"
#include "quant_gemv.cuh"

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


// ---- decode: split-K over 32-column tiles (quant_gemv.cuh) ----

constexpr int kGemvBN = 32;                           // columns per block
constexpr int kGemvLanes = gemv::kThreads / kGemvBN;  // warps = K lanes

template <bool PACKED>
__device__ __forceinline__ int code_at(const uint8_t* row, int c) {
  if (PACKED) {  // low nibble = even column
    const uint8_t raw = row[c >> 1];
    const int nib = (c & 1) ? (raw >> 4) : (raw & 0xF);
    return nib >= 8 ? nib - 16 : nib;
  }
  return static_cast<int8_t>(row[c]);
}

template <int MT, bool PACKED>
size_t gemv_smem(int k_per_split) {
  constexpr int RB = PACKED ? kGemvBN / 2 : kGemvBN;
  return (size_t)k_per_split * RB + sizeof(float) * (
      (size_t)k_per_split * MT + kGemvLanes * MT * kGemvBN + 256);
}

// grid (N / 32 column tiles, splits); 256 threads: warp w is K lane w,
// lane c is column c of the tile
template <typename TX, int MT, bool PACKED>
__global__ void __launch_bounds__(gemv::kThreads)
axllm_gemv_kernel(const TX* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ codebook, void* __restrict__ y,
                  int out_bf16, float* __restrict__ part,
                  int* __restrict__ counters, int M, int N, int n_levels,
                  gemv::SplitPlan sp) {
  constexpr int RB = PACKED ? kGemvBN / 2 : kGemvBN;  // code bytes a row
  constexpr int VPR = RB / 16;                         // 16-byte vectors
  constexpr int OUT = MT * kGemvBN / gemv::kThreads;   // outputs a thread
  extern __shared__ float4 smem4[];
  const int kps = sp.k_per_split;
  uint8_t* cs = reinterpret_cast<uint8_t*>(smem4);        // [kps][RB]
  float* xs = reinterpret_cast<float*>(cs + (size_t)kps * RB);  // [kps][MT]
  float* red = xs + (size_t)kps * MT;           // [lanes][MT][kGemvBN]
  float* cb = red + kGemvLanes * MT * kGemvBN;  // [256] codebook

  const int tid = threadIdx.x, tile = blockIdx.x, z = blockIdx.y;
  const int n0 = tile * kGemvBN;
  const int K = sp.K;
  const int kbeg = z * kps, kend = min(K, kbeg + kps), rows = kend - kbeg;

  // every code load of the slice in flight before any is used
  const int row_bytes = PACKED ? N / 2 : N;
  const int byte0 = PACKED ? n0 / 2 : n0;
  for (int i = tid; i < rows * VPR; i += gemv::kThreads) {
    const int r = i / VPR, b = byte0 + (i % VPR) * 16;
    const bool ok = b < row_bytes;
    cp_async16(cs + r * RB + (i % VPR) * 16,
               codes + (size_t)(kbeg + r) * row_bytes + (ok ? b : 0), ok);
  }
  cp_async_commit();
  // x's [M, slice] once, as f32 [slice][MT]; rows past M are 0
#pragma unroll 8
  for (int i = tid; i < rows * MT; i += gemv::kThreads) {
    const int m = i / rows, r = i % rows;
    const float v = to_f32(x[(size_t)min(m, M - 1) * K + kbeg + r]);
    xs[r * MT + m] = m < M ? v : 0.f;
  }
  const bool use_cb = codebook != nullptr;
  if (use_cb)
    for (int i = tid; i < n_levels; i += gemv::kThreads) cb[i] = codebook[i];
  cp_async_wait<0>();
  __syncthreads();

  const int c = tid % kGemvBN, lane = tid / kGemvBN;
  const int offset = n_levels / 2;
  const bool defer = sp.defer();
  float fin[OUT];
#pragma unroll
  for (int j = 0; j < OUT; ++j) fin[j] = 0.f;
  // one pass per scale group of the split: the lanes' sums, then the
  // group's sum (lanes in order) times its scale
  for (int s0 = kbeg; s0 < kend;) {
    const int g = s0 / sp.group_rows;
    const int s1 = min(kend, (g + 1) * sp.group_rows);
    float sc[OUT];
#pragma unroll
    for (int j = 0; j < OUT; ++j) {  // issued now, used after the pass
      const int n = n0 + (tid + j * gemv::kThreads) % kGemvBN;
      sc[j] = defer ? 1.f : scale[(size_t)g * N + min(n, N - 1)];
    }
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    auto row = [&](int k) {
      const int r = k - kbeg;
      const int code = code_at<PACKED>(cs + r * RB, c);
      const float lv = use_cb ? cb[code + offset] : (float)code;
      const float4* xr = reinterpret_cast<const float4*>(xs + r * MT);
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 a = xr[q];
        acc[4 * q] = fmaf(a.x, lv, acc[4 * q]);
        acc[4 * q + 1] = fmaf(a.y, lv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a.z, lv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a.w, lv, acc[4 * q + 3]);
      }
    };
    int k = s0 + lane;  // 4 rows at a time, their reads in flight together
    for (; k + 3 * kGemvLanes < s1; k += 4 * kGemvLanes)
#pragma unroll
      for (int u = 0; u < 4; ++u) row(k + u * kGemvLanes);
    for (; k < s1; k += kGemvLanes) row(k);
#pragma unroll
    for (int m = 0; m < MT; ++m) red[(lane * MT + m) * kGemvBN + c] = acc[m];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      const int o = tid + j * gemv::kThreads;  // = m * kGemvBN + column
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < kGemvLanes; ++l) s += red[l * MT * kGemvBN + o];
      fin[j] += s * sc[j];
    }
    __syncthreads();
    s0 = s1;
  }

  if (sp.splits == 1) {
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      const int o = tid + j * gemv::kThreads;
      const int m = o / kGemvBN, n = n0 + o % kGemvBN;
      if (m < M && n < N)
        gemv::store_out(y, (size_t)m * N + n, fin[j], out_bf16);
    }
    return;
  }
  float* base = part + (size_t)tile * sp.splits * MT * kGemvBN;
#pragma unroll
  for (int j = 0; j < OUT; ++j)
    base[(size_t)z * MT * kGemvBN + tid + j * gemv::kThreads] = fin[j];
  if (!gemv::arrive_last(counters + tile, sp.splits)) return;
  const int n = n0 + c;  // the column of each of this thread's outputs
  float total[OUT];
  gemv::merge<OUT>(base + tid, MT * kGemvBN, gemv::kThreads, sp, scale,
                   min(n, N - 1), N, total);
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    const int m = (tid + j * gemv::kThreads) / kGemvBN;
    if (m < M && n < N)
      gemv::store_out(y, (size_t)m * N + n, total[j], out_bf16);
  }
  if (tid == 0) counters[tile] = 0;
}

template <typename TX, int MT, bool PACKED>
int gemv_launch(const void* x, const void* codes, const float* scale,
                const float* codebook, void* y, int out_bf16, float* part,
                int* counters, int M, int N, int n_levels,
                const gemv::SplitPlan& sp, cudaStream_t stream) {
  auto kernel = axllm_gemv_kernel<TX, MT, PACKED>;
  static size_t reserved = 0;
  const size_t smem = gemv_smem<MT, PACKED>(sp.k_per_split);
  if (smem > gemv::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = gemv::reserve_smem(kernel, smem, &reserved);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kGemvBN - 1) / kGemvBN, sp.splits);
  kernel<<<grid, gemv::kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(codes), scale,
      codebook, y, out_bf16, part, counters, M, N, n_levels, sp);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, int MT>
int gemv_launch_p(int packed, const void* x, const void* codes,
                  const float* scale, const float* codebook, void* y,
                  int out_bf16, float* part, int* counters, int M, int N,
                  int n_levels, const gemv::SplitPlan& sp, cudaStream_t s) {
  return packed ? gemv_launch<TX, MT, true>(x, codes, scale, codebook, y,
                                             out_bf16, part, counters, M, N,
                                             n_levels, sp, s)
                : gemv_launch<TX, MT, false>(x, codes, scale, codebook, y,
                                              out_bf16, part, counters, M, N,
                                              n_levels, sp, s);
}

template <typename TX>
int gemv_launch_m(int packed, const void* x, const void* codes,
                  const float* scale, const float* codebook, void* y,
                  int out_bf16, float* part, int* counters, int M, int N,
                  int n_levels, const gemv::SplitPlan& sp, cudaStream_t s) {
  return M <= 8 ? gemv_launch_p<TX, 8>(packed, x, codes, scale, codebook, y,
                                       out_bf16, part, counters, M, N,
                                       n_levels, sp, s)
                : gemv_launch_p<TX, 16>(packed, x, codes, scale, codebook, y,
                                        out_bf16, part, counters, M, N,
                                        n_levels, sp, s);
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

// The tensor-core path: x [M,K] bf16; codes [K,N] int8 or [K,N/2] uint8
// (packed = 1); scale [n_scale_rows, N] f32 (1/qmax folded in for affine
// codes); alphabet (qgemm::Alphabet): affine (codebook NULL), NF4
// (codebook: its [16] f32 table) or identity-8 (int8 codes; the kernel
// computes the levels c / 127, codebook not read); sum_rows: a codebook's
// partial-sum span (kernels/ref.py CODEBOOK_SUM_ROWS), 0 for affine
// codes; y [M,N] f32, or bf16 when out_bf16 = 1.
extern "C" int axllm_matmul_wgmma_launch(const void* x, const void* codes,
                                         const float* scale,
                                         const float* codebook, void* y,
                                         int M, int K, int N, int packed,
                                         int alphabet, int sum_rows,
                                         int n_scale_rows, int out_bf16,
                                         void* stream) {
  return qgemm::quant_gemm_launch(x, codes, scale, codebook, y, M, K, N,
                                  packed, n_scale_rows, alphabet, sum_rows,
                                  out_bf16, static_cast<cudaStream_t>(stream));
}

// The decode path: x [M,K] f32 (x_bf16 = 0) or bf16 with 1 <= M <= 16;
// codes [K,N] int8 or [K,N/2] uint8 (packed = 1), 16-byte aligned, N a
// multiple of 16 (32 packed); scale [n_scale_rows, N] f32; codebook
// [n_levels] f32 or NULL; y [M,N] f32, or bf16 when out_bf16 = 1. The K
// splits: `splits` of k_per_split rows (the host's plan; none straddles a
// scale group); part: f32 scratch of ceil(N/32) * splits * 16 * 32 floats
// and counters: ceil(N/32) int32 at 0 (left at 0), both NULL for one split.
extern "C" int axllm_matmul_gemv_launch(
    const void* x, int x_bf16, const void* codes, const float* scale,
    const float* codebook, void* y, int out_bf16, float* part, int* counters,
    int M, int K, int N, int packed, int n_levels, int n_scale_rows,
    int k_per_split, int splits, void* stream) {
  const gemv::SplitPlan sp{K, k_per_split, splits,
                           n_scale_rows > 0 ? K / n_scale_rows : 0};
  if (M < 1 || M > 16 || N <= 0 || n_scale_rows <= 0 || K % n_scale_rows ||
      n_levels > 256 || N % (packed ? 32 : 16) ||
      reinterpret_cast<uintptr_t>(codes) % 16 ||
      !gemv::plan_ok(sp, n_scale_rows) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? gemv_launch_m<__nv_bfloat16>(packed, x, codes, scale,
                                               codebook, y, out_bf16, part,
                                               counters, M, N, n_levels, sp, s)
                : gemv_launch_m<float>(packed, x, codes, scale, codebook, y,
                                       out_bf16, part, counters, M, N,
                                       n_levels, sp, s);
}
