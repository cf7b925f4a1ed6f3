// AxLLM reuse (LUT) matmul for Hopper: the paper's Result Cache on device.
//
// Replaces the TPU kernel reuse_matmul_pallas (src/repro/kernels/
// reuse_matmul.py:115; body _reuse_kernel :57). It computes
//   y[m,n] = sum_g scale[g,n] * sum_{k in group g} sign * x[m,k] * levels[cell]
// where a code c reads cell |c| with sign(c) (affine, folded alphabet:
// levels = 0..qmax) or cell c + L/2 with sign +1 (codebook: NF4 or the
// 8-bit identity table), and the [G,N] scale (1/qmax folded in for affine)
// multiplies each group's sum, as kernels/ref.py reuse_matmul_ref does.
// Codes are int8 [K,N] or two int4 per byte uint8 [K,N/2] (low nibble =
// even column). Sums run in f32.
//
// The reuse: for each K chunk a block first builds the product table
// T[k][l][m] = x[m,k] * levels[l] in shared memory (the only place an
// activation is multiplied), then every code of the chunk is a signed
// gather from that table instead of a multiply. The TPU kernel writes the
// gather as a one-hot MXU contraction; here it is a direct shared-memory
// read: each thread owns one output column and all 8 rows of the M tile,
// so one code costs two 16-byte table reads and 8 adds.
//
// It also counts what the Result Cache executes: the distinct cells per
// (k-row, seg-wide column segment), summed (the TPU kernel's second
// output). Only blocks of the first M tile count: per chunk they set one
// bit per (k-row, segment, cell) in a shared bitmask, pop-count it, and
// add their total to *mults with one atomic. seg is a power of two that
// divides the block's 256 columns, so no segment spans two blocks.
//
// Two paths; the wrapper (kernels/reuse_matmul.py, tensor_core_path)
// picks one by shape and type before the launch:
//
// 1. Tensor cores (reuse_matmul_wgmma_launch, quant_gemm_sm90.cuh): bf16
//    activations, affine alphabets (int8, int4, int4 packed), one scale row
//    or groups of a multiple of 64 rows, and M at or above the measured
//    threshold: the prefill waves. For an affine alphabet
//    sign(c) * levels[|c|] == c, so wgmma over bf16 x and bf16-cast codes,
//    summed in f32 per scale group and scaled after the group sum, is this
//    kernel's association term for term. At prefill the H100 runs the
//    multiplies on its tensor cores instead of skipping them: the Result
//    Cache's saving is energy on the paper's accelerator, and a table gather
//    cannot reach the tensor cores' rate here (below). With a count asked
//    for, this kernel runs once more in its count-only mode (M = 0), so the
//    count is the Result Cache's, as on the other path.
//
// 2. The product table (reuse_matmul_launch, below): everything else, which
//    is f32 activations, codebook alphabets (NF4 levels are not exact in
//    bf16), decode M = n_slots = 8 and group sizes that 64 does not divide.
//    Its time bound is the bytes of the codes at decode, but the design's
//    own cost is shared-memory traffic: every product is a 4-byte table
//    read, and a block rewrites its 64 KB table once per chunk, which
//    floors it near 0.8 ms at M4096 K768 N2048 (4.3 ms measured). Decode
//    has few output columns, so K is split across blocks (blockIdx.z) into
//    a workspace that a second kernel sums in a fixed order (no atomics on
//    y: the result does not change from run to run). The split keeps the
//    scale after the group sum: with one scale group (per-channel, per-
//    tensor) the splits write unscaled partial sums and the second kernel
//    scales their fixed-order total; with several groups the splits fall
//    on group boundaries, so each split scales only whole groups.

#include "common.cuh"
#include "quant_gemm_sm90.cuh"

namespace {

constexpr int kBM = 8;               // rows of x per block (the M tile)
constexpr int kBN = 256;             // output columns per block = threads
constexpr int kTablePairs = 2048;    // BK * L: 2048 * 8 rows * 4 B = 64 KB

template <bool PACKED>
__device__ __forceinline__ int code_of(uint8_t raw, int n) {
  if (PACKED) {  // low nibble = even column
    const int nib = (n & 1) ? (raw >> 4) : (raw & 0xF);
    return nib >= 8 ? nib - 16 : nib;
  }
  return static_cast<int8_t>(raw);
}

template <typename TX, bool PACKED, int BK>
__global__ void __launch_bounds__(kBN)
reuse_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scale,
                    const float* __restrict__ levels, float* __restrict__ y,
                    int* __restrict__ mults, int M, int K, int N, int L,
                    int fold, int group_rows, int seg, int k_per_split) {
  extern __shared__ float4 smem4[];
  float* table = reinterpret_cast<float*>(smem4);  // [BK][L][kBM]
  float* xs = table + BK * L * kBM;                // [BK][kBM]
  float* lv = xs + BK * kBM;                       // [L]
  unsigned* mask = reinterpret_cast<unsigned*>(lv + 256);  // [BK][nsub][w]

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + tid;
  const bool n_ok = n < N;
  const int m0 = blockIdx.y * kBM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const bool count = mults != nullptr && blockIdx.y == 0;
  const int words = (L + 31) / 32;
  const int nsub = kBN / seg;
  const int sub = tid / seg;
  const int mask_words = BK * nsub * words;
  const int half = L >> 1;

  for (int i = tid; i < L; i += kBN) lv[i] = levels[i];
  // a code's table cell (clamped into the table) and its sign
  auto cell_of = [](uint8_t raw, int n, int fold, int half, int L) {
    const int c = code_of<PACKED>(raw, n);
    return min(fold ? abs(c) : c + half, L - 1);
  };
  auto negative = [](uint8_t raw, int n, int fold) {
    return fold && code_of<PACKED>(raw, n) < 0;
  };

  float acc[kBM], part[kBM];
#pragma unroll
  for (int m = 0; m < kBM; ++m) acc[m] = part[m] = 0.f;
  int g = kbeg / group_rows;
  int g_end = min((g + 1) * group_rows, kend);
  int my_count = 0;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // this thread's codes of the chunk, all issued before any is used
    uint8_t raw[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int k = k0 + j;
      const bool ok = n_ok && k < kend;
      const size_t at = PACKED ? (size_t)k * (N / 2) + n / 2
                               : (size_t)k * N + n;
      raw[j] = codes[ok ? at : 0];
    }
    for (int i = tid; i < BK * kBM; i += kBN) {
      const int kk = i / kBM, m = i % kBM;
      const int k = k0 + kk, row = m0 + m;
      xs[i] = (row < M && k < kend) ? to_f32(x[(size_t)row * K + k]) : 0.f;
    }
    if (count)
      for (int i = tid; i < mask_words; i += kBN) mask[i] = 0u;
    __syncthreads();

    // the table build: every alphabet product of the chunk, once
    for (int p = tid; p < BK * L; p += kBN) {
      const int kk = p / L, l = p % L;
      const float v = lv[l];
      const float4* xr = reinterpret_cast<const float4*>(xs + kk * kBM);
      const float4 a = xr[0], b = xr[1];
      float4* t = reinterpret_cast<float4*>(table + p * kBM);
      t[0] = make_float4(a.x * v, a.y * v, a.z * v, a.w * v);
      t[1] = make_float4(b.x * v, b.y * v, b.z * v, b.w * v);
    }

    if (count && n_ok) {
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        if (k0 + j < kend) {
          const int c = cell_of(raw[j], n, fold, half, L);
          atomicOr(&mask[(j * nsub + sub) * words + (c >> 5)], 1u << (c & 31));
        }
      }
    }
    __syncthreads();

    if (count)
      for (int i = tid; i < mask_words; i += kBN) my_count += __popc(mask[i]);

    // the reuse path: a signed table read per code, sums per scale group
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int k = k0 + j;
      if (k < kend) {
        const int c = cell_of(raw[j], n, fold, half, L);
        const float4* t =
            reinterpret_cast<const float4*>(table + (j * L + c) * kBM);
        const float4 a = t[0], b = t[1];
        const float s = negative(raw[j], n, fold) ? -1.f : 1.f;
        part[0] = fmaf(s, a.x, part[0]);
        part[1] = fmaf(s, a.y, part[1]);
        part[2] = fmaf(s, a.z, part[2]);
        part[3] = fmaf(s, a.w, part[3]);
        part[4] = fmaf(s, b.x, part[4]);
        part[5] = fmaf(s, b.y, part[5]);
        part[6] = fmaf(s, b.z, part[6]);
        part[7] = fmaf(s, b.w, part[7]);
        if (k + 1 == g_end) {  // group done: its scale times its sum
          // (no scale: a split of the only group; the sum kernel scales)
          const float sc = !n_ok ? 0.f : scale ? scale[(size_t)g * N + n] : 1.f;
#pragma unroll
          for (int m = 0; m < kBM; ++m) {
            acc[m] += part[m] * sc;
            part[m] = 0.f;
          }
          ++g;
          g_end = min((g + 1) * group_rows, kend);
        }
      }
    }
    __syncthreads();  // the next chunk rewrites table, xs and mask
  }

  if (n_ok) {
    float* out = y + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      if (m0 + m < M) out[(size_t)(m0 + m) * N + n] = acc[m];
  }
  if (count) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      my_count += __shfl_xor_sync(0xffffffffu, my_count, o);
    if ((tid & 31) == 0 && my_count) atomicAdd(mults, my_count);
  }
}

// y[m,n] = sum_z ws[z,m,n], in order z = 0, 1, ..., times scale[n] when
// the splits left the only scale group unscaled (scale != NULL)
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  const float* __restrict__ scale,
                                  float* __restrict__ y, int MN, int N,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * MN + i];
  y[i] = scale ? s * scale[i % N] : s;
}

size_t smem_bytes(int bk, int L, int seg) {
  const int words = (L + 31) / 32;
  return sizeof(float) * ((size_t)bk * L * kBM + bk * kBM + 256) +
         sizeof(unsigned) * (size_t)bk * (kBN / seg) * words;
}

template <typename TX, bool PACKED, int BK>
int launch(const void* x, const void* codes, const float* scale,
           const float* levels, float* out, int* mults, int M, int K, int N,
           int L, int fold, int group_rows, int seg, int splits,
           int k_per_split, cudaStream_t stream) {
  auto kernel = reuse_matmul_kernel<TX, PACKED, BK>;
  const size_t smem = smem_bytes(BK, L, seg);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, M > 0 ? (M + kBM - 1) / kBM : 1,
                  splits);
  kernel<<<grid, kBN, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(codes), scale,
      levels, out, mults, M, K, N, L, fold, group_rows, seg, k_per_split);
  return static_cast<int>(cudaGetLastError());
}

int table_rows(int L) { return L * 32 <= kTablePairs ? 32
                              : L * 16 <= kTablePairs ? 16 : 8; }

template <typename TX, bool PACKED>
int launch_bk(const void* x, const void* codes, const float* scale,
              const float* levels, float* out, int* mults, int M, int K,
              int N, int L, int fold, int group_rows, int seg, int splits,
              int k_per_split, cudaStream_t s) {
  switch (table_rows(L)) {
    case 32:
      return launch<TX, PACKED, 32>(x, codes, scale, levels, out, mults, M, K,
                                    N, L, fold, group_rows, seg, splits,
                                    k_per_split, s);
    case 16:
      return launch<TX, PACKED, 16>(x, codes, scale, levels, out, mults, M, K,
                                    N, L, fold, group_rows, seg, splits,
                                    k_per_split, s);
    default:
      return launch<TX, PACKED, 8>(x, codes, scale, levels, out, mults, M, K,
                                   N, L, fold, group_rows, seg, splits,
                                   k_per_split, s);
  }
}

}  // namespace

// x: [M,K] f32 (x_bf16 = 0) or bf16; codes: [K,N] int8 or [K,N/2] uint8
// (packed = 1); scale: [n_scale_rows, N] f32; levels: [L] f32 with L <= 256;
// fold: 1 = cell |c| with the sign on read, 0 = cell c + L/2; seg: the
// counting segment, a power of two in [8, 256] dividing N; mults: int32
// scalar the count is added to (zero it first), or NULL for no count;
// y: [M,N] f32; ws: [splits,M,N] f32 scratch when splits > 1, else NULL.
// Fewer than `splits` K splits run when the split falls on group
// boundaries.
extern "C" int reuse_matmul_launch(const void* x, int x_bf16, const void* codes,
                                   const float* scale, const float* levels,
                                   float* y, float* ws, int* mults, int M,
                                   int K, int N, int packed, int L, int fold,
                                   int n_scale_rows, int seg, int splits,
                                   void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || L <= 0 || L > 256 || n_scale_rows <= 0 ||
      K % n_scale_rows || (packed && N % 2) || seg < 8 || seg > kBN ||
      (seg & (seg - 1)) || N % seg || splits < 1 || (splits > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_rows = K / n_scale_rows;
  const int bk = table_rows(L);
  int k_per_split = (((K + bk - 1) / bk + splits - 1) / splits) * bk;
  if (n_scale_rows > 1)  // whole groups per split
    k_per_split = ((k_per_split + group_rows - 1) / group_rows) * group_rows;
  splits = (K + k_per_split - 1) / k_per_split;
  // one scale group split over K: the sum kernel applies its scale
  const bool defer = splits > 1 && n_scale_rows == 1;
  const float* kscale = defer ? nullptr : scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? ws : y;
  int err;
  if (x_bf16)
    err = packed ? launch_bk<__nv_bfloat16, true>(x, codes, kscale, levels,
                                                  out, mults, M, K, N, L, fold,
                                                  group_rows, seg, splits,
                                                  k_per_split, s)
                 : launch_bk<__nv_bfloat16, false>(x, codes, kscale, levels,
                                                   out, mults, M, K, N, L,
                                                   fold, group_rows, seg,
                                                   splits, k_per_split, s);
  else
    err = packed ? launch_bk<float, true>(x, codes, kscale, levels, out, mults,
                                          M, K, N, L, fold, group_rows, seg,
                                          splits, k_per_split, s)
                 : launch_bk<float, false>(x, codes, kscale, levels, out,
                                           mults, M, K, N, L, fold, group_rows,
                                           seg, splits, k_per_split, s);
  if (err || splits == 1 || M == 0) return err;
  const int MN = M * N;
  sum_splits_kernel<<<(MN + 255) / 256, 256, 0, s>>>(
      ws, defer ? scale : nullptr, y, MN, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core path: x [M,K] bf16 with M > 0; codes [K,N] int8 or
// [K,N/2] uint8 (packed = 1) of an affine alphabet (fold = 1, levels
// 0..qmax); scale [n_scale_rows, N] f32 with 1/qmax folded in; y [M,N]
// f32, or bf16 when out_bf16 = 1. With mults != NULL the product-table
// kernel first adds the Result Cache's count over seg-wide segments to it
// (zero it first), in its count-only mode.
extern "C" int reuse_matmul_wgmma_launch(const void* x, const void* codes,
                                         const float* scale,
                                         const float* levels, void* y,
                                         int* mults, int M, int K, int N,
                                         int packed, int L, int n_scale_rows,
                                         int seg, int out_bf16, void* stream) {
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mults) {
    const int err = reuse_matmul_launch(x, 1, codes, scale, levels, nullptr,
                                        nullptr, mults, 0, K, N, packed, L, 1,
                                        n_scale_rows, seg, 1, stream);
    if (err) return err;
  }
  return qgemm::quant_gemm_launch(x, codes, scale, y, M, K, N, packed,
                                  n_scale_rows, out_bf16,
                                  static_cast<cudaStream_t>(stream));
}
