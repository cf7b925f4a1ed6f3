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
// read: each thread owns one output column and all rows of the M tile,
// so one code costs two 16-byte table reads and 8 adds at 8 rows.
//
// It also counts what the Result Cache executes: the distinct cells per
// (k-row, seg-wide column segment), summed (the TPU kernel's second
// output). Only blocks of the first M tile count: per chunk they set one
// bit per (k-row, segment, cell) in a shared bitmask, pop-count it, and
// add their total to *mults with one atomic. seg is a power of two that
// divides the block's 256 columns, so no segment spans two blocks.
//
// Three paths; the wrapper (kernels/reuse_matmul.py, matmul_path) picks
// one by shape, type and alignment before the launch:
//
// 1. Tensor cores (reuse_matmul_wgmma_launch, quant_gemm_sm90.cuh): bf16
//    activations, affine alphabets (int8, int4, int4 packed), one scale row
//    or groups of a multiple of 64 rows, and M above the decode kernel's
//    16 rows (measured faster than the table kernels at every such M): the
//    prefill waves. For an affine alphabet
//    sign(c) * levels[|c|] == c, so wgmma over bf16 x and bf16-cast codes,
//    summed in f32 per scale group and scaled after the group sum, is this
//    kernel's association term for term. At prefill the H100 runs the
//    multiplies on its tensor cores instead of skipping them: the Result
//    Cache's saving is energy on the paper's accelerator, and a table gather
//    cannot reach the tensor cores' rate here (below). With a count asked
//    for, the table kernel runs once more in its count-only mode (M = 0), so
//    the count is the Result Cache's, as on the other paths.
//
// 2. Decode (reuse_matmul_gemv_launch, below, on quant_gemv.cuh): M <= 16,
//    f32 or bf16 x, every alphabet, codes 16-byte aligned with N a multiple
//    of 16 (32 packed). Bound by the code bytes; the product table stays
//    the only place an activation is multiplied. A block takes 256 columns
//    (a multiple of the counting segment, so each (k-row, segment) is
//    counted by one block), an M tile of 1, 2 or 4 rows (a table entry is at
//    most 16 bytes: one shared-memory read a code; 8 rows took 1.5x the
//    time on an H100) and one K split of the host's plan: the plan shrinks
//    the M tile and splits K until the card has a block per SM. The block
//    issues all its codes as 16-byte cp.async first, so they land while it
//    builds its first table; then per chunk it builds the table, counts
//    and gathers. The splits merge in the same launch in a fixed order
//    (quant_gemv.cuh), scaled once per group sum, and the kernel writes the
//    caller's f32 or bf16: one launch a call, no workspace allocation, no
//    second kernel.
//
// 3. The product table over all of K (reuse_matmul_launch, below):
//    everything else, which is f32 and codebook activations or alphabets
//    above M = 16, group sizes that 64 does not divide, small M with codes
//    the decode kernel cannot read in 16-byte vectors, and the count-only
//    mode. Its time bound is the bytes of the codes, but the design's own
//    cost is shared-memory traffic: every product is a 4-byte table read,
//    and a block rewrites its 64 KB table once per chunk, which floors it
//    near 0.8 ms at M4096 K768 N2048 (4.3 ms measured). It writes f32.

#include "common.cuh"
#include "quant_gemm_sm90.cuh"
#include "quant_gemv.cuh"

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
                    int fold, int group_rows, int seg) {
  extern __shared__ float4 smem4[];
  float* table = reinterpret_cast<float*>(smem4);  // [BK][L][kBM]
  float* xs = table + BK * L * kBM;                // [BK][kBM]
  float* lv = xs + BK * kBM;                       // [L]
  unsigned* mask = reinterpret_cast<unsigned*>(lv + 256);  // [BK][nsub][w]

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + tid;
  const bool n_ok = n < N;
  const int m0 = blockIdx.y * kBM;
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
  int g = 0;
  int g_end = min(group_rows, K);
  int my_count = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // this thread's codes of the chunk, all issued before any is used
    uint8_t raw[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int k = k0 + j;
      const bool ok = n_ok && k < K;
      const size_t at = PACKED ? (size_t)k * (N / 2) + n / 2
                               : (size_t)k * N + n;
      raw[j] = codes[ok ? at : 0];
    }
    for (int i = tid; i < BK * kBM; i += kBN) {
      const int kk = i / kBM, m = i % kBM;
      const int k = k0 + kk, row = m0 + m;
      xs[i] = (row < M && k < K) ? to_f32(x[(size_t)row * K + k]) : 0.f;
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
        if (k0 + j < K) {
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
      if (k < K) {
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
          const float sc = n_ok ? scale[(size_t)g * N + n] : 0.f;
#pragma unroll
          for (int m = 0; m < kBM; ++m) {
            acc[m] += part[m] * sc;
            part[m] = 0.f;
          }
          ++g;
          g_end = min((g + 1) * group_rows, K);
        }
      }
    }
    __syncthreads();  // the next chunk rewrites table, xs and mask
  }

  if (n_ok) {
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      if (m0 + m < M) y[(size_t)(m0 + m) * N + n] = acc[m];
  }
  if (count) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      my_count += __shfl_xor_sync(0xffffffffu, my_count, o);
    if ((tid & 31) == 0 && my_count) atomicAdd(mults, my_count);
  }
}

size_t smem_bytes(int bk, int L, int seg) {
  const int words = (L + 31) / 32;
  return sizeof(float) * ((size_t)bk * L * kBM + bk * kBM + 256) +
         sizeof(unsigned) * (size_t)bk * (kBN / seg) * words;
}

template <typename TX, bool PACKED, int BK>
int launch(const void* x, const void* codes, const float* scale,
           const float* levels, float* y, int* mults, int M, int K, int N,
           int L, int fold, int group_rows, int seg, cudaStream_t stream) {
  auto kernel = reuse_matmul_kernel<TX, PACKED, BK>;
  const size_t smem = smem_bytes(BK, L, seg);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, M > 0 ? (M + kBM - 1) / kBM : 1);
  kernel<<<grid, kBN, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(codes), scale,
      levels, y, mults, M, K, N, L, fold, group_rows, seg);
  return static_cast<int>(cudaGetLastError());
}

int table_rows(int L) { return L * 32 <= kTablePairs ? 32
                              : L * 16 <= kTablePairs ? 16 : 8; }

template <typename TX, bool PACKED>
int launch_bk(const void* x, const void* codes, const float* scale,
              const float* levels, float* y, int* mults, int M, int K, int N,
              int L, int fold, int group_rows, int seg, cudaStream_t s) {
  switch (table_rows(L)) {
    case 32:
      return launch<TX, PACKED, 32>(x, codes, scale, levels, y, mults, M, K,
                                    N, L, fold, group_rows, seg, s);
    case 16:
      return launch<TX, PACKED, 16>(x, codes, scale, levels, y, mults, M, K,
                                    N, L, fold, group_rows, seg, s);
    default:
      return launch<TX, PACKED, 8>(x, codes, scale, levels, y, mults, M, K,
                                   N, L, fold, group_rows, seg, s);
  }
}

// ---- decode: split-K over 256-column tiles (quant_gemv.cuh) ----

constexpr int kTableFloats = 16384;  // the decode table: 64 KB
constexpr int kMaskWords = 4096;     // its count bitmask: 16 KB

// the table's rows per chunk: 64 KB of products (and a 16 KB bitmask)
int gemv_table_rows(int k_per_split, int L, int mt, int seg, bool count) {
  int bk = kTableFloats / (L * mt);
  if (count) bk = min(bk, kMaskWords / ((kBN / seg) * ((L + 31) / 32)));
  return max(1, min(bk, k_per_split));
}

size_t gemv_smem(int k_per_split, int bk, int L, int mt, int seg, bool count,
                 bool packed) {
  const size_t rb = packed ? kBN / 2 : kBN;
  return (size_t)k_per_split * rb +
         gemv::round16(sizeof(float) * (size_t)k_per_split * mt) +
         gemv::round16(sizeof(float) * (size_t)bk * L * mt) +
         sizeof(float) * 256 +
         (count ? sizeof(unsigned) * (size_t)bk * (kBN / seg) *
                      ((L + 31) / 32)
                : 0);
}

// MT rows of x at a table cell, times s, added to acc
template <int MT>
__device__ __forceinline__ void gather_add(float (&acc)[MT], const float* t,
                                           float s) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(t)[q];
      acc[4 * q] = fmaf(s, a.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(s, a.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(s, a.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(s, a.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = fmaf(s, t[m], acc[m]);
  }
}

// t[m] = xr[m] * v for the MT rows of one table entry
template <int MT>
__device__ __forceinline__ void table_entry(float* t, const float* xr,
                                            float v) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(xr)[q];
      reinterpret_cast<float4*>(t)[q] =
          make_float4(a.x * v, a.y * v, a.z * v, a.w * v);
    }
  } else if constexpr (MT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(xr);
    *reinterpret_cast<float2*>(t) = make_float2(a.x * v, a.y * v);
  } else {
    t[0] = xr[0] * v;
  }
}

// grid (N / 256 column tiles, splits, M tiles of MT rows); thread = column
template <typename TX, int MT, bool PACKED>
__global__ void __launch_bounds__(kBN)
reuse_gemv_kernel(const TX* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ levels, void* __restrict__ y,
                  int out_bf16, float* __restrict__ part,
                  int* __restrict__ counters, int* __restrict__ mults, int M,
                  int N, int L, int fold, int seg, int bk,
                  gemv::SplitPlan sp) {
  constexpr int RB = PACKED ? kBN / 2 : kBN;  // code bytes a row
  constexpr int VPR = RB / 16;
  extern __shared__ float4 smem4[];
  const int kps = sp.k_per_split;
  uint8_t* cs = reinterpret_cast<uint8_t*>(smem4);          // [kps][RB]
  float* xs = reinterpret_cast<float*>(cs + (size_t)kps * RB);  // [kps][MT]
  float* table = xs + gemv::round16(sizeof(float) * kps * MT) / 4;
  float* lv = table + gemv::round16(sizeof(float) * bk * L * MT) / 4;
  unsigned* mask = reinterpret_cast<unsigned*>(lv + 256);  // [bk][nsub][w]

  const int tid = threadIdx.x, tile = blockIdx.x, z = blockIdx.y;
  const int n = tile * kBN + tid;
  const bool n_ok = n < N;
  const int m0 = blockIdx.z * MT;
  const int K = sp.K;
  const int kbeg = z * kps, kend = min(K, kbeg + kps), rows = kend - kbeg;

  // every code load of the slice in flight first: they land while the
  // first table is built
  const int row_bytes = PACKED ? N / 2 : N;
  const int byte0 = tile * RB;
  for (int i = tid; i < rows * VPR; i += kBN) {
    const int r = i / VPR, b = byte0 + (i % VPR) * 16;
    const bool ok = b < row_bytes;
    cp_async16(cs + r * RB + (i % VPR) * 16,
               codes + (size_t)(kbeg + r) * row_bytes + (ok ? b : 0), ok);
  }
  cp_async_commit();
  // x's [MT rows, slice] once, as f32 [slice][MT]; rows past M are 0
#pragma unroll 8
  for (int i = tid; i < rows * MT; i += kBN) {
    const int m = i / rows, r = i % rows;
    const float v = to_f32(x[(size_t)min(m0 + m, M - 1) * K + kbeg + r]);
    xs[r * MT + m] = m0 + m < M ? v : 0.f;
  }
  for (int i = tid; i < L; i += kBN) lv[i] = levels[i];

  const bool count = mults != nullptr && blockIdx.z == 0;
  const int words = (L + 31) / 32;
  const int nsub = kBN / seg;
  const int sub = tid / seg;
  const int mask_words = bk * nsub * words;
  const int half = L >> 1;
  const bool defer = sp.defer();
  const int col = PACKED ? tid >> 1 : tid;

  float acc[MT], grp[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = grp[m] = 0.f;
  int g = kbeg / sp.group_rows;
  int g_end = min((g + 1) * sp.group_rows, kend);
  // the group's scale, issued well before its use at the group's end
  float sc = defer ? 1.f : scale[(size_t)g * N + min(n, N - 1)];
  int my_count = 0;

  for (int k0 = kbeg; k0 < kend; k0 += bk) {
    const int nrow = min(bk, kend - k0);
    __syncthreads();  // the last chunk's reads done; xs and lv written
    if (count)
      for (int i = tid; i < mask_words; i += kBN) mask[i] = 0u;
    // the table build: every alphabet product of the chunk, once; a
    // thread writes its MT products as one contiguous run (16-byte stores
    // for MT >= 4), so a warp's stores fill whole banks
    for (int p = tid; p < nrow * L; p += kBN)
      table_entry<MT>(table + (size_t)p * MT,
                      xs + (k0 - kbeg + p / L) * MT, lv[p % L]);
    if (k0 == kbeg) cp_async_wait<0>();
    __syncthreads();

    if (count) {
      if (n_ok)
        for (int j = 0; j < nrow; ++j) {
          const int c = code_of<PACKED>(cs[(k0 - kbeg + j) * RB + col], n);
          const int cell = min(fold ? abs(c) : c + half, L - 1);
          atomicOr(&mask[(j * nsub + sub) * words + (cell >> 5)],
                   1u << (cell & 31));
        }
      __syncthreads();
      for (int i = tid; i < mask_words; i += kBN) my_count += __popc(mask[i]);
    }

    // the reuse path: a signed table read per code, sums per scale group;
    // the rows of a group run unbranched, 8 at a time, so their table
    // reads are in flight together
    auto gather = [&](int j) {
      const int c = code_of<PACKED>(cs[(k0 - kbeg + j) * RB + col], n);
      const int cell = min(fold ? abs(c) : c + half, L - 1);
      gather_add<MT>(grp, table + (size_t)(j * L + cell) * MT,
                     fold && c < 0 ? -1.f : 1.f);
    };
    for (int j0 = 0; j0 < nrow;) {
      const int j1 = min(nrow, g_end - k0);  // this group's rows of the chunk
      int j = j0;
      for (; j + 8 <= j1; j += 8)
#pragma unroll
        for (int u = 0; u < 8; ++u) gather(j + u);
      for (; j < j1; ++j) gather(j);
      if (k0 + j1 == g_end) {  // group done: its scale times its sum
        const float s = n_ok ? sc : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m] += grp[m] * s;
          grp[m] = 0.f;
        }
        ++g;
        g_end = min((g + 1) * sp.group_rows, kend);
        if (g_end > k0 + j1) sc = scale[(size_t)g * N + min(n, N - 1)];
      }
      j0 = j1;
    }
  }
  if (count) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      my_count += __shfl_xor_sync(0xffffffffu, my_count, o);
    if ((tid & 31) == 0 && my_count) atomicAdd(mults, my_count);
  }

  if (sp.splits == 1) {
    if (n_ok)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M)
          gemv::store_out(y, (size_t)(m0 + m) * N + n, acc[m], out_bf16);
    return;
  }
  const int slot = blockIdx.z * gridDim.x + tile;  // (M tile, column tile)
  float* base = part + (size_t)slot * sp.splits * MT * kBN;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    base[((size_t)z * MT + m) * kBN + tid] = acc[m];
  if (!gemv::arrive_last(counters + slot, sp.splits)) return;
  float total[MT];
  gemv::merge<MT>(base + tid, MT * kBN, kBN, sp, scale, min(n, N - 1), N,
                  total);
  if (n_ok)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < M)
        gemv::store_out(y, (size_t)(m0 + m) * N + n, total[m], out_bf16);
  if (tid == 0) counters[slot] = 0;
}

template <typename TX, int MT, bool PACKED>
int gemv_launch(const void* x, const void* codes, const float* scale,
                const float* levels, void* y, int out_bf16, float* part,
                int* counters, int* mults, int M, int N, int L, int fold,
                int seg, const gemv::SplitPlan& sp, cudaStream_t stream) {
  auto kernel = reuse_gemv_kernel<TX, MT, PACKED>;
  static size_t reserved = 0;
  const bool count = mults != nullptr;
  const int bk = gemv_table_rows(sp.k_per_split, L, MT, seg, count);
  const size_t smem = gemv_smem(sp.k_per_split, bk, L, MT, seg, count,
                                PACKED);
  if (smem > gemv::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = gemv::reserve_smem(kernel, smem, &reserved);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, sp.splits, (M + MT - 1) / MT);
  kernel<<<grid, kBN, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(codes), scale,
      levels, y, out_bf16, part, counters, mults, M, N, L, fold, seg, bk,
      sp);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, int MT>
int gemv_launch_p(int packed, const void* x, const void* codes,
                  const float* scale, const float* levels, void* y,
                  int out_bf16, float* part, int* counters, int* mults, int M,
                  int N, int L, int fold, int seg, const gemv::SplitPlan& sp,
                  cudaStream_t s) {
  return packed ? gemv_launch<TX, MT, true>(x, codes, scale, levels, y,
                                             out_bf16, part, counters, mults,
                                             M, N, L, fold, seg, sp, s)
                : gemv_launch<TX, MT, false>(x, codes, scale, levels, y,
                                              out_bf16, part, counters, mults,
                                              M, N, L, fold, seg, sp, s);
}

template <typename TX>
int gemv_launch_m(int mt, int packed, const void* x, const void* codes,
                  const float* scale, const float* levels, void* y,
                  int out_bf16, float* part, int* counters, int* mults, int M,
                  int N, int L, int fold, int seg, const gemv::SplitPlan& sp,
                  cudaStream_t s) {
  switch (mt) {
    case 1:
      return gemv_launch_p<TX, 1>(packed, x, codes, scale, levels, y,
                                  out_bf16, part, counters, mults, M, N, L,
                                  fold, seg, sp, s);
    case 2:
      return gemv_launch_p<TX, 2>(packed, x, codes, scale, levels, y,
                                  out_bf16, part, counters, mults, M, N, L,
                                  fold, seg, sp, s);
    default:
      return gemv_launch_p<TX, 4>(packed, x, codes, scale, levels, y,
                                  out_bf16, part, counters, mults, M, N, L,
                                  fold, seg, sp, s);
  }
}

}  // namespace

// The table path over all of K: x: [M,K] f32 (x_bf16 = 0) or bf16; codes:
// [K,N] int8 or [K,N/2] uint8 (packed = 1); scale: [n_scale_rows, N] f32;
// levels: [L] f32 with L <= 256; fold: 1 = cell |c| with the sign on read,
// 0 = cell c + L/2; seg: the counting segment, a power of two in [8, 256]
// dividing N; mults: int32 scalar the count is added to (zero it first), or
// NULL for no count; y: [M,N] f32 (M = 0: the count only).
extern "C" int reuse_matmul_launch(const void* x, int x_bf16, const void* codes,
                                   const float* scale, const float* levels,
                                   float* y, int* mults, int M, int K, int N,
                                   int packed, int L, int fold,
                                   int n_scale_rows, int seg, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || L <= 0 || L > 256 || n_scale_rows <= 0 ||
      K % n_scale_rows || (packed && N % 2) || seg < 8 || seg > kBN ||
      (seg & (seg - 1)) || N % seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_rows = K / n_scale_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return packed ? launch_bk<__nv_bfloat16, true>(x, codes, scale, levels, y,
                                                   mults, M, K, N, L, fold,
                                                   group_rows, seg, s)
                  : launch_bk<__nv_bfloat16, false>(x, codes, scale, levels, y,
                                                    mults, M, K, N, L, fold,
                                                    group_rows, seg, s);
  return packed ? launch_bk<float, true>(x, codes, scale, levels, y, mults, M,
                                         K, N, L, fold, group_rows, seg, s)
                : launch_bk<float, false>(x, codes, scale, levels, y, mults, M,
                                          K, N, L, fold, group_rows, seg, s);
}

// The decode path: x [M,K] f32 (x_bf16 = 0) or bf16 with M >= 1; codes
// [K,N] int8 or [K,N/2] uint8 (packed = 1), 16-byte aligned, N a multiple
// of 16 (32 packed); scale, levels, fold, seg, mults as above; y [M,N] f32,
// or bf16 when out_bf16 = 1. The host's plan: M tiles of mt in {1, 2, 4}
// rows, `splits` K splits of k_per_split rows (none straddles a scale
// group); part: f32 scratch of ceil(N/256) * ceil(M/mt) * splits * mt * 256
// floats and counters: ceil(N/256) * ceil(M/mt) int32 at 0 (left at 0),
// both NULL for one split.
extern "C" int reuse_matmul_gemv_launch(
    const void* x, int x_bf16, const void* codes, const float* scale,
    const float* levels, void* y, int out_bf16, float* part, int* counters,
    int* mults, int M, int K, int N, int packed, int L, int fold,
    int n_scale_rows, int seg, int mt, int k_per_split, int splits,
    void* stream) {
  const gemv::SplitPlan sp{K, k_per_split, splits,
                           n_scale_rows > 0 ? K / n_scale_rows : 0};
  if (M < 1 || N <= 0 || L <= 0 || L > 256 || n_scale_rows <= 0 ||
      K % n_scale_rows || N % (packed ? 32 : 16) || seg < 8 || seg > kBN ||
      (seg & (seg - 1)) || N % seg || (mt != 1 && mt != 2 && mt != 4) ||
      reinterpret_cast<uintptr_t>(codes) % 16 ||
      !gemv::plan_ok(sp, n_scale_rows) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? gemv_launch_m<__nv_bfloat16>(mt, packed, x, codes, scale,
                                               levels, y, out_bf16, part,
                                               counters, mults, M, N, L, fold,
                                               seg, sp, s)
                : gemv_launch_m<float>(mt, packed, x, codes, scale, levels, y,
                                       out_bf16, part, counters, mults, M, N,
                                       L, fold, seg, sp, s);
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
                                        mults, 0, K, N, packed, L, 1,
                                        n_scale_rows, seg, stream);
    if (err) return err;
  }
  return qgemm::quant_gemm_launch(x, codes, scale, y, M, K, N, packed,
                                  n_scale_rows, out_bf16,
                                  static_cast<cudaStream_t>(stream));
}
