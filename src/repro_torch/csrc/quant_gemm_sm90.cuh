// Shared Hopper mainloop of the two quantized matmuls at prefill:
//   y[m,n] = sum_g scale[g,n] * sum_{k in group g} x[m,k] * c[k,n]
// for bf16 x [M,K] and affine integer codes c (int8 [K,N], or int4 packed
// two per byte [K,N/2], low nibble = even column), the [G,N] f32 scale with
// the affine 1/qmax folded in. Included by axllm_matmul.cu and
// reuse_matmul.cu; each exposes its own C launch function around
// quant_gemm_launch().
//
// Why the tensor cores compute the reuse kernel's own association: an
// affine code is its own level (sign(c) * levels[|c|] == c), codes up to
// |c| = 128 are exact in bf16, and a bf16 x bf16 product is exact in f32.
// So wgmma over bf16 x and bf16-cast codes, summed in f32 within each scale
// group and scaled after the group sum, is the plain version's
// sum_g scale_g * (x_g @ c_g) term for term; only the order of the f32
// additions differs (kernels/ref.py quant_gemm_ref emulates it).
//
// The mainloop, one 128 x 128 output tile per block (288 threads):
//   * one producer warp keeps a ring of stages in flight: the x tile
//     [128, 64] bf16 (TMA, 128-byte swizzle) and the code tile [64, 128]
//     int8 or [64, 64] packed (TMA, unswizzled), both signalled on the
//     stage's `full` mbarrier; ragged M, N and K read as zeros;
//   * two consumer warpgroups (64 rows each) convert the stage's codes to
//     bf16 into a K-major, 128-byte-swizzled B tile (an 8 x 4 code block
//     per thread, integer and FADD ops only: no I2F), fence the async
//     proxy, meet on a named barrier, and issue four wgmma.m64n128k16
//     (bf16 x bf16 -> f32). Conversion of tile k+1 overlaps the wgmmas of
//     tile k; a stage is released on its `empty` mbarrier once both
//     warpgroups' wgmmas on it completed;
//   * per-group scales: at each group's last tile the consumers wait for
//     their wgmmas, add partial * scale[g, n] into a second f32
//     accumulator and restart the partial; per-channel and per-tensor
//     scales multiply once in the epilogue;
//   * the epilogue writes f32, or bf16 rounded to nearest even as
//     torch's .to(bfloat16) does, straight from the accumulators, masked.
//
// What bounds it on an H100: at M4096 K768 N2048 the operations (12.9
// GFLOP, 0.013 ms at 989 TFLOP/s bf16) dominate the bytes (6.3 MB in,
// 33.5 MB of f32 out). But each block re-reads its x and code tiles from
// L2 (148 MB over the grid at that shape), and a tile's loads take longer
// than its wgmmas. So a grid of more than one wave runs two blocks per SM,
// each with two stages, and one block's prologue and epilogue overlap the
// other's mainloop; a grid that does not fill the card runs one block per
// SM with four stages in flight. The role of each warp is made
// warp-uniform and every wgmma wait sits outside any branch: otherwise
// ptxas serializes the wgmmas (advisory C7518) and conversion no longer
// overlaps them. The codes stay int8 (or int4) in device memory: their
// bf16 form exists only in shared memory.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace qgemm {

constexpr int kBM = 128;    // rows of x per block: two warpgroups of 64
constexpr int kBN = 128;    // output columns per block
constexpr int kBK = 64;     // K per stage: one 128-byte bf16 row of x
constexpr int kBBufs = 3;   // converted B tiles: tile k is written while the
                            // other warpgroup may still read tile k-2
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kATile = kBM * kBK * 2;       // 16 KB bf16
constexpr int kBTile = kBN * kBK * 2;       // 16 KB bf16
constexpr int kCTile = kBK * kBN;           // 8 KB int8 (4 KB packed)

// A block's pipeline: STAGES x and code tiles in flight, MINB blocks
// resident per SM.
template <int STAGES, int MINB>
struct Pipe {
  static constexpr int kStages = STAGES, kMinBlocks = MINB;
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * (kATile + kCTile) +
                                  (size_t)kBBufs * kBTile +
                                  2 * STAGES * sizeof(uint64_t);
};
// two blocks per SM (97 KB each, at most 113 registers a thread): one
// block's prologue and epilogue overlap the other's mainloop; grids of
// more than one wave
using Pair = Pipe<2, 2>;
// one block per SM with four stages in flight: a grid that does not fill
// the card (two stages leave its loads' latency exposed), and per-group
// scales, whose second accumulator does not fit two blocks per SM
using Deep = Pipe<4, 1>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); the tile base is 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (+)= A[64 x 16] * B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The 8 codes of column j of a thread's 8 x 4 block as 8 bf16 (k in
// order). int8: raw[r] holds row r's 4 codes, each byte already XORed with
// 0x80 (u = c + 128); the float with bits 0x4B000000 | u is 2^23 + u
// exactly, so subtracting 2^23 + 128 leaves c, and the upper half of an
// f32 integer of magnitude <= 128 is that integer in bf16. Packed: raw[r]
// holds row r's 4 nibbles (low nibble = even column); u = nibble ^ 8 is
// c + 8 for the sign-extended nibble c, the same trick.
template <bool PACKED>
__device__ __forceinline__ uint4 column_bf16(const uint32_t (&raw)[8], int j) {
  float f[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t bits =
        PACKED ? (((raw[r] >> (4 * j)) & 0xFu) ^ 0x4B000008u)
               : __byte_perm(raw[r], 0x4B000000u, 0x7540u | j);
    f[r] = __uint_as_float(bits) - (PACKED ? 8388616.f : 8388736.f);
  }
  uint4 v;
  v.x = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  v.y = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  v.z = __byte_perm(__float_as_uint(f[4]), __float_as_uint(f[5]), 0x7632);
  v.w = __byte_perm(__float_as_uint(f[6]), __float_as_uint(f[7]), 0x7632);
  return v;
}

// Consumer thread t converts rows 8*(t/32) .. +7, columns 4*(t%32) .. +3
// of the stage's code tile into the K-major swizzled B tile: element
// (n, k) at n*128 + ((k/8) ^ (n%8))*16 + (k%8)*2 bytes. Reads are one
// 128-byte (64-byte packed) row per warp instruction; each store
// instruction writes column (i + lane/2) % 4 of the thread's block, so the
// 8 threads of a quarter-warp hit 8 distinct 16-byte bank groups.
template <bool PACKED>
__device__ __forceinline__ void convert_stage(const uint8_t* ctile,
                                              uint8_t* btile, int t) {
  const int kc = t >> 5, lane = t & 31;
  uint32_t raw[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = kc * 8 + r;
    raw[r] = PACKED ? *reinterpret_cast<const uint16_t*>(
                          ctile + k * (kBN / 2) + lane * 2)
                    : *reinterpret_cast<const uint32_t*>(
                          ctile + k * kBN + lane * 4) ^ 0x80808080u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + (lane >> 1)) & 3;
    const int n = lane * 4 + j;
    *reinterpret_cast<uint4*>(btile + n * 128 + ((kc ^ (n & 7)) << 4)) =
        column_bf16<PACKED>(raw, j);
  }
}

// The scales of columns n and n + 1 in row `g` of the [G, N] scale; 0 past
// N (N is even, so n < N means n + 1 < N).
__device__ __forceinline__ float2 scale_pair(const float* __restrict__ scale,
                                             int g, int n, int N) {
  return n < N ? __ldg(reinterpret_cast<const float2*>(scale +
                                                       (size_t)g * N + n))
               : make_float2(0.f, 0.f);
}

template <class P, bool PACKED, bool GROUPED, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
quant_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_c,
                  const float* __restrict__ scale, void* __restrict__ y, int M,
                  int K, int N, int tiles_per_group) {
  constexpr int S = P::kStages;
  constexpr int kCBytes = PACKED ? kCTile / 2 : kCTile;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = a_ring + S * kATile;
  uint8_t* c_ring = b_ring + kBBufs * kBTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_ring + S * kCTile);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + S);

  const int tid = threadIdx.x;
  // warp-uniform role, so that ptxas does not serialize the wgmmas of a
  // path it would otherwise consider divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_k = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers / 128) {  // the producer warp: TMA loads only
    if (tid == kConsumers) {
      const int c_col = PACKED ? n0 / 2 : n0;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(empty0 + 8 * s, ((kt / S) + 1) & 1);
        mbar_expect_tx(full0 + 8 * s, kATile + kCBytes);
        tma_load_2d(smem_u32(a_ring + s * kATile), &map_x, full0 + 8 * s,
                    kt * kBK, m0);
        tma_load_2d(smem_u32(c_ring + s * kCTile), &map_c, full0 + 8 * s,
                    c_col, kt * kBK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64*wg .. +63. Every wgmma wait
  // sits outside any branch: one group of tiles per scale row (all of K
  // for one row), a wait for the newest but one wgmma batch per tile, a
  // wait for all at the group's end.
  const int lane = tid & 31;
  const int tiles = GROUPED ? tiles_per_group : n_k;
  const int groups = GROUPED ? n_k / tiles_per_group : 1;
  float acc[kBN / 2];
  float out[GROUPED ? kBN / 2 : 1];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) out[i] = 0.f;
  }
  int kt = 0;
  for (int g = 0; g < groups; ++g) {
    for (int t = 0; t < tiles; ++t, ++kt) {
      const int s = kt % S;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      uint8_t* btile = b_ring + (kt % kBBufs) * kBTile;
      convert_stage<PACKED>(c_ring + s * kCTile, btile, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

      const uint64_t da =
          sw128_desc(smem_u32(a_ring + s * kATile + wg * 8192));
      const uint64_t db = sw128_desc(smem_u32(btile));
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // +32 bytes per 16 of K
        wgmma_n128(acc, da + 2 * kk, db + 2 * kk, (kk > 0 || t > 0) ? 1 : 0);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
      wgmma_wait<1>();   // the previous tile's wgmmas are done
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
      if (t > 0) mbar_arrive(empty0 + 8 * ((kt - 1) % S));
    }
    float2 sc[GROUPED ? kBN / 8 : 1];
    if constexpr (GROUPED) {   // loads in flight while the wgmmas finish
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
        sc[jn] = scale_pair(scale, g, n0 + jn * 8 + 2 * (lane & 3), N);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
    mbar_arrive(empty0 + 8 * ((kt - 1) % S));
    if constexpr (GROUPED) {  // the group's sum times its scale
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        out[i] = fmaf(acc[i], (i & 1) ? sc[i / 4].y : sc[i / 4].x, out[i]);
    }
  }

  // accumulator i of this thread: row row0 + 8*((i/2)%2), column
  // n0 + 8*(i/4) + 2*(lane%4) + i%2
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int jn = 0; jn < kBN / 8; ++jn) {
    const int n = n0 + jn * 8 + 2 * (lane & 3);
    if (n >= N) continue;
    const float2 sc = GROUPED ? make_float2(1.f, 1.f)
                              : scale_pair(scale, 0, n, N);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h, i = 4 * jn + 2 * h;
      if (row >= M) continue;
      float v0, v1;
      if constexpr (GROUPED) {
        v0 = out[i];
        v1 = out[i + 1];
      } else {
        v0 = acc[i] * sc.x;
        v1 = acc[i + 1] * sc.y;
      }
      const size_t at = (size_t)row * N + n;
      if constexpr (OUT_BF16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) +
                                           at) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(y) + at) =
            make_float2(v0, v1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link against libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] tensor read in [box_rows, box_cols] boxes;
// out-of-range elements read as zero
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, uint64_t rows, uint64_t cols,
                       uint64_t row_bytes, uint32_t box_rows,
                       uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P, bool PACKED, bool GROUPED, bool OUT_BF16>
int launch_typed(const void* x, const void* codes, const float* scale,
                 void* y, int M, int K, int N, int tiles_per_group,
                 cudaStream_t stream) {
  CUtensorMap mx, mc;
  const int c_cols = PACKED ? N / 2 : N;
  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                  (uint64_t)K * 2, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, K, c_cols,
                  (uint64_t)c_cols, kBK, PACKED ? kBN / 2 : kBN,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = quant_gemm_kernel<P, PACKED, GROUPED, OUT_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(mx, mc, scale, y, M, K, N,
                                               tiles_per_group);
  return static_cast<int>(cudaGetLastError());
}

template <class P, bool GROUPED>
int launch_pipe(const void* x, const void* codes, const float* scale, void* y,
                int M, int K, int N, int tpg, int packed, int out_bf16,
                cudaStream_t s) {
  if (packed)
    return out_bf16 ? launch_typed<P, true, GROUPED, true>(x, codes, scale, y,
                                                           M, K, N, tpg, s)
                    : launch_typed<P, true, GROUPED, false>(
                          x, codes, scale, y, M, K, N, tpg, s);
  return out_bf16 ? launch_typed<P, false, GROUPED, true>(x, codes, scale, y,
                                                          M, K, N, tpg, s)
                  : launch_typed<P, false, GROUPED, false>(x, codes, scale, y,
                                                           M, K, N, tpg, s);
}

// Whether a grid of 128 x 128 tiles fills the card (`sms` SMs) at least
// once: then two blocks per SM, else one with a deeper pipeline.
inline bool fills_card(int M, int N, int sms) {
  return (long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM) > sms;
}

// x: [M,K] bf16; codes: [K,N] int8 or [K,N/2] uint8 (packed = 1); scale:
// [n_scale_rows, N] f32, one row or groups of a multiple of kBK rows; y:
// [M,N] f32 or bf16 (out_bf16 = 1). TMA needs 16-byte aligned rows and
// bases: K % 8 == 0, N % 16 == 0 (N % 32 == 0 packed).
inline int quant_gemm_launch(const void* x, const void* codes,
                             const float* scale, void* y, int M, int K, int N,
                             int packed, int n_scale_rows, int out_bf16,
                             cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % (packed ? 32 : 16) ||
      n_scale_rows <= 0 || K % n_scale_rows ||
      (n_scale_rows > 1 && (K / n_scale_rows) % kBK) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_scale_rows > 1)
    return launch_pipe<Deep, true>(x, codes, scale, y, M, K, N,
                                   K / n_scale_rows / kBK, packed, out_bf16,
                                   stream);
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fills_card(M, N, sms))
    return launch_pipe<Pair, false>(x, codes, scale, y, M, K, N, 0, packed,
                                    out_bf16, stream);
  return launch_pipe<Deep, false>(x, codes, scale, y, M, K, N, 0, packed,
                                  out_bf16, stream);
}

}  // namespace qgemm
