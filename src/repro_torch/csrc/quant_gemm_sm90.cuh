// Shared Hopper mainloop of the two quantized matmuls at prefill:
//   y[m,n] = sum_g scale[g,n] * sum_{k in group g} x[m,k] * level(c[k,n])
// for bf16 x [M,K] and integer codes c (int8 [K,N], or int4 packed two per
// byte [K,N/2], low nibble = even column) of one of three alphabets, and
// the [G,N] f32 scale (with the affine 1/qmax folded in). Included by
// axllm_matmul.cu and reuse_matmul.cu; each exposes its own C launch
// function around quant_gemm_launch().
//
// Why the tensor cores compute the plain association (kernels/ref.py
// reuse_matmul_ref) term for term:
//   * affine: a code is its own level (sign(c) * levels[|c|] == c), codes
//     up to |c| = 128 are exact in bf16, and a bf16 x bf16 product is
//     exact in f32. So wgmma over bf16 x and bf16-cast codes, summed in
//     f32 within each scale group and scaled after the group sum, is the
//     plain version's sum_g scale_g * (x_g @ c_g);
//   * codebooks (NF4: 16 f32 quantiles, code + 8 indexes them; identity-8:
//     c / 127): a level is not exact in bf16, so it is split into three
//     bf16 terms, hi = bf16(l), mid = bf16(l - hi), lo = bf16(l - hi -
//     mid), with hi + mid + lo == l exactly (each subtraction is exact in
//     f32, and three 8-bit significands cover f32's 24). Each x * term is
//     exact in f32, and three wgmma passes over the same x tile against the
//     three term tiles add into the group's f32 sum. Two terms would leave
//     up to 2^-17 of each level out: not the plain version's products, so
//     three it is.
// Only the order of the f32 additions differs (kernels/ref.py
// quant_gemm_ref emulates it). The codes stay int8 (or int4) in device
// memory: their bf16 values or terms exist only in shared memory.
//
// The mainloop, one 128 x 128 output tile per block (288 threads):
//   * one producer warp keeps a ring of stages in flight: the x tile
//     [128, 64] bf16 (TMA, 128-byte swizzle) and the code tile [64, 128]
//     int8 or [64, 64] packed (TMA, unswizzled), both signalled on the
//     stage's `full` mbarrier; ragged M, N and K read as zeros;
//   * two consumer warpgroups (64 rows each) convert the stage's codes to
//     bf16 into a set of K-major, 128-byte-swizzled B tiles (an 8 x 4 code
//     block per thread; one tile for affine codes, three term tiles for a
//     codebook, each code read and its selectors or level computed once),
//     fence the async proxy, meet on a named barrier, and issue four
//     wgmma.m64n128k16 (bf16 x bf16 -> f32) a B tile into one commit
//     group. Conversion of tile k+1 overlaps the wgmmas of tile k; a stage
//     is released on its `empty` mbarrier once both warpgroups' wgmmas on
//     it completed;
//   * conversion, integer and FADD ops only (no I2F), the alphabet a
//     template parameter: affine codes are their value (below);
//     identity-8 levels are computed as c / 127, correctly rounded, from
//     the code (an fma-corrected product), then split; NF4 reads its 16
//     levels' three terms once per block into shared memory, and picks
//     each term with byte permutes from that term's 8-register table
//     (__byte_perm: no per-code shared-memory read, which would
//     bank-conflict);
//   * per-group scales: at each group's last tile the consumers wait for
//     their wgmmas, add partial * scale[g, n] into a second f32
//     accumulator and restart the partial; per-channel and per-tensor
//     scales multiply once in the epilogue. A codebook's partial also
//     restarts every `sum_rows` rows of its scale row (the caller's
//     kernels/ref.py CODEBOOK_SUM_ROWS), whatever the scale rows: the
//     tensor cores' f32 accumulation truncates, and the three passes' long
//     chain over all of K drifted close to 1e-5 of the output scale from
//     the plain version at K2048 on an H100; restarted every 256 rows, it
//     stays within 3e-6 (chip_smoke.py);
//   * the epilogue writes f32, or bf16 rounded to nearest even as
//     torch's .to(bfloat16) does, straight from the accumulators, masked.
//
// What bounds it on an H100: at M4096 K768 N2048 the operations (12.9
// GFLOP, 0.013 ms at 989 TFLOP/s bf16) dominate the bytes (6.3 MB in,
// 33.5 MB of f32 out); a codebook runs three times the wgmmas for the same
// function, and its bound stays the function's. Each block re-reads its x
// and code tiles from L2 (148 MB over the grid at that shape), and an
// affine tile's loads take longer than its wgmmas. So an affine grid of
// more than one wave runs two blocks per SM, each with two stages, and one
// block's prologue and epilogue overlap the other's mainloop; other affine
// grids (per-group scales, grids that do not fill the card) run one block
// per SM with four stages in flight, and codebooks one block per SM with
// three stages and three sets of three term tiles (217 KB). The role
// of each warp is made warp-uniform and every wgmma wait sits outside any
// branch: otherwise ptxas serializes the wgmmas (advisory C7518) and
// conversion no longer overlaps them.

#pragma once

#include "sm90.cuh"

namespace qgemm {

constexpr int kBM = 128;    // rows of x per block: two warpgroups of 64
constexpr int kBN = 128;    // output columns per block
constexpr int kBK = 64;     // K per stage: one 128-byte bf16 row of x
constexpr int kBBufs = 3;   // sets of converted B tiles: tile k's set is
                            // written while the other warpgroup may still
                            // read tile k-2's
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kATile = kBM * kBK * 2;       // 16 KB bf16
constexpr int kBTile = kBN * kBK * 2;       // 16 KB bf16
constexpr int kCTile = kBK * kBN;           // 8 KB int8 (4 KB packed)
constexpr int kTerms = 3;                   // bf16 terms of a codebook level
constexpr int kLutBytes = kTerms * 16 * 2;  // NF4's terms, bf16

// The code alphabets, named by the caller (kernels/axllm_matmul.py
// TC_AFFINE, TC_NF4, TC_IDENTITY8) and a template parameter of the kernel:
// each converts its own way, and no runtime branch sits between the
// wgmmas.
enum Alphabet : int { kAffine = 0, kNF4 = 1, kIdentity8 = 2 };

// A block's pipeline: STAGES x and code tiles in flight, MINB blocks
// resident per SM, TERMS B tiles (a set) converted from each code tile.
template <int STAGES, int MINB, int TERMS = 1>
struct Pipe {
  static constexpr int kStages = STAGES, kMinBlocks = MINB, kTerms = TERMS;
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * (kATile + kCTile) +
                                  (size_t)kBBufs * TERMS * kBTile +
                                  2 * STAGES * sizeof(uint64_t) + kLutBytes;
};
// two blocks per SM (97 KB each, at most 113 registers a thread): one
// block's prologue and epilogue overlap the other's mainloop; grids of
// more than one wave
using Pair = Pipe<2, 2>;
// one block per SM with four stages in flight: a grid that does not fill
// the card (two stages leave its loads' latency exposed), and per-group
// scales, whose second accumulator does not fit two blocks per SM
using Deep = Pipe<4, 1>;
// codebooks: three term tiles a code tile (sets of 48 KB), one block per
// SM with three stages in flight (217 KB)
using Book = Pipe<3, 1, kTerms>;

// The 8 codes of column j of a thread's 8 x 4 block as 8 bf16 (k in
// order), affine codes. int8: raw[r] holds row r's 4 codes, each byte
// already XORed with 0x80 (u = c + 128); the float with bits 0x4B000000 |
// u is 2^23 + u exactly, so subtracting 2^23 + 128 leaves c, and the upper
// half of an f32 integer of magnitude <= 128 is that integer in bf16.
// Packed: raw[r] holds row r's 4 nibbles (low nibble = even column); u =
// nibble ^ 8 is c + 8 for the sign-extended nibble c, the same trick.
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

// a (low half) and b (high half) rounded to bf16, nearest even
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The identity-8 level of code c (an f32 integer in [-128, 127]): c / 127
// rounded to nearest even, as core/quantization.identity_codebook(8)
// divides, from the product by 1/127 (bits 0x3C010204) and one fma
// correction. Exact for all 256 codes (tests/test_torch_quant_gemm.py
// checks the sequence in rational arithmetic).
__device__ __forceinline__ float identity8_level(float c) {
  const float inv = __uint_as_float(0x3C010204u);
  const float q = __fmul_rn(c, inv);
  return __fmaf_rn(__fmaf_rn(-q, 127.f, c), inv, q);
}

// The byte permutes that pick entries a and b of a 16-entry bf16 table
// t (t[i] = entries 2i, 2i+1) as a bf16 pair, with a in the low nibble of
// u's byte 0 and b in that of its byte 1 (higher bits are ignored): one
// permute picks entry (a % 4) of each group of 4, two more pick by bit 2
// and one by bit 3. The selectors depend on the codes only, so the three
// term tables share them.
struct Lut16Sel {
  uint32_t low, bit2, bit3;
};
__device__ __forceinline__ Lut16Sel lut16_sel(uint32_t u) {
  return {((u & 0x0303u) << 1) * 0x11u + 0x1010u,
          0x3210u + ((u >> 2) & 0x0101u) * 0x44u,
          0x3210u + ((u >> 3) & 0x0101u) * 0x44u};
}
__device__ __forceinline__ uint32_t lut16_pair(const Lut16Sel& s,
                                               const uint32_t (&t)[8]) {
  const uint32_t g0 = __byte_perm(t[0], t[1], s.low);
  const uint32_t g1 = __byte_perm(t[2], t[3], s.low);
  const uint32_t g2 = __byte_perm(t[4], t[5], s.low);
  const uint32_t g3 = __byte_perm(t[6], t[7], s.low);
  return __byte_perm(__byte_perm(g0, g1, s.bit2), __byte_perm(g2, g3, s.bit2),
                     s.bit3);
}

// Stores the three bf16 terms of column j of a thread's 8 x 4 block of
// codebook ALPHABET codes, k in order, at `at` and kBTile and 2 kBTile
// bytes on: hi = bf16(l), mid = bf16(l - hi), lo = bf16(l - hi - mid),
// each subtraction exact in f32 (kernels/ref.py level_terms); word i of a
// term holds rows 2i, 2i+1 (the lower k in the low half). raw[r] as
// convert_stage loads it: identity-8, row r's 4 codes XORed with 0x80 (as
// affine int8); NF4, row r's 4 codes (int8, XORed with 0x08) or 4 nibbles
// (packed, XORed with 0x8888), so that the low nibble of each is its table
// index c + 8. NF4 reads each term's table (8 registers) from `lut` in
// shared memory while it picks that term, so only one table is live.
template <bool PACKED, int ALPHABET>
__device__ __forceinline__ void store_terms(const uint32_t (&raw)[8], int j,
                                            const uint32_t* lut,
                                            uint8_t* at) {
  if constexpr (ALPHABET == kIdentity8) {
    uint32_t w[kTerms][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = identity8_level(
          __uint_as_float(__byte_perm(raw[2 * i], 0x4B000000u, 0x7540u | j)) -
          8388736.f);
      float b = identity8_level(
          __uint_as_float(
              __byte_perm(raw[2 * i + 1], 0x4B000000u, 0x7540u | j)) -
          8388736.f);
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
        const uint32_t h = bf16x2_bits(a, b);
        w[term][i] = h;
        a -= __uint_as_float(h << 16);
        b -= __uint_as_float(h & 0xFFFF0000u);
      }
    }
#pragma unroll
    for (int term = 0; term < kTerms; ++term)
      *reinterpret_cast<uint4*>(at + term * kBTile) =
          make_uint4(w[term][0], w[term][1], w[term][2], w[term][3]);
  } else {
    Lut16Sel sel[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t r0 = raw[2 * i], r1 = raw[2 * i + 1];
      sel[i] = lut16_sel(PACKED
                             ? __byte_perm(r0 >> (4 * j), r1 >> (4 * j),
                                           0x0040u)
                             : __byte_perm(r0, r1, j | ((j + 4) << 4)));
    }
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      // broadcast reads: one address a warp
      const uint4 t0 = reinterpret_cast<const uint4*>(lut)[2 * term];
      const uint4 t1 = reinterpret_cast<const uint4*>(lut)[2 * term + 1];
      const uint32_t tab[8] = {t0.x, t0.y, t0.z, t0.w,
                               t1.x, t1.y, t1.z, t1.w};
      *reinterpret_cast<uint4*>(at + term * kBTile) = make_uint4(
          lut16_pair(sel[0], tab), lut16_pair(sel[1], tab),
          lut16_pair(sel[2], tab), lut16_pair(sel[3], tab));
    }
  }
}

// Consumer thread t converts rows 8*(t/32) .. +7, columns 4*(t%32) .. +3
// of the stage's code tile into the tile's set of K-major swizzled B tiles
// (affine codes: one, their bf16 values; a codebook: its three terms,
// kBTile bytes apart): element (n, k) at n*128 + ((k/8) ^ (n%8))*16 +
// (k%8)*2 bytes. Reads are one 128-byte (64-byte packed) row per warp
// instruction; each store instruction writes column (i + lane/2) % 4 of
// the thread's block, so the 8 threads of a quarter-warp hit 8 distinct
// 16-byte bank groups. `lut`: NF4's term tables in shared memory,
// [kTerms][16] bf16.
template <bool PACKED, int ALPHABET>
__device__ __forceinline__ void convert_stage(const uint8_t* ctile,
                                              uint8_t* bset, int t,
                                              const uint32_t* lut) {
  const int kc = t >> 5, lane = t & 31;
  // the XOR that puts each code where its conversion reads it
  constexpr uint32_t flip =
      ALPHABET == kNF4 ? (PACKED ? 0x8888u : 0x08080808u)
                       : (PACKED ? 0u : 0x80808080u);
  uint32_t raw[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = kc * 8 + r;
    raw[r] = (PACKED ? *reinterpret_cast<const uint16_t*>(
                           ctile + k * (kBN / 2) + lane * 2)
                     : *reinterpret_cast<const uint32_t*>(
                           ctile + k * kBN + lane * 4)) ^ flip;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + (lane >> 1)) & 3;
    const int n = lane * 4 + j;
    uint8_t* at = bset + n * 128 + ((kc ^ (n & 7)) << 4);
    if constexpr (ALPHABET == kAffine)
      *reinterpret_cast<uint4*>(at) = column_bf16<PACKED>(raw, j);
    else
      store_terms<PACKED, ALPHABET>(raw, j, lut, at);
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

// One tile of a warpgroup: convert the stage's codes into the tile's set
// of T B tiles, meet the other warpgroup, issue the T x 4 wgmmas of the
// tile's K (each term's against the same x rows), and wait for the
// previous tile's. The first tile of a partial sum starts it.
template <bool PACKED, int ALPHABET, int T>
__device__ __forceinline__ void mma_tile(float (&acc)[kBN / 2],
                                         const uint8_t* ctile, uint8_t* bset,
                                         uint64_t da, int tid,
                                         const uint32_t* lut, bool first) {
  convert_stage<PACKED, ALPHABET>(ctile, bset, tid, lut);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int term = 0; term < T; ++term) {
    const uint64_t db = sw128_desc(smem_u32(bset + term * kBTile));
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // +32 bytes per 16 of K
      wgmma_ss<kBN>(acc, da + 2 * kk, db + 2 * kk,
                    (kk > 0 || term > 0 || !first) ? 1 : 0);
  }
  wgmma_commit();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
  wgmma_wait<1>();   // the previous tile's wgmmas are done
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
}

template <class P, bool PACKED, bool GROUPED, bool OUT_BF16, int ALPHABET>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
quant_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_c,
                  const float* __restrict__ scale,
                  const float* __restrict__ levels, void* __restrict__ y,
                  int M, int K, int N, int row_tiles, int sum_tiles) {
  constexpr int S = P::kStages;
  constexpr int kCBytes = PACKED ? kCTile / 2 : kCTile;
  constexpr int T = P::kTerms;   // B tiles a code tile
  static_assert((ALPHABET == kAffine) == (T == 1), "a codebook has terms");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;
  uint8_t* b_ring = a_ring + S * kATile;
  uint8_t* c_ring = b_ring + kBBufs * T * kBTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_ring + S * kCTile);
  uint32_t* lut = reinterpret_cast<uint32_t*>(bars + 2 * S);
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
  if (ALPHABET == kNF4 && tid < 16) {  // each level's terms, [term][level]
    float l = levels[tid];
    __nv_bfloat16* terms = reinterpret_cast<__nv_bfloat16*>(lut);
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      const __nv_bfloat16 h = __float2bfloat16_rn(l);
      terms[term * 16 + tid] = h;
      l -= __bfloat162float(h);
    }
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
  // sits outside any branch: a partial sum spans all of K ungrouped, else
  // at most sum_tiles tiles and never past the end of its scale row of
  // row_tiles tiles (the last may be short); a wait for the newest but one
  // wgmma batch after each tile, a wait for all at the partial's end. A
  // partial takes the scale row it lies in.
  const int lane = tid & 31;
  float acc[kBN / 2];
  float out[GROUPED ? kBN / 2 : 1];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) out[i] = 0.f;
  }
  int kt = 0;
  while (kt < n_k) {
    const int row = GROUPED ? kt / row_tiles : 0;
    const int tiles =
        GROUPED ? min(sum_tiles, min(n_k, (row + 1) * row_tiles) - kt) : n_k;
    for (int t = 0; t < tiles; ++t, ++kt) {
      const int s = kt % S;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      const uint8_t* ctile = c_ring + s * kCTile;
      const uint64_t da =
          sw128_desc(smem_u32(a_ring + s * kATile + wg * 8192));
      mma_tile<PACKED, ALPHABET, T>(
          acc, ctile, b_ring + (kt % kBBufs) * T * kBTile, da, tid, lut,
          t == 0);
      // the previous tile's wgmmas are done: release its stage
      if (t > 0) mbar_arrive(empty0 + 8 * ((kt - 1) % S));
    }
    float2 sc[GROUPED ? kBN / 8 : 1];
    if constexpr (GROUPED) {   // loads in flight while the wgmmas finish
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
        sc[jn] = scale_pair(scale, row, n0 + jn * 8 + 2 * (lane & 3), N);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) keep(acc[i]);
    mbar_arrive(empty0 + 8 * ((kt - 1) % S));
    if constexpr (GROUPED) {  // the partial times its scale row
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

// One launch's operands (checked by quant_gemm_launch).
struct Args {
  const void* x;
  const void* codes;
  const float* scale;
  const float* levels;
  void* y;
  int M, K, N, row_tiles, sum_tiles;
  cudaStream_t stream;
};

template <class P, bool PACKED, bool GROUPED, bool OUT_BF16, int ALPHABET>
int launch_typed(const Args& a) {
  CUtensorMap mx, mc;
  const int c_cols = PACKED ? a.N / 2 : a.N;
  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.M, a.K,
                  (uint64_t)a.K * 2, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.codes, a.K, c_cols,
                  (uint64_t)c_cols, kBK, PACKED ? kBN / 2 : kBN,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = quant_gemm_kernel<P, PACKED, GROUPED, OUT_BF16, ALPHABET>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, P::kSmem, a.stream>>>(
      mx, mc, a.scale, a.levels, a.y, a.M, a.K, a.N, a.row_tiles,
      a.sum_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <class P, bool GROUPED, int ALPHABET, bool PACKED>
int launch_out(const Args& a, int out_bf16) {
  return out_bf16 ? launch_typed<P, PACKED, GROUPED, true, ALPHABET>(a)
                  : launch_typed<P, PACKED, GROUPED, false, ALPHABET>(a);
}

// A codebook runs the Book pipe and restarts its partials (GROUPED), and
// identity-8 codes are int8, never packed: quant_gemm_launch sees to all.
template <class P, bool GROUPED>
int launch_pipe(const Args& a, int packed, int out_bf16, int alphabet) {
  if constexpr (P::kTerms > 1) {
    if (alphabet == kIdentity8)
      return launch_out<P, GROUPED, kIdentity8, false>(a, out_bf16);
    return packed ? launch_out<P, GROUPED, kNF4, true>(a, out_bf16)
                  : launch_out<P, GROUPED, kNF4, false>(a, out_bf16);
  } else {
    return packed ? launch_out<P, GROUPED, kAffine, true>(a, out_bf16)
                  : launch_out<P, GROUPED, kAffine, false>(a, out_bf16);
  }
}

// Whether a grid of 128 x 128 tiles fills the card (`sms` SMs) at least
// once: then two blocks per SM, else one with a deeper pipeline.
inline bool fills_card(int M, int N, int sms) {
  return (long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM) > sms;
}

// x: [M,K] bf16; codes: [K,N] int8 or [K,N/2] uint8 (packed = 1); scale:
// [n_scale_rows, N] f32, one row or groups of a multiple of kBK rows;
// alphabet: kAffine (1/qmax folded into the scale), kNF4 (levels: its [16]
// f32 table on the device, code + 8 indexing it) or kIdentity8 (int8
// codes, levels c / 127 computed, levels not read); sum_rows: for a
// codebook, the rows of K a partial sum spans at most, a positive multiple
// of kBK (0 for affine codes, whose partials span their scale row); y:
// [M,N] f32 or bf16 (out_bf16 = 1). TMA needs 16-byte aligned rows and
// bases: K % 8 == 0, N % 16 == 0 (N % 32 == 0 packed).
inline int quant_gemm_launch(const void* x, const void* codes,
                             const float* scale, const float* levels,
                             void* y, int M, int K, int N, int packed,
                             int n_scale_rows, int alphabet, int sum_rows,
                             int out_bf16, cudaStream_t stream) {
  const bool book = alphabet != kAffine;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % (packed ? 32 : 16) ||
      n_scale_rows <= 0 || K % n_scale_rows ||
      (n_scale_rows > 1 && (K / n_scale_rows) % kBK) ||
      (alphabet != kAffine && alphabet != kNF4 && alphabet != kIdentity8) ||
      (book ? sum_rows <= 0 || sum_rows % kBK : sum_rows != 0) ||
      (alphabet == kNF4 && levels == nullptr) ||
      (alphabet == kIdentity8 && packed) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_k = (K + kBK - 1) / kBK;
  const int row_tiles = n_scale_rows > 1 ? K / n_scale_rows / kBK : n_k;
  const int sum_tiles =
      book && sum_rows / kBK < row_tiles ? sum_rows / kBK : row_tiles;
  Args a{x, codes, scale, levels, y, M, K, N, row_tiles, sum_tiles, stream};
  if (book) return launch_pipe<Book, true>(a, packed, out_bf16, alphabet);
  if (n_scale_rows > 1)
    return launch_pipe<Deep, true>(a, packed, out_bf16, alphabet);
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fills_card(M, N, sms))
    return launch_pipe<Pair, false>(a, packed, out_bf16, alphabet);
  return launch_pipe<Deep, false>(a, packed, out_bf16, alphabet);
}

}  // namespace qgemm
