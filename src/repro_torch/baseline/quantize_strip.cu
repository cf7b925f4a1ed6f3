// The 64-column strip kernel that ../csrc/quantize.cu replaced, kept only as a
// measuring aid: chip_smoke.py builds it as its own library and times it
// beside the cluster kernel (the "was" times). No path of the package
// calls it.
//
// A block owns a 64-column strip of one matrix and its 16 warps split K:
// each warp reads whole 64-column row pieces, the warps combine their
// maxima in shared memory, and a second pass re-reads w, divides, rounds
// and stores one int8 code per lane and column. Its maxima use fmaxf,
// which drops a NaN, and its clip maps a NaN quotient to -qmax: a column
// that holds a NaN gets a finite scale and nonzero codes here, where the
// plain version gives a NaN scale and codes 0.

#include "../csrc/common.cuh"

namespace {

constexpr int kCols = 64;    // columns per block (two per lane)
constexpr int kWarps = 16;   // warps per block, splitting K

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const T* __restrict__ w, int8_t* __restrict__ codes,
                float* __restrict__ scale, int K, int N, int qmax) {
  __shared__ float part[kWarps][kCols];
  __shared__ float col_scale[kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols;
  const size_t mat = (size_t)blockIdx.y * K * N;
  const int c0 = n0 + lane, c1 = n0 + lane + 32;
  const bool in0 = c0 < N, in1 = c1 < N;
  // lanes past the ragged edge read column N - 1 instead: their maxima
  // are never used, and the loads stay unconditional (a load under a
  // branch on a runtime flag is issued only after the branch resolves)
  const int l0 = in0 ? c0 : N - 1, l1 = in1 ? c1 : N - 1;

  float m0 = 0.f, m1 = 0.f;
#pragma unroll 4
  for (int k = warp; k < K; k += kWarps) {
    const T* row = w + mat + (size_t)k * N;
    m0 = fmaxf(m0, fabsf(to_f32(row[l0])));
    m1 = fmaxf(m1, fabsf(to_f32(row[l1])));
  }
  part[warp][lane] = m0;
  part[warp][lane + 32] = m1;
  __syncthreads();
  if (threadIdx.x < kCols) {
    float m = part[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, part[i][threadIdx.x]);
    const float s = fmaxf(m, 1e-8f) / static_cast<float>(qmax);
    col_scale[threadIdx.x] = s;
    if (n0 + threadIdx.x < N)
      scale[(size_t)blockIdx.y * N + n0 + threadIdx.x] = s;
  }
  __syncthreads();

  const float s0 = col_scale[lane], s1 = col_scale[lane + 32];
  const float lo = static_cast<float>(-qmax), hi = static_cast<float>(qmax);
#pragma unroll 4
  for (int k = warp; k < K; k += kWarps) {
    const size_t r = mat + (size_t)k * N;
    const float q0 = fminf(fmaxf(rintf(to_f32(w[r + l0]) / s0), lo), hi);
    const float q1 = fminf(fmaxf(rintf(to_f32(w[r + l1]) / s1), lo), hi);
    if (in0) codes[r + c0] = static_cast<int8_t>(q0);
    if (in1) codes[r + c1] = static_cast<int8_t>(q1);
  }
}

}  // namespace

// w: [batch, K, N] f32 (w_bf16 = 0) or bf16, contiguous; codes: [batch, K, N]
// int8; scale: [batch, 1, N] f32. bits in [2, 8].
extern "C" int quantize_strip_launch(const void* w, int w_bf16, int8_t* codes,
                                     float* scale, int batch, int K,
                                     int N, int bits, void* stream) {
  if (batch <= 0 || K <= 0 || N <= 0 || bits < 2 || bits > 8 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qmax = (1 << (bits - 1)) - 1;
  const dim3 grid((N + kCols - 1) / kCols, batch);
  if (w_bf16)
    quantize_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), codes, scale, K, N, qmax);
  else
    quantize_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(w), codes, scale, K, N, qmax);
  return static_cast<int>(cudaGetLastError());
}
