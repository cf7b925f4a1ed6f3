// Causal or non-causal GQA flash attention (forward) for Hopper.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py:81; body _flash_kernel :34). q [B,Sq,H,d] attends to
// k/v [B,Sk,Hk,d] with Sq <= Sk; causal queries sit at the last Sq key
// positions (query i sees keys 0..i+Sk-Sq). Query head h reads KV head
// h / (H/Hk). Online softmax in f32; the Sq x Sk scores never reach device
// memory. Ragged edges (Sq or Sk not a multiple of the tile) are masked
// here, so no caller pads.
//
// What bounds it on an H100: at the prefill wave's shapes (Sq = Sk = 512,
// d = 64) the operations; O(S^2 d) work on O(S d) bytes. The design skips
// key tiles that lie wholly above a query tile's causal diagonal instead
// of computing and masking them (about half the work of a causal
// prefill), keeps one query row per thread in registers, and stages each
// K/V tile once in shared memory for all 128 query rows of the block,
// read as float4. It runs on the SIMT cores, not the tensor cores: a
// correct first kernel; wgmma tiling is later work.

#include "common.cuh"

namespace {

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
  if (B <= 0 || Sq <= 0 || Sk < Sq || Hk <= 0 || H % Hk || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hk, D, causal,
                                   sm_scale, s);
  return launch_t<float>(q, k, v, out, B, Sq, Sk, H, Hk, D, causal, sm_scale,
                         s);
}
