// Per-channel absmax quantization for Hopper: K split across the blocks of
// a thread-block cluster.
//
// Replaces the TPU kernel quantize_pallas (src/repro/kernels/quantize.py:33;
// body _quant_kernel :23). For each matrix w [K, N] of a batch and each
// column n:
//   absmax = max_k |float(w[k, n])|                    (a NaN propagates)
//   scale  = max(absmax, 1e-8) / qmax                  (IEEE division)
//   codes  = clip(rint(float(w[k, n]) / scale), -qmax, qmax)   (int8)
// with qmax = 2^(bits-1) - 1. Codes and scales are bit-equal to the plain
// version (kernels/ref.quantize_ref), NaN and inf included: a NaN anywhere
// in a column makes its scale NaN and every code of it 0 (as the plain
// version's cast of a NaN to int8 gives), an inf makes the scale inf. The
// build uses no fast math and the scale is __fdiv_rn.
//
// The codes divide only where they must. With r = __frcp_rn(s) (the IEEE
// reciprocal) and q the exact quotient x / s: s is at least
// max(|x|, 1e-8) / qmax rounded once, so |q| < 128, and the exact product
// y = x r = q (1 + e) with |e| <= 2^-24 lies within 2^-17 of q; the
// division's own result RN(q) is within 2^-18 of q. fma(x, r, 1.5 * 2^23)
// rounds y half to even (the sum's low byte is the code), and a second fma
// gives t = y - rint(y) rounded once (within 2^-25). So where |t| <
// 0.5 - 2^-16, y lies more than 2^-16 - 2^-25 from every half-integer,
// farther than RN(q) (within 1.5 * 2^-17 of y), so RN(q) lies strictly
// between the same two half-integers, rint(RN(q)) = rint(y), and |y| <
// qmax + 0.5 makes the clip a no-op. Every other
// element (a quotient near a half, or a NaN) is divided with __fdiv_rn,
// rounded by cvt.rni (half to even) and clipped: few weights sit that
// near a half. ref.quantize_rcp_ref emulates this arithmetic on the CPU,
// where the tests hold it to the division on every bf16 value.
//
// What bounds it on an H100: bytes, about 1.5 per bf16 weight (read it,
// write its code) for under ten instructions. The maximum of a column
// needs all of K before any code can be written, so a kernel that walks K
// in one block either keeps few blocks busy or reads w twice. Here a
// cluster of `cluster` blocks owns a strip of `strip` columns of one
// matrix (a work item), and each of its blocks a contiguous slice of
// `rows` rows of that strip:
//   1. the block loads its slice into shared memory once by 16-byte cp.async
//      (narrower where N is not a multiple of the 16 bytes' columns),
//      consecutive threads on consecutive addresses, in four commit
//      groups; it reduces each of the slice's four parts as it lands;
//   2. it reduces its column maxima (a NaN-propagating max, two bf16 a
//      word) over lanes and warps and publishes them in its shared memory;
//   3. at the cluster barrier every block reads every split's maxima
//      through distributed shared memory (map_shared_rank), takes the
//      scales and their reciprocals, and block 0 writes the scales;
//   4. each block rounds the codes of its own slice from shared memory
//      (above) and stores them, `vec` codes a store (16 where N allows).
// The grid holds the clusters that fit on the card at once, and each
// walks its items in turn with three slots: item n + 1 loads while item n
// is reduced, and item n - 1 is rounded while item n's maxima cross the
// barrier (arrive before, wait after). A block leaves only after its
// cluster has read its maxima.
// Where a cluster cannot hold a strip's K (the slice would pass the plan's
// shared-memory budget), the same kernel streams: each block walks its
// slice in chunks through a ring of three slots, once for the maxima and
// once to round, so w is read twice. The route, the strip, the cluster
// size, the rows of a split and the access width are the host's plan
// (kernels/quantize.quantize_plan); this file checks that a plan is
// consistent and launches it. A stacked [L, K, N] leaf is one launch, and
// K has no cap: the TPU's MAX_K_VMEM is a VMEM budget.

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 3;    // chunk slots of the streamed route
constexpr int kParts = 4;   // commit groups of a held slice
constexpr int kHeldSlots = 3;   // held slices: loading, reducing, rounding
constexpr int kMaxCluster = 16;
// rint by the magic number: y + 1.5 * 2^23 rounds y (|y| < 2^22) to an
// integer, half to even, whose two's complement is the float's low byte
constexpr float kMagic = 12582912.0f;
// x * rcp(s) within this of an integer rounds as x / s does (the header's
// proof)
constexpr float kDecided = 0.5f - 0x1p-16f;

struct Params {
  const void* w;
  int8_t* codes;
  float* scale;
  int batch, K, N, strip, cluster, rows, chunk_rows, qmax;
};

// max that propagates a NaN, as torch.amax and jnp.max do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Arrive at the cluster barrier, releasing the warp's writes to the
// cluster (a warp that wrote nothing the cluster reads arrives relaxed: a
// release also orders its earlier memory operations, the next item's
// loads among them). `release` is the same for the whole warp.
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// P bytes global -> shared (P = 16, 8, 4 by cp.async, zero-filled if
// !valid; P = 2 by a plain load, for bf16 rows of odd length). `src` is a
// valid address either way, so no load waits on a branch.
template <int P>
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           bool valid) {
  if constexpr (P == 16) {
    cp_async16(dst, src, valid);
  } else if constexpr (P == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else if constexpr (P == 4) {
    cp_async4(dst, src, valid);
  } else {
    const uint16_t v = *static_cast<const uint16_t*>(src);
    *static_cast<uint16_t*>(dst) = valid ? v : uint16_t(0);
  }
}

// wait until at most n commit groups are in flight (n < 2 kParts)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// the 32-bit words that hold V consecutive elements of T in shared memory
// (a bf16 row of odd length: one element, in the high half)
template <typename T, int V>
struct Words {
  static constexpr int kN = V * sizeof(T) >= 4 ? V * sizeof(T) / 4 : 1;
};
template <typename T, int V>
__device__ __forceinline__ void load_words(const T* p,
                                           uint32_t (&u)[Words<T, V>::kN]) {
  constexpr int kN = Words<T, V>::kN;
  if constexpr (sizeof(T) == 2 && V == 1) {
    u[0] = uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16;
  } else if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      u[4 * i] = q.x, u[4 * i + 1] = q.y, u[4 * i + 2] = q.z,
      u[4 * i + 3] = q.w;
    }
  } else if constexpr (kN == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x, u[1] = q.y;
  } else {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// element j of those words as f32 (bf16, little-endian: element 2i in the
// low half of word i)
template <typename T, int V>
__device__ __forceinline__ float word_elem(const uint32_t* u, int j) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(u[j]);
  else if constexpr (V == 1) return __uint_as_float(u[0]);
  else return __uint_as_float(j & 1 ? u[j / 2] & 0xffff0000u : u[j / 2] << 16);
}

// |a| against b, two bf16 a word, a NaN kept (the maximum of bf16
// magnitudes is itself a bf16 value, so the packed maxima are exact)
__device__ __forceinline__ uint32_t max_abs_bf16x2(uint32_t b, uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(b), "r"(a & 0x7fff7fffu));
  return d;
}

// V int8 codes to global memory in one store of V bytes
template <int V>
__device__ __forceinline__ void store_codes(int8_t* dst, const int (&c)[V]) {
  if constexpr (V == 1) {
    *dst = static_cast<int8_t>(c[0]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        static_cast<uint16_t>((c[0] & 0xff) | ((c[1] & 0xff) << 8));
  } else {
    uint32_t u[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      u[i] = (c[4 * i] & 0xff) | ((c[4 * i + 1] & 0xff) << 8) |
             ((c[4 * i + 2] & 0xff) << 16) | (uint32_t(c[4 * i + 3]) << 24);
    if constexpr (V == 16)
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (V == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = u[0];
  }
}

// T: float or bf16. V: the access width in columns (a divisor of N; a
// thread reads V weights and stores V codes at a time). kHeld: a block's
// slice stays in shared memory between the two passes (else it streams);
// rows past the split load as zeros. A cluster walks the work items
// (matrix, strip) cid, cid + clusters, ... in turn.
template <typename T, int V, bool kHeld>
__global__ void __launch_bounds__(kThreads) quantize_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = p.strip, R = p.chunk_rows;
  const int strips = (p.N + S - 1) / S;
  const int items = p.batch * strips;
  const int clusters = gridDim.x / p.cluster;
  const int k0 = rank * p.rows;                 // this split: rows [k0, k1)
  const int k1 = min(k0 + p.rows, p.K);

  // compute layout: G threads along a row of the strip, V columns each,
  // RS rows a step
  const int G = S / V, RS = kThreads / G;
  const int tid = threadIdx.x;
  const int cgp = tid % G, rl = tid / G;
  // the warps of the threads tid < S, which publish and read the maxima
  const bool writer = tid / 32 < (S + 31) / 32;
  // load layout: consecutive threads on consecutive P-byte pieces
  constexpr int kElem = sizeof(T);
  constexpr int P = V * kElem < 16 ? V * kElem : 16;
  const int ppr = S * kElem / P;
  const int lp = tid % ppr, lr = tid / ppr, lrs = kThreads / ppr;

  // shared memory: the chunk slots, the partial maxima (PR rows of S),
  // this block's column maxima by item parity (read by the cluster), the
  // scales and their reciprocals by item parity
  constexpr int kSlots = kHeld ? kHeldSlots : kRing;
  T* stash = reinterpret_cast<T*>(smem);
  const int PR = G >= 32 ? RS : kThreads / 32;
  float* part = reinterpret_cast<float*>(
      smem + (size_t)kSlots * R * S * kElem);
  float* colmax = part + PR * S;
  float* colscale = colmax + 2 * S;
  float* colrcp = colscale + 2 * S;
  // the host's plan sized the launch's shared memory for this layout
  uint32_t dyn_smem;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_smem));
  if (reinterpret_cast<unsigned char*>(colrcp + 2 * S) - smem > dyn_smem)
    __trap();

  // rows [ra, rb) of chunk c of item `it` into slot `slot`
  auto load_rows = [&](int it, int c, int slot, int ra, int rb) {
    const T* w = static_cast<const T*>(p.w) + (size_t)(it / strips) * p.K *
                                                  p.N;
    const int lcol = (it % strips) * S + lp * (P / kElem);
    const bool lcol_ok = lcol < p.N;
    const int r0 = k0 + c * R;
    T* dst = stash + (size_t)slot * R * S + lp * (P / kElem);
    for (int r = ra + lr; r < rb; r += lrs) {
      const int k = r0 + r;
      const bool ok = lcol_ok && k < k1;
      copy_piece<P>(dst + r * S, ok ? w + (size_t)k * p.N + lcol : w, ok);
    }
  };
  // held: the slice in kParts parts, one commit group each, each part
  // reduced as it lands
  auto part_lo = [&](int i) { return i * R / kParts; };
  auto load_item = [&](int it, int slot) {
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      load_rows(it, 0, slot, part_lo(i), part_lo(i + 1));
      cp_async_commit();
    }
  };

  // the column maxima of |w| so far: bf16 pairs packed in a word where V
  // is even (one max.NaN.bf16x2 for two weights), else f32 (as bits)
  constexpr bool kPacked = sizeof(T) == 2 && V > 1;
  constexpr int kM = Words<T, V>::kN;
  uint32_t m[kM];
  auto max_rows = [&](int slot, int ra, int rb) {   // rows past k1 are 0
    const T* src = stash + (size_t)slot * R * S + cgp * V;
    for (int r = ra + rl; r < rb; r += RS) {
      uint32_t u[kM];
      load_words<T, V>(src + r * S, u);
#pragma unroll
      for (int i = 0; i < kM; ++i)
        m[i] = kPacked ? max_abs_bf16x2(m[i], u[i])
                       : __float_as_uint(max_nan(__uint_as_float(m[i]),
                                                 fabsf(__uint_as_float(u[i]))));
    }
  };

  // the block's maxima m over its threads into mine[parity], this block's
  // share of the item's column maxima, which the cluster reads after the
  // barrier
  auto publish = [&](int parity) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)   // lanes G apart share columns
      if (o >= G) {
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const uint32_t v = __shfl_xor_sync(0xffffffffu, m[i], o);
          m[i] = kPacked ? max_abs_bf16x2(m[i], v)
                         : __float_as_uint(max_nan(__uint_as_float(m[i]),
                                                   __uint_as_float(v)));
        }
      }
    if (G >= 32 || (tid & 31) < G) {
      const int prow = G >= 32 ? rl : tid / 32;
#pragma unroll
      for (int j = 0; j < V; ++j)
        part[prow * S + cgp * V + j] = word_elem<T, V>(m, j);
    }
    __syncthreads();
    if (tid < S) {
      float mm = part[tid];
#pragma unroll
      for (int i = 1; i < kThreads / 32; ++i)
        if (i < PR) mm = max_nan(mm, part[i * S + tid]);
      colmax[parity * S + tid] = mm;
    }
  };
  // after the barrier: every split's maxima of item `it` to its scales
  // and their reciprocals in colscale[parity], colrcp[parity] (visible
  // to the block after its next __syncthreads); block 0 writes the scales
  auto take_scales = [&](int it, int parity) {
    if (tid < S) {
      float mm = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < p.cluster)
          mm = max_nan(mm,
                       cluster.map_shared_rank(colmax + parity * S, r)[tid]);
      const float a = mm < 1e-8f ? 1e-8f : mm;   // a NaN stays NaN
      const float sc = __fdiv_rn(a, static_cast<float>(p.qmax));
      colscale[parity * S + tid] = sc;
      colrcp[parity * S + tid] = __frcp_rn(sc);
      const int n = (it % strips) * S + tid;
      if (rank == 0 && n < p.N) p.scale[(size_t)(it / strips) * p.N + n] = sc;
    }
  };

  // the codes of rows [0, rend) of chunk c (slot `slot`) of item `it`:
  // rint(x * rcp) by fma(x, rcp, 1.5 * 2^23), x / s where that does not
  // decide the rounding (the header's proof)
  auto round_chunk = [&](int it, int c, int slot, int parity) {
    const int col = (it % strips) * S + cgp * V;
    if (col >= p.N) return;   // V divides N: a group is whole or out
    float s[V], rcp[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = colscale[parity * S + cgp * V + j];
      rcp[j] = colrcp[parity * S + cgp * V + j];
    }
    int8_t* codes = p.codes + (size_t)(it / strips) * p.K * p.N + col;
    const int r0 = k0 + c * R;
    const int rend = min(R, k1 - r0);
    const T* src = stash + (size_t)slot * R * S + cgp * V;
    for (int r = rl; r < rend; r += RS) {
      uint32_t u[kM];
      load_words<T, V>(src + r * S, u);
      int q[V];   // codes in the low byte
      float t[V];
      bool decided = true;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = word_elem<T, V>(u, j);
        const float mg = __fmaf_rn(x, rcp[j], kMagic);
        t[j] = __fmaf_rn(x, rcp[j], -__fsub_rn(mg, kMagic));
        q[j] = __float_as_int(mg);
        decided &= fabsf(t[j]) < kDecided;
      }
      if (!decided) {   // some quotient near a half, or NaN: divide those
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (!(fabsf(t[j]) < kDecided)) {
            const float y = __fdiv_rn(word_elem<T, V>(u, j), s[j]);
            q[j] = y == y ? min(max(__float2int_rn(y), -p.qmax), p.qmax)
                          : 0;   // a NaN quotient gives 0
          }
      }
      store_codes<V>(codes + (size_t)(r0 + r) * p.N, q);
    }
  };

  const int cid = blockIdx.x / p.cluster;
  const int count = cid < items ? (items - cid + clusters - 1) / clusters : 0;
  if constexpr (kHeld) {
    // item n in slot n % 3: while item n's maxima cross the cluster
    // barrier, the block rounds item n - 1, and item n + 1 is loading
    if (count > 0) load_item(cid, 0);
    for (int n = 0; n <= count; ++n) {
      const int it = cid + n * clusters, slot = n % kHeldSlots;
      const bool next = n + 1 < count;
      if (next) load_item(it + clusters, (n + 1) % kHeldSlots);
      if (n < count) {
#pragma unroll
        for (int i = 0; i < kM; ++i) m[i] = 0u;
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          cp_async_wait_pending(kParts - 1 - i + (next ? kParts : 0));
          __syncthreads();
          max_rows(slot, part_lo(i), part_lo(i + 1));
        }
        publish(n & 1);
        cluster_arrive(writer);
      }
      if (n > 0)
        round_chunk(it - clusters, 0, (n - 1) % kHeldSlots, (n - 1) & 1);
      if (n < count) {
        cluster_wait();   // every split's maxima of item n are published
        take_scales(it, n & 1);
      }
      __syncthreads();   // the scales are visible; slot n - 1 is free
    }
  } else {
    const int nch = k1 > k0 ? (k1 - k0 + R - 1) / R : 0;
    for (int n = 0; n < count; ++n) {
      const int it = cid + n * clusters;
#pragma unroll
      for (int i = 0; i < kM; ++i) m[i] = 0u;
      // pass 1: the column maxima, chunk by chunk through the ring
#pragma unroll
      for (int c = 0; c < kRing - 1; ++c) {
        if (c < nch) load_rows(it, c, c, 0, R);
        cp_async_commit();
      }
      for (int c = 0; c < nch; ++c) {
        cp_async_wait<kRing - 2>();
        __syncthreads();   // chunk c landed; slot (c - 1) % kRing is free
        if (c + kRing - 1 < nch)
          load_rows(it, c + kRing - 1, (c + kRing - 1) % kRing, 0, R);
        cp_async_commit();
        max_rows(c % kRing, 0, R);
      }
      cp_async_wait<0>();
      publish(n & 1);
      cluster_arrive(writer);
      cluster_wait();   // every split's maxima of item n are published
      take_scales(it, n & 1);
      __syncthreads();
      // pass 2: the codes, reading the slice again
#pragma unroll
      for (int c = 0; c < kRing - 1; ++c) {
        if (c < nch) load_rows(it, c, c, 0, R);
        cp_async_commit();
      }
      for (int c = 0; c < nch; ++c) {
        cp_async_wait<kRing - 2>();
        __syncthreads();
        if (c + kRing - 1 < nch)
          load_rows(it, c + kRing - 1, (c + kRing - 1) % kRing, 0, R);
        cp_async_commit();
        round_chunk(it, c, c % kRing, n & 1);
      }
      cp_async_wait<0>();
      __syncthreads();   // the ring is free for the next item
    }
  }
  // no block leaves before the cluster has read its maxima
  cluster_arrive(writer);
  cluster_wait();
}

using KernelFn = void (*)(Params);

template <typename T, bool kHeld>
KernelFn pick(int vec) {
  switch (vec) {
    case 16: return quantize_kernel<T, 16, kHeld>;
    case 8: return quantize_kernel<T, 8, kHeld>;
    case 4: return quantize_kernel<T, 4, kHeld>;
    case 2: return quantize_kernel<T, 2, kHeld>;
    case 1: return quantize_kernel<T, 1, kHeld>;
    default: return nullptr;
  }
}

// The clusters that fit on the current device at once for a kernel,
// shared memory size and cluster size (asked once per device, kept)
int active_clusters(int device, KernelFn fn, const cudaLaunchConfig_t& cfg,
                    int cluster) {
  using Key = std::tuple<int, KernelFn, size_t, int>;
  static std::mutex mu;
  static std::map<Key, int> seen;
  const Key key{device, fn, cfg.dynamicSmemBytes, cluster};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = seen.find(key);
  if (hit != seen.end()) return hit->second;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) n = 0;
  if (n > 0) seen[key] = n;
  return n;
}

}  // namespace

// w: [batch, K, N] f32 (w_bf16 = 0) or bf16, contiguous; codes: [batch, K, N]
// int8; scale: [batch, 1, N] f32. bits in [2, 8]. The plan
// (kernels/quantize.quantize_plan): `strip` columns a cluster of `cluster`
// blocks, `rows` rows a block, chunks of `chunk_rows` rows (held: one
// chunk holds the block's rows), `vec` columns an access, `smem` bytes of
// dynamic shared memory a block (the plan sizes the layout; the kernel
// traps if it does not fit). An inconsistent plan is refused.
// The grid holds as many clusters as fit on the card at once (no more
// than there are items), each walking the same number of items, give or
// take one.
extern "C" int quantize_launch(const void* w, int w_bf16, int8_t* codes,
                               float* scale, int batch, int K, int N,
                               int bits, int strip, int cluster, int rows,
                               int chunk_rows, int vec, int smem,
                               void* stream) {
  const int elem = w_bf16 ? 2 : 4;
  const bool vec_ok = vec == 1 || vec == 2 || vec == 4 || vec == 8 ||
                      vec == 16;
  if (batch <= 0 || K <= 0 || N <= 0 || bits < 2 || bits > 8 || !vec_ok ||
      N % vec || strip < vec || strip % vec || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || (long long)rows * cluster < K ||
      (long long)rows * (cluster - 1) >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = strip / vec;
  const int piece = vec * elem < 16 ? vec * elem : 16;
  if (strip > kThreads || kThreads % G || strip * elem % 16 ||
      strip * elem / piece > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (long long)batch * ((N + strip - 1) / strip);
  const bool held = chunk_rows >= rows;
  if (chunk_rows < 1 || items * cluster > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(w) % piece ||
      reinterpret_cast<uintptr_t>(codes) % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem < 1 || smem > smem_max)
    return static_cast<int>(cudaErrorInvalidValue);

  KernelFn fn = w_bf16 ? (held ? pick<__nv_bfloat16, true>(vec)
                               : pick<__nv_bfloat16, false>(vec))
                       : (held ? pick<float, true>(vec)
                               : pick<float, false>(vec));
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  Params prm{w, codes, scale, batch, K, N, strip, cluster, rows, chunk_rows,
             (1 << (bits - 1)) - 1};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(items * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long fit = active_clusters(device, fn, cfg, cluster);
  if (fit > 0 && fit < items) {   // rounds of items, clusters to balance
    const long long rounds = (items + fit - 1) / fit;
    cfg.gridDim = dim3(
        static_cast<unsigned>((items + rounds - 1) / rounds * cluster));
  }
  err = cudaLaunchKernelEx(&cfg, fn, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
