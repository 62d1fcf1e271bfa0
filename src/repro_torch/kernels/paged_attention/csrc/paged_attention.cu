// Paged-attention decode kernel for Hopper (sm_90a): single-query GQA over
// a paged KV pool, with the length mask, sliding window, logit softcap and
// an online softmax.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
//           paged_attention_pallas (body _paged_kernel).
//
// Shapes: q [B, Hkv, G, d], k_pool [N, bs, Hkv, d], v_pool [N, bs, Hkv, dv],
// tables [B, n] int32, lengths [B] int32 -> out [B, Hkv, G, dv] (q's dtype).
// Row b attends the virtual positions pos < lengths[b]; position p lives at
// pool[tables[b, p / bs], p % bs].  With a window, only positions with
// (length - 1 - pos) < window count.  Scores are q.k * scale in f32, then
// softcap * tanhf(s / softcap); m, l and acc are f32; each probability is
// rounded to the pool dtype before it weights V, as the reference does.
//
// Design (simple and right first):
//   * one thread block per (row b, KV head h), 16 warps; the block loads
//     its own lengths[b] and tables[b, j];
//   * the TPU's sequential grid axis over the row's blocks becomes a loop:
//     warp w takes blocks j = first/bs + w, + 16, ... below
//     ceil(length/bs), so blocks at or after the length, and blocks wholly
//     left of the window, are never read;
//   * each lane holds 16-byte chunks of q, of the K and V rows it streams,
//     and of acc, in registers: a row of d = 256 bf16 values is one
//     coalesced 512-byte load per warp.  A score is a per-lane partial dot
//     product and a butterfly reduction; the online-softmax state (m, l)
//     is per warp, and the warps' states are merged through shared memory
//     at the end;
//   * only the valid positions [t_lo, t_hi) of a block are loaded at all,
//     so garbage (or NaN) in a masked slot never reaches the output;
//   * K/V rows of kTile positions are loaded together before they are
//     used, so their memory latencies overlap, and the tile's kTile * kG
//     scores are reduced together, with one online-softmax rescale per
//     tile.
// Shapes: d and dv multiples of 16 / sizeof(T) and at most 64 such chunks
// (d <= 512 in bf16, 256 in f32); any G (query heads are taken kG <= 8 at
// a time), as long as the merge buffer, 16 * kG * (dv + 2) floats, fits
// in shared memory (every G at dv <= 256).
//
// Bound on this card: HBM bytes.  Each call must read the K and V rows of
// the valid positions once: sum_b Hkv * L_b * (d + dv) * sizeof(T), over
// 3.35 TB/s (H100 SXM).  The arithmetic, 2 * G * (d + dv) flops per
// position and head, is far below the f32 rate.
//
// What this design leaves on the table (work for a later change):
//   * the grid is B * Hkv blocks -- a few dozen at serve batch sizes, on 132
//     SMs -- so most of the card idles; splitting the sequence across blocks
//     (flash-decoding with a second reduction pass) is the first fix;
//   * a warp waits for each tile of K/V rows before it computes on it (no
//     cp.async/TMA pipeline across tiles);
//   * every lane of a warp computes the same softcap and exponentials (the
//     scores are warp-uniform after the butterfly reduction).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf and tanhf stay IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // 16 warps: a warp's chain of dependent
                                 // latencies bounds it, so more warps per
                                 // block (not bigger tiles) is what helps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 2;   // 16-byte chunks of a row per lane
constexpr int kMaxG = 8;        // query heads per pass over the KV rows

template <typename T> struct Vec;       // 16 bytes of T, unpacked to f32
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static float store(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Per warp: m [kG], l [kG], acc [kG * dv] f32, for the final merge.
inline size_t smem_bytes(int kG, int dv) {
  return sizeof(float) * kWarps * (2 * (size_t)kG + (size_t)kG * dv);
}

template <typename T, int kG, int kC>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int Hkv, int G, int d, int dv,
                       int bs, int n, float scale, int window, float softcap) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  constexpr int kTile = 8 / kC;          // positions whose rows load together
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int length = lengths[b];
  const int nd = d / kN, nv = dv / kN;   // 16-byte chunks per row

  // valid positions of this row: [first, length)
  const int first = window > 0 ? max(0, length - window) : 0;
  const int j_end = length > 0 ? min((length + bs - 1) / bs, n) : 0;
  const int j_begin = first / bs;
  const int64_t kstride = (int64_t)Hkv * d;   // next position, K pool
  const int64_t vstride = (int64_t)Hkv * dv;  // next position, V pool

  float* m_w = smem + warp * (2 * kG + kG * dv);
  float* l_w = m_w + kG;
  float* acc_w = l_w + kG;

  for (int g0 = 0; g0 < G; g0 += kG) {
    const int gn = min(kG, G - g0);
    float qf[kG][kC][kN];
    float acc[kG][kC][kN];
    float m[kG], l[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = lane + 32 * k;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (g < gn && c < nd)
          u = load16(q + ((int64_t)(b * Hkv + h) * G + g0 + g) * d + c * kN);
        V::unpack(u, qf[g][k]);
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[g][k][e] = 0.f;
      }
    }

    for (int j = j_begin + warp; j < j_end; j += kWarps) {
      const int64_t blk = tables[(int64_t)b * n + j];
      const int t_lo = max(0, first - j * bs);
      const int t_hi = min(bs, length - j * bs);
      const T* kb = k_pool + blk * bs * kstride + (int64_t)h * d;
      const T* vb = v_pool + blk * bs * vstride + (int64_t)h * dv;
      for (int t0 = t_lo; t0 < t_hi; t0 += kTile) {
        uint4 kr[kTile][kC], vr[kTile][kC];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            const int c = lane + 32 * k;
            const int t = t0 + u;
            kr[u][k] = vr[u][k] = make_uint4(0, 0, 0, 0);
            if (t < t_hi && c < nd) kr[u][k] = load16(kb + t * kstride + c * kN);
            if (t < t_hi && c < nv) vr[u][k] = load16(vb + t * vstride + c * kN);
          }
        }
        // the tile's scores: kTile * kG independent dot products, reduced
        // together; positions past t_hi score -inf
        float sc[kTile][kG];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          float kf[kC][kN];
#pragma unroll
          for (int k = 0; k < kC; ++k) V::unpack(kr[u][k], kf[k]);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int k = 0; k < kC; ++k)
#pragma unroll
              for (int e = 0; e < kN; ++e) dot += qf[g][k][e] * kf[k][e];
            sc[u][g] = dot;
          }
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float s = warp_sum(sc[u][g]) * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            sc[u][g] = t0 + u < t_hi ? s : -INFINITY;
          }
        // online softmax, one rescale per tile; p = 0 by select past t_hi
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int u = 0; u < kTile; ++u) m_new = fmaxf(m_new, sc[u][g]);
          const float corr = expf(m[g] - m_new);     // m = -inf -> 0
          m[g] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < kTile; ++u) {
            const float p = t0 + u < t_hi ? expf(sc[u][g] - m_new) : 0.f;
            sum += p;
            sc[u][g] = V::round(p);                  // p in the pool dtype
          }
          l[g] = l[g] * corr + sum;
#pragma unroll
          for (int k = 0; k < kC; ++k)
#pragma unroll
            for (int e = 0; e < kN; ++e) acc[g][k][e] *= corr;
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          float vf[kC][kN];
#pragma unroll
          for (int k = 0; k < kC; ++k) V::unpack(vr[u][k], vf[k]);
#pragma unroll
          for (int g = 0; g < kG; ++g)
#pragma unroll
            for (int k = 0; k < kC; ++k)
#pragma unroll
              for (int e = 0; e < kN; ++e)
                acc[g][k][e] += sc[u][g] * vf[k][e];
        }
      }
    }

    // merge the warps' (m, l, acc): out = sum_w acc_w e^(m_w - M) /
    // sum_w l_w e^(m_w - M), M = max_w m_w; a warp that saw no position
    // has m = -inf and weighs 0
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= gn) break;
      if (lane == 0) {
        m_w[g] = m[g];
        l_w[g] = l[g];
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = lane + 32 * k;
        if (c < nv)
#pragma unroll
          for (int e = 0; e < kN; ++e) acc_w[g * dv + c * kN + e] = acc[g][k][e];
      }
    }
    __syncthreads();
    const int stride_w = 2 * kG + kG * dv;
    for (int i = threadIdx.x; i < gn * dv; i += kThreads) {
      const int g = i / dv;
      float M = -INFINITY;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, smem[w * stride_w + g]);
      float L = 0.f, A = 0.f;
      if (M != -INFINITY) {
        for (int w = 0; w < kWarps; ++w) {
          const float* base = smem + w * stride_w;
          const float f = expf(base[g] - M);
          L += base[kG + g] * f;
          A += base[2 * kG + i] * f;
        }
      }
      out[((int64_t)(b * Hkv + h) * G + g0) * dv + i] =
          V::store(A / fmaxf(L, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int kG, int kC>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int B, int Hkv,
           int G, int d, int dv, int bs, int n, float scale, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(kG, dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, kG, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T, kG, kC><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), Hkv, G, d,
      dv, bs, n, scale, window, softcap);
  return (int)cudaGetLastError();
}

// query heads per pass: the smallest power of two >= G, at most kMaxG
inline int group_size(int G) {
  int kG = 1;
  while (kG < G && kG < kMaxG) kG *= 2;
  return kG;
}

// 16-byte chunks per lane for the wider of d and dv; 0 if unsupported
inline int chunks_per_lane(int d, int dv, int elem) {
  const int kN = 16 / elem;
  if (d % kN || dv % kN || d <= 0 || dv <= 0) return 0;
  const int c = ((d > dv ? d : dv) / kN + 31) / 32;
  return c <= kMaxChunks ? c : 0;
}

template <typename T, int kC>
int launch_g(int kG, const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* lengths, void* out, int B,
             int Hkv, int G, int d, int dv, int bs, int n, float scale,
             int window, float softcap, cudaStream_t s) {
#define PA_LAUNCH(KG)                                                       \
  return launch<T, KG, kC>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, \
                           G, d, dv, bs, n, scale, window, softcap, s)
  switch (kG) {
    case 1: PA_LAUNCH(1);
    case 2: PA_LAUNCH(2);
    case 4: PA_LAUNCH(4);
    default: PA_LAUNCH(8);
  }
#undef PA_LAUNCH
}

template <typename T>
int launch_t(const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* lengths, void* out, int B,
             int Hkv, int G, int d, int dv, int bs, int n, float scale,
             int window, float softcap, cudaStream_t s) {
  const int kC = chunks_per_lane(d, dv, sizeof(T));
  const int kG = group_size(G);
  if (kC == 1)
    return launch_g<T, 1>(kG, q, k_pool, v_pool, tables, lengths, out, B, Hkv,
                          G, d, dv, bs, n, scale, window, softcap, s);
  if (kC == 2)
    return launch_g<T, 2>(kG, q, k_pool, v_pool, tables, lengths, out, B, Hkv,
                          G, d, dv, bs, n, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), or 0 if the kernel does not take
// the shape; dtype 0 = float32, 1 = bfloat16.
size_t paged_attention_smem_bytes(int G, int d, int dv, int bs, int dtype) {
  if (G < 1 || bs < 1 || !chunks_per_lane(d, dv, dtype == 0 ? 4 : 2))
    return 0;
  return smem_bytes(group_size(G), dv);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  window <= 0 means no window, softcap <= 0 means no softcap.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* lengths, void* out, int B, int Hkv,
                           int G, int d, int dv, int bs, int n, float scale,
                           int window, float softcap, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G,
                           d, dv, bs, n, scale, window, softcap, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                   Hkv, G, d, dv, bs, n, scale, window,
                                   softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
