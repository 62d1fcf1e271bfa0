// Paged-attention decode kernel for Hopper (sm_90a): single-query GQA over
// a paged KV pool, with the length mask, sliding window, logit softcap and
// an online softmax, as split-sequence flash-decoding.
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
// Bound on this card: HBM bytes.  Each call must read the K and V rows of
// the valid positions once: sum_b Hkv * L_b * (d + dv) * sizeof(T), over
// 3.35 TB/s (H100 SXM).  The arithmetic, 2 * G * (d + dv) flops per
// position and head, is far below the f32 rate.
//
// Design.  The first version gave each (row, KV head) one block that walked
// the whole row: B * Hkv = 32 blocks at the served shape, on 132 SMs, each
// a chain of dependent tiles.  Here the row's sequence is split:
//   * grid (splits, Hkv, B).  ops.plan_splits picks the split count on
//     the host from B, Hkv, n, bs and the SM count alone (reading lengths
//     there would be a device-to-host sync, and would break CUDA-graph
//     capture); each block then cuts its own row's live pages on the card:
//     the pages from the window's first position (or 0) to the length go
//     to the splits in chunks of ceil(live / splits) whole pages, at least
//     min_pages (ops.MIN_SPLIT_POSITIONS positions).  So a row's work is
//     spread over the splits however wide its table is (a table spanning
//     the model's context with a short row does not leave the row to one
//     split), and a window's dead pages take no split;
//   * a block reads its row's length, then its chunk's table entries (a
//     second dependent trip to memory, the price of cutting on the card);
//     a split past its row's live pages writes the empty state (m = -inf,
//     l = 0) and reads nothing else;
//   * 4 warps a block; warp w takes tiles w, w + 4, ... of kTP positions
//     of the split's valid range.  Each lane streams its 16-byte chunks of
//     a tile's K and V rows into its own slots of a per-warp shared-memory
//     ring with cp.async, kStages tiles deep, and reads back only what it
//     copied itself: the loads of the next kStages - 1 tiles are in flight
//     while a tile is computed, without registers held for them and
//     without a barrier.  A score is a per-lane partial dot product; the
//     tile's kTP * kG partial scores are summed across the warp by a
//     transposing butterfly (kTP * kG - 1 + 5 - log2(kTP * kG) shuffles,
//     not 5 per score), after which each lane holds one whole score, so
//     softcap, mask and exponential run once per score and not on all 32
//     lanes; each p is then broadcast back for the PV product.  The online
//     softmax (m, l) is per warp and rounds each p relative to the warp's
//     running max;
//   * only the valid positions of a tile are copied (the rest are
//     zero-filled without a read), so garbage or NaN in a masked slot never
//     reaches the output;
//   * the 4 warps' states are merged through shared memory into the
//     split's partial state, written in f32: m, l [B, Hkv, G, S] and acc
//     [B, Hkv, G, S, dv];
//   * a second kernel (split_merge.cuh, shared with B8) merges the S
//     partial states and rounds to q's dtype once.  It is a kernel of its
//     own, not "the last block to arrive merges"; the header says why.  It
//     is launched as a programmatic dependent, so its launch overlaps this
//     kernel's run.
// What this design leaves on the table: two launches, three dependent
// trips to memory in the split kernel and two in the merge, a fixed cost
// (the intercept of chip_smoke.py's length sweep, PERF.md) that is most
// of a call at the served lengths.
// Shapes: d and dv multiples of 16 / sizeof(T) and at most 64 such chunks
// (d <= 512 in bf16, 256 in f32); any G (query heads are taken kG <= 8 at
// a time; the split streams its K/V rows again per group of 8).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf and tanhf stay IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTP = 4;          // positions of a warp's tile
constexpr int kStages = 4;      // tiles of a warp's ring: 3 in flight
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !valid
// (the "memory" clobbers keep the compiler from moving shared-memory
// reads of a slot across the copies that land in it or refill it)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ring: kWarps x kStages x kTP x kC x {K, V} x 32 lanes x 16 bytes; the
// warps' final (m, l, acc), kWarps x (2 kG + kG dv) f32, reuse it; then
// the split's block ids [pages] (int32), past both
__host__ __device__ inline size_t table_offset(int kG, int kC, int dv) {
  const size_t ring = (size_t)kWarps * kStages * kTP * kC * 2 * 32 * 16;
  const size_t merge = sizeof(float) * kWarps * (2 * (size_t)kG +
                                                 (size_t)kG * dv);
  return ring > merge ? ring : merge;
}
inline size_t smem_bytes(int kG, int kC, int dv, int pages) {
  return table_offset(kG, kC, dv) + sizeof(int32_t) * (size_t)pages;
}

template <typename T, int kG, int kC>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int32_t* __restrict__ tables,
                             const int32_t* __restrict__ lengths,
                             float* __restrict__ part_m,
                             float* __restrict__ part_l,
                             float* __restrict__ part_acc, int Hkv, int G,
                             int d, int dv, int bs, int n, int min_pages,
                             float scale, int window, float softcap) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  int32_t* blk_s =
      reinterpret_cast<int32_t*>(smem_raw + table_offset(kG, kC, dv));
  float* merge_s = reinterpret_cast<float*>(smem_raw);

  const int s = blockIdx.x, S = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nd = d / kN, nv = dv / kN;   // 16-byte chunks per row
  const int64_t bh = (int64_t)b * Hkv + h;
  split_merge::launch_dependents();      // the merge may start launching

  // this row's live pages [p_lo, p_hi), cut into chunks of `chunk` pages:
  // split s takes [page0, page_end)
  const int length = lengths[b];
  const int first = window > 0 ? max(0, length - window) : 0;
  const int p_lo = first / bs, p_hi = (min(length, n * bs) + bs - 1) / bs;
  const int chunk = max((p_hi - p_lo + S - 1) / S, min_pages);
  const int page0 = p_lo + s * chunk;
  const int page_end = min(page0 + chunk, p_hi);
  // this split's valid positions: [lo, hi)
  const int lo = max(first, page0 * bs);
  const int hi = min(length, page_end * bs);
  if (lo >= hi) {                        // nothing to read: the empty state
    for (int g = threadIdx.x; g < G; g += kThreads) {
      part_m[(bh * G + g) * S + s] = -INFINITY;
      part_l[(bh * G + g) * S + s] = 0.f;
    }
    return;
  }
  // the chunk's block ids (at most `pages`: chunk <= pages where the row
  // has more than min_pages live pages, and page_end - page0 <= n <= pages
  // otherwise)
  for (int j = page0 + threadIdx.x; j < page_end; j += kThreads)
    blk_s[j - page0] = tables[(int64_t)b * n + j];
  __syncthreads();

  const int64_t kstride = (int64_t)Hkv * d;   // next position, K pool
  const int64_t vstride = (int64_t)Hkv * dv;  // next position, V pool
  const int ntiles = (hi - lo + kTP - 1) / kTP;
  const int my_tiles = warp < ntiles ? (ntiles - warp + kWarps - 1) / kWarps
                                     : 0;
  uint4* my_ring = ring + (size_t)warp * kStages * kTP * kC * 2 * 32;

  // copy this lane's chunks of the warp's i-th tile into ring slot `slot`
  auto issue = [&](int i, int slot) {
    const int p0 = lo + (i * kWarps + warp) * kTP;
    uint4* dst = my_ring + (size_t)slot * kTP * kC * 2 * 32;
#pragma unroll
    for (int u = 0; u < kTP; ++u) {
      const int p = p0 + u;
      const bool live = p < hi;
      const int64_t row = live ? (int64_t)blk_s[p / bs - page0] * bs + p % bs
                               : 0;
      const T* kr = k_pool + row * kstride + (int64_t)h * d;
      const T* vr = v_pool + row * vstride + (int64_t)h * dv;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = lane + 32 * k;
        uint4* slot_u = dst + ((u * kC + k) * 2) * 32 + lane;
        cp_async16(slot_u, kr + (c < nd ? c * kN : 0), live && c < nd);
        cp_async16(slot_u + 32, vr + (c < nv ? c * kN : 0), live && c < nv);
      }
    }
  };

  // after the transposing butterfly this lane holds score idx = u * kG + g
  // of a tile (its top index bits are the lane's top bits)
  constexpr int kV = kTP * kG, kLogV = kV == 32 ? 5 : kV == 16 ? 4
                                      : kV == 8 ? 3 : kV == 4 ? 2 : 1;
  static_assert((1 << kLogV) == kV && kV <= 32, "kTP * kG: 4 .. 32");
  static_assert(kTP == 4, "the max and sum over u use lane bits 16, 8");
  constexpr int kLaneShift = 5 - kLogV;  // lane of score idx: idx << shift
  const int idx = lane >> kLaneShift;
  const int u_mine = idx / kG;

  for (int g0 = 0; g0 < G; g0 += kG) {
    const int gn = min(kG, G - g0);
    float qf[kG][kC][kN];
    float acc[kG][kC][kN];
    float m = -INFINITY, l = 0.f;        // of this lane's g, idx % kG
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = lane + 32 * k;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (g < gn && c < nd) u = load16(q + (bh * G + g0 + g) * d + c * kN);
        V::unpack(u, qf[g][k]);
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[g][k][e] = 0.f;
      }
    }

    // one commit group per tile slot, empty past the warp's last tile, so
    // that "all but the newest kStages - 1 groups done" means "tile i has
    // landed"
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < my_tiles) issue(i, i);
      cp_async_commit();
    }
    for (int i = 0; i < my_tiles; ++i) {
      cp_async_wait<kStages - 1>();
      const int slot = i % kStages;
      const uint4* src = my_ring + (size_t)slot * kTP * kC * 2 * 32;
      const int p0 = lo + (i * kWarps + warp) * kTP;
      // the tile's kV partial dot products, v[u * kG + g]
      float v[kV];
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        float kf[kC][kN];
#pragma unroll
        for (int k = 0; k < kC; ++k)
          V::unpack(src[((u * kC + k) * 2) * 32 + lane], kf[k]);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < kC; ++k)
#pragma unroll
            for (int e = 0; e < kN; ++e) dot += qf[g][k][e] * kf[k][e];
          v[u * kG + g] = dot;
        }
      }
      // transposing butterfly: at offset 16 >> t the lanes with that bit
      // set keep the upper half of the remaining scores and pass the lower
      // half, so each step halves the scores a lane carries
#pragma unroll
      for (int t = 0; t < kLogV; ++t) {
        const int half = kV >> (t + 1), off = 16 >> t;
        const bool upper = lane & off;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? v[j] : v[j + half];
          const float keep = upper ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = 16 >> kLogV; off > 0; off >>= 1)
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
      // this lane's score: scale, softcap, mask (past hi: -inf)
      const bool live = p0 + u_mine < hi;
      float sv = v[0] * scale;
      if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
      sv = live ? sv : -INFINITY;
      // online softmax of this lane's g, one rescale per tile: the tile's
      // max and sum run over u, the lane bits 16 and 8 (kTP = 4)
      float mx = fmaxf(sv, __shfl_xor_sync(0xffffffffu, sv, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m, mx);     // finite: p0 < hi
      const float corr = expf(m - m_new);    // m = -inf -> 0
      const float e = live ? expf(sv - m_new) : 0.f;
      float sum = e + __shfl_xor_sync(0xffffffffu, e, 16);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      l = l * corr + sum;
      m = m_new;
      const float p = V::round(e);           // p in the pool dtype
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float cg = __shfl_sync(0xffffffffu, corr, g << kLaneShift);
#pragma unroll
        for (int k = 0; k < kC; ++k)
#pragma unroll
          for (int e2 = 0; e2 < kN; ++e2) acc[g][k][e2] *= cg;
      }
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        float vf[kC][kN];
#pragma unroll
        for (int k = 0; k < kC; ++k)
          V::unpack(src[((u * kC + k) * 2 + 1) * 32 + lane], vf[k]);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float pg = __shfl_sync(0xffffffffu, p,
                                       (u * kG + g) << kLaneShift);
#pragma unroll
          for (int k = 0; k < kC; ++k)
#pragma unroll
            for (int e2 = 0; e2 < kN; ++e2) acc[g][k][e2] += pg * vf[k][e2];
        }
      }
      // the slot is read: refill it with tile i + kStages
      if (i + kStages < my_tiles) issue(i + kStages, slot);
      cp_async_commit();
    }
    cp_async_wait<0>();

    // merge the warps' (m, l, acc) into the split's partial state: M =
    // max_w m_w, l = sum_w l_w e^(m_w - M), acc likewise; a warp that saw
    // no position has m = -inf and weighs 0
    __syncthreads();                     // every warp is done with its ring
    const int stride_w = 2 * kG + kG * dv;
    float* m_w = merge_s + warp * stride_w;
    float* l_w = m_w + kG;
    float* acc_w = l_w + kG;
    if (lane < kG << kLaneShift && (lane & ((1 << kLaneShift) - 1)) == 0 &&
        idx < gn) {                      // u = 0: one lane per g
      m_w[idx] = m;
      l_w[idx] = l;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= gn) break;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = lane + 32 * k;
        if (c < nv)
#pragma unroll
          for (int e = 0; e < kN; ++e) acc_w[g * dv + c * kN + e] = acc[g][k][e];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * dv; i += kThreads) {
      const int g = i / dv, c = i - g * dv;
      float M = -INFINITY;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, merge_s[w * stride_w + g]);
      float L = 0.f, A = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* base = merge_s + w * stride_w;
        if (base[g] != -INFINITY) {
          const float f = expf(base[g] - M);
          L += base[kG + g] * f;
          A += base[2 * kG + i] * f;
        }
      }
      const int64_t row = bh * G + g0 + g;
      part_acc[(row * S + s) * dv + c] = A;
      if (c == 0) {
        part_m[row * S + s] = M;
        part_l[row * S + s] = L;
      }
    }
    __syncthreads();                     // merge_s is the next pass's ring
  }
}

template <typename T, int kG, int kC>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, float* part_m,
           float* part_l, float* part_acc, int B, int Hkv, int G, int d,
           int dv, int bs, int n, int splits, int pages, int min_pages,
           float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(kG, kC, dv, pages);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_split_kernel<T, kG, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(splits, Hkv, B);
  paged_attention_split_kernel<T, kG, kC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), part_m, part_l, part_acc, Hkv, G,
      d, dv, bs, n, min_pages, scale, window, softcap);
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
             const void* tables, const void* lengths, float* part_m,
             float* part_l, float* part_acc, int B, int Hkv, int G, int d,
             int dv, int bs, int n, int splits, int pages, int min_pages,
             float scale, int window, float softcap, cudaStream_t s) {
#define PA_LAUNCH(KG)                                                      \
  return launch<T, KG, kC>(q, k_pool, v_pool, tables, lengths, part_m,     \
                           part_l, part_acc, B, Hkv, G, d, dv, bs, n,     \
                           splits, pages, min_pages, scale, window, softcap, \
                           s)
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
             const void* tables, const void* lengths, float* part_m,
             float* part_l, float* part_acc, int B, int Hkv, int G, int d,
             int dv, int bs, int n, int splits, int pages, int min_pages,
             float scale, int window, float softcap, cudaStream_t s) {
  const int kC = chunks_per_lane(d, dv, sizeof(T));
  const int kG = group_size(G);
  if (kC == 1)
    return launch_g<T, 1>(kG, q, k_pool, v_pool, tables, lengths, part_m,
                          part_l, part_acc, B, Hkv, G, d, dv, bs, n, splits,
                          pages, min_pages, scale, window, softcap, s);
  if (kC == 2)
    return launch_g<T, 2>(kG, q, k_pool, v_pool, tables, lengths, part_m,
                          part_l, part_acc, B, Hkv, G, d, dv, bs, n, splits,
                          pages, min_pages, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// names B7's instance of the merge kernel
struct paged_attention_merge {};

}  // namespace

extern "C" {

// Shared memory one block of the split kernel needs (bytes) for splits of
// `pages` table pages, or 0 if the kernel does not take the shape; dtype
// 0 = float32, 1 = bfloat16.
size_t paged_attention_smem_bytes(int G, int d, int dv, int pages,
                                  int dtype) {
  const int kC = chunks_per_lane(d, dv, dtype == 0 ? 4 : 2);
  if (G < 1 || pages < 1 || !kC || (dtype != 0 && dtype != 1)) return 0;
  return smem_bytes(group_size(G), kC, dv, pages);
}

// The split kernel on `stream`: grid (splits, Hkv, B), partial states into
// part_m, part_l [B, Hkv, G, splits] and part_acc [B, Hkv, G, splits, dv]
// (f32).  Returns cudaGetLastError() after the launch (0 on success).
// window <= 0 means no window, softcap <= 0 means no softcap.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* lengths, void* part_m, void* part_l,
                           void* part_acc, int B, int Hkv, int G, int d,
                           int dv, int bs, int n, int splits, int pages,
                           int min_pages, float scale, int window,
                           float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || bs <= 0 || n <= 0 || splits <= 0 || pages <= 0 ||
      min_pages <= 0)
    return (int)cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch_t<float>(q, k_pool, v_pool, tables, lengths, pm, pl, pa, B,
                           Hkv, G, d, dv, bs, n, splits, pages, min_pages,
                           scale, window, softcap, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, pm, pl,
                                   pa, B, Hkv, G, d, dv, bs, n, splits, pages,
                                   min_pages, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The merge (split_merge.cuh) on `stream`: rows = B * Hkv * G output rows
// of width dv from the split kernel's partial states, into out [rows, dv]
// in the dtype (0 = float32, 1 = bfloat16).  Returns cudaGetLastError().
int paged_attention_merge_launch(const void* part_m, const void* part_l,
                                 const void* part_acc, void* out, int rows,
                                 int splits, int width, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  if (dtype == 0)
    return split_merge::launch<float, paged_attention_merge>(
        pm, pl, pa, static_cast<float*>(out), rows, splits, width, s);
  if (dtype == 1)
    return split_merge::launch<__nv_bfloat16, paged_attention_merge>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), rows, splits, width, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
