// Flash-attention forward for Hopper (sm_90a): an online softmax over KV
// tiles, the scores never written to device memory.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//           flash_attention_pallas (body _flash_kernel).
//
// Shapes: q [B, Tq, Hq, D], k [B, Tk, Hkv, D], v [B, Tk, Hkv, Dv], all
// contiguous in that layout, -> out [B, Tq, Hq, Dv] in q's dtype.  Query
// head h reads KV head h / (Hq / Hkv) straight from the layout: no
// broadcast copy of K and V and no transpose (the reference's op makes
// both).  Query row i sees key j when j < Tk, j <= i if causal (top-left
// aligned, both counted from 0: not bottom-right), and i - j < window
// when a window is given.  The score is (q . k) * scale in f32, then
// softcap * tanh(score / softcap) when a softcap is given.  m, l and acc
// are f32; each probability is rounded to v's dtype before it weights V
// (the Pallas kernel's p.astype(v.dtype)); l sums the unrounded f32
// probabilities; the output is acc / max(l, 1e-30) (the bf16 kernel
// multiplies by that divisor's IEEE reciprocal), rounded once.  A row
// that sees no key at all gets l = 0 and so an output of 0.
//
// Keys at or past Tk are never read (TMA fills them with zeros) and are
// masked, so whatever lies past the end of K and V (NaN included) cannot
// reach the output; the reference's op pads Tk with zero keys that can
// enter the softmax (ROADMAP C2), which this kernel does not reproduce.
// Tiles wholly above the diagonal, wholly left of the window, or at or
// past Tk are skipped by the loop bounds.
//
// Two kernels, by dtype:
//   * bf16: wgmma fed by TMA (after FlashAttention-3).  A block owns 128
//     query rows of one head: two warpgroups of 64 rows each; grid (Hq,
//     B, q-blocks), the q-blocks in reverse under a causal mask so that
//     the longest blocks start first.  One thread loads the Q tile
//     [128, D] once and the first K [kBK, D] and V [kBK, Dv] tiles into a
//     2-stage ring, all by TMA over the [B, T, H, D] tensors read as 4-d
//     (D, H, T, B) with boxes of (64, 1, rows, 1) and the 128-byte
//     swizzle; boxes past D, Dv, Tq or Tk come back as zeros, so D and Dv
//     are padded to 64 for free.  Per tile: S [64, kBK] = Q K^T by wgmma
//     with both operands in shared memory (K is K-major as it lies; the
//     loop over D's 64-column chunks is unrolled at compile time); the
//     logits and the online softmax in registers (masks only on tiles
//     that cross the diagonal, the window edge or Tk; ex2.approx with
//     log2(e) folded into the scale; the softcap's tanh as
//     1 - 2 / (e^2x + 1) through ex2.approx and a reciprocal, within
//     ~1e-6 of tanhf; the accumulator rescaled only where a maximum
//     moved); then acc [64, Dv] += P V by wgmma with P from registers
//     (the f32 S accumulator's fragment is the bf16 A fragment, so P needs
//     no shuffle) and V MN-major through the transpose flag.  The second
//     warpgroup done with a stage refills it by TMA (a count in shared
//     memory says which is second), so no warp is set aside to produce.
//     With a producer warpgroup (384 threads, 168 registers a thread at
//     launch) the width-256 instances spilled alike with setmaxnreg 240,
//     232, 208 or none, and ptxas serialised their wgmma pipeline; with
//     256 threads each has 255, nothing spills, and the kernel ran 1.4x
//     faster.  The two warpgroups interleave on the
//     tensor cores: one's softmax runs beside the other's products.  A
//     warpgroup that sees no key of a tile only hands the stage back.
//     The accumulator width is a template size (64, 128 or 256: Dv
//     rounded up); the key tile is 64 at widths 256 and at 128 with
//     D > 192 (shared memory), else 128.  D and Dv are multiples of 16
//     up to 256; q, k, v and out start on 16 bytes (TMA).
//   * f32: the CUDA cores, for the tests' f32 cases.  Grid
//     (ceil(Tq / 32), Hq, B); 8 warps, 4 query rows each; tiles of 32 keys
//     (one per lane) in shared memory; lane j scores key j, the warp
//     shuffles p and accumulates columns lane, lane + 32, ... of Dv.  Any
//     D and Dv up to 256.  IEEE expf and tanhf.
//
// Bound on this card: operations, at the shapes of the models.  Per
// visible (query, key) pair and head, 2 D + 2 Dv flops: gemma2-2b's global
// layer at B 2, T 1024, 8 heads, D 256, causal: 8.6 Gflop, 8.7 us at 989
// TFLOP/s, while its 13 MB of q, k, v and out take 3.9 us at 3.35 TB/s.
// There the grid is 128 blocks on 132 SMs and the last q-block (128 rows
// by 1024 keys, 134 Mflop) sets the time: 18 us at one SM's share of the
// peak.  Each score also costs MUFU operations at 16 a clock per SM: one
// ex2, and with a softcap an ex2 and a rcp more.  At D = Dv = 256 with
// the softcap that is 3 / 16 of a clock per (row, key), against
// 1,024 flop / 4,096 a clock = 1 / 4 on the tensor cores: the two are
// near each other, and only overlap hides one behind the other.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I kernels/common (no --use_fast_math: the f32
//        kernel's expf, tanhf and final division and the bf16 kernel's
//        reciprocal of l stay IEEE; the bf16 kernel asks for ex2.approx
//        and rcp.approx itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;                // D and Dv, both kernels
constexpr int kThreads = 256;             // the f32 kernel
constexpr int kWarps = kThreads / 32;

// the keys [begin, end) any query row in [q0, q_end) may see
struct KeyRange {
  int begin, end;
};

__device__ __forceinline__ KeyRange key_range(int q0, int q_end, int Tk,
                                              int causal, int window) {
  KeyRange r{0, Tk};
  if (causal) r.end = min(Tk, q_end);                 // keys <= q_end - 1
  if (window > 0) r.begin = max(0, q0 - window + 1);  // q0 - j < window
  return r;
}

__device__ __forceinline__ bool visible(int row, int key, int Tk, int causal,
                                        int window) {
  return key < Tk && (!causal || key <= row) &&
         (window <= 0 || row - key < window);
}

__device__ __forceinline__ float logit(float s, float scale, float softcap) {
  const float x = s * scale;
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, Q, K and V by TMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                  // query rows per block
constexpr int kWThreads = 256;            // 2 consumer WGs
constexpr int kRowBytes = 128;            // 64 bf16: one swizzled row

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__host__ __device__ inline int d_chunks(int D) { return (D + 63) / 64; }

constexpr int kStages = 2;                // K and V tiles in the ring

// shared memory of one block: 1024 to align, Q [128, D], kStages stages of
// K [bk, D] and V [bk, dvp] (64-column chunks), 1 + 2 kStages barriers and
// kStages release counts
inline size_t wgmma_smem_bytes(int D, int dvp, int bk) {
  return 1024 +
         (size_t)kRowBytes *
             (kBQ * d_chunks(D) + kStages * bk * (d_chunks(D) + dvp / 64)) +
         (1 + 2 * kStages) * sizeof(uint64_t) + kStages * sizeof(int);
}

// The logits of this tile in the log2 domain (x log2(e)), -inf where
// masked.  kMask: the tile crosses the diagonal, the window edge or Tk.
template <bool kMask, int kN>
__device__ __forceinline__ void logits_log2(float (&s)[kN], int row_a,
                                            int key0, int Tk, int causal,
                                            int window, float qk_log2,
                                            float cap_in, float cap_out) {
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    float y;
    if (cap_out > 0.f) {                    // cap tanh(x / cap) log2(e)
      const float big = ex2(s[e] * cap_in);  // e^(2 x / cap)
      y = cap_out * fmaf(-2.f, rcp(big + 1.f), 1.f);
    } else {
      y = s[e] * qk_log2;
    }
    if (kMask) {
      const int row = row_a + 8 * ((e >> 1) & 1);
      const int key = key0 + (e >> 2) * 8 + (e & 1);
      if (!visible(row, key, Tk, causal, window)) y = -INFINITY;
    }
    s[e] = y;
  }
}

// The online softmax of one tile's scores `s` (this thread's share of
// rows row_a and row_a + 8): the logits, the running maxima m and sums l,
// s overwritten with the f32 probabilities, and the factors by which the
// accumulator's rows must be rescaled.
template <int kBK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBK / 2], float& m_a, float& m_b, float& l_a, float& l_b,
    float& corr_a, float& corr_b, int row_a, int r_lo, int k0, int key0,
    int Tk, int causal, int window, float qk_log2, float cap_in,
    float cap_out) {
  // the mask only where the tile crosses the diagonal, the window's edge
  // or Tk for some row of this warpgroup
  const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > r_lo) ||
                    (window > 0 && r_lo + 63 - k0 >= window);
  if (edge)
    logits_log2<true>(s, row_a, key0, Tk, causal, window, qk_log2, cap_in,
                      cap_out);
  else
    logits_log2<false>(s, row_a, key0, Tk, causal, window, qk_log2, cap_in,
                       cap_out);
  // row maxima over the quad that shares a row
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) {
    if (e & 2) mx_b = fmaxf(mx_b, s[e]);
    else mx_a = fmaxf(mx_a, s[e]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  // a row with nothing visible yet keeps m = -inf: subtract 0 instead
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
  corr_a = ex2(m_a - base_a);
  corr_b = ex2(m_b - base_b);
  m_a = mn_a;
  m_b = mn_b;
  // p = 2^(y - m), unrounded into l
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) {
    s[e] = ex2(s[e] - ((e & 2) ? base_b : base_a));
    if (e & 2) sum_b += s[e];
    else sum_a += s[e];
  }
  l_a = l_a * corr_a + sum_a;       // this thread's share; summed at the end
  l_b = l_b * corr_b + sum_b;
}

// The probabilities rounded to bf16 into P's A fragments: the S
// accumulator's n-tiles 2 k and 2 k + 1 make the k-th step of 16 keys.
template <int kBK>
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2],
                                       uint32_t (&p)[kBK / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    p[j / 2][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);  // row g
    p[j / 2][(j & 1) * 2 + 1] =
        pack_bf16(s[4 * j + 2], s[4 * j + 3]);                  // row g + 8
  }
}

template <int kDvp, int kBK, int kDc>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ out, int Tq, int Tk, int Hq, int Hkv,
                   int Dv, float qk_log2, float cap_in, float cap_out,
                   int causal, int window) {
  using namespace hopper;
  constexpr int dc = kDc;                 // 64-column chunks of D
  constexpr int kVc = kDvp / 64;          // 64-column chunks of V
  constexpr int kS = kBK / 2;             // S accumulator registers
  constexpr int kA = kDvp / 2;            // output accumulator registers
  constexpr int k_stage = dc * kBK * kRowBytes;
  constexpr int v_stage = kVc * kBK * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =                    // dc x [128, 64]
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + dc * kBQ * kRowBytes;  // kStages x dc x ...
  unsigned char* v_s = k_s + kStages * k_stage;     // kStages x kVc x ...
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * v_stage);
  uint64_t* k_full = q_full + 1;          // [kStages] each
  uint64_t* v_full = k_full + kStages;
  int* released = reinterpret_cast<int*>(v_full + kStages);  // [kStages]:
                                          // warpgroups done with a stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qb * kBQ, hk = h / (Hq / Hkv);
  const KeyRange kr = key_range(q0, min(q0 + kBQ, Tq), Tk, causal, window);
  const int t_begin = kr.begin / kBK;
  const int t_end = kr.end > kr.begin ? (kr.end + kBK - 1) / kBK : t_begin;
  const int wg = threadIdx.x / 128;
  // K and V of tile t into stage s, by TMA
  auto load_tile = [&](int t, int s) {
    mbar_arrive_expect_tx(&k_full[s], k_stage);
#pragma unroll
    for (int c = 0; c < dc; ++c)
      tma_load_4d(k_s + s * k_stage + c * kBK * kRowBytes, &kmap, &k_full[s],
                  c * 64, hk, t * kBK, b);
    mbar_arrive_expect_tx(&v_full[s], v_stage);
#pragma unroll
    for (int c = 0; c < kVc; ++c)
      tma_load_4d(v_s + s * v_stage + c * kBK * kRowBytes, &vmap, &v_full[s],
                  c * 64, hk, t * kBK, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);             // expect_tx by the issuer
      mbar_init(&v_full[s], 1);
      released[s] = 0;
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(q_full, dc * kBQ * kRowBytes);
#pragma unroll
    for (int c = 0; c < dc; ++c)
      tma_load_4d(q_s + c * kBQ * kRowBytes, &qmap, q_full, c * 64, h, q0, b);
    for (int i = 0; i < kStages && t_begin + i < t_end; ++i)
      load_tile(t_begin + i, i);
  }
  __syncthreads();

  const int half = wg;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r_lo = q0 + half * 64;        // this warpgroup's 64 rows
  // this thread's rows: row_a (accumulator elements 4 n, 4 n + 1) and
  // row_a + 8 (4 n + 2, 4 n + 3)
  const int row_a = r_lo + warp * 16 + (lane >> 2);
  const KeyRange wr = key_range(r_lo, min(r_lo + 64, Tq), Tk, causal, window);
  float acc[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) acc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint64_t dq = desc_sw128(q_s + half * 64 * kRowBytes, 0, 1024);

  mbar_wait(q_full, 0);                   // also when no tile follows
  int s = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    mbar_wait(&k_full[s], phase);
    if (r_lo < Tq && k0 < wr.end && k0 + kBK > wr.begin) {
      // S = Q K^T: 4 k-steps of 16 per 64-column chunk of D
      float sc[kS];
#pragma unroll
      for (int e = 0; e < kS; ++e) sc[e] = 0.f;
      const uint64_t dk = desc_sw128(k_s + s * k_stage, 0, 1024);
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < dc; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<kBK>::template ss<0>(
              sc, dq + ((c * kBQ * kRowBytes + kk * 32) >> 4),
              dk + ((c * kBK * kRowBytes + kk * 32) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      float corr_a, corr_b;
      softmax_tile<kBK>(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, row_a, r_lo,
                        k0, k0 + 2 * (lane & 3), Tk, causal, window,
                        qk_log2, cap_in, cap_out);
      uint32_t p[kBK / 16][4];
      pack_p<kBK>(sc, p);
      // rescale only where a maximum moved (rarely, after the first tiles)
      if (!__all_sync(0xffffffffu, corr_a == 1.f && corr_b == 1.f)) {
#pragma unroll
        for (int n = 0; n < kA / 4; ++n) {
          acc[4 * n] *= corr_a;
          acc[4 * n + 1] *= corr_a;
          acc[4 * n + 2] *= corr_b;
          acc[4 * n + 3] *= corr_b;
        }
      }

      // acc += P V: V [kBK, Dv] is MN-major, k-steps of 16 rows
      mbar_wait(&v_full[s], phase);
      const uint64_t dv = desc_sw128(v_s + s * v_stage, kBK * kRowBytes,
                                     1024);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Wgmma<kDvp>::template rs<1>(acc, p[kk],
                                    dv + ((kk * 16 * kRowBytes) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    } else {
      mbar_wait(&v_full[s], phase);       // nothing to see: hand it back
    }
    // the second warpgroup done with stage s refills it with tile
    // t + kStages (both warpgroups' products on it have completed)
    if ((threadIdx.x & 127) == 0 && atomicAdd(&released[s], 1) == 1) {
      atomicExch(&released[s], 0);
      if (t + kStages < t_end) load_tile(t + kStages, s);
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int64_t o_row = (int64_t)Hq * Dv;
  bf16* ob = out + ((int64_t)b * Tq * Hq + h) * Dv;
#pragma unroll
  for (int n = 0; n < kA / 4; ++n) {
    const int col = n * 8 + 2 * (lane & 3);
    if (col >= Dv) continue;
    if (row_a < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * o_row + col) =
          __floats2bfloat162_rn(acc[4 * n] * inv_a, acc[4 * n + 1] * inv_a);
    if (row_a + 8 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row_a + 8) * o_row + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv_b,
                                acc[4 * n + 3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFQ = 32;                   // query rows per block
constexpr int kFRows = kFQ / kWarps;      // rows per warp
constexpr int kFK = 32;                   // keys per tile: one per lane
constexpr int kFCols = kMaxD / 32;        // Dv columns per lane

inline size_t simt_smem_bytes(int D, int Dv) {
  return sizeof(float) *
         ((size_t)kFQ * D + (size_t)kFK * (D + 1) + (size_t)kFK * Dv);
}

__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Tq, int Tk, int Hq, int Hkv, int D, int Dv, float scale,
                  int causal, int window, float softcap) {
  extern __shared__ __align__(16) float fsmem[];
  float* q_s = fsmem;                      // [kFQ, D]
  float* k_s = q_s + kFQ * D;              // [kFK, D + 1]: lanes on rows
  float* v_s = k_s + kFK * (D + 1);        // [kFK, Dv]

  const int q0 = blockIdx.x * kFQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t q_row = (int64_t)Hq * D, k_row = (int64_t)Hkv * D;
  const int64_t v_row = (int64_t)Hkv * Dv, o_row = (int64_t)Hq * Dv;
  const float* qb = q + ((int64_t)b * Tq * Hq + h) * D;
  const float* kb = k + ((int64_t)b * Tk * Hkv + hk) * D;
  const float* vb = v + ((int64_t)b * Tk * Hkv + hk) * Dv;
  float* ob = out + ((int64_t)b * Tq * Hq + h) * Dv;

  const KeyRange kr = key_range(q0, min(q0 + kFQ, Tq), Tk, causal, window);
  const int t_begin = kr.begin / kFK;
  const int t_end = kr.end > kr.begin ? (kr.end + kFK - 1) / kFK : t_begin;

  for (int i = tid; i < kFQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    q_s[i] = q0 + r < Tq ? qb[(q0 + r) * q_row + c] : 0.f;
  }
  float acc[kFRows][kFCols], m[kFRows], l[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kFCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kFK;
    __syncthreads();                       // the last tile is used up
    for (int i = tid; i < kFK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      k_s[r * (D + 1) + c] = k0 + r < Tk ? kb[(k0 + r) * k_row + c] : 0.f;
    }
    for (int i = tid; i < kFK * Dv; i += kThreads) {
      const int r = i / Dv, c = i - r * Dv;
      v_s[i] = k0 + r < Tk ? vb[(k0 + r) * v_row + c] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      const int rr = warp * kFRows + i, row = q0 + rr;
      float sc = 0.f;
      for (int d = 0; d < D; ++d)
        sc = fmaf(q_s[rr * D + d], k_s[lane * (D + 1) + d], sc);
      const float x = visible(row, key, Tk, causal, window)
                          ? logit(sc, scale, softcap)
                          : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float corr = expf(m[i] - base);
      const float p = expf(x - base);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kFCols; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kFK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kFCols; ++c) {
          const int col = lane + 32 * c;
          if (col < Dv) acc[i][c] = fmaf(pj, v_s[j * Dv + col], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int row = q0 + warp * kFRows + i;
    if (row >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kFCols; ++c) {
      const int col = lane + 32 * c;
      if (col < Dv) ob[row * o_row + col] = acc[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;       // a block's shared memory (H100)

// the bf16 kernel's accumulator width and key tile for (D, Dv): 64 keys
// at width 256 and at width 128 with D > 192 (128 would not fit in
// shared memory), else 128
inline int wgmma_dvp(int Dv) { return Dv <= 64 ? 64 : Dv <= 128 ? 128 : 256; }
inline int wgmma_bk(int D, int Dv) {
  const int dvp = wgmma_dvp(Dv);
  return dvp == 256 || (dvp == 128 && d_chunks(D) == 4) ? 64 : 128;
}

// whether a kernel takes (D, Dv): bf16 (dtype 1) by wgmma's k-steps of
// 16, f32 (dtype 0) any size; both at most kMaxD
inline bool supported(int D, int Dv, int dtype) {
  if (D <= 0 || Dv <= 0 || D > kMaxD || Dv > kMaxD) return false;
  if (dtype == 1) return D % 16 == 0 && Dv % 16 == 0;
  return dtype == 0;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// a TMA map over [B, T, H, W] bf16 read as (W, H, T, B), boxes of
// (64, 1, rows, 1)
inline int bthw_map(CUtensorMap* map, const void* base, int B, int T, int H,
                    int W, int rows) {
  const cuuint64_t t = T > 1 ? T : 1;     // a map has no empty dimension
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, t,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 t * H * W * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hopper::make_map_bf16(map, base, 4, dims, strides, box);
}

template <int kDvp, int kBK, int kDc>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Tq, int Tk, int Hq, int Hkv, int D, int Dv,
                 float scale, int causal, int window, float softcap,
                 cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (int err = bthw_map(&qm, q, B, Tq, Hq, D, kBQ)) return err;
  if (int err = bthw_map(&km, k, B, Tk, Hkv, D, kBK)) return err;
  if (int err = bthw_map(&vm, v, B, Tk, Hkv, Dv, kBK)) return err;
  const size_t smem = wgmma_smem_bytes(D, kDvp, kBK);
  if (int err = set_smem(flash_wgmma_kernel<kDvp, kBK, kDc>, smem))
    return err;
  const float log2e = 1.4426950408889634f;
  const float cap_in = softcap > 0.f ? 2.f * scale * log2e / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap * log2e : 0.f;
  const dim3 grid(Hq, B, (Tq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<kDvp, kBK, kDc><<<grid, kWThreads, smem, st>>>(
      qm, km, vm, static_cast<bf16*>(out), Tq, Tk, Hq, Hkv, Dv,
      scale * log2e, cap_in, cap_out, causal, window);
  return (int)cudaGetLastError();
}

// the instance for D's number of 64-column chunks: the S loop is unrolled
// at compile time (with a loop bound known only at run time, ptxas spills
// more at width 256 and the kernel ran 1.2-1.3x slower)
template <int kDvp, int kBK>
int launch_by_dc(const void* q, const void* k, const void* v, void* out,
                 int B, int Tq, int Tk, int Hq, int Hkv, int D, int Dv,
                 float scale, int causal, int window, float softcap,
                 cudaStream_t st) {
  switch (d_chunks(D)) {
    case 1:
      return launch_wgmma<kDvp, kBK, 1>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D,
                                        Dv, scale, causal, window, softcap,
                                        st);
    case 2:
      return launch_wgmma<kDvp, kBK, 2>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D,
                                        Dv, scale, causal, window, softcap,
                                        st);
    case 3:
      return launch_wgmma<kDvp, kBK, 3>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D,
                                        Dv, scale, causal, window, softcap,
                                        st);
    default:
      return launch_wgmma<kDvp, kBK, 4>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D,
                                        Dv, scale, causal, window, softcap,
                                        st);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), or 0 if the kernel does not take
// (D, Dv); dtype 0 = float32, 1 = bfloat16.
size_t flash_attention_smem_bytes(int D, int Dv, int dtype) {
  if (!supported(D, Dv, dtype)) return 0;
  return dtype == 1 ? wgmma_smem_bytes(D, wgmma_dvp(Dv), wgmma_bk(D, Dv))
                    : simt_smem_bytes(D, Dv);
}

// out = attention(q, k, v) as in the header; window 0 = none, softcap 0 =
// none, causal 0/1.  bf16 needs q, k, v and out on 16 bytes.  Launches on
// `stream`; returns cudaGetLastError() after the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Tq, int Tk, int Hq, int Hkv,
                           int D, int Dv, float scale, int causal, int window,
                           float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 0 || Tq < 0 || Tk < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      window < 0 || !supported(D, Dv, dtype) || B > 65535 || Hq > 65535 ||
      (Tq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  if (dtype == 1) {
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    const int dvp = wgmma_dvp(Dv), bk = wgmma_bk(D, Dv);
    if (dvp == 64)
      return launch_by_dc<64, 128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                   scale, causal, window, softcap, st);
    if (dvp == 128 && bk == 128)          // D <= 192
      return launch_by_dc<128, 128>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                    scale, causal, window, softcap, st);
    if (dvp == 128)                       // D > 192: 4 chunks
      return launch_wgmma<128, 64, 4>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D,
                                      Dv, scale, causal, window, softcap, st);
    return launch_by_dc<256, 64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                 scale, causal, window, softcap, st);
  }
  const size_t smem = simt_smem_bytes(D, Dv);
  if (int err = set_smem(flash_simt_kernel, smem)) return err;
  const dim3 grid((Tq + kFQ - 1) / kFQ, Hq, B);
  flash_simt_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, Hq,
      Hkv, D, Dv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // extern "C"
