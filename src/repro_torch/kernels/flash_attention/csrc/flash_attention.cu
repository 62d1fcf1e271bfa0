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
// softcap * tanhf(score / softcap) when a softcap is given.  m, l and acc
// are f32; each probability is rounded to v's dtype before it weights V
// (the Pallas kernel's p.astype(v.dtype)); l sums the unrounded f32
// probabilities; the output is acc / max(l, 1e-30), rounded once.  A row
// that sees no key at all gets l = 0 and so an output of 0.
//
// Keys at or past Tk are never loaded (cp.async zero-fills them) and are
// masked, so whatever lies past the end of K and V (NaN included) cannot
// reach the output; the reference's op pads Tk with zero keys that can
// enter the softmax (ROADMAP C2), which this kernel does not reproduce.
// Tiles wholly above the diagonal, wholly left of the window, or at or
// past Tk are skipped by the loop bounds.
//
// Two kernels, by dtype:
//   * bf16: the tensor cores.  Grid (ceil(Tq / 128), Hq, B); 8 warps, each
//     owning 16 query rows of the block's 128.  The Q tile [128, D] is
//     loaded once into shared memory; K and V tiles of kBK keys ([kBK, D]
//     and [kBK, Dv]) arrive by cp.async, double-buffered.  Per tile:
//     S [16, kBK] = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate;
//     K read by ldmatrix), the mask, the online softmax in registers (row
//     maxima and sums across the 4 threads of a quad), P rounded to bf16
//     straight into the A fragments of P V, then acc [16, Dv] += P V by
//     mma.sync (V read by ldmatrix.trans).  D and Dv are multiples of 16
//     up to 256.  The accumulator is a template size (64, 128 or 256
//     columns); at 256 the tile is 32 keys so that acc (128 registers) and
//     S fit beside each other without spilling, else 64.  Shared memory:
//     2 (128 (D + 8) + 2 kBK (D + 8) + 2 kBK (Dv + 8)) bytes, over 48 KB
//     from D = 64 up, so the launcher opts in (cudaFuncSetAttribute).
//   * f32: the CUDA cores, for the tests' f32 cases.  Grid
//     (ceil(Tq / 32), Hq, B); 8 warps, 4 query rows each; tiles of 32 keys
//     (one per lane) in shared memory; lane j scores key j, the warp
//     shuffles p and accumulates columns lane, lane + 32, ... of Dv.  Any
//     D and Dv up to 256.
//
// Bound on this card: operations, at the shapes of the models.  Per
// visible (query, key) pair and head, 2 D + 2 Dv flops: gemma2-2b's global
// layer at B 2, T 1024, 8 heads, D 256, causal: 8.6 Gflop, 8.7 us at 989
// TFLOP/s, while its 13 MB of q, k, v and out take 3.9 us at 3.35 TB/s.
// mma.sync does not reach the wgmma peak, and this design keeps 8 warps,
// a 2-stage ring and no warp specialisation; wgmma, TMA and splitting the
// softmax from the products are the redesign's work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf, tanhf and the final
//        division stay IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;                // D and Dv, both kernels
constexpr int kPad = 8;                   // bf16 per smem row, vs conflicts

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                  // query rows per block
constexpr int kWarps = 8;                 // 16 query rows each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// the keys [kv_begin, kv_end) any query row in [q0, q_end) may see
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

inline size_t mma_smem_bytes(int D, int Dv, int bk) {
  return sizeof(bf16) * ((size_t)kBQ * (D + kPad) +
                         2 * (size_t)bk * (D + kPad) +
                         2 * (size_t)bk * (Dv + kPad));
}

template <int kDv, int kBK>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Tq,
                 int Tk, int Hq, int Hkv, int D, int Dv, float scale,
                 int causal, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = D + kPad, vs = Dv + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // [kBQ, ds]
  bf16* k_s = q_s + kBQ * ds;                        // 2 x [kBK, ds]
  bf16* v_s = k_s + 2 * kBK * ds;                    // 2 x [kBK, vs]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int64_t q_row = (int64_t)Hq * D, k_row = (int64_t)Hkv * D;
  const int64_t v_row = (int64_t)Hkv * Dv, o_row = (int64_t)Hq * Dv;
  const bf16* qb = q + ((int64_t)b * Tq * Hq + h) * D;
  const bf16* kb = k + ((int64_t)b * Tk * Hkv + hk) * D;
  const bf16* vb = v + ((int64_t)b * Tk * Hkv + hk) * Dv;
  bf16* ob = out + ((int64_t)b * Tq * Hq + h) * Dv;

  const KeyRange kr = key_range(q0, min(q0 + kBQ, Tq), Tk, causal, window);
  const int t_begin = kr.begin / kBK;
  const int t_end = kr.end > kr.begin ? (kr.end + kBK - 1) / kBK : t_begin;
  const int dc = D / 8, vc = Dv / 8;                 // 16-byte chunks a row

  for (int i = tid; i < kBQ * dc; i += kThreads) {   // the Q tile
    const int r = i / dc, c = i - r * dc;
    const bool ok = q0 + r < Tq;
    cp_async16(q_s + r * ds + c * 8,
               ok ? qb + (q0 + r) * q_row + c * 8 : qb, ok);
  }
  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kBK;
    bf16* kd = k_s + st * kBK * ds;
    bf16* vd = v_s + st * kBK * vs;
    for (int i = tid; i < kBK * dc; i += kThreads) {
      const int r = i / dc, c = i - r * dc;
      const bool ok = k0 + r < Tk;                   // else zero, not read
      cp_async16(kd + r * ds + c * 8,
                 ok ? kb + (k0 + r) * k_row + c * 8 : kb, ok);
    }
    for (int i = tid; i < kBK * vc; i += kThreads) {
      const int r = i / vc, c = i - r * vc;
      const bool ok = k0 + r < Tk;
      cp_async16(vd + r * vs + c * 8,
                 ok ? vb + (k0 + r) * v_row + c * 8 : vb, ok);
    }
  };

  constexpr int kNt = kBK / 8;                       // score n-tiles
  constexpr int kVt = kDv / 8;                       // acc n-tiles
  float acc[kVt][4];
#pragma unroll
  for (int n = 0; n < kVt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's rows: ra (accumulator elements 0, 1), rb (2, 3)
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  // ldmatrix lane offsets: A / V^T tiles (lrow, lcol), K tiles (krow, kcol)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  const int krow = (lane & 7) + 8 * (lane >> 4), kcol = 8 * ((lane >> 3) & 1);
  const int v16 = Dv / 16;

  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();                                 // Q and the first tile
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, st ^ 1);       // freed by the barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = k_s + st * kBK * ds;
    const bf16* vt = v_s + st * kBK * vs;
    const int k0 = t * kBK;

    // S = Q K^T, this warp's 16 rows by the tile's kBK keys
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + lrow) * ds + ks * 16 + lcol);
#pragma unroll
      for (int j2 = 0; j2 < kBK / 16; ++j2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (j2 * 16 + krow) * ds + ks * 16 + kcol);
        mma_bf16(s[2 * j2], a, bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], a, bk[2], bk[3]);
      }
    }

    // logits, mask, row maxima (over the quad that shares a row)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tig + (e & 1);
        const float x = visible(e < 2 ? ra : rb, key, Tk, causal, window)
                            ? logit(s[j][e], scale, softcap)
                            : -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
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
    const float corr_a = expf(m_a - base_a), corr_b = expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;

    // p = exp(s - m): f32 into l, bf16 into P's A fragments
    uint32_t p[kBK / 16][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const float p0 = expf(s[j][0] - base_a), p1 = expf(s[j][1] - base_a);
      const float p2 = expf(s[j][2] - base_b), p3 = expf(s[j][3] - base_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      p[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);      // row g
      p[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }
    l_a = l_a * corr_a + sum_a;      // this thread's share; summed at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < kVt; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // acc += P V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kDv / 16; ++c) {
        if (c < v16) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + lrow) * vs + c * 16 + lcol);
          mma_bf16(acc[2 * c], p[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * c + 1], p[kk], bv[2], bv[3]);
        }
      }
    __syncthreads();                 // stage st is free for tile t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < kVt; ++n) {
    const int col = n * 8 + 2 * tig;
    if (col >= Dv) continue;
    if (ra < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ra * o_row + col) =
          __floats2bfloat162_rn(acc[n][0] / den_a, acc[n][1] / den_a);
    if (rb < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + rb * o_row + col) =
          __floats2bfloat162_rn(acc[n][2] / den_b, acc[n][3] / den_b);
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

inline int mma_dv(int Dv) { return Dv <= 64 ? 64 : Dv <= 128 ? 128 : 256; }
inline int mma_bk(int Dv) { return mma_dv(Dv) == 256 ? 32 : 64; }

// whether a kernel takes (D, Dv): bf16 (dtype 1) by the mma's k-steps of
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

template <int kDv, int kBK>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Tq, int Tk, int Hq, int Hkv, int D, int Dv, float scale,
               int causal, int window, float softcap, cudaStream_t st) {
  const size_t smem = mma_smem_bytes(D, Dv, kBK);
  if (int err = set_smem(flash_mma_kernel<kDv, kBK>, smem)) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  flash_mma_kernel<kDv, kBK><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, Tk, Hq, Hkv,
      D, Dv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), or 0 if the kernel does not take
// (D, Dv); dtype 0 = float32, 1 = bfloat16.
size_t flash_attention_smem_bytes(int D, int Dv, int dtype) {
  if (!supported(D, Dv, dtype)) return 0;
  return dtype == 1 ? mma_smem_bytes(D, Dv, mma_bk(Dv))
                    : simt_smem_bytes(D, Dv);
}

// out = attention(q, k, v) as in the header; window 0 = none, softcap 0 =
// none, causal 0/1.  Launches on `stream`; returns cudaGetLastError()
// after the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Tq, int Tk, int Hq, int Hkv,
                           int D, int Dv, float scale, int causal, int window,
                           float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 0 || Tq < 0 || Tk < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      window < 0 || !supported(D, Dv, dtype) || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  if (dtype == 1) {
    switch (mma_dv(Dv)) {
      case 64:
        return launch_mma<64, 64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                  scale, causal, window, softcap, st);
      case 128:
        return launch_mma<128, 64>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                   scale, causal, window, softcap, st);
      default:
        return launch_mma<256, 32>(q, k, v, out, B, Tq, Tk, Hq, Hkv, D, Dv,
                                   scale, causal, window, softcap, st);
    }
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
