// Absorbed-MLA paged decode kernel for Hopper (sm_90a): one query per row,
// attending in DeepSeek's latent space over a paged latent cache.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
//           paged_mla_attention_pallas (body _paged_mla_kernel).
//
// Shapes: q_eff [B, H, r] (q_nope . W_uk), q_rope [B, H, dr],
// ckv_pool [N, bs, r], kr_pool [N, bs, dr], tables [B, n] int32,
// lengths [B] int32 -> out [B, H, r] (q_eff's dtype).  Row b attends the
// virtual positions pos < lengths[b]; position p lives at
// pool[tables[b, p / bs], p % bs].  The score of head h at p is
// (q_eff[h] . c_kv[p] + q_rope[h] . k_rope[p]) * scale, summed in f32;
// m, l and acc are f32; each probability is rounded to the pool dtype
// before it weights c_kv (which is both the key's latent part and the
// value), as the reference does; the output is acc / max(l, 1e-30),
// rounded to q's dtype once.
//
// Design.  The TPU kernel keeps acc [H, r] for a whole row in VMEM; at
// full width that is 128 x 512 x 4 B = 256 KB, more than an SM's shared
// memory or registers.  So heads are split across thread blocks, and the
// row's sequence is split too (flash-decoding, as B7): the grid is
// (splits, head blocks, B).  ops.plan_splits picks the split count on the
// host from B, the head blocks, n, bs and the SM count alone; each block
// cuts its own row's pages on the card, from the row's length, into
// chunks of ceil(pages / splits), at least min_pages (as B7), so a short
// row in a wide table is still spread over the splits.  A split loads
// only its own chunk's table entries; one past its row's length writes
// the empty state (m = -inf, l = 0) at once.
// Inside a split, the TPU's sequential grid axis over blocks becomes a
// loop over tiles of positions.  A tile is loaded once into shared memory
// (only the valid positions, whatever block they lie in) and serves both
// products.  Blocks at or after the length, and table entries past it,
// are never read, so garbage (or NaN) there never reaches the output.
// Each split writes its heads' partial state in f32, m and l [B, H, S]
// and the unnormalised acc [B, H, S, r]; split_merge.cuh (shared with B7)
// merges them and rounds to q's dtype once.  Two paths, by dtype:
//   * bf16 (the full widths): the tensor cores.  8 warps, 16 heads per
//     block (the mma's M).  Tiles of 32 positions arrive by cp.async into
//     a ring of 2 buffers, one tile ahead of the one in use (each thread
//     copies a fixed 16-byte column of fixed rows, the rows' pool offsets
//     computed once per position); 2 buffers, not the first version's 4,
//     so that two blocks fit an SM and the splits of a serve step run in
//     one wave.
//     Scores [16 heads, 32 positions] by mma.sync m16n8k16 (bf16 in, f32
//     accumulate; warp w takes 8 positions over one half of the r + dr
//     dims); an online softmax in f32 (16 threads per head), whose p is
//     rounded to bf16 in shared memory; then acc [16, r] += p . c_kv by
//     mma.sync again, warp w owning an eighth of the r columns, c_kv read
//     back by ldmatrix.trans.
//   * f32 (the smoke widths): the CUDA cores.  8 warps, one head per
//     warp, tiles of 16 positions in shared memory; a warp's 16
//     lane-strided dot products and butterfly sums interleave (rows past
//     the valid count are masked, never branched around); each thread
//     holds its share of the next tile in registers while the current
//     one is multiplied; thread i accumulates latent columns 2i, 2i + 1
//     for the block's 8 heads.
// Each split re-reads its latent tiles once per head block (8 times at
// full width), which the 50 MB L2 serves.
// Sizes: r <= 512 and dr <= 128, multiples of 4 in f32 (16-byte chunks)
// and of 16 in bf16 (the mma's k-steps); r = 32, dr = 16 in f32 and
// r = 512, dr = 64 in bf16 are the smoke and the full widths; any H and
// bs; pages while a split's block ids (f32) or pool rows (bf16) fit in
// shared memory beside the tiles.
//
// Bound on this card: HBM bytes.  A call must read each valid position's
// latent row once, (r + dr) * sizeof(T) bytes, plus q_eff and q_rope, and
// write out: at B = 8, H = 128, lengths ~300 about 5 MB, 1.5 us at
// 3.35 TB/s; its 2 * (r + dr) + 2 * r flops per head and position are
// 0.7 us at the bf16 tensor-core peak.
//
// What this design leaves on the table (work for a later change): a
// split's tiles still go one after another, each a chain of dependent
// steps (scores, a barrier, the softmax, a barrier, PV, a barrier) that 8
// warps cannot hide, so a long row's time grows with its chunk; and the
// partial acc, 2 KB per head and split, is written and read back once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf and the final division
//        stay IEEE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int kWarps = 8;                 // one head per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = kWarps;            // heads per block
constexpr int kTile = 16;                 // positions per tile
constexpr int kMaxR = 2 * kThreads;       // a column pair per thread: 512
constexpr int kMaxQ4 = kMaxR / 4 / 32;    // float4 chunks of q_eff per lane
constexpr int kMaxDr = 4 * 32;            // one float4 of q_rope per lane

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// c_kv tile [kTile, r], k_rope tile [kTile, dr], p [kTile, kHeads],
// corr [kHeads] (f32), then the split's block ids [pages] (int32)
inline size_t simt_smem_bytes(int r, int dr, int pages) {
  return sizeof(float) *
             ((size_t)kTile * (r + dr) + (size_t)kTile * kHeads + kHeads) +
         sizeof(int32_t) * (size_t)pages;
}

__global__ void __launch_bounds__(kThreads)
paged_mla_simt_kernel(const float* __restrict__ q_eff,
                      const float* __restrict__ q_rope,
                      const float* __restrict__ ckv_pool,
                      const float* __restrict__ kr_pool,
                      const int32_t* __restrict__ tables,
                      const int32_t* __restrict__ lengths,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int r, int dr,
                      int bs, int n, int min_pages, float scale) {
  constexpr int kN = 4;                         // floats per 16 bytes
  // 16-byte chunks of one tile a thread loads: kTile rows of at most
  // kMaxR + kMaxDr elements
  constexpr int kChunks =
      (kTile * (kMaxR + kMaxDr) / kN + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ckv_s = smem;                          // [kTile, r]
  float* kr_s = ckv_s + kTile * r;              // [kTile, dr]
  float* p_s = kr_s + kTile * dr;               // [kTile, kHeads]
  float* corr_s = p_s + kTile * kHeads;         // [kHeads]
  int32_t* blk_s = reinterpret_cast<int32_t*>(corr_s + kHeads);  // [pages]

  const int s = blockIdx.x, S = gridDim.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kHeads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = h0 + warp;
  const bool head_live = h < H;
  const int heads = min(kHeads, H - h0);
  const int nr4 = r / 4, nd4 = dr / 4;          // float4s per smem row
  const int nck = r / kN, nkr = dr / kN;        // 16-byte chunks per row
  const int row_chunks = nck + nkr;
  split_merge::launch_dependents();             // the merge may launch

  // the row's pages [0, p_hi), cut into chunks of `chunk` pages: split s
  // takes [page0, page_end), its valid positions [lo, hi)
  const int length = min(lengths[b], n * bs);   // positions past the table
                                                // span do not exist
  const int p_hi = (length + bs - 1) / bs;
  const int chunk = max((p_hi + S - 1) / S, min_pages);
  const int page0 = s * chunk, lo = page0 * bs;
  const int page_end = min(page0 + chunk, p_hi);
  const int hi = min(length, page_end * bs);
  if (lo >= hi) {                               // the empty state
    if (threadIdx.x < heads) {
      part_m[((int64_t)b * H + h0 + threadIdx.x) * S + s] = -INFINITY;
      part_l[((int64_t)b * H + h0 + threadIdx.x) * S + s] = 0.f;
    }
    return;
  }
  // the chunk's block ids (at most `pages`); tile rows start at zero, and a
  // row past a tile's valid count only ever holds an earlier tile's data
  for (int i = threadIdx.x; i < page_end - page0; i += kThreads)
    blk_s[i] = tables[(int64_t)b * n + page0 + i];
  for (int i = threadIdx.x; i < kTile * (r + dr); i += kThreads)
    ckv_s[i] = 0.f;
  __syncthreads();

  // the tile at p0: this thread's 16-byte chunks, straight from the pools
  // into registers (the next tile's loads fly while this one is used)
  auto fetch = [&](int p0, int nt, uint4* buf) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int i = threadIdx.x + k * kThreads;
      buf[k] = make_uint4(0, 0, 0, 0);
      if (i < nt * row_chunks) {
        const int t = i / row_chunks;
        const int c = i - t * row_chunks;
        const int p = p0 + t;
        const int64_t row = (int64_t)blk_s[p / bs - page0] * bs + p % bs;
        buf[k] = c < nck ? load16(ckv_pool + row * r + c * kN)
                         : load16(kr_pool + row * dr + (c - nck) * kN);
      }
    }
  };
  auto stash = [&](int nt, const uint4* buf) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nt * row_chunks) {
        const int t = i / row_chunks;
        const int c = i - t * row_chunks;
        float* dst = c < nck ? ckv_s + t * r + c * kN
                             : kr_s + t * dr + (c - nck) * kN;
        *reinterpret_cast<uint4*>(dst) = buf[k];
      }
    }
  };

  // this warp's head: q_eff and q_rope in registers
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qe[kMaxQ4], qr = zero4;
#pragma unroll
  for (int i = 0; i < kMaxQ4; ++i) {
    const int c4 = lane + 32 * i;
    qe[i] = head_live && c4 < nr4
                ? reinterpret_cast<const float4*>(
                      q_eff + ((int64_t)b * H + h) * r)[c4]
                : zero4;
  }
  if (head_live && lane < nd4)
    qr = reinterpret_cast<const float4*>(q_rope +
                                         ((int64_t)b * H + h) * dr)[lane];

  // PV: this thread's latent columns 2c, 2c + 1 for the block's heads
  const int c2 = threadIdx.x;
  const bool owns = 2 * c2 < r;
  float2 acc[kHeads];
#pragma unroll
  for (int k = 0; k < kHeads; ++k) acc[k] = make_float2(0.f, 0.f);
  float m = -INFINITY, l = 0.f;                 // head h's softmax state

  uint4 pre[kChunks];
  fetch(lo, min(kTile, hi - lo), pre);
  for (int p0 = lo; p0 < hi; p0 += kTile) {
    const int nt = min(kTile, hi - p0);         // valid positions here
    stash(nt, pre);
    __syncthreads();
    if (p0 + kTile < hi)
      fetch(p0 + kTile, min(kTile, hi - p0 - kTile), pre);

    // scores of head h at the tile's positions (rows >= nt hold zeros or
    // an earlier tile's values and are masked below); online softmax
    float pmine = 0.f, corr = 0.f;
    if (head_live) {
      float s[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4* crow = reinterpret_cast<const float4*>(ckv_s + t * r);
        float acc_s = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxQ4; ++i) {
          const int c4 = lane + 32 * i;
          if (c4 < nr4) acc_s = dot4(qe[i], crow[c4], acc_s);
        }
        if (lane < nd4)
          acc_s = dot4(qr,
                       reinterpret_cast<const float4*>(kr_s + t * dr)[lane],
                       acc_s);
        s[t] = acc_s;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) s[t] = warp_sum(s[t]) * scale;
      float m_new = m;
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < nt) m_new = fmaxf(m_new, s[t]);
      corr = expf(m - m_new);                   // m = -inf -> 0
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float e = t < nt ? expf(s[t] - m_new) : 0.f;
        sum += e;
        if (lane == t) pmine = e;
      }
      l = l * corr + sum;
      m = m_new;
    }
    if (lane < kTile) p_s[lane * kHeads + warp] = pmine;
    if (lane == 0) corr_s[warp] = corr;
    __syncthreads();

    // acc = acc * corr + sum_t p[t] * c_kv[t]
    if (owns) {
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        const float cr = corr_s[k];
        acc[k].x *= cr;
        acc[k].y *= cr;
      }
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float2 v = reinterpret_cast<const float2*>(ckv_s + t * r)[c2];
        const float4 pa = reinterpret_cast<const float4*>(p_s + t * kHeads)[0];
        const float4 pb = reinterpret_cast<const float4*>(p_s + t * kHeads)[1];
        const float pk[kHeads] = {pa.x, pa.y, pa.z, pa.w,
                                  pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int k = 0; k < kHeads; ++k) {
          acc[k].x = fmaf(pk[k], v.x, acc[k].x);
          acc[k].y = fmaf(pk[k], v.y, acc[k].y);
        }
      }
    }
    __syncthreads();
  }

  // the split's partial state: head h's (m, l), and the unnormalised acc
  // of the block's heads
  if (head_live && lane == 0) {
    part_m[((int64_t)b * H + h) * S + s] = m;
    part_l[((int64_t)b * H + h) * S + s] = l;
  }
  if (owns) {
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      if (k >= heads) break;
      reinterpret_cast<float2*>(
          part_acc + (((int64_t)b * H + h0 + k) * S + s) * r)[c2] = acc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMWarps = 8;
constexpr int kMThreads = 32 * kMWarps;
constexpr int kMHeads = 16;               // the mma's M: heads per block
constexpr int kMTile = 32;                // positions per tile
constexpr int kStages = 2;                // tiles in the cp.async ring
constexpr int kMaxPairs = kMaxR / 16 / kMWarps;   // 16-column pairs a warp
constexpr int kPad = 8;                   // bf16 per smem row, vs conflicts
constexpr int kSStride = kMTile + 4;      // f32 scores row
constexpr int kPStride = kMTile + kPad;   // bf16 probabilities row

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

// q [16, r + dr + pad], kStages tiles of c_kv [32, r + pad] and k_rope
// [32, dr + pad] (bf16), two halves of the scores [16, kSStride] (f32),
// p [16, kPStride] (bf16), corr [16] (f32), the pool row of each of the
// pages * bs positions a split spans (int32)
inline size_t mma_smem_bytes(int r, int dr, int pages, int bs) {
  return 2 * ((size_t)kMHeads * (r + dr + kPad) +
              kStages * (size_t)kMTile * (r + kPad + dr + kPad) +
              (size_t)kMHeads * kPStride) +
         4 * (2 * (size_t)kMHeads * kSStride + kMHeads) +
         4 * (size_t)pages * bs;
}

// One block: 16 heads of one split of one row, 8 warps.  Per 32-position
// tile of the split's valid positions, loaded
// by cp.async into a ring of kStages buffers, kStages - 1 tiles ahead of
// the one in use:
//   scores  S [16 heads, 32 pos] = [q_eff | q_rope] . [c_kv | k_rope]^T,
//           warp w computing positions 8 (w % 4) .. + 7 over one half of
//           the r + dr dims (w / 4), the halves summed by the softmax;
//   softmax thread i: head i / 16, positions 2 (i % 16), + 1, online
//           (m, l in f32), p rounded to bf16 into shared memory;
//   PV      acc [16, r] += p [16, 32] . c_kv [32, r], warp w owning the
//           16-column pairs w, w + 8, ... (c_kv read by ldmatrix.trans).
__global__ void __launch_bounds__(kMThreads)
paged_mla_mma_kernel(const __nv_bfloat16* __restrict__ q_eff,
                     const __nv_bfloat16* __restrict__ q_rope,
                     const __nv_bfloat16* __restrict__ ckv_pool,
                     const __nv_bfloat16* __restrict__ kr_pool,
                     const int32_t* __restrict__ tables,
                     const int32_t* __restrict__ lengths,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, int H, int r, int dr,
                     int bs, int n, int min_pages, float scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rq = r + dr + kPad, rc = r + kPad, rk = dr + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);           // [16, rq]
  bf16* c_s = q_s + kMHeads * rq;                    // kStages x [32, rc]
  bf16* k_s = c_s + kStages * kMTile * rc;           // kStages x [32, rk]
  bf16* p_s = k_s + kStages * kMTile * rk;           // [16, kPStride]
  float* s_s = reinterpret_cast<float*>(p_s + kMHeads * kPStride);
  float* corr_s = s_s + 2 * kMHeads * kSStride;            // [16]
  int32_t* row_s = reinterpret_cast<int32_t*>(corr_s + kMHeads);
                                                     // [pages * bs]
  const int s = blockIdx.x, S = gridDim.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kMHeads;
  const int heads = min(kMHeads, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nr8 = r / 8, nd8 = dr / 8;      // 16-byte chunks per row
  split_merge::launch_dependents();         // the merge may launch

  // the row's pages [0, p_hi), cut into chunks of `chunk` pages: split s
  // takes positions [lo, span), its valid ones [lo, hi)
  const int length = min(lengths[b], n * bs);
  const int p_hi = (length + bs - 1) / bs;
  const int chunk = max((p_hi + S - 1) / S, min_pages);
  const int page0 = s * chunk, lo = page0 * bs;
  const int span = min(page0 + chunk, p_hi) * bs;
  const int hi = min(length, span);
  if (lo >= hi) {                           // the empty state
    if (tid < heads) {
      part_m[((int64_t)b * H + h0 + tid) * S + s] = -INFINITY;
      part_l[((int64_t)b * H + h0 + tid) * S + s] = 0.f;
    }
    return;
  }
  // the pool row of every position the chunk's pages hold, once (no
  // division per load; at most `pages` pages); a row past the length is
  // never dereferenced
  for (int p = lo + tid; p < span; p += kMThreads)
    row_s[p - lo] = (int32_t)((uint32_t)tables[(int64_t)b * n + p / bs] *
                                  (uint32_t)bs + (uint32_t)(p % bs));

  // the block's queries, [q_eff | q_rope] per head; rows past H are zero
  for (int i = tid; i < kMHeads * (nr8 + nd8); i += kMThreads) {
    const int row = i / (nr8 + nd8), c = i - row * (nr8 + nd8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < heads) {
      const int64_t hr = (int64_t)b * H + h0 + row;
      v = c < nr8 ? load16(q_eff + hr * r + c * 8)
                  : load16(q_rope + hr * dr + (c - nr8) * 8);
    }
    *reinterpret_cast<uint4*>(q_s + row * rq + c * 8) = v;
  }
  __syncthreads();

  // a tile's copies: thread tid takes 16-byte chunk tid % nr8 of rows
  // tid / nr8, + 128 / nr8, ... of c_kv, and likewise for k_rope
  const int c_rows = kMThreads / nr8, c_t0 = tid / nr8, c_c = tid % nr8;
  const int k_rows = kMThreads / nd8, k_t0 = tid / nd8, k_c = tid % nd8;
  auto issue = [&](int tile, int buf) {
    const int p0 = tile * kMTile;             // from lo
    bf16* cb = c_s + buf * kMTile * rc;
    bf16* kb = k_s + buf * kMTile * rk;
    if (c_t0 < c_rows)
      for (int t = c_t0; t < kMTile; t += c_rows) {
        const bool valid = lo + p0 + t < hi;  // else zero-filled, not read
        const int64_t row = valid ? row_s[p0 + t] : 0;
        cp_async16(cb + t * rc + c_c * 8, ckv_pool + row * r + c_c * 8,
                   valid);
      }
    if (k_t0 < k_rows)
      for (int t = k_t0; t < kMTile; t += k_rows) {
        const bool valid = lo + p0 + t < hi;
        const int64_t row = valid ? row_s[p0 + t] : 0;
        cp_async16(kb + t * rk + k_c * 8, kr_pool + row * dr + k_c * 8,
                   valid);
      }
  };

  float acc[kMaxPairs][2][4];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float m = -INFINITY, l = 0.f;    // head tid / 16's state (softmax role)
  const int sh = tid >> 4, sq = (tid & 15) * 2;
  const int npairs = r / 16;
  // ldmatrix row / column offsets of this lane within a 16 x 16 tile
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);

  // one commit group per tile slot, empty past the last tile, so that
  // "all but the newest kStages - 1 groups done" always means "this tile
  // has landed"
  const int ntiles = (hi - lo + kMTile - 1) / kMTile;
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t, t);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile % kStages;
    const int ahead = tile + kStages - 1;     // into the slot freed last
    if (ahead < ntiles) issue(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* cb = c_s + buf * kMTile * rc;
    const bf16* kb = k_s + buf * kMTile * rk;

    // scores of positions 8 (w % 4) .. + 7 over half w / 4 of the dims
    // (two accumulators: even and odd k-steps, so consecutive mma do not
    // wait on each other)
    {
      const int sw = warp & 3, kh = warp >> 2;
      const int nk = (r + dr) / 16, half = (nk + 1) / 2;
      const int k_end = min(nk, (kh + 1) * half), nr16 = r / 16;
      const bf16* crow = cb + (8 * sw + g) * rc + 2 * tig;
      const bf16* krow = kb + (8 * sw + g) * rk + 2 * tig - r;
      const bf16* qa = q_s + lrow * rq + lcol;
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int ks = kh * half; ks < k_end; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + ks * 16);
        const bf16* src = (ks < nr16 ? crow : krow) + ks * 16;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(src + 8);
        if (ks & 1) mma_bf16(d1, a, b0, b1);
        else mma_bf16(d0, a, b0, b1);
      }
      float* s0 = s_s + (kh * kMHeads + g) * kSStride + 8 * sw + 2 * tig;
      float* s1 = s0 + 8 * kSStride;
      *reinterpret_cast<float2*>(s0) = make_float2(d0[0] + d1[0],
                                                   d0[1] + d1[1]);
      *reinterpret_cast<float2*>(s1) = make_float2(d0[2] + d1[2],
                                                   d0[3] + d1[3]);
    }
    __syncthreads();

    // online softmax: 16 threads per head, 2 positions each; positions
    // past the length score -inf
    {
      const int pos = lo + tile * kMTile + sq;
      const float2 s0 = *reinterpret_cast<const float2*>(
          s_s + sh * kSStride + sq);
      const float2 s1 = *reinterpret_cast<const float2*>(
          s_s + (kMHeads + sh) * kSStride + sq);
      const float sx = pos < hi ? (s0.x + s1.x) * scale : -INFINITY;
      const float sy = pos + 1 < hi ? (s0.y + s1.y) * scale : -INFINITY;
      float mx = fmaxf(sx, sy);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);     // m = -inf -> 0
      const float ex = expf(sx - m_new), ey = expf(sy - m_new);
      float sum = ex + ey;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = l * corr + sum;
      m = m_new;
      *reinterpret_cast<__nv_bfloat162*>(p_s + sh * kPStride + sq) =
          __floats2bfloat162_rn(ex, ey);      // p in the pool dtype
      if ((tid & 15) == 0) corr_s[sh] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p . c_kv
    {
      const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[i][j][0] *= c_lo;
          acc[i][j][1] *= c_lo;
          acc[i][j][2] *= c_hi;
          acc[i][j][3] *= c_hi;
        }
#pragma unroll
      for (int ks = 0; ks < kMTile / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, p_s + lrow * kPStride + ks * 16 + lcol);
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          const int q = warp + kMWarps * i;
          if (q < npairs) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, cb + (ks * 16 + lrow) * rc + q * 16 + lcol);
            mma_bf16(acc[i][0], a, bb[0], bb[1]);
            mma_bf16(acc[i][1], a, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();              // buf is free for tile + kStages
  }

  // the split's partial state: (m, l) of head sh, and the unnormalised
  // acc of heads g and g + 8
  if ((tid & 15) == 0 && sh < heads) {
    part_m[((int64_t)b * H + h0 + sh) * S + s] = m;
    part_l[((int64_t)b * H + h0 + sh) * S + s] = l;
  }
  float* acc_lo = part_acc + (((int64_t)b * H + h0 + g) * S + s) * r;
  float* acc_hi = part_acc + (((int64_t)b * H + h0 + g + 8) * S + s) * r;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int q = warp + kMWarps * i;
    if (q >= npairs) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = q * 16 + j * 8 + 2 * tig;
      if (g < heads)
        *reinterpret_cast<float2*>(acc_lo + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (g + 8 < heads)
        *reinterpret_cast<float2*>(acc_hi + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// whether a kernel takes (r, dr): f32 (dtype 0) by 16-byte chunks, bf16
// (dtype 1) by the mma's k-steps of 16
inline bool supported(int r, int dr, int dtype) {
  if (r <= 0 || dr <= 0 || r > kMaxR || dr > kMaxDr) return false;
  if (dtype == 0) return r % 4 == 0 && dr % 4 == 0;
  return dtype == 1 && r % 16 == 0 && dr % 16 == 0;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch_mma(const void* q_eff, const void* q_rope, const void* ckv_pool,
               const void* kr_pool, const void* tables, const void* lengths,
               float* part_m, float* part_l, float* part_acc, int B, int H,
               int r, int dr, int bs, int n, int splits, int pages,
               int min_pages, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = mma_smem_bytes(r, dr, pages, bs);
  if (int err = set_smem(paged_mla_mma_kernel, smem)) return err;
  const dim3 grid(splits, (H + kMHeads - 1) / kMHeads, B);
  paged_mla_mma_kernel<<<grid, kMThreads, smem, stream>>>(
      static_cast<const bf16*>(q_eff), static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(ckv_pool), static_cast<const bf16*>(kr_pool),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), part_m, part_l, part_acc, H, r,
      dr, bs, n, min_pages, scale);
  return (int)cudaGetLastError();
}

int launch_simt(const void* q_eff, const void* q_rope, const void* ckv_pool,
                const void* kr_pool, const void* tables, const void* lengths,
                float* part_m, float* part_l, float* part_acc, int B, int H,
                int r, int dr, int bs, int n, int splits, int pages,
                int min_pages, float scale, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(r, dr, pages);
  if (int err = set_smem(paged_mla_simt_kernel, smem)) return err;
  const dim3 grid(splits, (H + kHeads - 1) / kHeads, B);
  paged_mla_simt_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv_pool), static_cast<const float*>(kr_pool),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), part_m, part_l, part_acc, H, r,
      dr, bs, n, min_pages, scale);
  return (int)cudaGetLastError();
}

// names B8's instance of the merge kernel
struct paged_mla_attention_merge {};

}  // namespace

extern "C" {

// Shared memory one block of the split kernel needs (bytes) for splits of
// `pages` table pages of bs positions, or 0 if the kernel does not take
// the shape; dtype 0 = float32, 1 = bfloat16.
size_t paged_mla_attention_smem_bytes(int r, int dr, int pages, int bs,
                                      int dtype) {
  if (!supported(r, dr, dtype) || pages < 1 || bs < 1) return 0;
  return dtype == 1 ? mma_smem_bytes(r, dr, pages, bs)
                    : simt_smem_bytes(r, dr, pages);
}

// The split kernel on `stream`: grid (splits, head blocks, B), partial
// states into part_m, part_l [B, H, splits] and part_acc [B, H, splits, r]
// (f32).  Returns cudaGetLastError() after the launch (0 on success).
int paged_mla_attention_launch(const void* q_eff, const void* q_rope,
                               const void* ckv_pool, const void* kr_pool,
                               const void* tables, const void* lengths,
                               void* part_m, void* part_l, void* part_acc,
                               int B, int H, int r, int dr, int bs, int n,
                               int splits, int pages, int min_pages,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || bs <= 0 || n <= 0 || splits <= 0 || pages <= 0 ||
      min_pages <= 0 || !supported(r, dr, dtype))
    return (int)cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 1)
    return launch_mma(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths, pm,
                      pl, pa, B, H, r, dr, bs, n, splits, pages, min_pages,
                      scale, s);
  return launch_simt(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths, pm,
                     pl, pa, B, H, r, dr, bs, n, splits, pages, min_pages,
                     scale, s);
}

// The merge (split_merge.cuh) on `stream`: rows = B * H output rows of
// width r from the split kernel's partial states, into out [rows, r] in
// the dtype (0 = float32, 1 = bfloat16).  Returns cudaGetLastError().
int paged_mla_attention_merge_launch(const void* part_m, const void* part_l,
                                     const void* part_acc, void* out,
                                     int rows, int splits, int width,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  if (dtype == 0)
    return split_merge::launch<float, paged_mla_attention_merge>(
        pm, pl, pa, static_cast<float*>(out), rows, splits, width, s);
  if (dtype == 1)
    return split_merge::launch<__nv_bfloat16, paged_mla_attention_merge>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), rows, splits, width, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
