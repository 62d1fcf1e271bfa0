// Blocked GEMM for Hopper (sm_90a): out [M, N] = x [M, K] @ y [K, N], an
// f32 accumulator across the whole K loop, the output rounded once to x's
// dtype.  Any M, N, K: the ragged edges are masked, never padded.
//
// Replaces: src/repro/kernels/gemm/kernel.py, gemm_pallas (body
//           _gemm_kernel; its ops.py pads every dimension to the block).
//
// Three kernels; the caller (ops.py, gemm_path) names the one to launch,
// by dtype and shape, before the launch:
//   * bf16, K and N multiples of 8 and x, y 16-byte aligned ("wgmma"): a
//     persistent, warp-specialised wgmma kernel.  A block (one per SM)
//     walks 256 x 192 tiles of out, M first, so the blocks in flight share
//     y's column tiles in L2.  Its third warpgroup is the producer: it
//     gives its registers back (setmaxnreg 24) and one thread keeps a ring
//     of 4 stages full by TMA, each stage x [256, 64] and y [64, 192]
//     (three [64, 64] boxes) with the 128-byte swizzle, guarded by a full
//     and an empty mbarrier; the ring runs on across tiles, so the next
//     tile's loads overlap this tile's epilogue.  The two consumer
//     warpgroups (setmaxnreg 240) own 128 rows each: per stage 2 x 4
//     wgmma m64n192k16 with both operands in shared memory (x K-major; y
//     row-major [K, N], so MN-major, read through wgmma's transpose flag,
//     not transposed in memory), the f32 accumulator (192 registers a
//     thread) in registers.  One stage's products stay in flight while
//     the next stage's are issued; a stage goes back to the producer when
//     its products are done.  TMA reads zeros past M, N and K, so ragged
//     edges need no padded copy; the epilogue rounds to bf16 once and
//     stores pairs, masked.
//   * bf16, any other shape ("mma": K or N not a multiple of 8, or x or y
//     off 16 bytes): mma.sync m16n8k16 on 128 x 128 tiles with 8 warps (2
//     along M x 4 along N, 64 x 32 each), K in steps of 32 through two
//     shared-memory stages loaded element by element, masked past M, N, K
//     (no row need start on 16 bytes); x's fragments by ldmatrix, y's by
//     ldmatrix.trans.
//   * f32 ("f32"): the CUDA cores, fmaf, no TF32 (so it holds an f32
//     tolerance): a 64 x 64 tile per block of 256 threads, 4 x 4 outputs
//     each, K in steps of 16 through shared memory, masked loads.
//
// Bound on this card: at gemma2-2b's MLP up-projection, [2048, 2304] @
// [2304, 9216] bf16, 2 M N K = 87.0 Gflop, 88 us at 989 TFLOP/s (dense bf16
// peak); its 61 MB of operands and output take 18 us at 3.35 TB/s.  So
// operations bound it, and only wgmma reaches that rate.  384 tiles of
// 256 x 192 make 2.9 rounds of 132 SMs (128 x 256 made 4.4, the last 36 %
// full); each tile reads 2.1 MB of x and y through L2 for 226 Mflop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I kernels/common (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16, any shape: mma.sync through a 2-stage cp.async ring
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;               // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kAStride = kBK + 8;           // bf16 per smem row of x: 80 B
constexpr int kBStride = kBN + 8;           // bf16 per smem row of y: 272 B

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

struct __align__(16) BfTiles {
  bf16 a[2][kBM * kAStride];                // x [128, 32] per stage
  bf16 b[2][kBK * kBStride];                // y [32, 128] per stage
};

// The loads of K step kt into stage st: x rows m0 .. m0+127, columns
// k0 .. k0+31 (4 runs of 8 per row), y rows k0 .. k0+31, columns
// n0 .. n0+127 (16 runs per row); 2 runs of each per thread, zero past
// M, N, K.
__device__ __forceinline__ void load_tiles(BfTiles& t, int st,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ y, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  const bf16 zero = __ushort_as_bfloat16(0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 2, col = (c & 3) * 8;
    const int gm = m0 + row, gk = k0 + col;
    bf16* dst = &t.a[st][row * kAStride + col];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = gm < M && gk + e < K ? x[(int64_t)gm * K + gk + e] : zero;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 4, col = (c & 15) * 8;
    const int gk = k0 + row, gn = n0 + col;
    bf16* dst = &t.b[st][row * kBStride + col];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = gk < K && gn + e < N ? y[(int64_t)gk * N + gn + e] : zero;
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                 bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) unsigned char smem_raw[sizeof(BfTiles)];
  BfTiles& t = *reinterpret_cast<BfTiles*>(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * kWarpM, wn = (warp & 3) * kWarpN;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix row / column offsets of this lane within a 16 x 16 tile
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ksteps = (K + kBK - 1) / kBK;
  load_tiles(t, 0, x, y, M, N, K, m0, n0, 0);
  for (int kt = 0; kt < ksteps; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ksteps)      // stage st ^ 1 was freed by the last barrier
      load_tiles(t, st ^ 1, x, y, M, N, K, m0, n0, (kt + 1) * kBK);
    __syncthreads();          // step kt's stage is written
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &t.a[st][(wm + i * 16 + lrow) * kAStride +
                                   ks * 16 + lcol]);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &t.b[st][(ks * 16 + lrow) * kBStride + wn +
                                      j2 * 16 + lcol]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * j2], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j2 + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // each accumulator: rows g and g + 8 of a 16 x 8 tile, columns 2 tig, + 1
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        bf16* dst = out + (int64_t)row * N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// bf16, aligned shapes: warp-specialised wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kWM = 256, kWN = 192, kWK = 64, kStages = 4;
constexpr int kWThreads = 384;              // 2 consumer WGs + producer
constexpr int kMi = kWM / 128;              // m64 row blocks per consumer
constexpr int kATile = kWM * kWK * 2;       // x [256, 64]: 32 KB
constexpr int kBChunk = kWK * 64 * 2;       // y [64, 64]: 8 KB
constexpr int kBTile = kBChunk * (kWN / 64);
constexpr int kStageBytes = kATile + kBTile;
constexpr size_t kWSmem =                   // + 1024 to align the ring
    1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kWThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap ymap,
                  bf16* __restrict__ out, int M, int N, int K, int m_tiles,
                  int tiles) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s =                      // kStages x [kWM, 64]
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* b_s = a_s + kStages * kATile;  // kStages x kWN/64 x ...
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * kBTile);
  uint64_t* empty = full + kStages;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // uniform
  const int ksteps = (K + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], 2);              // one arrival per consumer WG
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: block i takes tiles i, i + grid, ...  The ring runs on
  // across tiles, so the producer loads the next tile while the consumers
  // store this one.
  if (wg == 2) {                            // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * kWM, n0 = (tile / m_tiles) * kWN;
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_2d(a_s + s * kATile, &xmap, &full[s], kt * kWK, m0);
#pragma unroll
          for (int c = 0; c < kWN / 64; ++c)
            tma_load_2d(b_s + s * kBTile + c * kBChunk, &ymap, &full[s],
                        n0 + c * 64, kt * kWK);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int half = wg;                      // rows kWM / 2 half .. + kWM / 2
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kWM, n0 = (tile / m_tiles) * kWN;
    float acc[kMi][kWN / 2];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) acc[mi][i] = 0.f;
    int prev = -1;                          // the stage still in flight
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&full[s], phase);
      const uint64_t db = desc_sw128(b_s + s * kBTile, kBChunk, 1024);
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) reg_fence(acc[mi]);
      wgmma_fence();
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        const uint64_t da = desc_sw128(
            a_s + s * kATile + (half * kWM / 2 + mi * 64) * 128, 0, 1024);
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)  // 32 B along x's rows, 16
          Wgmma<kWN>::ss<1>(acc[mi], da + 2 * kk,  // rows down y's
                                     db + 128 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                      // the step before is done
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) reg_fence(acc[mi]);
      if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) reg_fence(acc[mi]);
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);

#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      const int row0 =
          m0 + half * kWM / 2 + mi * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * (lane & 3);
        if (col >= N) continue;             // N % 8 == 0: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * N +
                                               col) =
                __floats2bfloat162_rn(acc[mi][4 * j + 2 * h],
                                      acc[mi][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

int launch_wgmma(const void* x, const void* y, void* out, int M, int N,
                 int K, cudaStream_t st) {
  CUtensorMap xmap, ymap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {64, kWM};
  const cuuint64_t ydims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t ystride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t ybox[2] = {64, kWK};
  if (int err = hopper::make_map_bf16(&xmap, x, 2, xdims, xstride, xbox))
    return err;
  if (int err = hopper::make_map_bf16(&ymap, y, 2, ydims, ystride, ybox))
    return err;
  if (cudaError_t err = cudaFuncSetAttribute(
          gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kWSmem))
    return (int)err;
  int dev = 0, sms = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (cudaError_t err =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)err;
  const int m_tiles = (M + kWM - 1) / kWM;
  const int tiles = m_tiles * ((N + kWN - 1) / kWN);
  gemm_wgmma_kernel<<<tiles < sms ? tiles : sms, kWThreads, kWSmem, st>>>(
      xmap, ymap, static_cast<bf16*>(out), M, N, K, m_tiles, tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFPad = 4;

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float as[kFK][kFM + kFPad];   // x tile, k-major
  __shared__ __align__(16) float bs[kFK][kFN + kFPad];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFM * kFK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int m = e / kFK, k = e % kFK;         // consecutive k: coalesced
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = gm < M && gk < K ? x[(int64_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kFK * kFN / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = e / kFN, n = e % kFN;
      const int gk = k0 + k, gn = n0 + n;
      bs[k][n] = gk < K && gn < N ? y[(int64_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[(int64_t)row * N + col] = acc[i][j];
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

}  // namespace

extern "C" {

// out [M, N] = x [M, K] @ y [K, N], dtype 0 = float32, 1 = bfloat16 (all
// three the same dtype), row-major and contiguous, by kernel `path`: 0 =
// f32 (float32), 1 = mma (bfloat16, any shape), 2 = wgmma (bfloat16, K > 0
// and K, N multiples of 8, x, y and out 16-byte aligned).  A path that does
// not take the call returns cudaErrorInvalidValue and launches nothing.
// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).
int gemm_launch(const void* x, const void* y, void* out, int M, int N, int K,
                int dtype, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0 || dtype != (path == 0 ? 0 : 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if (path == 2) {
    if (K == 0 || K % 8 || N % 8 || !aligned(x, 16) || !aligned(y, 16) ||
        !aligned(out, 16))
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, y, out, M, N, K, st);
  }
  if (path == 1) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* yb = static_cast<const bf16*>(y);
    bf16* ob = static_cast<bf16*>(out);
    gemm_bf16_kernel<<<grid, kThreads, 0, st>>>(xb, yb, ob, M, N, K);
    return (int)cudaGetLastError();
  }
  if (path == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
