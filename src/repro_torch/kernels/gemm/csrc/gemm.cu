// Blocked GEMM for Hopper (sm_90a): out [M, N] = x [M, K] @ y [K, N], an
// f32 accumulator across the whole K loop, the output rounded once to x's
// dtype.  Any M, N, K: the ragged edges are masked, never padded.
//
// Replaces: src/repro/kernels/gemm/kernel.py, gemm_pallas (body
//           _gemm_kernel; its ops.py pads every dimension to the block).
//
// Two kernels, by dtype:
//   * bf16: the tensor cores.  A block computes a 128 x 128 tile of out
//     with 8 warps (2 along M x 4 along N, 64 x 32 each) by mma.sync
//     m16n8k16 (bf16 in, f32 accumulate).  K goes in steps of 32: the
//     [128, 32] slice of x and the [32, 128] slice of y arrive in shared
//     memory by cp.async, double-buffered (the next step's copies fly
//     while this one multiplies), each 16-byte copy zero-filled where it
//     lies past M, N or K.  That needs every row to start on 16 bytes (K
//     and N multiples of 8, aligned pointers); otherwise the same tiles are
//     loaded element by element, masked.  x's fragments come by ldmatrix,
//     y's (row-major [K, N]) by ldmatrix.trans.
//   * f32: the CUDA cores, fmaf, no TF32 (so it holds an f32 tolerance): a
//     64 x 64 tile per block of 256 threads, 4 x 4 outputs each, K in steps
//     of 16 through shared memory, masked loads.
//
// Bound on this card: at gemma2-2b's MLP up-projection, [2048, 2304] @
// [2304, 9216] bf16, 2 M N K = 87.0 Gflop, 88 us at 989 TFLOP/s (dense bf16
// peak); its 61 MB of operands and output take 18 us at 3.35 TB/s.  So
// operations bound it.  mma.sync does not reach the wgmma peak, and this
// design keeps only 2 stages and 8 warps; wgmma, TMA and a deeper ring are
// the redesign's work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
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

struct __align__(16) BfTiles {
  bf16 a[2][kBM * kAStride];                // x [128, 32] per stage
  bf16 b[2][kBK * kBStride];                // y [32, 128] per stage
};

// The copies of K step kt into stage st: x rows m0 .. m0+127, columns
// k0 .. k0+31 (4 chunks of 8 per row), y rows k0 .. k0+31, columns
// n0 .. n0+127 (16 chunks per row); 2 chunks of each per thread.
template <bool kAligned>
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
    if constexpr (kAligned) {
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? x + (int64_t)gm * K + gk : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = gm < M && gk + e < K ? x[(int64_t)gm * K + gk + e] : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 4, col = (c & 15) * 8;
    const int gk = k0 + row, gn = n0 + col;
    bf16* dst = &t.b[st][row * kBStride + col];
    if constexpr (kAligned) {
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? y + (int64_t)gk * N + gn : y, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = gk < K && gn + e < N ? y[(int64_t)gk * N + gn + e] : zero;
    }
  }
}

template <bool kAligned>
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
  load_tiles<kAligned>(t, 0, x, y, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ksteps; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ksteps)      // stage st ^ 1 was freed by the last barrier
      load_tiles<kAligned>(t, st ^ 1, x, y, M, N, K, m0, n0, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();       // all but the newest group: step kt landed
    __syncthreads();
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
// three the same dtype), row-major and contiguous.  Launches on `stream`;
// returns cudaGetLastError() after the launch (0 on success).
int gemm_launch(const void* x, const void* y, void* out, int M, int N, int K,
                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if (dtype == 1) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* yb = static_cast<const bf16*>(y);
    bf16* ob = static_cast<bf16*>(out);
    if (K % 8 == 0 && N % 8 == 0 && aligned(x, 16) && aligned(y, 16))
      gemm_bf16_kernel<true><<<grid, kThreads, 0, st>>>(xb, yb, ob, M, N, K);
    else
      gemm_bf16_kernel<false><<<grid, kThreads, 0, st>>>(xb, yb, ob, M, N, K);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
