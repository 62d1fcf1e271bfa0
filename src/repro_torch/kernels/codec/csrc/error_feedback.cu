// Error feedback (EF) for the BSP sync's wire codecs in one pass over memory
// (Hopper, sm_90a): the `bsp.ef` phase of
// runtime/trainer.make_bsp_train_step, once per codec'd bucket.
//
// Replaces no TPU kernel.  The reference runs EF as jitted jnp
// (repro/optim/compression.error_feedback_step), which XLA fuses into one
// loop; the port ran it eagerly as about eleven PyTorch passes over the
// bucket (`g.add_(res)`, `quantization_error(g, c)`, `res.copy_(...)`,
// `g.sub_(...)`), moving ~90 B an element for int8 and ~56 B for bf16.
//
// In place on the rank-stacked gradient bucket g [W, L] (contiguous) and
// the residual r [W, L] whose rows lie `rstride` elements apart (the
// bucket's columns of the trainer's [W, total] EF residual).  For each
// element, with x = g + r:
//   int8, per block of 128 consecutive elements of a row:
//     scale = max|x| * f32(1/127); safe = scale == 0 ? 1 : scale
//     q     = clamp(rint(x / safe), -127, 127), NaN -> 0 (the int8 cast)
//     r'    = x - f32(q) * scale      (the product rounded, then the sum)
//     g'    = x - r'
//   bf16:
//     r'    = x - f32(bf16_rn(x));  g' = x - r'
// Every rounding is spelled out (__fadd_rn, __fdiv_rn, __fmul_rn,
// __fsub_rn; the file is built without --use_fast_math, so
// subnormals are kept and nothing is contracted), so that g' and r' equal
// the eager PyTorch sequence on the card bit for bit: its true division
// by the safe scale, its multiply by the f32 reciprocal of 127, its
// `torch.addcmul(x, q, scale, value=-1)`, which on CUDA rounds the product
// before the difference (on the CPU, and in the jitted reference, it is
// one fused multiply-add), and its amax, which propagates NaN, as the
// block's maximum over the absolute values' bits does too (a NaN's bits
// exceed inf's).
//
// Bound on this card: HBM bytes.  Each element is read twice (g, r) and
// written twice (g', r'): 16 B, 3.35 TB/s on an H100 SXM.  The arithmetic
// (one IEEE division an element for int8) is far below any rate.
//
// Design: the work is cut into chunks of 128 consecutive elements of a row
// (one int8 codec block; a row's last bf16 chunk may be shorter).  A
// persistent grid (at most 132 x 8 blocks of 256 threads, all resident)
// walks the W x ceil(L / 128) chunks, warp w taking chunks w, w + warps,
// ...; each lane holds four elements: on the vector path one float4 of g
// and one of r (lane * 4 .. lane * 4 + 3, 16-byte loads and stores), on the
// scalar path elements lane + 32 j.  int8's block maximum is one
// `redux.sync` over the warp (__reduce_max_sync on the absolute values'
// bits).  Indices are 64-bit (a bucket row reaches ~3e8 elements).
// The vector path needs g and r on 16 bytes and L and rstride multiples of
// 4; anything else takes the scalar path (ops.ef_path picks it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kChunk = 128;                  // elements a warp iteration
constexpr float kInv127 = (float)(1.0 / 127.0);

enum Codec { kBf16 = 0, kInt8 = 1 };

__device__ __forceinline__ float int8_residual(float x, float scale,
                                               float safe) {
  const float y = rintf(__fdiv_rn(x, safe));
  // torch's clamp keeps NaN and its int8 cast makes it 0; the cast through
  // int also turns -0 into +0, as q.to(int8).to(f32) does
  const float q = y != y ? 0.0f
      : __int2float_rn(__float2int_rz(fminf(fmaxf(y, -127.0f), 127.0f)));
  return __fsub_rn(x, __fmul_rn(q, scale));
}

__device__ __forceinline__ float bf16_residual(float x) {
  return __fsub_rn(x, __bfloat162float(__float2bfloat16_rn(x)));
}

template <int kCodec, bool kVec>
__global__ void __launch_bounds__(kThreads)
error_feedback_kernel(float* __restrict__ g, float* __restrict__ r,
                      int64_t L, int64_t rstride, int64_t chunks_per_row,
                      int64_t chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t k = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       k < chunks; k += warps) {
    const int64_t row = k / chunks_per_row;
    const int64_t col = (k - row * chunks_per_row) * kChunk;
    const int64_t cols = L - col < kChunk ? L - col : kChunk;
    float* gp = g + row * L + col;
    float* rp = r + row * rstride + col;
    // element j of this lane: vector lane * 4 + j, scalar lane + 32 j
    bool live[4];
    float x[4];
    if (kVec) {
      const bool on = lane * 4 < cols;          // cols % 4 == 0 here
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (on) {
        a = reinterpret_cast<const float4*>(gp)[lane];
        b = reinterpret_cast<const float4*>(rp)[lane];
      }
      x[0] = __fadd_rn(a.x, b.x);
      x[1] = __fadd_rn(a.y, b.y);
      x[2] = __fadd_rn(a.z, b.z);
      x[3] = __fadd_rn(a.w, b.w);
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = on;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        live[j] = e < cols;
        x[j] = live[j] ? __fadd_rn(gp[e], rp[e]) : 0.0f;
      }
    }
    float rn[4];
    if (kCodec == kInt8) {                  // cols == 128: all lanes live
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = __float_as_uint(x[j]) & 0x7fffffffu;
        m = a > m ? a : m;
      }
      m = __reduce_max_sync(0xffffffffu, m);
      const float scale = __fmul_rn(__uint_as_float(m), kInv127);
      const float safe = scale == 0.0f ? 1.0f : scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) rn[j] = int8_residual(x[j], scale, safe);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) rn[j] = bf16_residual(x[j]);
    }
    if (kVec) {
      if (live[0]) {
        reinterpret_cast<float4*>(rp)[lane] =
            make_float4(rn[0], rn[1], rn[2], rn[3]);
        reinterpret_cast<float4*>(gp)[lane] = make_float4(
            __fsub_rn(x[0], rn[0]), __fsub_rn(x[1], rn[1]),
            __fsub_rn(x[2], rn[2]), __fsub_rn(x[3], rn[3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (live[j]) {
          const int e = lane + 32 * j;
          rp[e] = rn[j];
          gp[e] = __fsub_rn(x[j], rn[j]);
        }
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

template <int kCodec>
void launch(bool vec, int blocks, float* g, float* r, int64_t L,
            int64_t rstride, int64_t cpr, int64_t chunks,
            cudaStream_t stream) {
  if (vec)
    error_feedback_kernel<kCodec, true><<<blocks, kThreads, 0, stream>>>(
        g, r, L, rstride, cpr, chunks);
  else
    error_feedback_kernel<kCodec, false><<<blocks, kThreads, 0, stream>>>(
        g, r, L, rstride, cpr, chunks);
}

}  // namespace

extern "C" {

// EF in place on g [W, L] (contiguous) and r [W, L] (rows `rstride`
// elements apart), codec 0 bf16 or 1 int8 (L % 128 == 0), vec 1 for the
// vector path (g and r on 16 bytes, L and rstride multiples of 4) or 0 for
// the scalar one.  Launches on `stream`; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
int error_feedback_launch(float* g, float* r, int64_t W, int64_t L,
                          int64_t rstride, int codec, int vec,
                          cudaStream_t stream) {
  if (W < 0 || L < 0 || (W > 1 && rstride < L) || (codec != kBf16 &&
      codec != kInt8) || (codec == kInt8 && L % kChunk))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(g, 16) && aligned(r, 16) && L % 4 == 0 &&
               rstride % 4 == 0))
    return (int)cudaErrorInvalidValue;
  const int64_t cpr = (L + kChunk - 1) / kChunk;
  const int64_t chunks = W * cpr;
  if (chunks == 0) return 0;
  const int64_t want = (chunks + kWarps - 1) / kWarps;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (codec == kInt8)
    launch<kInt8>(vec != 0, blocks, g, r, L, rstride, cpr, chunks, stream);
  else
    launch<kBf16>(vec != 0, blocks, g, r, L, rstride, cpr, chunks, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
