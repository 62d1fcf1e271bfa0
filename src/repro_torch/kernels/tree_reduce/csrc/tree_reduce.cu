// Codec decode-add kernels for Hopper (sm_90a): the receive side of every
// reduce hop of the fractal reduce-scatter, `keep + decode(wire)` in one
// pass over memory.
//
// Replaces: src/repro/kernels/tree_reduce/kernel.py,
//   B1 decode_add_bf16_pallas (body _decode_add_bf16_kernel):
//        out[i] = keep[i] + f32(wire[i]),          keep f32, wire bf16;
//   B2 decode_add_int8_pallas (body _decode_add_int8_kernel):
//        out[i] = keep[i] + f32(q[i]) * scale[i / 128],
//                                                  keep f32, q int8,
//                                                  scale f32 per 128-block.
//
// Rounding is spelled out, because the result must equal the reference bit
// for bit: B1 widens the bf16 bits exactly and adds once (__fadd_rn); B2 is
// one fused multiply-add, __fmaf_rn(f32(q), scale, keep), which is what the
// jitted reference computes (XLA contracts the dequant-add into an FMA).
// The file is built without --use_fast_math and neither kernel leaves a
// multiply-add for the compiler to contract or not.
//
// Shapes: any element count M (64-bit); B2 needs M % 128 == 0 (one scale
// per block).  The launchers pick a vectorised body when the pointers allow
// it (keep and out 16-byte aligned; wire 8-byte, q 4-byte aligned) and a
// scalar one otherwise; a ragged tail is masked.
//
// Bound on this card: HBM bytes.  Per element B1 reads 4 + 2 bytes and
// writes 4 (10 B); B2 reads 4 + 1 + 4/128 and writes 4 (9.03 B), over
// 3.35 TB/s (H100 SXM).  One add or FMA per element is far below any
// arithmetic rate.
//
// Design (simple and right first): a grid-stride loop, four elements per
// thread per iteration (one 16-byte load of keep, 8 bytes of bf16 wire or 4
// bytes of int8 codes, one 16-byte store), 256 threads per block and at
// most 132 * 8 blocks, so every block is resident at once.  The four
// elements of an int8 quad share one scale (128 % 4 == 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kCodecBlock = 128;

__device__ __forceinline__ float bf16_hi(uint32_t bits) {
  return __uint_as_float(bits & 0xffff0000u);      // the upper bf16 of two
}

__device__ __forceinline__ float bf16_lo(uint32_t bits) {
  return __uint_as_float(bits << 16);              // the lower bf16 of two
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_add_bf16_kernel(const float* __restrict__ keep,
                       const uint16_t* __restrict__ wire,
                       float* __restrict__ out, int64_t M) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {
    const int64_t n4 = M / 4;
    const float4* k4 = reinterpret_cast<const float4*>(keep);
    const uint2* w4 = reinterpret_cast<const uint2*>(wire);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = t; i < n4; i += stride) {
      const float4 k = k4[i];
      const uint2 w = w4[i];
      float4 o;
      o.x = __fadd_rn(k.x, bf16_lo(w.x));
      o.y = __fadd_rn(k.y, bf16_hi(w.x));
      o.z = __fadd_rn(k.z, bf16_lo(w.y));
      o.w = __fadd_rn(k.w, bf16_hi(w.y));
      o4[i] = o;
    }
    const int64_t j = n4 * 4 + t;                   // the M % 4 tail
    if (t < 4 && j < M)
      out[j] = __fadd_rn(keep[j], bf16_lo(wire[j]));
  } else {
    for (int64_t i = t; i < M; i += stride)
      out[i] = __fadd_rn(keep[i], bf16_lo(wire[i]));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_add_int8_kernel(const float* __restrict__ keep,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int64_t M) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {                                       // M % 128 == 0: no tail
    const int64_t n4 = M / 4;
    const float4* k4 = reinterpret_cast<const float4*>(keep);
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = t; i < n4; i += stride) {
      const float4 k = k4[i];
      const char4 c = q4[i];
      const float s = scale[i / (kCodecBlock / 4)];
      float4 o;
      o.x = __fmaf_rn((float)c.x, s, k.x);
      o.y = __fmaf_rn((float)c.y, s, k.y);
      o.z = __fmaf_rn((float)c.z, s, k.z);
      o.w = __fmaf_rn((float)c.w, s, k.w);
      o4[i] = o;
    }
  } else {
    for (int64_t i = t; i < M; i += stride)
      out[i] = __fmaf_rn((float)q[i], scale[i / kCodecBlock], keep[i]);
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

inline int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// out[i] = keep[i] + f32(wire[i]), i < M.  Launches on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
int decode_add_bf16_launch(const float* keep, const uint16_t* wire,
                           float* out, int64_t M, cudaStream_t stream) {
  if (M <= 0) return 0;
  if (aligned(keep, 16) && aligned(out, 16) && aligned(wire, 8))
    decode_add_bf16_kernel<true><<<blocks_for(M / 4), kThreads, 0, stream>>>(
        keep, wire, out, M);
  else
    decode_add_bf16_kernel<false><<<blocks_for(M), kThreads, 0, stream>>>(
        keep, wire, out, M);
  return (int)cudaGetLastError();
}

// out[i] = fma(f32(q[i]), scale[i / 128], keep[i]), i < M, M % 128 == 0.
// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a ragged M.
int decode_add_int8_launch(const float* keep, const int8_t* q,
                           const float* scale, float* out, int64_t M,
                           cudaStream_t stream) {
  if (M < 0 || M % kCodecBlock) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (aligned(keep, 16) && aligned(out, 16) && aligned(q, 4))
    decode_add_int8_kernel<true><<<blocks_for(M / 4), kThreads, 0, stream>>>(
        keep, q, scale, out, M);
  else
    decode_add_int8_kernel<false><<<blocks_for(M), kThreads, 0, stream>>>(
        keep, q, scale, out, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
