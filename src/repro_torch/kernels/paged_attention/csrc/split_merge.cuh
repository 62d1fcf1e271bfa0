// The merge pass of split-sequence (flash-decoding) attention, shared by
// the paged decode kernels B7 (paged_attention.cu) and B8
// (paged_mla_attention.cu).
//
// A split kernel gives each output row (one query head of one batch row)
// S partial softmax states, one per chunk of the row's sequence, in f32:
//   m   [rows, S]         the chunk's largest score (-inf if the chunk held
//                         no valid position: such a chunk writes only m
//                         and l, never acc),
//   l   [rows, S]         sum over the chunk of e^(score - m),
//   acc [rows, S, width]  sum over the chunk of e^(score - m) * value,
//                         each probability rounded to the pool dtype
//                         before it weighs the value.
// The merge computes, per row and column,
//   M   = max_s m_s,   w_s = e^(m_s - M)   (0 for an empty chunk),
//   out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
// summing s in order (deterministic), and rounds to the output dtype once.
// Empty chunks weigh exactly 0 and their acc is never read, so a row whose
// chunks are all empty comes out 0, not NaN.  One warp of a row's block
// computes the weights into shared memory; every thread then reads its
// columns' S partial accs, which were written just before (the L2 holds
// them).
//
// Why a second kernel and not "the last block to arrive merges": the
// latter needs a counter per row that every call leaves at zero, a buffer
// that must outlive the call and be zeroed before the first one (also
// inside a CUDA graph capture), and a fence-and-atomic handshake; the
// second launch is stateless and deterministic, and its cost is measured
// on its own (a launch count of its own, ops.MERGE_LAUNCHES and
// ops.MLA_MERGE_LAUNCHES).  Its launch overlaps the split kernel's run:
// the merge is launched as a programmatic dependent (Hopper's
// griddepcontrol), every split block lets it launch as soon as it starts,
// and the merge waits for the split grid's writes before it reads them.
//
// expf stays IEEE (the libraries are built without --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split_merge {

constexpr int kThreads = 256;
constexpr int kMaxSplits = 1024;

// In a split kernel: let the dependent merge grid launch now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// In the merge: wait until the split grid has finished and its writes are
// visible (returns at once when launched without a prerequisite grid).
__device__ __forceinline__ void wait_for_split_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One block per row; thread i takes columns i, i + kThreads, ...  `Op` is
// an empty type named after the op that launches the merge, so that a
// profile tells B7's merges from B8's by the kernel's name.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ m, const float* __restrict__ l,
             const float* __restrict__ acc, T* __restrict__ out, int S,
             int width) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float den_s;
  wait_for_split_grid();
  const int64_t row = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* mr = m + row * S;
    const float* lr = l + row * S;
    float M = -INFINITY;
    for (int s = lane; s < S; s += 32) M = fmaxf(M, mr[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    for (int s = lane; s < S; s += 32)
      w_s[s] = mr[s] == -INFINITY ? 0.f : expf(mr[s] - M);
    __syncwarp();
    if (lane == 0) {                 // the normaliser, in split order
      float L = 0.f;
      for (int s = 0; s < S; ++s) L += w_s[s] * lr[s];
      den_s = fmaxf(L, 1e-30f);
    }
  }
  __syncthreads();
  const float den = den_s;
  for (int c = threadIdx.x; c < width; c += kThreads) {
    float A = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = w_s[s];           // the same in the whole block
      if (w != 0.f) A += w * acc[(row * S + s) * width + c];
    }
    store(out + row * width + c, A / den);
  }
}

// Launches the merge of `rows` rows on `stream`, as a programmatic
// dependent of the kernel launched before it; returns the launch's error.
template <typename T, typename Op>
int launch(const float* m, const float* l, const float* acc, T* out,
           int rows, int S, int width, cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || S > kMaxSplits || width <= 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, merge_kernel<T, Op>, m, l, acc, out, S, width);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace split_merge
