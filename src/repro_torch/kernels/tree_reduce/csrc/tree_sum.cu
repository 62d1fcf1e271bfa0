// Pairwise-tree column sums for Hopper (sm_90a): N rows reduced to one in
// log2 N halvings, in exactly the reference's pairing, so the sum is bit
// for bit the same whatever order the rows arrived in.
//
// Replaces: src/repro/kernels/tree_reduce/kernel.py,
//   B3 tree_reduce_pallas (body _tree_reduce_kernel):
//        x [N, D] f32 or bf16 -> [D] f32 or bf16 (output dtype separate);
//   B4 int8_tree_reduce_pallas (body _int8_tree_reduce_kernel):
//        q [N, nb, 128] int8, scale [N, nb, 1] f32 -> [nb * 128] f32.
//
// Arithmetic, spelled out because the result must equal the plain version
// (ref.py) bit for bit: every value widens to f32 exactly (bf16 by a bit
// shift); level 1 adds row i + N/2 to row i, level 2 row i + N/4, ...,
// each add one __fadd_rn (no contraction, no reordering); the result is
// rounded once to the output dtype (__float2bfloat16_rn for bf16).  B4's
// first level dequantises inside the add with one rounding for the low
// row's product, __fmaf_rn(f32(q[i]), s[i], __fmul_rn(f32(q[i+N/2]),
// s[i+N/2])), as the reference's interpret-mode kernel computes it (see
// ref.py).  No atomics, and no column is split across threads: each
// thread owns whole columns.  Rows N .. N2-1 of the power of two N2 =
// max(2, 2^ceil(log2 N)) read as +0.0 and are never loaded, so the
// caller's zero padding costs nothing.  The file is built without
// --use_fast_math.
//
// Passes: a thread holds the 2^L values of its columns (L <= 3, eight
// rows) in registers.  Up to 8 rows take one launch; more rows take a
// first pass of 3 levels into an f32 scratch [N2 / 8, D] and further
// passes over it in place.  In place is safe: output row o of a pass reads
// input rows o + m * rows_out, of which only m = 0 is an output row, and
// the thread that reads it is the one that writes it.  Splitting the
// levels across launches changes no sum: each level is the same f32 adds.
//
// Bound on this card: HBM bytes.  One pass of N <= 8 rows reads each input
// byte once and writes D outputs: 8 x 67,108,864 f32 rows (one 256 MB
// gradient bucket per micro-batch) move 2.42 GB, 0.72 ms at 3.35 TB/s;
// int8 rows of the same width 0.82 GB, 0.25 ms.  Adds are 7 per column.
//
// Design (simple and right first): a grid-stride loop over column
// vectors (4 f32 / 4 bf16 / 8 int8 per thread, one 16/8/8-byte load per
// row), output rows in gridDim.y; a scalar path when D or a pointer does
// not allow the vector loads.  All eight rows' loads of a column vector
// are issued before the first add.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxLevels = 3;             // 8 rows per pass in registers
constexpr int kCodecBlock = 128;
constexpr int64_t kMaxRowsOut = 65535;    // gridDim.y

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// kVec consecutive elements of a row, widened to f32
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = p[e];
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const uint16_t* p,
                                         float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_to_f32(t.x & 0xffffu); v[1] = bf16_to_f32(t.x >> 16);
    v[2] = bf16_to_f32(t.y & 0xffffu); v[3] = bf16_to_f32(t.y >> 16);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = bf16_to_f32(p[e]);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = v[e];
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(uint16_t* p,
                                          const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    uint2 t;
    t.x = f32_to_bf16(v[0]) | (static_cast<uint32_t>(f32_to_bf16(v[1])) << 16);
    t.y = f32_to_bf16(v[2]) | (static_cast<uint32_t>(f32_to_bf16(v[3])) << 16);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = f32_to_bf16(v[e]);
  }
}

// the halving over v[0 .. 2 kHalf): v[m] += v[m + kHalf] for m < kHalf,
// then the same with kHalf / 2, down to v[0] += v[1]
template <int kHalf, int kRows, int kVec>
__device__ __forceinline__ void halve(float (&v)[kRows][kVec]) {
  if constexpr (kHalf >= 1) {
#pragma unroll
    for (int m = 0; m < kHalf; ++m)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[m][e] = __fadd_rn(v[m][e], v[m + kHalf][e]);
    halve<kHalf / 2, kRows, kVec>(v);
  }
}

// One pass: out row o (gridDim.y) = the tree over input rows
// o + m * rows_out, m < 2^kLevels; input rows >= rows_real read as +0.
// in and out may be the same buffer (see the header), so neither is
// __restrict__.
template <typename Tin, typename Tout, int kLevels, int kVec>
__global__ void __launch_bounds__(kThreads)
tree_pass_kernel(const Tin* in, Tout* out,
                 int64_t D, int64_t rows_real, int64_t rows_out) {
  constexpr int kRows = 1 << kLevels;
  const int64_t o = blockIdx.y;
  const int64_t nvec = D / kVec;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < nvec;
       w += stride) {
    const int64_t c = w * kVec;
    float v[kRows][kVec];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int64_t r = o + m * rows_out;
      if (r < rows_real) {
        load_vec<kVec>(in + r * D + c, v[m]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[m][e] = 0.f;
      }
    }
    halve<kRows / 2>(v);
    store_vec<kVec>(out + o * D + c, v[0]);
  }
}

// B4's first pass: the same tree over dequantised int8 rows, level 1
// fused: v[m] = fma(q[m], s[m], q[m + half] * s[m + half]).
template <int kLevels, int kVec>
__global__ void __launch_bounds__(kThreads)
int8_tree_pass_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ out,
                      int64_t nb, int64_t rows_real, int64_t rows_out) {
  constexpr int kRows = 1 << kLevels;
  constexpr int kHalf = kRows / 2;
  const int64_t o = blockIdx.y;
  const int64_t D = nb * kCodecBlock;
  const int64_t nvec = D / kVec;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < nvec;
       w += stride) {
    const int64_t c = w * kVec;
    const int64_t blk = c / kCodecBlock;   // a vector never straddles one
    float qv[kRows][kVec], s[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int64_t r = o + m * rows_out;
      s[m] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[m][e] = 0.f;
      if (r < rows_real) {
        s[m] = scale[r * nb + blk];
        const int8_t* p = q + r * D + c;
        if constexpr (kVec == 8) {
          const uint2 t = *reinterpret_cast<const uint2*>(p);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qv[m][e] = (float)(int8_t)(t.x >> (8 * e));
            qv[m][4 + e] = (float)(int8_t)(t.y >> (8 * e));
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) qv[m][e] = (float)p[e];
        }
      }
    }
    float v[kHalf][kVec];
#pragma unroll
    for (int m = 0; m < kHalf; ++m)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[m][e] = __fmaf_rn(qv[m][e], s[m],
                            __fmul_rn(qv[m + kHalf][e], s[m + kHalf]));
    halve<kHalf / 2>(v);
    float* dst = out + o * D + c;
    if constexpr (kVec == 8) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[0][4], v[0][5], v[0][6], v[0][7]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = v[0][e];
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

inline int blocks_for(int64_t work, int64_t rows_out) {
  int64_t cap = kMaxBlocks / rows_out;
  if (cap < 1) cap = 1;
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

template <typename Tin, typename Tout, int kVec>
int pass_vec(const void* in, void* out, int64_t D, int64_t rows_real,
             int64_t rows_out, int levels, cudaStream_t st) {
  const dim3 grid(blocks_for(D / kVec, rows_out), (unsigned)rows_out);
  const Tin* i = static_cast<const Tin*>(in);
  Tout* o = static_cast<Tout*>(out);
  switch (levels) {
    case 1: tree_pass_kernel<Tin, Tout, 1, kVec><<<grid, kThreads, 0, st>>>(
                i, o, D, rows_real, rows_out); break;
    case 2: tree_pass_kernel<Tin, Tout, 2, kVec><<<grid, kThreads, 0, st>>>(
                i, o, D, rows_real, rows_out); break;
    case 3: tree_pass_kernel<Tin, Tout, 3, kVec><<<grid, kThreads, 0, st>>>(
                i, o, D, rows_real, rows_out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// one pass over rows_out << levels input rows, vectorised where D and the
// pointers allow
template <typename Tin, typename Tout>
int pass(const void* in, void* out, int64_t D, int64_t rows_real,
         int64_t rows_out, int levels, cudaStream_t st) {
  const bool vec = D % 4 == 0 && aligned(in, 4 * sizeof(Tin)) &&
                   aligned(out, 4 * sizeof(Tout));
  return vec ? pass_vec<Tin, Tout, 4>(in, out, D, rows_real, rows_out,
                                      levels, st)
             : pass_vec<Tin, Tout, 1>(in, out, D, rows_real, rows_out,
                                      levels, st);
}

// pass with the input dtype code (0 f32, 1 bf16) and the output's
int pass_typed(const void* in, int in_dtype, void* out, int out_dtype,
               int64_t D, int64_t rows_real, int64_t rows_out, int levels,
               cudaStream_t st) {
  if (in_dtype == 0 && out_dtype == 0)
    return pass<float, float>(in, out, D, rows_real, rows_out, levels, st);
  if (in_dtype == 0 && out_dtype == 1)
    return pass<float, uint16_t>(in, out, D, rows_real, rows_out, levels, st);
  if (in_dtype == 1 && out_dtype == 0)
    return pass<uint16_t, float>(in, out, D, rows_real, rows_out, levels, st);
  if (in_dtype == 1 && out_dtype == 1)
    return pass<uint16_t, uint16_t>(in, out, D, rows_real, rows_out, levels,
                                    st);
  return (int)cudaErrorInvalidValue;
}

int log2_padded(int64_t n) {              // log2 of max(2, 2^ceil(log2 n))
  int levels = 1;
  while ((int64_t(1) << levels) < n) ++levels;
  return levels;
}

// the passes after a first one that left `rows` f32 rows in scratch
int finish(float* scratch, void* out, int out_dtype, int64_t D, int64_t rows,
           int levels_left, cudaStream_t st) {
  while (levels_left > 0) {
    const int k = levels_left < kMaxLevels ? levels_left : kMaxLevels;
    const int64_t rows_out = rows >> k;
    const bool last = k == levels_left;
    if (int err = pass_typed(scratch, 0, last ? out : scratch,
                             last ? out_dtype : 0, D, rows, rows_out, k, st))
      return err;
    rows = rows_out;
    levels_left -= k;
  }
  return 0;
}

}  // namespace

extern "C" {

// Rows of the f32 scratch [rows, D] that tree_sum_launch and
// int8_tree_sum_launch need for N input rows: N2 / 8 when N2 > 8 (the
// first pass's output rows), else 0 (one pass, no scratch).
int64_t tree_sum_scratch_rows(int64_t N) {
  if (N < 1) return 0;
  const int levels = log2_padded(N);
  return levels > kMaxLevels ? (int64_t(1) << levels) >> kMaxLevels : 0;
}

// B3: out[c] = tree sum over rows r < N of x[r, c] (rows N .. N2-1 zero),
// x [N, D] of dtype code in_dtype (0 f32, 1 bf16), out [D] of out_dtype.
// scratch: f32 [N2 / 8, D] when N2 > 8, else unused.  Launches on
// `stream`; returns cudaGetLastError() after the launches (0 on success).
int tree_sum_launch(const void* x, int in_dtype, void* out, int out_dtype,
                    void* scratch, int64_t N, int64_t D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 0) return (int)cudaErrorInvalidValue;
  if (D == 0) return 0;
  const int levels = log2_padded(N);
  const int k = levels < kMaxLevels ? levels : kMaxLevels;
  const int64_t rows_out = (int64_t(1) << levels) >> k;
  if (rows_out > kMaxRowsOut || (rows_out > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool last = k == levels;
  if (int err = pass_typed(x, in_dtype, last ? out : scratch,
                           last ? out_dtype : 0, D, N, rows_out, k, st))
    return err;
  return finish(static_cast<float*>(scratch), out, out_dtype, D, rows_out,
                levels - k, st);
}

// B4: out[c] = tree sum over rows r < N of f32(q[r, c]) * scale[r, c/128],
// level 1 fused (see the header); q [N, nb, 128] int8, scale [N, nb] f32,
// out [nb * 128] f32, scratch as tree_sum_launch.
int int8_tree_sum_launch(const int8_t* q, const float* scale, float* out,
                         void* scratch, int64_t N, int64_t nb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const int levels = log2_padded(N);
  const int k = levels < kMaxLevels ? levels : kMaxLevels;
  const int64_t rows_out = (int64_t(1) << levels) >> k;
  if (rows_out > kMaxRowsOut || (rows_out > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* dst = k == levels ? out : static_cast<float*>(scratch);
  const int64_t D = nb * kCodecBlock;
  const bool vec = aligned(q, 8) && aligned(dst, 16);
  const dim3 grid(blocks_for(vec ? D / 8 : D, rows_out), (unsigned)rows_out);
#define INT8_PASS(L, V)                                                  \
  int8_tree_pass_kernel<L, V><<<grid, kThreads, 0, st>>>(q, scale, dst, nb, \
                                                         N, rows_out)
  switch (k * 2 + (vec ? 1 : 0)) {
    case 2: INT8_PASS(1, 1); break;
    case 3: INT8_PASS(1, 8); break;
    case 4: INT8_PASS(2, 1); break;
    case 5: INT8_PASS(2, 8); break;
    case 6: INT8_PASS(3, 1); break;
    case 7: INT8_PASS(3, 8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef INT8_PASS
  if (int err = (int)cudaGetLastError()) return err;
  return finish(static_cast<float*>(scratch), out, 0, D, rows_out,
                levels - k, st);
}

}  // extern "C"
