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
// shift, an int8 code by the exponent trick below); level 1 adds row
// i + N/2 to row i, level 2 row i + N/4, ..., each add one __fadd_rn (no
// contraction, no reordering); the result is rounded once to the output
// dtype (__float2bfloat16_rn for bf16).  B4's first level dequantises
// inside the add with one rounding for the low row's product,
// __fmaf_rn(f32(q[i]), s[i], __fmul_rn(f32(q[i+N/2]), s[i+N/2])), as the
// reference's interpret-mode kernel computes it (see ref.py).  No atomics,
// and no column is split across threads: each thread owns whole columns.
// Rows N .. N2-1 of the power of two N2 = max(2, 2^ceil(log2 N)) read as
// +0.0 and are never loaded, so the caller's zero padding costs nothing.
// The file is built without --use_fast_math.
//
// Passes: a thread holds the 2^L values of its columns (L <= 3, eight
// rows) in registers.  Up to 8 rows take one launch; more rows take a
// first pass of 3 levels into an f32 scratch [N2 / 8, D] and further
// passes over it in place.  In place is safe on both paths: output row o
// of a pass reads input rows o + m * rows_out, of which only m = 0 is an
// output row, and only the item (o, column tile t) reads row o at tile t.
// That item's consumers write row o at tile t after its input has landed
// in shared memory (ring) or in registers (ragged), so a producer running
// ahead never reads a tile that is already written: it only ever loads
// the tiles of its own later items, which are disjoint.  Splitting the
// levels across launches changes no sum: each level is the same f32 adds.
//
// Bound on this card: HBM bytes.  One pass of N <= 8 rows reads each input
// byte once and writes D outputs: 8 x 67,108,864 f32 rows (one 256 MB
// gradient bucket per micro-batch) move 2.42 GB, 0.72 ms at 3.35 TB/s;
// int8 rows of the same width 0.82 GB, 0.25 ms.  Adds are 7 per column.
//
// Two paths, chosen by the caller before the launch (ops.tree_sum_path),
// never switched at run time:
//
// * ring (rows on 16 bytes: f32 D % 4 == 0, bf16 D % 8 == 0, int8 nb % 4
//   == 0; every pointer on 16 bytes): a persistent, warp-specialised
//   streaming pass.  The grid is the number of blocks that fit on the card
//   at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count,
//   queried once per device and kernel: one 288-thread block of 192 KB an
//   SM), so no wave tail is left.  Work items are (output row o, column
//   tile t), o major; block b walks items b, b + grid, b + 2 grid, ...,
//   so the card streams through neighbouring tiles together (a contiguous
//   run of items a block measured 1 % slower on the H100).  A tile is
//   8192 bytes of each input row (2048 f32, 4096 bf16, 8192 int8
//   columns).  One producer thread issues 1-D bulk copies (cp.async.bulk,
//   mbarrier complete_tx) of the item's 2^L row slices, and for B4 the
//   slices' scales (64 f32 a row), into stage s of a ring of
//   kRingBytes / (2^L x 8192) stages (3 at 8 rows) in shared memory;
//   completion lands on the stage's `full` barrier.  Eight consumer warps
//   own two 16-byte column vectors of every row slice a thread, read them
//   from shared memory, dequantise (B4), halve in registers, store with
//   streaming 16-byte stores (st.global.cs), and arrive on the stage's
//   `empty` barrier, which the producer waits on before it reuses the
//   stage.  The last tile of a row is shorter; its copies stay multiples
//   of 16 bytes because the rows are.
//   B4's codes widen without I2F: the biased byte q + 128 (q ^ 0x80) is
//   placed in the mantissa of 2^23 by one byte permute, and 8,388,736.0f
//   (2^23 + 128) is subtracted: exact, so the same bits as (float)q, at
//   the FADD rate instead of the conversion unit's 16 a clock.
// * ragged (anything else): a grid-stride loop over column vectors (4 f32 /
//   4 bf16 / 8 int8 per thread, one 16/8/8-byte load per row) when D and
//   the pointers allow, else one column a thread; output rows in
//   gridDim.y.  All eight rows' loads of a column vector are issued before
//   the first add.  Its grid is sized as if eight 256-thread blocks fit on
//   each of 132 SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I kernels/common (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxLevels = 3;             // 8 rows per pass in registers
constexpr int kCodecBlock = 128;
constexpr int64_t kMaxRowsOut = 65535;    // gridDim.y

// ring path (ops.py mirrors these: RING_SLICE_BYTES, RING_BYTES)
constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kRingThreads = kConsumerThreads + 32;       // + a producer
constexpr int kVecsPerThread = 2;         // 16-byte vectors a row slice
constexpr int kSlice = kConsumerThreads * 16 * kVecsPerThread;   // 8 KB
constexpr int kRingBytes = 192 * 1024;    // row slices in flight a block
constexpr int kScaleSlice = kSlice / kCodecBlock * 4;     // B4: 64 f32

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

// ---------------------------------------------------------------------------
// ragged path
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// ring path
// ---------------------------------------------------------------------------

struct RingArgs {
  const void* in;        // [rows_real, D] of Tin
  const float* scale;    // B4: [rows_real, D / 128]
  void* out;             // [rows_out, D] of Tout (may be `in`)
  int64_t D, rows_real, rows_out;
  int64_t tiles;         // column tiles a row
  int64_t items;         // rows_out * tiles
};

// shared memory of one ring pass: kStages stages, each 2^kLevels row
// slices (then, for B4, their scales), then the full and empty barriers
template <int kLevels, bool kInt8>
struct RingLayout {
  static constexpr int kRows = 1 << kLevels;
  static constexpr int kStages = kRingBytes / (kRows * kSlice);
  static constexpr int kScales = kRows * kSlice;        // offset in a stage
  static constexpr int kStage = kRows * (kSlice + (kInt8 ? kScaleSlice : 0));
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static_assert(kStages >= 2, "a ring needs two stages");
  static_assert(kStage % 16 == 0, "stages must stay on 16 bytes");
};

// rows of input that exist among o + m * rows_out, m < kRows: a prefix of m
template <int kRows>
__device__ __forceinline__ int real_rows(int64_t o, int64_t rows_out,
                                         int64_t rows_real) {
  const int64_t n = (rows_real - o + rows_out - 1) / rows_out;
  return n < kRows ? (int)n : kRows;
}

// 16 bytes of a row slice in shared memory, widened to f32
__device__ __forceinline__ void smem_vec(const unsigned char* p,
                                         float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void smem_vec(const unsigned char* p,
                                         float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 int8 codes as exact f32 without I2F: the biased byte q + 128 = q ^
// 0x80 becomes the low mantissa byte of 2^23 (one PRMT), and 2^23 + 128 is
// subtracted (one FADD, exact: both operands and the result are integers
// below 2^24)
__device__ __forceinline__ void smem_codes(const unsigned char* p,
                                           float (&v)[16]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x ^ 0x80808080u, t.y ^ 0x80808080u,
                         t.z ^ 0x80808080u, t.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[4 * i + e] = __fsub_rn(
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u + e)),
          8388736.0f);
}

// streaming (evict-first) stores of a thread's kVec outputs
template <int kVec>
__device__ __forceinline__ void store_cs(float* p, const float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4)
    __stcs(reinterpret_cast<float4*>(p + i),
           make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
}

template <int kVec>
__device__ __forceinline__ void store_cs(uint16_t* p,
                                         const float (&v)[kVec]) {
  uint32_t w[kVec / 2];
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    w[i] = f32_to_bf16(v[2 * i]) |
           (static_cast<uint32_t>(f32_to_bf16(v[2 * i + 1])) << 16);
  if constexpr (kVec == 4) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
  } else {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// One persistent ring pass (see the header).  Tin float / uint16_t (bf16)
// / int8_t (B4's first pass, kInt8); Tout float / uint16_t.
template <typename Tin, typename Tout, int kLevels, bool kInt8>
__global__ void __launch_bounds__(kRingThreads, 1)
ring_pass_kernel(const RingArgs a) {
  using L = RingLayout<kLevels, kInt8>;
  constexpr int kRows = L::kRows;
  constexpr int kVec = 16 / sizeof(Tin);           // columns a thread
  constexpr int64_t kTileCols = kSlice / sizeof(Tin);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                    // the producer
    if (lane != 0) return;
    const unsigned char* in = static_cast<const unsigned char*>(a.in);
    for (int64_t i = blockIdx.x, k = 0; i < a.items; i += gridDim.x, ++k) {
      const int s = (int)(k % L::kStages);
      const uint32_t n = (uint32_t)(k / L::kStages);
      hopper::mbar_wait(&empty[s], (n & 1) ^ 1);
      const int64_t o = i / a.tiles, c0 = (i - o * a.tiles) * kTileCols;
      const int64_t cols = a.D - c0 < kTileCols ? a.D - c0 : kTileCols;
      const uint32_t bytes = (uint32_t)(cols * sizeof(Tin));
      const uint32_t sbytes =
          kInt8 ? (uint32_t)(cols / kCodecBlock * sizeof(float)) : 0;
      const int rows = real_rows<kRows>(o, a.rows_out, a.rows_real);
      unsigned char* stage = smem + s * L::kStage;
      hopper::mbar_arrive_expect_tx(&full[s], rows * (bytes + sbytes));
      for (int m = 0; m < rows; ++m) {
        const int64_t r = o + m * a.rows_out;
        hopper::bulk_load_1d(stage + m * kSlice,
                             in + (r * a.D + c0) * sizeof(Tin), bytes,
                             &full[s]);
        if constexpr (kInt8)
          hopper::bulk_load_1d(
              stage + L::kScales + m * kScaleSlice,
              a.scale + r * (a.D / kCodecBlock) + c0 / kCodecBlock, sbytes,
              &full[s]);
      }
    }
    return;
  }

  const int j = threadIdx.x;                       // consumer thread
  Tout* out = static_cast<Tout*>(a.out);
  for (int64_t i = blockIdx.x, k = 0; i < a.items; i += gridDim.x, ++k) {
    const int s = (int)(k % L::kStages);
    const uint32_t n = (uint32_t)(k / L::kStages);
    hopper::mbar_wait(&full[s], n & 1);
    const int64_t o = i / a.tiles, c0 = (i - o * a.tiles) * kTileCols;
    const int64_t cols = a.D - c0 < kTileCols ? a.D - c0 : kTileCols;
    const int rows = real_rows<kRows>(o, a.rows_out, a.rows_real);
    const unsigned char* stage = smem + s * L::kStage;
#pragma unroll
    for (int u = 0; u < kVecsPerThread; ++u) {
      const int cj = (u * kConsumerThreads + j) * kVec;   // tile column
      if (cj >= cols) break;
      float v[kRows][kVec];
      if constexpr (kInt8) {
        constexpr int kHalf = kRows / 2;
        const float* sc = reinterpret_cast<const float*>(stage + L::kScales);
#pragma unroll
        for (int m = 0; m < kHalf; ++m) {
          float lo[kVec], hi[kVec], s_lo = 0.f, s_hi = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) lo[e] = hi[e] = 0.f;
          if (m < rows) {
            smem_codes(stage + m * kSlice + cj, lo);
            s_lo = sc[m * (kScaleSlice / 4) + cj / kCodecBlock];
          }
          if (m + kHalf < rows) {
            smem_codes(stage + (m + kHalf) * kSlice + cj, hi);
            s_hi = sc[(m + kHalf) * (kScaleSlice / 4) + cj / kCodecBlock];
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            v[m][e] = __fmaf_rn(lo[e], s_lo, __fmul_rn(hi[e], s_hi));
        }
        halve<kHalf / 2>(v);
      } else {
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (m < rows) {
            smem_vec(stage + m * kSlice + cj * sizeof(Tin), v[m]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) v[m][e] = 0.f;
          }
        }
        halve<kRows / 2>(v);
      }
      store_cs<kVec>(out + o * a.D + c0 + cj, v[0]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}

struct Occupancy {
  int per_sm = 0, sms = 0;
};

// blocks of one ring kernel that fit on an SM, and the SMs, of the
// current device: queried once per device and kernel
template <typename Tin, typename Tout, int kLevels, bool kInt8>
int ring_occupancy(Occupancy* occ) {
  constexpr int kMaxDevices = 64;
  static Occupancy cache[kMaxDevices];
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cache[dev].per_sm == 0) {
    auto kernel = ring_pass_kernel<Tin, Tout, kLevels, kInt8>;
    constexpr int smem = RingLayout<kLevels, kInt8>::kBytes;
    Occupancy got;
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &got.per_sm, kernel, kRingThreads, smem))
      return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &got.sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (got.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache[dev] = got;
  }
  *occ = cache[dev];
  return 0;
}

// a ring pass over `items` work items on every block that fits on the
// card at once (fewer when there are fewer items); block b walks items b,
// b + grid, b + 2 grid, ... (ops.tree_sum_tiles mirrors this)
template <typename Tin, typename Tout, int kLevels, bool kInt8>
int ring_launch(const RingArgs& a, cudaStream_t st) {
  Occupancy occ;
  if (int err = ring_occupancy<Tin, Tout, kLevels, kInt8>(&occ)) return err;
  const int64_t cap = (int64_t)occ.per_sm * occ.sms;
  const int64_t grid = a.items < cap ? a.items : cap;
  ring_pass_kernel<Tin, Tout, kLevels, kInt8>
      <<<(unsigned)grid, kRingThreads, RingLayout<kLevels, kInt8>::kBytes,
         st>>>(a);
  return (int)cudaGetLastError();
}

template <typename Fn>
int with_levels(int levels, Fn&& fn) {
  switch (levels) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

template <typename Tin, typename Tout, bool kInt8>
int ring_pass(const void* in, const float* scale, void* out, int64_t D,
              int64_t rows_real, int64_t rows_out, int levels,
              cudaStream_t st) {
  constexpr int64_t kTileCols = kSlice / sizeof(Tin);
  if ((D * (int64_t)sizeof(Tin)) % 16 || !aligned(in, 16) ||
      !aligned(out, 16) ||
      (kInt8 && ((D / kCodecBlock) % 4 || !aligned(scale, 16))))
    return (int)cudaErrorInvalidValue;
  RingArgs a{in, scale, out, D, rows_real, rows_out,
             (D + kTileCols - 1) / kTileCols, 0};
  a.items = rows_out * a.tiles;
  if (a.items == 0) return 0;
  return with_levels(levels, [&](auto lv) {
    return ring_launch<Tin, Tout, decltype(lv)::value, kInt8>(a, st);
  });
}

// ---------------------------------------------------------------------------
// host: passes on either path
// ---------------------------------------------------------------------------

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

// one pass over rows_out << levels input rows: the ring, or the ragged
// kernel, vectorised where D and the pointers allow
template <typename Tin, typename Tout>
int pass(bool ring, const void* in, void* out, int64_t D, int64_t rows_real,
         int64_t rows_out, int levels, cudaStream_t st) {
  if (ring)
    return ring_pass<Tin, Tout, false>(in, nullptr, out, D, rows_real,
                                       rows_out, levels, st);
  if (rows_out > kMaxRowsOut) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned(in, 4 * sizeof(Tin)) &&
                   aligned(out, 4 * sizeof(Tout));
  return vec ? pass_vec<Tin, Tout, 4>(in, out, D, rows_real, rows_out,
                                      levels, st)
             : pass_vec<Tin, Tout, 1>(in, out, D, rows_real, rows_out,
                                      levels, st);
}

// pass with the input dtype code (0 f32, 1 bf16) and the output's
int pass_typed(bool ring, const void* in, int in_dtype, void* out,
               int out_dtype, int64_t D, int64_t rows_real, int64_t rows_out,
               int levels, cudaStream_t st) {
  if (in_dtype == 0 && out_dtype == 0)
    return pass<float, float>(ring, in, out, D, rows_real, rows_out, levels,
                              st);
  if (in_dtype == 0 && out_dtype == 1)
    return pass<float, uint16_t>(ring, in, out, D, rows_real, rows_out,
                                 levels, st);
  if (in_dtype == 1 && out_dtype == 0)
    return pass<uint16_t, float>(ring, in, out, D, rows_real, rows_out,
                                 levels, st);
  if (in_dtype == 1 && out_dtype == 1)
    return pass<uint16_t, uint16_t>(ring, in, out, D, rows_real, rows_out,
                                    levels, st);
  return (int)cudaErrorInvalidValue;
}

int log2_padded(int64_t n) {              // log2 of max(2, 2^ceil(log2 n))
  int levels = 1;
  while ((int64_t(1) << levels) < n) ++levels;
  return levels;
}

// the passes after a first one that left `rows` f32 rows in scratch
int finish(bool ring, float* scratch, void* out, int out_dtype, int64_t D,
           int64_t rows, int levels_left, cudaStream_t st) {
  while (levels_left > 0) {
    const int k = levels_left < kMaxLevels ? levels_left : kMaxLevels;
    const int64_t rows_out = rows >> k;
    const bool last = k == levels_left;
    if (int err = pass_typed(ring, scratch, 0, last ? out : scratch,
                             last ? out_dtype : 0, D, rows, rows_out, k, st))
      return err;
    rows = rows_out;
    levels_left -= k;
  }
  return 0;
}

}  // namespace

extern "C" {

// The ring kernel of input dtype code in_dtype (0 f32, 1 bf16, 2 int8:
// B4's first pass), output out_dtype (0 f32, 1 bf16) and `levels` (1-3)
// on the current device: blocks an SM holds and the SM count.  Returns 0
// or a cudaError_t.
int tree_sum_ring_occupancy(int in_dtype, int out_dtype, int levels,
                            int* per_sm, int* sms) {
  Occupancy occ;
  const int err = with_levels(levels, [&](auto lv) {
    constexpr int L = decltype(lv)::value;
    switch (in_dtype * 2 + out_dtype) {
      case 0: return ring_occupancy<float, float, L, false>(&occ);
      case 1: return ring_occupancy<float, uint16_t, L, false>(&occ);
      case 2: return ring_occupancy<uint16_t, float, L, false>(&occ);
      case 3: return ring_occupancy<uint16_t, uint16_t, L, false>(&occ);
      case 4: return ring_occupancy<int8_t, float, L, true>(&occ);
      default: return (int)cudaErrorInvalidValue;
    }
  });
  if (err) return err;
  *per_sm = occ.per_sm;
  *sms = occ.sms;
  return 0;
}

// B3: out[c] = tree sum over rows r < N of x[r, c] (rows N .. N2-1 zero),
// x [N, D] of dtype code in_dtype (0 f32, 1 bf16), out [D] of out_dtype.
// scratch: f32 [N2 / 8, D] when N2 > 8 (the first pass's output rows;
// ops.tree_sum_passes), else unused.  path 1: every pass
// on the ring (refused unless the rows and pointers are on 16 bytes), 0:
// every pass on the ragged kernel.  Launches on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
int tree_sum_launch(const void* x, int in_dtype, void* out, int out_dtype,
                    void* scratch, int64_t N, int64_t D, int path,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 0 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (D == 0) return 0;
  const bool ring = path == 1;
  const int levels = log2_padded(N);
  const int k = levels < kMaxLevels ? levels : kMaxLevels;
  const int64_t rows_out = (int64_t(1) << levels) >> k;
  if (rows_out > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool last = k == levels;
  if (int err = pass_typed(ring, x, in_dtype, last ? out : scratch,
                           last ? out_dtype : 0, D, N, rows_out, k, st))
    return err;
  return finish(ring, static_cast<float*>(scratch), out, out_dtype, D,
                rows_out, levels - k, st);
}

// B4: out[c] = tree sum over rows r < N of f32(q[r, c]) * scale[r, c/128],
// level 1 fused (see the header); q [N, nb, 128] int8, scale [N, nb] f32,
// out [nb * 128] f32, scratch and path as tree_sum_launch (the ring also
// needs nb % 4 == 0, so that each row of scales starts on 16 bytes).
int int8_tree_sum_launch(const int8_t* q, const float* scale, float* out,
                         void* scratch, int64_t N, int64_t nb, int path,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || nb < 0 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const bool ring = path == 1;
  const int levels = log2_padded(N);
  const int k = levels < kMaxLevels ? levels : kMaxLevels;
  const int64_t rows_out = (int64_t(1) << levels) >> k;
  if (rows_out > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* dst = k == levels ? out : static_cast<float*>(scratch);
  const int64_t D = nb * kCodecBlock;
  if (ring) {
    if (int err = ring_pass<int8_t, float, true>(q, scale, dst, D, N,
                                                 rows_out, k, st))
      return err;
  } else {
    if (rows_out > kMaxRowsOut) return (int)cudaErrorInvalidValue;
    const bool vec = aligned(q, 8) && aligned(dst, 16);
    const dim3 grid(blocks_for(vec ? D / 8 : D, rows_out),
                    (unsigned)rows_out);
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
  }
  return finish(ring, static_cast<float*>(scratch), out, 0, D, rows_out,
                levels - k, st);
}

}  // extern "C"
