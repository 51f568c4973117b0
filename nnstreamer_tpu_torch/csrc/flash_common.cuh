// Pieces shared by the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the two backward kernels): tile sizes,
// dtype conversion, the tile loader, and the two products every kernel is
// built from, all on the CUDA cores in f32.
//
// Layout of the work: a block of 256 threads covers a 64 x 64 tile of scores;
// thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 i and columns
// tx + 16 j (i, j < 4).  The 16 threads that share a row are one half-warp,
// so a row's max and sum are 4 shuffles, and a tile written to shared memory
// row by row is read back by the same half-warp after a __syncwarp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace nns_flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;     // score rows per thread
constexpr int kCols = kBlockK / 16;     // score columns per thread
constexpr int kPStride = kBlockK + 16;  // rows ty and ty+1 land 16 banks apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Loads rows [row0, row0 + 64) of one head of a (T, H, D) tensor into an f32
// shared tile of 64 x `stride` floats; rows past `n_rows` and columns past `d`
// are zero.  With `vec`, each thread issues all its 16-byte loads before it
// converts and stores any of them, so they are in flight together; the scalar
// path takes inputs whose rows or head dim are not 16-byte aligned.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, bool vec) {
  static_assert(kBlockQ == kBlockK, "one loader serves q, k and v tiles");
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);     // elements per 16-byte load
    constexpr int kPerRow = DP / V;
    constexpr int kTotal = kBlockQ * kPerRow;
    constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
    uint4 buf[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / kPerRow;
      const int c = (idx - r * kPerRow) * V;
      buf[it] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kTotal && row0 + r < n_rows && c < d)
        buf[it] = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * row_stride + c);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (kIters * kThreads != kTotal && idx >= kTotal) break;
      const int r = idx / kPerRow;
      const int c = (idx - r * kPerRow) * V;
      const T* x = reinterpret_cast<const T*>(&buf[it]);
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + r * stride + c + e) =
            make_float4(to_f32(x[e]), to_f32(x[e + 1]), to_f32(x[e + 2]),
                        to_f32(x[e + 3]));
    }
    return;
  }
  constexpr int kChunk = 16;  // loads in flight per thread
  for (int base = 0; base < kBlockQ * DP; base += kChunk * kThreads) {
    float x[kChunk];
#pragma unroll
    for (int it = 0; it < kChunk; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      const int r = idx / DP;
      const int c = idx - r * DP;
      x[it] = 0.f;
      if (idx < kBlockQ * DP && row0 + r < n_rows && c < d)
        x[it] = to_f32(src[(long long)(row0 + r) * row_stride + c]);
    }
#pragma unroll
    for (int it = 0; it < kChunk; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      if (idx < kBlockQ * DP) dst[(idx / DP) * stride + idx % DP] = x[it];
    }
  }
}

// Width of the vector a thread reads per output column group in the tile-by-
// rows product: 4 contiguous columns when the padded head dim allows it.
template <int DP>
struct OutLayout {
  static constexpr int kVec = DP >= 64 ? 4 : DP / 16;  // 1, 2 or 4
  static constexpr int kGroups = DP / (16 * kVec);     // groups per thread
  static constexpr int kWidth = kGroups * kVec;        // columns per thread
};

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the padded head dim, for two
// 64-row shared tiles.  `b`'s rows are read 16 at a time by a half-warp, so
// its stride is DP + 4: the rows fall in distinct banks.
template <int DP, int AStride, int BStride>
__device__ __forceinline__ void tile_dots(const float* a_s, const float* b_s,
                                          int ty, int tx,
                                          float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[kRows], b[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * AStride + c);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * BStride + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][:] += p[ty + 16 i][:] . x[:, this thread's columns]: `p` is a 64 x 64
// tile in shared memory (stride kPStride) whose rows ty + 16 i this thread's
// own half-warp wrote; `x` a 64-row tile of the head dim (stride XStride).
template <int DP, int XStride>
__device__ __forceinline__ void tile_accumulate(
    const float* p_s, const float* x_s, int ty, int tx,
    float (&acc)[kRows][OutLayout<DP>::kWidth]) {
  using L = OutLayout<DP>;
#pragma unroll 2
  for (int j = 0; j < kBlockK; j += 4) {
    float4 p4[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      p4[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPStride + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* xrow = x_s + (j + jj) * XStride;
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        float xv[L::kVec];
        load_vec<L::kVec>(xrow + g * 16 * L::kVec + tx * L::kVec, xv);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0 ? p4[i].x
                        : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z
                                  : p4[i].w;
#pragma unroll
          for (int e = 0; e < L::kVec; ++e)
            acc[i][g * L::kVec + e] = fmaf(p, xv[e], acc[i][g * L::kVec + e]);
        }
      }
    }
  }
}

// Writes this thread's rows ty + 16 i (those below n_rows) of a 64-row f32
// accumulator into row0.. of a contiguous (T, H, D) output for one head.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(
    T* __restrict__ out, const float (&acc)[kRows][OutLayout<DP>::kWidth],
    int row0, int n_rows, int h, int head, int d, int ty, int tx) {
  using L = OutLayout<DP>;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
    T* orow = out + ((long long)row * h + head) * d;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        const int col = g * 16 * L::kVec + tx * L::kVec + e;
        if (col < d) orow[col] = from_f32<T>(acc[i][g * L::kVec + e]);
      }
  }
}

}  // namespace nns_flash
