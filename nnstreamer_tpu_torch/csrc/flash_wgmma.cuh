// Tensor-core pieces of the flash-attention kernels for 16-bit inputs on
// Hopper (sm_90a): the forward (K2, flash_attention.cu) and the two backward
// kernels (K3 and K4, flash_attention_bwd.cu).  The shared-memory tile
// layout, its asynchronous and scalar loaders, the warpgroup matrix products
// (wgmma) that read it, and the mask helpers all three share.
//
// Tile layout.  A tile is 64 rows (tokens) x DP columns (the padded head
// dim) of a 16-bit type, stored row after row in rows of W = min(2 DP, 128)
// bytes, with each 16-byte chunk of a row XOR-swizzled by the row (the
// 128-, 64- or 32-byte swizzle of wgmma, for W = 128, 64, 32); at DP = 128
// the columns 64..127 follow as a second such block.  Eight rows form one
// swizzle atom of 8 W bytes.  One tile serves two ways:
//
// - K-major (rows are M or N, columns are K), as in S = Q K^T: atoms next
//   to each other in M or N lie 8 W bytes apart (the descriptor's stride
//   byte offset); a k step of 16 columns starts 32 bytes further along;
// - MN-major (rows are K, columns are N), as the B of dQ = dS K: 8 K-rows
//   lie 8 W bytes apart, the second 64-column block (DP = 128) 64 W bytes;
//   a k step of 16 rows starts 16 W bytes further; the instruction
//   transposes.
//
// The swizzle puts the chunks that a wgmma (or a warp's 16-byte copies)
// touch together in distinct banks; in an unswizzled layout of 8 x 8 core
// matrices the same chunk of eight neighbouring core matrices shares its
// banks.
//
// Products.  One warpgroup (128 threads) holds a 64-row f32 accumulator: in
// warp w, lane l has rows 16 w + l / 4 and that + 8, and in every 8-column
// block j the columns 8 j + 2 (l % 4) and + 1, at d[4 j + 0..3] (row, row,
// row + 8, row + 8).  wgmma takes its A operand from registers in the same
// arrangement, 16 columns (k) at a time, so an accumulator tile rounded to
// 16 bits is the A of the next product without passing through memory
// (pack_a).

#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace nns_flash {
namespace tc {

constexpr int kTile = 64;      // rows of a tile, the M of one wgmma
constexpr int kThreads = 128;  // one warpgroup

template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * DP * 2;
}

// Row bytes W of a tile's swizzle atom, and the wgmma layout code of its
// swizzle (1: 128 bytes, 2: 64, 3: 32).
template <int DP>
struct Swizzle {
  static constexpr int kRowBytes = 2 * DP < 128 ? 2 * DP : 128;
  static constexpr int kBlockBytes = kTile * kRowBytes;  // 64 columns' block
  static constexpr uint64_t kCode = kRowBytes == 128 ? 1
                                  : kRowBytes == 64  ? 2
                                                     : 3;
};

// Byte offset of the 16-byte chunk holding columns 8 cb .. 8 cb + 7 of row r.
template <int DP>
__device__ __forceinline__ int chunk_offset(int r, int cb) {
  using S = Swizzle<DP>;
  constexpr int kPerRow = S::kRowBytes / 16;
  const int lin = r * S::kRowBytes + (cb % kPerRow) * 16;
  return (cb / kPerRow) * S::kBlockBytes +
         (lin ^ (((lin >> 7) & (kPerRow - 1)) << 4));
}

// Byte offset of element (r, c).
template <int DP>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return chunk_offset<DP>(r, c >> 3) + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tiles start on the 1024-byte period of the widest swizzle; a kernel's
// dynamic shared memory is asked for kAtomAlign bytes more than it uses.
constexpr int kAtomAlign = 1024;
__device__ __forceinline__ char* align_atoms(char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAtomAlign - (a & (kAtomAlign - 1))) & (kAtomAlign - 1));
}

// cp.async: `bytes` of `src` (0 .. n) copied, the rest of the n zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before later reads by wgmma (the
// async proxy); a __syncthreads() after it extends that to the block.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte cp.async copies of 64-row tiles of one head of a (T, H, D)
// tensor into the swizzled layout, with each thread's part of the addresses
// worked out once (per copy they are one add and one compare): thread t of
// a warpgroup
// copies chunk column t % (DP / 8) of rows r0 + R i (r0 = t / (DP / 8),
// R = 128 / (DP / 8)), which land R W bytes apart, since R is a multiple of
// the swizzle's period in rows.
template <typename T, int DP>
struct TileCopy {
  static constexpr int kPerRow = DP / 8;
  static constexpr int kRowStep = kThreads / kPerRow;  // R
  static constexpr int kCopies = kTile / kRowStep;
  static_assert(kThreads % kPerRow == 0 && kTile % kRowStep == 0,
                "whole rows of copies per pass");
  const T* head;  // the source of zero-filled copies
  const T* src;
  long long row_stride;
  int r0, soff;
  bool col_ok;

  __device__ __forceinline__ TileCopy(const T* base, long long stride,
                                      int d) {
    const int t = threadIdx.x % kThreads;
    const int cb = t % kPerRow;
    r0 = t / kPerRow;
    soff = chunk_offset<DP>(r0, cb);
    col_ok = cb * 8 < d;
    row_stride = stride;
    head = base;
    src = base + r0 * stride + cb * 8;
  }

  // Rows [row0, row0 + 64) into `tile`; rows past n_rows and columns past d
  // are zero-filled.  In flight on return.
  __device__ __forceinline__ void load(char* tile, int row0,
                                       int n_rows) const {
    const uint32_t dst = smem_u32(tile) + soff;
    const T* g = src + row0 * row_stride;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool ok = col_ok && row0 + r0 + i * kRowStep < n_rows;
      cp_async_16(dst + i * kRowStep * Swizzle<DP>::kRowBytes,
                  ok ? g + i * kRowStep * row_stride : head, ok ? 16 : 0);
    }
  }
};

// Rows [row0, row0 + 64) of one head of a (T, H, D) tensor into the tile at
// `tile`; rows past n_rows and columns past d are zeros.  With `vec` (rows
// and d 16-byte aligned) as 16-byte cp.async copies (TileCopy), in flight
// on return.  Without, as scalar loads and stores, done on return (a shape
// rule: inputs whose rows or head dim are not 16-byte aligned cannot be
// copied 16 bytes at a time).  `tile` must be 1024-byte aligned, as the
// swizzle atoms are.  The 128 threads of one warpgroup make the copy (in a
// block of several, each warpgroup may load a tile of its own).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(char* tile,
                                          const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, bool vec) {
  if (vec) {
    TileCopy<T, DP>(src, row_stride, d).load(tile, row0, n_rows);
    return;
  }
  for (int i = threadIdx.x % kThreads; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    T x = from_f32<T>(0.f);
    if (row0 + r < n_rows && c < d)
      x = src[(long long)(row0 + r) * row_stride + c];
    *reinterpret_cast<T*>(tile + tile_offset<DP>(r, c)) = x;
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The last key (local index) that query row r sees: tkv - 1, or less under
// `causal`; -1 when it sees none.  A key tile [k0, k0 + 64) needs no mask in
// a query tile whose first row sees key k0 + 63.
__device__ __forceinline__ int last_visible_key(int r, int tkv, int causal,
                                                long long q_offset,
                                                long long k_offset) {
  long long last = tkv - 1;
  if (causal) last = min(last, q_offset + r - k_offset);
  return (int)max(last, -1LL);
}

// A wgmma descriptor of a swizzled tile in shared memory: `lbo` and `sbo`
// are the descriptor's leading and stride byte offsets.
template <int DP>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (Swizzle<DP>::kCode << 62);
}
// The tile as a K-major operand, k step `kk` (columns 16 kk .. 16 kk + 15).
template <int DP>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using S = Swizzle<DP>;
  const int byte = 32 * kk;
  return make_desc<DP>(tile + (byte / S::kRowBytes) * S::kBlockBytes +
                           byte % S::kRowBytes,
                       16, 8 * S::kRowBytes);
}
// The tile as an MN-major B, k step `kk` (rows 16 kk .. 16 kk + 15).
template <int DP>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using S = Swizzle<DP>;
  return make_desc<DP>(tile + kk * 16 * S::kRowBytes, S::kBlockBytes,
                       8 * S::kRowBytes);
}

// The byte offsets that take a tile's k-step-0 descriptor to k step kk, as
// a K-major operand and as an MN-major B: a descriptor holds its address in
// 16-byte units in its low bits, so desc + bytes / 16 is the descriptor of
// the same layout `bytes` further on (shared addresses stay below 2^18).
template <int DP>
__host__ __device__ constexpr uint32_t k_step_bytes(int kk) {
  return (32 * kk / Swizzle<DP>::kRowBytes) * Swizzle<DP>::kBlockBytes +
         32 * kk % Swizzle<DP>::kRowBytes;
}
template <int DP>
__host__ __device__ constexpr uint32_t mn_step_bytes(int kk) {
  return kk * 16 * Swizzle<DP>::kRowBytes;
}
__device__ __forceinline__ uint64_t desc_shift(uint64_t desc,
                                               uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait that
// completes it (the products write it asynchronously).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NNS_WGMMA_SS_N64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)                                \
      : "memory")

#define NNS_WGMMA_RS_N16(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                    \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

#define NNS_WGMMA_RS_N32(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

#define NNS_WGMMA_RS_N64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

#define NNS_WGMMA_RS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                             \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                             \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                             \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                             \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

// d (+)= A B on one warpgroup, f32 accumulators; the product adds to d when
// scale_d is nonzero and overwrites it otherwise.
//
// mma_ss_n64: A (64 x 16) and B (16 x 64) K-major from shared memory.
template <typename T>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    NNS_WGMMA_SS_N64("bf16");
  } else {
    NNS_WGMMA_SS_N64("f16");
  }
}

// mma_rs: A (64 x 16) from registers (pack_a), B (16 x N) MN-major from
// shared memory.
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 16) {
    if constexpr (kBf16) NNS_WGMMA_RS_N16("bf16");
    else NNS_WGMMA_RS_N16("f16");
  } else if constexpr (N == 32) {
    if constexpr (kBf16) NNS_WGMMA_RS_N32("bf16");
    else NNS_WGMMA_RS_N32("f16");
  } else if constexpr (N == 64) {
    if constexpr (kBf16) NNS_WGMMA_RS_N64("bf16");
    else NNS_WGMMA_RS_N64("f16");
  } else {
    if constexpr (kBf16) NNS_WGMMA_RS_N128("bf16");
    else NNS_WGMMA_RS_N128("f16");
  }
}

#undef NNS_WGMMA_SS_N64
#undef NNS_WGMMA_RS_N16
#undef NNS_WGMMA_RS_N32
#undef NNS_WGMMA_RS_N64
#undef NNS_WGMMA_RS_N128

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A 64 x 64 accumulator rounded to T as four k steps of A operands: a[kk]
// holds its columns 16 kk .. 16 kk + 15.
template <typename T>
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Writes a 64 x DP accumulator (rows row0.. of one head, those below n_rows
// and columns below d) into a contiguous (T, H, D) output.
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[DP / 2],
                                          int row0, int n_rows, int h,
                                          int head, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * half;
    if (row >= n_rows) continue;
    T* orow = out + ((long long)row * h + head) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + e;
        if (col < d) orow[col] = from_f32<T>(acc[4 * j + 2 * half + e]);
      }
  }
}

}  // namespace tc
}  // namespace nns_flash
