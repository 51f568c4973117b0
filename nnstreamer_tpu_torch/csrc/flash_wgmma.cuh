// Tensor-core pieces of the flash-attention kernels on Hopper (sm_90a): the
// forward (K2, flash_attention.cu), the two backward kernels (K3 and K4,
// flash_attention_bwd.cu) and their variants with an additive bias
// (flash_attention_bias.cu).  The shared-memory tile layout, its
// asynchronous and scalar loaders, the warpgroup matrix products (wgmma)
// that read it, and the mask helpers all share; the forward's streaming
// softmax, which both forwards share; and the TF32 products, their operand
// split and the f32 loaders (a chunk of the head dim; a piece of it
// transposed) that take f32 to the tensor cores in K2, K3 and K4.
//
// Tile layout.  A tile is 64 rows (tokens) x DP columns (the padded head
// dim) of a 16-bit type, stored row after row in rows of W = min(2 DP, 128)
// bytes, with each 16-byte chunk of a row XOR-swizzled by the row (the
// 128-, 64- or 32-byte swizzle of wgmma, for W = 128, 64, 32); at DP = 128
// and 256 the columns past 64 follow as further such blocks of 64 columns
// (two, or four: a row of four 128-byte swizzle atoms).  Eight rows form one
// swizzle atom of 8 W bytes.  One tile serves two ways:
//
// - K-major (rows are M or N, columns are K), as in S = Q K^T: atoms next
//   to each other in M or N lie 8 W bytes apart (the descriptor's stride
//   byte offset); a k step of 16 columns starts 32 bytes further along;
// - MN-major (rows are K, columns are N), as the B of dQ = dS K: 8 K-rows
//   lie 8 W bytes apart, each further 64-column block (DP = 128, 256) 64 W
//   bytes after the last (the descriptor's leading byte offset);
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
//
// 32-bit elements.  A TF32 product reads 32-bit elements with a k step of 8
// (still 32 bytes, so the byte layout above serves a tile of DP f32 columns
// as it serves 2 DP 16-bit ones), both operands K-major from shared
// memory (the only order wgmma takes for 32-bit types).  Its A from registers
// holds, in warp w, lane l, rows 16 w + l / 4 and + 8 at k columns l % 4
// and l % 4 + 4: words at the same bytes of the row (4 (l % 4) and 16 +
// 4 (l % 4) of each 32-byte step) as the 16-bit A's.  SwzRows gives the
// layout at any tile height, tf32_hi / tf32_lo split an operand for the
// three products that stand for one f32 product.

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
// a warpgroup copies chunk column t % C of rows r0 + R i (C = min(DP / 8,
// 16) chunk columns a pass, r0 = t / C, R = 128 / C), which land R W bytes
// apart, since R is a multiple of the swizzle's period in rows (8); at DP =
// 256 a second pass copies chunk column t % C + 16, two 64-column blocks
// further on.
template <typename T, int DP>
struct TileCopy {
  static constexpr int kPerRow = DP / 8;
  static constexpr int kCols = kPerRow < 16 ? kPerRow : 16;  // C
  static constexpr int kPasses = kPerRow / kCols;
  static constexpr int kRowStep = kThreads / kCols;  // R
  static constexpr int kCopies = kTile / kRowStep;
  // bytes from a pass's chunk to the next pass's, in the same row
  static constexpr int kPassBytes =
      kCols * 16 / Swizzle<DP>::kRowBytes * Swizzle<DP>::kBlockBytes;
  static_assert(kThreads % kCols == 0 && kTile % kRowStep == 0 &&
                    kRowStep % 8 == 0 && kPerRow % kCols == 0,
                "whole rows of copies per pass, on the swizzle's period");
  const T* head;  // the source of zero-filled copies
  const T* src;
  long long row_stride;
  int r0, soff;
  bool col_ok[kPasses];

  __device__ __forceinline__ TileCopy(const T* base, long long stride,
                                      int d) {
    const int t = threadIdx.x % kThreads;
    const int cb = t % kCols;
    r0 = t / kCols;
    soff = chunk_offset<DP>(r0, cb);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) col_ok[p] = (cb + p * kCols) * 8 < d;
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
    if constexpr (kPasses == 1) {
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const bool ok = col_ok[0] && row0 + r0 + i * kRowStep < n_rows;
        cp_async_16(dst + i * kRowStep * Swizzle<DP>::kRowBytes,
                    ok ? g + i * kRowStep * row_stride : head, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          const bool ok = col_ok[p] && row0 + r0 + i * kRowStep < n_rows;
          cp_async_16(dst + p * kPassBytes +
                          i * kRowStep * Swizzle<DP>::kRowBytes,
                      ok ? g + i * kRowStep * row_stride + p * kCols * 8
                         : head,
                      ok ? 16 : 0);
        }
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

#define NNS_WGMMA_SS_N32(K, TY, IMM)                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32" K ".f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "%16, %17, p, " IMM ";\n}\n"                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)                                \
      : "memory")

#define NNS_WGMMA_SS_N64(K, TY, IMM)                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64" K ".f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "%32, %33, p, " IMM ";\n}\n"                                            \
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

#define NNS_WGMMA_RS_N16(K, TY, IMM)                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n16" K ".f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                    \
      "{%8, %9, %10, %11}, %12, p, " IMM ";\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

#define NNS_WGMMA_RS_N32(K, TY, IMM)                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32" K ".f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "{%16, %17, %18, %19}, %20, p, " IMM ";\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

#define NNS_WGMMA_RS_N64(K, TY, IMM)                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64" K ".f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "{%32, %33, %34, %35}, %36, p, " IMM ";\n}\n"                           \
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

#define NNS_WGMMA_RS_N128(K, TY, IMM)                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128" K ".f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                             \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                             \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                             \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                             \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "{%64, %65, %66, %67}, %68, p, " IMM ";\n}\n"                           \
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

#define NNS_WGMMA_RS_N256(K, TY, IMM)                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256" K ".f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                               \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                             \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                             \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                             \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                             \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                             \
      " %56, %57, %58, %59, %60, %61, %62, %63, "                             \
      " %64, %65, %66, %67, %68, %69, %70, %71, "                             \
      " %72, %73, %74, %75, %76, %77, %78, %79, "                             \
      " %80, %81, %82, %83, %84, %85, %86, %87, "                             \
      " %88, %89, %90, %91, %92, %93, %94, %95, "                             \
      " %96, %97, %98, %99, %100, %101, %102, %103, "                         \
      " %104, %105, %106, %107, %108, %109, %110, %111, "                     \
      " %112, %113, %114, %115, %116, %117, %118, %119, "                     \
      " %120, %121, %122, %123, %124, %125, %126, %127}, "                    \
      "{%128, %129, %130, %131}, %132, p, " IMM ";\n}\n"                      \
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                   \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                   \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                   \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                   \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                   \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                   \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                   \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                   \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                   \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                   \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d)                                                          \
      : "memory")

// d (+)= A B on one warpgroup, f32 accumulators; the product adds to d when
// scale_d is nonzero and overwrites it otherwise.
//
// mma_ss: A (64 x 16) and B (16 x N) K-major from shared memory.
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a,
                                       uint64_t desc_b, int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) {
    if constexpr (kBf16) NNS_WGMMA_SS_N32("k16", "bf16", "1, 1, 0, 0");
    else NNS_WGMMA_SS_N32("k16", "f16", "1, 1, 0, 0");
  } else {
    if constexpr (kBf16) NNS_WGMMA_SS_N64("k16", "bf16", "1, 1, 0, 0");
    else NNS_WGMMA_SS_N64("k16", "f16", "1, 1, 0, 0");
  }
}

// mma_rs: A (64 x 16) from registers (pack_a), B (16 x N) MN-major from
// shared memory.
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma width");
  if constexpr (N == 16) {
    if constexpr (kBf16) NNS_WGMMA_RS_N16("k16", "bf16", "1, 1, 1");
    else NNS_WGMMA_RS_N16("k16", "f16", "1, 1, 1");
  } else if constexpr (N == 32) {
    if constexpr (kBf16) NNS_WGMMA_RS_N32("k16", "bf16", "1, 1, 1");
    else NNS_WGMMA_RS_N32("k16", "f16", "1, 1, 1");
  } else if constexpr (N == 64) {
    if constexpr (kBf16) NNS_WGMMA_RS_N64("k16", "bf16", "1, 1, 1");
    else NNS_WGMMA_RS_N64("k16", "f16", "1, 1, 1");
  } else if constexpr (N == 128) {
    if constexpr (kBf16) NNS_WGMMA_RS_N128("k16", "bf16", "1, 1, 1");
    else NNS_WGMMA_RS_N128("k16", "f16", "1, 1, 1");
  } else {
    if constexpr (kBf16) NNS_WGMMA_RS_N256("k16", "bf16", "1, 1, 1");
    else NNS_WGMMA_RS_N256("k16", "f16", "1, 1, 1");
  }
}

// mma_ss_tf32: A (64 x 8) and B (8 x N) K-major from shared memory, 32-bit
// operands taken as TF32.
template <int N>
__device__ __forceinline__ void mma_ss_tf32(float (&d)[N / 2],
                                            uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma width");
  if constexpr (N == 32) NNS_WGMMA_SS_N32("k8", "tf32", "1, 1");
  else NNS_WGMMA_SS_N64("k8", "tf32", "1, 1");
}

// mma_rs_tf32: the same for 32-bit operands taken as TF32 (k steps of 8;
// B K-major, the only order wgmma takes for 32-bit types), A in registers
// as the header's "32-bit elements" says.
template <int N>
__device__ __forceinline__ void mma_rs_tf32(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma width");
  if constexpr (N == 16) NNS_WGMMA_RS_N16("k8", "tf32", "1, 1");
  else if constexpr (N == 32) NNS_WGMMA_RS_N32("k8", "tf32", "1, 1");
  else if constexpr (N == 64) NNS_WGMMA_RS_N64("k8", "tf32", "1, 1");
  else if constexpr (N == 128) NNS_WGMMA_RS_N128("k8", "tf32", "1, 1");
  else NNS_WGMMA_RS_N256("k8", "tf32", "1, 1");
}

#undef NNS_WGMMA_SS_N32
#undef NNS_WGMMA_SS_N64
#undef NNS_WGMMA_RS_N16
#undef NNS_WGMMA_RS_N32
#undef NNS_WGMMA_RS_N64
#undef NNS_WGMMA_RS_N128
#undef NNS_WGMMA_RS_N256

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

// A 64 x N accumulator (N / 2 values a thread) rounded to T as N / 16 k
// steps of A operands: a[kk] holds its columns 16 kk .. 16 kk + 15.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&x)[N],
                                       uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Writes a 64 x N accumulator (rows row0 + 16 w.. of one head for warp w of
// the block, those below n_rows; its columns are c0 .. c0 + N - 1, those
// below d) into a contiguous (T, H, D) output.
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[N / 2],
                                          int row0, int n_rows, int h,
                                          int head, int d, int c0 = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * half;
    if (row >= n_rows) continue;
    T* orow = out + ((long long)row * h + head) * d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * (lane & 3) + e;
        if (col < d) orow[col] = from_f32<T>(acc[4 * j + 2 * half + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// 32-bit operands, tiles of any height, f32 loads through registers
// ---------------------------------------------------------------------------

// An f32 x as hi + lo, exactly: hi is x with its low 13 mantissa bits
// cleared (a TF32 value, which the tensor cores read as it is) and lo = x -
// hi, |lo| < 2^-10 |x|, whose own low bits the tensor cores drop.  Three
// TF32 products hi_a hi_b + hi_a lo_b + lo_a hi_b then miss a b by ~2^-20
// of |a b| (lo_a lo_b and the bits lo drops), the order of an f32 rounding.
__device__ __forceinline__ uint32_t tf32_hi(uint32_t x) {
  return x & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(tf32_hi(x)));
}

// Tiles of R rows in 128-byte swizzle atoms, laid out as the 64-row tiles
// above are at widths of 128 bytes or more: each row in blocks of 128
// bytes, block b of every row R x 128 bytes after block 0, each 16-byte
// chunk XOR-swizzled by its row.  Read as a K-major operand the R rows are
// the N of a product (8 of them 1024 bytes apart) and a 32-byte k step (16
// 16-bit or 8 32-bit elements) starts step(kk) bytes further on; at R = 64
// and 256-byte rows this is the layout of a 64 x 128 16-bit tile.
template <int R>
struct SwzRows {
  static_assert(R % 8 == 0, "whole swizzle atoms");
  // byte offset of 16-byte chunk cb of row r
  __device__ static __forceinline__ int chunk(int r, int cb) {
    const int lin = r * 128 + (cb & 7) * 16;
    return (cb >> 3) * (R * 128) + (lin ^ ((r & 7) << 4));
  }
  __host__ __device__ static constexpr uint32_t step(int kk) {
    return (kk >> 2) * (R * 128) + (kk & 3) * 32;
  }
  __device__ static __forceinline__ uint64_t desc(const char* tile) {
    return make_desc<128>(smem_u32(tile), 16, 8 * 128);
  }
};

// The f32 elements [col, col + 4) of the row at p: zeros past d, or where
// the row does not exist (!row_ok).  With `vec` (rows and d 16-byte
// aligned) one 16-byte load.
__device__ __forceinline__ uint4 load_f32x4(const float* __restrict__ p,
                                            int col, int d, bool row_ok,
                                            bool vec) {
  if (!row_ok || col >= d) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + col));
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = col + e < d ? __float_as_uint(__ldg(p + col + e)) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16-byte piece x of an f32 tile, split: hi at dst, lo `lo` bytes on.
__device__ __forceinline__ void store_split(char* dst, int lo, uint4 x) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  *reinterpret_cast<uint4*>(dst + lo) =
      make_uint4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// threadIdx.x, read anew where it is used.  The f32 loaders work their
// addresses out from the thread's index; from threadIdx.x the compiler
// hoists them out of a kernel's loop and holds them in registers across it,
// which a kernel with wide accumulators cannot spare (the backward's piece
// kernels spilled); from this they are recomputed at each load.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Rows [r0, r0 + R) of one head of a (T, H, D) tensor, the element columns
// of 256-byte chunk c that lie below dp (zeros past d and past n_rows), into
// the SwzRows<R> tile at `tile`.  f16 and bf16 as 16-byte cp.async copies (R
// = 64, in flight on return; scalar where !vec); f32 through registers, split
// into hi at `tile` and lo `lo` bytes after it, done on return.  One
// warpgroup a block; `tid` is the thread's index in it.
template <typename T, int R>
__device__ __forceinline__ void load_chunk(char* tile, int lo,
                                           const T* __restrict__ src,
                                           long long stride, int r0,
                                           int n_rows, int c, int dp, int d,
                                           bool vec, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kN = R * 16 / kThreads;  // 16-byte pieces a thread
    uint4 x[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int p = tid + kThreads * i, r = p >> 4;
      x[i] = load_f32x4(src + (long long)(r0 + r) * stride,
                        64 * c + 4 * (p & 15), d, r0 + r < n_rows, vec);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int p = tid + kThreads * i;
      if (64 * c + 4 * (p & 15) >= dp) continue;  // past the k steps
      store_split(tile + SwzRows<R>::chunk(p >> 4, p & 15), lo, x[i]);
    }
  } else {
    static_assert(R == kTile, "16-bit chunks of 64 rows");
    load_tile<T, 128>(tile, src + 128 * c, stride, r0, n_rows, d - 128 * c,
                      vec);
  }
}
template <typename T, int R>
__device__ __forceinline__ void load_chunk(char* tile, int lo,
                                           const T* __restrict__ src,
                                           long long stride, int r0,
                                           int n_rows, int c, int dp, int d,
                                           bool vec) {
  load_chunk<T, R>(tile, lo, src, stride, r0, n_rows, c, dp, d, vec,
                   threadIdx.x);
}

// A transposed f32 tile of R rows (keys or queries) and N columns, in
// 16-byte pieces of 4 columns of one row: piece p holds row u and column
// group cg.  A warp takes 16 rows x 2 column groups, so that each of its
// transposed word stores (store_transposed) is one word to a bank.
template <int R>
__device__ __forceinline__ void transposed_piece(int p, int& u, int& cg) {
  const int w = p >> 5;
  u = (p & 15) + 16 * (w % (R / 16));
  cg = ((p >> 4) & 1) + 2 * (w / (R / 16));
}

// Piece x (row u, columns 4 cg .. 4 cg + 3) into the transposed SwzRows<N>
// tile at `tile` as hi and, `lo` bytes after it, lo: column 4 cg + e is
// the tile's row 4 cg + e, and in it row u lies at word 8 (u / 8) + (u %
// 8) / 2 + 4 (u % 2).  That is the order in which a score accumulator's
// thread holds its columns as the A of a TF32 product (columns 8 t + 2 (l
// % 4) and + 1 where the A wants k columns l % 4 and + 4): the product sums
// over these rows, so the A needs no shuffle.
template <int N>
__device__ __forceinline__ void store_transposed(char* tile, int lo, int u,
                                                 int cg, uint4 x) {
  const int kc = (u & ~7) | ((u >> 1) & 3) | ((u & 1) << 2);
  const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    char* dst = tile + SwzRows<N>::chunk(4 * cg + e, kc >> 2) + (kc & 3) * 4;
    *reinterpret_cast<uint32_t*>(dst) = tf32_hi(w4[e]);
    *reinterpret_cast<uint32_t*>(dst + lo) = tf32_lo(w4[e]);
  }
}

// Rows [r0, r0 + R) of one head of an f32 (T, H, D) tensor, columns [c0,
// c0 + N), transposed into the SwzRows<N> tile at `tile` (store_transposed,
// lo `lo` bytes on).  Zeros past d and past n_rows; done on return.  One
// warpgroup a block; `tid` is the thread's index in it.
template <int N, int R>
__device__ __forceinline__ void load_f32_transposed(
    char* tile, int lo, const float* __restrict__ src, long long stride,
    int r0, int n_rows, int c0, int d, bool vec, int tid) {
  constexpr int kN = R * N / 4 / kThreads;  // 16-byte pieces a thread
  constexpr int kBatch = kN < 8 ? kN : 8;
  static_assert(kN >= 1 && kN % kBatch == 0, "whole batches of pieces");
#pragma unroll
  for (int i0 = 0; i0 < kN; i0 += kBatch) {
    uint4 x[kBatch];
    int u[kBatch], cg[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      transposed_piece<R>(tid + kThreads * (i0 + i), u[i], cg[i]);
      x[i] = load_f32x4(src + (long long)(r0 + u[i]) * stride,
                        c0 + 4 * cg[i], d, r0 + u[i] < n_rows, vec);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      store_transposed<N>(tile, lo, u[i], cg[i], x[i]);
  }
}
template <int N, int R>
__device__ __forceinline__ void load_f32_transposed(
    char* tile, int lo, const float* __restrict__ src, long long stride,
    int r0, int n_rows, int c0, int d, bool vec) {
  load_f32_transposed<N, R>(tile, lo, src, stride, r0, n_rows, c0, d, vec,
                            threadIdx.x);
}

// ---------------------------------------------------------------------------
// the forward's streaming softmax (flash_attention.cu and its biased
// variant, flash_attention_bias.cu)
// ---------------------------------------------------------------------------

// s = q k^T for NT tiles of 64 keys (k tile t TB bytes after the tile of
// K-major descriptor kd; q the tile of descriptor qd), issued and
// committed, not waited for.
template <typename T, int DP, int NT>
__device__ __forceinline__ void issue_scores(float (&s)[NT][32], uint64_t qd,
                                             uint64_t kd) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      tc::mma_ss<T, 64>(
          s[t], tc::desc_shift(qd, tc::k_step_bytes<DP>(kk)),
          tc::desc_shift(kd,
                         t * tc::tile_bytes<DP>() + tc::k_step_bytes<DP>(kk)),
          kk);
  tc::wgmma_commit();
}

// o += p v over NT tiles of 64 keys, p from registers, v tile t (t TB
// bytes after the tile of MN-major descriptor vd); issued and committed,
// not waited for.
template <typename T, int DP, int NT>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&pa)[NT][4][4],
                                         uint64_t vd) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_rs<T, DP>(
          acc, pa[t][kk],
          tc::desc_shift(vd,
                         t * tc::tile_bytes<DP>() + tc::mn_step_bytes<DP>(kk)),
          1);
  tc::wgmma_commit();
}

// 2^x on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of NT score tiles of 2 NS keys in this thread's two
// rows (s[t][4 j + e] is row e / 2, key k0 + 2 NS t + 8 j + col + e % 2):
// masks keys past each row's last visible key where `cut`; updates the
// running max m2 (base 2, scaled) and the thread's part of the row sum;
// leaves p in s (f32) and the factor by which each row's o must be rescaled
// in corr.
template <int NT, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NT][NS],
                                               float (&m2)[2],
                                               float (&lsum)[2],
                                               float (&corr)[2], bool cut,
                                               int k0, int col,
                                               const int (&last_key)[2],
                                               float scale2) {
  if (cut) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 2 * NS * t + 8 * j + col + (e & 1) > last_key[e >> 1])
            s[t][4 * j + e] = -CUDART_INF_F;
  }
  // each row's values as a tree of 4 partial maxima (then sums)
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i >> 2][i & 3] = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      float& p = part[(e >> 1) & 1][((e >> 2) & 1) * 2 + (e & 1)];
      p = fmaxf(p, s[t][e]);
    }
  float tmax[2], neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(fmaxf(part[i][0], part[i][1]),
                    fmaxf(part[i][2], part[i][3]));
    // the row's four threads are neighbouring lanes
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    const float m_new = fmaxf(m2[i], tmax[i] * scale2);
    // a row that has seen no visible key keeps m = -inf: p and corr are 0
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    corr[i] = exp2_ftz(m2[i] - m_use);
    m2[i] = m_new;
    neg[i] = -m_use;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i >> 2][i & 3] = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      s[t][e] = exp2_ftz(fmaf(s[t][e], scale2, neg[(e >> 1) & 1]));
      part[(e >> 1) & 1][((e >> 2) & 1) * 2 + (e & 1)] += s[t][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lsum[i] = lsum[i] * corr[i] +
              ((part[i][0] + part[i][1]) + (part[i][2] + part[i][3]));
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&f)[2]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] *= f[(e >> 1) & 1];
}

}  // namespace tc
}  // namespace nns_flash
