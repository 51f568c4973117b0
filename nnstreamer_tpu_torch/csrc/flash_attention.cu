// Flash-attention forward: exact attention with a streaming softmax.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/flash_attention.py::_kernel
// (body at :178-247), launched by _flash_forward at :282.  It computes the same
// function: for q (Tq, H, D) and k, v (Tkv, H, D),
//
//   s[i, j] = (q[i] . k[j]) / sqrt(D),  masked to -inf where the key lies past
//             the end of k, or (causal) where k_offset + j > q_offset + i,
//   out[i]  = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-20),
//   lse[i]  = m_i + log(l_i), or -inf for a row that sees no key (out is 0 there),
//
// with the running max m and sum l kept per row as the key tiles stream past,
// in f32 whatever the input type.
//
// The TPU kernel padded T up to its tile, transposed q/k/v to (H, T, D) and
// sliced the result back; here each input is read in place through its strides
// (batch, row and head strides, unit stride along D), the ragged tail is masked
// by bounds, and out is written straight into ([B,] Tq, H, D).  Its sequential
// grid axis over key tiles becomes a loop inside the block; the batch axis that
// jax.vmap lifts into the pallas_call grid is a grid axis here too (a call
// without one has b = 1).  Under `causal`, key tiles wholly in the future of a
// query tile are never loaded, and the query tiles that see the most keys are
// issued first.
//
// What bounds it: at the paths' shapes the work is operations for long causal
// sequences (LM, T = 2048: 4.3 GFLOP against 8.5 MB) and bytes for ViT's
// T = 197 (60 MFLOP against 0.61 MB), where launch and latency weigh most.
// There are three routes, by dtype and head dim:
//
// f16 and bf16: the tensor cores (flash_wgmma.cuh, shared with the backward).
// A block has WG warpgroups of 128 threads, each owning 64 query rows (the M
// of one wgmma), and they share the key/value tiles, 64 NT keys a stage:
//
// - s = q k^T is wgmma m64n64k16 over D / 16 k steps, the q tile and the k
//   tile both K-major from shared memory; o += p v is wgmma m64nDk16 with p
//   from registers (the s accumulator rounded to the inputs' type, as
//   FlashAttention-2 and -3 do; the row sum l adds the unrounded f32 p, as
//   the TPU kernel does) and the v tile read transposed (MN-major);
// - the online softmax runs in the accumulator's layout: a thread holds 16
//   scores of each of two rows a tile, so a row's max is two shuffles, and
//   it owns the same two rows of o, so the rescale by exp2(m_old - m_new)
//   touches only its own accumulators.  Scores are taken in base 2 with
//   scale * log2(e) folded into one FMA; a row that has seen no visible key
//   yet keeps m = -inf and gets p and factor 0 (the TPU kernel's safe_max).
//   The thread's part of l is summed across the row's four threads once, at
//   the end, and lse = (m2 + log2 l) ln 2 goes out in natural-log units;
// - q is copied once, and k/v stages go through a ring of S slots filled by
//   16-byte cp.async copies with zero-fill for ragged rows (a scalar loader
//   for rows or a D that are not 16-byte aligned): the next stages are in
//   flight while one computes.  Tiles stay 16-bit in wgmma's swizzled layout;
// - masks cost a compare per score only in stages the mask cuts (the causal
//   diagonal, the ragged end of k);
// - the grid is one axis, query tile outermost: under `causal` the tiles
//   that see the most keys start first across every head and batch element.
//
// What bounds it is the instruction stream, not one unit.  Per 64 x 64 tile
// a warpgroup's exp work on the special-function unit (16 a clock an SM)
// takes as long as its two products on the tensor cores, and at first the
// loop issued ~714 instructions a thread a tile, mostly address and
// descriptor arithmetic; with the copies' addressing worked out once
// (tc::TileCopy) and descriptors shifted by constants it issues ~480.
// FlashAttention-3's overlap of a warpgroup's softmax with its own p.v
// product gained nothing here (ptxas schedules the wait for p.v ahead of
// the softmax that the source puts before it), so each stage waits for
// its products and only other warpgroups on the SM fill the gaps.  The
// two versions (launch) trade latency for throughput: two warpgroups
// sharing each stage halve the copies a product needs and win on the
// batched training grids; one warpgroup on 128 keys a stage halves the
// per-stage overhead of the rows that set a small grid's time, and wins
// on the serving shapes.  Registers (ptxas, bf16 and f16): 95 / 104 / 125
// / 158 a thread at padded widths 16 / 32 / 64 / 128 for version 1, 155 /
// 161 / 177 / 211 for version 2, no spills.
//
// A padded width of 256 (a wide-head LM's D = 256, Gemma's head width)
// stays on the tensor cores: the p.v product is one wgmma m64n256k16 a k
// step, the v tile four 128-byte swizzle atoms a row.  Its accumulator alone
// is DP / 2 = 128 f32 a thread, so a stage holds 64 keys in both versions
// (version 2's two 64-key score tiles beside it would pass 255 registers),
// two stages of 32 KB tiles: 193 KB of shared memory for two warpgroups,
// 161 KB for one, a block an SM.  Registers 234 (version 1) and 227
// (version 2), no spills.

// f32: the CUDA cores, as first written.  A tensor-core f32 product is TF32,
// and the f32 kernel is held to the plain version to summation order.  One
// block of 256 threads per (64-query tile, head, batch element); key/value
// tiles go through shared memory in f32; each thread holds a 4 x 4 tile of
// scores and the same 4 rows of the output accumulator, and p passes through
// shared memory to be read back as the rows of the p.v product.  Its ceiling
// is the 67 TFLOP/s f32 rate.  The head dimension is a runtime value up to
// 256 (padded widths 16, 32, 64, 128 and 256), and columns past D load as
// zeros.
//
// Head dims past 256, every dtype: the same CUDA-core kernel in chunks of
// 64 columns (kChunked).  The scores sum over the chunks of q and k, each
// loaded in turn; lse comes once from the full sum; a block owns one chunk
// of out's columns (a grid axis), so it recomputes the scores for it: the
// score work grows with the number of chunks (5 at D = 320), a simple
// kernel that is right first.  The last chunk may be partial (D = 320 =
// 256 + 64 takes five whole ones; D = 600 ends on 24 columns): columns past
// D load as zeros and are not stored.  f16 and bf16 compute in f32 here,
// p unrounded, so they hold to the plain version to summation order too.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace nns_flash;
namespace tc = nns_flash::tc;

// Strides of q, k and v (batch, row, head), in elements.
struct Strides {
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

// DP is the padded head dim, or with kChunked the width of a head-dim chunk
// (any D, in chunks of DP columns: a block owns the output columns of chunk
// blockIdx.x % n_oc, and sums its scores over every chunk of q and k).
template <typename T, int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int tq, int tkv, int h, int d,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     int causal, long long q_offset, long long k_offset,
                     float scale, int vec) {
  using L = OutLayout<DP>;
  constexpr int kQStride = DP;
  constexpr int kKStride = DP + 4;
  constexpr int kVStride = DP;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // kBlockQ x kQStride
  float* ks = qs + kBlockQ * kQStride;       // kBlockK x kKStride
  float* vs = ks + kBlockK * kKStride;       // kBlockK x kVStride
  float* ps = vs + kBlockK * kVStride;       // kBlockQ x kPStride

  const int n_oc = kChunked ? (d + DP - 1) / DP : 1;  // output chunks
  const int rank = (int)blockIdx.x / n_oc;
  const int c_out = ((int)blockIdx.x - rank * n_oc) * DP;  // first column
  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  // causal: the last query tile sees the most keys, so issue it first
  const int qt = causal ? n_qtiles - 1 - rank : rank;
  const int q0 = qt * kBlockQ;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  q += bat * q_sb + head * q_sh;
  k += bat * k_sb + head * k_sh;
  v += bat * v_sb + head * v_sh;
  out += bat * tq * h * d;
  lse += (bat * h + head) * tq;
  if constexpr (!kChunked)
    load_tile<T, DP>(qs, kQStride, q, q_st, q0, tq, d, vec);

  // keys [0, k_end) can be visible to some row of this tile
  long long k_end = tkv;
  if (causal) {
    const long long last_q = q_offset + min(q0 + kBlockQ, tq) - 1;
    const long long visible = last_q - k_offset + 1;
    k_end = visible < 0 ? 0 : (visible < tkv ? visible : tkv);
  }

  float m_run[kRows], l_run[kRows];
  float acc[kRows][L::kWidth];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kWidth; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    // scores: s[i][j] = q[ty + 16i] . k[tx + 16j]
    float s[kRows][kCols];
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();  // the last chunk's q and k (and p, v) are read
        load_tile<T, DP>(qs, kQStride, q + c0, q_st, q0, tq, d - c0, vec);
        load_tile<T, DP>(ks, kKStride, k + c0, k_st, k0, tkv, d - c0, vec);
        __syncthreads();
        tile_dots<DP, kQStride, kKStride, true>(qs, ks, ty, tx, s);
      }
      // this block's output columns of v
      load_tile<T, DP>(vs, kVStride, v + c_out, v_st, k0, tkv, d - c_out,
                       vec);
      __syncthreads();
    } else {
      __syncthreads();  // the previous tile's k, v and p are no longer read
      load_tile<T, DP>(ks, kKStride, k, k_st, k0, tkv, d, vec);
      load_tile<T, DP>(vs, kVStride, v, v_st, k0, tkv, d, vec);
      __syncthreads();
      tile_dots<DP, kQStride, kKStride>(qs, ks, ty, tx, s);
    }

    // mask, then the streaming-softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qpos = q_offset + q0 + ty + 16 * i;
      float bmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kl = k0 + tx + 16 * j;
        const bool dead = kl >= tkv || (causal && k_offset + kl > qpos);
        s[i][j] = dead ? -CUDART_INF_F : s[i][j] * scale;
        bmax = fmaxf(bmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_new = fmaxf(m_run[i], bmax);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr =
          m_run[i] == -CUDART_INF_F ? 0.f : expf(m_run[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_safe);
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      m_run[i] = m_new;
      l_run[i] = l_run[i] * corr + psum;
#pragma unroll
      for (int c = 0; c < L::kWidth; ++c) acc[i][c] *= corr;
    }
    // the rows this thread reads back were written by its own half-warp
    __syncwarp();

    // acc[i][:] += p[ty + 16i][:] . v[:, this thread's columns]
    tile_accumulate<DP, kVStride>(ps, vs, ty, tx, acc);
  }

  // out = acc / max(l, 1e-20); lse = m + log(l), -inf where no key was seen
  // (written by the blocks of the first output chunk)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int c = 0; c < L::kWidth; ++c) acc[i][c] *= inv;
    if (tx == 0 && c_out == 0)
      lse[row] = l_run[i] > 0.f ? m_run[i] + logf(denom) : -CUDART_INF_F;
  }
  store_rows<T, DP>(out, acc, q0, tq, h, head, d, ty, tx, c_out);
}

// ---------------------------------------------------------------------------
// f16 and bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

// Stages of the key/value ring: three where a stage holds 16 KB, else two.
template <int DP, int NT>
__host__ __device__ constexpr int tc_stages() {
  return DP * NT <= 64 ? 3 : 2;
}

// Blocks an SM holds by registers: 3 x 128 threads (170 registers a thread)
// or 2 x 256 (128) at D <= 64 and 64 keys a stage, one fewer where the
// accumulators are wider.  At a padded width of 256 shared memory holds one
// block (161 KB for one warpgroup, 193 KB for two), whose threads may take
// 255 registers.
template <int DP, int WG, int NT>
__host__ __device__ constexpr int tc_min_blocks() {
  return DP > 128 ? 1 : (WG == 1 ? 3 : 2) - (DP > 64 || NT > 1 ? 1 : 0);
}

// The q tiles, the ring, and room to align the tiles.
template <int DP, int WG, int NT>
constexpr int tc_smem_bytes() {
  return (WG + 2 * NT * tc_stages<DP, NT>()) * tc::tile_bytes<DP>() +
         tc::kAtomAlign;
}

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

// The online softmax of NT score tiles in this thread's two rows (s[t][4 j +
// e] is row e / 2, key k0 + 64 t + 8 j + col + e % 2): masks keys past each
// row's last visible key where `cut`; updates the running max m2 (base 2,
// scaled) and the thread's part of the row sum; leaves p in s (f32) and the
// factor by which each row's o must be rescaled in corr.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][32],
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
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 64 * t + 8 * j + col + (e & 1) > last_key[e >> 1])
            s[t][4 * j + e] = -CUDART_INF_F;
  }
  // each row's values as a tree of 4 partial maxima (then sums)
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i >> 2][i & 3] = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
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
    for (int e = 0; e < 32; ++e) {
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

// K2 on the tensor cores: one block per (64 WG query rows, head, batch
// element), warpgroup w owning rows 64 w .. 64 w + 63 of the block's, and
// 64 NT keys a stage.  The grid is one axis, query tile outermost, so that
// under `causal` the tiles that see the most keys are issued first across
// every head and batch element, and the short ones fill the tail.
// Shared memory: the WG q tiles, then the ring of S slots, stage j's k and
// v tiles in slot j % S.  In a block of two warpgroups the first copies the
// k tiles and the second the v tiles.
template <typename T, int DP, int WG, int NT>
__global__ void __launch_bounds__(WG* tc::kThreads,
                                  tc_min_blocks<DP, WG, NT>())
flash_forward_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, int b, int tq, int tkv,
                        int h, int d, Strides st, int causal,
                        long long q_offset, long long k_offset, float scale,
                        int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  constexpr int S = tc_stages<DP, NT>();
  constexpr int kRows = WG * tc::kTile;
  constexpr int kKeys = NT * tc::kTile;  // keys a stage
  extern __shared__ __align__(1024) char smem_tc[];
  char* qs = tc::align_atoms(smem_tc);  // warpgroup w's q tile at + w TB
  char* ring = qs + WG * TB;  // slot s: k at + 2 NT s TB, v NT TB after

  const int n_qtiles = (tq + kRows - 1) / kRows;
  const int rank = blockIdx.x / (h * b);
  const int hb = blockIdx.x - rank * h * b;
  const int head = hb % h;
  const long long bat = hb / h;
  // causal: the last query tile sees the most keys, so issue it first
  const int q0 = (causal ? n_qtiles - 1 - rank : rank) * kRows;
  const int wg = threadIdx.x / tc::kThreads;
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block
  const int wq0 = q0 + wg * tc::kTile;  // this warpgroup's first row

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  out += bat * tq * h * d;
  lse += (bat * h + head) * tq;

  // stages of keys that some row of [first, first + rows) below tq sees
  auto key_stages = [&](int first, int rows) {
    const int last = min(first + rows, tq) - 1;
    if (last < first) return 0;
    const int k_end =
        tc::last_visible_key(last, tkv, causal, q_offset, k_offset) + 1;
    return (k_end + kKeys - 1) / kKeys;
  };
  const int n = key_stages(q0, kRows);             // the block's
  const int n_mine = key_stages(wq0, tc::kTile);   // this warpgroup's

  // a warpgroup's copies of stage g's k tiles (x = 0) or v tiles (x = 1)
  auto load_half = [&](int x, int g) {
    if (g >= n) return;
    char* dst = ring + ((g % S) * 2 + x) * NT * TB;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      tc::load_tile<T, DP>(dst + t * TB, x ? v : k, x ? st.v_st : st.k_st,
                           g * kKeys + t * tc::kTile, tkv, d, vec);
  };
  auto load_group = [&](int g) {
    if constexpr (WG == 1) {
      load_half(0, g);
      load_half(1, g);
    } else {
      load_half(wg, g);
    }
  };
  tc::load_tile<T, DP>(qs + wg * TB, q, st.q_st, wq0, tq, d, vec);
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {  // q travels with group 0
    load_group(g);
    tc::cp_async_commit();
  }

  // this thread's two rows: the last key each sees, running max and sum
  int last_key[2];
  float m2[2], lsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    last_key[i] = tc::last_visible_key(q0 + row + 8 * i, tkv, causal,
                                       q_offset, k_offset);
    m2[i] = -CUDART_INF_F;
    lsum[i] = 0.f;
  }
  // keys past this are masked in some row of the warpgroup's tile
  const int tile_last =
      tc::last_visible_key(wq0, tkv, causal, q_offset, k_offset);
  const float scale2 = scale * tc::kLog2e;
  const uint64_t qd = tc::desc_k_major<DP>(tc::smem_u32(qs + wg * TB), 0);
  const uint64_t kd0 = tc::desc_k_major<DP>(tc::smem_u32(ring), 0);
  const uint64_t vd0 = tc::desc_mn_major<DP>(tc::smem_u32(ring + NT * TB), 0);
  // the descriptors of stage j's k tiles and v tiles
  auto k_desc = [&](int j) {
    return tc::desc_shift(kd0, (j % S) * 2 * NT * TB);
  };
  auto v_desc = [&](int j) {
    return tc::desc_shift(vd0, (j % S) * 2 * NT * TB);
  };

  float acc[DP / 2], s[NT][32], corr[2];
  uint32_t pa[NT][4][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    tc::cp_async_wait<S - 2>();  // stage j has landed
    tc::fence_async_shared();
    __syncthreads();  // and every warpgroup is done with stage j - 1
    load_group(j + S - 1);
    tc::cp_async_commit();
    if (j >= n_mine) continue;  // keys in this warpgroup's future
    tc::wgmma_fence();
    issue_scores<T, DP, NT>(s, qd, k_desc(j));
    tc::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NT; ++t) tc::fence_acc(s[t]);
    const int k0 = j * kKeys;
    online_softmax(s, m2, lsum, corr, k0 + kKeys - 1 > tile_last, k0, col,
                   last_key, scale2);
#pragma unroll
    for (int t = 0; t < NT; ++t) tc::pack_a<T>(s[t], pa[t]);
    rescale(acc, corr);
    tc::wgmma_fence();
    issue_pv<T, DP, NT>(acc, pa, v_desc(j));
    tc::wgmma_wait<0>();
    tc::fence_acc(acc);
  }
  tc::cp_async_wait<0>();

  // out = o / max(l, 1e-20); lse = (m2 + log2 l) ln 2, -inf where l = 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-20f);
    const int r = q0 + row + 8 * i;
    if ((lane & 3) == 0 && r < tq)
      lse[r] = l > 0.f ? (m2[i] + log2f(l)) * tc::kLn2 : -CUDART_INF_F;
  }
  rescale(acc, inv);
  tc::store_acc<T, DP>(out, acc, q0, tq, h, head, d);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int b, tq, tkv, h, d;
  Strides st;
  int causal;
  long long q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

// 16-byte loads need 16-byte aligned rows and a head dim of whole vectors.
template <typename T>
bool vector_ok(const Args& a) {
  constexpr long long V = 16 / sizeof(T);
  const Strides& s = a.st;
  const long long all[] = {s.q_sb, s.q_st, s.q_sh, s.k_sb, s.k_st,
                           s.k_sh, s.v_sb, s.v_st, s.v_sh};
  for (long long x : all)
    if (x % V) return false;
  return a.d % V == 0 && (uintptr_t)a.q % 16 == 0 &&
         (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
}

// Sets a kernel's dynamic shared memory (above 48 KB a block must opt in).
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DP, int WG, int NT>
int launch_tc(const Args& a) {
  constexpr int bytes = tc_smem_bytes<DP, WG, NT>();
  auto kernel = flash_forward_tc_kernel<T, DP, WG, NT>;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows = WG * tc::kTile;
  const long long blocks = (long long)((a.tq + rows - 1) / rows) * a.h * a.b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WG * tc::kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.b, a.tq,
      a.tkv, a.h, a.d, a.st, a.causal, a.q_offset, a.k_offset, a.scale,
      (int)vector_ok<T>(a));
  return (int)cudaGetLastError();
}

// The CUDA-core kernel: DP the padded head dim, or with kChunked the chunk
// width, a grid axis of output chunks folded into x.
template <typename T, int DP, bool kChunked>
int launch_simt(const Args& a) {
  constexpr int floats = kBlockQ * DP + kBlockK * (DP + 4) + kBlockK * DP +
                         kBlockQ * kPStride;
  constexpr int bytes = floats * (int)sizeof(float);
  auto kernel = flash_forward_kernel<T, DP, kChunked>;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const Strides& s = a.st;
  const long long n_oc = kChunked ? (a.d + DP - 1) / DP : 1;
  const long long blocks = (long long)((a.tq + kBlockQ - 1) / kBlockQ) * n_oc;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, a.h, a.b);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.tq, a.tkv,
      a.h, a.d, s.q_sb, s.q_st, s.q_sh, s.k_sb, s.k_st, s.k_sh, s.v_sb,
      s.v_st, s.v_sh, a.causal, a.q_offset, a.k_offset, a.scale,
      (int)vector_ok<T>(a));
  return (int)cudaGetLastError();
}

// Whether blocks of two warpgroups (128 query rows) fill both block slots
// of every SM of the current device.
bool wide_grid(const Args& a) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)((a.tq + 127) / 128) * a.h * a.b >= 2LL * sms;
}

// f32 on the CUDA cores; f16 and bf16 up to 256 on the tensor cores, in
// version
//   1: two warpgroups a block, 64 keys a stage: fewer copies a product,
//      fastest where the grid fills every SM twice over (the batched
//      training shapes);
//   2: one warpgroup a block, 128 keys a stage (64 at a padded width of
//      256, where the p.v accumulator alone is 128 registers a thread):
//      less overhead a stage on the rows of key stages that set a small
//      grid's time (the serving shapes);
// version 0, what flash_attention launches, picks by the grid.
// chip_smoke.py times 1 and 2 against each other.
template <typename T, int DP>
int launch(const Args& a, int version) {
  if constexpr (std::is_same<T, float>::value) {
    if (version) return (int)cudaErrorInvalidValue;
    return launch_simt<T, DP, false>(a);
  } else {
    constexpr int kNT = DP > 128 ? 1 : 2;  // version 2's 64-key tiles
    if (version == 0) version = wide_grid(a) ? 1 : 2;
    if (version == 1) return launch_tc<T, DP, 2, 1>(a);
    if (version == 2) return launch_tc<T, DP, 1, kNT>(a);
    return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_d(const Args& a, int version) {
  if (a.d <= 16) return launch<T, 16>(a, version);
  if (a.d <= 32) return launch<T, 32>(a, version);
  if (a.d <= 64) return launch<T, 64>(a, version);
  if (a.d <= 128) return launch<T, 128>(a, version);
  if (a.d <= 256) return launch<T, 256>(a, version);
  // past 256, every dtype: the D-chunked CUDA-core kernel
  if (version) return (int)cudaErrorInvalidValue;
  return launch_simt<T, kChunk, true>(a);
}

int entry(const Args& a, int dtype, int version) {
  if (a.b <= 0 || a.tq <= 0 || a.h <= 0) return 0;
  if (a.d <= 0 || a.b > 65535) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch_d<float>(a, version);
    case 1:
      return dispatch_d<__half>(a, version);
    case 2:
      return dispatch_d<__nv_bfloat16>(a, version);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  q (b, tq, h, d), k and v (b, tkv, h, d), read through their
// strides (in elements; the head dimension must be contiguous); a call
// without a batch axis passes b = 1.  dtype: 0 f32, 1 f16, 2 bf16 (q, k, v
// and out alike).  out is a contiguous (b, tq, h, d) tensor, lse a
// contiguous f32 (b, h, tq).
#define NNS_FLASH_FWD_PARAMS                                                  \
  const void *q, const void *k, const void *v, void *out, void *lse, int b,   \
      int tq, int tkv, int h, int d, long long q_sb, long long q_st,          \
      long long q_sh, long long k_sb, long long k_st, long long k_sh,         \
      long long v_sb, long long v_st, long long v_sh, int causal,             \
      long long q_offset, long long k_offset, float scale, int dtype,         \
      void *stream
#define NNS_FLASH_FWD_ARGS                                                    \
  Args {                                                                      \
    q, k, v, out, static_cast<float*>(lse), b, tq, tkv, h, d,                 \
        Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh},        \
        causal, q_offset, k_offset, scale, static_cast<cudaStream_t>(stream)  \
  }

extern "C" int nns_flash_attention_fwd(NNS_FLASH_FWD_PARAMS) {
  return entry(NNS_FLASH_FWD_ARGS, dtype, 0);
}

// The same in tensor-core version `version` (see launch; 0 is the one
// nns_flash_attention_fwd launches).
extern "C" int nns_flash_attention_fwd_version(NNS_FLASH_FWD_PARAMS,
                                               int version) {
  return entry(NNS_FLASH_FWD_ARGS, dtype, version);
}

#undef NNS_FLASH_FWD_PARAMS
#undef NNS_FLASH_FWD_ARGS

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
