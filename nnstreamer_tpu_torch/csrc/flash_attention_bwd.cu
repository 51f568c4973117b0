// Flash-attention backward: dq, dk and dv without a (Tq, Tkv) matrix in memory.
//
// Replaces the two Pallas TPU kernels of nnstreamer_tpu/ops/flash_attention.py
// launched by _flash_backward: _bwd_dq_kernel (body at :331-370, launched at
// :466) and _bwd_dkv_kernel (:373-418, launched at :481).  Both recompute each
// 64 x 64 tile of probabilities from the forward's saved logsumexp, as
// _recompute_p (:311-328) does:
//
//   s[i, j]  = (q[i] . k[j]) / sqrt(D), masked where the key lies past the end
//              of k, or (causal) where k_offset + j > q_offset + i;
//   p[i, j]  = exp(s[i, j] - lse[i]), exactly 0 where masked and in rows with
//              lse = -inf (rows that saw no key, and rows past the end of q);
//   ds[i, j] = p[i, j] (dO[i] . v[j] - delta[i]) / sqrt(D),
//
// where delta = rowsum(dO * O) (less the lse cotangent) comes from the caller.
// The dq kernel (K3) sums dq[i] = sum_j ds[i, j] k[j]; the dk/dv kernel (K4)
// sums dv[j] = sum_i p[i, j] dO[i] and dk[j] = sum_i ds[i, j] q[i].  All sums
// are in f32; the results are cast once to the inputs' type.
//
// On the TPU each kernel walks its inner axis as a sequential grid dimension
// with VMEM scratch.  Here blocks run in parallel and in no order, so:
//
// - K3 has one block (256 threads in f32, 128 in f16 and bf16) per (64-query
//   tile, head, batch element) and loops over key tiles; K4 one per (64-key
//   tile, head, batch element), looping over query tiles.  Each block owns
//   its output rows outright: no atomics, so the result does not depend on
//   the order blocks run in;
// - under `causal`, K3 never loads key tiles wholly in the future of its query
//   tile and issues the longest query tiles first; K4 skips query tiles wholly
//   in the past of its key tile (the first key tiles, which see the most
//   query tiles, are issued first anyway);
// - inputs are read in place through their (batch, row, head) strides and the
//   ragged tails are masked by bounds, as in the forward (flash_attention.cu).
//
// What bounds it: per visible (query, key) pair K3 does 6 D operations
// (q.k, dO.v, ds.k) and K4 8 D (q.k, dO.v, p.dO, ds.q), so at the LM's
// 2048-token causal layer both are bound by operations, and at ViT's
// 197-token layers by bytes.  There are two routes, by dtype:
//
// f16 and bf16: the tensor cores (flash_wgmma.cuh).  One warpgroup of 128
// threads per block owns 64 output rows, the M of one wgmma.  All five tile
// products are wgmma m64nNk16 with f32 accumulators in registers: s and dp
// (N = 64) read both operands from shared memory; dq += ds k (K3) and
// dv += p^T dO, dk += ds^T q (K4) take p and ds from the registers that
// hold them, rounded to the inputs' type (as FlashAttention-2 does; the CPU
// test test_tensor_core_rounding_stays_inside_card_tolerance holds that
// rounding to the card's tolerance), and read k, dO and q as transposed
// (MN-major) operands of the same shared tiles that fed s and dp.  Tiles
// stay 16-bit in shared memory, in wgmma's swizzled layout, free of bank
// conflicts for the products' reads and the 16-byte copies alike.  The
// streamed tiles (k and v in K3; q, dO and their lse and delta slices in K4)
// go through a ring of two stages filled by 16-byte cp.async copies: the
// next tile's copy is in flight while this one computes.  Inputs whose rows or head dim are not 16-byte aligned
// (D = 6, say) cannot be copied 16 bytes at a time: a scalar loader fills the
// same layout, synchronously.  Masks cost a compare per score only in tiles the
// mask cuts (the causal diagonal, ragged ends); rows or columns with
// lse = -inf take lse = +inf, so exp2 gives them p = 0 exactly.
//
// Registers (ptxas, sm_90a): K3 115 / 115 / 139 / 168 and K4 118 / 136 /
// 168 / 232 a thread at padded widths 16 / 32 / 64 / 128, no spills; K4 at
// D = 64 holds dk and dv (64), s and dp (64) and the packed p and ds (32).
// Shared memory is 6 tiles (48 KB at D = 64, 96 KB at 128), so 3 K3 blocks
// and 2 K4 blocks share an SM at D = 64, 2 of each at D = 128.  What bounds
// them: within a block the exp and ds work on the CUDA cores does not
// overlap the block's own products (one warpgroup, no producer warp), so
// the SM's 2-3 blocks must overlap each other; at the LM layer they reach
// ~22 % of the bf16 tensor rate.
//
// A padded width of 256 (a wide-head LM's D = 256) stays on the tensor
// cores, 6 tiles of 32 KB (one block an SM); registers are what it costs:
//
// - K3's dq accumulator is 128 f32 a thread; two 64 x 64 score tiles (s and
//   dp, 64 more) beside it would not fit, so each stage's 64 keys are taken
//   32 at a time (wgmma m64n32k16 for s and dp, then dq += ds k as two k
//   steps of m64n256k16): 205 registers, no spills;
// - K4's dk and dv are 2 x 128 f32 a thread of one warpgroup, which no
//   tile order fits.  Two warpgroups share the block's 64 keys: the first
//   takes s^T and p, the second dp^T and then ds from the first's p, and
//   they trade p and ds through shared memory (16 KB); each owns a 128-
//   column half of dk and dv and runs its two products (m64n128k16, p^T and
//   ds^T rounded to T) on its half of the dO and q tiles.  The other way,
//   a grid axis over the halves, would recompute p and ds (half again the
//   products) and leave one warpgroup an SM.  252 registers, no spills;
//   215 KB of shared memory.
//
// Tile height: 64 rows is wgmma's M.  ViT's T = 197 = 3 * 64 + 5 pads the
// owned axis to 256 rows, 23 % of the work; a last streamed tile of 16 rows
// would cut that to ~4 %, at the cost of narrower s/dp variants.  Not done:
// at ViT's layer a block runs only 4 tile iterations, so its prologue, its
// store and the partial second wave of 768 blocks weigh as much.
//
// f32: the CUDA cores, as first written.  A tensor-core f32 product is TF32,
// and the f32 kernels are held to the plain backward to summation order.
// Each thread keeps a 4 x 4 tile of scores and its output rows' accumulators
// in registers; ds and p pass through shared memory only to be read back, by
// the half-warp that wrote them, as the rows of the next product.  Its
// ceiling is the 67 TFLOP/s f32 rate.  Padded widths 16, 32, 64 and 128
// (the f32 K4's 128-wide tiles take 174 KB of shared memory); columns past
// D load as zeros.
//
// Past those widths (f32 past 128, every dtype past 256): the same CUDA-core
// kernels in chunks of 64 columns (kChunked): s and dp sum over the
// chunks of q, dO, k and v; a block owns one chunk of the output
// columns (a grid axis folded into x) and recomputes s and dp for it; lse
// and delta come from the caller, once over the full D.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace nns_flash;
namespace tc = nns_flash::tc;

// Strides of the four (b, t, h, d) inputs, in elements.
struct Strides {
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // dO
};

template <int DP>
constexpr int min_blocks() {
  return DP <= 64 ? 2 : 1;
}

// K3 on the CUDA cores: dq.  Shared tiles: q and dO (the rows of the two
// score products), k and v (their columns, padded rows), ds.  DP is the
// padded head dim, or with kChunked the width of a head-dim chunk: the
// scores sum over every chunk of q, dO, k and v, and the block owns the dq
// columns of chunk blockIdx.x % n_oc.
template <typename T, int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads, min_blocks<DP>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tkv, int h, int d, Strides st, int causal,
                    long long q_offset, long long k_offset, float scale,
                    int vec) {
  using L = OutLayout<DP>;
  constexpr int kAStride = DP;
  constexpr int kBStride = DP + 4;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // kBlockQ x kAStride
  float* dos = qs + kBlockQ * kAStride;      // kBlockQ x kAStride
  float* ks = dos + kBlockQ * kAStride;      // kBlockK x kBStride
  float* vs = ks + kBlockK * kBStride;       // kBlockK x kBStride
  float* dss = vs + kBlockK * kBStride;      // kBlockQ x kPStride

  const int n_oc = kChunked ? (d + DP - 1) / DP : 1;  // output chunks
  const int rank = (int)blockIdx.x / n_oc;
  const int c_out = ((int)blockIdx.x - rank * n_oc) * DP;  // first column
  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  const int qt = causal ? n_qtiles - 1 - rank : rank;
  const int q0 = qt * kBlockQ;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  dout += bat * st.o_sb + head * st.o_sh;
  lse += (bat * h + head) * tq;
  delta += (bat * h + head) * tq;
  dq += bat * tq * h * d;

  if constexpr (!kChunked) {
    load_tile<T, DP>(qs, kAStride, q, st.q_st, q0, tq, d, vec);
    load_tile<T, DP>(dos, kAStride, dout, st.o_st, q0, tq, d, vec);
  }

  // this thread's rows: their lse (-inf past the end of q) and delta
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < tq ? lse[row] : -CUDART_INF_F;
    delta_r[i] = row < tq ? delta[row] : 0.f;
  }

  long long k_end = tkv;
  if (causal) {
    const long long last_q = q_offset + min(q0 + kBlockQ, tq) - 1;
    const long long visible = last_q - k_offset + 1;
    k_end = visible < 0 ? 0 : (visible < tkv ? visible : tkv);
  }

  float acc[kRows][L::kWidth];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < L::kWidth; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    float s[kRows][kCols], dp[kRows][kCols];
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();  // the last chunk's tiles (and ds, k) are read
        load_tile<T, DP>(qs, kAStride, q + c0, st.q_st, q0, tq, d - c0, vec);
        load_tile<T, DP>(dos, kAStride, dout + c0, st.o_st, q0, tq, d - c0,
                         vec);
        load_tile<T, DP>(ks, kBStride, k + c0, st.k_st, k0, tkv, d - c0,
                         vec);
        load_tile<T, DP>(vs, kBStride, v + c0, st.v_st, k0, tkv, d - c0,
                         vec);
        __syncthreads();
        tile_dots<DP, kAStride, kBStride, true>(qs, ks, ty, tx, s);
        tile_dots<DP, kAStride, kBStride, true>(dos, vs, ty, tx, dp);
      }
      __syncthreads();  // k's last chunk is read
      // this block's dq columns of k
      load_tile<T, DP>(ks, kBStride, k + c_out, st.k_st, k0, tkv, d - c_out,
                       vec);
      __syncthreads();
    } else {
      __syncthreads();  // the previous tile's k, v and ds are no longer read
      load_tile<T, DP>(ks, kBStride, k, st.k_st, k0, tkv, d, vec);
      load_tile<T, DP>(vs, kBStride, v, st.v_st, k0, tkv, d, vec);
      __syncthreads();
      tile_dots<DP, kAStride, kBStride>(qs, ks, ty, tx, s);
      tile_dots<DP, kAStride, kBStride>(dos, vs, ty, tx, dp);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qpos = q_offset + q0 + ty + 16 * i;
      const bool row_dead = lse_r[i] == -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kl = k0 + tx + 16 * j;
        const bool dead = row_dead || kl >= tkv ||
                          (causal && k_offset + kl > qpos);
        const float p = dead ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        dss[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncwarp();  // ds rows are read back by the half-warp that wrote them

    // acc[i][:] += ds[ty + 16i][:] . k[:, this thread's columns]
    tile_accumulate<DP, kBStride>(dss, ks, ty, tx, acc);
  }

  store_rows<T, DP>(dq, acc, q0, tq, h, head, d, ty, tx, c_out);
}

// K4 on the CUDA cores: dk and dv.  A thread's score rows are keys and its
// columns queries.  Shared tiles: k and v (the rows of the two transposed
// score products), q and dO (their columns, padded rows; also the rows of
// the dk and dv products), p^T and ds^T.  With kChunked, as K3's: the
// scores sum over every chunk, and the block owns the dk and dv columns of
// chunk blockIdx.x % n_oc.
template <typename T, int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads, min_blocks<DP>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tkv, int h, int d,
                     Strides st, int causal, long long q_offset,
                     long long k_offset, float scale, int vec) {
  using L = OutLayout<DP>;
  constexpr int kAStride = DP;
  constexpr int kBStride = DP + 4;

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // kBlockK x kAStride
  float* vs = ks + kBlockK * kAStride;       // kBlockK x kAStride
  float* qs = vs + kBlockK * kAStride;       // kBlockQ x kBStride
  float* dos = qs + kBlockQ * kBStride;      // kBlockQ x kBStride
  float* pts = dos + kBlockQ * kBStride;     // kBlockK x kPStride
  float* dsts = pts + kBlockK * kPStride;    // kBlockK x kPStride

  const int n_oc = kChunked ? (d + DP - 1) / DP : 1;  // output chunks
  const int kt = (int)blockIdx.x / n_oc;
  const int c_out = ((int)blockIdx.x - kt * n_oc) * DP;  // first column
  const int k0 = kt * kBlockK;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  dout += bat * st.o_sb + head * st.o_sh;
  lse += (bat * h + head) * tq;
  delta += (bat * h + head) * tq;
  dk += bat * tkv * h * d;
  dv += bat * tkv * h * d;

  if constexpr (!kChunked) {
    load_tile<T, DP>(ks, kAStride, k, st.k_st, k0, tkv, d, vec);
    load_tile<T, DP>(vs, kAStride, v, st.v_st, k0, tkv, d, vec);
  }

  float dk_acc[kRows][L::kWidth], dv_acc[kRows][L::kWidth];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < L::kWidth; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query tiles whose last row lies before this key tile's first key
  // see none of it
  int q_start = 0;
  if (causal) {
    // first query row (local) that can see key k0: q_offset + r >= k_offset + k0
    const long long first = k_offset + k0 - q_offset;
    q_start = first <= 0 ? 0
            : first >= tq ? tq
                          : (int)(first / kBlockQ) * kBlockQ;
  }

  for (int q0 = q_start; q0 < tq; q0 += kBlockQ) {
    float lse_c[kCols], delta_c[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = q0 + tx + 16 * j;
      lse_c[j] = col < tq ? lse[col] : -CUDART_INF_F;
      delta_c[j] = col < tq ? delta[col] : 0.f;
    }
    // s^T[i][j] = k[ty + 16i] . q[tx + 16j]; dp^T likewise from v and dO
    float s[kRows][kCols], dp[kRows][kCols];
    if constexpr (kChunked) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();  // the last chunk's tiles (and p^T, ds^T) are read
        load_tile<T, DP>(ks, kAStride, k + c0, st.k_st, k0, tkv, d - c0,
                         vec);
        load_tile<T, DP>(vs, kAStride, v + c0, st.v_st, k0, tkv, d - c0,
                         vec);
        load_tile<T, DP>(qs, kBStride, q + c0, st.q_st, q0, tq, d - c0, vec);
        load_tile<T, DP>(dos, kBStride, dout + c0, st.o_st, q0, tq, d - c0,
                         vec);
        __syncthreads();
        tile_dots<DP, kAStride, kBStride, true>(ks, qs, ty, tx, s);
        tile_dots<DP, kAStride, kBStride, true>(vs, dos, ty, tx, dp);
      }
      __syncthreads();  // q's and dO's last chunks are read
      // this block's dk and dv columns of q and dO
      load_tile<T, DP>(qs, kBStride, q + c_out, st.q_st, q0, tq, d - c_out,
                       vec);
      load_tile<T, DP>(dos, kBStride, dout + c_out, st.o_st, q0, tq,
                       d - c_out, vec);
      __syncthreads();
    } else {
      __syncthreads();  // the previous tile's q, dO, p^T and ds^T are not read
      load_tile<T, DP>(qs, kBStride, q, st.q_st, q0, tq, d, vec);
      load_tile<T, DP>(dos, kBStride, dout, st.o_st, q0, tq, d, vec);
      __syncthreads();
      tile_dots<DP, kAStride, kBStride>(ks, qs, ty, tx, s);
      tile_dots<DP, kAStride, kBStride>(vs, dos, ty, tx, dp);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kl = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long qpos = q_offset + q0 + tx + 16 * j;
        const bool dead = lse_c[j] == -CUDART_INF_F || kl >= tkv ||
                          (causal && k_offset + kl > qpos);
        const float p = dead ? 0.f : expf(s[i][j] * scale - lse_c[j]);
        pts[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        dsts[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p * (dp[i][j] - delta_c[j]) * scale;
      }
    }
    __syncwarp();  // p^T and ds^T rows are read back by their writers

    // dv[i][:] += p^T[ty + 16i][:] . dO[:, cols]; dk likewise from ds^T and q
    tile_accumulate<DP, kBStride>(pts, dos, ty, tx, dv_acc);
    tile_accumulate<DP, kBStride>(dsts, qs, ty, tx, dk_acc);
  }

  store_rows<T, DP>(dk, dk_acc, k0, tkv, h, head, d, ty, tx, c_out);
  store_rows<T, DP>(dv, dv_acc, k0, tkv, h, head, d, ty, tx, c_out);
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * kBlockQ * DP + 2 * kBlockK * (DP + 4) + kBlockQ * kPStride) *
         (int)sizeof(float);
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockK * DP + 2 * kBlockQ * (DP + 4) + 2 * kBlockK * kPStride) *
         (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// f16 and bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

// The first query (local index) that sees key kl: 0, or more under
// `causal`; tq when none does, as for keys past the end of k.
__device__ __forceinline__ int first_visible_query(int kl, int tq, int tkv,
                                                   int causal,
                                                   long long q_offset,
                                                   long long k_offset) {
  if (kl >= tkv) return tq;
  long long first = causal ? k_offset + kl - q_offset : 0;
  return (int)min(max(first, 0LL), (long long)tq);
}

// K3 on the tensor cores.  Shared memory: the q and dO tiles, then two stages
// of (k, v) tiles; the copy of the next stage is in flight while this one
// computes.  Each stage's 64 keys are taken KN at a time: s and dp are 64 x
// KN tiles.  KN is 64, or 32 at a padded width of 256, where the dq
// accumulator alone is 128 registers a thread and two 64 x 64 score tiles
// beside it would not fit.
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, min_blocks<DP>())
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int tq, int tkv, int h, int d, Strides st, int causal,
                       long long q_offset, long long k_offset, float scale,
                       int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  constexpr int KN = DP > 128 ? 32 : 64;  // keys a score tile
  constexpr int kRowBytes = tc::Swizzle<DP>::kRowBytes;
  extern __shared__ __align__(1024) char smem_tc[];
  char* qs = tc::align_atoms(smem_tc);
  char* dos = qs + TB;
  char* kvs = dos + TB;  // stage s: k at kvs + 2 s TB, v TB after it

  const int n_qtiles = (tq + tc::kTile - 1) / tc::kTile;
  const int qt = causal ? n_qtiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * tc::kTile;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  dout += bat * st.o_sb + head * st.o_sh;
  lse += (bat * h + head) * tq;
  delta += (bat * h + head) * tq;
  dq += bat * tq * h * d;

  tc::load_tile<T, DP>(qs, q, st.q_st, q0, tq, d, vec);
  tc::load_tile<T, DP>(dos, dout, st.o_st, q0, tq, d, vec);
  tc::cp_async_commit();

  // this thread's two rows: lse in base 2, made +inf where it is -inf or
  // past the end of q (exp2 of -inf gives those rows p = 0 exactly); delta;
  // the last key each row sees
  float lse2[2], dlt[2];
  int last_key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row + 8 * i;
    const float l = r < tq ? lse[r] : -CUDART_INF_F;
    lse2[i] = l == -CUDART_INF_F ? CUDART_INF_F : l * tc::kLog2e;
    dlt[i] = r < tq ? delta[r] : 0.f;
    last_key[i] = tc::last_visible_key(r, tkv, causal, q_offset, k_offset);
  }
  // keys past this are masked in some row of the tile
  const int tile_last =
      tc::last_visible_key(q0, tkv, causal, q_offset, k_offset);
  const float scale2 = scale * tc::kLog2e;

  long long k_end = tkv;
  if (causal) {
    const long long last_q = q_offset + min(q0 + tc::kTile, tq) - 1;
    const long long visible = last_q - k_offset + 1;
    k_end = visible < 0 ? 0 : (visible < tkv ? visible : tkv);
  }
  const int n_k = (int)((k_end + tc::kTile - 1) / tc::kTile);

  auto load_kv = [&](int stage, int k0) {
    char* ks = kvs + stage * 2 * TB;
    tc::load_tile<T, DP>(ks, k, st.k_st, k0, tkv, d, vec);
    tc::load_tile<T, DP>(ks + TB, v, st.v_st, k0, tkv, d, vec);
  };
  if (n_k > 0) load_kv(0, 0);
  tc::cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = tc::smem_u32(qs), doa = tc::smem_u32(dos);

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * tc::kTile;
    const uint32_t ka = tc::smem_u32(kvs + (it & 1) * 2 * TB);
    const uint32_t va = ka + TB;
    if (it + 1 < n_k) load_kv((it + 1) & 1, k0 + tc::kTile);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // q, dO and this stage have landed
    tc::fence_async_shared();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < tc::kTile / KN; ++u) {
      const int k1 = k0 + u * KN;  // this score tile's first key
      // rows u KN .. of the k and v tiles, as K-major Bs
      const uint32_t rows = u * KN * kRowBytes;
      // s = q k^T and dp = dO v^T, 64 x KN each
      float s[KN / 2], dp[KN / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, KN>(s, tc::desc_k_major<DP>(qa, kk),
                          tc::desc_k_major<DP>(ka + rows, kk), kk);
      tc::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, KN>(dp, tc::desc_k_major<DP>(doa, kk),
                          tc::desc_k_major<DP>(va + rows, kk), kk);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // s is done; dp may still run
      tc::fence_acc(s);
      if (k1 + KN - 1 > tile_last) {  // a tile the mask cuts
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = k1 + 8 * j + col + (e & 1);
            s[4 * j + e] = kl > last_key[e >> 1]
                               ? 0.f
                               : exp2f(s[4 * j + e] * scale2 - lse2[e >> 1]);
          }
      } else {
#pragma unroll
        for (int e = 0; e < KN / 2; ++e)
          s[e] = exp2f(s[e] * scale2 - lse2[(e >> 1) & 1]);
      }
      tc::wgmma_wait<0>();
      tc::fence_acc(dp);
#pragma unroll
      for (int e = 0; e < KN / 2; ++e)
        dp[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]) * scale;  // ds

      // dq += ds k: ds rounded to T, k rows u KN .. as the MN-major B
      uint32_t a[KN / 16][4];
      tc::pack_a<T>(dp, a);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        tc::mma_rs<T, DP>(acc, a[kk],
                          tc::desc_mn_major<DP>(ka, u * KN / 16 + kk), 1);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(acc);
    }
    __syncthreads();  // this stage is free for the copy after next
  }
  tc::cp_async_wait<0>();

  tc::store_acc<T, DP>(dq, acc, q0, tq, h, head, d);
}

// K4 on the tensor cores: the block's 64 keys are the rows of every product
// (s^T = k q^T, dp^T = v dO^T, dv += p^T dO, dk += ds^T q).  Shared memory:
// the k and v tiles, then two stages of (q tile, dO tile, the query tile's
// 64 lse and 64 delta values).
//
// WG warpgroups: one, or two at a padded width of 256, where dk and dv
// together are 256 f32 a thread of one warpgroup.  Two split the work: the
// first takes s^T and p, the second dp^T and ds, and they trade p and ds
// through shared memory (xch: a thread's 32 values at a stride of 128
// floats, so each of its stores and loads is one conflict-free row); each
// then owns one 128-column half of dk and dv, with p^T and ds^T rounded to
// T as the A of its two products.
template <typename T, int DP, int WG>
__global__ void __launch_bounds__(WG* tc::kThreads, min_blocks<DP>())
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int tq, int tkv, int h, int d,
                        Strides st, int causal, long long q_offset,
                        long long k_offset, float scale, int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  constexpr int NO = DP / WG;  // columns of dk and dv a warpgroup owns
  constexpr int kSlices = 2 * tc::kTile * (int)sizeof(float);
  static_assert(tc::kThreads == 2 * tc::kTile, "one lse or delta per thread");
  static_assert(WG == 1 || (WG == 2 && NO % 64 == 0), "whole column blocks");
  extern __shared__ __align__(1024) char smem_tc[];
  char* ks = tc::align_atoms(smem_tc);
  char* vs = ks + TB;
  char* stages = vs + TB;  // stage s: q at stages + 2 s TB, dO TB after it
  char* slices = stages + 4 * TB;  // stage s: lse, delta at + s kSlices
  float* xch = reinterpret_cast<float*>(slices + 2 * kSlices);  // WG == 2

  const int k0 = blockIdx.x * tc::kTile;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  // with one warpgroup these are constants, and the code is as it was
  const int wg = WG == 1 ? 0 : threadIdx.x / tc::kThreads;
  const int tid = WG == 1 ? threadIdx.x : threadIdx.x % tc::kThreads;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  dout += bat * st.o_sb + head * st.o_sh;
  lse += (bat * h + head) * tq;
  delta += (bat * h + head) * tq;
  dk += bat * tkv * h * d;
  dv += bat * tkv * h * d;

  // with two warpgroups the first copies k and q tiles, the second v and dO
  if (wg == 0) tc::load_tile<T, DP>(ks, k, st.k_st, k0, tkv, d, vec);
  if (wg == WG - 1) tc::load_tile<T, DP>(vs, v, st.v_st, k0, tkv, d, vec);
  tc::cp_async_commit();

  // causal: query tiles whose last row lies before this key tile's first key
  // see none of it
  int q_start = 0;
  if (causal) {
    const long long first = k_offset + k0 - q_offset;
    q_start = first <= 0 ? 0
            : first >= tq ? tq
                          : (int)(first / tc::kTile) * tc::kTile;
  }
  const int n_q = (tq - q_start + tc::kTile - 1) / tc::kTile;

  auto load_q = [&](int stage, int q0) {
    char* base = stages + stage * 2 * TB;
    if (wg == 0) tc::load_tile<T, DP>(base, q, st.q_st, q0, tq, d, vec);
    if (wg == WG - 1)
      tc::load_tile<T, DP>(base + TB, dout, st.o_st, q0, tq, d, vec);
    // thread t copies lse[q0 + t] (t < 64) or delta[q0 + t - 64]; zeros past
    // the end of q, whose columns the mask drops
    if (wg == 0) {
      const int t = tid & (tc::kTile - 1);
      const float* src = tid < tc::kTile ? lse : delta;
      const bool ok = q0 + t < tq;
      tc::cp_async_4(tc::smem_u32(slices + stage * kSlices) + 4 * tid,
                     ok ? src + q0 + t : src, ok ? 4 : 0);
    }
  };
  if (n_q > 0) load_q(0, q_start);
  tc::cp_async_commit();

  float dk_acc[NO / 2], dv_acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // the first query each of this thread's two keys is seen by (tq for keys
  // past the end of k), and the last such over the tile
  int first_q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    first_q[i] = first_visible_query(k0 + row + 8 * i, tq, tkv, causal,
                                     q_offset, k_offset);
  const int tile_first = first_visible_query(
      min(k0 + tc::kTile, tkv) - 1, tq, tkv, causal, q_offset, k_offset);
  const bool keys_cut = k0 + tc::kTile > tkv;
  const float scale2 = scale * tc::kLog2e;
  const uint32_t ka = tc::smem_u32(ks), va = tc::smem_u32(vs);
  // this warpgroup's output columns in the q and dO tiles (MN-major Bs)
  const uint32_t half = wg * (NO / 64) * tc::Swizzle<DP>::kBlockBytes;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_start + it * tc::kTile;
    char* base = stages + (it & 1) * 2 * TB;
    if (it + 1 < n_q) load_q((it + 1) & 1, q0 + tc::kTile);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // k, v and this stage have landed
    tc::fence_async_shared();
    __syncthreads();
    const uint32_t qa = tc::smem_u32(base), doa = qa + TB;
    const float* lse_s =
        reinterpret_cast<const float*>(slices + (it & 1) * kSlices);
    const float* delta_s = lse_s + tc::kTile;
    // a tile the mask cuts: keys or queries past the end, or the diagonal
    const bool cut = keys_cut || q0 + tc::kTile > tq || tile_first > q0;

    // p^T = exp(s^T - lse) from s^T = k q^T, masked (rows are keys,
    // columns queries)
    auto probabilities = [&](float (&s)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + col);
        // lse in base 2, +inf where it is -inf (queries that saw no key)
        const float l2[2] = {
            l.x == -CUDART_INF_F ? CUDART_INF_F : l.x * tc::kLog2e,
            l.y == -CUDART_INF_F ? CUDART_INF_F : l.y * tc::kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] * scale2 - l2[e & 1]);
          if (cut) {
            const int ql = q0 + 8 * j + col + (e & 1);
            s[4 * j + e] = ql < first_q[e >> 1] || ql >= tq ? 0.f : p;
          } else {
            s[4 * j + e] = p;
          }
        }
      }
    };
    // ds^T = p^T (dp^T - delta) / sqrt(D), into dp
    auto grads = [&](const float (&p)[32], float (&dp)[32]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = p[4 * j + e] *
                          (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    };

    float s[32], dp[32];
    if constexpr (WG == 1) {
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, 64>(s, tc::desc_k_major<DP>(ka, kk),
                          tc::desc_k_major<DP>(qa, kk), kk);
      tc::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, 64>(dp, tc::desc_k_major<DP>(va, kk),
                          tc::desc_k_major<DP>(doa, kk), kk);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // s^T is done; dp^T may still run
      tc::fence_acc(s);
      probabilities(s);
      tc::wgmma_wait<0>();
      tc::fence_acc(dp);
      grads(s, dp);
    } else {
      // warpgroup 0: s^T and p; warpgroup 1: dp^T, then ds from its p
      if (wg == 0) {
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          tc::mma_ss<T, 64>(s, tc::desc_k_major<DP>(ka, kk),
                            tc::desc_k_major<DP>(qa, kk), kk);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_acc(s);
        probabilities(s);
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[e * tc::kThreads + tid] = s[e];
      } else {
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          tc::mma_ss<T, 64>(dp, tc::desc_k_major<DP>(va, kk),
                            tc::desc_k_major<DP>(doa, kk), kk);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_acc(dp);
      }
      __syncthreads();  // p is in xch
      if (wg == 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = xch[e * tc::kThreads + tid];
        grads(s, dp);
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[e * tc::kThreads + tid] = dp[e];
      }
      __syncthreads();  // ds is in xch
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = xch[e * tc::kThreads + tid];
      }
    }

    // dv += p^T dO and dk += ds^T q: p^T and ds^T rounded to T, this
    // warpgroup's columns of dO and q as MN-major Bs
    uint32_t pa[4][4], da[4][4];
    tc::pack_a<T>(s, pa);
    tc::pack_a<T>(dp, da);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_rs<T, NO>(dv_acc, pa[kk],
                        tc::desc_mn_major<DP>(doa + half, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_rs<T, NO>(dk_acc, da[kk],
                        tc::desc_mn_major<DP>(qa + half, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(dv_acc);
    tc::fence_acc(dk_acc);
    __syncthreads();  // this stage (and xch) is free for the copy after next
  }
  tc::cp_async_wait<0>();

  // both warpgroups hold rows k0.. (store_acc counts warps across the block)
  tc::store_acc<T, NO>(dk, dk_acc, k0 - wg * tc::kTile, tkv, h, head, d,
                       wg * NO);
  tc::store_acc<T, NO>(dv, dv_acc, k0 - wg * tc::kTile, tkv, h, head, d,
                       wg * NO);
}

// Six tiles, the lse and delta slices (K4), K4's exchange of p and ds
// between two warpgroups (a padded width of 256), and room to align the
// tiles.
template <int DP>
constexpr int dq_tc_smem_bytes() {
  return 6 * tc::tile_bytes<DP>() + tc::kAtomAlign;
}

// K4's warpgroups at a padded width DP.
template <int DP>
constexpr int dkv_groups() {
  return DP > 128 ? 2 : 1;
}

template <int DP>
constexpr int dkv_tc_smem_bytes() {
  return 6 * tc::tile_bytes<DP>() + 4 * tc::kTile * (int)sizeof(float) +
         (dkv_groups<DP>() == 2 ? 32 * tc::kThreads * (int)sizeof(float)
                                : 0) +
         tc::kAtomAlign;
}

// 16-byte loads need 16-byte aligned rows and a head dim of whole vectors.
template <typename T>
bool vector_ok(const void* q, const void* k, const void* v, const void* dout,
               int d, const Strides& s) {
  constexpr long long V = 16 / sizeof(T);
  const long long all[] = {s.q_sb, s.q_st, s.q_sh, s.k_sb, s.k_st, s.k_sh,
                           s.v_sb, s.v_st, s.v_sh, s.o_sb, s.o_st, s.o_sh};
  for (long long x : all)
    if (x % V) return false;
  return d % V == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
         (uintptr_t)v % 16 == 0 && (uintptr_t)dout % 16 == 0;
}

// One call of either kernel: which = 0 is K3 (out0 = dq), 1 is K4 (out0 =
// dk, out1 = dv).
struct Call {
  int which;
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;
  int b, tq, tkv, h, d;
  Strides st;
  int causal;
  long long q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

// Sets the kernel's dynamic shared memory and launches `tiles` x h x b
// blocks of `threads`, each with the call's arguments (K3 takes one output,
// K4 two).
template <typename T, typename... Params>
int launch_kernel(void (*kernel)(Params...), int bytes, long long tiles,
                  int threads, const Call& c) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, c.h, c.b);
  const int vec = vector_ok<T>(c.q, c.k, c.v, c.dout, c.d, c.st);
  const T* q = static_cast<const T*>(c.q);
  const T* k = static_cast<const T*>(c.k);
  const T* v = static_cast<const T*>(c.v);
  const T* o = static_cast<const T*>(c.dout);
  T* o0 = static_cast<T*>(c.out0);
  T* o1 = static_cast<T*>(c.out1);
  if constexpr (sizeof...(Params) == 17)  // K3
    kernel<<<grid, threads, bytes, c.stream>>>(
        q, k, v, o, c.lse, c.delta, o0, c.tq, c.tkv, c.h, c.d, c.st,
        c.causal, c.q_offset, c.k_offset, c.scale, vec);
  else  // K4
    kernel<<<grid, threads, bytes, c.stream>>>(
        q, k, v, o, c.lse, c.delta, o0, o1, c.tq, c.tkv, c.h, c.d, c.st,
        c.causal, c.q_offset, c.k_offset, c.scale, vec);
  return (int)cudaGetLastError();
}

// The CUDA-core kernels: DP the padded head dim, or with kChunked the chunk
// width, a grid axis of output chunks folded into x.
template <typename T, int DP, bool kChunked>
int launch_simt(const Call& c) {
  const long long n_oc = kChunked ? (c.d + DP - 1) / DP : 1;
  const long long tiles =
      ((c.which ? c.tkv : c.tq) + kBlockQ - 1) / kBlockQ * n_oc;
  if (c.which == 0)
    return launch_kernel<T>(flash_bwd_dq_kernel<T, DP, kChunked>,
                            dq_smem_bytes<DP>(), tiles, kThreads, c);
  return launch_kernel<T>(flash_bwd_dkv_kernel<T, DP, kChunked>,
                          dkv_smem_bytes<DP>(), tiles, kThreads, c);
}

// The tensor-core kernels, one 64-row tile a block.
template <typename T, int DP>
int launch_tc(const Call& c) {
  static_assert(kBlockQ == tc::kTile && kBlockK == tc::kTile, "tile rows");
  if (c.which == 0)
    return launch_kernel<T>(flash_bwd_dq_tc_kernel<T, DP>,
                            dq_tc_smem_bytes<DP>(),
                            (c.tq + tc::kTile - 1) / tc::kTile, tc::kThreads,
                            c);
  return launch_kernel<T>(
      flash_bwd_dkv_tc_kernel<T, DP, dkv_groups<DP>()>,
      dkv_tc_smem_bytes<DP>(), (c.tkv + tc::kTile - 1) / tc::kTile,
      dkv_groups<DP>() * tc::kThreads, c);
}

// f32 on the CUDA cores up to 128, f16 and bf16 on the tensor cores up to
// 256; past those, every dtype in head-dim chunks on the CUDA cores.
template <typename T>
int dispatch_d(const Call& c) {
  if constexpr (std::is_same<T, float>::value) {
    if (c.d <= 16) return launch_simt<T, 16, false>(c);
    if (c.d <= 32) return launch_simt<T, 32, false>(c);
    if (c.d <= 64) return launch_simt<T, 64, false>(c);
    if (c.d <= 128) return launch_simt<T, 128, false>(c);
  } else {
    if (c.d <= 16) return launch_tc<T, 16>(c);
    if (c.d <= 32) return launch_tc<T, 32>(c);
    if (c.d <= 64) return launch_tc<T, 64>(c);
    if (c.d <= 128) return launch_tc<T, 128>(c);
    if (c.d <= 256) return launch_tc<T, 256>(c);
  }
  return launch_simt<T, kChunk, true>(c);
}

int entry(const Call& c, int dtype) {
  if (c.b <= 0 || c.tq <= 0 || c.tkv <= 0 || c.h <= 0) return 0;
  if (c.d <= 0 || c.b > 65535) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch_d<float>(c);
    case 1:
      return dispatch_d<__half>(c);
    case 2:
      return dispatch_d<__nv_bfloat16>(c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  q and dO are (b, tq, h, d), k and v (b, tkv, h, d), read through
// their strides (in elements; the head dimension must be contiguous); a call
// without a batch axis passes b = 1.  dtype: 0 f32, 1 f16, 2 bf16 (q, k, v, dO
// and the gradients alike).  lse and delta are contiguous f32 (b, h, tq); the
// gradients are written into contiguous (b, t, h, d) tensors.

// K3: dq.
extern "C" int nns_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int tq, int tkv,
    int h, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, long long q_offset, long long k_offset,
    float scale, int dtype, void* stream) {
  const Call c{0, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, b, tq, tkv, h,
               d, Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                          v_sh, o_sb, o_st, o_sh},
               causal, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return entry(c, dtype);
}

// K4: dk and dv.
extern "C" int nns_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int tq,
    int tkv, int h, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, long long q_offset, long long k_offset,
    float scale, int dtype, void* stream) {
  const Call c{1, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, b, tq, tkv, h, d,
               Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                       o_sb, o_st, o_sh},
               causal, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return entry(c, dtype);
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
