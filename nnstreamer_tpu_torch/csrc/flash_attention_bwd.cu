// Flash-attention backward: dq, dk and dv without a (Tq, Tkv) matrix in memory.
//
// Replaces the two Pallas TPU kernels of nnstreamer_tpu/ops/flash_attention.py
// launched by _flash_backward: _bwd_dq_kernel (body at :331-370, launched at
// :466) and _bwd_dkv_kernel (:373-418, launched at :481).  Both recompute each
// tile of probabilities from the forward's saved logsumexp, as _recompute_p
// (:311-328) does:
//
//   s[i, j]  = (q[i] . k[j]) / sqrt(D), masked where the key lies past the end
//              of k, or (causal) where k_offset + j > q_offset + i;
//   p[i, j]  = exp(s[i, j] - lse[i]), exactly 0 where masked and in rows with
//              lse = -inf (rows that saw no key, and rows past the end of q);
//   ds[i, j] = p[i, j] (dO[i] . v[j] - delta[i]) / sqrt(D),
//
// where delta = rowsum(dO * O) (less the lse cotangent) comes from the caller,
// once over the full head dim.  The dq kernel (K3) sums dq[i] = sum_j ds[i, j]
// k[j]; the dk/dv kernel (K4) sums dv[j] = sum_i p[i, j] dO[i] and dk[j] =
// sum_i ds[i, j] q[i].  All sums are in f32; the results are cast once to the
// inputs' type.
//
// On the TPU each kernel walks its inner axis as a sequential grid dimension
// with VMEM scratch.  Here blocks run in parallel and in no order, so:
//
// - K3 has one block of 128 threads (one warpgroup, two in K4 at a padded 256)
//   per (64-query tile, head, batch element, and piece of the output columns
//   where there are pieces) and loops over key tiles; K4 one per 64-key tile,
//   looping over query tiles.  Each block owns its output rows and columns
//   outright: no atomics, so the result does not depend on the order blocks
//   run in;
// - under `causal`, K3 never loads key tiles wholly in the future of its query
//   tile and issues the longest query tiles first; K4 skips query tiles wholly
//   in the past of its key tile (the first key tiles, which see the most
//   query tiles, are issued first anyway).  A block that sees no (query, key)
//   pair (the sp=2 ring's future block) loads no tile and writes zeros;
// - inputs are read in place through their (batch, row, head) strides and the
//   ragged tails are masked by bounds, as in the forward (flash_attention.cu).
//
// What bounds it: per visible (query, key) pair K3 does 6 D operations
// (q.k, dO.v, ds.k) and K4 8 D (q.k, dO.v, p.dO, ds.q), so at the LM's
// 2048-token causal layer both are bound by operations, and at ViT's
// 197-token layers by bytes.  Every dtype at every head dim runs on the
// tensor cores (flash_wgmma.cuh), in one of two pairs of kernels:
//
// f16 and bf16 up to a padded 256: flash_bwd_dq_tc_kernel and
// flash_bwd_dkv_tc_kernel.  One warpgroup of 128
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
// next tile's copy is in flight while this one computes.  Inputs whose rows
// or head dim are not 16-byte aligned (D = 6, say) cannot be copied 16 bytes
// at a time: a scalar loader fills the same layout, synchronously.  Masks
// cost a compare per score only in tiles the mask cuts (the causal diagonal,
// ragged ends); rows or columns with lse = -inf take lse = +inf, so exp2
// gives them p = 0 exactly.
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
// A padded width of 256 (a wide-head LM's D = 256) stays on the same
// kernels, 6 tiles of 32 KB (one block an SM); registers are what it costs:
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
// f32 at every head dim, and f16 and bf16 past 256:
// flash_bwd_dq_tc_piece_kernel and flash_bwd_dkv_tc_piece_kernel, built as
// K2's piece kernel (flash_attention.cu) is.  Two things bound these on
// this card.
//
// - The tensor cores take f32 only as TF32 (10 mantissa bits).  Each of the
//   five f32 products (s = q k^T and dp = dO v^T, in K4 their transposes;
//   dq += ds k; dv += p^T dO and dk += ds^T q) is three TF32 products,
//   a_hi b_hi + a_hi b_lo + a_lo b_hi, with hi the operand cut to TF32 and
//   lo the rest (tf32_hi, tf32_lo): they miss a b by ~2^-20 of |a b|, the
//   order of an f32 rounding, where one TF32 product misses the f32
//   tolerance (tests/test_torch_flash_tf32.py emulates both on the CPU
//   against the JAX package).  The ceiling is 495 / 3 = 165 TFLOP/s, 2.5
//   times the CUDA cores' 67.  wgmma reads 32-bit operands from shared
//   memory only K-major.  The score products are K-major as the tiles lie
//   (K is the head dim); the output products sum over keys (K3) or queries
//   (K4), so their B (K3: k; K4: dO and q) lands in shared memory a second
//   time, transposed (load_f32_transposed), in the order in which a
//   thread of the score accumulator holds its columns as the TF32 A: p and
//   ds are split into hi and lo in registers, without a shuffle.
// - Past the widths (f32 past 64, f16 and bf16 past 256) the output
//   accumulators outgrow the registers: at D = 320 in bf16, dq alone is 160
//   f32 a thread and dk + dv 320.  So the output columns go in pieces, a
//   piece a block (a grid axis), and each block takes s and dp itself over
//   the whole head dim: the score work is the number of pieces, 3 at D =
//   320 (pieces of 128), where the CUDA-core route took it 5 times (once
//   per 64 output columns).  Two warpgroups of one block trading p and ds
//   through shared memory (K4's design at 256) would take the scores once,
//   but each would wait on the other's half of the softmax, and a block
//   would need both pieces' output tiles; with a block a piece, blocks of
//   80-96 KB (f16, bf16) share an SM and overlap each other.
//
// The design, for both:
//
// - one warpgroup a block owns 64 rows (K3: queries, K4: keys) and DO output
//   columns: in f32 the padded head dim up to 64, else 128; in f16 and bf16
//   128 (D = 320: three pieces).  At 128 columns K4 holds dk and dv (128 f32
//   a thread) and s and dp beside them, as the 16-bit K4 at a padded 128;
//   256 columns would not fit;
// - NS streamed rows a stage (K3: keys, K4: queries): 64 in f16 and bf16; 32
//   in f32, where each streamed tile is in shared memory twice (a chunk
//   K-major, the piece transposed), as hi and lo.  Shared memory at D = 64
//   in f32: K3 112 KB (q and dO 32 KB each as hi and lo; k, v and k^T 16
//   KB each: two blocks an SM); K4 128 KB (k and v 32 KB each; q, dO, q^T
//   and dO^T 16 KB each: one block); 64 queries a stage would take K4 to
//   192 KB.  Past the widths: f32 K3 128 KB, K4 160 KB; f16 and bf16 K3 80
//   KB, K4 96 KB;
// - s and dp run over the head dim in chunks of 256 bytes (8 k steps) a
//   commit, both operands from shared memory: each chunk step loads the
//   owned rows' chunk and the stage's.  Where the head dim is one chunk (f32
//   up to 64) the owned rows are loaded once; past that it is padded with
//   zeros to whole chunks (f16 and bf16: D = 320 to 384, 20 % more score
//   work), so that no chunk ends early (see chunk_scores), and shared
//   memory does not grow with D;
// - the output products take p and ds from registers: in f32 split into hi
//   and lo (the A of k steps of 8), in f16 and bf16 rounded to T (k steps of
//   16) and read against the piece's 64 x 128 tile MN-major;
// - where the head dim is one chunk (f32 up to 64: the sp=2 ring, ViT in
//   f32), the stage's streamed rows go through registers a stage ahead
//   (StageRows): their loads are in flight while the last stage computes,
//   and one load fills both the K-major and the transposed tile.  Past one
//   chunk, copies are synchronous, as in K2's piece kernel: each thread
//   loads its part of a tile (f32 into registers, split, stored; f16 and
//   bf16 by cp.async, waited at once), and the products wait for it; the
//   blocks on an SM overlap each other's copies;
// - registers: worked out from threadIdx.x, the f32 loaders' addresses are
//   hoisted out of the stage loop and held across it, and at 128 columns
//   the kernels spill; they take the thread's index from tc::thread_index,
//   read anew at each load.  Every specialisation's registers and spills:
//   chip_smoke.py's build line (no piece kernel may spill);
// - a block that sees no (query, key) pair (under `causal`, the sp=2 ring's
//   future block) writes its zeros with 16-byte stores and returns before
//   it loads anything.

#include <type_traits>

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

// ---------------------------------------------------------------------------
// f16 and bf16 up to a padded 256: the tensor-core kernels
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

// ---------------------------------------------------------------------------
// f32 at every head dim, f16 and bf16 past 256: a piece of the output
// columns a block
// ---------------------------------------------------------------------------

// Shared memory of the piece kernels, f32 tiles as hi then lo: the two
// owned tiles (K3: q, dO; K4: k, v), 64 rows of one 256-byte chunk of the
// head dim (of the padded head dim DPS where that is known and narrower);
// the two streamed tiles (K3: k, v; K4: q, dO), NS rows of the same chunk;
// kX tiles of the streamed rows' piece of output columns for the output
// products (K3: k; K4: q, dO), in f32 transposed (DO rows of NS words), in
// f16 and bf16 64 x DO read MN-major; K4's lse and delta slices; and room
// to align the tiles.
template <typename T, int DO, int NS, int DPS, int kX>
struct PieceTiles {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kParts = kF32 ? 2 : 1;
  // bytes of a tile's row: a chunk, or one 128-byte swizzle block where
  // the padded head dim fits in it
  static constexpr int kRowBytes =
      DPS == 0 || DPS * (int)sizeof(T) > 128 ? 256 : 128;
  static constexpr int kOwnBytes = tc::kTile * kRowBytes;
  static constexpr int kStreamBytes = NS * kRowBytes;
  static constexpr int kXBytes = kF32 ? DO * NS * 4 : tc::tile_bytes<DO>();
  static constexpr int kSliceBytes = kX == 2 ? 2 * NS * (int)sizeof(float) : 0;
  static constexpr int kBytes =
      kParts * (2 * kOwnBytes + 2 * kStreamBytes + kX * kXBytes) +
      kSliceBytes + tc::kAtomAlign;
  static_assert(kF32 || NS == tc::kTile, "16-bit tiles hold 64 rows");
};

// k steps (32 bytes each) of a chunk: 8, or those of the padded head dim
// DPS where it is narrower than a chunk (f32 up to 32).
template <typename T, int DPS>
__host__ __device__ constexpr int chunk_steps() {
  return DPS && DPS * (int)sizeof(T) < 256 ? DPS * (int)sizeof(T) / 32 : 8;
}

// s (+)= a b^T over the KS k steps of chunk c, for the three (f32: TF32,
// hi and lo descriptors) or one product a k step: a the owned tile, 64
// rows; b the streamed one, NS rows.  Not committed.  Every chunk has its
// KS k steps (the head dim is padded to whole chunks with zeros): a chunk
// that ended early would leave the accumulators two paths, and ptxas
// serialises products whose accumulators a non-wgmma instruction defines.
template <typename T, int NS, int KS>
__device__ __forceinline__ void chunk_scores(float (&s)[NS / 2], uint64_t ad,
                                             uint64_t ald, uint64_t bd,
                                             uint64_t bld, int c) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int add = c + kk;  // 0: the first product overwrites s
    const uint32_t ao = tc::SwzRows<tc::kTile>::step(kk);
    const uint32_t bo = tc::SwzRows<NS>::step(kk);
    if constexpr (std::is_same<T, float>::value) {
      const uint64_t ah = tc::desc_shift(ad, ao), bh = tc::desc_shift(bd, bo);
      tc::mma_ss_tf32<NS>(s, ah, bh, add);
      tc::mma_ss_tf32<NS>(s, ah, tc::desc_shift(bld, bo), 1);
      tc::mma_ss_tf32<NS>(s, tc::desc_shift(ald, ao), bh, 1);
    } else {
      tc::mma_ss<T, NS>(s, tc::desc_shift(ad, ao), tc::desc_shift(bd, bo),
                        add);
    }
  }
}

// A score tile x (64 x NS, an accumulator) as the A of an output product:
// in f32 hi and lo, k steps of 8 rows, whose k columns l % 4 and l % 4 + 4
// of step t hold this thread's columns 8 t + col and + 1 (the transposed
// B's rows are in that order); in f16 and bf16 rounded to T, k steps of 16.
template <typename T, int NS>
struct OutA {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kSteps = kF32 ? NS / 8 : NS / 16;
  uint32_t hi[kSteps][4], lo[kF32 ? kSteps : 1][4];

  __device__ __forceinline__ explicit OutA(const float (&x)[NS / 2]) {
    if constexpr (kF32) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t u =
              __float_as_uint(x[4 * t + ((i & 1) << 1) + (i >> 1)]);
          hi[t][i] = tc::tf32_hi(u);
          lo[t][i] = tc::tf32_lo(u);
        }
    } else {
      tc::pack_a<T>(x, hi);
    }
  }
};

// acc += x b over the NS streamed rows, x from registers (OutA), b the
// streamed rows' piece of output columns: in f32 three TF32 products a k
// step (xd / xld the transposed tile's hi and lo), in f16 and bf16 one
// against the MN-major tile.  Issued, not committed; the A's registers
// must hold until the wait.
template <typename T, int DO, int NS>
__device__ __forceinline__ void issue_out(float (&acc)[DO / 2],
                                          const OutA<T, NS>& a, uint64_t xd,
                                          uint64_t xld) {
#pragma unroll
  for (int t = 0; t < OutA<T, NS>::kSteps; ++t) {
    if constexpr (OutA<T, NS>::kF32) {
      const uint32_t at = tc::SwzRows<DO>::step(t);
      tc::mma_rs_tf32<DO>(acc, a.hi[t], tc::desc_shift(xd, at), 1);
      tc::mma_rs_tf32<DO>(acc, a.hi[t], tc::desc_shift(xld, at), 1);
      tc::mma_rs_tf32<DO>(acc, a.lo[t], tc::desc_shift(xd, at), 1);
    } else {
      tc::mma_rs<T, DO>(acc, a.hi[t],
                        tc::desc_shift(xd, tc::mn_step_bytes<DO>(t)), 1);
    }
  }
}

// The streamed rows [r0, r0 + NS) of one head, output columns [c0, c0 +
// DO), as the B of an output product: f32 transposed, hi then lo; f16 and
// bf16 a 64-row tile read MN-major (cp.async, in flight on return).
template <typename T, int DO, int NS>
__device__ __forceinline__ void load_out_piece(char* tile, int lo,
                                               const T* __restrict__ src,
                                               long long stride, int r0,
                                               int n_rows, int c0, int d,
                                               bool vec) {
  if constexpr (std::is_same<T, float>::value)
    tc::load_f32_transposed<DO, NS>(tile, lo, src, stride, r0, n_rows, c0, d,
                                    vec, tc::thread_index());
  else
    tc::load_tile<T, DO>(tile, src + c0, stride, r0, n_rows, d - c0, vec);
}

// Descriptors of a piece tile (hi; lo, f32 only) as the B of an output
// product.
template <typename T, int DO>
__device__ __forceinline__ void out_desc(const char* tile, int lo,
                                         uint64_t& d, uint64_t& dl) {
  if constexpr (std::is_same<T, float>::value) {
    d = tc::SwzRows<DO>::desc(tile);
    dl = tc::SwzRows<DO>::desc(tile + lo);
  } else {
    d = tc::desc_mn_major<DO>(tc::smem_u32(tile), 0);
    dl = 0;
  }
}

// A stage's NS streamed rows of one head in registers, f32 with the padded
// head dim DO in one chunk (up to 64): each thread's 16-byte pieces as
// load_f32_transposed takes them (tc::transposed_piece), so that one load
// fills both the K-major chunk tile of the scores and the transposed tile
// of an output product, each store free of bank conflicts.  Loaded a stage
// ahead and stored when the stage begins: the global loads are in flight
// while the last stage computes.
template <int DO, int NS>
struct StageRows {
  static constexpr int kN = NS * DO / 4 / tc::kThreads;  // pieces a thread
  static_assert(kN >= 1 && DO * 4 <= 256, "one chunk, whole pieces");
  uint4 x[kN];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       long long stride, int r0, int n_rows,
                                       int d, bool vec) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      int u, cg;
      tc::transposed_piece<NS>(tc::thread_index() + tc::kThreads * i, u, cg);
      x[i] = tc::load_f32x4(src + (long long)(r0 + u) * stride, 4 * cg, d,
                            r0 + u < n_rows, vec);
    }
  }

  // Into the K-major SwzRows<NS> tile at `km` (lo `lo` bytes on) and,
  // unless `tr` is null, the transposed SwzRows<DO> tile at `tr` (lo `tlo`
  // bytes on), each as hi and lo.
  __device__ __forceinline__ void store(char* km, int lo, char* tr,
                                        int tlo) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      int u, cg;
      tc::transposed_piece<NS>(tc::thread_index() + tc::kThreads * i, u, cg);
      tc::store_split(km + tc::SwzRows<NS>::chunk(u, cg), lo, x[i]);
      if (tr != nullptr) tc::store_transposed<DO>(tr, tlo, u, cg, x[i]);
    }
  }
};

// Zeros into rows [row0, row0 + 64) (those below n_rows) and columns [c0,
// c0 + DO) (those below d) of one head of a contiguous (T, H, D) output,
// from a block that sees no (query, key) pair: 16-byte stores where d is
// whole vectors (the output's rows are then 16-byte aligned).
template <typename T, int DO>
__device__ __forceinline__ void store_zeros(T* __restrict__ out, int row0,
                                            int n_rows, int h, int head,
                                            int d, int c0) {
  constexpr int V = 16 / (int)sizeof(T);  // elements of a 16-byte store
  static_assert(DO % V == 0, "whole vectors a row");
  const bool vec = d % V == 0;
  for (int i = threadIdx.x; i < tc::kTile * DO / V; i += tc::kThreads) {
    const int r = row0 + i / (DO / V), col = c0 + i % (DO / V) * V;
    if (r >= n_rows || col >= d) continue;
    T* p = out + ((long long)r * h + head) * d + col;
    if (vec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int e = 0; e < V && col + e < d; ++e) p[e] = from_f32<T>(0.f);
    }
  }
}

// K3 on the tensor cores for f32 at every head dim (each product as three
// TF32 products) and for f16 and bf16 past a padded 256: one warpgroup per
// (64 query rows, piece of DO dq columns, head, batch element), NS keys a
// stage; the grid's x is the query tile (under `causal` the longest first)
// times the piece.  A block takes s and dp over the whole head dim, a
// 256-byte chunk at a time: the chunk of q and dO (loaded once where the
// head dim is one chunk) and of the stage's k and v; then dq += ds k
// against k's piece of columns.
template <typename T, int DO, int NS, int DPS>
__global__ void __launch_bounds__(tc::kThreads, 2)
flash_bwd_dq_tc_piece_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int tq, int tkv, int h, int d,
                             Strides st, int causal, long long q_offset,
                             long long k_offset, float scale, int vec) {
  using Tiles = PieceTiles<T, DO, NS, DPS, 1>;
  constexpr bool kF32 = Tiles::kF32;
  constexpr int kChunk = 256 / (int)sizeof(T);  // elements of a chunk
  constexpr int KS = chunk_steps<T, DPS>();
  // f32 with the head dim in one chunk and one piece (DO = DPS)
  constexpr bool kAhead = kF32 && DPS > 0;
  constexpr int OB = Tiles::kOwnBytes, SB = Tiles::kStreamBytes;
  constexpr int XB = Tiles::kXBytes;
  extern __shared__ __align__(1024) char smem_pc[];
  char* qs = tc::align_atoms(smem_pc);  // each tile hi, then lo (f32)
  char* dos = qs + Tiles::kParts * OB;
  char* ks = dos + Tiles::kParts * OB;
  char* vs = ks + Tiles::kParts * SB;
  char* xs = vs + Tiles::kParts * SB;  // k's piece of the dq columns

  // the head dim in chunks: one (DPS), or padded to whole chunks
  const int n_chunks = DPS ? 1 : (d + kChunk - 1) / kChunk;
  const int dp = DPS ? DPS : n_chunks * kChunk;
  const int pieces = (d + DO - 1) / DO;
  const int rank = (int)blockIdx.x / pieces;
  const int c0 = ((int)blockIdx.x - rank * pieces) * DO;  // first column
  const int n_qtiles = (tq + tc::kTile - 1) / tc::kTile;
  const int q0 = (causal ? n_qtiles - 1 - rank : rank) * tc::kTile;
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

  // stages of keys that some row of the tile sees; none: zeros, no load
  const int n = (tc::last_visible_key(min(q0 + tc::kTile, tq) - 1, tkv,
                                      causal, q_offset, k_offset) +
                 NS) /
                NS;
  if (n == 0) {
    store_zeros<T, DO>(dq, q0, tq, h, head, d, c0);
    return;
  }

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
  const uint64_t qd = tc::SwzRows<tc::kTile>::desc(qs);
  const uint64_t qld = tc::SwzRows<tc::kTile>::desc(qs + OB);
  const uint64_t dod = tc::SwzRows<tc::kTile>::desc(dos);
  const uint64_t dold = tc::SwzRows<tc::kTile>::desc(dos + OB);
  const uint64_t kd = tc::SwzRows<NS>::desc(ks);
  const uint64_t kld = tc::SwzRows<NS>::desc(ks + SB);
  const uint64_t vd = tc::SwzRows<NS>::desc(vs);
  const uint64_t vld = tc::SwzRows<NS>::desc(vs + SB);
  uint64_t xd, xld;
  out_desc<T, DO>(xs, XB, xd, xld);

  float acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc[i] = 0.f;
  // f32 in one chunk: the stage's k and v rows, loaded a stage ahead
  StageRows<kAhead ? DO : 64, NS> kr, vr;
  if constexpr (kAhead) {
    if (n > 0) {
      kr.load(k, st.k_st, 0, tkv, d, vec);
      vr.load(v, st.v_st, 0, tkv, d, vec);
    }
  }

  for (int j = 0; j < n; ++j) {
    const int k0 = j * NS;
    // s = q k^T and dp = dO v^T over the head dim, 8 k steps a chunk
    float s[NS / 2], ds[NS / 2];
    if constexpr (!kAhead) {
      // k's piece for dq += ds k, before the chunks (loaded inside the
      // chunk loop at its first chunk, the f32 kernel at 128 columns
      // spills)
      __syncthreads();  // the last stage's products are done with the tile
      load_out_piece<T, DO, NS>(xs, XB, k, st.k_st, k0, tkv, c0, d, vec);
    }
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // the last products are done with the tiles
      if (n_chunks > 1 || j == 0) {
        tc::load_chunk<T, tc::kTile>(qs, OB, q, st.q_st, q0, tq, c, dp, d,
                                     vec, tc::thread_index());
        tc::load_chunk<T, tc::kTile>(dos, OB, dout, st.o_st, q0, tq, c, dp,
                                     d, vec, tc::thread_index());
      }
      if constexpr (kAhead) {
        kr.store(ks, SB, xs, XB);
        vr.store(vs, SB, nullptr, 0);
      } else {
        tc::load_chunk<T, NS>(ks, SB, k, st.k_st, k0, tkv, c, dp, d, vec,
                              tc::thread_index());
        tc::load_chunk<T, NS>(vs, SB, v, st.v_st, k0, tkv, c, dp, d, vec,
                              tc::thread_index());
      }
      if constexpr (!kF32) {
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      tc::fence_async_shared();
      __syncthreads();
      if constexpr (kAhead) {
        if (j + 1 < n) {  // in flight while this stage computes
          kr.load(k, st.k_st, k0 + NS, tkv, d, vec);
          vr.load(v, st.v_st, k0 + NS, tkv, d, vec);
        }
      }
      tc::wgmma_fence();
      chunk_scores<T, NS, KS>(s, qd, qld, kd, kld, c);
      chunk_scores<T, NS, KS>(ds, dod, dold, vd, vld, c);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(s);
      tc::fence_acc(ds);
    }
    // p = exp(s - lse), masked; ds = p (dp - delta) / sqrt(D), into ds
    if (k0 + NS - 1 > tile_last) {  // a tile the mask cuts
#pragma unroll
      for (int jj = 0; jj < NS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = k0 + 8 * jj + col + (e & 1);
          s[4 * jj + e] =
              kl > last_key[e >> 1]
                  ? 0.f
                  : exp2f(s[4 * jj + e] * scale2 - lse2[e >> 1]);
        }
    } else {
#pragma unroll
      for (int e = 0; e < NS / 2; ++e)
        s[e] = exp2f(s[e] * scale2 - lse2[(e >> 1) & 1]);
    }
#pragma unroll
    for (int e = 0; e < NS / 2; ++e)
      ds[e] = s[e] * (ds[e] - dlt[(e >> 1) & 1]) * scale;
    // dq += ds k
    const OutA<T, NS> a(ds);
    tc::wgmma_fence();
    issue_out<T, DO, NS>(acc, a, xd, xld);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(acc);
  }

  tc::store_acc<T, DO>(dq, acc, q0, tq, h, head, d, c0);
}

// K4 on the tensor cores for f32 at every head dim and for f16 and bf16
// past a padded 256: one warpgroup per (64 keys, piece of DO dk and dv
// columns, head, batch element), NS queries a stage, the stage's rows past
// the key tile's causal start only.  s^T = k q^T and dp^T = v dO^T run over
// the head dim a chunk at a time, as K3's scores; then dv += p^T dO and dk
// += ds^T q against the stage's pieces of dO and q.
template <typename T, int DO, int NS, int DPS>
__global__ void __launch_bounds__(tc::kThreads, 2)
flash_bwd_dkv_tc_piece_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int tq,
                              int tkv, int h, int d, Strides st, int causal,
                              long long q_offset, long long k_offset,
                              float scale, int vec) {
  using Tiles = PieceTiles<T, DO, NS, DPS, 2>;
  constexpr bool kF32 = Tiles::kF32;
  constexpr int kChunk = 256 / (int)sizeof(T);  // elements of a chunk
  constexpr int KS = chunk_steps<T, DPS>();
  // f32 with the head dim in one chunk and one piece (DO = DPS)
  constexpr bool kAhead = kF32 && DPS > 0;
  constexpr int OB = Tiles::kOwnBytes, SB = Tiles::kStreamBytes;
  constexpr int XB = Tiles::kXBytes;
  extern __shared__ __align__(1024) char smem_pc[];
  char* ks = tc::align_atoms(smem_pc);  // each tile hi, then lo (f32)
  char* vs = ks + Tiles::kParts * OB;
  char* qs = vs + Tiles::kParts * OB;
  char* dos = qs + Tiles::kParts * SB;
  char* xq = dos + Tiles::kParts * SB;  // q's piece of the dk columns
  char* xdo = xq + Tiles::kParts * XB;  // dO's piece of the dv columns
  float* lse_s = reinterpret_cast<float*>(xdo + Tiles::kParts * XB);
  float* delta_s = lse_s + NS;

  // the head dim in chunks: one (DPS), or padded to whole chunks
  const int n_chunks = DPS ? 1 : (d + kChunk - 1) / kChunk;
  const int dp = DPS ? DPS : n_chunks * kChunk;
  const int pieces = (d + DO - 1) / DO;
  const int kt = (int)blockIdx.x / pieces;
  const int c0 = ((int)blockIdx.x - kt * pieces) * DO;  // first column
  const int k0 = kt * tc::kTile;
  const int head = blockIdx.y;
  const long long bat = blockIdx.z;
  const int tid = threadIdx.x;
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

  // causal: query rows before this key tile's first key see none of it;
  // none at all: zeros, no load
  int q_start = 0;
  if (causal) {
    const long long first = k_offset + k0 - q_offset;
    q_start = first <= 0 ? 0
            : first >= tq ? tq
                          : (int)(first / NS) * NS;
  }
  const int n = (tq - q_start + NS - 1) / NS;
  if (n == 0) {
    store_zeros<T, DO>(dk, k0, tkv, h, head, d, c0);
    store_zeros<T, DO>(dv, k0, tkv, h, head, d, c0);
    return;
  }
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

  const uint64_t kd = tc::SwzRows<tc::kTile>::desc(ks);
  const uint64_t kld = tc::SwzRows<tc::kTile>::desc(ks + OB);
  const uint64_t vd = tc::SwzRows<tc::kTile>::desc(vs);
  const uint64_t vld = tc::SwzRows<tc::kTile>::desc(vs + OB);
  const uint64_t qd = tc::SwzRows<NS>::desc(qs);
  const uint64_t qld = tc::SwzRows<NS>::desc(qs + SB);
  const uint64_t dod = tc::SwzRows<NS>::desc(dos);
  const uint64_t dold = tc::SwzRows<NS>::desc(dos + SB);
  uint64_t xqd, xqld, xdod, xdold;
  out_desc<T, DO>(xq, XB, xqd, xqld);
  out_desc<T, DO>(xdo, XB, xdod, xdold);

  float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // lse[q0 + t] for thread t < NS, delta[q0 + t - NS] for t < 2 NS; zeros
  // past the end of q, whose columns the mask drops
  auto slice = [&](int q0) {
    const int r = q0 + tid % NS;
    return tid < 2 * NS && r < tq ? (tid < NS ? lse : delta)[r] : 0.f;
  };
  // f32 in one chunk: the stage's q and dO rows and slices, loaded a stage
  // ahead
  StageRows<kAhead ? DO : 64, NS> qr, dor;
  float sl = 0.f;
  if constexpr (kAhead) {
    if (n > 0) {
      qr.load(q, st.q_st, q_start, tq, d, vec);
      dor.load(dout, st.o_st, q_start, tq, d, vec);
      sl = slice(q_start);
    }
  }

  for (int it = 0; it < n; ++it) {
    const int q0 = q_start + it * NS;
    // s^T = k q^T and dp^T = v dO^T over the head dim, 8 k steps a chunk
    float s[NS / 2], ds[NS / 2];
    if constexpr (!kAhead) {
      // q's and dO's pieces for dk and dv, and the lse and delta slices,
      // before the chunks (as in K3)
      __syncthreads();  // the last stage's products are done with them
      load_out_piece<T, DO, NS>(xq, XB, q, st.q_st, q0, tq, c0, d, vec);
      load_out_piece<T, DO, NS>(xdo, XB, dout, st.o_st, q0, tq, c0, d, vec);
      if (tid < 2 * NS) lse_s[tid] = slice(q0);
    }
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // the last products are done with the tiles
      if (n_chunks > 1 || it == 0) {
        tc::load_chunk<T, tc::kTile>(ks, OB, k, st.k_st, k0, tkv, c, dp, d,
                                     vec, tc::thread_index());
        tc::load_chunk<T, tc::kTile>(vs, OB, v, st.v_st, k0, tkv, c, dp, d,
                                     vec, tc::thread_index());
      }
      if constexpr (kAhead) {
        qr.store(qs, SB, xq, XB);
        dor.store(dos, SB, xdo, XB);
        if (tid < 2 * NS) lse_s[tid] = sl;
      } else {
        tc::load_chunk<T, NS>(qs, SB, q, st.q_st, q0, tq, c, dp, d, vec,
                              tc::thread_index());
        tc::load_chunk<T, NS>(dos, SB, dout, st.o_st, q0, tq, c, dp, d, vec,
                              tc::thread_index());
      }
      if constexpr (!kF32) {
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      tc::fence_async_shared();
      __syncthreads();
      if constexpr (kAhead) {
        if (it + 1 < n) {  // in flight while this stage computes
          qr.load(q, st.q_st, q0 + NS, tq, d, vec);
          dor.load(dout, st.o_st, q0 + NS, tq, d, vec);
          sl = slice(q0 + NS);
        }
      }
      tc::wgmma_fence();
      chunk_scores<T, NS, KS>(s, kd, kld, qd, qld, c);
      chunk_scores<T, NS, KS>(ds, vd, vld, dod, dold, c);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(s);
      tc::fence_acc(ds);
    }
    // a tile the mask cuts: keys or queries past the end, or the diagonal
    const bool cut = keys_cut || q0 + NS > tq || tile_first > q0;
    // p^T = exp(s^T - lse), masked (rows are keys, columns queries); ds^T
    // = p^T (dp^T - delta) / sqrt(D), into ds
#pragma unroll
    for (int jj = 0; jj < NS / 8; ++jj) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * jj + col);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + 8 * jj + col);
      // lse in base 2, +inf where it is -inf (queries that saw no key)
      const float l2[2] = {
          l.x == -CUDART_INF_F ? CUDART_INF_F : l.x * tc::kLog2e,
          l.y == -CUDART_INF_F ? CUDART_INF_F : l.y * tc::kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * jj + e] * scale2 - l2[e & 1]);
        if (cut) {
          const int ql = q0 + 8 * jj + col + (e & 1);
          if (ql < first_q[e >> 1] || ql >= tq) p = 0.f;
        }
        s[4 * jj + e] = p;
        ds[4 * jj + e] =
            p * (ds[4 * jj + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }
    // dv += p^T dO and dk += ds^T q.  At 128 columns dk and dv with both
    // A's beside them pass 255 registers: dv's products finish before ds
    // is split
    if constexpr (DO > 64) {
      {
        const OutA<T, NS> pa(s);
        tc::wgmma_fence();
        issue_out<T, DO, NS>(dv_acc, pa, xdod, xdold);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_acc(dv_acc);
      }
      const OutA<T, NS> da(ds);
      tc::wgmma_fence();
      issue_out<T, DO, NS>(dk_acc, da, xqd, xqld);
    } else {
      const OutA<T, NS> pa(s), da(ds);
      tc::wgmma_fence();
      issue_out<T, DO, NS>(dv_acc, pa, xdod, xdold);
      issue_out<T, DO, NS>(dk_acc, da, xqd, xqld);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(dv_acc);
    tc::fence_acc(dk_acc);
  }

  tc::store_acc<T, DO>(dk, dk_acc, k0, tkv, h, head, d, c0);
  tc::store_acc<T, DO>(dv, dv_acc, k0, tkv, h, head, d, c0);
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

// The tensor-core kernels, one 64-row tile a block.
template <typename T, int DP>
int launch_tc(const Call& c) {
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

// Asks for the SM's shared memory to go to blocks rather than to L1, so
// that two piece blocks of up to 113 KB share an SM.
template <typename Kernel>
cudaError_t prefer_shared(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The piece kernels: DO output columns a block, NS streamed rows a stage,
// DPS the padded head dim if known (else the head dim padded to a whole k
// step); a grid axis of pieces folded into x.
template <typename T, int DO, int NS, int DPS>
int launch_piece(const Call& c) {
  const long long pieces = (c.d + DO - 1) / DO;
  const long long rows = c.which ? c.tkv : c.tq;
  const long long tiles = (rows + tc::kTile - 1) / tc::kTile * pieces;
  if (c.which == 0) {
    auto kernel = flash_bwd_dq_tc_piece_kernel<T, DO, NS, DPS>;
    if (const cudaError_t err = prefer_shared(kernel)) return (int)err;
    return launch_kernel<T>(kernel, PieceTiles<T, DO, NS, DPS, 1>::kBytes,
                            tiles, tc::kThreads, c);
  }
  auto kernel = flash_bwd_dkv_tc_piece_kernel<T, DO, NS, DPS>;
  if (const cudaError_t err = prefer_shared(kernel)) return (int)err;
  return launch_kernel<T>(kernel, PieceTiles<T, DO, NS, DPS, 2>::kBytes,
                          tiles, tc::kThreads, c);
}

// f16 and bf16 up to a padded 256 in the tensor-core kernels; f32 at every
// head dim and f16 and bf16 past 256 in the piece kernels: f32 one piece of
// the padded head dim up to 64, 32 keys (K3) or queries (K4) a stage, else
// pieces of 128 columns; f16 and bf16 pieces of 128, 64 rows a stage.
template <typename T>
int dispatch_d(const Call& c) {
  if constexpr (std::is_same<T, float>::value) {
    if (c.d <= 16) return launch_piece<T, 16, 32, 16>(c);
    if (c.d <= 32) return launch_piece<T, 32, 32, 32>(c);
    if (c.d <= 64) return launch_piece<T, 64, 32, 64>(c);
    return launch_piece<T, 128, 32, 0>(c);
  } else {
    if (c.d <= 16) return launch_tc<T, 16>(c);
    if (c.d <= 32) return launch_tc<T, 32>(c);
    if (c.d <= 64) return launch_tc<T, 64>(c);
    if (c.d <= 128) return launch_tc<T, 128>(c);
    if (c.d <= 256) return launch_tc<T, 256>(c);
    return launch_piece<T, 128, 64, 0>(c);
  }
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
