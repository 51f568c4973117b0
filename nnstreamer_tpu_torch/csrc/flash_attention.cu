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
// Every dtype at every head dim runs on the tensor cores, in one of two
// kernels:
//
// f16 and bf16 up to a padded 256: flash_forward_tc_kernel (flash_wgmma.cuh,
// shared with the backward).
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

// f32 at every head dim, and f16 and bf16 past 256:
// flash_forward_tc_piece_kernel.  Two things bound these on this card.
//
// - The tensor cores take f32 only as TF32 (10 mantissa bits): with one
//   TF32 product out misses the plain version by ~2e-3 (the CPU emulation,
//   tests/test_torch_flash_tf32.py), twenty times the f32 tolerance of
//   1e-4.  So each f32 product is three: a_hi b_hi + a_hi b_lo +
//   a_lo b_hi, with hi the operand cut to TF32 and lo the rest (tf32_hi,
//   tf32_lo), which misses by ~2^-20 (lo_a lo_b), the order of an f32
//   rounding; the f32 kernel is held to the plain version within the f32
//   tolerance, not to summation order.  Its ceiling is 495 / 3 = 165
//   TFLOP/s, 2.5 times the CUDA cores' 67.  wgmma takes 32-bit operands
//   from shared memory only K-major, so v lands there transposed, through
//   registers.
// - Past 256 the p.v accumulator of one warpgroup is wgmma's widest N, 256
//   columns (128 f32 registers a thread), so out's columns go in pieces,
//   a piece a block (a grid axis).  Each block takes the scores itself over
//   the whole head dim, so the score work is the number of pieces (2 at D =
//   320, where the CUDA-core route took it five times, once per 64 output
//   columns).  Warpgroups of one block that trade p through shared memory
//   (K4's design at 256) would take the scores once, but one warpgroup
//   would wait on another's softmax, and a block would need both pieces'
//   tiles: with a block a piece, two blocks share an SM and overlap each
//   other.
//
// The design, for both:
//
// - one warpgroup a block owns 64 query rows and DO output columns: in
//   f16 and bf16 256 (D = 320: two pieces, D = 600: three); in f32 the
//   padded head dim up to 128, else 128, so f32 at 256 is two pieces and
//   takes its scores twice.  With 256 f32 columns (the accumulator, and p
//   and v^T in hi and lo) the kernel spilled 328 bytes at a padded 256 and
//   took 0.159 ms against 0.094 at (2, 512, 2, 256) (an H100 80GB HBM3 at
//   700 W, PERF.md §6);
// - s = q k^T runs over the head dim padded to a whole k step (16 columns
//   in f16 and bf16: D = 600 pads to 608; 8 in f32), both operands from
//   shared memory, in chunks of 256 bytes (8 k steps) a commit.  k goes
//   through shared memory a chunk at a time (KN keys x 256 bytes; f32 as a
//   hi and a lo tile, split on the way in).  q is loaded once, whole and
//   split, where its width is known at compile time (f32 up to 256:
//   16-128 KB), else a 64-row chunk beside each chunk of k, so shared
//   memory does not grow with D.  q's A fragments loaded from global
//   memory into registers instead cost a load's latency every 4 k steps:
//   K2 at the sp=2 ring's shape took 0.179 ms against 0.137 with q in
//   shared memory (the same card, PERF.md §6);
// - o += p v takes p from registers.  In f32, hi and lo come straight from
//   the score accumulator: its thread holds keys 8 t + col and + 1 where
//   the TF32 A wants k columns l % 4 and + 4; the product sums over keys,
//   so v^T's columns are stored in that order (key 8 t + u at column 8 t +
//   u / 2 + 4 (u % 2)) and p needs no shuffle.  f16 and bf16 round p as
//   flash_forward_tc_kernel does and read the v tile MN-major;
// - keys a stage: 64, or 32 in f32 at 128 output columns (a v^T tile of
//   128 x 64 f32 in hi and lo would take 64 KB).  Shared memory is 57-177
//   KB a block in f32, 65 KB in f16 and bf16; registers 174-248 in f32,
//   255 in f16 and bf16, no spills;
// - copies are synchronous: each thread loads its part of a tile (f32
//   into registers, split, stored; f16 and bf16 by cp.async, waited at
//   once), and the products wait for it.  A block's copies do not overlap
//   its own products; the blocks on an SM (one to three) overlap each
//   other's.  A simple kernel that is right first; a ring of stages is the
//   next step.

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
    tc::issue_scores<T, DP, NT>(s, qd, k_desc(j));
    tc::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NT; ++t) tc::fence_acc(s[t]);
    const int k0 = j * kKeys;
    tc::online_softmax(s, m2, lsum, corr, k0 + kKeys - 1 > tile_last, k0,
                       col, last_key, scale2);
#pragma unroll
    for (int t = 0; t < NT; ++t) tc::pack_a<T>(s[t], pa[t]);
    tc::rescale(acc, corr);
    tc::wgmma_fence();
    tc::issue_pv<T, DP, NT>(acc, pa, v_desc(j));
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
  tc::rescale(acc, inv);
  tc::store_acc<T, DP>(out, acc, q0, tq, h, head, d);
}

// ---------------------------------------------------------------------------
// f32 at every head dim, f16 and bf16 past 256: a piece of the output
// columns a block
// ---------------------------------------------------------------------------

// Shared memory of the piece kernel, f32 tiles as hi then lo: the k tile
// of one 256-byte chunk of the head dim (KN keys); the v tile of the block's
// output columns (f32: v^T, DO rows of KN keys; f16 and bf16: 64 keys x DO
// columns, read MN-major); the q tile, 64 rows of the whole head dim where
// it is known at compile time (DPS, f32 up to 256: at least 128 bytes a
// row) or else of one chunk; and room to align the tiles.
template <typename T, int DO, int KN, int DPS>
struct PieceTiles {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kParts = kF32 ? 2 : 1;
  static constexpr int kKBytes = KN * 256;
  static constexpr int kVBytes = kF32 ? DO * KN * 4 : tc::tile_bytes<DO>();
  static constexpr int kRowBytes = DPS * (int)sizeof(T);
  static constexpr int kQBytes =
      tc::kTile * (DPS == 0 ? 256 : kRowBytes > 128 ? kRowBytes : 128);
  static constexpr int kBytes =
      kParts * (kKBytes + kVBytes + kQBytes) + tc::kAtomAlign;
  static_assert(kF32 || KN == tc::kTile, "16-bit tiles hold 64 rows");
};

// K2 on the tensor cores for f32 at every head dim (each product as three
// TF32 products) and for f16 and bf16 past a padded 256: one warpgroup per
// (64 query rows, piece of DO output columns, head, batch element), KN keys
// a stage.  The grid is one axis, query tile outermost, then piece, head and
// batch element.  Each block takes the scores over the whole head dim, both
// operands from shared memory, in chunks of 256 bytes of columns (8 k steps):
// a chunk of k at a time, and q whole, loaded once, where DPS (the padded
// head dim, known at compile time for f32 up to 256) is not 0, else a chunk
// of q beside each chunk of k (`dp` the padded head dim).  A row's lse is
// written by the block of piece 0.
template <typename T, int DO, int KN, int DPS>
__global__ void __launch_bounds__(tc::kThreads, 2)
flash_forward_tc_piece_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ lse, int b, int tq,
                              int tkv, int h, int d, int dp, int pieces,
                              Strides st, int causal, long long q_offset,
                              long long k_offset, float scale, int vec) {
  using Tiles = PieceTiles<T, DO, KN, DPS>;
  constexpr bool kF32 = Tiles::kF32;
  constexpr int kE = 32 / (int)sizeof(T);  // elements of a k step
  extern __shared__ __align__(1024) char smem_pc[];
  char* ks = tc::align_atoms(smem_pc);  // each tile hi, then lo (f32)
  char* vs = ks + Tiles::kParts * Tiles::kKBytes;
  char* qs = vs + Tiles::kParts * Tiles::kVBytes;

  if constexpr (DPS > 0) dp = DPS;
  const int ksteps = dp / kE;
  const int n_qtiles = (tq + tc::kTile - 1) / tc::kTile;
  const int per_rank = pieces * h * b;
  const int rank = blockIdx.x / per_rank;
  int rest = blockIdx.x - rank * per_rank;
  const int piece = rest % pieces;
  rest /= pieces;
  const int head = rest % h;
  const long long bat = rest / h;
  // causal: the last query tile sees the most keys, so issue it first
  const int q0 = (causal ? n_qtiles - 1 - rank : rank) * tc::kTile;
  const int c0 = piece * DO;  // the block's first output column
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block

  q += bat * st.q_sb + head * st.q_sh;
  k += bat * st.k_sb + head * st.k_sh;
  v += bat * st.v_sb + head * st.v_sh;
  out += bat * tq * h * d;
  lse += (bat * h + head) * tq;

  // stages of keys that some row of the tile sees
  const int n = (tc::last_visible_key(min(q0 + tc::kTile, tq) - 1, tkv,
                                      causal, q_offset, k_offset) +
                 KN) /
                KN;
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
  // keys past this are masked in some row of the tile
  const int tile_last =
      tc::last_visible_key(q0, tkv, causal, q_offset, k_offset);
  const float scale2 = scale * tc::kLog2e;

  // the v tile of keys [k0, k0 + KN), output columns [c0, c0 + DO).  f32:
  // transposed, hi and lo, each key at its column of v^T
  auto load_v = [&](int k0) {
    if constexpr (kF32) {
      tc::load_f32_transposed<DO, KN>(vs, Tiles::kVBytes, v, st.v_st, k0,
                                      tkv, c0, d, vec);
    } else {
      tc::load_tile<T, DO>(vs, v + c0, st.v_st, k0, tkv, d - c0, vec);
    }
  };

  // q whole (DPS), a chunk each 16 KB further on, unless no key is seen
  // (the sp=2 ring's future block); made visible by the first stage's
  // fence and barrier
  if constexpr (DPS > 0) {
#pragma unroll
    for (int c = 0; c * 64 < DPS && n > 0; ++c)
      tc::load_chunk<T, tc::kTile>(qs + c * 2 * tc::kTile * 128,
                                   Tiles::kQBytes, q, st.q_st, q0, tq, c, dp,
                                   d, vec);
  }
  const uint64_t qd = tc::SwzRows<tc::kTile>::desc(qs);
  const uint64_t qld = tc::SwzRows<tc::kTile>::desc(qs + Tiles::kQBytes);
  const uint64_t kd = tc::SwzRows<KN>::desc(ks);
  const uint64_t kld = tc::SwzRows<KN>::desc(ks + Tiles::kKBytes);
  uint64_t vd, vld = 0;
  if constexpr (kF32) {
    vd = tc::SwzRows<DO>::desc(vs);
    vld = tc::SwzRows<DO>::desc(vs + Tiles::kVBytes);
  } else {
    vd = tc::desc_mn_major<DO>(tc::smem_u32(vs), 0);
  }

  float acc[DO / 2], s[1][KN / 2], corr[2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int k0 = j * KN;
    // s = q k^T over the head dim, a chunk of 8 k steps at a time
    for (int c = 0; 8 * c < ksteps; ++c) {
      __syncthreads();  // the last products are done with the tiles
      tc::load_chunk<T, KN>(ks, Tiles::kKBytes, k, st.k_st, k0, tkv, c, dp,
                            d, vec);
      if constexpr (DPS == 0)
        tc::load_chunk<T, tc::kTile>(qs, Tiles::kQBytes, q, st.q_st, q0, tq,
                                     c, dp, d, vec);
      if (c == 0) load_v(k0);
      if constexpr (!kF32) {
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      tc::fence_async_shared();
      __syncthreads();
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int step = 8 * c + kk;
        if (step >= ksteps) break;
        const uint32_t ak = tc::SwzRows<KN>::step(kk);
        const uint32_t aq = tc::SwzRows<tc::kTile>::step(DPS ? step : kk);
        if constexpr (kF32) {
          const uint64_t qh = tc::desc_shift(qd, aq);
          const uint64_t kh = tc::desc_shift(kd, ak);
          tc::mma_ss_tf32<KN>(s[0], qh, kh, step);
          tc::mma_ss_tf32<KN>(s[0], qh, tc::desc_shift(kld, ak), 1);
          tc::mma_ss_tf32<KN>(s[0], tc::desc_shift(qld, aq), kh, 1);
        } else {
          tc::mma_ss<T, KN>(s[0], tc::desc_shift(qd, aq),
                            tc::desc_shift(kd, ak), step);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(s[0]);
    }
    tc::online_softmax(s, m2, lsum, corr, k0 + KN - 1 > tile_last, k0, col,
                       last_key, scale2);
    // o += p v, p from registers
    if constexpr (kF32) {
      // A's k columns l % 4 and l % 4 + 4 of step t hold this thread's keys
      // 8 t + col and + 1 (v^T's columns are in that order)
      uint32_t ph[KN / 8][4], pl[KN / 8][4];
#pragma unroll
      for (int t = 0; t < KN / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t x =
              __float_as_uint(s[0][4 * t + ((i & 1) << 1) + (i >> 1)]);
          ph[t][i] = tc::tf32_hi(x);
          pl[t][i] = tc::tf32_lo(x);
        }
      tc::rescale(acc, corr);
      tc::wgmma_fence();
#pragma unroll
      for (int t = 0; t < KN / 8; ++t) {
        const uint32_t at = tc::SwzRows<DO>::step(t);
        tc::mma_rs_tf32<DO>(acc, ph[t], tc::desc_shift(vd, at), 1);
        tc::mma_rs_tf32<DO>(acc, ph[t], tc::desc_shift(vld, at), 1);
        tc::mma_rs_tf32<DO>(acc, pl[t], tc::desc_shift(vd, at), 1);
      }
      tc::wgmma_commit();
    } else {
      uint32_t pa[1][4][4];
      tc::pack_a<T>(s[0], pa[0]);
      tc::rescale(acc, corr);
      tc::wgmma_fence();
      tc::issue_pv<T, DO, 1>(acc, pa, vd);
    }
    tc::wgmma_wait<0>();
    tc::fence_acc(acc);
  }

  // out = o / max(l, 1e-20); lse = (m2 + log2 l) ln 2, -inf where l = 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-20f);
    const int r = q0 + row + 8 * i;
    if (piece == 0 && (lane & 3) == 0 && r < tq)
      lse[r] = l > 0.f ? (m2[i] + log2f(l)) * tc::kLn2 : -CUDART_INF_F;
  }
  tc::rescale(acc, inv);
  tc::store_acc<T, DO>(out, acc, q0, tq, h, head, d, c0);
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

// The piece kernel: DO output columns a block, KN keys a stage, DPS the
// padded head dim if known (else the head dim padded to a whole k step).
template <typename T, int DO, int KN, int DPS>
int launch_piece(const Args& a) {
  constexpr int bytes = PieceTiles<T, DO, KN, DPS>::kBytes;
  auto kernel = flash_forward_tc_piece_kernel<T, DO, KN, DPS>;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kE = 32 / (int)sizeof(T);
  const int dp = DPS ? DPS : (a.d + kE - 1) / kE * kE;
  const int pieces = (a.d + DO - 1) / DO;
  const long long blocks =
      (long long)((a.tq + tc::kTile - 1) / tc::kTile) * pieces * a.h * a.b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, tc::kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.b, a.tq,
      a.tkv, a.h, a.d, dp, pieces, a.st, a.causal, a.q_offset, a.k_offset,
      a.scale, (int)vector_ok<T>(a));
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

// f32 in the piece kernel (64 keys a stage up to 64 columns, 32 above;
// pieces of 128 columns past 128); f16 and bf16 up to 256 in
// flash_forward_tc_kernel, in version
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
    return launch_piece<float, DP <= 128 ? DP : 128, DP <= 64 ? 64 : 32,
                        DP>(a);
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
  // past 256, every dtype: the piece kernel, pieces of 256 output columns
  // (f32: 128), no version choice
  if (version) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value)
    return launch_piece<T, 128, 32, 0>(a);
  else
    return launch_piece<T, 256, 64, 0>(a);
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
