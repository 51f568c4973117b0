// Flash attention with an additive bias (SwinV2's window attention).
//
// The forward and the two backward kernels of flash_attention.cu and
// flash_attention_bwd.cu (K2, K3, K4) for attention whose scores carry a
// bias shared by every batch row (every window) and, optionally, a mask of
// regions:
//
//   s[b, h, i, j] = scale (q[i] . k[j]) + bias[h, i, j]
//                   - 100 where regions[b mod G, i] != regions[b mod G, j],
//
// then the softmax over j, out = p v and lse, as K2 computes them.  The
// backward recomputes p with the same bias and mask and also returns
//
//   dbias[h, i, j] = sum_b p (dp - delta)      (ds before the scale),
//
// the bias's gradient: SwinV2 learns its bias (a small MLP makes it every
// step).  -100 is SwinV2's score for two tokens from different regions of
// a cyclically shifted map; the mask is read as a label a token, so it
// costs no (T, T) read.
//
// A library of its own, built at the first biased call: a model without a
// bias builds and launches exactly the kernels it did.  f16 and bf16 at
// padded head dims 16-128 (SwinV2's is 32), up to 256 queries and keys
// (its windows hold 64 or 256 tokens), on the tensor cores with the tiles,
// loaders and products of flash_wgmma.cuh.
//
// What bounds them is the bias.  A block of 64 rows needs 64 KB of it at
// T = 256, twice the k and v tiles it reads.  Read from L2 for every window
// (each thread its 32 values a key tile in 8-byte loads while s = q k^T
// runs), the loads took 60 % of the forward's time and 37 % of the
// backward's at SwinV2-B's first stage (2,048 windows of 4 heads at batch
// 128; an H100 80GB HBM3 at 700 W).  So each block takes a group of windows of one head
// one after another, reads its rows of the bias once into shared memory
// (each thread its own accumulator elements, in its own slots, so neither a
// bank conflict nor a barrier), and folds them and the window's mask into
// the scores of every window of the group.  The grid is one axis, row tile
// innermost: the blocks of one (head, group) run together, so a window's
// tiles come from HBM once and from L2 for its other row tiles.
//
// - flash_biased_fwd_kernel: flash_forward_tc_kernel with one warpgroup a
//   block and 64 keys a stage (K2's version 2 at 64 keys a stage); bias
//   and mask go into the scaled scores before the shared online softmax
//   (tc::online_softmax, its scale then 1);
// - flash_biased_bwd_dq_kernel: flash_bwd_dq_tc_kernel with p recomputed
//   the same way, which also sums ds of its rows over the group in shared
//   memory (in the bias cache's layout, no atomics); the group's sum goes
//   out once, a partial of dbias.  Its two caches take it to one block an
//   SM (152 KB at T = 256);
// - flash_biased_bwd_dbias_sum_kernel: dbias as the sum of the groups'
//   partials in group order (the partial-sum kernel of layer_norm.cu's
//   kind), so the result does not depend on the order blocks run in;
// - flash_biased_bwd_dkv_kernel: flash_bwd_dkv_tc_kernel with the same p;
//   its cache holds the bias's columns of the block's keys (the scores are
//   s^T).
//
// Names: every kernel here starts flash_biased_, and none holds a name of
// the bias-free kernels (flash_forward, flash_bwd_dq, flash_bwd_dkv), so
// a reader of a device trace tells the two kinds apart.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace nns_flash;
namespace tc = nns_flash::tc;

// SwinV2's score for two tokens of different regions
constexpr float kRegionMask = -100.f;
// the widest query and key axes: a block holds a float of the bias a
// (row, column) of its 64 rows in shared memory, and K3 as many of dbias
constexpr int kMaxTokens = 256;

// Strides of q, k, v and dO (batch, row, head), in elements.
struct Strides {
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
};

// The bias, f32 (h, tq, tkv) contiguous; the region labels, int32 (groups,
// t) contiguous (batch row b's tokens in row b mod groups), or null.
struct Bias {
  const float* bias;
  const int* regions;
  int groups;
};

// x[i] and x[i + 1] of an f32 row (0 from n on); `pairs`: n is even, so
// an even i is one 8-byte load.
__device__ __forceinline__ float2 pair_f32(const float* __restrict__ x, int i,
                                           int n, bool pairs) {
  if (pairs && i < n) return __ldg(reinterpret_cast<const float2*>(x + i));
  return make_float2(i < n ? __ldg(x + i) : 0.f,
                     i + 1 < n ? __ldg(x + i + 1) : 0.f);
}
__device__ __forceinline__ int2 pair_i32(const int* __restrict__ x, int i,
                                         int n, bool pairs) {
  if (pairs && i < n) return __ldg(reinterpret_cast<const int2*>(x + i));
  return make_int2(i < n ? __ldg(x + i) : 0, i + 1 < n ? __ldg(x + i + 1) : 0);
}

// A block's bias, cached in shared memory: each thread's values of its
// accumulator elements in every 64-column tile (32 a tile), tile j's
// element e of thread t at cache[(32 j + e) 128 + t], so that each thread
// reads and writes only its own, without a conflict or a barrier.  `tiles`
// 64-column tiles; element e of a tile is the (row, column) the caller's
// `at(e)` gives within it.
constexpr int cache_bytes(int tiles) {
  return tiles * 32 * tc::kThreads * (int)sizeof(float);
}
__device__ __forceinline__ float& cached(float* cache, int j, int e) {
  return cache[(32 * j + e) * tc::kThreads + threadIdx.x];
}

// Fills the cache of rows-by-keys scores (K2 and K3: the accumulator's row
// i of the thread's two, key 64 j + 8 jj + col + e at element 4 jj + 2 i +
// e): `brow` the two rows' bias.
__device__ __forceinline__ void fill_row_cache(float* cache,
                                               const float* const (&brow)[2],
                                               int tiles, int col, int tkv,
                                               bool pairs) {
  for (int j = 0; j < tiles; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int key = 64 * j + 8 * jj + col;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = pair_f32(brow[i], key, tkv, pairs);
        cached(cache, j, 4 * jj + 2 * i) = x.x;
        cached(cache, j, 4 * jj + 2 * i + 1) = x.y;
      }
    }
}

// (bias + mask) log2(e) of this thread's 32 scores of the 64-key tile j
// (rows by keys, key k0 + 8 jj + col + e, k0 = 64 j): the bias from the
// cache, `lab` the rows' region labels, `regions` the element's labels
// (null: no mask).
__device__ __forceinline__ void row_bias(float (&add)[32], float* cache,
                                         int j, const int (&lab)[2],
                                         const int* __restrict__ regions,
                                         int col, int tkv, bool pairs) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int key = 64 * j + 8 * jj + col;
    const int2 lk = regions ? pair_i32(regions, key, tkv, pairs)
                            : make_int2(0, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * jj + 2 * i;
      add[e] = (cached(cache, j, e) + (lk.x != lab[i] ? kRegionMask : 0.f)) *
               tc::kLog2e;
      add[e + 1] = (cached(cache, j, e + 1) +
                    (lk.y != lab[i] ? kRegionMask : 0.f)) *
                   tc::kLog2e;
    }
  }
}

// The grid of the three kernels: one block per (64-row tile, head, group of
// `per_block` batch elements), the tile innermost, then the head.  A block
// takes its group's elements one after another; the blocks of one (head,
// group) run together, so each element's tiles come from HBM once and
// from L2 for the other row tiles.
struct Place {
  int tile, head;
  long long first;  // the group's first element
  int windows;      // elements in the group
};
__device__ __forceinline__ Place place(int tiles, int h, int b,
                                       int per_block) {
  Place p;
  p.tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  p.head = rest % h;
  p.first = (long long)(rest / h) * per_block;
  p.windows = (int)min((long long)per_block, b - p.first);
  return p;
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

// Stages of the key/value ring: three where a stage holds 16 KB, else two.
template <int DP>
__host__ __device__ constexpr int fwd_stages() {
  return DP <= 64 ? 3 : 2;
}

// The q tile, the ring, the bias cache of `tiles` key tiles, and room to
// align the tiles.
template <int DP>
constexpr int fwd_smem_bytes(int tiles) {
  return (1 + 2 * fwd_stages<DP>()) * tc::tile_bytes<DP>() +
         cache_bytes(tiles) + tc::kAtomAlign;
}

// K2 with the bias: one warpgroup per (64 query rows, head, group of
// elements), 64 keys a stage, the block's rows of the bias read once into
// the cache and used for every element of the group.
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, 2)
flash_biased_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, Bias bias, int per_block,
                        int b, int tq, int tkv, int h, int d, Strides st,
                        float scale, int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  constexpr int S = fwd_stages<DP>();
  extern __shared__ __align__(1024) char smem_bf[];
  char* qs = tc::align_atoms(smem_bf);
  char* ring = qs + TB;  // slot s: k at + 2 s TB, v TB after it
  float* cache = reinterpret_cast<float*>(ring + 2 * S * TB);

  const int n = (tkv + tc::kTile - 1) / tc::kTile;
  const Place at = place((tq + tc::kTile - 1) / tc::kTile, h, b, per_block);
  const int head = at.head;
  const int q0 = at.tile * tc::kTile;
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block

  // this thread's two rows (rows past tq read the last row's; they are
  // not stored): their bias, cached, and the last key each sees
  int last_key[2];
  {
    const float* brow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      brow[i] = bias.bias +
                ((long long)head * tq + min(q0 + row + 8 * i, tq - 1)) * tkv;
      last_key[i] = tkv - 1;
    }
    fill_row_cache(cache, brow, n, col, tkv, (tkv & 1) == 0);
  }
  const bool pairs = (tkv & 1) == 0;
  const float scale2 = scale * tc::kLog2e;
  const uint64_t qd = tc::desc_k_major<DP>(tc::smem_u32(qs), 0);
  const uint64_t kd0 = tc::desc_k_major<DP>(tc::smem_u32(ring), 0);
  const uint64_t vd0 = tc::desc_mn_major<DP>(tc::smem_u32(ring + TB), 0);

  for (int w = 0; w < at.windows; ++w) {
    const long long bat = at.first + w;
    const T* kw = k + bat * st.k_sb + head * st.k_sh;
    const T* vw = v + bat * st.v_sb + head * st.v_sh;
    const int* regions =
        bias.regions ? bias.regions + (bat % bias.groups) * tkv : nullptr;
    auto load_stage = [&](int g) {
      if (g >= n) return;
      char* dst = ring + (g % S) * 2 * TB;
      tc::load_tile<T, DP>(dst, kw, st.k_st, g * tc::kTile, tkv, d, vec);
      tc::load_tile<T, DP>(dst + TB, vw, st.v_st, g * tc::kTile, tkv, d,
                           vec);
    };
    tc::load_tile<T, DP>(qs, q + bat * st.q_sb + head * st.q_sh, st.q_st,
                         q0, tq, d, vec);
#pragma unroll
    for (int g = 0; g < S - 1; ++g) {  // q travels with stage 0
      load_stage(g);
      tc::cp_async_commit();
    }

    // this thread's two rows: region labels, running max and sum
    int lab[2];
    float m2[2], lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lab[i] = regions ? __ldg(regions + min(q0 + row + 8 * i, tq - 1)) : 0;
      m2[i] = -CUDART_INF_F;
      lsum[i] = 0.f;
    }
    float acc[DP / 2], s[1][32], add[32], corr[2];
    uint32_t pa[1][4][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n; ++j) {
      tc::cp_async_wait<S - 2>();  // stage j has landed
      tc::fence_async_shared();
      __syncthreads();  // and the block is done with stage j - 1
      load_stage(j + S - 1);
      tc::cp_async_commit();
      const int k0 = j * tc::kTile;
      tc::wgmma_fence();
      tc::issue_scores<T, DP, 1>(s, qd,
                                 tc::desc_shift(kd0, (j % S) * 2 * TB));
      // while s = q k^T runs: the stage's bias and mask, in base 2
      row_bias(add, cache, j, lab, regions, col, tkv, pairs);
      tc::wgmma_wait<0>();
      tc::fence_acc(s[0]);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[0][e] = fmaf(s[0][e], scale2, add[e]);
      tc::online_softmax(s, m2, lsum, corr, k0 + tc::kTile > tkv, k0, col,
                         last_key, 1.f);
      tc::pack_a<T>(s[0], pa[0]);
      tc::rescale(acc, corr);
      tc::wgmma_fence();
      tc::issue_pv<T, DP, 1>(acc, pa,
                             tc::desc_shift(vd0, (j % S) * 2 * TB));
      tc::wgmma_wait<0>();
      tc::fence_acc(acc);
    }
    tc::cp_async_wait<0>();

    // out = o / max(l, 1e-20); lse = (m2 + log2 l) ln 2, -inf where l = 0
    float inv[2];
    float* lsew = lse + (bat * h + head) * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = lsum[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = 1.f / fmaxf(l, 1e-20f);
      const int r = q0 + row + 8 * i;
      if ((lane & 3) == 0 && r < tq)
        lsew[r] = l > 0.f ? (m2[i] + log2f(l)) * tc::kLn2 : -CUDART_INF_F;
    }
    tc::rescale(acc, inv);
    tc::store_acc<T, DP>(out + bat * tq * h * d, acc, q0, tq, h, head, d);
    __syncthreads();  // the block is done with q and the ring
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

// K3's shared memory: the q and dO tiles, two stages of (k, v) tiles, the
// group's sum of ds and the bias cache (a float a (row, key) of the block's
// 64 rows each), and room to align the tiles.
template <int DP>
int dq_smem_bytes(int tkv) {
  return 6 * tc::tile_bytes<DP>() +
         2 * cache_bytes((tkv + tc::kTile - 1) / tc::kTile) + tc::kAtomAlign;
}

// K3 with the bias: one warpgroup per (64 query rows, head, group of
// elements), looping over the group's elements and, in each, over key
// tiles; dq of each element as K3 writes it, and the group's sum of ds
// over the block's rows into `partial` (groups, h, tq, tkv).
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_biased_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, float* __restrict__ partial,
                           Bias bias, int per_block, int b, int tq, int tkv,
                           int h, int d, Strides st, float scale, int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  extern __shared__ __align__(1024) char smem_bq[];
  char* qs = tc::align_atoms(smem_bq);
  char* dos = qs + TB;
  char* kvs = dos + TB;  // stage s: k at kvs + 2 s TB, v TB after it
  const int n_k = (tkv + tc::kTile - 1) / tc::kTile;
  // the group's sum of ds and the bias, each in the cache's layout
  float* sums = reinterpret_cast<float*>(kvs + 4 * TB);
  float* cache = sums + n_k * 32 * tc::kThreads;

  const Place at = place((tq + tc::kTile - 1) / tc::kTile, h, b, per_block);
  const int head = at.head;
  const int q0 = at.tile * tc::kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block
  const bool pairs = (tkv & 1) == 0;
  const bool cut_last = n_k * tc::kTile > tkv;  // the last tile is ragged
  const float scale2 = scale * tc::kLog2e;

  int rows[2];
  {
    const float* brow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rows[i] = q0 + row + 8 * i;
      brow[i] = bias.bias +
                ((long long)head * tq + min(rows[i], tq - 1)) * tkv;
    }
    fill_row_cache(cache, brow, n_k, col, tkv, pairs);
  }

  for (int w = 0; w < at.windows; ++w) {
    const long long bat = at.first + w;
    const T* qw = q + bat * st.q_sb + head * st.q_sh;
    const T* kw = k + bat * st.k_sb + head * st.k_sh;
    const T* vw = v + bat * st.v_sb + head * st.v_sh;
    const T* ow = dout + bat * st.o_sb + head * st.o_sh;
    const float* lsew = lse + (bat * h + head) * tq;
    const float* dltw = delta + (bat * h + head) * tq;
    const int* regions =
        bias.regions ? bias.regions + (bat % bias.groups) * tkv : nullptr;

    tc::load_tile<T, DP>(qs, qw, st.q_st, q0, tq, d, vec);
    tc::load_tile<T, DP>(dos, ow, st.o_st, q0, tq, d, vec);
    tc::cp_async_commit();
    auto load_kv = [&](int stage, int k0) {
      char* ks = kvs + stage * 2 * TB;
      tc::load_tile<T, DP>(ks, kw, st.k_st, k0, tkv, d, vec);
      tc::load_tile<T, DP>(ks + TB, vw, st.v_st, k0, tkv, d, vec);
    };
    load_kv(0, 0);
    tc::cp_async_commit();

    // this thread's two rows: lse in base 2, +inf where it is -inf or past
    // the end of q (exp2 then gives p = 0 exactly); delta; region label
    float lse2[2], dlt[2];
    int lab[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rows[i];
      const float l = r < tq ? lsew[r] : -CUDART_INF_F;
      lse2[i] = l == -CUDART_INF_F ? CUDART_INF_F : l * tc::kLog2e;
      dlt[i] = r < tq ? dltw[r] : 0.f;
      lab[i] = regions ? __ldg(regions + min(r, tq - 1)) : 0;
    }

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

      // s = q k^T and dp = dO v^T, 64 x 64 each
      float s[32], dp[32], add[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, 64>(s, tc::desc_k_major<DP>(qa, kk),
                          tc::desc_k_major<DP>(ka, kk), kk);
      tc::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::mma_ss<T, 64>(dp, tc::desc_k_major<DP>(doa, kk),
                          tc::desc_k_major<DP>(va, kk), kk);
      tc::wgmma_commit();
      row_bias(add, cache, it, lab, regions, col, tkv, pairs);
      tc::wgmma_wait<1>();  // s is done; dp may still run
      tc::fence_acc(s);
      const bool cut = cut_last && it == n_k - 1;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p =
            exp2f(fmaf(s[e], scale2, add[e]) - lse2[(e >> 1) & 1]);
        s[e] = cut && k0 + 8 * (e >> 2) + col + (e & 1) >= tkv ? 0.f : p;
      }
      tc::wgmma_wait<0>();
      tc::fence_acc(dp);
      // ds before the scale: the bias's gradient, summed over the group
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dp[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]);
        float& sum = cached(sums, it, e);
        sum = w == 0 ? dp[e] : sum + dp[e];
        dp[e] *= scale;
      }

      // dq += ds k: ds rounded to T, the k tile as the MN-major B
      uint32_t a[4][4];
      tc::pack_a<T>(dp, a);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<T, DP>(acc, a[kk], tc::desc_mn_major<DP>(ka, kk), 1);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(acc);
      __syncthreads();  // this stage is free for the copy after next
    }
    tc::cp_async_wait<0>();
    tc::store_acc<T, DP>(dq + bat * tq * h * d, acc, q0, tq, h, head, d);
  }

  // the group's partial of dbias: this thread's elements of every key tile
  float* part = partial + ((long long)(at.first / per_block) * h + head) *
                              tq * tkv;
  for (int it = 0; it < n_k; ++it) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = rows[(e >> 1) & 1];
      const int key = it * tc::kTile + 8 * (e >> 2) + col + (e & 1);
      if (r < tq && key < tkv)
        part[(long long)r * tkv + key] = cached(sums, it, e);
    }
  }
}

// dbias = the sum over `groups` partials of n = h tq tkv values, in group
// order; four values a thread.
__global__ void flash_biased_bwd_dbias_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ dbias, int groups,
    long long n) {
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  if ((n & 3) == 0) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < groups; ++g) {
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(partial + g * n + i));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(dbias + i) = acc;
    return;
  }
  for (int e = 0; e < 4 && i + e < n; ++e) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += __ldg(partial + g * n + i + e);
    dbias[i + e] = acc;
  }
}

// K4's shared memory: the k and v tiles, two stages of (q tile, dO tile,
// the query tile's 64 lse and 64 delta values), the bias cache (a float a
// (key, query) of the block's 64 keys), and room to align the tiles.
template <int DP>
int dkv_smem_bytes(int tq) {
  return 6 * tc::tile_bytes<DP>() + 4 * tc::kTile * (int)sizeof(float) +
         cache_bytes((tq + tc::kTile - 1) / tc::kTile) + tc::kAtomAlign;
}

// K4 with the bias: one warpgroup per (64 keys, head, group of elements),
// the keys the rows of every product (s^T = k q^T, dp^T = v dO^T, dv +=
// p^T dO, dk += ds^T q), looping over the group's elements and, in each,
// over query tiles.  The cache holds the bias's columns of the block's
// keys (s^T's element 4 j + 2 i + e: key row i of the thread's two, query
// 8 j + col + e of the tile).
template <typename T, int DP>
__global__ void __launch_bounds__(tc::kThreads, DP > 64 ? 1 : 2)
flash_biased_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, Bias bias,
                            int per_block, int b, int tq, int tkv, int h,
                            int d, Strides st, float scale, int vec) {
  constexpr int TB = tc::tile_bytes<DP>();
  constexpr int kSlices = 2 * tc::kTile * (int)sizeof(float);
  extern __shared__ __align__(1024) char smem_bk[];
  char* ks = tc::align_atoms(smem_bk);
  char* vs = ks + TB;
  char* stages = vs + TB;  // stage s: q at stages + 2 s TB, dO TB after it
  char* slices = stages + 4 * TB;  // stage s: lse, delta at + s kSlices
  float* cache = reinterpret_cast<float*>(slices + 2 * kSlices);

  const int n_q = (tq + tc::kTile - 1) / tc::kTile;
  const Place at = place((tkv + tc::kTile - 1) / tc::kTile, h, b, per_block);
  const int head = at.head;
  const int k0 = at.tile * tc::kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // and col + 1, of each 8-column block

  // this thread's two keys: whether each exists, their bias columns (the
  // last key's past the end of k), cached for every query tile
  bool key_ok[2];
  const float* bcol[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kl = k0 + row + 8 * i;
    key_ok[i] = kl < tkv;
    bcol[i] = bias.bias + (long long)head * tq * tkv + min(kl, tkv - 1);
  }
  for (int j = 0; j < n_q; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int ql = 64 * j + 8 * jj + col;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cached(cache, j, 4 * jj + 2 * i) =
            ql < tq ? __ldg(bcol[i] + (long long)ql * tkv) : 0.f;
        cached(cache, j, 4 * jj + 2 * i + 1) =
            ql + 1 < tq ? __ldg(bcol[i] + (long long)(ql + 1) * tkv) : 0.f;
      }
    }
  const bool keys_cut = k0 + tc::kTile > tkv;
  const bool pairs = (tq & 1) == 0;
  const float scale2 = scale * tc::kLog2e;
  const uint32_t ka = tc::smem_u32(ks), va = tc::smem_u32(vs);

  for (int w = 0; w < at.windows; ++w) {
    const long long bat = at.first + w;
    const T* qw = q + bat * st.q_sb + head * st.q_sh;
    const T* ow = dout + bat * st.o_sb + head * st.o_sh;
    const float* lsew = lse + (bat * h + head) * tq;
    const float* dltw = delta + (bat * h + head) * tq;
    const int* regions =
        bias.regions ? bias.regions + (bat % bias.groups) * tkv : nullptr;

    tc::load_tile<T, DP>(ks, k + bat * st.k_sb + head * st.k_sh, st.k_st, k0,
                         tkv, d, vec);
    tc::load_tile<T, DP>(vs, v + bat * st.v_sb + head * st.v_sh, st.v_st, k0,
                         tkv, d, vec);
    tc::cp_async_commit();
    auto load_q = [&](int stage, int q0) {
      char* base = stages + stage * 2 * TB;
      tc::load_tile<T, DP>(base, qw, st.q_st, q0, tq, d, vec);
      tc::load_tile<T, DP>(base + TB, ow, st.o_st, q0, tq, d, vec);
      // thread t copies lse[q0 + t] (t < 64) or delta[q0 + t - 64]; zeros
      // past the end of q, whose columns the mask drops
      const int t = tid & (tc::kTile - 1);
      const float* src = tid < tc::kTile ? lsew : dltw;
      const bool ok = q0 + t < tq;
      tc::cp_async_4(tc::smem_u32(slices + stage * kSlices) + 4 * tid,
                     ok ? src + q0 + t : src, ok ? 4 : 0);
    };
    load_q(0, 0);
    tc::cp_async_commit();

    int lab[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lab[i] = regions ? __ldg(regions + min(k0 + row + 8 * i, tkv - 1)) : 0;

    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int it = 0; it < n_q; ++it) {
      const int q0 = it * tc::kTile;
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
      const bool cut = keys_cut || q0 + tc::kTile > tq;

      float s[32], dp[32], add[32];
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
      // while they run: (bias + mask) log2(e) of this thread's scores
      // (rows are keys, columns queries q0 + 8 j + col + e)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ql = q0 + 8 * j + col;
        const int2 lq = regions ? pair_i32(regions, ql, tq, pairs)
                                : make_int2(0, 0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i;
          add[e] = (cached(cache, it, e) +
                    (lq.x != lab[i] ? kRegionMask : 0.f)) *
                   tc::kLog2e;
          add[e + 1] = (cached(cache, it, e + 1) +
                        (lq.y != lab[i] ? kRegionMask : 0.f)) *
                       tc::kLog2e;
        }
      }
      tc::wgmma_wait<1>();  // s^T is done; dp^T may still run
      tc::fence_acc(s);
      // p^T = exp(s^T + bias + mask - lse), 0 for keys or queries past the
      // end
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
          const int x = 4 * j + e;
          const float p = exp2f(fmaf(s[x], scale2, add[x]) - l2[e & 1]);
          s[x] = cut && (!key_ok[e >> 1] || q0 + 8 * j + col + (e & 1) >= tq)
                     ? 0.f
                     : p;
        }
      }
      tc::wgmma_wait<0>();
      tc::fence_acc(dp);
      // ds^T = p^T (dp^T - delta) scale, into dp
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] *
                          (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }

      // dv += p^T dO and dk += ds^T q: p^T and ds^T rounded to T, the dO
      // and q tiles as MN-major Bs
      uint32_t pa[4][4], da[4][4];
      tc::pack_a<T>(s, pa);
      tc::pack_a<T>(dp, da);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<T, DP>(dv_acc, pa[kk], tc::desc_mn_major<DP>(doa, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<T, DP>(dk_acc, da[kk], tc::desc_mn_major<DP>(qa, kk), 1);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_acc(dv_acc);
      tc::fence_acc(dk_acc);
      __syncthreads();  // this stage is free for the copy after next
    }
    tc::cp_async_wait<0>();
    tc::store_acc<T, DP>(dk + bat * tkv * h * d, dk_acc, k0, tkv, h, head, d);
    tc::store_acc<T, DP>(dv + bat * tkv * h * d, dv_acc, k0, tkv, h, head, d);
    __syncthreads();  // the block is done with k, v and the stages
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One call: which = 0 the forward (out0 = out, out1 = lse), 1 K3 (out0 =
// dq, partial), 2 K4 (out0 = dk, out1 = dv).
struct Call {
  int which;
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;
  float* partial;
  Bias bias;
  int per_block;
  int b, tq, tkv, h, d;
  Strides st;
  float scale;
  cudaStream_t stream;
};

// 16-byte loads need 16-byte aligned rows and a head dim of whole vectors.
template <typename T>
bool vector_ok(const Call& c) {
  constexpr long long V = 16 / sizeof(T);
  const Strides& s = c.st;
  const long long all[] = {s.q_sb, s.q_st, s.q_sh, s.k_sb, s.k_st, s.k_sh,
                           s.v_sb, s.v_st, s.v_sh, s.o_sb, s.o_st, s.o_sh};
  for (long long x : all)
    if (x % V) return false;
  return c.d % V == 0 && (uintptr_t)c.q % 16 == 0 &&
         (uintptr_t)c.k % 16 == 0 && (uintptr_t)c.v % 16 == 0 &&
         (uintptr_t)c.dout % 16 == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DP>
int launch(const Call& c) {
  const int vec = vector_ok<T>(c);
  const T* q = static_cast<const T*>(c.q);
  const T* k = static_cast<const T*>(c.k);
  const T* v = static_cast<const T*>(c.v);
  const T* o = static_cast<const T*>(c.dout);
  // one block per (64-row tile, head, group): the rows are queries but in
  // K4, keys
  const long long blocks =
      (long long)(((c.which == 2 ? c.tkv : c.tq) + tc::kTile - 1) /
                  tc::kTile) *
      c.h * ((c.b + c.per_block - 1) / c.per_block);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int tiles_k = (c.tkv + tc::kTile - 1) / tc::kTile;
  if (c.which == 0) {
    auto kernel = flash_biased_fwd_kernel<T, DP>;
    const int bytes = fwd_smem_bytes<DP>(tiles_k);
    if (const cudaError_t err = set_smem(kernel, bytes)) return (int)err;
    kernel<<<(unsigned)blocks, tc::kThreads, bytes, c.stream>>>(
        q, k, v, static_cast<T*>(c.out0), static_cast<float*>(c.out1),
        c.bias, c.per_block, c.b, c.tq, c.tkv, c.h, c.d, c.st, c.scale, vec);
  } else if (c.which == 1) {
    auto kernel = flash_biased_bwd_dq_kernel<T, DP>;
    const int bytes = dq_smem_bytes<DP>(c.tkv);
    if (const cudaError_t err = set_smem(kernel, bytes)) return (int)err;
    kernel<<<(unsigned)blocks, tc::kThreads, bytes, c.stream>>>(
        q, k, v, o, c.lse, c.delta, static_cast<T*>(c.out0), c.partial,
        c.bias, c.per_block, c.b, c.tq, c.tkv, c.h, c.d, c.st, c.scale,
        vec);
  } else {
    auto kernel = flash_biased_bwd_dkv_kernel<T, DP>;
    const int bytes = dkv_smem_bytes<DP>(c.tq);
    if (const cudaError_t err = set_smem(kernel, bytes)) return (int)err;
    kernel<<<(unsigned)blocks, tc::kThreads, bytes, c.stream>>>(
        q, k, v, o, c.lse, c.delta, static_cast<T*>(c.out0),
        static_cast<T*>(c.out1), c.bias, c.per_block, c.b, c.tq, c.tkv, c.h,
        c.d, c.st, c.scale, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Call& c) {
  if (c.d <= 16) return launch<T, 16>(c);
  if (c.d <= 32) return launch<T, 32>(c);
  if (c.d <= 64) return launch<T, 64>(c);
  if (c.d <= 128) return launch<T, 128>(c);
  return (int)cudaErrorInvalidValue;
}

// f16 and bf16 only (dtype 1, 2): f32 has no biased kernel.
int entry(const Call& c, int dtype) {
  if (c.b <= 0 || c.tq <= 0 || c.tkv <= 0 || c.h <= 0) return 0;
  if (c.d <= 0 || c.b > 65535 || c.tq > kMaxTokens || c.tkv > kMaxTokens ||
      c.per_block <= 0 ||
      (c.bias.regions && (c.bias.groups <= 0 || c.tq != c.tkv)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return dispatch_d<__half>(c);
    case 2:
      return dispatch_d<__nv_bfloat16>(c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  q and dO are (b, tq, h, d), k and v (b, tkv, h, d), read
// through their strides (in elements; the head dimension must be
// contiguous).  dtype: 1 f16, 2 bf16 (q, k, v, dO, out and the gradients
// alike).  bias is a contiguous f32 (h, tq, tkv); regions a contiguous
// int32 (groups, tq), batch row i's labels in row i mod groups, or null
// (no mask; tq == tkv where given).  lse and delta are contiguous f32 (b,
// h, tq); out and the gradients contiguous (b, t, h, d).

#define NNS_BIASED_PARAMS                                                     \
  const void *bias, const void *regions, int groups, int b, int tq, int tkv, \
      int h, int d, long long q_sb, long long q_st, long long q_sh,          \
      long long k_sb, long long k_st, long long k_sh, long long v_sb,        \
      long long v_st, long long v_sh, long long o_sb, long long o_st,        \
      long long o_sh, float scale, int dtype, void *stream
#define NNS_BIASED_ARGS                                                       \
  Bias{static_cast<const float*>(bias), static_cast<const int*>(regions),    \
       groups}

// Every kernel takes ceil(b / per_block) groups of per_block batch
// elements, a block a (row tile, head, group).

// The forward: out and lse (dO's strides are not read).
extern "C" int nns_flash_biased_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int per_block, NNS_BIASED_PARAMS) {
  const Call c{0, q, k, v, q, nullptr, nullptr, out, lse, nullptr,
               NNS_BIASED_ARGS, per_block, b, tq, tkv, h, d,
               Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                       o_sb, o_st, o_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return entry(c, dtype);
}

// K3: dq, and the groups' partials of dbias, f32 (groups, h, tq, tkv).
extern "C" int nns_flash_biased_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, void* partial, int per_block,
                                       NNS_BIASED_PARAMS) {
  const Call c{1, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr,
               static_cast<float*>(partial), NNS_BIASED_ARGS, per_block, b,
               tq, tkv, h, d,
               Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                       o_sb, o_st, o_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return entry(c, dtype);
}

// K4: dk and dv.
extern "C" int nns_flash_biased_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int per_block,
                                        NNS_BIASED_PARAMS) {
  const Call c{2, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, nullptr,
               NNS_BIASED_ARGS, per_block, b, tq, tkv, h, d,
               Strides{q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                       o_sb, o_st, o_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return entry(c, dtype);
}

#undef NNS_BIASED_PARAMS
#undef NNS_BIASED_ARGS

// dbias (n = h tq tkv f32) as the sum of `groups` partials of n values.
extern "C" int nns_flash_biased_dbias_sum(const void* partial, void* dbias,
                                          int groups, long long n,
                                          void* stream) {
  if (n <= 0) return 0;
  if (groups <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_biased_bwd_dbias_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), groups,
      n);
  return (int)cudaGetLastError();
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
