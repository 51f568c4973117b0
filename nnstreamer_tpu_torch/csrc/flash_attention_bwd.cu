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
// - K3 has one block of 256 threads per (64-query tile, head, batch element)
//   and loops over key tiles; K4 one per (64-key tile, head, batch element),
//   looping over query tiles.  Each block owns its output rows outright: no
//   atomics, so the result does not depend on the order blocks run in;
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
// 197-token layers by bytes.  Like the forward, this first version multiplies
// on the CUDA cores in f32 (no mma.sync, wgmma or TMA yet): its ceiling is the
// 67 TFLOP/s f32 rate.  Each thread keeps a 4 x 4 tile of scores and its
// output rows' accumulators in registers; ds and p pass through shared memory
// only to be read back, by the half-warp that wrote them, as the rows of the
// next product.
//
// The head dimension is a runtime value up to 128: the kernels are compiled
// for padded widths 16, 32, 64 and 128 (K4's 128-wide tiles take 174 KB of
// shared memory), and columns past D load as zeros.

#include "flash_common.cuh"

namespace {

using namespace nns_flash;

constexpr int kMaxHeadDim = 128;

// Strides of the four (b, t, h, d) inputs, in elements.
struct Strides {
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // dO
};

template <int DP>
constexpr int min_blocks() {
  return DP <= 64 ? 2 : 1;
}

// K3: dq.  Shared tiles: q and dO (the rows of the two score products), k and
// v (their columns, padded rows), ds.
template <typename T, int DP>
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

  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  const int qt = causal ? n_qtiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
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

  load_tile<T, DP>(qs, kAStride, q, st.q_st, q0, tq, d, vec);
  load_tile<T, DP>(dos, kAStride, dout, st.o_st, q0, tq, d, vec);

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
    __syncthreads();  // the previous tile's k, v and ds are no longer read
    load_tile<T, DP>(ks, kBStride, k, st.k_st, k0, tkv, d, vec);
    load_tile<T, DP>(vs, kBStride, v, st.v_st, k0, tkv, d, vec);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dots<DP, kAStride, kBStride>(qs, ks, ty, tx, s);
    tile_dots<DP, kAStride, kBStride>(dos, vs, ty, tx, dp);

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

  store_rows<T, DP>(dq, acc, q0, tq, h, head, d, ty, tx);
}

// K4: dk and dv.  A thread's score rows are keys and its columns queries.
// Shared tiles: k and v (the rows of the two transposed score products), q and
// dO (their columns, padded rows; also the rows of the dk and dv products),
// p^T and ds^T.
template <typename T, int DP>
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

  const int k0 = blockIdx.x * kBlockK;
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

  load_tile<T, DP>(ks, kAStride, k, st.k_st, k0, tkv, d, vec);
  load_tile<T, DP>(vs, kAStride, v, st.v_st, k0, tkv, d, vec);

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
    __syncthreads();  // the previous tile's q, dO, p^T and ds^T are not read
    load_tile<T, DP>(qs, kBStride, q, st.q_st, q0, tq, d, vec);
    load_tile<T, DP>(dos, kBStride, dout, st.o_st, q0, tq, d, vec);
    float lse_c[kCols], delta_c[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = q0 + tx + 16 * j;
      lse_c[j] = col < tq ? lse[col] : -CUDART_INF_F;
      delta_c[j] = col < tq ? delta[col] : 0.f;
    }
    __syncthreads();

    // s^T[i][j] = k[ty + 16i] . q[tx + 16j]; dp^T likewise from v and dO
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dots<DP, kAStride, kBStride>(ks, qs, ty, tx, s);
    tile_dots<DP, kAStride, kBStride>(vs, dos, ty, tx, dp);

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

  store_rows<T, DP>(dk, dk_acc, k0, tkv, h, head, d, ty, tx);
  store_rows<T, DP>(dv, dv_acc, k0, tkv, h, head, d, ty, tx);
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

// One launcher for both kernels: which = 0 launches K3 (out0 = dq), 1 launches
// K4 (out0 = dk, out1 = dv).
template <typename T, int DP>
int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* out0,
           void* out1, int b, int tq, int tkv, int h, int d,
           const Strides& st, int causal, long long q_offset,
           long long k_offset, float scale, cudaStream_t stream) {
  const int vec = vector_ok<T>(q, k, v, dout, d, st);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err;
  if (which == 0) {
    constexpr int bytes = dq_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((tq + kBlockQ - 1) / kBlockQ, h, b);
    flash_bwd_dq_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
        qt, kt, vt, ot, lse, delta, static_cast<T*>(out0), tq, tkv, h, d, st,
        causal, q_offset, k_offset, scale, vec);
  } else {
    constexpr int bytes = dkv_smem_bytes<DP>();
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((tkv + kBlockK - 1) / kBlockK, h, b);
    flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
        qt, kt, vt, ot, lse, delta, static_cast<T*>(out0),
        static_cast<T*>(out1), tq, tkv, h, d, st, causal, q_offset, k_offset,
        scale, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int which, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* out0, void* out1, int b, int tq, int tkv, int h, int d,
               const Strides& st, int causal, long long q_offset,
               long long k_offset, float scale, cudaStream_t s) {
#define NNS_FLASH_BWD_LAUNCH(DP)                                              \
  return launch<T, DP>(which, q, k, v, dout, lse, delta, out0, out1, b, tq,   \
                       tkv, h, d, st, causal, q_offset, k_offset, scale, s)
  if (d <= 16) NNS_FLASH_BWD_LAUNCH(16);
  if (d <= 32) NNS_FLASH_BWD_LAUNCH(32);
  if (d <= 64) NNS_FLASH_BWD_LAUNCH(64);
  if (d <= kMaxHeadDim) NNS_FLASH_BWD_LAUNCH(128);
#undef NNS_FLASH_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int entry(int which, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* out0,
          void* out1, int b, int tq, int tkv, int h, int d, const Strides& st,
          int causal, long long q_offset, long long k_offset, float scale,
          int dtype, void* stream) {
  if (b <= 0 || tq <= 0 || tkv <= 0 || h <= 0) return 0;
  if (d <= 0 || d > kMaxHeadDim || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define NNS_FLASH_BWD_DISPATCH(T)                                            \
  return dispatch_d<T>(which, q, k, v, dout, l, dl, out0, out1, b, tq, tkv,  \
                       h, d, st, causal, q_offset, k_offset, scale, s)
  switch (dtype) {
    case 0:
      NNS_FLASH_BWD_DISPATCH(float);
    case 1:
      NNS_FLASH_BWD_DISPATCH(__half);
    case 2:
      NNS_FLASH_BWD_DISPATCH(__nv_bfloat16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NNS_FLASH_BWD_DISPATCH
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
  const Strides st{q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                   v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  return entry(0, q, k, v, dout, lse, delta, dq, nullptr, b, tq, tkv, h, d,
               st, causal, q_offset, k_offset, scale, dtype, stream);
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
  const Strides st{q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                   v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  return entry(1, q, k, v, dout, lse, delta, dk, dv, b, tq, tkv, h, d, st,
               causal, q_offset, k_offset, scale, dtype, stream);
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
