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
// (row stride, head stride, unit stride along D), the ragged tail is masked by
// bounds, and out is written straight into (Tq, H, D).  Its sequential grid axis
// over key tiles becomes a loop inside the block.
//
// What bounds it: at the main path's shapes the work is operations for long
// causal sequences (LM, T=2048: 4.3 GFLOP against 8.5 MB) and bytes for ViT's
// T=197 (60 MFLOP against 0.61 MB), where the launch dominates anyway.  This
// first version does its products on the CUDA cores in f32 (no mma.sync, wgmma
// or TMA yet), so its ceiling is the 67 TFLOP/s f32 rate, not the tensor cores.
// The design keeps the f32 pipes fed:
//
// - one block of 256 threads per (64-query tile, head, batch element): the
//   batch axis that jax.vmap lifts into the pallas_call grid is the grid's z
//   axis here, read through its own strides (a call without one has b = 1);
// - the key/value tiles of 64 rows go through shared memory, converted to f32
//   once on load;
// - a tile is read with 16-byte loads, all of a thread's loads issued before
//   the first is used (one element at a time, each load waited for the last
//   and tile loads took most of the time);
// - each thread holds a 4x4 tile of scores (rows ty + 16*i, columns tx + 16*j)
//   and reads q and k in 16-byte vectors (the k tile's rows are padded by 4
//   floats, so the 8 rows a quarter-warp reads fall in distinct banks);
// - the softmax runs in registers: the 16 threads that share a row are one
//   half-warp, so its max and sum are 4 shuffles;
// - the thread then owns the same 4 rows of the output accumulator, so the
//   rescale by exp(m_old - m_new) needs no exchange, and p goes through shared
//   memory only to be read back as the rows of the p.v product;
// - under `causal`, key tiles wholly in the future of the query tile are never
//   loaded, and query tiles are issued longest first.
//
// The head dimension is a runtime value up to 256: the kernel is compiled for
// padded widths 16, 32, 64, 128 and 256, and columns past D load as zeros.
// The tile loader and the two tile products are shared with the backward
// kernels (flash_common.cuh).

#include "flash_common.cuh"

namespace {

using namespace nns_flash;

template <typename T, int DP>
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

  const int n_qtiles = (tq + kBlockQ - 1) / kBlockQ;
  // causal: the last query tile sees the most keys, so issue it first
  const int qt = causal ? n_qtiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
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
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<T, DP>(ks, kKStride, k, k_st, k0, tkv, d, vec);
    load_tile<T, DP>(vs, kVStride, v, v_st, k0, tkv, d, vec);
    __syncthreads();

    // scores: s[i][j] = q[ty + 16i] . k[tx + 16j]
    float s[kRows][kCols];
    tile_dots<DP, kQStride, kKStride>(qs, ks, ty, tx, s);

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
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
    const float inv = 1.f / denom;
    T* orow = out + ((long long)row * h + head) * d;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        const int col = g * 16 * L::kVec + tx * L::kVec + e;
        if (col < d) orow[col] = from_f32<T>(acc[i][g * L::kVec + e] * inv);
      }
    if (tx == 0)
      lse[row] = l_run[i] > 0.f ? m_run[i] + logf(denom) : -CUDART_INF_F;
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int tq, int tkv, int h, int d, long long q_sb,
           long long q_st, long long q_sh, long long k_sb, long long k_st,
           long long k_sh, long long v_sb, long long v_st, long long v_sh,
           int causal, long long q_offset, long long k_offset, float scale,
           cudaStream_t stream) {
  constexpr int floats = kBlockQ * DP + kBlockK * (DP + 4) + kBlockK * DP +
                         kBlockQ * kPStride;
  constexpr int bytes = floats * (int)sizeof(float);
  // above 48 KB a block must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  // 16-byte loads need 16-byte aligned rows and a head dim of whole vectors
  constexpr long long V = 16 / sizeof(T);
  const bool vec = d % V == 0 && q_sb % V == 0 && q_st % V == 0 &&
                   q_sh % V == 0 && k_sb % V == 0 && k_st % V == 0 &&
                   k_sh % V == 0 && v_sb % V == 0 && v_st % V == 0 &&
                   v_sh % V == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, h, b);
  flash_forward_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, tq, tkv, h, d,
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal, q_offset,
      k_offset, scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int tq, int tkv, int h, int d,
               long long q_sb, long long q_st, long long q_sh, long long k_sb,
               long long k_st, long long k_sh, long long v_sb, long long v_st,
               long long v_sh, int causal, long long q_offset,
               long long k_offset, float scale, cudaStream_t s) {
#define NNS_FLASH_LAUNCH(DP)                                                  \
  return launch<T, DP>(q, k, v, out, lse, b, tq, tkv, h, d, q_sb, q_st, q_sh, \
                       k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal, q_offset,  \
                       k_offset, scale, s)
  if (d <= 16) NNS_FLASH_LAUNCH(16);
  if (d <= 32) NNS_FLASH_LAUNCH(32);
  if (d <= 64) NNS_FLASH_LAUNCH(64);
  if (d <= 128) NNS_FLASH_LAUNCH(128);
  if (d <= 256) NNS_FLASH_LAUNCH(256);
#undef NNS_FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q (b, tq, h, d), k and v (b, tkv, h, d), read through their strides (in
// elements; the head dimension must be contiguous); a call without a batch
// axis passes b = 1.  dtype: 0 f32, 1 f16, 2 bf16 (q, k, v and out alike).
// out is a contiguous (b, tq, h, d) tensor, lse a contiguous f32 (b, h, tq).
extern "C" int nns_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int tq, int tkv, int h, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, int causal,
    long long q_offset, long long k_offset, float scale, int dtype,
    void* stream) {
  if (b <= 0 || tq <= 0 || h <= 0) return 0;
  if (d <= 0 || d > 256 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define NNS_FLASH_DISPATCH(T)                                                 \
  return dispatch_d<T>(q, k, v, out, l, b, tq, tkv, h, d, q_sb, q_st, q_sh,   \
                       k_sb, k_st, k_sh, v_sb, v_st, v_sh, causal, q_offset,  \
                       k_offset, scale, s)
  switch (dtype) {
    case 0:
      NNS_FLASH_DISPATCH(float);
    case 1:
      NNS_FLASH_DISPATCH(__half);
    case 2:
      NNS_FLASH_DISPATCH(__nv_bfloat16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NNS_FLASH_DISPATCH
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
