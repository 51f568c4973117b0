// LayerNorm forward and backward as flax's nn.LayerNorm computes it.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses flax's nn.LayerNorm into the
// ops around it; the port wrote the same expression as a chain of PyTorch ops
// on an f32 copy of the activation (ops/layer_norm.py:layer_norm_reference),
// about a dozen kernels forward and twenty to twenty-five backward, each
// reading or writing the whole (rows, D) activation in f32.  At ViT-S/16's
// training shape, (32 x 197, 384) in bf16 25 times a step, that chain was the
// largest block of device time in the training step.  These kernels compute
// the same function in one pass each way:
//
//   mu = E[x], var = max(E[x^2] - mu^2, 0)   (f32, one pass, flax's fast variance)
//   r  = rsqrt(var + eps)
//   y  = cast((x - mu) * (r * w) + b)        (w, b in f32)
//
// and its gradient, including the clip: where E[x^2] - mu^2 < 0 the variance
// path passes no gradient (clamp_min's), so with u = x - mu, g = dy,
// gw = g * w, Sg = sum(gw), Sgu = sum(gw * u) over the row,
//
//   dvar = clipped ? 0 : -r^3 * Sgu / 2
//   dx   = r * gw - r * Sg / D + 2 * dvar * u / D     (in x's dtype)
//   dw   = sum over rows of g * u * r,  db = sum over rows of g   (f32)
//
// (the plain version of the formula: layer_norm_backward_reference).
//
// What bounds it: bytes.  A normalisation does a few operations a value and
// moves 2 (bf16) or 4 (f32) bytes for each, far below the card's ~295
// operations a byte.  The least a forward can move is x in and y out, the
// backward x and dy in and dx out: 9.69 MB and 14.53 MB at (6304, 384) bf16,
// 2.9 us and 4.3 us at 3.35 TB/s.  So the design moves each of those bytes
// once and nothing else of that size:
//
// - a warp owns a row.  Each lane loads its share of the row with 16-byte
//   loads (8 bf16 or f16 values, 4 f32) and keeps it in registers: up to 4
//   loads a lane (D <= 1024 in bf16, 512 in f32) in the cached variant.
//   Wider rows, and a width or a pointer that does not allow 16-byte loads
//   (1-value loads), take the streaming variant, which reads the row again
//   from L1 for each pass (the row was just read, 16 KB at most);
// - sum and sum of squares are one pass and one butterfly of shuffles (every
//   lane ends with the same bits); no f32 copy of x and no row statistics are
//   written: the backward reads x anyway and recomputes them with the same
//   code, so they come out bit for bit the same;
// - the backward's warps each take a run of rows, with the next row's x and
//   dy in flight while one is computed, and keep the weight and their dw and
//   db partials for their columns in registers (the streaming variant: the
//   partials in shared memory).  A block adds its warps' partials in warp
//   order and writes one row of partials; layer_norm_param_sum_kernel adds
//   those rows in block order.  (Partials in shared memory, for more blocks
//   an SM, measured slower: the adds cost more than the occupancy gained.)
//   Nothing is summed with atomics, and the grid depends only on the shape
//   and the card, so a CUDA graph's replay gives the eager run's bits;
// - the forward launches one warp a row, all rows in one wave at ViT's shape.
//
// Rounding follows the plain expression: x * x, mu * mu, the difference, the
// product (x - mu) * (r * w) and the sum with b each round to f32 once (the
// intrinsics keep nvcc from contracting them into FMAs); only the order of
// the row sums differs from PyTorch's reductions.
//
// Nothing allocates or synchronises: the wrapper passes every output and the
// partials' scratch from torch.empty, so a captured step records the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 8;       // rows of a forward block, one a warp
constexpr int kMaxBwdWarps = 8;    // warps of a backward block
constexpr int kPartialFloats = 12288;  // a backward block's partials: 48 KB
constexpr int kSumRows = 16;       // partial rows a column's sum splits over
constexpr int kMaxWidth = 4096;

// Element access: raw bits in memory, f32 in registers.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  using Raw = float;
  static __device__ __forceinline__ float in(Raw r) { return r; }
  static __device__ __forceinline__ Raw out(float v) { return v; }
};

template <>
struct Elt<__half> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float in(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ Raw out(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <>
struct Elt<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float in(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw out(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// N values of E in one aligned access (a 32-byte pack of 8 f32 weights is two
// 16-byte loads).
template <typename E, int N>
struct alignas(sizeof(E) * N < 16 ? sizeof(E) * N : 16) Pack {
  E v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

struct Stats {
  float mu, r;
  bool clipped;  // E[x^2] - mu^2 < 0: the variance path passes no gradient
};

// A row's statistics from each lane's sum and sum of squares.
__device__ __forceinline__ Stats row_stats(float s, float ss, int d,
                                           float eps) {
  s = warp_sum(s);
  ss = warp_sum(ss);
  Stats st;
  st.mu = __fdiv_rn(s, (float)d);
  const float d2 = __fsub_rn(__fdiv_rn(ss, (float)d), __fmul_rn(st.mu, st.mu));
  st.clipped = !(d2 >= 0.f);            // NaN passes no gradient either
  const float var = d2 < 0.f ? 0.f : d2;  // NaN stays NaN, as clamp_min
  st.r = rsqrtf(__fadd_rn(var, eps));
  return st;
}

__device__ __forceinline__ void add_moments(float v, float& s, float& ss) {
  s = __fadd_rn(s, v);
  ss = __fadd_rn(ss, __fmul_rn(v, v));
}

__device__ __forceinline__ float normed(float v, const Stats& st, float w,
                                        float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, st.mu), __fmul_rn(st.r, w)), b);
}

// ---------------------------------------------------------------------------
// forward: one warp a row
// ---------------------------------------------------------------------------

// NV > 0: a lane holds NV packs of VEC values (pack c = lane + 32 i) in
// registers; NV == 0: the row streams, read twice.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32)
    layer_norm_fwd_kernel(const typename Elt<T>::Raw* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          typename Elt<T>::Raw* __restrict__ y, long long rows,
                          int d, float eps) {
  using Raw = typename Elt<T>::Raw;
  using XPack = Pack<Raw, VEC>;
  using WPack = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / VEC;
  const XPack* xr = reinterpret_cast<const XPack*>(x + row * d);
  XPack* yr = reinterpret_cast<XPack*>(y + row * d);
  const WPack* wv = reinterpret_cast<const WPack*>(w);
  const WPack* bv = reinterpret_cast<const WPack*>(b);
  float s = 0.f, ss = 0.f;
  if constexpr (NV > 0) {
    float v[NV][VEC] = {};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const XPack p = xr[c];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          v[i][k] = Elt<T>::in(p.v[k]);
          add_moments(v[i][k], s, ss);
        }
      }
    }
    const Stats st = row_stats(s, ss, d, eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const WPack wp = wv[c], bp = bv[c];
        XPack o;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o.v[k] = Elt<T>::out(normed(v[i][k], st, wp.v[k], bp.v[k]));
        yr[c] = o;
      }
    }
  } else {
    for (int c = lane; c < nvec; c += 32) {
      const XPack p = xr[c];
#pragma unroll
      for (int k = 0; k < VEC; ++k) add_moments(Elt<T>::in(p.v[k]), s, ss);
    }
    const Stats st = row_stats(s, ss, d, eps);
    for (int c = lane; c < nvec; c += 32) {
      const XPack p = xr[c];
      const WPack wp = wv[c], bp = bv[c];
      XPack o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.v[k] = Elt<T>::out(normed(Elt<T>::in(p.v[k]), st, wp.v[k], bp.v[k]));
      yr[c] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: a warp takes rows_per_warp rows in a run; per-block partials
// ---------------------------------------------------------------------------

// The per-row scalars of dx = r * gw + c2 * u + a.
struct Grad {
  float c2, a;
};

__device__ __forceinline__ Grad row_grad(const Stats& st, float sg, float sgu,
                                         int d) {
  sg = warp_sum(sg);
  sgu = warp_sum(sgu);
  const float dvar = st.clipped ? 0.f : -0.5f * st.r * st.r * st.r * sgu;
  return {2.f * dvar / (float)d, -st.r * sg / (float)d};
}

// VEC floats of a warp's partial row in shared memory, 16 bytes at a time
// where VEC allows.
template <int VEC>
__device__ __forceinline__ void store_to(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

template <int VEC>
__device__ __forceinline__ void add_to(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      float4 t = reinterpret_cast<float4*>(p)[j];
      t.x += v[4 * j], t.y += v[4 * j + 1], t.z += v[4 * j + 2],
          t.w += v[4 * j + 3];
      reinterpret_cast<float4*>(p)[j] = t;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] += v[k];
  }
}

// A row's packs of x and dy (pack c = lane + 32 i) into registers.
template <int NV, typename Raw, int VEC>
__device__ __forceinline__ void load_row(const Raw* x, const Raw* dy,
                                         long long row, int d, int nvec,
                                         int lane, Pack<Raw, VEC> (&xs)[NV],
                                         Pack<Raw, VEC> (&gs)[NV]) {
  const Pack<Raw, VEC>* xr = reinterpret_cast<const Pack<Raw, VEC>*>(x + row * d);
  const Pack<Raw, VEC>* gr = reinterpret_cast<const Pack<Raw, VEC>*>(dy + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) xs[i] = xr[c], gs[i] = gr[c];
  }
}

// One pack's share of the row sums of gw and gw * u.
template <typename T, int VEC>
__device__ __forceinline__ void grad_sums(
    const Pack<typename Elt<T>::Raw, VEC>& xp,
    const Pack<typename Elt<T>::Raw, VEC>& gp, const Pack<float, VEC>& wp,
    const Stats& st, float& sg, float& sgu) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float gw = Elt<T>::in(gp.v[k]) * wp.v[k];
    sg += gw;
    sgu += gw * __fsub_rn(Elt<T>::in(xp.v[k]), st.mu);
  }
}

// One pack of dx; its dw and db terms added to the warp's partial rows.
template <typename T, int VEC>
__device__ __forceinline__ Pack<typename Elt<T>::Raw, VEC> grad_pack(
    const Pack<typename Elt<T>::Raw, VEC>& xp,
    const Pack<typename Elt<T>::Raw, VEC>& gp, const Pack<float, VEC>& wp,
    const Stats& st, const Grad& gr, float* pw, float* pb) {
  Pack<typename Elt<T>::Raw, VEC> o;
  float dw[VEC], db[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float u = __fsub_rn(Elt<T>::in(xp.v[k]), st.mu);
    const float g = Elt<T>::in(gp.v[k]);
    o.v[k] = Elt<T>::out(st.r * (g * wp.v[k]) + gr.c2 * u + gr.a);
    dw[k] = g * u * st.r;
    db[k] = g;
  }
  add_to<VEC>(pw, dw);
  add_to<VEC>(pb, db);
  return o;
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxBwdWarps * 32)
    layer_norm_bwd_kernel(const typename Elt<T>::Raw* __restrict__ x,
                          const float* __restrict__ w,
                          const typename Elt<T>::Raw* __restrict__ dy,
                          typename Elt<T>::Raw* __restrict__ dx,
                          float* __restrict__ partials, long long rows, int d,
                          long long rows_per_warp, float eps) {
  using Raw = typename Elt<T>::Raw;
  using XPack = Pack<Raw, VEC>;
  using WPack = Pack<float, VEC>;
  extern __shared__ float part[];  // [warps][2 d]: dw's partials, then db's
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  float* mine = part + (long long)warp * 2 * d;
  const WPack* wv = reinterpret_cast<const WPack*>(w);
  const long long first = ((long long)blockIdx.x * warps + warp) * rows_per_warp;
  const long long end = first + rows_per_warp < rows ? first + rows_per_warp
                                                     : rows;
  if constexpr (NV > 0) {
    float wr[NV][VEC] = {}, pw[NV][VEC] = {}, pb[NV][VEC] = {};
    XPack xn[NV], gn[NV];  // the next row's x and dy, in flight
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const WPack wp = wv[c];
#pragma unroll
        for (int k = 0; k < VEC; ++k) wr[i][k] = wp.v[k];
      }
    }
    if (first < end) load_row<NV>(x, dy, first, d, nvec, lane, xn, gn);
    for (long long row = first; row < end; ++row) {
      float xv[NV][VEC] = {}, gv[NV][VEC] = {};
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            xv[i][k] = Elt<T>::in(xn[i].v[k]);
            gv[i][k] = Elt<T>::in(gn[i].v[k]);
            add_moments(xv[i][k], s, ss);
          }
        }
      }
      if (row + 1 < end) load_row<NV>(x, dy, row + 1, d, nvec, lane, xn, gn);
      const Stats st = row_stats(s, ss, d, eps);
      float sg = 0.f, sgu = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xv[i][k] = __fsub_rn(xv[i][k], st.mu);  // u
          const float gw = gv[i][k] * wr[i][k];
          sg += gw;
          sgu += gw * xv[i][k];
        }
      }
      const Grad gr = row_grad(st, sg, sgu, d);
      XPack* dxr = reinterpret_cast<XPack*>(dx + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          XPack o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float u = xv[i][k], g = gv[i][k];
            o.v[k] = Elt<T>::out(st.r * (g * wr[i][k]) + gr.c2 * u + gr.a);
            pw[i][k] += g * u * st.r;
            pb[i][k] += g;
          }
          dxr[c] = o;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        store_to<VEC>(mine + c * VEC, pw[i]);
        store_to<VEC>(mine + d + c * VEC, pb[i]);
      }
    }
  } else {
    // a lane owns the same columns in every pass: no sync inside the warp
    for (int c = lane; c < nvec; c += 32) {
      const float zero[VEC] = {};
      store_to<VEC>(mine + c * VEC, zero);
      store_to<VEC>(mine + d + c * VEC, zero);
    }
    for (long long row = first; row < end; ++row) {
      const XPack* xr = reinterpret_cast<const XPack*>(x + row * d);
      const XPack* gr_ = reinterpret_cast<const XPack*>(dy + row * d);
      float s = 0.f, ss = 0.f;
      for (int c = lane; c < nvec; c += 32) {
        const XPack p = xr[c];
#pragma unroll
        for (int k = 0; k < VEC; ++k) add_moments(Elt<T>::in(p.v[k]), s, ss);
      }
      const Stats st = row_stats(s, ss, d, eps);
      float sg = 0.f, sgu = 0.f;
      for (int c = lane; c < nvec; c += 32)
        grad_sums<T, VEC>(xr[c], gr_[c], wv[c], st, sg, sgu);
      const Grad gr = row_grad(st, sg, sgu, d);
      XPack* dxr = reinterpret_cast<XPack*>(dx + row * d);
      for (int c = lane; c < nvec; c += 32)
        dxr[c] = grad_pack<T, VEC>(xr[c], gr_[c], wv[c], st, gr, mine + c * VEC,
                              mine + d + c * VEC);
    }
  }
  __syncthreads();
  // the block's partials: its warps' in warp order
  for (int j = threadIdx.x; j < 2 * d; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < warps; ++k) acc += part[k * 2 * d + j];
    partials[(long long)blockIdx.x * 2 * d + j] = acc;
  }
}

// dw and db: the blocks' partial rows added in block order.  A column's rows
// split over kSumRows threads (row g to thread g % kSumRows), added again in
// thread order.
__global__ void __launch_bounds__(32 * kSumRows)
    layer_norm_param_sum_kernel(const float* __restrict__ partials, int blocks,
                                int d, float* __restrict__ dw,
                                float* __restrict__ db) {
  __shared__ float acc[kSumRows][33];
  const int width = 2 * d;
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < width)
    for (int g = threadIdx.y; g < blocks; g += kSumRows)
      s += partials[(long long)g * width + j];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSumRows; ++k) t += acc[k][threadIdx.x];
    if (j < d)
      dw[j] = t;
    else
      db[j - d] = t;
  }
}

// ---------------------------------------------------------------------------
// host side: the variant a shape and its pointers take, and the launches
// ---------------------------------------------------------------------------

// The variant a row takes: 16-byte loads where the width and every pointer
// allow them, kept in registers up to 2 or 4 loads a lane; otherwise the row
// streams (so do 1-value loads: no path of the program has such rows, and
// one variant for them keeps the build short).
struct Plan {
  int vec;  // values a load: 16 bytes' worth, or 1
  int nv;   // loads a lane keeps in registers (2 or 4), or 0: streaming
};

template <typename T>
Plan plan(int d, const void* const* ptrs, int n) {
  constexpr int wide = 16 / (int)sizeof(typename Elt<T>::Raw);
  bool ok = d % wide == 0;
  for (int i = 0; i < n; ++i) ok = ok && (uintptr_t)ptrs[i] % 16 == 0;
  if (!ok) return {1, 0};
  const int per_lane = (d / wide + 31) / 32;
  return {wide, per_lane <= 2 ? 2 : per_lane <= 4 ? 4 : 0};
}

int bwd_warps(int d) {
  int warps = kMaxBwdWarps;
  while (warps > 1 && warps * 2 * d > kPartialFloats) warps /= 2;
  return warps;
}

template <typename T, int VEC, int NV>
struct Fwd {
  static cudaError_t run(const void* x, const void* w, const void* b, void* y,
                         long long rows, int d, float eps, cudaStream_t s) {
    using Raw = typename Elt<T>::Raw;
    const long long blocks = (rows + kFwdWarps - 1) / kFwdWarps;
    layer_norm_fwd_kernel<T, VEC, NV><<<(unsigned)blocks, kFwdWarps * 32, 0, s>>>(
        static_cast<const Raw*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<Raw*>(y), rows, d, eps);
    return cudaGetLastError();
  }
};

struct BwdArgs {
  const void *x, *w, *dy;
  void* dx;
  float *partials, *dw, *db;
  long long rows;
  int d;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VEC, int NV>
struct Bwd {
  // The grid: as many warps as the card holds at once at this kernel's
  // occupancy, each taking an equal run of rows; so the blocks, and the
  // partial rows they write, depend only on the shape and the card.
  static cudaError_t grid(long long rows, int d, int* blocks,
                          long long* rows_per_warp) {
    const int warps = bwd_warps(d);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, layer_norm_bwd_kernel<T, VEC, NV>, warps * 32,
          (size_t)warps * 2 * d * sizeof(float));
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
    const long long most = (long long)sms * per_sm * warps;
    *rows_per_warp = (rows + most - 1) / most;
    *blocks = (int)((rows + warps * *rows_per_warp - 1) /
                    (warps * *rows_per_warp));
    return cudaSuccess;
  }

  static cudaError_t run(const BwdArgs& a, int blocks) {
    using Raw = typename Elt<T>::Raw;
    int want = 0;
    long long rpw = 0;
    cudaError_t e = grid(a.rows, a.d, &want, &rpw);
    if (e != cudaSuccess) return e;
    if (want != blocks) return cudaErrorInvalidValue;
    const int warps = bwd_warps(a.d);
    layer_norm_bwd_kernel<T, VEC, NV>
        <<<blocks, warps * 32, (size_t)warps * 2 * a.d * sizeof(float),
           a.stream>>>(static_cast<const Raw*>(a.x),
                       static_cast<const float*>(a.w),
                       static_cast<const Raw*>(a.dy), static_cast<Raw*>(a.dx),
                       a.partials, a.rows, a.d, rpw, a.eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    layer_norm_param_sum_kernel<<<(2 * a.d + 31) / 32, dim3(32, kSumRows), 0,
                                  a.stream>>>(a.partials, blocks, a.d, a.dw,
                                              a.db);
    return cudaGetLastError();
  }
};

// Op<T, VEC, NV> for the plan's variant.
template <typename T, template <typename, int, int> class Op, typename F>
cudaError_t dispatch(const Plan& p, F&& f) {
  constexpr int wide = 16 / (int)sizeof(typename Elt<T>::Raw);
  if (p.vec == 1) return f(Op<T, 1, 0>());
  switch (p.nv) {
    case 2: return f(Op<T, wide, 2>());
    case 4: return f(Op<T, wide, 4>());
    default: return f(Op<T, wide, 0>());
  }
}

template <template <typename, int, int> class Op, typename F>
cudaError_t by_dtype(int dtype, int d, const void* const* ptrs, int n,
                     F&& f) {
  switch (dtype) {
    case 0: return dispatch<float, Op>(plan<float>(d, ptrs, n), f);
    case 1: return dispatch<__half, Op>(plan<__half>(d, ptrs, n), f);
    case 2:
      return dispatch<__nv_bfloat16, Op>(plan<__nv_bfloat16>(d, ptrs, n), f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface (ctypes).  dtype: 0 float32, 1 float16, 2 bfloat16, for x,
// y, dy and dx; w, b, dw and db are float32, all contiguous, x (rows, d).
// Each returns cudaGetLastError() after its launches (0 on success).

extern "C" int nns_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, long long rows, int d, float eps,
                                  int dtype, void* stream) {
  if (d < 1 || d > kMaxWidth || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const void* ptrs[] = {x, w, b, y};
  return (int)by_dtype<Fwd>(dtype, d, ptrs, 4, [&](auto op) {
    return decltype(op)::run(x, w, b, y, rows, d, eps,
                             static_cast<cudaStream_t>(stream));
  });
}

// The partial rows the backward writes (the size of its scratch, blocks x
// 2 d floats) for these pointers and shape.
extern "C" int nns_layer_norm_bwd_blocks(const void* x, const void* w,
                                         const void* dy, const void* dx,
                                         long long rows, int d, int dtype,
                                         int* blocks) {
  if (d < 1 || d > kMaxWidth || rows < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w, dy, dx};
  return (int)by_dtype<Bwd>(dtype, d, ptrs, 4, [&](auto op) {
    long long rpw = 0;
    return decltype(op)::grid(rows, d, blocks, &rpw);
  });
}

// dx, dw and db: the backward kernel, then the partials' sum.
extern "C" int nns_layer_norm_bwd(const void* x, const void* w, const void* dy,
                                  void* dx, float* partials, int blocks,
                                  float* dw, float* db, long long rows, int d,
                                  float eps, int dtype, void* stream) {
  if (d < 1 || d > kMaxWidth || rows < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w, dy, dx};
  const BwdArgs a{x, w, dy, dx, partials, dw, db, rows, d, eps,
                  static_cast<cudaStream_t>(stream)};
  return (int)by_dtype<Bwd>(dtype, d, ptrs, 4, [&](auto op) {
    return decltype(op)::run(a, blocks);
  });
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
