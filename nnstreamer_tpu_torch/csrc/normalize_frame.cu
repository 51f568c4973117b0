// Frame normalization: y = cast(fma(float(x), scale, shift)) over a uint8 frame.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/preprocess.py::normalize_frame
// (body at :50-52, launched at :57).  It computes the same function, not the same
// blocks: the TPU kernel flattened the frame and padded it to (8,128) tiles for
// the vector unit; here the frame is read in place, with no pad, flatten or slice
// copies around the launch.
//
// What bounds it: memory.  It does 1 FMA per element and moves 1 byte in and
// 2 (bf16) or 4 (f32) bytes out.  At the main path's 224x224x3 frame it reads
// 150,528 B and writes 301,056 B in bf16: about 0.13 us at 3.35 TB/s, so the
// launch latency (a few microseconds) dominates.  The design therefore keeps the
// memory side plain and wide: each thread loads 16 input bytes with one 16-byte
// load and stores its 16 outputs with 16-byte stores; a grid-stride loop covers
// any size, and a scalar loop takes the ragged tail (and any input that is not
// 16-byte aligned).
//
// Rounding: __fmaf_rn rounds x*scale+shift once to f32, which is what the JAX
// reference computes on the CPU; bf16 output then rounds that f32 to nearest even
// (__float2bfloat16_rn), as the reference's cast does.  Results match bit for bit.
//
// scale and shift are runtime arguments, so a new value rebuilds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Output element as raw bits, so the 16-wide store can go through a union
// of trivially constructible members.
template <typename Raw>
__device__ __forceinline__ Raw convert(float v);

template <>
__device__ __forceinline__ float convert<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ unsigned short convert<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename Raw>
__global__ void normalize_frame_kernel(const uint8_t* __restrict__ x,
                                       Raw* __restrict__ y, long long n,
                                       long long n_vec, float scale,
                                       float shift) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  for (long long v = first; v < n_vec; v += stride) {
    union {
      uint4 u;
      uint8_t b[16];
    } in;
    in.u = reinterpret_cast<const uint4*>(x)[v];
    union {
      uint4 u[sizeof(Raw)];  // 16 outputs of sizeof(Raw) bytes each
      Raw r[16];
    } out;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      out.r[k] = convert<Raw>(__fmaf_rn((float)in.b[k], scale, shift));
    }
    uint4* dst = reinterpret_cast<uint4*>(y) + v * (long long)sizeof(Raw);
#pragma unroll
    for (int k = 0; k < (int)sizeof(Raw); ++k) {
      dst[k] = out.u[k];
    }
  }

  for (long long i = n_vec * 16 + first; i < n; i += stride) {
    y[i] = convert<Raw>(__fmaf_rn((float)x[i], scale, shift));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// out_bf16 != 0 writes bf16, else f32.
extern "C" int nns_normalize_frame(const void* x, void* y, long long n,
                                   float scale, float shift, int out_bf16,
                                   void* stream) {
  if (n <= 0) return 0;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long n_vec = aligned ? n / 16 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks/SM
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    normalize_frame_kernel<unsigned short><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<unsigned short*>(y), n,
        n_vec, scale, shift);
  } else {
    normalize_frame_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(y), n, n_vec,
        scale, shift);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nns_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
