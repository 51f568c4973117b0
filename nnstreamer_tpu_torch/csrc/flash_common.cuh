// Pieces shared by the flash-attention kernels (flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the two backward kernels): the CUDA
// headers they all include and the rounding of an f32 sum to the inputs'
// type.  Every kernel runs on the tensor cores; their tile layout, loaders
// and products are in flash_wgmma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace nns_flash {

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace nns_flash
