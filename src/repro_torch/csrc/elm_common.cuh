// Shared device helpers of the ELM kernels: the activation registry and
// the operand-dtype rounding.
//
// The activation ids follow the order of ``core/features.py``'s
// ACTIVATIONS (sigmoid, tanh, relu, sin, identity), then rbf; the
// wrappers map names to ids with ``kernels/_build.py``'s ACT_IDS. Every
// function uses the precise libm routines (no fast-math), so a kernel
// and its plain PyTorch version differ only in summation order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum ElmActivation {
  ACT_SIGMOID = 0,
  ACT_TANH = 1,
  ACT_RELU = 2,
  ACT_SIN = 3,
  ACT_IDENTITY = 4,
  ACT_RBF = 5,
};

__device__ __forceinline__ float elm_activation(int act, float z) {
  switch (act) {
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-z));
    case ACT_TANH: return tanhf(z);
    case ACT_RELU: return z < 0.0f ? 0.0f : z;  // NaN passes, as torch.relu
    case ACT_SIN: return sinf(z);
    default: return z;
  }
}

// Operand element -> f32 (exact for both operand types).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 value to the operand dtype and back (round to nearest
// even, as torch's and JAX's casts do).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
