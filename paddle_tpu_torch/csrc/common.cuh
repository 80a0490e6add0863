// Helpers shared by the port's hand-written kernels. Each kernel source
// is built into its own shared library with a plain C interface (see
// paddle_tpu_torch/ops/kernels/__init__.py); the functions below are
// compiled into every one of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptk {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Make `device` the calling thread's current device, calling
// cudaSetDevice only when it is not already: PyTorch keeps the device of
// the tensors it launches on current, so a launch usually costs just the
// thread-local read.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace ptk

// The wrapper turns a non-zero return code into a Python exception whose
// text comes from here.
extern "C" const char* ptk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
