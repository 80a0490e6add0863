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

// Attention dropout's keep decision: a pure function of (seed0, seed1,
// batch*head, query row, key column), so the forward and both backward
// kernels regenerate the same mask and none stores it. The coordinates
// are folded into seed1 with the murmur-style absorb of the Pallas
// kernels' `_dropout_keep` (xor, odd multiply, logical shift-xor, twice),
// then seed0 is xored in and murmur3's finalizer spreads the result over
// all 32 bits. The element is kept when the bits are >= threshold =
// min(p * 2^32, 2^32 - 1). The plain PyTorch version
// (ops/kernels/flash_attention.py, `dropout_keep_mask`) computes the same
// bits with int64 arithmetic masked to 32 bits.
__device__ __forceinline__ uint32_t dropout_absorb(uint32_t h, uint32_t v) {
  h = (h ^ v) * 0x9E3779B9u;
  h ^= h >> 15;
  h *= 0xB40E609Fu;
  h ^= h >> 13;
  return h;
}

// the part of the hash shared by one query row: seed1, bh and the row
__device__ __forceinline__ uint32_t dropout_row(uint32_t seed1, uint32_t bh,
                                                uint32_t row) {
  return dropout_absorb(dropout_absorb(seed1, bh), row);
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_hash,
                                             uint32_t seed0, uint32_t col,
                                             uint32_t threshold) {
  uint32_t h = dropout_absorb(row_hash, col) ^ seed0;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= threshold;
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
