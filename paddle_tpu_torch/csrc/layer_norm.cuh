// What the forward (layer_norm.cu) and backward (layer_norm_bwd.cu)
// layer-norm kernels share: loads and stores of V consecutive elements,
// warp and block sums, the chunk counts each instance is built for, and
// the grid that fills the card once.
//
// A lane (or, in the block-per-row kernels, a thread) owns chunks of V
// consecutive columns. The vector instances run with V = 16 / sizeof(x's
// dtype), so that every access to x, g, y and dx moves 16 bytes; they
// need d % V == 0 and 16-byte aligned pointers (the wrapper decides,
// ops/kernels/layer_norm.py `vector_width`, and the entry points check).
// The scalar instances run with V = 1 and take any d and any pointer.
#pragma once

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace ptk_ln {

using ptk::from_f32;
using ptk::to_f32;

constexpr int WARPS = 8;            // warps a block in the warp-per-row kernels
constexpr int NT = 32 * WARPS;      // threads a block, in every kernel here
constexpr int MAX_WARP_D = 1024;    // widest row a warp holds in registers

// 32-bit words that hold V elements of T as loaded (one for V = 1)
template <int V, typename T>
constexpr int WORDS =
    V * sizeof(T) >= 4 ? V * static_cast<int>(sizeof(T)) / 4 : 1;

// u = the bits of p[0..V). V * sizeof(T) is 4 (one f32 or bf16), 8, 16
// or 32 bytes; p is aligned to 16 bytes or to the whole access if less.
template <int V, typename T>
__device__ __forceinline__ void load_raw(const T* p, uint32_t* u) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>)
      u[0] = __float_as_uint(*p);
    else
      u[0] = __bfloat16_as_ushort(*p);
  } else if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      u[4 * k] = q.x;
      u[4 * k + 1] = q.y;
      u[4 * k + 2] = q.z;
      u[4 * k + 3] = q.w;
    }
  } else {
    static_assert(BYTES == 8, "8-, 16- or 32-byte chunks");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x;
    u[1] = q.y;
  }
}

// v[0..V) = the V elements of T in u, in f32
template <int V, typename T>
__device__ __forceinline__ void unpack(const uint32_t* u, float* v) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __uint_as_float(u[i]);
  } else if constexpr (V == 1) {
    v[0] = __uint_as_float(u[0] << 16);
  } else {  // two bf16 a word, the lower column in the low half
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// v[0..V) = p[0..V) in f32
template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float* v) {
  uint32_t u[WORDS<V, T>];
  load_raw<V>(p, u);
  unpack<V, T>(u, v);
}

// p[0..V) = v[0..V), rounded to T (round to nearest even for bf16).
template <int V, typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    constexpr int BYTES = V * static_cast<int>(sizeof(T));
    uint32_t u[BYTES / 4];
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        u[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k)
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums of a and b over the block, returned to every thread: warp
// shuffles, then one exchange through `red` (64 floats). The leading
// barrier keeps a previous call's readers safe.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < nwarps; ++i) {
    a += red[i];
    b += red[32 + i];
  }
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<CH>()) for the least chunk count CH >= need that the warp-per-row
// kernels are built for at vector width V (CH * 32 * V <= MAX_WARP_D).
template <int V, typename F>
void with_chunks(int need, F&& f) {
  if constexpr (V == 1) {
    if (need <= 1) f(Int<1>());
    else if (need <= 2) f(Int<2>());
    else if (need <= 4) f(Int<4>());
    else if (need <= 8) f(Int<8>());
    else if (need <= 16) f(Int<16>());
    else if (need <= 24) f(Int<24>());
    else f(Int<32>());
  } else if constexpr (V == 4) {
    if (need <= 1) f(Int<1>());
    else if (need <= 2) f(Int<2>());
    else if (need <= 4) f(Int<4>());
    else if (need <= 6) f(Int<6>());
    else f(Int<8>());
  } else {
    static_assert(V == 8, "vector width 1, 4 (f32) or 8 (bf16)");
    if (need <= 1) f(Int<1>());
    else if (need <= 2) f(Int<2>());
    else if (need <= 3) f(Int<3>());
    else f(Int<4>());
  }
}

constexpr int MAX_DEVICES = 64;

// *blocks = the blocks of `kernel` (NT threads) the whole card holds at
// once, queried once a device; `cache` is the calling instance's own.
template <typename K>
cudaError_t resident_blocks(K kernel, std::atomic<int>* cache, int device,
                            int* blocks) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int have = cache[device].load(std::memory_order_relaxed);
  if (have == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    have = per_sm * sms > 0 ? per_sm * sms : 1;
    cache[device].store(have, std::memory_order_relaxed);
  }
  *blocks = have;
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace ptk_ln
