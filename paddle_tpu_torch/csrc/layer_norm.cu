// Forward layer norm for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py, `_fwd_kernel` (launched by
// `_run_fwd`). For each row of x (N, D):
//   mu   = mean(x)
//   var  = mean((x - mu)^2)      two passes over the row, as the Pallas
//                                kernel does, not E[x^2] - mu^2
//   rstd = 1 / sqrt(var + eps)
//   y    = (x - mu) * rstd * w + b
// y is written in x's dtype (f32 or bf16); mu and rstd as f32, one per row.
// w and b may be f32 or bf16 independently of x.
//
// What bounds it on the H100: memory. Each element is read once and
// written once and costs about 8 flops, far below the card's
// flop-per-byte ridge, so the least time is the bytes over the card's
// memory rate. This first version runs 3x (f32) to 7x (bf16) above that
// bound at (4096, 768) on an H100 80GB HBM3 at 700 W (PERF.md).
//
// What the design does about it: one block per row, the row held in
// registers (ITEMS elements per thread, strided by the block size so each
// warp load touches consecutive addresses), so x leaves device memory
// exactly once and both reductions read registers; each reduction is a
// warp shuffle plus one shared-memory exchange between warps. Rows too
// wide for the register budget (more than 16 elements per thread at 512
// threads) take a generic kernel that re-reads the row for each pass.

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread. `red` holds one slot
// per warp; the leading barrier keeps a previous call's readers safe.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < nwarps; ++i) t += red[i];
  return t;
}

template <typename T, typename W, int ITEMS>
__global__ void ln_fwd_registers(const T* __restrict__ x,
                                 const W* __restrict__ w,
                                 const W* __restrict__ b, T* __restrict__ y,
                                 float* __restrict__ mu_out,
                                 float* __restrict__ rstd_out, int d,
                                 float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[ITEMS];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    v[k] = i < d ? to_f32(xr[i]) : 0.f;
    s += v[k];
  }
  const float mu = block_sum(s, red) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < d) {
      const float c = v[k] - mu;
      q += c * c;
    }
  }
  const float rstd = 1.f / sqrtf(block_sum(q, red) / d + eps);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < d)
      yr[i] = from_f32<T>((v[k] - mu) * rstd * to_f32(w[i]) + to_f32(b[i]));
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename W>
__global__ void ln_fwd_generic(const T* __restrict__ x,
                               const W* __restrict__ w,
                               const W* __restrict__ b, T* __restrict__ y,
                               float* __restrict__ mu_out,
                               float* __restrict__ rstd_out, int d,
                               float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += to_f32(xr[i]);
  const float mu = block_sum(s, red) / d;
  float q = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = to_f32(xr[i]) - mu;
    q += c * c;
  }
  const float rstd = 1.f / sqrtf(block_sum(q, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f32<T>((to_f32(xr[i]) - mu) * rstd * to_f32(w[i]) +
                        to_f32(b[i]));
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, const void* b, void* y, float* mu,
            float* rstd, int n, int d, float eps, cudaStream_t stream) {
  const int threads = d <= 1024 ? 128 : (d <= 4096 ? 256 : 512);
  const int items = (d + threads - 1) / threads;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
#define PTK_LN(ITEMS)                                                  \
  ln_fwd_registers<T, W, ITEMS><<<n, threads, 0, stream>>>(xp, wp, bp, yp, \
                                                           mu, rstd, d, eps)
  if (items <= 1) {
    PTK_LN(1);
  } else if (items <= 2) {
    PTK_LN(2);
  } else if (items <= 4) {
    PTK_LN(4);
  } else if (items <= 8) {
    PTK_LN(8);
  } else if (items <= 16) {
    PTK_LN(16);
  } else {
    ln_fwd_generic<T, W><<<n, threads, 0, stream>>>(xp, wp, bp, yp, mu, rstd,
                                                    d, eps);
  }
#undef PTK_LN
}

}  // namespace

// x, y: (n, d) contiguous; w, b: (d,); mu, rstd: (n,) f32.
// x_bf16 / w_bf16 select bf16 (1) or f32 (0). Launches on `stream` and
// returns cudaGetLastError(); allocates nothing.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, void* mu, void* rstd,
                              int n, int d, float eps, int x_bf16, int w_bf16,
                              void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, m, r, n, d, eps, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, b, y, m, r, n, d, eps, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, b, y, m, r, n, d, eps, s);
  else
    launch<float, float>(x, w, b, y, m, r, n, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}
