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
// memory rate.
//
// What the design does about it (layer_norm.cuh has the shared parts):
// - rows of up to 1024 take one warp each (`ln_fwd_warp`), eight warps a
//   block, the grid sized to what the card holds at once and each warp
//   walking its rows; w and b are loaded once a warp and kept in
//   registers; the row stays in registers, so x leaves device memory
//   once, and both sums are warp shuffles with no barrier; the next
//   row's x is loaded while the current row is worked on;
// - every access to x and y moves 16 bytes a lane (4 f32 or 8 bf16) where
//   d is a multiple of that and the pointers are 16-byte aligned; other
//   rows run the same kernel one element a lane;
// - wider rows take a block each (`ln_fwd_block`), in the same vector or
//   scalar access, re-reading the row from L1 or L2 for each pass.

#include "layer_norm.cuh"

namespace {

using namespace ptk_ln;

// One warp a row; lane owns chunk k's columns [(k * 32 + lane) * V, +V).
template <typename T, typename W, int V, int CH>
__global__ void __launch_bounds__(NT)
    ln_fwd_warp(const T* __restrict__ x, const W* __restrict__ w,
                const W* __restrict__ b, T* __restrict__ y,
                float* __restrict__ mu_out, float* __restrict__ rstd_out,
                int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float wv[CH][V], bv[CH][V];
  bool ok[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = (k * 32 + lane) * V;
    ok[k] = c < d;
    if (ok[k]) {
      load<V>(w + c, wv[k]);
      load<V>(b + c, bv[k]);
    }
  }
  const float fd = d;
  constexpr int U = WORDS<V, T>;
  // the next row's x as loaded: issued a row ahead of its use
  uint32_t xn[CH][U];
  const int64_t step = (int64_t)gridDim.x * WARPS;
  int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  auto fetch = [&](int64_t r) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (ok[k]) load_raw<V>(x + r * d + (k * 32 + lane) * V, xn[k]);
  };
  if (row < n) fetch(row);
  for (; row < n; row += step) {
    float v[CH][V];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (ok[k]) {
        unpack<V, T>(xn[k], v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.f;
      }
    }
    if (row + step < n) fetch(row + step);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[k][i];
    const float mu = warp_sum(s) / fd;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (ok[k])
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float c = v[k][i] - mu;
          q += c * c;
        }
    const float rstd = 1.f / sqrtf(warp_sum(q) / fd + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (ok[k]) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] = (v[k][i] - mu) * rstd * wv[k][i] + bv[k][i];
        store<V>(yr + (k * 32 + lane) * V, o);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// One block a row (any d); thread owns chunks j = threadIdx.x + k * NT,
// columns [j * V, +V). Three passes over the row: sum, centred squares,
// output; the second and third re-read it from L1 or L2.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(NT)
    ln_fwd_block(const T* __restrict__ x, const W* __restrict__ w,
                 const W* __restrict__ b, T* __restrict__ y,
                 float* __restrict__ mu_out, float* __restrict__ rstd_out,
                 int d, float eps) {
  __shared__ float red[64];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int chunks = d / V;
  float s = 0.f, unused = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < chunks; j += NT) {
    float v[V];
    load<V>(xr + j * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[i];
  }
  block_sum2(s, unused, red);
  const float mu = s / d;
  float q = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < chunks; j += NT) {
    float v[V];
    load<V>(xr + j * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) q += (v[i] - mu) * (v[i] - mu);
  }
  block_sum2(q, unused, red);
  const float rstd = 1.f / sqrtf(q / d + eps);
#pragma unroll 2
  for (int j = threadIdx.x; j < chunks; j += NT) {
    float v[V], wv[V], bv[V], o[V];
    load<V>(xr + j * V, v);
    load<V>(w + j * V, wv);
    load<V>(b + j * V, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (v[i] - mu) * rstd * wv[i] + bv[i];
    store<V>(yr + j * V, o);
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename W, int V>
cudaError_t launch(int device, const void* x, const void* w, const void* b,
                   void* y, float* mu, float* rstd, int n, int d, float eps,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  if (d > MAX_WARP_D) {
    ln_fwd_block<T, W, V><<<n, NT, 0, stream>>>(xp, wp, bp, yp, mu, rstd, d,
                                                eps);
    return cudaGetLastError();
  }
  cudaError_t err = cudaSuccess;
  with_chunks<V>((d + 32 * V - 1) / (32 * V), [&](auto ch) {
    constexpr int CH = decltype(ch)::value;
    static std::atomic<int> cache[MAX_DEVICES];
    auto kernel = ln_fwd_warp<T, W, V, CH>;
    int blocks = 0;
    err = resident_blocks(kernel, cache, device, &blocks);
    if (err != cudaSuccess) return;
    const int grid = std::min<int64_t>(blocks, (n + WARPS - 1) / WARPS);
    kernel<<<grid, NT, 0, stream>>>(xp, wp, bp, yp, mu, rstd, n, d, eps);
    err = cudaGetLastError();
  });
  return err;
}

template <typename T, typename W>
cudaError_t launch_dtypes(int device, int vec, const void* x, const void* w,
                          const void* b, void* y, float* mu, float* rstd,
                          int n, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec == 1)
    return launch<T, W, 1>(device, x, w, b, y, mu, rstd, n, d, eps, stream);
  if (vec != VEC || d % VEC != 0) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(b) || !aligned16(y))
    return cudaErrorMisalignedAddress;
  return launch<T, W, VEC>(device, x, w, b, y, mu, rstd, n, d, eps, stream);
}

}  // namespace

// x, y: (n, d) with rows packed; w, b: (d,); mu, rstd: (n,) f32.
// x_bf16 / w_bf16 select bf16 (1) or f32 (0). vec is 1 (one element a
// lane an access) or 16 / x's element size (16 bytes an access: d must be
// a multiple of it and x, w, b and y 16-byte aligned, else the call
// returns an error and launches nothing). Launches on `stream` and returns
// a CUDA error code; allocates nothing.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, void* mu, void* rstd,
                              int n, int d, float eps, int x_bf16, int w_bf16,
                              int vec, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (x_bf16 && w_bf16)
    err = launch_dtypes<__nv_bfloat16, __nv_bfloat16>(device, vec, x, w, b, y,
                                                      m, r, n, d, eps, s);
  else if (x_bf16)
    err = launch_dtypes<__nv_bfloat16, float>(device, vec, x, w, b, y, m, r,
                                              n, d, eps, s);
  else if (w_bf16)
    err = launch_dtypes<float, __nv_bfloat16>(device, vec, x, w, b, y, m, r,
                                              n, d, eps, s);
  else
    err = launch_dtypes<float, float>(device, vec, x, w, b, y, m, r, n, d,
                                      eps, s);
  return static_cast<int>(err);
}
