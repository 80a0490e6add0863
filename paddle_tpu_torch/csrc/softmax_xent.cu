// Fused softmax cross entropy for Hopper (sm_90a): forward and backward.
//
// Replaces: paddle_tpu/ops/pallas/softmax_xent.py, `_fwd_kernel` (launched
// by `_run_fwd`) and `_bwd_kernel` (launched by `_run_bwd`). For logits x
// (N, V), one hard label per row and a label smoothing eps, the forward
// gives per row
//   lse  = log(sum_c exp(x_c))
//   loss = lse - (1 - eps) * x[label] - (eps / V) * sum_c x_c
// (the last term only when eps != 0); a label outside [0, V) matches no
// column, so x[label] counts as 0 there and the caller masks the row. The
// backward, from the forward's lse and the upstream gradient g (N) f32:
//   dx = (exp(x - lse) - target) * g,  target = (1 - eps) onehot + eps / V
// written in the logits' dtype. Arithmetic is f32 (precise expf and logf);
// the logits are f32 or bf16.
//
// What bounds it on the H100: memory. The forward reads the logits once
// (BERT-base's masked-LM logits, 8192 x 30522 f32: 1.00 GB, 0.30 ms at
// 3.35 TB/s) for one exp an element; the backward reads them and writes
// dx (2.00 GB, 0.60 ms), an exp and a few operations an element.
//
// What the design does about it. Forward: one block per row. Each thread
// keeps an online maximum and a rescaled exp-sum over its columns, so the
// row is read once (the Pallas kernel holds the whole row in VMEM; a
// 122 KB row per block would leave the SMs a block or two each), and the
// block combines the (max, sum) pairs through warp shuffles and shared
// memory. The picked logit is one load by thread 0. Loads are 16 bytes
// wide; a row's pitch (30522 x 4 B) is 8- but not 16-byte aligned, so
// each row begins with a scalar head of up to 15 bytes. Backward:
// elementwise, one block per (row, 4096 columns), its lse, g and label
// loaded once; dx is written with the same 16-byte stores when its rows
// share the logits' alignment, else element by element. Rows whose g is 0
// (the ignored masked-LM positions) are computed all the same.

#include <math.h>

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int NT = 256;  // threads per block
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of T, loaded or stored as one vector
template <typename T>
struct Pack16;
template <>
struct Pack16<float> {
  using type = float4;
};
template <>
struct Pack16<__nv_bfloat16> {
  using type = uint4;
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const typename Pack16<T>::type raw =
        *reinterpret_cast<const typename Pack16<T>::type*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = to_f32(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(o[0]);
  } else {
    typename Pack16<T>::type raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(o[j]);
    *reinterpret_cast<typename Pack16<T>::type*>(p) = raw;
  }
}

// Elements before the row's first 16-byte boundary (0 for scalar access),
// at most v.
template <typename T, int VEC>
__device__ __forceinline__ int row_head(const T* row, int v) {
  if constexpr (VEC == 1) return 0;
  const int h = static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) / sizeof(T));
  return h < v ? h : v;
}

// One column into the thread's online (max, exp-sum) and its plain sum.
template <bool SMOOTH>
__device__ __forceinline__ void online(float x, float& m, float& s,
                                       float& sx) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
  if constexpr (SMOOTH) sx += x;
}

// (m, s) <- the pair for the union of both columns sets
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // neither has seen a column
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

template <bool SMOOTH>
__device__ __forceinline__ void warp_combine(float& m, float& s, float& sx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float s2 = __shfl_xor_sync(FULL, s, o);
    combine(m, s, m2, s2);
    if constexpr (SMOOTH) sx += __shfl_xor_sync(FULL, sx, o);
  }
}

template <typename T, int VEC, bool SMOOTH>
__global__ void __launch_bounds__(NT)
    xent_fwd(const T* __restrict__ x, const int* __restrict__ labels,
             float* __restrict__ loss, float* __restrict__ lse_out, int v,
             float keep, float spread) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  const int h = row_head<T, VEC>(xr, v);
  const int t = threadIdx.x;
  float m = -INFINITY, s = 0.f, sx = 0.f;
  if (t < h) online<SMOOTH>(to_f32(xr[t]), m, s, sx);
  for (int c = h + t * VEC; c < v; c += NT * VEC) {
    if (c + VEC <= v) {
      float e[VEC];
      load_vec<T, VEC>(xr + c, e);
#pragma unroll
      for (int j = 0; j < VEC; ++j) online<SMOOTH>(e[j], m, s, sx);
    } else {
      for (int j = c; j < v; ++j) online<SMOOTH>(to_f32(xr[j]), m, s, sx);
    }
  }

  __shared__ float red[3][NT / 32];
  const int lane = t & 31;
  const int warp = t >> 5;
  warp_combine<SMOOTH>(m, s, sx);
  if (lane == 0) {
    red[0][warp] = m;
    red[1][warp] = s;
    red[2][warp] = sx;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < NT / 32 ? red[0][lane] : -INFINITY;
  s = lane < NT / 32 ? red[1][lane] : 0.f;
  sx = lane < NT / 32 ? red[2][lane] : 0.f;
  warp_combine<SMOOTH>(m, s, sx);
  if (lane != 0) return;
  const int label = labels[row];
  const float picked = (label >= 0 && label < v) ? to_f32(xr[label]) : 0.f;
  const float lse = logf(s) + m;
  loss[row] = SMOOTH ? lse - keep * picked - spread * sx : lse - picked;
  lse_out[row] = lse;
}

template <typename T, int VEC, int ITERS, bool SMOOTH>
__global__ void __launch_bounds__(NT)
    xent_bwd(const T* __restrict__ x, const int* __restrict__ labels,
             const float* __restrict__ lse, const float* __restrict__ g,
             T* __restrict__ dx, int v, float keep, float spread) {
  constexpr int CHUNK = NT * VEC * ITERS;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  T* dr = dx + row * v;
  const int h = row_head<T, VEC>(xr, v);
  const float l = lse[row];
  const float gr = g[row];
  const int label = labels[row];
  const float hit = SMOOTH ? keep + spread : 1.f;
  const float miss = SMOOTH ? spread : 0.f;
  if (blockIdx.y == 0 && static_cast<int>(threadIdx.x) < h) {
    const int c = threadIdx.x;
    dr[c] = from_f32<T>((expf(to_f32(xr[c]) - l) - (c == label ? hit : miss))
                        * gr);
  }
  const int c0 = h + static_cast<int>(blockIdx.y) * CHUNK;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = c0 + (it * NT + static_cast<int>(threadIdx.x)) * VEC;
    if (c >= v) break;
    if (c + VEC <= v) {
      float e[VEC];
      load_vec<T, VEC>(xr + c, e);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = (expf(e[j] - l) - (c + j == label ? hit : miss)) * gr;
      store_vec<T, VEC>(dr + c, e);
    } else {
      for (int j = c; j < v; ++j)
        dr[j] = from_f32<T>(
            (expf(to_f32(xr[j]) - l) - (j == label ? hit : miss)) * gr);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int* labels, float* loss,
                       float* lse, long long n, int v, float keep,
                       float spread, bool smooth, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  if (smooth)
    xent_fwd<T, VEC, true><<<static_cast<unsigned>(n), NT, 0, stream>>>(
        xp, labels, loss, lse, v, keep, spread);
  else
    xent_fwd<T, VEC, false><<<static_cast<unsigned>(n), NT, 0, stream>>>(
        xp, labels, loss, lse, v, keep, spread);
  return cudaGetLastError();
}

template <typename T, int VEC, int ITERS>
cudaError_t launch_bwd_vec(const T* x, const int* labels, const float* lse,
                           const float* g, T* dx, long long n, int v,
                           float keep, float spread, bool smooth,
                           cudaStream_t stream) {
  constexpr int CHUNK = NT * VEC * ITERS;
  const unsigned chunks = static_cast<unsigned>((v + CHUNK - 1) / CHUNK);
  if (chunks > 65535u) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n), chunks);
  if (smooth)
    xent_bwd<T, VEC, ITERS, true><<<grid, NT, 0, stream>>>(
        x, labels, lse, g, dx, v, keep, spread);
  else
    xent_bwd<T, VEC, ITERS, false><<<grid, NT, 0, stream>>>(
        x, labels, lse, g, dx, v, keep, spread);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int* labels, const float* lse,
                       const float* g, void* dx, long long n, int v,
                       float keep, float spread, bool smooth,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* dp = static_cast<T*>(dx);
  // 16-byte stores of dx need its rows to share the logits' alignment
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(dx)) &
       15u) == 0)
    return launch_bwd_vec<T, VEC, 4096 / (NT * VEC)>(
        xp, labels, lse, g, dp, n, v, keep, spread, smooth, stream);
  return launch_bwd_vec<T, 1, 4>(xp, labels, lse, g, dp, n, v, keep, spread,
                                 smooth, stream);
}

}  // namespace

// x: (n, v) contiguous, f32 (x_bf16 0) or bf16 (1); labels: (n,) int32;
// loss, lse: (n,) f32. keep = 1 - eps and spread = eps / v; smooth != 0
// adds the eps term. Launches one kernel on `stream`; returns a CUDA error
// code.
extern "C" int softmax_xent_fwd(int device, const void* x, const void* labels,
                                void* loss, void* lse, long long n, int v,
                                float keep, float spread, int smooth,
                                int x_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (v <= 0 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int* lp = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? launch_fwd<__nv_bfloat16>(x, lp, lo, ls, n, v, keep, spread,
                                           smooth != 0, s)
               : launch_fwd<float>(x, lp, lo, ls, n, v, keep, spread,
                                   smooth != 0, s);
  return static_cast<int>(err);
}

// x, dx: (n, v) contiguous in x's dtype; labels: (n,) int32; lse, g: (n,)
// f32. Launches one kernel on `stream`; returns a CUDA error code.
extern "C" int softmax_xent_bwd(int device, const void* x, const void* labels,
                                const void* lse, const void* g, void* dx,
                                long long n, int v, float keep, float spread,
                                int smooth, int x_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (v <= 0 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int* lp = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? launch_bwd<__nv_bfloat16>(x, lp, ls, gp, dx, n, v, keep,
                                           spread, smooth != 0, s)
               : launch_bwd<float>(x, lp, ls, gp, dx, n, v, keep, spread,
                                   smooth != 0, s);
  return static_cast<int>(err);
}
