// Backward layer norm for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py, `_bwd_kernel` (launched
// by `_ln_bwd`). From x (N, D), the upstream gradient g, the affine weight
// w and the forward's saved per-row mu and rstd, for each row:
//   xhat  = (x - mu) * rstd
//   dxhat = g * w
//   dx    = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// written in x's dtype, and over all rows
//   dw = sum g * xhat,   db = sum g
// returned in w's dtype. Statistics and sums are f32.
//
// dw and db are a reduction across every row. The Pallas kernel revisits
// one output block on its sequential grid; CUDA blocks run in any order,
// so here each block of the first kernel writes its f32 partial sums (one
// row of dw and one of db) to a workspace, and a second kernel
// (`ln_bwd_reduce`) adds the partials column by column in a fixed order.
// No float atomics: the result is the same from run to run.
//
// What bounds it on the H100: memory. x and g are read once and dx
// written once, about a dozen operations an element, far below the
// card's flop-per-byte ridge.
//
// What the design does about it (layer_norm.cuh has the shared parts):
// - rows of up to 1024 take one warp each (`ln_bwd_warp`), eight warps a
//   block, the grid sized to what the card holds at once (so the
//   partials are few: one pair of rows a block) and each warp walking its
//   rows; w is loaded once a warp; the next row's x and g are loaded
//   while the current row is worked on, so each warp keeps two rows in
//   flight; dw and db are added before the row sums, and the two row
//   sums are warp shuffles with no barrier; each lane keeps its
//   columns' dw and db in registers across its rows, and the block's
//   eight warps combine theirs in a three-level tree through shared
//   memory;
// - every access to x, g and dx moves 16 bytes a lane (4 f32 or 8 bf16)
//   where d is a multiple of that and the pointers are 16-byte aligned;
//   other rows run the same kernel one element a lane;
// - wider rows, of any width, take a block each (`ln_bwd_block`): the row
//   sums in a first pass, dx in a second that re-reads the row from L1 or
//   L2, and each thread adds its columns' dw and db into the block's own
//   partial row, which no other thread touches;
// - the partials are summed by blocks of 32 columns x 16 partial rows.

#include "layer_norm.cuh"

namespace {

using namespace ptk_ln;

// The partial rows a call may write: the wrapper's workspace holds
// min(n, MAX_PARTS) (ops/kernels/layer_norm.py BWD_MAX_PARTS).
constexpr int MAX_PARTS = 1024;

// One warp a row; lane owns chunk k's columns [(k * 32 + lane) * V, +V).
// part: (gridDim.x, 2, d) f32, this block's dw partial then db partial.
template <typename T, typename W, int V, int CH>
__global__ void __launch_bounds__(NT)
    ln_bwd_warp(const T* __restrict__ x, const W* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ rstd,
                const T* __restrict__ g, T* __restrict__ dx,
                float* __restrict__ part, int n, int d) {
  constexpr int COLS = CH * 32 * V;
  __shared__ __align__(16) float tree[WARPS / 2][2][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float wv[CH][V], dw[CH][V], db[CH][V];
  bool ok[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = (k * 32 + lane) * V;
    ok[k] = c < d;
    if (ok[k]) load<V>(w + c, wv[k]);
#pragma unroll
    for (int i = 0; i < V; ++i) dw[k][i] = db[k][i] = 0.f;
  }
  const float fd = d;
  constexpr int U = WORDS<V, T>;
  // the next row's x and g as loaded: issued a row ahead of their use
  uint32_t xn[CH][U], gn[CH][U];
  float mn = 0.f, rn = 0.f;
  const int64_t step = (int64_t)gridDim.x * WARPS;
  int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  auto fetch = [&](int64_t r) {
    mn = mu[r];
    rn = rstd[r];
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (ok[k]) {
        const int64_t off = r * d + (k * 32 + lane) * V;
        load_raw<V>(x + off, xn[k]);
        load_raw<V>(g + off, gn[k]);
      }
  };
  if (row < n) fetch(row);
  for (; row < n; row += step) {
    const float m = mn;
    const float rs = rn;
    // xv becomes xhat and gv dxhat once dw and db have their terms
    float xv[CH][V], gv[CH][V];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      unpack<V, T>(xn[k], xv[k]);
      unpack<V, T>(gn[k], gv[k]);
    }
    if (row + step < n) fetch(row + step);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (xv[k][i] - m) * rs;
          dw[k][i] += gv[k][i] * xh;
          db[k][i] += gv[k][i];
          const float dxh = gv[k][i] * wv[k][i];
          s1 += dxh;
          s2 += dxh * xh;
          xv[k][i] = xh;
          gv[k][i] = dxh;
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float m1 = s1 / fd;
    const float m2 = s2 / fd;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (ok[k]) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] = rs * (gv[k][i] - m1 - xv[k][i] * m2);
        store<V>(dx + row * d + (k * 32 + lane) * V, o);
      }
    }
  }

  // warps [h, 2h) hand their sums to warps [0, h), for h = 4, 2, 1
#pragma unroll
  for (int h = WARPS / 2; h >= 1; h /= 2) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int c = (k * 32 + lane) * V;
        if (ok[k]) {
          store<V>(&tree[warp - h][0][c], dw[k]);
          store<V>(&tree[warp - h][1][c], db[k]);
        }
      }
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int c = (k * 32 + lane) * V;
        if (ok[k]) {
          float pw[V], pb[V];
          load<V>(&tree[warp][0][c], pw);
          load<V>(&tree[warp][1][c], pb);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            dw[k][i] += pw[i];
            db[k][i] += pb[i];
          }
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* dwp = part + (int64_t)blockIdx.x * 2 * d;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * 32 + lane) * V;
      if (ok[k]) {
        store<V>(dwp + c, dw[k]);
        store<V>(dwp + d + c, db[k]);
      }
    }
  }
}

// One block a row, any d; thread owns chunks j = threadIdx.x + k * NT,
// columns [j * V, +V). The block walks rows blockIdx.x + i * gridDim.x and
// adds each row's terms into its partial row of `part`, which the first
// row writes.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(NT)
    ln_bwd_block(const T* __restrict__ x, const W* __restrict__ w,
                 const float* __restrict__ mu, const float* __restrict__ rstd,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ part, int n, int d) {
  __shared__ float red[64];
  const int chunks = d / V;
  float* dwp = part + (int64_t)blockIdx.x * 2 * d;
  float* dbp = dwp + d;
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    const float m = mu[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
    for (int j = threadIdx.x; j < chunks; j += NT) {
      float xv[V], gv[V], wv[V];
      load<V>(xr + j * V, xv);
      load<V>(gr + j * V, gv);
      load<V>(w + j * V, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dxh = gv[i] * wv[i];
        s1 += dxh;
        s2 += dxh * (xv[i] - m) * rs;
      }
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 / d;
    const float m2 = s2 / d;
#pragma unroll 2
    for (int j = threadIdx.x; j < chunks; j += NT) {
      float xv[V], gv[V], wv[V], pw[V], pb[V], o[V];
      load<V>(xr + j * V, xv);
      load<V>(gr + j * V, gv);
      load<V>(w + j * V, wv);
      if (first) {
#pragma unroll
        for (int i = 0; i < V; ++i) pw[i] = pb[i] = 0.f;
      } else {
        load<V>(dwp + j * V, pw);
        load<V>(dbp + j * V, pb);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (xv[i] - m) * rs;
        o[i] = rs * (gv[i] * wv[i] - m1 - xh * m2);
        pw[i] += gv[i] * xh;
        pb[i] += gv[i];
      }
      store<V>(dx + row * d + j * V, o);
      store<V>(dwp + j * V, pw);
      store<V>(dbp + j * V, pb);
    }
  }
}

// dw[c] (blockIdx.y 0) or db[c] (1) = the sum of the nparts partials, for
// 32 columns a block: 16 threads a column each add every 16th partial,
// then one adds the 16 in order.
template <typename W>
__global__ void ln_bwd_reduce(const float* __restrict__ part, int nparts,
                              int d, W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float s[16][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int which = blockIdx.y;
  float acc = 0.f;
  if (c < d)
#pragma unroll 4
    for (int i = threadIdx.y; i < nparts; i += 16)
      acc += part[((int64_t)i * 2 + which) * d + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) t += s[i][threadIdx.x];
    (which ? db : dw)[c] = from_f32<W>(t);
  }
}

template <typename T, typename W, int V>
cudaError_t launch(int device, const void* x, const void* w, const float* mu,
                   const float* rstd, const void* g, void* dx, void* dw,
                   void* db, float* part, int n, int d, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  const int64_t most = std::min(n, MAX_PARTS);
  int grid = 0;
  cudaError_t err = cudaSuccess;
  if (d > MAX_WARP_D) {
    static std::atomic<int> cache[MAX_DEVICES];
    auto kernel = ln_bwd_block<T, W, V>;
    err = resident_blocks(kernel, cache, device, &grid);
    if (err != cudaSuccess) return err;
    grid = std::min<int64_t>(grid, most);
    kernel<<<grid, NT, 0, stream>>>(xp, wp, mu, rstd, gp, dxp, part, n, d);
    err = cudaGetLastError();
  } else {
    with_chunks<V>((d + 32 * V - 1) / (32 * V), [&](auto ch) {
      constexpr int CH = decltype(ch)::value;
      static std::atomic<int> cache[MAX_DEVICES];
      auto kernel = ln_bwd_warp<T, W, V, CH>;
      err = resident_blocks(kernel, cache, device, &grid);
      if (err != cudaSuccess) return;
      grid = std::min<int64_t>({grid, (n + WARPS - 1) / WARPS, most});
      kernel<<<grid, NT, 0, stream>>>(xp, wp, mu, rstd, gp, dxp, part, n, d);
      err = cudaGetLastError();
    });
  }
  if (err != cudaSuccess) return err;
  ln_bwd_reduce<W><<<dim3((d + 31) / 32, 2), dim3(32, 16), 0, stream>>>(
      part, grid, d, static_cast<W*>(dw), static_cast<W*>(db));
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_dtypes(int device, int vec, const void* x, const void* w,
                          const float* mu, const float* rstd, const void* g,
                          void* dx, void* dw, void* db, float* part, int n,
                          int d, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec == 1)
    return launch<T, W, 1>(device, x, w, mu, rstd, g, dx, dw, db, part, n, d,
                           stream);
  if (vec != VEC || d % VEC != 0) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(g) || !aligned16(dx) ||
      !aligned16(part))
    return cudaErrorMisalignedAddress;
  return launch<T, W, VEC>(device, x, w, mu, rstd, g, dx, dw, db, part, n, d,
                           stream);
}

}  // namespace

// x, g, dx: (n, d) with rows packed, in x's dtype; w, dw, db: (d,) in w's
// dtype; mu, rstd: (n,) f32; part: workspace of (min(n, 1024), 2, d) f32.
// Any d. x_bf16 / w_bf16 select bf16 (1) or f32 (0). vec is 1 (one
// element a lane an access) or 16 / x's element size (16 bytes an access:
// d must be a multiple of it and x, w, g, dx and part 16-byte aligned,
// else the call returns an error and launches nothing). Launches two
// kernels on `stream` and returns a CUDA error code; allocates nothing.
extern "C" int layer_norm_bwd(int device, const void* x, const void* w,
                              const void* mu, const void* rstd, const void* g,
                              void* dx, void* dw, void* db, void* part, int n,
                              int d, int x_bf16, int w_bf16, int vec,
                              void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  if (x_bf16 && w_bf16)
    err = launch_dtypes<__nv_bfloat16, __nv_bfloat16>(
        device, vec, x, w, m, r, g, dx, dw, db, pp, n, d, s);
  else if (x_bf16)
    err = launch_dtypes<__nv_bfloat16, float>(device, vec, x, w, m, r, g, dx,
                                              dw, db, pp, n, d, s);
  else if (w_bf16)
    err = launch_dtypes<float, __nv_bfloat16>(device, vec, x, w, m, r, g, dx,
                                              dw, db, pp, n, d, s);
  else
    err = launch_dtypes<float, float>(device, vec, x, w, m, r, g, dx, dw, db,
                                      pp, n, d, s);
  return static_cast<int>(err);
}
