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
// row of dw and one of db) to a workspace, and a second kernel adds the
// partials column by column in a fixed order. No float atomics: the
// result is the same from run to run.
//
// What bounds it on the H100: memory. x and g are read once and dx
// written once, about a dozen operations an element, far below the
// card's flop-per-byte ridge; the workspace adds 2 * D * 4 bytes per 16
// rows (1/24 of the traffic at BERT's (8192, 768) in f32).
//
// What the design does about it: rows of up to 1024 elements are handled
// by one warp each (eight per block, two rows a warp), the row held in
// registers, so each row's two sums are warp shuffles with no barrier;
// each lane keeps its columns' dw and db partials in registers across its
// rows, and the eight warps combine theirs through shared memory in a
// fixed order. Wider rows, up to 8192, take the whole block of 256
// threads per row, with the sums exchanged between warps through shared
// memory.

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int NT = 256;              // threads per block
constexpr int ROWS_PER_BLOCK = 16;   // rows of x per block (and partial)

// The sums of a and b over the TPR threads of one row group, returned to
// each of them: warp shuffles, then (TPR > 32) one exchange between the
// block's warps through `red` (64 floats).
template <int TPR>
__device__ __forceinline__ void group_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (TPR > 32) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // a previous call's readers are done
    if (lane == 0) {
      red[warp] = a;
      red[32 + warp] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) {
      a += red[i];
      b += red[32 + i];
    }
  }
}

// TPR threads per row (32: a warp; NT: the block), ITEMS columns each.
// part: (gridDim.x, 2, d) f32, this block's dw partial then db partial.
template <typename T, typename W, int TPR, int ITEMS>
__global__ void __launch_bounds__(NT)
    ln_bwd_rows(const T* __restrict__ x, const W* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ rstd,
                const T* __restrict__ g, T* __restrict__ dx,
                float* __restrict__ part, int n, int d) {
  constexpr int GROUPS = NT / TPR;
  constexpr int RPG = ROWS_PER_BLOCK / GROUPS;  // rows per group
  __shared__ float red[64];
  extern __shared__ float colsum[];  // [2][d], when GROUPS > 1
  const int grp = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;

  float wv[ITEMS], dw[ITEMS], db[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int c = lane + k * TPR;
    wv[k] = c < d ? to_f32(w[c]) : 0.f;
    dw[k] = 0.f;
    db[k] = 0.f;
  }

  for (int rr = 0; rr < RPG; ++rr) {
    // uniform across the group (and, for TPR == NT, the block)
    const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + rr * GROUPS +
                        grp;
    if (row >= n) break;
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    const float m = mu[row];
    const float rs = rstd[row];
    float xh[ITEMS], gv[ITEMS];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = lane + k * TPR;
      xh[k] = c < d ? (to_f32(xr[c]) - m) * rs : 0.f;
      gv[k] = c < d ? to_f32(gr[c]) : 0.f;
      const float dxh = gv[k] * wv[k];
      s1 += dxh;
      s2 += dxh * xh[k];
    }
    group_sum2<TPR>(s1, s2, red);
    const float m1 = s1 / d;
    const float m2 = s2 / d;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = lane + k * TPR;
      if (c < d) {
        dx[row * d + c] = from_f32<T>(rs * (gv[k] * wv[k] - m1 - xh[k] * m2));
        dw[k] += gv[k] * xh[k];
        db[k] += gv[k];
      }
    }
  }

  float* dwp = part + (int64_t)blockIdx.x * 2 * d;
  float* dbp = dwp + d;
  if constexpr (GROUPS == 1) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c = lane + k * TPR;
      if (c < d) {
        dwp[c] = dw[k];
        dbp[c] = db[k];
      }
    }
  } else {
    // the groups add into shared memory one after another: a fixed order
    for (int gi = 0; gi < GROUPS; ++gi) {
      if (grp == gi) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int c = lane + k * TPR;
          if (c < d) {
            colsum[c] = (gi == 0 ? 0.f : colsum[c]) + dw[k];
            colsum[d + c] = (gi == 0 ? 0.f : colsum[d + c]) + db[k];
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < d; c += NT) {
      dwp[c] = colsum[c];
      dbp[c] = colsum[d + c];
    }
  }
}

// dw[c] (blockIdx.y 0) or db[c] (1) = the sum of the nparts partials, for
// 32 columns a block: 8 threads a column each add every 8th partial, then
// one adds the 8 in order.
template <typename W>
__global__ void ln_bwd_reduce(const float* __restrict__ part, int nparts,
                              int d, W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int which = blockIdx.y;
  float acc = 0.f;
  if (c < d)
    for (int i = threadIdx.y; i < nparts; i += 8)
      acc += part[((int64_t)i * 2 + which) * d + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][threadIdx.x];
    (which ? db : dw)[c] = from_f32<W>(t);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const float* mu,
                   const float* rstd, const void* g, void* dx, void* dw,
                   void* db, float* part, int n, int d, cudaStream_t stream) {
  const int nblocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  const size_t warp_smem = 2 * d * sizeof(float);
#define PTK_LNB(TPR, ITEMS, SMEM)                                        \
  ln_bwd_rows<T, W, TPR, ITEMS><<<nblocks, NT, SMEM, stream>>>(           \
      xp, wp, mu, rstd, gp, dxp, part, n, d)
  if (d <= 128) {
    PTK_LNB(32, 4, warp_smem);
  } else if (d <= 256) {
    PTK_LNB(32, 8, warp_smem);
  } else if (d <= 512) {
    PTK_LNB(32, 16, warp_smem);
  } else if (d <= 768) {
    PTK_LNB(32, 24, warp_smem);
  } else if (d <= 1024) {
    PTK_LNB(32, 32, warp_smem);
  } else if (d <= 2048) {
    PTK_LNB(NT, 8, 0);
  } else if (d <= 4096) {
    PTK_LNB(NT, 16, 0);
  } else {
    PTK_LNB(NT, 32, 0);
  }
#undef PTK_LNB
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce<W><<<dim3((d + 31) / 32, 2), dim3(32, 8), 0, stream>>>(
      part, nblocks, d, static_cast<W*>(dw), static_cast<W*>(db));
  return cudaGetLastError();
}

}  // namespace

// x, g, dx: (n, d) contiguous, in x's dtype; w, dw, db: (d,) in w's
// dtype; mu, rstd: (n,) f32; part: workspace of (ceil(n / 16), 2, d) f32.
// d at most 8192. x_bf16 / w_bf16 select bf16 (1) or f32 (0). Launches
// two kernels on `stream` and returns a CUDA error code; allocates
// nothing.
extern "C" int layer_norm_bwd(int device, const void* x, const void* w,
                              const void* mu, const void* rstd, const void* g,
                              void* dx, void* dw, void* db, void* part, int n,
                              int d, int x_bf16, int w_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || d <= 0) return 0;
  if (d > 8192) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  if (x_bf16 && w_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, m, r, g, dx, dw, db, pp,
                                               n, d, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, w, m, r, g, dx, dw, db, pp, n, d,
                                       s);
  else if (w_bf16)
    err = launch<float, __nv_bfloat16>(x, w, m, r, g, dx, dw, db, pp, n, d,
                                       s);
  else
    err = launch<float, float>(x, w, m, r, g, dx, dw, db, pp, n, d, s);
  return static_cast<int>(err);
}
