// Training-mode batch norm over channels-last rows for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/batch_norm.py, the four Pallas kernels
// `_stats_kernel` (launched by `_stats`), `_norm_kernel` (`_normalize`),
// `_bwd_reduce_kernel` and `_bwd_dx_kernel` (both launched by `_bn_bwd`).
// x is viewed as (M, C) rows with the channel contiguous:
//
//   batch_norm_stats       s = sum(x - c), s2 = sum((x - c)^2) per channel in
//                          f32, c = the first row of x (the shift keeps the
//                          variance at a large mean), then
//                          mean = s/M + c, var = max(s2/M - (s/M)^2, 0)
//                          and, given w, b and eps, rstd = rsqrt(var + eps),
//                          scale = rstd w, shift = b - mean scale
//   batch_norm_normalize   y = x * scale + shift in f32, stored in x's type
//   batch_norm_bwd_reduce  dgamma = sum g * xhat, dbeta = sum g, with
//                          xhat = (x - mean) * rstd, in f32
//   batch_norm_bwd_dx      dx = w rstd (g - dbeta/M - xhat dgamma/M) + gm/M
//                          + (2/M)(x - mean) gv, stored in x's type (gm, gv
//                          the cotangents of the mean and variance outputs)
//
// The Pallas reductions revisit one (1, C) output block on a sequential
// grid. CUDA blocks run in any order, so here a block sums a chunk of rows
// for a tile of channels into an f32 workspace row, and a finishing kernel
// adds the chunks' rows column by column in a fixed order: no float
// atomics, the same bits from run to run. The per-channel arithmetic
// around the Pallas calls (jnp lines in the reference: mean, var, rstd,
// scale, shift after the stats; w rstd, the divisions by M and the stacked
// cotangents before dx) sits in the stats kernel's finishing pass and at
// the head of the dx kernel: as a dozen PyTorch operations a layer on (C,)
// tensors it cost the training step more host time than the four kernels
// cost the card (1,431 of a step's 2,850 launches on an H100).
//
// What bounds them on the H100: memory, all four. A handful of operations
// an element against 2 to 6 bytes an element in bf16.
//
// What the design does about it: every global access is a 16-byte load or
// store (8 bf16 or 4 f32 channels a thread) with neighbouring threads on
// neighbouring addresses, whatever C is: a block is TX threads across the
// channel vectors by 256 / TX down the rows, TX = 8, 16 or 32, so that at
// C = 64 in bf16 (a 128-byte row) a warp covers four whole rows and at
// C = 2048 it covers 512 bytes of one row. A thread keeps its channels for
// all its rows: the per-channel operands sit in registers, loaded once,
// and the sums are register accumulators joined through shared memory at
// the end, in a fixed order. A thread starts the loads of four rows (two
// where it reads x and g) before it uses any, to keep enough bytes in
// flight. Row chunks are sized so that about a thousand blocks cover the
// card. Where C is not a multiple of the vector width, or a pointer is not
// 16-byte aligned, the same kernels run with one channel a thread. Offsets
// are 64-bit: M * C passes 2^31 at real batch sizes.

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int NT = 256;  // threads per block

// VEC channels as they lie in memory: one 16-byte word where VEC > 1.
template <typename T, int VEC>
struct Raw {
  uint4 q;
};
template <typename T>
struct Raw<T, 1> {
  T q;
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* __restrict__ p) {
  Raw<T, VEC> r;
  if constexpr (VEC == 1) {
    r.q = p[0];
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    r.q = *reinterpret_cast<const uint4*>(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(r.q);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(r.q.x);
    v[1] = __uint_as_float(r.q.y);
    v[2] = __uint_as_float(r.q.z);
    v[3] = __uint_as_float(r.q.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC channels at p as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  unpack<T, VEC>(load_raw<T, VEC>(p), v);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// VEC per-channel f32 operands at p (always f32, so VEC of them are one
// or two 16-byte loads; scalar loads keep it simple and are done once).
template <int VEC>
__device__ __forceinline__ void load_chan(const float* __restrict__ p,
                                          float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = p[i];
}

// How a block is laid over the rows: thread (tx, ty) owns channel vector
// blockIdx.x * TX + tx and rows row0 + ty, row0 + ty + TY, ... of the
// block's chunk [row0, row1).
struct Tile {
  int tx, ty, TX, TY;
  int cv;        // this thread's channel vector
  int64_t row0;  // first row of the block's chunk
  int64_t row1;  // one past its last row
};

__device__ __forceinline__ Tile make_tile(int TX, int m, int rows_per_chunk) {
  Tile t;
  t.TX = TX;
  t.TY = NT / TX;
  t.tx = threadIdx.x % TX;
  t.ty = threadIdx.x / TX;
  t.cv = blockIdx.x * TX + t.tx;
  t.row0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t end = t.row0 + rows_per_chunk;
  t.row1 = end < m ? end : (int64_t)m;
  return t;
}

// Join the block's per-thread accumulators acc[K] (K sums for each of VEC
// channels, laid out acc[k * VEC + i]) over ty, in the order ty = 0, 1, ...,
// and write sum k of channel ch to part[(chunk * K + k) * c + ch].
template <int VEC, int K>
__device__ __forceinline__ void join_rows(const Tile& t,
                                          const float (&acc)[K * VEC],
                                          float* smem, float* part, int c,
                                          int cvecs) {
  constexpr int W = K * VEC;  // floats a thread contributes
  // smem[ty][tx][W], padded by one float a thread against bank conflicts
  float* mine = smem + ((size_t)t.ty * t.TX + t.tx) * (W + 1);
#pragma unroll
  for (int j = 0; j < W; ++j) mine[j] = acc[j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < t.TX * W; idx += NT) {
    const int tx = idx / W;
    const int j = idx % W;
    const int cv = blockIdx.x * t.TX + tx;
    if (cv >= cvecs) continue;
    float s = 0.f;
    for (int ty = 0; ty < t.TY; ++ty)
      s += smem[((size_t)ty * t.TX + tx) * (W + 1) + j];
    const int k = j / VEC;
    const int ch = cv * VEC + j % VEC;
    part[((size_t)blockIdx.y * K + k) * c + ch] = s;
  }
}

// Walk this thread's rows U at a time: `f(off, n)` gets the element
// offsets of the thread's vector in its next n rows, n = U, or 1 for the
// rows left over at the end.
template <int U, typename F>
__device__ __forceinline__ void for_rows(const Tile& t, int c, int vec,
                                         F&& f) {
  const int64_t col = (int64_t)t.cv * vec;
  int64_t r = t.row0 + t.ty;
  for (; r + (int64_t)(U - 1) * t.TY < t.row1; r += (int64_t)U * t.TY) {
    int64_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) off[u] = (r + (int64_t)u * t.TY) * c + col;
    f(off, U);
  }
  for (; r < t.row1; r += t.TY) {
    int64_t off[U];
    off[0] = r * c + col;
    f(off, 1);
  }
}

// part: (gridDim.y, 2, c) f32: this chunk's sum(x - c0) then sum((x - c0)^2)
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_stats_rows(const T* __restrict__ x, float* __restrict__ part, int m,
                  int c, int TX, int rows_per_chunk) {
  constexpr int U = 4;
  extern __shared__ float smem[];
  const Tile t = make_tile(TX, m, rows_per_chunk);
  const int cvecs = c / VEC;
  float acc[2 * VEC];
#pragma unroll
  for (int j = 0; j < 2 * VEC; ++j) acc[j] = 0.f;
  if (t.cv < cvecs) {
    float c0[VEC];
    load_vec<T, VEC>(x + (int64_t)t.cv * VEC, c0);  // the first row
    for_rows<U>(t, c, VEC, [&](const int64_t(&off)[U], int n) {
      Raw<T, VEC> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < n) raw[u] = load_raw<T, VEC>(x + off[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) {
          float v[VEC];
          unpack<T, VEC>(raw[u], v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float d = v[i] - c0[i];
            acc[i] += d;
            acc[VEC + i] += d * d;
          }
        }
      }
    });
  }
  join_rows<VEC, 2>(t, acc, smem, part, c, cvecs);
}

// The finishing kernels: blocks of (32 channels, FY threads each). A
// thread adds every FY-th chunk's two partial sums of its channel, in
// order; then thread 0 of the channel adds the FY results, in order.
constexpr int FY = 32;

__device__ __forceinline__ void sum_parts(const float* __restrict__ part,
                                          int nparts, int c, int ch,
                                          float (*s)[FY][33], float& a,
                                          float& b) {
  float pa = 0.f, pb = 0.f;
  if (ch < c)
    for (int i = threadIdx.y; i < nparts; i += FY) {
      pa += part[((size_t)i * 2) * c + ch];
      pb += part[((size_t)i * 2 + 1) * c + ch];
    }
  s[0][threadIdx.y][threadIdx.x] = pa;
  s[1][threadIdx.y][threadIdx.x] = pb;
  __syncthreads();
  a = 0.f;
  b = 0.f;
  if (threadIdx.y == 0) {
#pragma unroll
    for (int i = 0; i < FY; ++i) {
      a += s[0][i][threadIdx.x];
      b += s[1][i][threadIdx.x];
    }
  }
}

// mean and var, and where w is given rstd, scale and shift too
template <typename T>
__global__ void bn_stats_finish(const T* __restrict__ x,
                                const float* __restrict__ part, int nparts,
                                int m, int c, const float* __restrict__ w,
                                const float* __restrict__ b, float eps,
                                float* __restrict__ mean,
                                float* __restrict__ var,
                                float* __restrict__ rstd,
                                float* __restrict__ scale,
                                float* __restrict__ shift) {
  __shared__ float s[2][FY][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float s1, s2;
  sum_parts(part, nparts, c, ch, s, s1, s2);
  if (threadIdx.y == 0 && ch < c) {
    const float ms = s1 / m;
    const float mu = ms + to_f32(x[ch]);
    const float v = fmaxf(s2 / m - ms * ms, 0.f);
    mean[ch] = mu;
    var[ch] = v;
    if (w != nullptr) {
      const float rs = rsqrtf(v + eps);
      const float sc = rs * w[ch];
      rstd[ch] = rs;
      scale[ch] = sc;
      shift[ch] = b[ch] - mu * sc;
    }
  }
}

__global__ void bn_bwd_finish(const float* __restrict__ part, int nparts,
                              int c, float* __restrict__ dgamma,
                              float* __restrict__ dbeta) {
  __shared__ float s[2][FY][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float a, b;
  sum_parts(part, nparts, c, ch, s, a, b);
  if (threadIdx.y == 0 && ch < c) {
    dgamma[ch] = a;
    dbeta[ch] = b;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_normalize_rows(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ y,
                      int m, int c, int TX, int rows_per_chunk) {
  constexpr int U = 4;
  const Tile t = make_tile(TX, m, rows_per_chunk);
  if (t.cv >= c / VEC) return;
  float sc[VEC], sh[VEC];
  load_chan<VEC>(scale + t.cv * VEC, sc);
  load_chan<VEC>(shift + t.cv * VEC, sh);
  for_rows<U>(t, c, VEC, [&](const int64_t(&off)[U], int n) {
    Raw<T, VEC> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < n) raw[u] = load_raw<T, VEC>(x + off[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        float v[VEC];
        unpack<T, VEC>(raw[u], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = v[i] * sc[i] + sh[i];
        store_vec<T, VEC>(y + off[u], v);
      }
    }
  });
}

// part: (gridDim.y, 2, c) f32: this chunk's sum(g * xhat) then sum(g)
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_bwd_reduce_rows(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd, float* __restrict__ part,
                       int m, int c, int TX, int rows_per_chunk) {
  constexpr int U = 2;
  extern __shared__ float smem[];
  const Tile t = make_tile(TX, m, rows_per_chunk);
  const int cvecs = c / VEC;
  float acc[2 * VEC];
#pragma unroll
  for (int j = 0; j < 2 * VEC; ++j) acc[j] = 0.f;
  if (t.cv < cvecs) {
    float mu[VEC], rs[VEC];
    load_chan<VEC>(mean + t.cv * VEC, mu);
    load_chan<VEC>(rstd + t.cv * VEC, rs);
    for_rows<U>(t, c, VEC, [&](const int64_t(&off)[U], int n) {
      Raw<T, VEC> rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) {
          rx[u] = load_raw<T, VEC>(x + off[u]);
          rg[u] = load_raw<T, VEC>(g + off[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) {
          float xv[VEC], gv[VEC];
          unpack<T, VEC>(rx[u], xv);
          unpack<T, VEC>(rg[u], gv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[i] += gv[i] * ((xv[i] - mu[i]) * rs[i]);
            acc[VEC + i] += gv[i];
          }
        }
      }
    });
  }
  join_rows<VEC, 2>(t, acc, smem, part, c, cvecs);
}

// dx = w rstd (g - dbeta/M - xhat dgamma/M) + gm/M + (2/M)(x - mean) gv,
// regrouped per channel as a g + b (x - mean) + k with a = w rstd,
// b = 2 gv/M - a rstd dgamma/M, k = gm/M - a dbeta/M, so that four
// operands a channel stay in registers. gm or gv may be null: zeros.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bn_bwd_dx_rows(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const float* __restrict__ w,
                   const float* __restrict__ dgamma,
                   const float* __restrict__ dbeta,
                   const float* __restrict__ gm, const float* __restrict__ gv,
                   T* __restrict__ dx, int m, int c, int TX,
                   int rows_per_chunk) {
  constexpr int U = 2;
  const Tile t = make_tile(TX, m, rows_per_chunk);
  if (t.cv >= c / VEC) return;
  const float inv_m = 1.f / m;
  float mu[VEC], a[VEC], b[VEC], k[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = t.cv * VEC + i;
    mu[i] = mean[ch];
    a[i] = w[ch] * rstd[ch];
    b[i] = (gv != nullptr ? 2.f * gv[ch] * inv_m : 0.f) -
           a[i] * rstd[ch] * (dgamma[ch] * inv_m);
    k[i] = (gm != nullptr ? gm[ch] * inv_m : 0.f) - a[i] * (dbeta[ch] * inv_m);
  }
  for_rows<U>(t, c, VEC, [&](const int64_t(&off)[U], int n) {
    Raw<T, VEC> rx[U], rg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        rx[u] = load_raw<T, VEC>(x + off[u]);
        rg[u] = load_raw<T, VEC>(g + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        float xv[VEC], gv2[VEC];
        unpack<T, VEC>(rx[u], xv);
        unpack<T, VEC>(rg[u], gv2);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          gv2[i] = a[i] * gv2[i] + b[i] * (xv[i] - mu[i]) + k[i];
        store_vec<T, VEC>(dx + off[u], gv2);
      }
    }
  });
}

// The launch shape shared by the four row kernels.
struct Plan {
  int TX;              // threads across channel vectors: 8, 16 or 32
  int rows_per_chunk;  // a multiple of 256 / TX
  dim3 grid;           // (column tiles, row chunks)
  size_t smem;         // bytes for join_rows with K sums a channel
};

// `chunks` row chunks are wanted (the reductions' workspace has that many
// rows); 0 lets the plan choose about a thousand blocks of at least 64
// rows.
Plan make_plan(int m, int c, int vec, int chunks, int k) {
  const int cvecs = c / vec;
  Plan p;
  p.TX = cvecs <= 8 ? 8 : (cvecs <= 16 ? 16 : 32);
  const int ty = NT / p.TX;
  const int tiles = (cvecs + p.TX - 1) / p.TX;
  if (chunks <= 0) {
    const int most = 1024 / tiles > 0 ? 1024 / tiles : 1;
    chunks = (m + 63) / 64;
    if (chunks > most) chunks = most;
  }
  int rows = (m + chunks - 1) / chunks;
  rows = (rows + ty - 1) / ty * ty;
  p.rows_per_chunk = rows;
  p.grid = dim3(tiles, chunks);
  p.smem = (size_t)NT * (k * vec + 1) * sizeof(float);
  return p;
}

template <typename T>
int vec_of(int c, const void* a, const void* b = nullptr,
           const void* d = nullptr) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(d);
  return (c % V == 0 && bits % 16 == 0) ? V : 1;
}

// the per-channel f32 operands and results of the stats kernel
struct StatsOut {
  const float* w;  // null: mean and var only
  const float* b;
  float eps;
  float *mean, *var, *rstd, *scale, *shift;
};

template <typename T>
cudaError_t stats(const void* x, const StatsOut& o, float* part, int chunks,
                  int m, int c, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const int vec = vec_of<T>(c, x);
  const Plan p = make_plan(m, c, vec, chunks, 2);
  if (vec == V)
    bn_stats_rows<T, V><<<p.grid, NT, p.smem, s>>>(xp, part, m, c, p.TX,
                                                    p.rows_per_chunk);
  else
    bn_stats_rows<T, 1><<<p.grid, NT, p.smem, s>>>(xp, part, m, c, p.TX,
                                                    p.rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_finish<T><<<(c + 31) / 32, dim3(32, FY), 0, s>>>(
      xp, part, chunks, m, c, o.w, o.b, o.eps, o.mean, o.var, o.rstd, o.scale,
      o.shift);
  return cudaGetLastError();
}

template <typename T>
cudaError_t normalize(const void* x, const float* scale, const float* shift,
                      void* y, int m, int c, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int vec = vec_of<T>(c, x, y);
  const Plan p = make_plan(m, c, vec, 0, 0);
  if (vec == V)
    bn_normalize_rows<T, V><<<p.grid, NT, 0, s>>>(xp, scale, shift, yp, m, c,
                                                   p.TX, p.rows_per_chunk);
  else
    bn_normalize_rows<T, 1><<<p.grid, NT, 0, s>>>(xp, scale, shift, yp, m, c,
                                                   p.TX, p.rows_per_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_reduce(const void* x, const void* g, const float* mean,
                       const float* rstd, float* dgamma, float* dbeta,
                       float* part, int chunks, int m, int c, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const int vec = vec_of<T>(c, x, g);
  const Plan p = make_plan(m, c, vec, chunks, 2);
  if (vec == V)
    bn_bwd_reduce_rows<T, V><<<p.grid, NT, p.smem, s>>>(
        xp, gp, mean, rstd, part, m, c, p.TX, p.rows_per_chunk);
  else
    bn_bwd_reduce_rows<T, 1><<<p.grid, NT, p.smem, s>>>(
        xp, gp, mean, rstd, part, m, c, p.TX, p.rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_finish<<<(c + 31) / 32, dim3(32, FY), 0, s>>>(part, chunks, c, dgamma,
                                                        dbeta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dx(const void* x, const void* g, const float* mean,
                   const float* rstd, const float* w, const float* dgamma,
                   const float* dbeta, const float* gm, const float* gv,
                   void* dx, int m, int c, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  const int vec = vec_of<T>(c, x, g, dx);
  const Plan p = make_plan(m, c, vec, 0, 0);
  if (vec == V)
    bn_bwd_dx_rows<T, V><<<p.grid, NT, 0, s>>>(xp, gp, mean, rstd, w, dgamma,
                                                dbeta, gm, gv, dp, m, c, p.TX,
                                                p.rows_per_chunk);
  else
    bn_bwd_dx_rows<T, 1><<<p.grid, NT, 0, s>>>(xp, gp, mean, rstd, w, dgamma,
                                                dbeta, gm, gv, dp, m, c, p.TX,
                                                p.rows_per_chunk);
  return cudaGetLastError();
}

inline const float* f32(const void* p) { return static_cast<const float*>(p); }
inline float* f32(void* p) { return static_cast<float*>(p); }

inline bool bad_shape(int m, int c, int chunks) {
  // gridDim.y holds at most 65535 row chunks
  return m <= 0 || c <= 0 || chunks < 0 || chunks > 65535;
}

}  // namespace

// In all four: x (and g, y, dx) are (m, c) contiguous in x's dtype, bf16
// (x_bf16 = 1) or f32 (0); every per-channel operand is (c,) f32. Each
// launches on `stream`, allocates nothing and returns a CUDA error code.

// mean, var: (c,) f32 out. With w and b (both or neither; null: neither)
// also rstd = rsqrt(var + eps), scale = rstd w and shift = b - mean scale,
// (c,) f32 out. part: workspace of (chunks, 2, c) f32, chunks in 1..65535
// chosen by the caller. Two launches.
extern "C" int batch_norm_stats(int device, const void* x, const void* w,
                                const void* b, float eps, void* mean,
                                void* var, void* rstd, void* scale,
                                void* shift, void* part, int chunks, int m,
                                int c, int x_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(m, c, chunks) || chunks == 0 || (w == nullptr) != (b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StatsOut o{f32(w),    f32(b),     eps,       f32(mean),
                   f32(var),  f32(rstd),  f32(scale), f32(shift)};
  err = x_bf16 ? stats<__nv_bfloat16>(x, o, f32(part), chunks, m, c, s)
               : stats<float>(x, o, f32(part), chunks, m, c, s);
  return static_cast<int>(err);
}

// y = x * scale + shift. One launch.
extern "C" int batch_norm_normalize(int device, const void* x,
                                    const void* scale, const void* shift,
                                    void* y, int m, int c, int x_bf16,
                                    void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(m, c, 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? normalize<__nv_bfloat16>(x, f32(scale), f32(shift), y, m, c,
                                          s)
               : normalize<float>(x, f32(scale), f32(shift), y, m, c, s);
  return static_cast<int>(err);
}

// dgamma, dbeta: (c,) f32 out. part: workspace of (chunks, 2, c) f32. Two
// launches.
extern "C" int batch_norm_bwd_reduce(int device, const void* x, const void* g,
                                     const void* mean, const void* rstd,
                                     void* dgamma, void* dbeta, void* part,
                                     int chunks, int m, int c, int x_bf16,
                                     void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(m, c, chunks) || chunks == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? bwd_reduce<__nv_bfloat16>(x, g, f32(mean), f32(rstd),
                                           f32(dgamma), f32(dbeta), f32(part),
                                           chunks, m, c, s)
               : bwd_reduce<float>(x, g, f32(mean), f32(rstd), f32(dgamma),
                                   f32(dbeta), f32(part), chunks, m, c, s);
  return static_cast<int>(err);
}

// w: the affine weight; dgamma, dbeta: the sums of batch_norm_bwd_reduce;
// gm, gv: the cotangents of the mean and variance outputs, either may be
// null (zeros). One launch.
extern "C" int batch_norm_bwd_dx(int device, const void* x, const void* g,
                                 const void* mean, const void* rstd,
                                 const void* w, const void* dgamma,
                                 const void* dbeta, const void* gm,
                                 const void* gv, void* dx, int m, int c,
                                 int x_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(m, c, 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? bwd_dx<__nv_bfloat16>(x, g, f32(mean), f32(rstd), f32(w),
                                       f32(dgamma), f32(dbeta), f32(gm),
                                       f32(gv), dx, m, c, s)
               : bwd_dx<float>(x, g, f32(mean), f32(rstd), f32(w), f32(dgamma),
                               f32(dbeta), f32(gm), f32(gv), dx, m, c, s);
  return static_cast<int>(err);
}
