// Backward flash attention for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both launched by `_flash_bwd`). From the
// forward's saved per-row max m and normalizer l, and delta = rowsum(dO*O)
// (one PyTorch reduction before the kernels, as the Pallas module computes
// it outside its kernels), each recomputes for a (query, key) pair
//   s   = (q * scale) k^T + bias, -1e30 past the edges or above the
//         diagonal (causal), as in the forward
//   p   = valid ? exp(s - m) / max(l, 1e-20) : 0
//         exp(s - m), never exp(s - (m + log l)): with the -1e9 padding
//         mask s and m are ~1e9, where an f32 step is 64 and the folded
//         form would lose the whole log-normalizer
//   dp  = dO v^T, and with dropout dp = keep ? dp / (1 - rate) : 0
//   ds  = p (dp - delta)
// and accumulates
//   dQ kernel:   dq = scale * sum_k ds k     one block per (bh, q tile),
//                                           looping over the key tiles
//   dK/dV kernel: dv = sum_q pd^T dO,  dk = sum_q ds^T (q * scale)
//                one block per (bh, k tile), looping over the query tiles,
//                with pd = keep ? p / (1 - rate) : 0
// so no two blocks write the same output and nothing needs atomics. The
// dropout keep mask is regenerated from the counter hash of common.cuh at
// the same (bh, row, col) as the forward; it is never stored. A fully
// masked row (bool mask, -1e30) has m = 0 and gets p = 0 everywhere.
//
// What bounds it on the H100: at BERT's shapes (S = 128, head dim 64,
// bf16) the bytes of q, k, v, dO and the gradients on paper; but, like the
// forward, this first version computes its three (dQ) and four (dK/dV)
// products per tile on CUDA cores in f32, so its own arithmetic is what
// limits it (PERF.md has the times against the bound).
//
// What the design does about it: the tiles are staged in shared memory as
// f32, transposed with an odd row stride, so that both the score loops
// (reading along the head dim) and the accumulation loops (reading along
// the tile) are free of bank conflicts; each of the 256 threads keeps a
// 4 x 4 tile of scores and of dp, and a 4 x (D/16) tile of each
// accumulator in registers (two accumulators in dK/dV, hence 256 threads
// rather than the forward's 128: the per-thread accumulator halves). ds
// and pd pass through shared memory to the accumulation loops. q, k, v
// and dO are read in place through their strides (the head-split views
// of BERT's fused QKV projection, and dO in the forward output's
// (B, S, H, D) memory order), and the gradients are written through
// strides. Tensor cores (wgmma) and TMA are later work.

#include <atomic>

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // threads per block
constexpr int CG = 16;         // threads sharing one row group
constexpr int TM = 4;          // tile rows per thread
constexpr int TN = 64 / CG;    // tile columns per thread
constexpr int QS = BQ + 1;     // row stride of the transposed q, dO tiles
constexpr int KS = BK + 1;     // row stride of the transposed k, v tiles
constexpr int PS = 64 + 2;     // row stride of the ds / pd tiles
constexpr float NEG_INF = -1e30f;

static_assert(NT == (64 / TM) * CG, "thread layout");
static_assert(BQ == 64 && BK == 64, "both tiles are 64 wide");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;   // (G, 1 or Sq, Sk) f32, or null
  const float* m;      // (B*H, Sq)
  const float* l;      // (B*H, Sq)
  const float* delta;  // (B*H, Sq)
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk;
  // batch, head, sequence strides in elements: q, k, v, dO, dq, dk, dv
  int64_t st[7][3];
  int mask_mode;       // 0 none, 1 key row, 2 full
  int mb, mh;
  float scale;
  int causal;
  int dropout;
  uint32_t threshold;
  uint32_t seed0, seed1;
  float keep_div;
};

enum { Q = 0, K = 1, V = 2, DO = 3, DQ = 4, DK = 5, DV = 6 };

template <typename P>
__device__ __forceinline__ P* at(const Params& p, void* base, int which,
                                 int b, int h) {
  return static_cast<P*>(base) + b * p.st[which][0] + h * p.st[which][1];
}

template <typename P>
__device__ __forceinline__ const P* at(const Params& p, const void* base,
                                       int which, int b, int h) {
  return static_cast<const P*>(base) + b * p.st[which][0] +
         h * p.st[which][1];
}

// the mask rows this (batch, head) reads: the Pallas bh_to_g broadcast
__device__ __forceinline__ const float* mask_group(const Params& p, int b,
                                                   int h, int bh) {
  if (p.mask_mode == 0) return nullptr;
  int64_t g;
  if (p.mb == 1 && p.mh == 1) g = 0;
  else if (p.mb == 1) g = h;
  else if (p.mh == 1) g = b;
  else g = bh;
  const int64_t rows = p.mask_mode == 1 ? 1 : p.Sq;
  return p.mask + g * rows * p.Sk;
}

// the masked, scaled score of (qi, kj), or -1e30 where it is not valid;
// `valid` says which
__device__ __forceinline__ float masked_score(const Params& p,
                                              const float* mg, float s,
                                              int qi, int kj, bool& valid) {
  valid = qi < p.Sq && kj < p.Sk;
  if (p.causal) valid = valid && qi >= kj;
  if (!valid) return NEG_INF;
  if (p.mask_mode == 1) s += mg[kj];
  if (p.mask_mode == 2) s += mg[(int64_t)qi * p.Sk + kj];
  return s;
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * QS + 2 * D * KS + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const Params p) {
  constexpr int DC = D / CG;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;            // [D][QS]  q^T, pre-scaled
  float* Ot = Qt + D * QS;     // [D][QS]  dO^T
  float* Kt = Ot + D * QS;     // [D][KS]  k^T
  float* Vt = Kt + D * KS;     // [D][KS]  v^T
  float* Ps = Vt + D * KS;     // [BQ][PS] ds

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG;
  const int cg = tid % CG;

  const T* qb = at<T>(p, p.q, Q, b, h);
  const T* kb = at<T>(p, p.k, K, b, h);
  const T* vb = at<T>(p, p.v, V, b, h);
  const T* dob = at<T>(p, p.dout, DO, b, h);
  T* dqb = at<T>(p, p.dq, DQ, b, h);
  const float* mg = mask_group(p, b, h, bh);

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    const bool in = qi < p.Sq;
    Qt[d * QS + r] = in ? to_f32(qb[qi * p.st[Q][2] + d]) * p.scale : 0.f;
    Ot[d * QS + r] = in ? to_f32(dob[qi * p.st[DO][2] + d]) : 0.f;
  }

  float mrow[TM], linv[TM], dl[TM];
  uint32_t hrow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + rg * TM + i;
    const bool in = qi < p.Sq;
    const int64_t row = (int64_t)bh * p.Sq + qi;
    mrow[i] = in ? p.m[row] : 0.f;
    linv[i] = in ? 1.f / fmaxf(p.l[row], 1e-20f) : 0.f;
    dl[i] = in ? p.delta[row] : 0.f;
    hrow[i] = p.dropout ? ptk::dropout_row(p.seed1, bh, qi) : 0u;
  }

  float acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const int kj = k0 + r;
      const bool in = kj < p.Sk;
      Kt[d * KS + r] = in ? to_f32(kb[kj * p.st[K][2] + d]) : 0.f;
      Vt[d * KS + r] = in ? to_f32(vb[kj * p.st[V][2] + d]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = dp[i][t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TM], o[TM], bk[TN], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = Qt[d * QS + rg * TM + i];
        o[i] = Ot[d * QS + rg * TM + i];
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        bk[t] = Kt[d * KS + cg + CG * t];
        bv[t] = Vt[d * KS + cg + CG * t];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          s[i][t] = fmaf(a[i], bk[t], s[i][t]);
          dp[i][t] = fmaf(o[i], bv[t], dp[i][t]);
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg * TM + i;
      const int qi = q0 + r;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int kj = k0 + cg + CG * t;
        bool valid;
        const float sv = masked_score(p, mg, s[i][t], qi, kj, valid);
        const float pv = valid ? expf(sv - mrow[i]) * linv[i] : 0.f;
        float dpv = dp[i][t];
        if (p.dropout)
          dpv = ptk::dropout_keep(hrow[i], p.seed0, kj, p.threshold)
                    ? dpv / p.keep_div
                    : 0.f;
        Ps[r * PS + cg + CG * t] = pv * (dpv - dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[TM], kv[DC];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = Ps[(rg * TM + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kv[cc] = Kt[(cg + CG * cc) * KS + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(dsv[i], kv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + rg * TM + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      dqb[qi * p.st[DQ][2] + cg + CG * cc] =
          from_f32<T>(acc[i][cc] * p.scale);
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * KS + 2 * D * QS + 2 * BK * PS + 4 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(const Params p) {
  constexpr int DC = D / CG;
  extern __shared__ float smem[];
  float* Kt = smem;            // [D][KS]  k^T
  float* Vt = Kt + D * KS;     // [D][KS]  v^T
  float* Qt = Vt + D * KS;     // [D][QS]  q^T, pre-scaled
  float* Ot = Qt + D * QS;     // [D][QS]  dO^T
  float* Pd = Ot + D * QS;     // [BK][PS] pd^T
  float* Ds = Pd + BK * PS;    // [BK][PS] ds^T
  float* Mr = Ds + BK * PS;    // [BQ] m of the query tile
  float* Li = Mr + BQ;         // [BQ] 1 / max(l, 1e-20)
  float* Dl = Li + BQ;         // [BQ] delta
  uint32_t* Hr = reinterpret_cast<uint32_t*>(Dl + BQ);  // [BQ] row hashes

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int rg = tid / CG;  // key rows rg*TM .. rg*TM+TM-1
  const int cg = tid % CG;  // query columns cg + CG*t

  const T* qb = at<T>(p, p.q, Q, b, h);
  const T* kb = at<T>(p, p.k, K, b, h);
  const T* vb = at<T>(p, p.v, V, b, h);
  const T* dob = at<T>(p, p.dout, DO, b, h);
  T* dkb = at<T>(p, p.dk, DK, b, h);
  T* dvb = at<T>(p, p.dv, DV, b, h);
  const float* mg = mask_group(p, b, h, bh);

  for (int e = tid; e < BK * D; e += NT) {
    const int r = e / D, d = e % D;
    const int kj = k0 + r;
    const bool in = kj < p.Sk;
    Kt[d * KS + r] = in ? to_f32(kb[kj * p.st[K][2] + d]) : 0.f;
    Vt[d * KS + r] = in ? to_f32(vb[kj * p.st[V][2] + d]) : 0.f;
  }

  float dk[TM][DC], dv[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q_first = p.causal ? k0 / BQ : 0;

  for (int qt = q_first; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e % D;
      const int qi = q0 + r;
      const bool in = qi < p.Sq;
      Qt[d * QS + r] = in ? to_f32(qb[qi * p.st[Q][2] + d]) * p.scale : 0.f;
      Ot[d * QS + r] = in ? to_f32(dob[qi * p.st[DO][2] + d]) : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const int qi = q0 + r;
      const bool in = qi < p.Sq;
      const int64_t row = (int64_t)bh * p.Sq + qi;
      Mr[r] = in ? p.m[row] : 0.f;
      Li[r] = in ? 1.f / fmaxf(p.l[row], 1e-20f) : 0.f;
      Dl[r] = in ? p.delta[row] : 0.f;
      Hr[r] = p.dropout ? ptk::dropout_row(p.seed1, bh, qi) : 0u;
    }
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = dp[i][t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TM], av[TM], bq[TN], bo[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = Kt[d * KS + rg * TM + i];
        av[i] = Vt[d * KS + rg * TM + i];
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        bq[t] = Qt[d * QS + cg + CG * t];
        bo[t] = Ot[d * QS + cg + CG * t];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          s[i][t] = fmaf(a[i], bq[t], s[i][t]);
          dp[i][t] = fmaf(av[i], bo[t], dp[i][t]);
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg * TM + i;
      const int kj = k0 + r;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = cg + CG * t;
        const int qi = q0 + c;
        bool valid;
        const float sv = masked_score(p, mg, s[i][t], qi, kj, valid);
        const float pv = valid ? expf(sv - Mr[c]) * Li[c] : 0.f;
        float pd = pv, dpv = dp[i][t];
        if (p.dropout) {
          const bool keep = ptk::dropout_keep(Hr[c], p.seed0, kj, p.threshold);
          pd = keep ? pv / p.keep_div : 0.f;
          dpv = keep ? dpv / p.keep_div : 0.f;
        }
        Pd[r * PS + c] = pd;
        Ds[r * PS + c] = pv * (dpv - Dl[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pdv[TM], dsv[TM], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pdv[i] = Pd[(rg * TM + i) * PS + c];
        dsv[i] = Ds[(rg * TM + i) * PS + c];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        ov[cc] = Ot[(cg + CG * cc) * QS + c];
        qv[cc] = Qt[(cg + CG * cc) * QS + c];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          dv[i][cc] = fmaf(pdv[i], ov[cc], dv[i][cc]);
          dk[i][cc] = fmaf(dsv[i], qv[cc], dk[i][cc]);
        }
    }
  }

  // q was pre-scaled, so ds^T (q * scale) is already dk
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kj = k0 + rg * TM + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      dkb[kj * p.st[DK][2] + cg + CG * cc] = from_f32<T>(dk[i][cc]);
      dvb[kj * p.st[DV][2] + cg + CG * cc] = from_f32<T>(dv[i][cc]);
    }
  }
}

constexpr int kMaxDevices = 64;

// Launch the dQ (DKV false) or dK/dV (DKV true) kernel, opting in to more
// than 48 KB of shared memory once per kernel instance and device (two
// threads racing only repeat the same idempotent call).
template <typename T, int D, bool DKV>
cudaError_t launch(const Params& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes =
      (DKV ? dkv_smem_floats<D>() : dq_smem_floats<D>()) * sizeof(float);
  static std::atomic<bool> opted_in[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    cudaError_t err =
        DKV ? cudaFuncSetAttribute(flash_bwd_dkv<T, D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes)
            : cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  if (DKV)
    flash_bwd_dkv<T, D>
        <<<dim3(bh, (p.Sk + BK - 1) / BK), NT, bytes, stream>>>(p);
  else
    flash_bwd_dq<T, D>
        <<<dim3(bh, (p.Sq + BQ - 1) / BQ), NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t launch_any(const Params& p, int bh, int D, int bf16, int device,
                       cudaStream_t s) {
  if (bf16)
    return D == 64 ? launch<__nv_bfloat16, 64, DKV>(p, bh, device, s)
                   : launch<__nv_bfloat16, 128, DKV>(p, bh, device, s);
  return D == 64 ? launch<float, 64, DKV>(p, bh, device, s)
                 : launch<float, 128, DKV>(p, bh, device, s);
}

int run(bool dkv, int device, const void* q, const void* k, const void* v,
        const void* mask, const void* m, const void* l, const void* delta,
        const void* dout, void* dq, void* dk, void* dv, int B, int H, int Sq,
        int Sk, int D, const long long* strides, int mask_mode, int mb,
        int mh, float scale, int causal, int bf16, int dropout,
        unsigned threshold, unsigned seed0, unsigned seed1, float keep_div,
        void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.mask = static_cast<const float*>(mask);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.mask_mode = mask_mode;
  p.mb = mb;
  p.mh = mh;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.threshold = threshold;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.keep_div = keep_div;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  err = dkv ? launch_any<true>(p, bh, D, bf16, device, s)
            : launch_any<false>(p, bh, D, bf16, device, s);
  return static_cast<int>(err);
}

}  // namespace

// Both entry points take the same arguments. q, dO, dq (B,H,Sq,D) and k,
// v, dk, dv (B,H,Sk,D): any batch, head and sequence strides (in
// elements), the head dim contiguous; `strides` holds 21 of them, three
// each for q, k, v, dO, dq, dk, dv. mask: contiguous f32 (mb*mh, 1 or Sq,
// Sk) for mask_mode 1 or 2, else null. m, l, delta: contiguous f32
// (B*H, Sq). D must be 64 or 128. The dropout arguments are the
// forward's. `flash_attention_bwd_dq` writes dq and ignores dk, dv;
// `flash_attention_bwd_dkv` writes dk and dv and ignores dq. Each
// launches on `stream` and returns a CUDA error code; allocates nothing.
#define PTK_BWD_ARGS                                                        \
  int device, const void *q, const void *k, const void *v,                 \
      const void *mask, const void *m, const void *l, const void *delta,   \
      const void *dout, void *dq, void *dk, void *dv, int B, int H,        \
      int Sq, int Sk, int D, const long long *strides, int mask_mode,      \
      int mb, int mh, float scale, int causal, int bf16, int dropout,      \
      unsigned threshold, unsigned seed0, unsigned seed1, float keep_div,  \
      void *stream
#define PTK_BWD_PASS                                                        \
  device, q, k, v, mask, m, l, delta, dout, dq, dk, dv, B, H, Sq, Sk, D,   \
      strides, mask_mode, mb, mh, scale, causal, bf16, dropout, threshold, \
      seed0, seed1, keep_div, stream

extern "C" int flash_attention_bwd_dq(PTK_BWD_ARGS) {
  return run(false, PTK_BWD_PASS);
}

extern "C" int flash_attention_bwd_dkv(PTK_BWD_ARGS) {
  return run(true, PTK_BWD_PASS);
}
