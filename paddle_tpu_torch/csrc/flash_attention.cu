// Forward flash attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// (launched by `_flash_fwd_res`), in-kernel dropout included. For one
// (batch*head, query tile) per block it walks the key/value tiles with the
// online-softmax recurrence of the Pallas kernel:
//   s      = (q * scale) k^T + bias          bias: none, a key row
//                                            [G,1,Sk] or a full [G,Sq,Sk]
//   s      = -1e30 where the key is past Sk, or above the diagonal (causal)
//   m_new  = max(m, rowmax(s));  m_safe = m_new <= -1e30 ? 0 : m_new
//   p      = s <= -1e30 ? 0 : exp(s - m_safe)
//   corr   = m <= -1e30 ? 0 : exp(m - m_safe)
//   l      = l * corr + rowsum(p);  acc = acc * corr + pd v
// where pd = p, or with dropout pd = keep ? p / (1 - rate) : 0 and keep
// the counter hash of common.cuh at (bh, row, col): l stays the undropped
// normalizer, as in the Pallas kernel (`_fwd_kernel` drops p after l).
// and writes O = acc / max(l, 1e-20) in q's dtype, plus the per-row max m
// (0 for a row with every key masked) and normalizer l as f32, kept apart
// and not folded into one log-sum-exp: with the -1e9 additive padding mask
// the scores are ~1e9 in size, where the folded form loses the whole
// log-normalizer (the Pallas module's docstring explains why). A row whose
// keys are all masked with -1e30 (a bool mask) gets p = 0 and O = 0.
//
// What bounds it on the H100: at BERT's shapes (S = 128..512, head dim
// 64) the bytes of q, k, v and O bound the work on paper (in bf16; in
// f32 the operations on CUDA cores do), but this first version computes on
// CUDA cores in f32, without tensor cores, so its own arithmetic is what
// limits it: 4x (f32) to 12x (bf16) above the bound at B=32, S=128 on an
// H100 80GB HBM3 at 700 W (PERF.md).
//
// What the design does about it: q (pre-scaled), k and v tiles are staged
// in shared memory as f32, q and k transposed so that the score loop reads
// them without bank conflicts; each of the 128 threads keeps a 4 x 8 tile
// of scores and a 4 x (D/8) tile of the output accumulator in registers
// (8 threads share a row, so the row max and sum are 3 warp shuffles), and
// the probabilities pass through shared memory to the P·V loop. The S x S
// score matrix never reaches device memory, and q, k, v are read in place
// through their strides, so the head-split view of the fused QKV
// projection needs no copy; O is written through strides as well.
// Tensor cores (wgmma) and TMA are later work.

#include <atomic>

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // threads per block
constexpr int CG = 8;          // threads sharing one row group
constexpr int TM = 4;          // query rows per thread
constexpr int TN = BK / CG;    // score columns per thread
constexpr int QS = BQ + 1;     // row stride of the transposed q tile
constexpr int KS = BK + 1;     // row stride of the transposed k tile
constexpr int PS = BK + 2;     // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

static_assert(NT == (BQ / TM) * CG, "thread layout");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // (G, 1 or Sq, Sk) f32, or null
  void* o;
  float* m;           // (B*H, Sq)
  float* l;           // (B*H, Sq)
  int H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int mask_mode;      // 0 none, 1 key row, 2 full
  int mb, mh;         // mask's batch and head extents (1 = broadcast)
  float scale;
  int causal;
  int dropout;         // 0 or 1
  uint32_t threshold;  // keep where the hash >= threshold
  uint32_t seed0, seed1;
  float keep_div;      // 1 - rate
};

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd(const Params p) {
  constexpr int DC = D / CG;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;            // [D][QS]  q^T, pre-scaled
  float* Kt = Qt + D * QS;     // [D][KS]  k^T
  float* Vs = Kt + D * KS;     // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PS]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG;  // row group: rows rg*TM .. rg*TM+TM-1
  const int cg = tid % CG;  // column group: columns cg + CG*j

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the mask group this (batch, head) reads: the Pallas bh_to_g broadcast
  const float* mg = nullptr;
  if (p.mask_mode != 0) {
    int64_t g;
    if (p.mb == 1 && p.mh == 1) g = 0;
    else if (p.mb == 1) g = h;
    else if (p.mh == 1) g = b;
    else g = bh;
    const int64_t rows = p.mask_mode == 1 ? 1 : p.Sq;
    mg = p.mask + g * rows * p.Sk;
  }

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qt[d * QS + r] =
        qi < p.Sq ? to_f32(qb[qi * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = __int_as_float(0xff800000);  // -inf
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done (and Qt is in)
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const int kj = k0 + r;
      const bool in = kj < p.Sk;
      Kt[d * KS + r] = in ? to_f32(kb[kj * p.k_ss + d]) : 0.f;
      // padded v rows are zero: p is 0 there, but 0 * garbage could be NaN
      Vs[r * D + d] = in ? to_f32(vb[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qt[d * QS + rg * TM + i];
#pragma unroll
      for (int t = 0; t < TN; ++t) bk[t] = Kt[d * KS + cg + CG * t];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) s[i][t] = fmaf(a[i], bk[t], s[i][t]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg * TM + i;
      const int qi = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int kj = k0 + cg + CG * t;
        bool valid = qi < p.Sq && kj < p.Sk;
        if (p.causal) valid = valid && qi >= kj;
        float sv = s[i][t];
        if (valid && p.mask_mode == 1) sv += mg[kj];
        if (valid && p.mask_mode == 2) sv += mg[(int64_t)qi * p.Sk + kj];
        s[i][t] = valid ? sv : NEG_INF;
        mx = fmaxf(mx, s[i][t]);
      }
      // the 8 threads of a row group are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
      const uint32_t hrow = p.dropout ? ptk::dropout_row(p.seed1, bh, qi) : 0u;
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float pv = s[i][t] <= NEG_INF ? 0.f : expf(s[i][t] - m_safe);
        float pd = pv;
        if (p.dropout)
          pd = ptk::dropout_keep(hrow, p.seed0, k0 + cg + CG * t, p.threshold)
                   ? pv / p.keep_div
                   : 0.f;
        Ps[r * PS + cg + CG * t] = pd;
        rs += pv;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float corr = m[i] <= NEG_INF ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[TM], vv[DC];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(rg * TM + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * D + cg + CG * cc];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + rg * TM + i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      ob[qi * p.o_ss + cg + CG * cc] = from_f32<T>(acc[i][cc] / den);
    if (cg == 0) {
      const int64_t row = (int64_t)bh * p.Sq + qi;
      p.m[row] = m[i] <= NEG_INF ? 0.f : m[i];
      p.l[row] = l[i];
    }
  }
}

constexpr int kMaxDevices = 64;

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, int device, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  // the shared-memory opt-in is set once per instance and device, not on
  // every launch; two threads racing only repeat the same idempotent call
  static std::atomic<bool> opted_in[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid(bh, (p.Sq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k and v (B,H,Sk,D), O (B,H,Sq,D): any strides for the
// batch, head and sequence dims, the head dim contiguous (strides in
// elements). mask: contiguous f32 (mb*mh, 1 or Sq, Sk) for mask_mode 1 or
// 2, else null. m, l: contiguous f32 (B*H, Sq). D must be 64 or 128.
// dropout 1 drops attention probabilities where the counter hash of
// (seed0, seed1, bh, row, col) is below threshold, scaling the kept ones
// by 1 / keep_div. Launches on `stream` and returns a CUDA error code;
// allocates nothing.
extern "C" int flash_attention_fwd(
    int device, const void* q, const void* k, const void* v,
    const void* mask, void* o, void* m, void* l, int B, int H, int Sq,
    int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int mask_mode, int mb, int mh, float scale, int causal,
    int bf16, int dropout, unsigned threshold, unsigned seed0, unsigned seed1,
    float keep_div, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.o = o;
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
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
  if (bf16)
    err = D == 64 ? launch<__nv_bfloat16, 64>(p, bh, device, s)
                  : launch<__nv_bfloat16, 128>(p, bh, device, s);
  else
    err = D == 64 ? launch<float, 64>(p, bh, device, s)
                  : launch<float, 128>(p, bh, device, s);
  return static_cast<int>(err);
}
