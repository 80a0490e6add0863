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
// 64) the bytes of q, k, v and O in bf16 (the two products need 1.6 us at
// (32, 12, 128, 64) on the tensor cores against a 7.6 us byte bound); in
// float32, whose products stay on the CUDA cores so that the result keeps
// full float32, the operations (PERF.md has the times against the bound).
//
// What the design does about it. bf16 (`flash_fwd_tc`): 4 warps, 64 query
// rows a block, 16 a warp, 64-key tiles. q is copied once, k and v tiles
// double-buffered, by 16-byte cp.async into XOR-swizzled bf16 shared
// tiles, so the next tile's copy overlaps this tile's arithmetic and the
// ldmatrix loads meet no bank conflict; nothing is staged as f32. Both
// products run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums): q's A fragments stay in registers for the whole key loop, k is
// the B operand of s = q k^T through ldmatrix, v that of pd v through
// ldmatrix.trans. The scale multiplies the f32 scores (1/sqrt(128) is not
// a power of two, so scaling bf16 q would round); the softmax runs in
// registers (row max and sum over the 4 lanes of a quad, two shuffles),
// and p goes to the P·V product straight from the score accumulators,
// rounded to bf16 pairs: it never enters shared memory. l sums the f32,
// unrounded, undropped p; the one rounding the reference does not make is
// p to bf16 (2^-9 relative). Causal blocks stop at the diagonal tile, and
// only tiles on an edge (the diagonal, past Sk) are masked per element.
// float32 (`flash_fwd`): q (pre-scaled), k and v tiles staged in shared
// memory as f32, q and k transposed so that the score loop reads them
// without bank conflicts; each of the 128 threads keeps a 4 x 8 tile of
// scores and a 4 x (D/8) tile of the accumulator in registers (8 threads
// share a row: the row max and sum are 3 shuffles), and the probabilities
// pass through shared memory to the P·V loop.
// Both read q, k, v in place through their strides, so the head-split
// view of the fused QKV projection needs no copy (the bf16 kernel wants
// 16-byte aligned rows, which the wrapper ensures), and write O through
// strides; the S x S score matrix never reaches device memory.

#include <atomic>

#include "common.cuh"
#include "tensor_core.cuh"

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


// -- bf16 on the tensor cores ---------------------------------------------

namespace tc = ptk::tc;

template <int D>
constexpr int tc_smem_bytes() {
  // q tile, two k and two v tiles (bf16), two key-bias rows (f32)
  return (BQ * D + 4 * BK * D) * 2 + 2 * BK * 4;
}

template <int D>
// four blocks an SM at D = 64 (at most 128 registers, no spill)
__global__ void __launch_bounds__(NT, D == 64 ? 4 : 2)
    flash_fwd_tc(const Params p) {
  using bf16 = tc::bf16;
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int ND = D / 8;   // 8-wide n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][D]
  bf16* Ks = Qs + BQ * D;                        // [2][BK][D]
  bf16* Vs = Ks + 2 * BK * D;                    // [2][BK][D]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * D);  // [2][BK]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;          // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* mg = nullptr;
  if (p.mask_mode != 0) {
    int64_t grp;
    if (p.mb == 1 && p.mh == 1) grp = 0;
    else if (p.mb == 1) grp = h;
    else if (p.mh == 1) grp = b;
    else grp = bh;
    mg = p.mask + grp * (p.mask_mode == 1 ? 1 : p.Sq) * (int64_t)p.Sk;
  }
  auto load_bias = [&](int buf, int k0) {
    for (int c = tid; c < BK; c += NT)
      Bs[buf * BK + c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  };

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  tc::load_tile<D, BQ, NT>(Qs, qb, p.q_ss, q0, p.Sq, tid);
  tc::load_tile<D, BK, NT>(Ks, kb, p.k_ss, 0, p.Sk, tid);
  tc::load_tile<D, BK, NT>(Vs, vb, p.v_ss, 0, p.Sk, tid);
  tc::cp_async_commit();
  if (p.mask_mode == 1) load_bias(0, 0);

  uint32_t hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hrow[i] = p.dropout ? ptk::dropout_row(p.seed1, bh, rows[i]) : 0u;
  const float inv_keep = 1.f / p.keep_div;

  uint32_t qf[KD][4];
  float o[ND][4];
  float m[2], l[2];  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = __int_as_float(0xff800000);  // -inf
    l[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    const int k0 = j * BK;
    tc::cp_async_wait_all();
    __syncthreads();  // tile j is in; every reader of tile j-1 is done
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) tc::load_a<D>(qf[kk], Qs, wrow, kk, lane);
    }
    if (j + 1 < nk) {
      tc::load_tile<D, BK, NT>(Ks + (buf ^ 1) * BK * D, kb, p.k_ss, k0 + BK,
                               p.Sk, tid);
      tc::load_tile<D, BK, NT>(Vs + (buf ^ 1) * BK * D, vb, p.v_ss, k0 + BK,
                               p.Sk, tid);
      tc::cp_async_commit();
      if (p.mask_mode == 1) load_bias(buf ^ 1, k0 + BK);
    }
    const bf16* Kt = Ks + buf * BK * D;
    const bf16* Vt = Vs + buf * BK * D;

    // s = q k^T: 16 rows x 64 keys a warp, eight 8-key n-tiles
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        tc::load_b_rows<D>(kf, Kt, np * 16, kk, lane);
        tc::mma(s[2 * np], qf[kk], kf[0], kf[1]);
        tc::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale, bias, and -1e30 where a key is past Sk or above the diagonal
    const bool edge = k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + wrow);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int cl = t * 8 + t4 * 2 + (e & 1);
        const int kj = k0 + cl;
        float x = s[t][e] * p.scale;
        if (p.mask_mode == 1) x += Bs[buf * BK + cl];
        else if (p.mask_mode == 2)
          x += row < p.Sq && kj < p.Sk ? mg[(int64_t)row * p.Sk + kj] : 0.f;
        if (edge && (kj >= p.Sk || (p.causal && row < kj))) x = NEG_INF;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float msafe[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      msafe[i] = m_new <= NEG_INF ? 0.f : m_new;
      corr[i] = m[i] <= NEG_INF ? 0.f : __expf(m[i] - msafe[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }

    // p, l from the undropped p, then the dropped p as bf16 A fragments
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[t][e];
        float pv = x <= NEG_INF ? 0.f : __expf(x - msafe[e >> 1]);
        l[e >> 1] += pv;
        if (p.dropout)
          pv = ptk::dropout_keep(hrow[e >> 1], p.seed0,
                                 k0 + t * 8 + t4 * 2 + (e & 1), p.threshold)
                   ? pv * inv_keep
                   : 0.f;
        s[t][e] = pv;
      }
    uint32_t pa[4][4];
    tc::c_to_a<4>(pa, s);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // o += p v: 16 keys a step, two 8-wide output n-tiles a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        tc::load_b_cols<D>(vf, Vt, kk * 16, dp * 2, lane);
        tc::mma(o[2 * dp], pa[kk], vf[0], vf[1]);
        tc::mma(o[2 * dp + 1], pa[kk], vf[2], vf[3]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = rows[i];
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    bf16* orow = ob + row * p.o_ss + t4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          tc::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t4 == 0) {
      const int64_t r = (int64_t)bh * p.Sq + row;
      p.m[r] = m[i] <= NEG_INF ? 0.f : m[i];
      p.l[r] = l[i];
    }
  }
}

constexpr int kMaxDevices = 64;

// Launch one instance, opting in to its dynamic shared memory once per
// instance and device, not on every launch (two threads racing only
// repeat the same idempotent call).
template <typename K>
cudaError_t launch_kernel(K kernel, int bytes, const Params& p, int bh,
                          int device, cudaStream_t stream,
                          std::atomic<bool>* opted_in) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid(bh, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int bh, int device,
                       cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  return launch_kernel(flash_fwd<float, D>, smem_floats<D>() * 4, p, bh,
                       device, stream, opted_in);
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, int device,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  return launch_kernel(flash_fwd_tc<D>, tc_smem_bytes<D>(), p, bh, device,
                       stream, opted_in);
}

// bf16 operands are read by 16-byte copies: the base pointer and every
// stride of a dimension longer than 1 must be a multiple of 16 bytes
bool rows_aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss,
                  int B, int H, int S) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (B == 1 || sb % 8 == 0) && (H == 1 || sh % 8 == 0) &&
         (S == 1 || ss % 8 == 0);
}

}  // namespace

// q (B,H,Sq,D), k and v (B,H,Sk,D), O (B,H,Sq,D): any strides for the
// batch, head and sequence dims, the head dim contiguous (strides in
// elements). mask: contiguous f32 (mb*mh, 1 or Sq, Sk) for mask_mode 1 or
// 2, else null. m, l: contiguous f32 (B*H, Sq). D must be 64 or 128.
// bf16 q, k, v must start on 16 bytes and have strides that are
// multiples of 8 elements (cudaErrorMisalignedAddress otherwise).
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
  if (bf16) {
    if (!rows_aligned(q, q_sb, q_sh, q_ss, B, H, Sq) ||
        !rows_aligned(k, k_sb, k_sh, k_ss, B, H, Sk) ||
        !rows_aligned(v, v_sb, v_sh, v_ss, B, H, Sk))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = D == 64 ? launch_bf16<64>(p, bh, device, s)
                  : launch_bf16<128>(p, bh, device, s);
  } else {
    err = D == 64 ? launch_f32<64>(p, bh, device, s)
                  : launch_f32<128>(p, bh, device, s);
  }
  return static_cast<int>(err);
}
