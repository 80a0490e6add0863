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
// float32, the bytes too once its products run on the tensor cores (below:
// their three TF32 products a term need 9.8 us at that shape against a 15
// us byte bound), but also the instructions that split every operand
// (PERF.md has the times against the bound).
//
// What the design does about it. Both kernels: 4 warps, 64 query rows a
// block, 16 a warp, 64-key tiles; k and v tiles double-buffered by 16-byte
// cp.async into XOR-swizzled shared tiles (csrc/tensor_core.cuh), so the
// next tile's copy overlaps this tile's arithmetic and the fragment loads
// meet no bank conflict; both products on the tensor cores with f32 sums,
// the softmax in registers (row max and sum over the 4 lanes of a quad,
// two shuffles), p handed to the P·V product straight from the score
// accumulators, never through shared memory. Causal blocks stop at the
// diagonal tile, and only tiles on an edge (the diagonal, past Sk) are
// masked per element. l sums the f32, undropped p.
// bf16 (`flash_fwd_tc`): q copied once as well, mma.sync m16n8k16: q's A
// fragments stay in registers for the whole key loop, k is the B operand
// of s = q k^T through ldmatrix, v that of pd v through ldmatrix.trans.
// The scale multiplies the f32 scores (1/sqrt(128) is not a power of two,
// so scaling bf16 q would round). The one rounding the reference does not
// make is p to bf16 (2^-9 relative).
// float32 (`flash_fwd_tf32`): mma.sync m16n8k8 on TF32 operands, each
// product split in three (lo hi + hi lo + hi hi, "3xTF32"), which keeps
// about 2^-21 of each product where one TF32 product keeps 2^-11: the
// result stays within float32 tolerance. q's rows, pre-scaled, are read
// anew (from L1) and split at each tile, which costs fewer cycles than
// the block an SM their registers would; k and v are split as they are
// read. Fragments are read with 16-byte shared loads: both products
// order their k index so that a thread's two k values sit side by side,
// and p v orders O's columns so that a thread's four n-tiles take four
// neighbouring columns of v (and write four neighbouring columns of O).
// Both read q, k, v in place through their strides, so the head-split
// view of the fused QKV projection needs no copy (16-byte aligned rows,
// which the wrapper ensures), and write O through strides; the S x S
// score matrix never reaches device memory.

#include <atomic>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block, 16 a warp
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // threads per block
constexpr float NEG_INF = -1e30f;

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
  const uint32_t* seed;  // the two dropout words, in device memory
  float keep_div;      // 1 - rate
};

// the mask rows this (batch, head) reads: the Pallas bh_to_g broadcast
__device__ __forceinline__ const float* mask_group(const Params& p, int b,
                                                   int h, int bh) {
  if (p.mask_mode == 0) return nullptr;
  int64_t g;
  if (p.mb == 1 && p.mh == 1) g = 0;
  else if (p.mb == 1) g = h;
  else if (p.mh == 1) g = b;
  else g = bh;
  return p.mask + g * (p.mask_mode == 1 ? 1 : p.Sq) * (int64_t)p.Sk;
}

namespace tc = ptk::tc;

// -- float32 on the tensor cores, in split TF32 -------------------------------

template <int D>
constexpr int tf32_smem_bytes() {
  // two k and two v tiles (f32), two key-bias rows
  return 4 * BK * D * 4 + 2 * BK * 4;
}

template <int D>
// three blocks an SM at D = 64 (168 registers, no spill); one at D = 128,
// whose tiles take 128 KB
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 1)
    flash_fwd_tf32(const Params p) {
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int NG = D / 32;  // 32-wide column groups of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [2][BK][D]
  float* Vs = Ks + 2 * BK * D;                     // [2][BK][D]
  float* Bs = Vs + 2 * BK * D;                     // [2][BK]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;          // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* mg = mask_group(p, b, h, bh);
  auto load_bias = [&](int buf, int k0) {
    for (int c = tid; c < BK; c += NT)
      Bs[buf * BK + c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  };

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  tc::load_tile_f32<D, BK, NT>(Ks, kb, p.k_ss, 0, p.Sk, tid);
  tc::load_tile_f32<D, BK, NT>(Vs, vb, p.v_ss, 0, p.Sk, tid);
  tc::cp_async_commit();
  if (p.mask_mode == 1) load_bias(0, 0);

  uint32_t hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    hrow[i] =
        p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, rows[i]) : 0u;
  const float inv_keep = 1.f / p.keep_div;

  // o[G][n][.]: the C tile of output n-tile n of column group G, whose
  // logical column c is column 32 G + 4 c + n of O (v is read that way)
  float o[NG][4][4];
  float m[2], l[2];  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = __int_as_float(0xff800000);  // -inf
    l[i] = 0.f;
  }
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[G][n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    const int k0 = j * BK;
    tc::cp_async_wait_all();
    __syncthreads();  // tile j is in; every reader of tile j-1 is done
    if (j + 1 < nk) {
      tc::load_tile_f32<D, BK, NT>(Ks + (buf ^ 1) * BK * D, kb, p.k_ss,
                                   k0 + BK, p.Sk, tid);
      tc::load_tile_f32<D, BK, NT>(Vs + (buf ^ 1) * BK * D, vb, p.v_ss,
                                   k0 + BK, p.Sk, tid);
      tc::cp_async_commit();
      if (p.mask_mode == 1) load_bias(buf ^ 1, k0 + BK);
    }
    const float* Kt = Ks + buf * BK * D;
    const float* Vt = Vs + buf * BK * D;

    // s = q k^T: 16 rows x 64 keys a warp, eight 8-key n-tiles. A slice
    // of 16 columns at a time: q's rows (pre-scaled) read anew from
    // device memory (L1 after the first tile) and split, where keeping
    // them in registers would cost a block an SM; qk[4 i + j] is row
    // rows[i] at column 16 kk + 4 t4 + j, so that step u takes columns
    // 4 t4 + 2u (as k = t4) and 4 t4 + 2u + 1 (as k = t4 + 4). k's
    // columns 4 t4 .. 4 t4 + 3 come in one 16-byte load.
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < KD; ++kk) {
      float qk[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rows[i] < p.Sq)
          x = *reinterpret_cast<const float4*>(qb + rows[i] * p.q_ss +
                                               16 * kk + 4 * t4);
        qk[4 * i + 0] = x.x * p.scale;
        qk[4 * i + 1] = x.y * p.scale;
        qk[4 * i + 2] = x.z * p.scale;
        qk[4 * i + 3] = x.w * p.scale;
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        tc::tf32_split(qk[2 * u], ah[u][0], al[u][0]);
        tc::tf32_split(qk[4 + 2 * u], ah[u][1], al[u][1]);
        tc::tf32_split(qk[2 * u + 1], ah[u][2], al[u][2]);
        tc::tf32_split(qk[4 + 2 * u + 1], ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Kt + tc::f32_off<D>(t * 8 + g, kk * 4 + t4));
        uint32_t bh[4], bl[4];
        tc::tf32_split(kv.x, bh[0], bl[0]);
        tc::tf32_split(kv.y, bh[1], bl[1]);
        tc::tf32_split(kv.z, bh[2], bl[2]);
        tc::tf32_split(kv.w, bh[3], bl[3]);
        tc::mma_3xtf32(s[t], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        tc::mma_3xtf32(s[t], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // bias, and -1e30 where a key is past Sk or above the diagonal
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
        float x = s[t][e];
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
      corr[i] = m[i] <= NEG_INF ? 0.f : expf(m[i] - msafe[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }

    // p, l from the undropped p, then the dropped p
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[t][e];
        float pv = x <= NEG_INF ? 0.f : expf(x - msafe[e >> 1]);
        l[e >> 1] += pv;
        if (p.dropout)
          pv = ptk::dropout_keep(hrow[e >> 1], ptk::seed_word(p, 0),
                                 k0 + t * 8 + t4 * 2 + (e & 1), p.threshold)
                   ? pv * inv_keep
                   : 0.f;
        s[t][e] = pv;
      }
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[G][n][e] *= corr[e >> 1];

    // o += p v, 8 keys a step: p's C tile t is the A fragment with k = t4
    // as key 2 t4 and k = t4 + 4 as key 2 t4 + 1; v's rows 2 t4 and
    // 2 t4 + 1 are then b0 and b1, four output n-tiles a 16-byte load
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      uint32_t ph[4], pl[4];
      tc::tf32_split(s[t][0], ph[0], pl[0]);
      tc::tf32_split(s[t][2], ph[1], pl[1]);
      tc::tf32_split(s[t][1], ph[2], pl[2]);
      tc::tf32_split(s[t][3], ph[3], pl[3]);
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        const float4 v0 = *reinterpret_cast<const float4*>(
            Vt + tc::f32_off<D>(t * 8 + 2 * t4, G * 8 + g));
        const float4 v1 = *reinterpret_cast<const float4*>(
            Vt + tc::f32_off<D>(t * 8 + 2 * t4 + 1, G * 8 + g));
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          tc::tf32_split(b0[n], bh0, bl0);
          tc::tf32_split(b1[n], bh1, bl1);
          tc::mma_3xtf32(o[G][n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  tc::cp_async_wait_all();  // no copy outlives the block

  // row rows[i] of O: logical columns 2 t4 and 2 t4 + 1 of the four
  // n-tiles of group G are O's columns 32 G + 8 t4 .. 32 G + 8 t4 + 7,
  // two 16-byte stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = rows[i];
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = ob + row * p.o_ss + 8 * t4;
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<float4*>(orow + 32 * G + 4 * c) = make_float4(
            o[G][0][2 * i + c] * inv, o[G][1][2 * i + c] * inv,
            o[G][2][2 * i + c] * inv, o[G][3][2 * i + c] * inv);
    if (t4 == 0) {
      const int64_t r = (int64_t)bh * p.Sq + row;
      p.m[r] = m[i] <= NEG_INF ? 0.f : m[i];
      p.l[r] = l[i];
    }
  }
}


// -- bf16 on the tensor cores ---------------------------------------------

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
  const float* mg = mask_group(p, b, h, bh);
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
    hrow[i] =
        p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, rows[i]) : 0u;
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
          pv = ptk::dropout_keep(hrow[e >> 1], ptk::seed_word(p, 0),
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
  return launch_kernel(flash_fwd_tf32<D>, tf32_smem_bytes<D>(), p, bh,
                       device, stream, opted_in);
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, int device,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  return launch_kernel(flash_fwd_tc<D>, tc_smem_bytes<D>(), p, bh, device,
                       stream, opted_in);
}

// q, k and v are read by 16-byte copies: the base pointer and every
// stride of a dimension longer than 1 must be a multiple of 16 bytes
// (`per16` elements)
bool rows_aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss,
                  int B, int H, int S, int per16) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (B == 1 || sb % per16 == 0) && (H == 1 || sh % per16 == 0) &&
         (S == 1 || ss % per16 == 0);
}

}  // namespace

// q (B,H,Sq,D), k and v (B,H,Sk,D), O (B,H,Sq,D): any strides for the
// batch, head and sequence dims, the head dim contiguous (strides in
// elements). mask: contiguous f32 (mb*mh, 1 or Sq, Sk) for mask_mode 1 or
// 2, else null. m, l: contiguous f32 (B*H, Sq). D must be 64 or 128.
// q, k, v must start on 16 bytes and have strides that are multiples of
// 16 bytes (cudaErrorMisalignedAddress otherwise); O's row stride must be
// a multiple of 4 elements.
// dropout 1 drops attention probabilities where the counter hash of
// (seed0, seed1, bh, row, col) is below threshold, scaling the kept ones
// by 1 / keep_div; `seed` points at the two words (seed0, seed1) in
// device memory, which the kernel reads when it runs, so a CUDA graph
// that replays the launch reads the words its replay drew (null and
// unread when dropout is 0). Launches on `stream` and returns a CUDA
// error code; allocates nothing.
extern "C" int flash_attention_fwd(
    int device, const void* q, const void* k, const void* v,
    const void* mask, void* o, void* m, void* l, int B, int H, int Sq,
    int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int mask_mode, int mb, int mh, float scale, int causal,
    int bf16, int dropout, unsigned threshold, const void* seed,
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
  p.seed = static_cast<const uint32_t*>(seed);
  p.keep_div = keep_div;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  const int per16 = bf16 ? 8 : 4;
  if (!rows_aligned(q, q_sb, q_sh, q_ss, B, H, Sq, per16) ||
      !rows_aligned(k, k_sb, k_sh, k_ss, B, H, Sk, per16) ||
      !rows_aligned(v, v_sb, v_sh, v_ss, B, H, Sk, per16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (bf16) {
    err = D == 64 ? launch_bf16<64>(p, bh, device, s)
                  : launch_bf16<128>(p, bh, device, s);
  } else {
    err = D == 64 ? launch_f32<64>(p, bh, device, s)
                  : launch_f32<128>(p, bh, device, s);
  }
  return static_cast<int>(err);
}
