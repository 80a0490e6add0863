// Backward flash attention for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both launched by `_flash_bwd`). From the
// forward's saved per-row max m and normalizer l, and delta = rowsum(dO*O)
// (which the Pallas module computes outside its kernels; here the dQ
// kernel computes it for its rows and writes it for dK/dV, which runs
// after it), each recomputes for a (query, key) pair
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
// With causal 2 the caller has folded sdpa's -1e9 causal edge into a full
// bias (a mask the reference hands to sdpa): no edge here, and ds = 0
// above the diagonal, where sdpa's `where` passes no gradient.
//
// What bounds it on the H100: at BERT's shapes (S = 128, head dim 64)
// the bytes of q, k, v, dO, O and the gradients. bf16: dK/dV's four
// products need 6.5 us at (64, 12, 128, 64) on the tensor cores against a
// 23 us byte bound, dQ's three 4.9 us against 19 us. float32: each
// product runs as three TF32 products (below), 29 us for dQ and 39 us
// for dK/dV at 495 TFLOP/s against a 45 us byte bound each; and the
// integer work of splitting every operand, which the tensor cores do not
// do (PERF.md has the times against the bound).
//
// What the design does about it. Both dtypes on the tensor cores with f32
// sums, tiles copied by 16-byte cp.async into XOR-swizzled shared tiles
// (csrc/tensor_core.cuh), p and ds computed in registers from the
// accumulators and handed to the next product as its A operand straight
// from them, the scale multiplying the f32 scores and, once, the
// gradient at the end. No two blocks write the same rows, so nothing
// needs atomics and the bits are the same every run.
// dK/dV: one block per (bh, 64-key tile), 4 warps of 16 keys; k and v
// are copied once (their A fragments read from shared memory at each
// use), and the loop over 64-row query tiles, in halves of 32, from the
// causal start, double-buffers q and dO, the tile's m, 1/l, delta and
// dropout row hashes beside them. Every product runs in transposed form,
// so that each takes its A operand from registers: s^T = k q^T and dp^T
// = v dO^T (q and dO the B operands), then p^T, pd^T and ds^T in
// registers, and dv += pd^T dO, dk += ds^T q with dO, q read down their
// columns.
// dQ: one block per (bh, 64-query tile), 4 warps of 16 rows; q and dO
// copied once (their A fragments read from shared memory at each use);
// k and v tiles with the key-bias row (double-buffered in bf16, below for
// float32). Per key tile, in chunks of keys: s = q k^T and dp = dO v^T
// (k and v the B operands), p and ds in registers, dq += ds k (k read
// down its columns). Its prologue
// computes delta from dO's tile and O's rows (read while the first copies
// are in flight), in f32, and writes it for dK/dV: no PyTorch pass over
// float32 copies of dO and O.
// bf16 (`flash_bwd_dq_tc`, `flash_bwd_dkv_tc`): mma.sync m16n8k16,
// fragments through ldmatrix(.trans), p and ds rounded to bf16 as A
// operands (the one rounding the reference does not make, 2^-9
// relative); dK/dV three blocks an SM, dQ four, 16-key chunks (faster on
// the H100 than keeping fragments in registers at fewer blocks, PERF.md).
// float32 (`flash_bwd_dq_tf32`, `flash_bwd_dkv_tf32`): mma.sync m16n8k8
// on TF32 operands, each product split in three (lo hi + hi lo + hi hi,
// "3xTF32", tc::mma_3xtf32), which keeps about 2^-20 of each product
// where one TF32 product keeps 2^-10: float32 accuracy (within 1e-5 in
// the CPU emulation, tests/test_torch_flash_f32_split.py). Every operand
// is split as it is read from shared memory, with 16-byte loads: the
// products order their k index so that a thread's two k values are
// neighbours (tc::load_a_f32, tc::load_b_rows_f32), and the products that
// take a C tile as A (ds k, pd^T dO, ds^T q) order the output's columns
// so that a thread's four n-tiles read four neighbouring columns of the
// B tile (tc::load_b_cols_f32) and write four neighbouring gradient
// columns. At D = 64 dK/dV double-buffers q and dO at two blocks an SM
// (96 KB of f32 tiles each); dQ single-buffers k and v at three (64 KB),
// in chunks of 16 keys. Measured on the H100 at BERT's (64, 12, 128, 64)
// beside the parent's CUDA-core kernels (dQ 0.247 ms, dK/dV 0.285):
// double-buffered at two blocks, dQ 0.172 (32-key chunks), dK/dV 0.214;
// with q, dO (dK/dV) and k, v (dQ) split once a block into hi and lo
// tiles in shared memory as they land, 0.172 and 0.216: the split's
// integer work is not what bounds them; fully unrolled passes, 0.171 and
// 0.217; single-buffered at three blocks, dQ 0.145 (32-key chunks, 44
// bytes spilled) and 0.152 (16-key chunks, no spill), dK/dV 0.182 to
// 0.200 but with 4 to 16 bytes spilled, and at causal S = 512 0.134 to
// 0.147 against 0.112 double-buffered (PERF.md, PR 7).
// All read q, k, v, dO and O in place through their strides (the
// head-split views of BERT's fused QKV projection, and dO and O in the
// forward output's (B, S, H, D) memory order; 16-byte aligned rows, which
// the wrapper ensures), and write the gradients through strides.

#include <atomic>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;   // (G, 1 or Sq, Sk) f32, or null
  const float* m;      // (B*H, Sq)
  const float* l;      // (B*H, Sq)
  float* delta;        // (B*H, Sq): written by dQ, read by dK/dV
  const void* o;       // the forward's output
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk;
  // batch, head, sequence strides in elements: q, k, v, dO, dq, dk, dv, O
  int64_t st[8][3];
  int mask_mode;       // 0 none, 1 key row, 2 full
  int mb, mh;
  float scale;
  int causal;          // 0 none; 1 the diagonal edge; 2 the edge is in the
                       // bias, and ds is 0 above the diagonal
  int dropout;
  uint32_t threshold;
  const uint32_t* seed;  // the two dropout words, in device memory
  float keep_div;
  float inv_keep;        // 1 / keep_div, as the kernels would divide it
};

enum { Q = 0, K = 1, V = 2, DO = 3, DQ = 4, DK = 5, DV = 6, O = 7 };

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

// -- float32 on the tensor cores, in split TF32 ---------------------------------

namespace tc = ptk::tc;

constexpr int NT_TC = 128;  // 4 warps, 16 rows (dQ) or keys (dK/dV) each

template <int D>
constexpr int dkv_tf32_smem_bytes() {
  // k and v tiles; two q and two dO tiles (f32); two sets of the query
  // tile's m, 1/l, delta and dropout row hashes; the key tile's bias row;
  // the dropout word seed0 (one slot, padded)
  return (2 * BK * D + 4 * BQ * D) * 4 + 2 * 4 * BQ * 4 + BK * 4 + 16;
}

template <int D>
// two blocks an SM at D = 64, whose tiles take 96 KB; one at D = 128
__global__ void __launch_bounds__(NT_TC, D == 64 ? 2 : 1)
    flash_bwd_dkv_tf32(const Params p) {
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int NG = D / 32;  // 32-wide column groups of dk and dv
  constexpr int QC = 32;      // queries a pass
  constexpr int NT8 = QC / 8;  // 8-query n-tiles a pass
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BK][D]
  float* Vs = Ks + BK * D;                         // [BK][D]
  float* Qs = Vs + BK * D;                         // [2][BQ][D]
  float* Os = Qs + 2 * BQ * D;                     // [2][BQ][D]  dO
  float* Mr = Os + 2 * BQ * D;                     // [2][BQ] m
  float* Li = Mr + 2 * BQ;                     // [2][BQ] 1 / max(l, 1e-20)
  float* Dl = Li + 2 * BQ;                         // [2][BQ] delta
  uint32_t* Hr = reinterpret_cast<uint32_t*>(Dl + 2 * BQ);  // [2][BQ]
  float* Bk = reinterpret_cast<float*>(Hr + 2 * BQ);        // [BK]
  // seed0, staged here and read at each use: it holds no register
  uint32_t* Sd = reinterpret_cast<uint32_t*>(Bk + BK);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first key in the tile
  const int keys[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  const float* qb = at<float>(p, p.q, Q, b, h);
  const float* kb = at<float>(p, p.k, K, b, h);
  const float* vb = at<float>(p, p.v, V, b, h);
  const float* dob = at<float>(p, p.dout, DO, b, h);
  float* dkb = at<float>(p, p.dk, DK, b, h);
  float* dvb = at<float>(p, p.dv, DV, b, h);
  const float* mg = mask_group(p, b, h, bh);

  const bool causal = p.causal == 1, fold = p.causal == 2;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  auto load_q_tile = [&](int buf, int qt) {
    const int q0 = qt * BQ;
    tc::load_tile_f32<D, BQ, NT_TC>(Qs + buf * BQ * D, qb, p.st[Q][2], q0,
                                    p.Sq, tid);
    tc::load_tile_f32<D, BQ, NT_TC>(Os + buf * BQ * D, dob, p.st[DO][2], q0,
                                    p.Sq, tid);
    tc::cp_async_commit();
    for (int r = tid; r < BQ; r += NT_TC) {
      const int qi = q0 + r;
      const bool in = qi < p.Sq;
      const int64_t row = (int64_t)bh * p.Sq + qi;
      Mr[buf * BQ + r] = in ? p.m[row] : 0.f;
      Li[buf * BQ + r] = in ? 1.f / fmaxf(p.l[row], 1e-20f) : 0.f;
      Dl[buf * BQ + r] = in ? p.delta[row] : 0.f;
      Hr[buf * BQ + r] =
          p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, qi) : 0u;
    }
  };

  tc::load_tile_f32<D, BK, NT_TC>(Ks, kb, p.st[K][2], k0, p.Sk, tid);
  tc::load_tile_f32<D, BK, NT_TC>(Vs, vb, p.st[V][2], k0, p.Sk, tid);
  if (p.mask_mode == 1)
    for (int c = tid; c < BK; c += NT_TC)
      Bk[c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  if (tid == 0 && p.dropout) Sd[0] = ptk::seed_word(p, 0);
  load_q_tile(0, q_first);

  // dk[G][n], dv[G][n]: the C tile of n-tile n of column group G, whose
  // C column 2 t4 + c is column 32 G + 8 t4 + 4 c + n (tc::load_b_cols_f32)
  float dk[NG][4][4], dv[NG][4][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[G][n][e] = dv[G][n][e] = 0.f;

  for (int qt = q_first; qt < nq; ++qt) {
    const int buf = (qt - q_first) & 1;
    const int q0 = qt * BQ;
    tc::cp_async_wait_all();
    __syncthreads();  // tile qt is in; every reader of tile qt-1 is done
    if (qt + 1 < nq) load_q_tile(buf ^ 1, qt + 1);
    const float* Qt = Qs + buf * BQ * D;
    const float* Ot = Os + buf * BQ * D;
    const float* mr = Mr + buf * BQ;
    const float* li = Li + buf * BQ;
    const float* dl = Dl + buf * BQ;
    const uint32_t* hr = Hr + buf * BQ;

    // the query tile in passes of QC, so that s^T and dp^T of one pass
    // are live at a time beside the two accumulators
    const bool edge = q0 + BQ > p.Sq || k0 + BK > p.Sk ||
                      (causal && q0 < k0 + wrow + 15);
#pragma unroll 1
    for (int hq = 0; hq < BQ / QC; ++hq) {
      // s^T = k q^T and dp^T = v dO^T: 16 keys x QC queries a warp, the
      // warp's k and v rows (A) read from shared memory and split anew at
      // each slice, q's and dO's rows the B operands
      float s[NT8][4], dp[NT8][4];
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[2][4], al[2][4], fh[4], fl[4];
        tc::load_a_f32<D>(ah, al, Ks, wrow, kk, lane);
#pragma unroll
        for (int t = 0; t < NT8; ++t) {
          tc::load_b_rows_f32<D>(fh, fl, Qt, hq * QC + t * 8, kk, lane);
          tc::mma_3xtf32(s[t], ah[0], al[0], fh[0], fh[1], fl[0], fl[1]);
          tc::mma_3xtf32(s[t], ah[1], al[1], fh[2], fh[3], fl[2], fl[3]);
        }
        tc::load_a_f32<D>(ah, al, Vs, wrow, kk, lane);
#pragma unroll
        for (int t = 0; t < NT8; ++t) {
          tc::load_b_rows_f32<D>(fh, fl, Ot, hq * QC + t * 8, kk, lane);
          tc::mma_3xtf32(dp[t], ah[0], al[0], fh[0], fh[1], fl[0], fl[1]);
          tc::mma_3xtf32(dp[t], ah[1], al[1], fh[2], fh[3], fl[2], fl[3]);
        }
      }

      // p^T, pd^T (in s) and ds^T (in dp), masked per element only on an
      // edge tile: queries past Sq, keys past Sk, or the causal diagonal
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = keys[e >> 1];
          const int c = (hq * NT8 + t) * 8 + t4 * 2 + (e & 1);
          const int qi = q0 + c;
          float x = s[t][e] * p.scale;
          if (p.mask_mode == 1) x += Bk[wrow + g + ((e >> 1) << 3)];
          else if (p.mask_mode == 2)
            x += qi < p.Sq && kj < p.Sk ? mg[(int64_t)qi * p.Sk + kj] : 0.f;
          const bool valid =
              !edge || (qi < p.Sq && kj < p.Sk && (!causal || qi >= kj));
          const float pv = valid ? expf(x - mr[c]) * li[c] : 0.f;
          float pd = pv, dpv = dp[t][e];
          if (p.dropout) {
            const bool keep =
                ptk::dropout_keep(hr[c], ptk::volatile_word(Sd), kj,
                                 p.threshold);
            pd = keep ? pv * p.inv_keep : 0.f;
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          s[t][e] = pd;
          dp[t][e] = fold && qi < kj ? 0.f : pv * (dpv - dl[c]);
        }

      // dv += pd^T dO and dk += ds^T q, 8 queries a step: each C tile is
      // the split A fragment, dO's and q's rows 2 t4 and 2 t4 + 1 the B
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        uint32_t ph[4], pl[4], dh[4], dlo[4];
        tc::c_to_a_f32(ph, pl, s[t]);
        tc::c_to_a_f32(dh, dlo, dp[t]);
        const int r0 = hq * QC + t * 8;
#pragma unroll
        for (int G = 0; G < NG; ++G) {
          uint32_t fh[2][4], fl[2][4];
          tc::load_b_cols_f32<D>(fh, fl, Ot, r0, G, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tc::mma_3xtf32(dv[G][n], ph, pl, fh[0][n], fh[1][n], fl[0][n],
                           fl[1][n]);
          tc::load_b_cols_f32<D>(fh, fl, Qt, r0, G, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tc::mma_3xtf32(dk[G][n], dh, dlo, fh[0][n], fh[1][n], fl[0][n],
                           fl[1][n]);
        }
      }
    }
  }
  tc::cp_async_wait_all();  // no copy outlives the block

  // dk sums ds^T q: the scale once, here; two 16-byte stores a group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = keys[i];
    if (kj >= p.Sk) continue;
    float* dkr = dkb + kj * p.st[DK][2] + 8 * t4;
    float* dvr = dvb + kj * p.st[DV][2] + 8 * t4;
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * i + c;
        *reinterpret_cast<float4*>(dkr + 32 * G + 4 * c) = make_float4(
            dk[G][0][e] * p.scale, dk[G][1][e] * p.scale,
            dk[G][2][e] * p.scale, dk[G][3][e] * p.scale);
        *reinterpret_cast<float4*>(dvr + 32 * G + 4 * c) = make_float4(
            dv[G][0][e], dv[G][1][e], dv[G][2][e], dv[G][3][e]);
      }
  }
}

template <int D>
constexpr int dq_tf32_smem_bytes() {
  // q, dO, k and v tiles (f32); the key-bias row and the query tile's
  // delta
  return (2 * BQ * D + 2 * BK * D) * 4 + BK * 4 + BQ * 4;
}

template <int D>
// three blocks an SM at D = 64, whose tiles take 64 KB (single-buffered
// k and v: faster on the H100 than double-buffered at two, PERF.md); one
// at D = 128
__global__ void __launch_bounds__(NT_TC, D == 64 ? 3 : 1)
    flash_bwd_dq_tf32(const Params p) {
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int NG = D / 32;  // 32-wide column groups of dq
  constexpr int CH = D / 4;   // 16-byte chunks of a row
  constexpr int KC = 16;      // keys a warp takes at a time
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][D]
  float* Os = Qs + BQ * D;                         // [BQ][D]  dO
  float* Ks = Os + BQ * D;                         // [BK][D]
  float* Vs = Ks + BK * D;                         // [BK][D]
  float* Bs = Vs + BK * D;                         // [BK]
  float* Dl = Bs + BK;                             // [BQ] delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const float* qb = at<float>(p, p.q, Q, b, h);
  const float* kb = at<float>(p, p.k, K, b, h);
  const float* vb = at<float>(p, p.v, V, b, h);
  const float* dob = at<float>(p, p.dout, DO, b, h);
  const float* ob = at<float>(p, p.o, O, b, h);
  float* dqb = at<float>(p, p.dq, DQ, b, h);
  const float* mg = mask_group(p, b, h, bh);
  auto load_kv_tile = [&](int k0) {
    tc::load_tile_f32<D, BK, NT_TC>(Ks, kb, p.st[K][2], k0, p.Sk, tid);
    tc::load_tile_f32<D, BK, NT_TC>(Vs, vb, p.st[V][2], k0, p.Sk, tid);
    tc::cp_async_commit();
    if (p.mask_mode == 1)
      for (int c = tid; c < BK; c += NT_TC)
        Bs[c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  };

  const bool causal = p.causal == 1, fold = p.causal == 2;
  int nk = (p.Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  tc::load_tile_f32<D, BQ, NT_TC>(Qs, qb, p.st[Q][2], q0, p.Sq, tid);
  tc::load_tile_f32<D, BQ, NT_TC>(Os, dob, p.st[DO][2], q0, p.Sq, tid);
  load_kv_tile(0);

  // delta's operands: two lanes a row of the warp's 16, this lane's half
  // of O's row read from device memory while the copies are in flight
  const int drow = wrow + (lane >> 1);
  float4 orow[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i)
    orow[i] = q0 + drow < p.Sq
                  ? *reinterpret_cast<const float4*>(
                        ob + (q0 + drow) * p.st[O][2] +
                        ((lane & 1) + 2 * i) * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);

  float mrow[2], linv[2], dl[2];
  uint32_t hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.Sq;
    const int64_t r = (int64_t)bh * p.Sq + rows[i];
    mrow[i] = in ? p.m[r] : 0.f;
    linv[i] = in ? 1.f / fmaxf(p.l[r], 1e-20f) : 0.f;
    hrow[i] =
        p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, rows[i]) : 0u;
  }
  const float inv_keep = 1.f / p.keep_div;

  tc::cp_async_wait_all();
  __syncthreads();  // q, dO and the first k and v tiles are in
  // delta = rowsum(dO * O) (zero past Sq), written for the dK/dV kernel,
  // which runs after this one
  {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          Os + tc::f32_off<D>(drow, (lane & 1) + 2 * i));
      acc = fmaf(x.x, orow[i].x, acc);
      acc = fmaf(x.y, orow[i].y, acc);
      acc = fmaf(x.z, orow[i].z, acc);
      acc = fmaf(x.w, orow[i].w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      Dl[drow] = acc;
      if (q0 + drow < p.Sq) p.delta[(int64_t)bh * p.Sq + q0 + drow] = acc;
    }
    __syncwarp();
    dl[0] = Dl[wrow + g];
    dl[1] = Dl[wrow + g + 8];
  }

  // dq[G][n]: the C tile of n-tile n of column group G, whose C column
  // 2 t4 + c is column 32 G + 8 t4 + 4 c + n (tc::load_b_cols_f32)
  float dq[NG][4][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[G][n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (j > 0) {
      __syncthreads();  // every reader of tile j-1 is done
      load_kv_tile(k0);
      tc::cp_async_wait_all();
      __syncthreads();  // tile j is in
    }
    const bool edge = k0 + BK > p.Sk ||
                      (causal && k0 + BK - 1 > q0 + wrow);

    // the key tile in chunks of KC keys, so that s and dp of one chunk
    // are live at a time beside the accumulator; q's and dO's rows (A)
    // read from shared memory and split anew at each slice
#pragma unroll 1
    for (int hk = 0; hk < BK / KC; ++hk) {
      // s = q k^T and dp = dO v^T: 16 rows x KC keys a warp
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int t = 0; t < KC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[2][4], al[2][4], fh[4], fl[4];
        tc::load_a_f32<D>(ah, al, Qs, wrow, kk, lane);
#pragma unroll
        for (int t = 0; t < KC / 8; ++t) {
          tc::load_b_rows_f32<D>(fh, fl, Ks, hk * KC + t * 8, kk, lane);
          tc::mma_3xtf32(s[t], ah[0], al[0], fh[0], fh[1], fl[0], fl[1]);
          tc::mma_3xtf32(s[t], ah[1], al[1], fh[2], fh[3], fl[2], fl[3]);
        }
        tc::load_a_f32<D>(ah, al, Os, wrow, kk, lane);
#pragma unroll
        for (int t = 0; t < KC / 8; ++t) {
          tc::load_b_rows_f32<D>(fh, fl, Vs, hk * KC + t * 8, kk, lane);
          tc::mma_3xtf32(dp[t], ah[0], al[0], fh[0], fh[1], fl[0], fl[1]);
          tc::mma_3xtf32(dp[t], ah[1], al[1], fh[2], fh[3], fl[2], fl[3]);
        }
      }

      // p and ds = p (dp - delta) in s, masked per element only on an
      // edge tile: keys past Sk, or the causal diagonal
#pragma unroll
      for (int t = 0; t < KC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int row = rows[i];
          const int cl = hk * KC + t * 8 + t4 * 2 + (e & 1);
          const int kj = k0 + cl;
          float x = s[t][e] * p.scale;
          if (p.mask_mode == 1) x += Bs[cl];
          else if (p.mask_mode == 2)
            x += row < p.Sq && kj < p.Sk ? mg[(int64_t)row * p.Sk + kj] : 0.f;
          const bool valid =
              !edge || (kj < p.Sk && (!causal || row >= kj));
          const float pv = valid ? expf(x - mrow[i]) * linv[i] : 0.f;
          float dpv = dp[t][e];
          if (p.dropout)
            dpv = ptk::dropout_keep(hrow[i], ptk::seed_word(p, 0), kj,
                                    p.threshold)
                      ? dpv * inv_keep
                      : 0.f;
          s[t][e] = fold && row < kj ? 0.f : pv * (dpv - dl[i]);
        }

      // dq += ds k, 8 keys a step: each C tile of ds is the split A
      // fragment, k's rows 2 t4 and 2 t4 + 1 the B
#pragma unroll
      for (int t = 0; t < KC / 8; ++t) {
        uint32_t dh[4], dlo[4];
        tc::c_to_a_f32(dh, dlo, s[t]);
#pragma unroll
        for (int G = 0; G < NG; ++G) {
          uint32_t fh[2][4], fl[2][4];
          tc::load_b_cols_f32<D>(fh, fl, Ks, hk * KC + t * 8, G, lane);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tc::mma_3xtf32(dq[G][n], dh, dlo, fh[0][n], fh[1][n], fl[0][n],
                           fl[1][n]);
        }
      }
    }
  }
  tc::cp_async_wait_all();  // no copy outlives the block

  // dq sums ds k: the scale once, here; two 16-byte stores a group
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= p.Sq) continue;
    float* dqr = dqb + row * p.st[DQ][2] + 8 * t4;
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * i + c;
        *reinterpret_cast<float4*>(dqr + 32 * G + 4 * c) = make_float4(
            dq[G][0][e] * p.scale, dq[G][1][e] * p.scale,
            dq[G][2][e] * p.scale, dq[G][3][e] * p.scale);
      }
  }
}

// -- dK/dV in bf16 on the tensor cores ----------------------------------------

template <int D>
constexpr int dkv_tc_smem_bytes() {
  // k and v tiles; two q and two dO tiles (bf16); two sets of the query
  // tile's m, 1/l, delta and dropout row hashes; the key tile's bias row;
  // the dropout word seed0 (one slot, padded)
  return (2 * BK * D + 4 * BQ * D) * 2 + 2 * 4 * BQ * 4 + BK * 4 + 16;
}

// FOLD: causal 2, the edge in the bias (ds^T zeroed above the diagonal),
// an instance of its own: at D = 64 the kernel sits at its register cap,
// and the extra pass would make the path's instance spill
template <int D, bool FOLD>
// three blocks an SM at D = 64 (168 registers, no spill); two at D = 128
__global__ void __launch_bounds__(NT_TC, D == 64 ? 3 : 2)
    flash_bwd_dkv_tc(const Params p) {
  using bf16 = tc::bf16;
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int ND = D / 8;   // 8-wide n-tiles of dk and dv
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][D]
  bf16* Vs = Ks + BK * D;                        // [BK][D]
  bf16* Qs = Vs + BK * D;                        // [2][BQ][D]
  bf16* Os = Qs + 2 * BQ * D;                    // [2][BQ][D]  dO
  float* Mr = reinterpret_cast<float*>(Os + 2 * BQ * D);  // [2][BQ] m
  float* Li = Mr + 2 * BQ;                       // [2][BQ] 1 / max(l, 1e-20)
  float* Dl = Li + 2 * BQ;                       // [2][BQ] delta
  uint32_t* Hr = reinterpret_cast<uint32_t*>(Dl + 2 * BQ);  // [2][BQ]
  float* Bk = reinterpret_cast<float*>(Hr + 2 * BQ);        // [BK]
  // seed0, staged here and read at each use: it holds no register
  uint32_t* Sd = reinterpret_cast<uint32_t*>(Bk + BK);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first key in the tile
  const int keys[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  const bf16* qb = at<bf16>(p, p.q, Q, b, h);
  const bf16* kb = at<bf16>(p, p.k, K, b, h);
  const bf16* vb = at<bf16>(p, p.v, V, b, h);
  const bf16* dob = at<bf16>(p, p.dout, DO, b, h);
  bf16* dkb = at<bf16>(p, p.dk, DK, b, h);
  bf16* dvb = at<bf16>(p, p.dv, DV, b, h);
  const float* mg = mask_group(p, b, h, bh);

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q_first = !FOLD && p.causal ? k0 / BQ : 0;
  auto load_q_tile = [&](int buf, int qt) {
    const int q0 = qt * BQ;
    tc::load_tile<D, BQ, NT_TC>(Qs + buf * BQ * D, qb, p.st[Q][2], q0, p.Sq,
                                tid);
    tc::load_tile<D, BQ, NT_TC>(Os + buf * BQ * D, dob, p.st[DO][2], q0,
                                p.Sq, tid);
    tc::cp_async_commit();
    for (int r = tid; r < BQ; r += NT_TC) {
      const int qi = q0 + r;
      const bool in = qi < p.Sq;
      const int64_t row = (int64_t)bh * p.Sq + qi;
      Mr[buf * BQ + r] = in ? p.m[row] : 0.f;
      Li[buf * BQ + r] = in ? 1.f / fmaxf(p.l[row], 1e-20f) : 0.f;
      Dl[buf * BQ + r] = in ? p.delta[row] : 0.f;
      Hr[buf * BQ + r] =
          p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, qi) : 0u;
    }
  };

  tc::load_tile<D, BK, NT_TC>(Ks, kb, p.st[K][2], k0, p.Sk, tid);
  tc::load_tile<D, BK, NT_TC>(Vs, vb, p.st[V][2], k0, p.Sk, tid);
  if (p.mask_mode == 1)
    for (int c = tid; c < BK; c += NT_TC)
      Bk[c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  if (tid == 0 && p.dropout) Sd[0] = ptk::seed_word(p, 0);
  load_q_tile(0, q_first);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = q_first; qt < nq; ++qt) {
    const int buf = (qt - q_first) & 1;
    const int q0 = qt * BQ;
    tc::cp_async_wait_all();
    __syncthreads();  // tile qt is in; every reader of tile qt-1 is done
    if (qt + 1 < nq) load_q_tile(buf ^ 1, qt + 1);
    const bf16* Qt = Qs + buf * BQ * D;
    const bf16* Ot = Os + buf * BQ * D;
    const float* mr = Mr + buf * BQ;
    const float* li = Li + buf * BQ;
    const float* dl = Dl + buf * BQ;
    const uint32_t* hr = Hr + buf * BQ;

    // the query tile in two halves of 32, so that s^T and dp^T of one
    // half are live at a time beside the two D-wide accumulators; the k
    // and v A fragments are re-read from shared memory at each use, which
    // leaves registers for three blocks an SM (faster on the H100 than
    // keeping them in registers at two blocks, PERF.md)
    const bool edge = q0 + BQ > p.Sq || k0 + BK > p.Sk ||
                      (!FOLD && p.causal && q0 < k0 + wrow + 15);
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      // s^T = k q^T and dp^T = v dO^T: 16 keys x 32 queries a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        tc::load_a<D>(ka, Ks, wrow, kk, lane);
        tc::load_a<D>(va, Vs, wrow, kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bo[4];
          const int n0 = (hq * 2 + np) * 16;
          tc::load_b_rows<D>(bq, Qt, n0, kk, lane);
          tc::load_b_rows<D>(bo, Ot, n0, kk, lane);
          tc::mma(s[2 * np], ka, bq[0], bq[1]);
          tc::mma(s[2 * np + 1], ka, bq[2], bq[3]);
          tc::mma(dp[2 * np], va, bo[0], bo[1]);
          tc::mma(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }

      // p^T, pd^T (in s) and ds^T (in dp), masked per element only on an
      // edge tile: queries past Sq, keys past Sk, or the causal diagonal
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = keys[e >> 1];
          const int c = (hq * 4 + t) * 8 + t4 * 2 + (e & 1);
          const int qi = q0 + c;
          float x = s[t][e] * p.scale;
          if (p.mask_mode == 1) x += Bk[wrow + g + ((e >> 1) << 3)];
          else if (p.mask_mode == 2)
            x += qi < p.Sq && kj < p.Sk ? mg[(int64_t)qi * p.Sk + kj] : 0.f;
          const bool valid =
              !edge ||
              (qi < p.Sq && kj < p.Sk && (FOLD || !p.causal || qi >= kj));
          const float pv = valid ? __expf(x - mr[c]) * li[c] : 0.f;
          float pd = pv, dpv = dp[t][e];
          if (p.dropout) {
            const bool keep =
                ptk::dropout_keep(hr[c], ptk::volatile_word(Sd), kj,
                                 p.threshold);
            pd = keep ? pv * p.inv_keep : 0.f;
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          s[t][e] = pd;
          dp[t][e] = pv * (dpv - dl[c]);
        }
      if constexpr (FOLD) {  // no ds^T above the diagonal
        if (q0 + hq * 32 < k0 + wrow + 16)
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (q0 + (hq * 4 + t) * 8 + t4 * 2 + (e & 1) < keys[e >> 1])
                dp[t][e] = 0.f;
      }
      uint32_t pa[2][4], da[2][4];
      tc::c_to_a<2>(pa, s);
      tc::c_to_a<2>(da, dp);

      // dv += pd^T dO and dk += ds^T q: 16 queries a step
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t bo[4], bq[4];
          const int r0 = (hq * 2 + kk) * 16;
          tc::load_b_cols<D>(bo, Ot, r0, n2 * 2, lane);
          tc::load_b_cols<D>(bq, Qt, r0, n2 * 2, lane);
          tc::mma(dv[2 * n2], pa[kk], bo[0], bo[1]);
          tc::mma(dv[2 * n2 + 1], pa[kk], bo[2], bo[3]);
          tc::mma(dk[2 * n2], da[kk], bq[0], bq[1]);
          tc::mma(dk[2 * n2 + 1], da[kk], bq[2], bq[3]);
        }
    }
  }
  tc::cp_async_wait_all();  // no copy outlives the block

  // dk sums ds^T q: the scale once, here
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = keys[i];
    if (kj >= p.Sk) continue;
    bf16* dkr = dkb + kj * p.st[DK][2] + t4 * 2;
    bf16* dvr = dvb + kj * p.st[DV][2] + t4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + n * 8) = tc::pack_bf16(
          dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + n * 8) =
          tc::pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// -- dQ in bf16 on the tensor cores -------------------------------------------

template <int D>
constexpr int dq_tc_smem_bytes() {
  // q and dO tiles, two k and two v tiles (bf16); two key-bias rows and
  // the query tile's delta (f32)
  return (2 * BQ * D + 4 * BK * D) * 2 + 2 * BK * 4 + BQ * 4;
}

template <int D>
// four blocks an SM at D = 64 (128 registers, no spill); two at D = 128
__global__ void __launch_bounds__(NT_TC, D == 64 ? 4 : 2)
    flash_bwd_dq_tc(const Params p) {
  using bf16 = tc::bf16;
  constexpr int KD = D / 16;  // 16-wide slices of the head dim
  constexpr int ND = D / 8;   // 8-wide n-tiles of dq
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  constexpr int KC = 16;      // keys a warp takes at a time
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][D]
  bf16* Os = Qs + BQ * D;                        // [BQ][D]  dO
  bf16* Ks = Os + BQ * D;                        // [2][BK][D]
  bf16* Vs = Ks + 2 * BK * D;                    // [2][BK][D]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * D);  // [2][BK]
  float* Dl = Bs + 2 * BK;                       // [BQ] delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const bf16* qb = at<bf16>(p, p.q, Q, b, h);
  const bf16* kb = at<bf16>(p, p.k, K, b, h);
  const bf16* vb = at<bf16>(p, p.v, V, b, h);
  const bf16* dob = at<bf16>(p, p.dout, DO, b, h);
  const bf16* ob = at<bf16>(p, p.o, O, b, h);
  bf16* dqb = at<bf16>(p, p.dq, DQ, b, h);
  const float* mg = mask_group(p, b, h, bh);
  auto load_bias = [&](int buf, int k0) {
    for (int c = tid; c < BK; c += NT_TC)
      Bs[buf * BK + c] = k0 + c < p.Sk ? mg[k0 + c] : 0.f;
  };

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal == 1) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  tc::load_tile<D, BQ, NT_TC>(Qs, qb, p.st[Q][2], q0, p.Sq, tid);
  tc::load_tile<D, BQ, NT_TC>(Os, dob, p.st[DO][2], q0, p.Sq, tid);
  tc::load_tile<D, BK, NT_TC>(Ks, kb, p.st[K][2], 0, p.Sk, tid);
  tc::load_tile<D, BK, NT_TC>(Vs, vb, p.st[V][2], 0, p.Sk, tid);
  tc::cp_async_commit();
  if (p.mask_mode == 1) load_bias(0, 0);

  // delta's operands: two lanes a row of the warp's 16, this lane's half
  // of O's row read from device memory while the copies are in flight
  const int drow = wrow + (lane >> 1);
  uint4 orow[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i)
    orow[i] = q0 + drow < p.Sq
                  ? *reinterpret_cast<const uint4*>(
                        ob + (q0 + drow) * p.st[O][2] +
                        ((lane & 1) + 2 * i) * 8)
                  : make_uint4(0u, 0u, 0u, 0u);

  float mrow[2], linv[2], dl[2];
  uint32_t hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.Sq;
    const int64_t r = (int64_t)bh * p.Sq + rows[i];
    mrow[i] = in ? p.m[r] : 0.f;
    linv[i] = in ? 1.f / fmaxf(p.l[r], 1e-20f) : 0.f;
    hrow[i] =
        p.dropout ? ptk::dropout_row(ptk::seed_word(p, 1), bh, rows[i]) : 0u;
  }
  const float inv_keep = 1.f / p.keep_div;

  tc::cp_async_wait_all();
  __syncthreads();  // q, dO and the first k and v tiles are in
  // delta = rowsum(dO * O) in f32 from the bf16 rows (zero past Sq),
  // written for the dK/dV kernel, which runs after this one
  {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const uint4 dv = *reinterpret_cast<const uint4*>(
          Os + tc::swz<D>(drow, (lane & 1) + 2 * i));
      const __nv_bfloat162* x =
          reinterpret_cast<const __nv_bfloat162*>(&orow[i]);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(x[e]);
        const float2 c = __bfloat1622float2(y[e]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      Dl[drow] = acc;
      if (q0 + drow < p.Sq) p.delta[(int64_t)bh * p.Sq + q0 + drow] = acc;
    }
    __syncwarp();
    dl[0] = Dl[wrow + g];
    dl[1] = Dl[wrow + g + 8];
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    const int k0 = j * BK;
    if (j > 0) {
      tc::cp_async_wait_all();
      __syncthreads();  // tile j is in; every reader of tile j-1 is done
    }
    if (j + 1 < nk) {
      tc::load_tile<D, BK, NT_TC>(Ks + (buf ^ 1) * BK * D, kb, p.st[K][2],
                                  k0 + BK, p.Sk, tid);
      tc::load_tile<D, BK, NT_TC>(Vs + (buf ^ 1) * BK * D, vb, p.st[V][2],
                                  k0 + BK, p.Sk, tid);
      tc::cp_async_commit();
      if (p.mask_mode == 1) load_bias(buf ^ 1, k0 + BK);
    }
    const bf16* Kt = Ks + buf * BK * D;
    const bf16* Vt = Vs + buf * BK * D;
    const bool edge = k0 + BK > p.Sk ||
                      (p.causal == 1 && k0 + BK - 1 > q0 + wrow);

    // the key tile in chunks of KC keys, so that s and dp of one chunk
    // are live at a time beside the accumulator; q's and dO's A fragments
    // are re-read from shared memory at each use, one 16-wide slice at a
    // time, which leaves registers for four blocks an SM (faster on the
    // H100 than keeping them in registers at three, PERF.md)
#pragma unroll 2
    for (int hk = 0; hk < BK / KC; ++hk) {
      // s = q k^T and dp = dO v^T: 16 rows x KC keys a warp
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int t = 0; t < KC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], oa[4];
        tc::load_a<D>(qa, Qs, wrow, kk, lane);
        tc::load_a<D>(oa, Os, wrow, kk, lane);
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t kf[4], vf[4];
          const int n0 = hk * KC + np * 16;
          tc::load_b_rows<D>(kf, Kt, n0, kk, lane);
          tc::load_b_rows<D>(vf, Vt, n0, kk, lane);
          tc::mma(s[2 * np], qa, kf[0], kf[1]);
          tc::mma(s[2 * np + 1], qa, kf[2], kf[3]);
          tc::mma(dp[2 * np], oa, vf[0], vf[1]);
          tc::mma(dp[2 * np + 1], oa, vf[2], vf[3]);
        }
      }

      // p and ds = p (dp - delta) in s, masked per element only on an
      // edge tile: keys past Sk, or the causal diagonal
#pragma unroll
      for (int t = 0; t < KC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int row = rows[i];
          const int cl = hk * KC + t * 8 + t4 * 2 + (e & 1);
          const int kj = k0 + cl;
          float x = s[t][e] * p.scale;
          if (p.mask_mode == 1) x += Bs[buf * BK + cl];
          else if (p.mask_mode == 2)
            x += row < p.Sq && kj < p.Sk ? mg[(int64_t)row * p.Sk + kj] : 0.f;
          const bool valid =
              !edge || (kj < p.Sk && (p.causal != 1 || row >= kj));
          const float pv = valid ? __expf(x - mrow[i]) * linv[i] : 0.f;
          float dpv = dp[t][e];
          if (p.dropout)
            dpv = ptk::dropout_keep(hrow[i], ptk::seed_word(p, 0), kj,
                                    p.threshold)
                      ? dpv * inv_keep
                      : 0.f;
          s[t][e] = p.causal == 2 && row < kj ? 0.f : pv * (dpv - dl[i]);
        }
      uint32_t da[KC / 16][4];
      tc::c_to_a<KC / 16>(da, s);

      // dq += ds k: 16 keys a step, k through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t kf[4];
          tc::load_b_cols<D>(kf, Kt, hk * KC + kk * 16, n2 * 2, lane);
          tc::mma(dq[2 * n2], da[kk], kf[0], kf[1]);
          tc::mma(dq[2 * n2 + 1], da[kk], kf[2], kf[3]);
        }
    }
  }
  tc::cp_async_wait_all();  // no copy outlives the block

  // dq sums ds k: the scale once, here
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= p.Sq) continue;
    bf16* dqr = dqb + row * p.st[DQ][2] + t4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqr + n * 8) =
          tc::pack_bf16(dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
  }
}

constexpr int kMaxDevices = 64;

// Launch one kernel instance on a (bh, tiles) grid, opting in to its
// dynamic shared memory once per instance and device (two threads racing
// only repeat the same idempotent call).
template <typename Kern>
cudaError_t launch_kernel(Kern kernel, int threads, int bytes, int tiles,
                          int bh, int device, cudaStream_t stream,
                          std::atomic<bool>* opted_in, const Params& p) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  kernel<<<dim3(bh, tiles), threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The f32 dK/dV (DKV true) or dQ kernel, in split TF32.
template <int D, bool DKV>
cudaError_t launch_tf32(const Params& p, int bh, int device,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  if constexpr (DKV)
    return launch_kernel(flash_bwd_dkv_tf32<D>, NT_TC,
                         dkv_tf32_smem_bytes<D>(), (p.Sk + BK - 1) / BK, bh,
                         device, stream, opted_in, p);
  else
    return launch_kernel(flash_bwd_dq_tf32<D>, NT_TC, dq_tf32_smem_bytes<D>(),
                         (p.Sq + BQ - 1) / BQ, bh, device, stream, opted_in,
                         p);
}

// The bf16 dK/dV (DKV true; its FOLD instance opts in on the second half
// of `opted_in`) or dQ kernel.
template <int D, bool DKV>
cudaError_t launch_tc(const Params& p, int bh, int device,
                      cudaStream_t stream) {
  static std::atomic<bool> opted_in[2 * kMaxDevices];
  if constexpr (DKV)
    return p.causal == 2
               ? launch_kernel(flash_bwd_dkv_tc<D, true>, NT_TC,
                               dkv_tc_smem_bytes<D>(), (p.Sk + BK - 1) / BK,
                               bh, device, stream, opted_in + kMaxDevices, p)
               : launch_kernel(flash_bwd_dkv_tc<D, false>, NT_TC,
                               dkv_tc_smem_bytes<D>(), (p.Sk + BK - 1) / BK,
                               bh, device, stream, opted_in, p);
  else
    return launch_kernel(flash_bwd_dq_tc<D>, NT_TC, dq_tc_smem_bytes<D>(),
                         (p.Sq + BQ - 1) / BQ, bh, device, stream, opted_in,
                         p);
}

template <bool DKV>
cudaError_t launch_any(const Params& p, int bh, int D, int bf16, int device,
                       cudaStream_t s) {
  if (bf16)
    return D == 64 ? launch_tc<64, DKV>(p, bh, device, s)
                   : launch_tc<128, DKV>(p, bh, device, s);
  return D == 64 ? launch_tf32<64, DKV>(p, bh, device, s)
                 : launch_tf32<128, DKV>(p, bh, device, s);
}

// q, k, v, dO and O are read by 16-byte copies and loads: the base
// pointer and every stride of a dimension longer than 1 must be a
// multiple of 16 bytes (`per16` elements)
bool rows_aligned(const void* ptr, const long long* st, int B, int H, int S,
                  int per16) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (B == 1 || st[0] % per16 == 0) && (H == 1 || st[1] % per16 == 0) &&
         (S == 1 || st[2] % per16 == 0);
}

int run(bool dkv, int device, const void* q, const void* k, const void* v,
        const void* mask, const void* m, const void* l, void* delta,
        const void* dout, const void* o, void* dq, void* dk, void* dv, int B,
        int H, int Sq,
        int Sk, int D, const long long* strides, int mask_mode, int mb,
        int mh, float scale, int causal, int bf16, int dropout,
        unsigned threshold, const void* seed, float keep_div,
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
  p.delta = static_cast<float*>(delta);
  p.o = o;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.mask_mode = mask_mode;
  p.mb = mb;
  p.mh = mh;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.threshold = threshold;
  p.seed = static_cast<const uint32_t*>(seed);
  p.keep_div = keep_div;
  p.inv_keep = 1.f / keep_div;
  const int per16 = bf16 ? 8 : 4;
  if (!(rows_aligned(q, strides + 3 * Q, B, H, Sq, per16) &&
        rows_aligned(k, strides + 3 * K, B, H, Sk, per16) &&
        rows_aligned(v, strides + 3 * V, B, H, Sk, per16) &&
        rows_aligned(dout, strides + 3 * DO, B, H, Sq, per16) &&
        (dkv || rows_aligned(o, strides + 3 * O, B, H, Sq, per16))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  err = dkv ? launch_any<true>(p, bh, D, bf16, device, s)
            : launch_any<false>(p, bh, D, bf16, device, s);
  return static_cast<int>(err);
}

}  // namespace

// Both entry points take the same arguments. q, dO, O (the forward's
// output), dq (B,H,Sq,D) and k, v, dk, dv (B,H,Sk,D): any batch, head and
// sequence strides (in elements), the head dim contiguous; `strides`
// holds 24 of them, three each for q, k, v, dO, dq, dk, dv, O. mask:
// contiguous f32 (mb*mh, 1 or Sq, Sk) for mask_mode 1 or 2, else null.
// m, l, delta: contiguous f32 (B*H, Sq). D must be 64 or 128. causal: 0,
// 1 (the diagonal edge), or 2 (the caller folded the edge into a full
// bias: no edge, and ds = 0 above the diagonal). The dropout arguments
// are the forward's. q, k, v, dO (and O for dQ) must start on 16 bytes
// and have strides that are multiples of 16 bytes
// (cudaErrorMisalignedAddress otherwise); dq, dk and dv rows too, which
// are written 16 bytes at a time in f32. `flash_attention_bwd_dq` writes
// dq and delta = rowsum(dO * O), and ignores dk, dv;
// `flash_attention_bwd_dkv` reads that delta, writes dk and dv and
// ignores dq and O: it runs after dQ. Each launches on `stream` and
// returns a CUDA error code; allocates nothing.
#define PTK_BWD_ARGS                                                        \
  int device, const void *q, const void *k, const void *v,                 \
      const void *mask, const void *m, const void *l, void *delta,         \
      const void *dout, const void *o, void *dq, void *dk, void *dv,       \
      int B, int H, int Sq, int Sk, int D, const long long *strides,       \
      int mask_mode, int mb, int mh, float scale, int causal, int bf16,    \
      int dropout, unsigned threshold, const void *seed, float keep_div,   \
      void *stream
#define PTK_BWD_PASS                                                        \
  device, q, k, v, mask, m, l, delta, dout, o, dq, dk, dv, B, H, Sq, Sk,   \
      D, strides, mask_mode, mb, mh, scale, causal, bf16, dropout,         \
      threshold, seed, keep_div, stream

extern "C" int flash_attention_bwd_dq(PTK_BWD_ARGS) {
  return run(false, PTK_BWD_PASS);
}

extern "C" int flash_attention_bwd_dkv(PTK_BWD_ARGS) {
  return run(true, PTK_BWD_PASS);
}
