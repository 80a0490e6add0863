// Post-training int8 products for Hopper (sm_90a): the activation
// quantizer and the int8 x int8 -> int32 GEMM with its float epilogue.
//
// Replaces: no Pallas kernel. The reference's frozen int8 layers
// (paddle_tpu/quantization.py) multiply on the MXU through XLA:
// `lax.dot_general(..., preferred_element_type=int32)` in
// QuantizedLinear (:242) and `lax.conv_general_dilated(...,
// preferred_element_type=int32)` in QuantizedConv2D (:318), each behind an
// elementwise activation quantizer. PyTorch on CUDA has no route that
// follows them at every shape (`torch._int_mm` wants more than 16 rows
// and K, N multiples of 8, and there is no int8 convolution), so the port
// runs both layers through these two kernels; the convolution as an
// im2col of the quantized input followed by the GEMM.
//
// int8_quantize: q = clamp(rint(x / step), -qmax, qmax) as int8, with
//   step = max(act_scale, 1e-8) / qmax
// computed on the card from the act_scale buffer (no host read, so a CUDA
// graph captures it and a replay sees a loaded scale). x is float32 or
// bf16 rows (M, K) with a row pitch; q is packed (M, K). IEEE division
// (__fdiv_rn) and round-half-even (rintf), as jnp.round and torch.round.
// Bound: memory, 5 bytes an element for f32 (3 for bf16). Design: one
// thread per 4 elements with 16-byte loads (8-byte for bf16) and 4-byte
// stores where the rows allow it, else one element a thread.
//
// int8_gemm: out[m, n] = (float(acc[m, n]) * step) * wscale[n] (+ bias[n])
// with acc = sum_k a[m, k] * b[n, k] in int32, cast to out's dtype (f32 or
// bf16). a is (M, K) and b is (N, K), each row-major with a row pitch:
// both K-major, as 8-bit wgmma wants them (b is the weight's (out, in)
// layout). The epilogue is __int2float_rn, then __fmul_rn by step and by
// wscale and __fadd_rn of bias, in the reference's order, so no FMA
// contraction moves it off the plain version: the int32 sums are exact
// and the outputs equal the plain version's to the bit.
//
// What bounds it on an H100 (3.35 TB/s, 1,979 dense int8 TOP/s): at
// BERT-base's served batch (M = 4,096) the f32 output's bytes. FFN-up
// (768 -> 3,072) writes 50.3 of its 55.8 MB (16.7 us) for 19.3 GOP (9.8
// us), and QKV and out likewise; FFN-down (K = 3,072) is bound by its
// operations, 19.3 GOP (9.8 us) against 27.5 MB (8.2 us), as is
// bench_int8's 512 x 4,096 x 4,096: 17.2 GOP (8.7 us) against 27.3 MB.
//
// Design, int8_gemm_wgmma<BN, OutT> (every product whose A and B TMA can
// load: base addresses 16-byte aligned, row pitches multiples of 16
// bytes, K > 0):
// * wgmma.mma_async m64nBNk32 s32.s8.s8, both operands from shared
//   memory through 128-byte-swizzled descriptors: the tensor cores' full
//   dense int8 rate, where mma.sync reaches about half. A tile is 128 rows
//   x BN columns, BN 128 or 192, chosen per product by the wrapper
//   (ops/kernels/int8_gemm.py, gemm_route).
// * A ring of K steps of 128 bytes (5 stages at BN = 128, 3 at 192),
//   filled by TMA (2-D tensor maps with 128-byte swizzle, whose zero fill
//   past M, N and K replaces predicated copies) under full/empty
//   mbarriers. One producer thread issues the loads; each of two consumer
//   warpgroups owns 64 rows x BN int32 accumulators and releases a stage
//   after its wgmma.wait_group. setmaxnreg gives the producer
//   warpgroup's registers to the consumers.
// * A persistent walk: min(tiles, SMs) blocks each take every gridDim-th
//   tile, M fastest, so the blocks running together share B's tiles in
//   L2; the producer runs ahead into the next tile while the consumers
//   finish this one's epilogue.
// * The epilogue: wscale and bias are loaded while the products run and
//   staged in shared memory once a tile; each consumer scales its
//   fragment in registers and stages it, f32, in shared memory under the
//   same 128-byte swizzle (its writes meet no bank conflict), and a
//   store-issuer thread writes the half tile out by TMA stores and hands
//   the buffer back once they have read it, while the consumer goes on
//   to its next tile. Where TMA cannot store (a bf16 output, or an f32
//   row pitch that is not a multiple of 16 bytes) the consumer writes
//   two outputs a store from its registers. The f32 output stays f32:
//   the reference computes f32.
// The tensor maps are encoded on the host at every call, for that call's
// pointers (a CUDA graph keeps the launch's parameters by value), by
// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's
// cudaGetDriverEntryPoint, so the library links nothing beyond the
// runtime.
//
// int8_gemm_tc<OutT> (the products TMA cannot load: K or a pitch not a
// multiple of 16 bytes, a misaligned column slice; ResNet-50's first
// convolution at K = 147, the reference's ragged shapes): mma.sync
// m16n8k32 s8 on 128 x 128 tiles, 8 warps of 64 x 32, K in steps of 64
// bytes filled a byte at a time (zero past M, N and K) into shared rows
// padded to 80 bytes.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int QNT = 256;                    // quantizer threads per block

__device__ __forceinline__ float act_step(const float* ascale, float qmax) {
  return __fdiv_rn(fmaxf(__ldg(ascale), 1e-8f), qmax);
}

__device__ __forceinline__ int8_t quantize1(float v, float step,
                                            float qmax) {
  float r = rintf(__fdiv_rn(v, step));
  r = fminf(fmaxf(r, -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

// -- the quantizer ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(QNT)
    int8_quantize_scalar(const T* __restrict__ x, long long ldx,
                    const float* __restrict__ ascale, float qmax,
                    int8_t* __restrict__ q, long long m, long long k) {
  const float step = act_step(ascale, qmax);
  const long long total = m * k;
  for (long long i = blockIdx.x * (long long)QNT + threadIdx.x; i < total;
       i += (long long)gridDim.x * QNT) {
    const long long r = i / k, c = i - r * k;
    q[i] = quantize1(to_f32(x[r * ldx + c]), step, qmax);
  }
}

template <typename T>
struct Pack4;
template <>
struct Pack4<float> {
  using type = float4;
};
template <>
struct Pack4<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ void unpack4(const typename Pack4<T>::type& p,
                                        float (&v)[4]);
template <>
__device__ __forceinline__ void unpack4<float>(const float4& p,
                                               float (&v)[4]) {
  v[0] = p.x;
  v[1] = p.y;
  v[2] = p.z;
  v[3] = p.w;
}
template <>
__device__ __forceinline__ void unpack4<__nv_bfloat16>(const uint2& p,
                                                       float (&v)[4]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&p);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
}

// k and ldx multiples of 4, x aligned to 4 elements: 4 elements a thread
template <typename T>
__global__ void __launch_bounds__(QNT)
    int8_quantize_vec4(const T* __restrict__ x, long long ldx,
                  const float* __restrict__ ascale, float qmax,
                  int8_t* __restrict__ q, long long m, long long k) {
  using P = typename Pack4<T>::type;
  const float step = act_step(ascale, qmax);
  const long long k4 = k / 4, total = m * k4;
  for (long long i = blockIdx.x * (long long)QNT + threadIdx.x; i < total;
       i += (long long)gridDim.x * QNT) {
    const long long r = i / k4, c = (i - r * k4) * 4;
    float v[4];
    unpack4<T>(*reinterpret_cast<const P*>(x + r * ldx + c), v);
    char4 o;
    o.x = quantize1(v[0], step, qmax);
    o.y = quantize1(v[1], step, qmax);
    o.z = quantize1(v[2], step, qmax);
    o.w = quantize1(v[3], step, qmax);
    *reinterpret_cast<char4*>(q + r * k + c) = o;
  }
}


// -- the GEMM: what both kernels share ----------------------------------------

struct GemmParams {
  const int8_t* a;           // the wgmma kernel reads a and b through
  const int8_t* b;           // its tensor maps
  const float* wscale;
  const float* ascale;
  const void* bias;
  void* out;
  long long lda, ldb, ldo;
  int m, n, k;
  float qmax;
  int bias_bf16;
  int tma_store;             // int8_gemm_wgmma: write through map_out,
  int pair_store;            // else two outputs a store where aligned
  int m_tiles, tiles;        // int8_gemm_wgmma: the persistent walk
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bias_at(const GemmParams& p, int col) {
  return p.bias_bf16
             ? __bfloat162float(
                   static_cast<const __nv_bfloat16*>(p.bias)[col])
             : __ldg(static_cast<const float*>(p.bias) + col);
}

// (acc * step) * w (+ b), rounded at each step as the reference rounds
__device__ __forceinline__ float epilogue1(int acc, float step, float w,
                                           float b, bool has_bias) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), step), w);
  return has_bias ? __fadd_rn(v, b) : v;
}

// -- int8_gemm_tc: mma.sync with byte loads, for what TMA cannot load --------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;  // rows, cols, K bytes
constexpr int TC_PITCH = 80;                // shared row pitch in bytes
constexpr int TC_NT = 256;                  // threads: 8 warps, 2 x 4

// rows row0.. of a (rows, k) int8 matrix with pitch ld into a TC_BM x
// TC_BK shared tile (TC_PITCH bytes a row), zero past `rows` and `k`, a
// byte at a time, 4 consecutive bytes a step: 32 bytes a thread
__device__ __forceinline__ void load_tile_bytes(int8_t* tile,
                                                const int8_t* src,
                                                long long ld, int row0,
                                                int rows, int k0, int k,
                                                int tid) {
#pragma unroll 2
  for (int e = tid; e < TC_BM * (TC_BK / 4); e += TC_NT) {
    const int r = e / (TC_BK / 4), c = (e % (TC_BK / 4)) * 4;
    const bool row_in = row0 + r < rows;
    const int8_t* s = src + (long long)(row0 + r) * ld;
    char4 v;
    v.x = row_in && k0 + c + 0 < k ? s[k0 + c + 0] : 0;
    v.y = row_in && k0 + c + 1 < k ? s[k0 + c + 1] : 0;
    v.z = row_in && k0 + c + 2 < k ? s[k0 + c + 2] : 0;
    v.w = row_in && k0 + c + 3 < k ? s[k0 + c + 3] : 0;
    *reinterpret_cast<char4*>(tile + r * TC_PITCH + c) = v;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename OutT>
__device__ __forceinline__ void store_out(const GemmParams& p, int row,
                                          int col, int acc, float step) {
  if (row >= p.m || col >= p.n) return;
  const float v =
      epilogue1(acc, step, __ldg(p.wscale + col),
                p.bias != nullptr ? bias_at(p, col) : 0.f, p.bias != nullptr);
  static_cast<OutT*>(p.out)[(long long)row * p.ldo + col] = from_f32<OutT>(v);
}

// Fragments of mma.m16n8k32 (PTX ISA, "Matrix Fragments for
// mma.m16n8k32"), lane = 4 g + t, each register four int8:
//   A (16 x 32): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..),
//                a3 (g+8, 16+4t..)
//   B (32 x 8, held as its transpose's rows): b0 (n g, k 4t..4t+3),
//                b1 (n g, k 16+4t..)
//   C (16 x 8 int32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <typename OutT>
__global__ void __launch_bounds__(TC_NT) int8_gemm_tc(const GemmParams p) {
  __shared__ __align__(16) int8_t sa[2][TC_BM * TC_PITCH];
  __shared__ __align__(16) int8_t sb[2][TC_BN * TC_PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.k + TC_BK - 1) / TC_BK;
  if (ktiles > 0) {
    load_tile_bytes(sa[0], p.a, p.lda, m0, p.m, 0, p.k, tid);
    load_tile_bytes(sb[0], p.b, p.ldb, n0, p.n, 0, p.k, tid);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile_bytes(sa[cur ^ 1], p.a, p.lda, m0, p.m, (kt + 1) * TC_BK,
                      p.k, tid);
      load_tile_bytes(sb[cur ^ 1], p.b, p.ldb, n0, p.n, (kt + 1) * TC_BK,
                      p.k, tid);
    }
    __syncthreads();
    const int8_t* ta = sa[cur] + (wm * 64) * TC_PITCH;
    const int8_t* tb = sb[cur] + (wn * 32) * TC_PITCH;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = ta + (i * 16 + g) * TC_PITCH + kk + 4 * t;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r0 + 8 * TC_PITCH);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r0 + 8 * TC_PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = tb + (j * 8 + g) * TC_PITCH + kk + 4 * t;
        bfr[j][0] = lds32(c0);
        bfr[j][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  const float step = act_step(p.ascale, p.qmax);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      store_out<OutT>(p, row, col, acc[i][j][0], step);
      store_out<OutT>(p, row, col + 1, acc[i][j][1], step);
      store_out<OutT>(p, row + 8, col, acc[i][j][2], step);
      store_out<OutT>(p, row + 8, col + 1, acc[i][j][3], step);
    }
  }
}

// -- int8_gemm_wgmma: wgmma fed by a TMA ring, a persistent walk -------------

constexpr int WG_BM = 128;         // rows a tile: two consumers of 64
constexpr int WG_BK = 128;         // K bytes a stage: one swizzle row
constexpr int WG_THREADS = 384;    // the producer warpgroup, two consumers
constexpr int OUT_CHUNK = 64 * 128;  // a staged chunk: 64 rows x 128 bytes
// a wait on an mbarrier that outlasts this is a fault of the pipeline:
// the kernel traps (a launch error) rather than hold the card
constexpr unsigned long long WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

// Shared memory: the ring's stages of A (128 rows) and B (BN rows) of 128
// bytes, then each consumer's staged half tile (64 rows x BN f32), a
// tile's wscale and bias, and the barriers. The ring takes what the rest
// leaves of the 227 KB: 5 stages at BN = 128, 3 at BN = 192.
template <int BN>
struct WgLayout {
  static constexpr int A_BYTES = WG_BM * WG_BK;
  static constexpr int B_BYTES = BN * WG_BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = 64 * BN * 4;
  static constexpr int WSB_BYTES = 2 * BN * 4;  // a tile's wscale, bias
  static constexpr int STAGES =
      (232448 - 1024 - 2 * OUT_BYTES - WSB_BYTES - 256) / STAGE_BYTES;
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int OUT_OFF = B_OFF + STAGES * B_BYTES;
  static constexpr int WSB_OFF = OUT_OFF + 2 * OUT_BYTES;
  static constexpr int BAR_OFF = WSB_OFF + WSB_BYTES;
  // + 1024: the base is rounded up to the 1024 bytes a swizzle atom spans
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
};
static_assert(WgLayout<128>::STAGES == 5 && WgLayout<192>::STAGES == 3 &&
                  WgLayout<128>::SMEM <= 232448 &&
                  WgLayout<192>::SMEM <= 232448,
              "the ring's depth at each tile width, within 227 KB");

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try_wait(b, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(b, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// a (box rows x 128 bytes) tile at (c0 bytes along K, row c1) into shared
// memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread made visible to the TMA (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 threads of the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the shared-memory matrix descriptor of a K-major operand laid out by
// TMA's 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (the stride byte offset), the leading offset unused under a swizzle;
// adding 2 moves it 32 bytes (one k32 step) along K
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma's issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x BN int32, the warpgroup's fragment, BN / 2 a thread) += the
// product of A (64 x 32 bytes at descriptor a) and B (BN x 32 bytes at b)
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int (&d)[96], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// A staged chunk is 64 rows x 32 f32 columns, 128 bytes a row, under the
// 128-byte swizzle the TMA store reads it with: 16-byte unit u of row r
// is kept at unit u ^ (r % 8). The byte of (row r, byte c):
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// outputs (row, col) and (row, col + 1), by one store where the rows keep
// two outputs aligned (p.pair_store)
template <typename OutT>
__device__ __forceinline__ void store2(const GemmParams& p, int row, int col,
                                       float v0, float v1) {
  if (row >= p.m || col >= p.n) return;
  OutT* dst = static_cast<OutT*>(p.out) + (long long)row * p.ldo + col;
  if (p.pair_store && col + 1 < p.n) {
    if constexpr (sizeof(OutT) == 4)
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  dst[0] = from_f32<OutT>(v0);
  if (col + 1 < p.n) dst[1] = from_f32<OutT>(v1);
}

// Accumulator fragment of wgmma m64nNk32 (PTX ISA, "Register fragment
// layout for accumulator matrix D"), thread = 32 w + 4 g + t of the
// warpgroup: d[4 j + 0, 1] are rows 16 w + g, columns 8 j + 2 t + {0, 1};
// d[4 j + 2, 3] the same columns of row 16 w + g + 8.
//
// Roles: thread 0 issues the TMA loads, thread 1 the TMA stores (the rest
// of warpgroup 0 gives its registers away and leaves); warpgroups 1 and 2
// are the consumers. After its products a consumer scales its 64 x BN
// sums in registers (wscale and bias, loaded while the products run, are
// staged in shared memory once a tile) and either stages them for the
// store issuer, which writes them by TMA and hands the buffer back once
// it is read, or writes them itself where TMA cannot (bf16 outputs, other
// pitches).
template <int BN, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    int8_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out,
                    const GemmParams p) {
  using L = WgLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* staged = empty + L::STAGES;  // a consumer's outputs are staged
  uint64_t* freed = staged + 2;          // and the TMA has read them
  const int wg = threadIdx.x / 128;
  const int ktiles = (p.k + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx
      mbar_init(&empty[s], 8);   // one arrive from each consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&staged[c], 128);  // every thread of the consumer
      mbar_init(&freed[c], 1);     // the store issuer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // the producer: one thread keeps the ring full, tile after tile
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int m0 = (t % p.m_tiles) * WG_BM, n0 = (t / p.m_tiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::STAGE_BYTES);
          tma_load(smem + stage * L::A_BYTES, &map_a, &full[stage],
                   kt * WG_BK, m0);
          tma_load(smem + L::B_OFF + stage * L::B_BYTES, &map_b,
                   &full[stage], kt * WG_BK, n0);
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 1 && p.tma_store) {
      // the store issuer: a staged half tile leaves by TMA stores, and
      // its buffer goes back to the consumer once they have read it
      uint32_t it = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
        const int m0 = (t % p.m_tiles) * WG_BM, n0 = (t / p.m_tiles) * BN;
        for (int c = 0; c < 2; ++c) {
          const uint8_t* half = smem + L::OUT_OFF + c * L::OUT_BYTES;
          mbar_wait(&staged[c], it & 1);
#pragma unroll
          for (int ch = 0; ch < BN / 32; ++ch)
            tma_store(&map_out, half + ch * OUT_CHUNK, n0 + ch * 32,
                      m0 + 64 * c);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(&freed[c]);
        }
      }
      bulk_wait_all();
    }
  } else {
    // a consumer: rows 64 c .. 64 c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int r = 16 * warp + (lane >> 2), q = lane & 3;
    const int gi = 128 * c + tid;  // the scale this thread stages
    uint8_t* half = smem + L::OUT_OFF + c * L::OUT_BYTES;
    float* wsb = reinterpret_cast<float*>(smem + L::WSB_OFF);
    const float step = act_step(p.ascale, p.qmax);
    const bool has_bias = p.bias != nullptr;
    int stage = 0;
    uint32_t phase = 0, it = 0;
    int acc[BN / 2];
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
      const int m0 = (t % p.m_tiles) * WG_BM, n0 = (t / p.m_tiles) * BN;
      // this tile's wscale and bias, read while the products run
      float ws_g = 0.f, b_g = 0.f;
      if (gi < BN && n0 + gi < p.n) {
        ws_g = __ldg(p.wscale + n0 + gi);
        if (has_bias) b_g = bias_at(p, n0 + gi);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int held = -1;  // the stage the wgmma in flight reads
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        __syncwarp();  // wgmma is .aligned: the warp leaves the wait as one
        const uint64_t da =
            desc_sw128(smem + stage * L::A_BYTES + c * 64 * WG_BK);
        const uint64_t db = desc_sw128(smem + L::B_OFF + stage * L::B_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 32; ++kk)
          wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done
        fence_regs(acc);
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

      // the epilogue: out = ((float(acc) * step) * wscale (+ bias))
      consumers_sync();  // both consumers are done with the last scales
      if (gi < BN) {
        wsb[gi] = ws_g;
        wsb[BN + gi] = b_g;
      }
      consumers_sync();
      const int row0 = m0 + 64 * c;
      if (p.tma_store) mbar_wait(&freed[c], (it & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * q;
        const float2 w = *reinterpret_cast<const float2*>(wsb + cl);
        const float2 b = *reinterpret_cast<const float2*>(wsb + BN + cl);
        const float v0 = epilogue1(acc[4 * j], step, w.x, b.x, has_bias);
        const float v1 = epilogue1(acc[4 * j + 1], step, w.y, b.y, has_bias);
        const float v2 = epilogue1(acc[4 * j + 2], step, w.x, b.x, has_bias);
        const float v3 = epilogue1(acc[4 * j + 3], step, w.y, b.y, has_bias);
        if (p.tma_store) {
          uint8_t* chunk = half + (j / 4) * OUT_CHUNK;
          const int cc = 4 * (8 * (j % 4) + 2 * q);
          *reinterpret_cast<float2*>(chunk + swizzled(r, cc)) =
              make_float2(v0, v1);
          *reinterpret_cast<float2*>(chunk + swizzled(r + 8, cc)) =
              make_float2(v2, v3);
        } else {
          store2<OutT>(p, row0 + r, n0 + cl, v0, v1);
          store2<OutT>(p, row0 + r + 8, n0 + cl, v2, v3);
        }
      }
      if (p.tma_store) {
        fence_proxy_async();
        mbar_arrive(&staged[c]);
      }
    }
  }
}

int quantize_blocks(long long work) {
  const long long b = (work + QNT - 1) / QNT;
  return static_cast<int>(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// -- the tensor maps ---------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (null
// where it has none)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, inner) matrix with a pitch of `pitch` bytes, read or
// written box_rows x box_inner at a time under the 128-byte swizzle;
// outside the matrix a load reads zeros and a store writes nothing
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               long long inner, long long rows, long long pitch,
               int box_inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename OutT>
cudaError_t launch_wgmma(GemmParams p, int sms, cudaStream_t s) {
  using L = WgLayout<BN>;
  CUtensorMap ma, mb, mo = {};
  const int esize = sizeof(OutT);
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.a, p.k, p.m, p.lda,
                 WG_BK, WG_BM) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.b, p.k, p.n, p.ldb,
                 WG_BK, BN))
    return cudaErrorInvalidValue;
  // TMA stores for f32 rows on 16-byte boundaries; else two outputs a
  // store where the rows keep them aligned, else one
  p.tma_store = esize == 4 && aligned(p.out, 16) && p.ldo % 4 == 0;
  p.pair_store = aligned(p.out, 2 * esize) && p.ldo % 2 == 0;
  if (p.tma_store &&
      !encode_2d(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.out, p.n, p.m,
                 p.ldo * esize, 32, 64))
    return cudaErrorInvalidValue;
  p.m_tiles = (p.m + WG_BM - 1) / WG_BM;
  const long long tiles = (long long)p.m_tiles * ((p.n + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  auto kernel = int8_gemm_wgmma<BN, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, WG_THREADS, L::SMEM, s>>>(ma, mb, mo, p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_gemm(const GemmParams& p, int tile_n, int sms,
                        cudaStream_t s) {
  switch (tile_n) {
    case 0: {
      if ((p.m + TC_BM - 1) / TC_BM > 65535) return cudaErrorInvalidValue;
      const dim3 grid((p.n + TC_BN - 1) / TC_BN, (p.m + TC_BM - 1) / TC_BM);
      int8_gemm_tc<OutT><<<grid, TC_NT, 0, s>>>(p);
      return cudaGetLastError();
    }
    case 128:
      return launch_wgmma<128, OutT>(p, sms, s);
    case 192:
      return launch_wgmma<192, OutT>(p, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (m, k) rows of f32 (x_bf16 = 0) or bf16 with pitch ldx elements;
// ascale: one f32 on the card; q: (m, k) int8, packed. Launches one kernel
// on `stream`; returns a CUDA error code.
extern "C" int int8_quantize(int device, const void* x, long long ldx,
                             const void* ascale, int qmax, void* q,
                             long long m, long long k, int x_bf16,
                             void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || k <= 0) return 0;
  if (qmax <= 0 || ldx < k) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* as = static_cast<const float*>(ascale);
  int8_t* qp = static_cast<int8_t*>(q);
  const float qm = static_cast<float>(qmax);
  const int xbytes = x_bf16 ? 2 : 4;
  const bool vec = k % 4 == 0 && ldx % 4 == 0 && aligned(x, 4 * xbytes) &&
                   aligned(q, 4);
  const long long work = vec ? m * (k / 4) : m * k;
  const int blocks = quantize_blocks(work);
  if (x_bf16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      int8_quantize_vec4<<<blocks, QNT, 0, s>>>(xp, ldx, as, qm, qp, m, k);
    else
      int8_quantize_scalar<<<blocks, QNT, 0, s>>>(xp, ldx, as, qm, qp, m, k);
  } else {
    const float* xp = static_cast<const float*>(x);
    if (vec)
      int8_quantize_vec4<<<blocks, QNT, 0, s>>>(xp, ldx, as, qm, qp, m, k);
    else
      int8_quantize_scalar<<<blocks, QNT, 0, s>>>(xp, ldx, as, qm, qp, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (m, k) int8 with pitch lda; b: (n, k) int8 with pitch ldb; wscale:
// (n,) f32; ascale: one f32 on the card; bias: (n,) f32 or bf16
// (bias_bf16), or null; out: (m, n) f32 or bf16 (out_bf16) with pitch
// ldo. tile_n picks the kernel: 0 int8_gemm_tc (byte loads, any shape),
// 128, 192 or 256 int8_gemm_wgmma with 128 x tile_n tiles on at most
// `sms` blocks, which wants k > 0, a and b 16-byte aligned and lda, ldb
// multiples of 16 (the wrapper's gemm_route decides; a call that breaks
// these is refused, never sent to another kernel). Launches one kernel on
// `stream`; returns a CUDA error code.
extern "C" int int8_gemm(int device, const void* a, long long lda,
                         const void* b, long long ldb, const void* wscale,
                         const void* ascale, const void* bias, int bias_bf16,
                         void* out, long long ldo, int m, int n, int k,
                         int qmax, int out_bf16, int tile_n, int sms,
                         void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || qmax <= 0 || lda < k || ldb < k || ldo < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_n != 0 && (k == 0 || sms <= 0 || lda % 16 != 0 ||
                      ldb % 16 != 0 || !aligned(a, 16) || !aligned(b, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmParams p{static_cast<const int8_t*>(a),
                     static_cast<const int8_t*>(b),
                     static_cast<const float*>(wscale),
                     static_cast<const float*>(ascale),
                     bias,
                     out,
                     lda,
                     ldb,
                     ldo,
                     m,
                     n,
                     k,
                     static_cast<float>(qmax),
                     bias_bf16,
                     0,
                     0,
                     0,
                     0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = out_bf16 ? launch_gemm<__nv_bfloat16>(p, tile_n, sms, s)
                 : launch_gemm<float>(p, tile_n, sms, s);
  return static_cast<int>(err);
}
