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
// bf16). a is (M, K) and b is (N, K), each row-major with a row pitch
// (b is the weight's (out, in) layout, which mma's .col operand wants).
// The epilogue is __fmul_rn / __fadd_rn, in the reference's order, so no
// FMA contraction moves it off the plain version. Bound at BERT-base's
// shapes (M = 4096): the f32 output, e.g. the FFN-up product writes 50.3
// MB (15.0 us at 3.35 TB/s) for 19.3 GOP (9.8 us at 1,979 TOP/s dense
// int8). Design (right and simple first): 128 x 128 output tiles, 8 warps
// of 64 x 32 each, K in steps of 64 bytes double-buffered in shared memory
// through 16-byte cp.async (zero-filled past M, N and K); mma.sync
// m16n8k32 s8.s8.s32 on the tensor cores; rows padded to 80 bytes so the
// fragment loads meet no bank conflict. Where K or a pitch is not a
// multiple of 16 the tiles are filled a byte at a time instead (the
// reference's ragged shapes, ResNet's first convolution at K = 147).
// wgmma, TMA and a deeper pipeline are later work (ROADMAP Queue B).

#include <stdint.h>

#include "common.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int BM = 128, BN = 128, BK = 64;  // tile: rows, cols, K bytes
constexpr int PITCH = 80;                   // shared row pitch in bytes
constexpr int NT = 256;                     // threads: 8 warps, 2 x 4
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

// -- the GEMM ----------------------------------------------------------------

struct GemmParams {
  const int8_t* a;
  const int8_t* b;
  const float* wscale;
  const float* ascale;
  const void* bias;
  void* out;
  long long lda, ldb, ldo;
  int m, n, k;
  float qmax;
  int bias_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes where !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// rows row0.. of a (rows, k) int8 matrix with pitch ld into a BM x BK
// shared tile (PITCH bytes a row), zero past `rows` and `k`
template <bool VEC>
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* src,
                                          long long ld, int row0, int rows,
                                          int k0, int k, int tid) {
  if constexpr (VEC) {
    // 128 rows x 4 chunks of 16 bytes: 2 chunks a thread
#pragma unroll
    for (int e = tid; e < BM * (BK / 16); e += NT) {
      const int r = e >> 2, c = (e & 3) * 16;
      const bool in = row0 + r < rows && k0 + c < k;
      const int8_t* s = in ? src + (long long)(row0 + r) * ld + k0 + c : src;
      cp16(tile + r * PITCH + c, s, in);
    }
  } else {
    // a byte at a time, 4 consecutive bytes a step: 32 bytes a thread
#pragma unroll 2
    for (int e = tid; e < BM * (BK / 4); e += NT) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const bool row_in = row0 + r < rows;
      const int8_t* s = src + (long long)(row0 + r) * ld;
      char4 v;
      v.x = row_in && k0 + c + 0 < k ? s[k0 + c + 0] : 0;
      v.y = row_in && k0 + c + 1 < k ? s[k0 + c + 1] : 0;
      v.z = row_in && k0 + c + 2 < k ? s[k0 + c + 2] : 0;
      v.w = row_in && k0 + c + 3 < k ? s[k0 + c + 3] : 0;
      *reinterpret_cast<char4*>(tile + r * PITCH + c) = v;
    }
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
  float v = __fmul_rn(__int2float_rn(acc), step);
  v = __fmul_rn(v, __ldg(p.wscale + col));
  if (p.bias != nullptr) {
    const float b =
        p.bias_bf16
            ? __bfloat162float(
                  static_cast<const __nv_bfloat16*>(p.bias)[col])
            : __ldg(static_cast<const float*>(p.bias) + col);
    v = __fadd_rn(v, b);
  }
  static_cast<OutT*>(p.out)[(long long)row * p.ldo + col] = from_f32<OutT>(v);
}

// Fragments of mma.m16n8k32 (PTX ISA, "Matrix Fragments for
// mma.m16n8k32"), lane = 4 g + t, each register four int8:
//   A (16 x 32): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..),
//                a3 (g+8, 16+4t..)
//   B (32 x 8, held as its transpose's rows): b0 (n g, k 4t..4t+3),
//                b1 (n g, k 16+4t..)
//   C (16 x 8 int32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <bool VEC, typename OutT>
__global__ void __launch_bounds__(NT) int8_gemm_tc(const GemmParams p) {
  __shared__ __align__(16) int8_t sa[2][BM * PITCH];
  __shared__ __align__(16) int8_t sb[2][BN * PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 cols
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.k + BK - 1) / BK;
  if (ktiles > 0) {
    load_tile<VEC>(sa[0], p.a, p.lda, m0, p.m, 0, p.k, tid);
    load_tile<VEC>(sb[0], p.b, p.ldb, n0, p.n, 0, p.k, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile<VEC>(sa[cur ^ 1], p.a, p.lda, m0, p.m, (kt + 1) * BK, p.k,
                     tid);
      load_tile<VEC>(sb[cur ^ 1], p.b, p.ldb, n0, p.n, (kt + 1) * BK, p.k,
                     tid);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int8_t* ta = sa[cur] + (wm * 64) * PITCH;
    const int8_t* tb = sb[cur] + (wn * 32) * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = ta + (i * 16 + g) * PITCH + kk + 4 * t;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r0 + 8 * PITCH);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r0 + 8 * PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = tb + (j * 8 + g) * PITCH + kk + 4 * t;
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

int quantize_blocks(long long work) {
  const long long b = (work + QNT - 1) / QNT;
  return static_cast<int>(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
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
// ldo. Launches one kernel on `stream`; returns a CUDA error code.
extern "C" int int8_gemm(int device, const void* a, long long lda,
                         const void* b, long long ldb, const void* wscale,
                         const void* ascale, const void* bias, int bias_bf16,
                         void* out, long long ldo, int m, int n, int k,
                         int qmax, int out_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || qmax <= 0 || lda < k || ldb < k || ldo < n ||
      (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p{static_cast<const int8_t*>(a),
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
               bias_bf16};
  const bool vec = k % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                   aligned(a, 16) && aligned(b, 16);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    if (vec)
      int8_gemm_tc<true, __nv_bfloat16><<<grid, NT, 0, s>>>(p);
    else
      int8_gemm_tc<false, __nv_bfloat16><<<grid, NT, 0, s>>>(p);
  } else {
    if (vec)
      int8_gemm_tc<true, float><<<grid, NT, 0, s>>>(p);
    else
      int8_gemm_tc<false, float><<<grid, NT, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
