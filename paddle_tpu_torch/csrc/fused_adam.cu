// Fused Adam for Hopper (sm_90a): one tensor, many tensors, and the flat
// parameter arena, all through one update body.
//
// Replaces: paddle_tpu/ops/pallas/fused_adam.py, `_adam_kernel` (launched
// by `fused_adam_update`) and `_adam_multi_kernel` (launched by
// `fused_adam_update_multi` and `fused_adam_update_flat`). Per element,
// from the scalars [lr, beta1_pow, beta2_pow, wd] (already advanced for
// this step, f32 on the device, as the Pallas kernels' SMEM scalars):
//   m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
//   p = p - lr (m / (1 - beta1_pow)) / (sqrt(v / (1 - beta2_pow)) + eps)
//         [- (lr wd) p_old, the multi-tensor and arena kernels' decoupled
//          weight decay]
// p, m and v are updated in place, as the Pallas calls alias them
// (input_output_aliases). m, v and g are f32; the single-tensor kernel
// takes p in f32 or bf16 and computes in f32, the others f32 only.
//
// The body spells every operation as a rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an
// FMA: the arithmetic is the plain PyTorch version's, operation for
// operation, and the many-tensor and arena kernels give identical bits on
// the same inputs.
//
// What bounds it on the H100: memory. Each element reads p, g, m, v and
// writes p, m, v: 28 bytes in f32, for about 15 operations. BERT-base's
// 110 M parameters move 3.1 GB, 0.92 ms at 3.35 TB/s.
//
// What the design does about it: 16-byte loads and stores where a
// tensor's pointers allow (else element by element), and fixed chunks of
// 16384 elements, one per block, so that blocks are equal work whatever
// the tensor sizes. The many-tensor kernel takes a table of up to 256
// tensors' pointers and sizes as its kernel parameter (an 11.5 KB
// __grid_constant__ struct: CUDA 12.1 and later allow 32 KB), each block
// finding its tensor by binary search over the chunk prefix sums; the
// table changes every step (fresh gradients) and needs no host-to-device
// copy. The Pallas version concatenates and splits every tensor instead.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int VEC = 4;                  // elements per vector access
constexpr int CHUNK = NT * VEC * 16;    // elements per block
constexpr int MAX_TENSORS = 256;        // tensors per many-tensor launch

struct Hyper {
  float b1, omb1, b2, omb2, eps;  // omb1 = 1 - b1, rounded on the host
};

struct Step {
  float lr, omb1p, omb2p, lrwd;
};

// scal[3] (wd) is read only with DECAY: the single-tensor kernel's scalars
// are three
template <bool DECAY>
__device__ __forceinline__ Step read_step(const float* scal) {
  Step s;
  s.lr = scal[0];
  s.omb1p = __fsub_rn(1.f, scal[1]);
  s.omb2p = __fsub_rn(1.f, scal[2]);
  s.lrwd = 0.f;
  if constexpr (DECAY) s.lrwd = __fmul_rn(s.lr, scal[3]);
  return s;
}

// THE update of one element; returns the new p in f32
template <bool DECAY>
__device__ __forceinline__ float adam_elem(float p, float g, float& m,
                                           float& v, const Hyper& h,
                                           const Step& s) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mhat = __fdiv_rn(m, s.omb1p);
  const float vhat = __fdiv_rn(v, s.omb2p);
  float np = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), h.eps)));
  if constexpr (DECAY) np = __fsub_rn(np, __fmul_rn(s.lrwd, p));
  return np;
}

__device__ __forceinline__ void load4(const float* a, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(a);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a,
                                      float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(a);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store4(float* a, const float (&o)[4]) {
  *reinterpret_cast<float4*>(a) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a,
                                       const float (&o)[4]) {
  uint2 t;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16(o[j]);
  *reinterpret_cast<uint2*>(a) = t;
}

template <bool DECAY, typename P>
__device__ __forceinline__ void adam_one(P* p, const float* g, float* m,
                                         float* v, int64_t i,
                                         const Hyper& h, const Step& s) {
  float mi = m[i], vi = v[i];
  p[i] = ptk::from_f32<P>(adam_elem<DECAY>(ptk::to_f32(p[i]), g[i], mi, vi,
                                           h, s));
  m[i] = mi;
  v[i] = vi;
}

// The block's chunk of one tensor of n elements. `vec`: p, g, m and v
// allow 4-element vector access (chunks start at multiples of 4).
template <bool DECAY, typename P>
__device__ __forceinline__ void adam_chunk(P* __restrict__ p,
                                           const float* __restrict__ g,
                                           float* __restrict__ m,
                                           float* __restrict__ v, int64_t n,
                                           int64_t chunk, bool vec,
                                           const Hyper& h, const Step& s) {
  const int64_t begin = chunk * CHUNK;
  const int64_t end = begin + CHUNK < n ? begin + CHUNK : n;
  int64_t tail = begin;
  if (vec) {
    tail = begin + ((end - begin) / VEC) * VEC;
    for (int64_t i = begin + threadIdx.x * VEC; i < tail; i += NT * VEC) {
      float pv[4], gv[4], mv[4], vv[4];
      load4(p + i, pv);
      load4(g + i, gv);
      load4(m + i, mv);
      load4(v + i, vv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pv[j] = adam_elem<DECAY>(pv[j], gv[j], mv[j], vv[j], h, s);
      store4(p + i, pv);
      store4(m + i, mv);
      store4(v + i, vv);
    }
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += NT)
    adam_one<DECAY>(p, g, m, v, i, h, s);
}

// One tensor (or one arena group): block b takes chunk b.
template <bool DECAY, typename P>
__global__ void __launch_bounds__(NT)
    adam_single(P* p, const float* g, float* m, float* v, int64_t n,
                const float* scal, Hyper h, int vec) {
  const Step s = read_step<DECAY>(scal);
  adam_chunk<DECAY, P>(p, g, m, v, n, blockIdx.x, vec != 0, h, s);
}

struct Table {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  int64_t n[MAX_TENSORS];
  int first[MAX_TENSORS + 1];  // first block of each tensor; [count]: all
  unsigned char vec[MAX_TENSORS];
  int count;
};

__global__ void __launch_bounds__(NT)
    adam_multi(const __grid_constant__ Table t, const float* scal,
               Hyper h) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last tensor whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Step s = read_step<true>(scal);
  adam_chunk<true, float>(t.p[lo], t.g[lo], t.m[lo], t.v[lo], t.n[lo],
                          b - t.first[lo], t.vec[lo] != 0, h, s);
}

bool aligned(const void* a, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(a) & (bytes - 1)) == 0;
}

Hyper hyper(float b1, float omb1, float b2, float omb2, float eps) {
  return Hyper{b1, omb1, b2, omb2, eps};
}

long long blocks_for(long long n) { return (n + CHUNK - 1) / CHUNK; }

}  // namespace

// One tensor: p (n) f32 (p_bf16 0) or bf16 (1); g, m, v (n) f32; scal
// [lr, beta1_pow, beta2_pow] f32 on the device. omb1 = 1 - b1 and omb2 =
// 1 - b2. Updates p, m, v in place with one kernel on `stream`; returns a
// CUDA error code.
extern "C" int fused_adam(int device, void* p, const void* g, void* m,
                          void* v, long long n, const void* scal, float b1,
                          float omb1, float b2, float omb2, float eps,
                          int p_bf16, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (blocks_for(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h = hyper(b1, omb1, b2, omb2, eps);
  const float* sp = static_cast<const float*>(scal);
  const float* gp = static_cast<const float*>(g);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  const bool vec3 = aligned(g, 16) && aligned(m, 16) && aligned(v, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks_for(n));
  if (p_bf16)
    adam_single<false, __nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), gp, mp, vp, n, sp, h,
        vec3 && aligned(p, 8));
  else
    adam_single<false, float><<<grid, NT, 0, s>>>(
        static_cast<float*>(p), gp, mp, vp, n, sp, h,
        vec3 && aligned(p, 16));
  return static_cast<int>(cudaGetLastError());
}

// Up to 256 f32 tensors in one launch: p, g, m, v are arrays of `count`
// device pointers and n their element counts; scal [lr, beta1_pow,
// beta2_pow, wd] f32 on the device. Updates every p, m, v in place, with
// AdamW's decoupled decay (wd 0 gives Adam); returns a CUDA error code.
extern "C" int fused_adam_multi(int device, int count, void* const* p,
                                void* const* g, void* const* m,
                                void* const* v, const long long* n,
                                const void* scal, float b1, float omb1,
                                float b2, float omb2, float eps,
                                void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 0 || count > MAX_TENSORS)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.count = 0;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    const int k = t.count++;
    t.p[k] = static_cast<float*>(p[i]);
    t.g[k] = static_cast<const float*>(g[i]);
    t.m[k] = static_cast<float*>(m[i]);
    t.v[k] = static_cast<float*>(v[i]);
    t.n[k] = n[i];
    t.vec[k] = aligned(p[i], 16) && aligned(g[i], 16) &&
               aligned(m[i], 16) && aligned(v[i], 16);
    t.first[k] = static_cast<int>(blocks);
    blocks += blocks_for(n[i]);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t.count == 0) return 0;
  t.first[t.count] = static_cast<int>(blocks);
  adam_multi<<<static_cast<unsigned>(blocks), NT, 0,
               static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(scal), hyper(b1, omb1, b2, omb2, eps));
  return static_cast<int>(cudaGetLastError());
}

// An arena group: p, g, m, v (n) f32, n a multiple of 1024 (the arena's
// padding); scal [lr, beta1_pow, beta2_pow, wd] f32 on the device. The
// many-tensor kernel's update over one flat buffer, in place; returns a
// CUDA error code.
extern "C" int fused_adam_flat(int device, void* p, const void* g, void* m,
                               void* v, long long n, const void* scal,
                               float b1, float omb1, float b2, float omb2,
                               float eps, void* stream) {
  cudaError_t err = ptk::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (n % 1024 != 0 || blocks_for(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(p, 16) && aligned(g, 16) && aligned(m, 16) &&
                   aligned(v, 16);
  adam_single<true, float><<<static_cast<unsigned>(blocks_for(n)), NT, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n,
      static_cast<const float*>(scal), hyper(b1, omb1, b2, omb2, eps), vec);
  return static_cast<int>(cudaGetLastError());
}
