// bf16 tensor-core building blocks for the flash-attention kernels:
// 16-byte cp.async copies into XOR-swizzled shared tiles, ldmatrix
// fragment loads, and mma.sync m16n8k16 (bf16 operands, f32 sums).
//
// A shared tile holds rows of D bf16 values, cut into 16-byte chunks of 8
// values. Chunk c of row r is stored at chunk c ^ (r & 7) of that row, so
// the eight rows one ldmatrix phase reads at one logical chunk fall in
// eight different bank groups, and neither the copies nor the fragment
// loads meet a bank conflict.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane = 4 * g + t (g the group, t its thread):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..), a3 (g+8, 8+2t..)
//   B (16 x 8, K x N), two registers: b0 (k 2t..2t+1, n g), b1 (k 8+2t..)
//   C (16 x 8 f32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C tiles of one product, two n-tiles side by side, are already
// the A fragment of the next product once rounded to bf16 pairs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptk {
namespace tc {

using bf16 = __nv_bfloat16;

// element offset of chunk c of row r in a swizzled tile of D-wide rows
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes where !pred (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows row0 .. row0+ROWS-1 of a (n, D) bf16 matrix whose rows are
// `ss` elements apart (16-byte aligned) into a swizzled tile, zero past
// row n. Every thread of the block takes part; NT threads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int64_t ss, int row0, int n,
                                          int tid) {
  constexpr int CH = D / 8;  // chunks per row
#pragma unroll
  for (int e = tid; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < n;
    const bf16* s = in ? src + (row0 + r) * ss + c * 8 : src;
    cp_async16(tile + swz<D>(r, c), s, in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows r0..r0+15, columns 16 kk .. 16 kk + 15 of a
// swizzled tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk, int lane) {
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                           kk * 2 + (lane >> 4)));
}

// B fragments where B(k, n) = tile[n0 + n][16 kk + k] (the tile's rows
// are B's columns): b[0], b[1] for columns n0..n0+7, b[2], b[3] for
// n0+8..n0+15.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int n0, int kk,
                                            int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           kk * 2 + ((lane >> 3) & 1)));
}

// B fragments where B(k, n) = tile[k0 + k][8 c0 + n] (the tile's rows are
// B's rows, read transposed): b[0], b[1] for columns 8 c0 .. 8 c0 + 7,
// b[2], b[3] for the next 8.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const bf16* tile, int k0, int c0,
                                            int lane) {
  ldsm_x4_t(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                             c0 + (lane >> 4)));
}

// c += a b on the tensor cores: a 16 x 16, b 16 x 8, bf16; c f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as one register of bf16 (round to nearest even), the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments of a 16 x (16 KS) product held as 2 KS C tiles (n-tiles
// 2 kk and 2 kk + 1 make the A fragment of columns 16 kk .. 16 kk + 15).
template <int KS>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[KS][4],
                                       const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

}  // namespace tc
}  // namespace ptk
