// Tensor-core building blocks for the flash-attention kernels: 16-byte
// cp.async copies into XOR-swizzled shared tiles, ldmatrix fragment loads,
// and mma.sync m16n8k16 (bf16 operands, f32 sums); and for float32,
// mma.sync m16n8k8 on TF32 operands with each product split in three
// ("3xTF32", below).
//
// A shared bf16 tile holds rows of D values, cut into 16-byte chunks of 8
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

// -- float32 in split TF32 ----------------------------------------------------
//
// mma.m16n8k8 with .tf32 operands (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), for lane = 4 * g + t:
//   A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, K x N): b0 (k t, n g), b1 (k t+4, n g)
//   C as for m16n8k16.
// A product sums over k, so any order of k that A and B share gives the
// same product: the kernels map k = t and t + 4 to two neighbouring
// columns, which a thread then reads with one 8- or 16-byte load.
//
// TF32 keeps 10 of float32's 23 mantissa bits, about three decimal
// digits. To keep float32's accuracy each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a b is formed as lo b_hi + hi b_lo
// + hi b_hi with f32 sums: the lo lo term dropped and the two cuts leave
// about 2^-20 of each product, against 2^-10 for one TF32 product
// (tests/test_torch_flash_f32_split.py emulates both). tf32() here cuts
// the 13 bits below TF32's mantissa (rounds toward zero): one logic
// instruction, where rounding to nearest takes two, and the split's
// integer work is what the float32 kernel spends most instructions on.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b on the tensor cores: a 16 x 8, b 8 x 8, TF32; c f32
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32, the small terms first: a as (hi, lo) fragments,
// b as (hi, lo) pairs of its two registers
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// A float32 tile holds rows of D values in 16-byte chunks of 4. Chunk c of
// row r is stored at chunk c ^ f32_swz(r) (the low three bits of c
// change), which keeps both float32 fragment reads free of bank
// conflicts: eight lanes reading rows 2i and 2i + 1 at the chunks 4 kk ..
// 4 kk + 3 (k as the B operand of q k^T: bit 2 of the swizzle differs
// between the two rows), and eight lanes reading rows e, 2 + e, 4 + e,
// 6 + e at chunks 2i and 2i + 1 (v as the B operand of p v: bits 1 and 2
// differ among the four rows). D >= 32.
__device__ __forceinline__ int f32_swz(int r) {
  return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2);
}

template <int D>
__device__ __forceinline__ int f32_off(int r, int c) {
  return r * D + ((c ^ f32_swz(r)) << 2);
}

// Copy rows row0 .. row0+ROWS-1 of a (n, D) float32 matrix whose rows are
// `ss` elements apart (16-byte aligned) into a swizzled f32 tile, zero
// past row n. Every thread of the block takes part; NT threads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* src,
                                              int64_t ss, int row0, int n,
                                              int tid) {
  constexpr int CH = D / 4;  // chunks per row
#pragma unroll
  for (int e = tid; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < n;
    const float* s = in ? src + (row0 + r) * ss + c * 4 : src;
    cp_async16(tile + f32_off<D>(r, c), s, in);
  }
}

// The split A fragments of rows r0 + g and r0 + g + 8, columns 16 kk ..
// 16 kk + 15, of a swizzled f32 tile, for the slice's two k-steps: step u
// takes columns 4 t4 + 2u (as k = t4) and 4 t4 + 2u + 1 (as k = t4 + 4),
// so a row's four columns come in one 16-byte load
template <int D>
__device__ __forceinline__ void load_a_f32(uint32_t (&ah)[2][4],
                                           uint32_t (&al)[2][4],
                                           const float* tile, int r0,
                                           int kk, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const float4 x0 = *reinterpret_cast<const float4*>(
      tile + f32_off<D>(r0 + g, kk * 4 + t4));
  const float4 x1 = *reinterpret_cast<const float4*>(
      tile + f32_off<D>(r0 + g + 8, kk * 4 + t4));
  tf32_split(x0.x, ah[0][0], al[0][0]);
  tf32_split(x1.x, ah[0][1], al[0][1]);
  tf32_split(x0.y, ah[0][2], al[0][2]);
  tf32_split(x1.y, ah[0][3], al[0][3]);
  tf32_split(x0.z, ah[1][0], al[1][0]);
  tf32_split(x1.z, ah[1][1], al[1][1]);
  tf32_split(x0.w, ah[1][2], al[1][2]);
  tf32_split(x1.w, ah[1][3], al[1][3]);
}

// The split B fragments where B(k, n) = tile[n0 + n][...] (the tile's
// rows are B's columns) in load_a_f32's k order: bh[2u] and bh[2u + 1]
// are b0 and b1 of step u
template <int D>
__device__ __forceinline__ void load_b_rows_f32(uint32_t (&bh)[4],
                                                uint32_t (&bl)[4],
                                                const float* tile, int n0,
                                                int kk, int lane) {
  const float4 x = *reinterpret_cast<const float4*>(
      tile + f32_off<D>(n0 + (lane >> 2), kk * 4 + (lane & 3)));
  tf32_split(x.x, bh[0], bl[0]);
  tf32_split(x.y, bh[1], bl[1]);
  tf32_split(x.z, bh[2], bl[2]);
  tf32_split(x.w, bh[3], bl[3]);
}

// A C tile (16 x 8) as the split A fragment of the next product, k = t4
// standing for the tile's column 2 t4 and k = t4 + 4 for column 2 t4 + 1
__device__ __forceinline__ void c_to_a_f32(uint32_t (&ah)[4],
                                           uint32_t (&al)[4],
                                           const float (&c)[4]) {
  tf32_split(c[0], ah[0], al[0]);
  tf32_split(c[2], ah[1], al[1]);
  tf32_split(c[1], ah[2], al[2]);
  tf32_split(c[3], ah[3], al[3]);
}

// The B fragments, split, for that A: rows k0 + 2 t4 (b0) and k0 + 2 t4 +
// 1 (b1) of a swizzled f32 tile, at its columns 32 G + 4 g .. 32 G + 4 g
// + 3, one 16-byte load each; n-tile n takes column 32 G + 4 g + n as its
// column g, so its C column 2 t4 + c is the product's column 32 G + 8 t4
// + 4 c + n
template <int D>
__device__ __forceinline__ void load_b_cols_f32(uint32_t (&bh)[2][4],
                                                uint32_t (&bl)[2][4],
                                                const float* tile, int k0,
                                                int G, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(
        tile + f32_off<D>(k0 + 2 * t4 + i, G * 8 + g));
    tf32_split(x.x, bh[i][0], bl[i][0]);
    tf32_split(x.y, bh[i][1], bl[i][1]);
    tf32_split(x.z, bh[i][2], bl[i][2]);
    tf32_split(x.w, bh[i][3], bl[i][3]);
  }
}

}  // namespace tc
}  // namespace ptk
