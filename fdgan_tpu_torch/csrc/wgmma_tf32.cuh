// Hopper's warpgroup products on tf32 operands for the fp32 kernels of
// dense_layer.cu, and the 3xTF32 split that keeps their sums at fp32's
// precision.
//
// 3xTF32. A tf32 value is an fp32 with its 13 low mantissa bits zero (10
// bits of mantissa, fp32's exponent). An fp32 v splits into
//     big = rna_tf32(v),   small = rna_tf32(v - big)
// (cvt.rna.tf32.f32: round to nearest, ties away from zero; v - big is exact
// in fp32), so that big + small holds v to ~2^-22 of |v|. A product of two
// fp32 values is then taken as
//     a.b ~ a_small.b_big + a_big.b_small + a_big.b_big,
// dropping only a_small.b_small (~2^-22 relative): three tf32 products, each
// exact in the tensor core and added in fp32. The two small products are
// added first, while the accumulator still holds the smaller partial sums.
// The tensor cores' tf32 rate, 495 TFLOP/s on an H100 SXM, buys 165 TFLOP/s
// of fp32 products this way, against 67 TFLOP/s on the CUDA cores. Plain
// tf32 (one product) would keep ~3 decimal digits: too few for the fp32
// path, which must match the JAX package's "highest" matmul precision.
//
// Operands. A comes from registers (the split is made there, as the values
// are computed or loaded), B from shared memory. tf32 wgmma takes no
// transpose flag: B must be K-major, [n][k], in core matrices of 8 rows of
// 16 bytes, here four fp32 of k. The kernels store B as planes of four k,
//     [k / 4][n][4 fp32],
// the layout of wgmma_bf16.cuh with a plane of four fp32 in place of eight
// bf16: SBO 128 bytes, LBO one plane, and a k8 instruction reads two planes.
// The weights arrive in that layout from device memory, big planes then
// small planes per chunk (ops/dense.py::w1_tf32x3_planes, w2_tf32x3_planes).
//
// The A fragment of m64nNk8 with tf32 operands, for lane 4*gq + tq of warp w
// of the warpgroup (rows 16w ..): a[0] = (row gq, k tq), a[1] = (gq + 8, tq),
// a[2] = (gq, tq + 4), a[3] = (gq + 8, tq + 4). The kernels take the channels
// of a 32-channel chunk in an order that gives lane tq, over the chunk's four
// k-steps, the eight consecutive channels 8tq .. 8tq + 7 of its two rows:
//     logical k = 8s + kk  (k-step s, kk < 8)  is channel  8 (kk % 4) + 2s + kk / 4,
// so a thread reads its eight values of a row as two 16-byte vectors, and
// fragment element 2i + h (i < 8, h < 2) of the step is channel 8tq + i of
// row gq + 8h: a[4s ..] is elements 4s .. 4s + 3. B's planes take the same
// order: plane p = 2s + kk / 4, element e = kk % 4 of a chunk is channel
// 8e + p.
//
// Rows of 32 fp32 (128 bytes: a chunk of x, or of g) are read that way by a
// warp's eight rows gq and four tq at once; each row's eight 16-byte vectors
// are stored permuted by tf32_swz(row), so that those reads, and the float2
// stores of an accumulator fragment into g, fall in distinct banks.

#pragma once

#include "wgmma_bf16.cuh"

namespace fdgan_dev {

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void tf32_split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// the eight values of rows gq (v[0]) and gq + 8 (v[1]) -> the A fragments of a
// 32-channel step, element 2i + h = channel 8tq + i of row gq + 8h
__device__ __forceinline__ void tf32_split_frags(const float (&v)[2][8], uint32_t (&big)[16], uint32_t (&small)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) tf32_split(v[h][i], big[2 * i + h], small[2 * i + h]);
}

// where 16-byte vector v (of a 128-byte group) of a row lies in it: rows gq and
// gq + 8 (same bits 0-1), lanes tq reading vectors 2tq and 2tq + 1, hit all 32
// banks per eight lanes; float2 stores of a fragment do per sixteen
__device__ __forceinline__ int tf32_swz(int row, int v) { return v ^ (3 * (row & 1)) ^ (4 * ((row >> 1) & 1)); }

// the eight fp32 of channels 8tq .. 8tq + 7 of a 32-channel group of a row
// (row_bytes: the row's start, group: which 128 bytes of it)
__device__ __forceinline__ void tf32_load8(const unsigned char* row_bytes, int row, int group, int tq, float (&v)[8]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 q = *reinterpret_cast<const float4*>(row_bytes + 128 * group + 16 * tf32_swz(row, 2 * tq + u));
    v[4 * u] = q.x, v[4 * u + 1] = q.y, v[4 * u + 2] = q.z, v[4 * u + 3] = q.w;
  }
}

// d (64 x 128, fp32) = a (64 x 8, tf32 in registers, the fragment above) . b^T
// (b is 128 x 8, K-major in shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 96, fp32) = a (64 x 8, tf32 in registers) . b^T (b is 96 x 8, K-major in
// shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[48], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The three products of one k-step s of a 32-channel chunk: acc += a . B over
// B's planes 2s, 2s + 1, B's big planes at b_big and small ones at b_small
// (shared-memory addresses), a plane ``plane`` bytes. first: acc starts at 0.
template <int N, typename Acc>
__device__ __forceinline__ void tf32x3_kstep(Acc& acc, const uint32_t (&a_big)[16], const uint32_t (&a_small)[16],
                                             uint32_t b_big, uint32_t b_small, uint32_t plane, int s, bool first) {
  const uint64_t db = wgmma_desc(b_big + s * 2 * plane, plane, CORE_BYTES);
  const uint64_t ds = wgmma_desc(b_small + s * 2 * plane, plane, CORE_BYTES);
  if constexpr (N == 128) {
    wgmma_m64n128k8_tf32(acc, a_small + 4 * s, db, !first);
    wgmma_m64n128k8_tf32(acc, a_big + 4 * s, ds, 1);
    wgmma_m64n128k8_tf32(acc, a_big + 4 * s, db, 1);
  } else {
    static_assert(N == 96, "the kernels multiply N = 128 (t.W1) and N = 96 (the conv's three taps)");
    wgmma_m64n96k8_tf32(acc, a_small + 4 * s, db, !first);
    wgmma_m64n96k8_tf32(acc, a_big + 4 * s, ds, 1);
    wgmma_m64n96k8_tf32(acc, a_big + 4 * s, db, 1);
  }
}

}  // namespace fdgan_dev
