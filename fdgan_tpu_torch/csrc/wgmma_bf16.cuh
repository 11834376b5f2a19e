// Hopper's warpgroup matrix multiply (wgmma) for the bf16 kernels of
// dense_layer.cu and probes.cu, and the 3x3 conv stage they share.
//
// wgmma.mma_async multiplies a 64-row tile: four warps (a warpgroup) start it
// together, the tensor core reads both operands from shared memory by itself
// (no fragment loads in the instruction stream, each operand read once per 64
// rows) and adds into fp32 registers, asynchronously. It is the only way to
// the card's full tensor-core rate.
//
// Operand layout. Both operands are K-major (A is [row][k], B is [n][k]) in
// the layout without swizzle: a core matrix is 8 rows of 8 bf16 (16 bytes a
// row, 128 contiguous bytes), and a 64 x 16 operand tile of one instruction is
// 8 x 2 of them. A 64-bit descriptor names the tile: its start address, the
// byte step between the two core matrices along k (LBO, "leading byte
// offset") and between core matrices along the rows (SBO, "stride byte
// offset"); cute/arch/mma_sm90_desc.hpp of CUTLASS is the reference for what
// the two mean in each layout. The kernels here store an operand as planes of
// eight k values,
//     [k / 8][row][8 bf16],
// so SBO is 128 bytes and LBO is one plane. That has two uses. A plane may be
// padded: with a plane of 16 bytes more than a multiple of 128, the eight
// 16-byte vectors of one row (what a thread group holds after a coalesced
// load of that row) fall in distinct banks. And the start address may be any
// multiple of 16 bytes, that is any row: a tile that starts r rows further on
// is the same descriptor plus r. A swizzled layout would tie the start
// address to the swizzle's 1024-byte atom (or need the descriptor's
// base-offset field), so the 3x3 conv below, whose taps are row
// offsets into one tile, takes the unswizzled layout. A core matrix is still
// read as 128 contiguous bytes.
//
// Ordering. wgmma reads shared memory through the asynchronous proxy: what
// ordinary stores or cp.async wrote has to be followed by fence_proxy_async()
// and a barrier among writers and readers before the wgmma that reads it.
// wgmma_fence() comes before the first wgmma of a group, wgmma_commit() ends
// the group, wgmma_wait<N>() returns when at most N groups are still running;
// until then neither the accumulators nor the operands may be touched, which
// wgmma_fence_acc() tells the compiler about the accumulators.
//
// Accumulators of m64nN: N / 2 floats a thread. Warp w of the warpgroup holds
// rows 16w .. 16w+15; lane 4*gq + tq holds, for j < N / 8, d[4j], d[4j+1] =
// (row gq, columns 8j + 2tq, + 1) and d[4j+2], d[4j+3] = (row gq + 8, the same
// columns): the m16n8 pattern of mma.sync, once per 8 columns.

#pragma once

#include "mma_bf16.cuh"

namespace fdgan_dev {

constexpr int WG_THREADS = 128;  // a warpgroup
constexpr uint32_t CORE_BYTES = 128;  // a core matrix: 8 rows of 16 bytes

// the descriptor of an unswizzled K-major tile; all three in bytes, multiples of 16
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// the same tile ``bytes`` further on (a multiple of 16; the address field does not overflow
// within the 227 KB a block can address)
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving a use of the accumulators across this point
template <int N>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Four 8 x 8 blocks of bf16 from a warp's registers to shared memory: lane
// 4*gq + tq holds, in v[m], columns 2tq, 2tq + 1 of row gq of block m (an
// accumulator fragment rounded to pairs), and lane l gives the address of row
// l % 8 of block l / 8, 16 bytes a row.
__device__ __forceinline__ void stmatrix_x4(uint32_t row_addr, const uint32_t (&v)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(row_addr), "r"(v[0]),
               "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// barrier among the 128 threads of warpgroup ``wg`` (hardware barrier wg + 1; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

// d (64 x 32, fp32) = a (64 x 16) . b^T (b is 32 x 16) + (scale_d ? d : 0), both
// operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 96, fp32) = a (64 x 16) . b^T (b is 96 x 16) + (scale_d ? d : 0), both
// operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, fp32) = a (64 x 16) . b^T (b is 128 x 16) + (scale_d ? d : 0), both
// operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// -----------------------------------------------------------------------------
// The 3x3 conv 128 -> 32 of an 8 x TW output tile as wgmma products: the conv2
// probe's "wgmma" body (probes.cu) and the second stage of the dense layer
// (dense_layer.cu).
//
// The tap shift is an address. g of the halo tile, (8 + 2) x (TW + 2) pixels,
// lies in shared memory pixel-major by its flat halo index p = y * HW + x,
// HW = TW + 2, as [k / 8][p][8 bf16]. The output at p (its top-left corner in
// the halo) needs, for tap (dy, dx), row p + dy * HW + dx: one row offset for
// a whole 64-row tile, so a tap is the A descriptor moved by that many rows
// (no gather). The M rows run over flat indices, so the two halo columns at
// the end of every tile row are computed and dropped (SPAN flat indices hold
// the 8 * TW outputs; M2 tiles of 64 rows cover them), and the last tile's
// rows past SPAN read whatever follows the halo in the buffer: a row's
// garbage reaches only that row's result, which is dropped too. The buffer
// has G_ROWS rows so that every read stays inside it.
//
// The three taps of a kernel row lie side by side in N. As nine products of
// N = 32 the conv is held by shared memory: m64n32k16 reads 3 KB for 65,536
// FLOP and runs at ~500 TFLOP/s on an H100, m64n96k16 reads 5 KB for three
// times the work and g once for three taps, ~840 TFLOP/s
// (tools/probes.py::wgmma_rates). So W2 lies as
// [dy][k / 8][dx * 32 + n][8 bf16] (72 KB, staged once per block from w2r
// (9, 32, 128)), a warpgroup starts 3 x 8 products m64n96k16, and its
// accumulators hold, at row p and columns 32 dx .., tap dx's share of the
// output at p - dx; conv2_flat_share and conv2_flat_combine bring the three
// shares of an output together, by shuffles within a warp and through a few
// rows of shared memory between warps.
// -----------------------------------------------------------------------------

// A persistent block's walk over the tiles (tx, ty, b) of a batch of images:
// its tiles are ``step`` apart in the flat order, and a tile's place comes from
// the last one's by adding the step's place and carrying. The divisions are
// done once: per tile their dependent chains cost ~900 clocks.
struct TileWalk {
  int tiles_x, tiles_y, step_x, step_y, step_b, tx, ty, b;
  __device__ TileWalk(int first, int step, int tiles_x_, int tiles_y_)
      : tiles_x(tiles_x_), tiles_y(tiles_y_),
        step_x(step % tiles_x_), step_y(step / tiles_x_ % tiles_y_), step_b(step / (tiles_x_ * tiles_y_)),
        tx(first % tiles_x_), ty(first / tiles_x_ % tiles_y_), b(first / (tiles_x_ * tiles_y_)) {}
  __device__ void advance() {
    tx += step_x;
    const int cx = tx >= tiles_x;
    tx -= cx ? tiles_x : 0;
    ty += step_y + cx;
    const int cy = ty >= tiles_y;
    ty -= cy ? tiles_y : 0;
    b += step_b + cy;
  }
};

template <int TW_>
struct FlatTile {
  static constexpr int TH = 8, TW = TW_;
  static constexpr int HW = TW + 2;                  // halo width
  static constexpr int HPIX = (TH + 2) * HW;         // halo pixels
  static constexpr int M1 = (HPIX + 63) / 64;        // 64-row tiles that cover the halo (the t.W1 product's rows)
  static constexpr int SPAN = (TH - 1) * HW + TW;    // flat indices from the first output to the last
  static constexpr int M2 = (SPAN + 63) / 64;        // 64-row tiles of the conv
  static constexpr int READ_ROWS = 64 * M2 + 2 * HW;  // rows the conv reads
  static constexpr int MIN_ROWS = READ_ROWS > 64 * M1 ? READ_ROWS : 64 * M1;
  static constexpr int G_ROWS = (MIN_ROWS + 7) / 8 * 8 + 1;  // a plane is 16 bytes past a multiple of 128
  static constexpr uint32_t G_PLANE = G_ROWS * 16;   // bytes of one plane of 8 channels
  static constexpr uint32_t G_BYTES = (INTER / 8) * G_PLANE;
  static constexpr int OS_LD = 2 * GROWTH + 16;      // bytes of a staged output row (32 bf16, padded: conflict-free)
  static constexpr uint32_t OS_BYTES = 64 * M2 * OS_LD;
};

constexpr uint32_t W2_PLANE = 3 * GROWTH * 16;            // [dx * 32 + n][8 bf16]
constexpr uint32_t W2_DY = (INTER / 8) * W2_PLANE;        // 24 KB a kernel row
constexpr uint32_t W2_BYTES = 3 * W2_DY;                  // 72 KB

// w2r (9, 32, 128) -> w2s in the layout above, by cp.async; the caller commits and waits

__device__ __forceinline__ void stage_w2(unsigned char* w2s, const bf16* __restrict__ w2r, int tid, int nthreads) {
  for (int v = tid; v < 9 * GROWTH * (INTER / 8); v += nthreads) {
    const int oct = v % (INTER / 8), n = v / (INTER / 8) % GROWTH, tap = v / (INTER / 8) / GROWTH;
    cp_async16(w2s + (tap / 3) * W2_DY + oct * W2_PLANE + ((tap % 3) * GROWTH + n) * 16, w2r + (size_t)v * 8);
  }
}

// acc (64 x 96) = the three taps' shares at flat indices row0 .. row0 + 63: 24
// products started back to back. g_addr and w2_addr are shared-memory addresses
// of the g buffer and of W2. The caller has fenced (wgmma_fence) and commits.
template <int TW>
__device__ __forceinline__ void conv2_flat_mma(float (&acc)[48], uint32_t g_addr, int row0, uint32_t w2_addr) {
  typedef FlatTile<TW> T;
  const uint64_t da = wgmma_desc(g_addr + row0 * 16, T::G_PLANE, CORE_BYTES);
  const uint64_t db = wgmma_desc(w2_addr, W2_PLANE, CORE_BYTES);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int ks = 0; ks < INTER / 16; ++ks)
      wgmma_m64n96k16(acc, desc_advance(da, dy * T::HW * 16 + ks * 2 * T::G_PLANE),
                      desc_advance(db, dy * W2_DY + ks * 2 * W2_PLANE), (dy | ks) != 0);
  }
}

// The output at row p is acc[dx = 0] at p + acc[dx = 1] at p + 1 + acc[dx = 2]
// at p + 2. A lane holds rows gq and gq + 8 of its warp's 16; the rows after
// them are held by lanes 4 or 8 further on (shuffles), except that rows 16 and
// 17 are the next warp's rows 0 and 1, which every warp leaves in xch
// ([warp of the block + 1][3][32] floats: row 0 of dx = 1, rows 0 and 1 of
// dx = 2) between share and combine, with a barrier of the block between the
// two. The entry after the last warp's is never written: the last rows' shares
// from beyond the tile reach only rows that are no output.
constexpr int XCH_WARP = 3 * GROWTH;

__device__ __forceinline__ void conv2_flat_share(float* xch, const float (&acc)[48], int warp_of_block, int lane) {
  const int gq = lane / 4, tq = lane % 4;
  float* mine = xch + warp_of_block * XCH_WARP + 2 * tq;
  if (gq < 2) {
#pragma unroll
    for (int j = 0; j < GROWTH / 8; ++j) {
      if (gq == 0) *reinterpret_cast<float2*>(mine + 8 * j) = make_float2(acc[16 + 4 * j], acc[16 + 4 * j + 1]);
      *reinterpret_cast<float2*>(mine + (1 + gq) * GROWTH + 8 * j) = make_float2(acc[32 + 4 * j], acc[32 + 4 * j + 1]);
    }
  }
}

__device__ __forceinline__ void conv2_flat_combine(float (&out)[16], const float (&acc)[48], const float* xch,
                                                   int warp_of_block, int lane) {
  const int gq = lane / 4, tq = lane % 4;
  const float* next = xch + (warp_of_block + 1) * XCH_WARP + 2 * tq;
  const int l1 = (lane + 4) & 31, l2 = (lane + 8) & 31;  // the lanes that hold rows + 1 and + 2, wrapping to rows 8, 9
#pragma unroll
  for (int j = 0; j < GROWTH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s1a = __shfl_sync(0xffffffffu, acc[16 + 4 * j + e], l1), s1b = __shfl_sync(0xffffffffu, acc[16 + 4 * j + 2 + e], l1);
      const float s2a = __shfl_sync(0xffffffffu, acc[32 + 4 * j + e], l2), s2b = __shfl_sync(0xffffffffu, acc[32 + 4 * j + 2 + e], l2);
      const float n1 = gq < 7 ? s1b : next[8 * j + e];                        // row gq + 9, or the next warp's row 0
      const float n2 = gq < 6 ? s2b : next[(gq - 5) * GROWTH + 8 * j + e];    // row gq + 10, or its row 0 or 1 (gq 6, 7)
      out[4 * j + e] = acc[4 * j + e] + (gq < 7 ? s1a : s1b) + (gq < 6 ? s2a : s2b);
      out[4 * j + 2 + e] = acc[4 * j + 2 + e] + n1 + n2;
    }
}

// the warpgroup's accumulators -> staged output rows (os: [flat index][32 bf16], OS_LD bytes a row)
template <int TW>
__device__ __forceinline__ void conv2_flat_stage(unsigned char* os, const float (&acc)[16], int row0, int lane_in_wg) {
  typedef FlatTile<TW> T;
  // blocks (channels 8j .., rows +0), (8j, +8), (8j + 8, +0), (8j + 8, +8) per store
  const int warp = lane_in_wg / 32, lane = lane_in_wg % 32;
  const uint32_t orow = smem_u32(os) + (row0 + 16 * warp + lane % 16) * T::OS_LD + (lane / 16) * 16;
#pragma unroll
  for (int j = 0; j < GROWTH / 8; j += 2) {
    const uint32_t v[4] = {pack_pair(acc[4 * j], acc[4 * j + 1]), pack_pair(acc[4 * j + 2], acc[4 * j + 3]),
                           pack_pair(acc[4 * j + 4], acc[4 * j + 5]), pack_pair(acc[4 * j + 6], acc[4 * j + 7])};
    stmatrix_x4(orow + j * 16, v);
  }
}

// the warpgroup's 64 staged rows (flat indices row0 ..) -> out (B, H, W, 32) for
// the tile at (b, y0, x0), 16 bytes a thread; rows that are no output (the two
// halo columns, rows past the tile, pixels outside the image) are dropped. A
// warpgroup stores what it staged, so only its own barrier lies between the two.
template <int TW>
__device__ __forceinline__ void conv2_flat_store(const unsigned char* os, bf16* __restrict__ out, int row0, int b, int y0,
                                                 int x0, int H, int W, int lane_in_wg) {
  typedef FlatTile<TW> T;
#pragma unroll
  for (int v = lane_in_wg; v < 64 * 4; v += WG_THREADS) {
    const int row = row0 + v / 4, part = v % 4;
    const int ty = row / T::HW, tx = row % T::HW;
    const int oy = y0 + ty, ox = x0 + tx;
    if (ty < T::TH && tx < TW && oy < H && ox < W)
      *reinterpret_cast<uint4*>(out + ((size_t)(b * H + oy) * W + ox) * GROWTH + 8 * part) =
          *reinterpret_cast<const uint4*>(os + row * T::OS_LD + 16 * part);
  }
}

}  // namespace fdgan_dev
