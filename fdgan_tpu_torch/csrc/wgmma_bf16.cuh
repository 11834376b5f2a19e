// Hopper's warpgroup matrix multiply (wgmma) for the bf16 kernels of
// dense_layer.cu and probes.cu, and the 3x3 conv stage they share.
//
// The dense layer's t.W1 stage streamed over flat pixel tiles (tw1_stream, the
// body of K2 and of the conv1 probe's "wgmma" mode) is at the end.
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
// the tile at (b, y0, x0), 16 bytes a thread; ldo is the elements from one
// pixel of out to the next (32, or more where out is a channel slice of a
// wider buffer; a multiple of 8). Rows that are no output (the two halo
// columns, rows past the tile, pixels outside the image) are dropped. A
// warpgroup stores what it staged, so only its own barrier lies between the two.
template <int TW>
__device__ __forceinline__ void conv2_flat_store(const unsigned char* os, bf16* __restrict__ out, int ldo, int row0,
                                                 int b, int y0, int x0, int H, int W, int lane_in_wg) {
  typedef FlatTile<TW> T;
#pragma unroll
  for (int v = lane_in_wg; v < 64 * 4; v += WG_THREADS) {
    const int row = row0 + v / 4, part = v % 4;
    const int ty = row / T::HW, tx = row % T::HW;
    const int oy = y0 + ty, ox = x0 + tx;
    if (ty < T::TH && tx < TW && oy < H && ox < W)
      *reinterpret_cast<uint4*>(out + ((size_t)(b * H + oy) * W + ox) * ldo + 8 * part) =
          *reinterpret_cast<const uint4*>(os + row * T::OS_LD + 16 * part);
  }
}

// eight bf16 of x -> round(relu(a*x + b)) as eight bf16; 0 where !ok. Selects,
// no branches: K1 runs it under its conv's products.
__device__ __forceinline__ uint4 affine_relu8(uint4 x, const float (&a)[8], const float (&b)[8], bool ok) {
  auto pair = [](uint32_t xw, float a0, float a1, float b0, float b1) {
    return pack_pair_relu(__uint_as_float(xw << 16) * a0 + b0, __uint_as_float(xw & 0xffff0000u) * a1 + b1);
  };
  uint4 t;
  t.x = ok ? pair(x.x, a[0], a[1], b[0], b[1]) : 0u;
  t.y = ok ? pair(x.y, a[2], a[3], b[2], b[3]) : 0u;
  t.z = ok ? pair(x.z, a[4], a[5], b[4], b[5]) : 0u;
  t.w = ok ? pair(x.w, a[6], a[7], b[6], b[7]) : 0u;
  return t;
}

// a[0..7], b[0..7] = a1[c ..], b1[c ..] as 16-byte loads; 0 where c >= C (t is 0 there anyway)
__device__ __forceinline__ void affine8(const float* a1, const float* b1, int c, int C, float (&a)[8], float (&b)[8]) {
  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 av[2] = {c < C ? *reinterpret_cast<const float4*>(a1 + c) : none,
                        c < C ? *reinterpret_cast<const float4*>(a1 + c + 4) : none};
  const float4 bv[2] = {c < C ? *reinterpret_cast<const float4*>(b1 + c) : none,
                        c < C ? *reinterpret_cast<const float4*>(b1 + c + 4) : none};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[4 * h] = av[h].x, a[4 * h + 1] = av[h].y, a[4 * h + 2] = av[h].z, a[4 * h + 3] = av[h].w;
    b[4 * h] = bv[h].x, b[4 * h + 1] = bv[h].y, b[4 * h + 2] = bv[h].z, b[4 * h + 3] = bv[h].w;
  }
}

// -----------------------------------------------------------------------------
// The t.W1 stage streamed over flat pixel tiles: K2 (h_stats_bf16_kernel,
// dense_layer.cu) and the conv1 probe's "wgmma" body (probes.cu).
//
//     h[p] = round(relu(a1*x[p] + b1)) . W1,    p < npix, h (128 columns) in fp32
//
// It is pointwise in pixels, so a tile is 128 consecutive pixels (no halo),
// and it is bound by the bytes of x: 128 FLOP per byte at every C, against
// the card's ridge of ~295. So the design streams x and keeps everything
// else off its path. One persistent block per SM of two warpgroups, each
// owning 64 rows of a tile, walks the block's tiles (tile = blockIdx.x +
// k * gridDim.x: a static walk, so a launch gives the same bits every time)
// in steps of 64 channels:
// - x arrives by cp.async into a STAGES-deep ring in shared memory,
//   STAGES - 1 steps ahead, each warp copying its own 16 rows: 8 lanes to a
//   row, so that every copy instruction takes four whole 128-byte lines
//   (were each lane to copy the 32 bytes it reads itself, an instruction
//   would take half of each of 32 sectors). No register
//   holds data in flight and no block barrier orders the ring: each lane's
//   cp.async.wait_group and a warp barrier do. (x loaded into registers
//   ahead of t staged in shared memory, with a proxy fence and a block
//   barrier every step, cost a DRAM round trip per step, 2-3 us at every C:
//   the loads in flight were waited for before the products.)
// - t = round(relu(a1*x + b1)) is computed in registers straight into the
//   A fragments of wgmma m64n128k16 with A from registers. Within a 64-channel
//   chunk the channels are taken in a permuted order, so that the fragment
//   elements of lane 4*gq + tq are 16 consecutive channels of its rows:
//   logical k = 16s + kk (k-step s, kk < 16) is channel
//       16 * (kk % 8 / 2) + 4s + 2 * (kk / 8) + kk % 2
//   of the chunk (TW1 order); W1's rows are permuted the same way
//   (ops/dense.py::w1_tw1_planes), so the sum is the same.
// - W1 lies in device memory in that order as planes ([k / 8][n][8]), zero-
//   padded to whole chunks: its first RES chunks arrive by one bulk copy and
//   stay for the block's life; the chunks past them arrive per tile, one
//   ahead, by one bulk copy each into a two-stage ring, which is the only
//   place where the two warpgroups meet (a block barrier on those steps).
//   W1's reads from L2 per tile are then (C - 64 RES) * 256 bytes against
//   x's 256 C.
// - A step's products are started as soon as its t is in registers; the next
//   step's t is computed under them, then they are waited for (in straight
//   code: the compiler serialises products in flight across a branch).
//
// The epilogue is the caller's: epilogue(acc, tile) runs once per tile, after
// its last step's products are done, with acc the warpgroup's 64 x 128 fp32
// fragment (rows 64 wg .., the accumulator layout above). Every thread of the
// block runs it the same number of times, so it may hold block barriers.
//
// Traps: rows past npix get t = 0 (relu(b1) is not 0: a zero x is not
// enough), so their h is 0; with C % 64 = 32 the last chunk's x is zero-
// filled and a1, b1 read as 0 past C, so t is 0 there, and W1's padding rows
// are zeros.
// -----------------------------------------------------------------------------

// Per-phase clock64 stamps of tw1_stream, compiled in by -DFDGAN_TW1_STAMPS
// (python -m fdgan_tpu_torch.tools.stamp_k2); empty otherwise. Lane 0 of
// every warp adds its cycles per phase into tw1_stamps at the block's end:
// [0..6] the phases of a step (W1 ring, products' issue, x wait, t, copies'
// issue, products' wait, epilogue), [7] steps, [8] cycles from start to end,
// [9] warps. One array per source file: the K2 kernel's is dense_layer.cu's.
#ifdef FDGAN_TW1_STAMPS
static __device__ unsigned long long tw1_stamps[16];
#define TW1_STAMP_BEGIN long long tw1_t[7] = {0, 0, 0, 0, 0, 0, 0}, tw1_c = clock64(); const long long tw1_start = tw1_c;
#define TW1_STAMP_RESET { for (int i_ = 0; i_ < 7; ++i_) tw1_t[i_] = 0; tw1_c = clock64(); }
#define TW1_STAMP(i) { const long long c_ = clock64(); tw1_t[i] += c_ - tw1_c; tw1_c = c_; }
#define TW1_STAMP_END(steps)                                                                          \
  if (threadIdx.x % 32 == 0) {                                                                        \
    for (int i_ = 0; i_ < 7; ++i_) atomicAdd(tw1_stamps + i_, (unsigned long long)tw1_t[i_]);          \
    atomicAdd(tw1_stamps + 7, (unsigned long long)(steps));                                           \
    atomicAdd(tw1_stamps + 8, (unsigned long long)(clock64() - tw1_start));                            \
    atomicAdd(tw1_stamps + 9, 1ull);                                                                  \
  }
#else
#define TW1_STAMP_BEGIN
#define TW1_STAMP_RESET
#define TW1_STAMP(i)
#define TW1_STAMP_END(steps)
#endif

// 16 bytes from gmem_src to smem_dst, or 16 zero bytes (nothing is read) where !ok
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)), "l"(gmem_src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// d (64 x 128, fp32) = a (64 x 16, bf16 pairs in registers, the m16n8k16 A
// fragment per warp: {row gq, k 2tq}, {gq + 8, 2tq}, {gq, 2tq + 8}, {gq + 8,
// 2tq + 8}) . b^T (b is 128 x 16, K-major in shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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

// where the 8 channels c .. c + 7 of pixel p lie: base + p * ld
struct XColumn {
  const bf16* base;
  int ld;
};

// x with the C channels at the start of each pixel's ld elements
struct StridedX {
  const bf16* x;
  int ld;
  __device__ __forceinline__ XColumn column(int c) const { return {x + c, ld}; }
};

constexpr int TW1_WGS = 2;
constexpr int TW1_THREADS = WG_THREADS * TW1_WGS;            // 256
constexpr int TW1_ROWS = 64 * TW1_WGS;                       // pixels of a tile
constexpr int TW1_KC = 64;                                   // channels of x per step
constexpr int TW1_MAX_C = 1024;                              // a1, b1 are staged in shared memory up to this C
constexpr uint32_t TW1_W1_PLANE = INTER * 16;                // in the layout of device memory
constexpr uint32_t TW1_W1_CHUNK = (TW1_KC / 8) * TW1_W1_PLANE;  // 16 KB
constexpr uint32_t TW1_X_ROW = 2 * TW1_KC + 16;              // a row of a chunk of x, padded: conflict-free reads
constexpr uint32_t TW1_X_STAGE = (TW1_THREADS / 32) * 16 * TW1_X_ROW;  // [warp][row < 16][TW1_X_ROW]: 18 KB
constexpr int TW1_STAGES = 4;                                 // x is copied 3 steps ahead
static_assert(TW1_ROWS * TW1_KC == TW1_THREADS * 4 * 8, "each thread copies 4 vectors of x per step");

// shared memory of tw1_stream, in bytes from the start
template <int RES>
struct TW1Smem {
  static constexpr uint32_t RING = RES * TW1_W1_CHUNK;        // [2] W1 chunks past the resident ones
  static constexpr uint32_t X = RING + 2 * TW1_W1_CHUNK;      // [STAGES] x
  static constexpr uint32_t AB = X + TW1_STAGES * TW1_X_STAGE;  // a1 | b1
  static constexpr uint32_t BARS = AB + 2 * TW1_MAX_C * 4;    // [3] mbarriers: resident W1, ring stages 0 and 1
  static constexpr uint32_t BYTES = BARS + 3 * 8;             // the caller's own shared memory follows
};

// a step: chunk ci of the tile ``tile``; the walk goes on with the block's next tile
struct TW1Step {
  int tile, ci;
  __device__ __forceinline__ void advance(int nchunks, int stride) {
    const bool wrap = ++ci == nchunks;  // selects: it runs under products
    ci = wrap ? 0 : ci;
    tile += wrap ? stride : 0;
  }
};

template <int RES, typename X, typename Epilogue>
__device__ __forceinline__ void tw1_stream(const X& xs, const float* __restrict__ a1, const float* __restrict__ b1,
                                           const bf16* __restrict__ w1p, int npix, int C, unsigned char* smem,
                                           Epilogue&& epilogue) {
  typedef TW1Smem<RES> S;
  constexpr int STAGES = TW1_STAGES;
  unsigned char* res = smem;
  unsigned char* ring = smem + S::RING;
  float* ab = reinterpret_cast<float*>(smem + S::AB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BARS);

  const int tid = threadIdx.x, wg = tid / WG_THREADS, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = 64 * wg + 16 * (tid % WG_THREADS / 32) + gq;  // the thread's rows: row0 and row0 + 8
  const int ntiles = (npix + TW1_ROWS - 1) / TW1_ROWS;
  const int nchunks = (C + TW1_KC - 1) / TW1_KC;
  const int my_tiles = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nsteps = my_tiles * nchunks;
  if (nsteps == 0) return;
  TW1_STAMP_BEGIN
  const bool ab_staged = C <= TW1_MAX_C;
  const float* a1s = ab_staged ? ab : a1;
  const float* b1s = ab_staged ? ab + TW1_MAX_C : b1;

  if (ab_staged)
    for (int c = tid; c < C; c += TW1_THREADS) {
      ab[c] = a1[c];
      ab[TW1_MAX_C + c] = b1[c];
    }
  if (tid == 0)
    for (int i = 0; i < 3; ++i) mbarrier_init(bars + i, 1);

  // chunk ci of W1 into a ring stage, by one thread: one bulk copy of 16 KB
  auto w1_ring_copy = [&](int ci, int stage) {
    mbarrier_arrive_expect_tx(bars + 1 + stage, TW1_W1_CHUNK);
    bulk_copy_g2s(ring + stage * TW1_W1_CHUNK, w1p + (size_t)ci * (TW1_W1_CHUNK / 2), TW1_W1_CHUNK, bars + 1 + stage);
  };

  // x of a step into stage k % STAGES: the warp's 16 rows, lane l copying channels 8 (l % 8) ..
  // of rows l / 8 + 4j; zeros past npix and past C; one cp.async group per step
  TW1Step fe{(int)blockIdx.x, 0};  // the next step whose x is copied
  int fe_k = 0;
  const int wrow0 = 64 * wg + 16 * (tid % WG_THREADS / 32);  // the warp's first row
  unsigned char* xbytes = smem + S::X + (tid / 32) * 16 * TW1_X_ROW;
  auto fetch = [&]() {
    unsigned char* dst = xbytes + (fe_k % STAGES) * TW1_X_STAGE;
    const int part = lane % 8;
    const int c = fe.ci * TW1_KC + 8 * part;
    const XColumn col = xs.column(c < C ? c : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * j + lane / 8;
      const int p = fe.tile * TW1_ROWS + wrow0 + r;
      const bool ok = c < C && p < npix;
      cp_async16_zfill(dst + r * TW1_X_ROW + 16 * part, ok ? col.base + (size_t)p * col.ld : col.base, ok);
    }
    cp_async_commit();
    fe.advance(nchunks, gridDim.x);
    ++fe_k;
  };
  // t of the next step, from its stage of x, into A fragments: a[4s ..] for k-step s
  TW1Step st{(int)blockIdx.x, 0};
  int st_k = 0;
  auto make_t = [&](uint32_t (&frag)[16]) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the step have landed
    __syncwarp();                 // ... and the warp's
    TW1_STAMP(2)
    const unsigned char* src = xbytes + (st_k % STAGES) * TW1_X_STAGE;
    const int c = st.ci * TW1_KC + 16 * tq;
    bool ok[2];  // rows past npix: t = 0, not relu(b1)
#pragma unroll
    for (int h = 0; h < 2; ++h) ok[h] = st.tile * TW1_ROWS + row0 + 8 * h < npix;
#pragma unroll
    for (int g = 0; g < 2; ++g) {  // channels c + 8g .. c + 8g + 7
      float av[8], bv[8];
      affine8(a1s, b1s, c + 8 * g, C, av, bv);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 xv = *reinterpret_cast<const uint4*>(src + (gq + 8 * h) * TW1_X_ROW + 16 * (2 * tq + g));
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // channel pair q = 4g + i: k-step q / 2, k 2tq (+ 8 for odd q)
          const uint32_t t = pack_pair_relu(__uint_as_float(xw[i] << 16) * av[2 * i] + bv[2 * i],
                                            __uint_as_float(xw[i] & 0xffff0000u) * av[2 * i + 1] + bv[2 * i + 1]);
          frag[4 * (2 * g + i / 2) + 2 * (i % 2) + h] = ok[h] ? t : 0u;
        }
      }
    }
    __syncwarp();  // every lane has read the stage before a lane refills it
    st.advance(nchunks, gridDim.x);
    ++st_k;
  };

  for (int i = 0; i < STAGES - 1; ++i) fetch();
  __syncthreads();  // a1, b1 are staged, the barriers are set up
  if (tid == 0) {
    const int nres = min(nchunks, RES);
    mbarrier_arrive_expect_tx(bars, nres * TW1_W1_CHUNK);
    bulk_copy_g2s(res, w1p, nres * TW1_W1_CHUNK, bars);
    if (nchunks > RES) w1_ring_copy(RES, 0);
  }
  mbarrier_wait(bars, 0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a0[16], a1r[16];
  TW1Step pc{(int)blockIdx.x, 0};  // the step whose products run
  int ring_k = 0;                  // ring chunks used so far: the next one is in stage ring_k & 1
  auto step = [&](const uint32_t (&a)[16], uint32_t (&a_next)[16]) {
    TW1_STAMP(6)
    const bool in_ring = pc.ci >= RES;
    if (in_ring) {
      mbarrier_wait(bars + 1 + (ring_k & 1), (ring_k >> 1) & 1);  // this chunk of W1 has landed
      __syncthreads();  // both warpgroups are past the products that read the other stage
      if (tid == 0 && !(pc.ci + 1 == nchunks && pc.tile + (int)gridDim.x >= ntiles))
        w1_ring_copy(pc.ci + 1 < nchunks ? pc.ci + 1 : RES, (ring_k + 1) & 1);
    }
    TW1_STAMP(0)
    const unsigned char* w1c = in_ring ? ring + (ring_k & 1) * TW1_W1_CHUNK : res + pc.ci * TW1_W1_CHUNK;
    const uint64_t db = wgmma_desc(smem_u32(w1c), TW1_W1_PLANE, CORE_BYTES);
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TW1_KC / 16; ++ks)
      wgmma_m64n128k16_rs(acc, *reinterpret_cast<const uint32_t(*)[4]>(a + 4 * ks),
                          desc_advance(db, ks * 2 * TW1_W1_PLANE), (pc.ci | ks) != 0);
    wgmma_commit();
    ring_k += in_ring;
    TW1_STAMP(1)
    make_t(a_next);  // under the products: the next step's t, then x for a later step sets out
    TW1_STAMP(3)
    fetch();
    TW1_STAMP(4)
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    TW1_STAMP(5)
    if (pc.ci == nchunks - 1) epilogue(acc, pc.tile);
    pc.advance(nchunks, gridDim.x);
  };

  make_t(a0);
  fetch();
  TW1_STAMP_RESET  // the prologue is not a phase of a step
  for (int s = 0; s < nsteps; s += 2) {
    step(a0, a1r);
    if (s + 1 < nsteps) step(a1r, a0);
  }
  TW1_STAMP(6)
  cp_async_wait<0>();  // the copies past the last step (zeros) land before the block ends
  TW1_STAMP_END(nsteps)
}

}  // namespace fdgan_dev
