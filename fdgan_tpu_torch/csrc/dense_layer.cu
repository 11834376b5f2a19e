// Hand-written Hopper kernels for the FDGAN encoder's DenseNet layer.
//
// K1  fdgan_dense_layer_{f32,bf16}
//     Replaces fdgan_tpu/ops/pallas_dense.py::_fused_layer_pallas (kernel
//     body _layer_kernel). One DenseNet-121 layer, fused:
//         t = relu(a1*x + b1)             rounded to x's dtype
//         h = t . W1                      1x1 conv C -> 128, fp32 accumulation
//         g = relu(a2*h + b2)             rounded to x's dtype; 0 outside the image,
//                                         or from a neighbour's row of x (halo_pixel)
//         f = sum over 9 taps of shift(g) . W2[tap]   3x3 conv 128 -> 32, fp32 acc.
//     h and g never leave the SM.
//
// K2  fdgan_h_stats_{f32,bf16}
//     Replaces pallas_dense.py::_h_stats_pallas (kernel body _phase_a_kernel):
//     per-block partial sums of h and h*h over the block's pixels, for
//     norm2's batch statistics. No atomics: every block writes its own row of
//     a (blocks, 128) buffer and the wrapper reduces the rows in float64, so
//     the result does not depend on block scheduling. K1 consumes the
//     statistics K2 produces, so K2 must finish over the whole batch before
//     K1 starts; it cannot ride K1's epilogue.
//
// The concat. A dense block's layers read a growing concat of channels; the
// kernels take x with a pixel stride ldx >= C (the elements from one pixel to
// the next) and K1 writes its 32 channels with a pixel stride ldo, so that a
// block's layers read and write channel slices of one buffer and no layer
// copies the concat (ops/dense.py::dense_block_fused). A pixel's 64-channel
// chunk stays 128 contiguous bytes, so the reads stay whole lines.
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W; data-sheet peaks:
// 989 TFLOP/s bf16 and 495 tf32 in the tensor cores, 67 fp32 on the CUDA
// cores, 3.35 TB/s): K1 does 2*C*128 + 2*9*128*32 FLOP per output pixel
// against C+32 values read and written; K2 does 2*C*128 against C.
// - bf16: K1 ~470 FLOP per byte at C = 64 (dense block 1), above the card's
//   ridge of ~295: tensor-core bound; at C = 256..992 (block 3) 240..160
//   FLOP/B, memory-bound. K2 128 FLOP/B at every C: bound by reading x.
// - fp32 in full precision (the demo's default, the training CLI's eval, the
//   fp32 train step and the zoo's fp32 forwards): K1 does 235 (C = 64) to 80
//   (C = 992) FLOP per byte, K2 64; 3xTF32 takes each product three times in
//   tf32, and at 495 TFLOP/s against 3.35 TB/s (a ridge of ~148 for the
//   tripled count) both are bound by the tensor cores' tf32 rate at every C
//   of the encoder. Summed over the demo's 42 layers at 1024^2 the 3xTF32
//   bounds are ~9.3 ms (K1) and ~4.4 ms (K2); on the CUDA cores 23.0 and 10.9.
// The design keeps h and g on chip (the Pallas kernel's point), reads x once
// per tile plus a one-pixel halo ring (192 rows of t.W1 for 128 outputs),
// and writes only the 32 new channels.
// - bf16 K1 (dense_layer_bf16_kernel): both products are wgmma, Hopper's
//   warpgroup products, whose operands the tensor core reads from shared
//   memory itself (wgmma_bf16.cuh). Its mma.sync predecessor was held at
//   9-14 % of the bound by what surrounds the products: every warp loaded its
//   own A and B fragments from shared memory, W1 and W2 were restaged per 128
//   outputs with block barriers per chunk and per tap. The wgmma kernel is
//   persistent (W2 staged once per block, all nine taps resident), takes the
//   3x3 conv as 24 products of N = 96 per 64 rows with the tap shift as an
//   address, brings W1 in by bulk copies that no thread's load queue sees,
//   and has one block barrier per 64-channel step. On an H100 80GB HBM3 at
//   700 W it took 0.4-0.7 of the mma.sync body's time on the device at the
//   encoder's shapes (PERF.md has the table) and reaches 30 % of the bound at
//   8x512x512x64. What holds it now, from clock64 stamps per phase: the
//   products need ~45 % of a tile's time at C = 64 and ~30 % of a step's at
//   large C. The rest is the warps' own work (affine, ReLU and rounding of t,
//   the epilogue of g, the conv's shift-add), which all twelve warps do at
//   the same time, and x arriving as 16-byte loads per thread; a step's
//   products, started before that work, are not done until well after it, so
//   the work also slows them (every instruction taken out of stage_t showed
//   in the kernel's time).
// - bf16 K2 (h_stats_bf16_kernel): the t.W1 stage of wgmma_bf16.cuh
//   (tw1_stream: persistent blocks of two warpgroups over 128-pixel tiles, x
//   by cp.async three steps ahead, t computed straight into the A fragments
//   of register-A wgmma, W1 resident up to C = 384 and by a ring of bulk
//   copies past that), and an epilogue that never leaves registers per tile:
//   each thread adds its fragment's two rows into running fp32 sums of its
//   32 columns; every 16 tiles, and at the end, a butterfly over the 8 lanes
//   that share columns and a pass through shared memory bring them into one
//   float64 total per column and block (HStatsSums). One row of partials per
//   block. Its mma.sync body (h_stats_bf16_mma_kernel: 192-pixel blocks, W1
//   restaged from L2 in 32-channel chunks with block barriers, fragments
//   loaded by every warp, one row of partials per 192 pixels) is kept to
//   time old against new; no model path reaches it.
// - fp32 K1 and K2 (dense_layer_tf32x3_kernel, h_stats_tf32x3_kernel): the
//   same two designs on tf32 wgmma with the 3xTF32 split (wgmma_tf32.cuh),
//   which keeps fp32's precision (plain tf32 would not: the fp32 path must
//   match the JAX package's "highest" matmul precision). Where fp32 differs
//   from bf16: operands are split in
//   registers as they are made (t) or loaded (g), since tf32 wgmma takes no
//   transposed operand and g in big and small copies would not fit beside
//   W2; W2 in big and small planes (288 KB) cannot be resident, so W1's and
//   W2's chunks stream through one ring of bulk copies; steps are 32
//   channels (a 128-byte row of x). The tile, by measurement (NVIDIA H100
//   80GB HBM3, 700 W; tools/compare_trees.py at the demo's four layer
//   shapes): the fp32 K1 takes ~19 us a tile plus ~0.08 us per input
//   channel; the halo's 64 extra rows of t.W1 are a third of the per-channel
//   part, ~7 % of a tile's time at C = 64 and ~27 % at C = 992. A tile with
//   fewer halo rows per output needs more g than a block holds beside the
//   rings: 16 x 16 keeps the 1.5x (324 halo pixels, 384 rows for 256
//   outputs), 16 x 32 (1.25x) needs 640 rows of g, 320 KB. So the 8 x 16
//   tile of the bf16 K1 (FlatTile) stays. Alone, a 3xTF32 k-step runs at
//   ~162 TFLOP/s of fp32 products on that card (tools/probes.py::
//   tf32x3_rates, 98 % of the tf32 peak, one warpgroup per SM enough); the
//   two kernels reach 40-60 % of that. Details at each kernel.
//
// Tiles: an 8x16 output tile (K1, walked by persistent 384-thread blocks),
// 128 flat pixels walked by persistent 256-thread blocks (K2; 192 flat pixels
// per 256-thread block in the mma.sync K2); the ragged last chunk of C is
// zero-filled.

#include "wgmma_tf32.cuh"

namespace {

using namespace fdgan_dev;  // bf16, INTER, GROWTH, THREADS, KC, the mma.sync and wgmma helpers

constexpr int NPIX = 192;    // pixels per block of the mma.sync K2 body

// --- K2 bf16, the mma.sync body ------------------------------------------------
//
// Kept to time old against new in one run; no model path reaches it. Warp w
// of 8, lane = 4*gq + tq: the t.W1 product (192 x 128, K = C) is
// gemm1_bf16<3> of mma_bf16.cuh, warp w owning rows 48*(w%4) .. +48 (three
// m16 tiles) and columns 64*(w/4) .. +64 (eight n8 tiles). x and W1 are
// staged in 16-byte vectors, the next chunk loaded into registers while the
// tensor cores work on the current one; shared rows are padded by 8 bf16 so
// that the eight rows a fragment load touches fall in distinct banks. W1
// arrives as w1t (128, C), W1 transposed. C must be a multiple of 8.

constexpr int BF_TS = NPIX * TB_LD;
constexpr int BF_W1S = INTER * TB_LD;
constexpr size_t BF_K2_SMEM = 2 * (BF_TS + BF_W1S) + 4 * NPIX;
static_assert(2 * 4 * INTER * 2 <= BF_TS, "K2's reduction (fp32) must fit in the t staging area");
static_assert(NPIX == 3 * 64 && NPIX * (KC / 8) == 3 * THREADS && INTER * (KC / 8) == 2 * THREADS,
              "each thread stages 3 x vectors and 2 W1 vectors");

// Grid (ceil(npix/192)).
__global__ void __launch_bounds__(THREADS, 2)
h_stats_bf16_mma_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ a1,
                    const float* __restrict__ b1, const bf16* __restrict__ w1t,
                    float* __restrict__ psum, float* __restrict__ psq, int npix, int C) {
  extern __shared__ float smem[];
  bf16* ts = reinterpret_cast<bf16*>(smem);
  bf16* w1s = ts + BF_TS;
  int* pix = reinterpret_cast<int*>(w1s + BF_W1S);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * NPIX;
  for (int row = tid; row < NPIX; row += THREADS) pix[row] = p0 + row < npix ? p0 + row : -1;

  float acc[3][8][4];
  gemm1_bf16<3>([=](int gp, int c) { return x + (size_t)gp * ldx + c; }, a1, b1, w1t, C, pix, ts,
                w1s, acc);

  // rows past the end hold h = 0. Sum the thread's 6 rows, then the 8 lanes
  // of a column (shuffles over gq), then the 4 row-warps in a fixed order.
  float* red = reinterpret_cast<float*>(ts);  // [2][4][INTER]; ts is consumed
  const int wm = warp % 4, n0 = 64 * (warp / 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[mi][j][2 * half + e];
          s += v;
          q = fmaf(v, v, q);
        }
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (gq == 0) {
        const int col = n0 + 8 * j + 2 * tq + e;
        red[wm * INTER + col] = s;
        red[(4 + wm) * INTER + col] = q;
      }
    }
  __syncthreads();
  if (tid < INTER) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < 4; ++r) {
      s += red[r * INTER + tid];
      q += red[(4 + r) * INTER + tid];
    }
    psum[(size_t)blockIdx.x * INTER + tid] = s;
    psq[(size_t)blockIdx.x * INTER + tid] = q;
  }
}


// --- K1 bf16 on wgmma ----------------------------------------------------------
//
// One persistent block of three warpgroups (384 threads) per SM walks the
// 8 x 16 output tiles (TileWalk). Per tile:
//   1. t.W1 for the 180 halo pixels (192 rows: warpgroup w owns rows 64w ..
//      64w+63) as wgmma m64n128k16, 64 channels of x per step. A thread
//      loads 16-byte vectors of x, applies the affine and ReLU in registers
//      and stores t into a two-stage ring in the descriptor layout. The W1
//      chunk arrives in the ring by one bulk copy from w1p, which has that
//      layout in device memory, and is read by the tensor core, not by every
//      warp; with C <= 128 the ring holds all of W1 and it is copied once per
//      block. x is loaded two chunks ahead into registers, W1 one chunk
//      ahead, and a step's products run while the next step's t is computed:
//      one block barrier per step.
//   2. g = round(relu(a2*h + b2)), 0 outside the image, from the accumulators
//      straight into the flat-index buffer of wgmma_bf16.cuh, while the next
//      tile's first x is already on its way.
//   3. the 3x3 conv as 24 wgmma m64n96k16 per warpgroup on g and the resident
//      W2 (conv2_flat_mma), the next tile's first t staged under them; then
//      the three taps' shares of each output are brought together
//      (conv2_flat_share, a block barrier, conv2_flat_combine).
//   4. the 32 channels leave through shared memory in 16-byte vectors, each
//      warpgroup storing the rows it staged.
// Three block barriers per tile plus one per step keep the stages in order; a
// stage of the ring is rewritten only after every warpgroup waited for the
// products that read it (wgmma_wait<0> before the barrier that precedes the
// write). Every wait for products stands in straight code right after they
// are started or at a step's barrier: with products in flight across a loop or
// a branch the compiler serialises them all (ptxas C7518), which a version
// with mbarrier rings and the conv left running under the next tile's steps
// ran into, 30 % slower than this one. a1, b1, a2, b2 are staged once.
// Shared memory: W2 72 KB, g 58 KB, the ring 80 KB, the affines 9 KB, the
// conv's hand-over rows 5 KB: 224 KB of the 227 a block may have.

// The halo ring of a tile and the image's top and bottom rows. Under spatial
// sharding (dist/halo_exchange.py) an image's H rows are split over ranks, and
// the row above a shard's first (below its last) is a neighbour's: there g is
// computed like at any pixel of the image, from that row of x, not set to 0.
// Those rows lie in x's own buffer, after its B*H*W pixels: ``top`` (``bot``)
// is the pixel index, from x, of image 0's row above (below), image b's at
// + b*W, with x's pixel stride; -1 where the image ends (g = 0, the conv's
// zero padding). Returns the pixel index from x of (b, iy, ix) for iy in
// -1 .. H, or -1 where g is 0.
__device__ __forceinline__ int halo_pixel(int b, int iy, int ix, int H, int W, int top, int bot) {
  if (ix < 0 || ix >= W) return -1;
  if (iy >= 0 && iy < H) return (b * H + iy) * W + ix;
  const int row = iy < 0 ? top : bot;  // iy is -1 or H: a tile's ring reaches one row out
  return row >= 0 ? row + b * W + ix : -1;
}

constexpr int K1_TW = 16;
typedef FlatTile<K1_TW> K1T;
constexpr int K1_WGS = K1T::M1;                      // 3 warpgroups
constexpr int K1_THREADS = WG_THREADS * K1_WGS;      // 384
constexpr int K1_ROWS = 64 * K1_WGS;                 // 192 rows of t and h
constexpr int K1_KC = 64;                            // channels of x per step
constexpr int K1_MAX_C = 1024;                       // a1, b1 are staged in shared memory up to this C
constexpr uint32_t K1_T_PLANE = (K1_ROWS + 1) * 16;  // planes padded by 16 bytes: conflict-free stores
constexpr uint32_t K1_W1_PLANE = INTER * 16;         // W1 arrives by bulk copy, in the layout of device memory
constexpr uint32_t K1_T_BYTES = (K1_KC / 8) * K1_T_PLANE;
constexpr uint32_t K1_STAGE = K1_T_BYTES + (K1_KC / 8) * K1_W1_PLANE;
constexpr uint32_t K1_AB_BYTES = (2 * K1_MAX_C + 2 * INTER) * 4;
constexpr uint32_t K1_XCH_BYTES = (K1_THREADS / 32 + 1) * XCH_WARP * 4;
constexpr size_t K1_SMEM = W2_BYTES + K1T::G_BYTES + 2 * (size_t)K1_STAGE + K1_AB_BYTES + K1_XCH_BYTES + 2 * sizeof(uint64_t);
static_assert(K1T::M2 == K1_WGS, "a warpgroup per 64-row tile of the conv, and the conv's barrier is the block's");
static_assert(K1T::OS_BYTES <= K1_T_BYTES, "the staged outputs take the place of a t stage");
static_assert(K1_SMEM <= 232448, "a block's shared memory");
static_assert(K1_ROWS * (K1_KC / 8) == 4 * K1_THREADS, "each thread stages 4 vectors of x per step");

template <bool HALO>
__global__ void __launch_bounds__(K1_THREADS, 1)
dense_layer_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a1,
                        const float* __restrict__ b1, const bf16* __restrict__ w1p,
                        const float* __restrict__ a2, const float* __restrict__ b2,
                        const bf16* __restrict__ w2r, bf16* __restrict__ out, int B, int H, int W, int C,
                        int ldx, int ldo, int top, int bot) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* w2s = smem_wg;
  unsigned char* gs = w2s + W2_BYTES;            // g of the halo tile, [k / 8][flat index][8]
  unsigned char* ring = gs + K1T::G_BYTES;       // [2] stages: t [k / 8][row][8], then W1 [k / 8][n][8]
  unsigned char* os = ring + K1_STAGE;           // staged outputs, in the second stage's t
  float* abs_ = reinterpret_cast<float*>(ring + 2 * K1_STAGE);  // a1 | b1 | a2 | b2

  const int tid = threadIdx.x, wg = tid / WG_THREADS, lw = tid % WG_THREADS;
  const int warp = lw / 32, gq = lw % 32 / 4, tq = lw % 4;
  const int oct = lw % 8;                        // the thread stages channels 8*oct .. of rows srow + 16*r
  const int srow = 64 * wg + lw / 8;
  const int tiles_x = (W + K1_TW - 1) / K1_TW, tiles_y = (H + K1T::TH - 1) / K1T::TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int nchunks = (C + K1_KC - 1) / K1_KC;
  const bool w1_resident = nchunks <= 2;  // the ring's two stages hold all of W1: staged once, not per tile
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const bool ab_staged = C <= K1_MAX_C;
  const float* a1s = ab_staged ? abs_ : a1;
  const float* b1s = ab_staged ? abs_ + K1_MAX_C : b1;
  const float* a2s = abs_ + 2 * K1_MAX_C;
  const float* b2s = a2s + INTER;
  float* xch = abs_ + 2 * K1_MAX_C + 2 * INTER;  // rows handed from warp to warp (conv2_flat_share)
  uint64_t* w1_bar = reinterpret_cast<uint64_t*>(xch + K1_XCH_BYTES / 4);  // [2]: a stage's W1 has landed

  int gp[4];  // device-memory pixel index of the thread's four staging rows, -1 outside the image
  auto tile_pixels = [&](int tx, int ty, int b) {
    const int x0 = tx * K1_TW, y0 = ty * K1T::TH;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = srow + 16 * r;
      const int iy = y0 - 1 + row / K1T::HW, ix = x0 - 1 + row % K1T::HW;
      if constexpr (HALO)
        gp[r] = row < K1T::HPIX ? halo_pixel(b, iy, ix, H, W, top, bot) : -1;
      else
        gp[r] = (row < K1T::HPIX && iy >= 0 && iy < H && ix >= 0 && ix < W) ? (b * H + iy) * W + ix : -1;
    }
  };
  auto fetch = [&](uint4 (&xr)[4], int c0) {
    const int c = c0 + 8 * oct;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      xr[r] = (c < C && gp[r] >= 0) ? __ldcg(reinterpret_cast<const uint4*>(x + (size_t)gp[r] * ldx + c)) : zero;
  };
  // Chunk ci of W1 into a stage, by one thread: w1p (C / 8, 128, 8) is the stage's own
  // layout, so a chunk is one bulk copy of up to 16 KB that no thread's load queue
  // sees (as 16-byte cp.async the copies took ~1,000 clocks a step to send off and land).
  // A ragged last chunk copies the planes there are; t is 0 past C and what the rest of
  // the stage holds is finite (zeros at first, then weights), so it multiplies as 0.
  auto w1_bulk = [&](int ci, int stage) {
    const int planes = min(K1_KC / 8, C / 8 - ci * (K1_KC / 8));
    mbarrier_arrive_expect_tx(w1_bar + stage, planes * K1_W1_PLANE);
    bulk_copy_g2s(ring + stage * K1_STAGE + K1_T_BYTES, w1p + (size_t)ci * (K1_KC / 8) * INTER * 8, planes * K1_W1_PLANE,
                  w1_bar + stage);
  };
  uint32_t w1_parity = 0;  // bit s: the phase of w1_bar[s] to wait for next

  // rows of g past the 192 the epilogue writes feed only results that are dropped; zero them once
  for (int v = tid; v < (INTER / 8) * (K1T::G_ROWS - K1_ROWS); v += K1_THREADS)
    *reinterpret_cast<uint4*>(gs + (v / (K1T::G_ROWS - K1_ROWS)) * K1T::G_PLANE +
                              (K1_ROWS + v % (K1T::G_ROWS - K1_ROWS)) * 16) = zero;
  if (ab_staged)
    for (int c = tid; c < C; c += K1_THREADS) {
      abs_[c] = a1[c];
      abs_[K1_MAX_C + c] = b1[c];
    }
  if (tid < INTER) {
    abs_[2 * K1_MAX_C + tid] = a2[tid];
    abs_[2 * K1_MAX_C + INTER + tid] = b2[tid];
  }
  for (int v = tid; v < 2 * (K1_KC / 8) * INTER; v += K1_THREADS)
    *reinterpret_cast<uint4*>(ring + (v / ((K1_KC / 8) * INTER)) * K1_STAGE + K1_T_BYTES + (v % ((K1_KC / 8) * INTER)) * 16) = zero;
  stage_w2(w2s, w2r, tid, K1_THREADS);
  cp_async_commit();
  if (tid == 0) {
    mbarrier_init(w1_bar, 1);
    mbarrier_init(w1_bar + 1, 1);
  }

  uint4 x0r[4], x1r[4];
  int tile = blockIdx.x;
  TileWalk at(tile, gridDim.x, tiles_x, tiles_y);  // the tile whose x is loaded next
  if (tile < ntiles) {
    tile_pixels(at.tx, at.ty, at.b);
    fetch(x0r, 0);
    if (K1_KC < C) fetch(x1r, K1_KC);
  }
  cp_async_wait<0>();   // W2 has landed
  fence_proxy_async();  // the zeros are visible to the bulk copies, W2 to the tensor core's reads
  __syncthreads();      // a1 .. b2 are staged, the barriers are set up
  if (tid == 0) {
    w1_bulk(0, 0);
    if (nchunks == 2) w1_bulk(1, 1);
  }
  if (w1_resident) {
    mbarrier_wait(w1_bar, 0);
    if (nchunks == 2) mbarrier_wait(w1_bar + 1, 0);
  }

  float acc[64];
  // t of chunk ci from xr into stage ci & 1; then xr sets out for the chunk after next.
  // Straight code (selects, no branches): it also runs under the conv's products.
  auto stage_t = [&](int ci, uint4 (&xr)[4]) {
    const int c = ci * K1_KC + 8 * oct;
    float a[8], b[8];
    affine8(a1s, b1s, c, C, a, b);
    unsigned char* ts = ring + (ci & 1) * K1_STAGE + oct * K1_T_PLANE;
#pragma unroll
    for (int r = 0; r < 4; ++r)  // rows outside the image and channels past C stage t = 0
      *reinterpret_cast<uint4*>(ts + (srow + 16 * r) * 16) = affine_relu8(xr[r], a, b, c < C && gp[r] >= 0);
    if (ci + 2 < nchunks) fetch(xr, (ci + 2) * K1_KC);  // in flight over the next step
  };
  // the rest of step ci: the products on its staged t and W1 started
  auto start_products = [&](int ci) {
    const int stage = ci & 1;
    wgmma_wait<0>();      // the last step's products are done: its stage may be rewritten after the barrier
    if (!w1_resident) {   // this chunk of W1 has landed
      mbarrier_wait(w1_bar + stage, w1_parity >> stage & 1);
      w1_parity ^= 1u << stage;
    }
    fence_proxy_async();  // t is visible to the tensor core's reads
    __syncthreads();
    if (!w1_resident && ci + 1 < nchunks && tid == 0) w1_bulk(ci + 1, stage ^ 1);
    wgmma_fence();
    const uint64_t da = wgmma_desc(smem_u32(ring + stage * K1_STAGE) + 64 * wg * 16, K1_T_PLANE, CORE_BYTES);
    const uint64_t db = wgmma_desc(smem_u32(ring + stage * K1_STAGE + K1_T_BYTES), K1_W1_PLANE, CORE_BYTES);
#pragma unroll
    for (int ks = 0; ks < K1_KC / 16; ++ks)
      wgmma_m64n128k16(acc, desc_advance(da, ks * 2 * K1_T_PLANE), desc_advance(db, ks * 2 * K1_W1_PLANE), (ci | ks) != 0);
    wgmma_commit();
  };

  stage_t(0, x0r);  // the first tile's first chunk; every later tile's is staged under the conv before it
  for (; tile < ntiles; tile += gridDim.x) {
    const int x0 = at.tx * K1_TW, y0 = at.ty * K1T::TH, b = at.b;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wgmma_fence_acc(acc);
    for (int ci = 0; ci < nchunks; ci += 2) {
      if (ci > 0) stage_t(ci, x0r);
      start_products(ci);
      if (ci + 1 < nchunks) {
        stage_t(ci + 1, x1r);
        start_products(ci + 1);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);

    // x0r and x1r are free: the next tile's first x sets out now and lands under the
    // epilogue (sent off just before the conv, the loads held its products up)
    at.advance();
    if (tile + (int)gridDim.x < ntiles) {
      tile_pixels(at.tx, at.ty, at.b);
      fetch(x0r, 0);
      if (K1_KC < C) fetch(x1r, K1_KC);
    }

    // g = round(relu(a2*h + b2)), exactly 0 outside the image: that is conv2's
    // zero padding (a zero x there would leak relu(b1), relu(b2))
    {
      bool in[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 64 * wg + 16 * warp + gq + 8 * half;
        const int iy = y0 - 1 + row / K1T::HW, ix = x0 - 1 + row % K1T::HW;
        if constexpr (HALO)
          in[half] = row < K1T::HPIX && halo_pixel(b, iy, ix, H, W, top, bot) >= 0;
        else
          in[half] = row < K1T::HPIX && iy >= 0 && iy < H && ix >= 0 && ix < W;
      }
      // four 8 x 8 blocks of the fragment per store: lane l names row l % 8 of block l / 8,
      // blocks (plane j, rows +0), (j, +8), (j + 1, +0), (j + 1, +8); a row is 16 bytes of a plane
      const int lane = lw % 32;
      const uint32_t grow = smem_u32(gs) + (lane / 16) * K1T::G_PLANE + (64 * wg + 16 * warp + lane % 16) * 16;
#pragma unroll
      for (int j = 0; j < INTER / 8; j += 2) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float2 a = *reinterpret_cast<const float2*>(a2s + 8 * (j + jj) + 2 * tq);
          const float2 bb = *reinterpret_cast<const float2*>(b2s + 8 * (j + jj) + 2 * tq);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            v[2 * jj + half] = in[half] ? pack_pair_relu(acc[4 * (j + jj) + 2 * half] * a.x + bb.x,
                                                         acc[4 * (j + jj) + 2 * half + 1] * a.y + bb.y)
                                        : 0u;
        }
        stmatrix_x4(grow + j * K1T::G_PLANE, v);
      }
    }
    fence_proxy_async();
    __syncthreads();  // g is whole; every warpgroup is past its t.W1 products, so the ring is free

    // the next tile's first chunk of W1 sets out while this tile's conv runs
    if (!w1_resident && tile + (int)gridDim.x < ntiles && tid == 0) w1_bulk(0, 0);

    // A warpgroup per 64-row tile of the conv: all three (K1T::M2 == K1_WGS), so the
    // block's barrier inside is reached by every thread. The test stays: with
    // the conv's products in the loop's straight code, ptxas of CUDA 12.9
    // crashes at -O2 and above.
    if (wg < K1T::M2) {
      float acc3[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) acc3[i] = 0.f;
      wgmma_fence_acc(acc3);
      wgmma_fence();
      conv2_flat_mma<K1_TW>(acc3, smem_u32(gs), 64 * wg, smem_u32(w2s));
      wgmma_commit();
      // under the conv: the next tile's first t (after the last tile: stale values, never read)
      stage_t(0, x0r);
      wgmma_wait<0>();
      wgmma_fence_acc(acc3);
      float acc2[16];
      conv2_flat_share(xch, acc3, tid / 32, tid % 32);
      __syncthreads();
      conv2_flat_combine(acc2, acc3, xch, tid / 32, tid % 32);
      conv2_flat_stage<K1_TW>(os, acc2, 64 * wg, lw);
      warpgroup_sync(wg);
      conv2_flat_store<K1_TW>(os, out, ldo, 64 * wg, b, y0, x0, H, W, lw);
    }
    // os is the second stage's t, rows 64 wg .. of it this warpgroup's own: they are next
    // written in step 1 of the next tile, after step 0's block barrier; g is next
    // written after every step's barrier, which every thread reaches past its conv
  }
}

// --- K2 bf16 on wgmma ----------------------------------------------------------
//
// tw1_stream (wgmma_bf16.cuh) computes h tile by tile; the epilogue below
// turns each tile's accumulators into column sums without leaving registers.
// A thread's fragment holds two rows of 32 columns (col = 8j + 2tq + e), the
// same columns on every tile, so it adds them into running fp32 sums of h
// and h*h (64 registers). Every K2_FLUSH tiles, and at the end, the sums are
// reduced: a butterfly over the 8 lanes that share columns (lane bits 2-4,
// 56 shuffles) leaves each lane 8 of the warp's 256 sums, the 8 warps meet
// in shared memory, and thread i (statistic i / 128, column i % 128) adds
// their fp32 sum, in warp order, into its float64 total for the block. So an
// fp32 sum never spans more than 2 * K2_FLUSH rows before the lane tree (the
// mma.sync body's spanned 192 rows), the reduction costs ~4 shuffles a tile,
// and the block writes one row of float64 partials: 132 rows on an H100,
// not one per 192 pixels. Rows past npix hold h = 0 (tw1_stream stages t = 0
// there), so they add nothing. The walk is static and every sum is taken in
// a fixed order: a launch gives the same bits every time on one machine.

// One step of a reduce-scatter across the lanes that differ in ``bit``: of the
// first 2N values, the lower lane keeps [0, N) and the upper [N, 2N), each
// adding the other's half. N is a template constant so that every index is.
template <int N>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[64], int lane, int bit) {
  const bool upper = lane & bit;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? v[N + i] : v[i], send = upper ? v[i] : v[N + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

constexpr int K2_RES = 6;     // W1 chunks resident: all of W1 for C <= 384 (what fits beside the x ring)
constexpr int K2_FLUSH = 16;  // tiles between two reductions of the running sums
typedef TW1Smem<K2_RES> K2S;
constexpr int K2_WARPS = TW1_THREADS / 32;
constexpr uint32_t K2_RED_BYTES = K2_WARPS * 2 * INTER * sizeof(float);  // [warp][statistic][column]
constexpr size_t K2_SMEM = K2S::BYTES + K2_RED_BYTES;
static_assert(K2_SMEM <= 232448, "a block's shared memory");
static_assert(TW1_THREADS == 2 * INTER, "a thread per (statistic, column) keeps the block's float64 total");

// The epilogue of both K2 kernels (bf16 and fp32): a warpgroup's 64 x 128
// accumulators per tile into running sums, and their reduction into the
// block's float64 total. Every thread calls add() the same number of times
// (the barriers inside flush() are reached by all).
struct HStatsSums {
  float run[64];  // run[2j + e]: sum of h at column 8j + 2tq + e over the thread's rows; run[32 + 2j + e]: of h*h
  double total;   // statistic tid / 128 of column tid % 128 over the block's tiles
  int since_flush;

  __device__ __forceinline__ HStatsSums() : total(0.0), since_flush(0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = 0.f;
  }

  __device__ __forceinline__ void flush(float* red) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tq = lane % 4;
    // reduce-scatter over lane bits 4, 3, 2 (constant indices throughout: run stays in registers)
    reduce_scatter_step<32>(run, lane, 16);
    reduce_scatter_step<16>(run, lane, 8);
    reduce_scatter_step<8>(run, lane, 4);
    // lane holds run[32 b4 + 16 b3 + 8 b2 + i], i < 8, summed over the warp's 16 rows (b_k = bit k of lane)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 16 * (lane >> 3 & 1) + 8 * (lane >> 2 & 1) + i;  // 2j + e
      red[(warp * 2 + (lane >> 4)) * INTER + 8 * (k >> 1) + 2 * tq + (k & 1)] = run[i];
    }
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < K2_WARPS; ++w) s += red[w * 2 * INTER + tid];
    total += (double)s;
    __syncthreads();  // red is free again
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = 0.f;
    since_flush = 0;
  }

  __device__ __forceinline__ void add(const float (&acc)[64], float* red) {
#pragma unroll
    for (int j = 0; j < INTER / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];  // rows gq and gq + 8
        run[2 * j + e] += v0 + v1;
        run[32 + 2 * j + e] = fmaf(v1, v1, fmaf(v0, v0, run[32 + 2 * j + e]));
      }
    if (++since_flush == K2_FLUSH) flush(red);
  }

  // the sums not yet flushed, then the block's row of partials
  __device__ __forceinline__ void finish(float* red, double* __restrict__ psum, double* __restrict__ psq) {
    if (since_flush > 0) flush(red);
    const int tid = threadIdx.x;
    (tid < INTER ? psum : psq)[(size_t)blockIdx.x * INTER + tid % INTER] = total;
  }
};

__global__ void __launch_bounds__(TW1_THREADS, 1)
h_stats_bf16_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ a1, const float* __restrict__ b1,
                    const bf16* __restrict__ w1p, double* __restrict__ psum, double* __restrict__ psq, int npix,
                    int C) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  float* red = reinterpret_cast<float*>(smem_wg + K2S::BYTES);
  HStatsSums sums;
  tw1_stream<K2_RES>(StridedX{x, ldx}, a1, b1, w1p, npix, C, smem_wg,
                     [&](const float (&acc)[64], int) { sums.add(acc, red); });
  sums.finish(red, psum, psq);
}

// --- fp32 on wgmma: 3xTF32 products (wgmma_tf32.cuh) -------------------------
//
// Both fp32 kernels take x in steps of 32 channels: a step's x is a row of 128
// bytes per pixel in shared memory (rows swizzled by tf32_swz), brought by
// cp.async, each warp copying and reading only its own 16 rows (a warp
// barrier orders them, no block barrier). A thread computes t = relu(a1*x +
// b1) for its two rows and eight channels of the step in fp32 and splits it
// into the A fragments of wgmma (tf32_split_frags); W1 arrives as tf32 big and
// small planes, 32 KB a chunk of 32 channels (ops/dense.py::w1_tf32x3_planes),
// by bulk copies. A step is 4 k-steps of three m64n128k8 products. a1 and b1
// are read from device memory (the wrapper pads them to whole chunks with
// zeros, so t is 0 past C, and W1's padding rows are zeros); x is zero-filled
// past C (the wrapper pads x to C % 4 == 0, ld % 4 == 0 and 16-byte alignment
// where it is not so already).

constexpr int TF_KC = 32;                                   // channels of x per step
constexpr uint32_t TF_ROW = 4 * TF_KC;                      // 128 bytes: a pixel's x of a step
constexpr uint32_t TF_W1_PLANE = INTER * 16;                // [n][4 fp32]
constexpr uint32_t TF_W1_HALF = (TF_KC / 4) * TF_W1_PLANE;  // 16 KB: a chunk's big (or small) planes
constexpr uint32_t TF_W1_CHUNK = 2 * TF_W1_HALF;            // 32 KB

// a[0..7], b[0..7] = a1, b1 at channels c .. c + 7 (in bounds: padded to whole chunks)
__device__ __forceinline__ void affine8_f32(const float* __restrict__ a1, const float* __restrict__ b1, int c,
                                            float (&a)[8], float (&b)[8]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 av = __ldg(reinterpret_cast<const float4*>(a1 + c) + u);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b1 + c) + u);
    a[4 * u] = av.x, a[4 * u + 1] = av.y, a[4 * u + 2] = av.z, a[4 * u + 3] = av.w;
    b[4 * u] = bv.x, b[4 * u + 1] = bv.y, b[4 * u + 2] = bv.z, b[4 * u + 3] = bv.w;
  }
}

// t of the thread's rows gq (h = 0) and gq + 8 (h = 1) of a warp's staged rows
// (xw: 16 rows of 128 bytes), channels 8tq .. of the step, into A fragments;
// ok[h] false: t = 0
__device__ __forceinline__ void tf32_t_frags(const unsigned char* xw, const float (&a)[8], const float (&b)[8],
                                             const bool (&ok)[2], int gq, int tq, uint32_t (&big)[16],
                                             uint32_t (&small)[16]) {
  float v[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h;
    tf32_load8(xw + r * TF_ROW, r, 0, tq, v[h]);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[h][i] = ok[h] ? fmaxf(fmaf(v[h][i], a[i], b[i]), 0.f) : 0.f;
  }
  tf32_split_frags(v, big, small);
}

// --- K2 fp32 ---------------------------------------------------------------------
//
// Replaces pallas_dense.py::_h_stats_pallas in fp32. The structure of the bf16
// K2 (tw1_stream): persistent blocks of two warpgroups over 128-pixel tiles, a
// static walk (tile = blockIdx.x + k * gridDim.x), x copied three steps ahead,
// the next step's t made while a step's products run, W1's first TF2_RES
// chunks resident and the rest through a two-stage ring, one chunk ahead. Its
// epilogue is HStatsSums: fp32 running sums in registers over at most 16
// tiles, then one float64 total per column and block.

constexpr int TF2_RES = 2;     // W1 chunks resident: all of W1 for C <= 64
constexpr int TF2_STAGES = 4;  // x copied 3 steps ahead
constexpr uint32_t TF2_X_STAGE = (TW1_THREADS / 32) * 16 * TF_ROW;  // [warp][16 rows][128 bytes]: 16 KB
constexpr uint32_t TF2_RING = TF2_RES * TF_W1_CHUNK;
constexpr uint32_t TF2_X = TF2_RING + 2 * TF_W1_CHUNK;
constexpr uint32_t TF2_RED = TF2_X + TF2_STAGES * TF2_X_STAGE;
constexpr uint32_t TF2_BARS = TF2_RED + K2_RED_BYTES;       // [3]: resident W1, ring stages 0 and 1
constexpr size_t TF2_SMEM = TF2_BARS + 3 * sizeof(uint64_t);
static_assert(TF2_SMEM <= 232448, "a block's shared memory");
static_assert(TW1_ROWS * TF_KC == TW1_THREADS * 4 * 4, "each thread copies 4 vectors of x per step");

__global__ void __launch_bounds__(TW1_THREADS, 1)
h_stats_tf32x3_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ a1, const float* __restrict__ b1,
                      const float* __restrict__ w1p, double* __restrict__ psum, double* __restrict__ psq, int npix,
                      int C) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* res = smem_wg;
  unsigned char* ring = smem_wg + TF2_RING;
  float* red = reinterpret_cast<float*>(smem_wg + TF2_RED);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wg + TF2_BARS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int ntiles = (npix + TW1_ROWS - 1) / TW1_ROWS;
  const int nchunks = (C + TF_KC - 1) / TF_KC;
  const int my_tiles = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nsteps = my_tiles * nchunks;
  HStatsSums sums;
  if (nsteps > 0) {
    if (tid == 0)
      for (int i = 0; i < 3; ++i) mbarrier_init(bars + i, 1);

    // chunk ci of W1 into a ring stage, by one thread
    auto ring_copy = [&](int ci, int stage) {
      mbarrier_arrive_expect_tx(bars + 1 + stage, TF_W1_CHUNK);
      bulk_copy_g2s(ring + stage * TF_W1_CHUNK, w1p + (size_t)ci * (TF_W1_CHUNK / 4), TF_W1_CHUNK, bars + 1 + stage);
    };

    // x of a step into stage k % STAGES: the warp's 16 rows, lane l copying channels 4 (l % 8) ..
    // of rows l / 8 + 4j; zeros past npix and past C; one cp.async group per step
    unsigned char* xw = smem_wg + TF2_X + warp * 16 * TF_ROW;
    TW1Step fe{(int)blockIdx.x, 0};
    int fe_k = 0;
    auto fetch = [&]() {
      unsigned char* dst = xw + (fe_k % TF2_STAGES) * TF2_X_STAGE;
      const int part = lane % 8;
      const int c = fe.ci * TF_KC + 4 * part;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * j + lane / 8;
        const int p = fe.tile * TW1_ROWS + 16 * warp + r;
        const bool ok = c < C && p < npix;
        cp_async16_zfill(dst + r * TF_ROW + 16 * tf32_swz(r, part), ok ? x + (size_t)p * ldx + c : x, ok);
      }
      cp_async_commit();
      fe.advance(nchunks, gridDim.x);
      ++fe_k;
    };
    // t of the next step into A fragments; rows past npix: t = 0, not relu(b1)
    TW1Step st{(int)blockIdx.x, 0};
    int st_k = 0;
    auto make_t = [&](uint32_t (&big)[16], uint32_t (&small)[16]) {
      cp_async_wait<TF2_STAGES - 2>();  // this thread's copies of the step have landed
      __syncwarp();                     // ... and the warp's
      float a[8], b[8];
      affine8_f32(a1, b1, st.ci * TF_KC + 8 * tq, a, b);
      const bool ok[2] = {st.tile * TW1_ROWS + 16 * warp + gq < npix, st.tile * TW1_ROWS + 16 * warp + gq + 8 < npix};
      tf32_t_frags(xw + (st_k % TF2_STAGES) * TF2_X_STAGE, a, b, ok, gq, tq, big, small);
      __syncwarp();  // every lane has read the stage before a lane refills it
      st.advance(nchunks, gridDim.x);
      ++st_k;
    };

    for (int i = 0; i < TF2_STAGES - 1; ++i) fetch();
    __syncthreads();  // the barriers are set up
    if (tid == 0) {
      const int nres = min(nchunks, TF2_RES);
      mbarrier_arrive_expect_tx(bars, nres * TF_W1_CHUNK);
      bulk_copy_g2s(res, w1p, nres * TF_W1_CHUNK, bars);
      if (nchunks > TF2_RES) ring_copy(TF2_RES, 0);
    }
    mbarrier_wait(bars, 0);

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t big0[16], small0[16], big1[16], small1[16];
    TW1Step pc{(int)blockIdx.x, 0};  // the step whose products run
    int ring_k = 0;                  // ring chunks used so far: the next one is in stage ring_k & 1
    auto step = [&](const uint32_t (&a_big)[16], const uint32_t (&a_small)[16], uint32_t (&n_big)[16],
                    uint32_t (&n_small)[16]) {
      const bool in_ring = pc.ci >= TF2_RES;
      if (in_ring) {
        mbarrier_wait(bars + 1 + (ring_k & 1), (ring_k >> 1) & 1);  // this chunk of W1 has landed
        __syncthreads();  // both warpgroups are past the products that read the other stage
        if (tid == 0 && !(pc.ci + 1 == nchunks && pc.tile + (int)gridDim.x >= ntiles))
          ring_copy(pc.ci + 1 < nchunks ? pc.ci + 1 : TF2_RES, (ring_k + 1) & 1);
      }
      const uint32_t w = smem_u32(in_ring ? ring + (ring_k & 1) * TF_W1_CHUNK : res + pc.ci * TF_W1_CHUNK);
      wgmma_fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < TF_KC / 8; ++s)
        tf32x3_kstep<INTER>(acc, a_big, a_small, w, w + TF_W1_HALF, TF_W1_PLANE, s, pc.ci == 0 && s == 0);
      wgmma_commit();
      ring_k += in_ring;
      make_t(n_big, n_small);  // under the products: the next step's t, then x for a later step sets out
      fetch();
      wgmma_wait<0>();
      wgmma_fence_acc(acc);
      if (pc.ci == nchunks - 1) sums.add(acc, red);
      pc.advance(nchunks, gridDim.x);
    };

    make_t(big0, small0);
    fetch();
    for (int s = 0; s < nsteps; s += 2) {
      step(big0, small0, big1, small1);
      if (s + 1 < nsteps) step(big1, small1, big0, small0);
    }
    cp_async_wait<0>();  // the copies past the last step (zeros) land before the block ends
  }
  sums.finish(red, psum, psq);
}

// --- K1 fp32 ---------------------------------------------------------------------
//
// Replaces pallas_dense.py::_fused_layer_pallas in fp32. One persistent block
// of three warpgroups (384 threads) per SM walks the 8 x 16 output tiles
// (tile = blockIdx.x + k * gridDim.x). Per tile:
//   1. h = t.W1 for the 180 halo pixels (192 rows, warpgroup w owning rows
//      64w ..) in steps of 32 channels: x copied two steps ahead into a
//      two-stage ring (the next tile's first two steps land under this
//      tile's conv), t made and split in registers, then the step's 12
//      products m64n128k8 on W1's chunk.
//   2. g = relu(a2*h + b2) in fp32, exactly 0 outside the image (conv2's zero
//      padding: a zero x there would leak relu(b1), relu(b2) through the
//      affines), into shared memory once: 192 rows of 512 bytes.
//   3. the 3x3 conv 128 -> 32 as the bf16 K1 takes it (wgmma_bf16.cuh,
//      FlatTile): the M rows run over g's flat halo index, a tap's row shift
//      dy is an address, and the three taps dx of a kernel row lie side by
//      side in N = 96; A is loaded from g's rows into registers and split
//      there (12 m64n96k8 products per 32 channels and kernel row), the next
//      chunk's A loaded and split while a chunk's products run. The shares
//      of the three taps dx are brought together by conv2_flat_share /
//      conv2_flat_combine and the 32 channels stored from registers.
// Weights. W2 split into big and small planes is 288 KB, more than a block
// may hold beside g (96 KB), so nothing is resident: W1's chunks (32 KB) and
// then W2's twelve (24 KB: a kernel row dy, 32 channels of g, N = 96) pass
// through one two-stage ring of bulk copies, a chunk ahead; the block's
// barrier at each chunk orders a stage's refill after every warpgroup's
// products that read it. The split of g is made in registers: g in big and
// small copies would take 192 KB.
// Registers: a launch of 384 threads has at most 168 a thread. t.W1 holds 64
// accumulators, so its steps make t before their products (one fragment
// set); the conv holds 48 and double-buffers its fragments.
// Shared memory: g 96 KB, the x ring 48 KB, the weight ring 64 KB, a2 and
// b2 1 KB, the conv's hand-over rows 5 KB: 214 KB of the 227 a block may have.

typedef FlatTile<16> TF1T;
constexpr int TF1_WGS = TF1T::M1;                              // 3
constexpr int TF1_THREADS = WG_THREADS * TF1_WGS;              // 384
constexpr int TF1_ROWS = 64 * TF1_WGS;                         // 192 rows of t, h and g
constexpr int TF1_STAGES = 2;                                  // x copied two steps ahead
constexpr uint32_t TF1_X_STAGE = TF1_ROWS * TF_ROW;            // 24 KB
constexpr uint32_t TF1_G_ROW = INTER * 4;                      // 512 bytes
constexpr uint32_t TF1_W2_PLANE = 3 * GROWTH * 16;             // [dx * 32 + n][4 fp32]
constexpr uint32_t TF1_W2_HALF = (TF_KC / 4) * TF1_W2_PLANE;   // 12 KB
constexpr uint32_t TF1_W2_CHUNK = 2 * TF1_W2_HALF;             // 24 KB
constexpr int TF1_W2_CHUNKS = 3 * (INTER / TF_KC);             // 12: kernel row dy, 32 channels kc (chunk 4 dy + kc)
constexpr uint32_t TF1_WSTAGE = TF_W1_CHUNK;                   // a stage holds a chunk of either
constexpr uint32_t TF1_X = TF1_ROWS * TF1_G_ROW;
constexpr uint32_t TF1_W = TF1_X + TF1_STAGES * TF1_X_STAGE;
constexpr uint32_t TF1_AB2 = TF1_W + 2 * TF1_WSTAGE;
constexpr uint32_t TF1_XCH = TF1_AB2 + 2 * INTER * 4;
constexpr uint32_t TF1_BARS = TF1_XCH + (TF1_THREADS / 32 + 1) * XCH_WARP * 4;
constexpr size_t TF1_SMEM = TF1_BARS + 2 * sizeof(uint64_t);
static_assert(TF1T::M2 == TF1_WGS, "a warpgroup per 64-row tile of the conv");
static_assert(TF1_W2_CHUNK <= TF1_WSTAGE, "a W2 chunk fits a ring stage");
static_assert(TF1_SMEM <= 232448, "a block's shared memory");

template <bool HALO>
__global__ void __launch_bounds__(TF1_THREADS, 1)
dense_layer_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ a1, const float* __restrict__ b1,
                          const float* __restrict__ w1p, const float* __restrict__ a2, const float* __restrict__ b2,
                          const float* __restrict__ w2p, float* __restrict__ out, int B, int H, int W, int C, int ldx,
                          int ldo, int top, int bot, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* gs = smem_wg;                   // g of the halo tile: [flat index][128 fp32], vectors swizzled
  unsigned char* wring = smem_wg + TF1_W;        // [2] stages of W1's or W2's chunks
  float* ab2 = reinterpret_cast<float*>(smem_wg + TF1_AB2);  // a2 | b2
  float* xch = reinterpret_cast<float*>(smem_wg + TF1_XCH);  // rows handed from warp to warp (conv2_flat_share)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wg + TF1_BARS);  // [2]: a ring stage has landed

  const int tid = threadIdx.x, wg = tid / WG_THREADS, warp = tid % WG_THREADS / 32, lane = tid % 32;
  const int wb = tid / 32;  // the warp of the block: its rows 16 wb .. of the halo tile
  const int gq = lane / 4, tq = lane % 4;
  const int tiles_x = (W + TF1T::TW - 1) / TF1T::TW, tiles_y = (H + TF1T::TH - 1) / TF1T::TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int nchunks = (C + TF_KC - 1) / TF_KC;
  const int per_tile = nchunks + TF1_W2_CHUNKS;  // weight chunks a tile takes
  const int my_tiles = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  if (my_tiles == 0) return;
  const int nsteps = my_tiles * nchunks, nw = my_tiles * per_tile;

  if (tid < INTER) {
    ab2[tid] = a2[tid];
    ab2[INTER + tid] = b2[tid];
  }
  if (tid == 0) {
    mbarrier_init(bars, 1);
    mbarrier_init(bars + 1, 1);
  }

  // weight chunk q of the block's sequence (per tile W1's chunks, then W2's) into stage q & 1, by one thread
  auto w_copy = [&](int q) {
    const int k = q % per_tile;
    const bool is_w1 = k < nchunks;
    const uint32_t bytes = is_w1 ? TF_W1_CHUNK : TF1_W2_CHUNK;
    const float* src = is_w1 ? w1p + (size_t)k * (TF_W1_CHUNK / 4) : w2p + (size_t)(k - nchunks) * (TF1_W2_CHUNK / 4);
    mbarrier_arrive_expect_tx(bars + (q & 1), bytes);
    bulk_copy_g2s(wring + (q & 1) * TF1_WSTAGE, src, bytes, bars + (q & 1));
  };
  // the next weight chunk, once it has landed; the block's barrier orders the refill of the
  // other stage after every warpgroup's products that read it (each waited for them before)
  int wq = 0;
  auto w_take = [&]() -> uint32_t {
    mbarrier_wait(bars + (wq & 1), (wq >> 1) & 1);
    __syncthreads();
    if (tid == 0 && wq + 1 < nw) w_copy(wq + 1);
    const uint32_t addr = smem_u32(wring + (wq & 1) * TF1_WSTAGE);
    ++wq;
    return addr;
  };

  // x: the warp's 16 rows of a stage, lane l copying channels 4 (l % 8) .. of rows l / 8 + 4j,
  // zeros outside the image, past the halo's 180 pixels and past C
  unsigned char* xw = smem_wg + TF1_X + wb * 16 * TF_ROW;
  int fe_tile = blockIdx.x, fe_ci = 0, fe_k = 0, fgp[4];
  auto fetch_pixels = [&]() {  // pixel of each row the lane copies for fe_tile, -1 for none
    const int tx = fe_tile % tiles_x, ty = fe_tile / tiles_x % tiles_y, b = fe_tile / (tiles_x * tiles_y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * wb + 4 * j + lane / 8;
      const int iy = ty * TF1T::TH - 1 + row / TF1T::HW, ix = tx * TF1T::TW - 1 + row % TF1T::HW;
      if constexpr (HALO)
        fgp[j] = row < TF1T::HPIX ? halo_pixel(b, iy, ix, H, W, top, bot) : -1;
      else
        fgp[j] = (row < TF1T::HPIX && iy >= 0 && iy < H && ix >= 0 && ix < W) ? (b * H + iy) * W + ix : -1;
    }
  };
  auto fetch = [&]() {  // the step fe_k into stage fe_k % 2; a cp.async group every call
    unsigned char* dst = xw + (fe_k % TF1_STAGES) * TF1_X_STAGE;
    const int part = lane % 8;
    const int c = fe_ci * TF_KC + 4 * part;
    const bool live = fe_k < nsteps;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * j + lane / 8;
      const bool ok = live && c < C && fgp[j] >= 0;
      cp_async16_zfill(dst + r * TF_ROW + 16 * tf32_swz(r, part), ok ? x + (size_t)fgp[j] * ldx + c : x, ok);
    }
    cp_async_commit();
    ++fe_k;
    if (++fe_ci == nchunks) {
      fe_ci = 0;
      fe_tile += gridDim.x;
      if (fe_tile < ntiles) fetch_pixels();
    }
  };
  int st_ci = 0, st_k = 0;  // the step whose t is made next
  auto make_t = [&](uint32_t (&big)[16], uint32_t (&small)[16]) {
    cp_async_wait<TF1_STAGES - 1>();  // this thread's copies of the step have landed
    __syncwarp();                     // ... and the warp's
    float a[8], b[8];
    affine8_f32(a1, b1, st_ci * TF_KC + 8 * tq, a, b);
    const bool ok[2] = {true, true};  // rows outside the image give h that g drops
    tf32_t_frags(xw + (st_k % TF1_STAGES) * TF1_X_STAGE, a, b, ok, gq, tq, big, small);
    __syncwarp();  // every lane has read the stage before a lane refills it
    ++st_k;
    if (++st_ci == nchunks) st_ci = 0;
  };

  // A of conv chunk k (kernel row dy = k / 4, channels 32 (k % 4) ..) from g: rows p + 18 dy of
  // the thread's rows p; rows past 191 feed only outputs that are dropped, and read row 191
  const int crow = 64 * wg + 16 * warp + gq;  // the thread's conv rows: crow, crow + 8
  auto load_g = [&](uint32_t (&big)[16], uint32_t (&small)[16], int k) {
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(crow + 8 * h + TF1T::HW * (k / 4), TF1_ROWS - 1);
      tf32_load8(gs + r * TF1_G_ROW, r, k % 4, tq, v[h]);
    }
    tf32_split_frags(v, big, small);
  };

  fetch_pixels();
  fetch();
  fetch();
  __syncthreads();  // a2, b2 are staged, the barriers are set up
  if (tid == 0) w_copy(0);

  uint32_t big0[16], small0[16], big1[16], small1[16];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = tile / tiles_x % tiles_y, b = tile / (tiles_x * tiles_y);
    const int x0 = tx * TF1T::TW, y0 = ty * TF1T::TH;

    // 1. h = t.W1 (the first product overwrites acc; zeroed so that no register is read unset)
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int ci = 0; ci < nchunks; ++ci) {
      make_t(big0, small0);
      fetch();
      const uint32_t w = w_take();
      wgmma_fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < TF_KC / 8; ++s)
        tf32x3_kstep<INTER>(acc, big0, small0, w, w + TF_W1_HALF, TF_W1_PLANE, s, ci == 0 && s == 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(acc);
    }

    // 2. g = relu(a2*h + b2), exactly 0 outside the image; float2 stores of the fragment
    {
      bool in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = crow + 8 * h;
        const int iy = y0 - 1 + row / TF1T::HW, ix = x0 - 1 + row % TF1T::HW;
        if constexpr (HALO)
          in[h] = row < TF1T::HPIX && halo_pixel(b, iy, ix, H, W, top, bot) >= 0;
        else
          in[h] = row < TF1T::HPIX && iy >= 0 && iy < H && ix >= 0 && ix < W;
      }
#pragma unroll
      for (int j = 0; j < INTER / 8; ++j) {
        const int col = 8 * j + 2 * tq, v = col / 4;
        const float2 a = *reinterpret_cast<const float2*>(ab2 + col);
        const float2 bb = *reinterpret_cast<const float2*>(ab2 + INTER + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = crow + 8 * h;
          const float2 g = in[h] ? make_float2(fmaxf(fmaf(acc[4 * j + 2 * h], a.x, bb.x), 0.f),
                                               fmaxf(fmaf(acc[4 * j + 2 * h + 1], a.y, bb.y), 0.f))
                                 : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(gs + row * TF1_G_ROW + 128 * (v / 8) + 16 * tf32_swz(row, v % 8) + 4 * (col % 4)) = g;
        }
      }
    }
    __syncthreads();  // g is whole

    // 3. the 3x3 conv: twelve chunks, each 4 k-steps of three m64n96k8 products
    float acc3[48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc3[i] = 0.f;
    load_g(big0, small0, 0);
    auto conv_chunk = [&](const uint32_t (&a_big)[16], const uint32_t (&a_small)[16], uint32_t (&n_big)[16],
                          uint32_t (&n_small)[16], int k) {
      const uint32_t w = w_take();
      wgmma_fence_acc(acc3);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < TF_KC / 8; ++s)
        tf32x3_kstep<3 * GROWTH>(acc3, a_big, a_small, w, w + TF1_W2_HALF, TF1_W2_PLANE, s, k == 0 && s == 0);
      wgmma_commit();
      if (k + 1 < TF1_W2_CHUNKS) load_g(n_big, n_small, k + 1);  // under the products
      wgmma_wait<0>();
      wgmma_fence_acc(acc3);
    };
#pragma unroll
    for (int k = 0; k < TF1_W2_CHUNKS; k += 2) {
      conv_chunk(big0, small0, big1, small1, k);
      conv_chunk(big1, small1, big0, small0, k + 1);
    }

    // 4. the three taps' shares of each output, and the 32 channels out
    float o[16];
    conv2_flat_share(xch, acc3, wb, lane);
    __syncthreads();
    conv2_flat_combine(o, acc3, xch, wb, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = crow + 8 * h, ty_ = p / TF1T::HW, tx_ = p % TF1T::HW;
      const int oy = y0 + ty_, ox = x0 + tx_;
      if (ty_ < TF1T::TH && tx_ < TF1T::TW && oy < H && ox < W) {
        float* dst = out + ((size_t)(b * H + oy) * W + ox) * ldo;
#pragma unroll
        for (int j = 0; j < GROWTH / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (vec_out) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
          } else {
            dst[col] = o[4 * j + 2 * h];
            dst[col + 1] = o[4 * j + 2 * h + 1];
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the copies past the last step (zeros) land before the block ends
}

// --- the 3xTF32 self-check ----------------------------------------------------------
//
// d (64, N) fp32 = reps * a (64, K) . b (K, N) through the fp32 kernels'
// helpers: a loaded into registers and split there (tf32_split_frags, the
// channel order of wgmma_tf32.cuh), b as w1_tf32x3_planes lays W1 out
// ((K/32, 2, 8, N, 4), in shared memory), tf32x3_kstep, by one warpgroup per
// block. A wrong fragment layout or plane order gives wrong numbers, not an
// error, so it is held against a float64 product on its own. With reps > 1 and
// many blocks it is a rate measurement: every block repeats the product, so
// its time over the k-steps started is what one 3xTF32 k-step costs an SM at
// that N and number of warpgroups, the ceiling of the fp32 kernels' products.
// Not a kernel of any path.

template <int N, int K>
__global__ void __launch_bounds__(WG_THREADS)
tf32x3_selfcheck_kernel(const float* __restrict__ a, const float* __restrict__ bp, float* __restrict__ d, int reps) {
  constexpr uint32_t PLANE = N * 16, HALF = (TF_KC / 4) * PLANE, CHUNK = 2 * HALF;
  constexpr int NK = K / TF_KC;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  for (int v = tid; v < NK * (int)CHUNK / 16; v += WG_THREADS) cp_async16(smem_wg + 16 * v, bp + 4 * (size_t)v);
  cp_async_commit();
  uint32_t big[NK][16], small[NK][16];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) v[h][i] = a[(16 * warp + gq + 8 * h) * K + TF_KC * kc + 8 * tq + i];
    tf32_split_frags(v, big[kc], small[kc]);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence_acc(acc);
  const uint32_t b0 = smem_u32(smem_wg);
  for (int rep = 0; rep < reps; ++rep) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NK; ++kc)
#pragma unroll
      for (int s = 0; s < TF_KC / 8; ++s)
        tf32x3_kstep<N>(acc, big[kc], small[kc], b0 + kc * CHUNK, b0 + kc * CHUNK + HALF, PLANE, s,
                        rep == 0 && kc == 0 && s == 0);
    wgmma_commit();
    wgmma_wait<1>();  // one group stays in flight behind the one being started
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
  if (blockIdx.x != 0) return;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(16 * warp + gq + 8 * (e / 2)) * N + 8 * j + 2 * tq + e % 2] = acc[4 * j + e];
}

template <int N, int K>
int launch_tf32x3_selfcheck(const void* a, const void* bp, void* d, int reps, int blocks, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(K / TF_KC) * 2 * (TF_KC / 4) * N * 16;
  if (int err = set_smem(tf32x3_selfcheck_kernel<N, K>, smem)) return err;
  tf32x3_selfcheck_kernel<N, K><<<blocks, WG_THREADS, smem, stream>>>((const float*)a, (const float*)bp, (float*)d, reps);
  return (int)cudaGetLastError();
}

// K1's launches: the body with halo rows (HALO) only where a launch has them, so
// that the single-device path runs the code it ran before halo rows existed.
template <bool HALO>
int launch_dense_layer_f32(const void* x, const void* a1, const void* b1, const void* w1, const void* a2,
                           const void* b2, const void* w2, void* out, int B, int H, int W, int C, int ldx, int ldo,
                           int top, int bot, void* stream) {
  if (int err = set_smem(dense_layer_tf32x3_kernel<HALO>, TF1_SMEM)) return err;
  const long long ntiles = (long long)B * ((H + TF1T::TH - 1) / TF1T::TH) * ((W + TF1T::TW - 1) / TF1T::TW);
  static int resident[MAX_DEVICES] = {};
  int grid = 0;
  if (int err = persistent_grid(dense_layer_tf32x3_kernel<HALO>, TF1_THREADS, TF1_SMEM, ntiles, 1, &grid, resident))
    return err;
  const int vec_out = ldo % 2 == 0 && (uintptr_t)out % 8 == 0;  // float2 stores
  dense_layer_tf32x3_kernel<HALO><<<grid, TF1_THREADS, TF1_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a1, (const float*)b1, (const float*)w1, (const float*)a2,
      (const float*)b2, (const float*)w2, (float*)out, B, H, W, C, ldx, ldo, top, bot, vec_out);
  return (int)cudaGetLastError();
}

template <bool HALO>
int launch_dense_layer_bf16(const void* x, const void* a1, const void* b1, const void* w1, const void* a2,
                            const void* b2, const void* w2, void* out, int B, int H, int W, int C, int ldx, int ldo,
                            int top, int bot, void* stream) {
  if (int err = set_smem(dense_layer_bf16_kernel<HALO>, K1_SMEM)) return err;
  const long long ntiles = (long long)B * ((H + K1T::TH - 1) / K1T::TH) * ((W + K1_TW - 1) / K1_TW);
  static int resident[MAX_DEVICES] = {};
  int grid = 0;
  if (int err = persistent_grid(dense_layer_bf16_kernel<HALO>, K1_THREADS, K1_SMEM, ntiles, 1, &grid, resident))
    return err;
  dense_layer_bf16_kernel<HALO><<<grid, K1_THREADS, K1_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)a1, (const float*)b1, (const bf16*)w1, (const float*)a2,
      (const float*)b2, (const bf16*)w2, (bf16*)out, B, H, W, C, ldx, ldo, top, bot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns a CUDA error code (0 = success): that of its
// set-up calls, or cudaGetLastError() after its launch. x (B,H,W,C) holds
// pixel p at x + p * ldx (ldx >= C), out (B,H,W,32) at out + p * ldo, both in
// the kernel's dtype; a2, b2 (128) are fp32.
// - bf16: a1, b1 (C) fp32; w2r (9,32,128); W1 as w1p (C/8,128,8), planes of
//   eight input channels: w1p[p][n][k] = W1[8p + k][n] (K1), the same with the
//   rows zero-padded to a multiple of 64 and permuted within each 64 into the
//   TW1 order of wgmma_bf16.cuh (fdgan_h_stats_bf16), or W1 transposed, w1t
//   (128,C) (fdgan_h_stats_bf16_mma). C, ldx and ldo multiples of 8, and
//   16-byte aligned x, out, W1, w2r, a1 and b1.
// - fp32: a1, b1 zero-padded to C32 = C rounded up to 32; W1 as
//   w1_tf32x3_planes (C32/32, 2, 8, 128, 4) and W2 as w2_tf32x3_planes (12, 2,
//   8, 96, 4) of ops/dense.py (tf32 big and small planes per chunk, in the
//   order of wgmma_tf32.cuh); C and ldx multiples of 4 and x 16-byte aligned
//   (the wrapper pads x where they are not); any ldo.
// - top, bot: -1, or the pixel index from x of image 0's halo row above
//   (below) its first (last) row, image b's at + b * W (halo_pixel); the rows
//   lie in x's buffer, with its pixel stride.

int fdgan_dense_layer_f32(const void* x, const void* a1, const void* b1, const void* w1,
                          const void* a2, const void* b2, const void* w2, void* out, int B,
                          int H, int W, int C, int ldx, int ldo, int top, int bot, void* stream) {
  return top < 0 && bot < 0
             ? launch_dense_layer_f32<false>(x, a1, b1, w1, a2, b2, w2, out, B, H, W, C, ldx, ldo, top, bot, stream)
             : launch_dense_layer_f32<true>(x, a1, b1, w1, a2, b2, w2, out, B, H, W, C, ldx, ldo, top, bot, stream);
}

int fdgan_dense_layer_bf16(const void* x, const void* a1, const void* b1, const void* w1,
                           const void* a2, const void* b2, const void* w2, void* out, int B,
                           int H, int W, int C, int ldx, int ldo, int top, int bot, void* stream) {
  return top < 0 && bot < 0
             ? launch_dense_layer_bf16<false>(x, a1, b1, w1, a2, b2, w2, out, B, H, W, C, ldx, ldo, top, bot, stream)
             : launch_dense_layer_bf16<true>(x, a1, b1, w1, a2, b2, w2, out, B, H, W, C, ldx, ldo, top, bot, stream);
}

static int tf2_resident[MAX_DEVICES] = {};

static int tf2_grid(int npix, int* grid) {
  if (int err = set_smem(h_stats_tf32x3_kernel, TF2_SMEM)) return err;
  return persistent_grid(h_stats_tf32x3_kernel, TW1_THREADS, TF2_SMEM, (npix + TW1_ROWS - 1) / TW1_ROWS, 1, grid,
                         tf2_resident);
}

// the rows of partials fdgan_h_stats_f32 writes for npix pixels on the current
// device (its grid), or minus a CUDA error code
int fdgan_h_stats_f32_blocks(int npix) {
  int grid = 0;
  if (int err = tf2_grid(npix, &grid)) return -err;
  return grid;
}

// psum, psq: float64 (fdgan_h_stats_f32_blocks(npix), 128); npix = B*H*W
int fdgan_h_stats_f32(const void* x, const void* a1, const void* b1, const void* w1, void* psum,
                      void* psq, int npix, int C, int ldx, void* stream) {
  int grid = 0;
  if (int err = tf2_grid(npix, &grid)) return err;
  h_stats_tf32x3_kernel<<<grid, TW1_THREADS, TF2_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, ldx, (const float*)a1, (const float*)b1, (const float*)w1, (double*)psum, (double*)psq, npix,
      C);
  return (int)cudaGetLastError();
}

static int k2_resident[MAX_DEVICES] = {};

static int k2_grid(int npix, int* grid) {
  if (int err = set_smem(h_stats_bf16_kernel, K2_SMEM)) return err;
  return persistent_grid(h_stats_bf16_kernel, TW1_THREADS, K2_SMEM, (npix + TW1_ROWS - 1) / TW1_ROWS, 1, grid,
                         k2_resident);
}

// the rows of partials fdgan_h_stats_bf16 writes for npix pixels on the current
// device (its grid), or minus a CUDA error code
int fdgan_h_stats_bf16_blocks(int npix) {
  int grid = 0;
  if (int err = k2_grid(npix, &grid)) return -err;
  return grid;
}

// psum, psq: float64 (fdgan_h_stats_bf16_blocks(npix), 128)
int fdgan_h_stats_bf16(const void* x, const void* a1, const void* b1, const void* w1,
                       void* psum, void* psq, int npix, int C, int ldx, void* stream) {
  int grid = 0;
  if (int err = k2_grid(npix, &grid)) return err;
  h_stats_bf16_kernel<<<grid, TW1_THREADS, K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, ldx, (const float*)a1, (const float*)b1, (const bf16*)w1, (double*)psum, (double*)psq, npix, C);
  return (int)cudaGetLastError();
}

// the mma.sync body that the wgmma kernel replaced, kept to time old against
// new in one run; no model path reaches it. psum, psq: fp32 (ceil(npix/192), 128)
int fdgan_h_stats_bf16_mma(const void* x, const void* a1, const void* b1, const void* w1,
                           void* psum, void* psq, int npix, int C, int ldx, void* stream) {
  if (int err = set_smem(h_stats_bf16_mma_kernel, BF_K2_SMEM)) return err;
  h_stats_bf16_mma_kernel<<<(npix + NPIX - 1) / NPIX, THREADS, BF_K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, ldx, (const float*)a1, (const float*)b1, (const bf16*)w1, (float*)psum,
      (float*)psq, npix, C);
  return (int)cudaGetLastError();
}

int fdgan_h_stats_rows(void) { return NPIX; }

// K2's tw1_stamps (wgmma_bf16.cuh) into out (16 values), then zeroed where
// reset; cudaErrorNotSupported unless the library was built with -DFDGAN_TW1_STAMPS
int fdgan_tw1_stamps(void* out, int reset) {
#ifdef FDGAN_TW1_STAMPS
  if (int err = (int)cudaMemcpyFromSymbol(out, tw1_stamps, sizeof(tw1_stamps))) return err;
  if (reset) {
    const unsigned long long zeros[16] = {};
    if (int err = (int)cudaMemcpyToSymbol(tw1_stamps, zeros, sizeof(tw1_stamps))) return err;
  }
  return 0;
#else
  (void)out, (void)reset;
  return (int)cudaErrorNotSupported;
#endif
}

// d (64, n) fp32 = reps * a . b for fp32 a (64, k) and b as w1_tf32x3_planes lays
// it out, (k/32, 2, 8, n, 4); n 96 or 128, k 32 or 64; every one of ``blocks``
// blocks computes it, block 0 writes it
int fdgan_tf32x3_selfcheck(const void* a, const void* bp, void* d, int n, int k, int reps, int blocks, void* stream) {
  if (reps < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 96 && k == 32) return launch_tf32x3_selfcheck<96, 32>(a, bp, d, reps, blocks, st);
  if (n == 96 && k == 64) return launch_tf32x3_selfcheck<96, 64>(a, bp, d, reps, blocks, st);
  if (n == 128 && k == 32) return launch_tf32x3_selfcheck<128, 32>(a, bp, d, reps, blocks, st);
  if (n == 128 && k == 64) return launch_tf32x3_selfcheck<128, 64>(a, bp, d, reps, blocks, st);
  return (int)cudaErrorInvalidValue;
}

const char* fdgan_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
