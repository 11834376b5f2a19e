// Hand-written Hopper kernels for the FDGAN encoder's DenseNet layer.
//
// K1  fdgan_dense_layer_{f32,bf16}
//     Replaces fdgan_tpu/ops/pallas_dense.py::_fused_layer_pallas (kernel
//     body _layer_kernel). One DenseNet-121 layer, fused:
//         t = relu(a1*x + b1)             rounded to x's dtype
//         h = t . W1                      1x1 conv C -> 128, fp32 accumulation
//         g = relu(a2*h + b2)             rounded to x's dtype; 0 outside the image
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
// What bounds them on an H100: K1 does 2*C*128 + 2*9*128*32 FLOP per output
// pixel against C+32 values read and written. In bf16 that is ~470 FLOP per
// byte at C = 64 (dense block 1), above the card's ridge of ~295: block 1 is
// bound by tensor-core throughput; at C = 256..992 (block 3) it falls to
// 240..160 FLOP/B, below the ridge: memory-bound. The design keeps h and g on
// chip (the Pallas kernel's point), reads x once per tile plus a one-pixel
// halo ring (180 rows of t.W1 for 128 outputs), and writes only the 32 new
// channels. K2 does 128 FLOP per byte at every C: bound by reading x.
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
//   float64 total per column and block. One row of partials per block. Its
//   mma.sync body (h_stats_bf16_mma_kernel: 192-pixel blocks, W1 restaged
//   from L2 in 32-channel chunks with block barriers, fragments loaded by
//   every warp, one row of partials per 192 pixels) is kept to time old
//   against new; no model path reaches it.
// - fp32: plain FMAs on the CUDA cores, so fp32 keeps full precision (no
//   TF32); its bound is the shared-memory read rate of the register-tiled
//   GEMM loops. It serves checkpoint-parity runs, not the serving default.
//
// Tiles: an 8x16 output tile (K1; a 256-thread block each in fp32, walked by
// persistent 384-thread blocks in bf16), 192 flat pixels per 256-thread block
// (fp32 K2 and the mma.sync K2) or 128 flat pixels walked by persistent
// 256-thread blocks (bf16 K2); the ragged last chunk of C is zero-filled.

#include "wgmma_bf16.cuh"

namespace {

using namespace fdgan_dev;  // bf16, INTER, GROWTH, THREADS, KC, the mma.sync helpers, gemm1_bf16

constexpr int TILE_H = 8;    // K1 output tile: 8 x 16 pixels
constexpr int TILE_W = 16;
constexpr int HALO_W = TILE_W + 2;                  // 18
constexpr int HALO_PIX = (TILE_H + 2) * HALO_W;     // 180
constexpr int NPIX = 192;    // GEMM1 rows per block (180 halo pixels, padded)

// --- the fp32 path: CUDA-core FMAs ------------------------------------------

constexpr int ROWS_PER_T = NPIX / 16;               // 12 GEMM1 rows per thread
constexpr int CH_PER_T = INTER / 16;                // 8 GEMM1 columns per thread
constexpr int TS_LD = NPIX + 1;   // padded strides keep shared reads conflict-free
constexpr int GS_LD = INTER + 1;
// shared-memory layout, in 4-byte words
constexpr int GS_WORDS = NPIX * GS_LD;     // g of the halo tile (K1 only)
constexpr int TS_WORDS = KC * TS_LD;       // t chunk, [k][row]
constexpr int W1S_WORDS = KC * INTER;      // W1 chunk, [k][i]
constexpr size_t F32_K1_SMEM = 4 * (GS_WORDS + TS_WORDS + W1S_WORDS + NPIX);
constexpr size_t F32_K2_SMEM = 4 * (TS_WORDS + W1S_WORDS + NPIX);
static_assert(INTER * GROWTH <= TS_WORDS, "a W2 tap must fit in the t staging area");
static_assert(2 * 16 * INTER <= TS_WORDS, "K2's reduction must fit in the t staging area");

// acc[r][j] = h[row][col] for the thread's rows row = pg + 16*r and columns
// col = cg + 16*j, where h[row] = relu(a1*x[pix[row]] + b1) . W1 and h = 0
// for rows whose pix is -1; pixel p of x starts at x + p * ldx. pix must be
// written before the call.
__device__ __forceinline__ void gemm1_f32(const float* __restrict__ x, int ldx, const float* __restrict__ a1,
                                          const float* __restrict__ b1, const float* __restrict__ w1,
                                          int C, const int* pix, float* ts, float* w1s,
                                          float acc[ROWS_PER_T][CH_PER_T]) {
  const int tid = threadIdx.x;
  const int pg = tid / 16, cg = tid % 16;
#pragma unroll
  for (int r = 0; r < ROWS_PER_T; ++r)
#pragma unroll
    for (int j = 0; j < CH_PER_T; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // pix is written / the previous chunk is consumed
    {
      const int k = tid % KC;
      const int c = c0 + k;
      const bool cok = c < C;
      const float a = cok ? a1[c] : 0.f;
      const float b = cok ? b1[c] : 0.f;
      for (int row = tid / KC; row < NPIX; row += THREADS / KC) {
        const int gp = pix[row];
        ts[k * TS_LD + row] = (cok && gp >= 0) ? fmaxf(x[(size_t)gp * ldx + c] * a + b, 0.f) : 0.f;
      }
    }
    for (int e = tid; e < KC * INTER; e += THREADS) {
      const int c = c0 + e / INTER;
      w1s[e] = c < C ? w1[(size_t)c0 * INTER + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float tv[ROWS_PER_T], wv[CH_PER_T];
#pragma unroll
      for (int r = 0; r < ROWS_PER_T; ++r) tv[r] = ts[k * TS_LD + pg + 16 * r];
#pragma unroll
      for (int j = 0; j < CH_PER_T; ++j) wv[j] = w1s[k * INTER + cg + 16 * j];
#pragma unroll
      for (int r = 0; r < ROWS_PER_T; ++r)
#pragma unroll
        for (int j = 0; j < CH_PER_T; ++j) acc[r][j] = fmaf(tv[r], wv[j], acc[r][j]);
    }
  }
}

// halo row r of the tile at (y0, x0) is image pixel (y0 - 1 + r / 18, x0 - 1 + r % 18)
__device__ __forceinline__ void halo_pixels(int* pix, int b, int y0, int x0, int H, int W) {
  for (int row = threadIdx.x; row < NPIX; row += THREADS) {
    int gp = -1;
    if (row < HALO_PIX) {
      const int iy = y0 - 1 + row / HALO_W, ix = x0 - 1 + row % HALO_W;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) gp = (b * H + iy) * W + ix;
    }
    pix[row] = gp;
  }
}

// K1, fp32. Grid (ceil(W/16), ceil(H/8), B).
__global__ void __launch_bounds__(THREADS)
dense_layer_f32_kernel(const float* __restrict__ x, const float* __restrict__ a1,
                       const float* __restrict__ b1, const float* __restrict__ w1,
                       const float* __restrict__ a2, const float* __restrict__ b2,
                       const float* __restrict__ w2, float* __restrict__ out, int H, int W, int C, int ldx,
                       int ldo) {
  extern __shared__ float smem[];
  float* gs = smem;
  float* ts = gs + GS_WORDS;
  float* w1s = ts + TS_WORDS;
  int* pix = reinterpret_cast<int*>(w1s + W1S_WORDS);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  halo_pixels(pix, b, y0, x0, H, W);

  float acc[ROWS_PER_T][CH_PER_T];
  gemm1_f32(x, ldx, a1, b1, w1, C, pix, ts, w1s, acc);

  // g = relu(a2*h + b2), exactly 0 outside the image: that is conv2's zero
  // padding (a zero x there would leak relu(b1), relu(b2) through the affines)
  {
    const int pg = tid / 16, cg = tid % 16;
#pragma unroll
    for (int j = 0; j < CH_PER_T; ++j) {
      const int i = cg + 16 * j;
      const float a = a2[i], bb = b2[i];
#pragma unroll
      for (int r = 0; r < ROWS_PER_T; ++r) {
        const int row = pg + 16 * r;
        gs[row * GS_LD + i] = pix[row] >= 0 ? fmaxf(acc[r][j] * a + bb, 0.f) : 0.f;
      }
    }
  }

  // GEMM2: thread owns output pixels q = qg + 32*m and channels f = fq + 8*j
  const int fq = tid % 8, qg = tid / 8;
  float acc2[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[m][j] = 0.f;

  float* w2s = ts;  // one W2 tap at a time, in the t staging area
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // g is written / the previous tap is consumed
    for (int e = tid; e < INTER * GROWTH; e += THREADS) w2s[e] = w2[(size_t)tap * INTER * GROWTH + e];
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    int base[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = qg + 32 * m;
      base[m] = ((q / TILE_W + dy) * HALO_W + q % TILE_W + dx) * GS_LD;
    }
#pragma unroll 4
    for (int i = 0; i < INTER; ++i) {
      float gv[4], wv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) gv[m] = gs[base[m] + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w2s[i * GROWTH + fq + 8 * j];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[m][j] = fmaf(gv[m], wv[j], acc2[m][j]);
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int q = qg + 32 * m;
    const int oy = y0 + q / TILE_W, ox = x0 + q % TILE_W;
    if (oy < H && ox < W) {
      float* o = out + ((size_t)(b * H + oy) * W + ox) * ldo;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[fq + 8 * j] = acc2[m][j];
    }
  }
}

// K2, fp32. Grid (ceil(npix/192)); block n covers flat pixels [192n, 192n+192).
__global__ void __launch_bounds__(THREADS)
h_stats_f32_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ a1,
                   const float* __restrict__ b1, const float* __restrict__ w1,
                   float* __restrict__ psum, float* __restrict__ psq, int npix, int C) {
  extern __shared__ float smem[];
  float* ts = smem;
  float* w1s = ts + TS_WORDS;
  int* pix = reinterpret_cast<int*>(w1s + W1S_WORDS);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * NPIX;
  for (int row = tid; row < NPIX; row += THREADS) pix[row] = p0 + row < npix ? p0 + row : -1;

  float acc[ROWS_PER_T][CH_PER_T];
  gemm1_f32(x, ldx, a1, b1, w1, C, pix, ts, w1s, acc);

  // rows past the end hold h = 0, so they add nothing to either sum
  const int pg = tid / 16, cg = tid % 16;
  float* red = ts;  // [2][16][INTER]
  __syncthreads();  // every thread is done reading ts
#pragma unroll
  for (int j = 0; j < CH_PER_T; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS_PER_T; ++r) {
      s += acc[r][j];
      q = fmaf(acc[r][j], acc[r][j], q);
    }
    red[pg * INTER + cg + 16 * j] = s;
    red[(16 + pg) * INTER + cg + 16 * j] = q;
  }
  __syncthreads();
  if (tid < INTER) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < 16; ++r) {
      s += red[r * INTER + tid];
      q += red[(16 + r) * INTER + tid];
    }
    psum[(size_t)blockIdx.x * INTER + tid] = s;
    psq[(size_t)blockIdx.x * INTER + tid] = q;
  }
}

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

__global__ void __launch_bounds__(K1_THREADS, 1)
dense_layer_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a1,
                        const float* __restrict__ b1, const bf16* __restrict__ w1p,
                        const float* __restrict__ a2, const float* __restrict__ b2,
                        const bf16* __restrict__ w2r, bf16* __restrict__ out, int B, int H, int W, int C,
                        int ldx, int ldo) {
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
constexpr size_t K2_SMEM = K2S::BYTES + K2_WARPS * 2 * INTER * sizeof(float);
static_assert(K2_SMEM <= 232448, "a block's shared memory");
static_assert(TW1_THREADS == 2 * INTER, "a thread per (statistic, column) keeps the block's float64 total");

__global__ void __launch_bounds__(TW1_THREADS, 1)
h_stats_bf16_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ a1, const float* __restrict__ b1,
                    const bf16* __restrict__ w1p, double* __restrict__ psum, double* __restrict__ psq, int npix,
                    int C) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  float* red = reinterpret_cast<float*>(smem_wg + K2S::BYTES);  // [warp][statistic][column]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tq = lane % 4;

  float run[64];  // run[2j + e]: sum of h at column 8j + 2tq + e over the thread's rows; run[32 + 2j + e]: of h*h
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.f;
  double total = 0.0;  // statistic tid / 128 of column tid % 128 over the block's tiles
  int since_flush = 0;
  auto flush = [&]() {
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
  };
  auto accumulate = [&](const float (&acc)[64], int) {
#pragma unroll
    for (int j = 0; j < INTER / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];  // rows gq and gq + 8
        run[2 * j + e] += v0 + v1;
        run[32 + 2 * j + e] = fmaf(v1, v1, fmaf(v0, v0, run[32 + 2 * j + e]));
      }
    if (++since_flush == K2_FLUSH) {  // the same count in every thread: the barriers inside are reached by all
      flush();
      since_flush = 0;
    }
  };
  tw1_stream<K2_RES>(StridedX{x, ldx}, a1, b1, w1p, npix, C, smem_wg, accumulate);
  if (since_flush > 0) flush();
  (tid < INTER ? psum : psq)[(size_t)blockIdx.x * INTER + tid % INTER] = total;
}

}  // namespace

extern "C" {

// Every entry point returns a CUDA error code (0 = success): that of its
// set-up calls, or cudaGetLastError() after its launch. x (B,H,W,C) holds
// pixel p at x + p * ldx (ldx >= C), out (B,H,W,32) at out + p * ldo, both in
// the kernel's dtype; a1, b1 (C) and a2, b2 (128) are fp32. The f32 kernels
// take w1 (C,128) and w2 (9*128,32); the bf16 kernels take w2r (9,32,128)
// and W1 as w1p (C/8,128,8), planes of eight input channels: w1p[p][n][k] =
// W1[8p + k][n] (K1), the same with the rows zero-padded to a multiple of
// 64 and permuted within each 64 into the TW1 order of wgmma_bf16.cuh
// (fdgan_h_stats_bf16), or W1 transposed, w1t (128,C)
// (fdgan_h_stats_bf16_mma). The bf16 kernels need C, ldx and ldo multiples of 8 and 16-byte
// aligned x, out, W1, w2r, a1 and b1.

int fdgan_dense_layer_f32(const void* x, const void* a1, const void* b1, const void* w1,
                          const void* a2, const void* b2, const void* w2, void* out, int B,
                          int H, int W, int C, int ldx, int ldo, void* stream) {
  if (int err = set_smem(dense_layer_f32_kernel, F32_K1_SMEM)) return err;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dense_layer_f32_kernel<<<grid, THREADS, F32_K1_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a1, (const float*)b1, (const float*)w1, (const float*)a2,
      (const float*)b2, (const float*)w2, (float*)out, H, W, C, ldx, ldo);
  return (int)cudaGetLastError();
}

int fdgan_dense_layer_bf16(const void* x, const void* a1, const void* b1, const void* w1,
                           const void* a2, const void* b2, const void* w2, void* out, int B,
                           int H, int W, int C, int ldx, int ldo, void* stream) {
  if (int err = set_smem(dense_layer_bf16_kernel, K1_SMEM)) return err;
  const long long ntiles = (long long)B * ((H + K1T::TH - 1) / K1T::TH) * ((W + K1_TW - 1) / K1_TW);
  static int resident[MAX_DEVICES] = {};
  int grid = 0;
  if (int err = persistent_grid(dense_layer_bf16_kernel, K1_THREADS, K1_SMEM, ntiles, 1, &grid, resident)) return err;
  dense_layer_bf16_kernel<<<grid, K1_THREADS, K1_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)a1, (const float*)b1, (const bf16*)w1, (const float*)a2,
      (const float*)b2, (const bf16*)w2, (bf16*)out, B, H, W, C, ldx, ldo);
  return (int)cudaGetLastError();
}

// psum, psq: fp32 (ceil(npix/192), 128); npix = B*H*W
int fdgan_h_stats_f32(const void* x, const void* a1, const void* b1, const void* w1, void* psum,
                      void* psq, int npix, int C, int ldx, void* stream) {
  if (int err = set_smem(h_stats_f32_kernel, F32_K2_SMEM)) return err;
  h_stats_f32_kernel<<<(npix + NPIX - 1) / NPIX, THREADS, F32_K2_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, ldx, (const float*)a1, (const float*)b1, (const float*)w1, (float*)psum,
      (float*)psq, npix, C);
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

const char* fdgan_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
