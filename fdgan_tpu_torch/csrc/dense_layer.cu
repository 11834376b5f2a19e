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
//     per-block fp32 partial sums of h and h*h over the block's pixels, for
//     norm2's batch statistics. No atomics: every block writes its own row of
//     a (n_blocks, 128) buffer and the wrapper reduces the rows in float64,
//     so the result does not depend on block scheduling. K1 consumes the
//     statistics K2 produces, so K2 must finish over the whole batch before
//     K1 starts; it cannot ride K1's epilogue.
//
// What bounds them on an H100: K1 does 2*C*128 + 2*9*128*32 FLOP per output
// pixel against C+32 values read and written. In bf16 that is ~470 FLOP per
// byte at C = 64 (dense block 1), above the card's ridge of ~295: block 1 is
// bound by tensor-core throughput; at C = 256..992 (block 3) it falls to
// 240..160 FLOP/B, below the ridge: memory-bound. The design keeps h and g on
// chip (the Pallas kernel's point), reads x once per block plus a one-pixel
// halo ring (180 GEMM1 rows for 128 outputs), and writes only the 32 new
// channels.
// - bf16: both GEMMs run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), fragments read straight from padded shared-memory rows;
//   operands are staged in 16-byte vectors with the next chunk prefetched
//   into registers, and two blocks share an SM. At the encoder's shapes this
//   version reaches 9-13 % of the bf16 roofline on an H100 80GB HBM3 at
//   700 W (PERF.md). The likely limits, not yet profiled per instruction:
//   mma.sync issue (wgmma is Hopper's full rate), the shared-memory fragment
//   loads, and the block-wide barriers between stages.
// - fp32: plain FMAs on the CUDA cores, so fp32 keeps full precision (no
//   TF32); its bound is the shared-memory read rate of the register-tiled
//   GEMM loops. It serves checkpoint-parity runs, not the serving default.
//
// Tiles: one 256-thread block per 8x16 output tile (K1) or per 192 flat
// pixels (K2); x is staged 32 channels at a time; the ragged last chunk of C
// is zero-filled. Both kernels take NHWC-contiguous x.

#include "mma_bf16.cuh"

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
// for rows whose pix is -1. pix must be written before the call.
__device__ __forceinline__ void gemm1_f32(const float* __restrict__ x, const float* __restrict__ a1,
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
        ts[k * TS_LD + row] = (cok && gp >= 0) ? fmaxf(x[(size_t)gp * C + c] * a + b, 0.f) : 0.f;
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
                       const float* __restrict__ w2, float* __restrict__ out, int H, int W, int C) {
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
  gemm1_f32(x, a1, b1, w1, C, pix, ts, w1s, acc);

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
      float* o = out + ((size_t)(b * H + oy) * W + ox) * GROWTH;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[fq + 8 * j] = acc2[m][j];
    }
  }
}

// K2, fp32. Grid (ceil(npix/192)); block n covers flat pixels [192n, 192n+192).
__global__ void __launch_bounds__(THREADS)
h_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ a1,
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
  gemm1_f32(x, a1, b1, w1, C, pix, ts, w1s, acc);

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

// --- the bf16 path: tensor cores ----------------------------------------------
//
// Warp w of 8, lane = 4*gq + tq. GEMM1 (192 x 128, K = C) is gemm1_bf16<3>
// of mma_bf16.cuh: warp w owns rows 48*(w%4) .. +48 (three m16 tiles) and
// columns 64*(w/4) .. +64 (eight n8 tiles). GEMM2 (128 x 32, K = 9*128):
// warp w owns output row w of the tile (one m16 tile: pixels x = gq and
// gq+8) and all four n8 tiles.
// Operands are staged in 16-byte vectors, and the next chunk of x and W1 (or
// the next W2 tap) is loaded into registers while the tensor cores work on
// the current one. Shared rows are padded by 8 bf16 (16 bytes) so that the
// eight rows a fragment load touches fall in distinct banks. C must be a
// multiple of 8 (every dense layer's is a multiple of 32).
// Weights arrive as w1t (128, C) = W1 transposed, and w2r (9, 32, 128) =
// per tap, per output channel, the 128 inputs: both are torch's OIHW order.

constexpr int GB_LD = INTER + 8;    // g [row][i] and one W2 tap [f][i], in bf16
constexpr int BF_GS = NPIX * GB_LD;         // bf16 elements
constexpr int BF_TS = NPIX * TB_LD;
constexpr int BF_W1S = INTER * TB_LD;
constexpr size_t BF_K1_SMEM = 2 * (BF_GS + BF_TS + BF_W1S) + 4 * NPIX;
constexpr size_t BF_K2_SMEM = 2 * (BF_TS + BF_W1S) + 4 * NPIX;
static_assert(GROWTH * GB_LD <= BF_TS, "a W2 tap must fit in the t staging area");
static_assert(2 * 4 * INTER * 2 <= BF_TS, "K2's reduction (fp32) must fit in the t staging area");
static_assert(NPIX == 3 * 64 && NPIX * (KC / 8) == 3 * THREADS && INTER * (KC / 8) == 2 * THREADS &&
                  GROWTH * (INTER / 8) == 2 * THREADS,
              "each thread stages 3 x vectors, 2 W1 vectors and 2 W2 vectors");

// K1, bf16. Grid (ceil(W/16), ceil(H/8), B).
__global__ void __launch_bounds__(THREADS, 2)
dense_layer_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a1,
                        const float* __restrict__ b1, const bf16* __restrict__ w1t,
                        const float* __restrict__ a2, const float* __restrict__ b2,
                        const bf16* __restrict__ w2r, bf16* __restrict__ out, int H, int W, int C) {
  extern __shared__ float smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* ts = gs + BF_GS;
  bf16* w1s = ts + BF_TS;
  int* pix = reinterpret_cast<int*>(w1s + BF_W1S);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  halo_pixels(pix, b, y0, x0, H, W);

  float acc[3][8][4];
  gemm1_bf16<3>([=](int gp, int c) { return x + (size_t)gp * C + c; }, a1, b1, w1t, C, pix, ts,
                w1s, acc);

  // the first W2 tap loads while the epilogue runs: f = sr2 + 16*r, inputs 8*iq ..
  const int sr2 = tid / 16, iq = tid % 16;
  uint4 w2v[2];
  auto fetch_tap = [&](int tap) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      w2v[r] = *reinterpret_cast<const uint4*>(w2r + ((size_t)tap * GROWTH + sr2 + 16 * r) * INTER + 8 * iq);
  };
  fetch_tap(0);

  // g = round(relu(a2*h + b2)), exactly 0 outside the image: that is conv2's
  // zero padding (a zero x there would leak relu(b1), relu(b2))
  {
    const int m0 = 48 * (warp % 4), n0 = 64 * (warp / 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = n0 + 8 * j + 2 * tq;
      const float a[2] = {a2[i], a2[i + 1]}, bb[2] = {b2[i], b2[i + 1]};
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + 16 * mi + gq + 8 * half;
          const bool in = pix[row] >= 0;
          const float lo = in ? fmaxf(acc[mi][j][2 * half] * a[0] + bb[0], 0.f) : 0.f;
          const float hi = in ? fmaxf(acc[mi][j][2 * half + 1] * a[1] + bb[1], 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(gs + row * GB_LD + i) = pack_pair(lo, hi);
        }
    }
  }

  float acc2[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;

  bf16* w2s = ts;  // one W2 tap at a time, [f][i], in the t staging area
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // g is written / the previous tap is consumed
#pragma unroll
    for (int r = 0; r < 2; ++r) *reinterpret_cast<uint4*>(w2s + (sr2 + 16 * r) * GB_LD + 8 * iq) = w2v[r];
    __syncthreads();
    if (tap < 8) fetch_tap(tap + 1);
    const int dy = tap / 3, dx = tap % 3;
    const bf16* g_lo = gs + ((warp + dy) * HALO_W + gq + dx) * GB_LD + 2 * tq;  // pixel x = gq
    const bf16* g_hi = g_lo + 8 * GB_LD;                                          // pixel x = gq + 8
#pragma unroll
    for (int ks = 0; ks < INTER; ks += 16) {
      const uint32_t afr[4] = {ld_pair(g_lo + ks), ld_pair(g_hi + ks), ld_pair(g_lo + ks + 8),
                               ld_pair(g_hi + ks + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = w2s + (8 * j + gq) * GB_LD + ks + 2 * tq;
        const uint32_t bfr[2] = {ld_pair(p), ld_pair(p + 8)};
        mma_bf16_16816(acc2[j], afr, bfr);
      }
    }
  }

  const int oy = y0 + warp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ox = x0 + gq + 8 * half;
    if (oy < H && ox < W) {
      bf16* o = out + ((size_t)(b * H + oy) * W + ox) * GROWTH + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_pair(acc2[j][2 * half], acc2[j][2 * half + 1]);
    }
  }
}

// K2, bf16. Grid (ceil(npix/192)).
__global__ void __launch_bounds__(THREADS, 2)
h_stats_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a1,
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
  gemm1_bf16<3>([=](int gp, int c) { return x + (size_t)gp * C + c; }, a1, b1, w1t, C, pix, ts,
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

}  // namespace

extern "C" {

// Every entry point returns cudaGetLastError() after its launch (0 = success).
// x (B,H,W,C) and out (B,H,W,32) are contiguous in the kernel's dtype; a1, b1
// (C) and a2, b2 (128) are fp32. The f32 kernels take w1 (C,128) and
// w2 (9*128,32); the bf16 kernels take w1t (128,C) and w2r (9,32,128), and
// need C % 8 == 0 and 16-byte aligned x, w1t, w2r, a1 and b1.

int fdgan_dense_layer_f32(const void* x, const void* a1, const void* b1, const void* w1,
                          const void* a2, const void* b2, const void* w2, void* out, int B,
                          int H, int W, int C, void* stream) {
  if (int err = set_smem(dense_layer_f32_kernel, F32_K1_SMEM)) return err;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dense_layer_f32_kernel<<<grid, THREADS, F32_K1_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a1, (const float*)b1, (const float*)w1, (const float*)a2,
      (const float*)b2, (const float*)w2, (float*)out, H, W, C);
  return (int)cudaGetLastError();
}

int fdgan_dense_layer_bf16(const void* x, const void* a1, const void* b1, const void* w1,
                           const void* a2, const void* b2, const void* w2, void* out, int B,
                           int H, int W, int C, void* stream) {
  if (int err = set_smem(dense_layer_bf16_kernel, BF_K1_SMEM)) return err;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dense_layer_bf16_kernel<<<grid, THREADS, BF_K1_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)a1, (const float*)b1, (const bf16*)w1, (const float*)a2,
      (const float*)b2, (const bf16*)w2, (bf16*)out, H, W, C);
  return (int)cudaGetLastError();
}

// psum, psq: fp32 (ceil(npix/192), 128); npix = B*H*W
int fdgan_h_stats_f32(const void* x, const void* a1, const void* b1, const void* w1, void* psum,
                      void* psq, int npix, int C, void* stream) {
  if (int err = set_smem(h_stats_f32_kernel, F32_K2_SMEM)) return err;
  h_stats_f32_kernel<<<(npix + NPIX - 1) / NPIX, THREADS, F32_K2_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a1, (const float*)b1, (const float*)w1, (float*)psum,
      (float*)psq, npix, C);
  return (int)cudaGetLastError();
}

int fdgan_h_stats_bf16(const void* x, const void* a1, const void* b1, const void* w1,
                       void* psum, void* psq, int npix, int C, void* stream) {
  if (int err = set_smem(h_stats_bf16_kernel, BF_K2_SMEM)) return err;
  h_stats_bf16_kernel<<<(npix + NPIX - 1) / NPIX, THREADS, BF_K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)a1, (const float*)b1, (const bf16*)w1, (float*)psum,
      (float*)psq, npix, C);
  return (int)cudaGetLastError();
}

int fdgan_h_stats_rows(void) { return NPIX; }

const char* fdgan_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
