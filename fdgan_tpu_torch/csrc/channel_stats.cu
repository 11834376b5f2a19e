// Hand-written Hopper kernel for the batch statistics of bf16 activations.
//
// channel_stats  fdgan_channel_stats_bf16
//     Replaces no Pallas kernel: on the TPU this is XLA's fused reduction of
//     fdgan_tpu/nn/layers.py::_batch_stats (:125-145), written so that no fp32
//     copy of x exists. From NHWC bf16 x (npix pixels of C channels, pixel p
//     at p*ld elements: x may be a channel slice of a dense block's concat)
//     it writes the per-channel fp32 mean and biased variance, by the
//     one-pass E[x^2] - mean^2 clamped at 0 (the bf16 branch of _batch_stats;
//     its plain twin is ops/stats.py::one_pass_reference).
//
// What bounds it on an H100: memory. Each element is read once and costs two
// additions, so the bound is npix*C*2 bytes at 3.35 TB/s. What the design
// does about it:
//   - each thread owns 8 consecutive channels (one 16-byte vector) of a fixed
//     channel group and walks pixels; the threads of a warp that share a
//     pixel read its channels as one run, so a 32-channel slice of a wider
//     buffer is read as whole 64-byte runs and nothing else of the buffer;
//   - the vectors come in by cp.async into a per-thread ring of STAGES tiles
//     in shared memory, STAGES-1 tiles ahead: no registers hold data in
//     flight, and since a thread reads back only what it copied itself, no
//     block barrier is needed until the end;
//   - the sums of x and x*x stay in fp32 registers (16 a thread, constant
//     indices: no stack frame, check ptxas -v), over the ~tens of pixels a
//     thread sees; a block reduces them by warp shuffles and shared memory
//     and writes one float64 row of partials per block;
//   - a second, small kernel reduces the rows in float64 (eight threads a
//     channel, then their sums in order) and writes mean and variance: at 2 M pixels E[x^2] - mean^2 in fp32 would
//     lose the variance to cancellation (as K2 in dense_layer.cu), and the
//     fixed order gives the same bits on every launch.
// Channels beyond 256 are further windows of 256 (blockIdx.y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fdgan_dev::bf16;

constexpr int THREADS = 256;
constexpr int WINDOW = 256;     // channels a block reduces: 32 groups of 8
constexpr int PASSES = 2;       // 16-byte vectors a thread copies per tile
constexpr int STAGES = 4;       // tiles in a thread's ring
constexpr size_t SMEM = (size_t)STAGES * PASSES * THREADS * 16;  // 32 KB: no opt-in attribute
constexpr int MAX_PER_SM = 4;  // ~100 KB of copies in flight per SM; fewer rows of partials to reduce
constexpr int FINISH_SLICES = 8;  // threads per channel in the reduction of the partials

int g_resident[fdgan_dev::MAX_DEVICES];  // blocks the card runs at once, by device

// channel groups of 8 in window w, and the power of two of threads that
// share a pixel (at least that many groups)
__host__ __device__ inline int window_groups(int C, int w) {
  const int cw = C - w * WINDOW;
  return (cw < WINDOW ? cw : WINDOW) / 8;
}
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n) : "memory");
}

__global__ void __launch_bounds__(THREADS)
channel_stats_kernel(const bf16* __restrict__ x, double* __restrict__ part, int npix, int C, int ld) {
  extern __shared__ __align__(16) uint4 ring[];  // [STAGES][PASSES][THREADS]
  const int tid = threadIdx.x, w = blockIdx.y;
  const int ng = window_groups(C, w), tpg = pow2_at_least(ng);
  const int g = tid % tpg, pr = tid / tpg;  // channel group, pixel of the pass
  const int ppp = THREADS / tpg;            // pixels per pass
  const int tile_px = ppp * PASSES;
  const int tiles = (npix + tile_px - 1) / tile_px;
  const bool active = g < ng;
  const bf16* xg = x + w * WINDOW + g * 8;

  auto issue = [&](int tile, int stage) {
    if (active && tile < tiles) {
#pragma unroll
      for (int r = 0; r < PASSES; ++r) {
        const int p = tile * tile_px + r * ppp + pr;
        const bool valid = p < npix;
        cp_async16_zfill(&ring[(stage * PASSES + r) * THREADS + tid], xg + (size_t)(valid ? p : 0) * ld, valid);
      }
    }
    fdgan_dev::cp_async_commit();  // an empty group past the last tile keeps the count
  };

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;

  const int step = gridDim.x;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(blockIdx.x + k * step, k);
  for (int k = 0, tile = blockIdx.x; tile < tiles; ++k, tile += step) {
    fdgan_dev::cp_async_wait<STAGES - 2>();  // this thread's copies of tile k have landed
    const int stage = k % STAGES;
    if (active) {
#pragma unroll
      for (int r = 0; r < PASSES; ++r) {  // past npix the vectors are zeros: they add nothing
        const uint4 v = ring[(stage * PASSES + r) * THREADS + tid];
        const uint32_t wds[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = __uint_as_float(wds[j] << 16), hi = __uint_as_float(wds[j] & 0xffff0000u);
          s[2 * j] += lo;
          q[2 * j] = fmaf(lo, lo, q[2 * j]);
          s[2 * j + 1] += hi;
          q[2 * j + 1] = fmaf(hi, hi, q[2 * j + 1]);
        }
      }
    }
    // into the stage consumed one iteration ago: its reads are behind us in program order
    issue(tile + (STAGES - 1) * step, (k + STAGES - 1) % STAGES);
  }
  fdgan_dev::cp_async_wait<0>();

  // the threads of a warp with the same group are lanes g, g + tpg, ...
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    for (int off = tpg; off < 32; off <<= 1) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
    }
  }
  __syncthreads();  // every thread is done with the ring: reuse it for the warps' sums
  float* red = reinterpret_cast<float*>(ring);  // [warp][group][s 8, q 8]
  const int warp = tid / 32, lane = tid % 32;
  if (lane < tpg && active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(warp * 32 + g) * 16 + j] = s[j];
      red[(warp * 32 + g) * 16 + 8 + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < ng * 8) {  // channel w*256 + tid: the warps' sums in float64, in warp order
    const int gg = tid / 8, j = tid % 8;
    double ds = 0.0, dq = 0.0;
    for (int wp = 0; wp < THREADS / 32; ++wp) {
      ds += (double)red[(wp * 32 + gg) * 16 + j];
      dq += (double)red[(wp * 32 + gg) * 16 + 8 + j];
    }
    const size_t row = (size_t)blockIdx.x * C + w * WINDOW + tid;
    part[row] = ds;
    part[(size_t)gridDim.x * C + row] = dq;
  }
}

// out[c] = mean, out[C + c] = biased variance, from rows of float64 partials:
// a block takes 32 channels, FINISH_SLICES threads per channel each sum every
// FINISH_SLICES-th row, then the slices are added in their order (fixed, so
// the same bits on every launch)
__global__ void __launch_bounds__(32 * FINISH_SLICES)
channel_stats_finish_kernel(const double* __restrict__ part, float* __restrict__ out, int rows, int C, int npix) {
  __shared__ double red[2][FINISH_SLICES][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  double s = 0.0, q = 0.0;
  if (c < C) {
#pragma unroll 4
    for (int r = slice; r < rows; r += FINISH_SLICES) {
      s += part[(size_t)r * C + c];
      q += part[(size_t)(rows + r) * C + c];
    }
  }
  red[0][slice][lane] = s;
  red[1][slice][lane] = q;
  __syncthreads();
  if (slice == 0 && c < C) {
    for (int i = 1; i < FINISH_SLICES; ++i) {
      s += red[0][i][lane];
      q += red[1][i][lane];
    }
    const double mean = s / npix, var = q / npix - mean * mean;
    out[c] = (float)mean;
    out[C + c] = (float)(var > 0.0 ? var : 0.0);
  }
}

int grid_x(int npix, int C, int* gx) {
  const int windows = (C + WINDOW - 1) / WINDOW;
  const int tile_px = THREADS / pow2_at_least(window_groups(C, 0)) * PASSES;
  const long long tiles = ((long long)npix + tile_px - 1) / tile_px;
  int blocks = 0;
  if (int err = fdgan_dev::persistent_grid(channel_stats_kernel, THREADS, SMEM, 1LL << 40, MAX_PER_SM, &blocks,
                                           g_resident))
    return err;
  const long long per_window = blocks / windows > 0 ? blocks / windows : 1;
  *gx = (int)(tiles < per_window ? tiles : per_window);
  return 0;
}

}  // namespace

extern "C" {

// The rows of float64 partials fdgan_channel_stats_bf16 writes for npix
// pixels of C channels (one per block along the pixels), or minus a CUDA
// error.
int fdgan_channel_stats_blocks(int npix, int C) {
  int gx = 0;
  if (int err = grid_x(npix, C, &gx)) return -err;
  return gx;
}

// x: npix pixels of C bf16 channels at a pixel stride of ld elements, 16-byte
// aligned, C and ld multiples of 8. part: (2, rows, C) float64 scratch, rows
// from fdgan_channel_stats_blocks(npix, C). out: (2, C) fp32, mean then
// biased variance. Returns cudaGetLastError() after the launches.
int fdgan_channel_stats_bf16(const void* x, void* part, void* out, int npix, int C, int ld, int rows,
                             void* stream) {
  int gx = 0;
  if (int err = grid_x(npix, C, &gx)) return err;
  if (gx != rows) return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, (C + WINDOW - 1) / WINDOW);
  channel_stats_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>((const bf16*)x, (double*)part, npix, C, ld);
  if (int err = (int)cudaGetLastError()) return err;
  channel_stats_finish_kernel<<<(C + 31) / 32, 32 * FINISH_SLICES, 0, (cudaStream_t)stream>>>(
      (const double*)part, (float*)out, gx, C, npix);
  return (int)cudaGetLastError();
}

}  // extern "C"
