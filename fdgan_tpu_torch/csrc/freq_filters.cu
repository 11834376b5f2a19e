// Hand-written Hopper kernel for the fusion discriminator's input.
//
// K3  fdgan_freq_filters_{f32,bf16}
//     Replaces fdgan_tpu/ops/pallas_filters.py::_plane_filters (kernel body
//     _freq_kernel) together with the XLA work of its wrapper
//     frequency_fuse_pallas: the NHWC->plane transposes, both pads, the
//     transposes back and the concat. From NHWC x (B,H,W,3) it writes NHWC
//     (B,H,W,9) = concat[x, LF, HF]:
//         LF = 15x15 sigma=3 Gaussian (separable: a column pass, then a row
//              pass) over (x - mean)/std, reflect-padded by 7;
//         HF = 3x3 Laplacian (ones, centre -8) over x, zero-padded by 1.
//     Rounding points are the plain version's (ops/filters.py): x is
//     normalised in x's dtype, both filters accumulate in fp32 with fp32
//     taps, in the same order and without fused multiply-adds, and LF and HF
//     are rounded to x's dtype once. In fp32 the kernel and the plain
//     version agree bit for bit.
//
// What bounds it on an H100: memory. Per pixel it reads 3 values and writes
// 9, against ~100 FLOP (30 Gaussian taps and 10 Laplacian terms per
// channel), far below the card's ridge. The design reads x from device
// memory once per block: one block per (image, 32x32 output tile) stages its
// 46x46 reflect-indexed halo of all three channels in shared memory, keeping
// the raw values (for HF, where positions outside the image read as 0) and
// the normalised ones (for LF) from the one load. The column pass goes to
// shared memory, the row pass and the Laplacian to registers, and each
// pixel's nine channels are written by one thread, contiguously. The halo
// re-read is (46/32)^2 = 2.1x of the input, from L2. No tensor cores, TMA or
// wgmma: the kernel moves 12 values per pixel and computes little.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TAPS = 15;
constexpr int PAD = TAPS / 2;            // 7
constexpr int TILE = 32;                 // output tile: 32 x 32 pixels
constexpr int HALO = TILE + 2 * PAD;     // 46
constexpr int CH = 3;                    // RGB in
constexpr int OUT_CH = 3 * CH;           // concat[x, LF, HF] out
constexpr int THREADS = 256;
constexpr int HALO_PLANE = HALO * HALO;
constexpr int COL_PLANE = TILE * HALO;
constexpr size_t SMEM = sizeof(float) * (2 * CH * HALO_PLANE + CH * COL_PLANE);  // 68,448 B

// taps[15], then the ImageNet mean[3] and std[3] in fp32; the same values
// on every call (ops/filters.py: blur_taps, IMAGENET_MEAN, IMAGENET_STD)
constexpr int N_CONSTS = TAPS + 2 * CH;
__constant__ float c_consts[N_CONSTS];

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T, kept as float
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);  // only tiles past the ragged edge go further
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
freq_filters_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  float* s_raw = smem;                       // [CH][HALO][HALO] x
  float* s_norm = s_raw + CH * HALO_PLANE;   // [CH][HALO][HALO] (x - mean)/std in T
  float* s_col = s_norm + CH * HALO_PLANE;   // [CH][TILE][HALO] column pass
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const T* xb = x + (size_t)blockIdx.z * H * W * CH;

  // stage the halo once: neighbouring threads read neighbouring addresses
  for (int i = tid; i < HALO_PLANE * CH; i += THREADS) {
    const int c = i % CH, p = i / CH;
    const int r = p / HALO, q = p % HALO;
    const int gy = reflect(y0 - PAD + r, H), gx = reflect(x0 - PAD + q, W);
    const float v = load(xb + ((size_t)gy * W + gx) * CH + c);
    const float mean = rnd<T>(c_consts[TAPS + c]), stdv = rnd<T>(c_consts[TAPS + CH + c]);
    s_raw[c * HALO_PLANE + p] = v;
    s_norm[c * HALO_PLANE + p] = rnd<T>(__fdiv_rn(rnd<T>(__fsub_rn(v, mean)), stdv));
  }
  __syncthreads();

  // column pass (along H) over all HALO columns: acc = acc + t[k] * a[r + k]
  for (int i = tid; i < CH * COL_PLANE; i += THREADS) {
    const int c = i / COL_PLANE, rq = i % COL_PLANE;
    const float* a = s_norm + c * HALO_PLANE + rq;  // row r, column q of the halo
    float acc = __fmul_rn(c_consts[0], a[0]);
#pragma unroll
    for (int k = 1; k < TAPS; ++k) acc = __fadd_rn(acc, __fmul_rn(c_consts[k], a[k * HALO]));
    s_col[i] = acc;
  }
  __syncthreads();

  // row pass, Laplacian and the 9-channel store, one pixel per thread
  for (int p = tid; p < TILE * TILE; p += THREADS) {
    const int r = p / TILE, q = p % TILE;
    const int gy = y0 + r, gx = x0 + q;
    if (gy >= H || gx >= W) continue;
    T vals[OUT_CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float* cr = s_col + c * COL_PLANE + r * HALO + q;
      float lf = __fmul_rn(c_consts[0], cr[0]);
#pragma unroll
      for (int k = 1; k < TAPS; ++k) lf = __fadd_rn(lf, __fmul_rn(c_consts[k], cr[k]));

      const float* centre = s_raw + c * HALO_PLANE + (r + PAD) * HALO + q + PAD;
      float z[3][3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int yy = gy + di - 1, xx = gx + dj - 1;
          const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
          z[di][dj] = inside ? centre[(di - 1) * HALO + dj - 1] : 0.f;
        }
      }
      float s = z[0][0];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          if (di || dj) s = __fadd_rn(s, z[di][dj]);
        }
      }
      vals[c] = to_t<T>(centre[0]);
      vals[CH + c] = to_t<T>(lf);
      vals[2 * CH + c] = to_t<T>(__fsub_rn(s, __fmul_rn(9.f, z[1][1])));
    }
    T* o = out + (((size_t)blockIdx.z * H + gy) * W + gx) * OUT_CH;
#pragma unroll
    for (int c = 0; c < OUT_CH; ++c) o[c] = vals[c];
  }
}

// The constants are copied to the device once per device and process.
int upload_consts(const float* consts) {
  static bool done[64] = {};
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (dev < 64 && done[dev]) return 0;
  if (int err = (int)cudaMemcpyToSymbol(c_consts, consts, sizeof(float) * N_CONSTS)) return err;
  if (dev < 64) done[dev] = true;
  return 0;
}

template <typename T>
int launch(const void* x, void* out, const void* consts, int B, int H, int W, void* stream) {
  if (int err = upload_consts((const float*)consts)) return err;
  if (int err = (int)cudaFuncSetAttribute(freq_filters_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM))
    return err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  freq_filters_kernel<T><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>((const T*)x, (T*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B,H,W,3) and out (B,H,W,9) are contiguous in the kernel's dtype; H and
// W exceed 7; consts is a host array of 21 fp32 values (taps, mean, std).
// Returns cudaGetLastError() after the launch (0 = success).

int fdgan_freq_filters_f32(const void* x, void* out, const void* consts, int B, int H, int W,
                           void* stream) {
  return launch<float>(x, out, consts, B, H, W, stream);
}

int fdgan_freq_filters_bf16(const void* x, void* out, const void* consts, int B, int H, int W,
                            void* stream) {
  return launch<bf16>(x, out, consts, B, H, W, stream);
}

}  // extern "C"
