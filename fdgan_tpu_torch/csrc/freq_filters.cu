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
// What bounds it on an H100: memory and instruction issue, about evenly.
// Per pixel it reads 3 values and writes 9 (24 bytes in bf16: 15 us at
// 8x512x512 at 3.35 TB/s), and per pixel and channel it does ~69 unfused fp32
// operations (15 products and 14 sums per pass, 10 for the Laplacian) that
// no FMA may shorten: ~14 us of the card's fp32 issue at that shape. So the
// design keeps every other instruction few and the reads and writes whole:
//   - a block owns a tile 128 pixels wide and TH rows tall (32, or 16 or 8
//     where the image has too few tiles of 32 to fill the card);
//   - the halo comes in as 16-byte vectors of the contiguous NHWC rows: a
//     thread loads 8 whole pixels (3 vectors in bf16), so every unpacking
//     index is a constant; edges and widths the vectors do not fit load
//     pixel by pixel with the reflect;
//   - each input value is normalised once per tile into shared memory (in
//     x's dtype), and only the 1-pixel halo of raw x is kept beside it, for
//     the Laplacian, with zeros already in place outside the image;
//   - the column pass runs over two adjacent columns per thread and 8 rows,
//     from bf16 pairs (fp32 pairs) read once into registers;
//   - the row pass gives each lane 4 consecutive pixels of a row: it reads
//     the 20 column sums they need as 5 16-byte vectors and slides over them
//     in registers; the Laplacian reads its 3x6 raw values as vectors too;
//   - a warp stages its row's 128 x 9 outputs in shared memory and writes
//     them as coalesced 16-byte stores (2,304 contiguous bytes in bf16).
// In bf16, (x - mean)/std is computed as (x - mean) * (1/std): with d and std
// bf16 values, the fp32 product rounds to the same bf16 as the correctly
// rounded quotient for every finite d (d/std is never within 2^-16 of a bf16
// rounding boundary; tests/test_torch_filters.py checks all 65,280 of them).
// fp32 keeps the division. No tensor cores, TMA or wgmma: nothing here is a
// product of matrices, and the copies are small.
//
// K3 with halo rows  fdgan_freq_filters_halo_{f32,bf16}
//     The same body for a shard of the image along H (training with H
//     sharded): the 7 rows above and below the shard come from two buffers
//     the caller fills from the neighbouring shards (B,7,W,3 each, or null
//     at an end of the image), where the body would reflect (blur) or read
//     zeros (Laplacian); at a side without a buffer it reflects and
//     zero-pads as on a whole image, which the end shard can do alone, since
//     a shard holds at least 8 rows. The halo is a template parameter, so
//     the whole-image body keeps its code (a run-time test in the one body
//     cost K1 12%, PERF.md). Its output rows are the whole image's, bit for
//     bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TAPS = 15;
constexpr int PAD = TAPS / 2;            // 7
constexpr int TW = 128;                  // output tile width
constexpr int GROUP = 8;                 // pixels a thread loads at once
constexpr int PITCH = TW + 2 * GROUP;    // 144 staged columns: pixels x0-8 .. x0+135
constexpr int GROUPS = PITCH / GROUP;    // 18
constexpr int CHUNK = 8;                 // rows of the column pass per round; one row per warp
constexpr int CH = 3;                    // RGB in
constexpr int OUT_CH = 3 * CH;           // concat[x, LF, HF] out
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAIRS = PITCH / 2;         // column pairs of the column pass
constexpr int MAX_DEVICES = 64;
static_assert(WARPS == CHUNK, "the row pass gives each warp one row of a chunk");
static_assert(TW == 32 * 4, "the row pass gives each lane 4 pixels");
static_assert(CH * PAIRS <= THREADS, "the column pass gives each thread at most one column pair");

// taps[15], then the ImageNet mean[3] and std[3] in fp32; the same values
// on every call (ops/filters.py: blur_taps, IMAGENET_MEAN, IMAGENET_STD)
constexpr int N_CONSTS = TAPS + 2 * CH;
__constant__ float c_consts[N_CONSTS];

template <int TH, typename T>
struct Smem {
  static constexpr int NRM_ROWS = TH + 2 * PAD;  // normalised halo rows
  static constexpr int RAW_ROWS = TH + 2;        // raw rows of the Laplacian
  static constexpr size_t COL = sizeof(float) * CH * CHUNK * PITCH;
  static constexpr size_t NRM = sizeof(T) * CH * NRM_ROWS * PITCH;
  static constexpr size_t RAW = sizeof(T) * CH * RAW_ROWS * PITCH;
  static constexpr size_t OUT = sizeof(T) * WARPS * TW * OUT_CH;
  static constexpr size_t BYTES = COL + NRM + RAW + OUT;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T, kept as float
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(to_t<T>(v)); }

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);  // only tiles past the ragged edge go further
}

// (x - mean)/std of 8 values, given d = x - mean in fp32; inv = 1/std. fp32
// divides. bf16 rounds d to bf16 by pairs and multiplies by 1/std (see the
// header); the result is rounded to bf16 where it is stored (store8).
template <typename T> __device__ __forceinline__ void normalise8(float d[8], float stdv, float inv);
template <> __device__ __forceinline__ void normalise8<float>(float d[8], float stdv, float) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = __fdiv_rn(d[i], stdv);
}
template <> __device__ __forceinline__ void normalise8<bf16>(float d[8], float, float inv) {
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(d[i], d[i + 1]);
    d[i] = __fmul_rn(__low2float(r), inv);
    d[i + 1] = __fmul_rn(__high2float(r), inv);
  }
}

// 8 pixels x 3 channels of x as 24 floats, by 16-byte vectors
__device__ __forceinline__ void load_group(const float* p, float v[24]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
  }
}
__device__ __forceinline__ void load_group(const bf16* p, float v[24]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// 8 values of T to shared memory at a 16-byte (bf16) or 32-byte (fp32) boundary
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {  // one cvt.rn.bf16x2.f32
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// two adjacent values of T from shared memory (4- or 8-byte aligned)
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// n values of T from shared memory: fp32 by 16-byte vectors (n a multiple of
// 4, p on a 16-byte boundary), bf16 by 8-byte ones (p on an 8-byte boundary)
template <int N>
__device__ __forceinline__ void load_run(const float* p, float v[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void load_run(const bf16* p, float v[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint2 q = reinterpret_cast<const uint2*>(p)[i];
    v[4 * i] = __uint_as_float(q.x << 16), v[4 * i + 1] = __uint_as_float(q.x & 0xffff0000u);
    v[4 * i + 2] = __uint_as_float(q.y << 16), v[4 * i + 3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// a lane's 4 pixels x 9 channels, as T, to its place in the warp's staged row
__device__ __forceinline__ void stage_out(float* p, const float v[36]) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ void stage_out(bf16* p, const float v[36]) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    reinterpret_cast<uint2*>(p)[i] = make_uint2(pack_bf16(v[4 * i], v[4 * i + 1]), pack_bf16(v[4 * i + 2], v[4 * i + 3]));
}

template <int TH, typename T, bool HALO>
__global__ void __launch_bounds__(THREADS)
freq_filters_kernel(const T* __restrict__ x, const T* __restrict__ top, const T* __restrict__ bot,
                    T* __restrict__ out, int H, int W) {
  using S = Smem<TH, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_col = reinterpret_cast<float*>(smem);         // [CH][CHUNK][PITCH] column sums
  T* s_nrm = reinterpret_cast<T*>(smem + S::COL);         // [CH][TH+14][PITCH] (x - mean)/std
  T* s_raw = reinterpret_cast<T*>(smem + S::COL + S::NRM);  // [CH][TH+2][PITCH] x, 0 outside
  T* s_out = reinterpret_cast<T*>(smem + S::COL + S::NRM + S::RAW);  // [WARPS][TW*9]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * CH;
  // with HALO, the neighbours' rows y0-7 .. -1 and H .. H+6 of this image (null at an end of the image)
  const T* tb = HALO && top != nullptr ? top + (size_t)b * PAD * W * CH : nullptr;
  const T* bb = HALO && bot != nullptr ? bot + (size_t)b * PAD * W * CH : nullptr;
  // whole 8-pixel groups load as vectors where each image row starts on a 16-byte boundary
  const bool rows_aligned = ((size_t)W * CH * sizeof(T)) % 16 == 0 && ((uintptr_t)x & 15) == 0;

  float mean[CH], stdv[CH], inv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    mean[c] = rnd<T>(c_consts[TAPS + c]);
    stdv[c] = rnd<T>(c_consts[TAPS + CH + c]);
    inv[c] = __frcp_rn(stdv[c]);
  }

  // --- stage the halo: normalised rows y0-7 .. y0+TH+6, raw rows y0-1 .. y0+TH;
  // a task is 8 pixels of one row
  for (int task = tid; task < S::NRM_ROWS * GROUPS; task += THREADS) {
    const int r = task / GROUPS, g = task % GROUPS;
    const int y = y0 - PAD + r, px0 = x0 - GROUP + g * GROUP;
    const T* row;
    if (HALO && y < 0 && tb != nullptr)
      row = tb + (size_t)(y + PAD) * W * CH;
    else if (HALO && y >= H && bb != nullptr)  // rows past H+6 only feed tiles past the ragged edge
      row = bb + (size_t)min(y - H, PAD - 1) * W * CH;
    else
      row = xb + (size_t)reflect(y, H) * W * CH;
    float v[24];
    if (rows_aligned && px0 >= 0 && px0 + GROUP <= W) {
      load_group(row + (size_t)px0 * CH, v);
    } else {  // an edge of the image, or rows the vectors do not fit: pixel by pixel, reflected
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const T* p = row + (size_t)reflect(px0 + i, W) * CH;
#pragma unroll
        for (int c = 0; c < CH; ++c) v[i * CH + c] = to_f<T>(p[c]);
      }
    }
    const bool raw_row = r >= PAD - 1 && r < PAD + TH + 1;
    const bool y_in = HALO ? (y >= 0 || tb != nullptr) && (y < H || bb != nullptr) : y >= 0 && y < H;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float n[GROUP], z[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const float vi = v[i * CH + c];
        n[i] = __fsub_rn(vi, mean[c]);
        z[i] = y_in && px0 + i >= 0 && px0 + i < W ? vi : 0.f;
      }
      normalise8<T>(n, stdv[c], inv[c]);
      store8(s_nrm + (c * S::NRM_ROWS + r) * PITCH + g * GROUP, n);
      if (raw_row) store8(s_raw + (c * S::RAW_ROWS + r - (PAD - 1)) * PITCH + g * GROUP, z);
    }
  }
  __syncthreads();

  for (int r0 = 0; r0 < TH; r0 += CHUNK) {
    // --- column pass (along H) for rows r0 .. r0+7 over every staged column:
    // acc = t[0]*a[r] then acc = acc + t[k]*a[r+k], two columns per thread
    if (tid < CH * PAIRS) {
      const int c = tid / PAIRS, j = 2 * (tid % PAIRS);
      const T* a = s_nrm + (c * S::NRM_ROWS + r0) * PITCH + j;
      float a0[CHUNK + TAPS - 1], a1[CHUNK + TAPS - 1];
#pragma unroll
      for (int k = 0; k < CHUNK + TAPS - 1; ++k) {
        const float2 p = load2(a + k * PITCH);
        a0[k] = p.x, a1[k] = p.y;
      }
#pragma unroll
      for (int rr = 0; rr < CHUNK; ++rr) {
        float s0 = __fmul_rn(c_consts[0], a0[rr]), s1 = __fmul_rn(c_consts[0], a1[rr]);
#pragma unroll
        for (int k = 1; k < TAPS; ++k) {
          s0 = __fadd_rn(s0, __fmul_rn(c_consts[k], a0[rr + k]));
          s1 = __fadd_rn(s1, __fmul_rn(c_consts[k], a1[rr + k]));
        }
        *reinterpret_cast<float2*>(s_col + (c * CHUNK + rr) * PITCH + j) = make_float2(s0, s1);
      }
    }
    __syncthreads();

    // --- row pass, Laplacian and the 9-channel row: warp w takes row r0+w,
    // lane l its pixels 4l .. 4l+3 (staged columns 4l+8 .. 4l+11)
    const int rr = warp, gy = y0 + r0 + rr;
    const int q0 = 4 * lane;
    float vals[4 * OUT_CH];  // pixel i, channel k at 9i + k
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float cv[20];  // column sums of staged columns 4l .. 4l+19; pixel i reads 4l+i+1 .. 4l+i+15
      load_run<20>(s_col + (c * CHUNK + rr) * PITCH + q0, cv);
      float z[3][12];  // raw staged columns 4l+4 .. 4l+15 of rows gy-1 .. gy+1; pixel i centres on 4l+8+i
#pragma unroll
      for (int di = 0; di < 3; ++di)
        load_run<12>(s_raw + (c * S::RAW_ROWS + r0 + rr + di) * PITCH + q0 + 4, z[di]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lf = __fmul_rn(c_consts[0], cv[i + 1]);
#pragma unroll
        for (int k = 1; k < TAPS; ++k) lf = __fadd_rn(lf, __fmul_rn(c_consts[k], cv[i + 1 + k]));
        float s = z[0][i + 3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            if (di || dj) s = __fadd_rn(s, z[di][i + 3 + dj]);
          }
        }
        vals[OUT_CH * i + c] = z[1][i + 4];
        vals[OUT_CH * i + CH + c] = lf;
        vals[OUT_CH * i + 2 * CH + c] = __fsub_rn(s, __fmul_rn(9.f, z[1][i + 4]));
      }
    }
    T* staged = s_out + warp * TW * OUT_CH;
    stage_out(staged + q0 * OUT_CH, vals);
    __syncwarp();
    if (gy < H && x0 < W) {
      const int n = min(TW, W - x0) * OUT_CH;  // elements of this row in the tile
      T* dst = out + (((size_t)b * H + gy) * W + x0) * OUT_CH;
      int done = 0;
      if (((uintptr_t)dst & 15) == 0) {
        const int nvec = n * (int)sizeof(T) / 16;
        for (int i = lane; i < nvec; i += 32) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(staged)[i];
        done = nvec * 16 / (int)sizeof(T);
      }
      for (int i = done + lane; i < n; i += 32) dst[i] = staged[i];
    }
    __syncthreads();  // s_col and the staged rows are reused by the next chunk
  }
}

// The constants are copied to the device once per device and process.
int upload_consts(const float* consts) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (dev < MAX_DEVICES && done[dev]) return 0;
  if (int err = (int)cudaMemcpyToSymbol(c_consts, consts, sizeof(float) * N_CONSTS)) return err;
  if (dev < MAX_DEVICES) done[dev] = true;
  return 0;
}

// the device's SM count, read once per device
int sm_count(int* sms) {
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (dev < MAX_DEVICES && count[dev]) {
    *sms = count[dev];
    return 0;
  }
  if (int err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  if (dev < MAX_DEVICES) count[dev] = *sms;
  return 0;
}

template <int TH, typename T, bool HALO>
int launch_tiles(const T* x, const T* top, const T* bot, T* out, int B, int H, int W, cudaStream_t stream) {
  static bool attr_done[MAX_DEVICES] = {};  // the opt-in above 48 KB, once per device
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  const size_t smem = Smem<TH, T>::BYTES;
  if (dev >= MAX_DEVICES || !attr_done[dev]) {
    if (int err = (int)cudaFuncSetAttribute(freq_filters_kernel<TH, T, HALO>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
    if (dev < MAX_DEVICES) attr_done[dev] = true;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  freq_filters_kernel<TH, T, HALO><<<grid, THREADS, smem, stream>>>(x, top, bot, out, H, W);
  return (int)cudaGetLastError();
}

template <typename T, bool HALO>
int launch(const void* x, const void* top, const void* bot, void* out, const void* consts, int B, int H, int W,
           void* stream) {
  if (int err = upload_consts((const float*)consts)) return err;
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  // the tallest tile (least halo per pixel) that still gives two blocks per SM
  const long long cols = (long long)B * ((W + TW - 1) / TW);
  auto tiles = [&](int th) { return cols * ((H + th - 1) / th); };
  const cudaStream_t s = (cudaStream_t)stream;
  const T *xt = (const T*)x, *tt = (const T*)top, *bt = (const T*)bot;
  if (tiles(32) >= 2LL * sms) return launch_tiles<32, T, HALO>(xt, tt, bt, (T*)out, B, H, W, s);
  if (tiles(16) >= 2LL * sms) return launch_tiles<16, T, HALO>(xt, tt, bt, (T*)out, B, H, W, s);
  return launch_tiles<8, T, HALO>(xt, tt, bt, (T*)out, B, H, W, s);
}

}  // namespace

extern "C" {

// x (B,H,W,3) and out (B,H,W,9) are contiguous in the kernel's dtype; H and
// W exceed 7; consts is a host array of 21 fp32 values (taps, mean, std).
// Returns cudaGetLastError() after the launch (0 = success).

int fdgan_freq_filters_f32(const void* x, void* out, const void* consts, int B, int H, int W,
                           void* stream) {
  return launch<float, false>(x, nullptr, nullptr, out, consts, B, H, W, stream);
}

int fdgan_freq_filters_bf16(const void* x, void* out, const void* consts, int B, int H, int W,
                            void* stream) {
  return launch<bf16, false>(x, nullptr, nullptr, out, consts, B, H, W, stream);
}

// x a shard of the image along H (H > 7 rows); top and bot the (B,7,W,3)
// rows above and below it, contiguous and 16-byte aligned, or null at an end
// of the image.
int fdgan_freq_filters_halo_f32(const void* x, const void* top, const void* bot, void* out, const void* consts,
                                int B, int H, int W, void* stream) {
  return launch<float, true>(x, top, bot, out, consts, B, H, W, stream);
}

int fdgan_freq_filters_halo_bf16(const void* x, const void* top, const void* bot, void* out, const void* consts,
                                 int B, int H, int W, void* stream) {
  return launch<bf16, true>(x, top, bot, out, consts, B, H, W, stream);
}

}  // extern "C"
