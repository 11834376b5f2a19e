// Hand-written Hopper kernel for DehazeFormer's shifted 8x8 window attention.
//
// window_attention  fdgan_window_attention_bf16
//     Replaces no TPU kernel: added for DehazeFormer (arXiv:2204.03883), whose
//     attention blocks the JAX package does not have. From NHWC bf16 QK (B, H,
//     W, 2C: Q then K) and V (B, H, W, C) it writes NHWC bf16 O (B, H, W, C):
//     [Q, K, V] reflect-padded to multiples of 8 (shift 0: after; shift 4:
//     4 before, the rest after), split into 8x8 windows of 64 tokens and
//     into heads of HD contiguous channels, O = softmax(q.k^T/sqrt(HD) + B_h).v
//     per window and head, cropped back to the image. Its plain version is
//     ops/window_attention.py::reference.
//
// What bounds it on an H100: bytes. Each real pixel's QK and V are read and
// its O written once, 8C bytes, against 4*64*C operations a token: 32 FLOP a
// byte, far below the ~295 at which the tensor cores would be the limit.
// What the design does about it:
//   - no padded or permuted copy exists: a block computes each token's
//     source pixel by reflection from its window's place and copies the
//     pixel's 2C + C channels into shared memory with 16-byte cp.async
//     vectors (a pixel's channels are contiguous, so a warp reads whole
//     runs); the few reflected pixels of the border windows are read twice;
//   - a block takes WPC = max(1, 8 / heads) consecutive windows, one warp a
//     (window, head): a warp keeps its head's K and V as mma.sync B
//     fragments in registers and walks the 64 queries in four m16 tiles;
//     head dims 12 and 16 are padded to the MMA's k = 16 in registers, with
//     zeros for Q's and K's channels past HD and V's columns past HD;
//   - scores, the bias B_h (fp32, read through the cache: every block reads
//     the same heads x 64 x 64 floats), the row max and the exponentials
//     stay in fp32 registers (a row lives in one lane quad: two shuffles);
//     the unnormalised probabilities are rounded to bf16 as the A fragments
//     of P.V, as the S accumulator's layout is the A operand's, and O is
//     divided by the row sum in fp32;
//   - O is stored only for tokens that are the image's own pixels, each
//     exactly once, as bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fdgan_dev::bf16;

constexpr int WIN = 8;
constexpr int TOK = WIN * WIN;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the window's padded origin and the image's batch, from its flat index
struct Window {
  int b, p0, q0;
};

__device__ __forceinline__ Window window_at(long long win, int nwh, int nww) {
  const long long per = (long long)nwh * nww;
  const int b = (int)(win / per), rem = (int)(win % per);
  return {b, (rem / nww) * WIN, (rem % nww) * WIN};
}

template <int HD>
__global__ void __launch_bounds__(256)
window_attention_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ out, int H, int W, int C, int heads, int shift, int wpc, int nwh, int nww,
                        long long nwin, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldqk = 2 * C + 8, ldv = C + 8;  // padded rows, in bf16: 16-byte aligned for C % 8 == 0
  bf16* qks = reinterpret_cast<bf16*>(smem);           // [wpc * 64][ldqk]
  bf16* vs = qks + (size_t)wpc * TOK * ldqk;           // [wpc * 64][ldv]
  const long long win0 = (long long)blockIdx.x * wpc;
  const int tid = threadIdx.x;

  // stage every token of the block's windows: 16-byte vectors of QK (C / 4 a
  // pixel) and of V (C / 8), from the reflected source pixel
  const int cqk = C / 4, per_tok = cqk + C / 8;
  const int total = wpc * TOK * per_tok;
  for (int i = tid; i < total; i += blockDim.x) {
    const int tok = i / per_tok, ch = i - tok * per_tok;
    const long long win = win0 + tok / TOK;
    if (win >= nwin) continue;  // a last block's missing windows: never read
    const Window wd = window_at(win, nwh, nww);
    const int t = tok % TOK;
    const int r = reflect(wd.p0 + t / WIN - shift, H), c = reflect(wd.q0 + t % WIN - shift, W);
    const size_t pix = ((size_t)wd.b * H + r) * W + c;
    if (ch < cqk)
      fdgan_dev::cp_async16(qks + (size_t)tok * ldqk + 8 * ch, qk + pix * 2 * C + 8 * ch);
    else
      fdgan_dev::cp_async16(vs + (size_t)tok * ldv + 8 * (ch - cqk), v + pix * C + 8 * (ch - cqk));
  }
  fdgan_dev::cp_async_commit();
  fdgan_dev::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int wl = warp / heads, h = warp % heads;
  const long long win = win0 + wl;
  if (wl >= wpc || win >= nwin) return;  // no barrier follows
  const Window wd = window_at(win, nwh, nww);
  const bf16* Qs = qks + (size_t)wl * TOK * ldqk + h * HD;
  const bf16* Ks = Qs + C;
  const bf16* Vs = vs + (size_t)wl * TOK * ldv + h * HD;
  const bool hi_k = 2 * tq + 8 < HD;  // this lane's upper k pair lies inside the head

  // K as the B operand of S = Q.K^T: column (token) 8j + gq, k (dims) 2tq.., 2tq + 8..
  uint32_t kb[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bf16* p = Ks + (8 * j + gq) * ldqk + 2 * tq;
    kb[j][0] = fdgan_dev::ld_pair(p);
    kb[j][1] = hi_k ? fdgan_dev::ld_pair(p + 8) : 0u;
  }
  // V as the B operand of O = P.V: k-step kk (tokens 16kk..), column (dim) 8n + gq
  uint32_t vb[4][2][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = 8 * n + gq;
      if (d < HD) {
        const bf16* p = Vs + (16 * kk + 2 * tq) * ldv + d;
        vb[kk][n][0] = pack_raw(p[0], p[ldv]);
        vb[kk][n][1] = pack_raw(p[8 * ldv], p[9 * ldv]);
      } else {
        vb[kk][n][0] = vb[kk][n][1] = 0u;
      }
    }
  const float* bh = bias + (size_t)h * TOK * TOK;

#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = 16 * mt + gq, r1 = r0 + 8;  // this lane's two query rows
    const bf16* q0 = Qs + r0 * ldqk + 2 * tq;
    const uint32_t a[4] = {fdgan_dev::ld_pair(q0), fdgan_dev::ld_pair(q0 + 8 * ldqk),
                           hi_k ? fdgan_dev::ld_pair(q0 + 8) : 0u, hi_k ? fdgan_dev::ld_pair(q0 + 8 * ldqk + 8) : 0u};
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      fdgan_dev::mma_bf16_16816(s[j], a, kb[j]);
    }
    // in base 2: s*scale*log2(e) + B_h*log2(e)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bh + r0 * TOK + 8 * j + 2 * tq));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bh + r1 * TOK + 8 * j + 2 * tq));
      s[j][0] = fmaf(s[j][0], scale_log2, b0.x * LOG2E);
      s[j][1] = fmaf(s[j][1], scale_log2, b0.y * LOG2E);
      s[j][2] = fmaf(s[j][2], scale_log2, b1.x * LOG2E);
      s[j][3] = fmaf(s[j][3], scale_log2, b1.y * LOG2E);
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    float o[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // S's accumulators of columns 16kk.. are P's A fragment of k-step kk
      const uint32_t pa[4] = {fdgan_dev::pack_pair(s[2 * kk][0], s[2 * kk][1]),
                              fdgan_dev::pack_pair(s[2 * kk][2], s[2 * kk][3]),
                              fdgan_dev::pack_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              fdgan_dev::pack_pair(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 2; ++n) fdgan_dev::mma_bf16_16816(o[n], pa, vb[kk][n]);
    }

    const float inv[2] = {1.f / l0, 1.f / l1};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? r1 : r0;
      const int r = wd.p0 + t / WIN - shift, c = wd.q0 + t % WIN - shift;
      if (r < 0 || r >= H || c < 0 || c >= W) continue;  // a padded token: keys and values only
      bf16* dst = out + (((size_t)wd.b * H + r) * W + c) * C + h * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (8 * n + 2 * tq < HD) {
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              fdgan_dev::pack_pair(o[n][2 * half] * inv[half], o[n][2 * half + 1] * inv[half]);
        }
      }
    }
  }
}

// padded length of an axis of ``size`` for ``shift``: a multiple of 8
int padded(int size, int shift) {
  const int m = (WIN - size % WIN) % WIN;
  return shift ? size + shift + (WIN - shift + m) % WIN : size + m;
}

template <int HD>
int launch(const void* qk, const void* v, const void* bias, void* out, int B, int H, int W, int C, int heads,
           int shift, cudaStream_t stream) {
  const int wpc = heads < 8 ? 8 / heads : 1;
  const int threads = 32 * wpc * heads;
  const size_t smem = (size_t)wpc * TOK * (3 * C + 16) * sizeof(bf16);
  const int nwh = padded(H, shift) / WIN, nww = padded(W, shift) / WIN;
  const long long nwin = (long long)B * nwh * nww;
  const long long blocks = (nwin + wpc - 1) / wpc;
  if (threads > 256 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    if (int err = fdgan_dev::set_smem(window_attention_kernel<HD>, smem)) return err;
  }
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  window_attention_kernel<HD><<<(unsigned)blocks, threads, smem, stream>>>(
      (const bf16*)qk, (const bf16*)v, (const float*)bias, (bf16*)out, H, W, C, heads, shift, wpc, nwh, nww, nwin,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qk: (B, H, W, 2C) bf16, v and out: (B, H, W, C) bf16, all NHWC-contiguous
// and 16-byte aligned, C % 8 == 0, C / heads in {12, 16}, heads * max(1, 8 /
// heads) warps <= 8; bias: (heads, 64, 64) fp32; shift 0 or 4, each pad
// shorter than its side. Returns cudaGetLastError() after the launch.
int fdgan_window_attention_bf16(const void* qk, const void* v, const void* bias, void* out, int B, int H, int W,
                                int C, int heads, int shift, void* stream) {
  if (heads < 1 || C % heads || C % 8 || (shift != 0 && shift != WIN / 2)) return (int)cudaErrorInvalidValue;
  switch (C / heads) {
    case 12:
      return launch<12>(qk, v, bias, out, B, H, W, C, heads, shift, (cudaStream_t)stream);
    case 16:
      return launch<16>(qk, v, bias, out, B, H, W, C, heads, shift, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
