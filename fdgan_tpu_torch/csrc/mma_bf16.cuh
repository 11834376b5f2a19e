// Device helpers shared by the bf16 tensor-core kernels of dense_layer.cu and
// probes.cu: mma.sync m16n8k16 fragments read from padded shared-memory rows,
// 16-byte asynchronous copies (cp.async), bulk copies in both directions with
// their mbarrier and bulk groups, the t.W1 product of K2's and the conv1
// probe's mma.sync bodies, and the launch helpers (set_smem, persistent_grid).
// The wgmma helpers are in wgmma_bf16.cuh.
//
// Fragment layout of mma.sync m16n8k16 (bf16 in, fp32 accumulate), for lane
// = 4*gq + tq of a warp: A holds rows gq and gq+8, k = 2tq, 2tq+1 and
// 2tq+8, 2tq+9; B holds column gq, the same four k; the accumulator holds
// rows gq and gq+8, columns 2tq, 2tq+1. Both operands are read as pairs of
// consecutive k, so A is stored [row][k] and B [column][k] (the transpose of
// a row-major (K, N) matrix). Rows are padded by 8 bf16 (16 bytes), so the
// eight rows a fragment load touches fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdgan_dev {

typedef __nv_bfloat16 bf16;

constexpr int INTER = 128;   // bn_size * growth of DenseNet-121
constexpr int GROWTH = 32;   // channels a dense layer adds
constexpr int THREADS = 256;
constexpr int KC = 32;       // channels of x staged per step of the t.W1 product
constexpr int TB_LD = KC + 8;       // t chunk [row][k] and W1 chunk [n][k], in bf16

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to nearest-even bf16 in one instruction, lo in the low half
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// round(max(lo, 0)), round(max(hi, 0)): the ReLU rides the conversion
__device__ __forceinline__ uint32_t pack_pair_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// two bf16 of x -> round(relu(a*x + b)) as two bf16
__device__ __forceinline__ uint32_t affine_relu_pair(uint32_t xw, const float* a, const float* b) {
  const float lo = __uint_as_float(xw << 16), hi = __uint_as_float(xw & 0xffff0000u);
  return pack_pair(fmaxf(lo * a[0] + b[0], 0.f), fmaxf(hi * a[1] + b[1], 0.f));
}

// c += a . b for one m16n8k16 tile, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from device memory to shared memory without passing through
// registers; both addresses 16-byte aligned. The copy lands some time after
// the thread's cp_async_commit() and before its cp_async_wait<N>() returns
// with at most N later groups still in flight.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- bulk copies (the Tensor Memory Accelerator's 1-D form) and their barrier --
//
// One thread asks for a run of bytes to be copied from device memory into
// shared memory; the hardware reports the bytes that arrive to an mbarrier,
// a 64-bit object in shared memory. A phase of the barrier completes when its
// expected arrivals (threads) and its expected bytes have all come in;
// waiters name the phase by its parity (0 for the first, then alternating).

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// by one thread, before any use; then a block-wide barrier
__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the calling thread arrives, and the phase also waits for ``bytes`` of copies
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// bytes % 16 == 0, both addresses 16-byte aligned; completion goes to ``bar``
__device__ __forceinline__ void bulk_copy_g2s(void* smem_dst, const void* gmem_src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// the calling thread arrives, expecting no bytes (a barrier of threads only)
__device__ __forceinline__ void mbarrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// bulk_copy_g2s under an L2 cache ``policy`` (createpolicy)
__device__ __forceinline__ void bulk_copy_g2s_hint(void* smem_dst, const void* gmem_src, uint32_t bytes, uint64_t* bar,
                                                   uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
          smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// The other direction: ``bytes`` from shared memory to device memory under
// the L2 ``policy``, one bulk copy in the calling thread's open bulk group
// (bytes % 16 == 0, both addresses 16-byte aligned). The threads' own writes
// to the source must come first: each writer's fence_proxy_async()
// (wgmma_bf16.cuh), then a barrier the issuing thread has waited on. The
// source must not be written again, nor the block exit, before bulk_wait<>
// says the copy is done.
__device__ __forceinline__ void bulk_copy_s2g_hint(void* gmem_dst, const void* smem_src, uint32_t bytes,
                                                   uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(gmem_dst),
               "r"(smem_u32(smem_src)), "r"(bytes), "l"(policy)
               : "memory");
}

// closes the calling thread's open bulk group: the bulk stores since the last commit
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// returns once at most N of the calling thread's committed bulk groups are
// still running
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for the phase of ``parity`` to complete. A phase that does not complete
// within ~2 s of clock ticks is a bug in the caller's pipeline: trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  }
}

// The t.W1 product of a block of 64*MI rows, K = C, N = 128, by 8 warps.
// Warp w owns rows 16*MI*(w%4) .. +16*MI (MI m16 tiles) and columns
// 64*(w/4) .. +64 (eight n8 tiles): acc[mi][j][*] is the m16n8 fragment of h
// for rows 16*MI*(w%4) + 16*mi and columns 64*(w/4) + 8*j.
//     h[row] = round(relu(a1*x[pix[row]] + b1)) . W1,   0 where pix[row] is -1.
// x_at(gp, c) points at the 8 channels c .. c+8 of pixel gp (c % 8 == 0), 16-
// byte aligned; w1t is W1 transposed, (128, C); C % 8 == 0. x and W1 are
// staged 32 channels at a time in 16-byte vectors (ts: 64*MI rows, w1s: 128
// rows, TB_LD bf16 each), the ragged last chunk zero-filled, and the next
// chunk is loaded into registers while the tensor cores work on the current
// one. pix (64*MI ints, shared) must be written before the call; the call
// ends with every thread past its last read of ts and w1s.
template <int MI, typename XAt>
__device__ __forceinline__ void gemm1_bf16(XAt x_at, const float* __restrict__ a1,
                                           const float* __restrict__ b1, const bf16* __restrict__ w1t,
                                           int C, const int* pix, bf16* ts, bf16* w1s,
                                           float acc[MI][8][4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * MI * (warp % 4), n0 = 64 * (warp / 4);
  // staging: rows sr + 64*r of x (r < MI) and of W1t (r < 2), channels 8*kq .. +8
  const int sr = tid / 4, kq = tid % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  uint4 xv[MI], wv[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto fetch = [&](int c0) {
    const int c = c0 + 8 * kq;
#pragma unroll
    for (int r = 0; r < MI; ++r) {
      const int gp = pix[sr + 64 * r];
      xv[r] = c < C && gp >= 0 ? *reinterpret_cast<const uint4*>(x_at(gp, c)) : zero;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      wv[r] = c < C ? *reinterpret_cast<const uint4*>(w1t + (size_t)(sr + 64 * r) * C + c) : zero;
  };

  __syncthreads();  // pix is written
  fetch(0);
  for (int c0 = 0; c0 < C; c0 += KC) {
    {
      const int c = c0 + 8 * kq;
      float a[8], b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[e] = c < C ? a1[c + e] : 0.f;
        b[e] = c < C ? b1[c + e] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MI; ++r) {
        const int row = sr + 64 * r;
        uint4 t = zero;  // rows outside the image and channels past C stage t = 0
        if (c < C && pix[row] >= 0) {
          t.x = affine_relu_pair(xv[r].x, a + 0, b + 0);
          t.y = affine_relu_pair(xv[r].y, a + 2, b + 2);
          t.z = affine_relu_pair(xv[r].z, a + 4, b + 4);
          t.w = affine_relu_pair(xv[r].w, a + 6, b + 6);
        }
        *reinterpret_cast<uint4*>(ts + row * TB_LD + 8 * kq) = t;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) *reinterpret_cast<uint4*>(w1s + (sr + 64 * r) * TB_LD + 8 * kq) = wv[r];
    }
    __syncthreads();
    if (c0 + KC < C) fetch(c0 + KC);  // in flight while the tensor cores run
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t bfr[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* p = w1s + (n0 + 8 * j + gq) * TB_LD + ks + 2 * tq;
        bfr[j][0] = ld_pair(p);
        bfr[j][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const bf16* p = ts + (m0 + 16 * mi + gq) * TB_LD + ks + 2 * tq;
        const uint32_t afr[4] = {ld_pair(p), ld_pair(p + 8 * TB_LD), ld_pair(p + 8),
                                 ld_pair(p + 8 * TB_LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[mi][j], afr, bfr[j]);
      }
    }
    __syncthreads();  // the chunk is consumed before the next one is staged
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// blocks of ``threads`` for a persistent kernel: as many as the card runs at
// once, capped per SM, and no more than there are tiles. ``resident``, where
// given, is the caller's table of that number by device (zeros at first): the
// occupancy query costs tens of microseconds, which a kernel launched 42
// times a forward asks once.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, long long ntiles, int max_per_sm, int* grid,
                    int* resident = nullptr) {
  int dev = 0, sms = 0, per_sm = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  long long blocks = resident && dev < MAX_DEVICES ? resident[dev] : 0;
  if (blocks == 0) {
    if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
    if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) return err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    if (per_sm > max_per_sm) per_sm = max_per_sm;
    blocks = (long long)sms * per_sm;
    if (resident && dev < MAX_DEVICES) resident[dev] = (int)blocks;
  }
  *grid = (int)(ntiles < blocks ? ntiles : blocks);
  return 0;
}

}  // namespace fdgan_dev
