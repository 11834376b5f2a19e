// Hand-written Hopper kernels for the kernel probes: the counterparts of
// tools/probe_pallas{,2,3,4,5}.py, the Pallas measurements that decided the
// dense layer's design on the TPU. Each is a stage of the dense layer (K1,
// dense_layer.cu) or a streaming copy, taken alone, so that its time can be
// held against its bound and against a library call at the dense block's
// own sizes (2^21 pixels, 128 channels: arrays of 0.5 GB, far beyond the
// 50 MB L2). All are bf16; the products run on the tensor cores with
// mma.sync m16n8k16 and fp32 accumulation, round once, and read their
// operands from padded shared-memory rows (mma_bf16.cuh).
//
// What the TPU versions are shaped by does not carry over: their row tiles
// of 1024-8192 rows (0.25-2 MB) exceed the 227 KB of shared memory a block
// may use, a grid's "arbitrary" or "parallel" order means nothing where all
// blocks run at once (though a stream is fastest in short-lived blocks that
// the hardware hands out in address order: the copies below), and the halo
// rows build_halo hands the conv2 probe
// are read here from g itself, with the image border masked to zero as K1
// does. The kernels that keep an operand resident (probe_mm's B, conv2's
// W2) run as persistent blocks, as many as fit the card, each walking its
// share of the tiles with the next tile's loads (cp.async) in flight under
// the current tile's products. The "wgmma" bodies of conv1 and conv2 are the
// dense layer's stages on Hopper's warpgroup products (wgmma_bf16.cuh).

#include "wgmma_bf16.cuh"

namespace {

using namespace fdgan_dev;

constexpr int ROW_LD = INTER + 8;  // a 128-wide bf16 row in shared memory, padded

// acc -> rows of a shared tile as bf16, in the accumulator's fragment layout:
// acc[j][2*half + e] is (row gq + 8*half, column 8*j + 2*tq + e) of an m16 tile
template <int NJ>
__device__ __forceinline__ void store_fragments(bf16* tile_row0, int ld, const float acc[NJ][4], int gq, int tq) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(tile_row0 + (gq + 8 * half) * ld + 8 * j + 2 * tq) =
          pack_pair(acc[j][2 * half], acc[j][2 * half + 1]);
}

// -----------------------------------------------------------------------------
// probe_mm: Y = A.B, A (M,128), B (128,128), Y (M,128).
//
// Replaces tools/probe_pallas.py:18 pallas_mm (body mm_kernel :14), its tile
// sweep tools/probe_pallas2.py:14 and the "parallel" grid variant
// tools/probe_pallas3.py:52 pmm: one function, so one kernel, with the row
// tile per block a compile-time parameter (64, 128 or 256 rows: the sweep).
//
// Bound on an H100: memory. It moves 2*(M*128 + M*128) bytes for 2*M*128*128
// FLOP, 64 FLOP per byte against the card's ridge of ~295. So the design is
// about streaming A and Y: B^T (32 KB) is staged once per block and stays,
// blocks are persistent, A tiles arrive through a two-stage cp.async ring so
// that the next tile loads while this one multiplies, and Y leaves through
// shared memory in 16-byte rows rather than as 4-byte fragment stores.
// -----------------------------------------------------------------------------

template <int MI>
constexpr size_t mm_smem() { return 2 * (size_t)(INTER * ROW_LD + 2 * 64 * MI * ROW_LD); }

template <int MI>
__global__ void __launch_bounds__(THREADS)
probe_mm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bt, bf16* __restrict__ y, int m) {
  constexpr int TM = 64 * MI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // B^T [n][k]
  bf16* ring = bs + INTER * ROW_LD;              // [2][TM][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * MI * (warp % 4), n0 = 64 * (warp / 4);
  const int ntiles = (m + TM - 1) / TM;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_tile = [&](int tile, bf16* dst) {
    const size_t row0 = (size_t)tile * TM;
    for (int v = tid; v < TM * 16; v += THREADS) {
      const int r = v / 16, kq = v % 16;
      bf16* d = dst + r * ROW_LD + 8 * kq;
      if (row0 + r < (size_t)m) cp_async16(d, a + (row0 + r) * INTER + 8 * kq);
      else *reinterpret_cast<uint4*>(d) = zero;  // rows past the end multiply as 0
    }
  };

  for (int v = tid; v < INTER * 16; v += THREADS) cp_async16(bs + (v / 16) * ROW_LD + 8 * (v % 16), bt + (size_t)v * 8);
  int tile = blockIdx.x;
  if (tile < ntiles) load_tile(tile, ring);
  cp_async_commit();

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    bf16* cur = ring + (it & 1) * TM * ROW_LD;
    if (tile + (int)gridDim.x < ntiles) load_tile(tile + gridDim.x, ring + ((it & 1) ^ 1) * TM * ROW_LD);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and B) has landed; the next may be in flight
    __syncthreads();

    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < INTER; ks += 16) {
      uint32_t bfr[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* p = bs + (n0 + 8 * j + gq) * ROW_LD + ks + 2 * tq;
        bfr[j][0] = ld_pair(p);
        bfr[j][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const bf16* p = cur + (m0 + 16 * mi + gq) * ROW_LD + ks + 2 * tq;
        const uint32_t afr[4] = {ld_pair(p), ld_pair(p + 8 * ROW_LD), ld_pair(p + 8),
                                 ld_pair(p + 8 * ROW_LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[mi][j], afr, bfr[j]);
      }
    }
    __syncthreads();  // every warp is done reading the A tile: Y takes its place
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) store_fragments<8>(cur + (m0 + 16 * mi) * ROW_LD + n0, ROW_LD, acc[mi], gq, tq);
    __syncthreads();
    const size_t row0 = (size_t)tile * TM;
    for (int v = tid; v < TM * 16; v += THREADS) {
      const int r = v / 16, kq = v % 16;
      if (row0 + r < (size_t)m)
        *reinterpret_cast<uint4*>(y + (row0 + r) * INTER + 8 * kq) =
            *reinterpret_cast<const uint4*>(cur + r * ROW_LD + 8 * kq);
    }
    __syncthreads();  // the stage is free for the load after next
  }
  cp_async_wait<0>();
}

// -----------------------------------------------------------------------------
// probe_scale_copy, probe_scale_copy_staged, probe_scale_copy_bulk: Y = 2.A
// over n bf16 values.
//
// - probe_scale_copy replaces tools/probe_pallas3.py:32 pcopy (body
//   copy_kernel :27): plain 16-byte loads and stores, a vector a thread and
//   one block per 4 KB, as PyTorch's elementwise kernels launch; loads that
//   bypass L1 and leave L2 first, streaming stores.
// - probe_scale_copy_staged and probe_scale_copy_bulk replace
//   tools/probe_pallas4.py:49 dbuf_copy (body dbuf_kernel :13-46), one
//   sequential program with two DMA slots of 8192 rows in and two out. Here a
//   block takes its bytes through stages of 4 KB in shared memory, every
//   stage's load in flight at once, and doubles and stores each stage as it
//   lands: the threads fill three stages with their own cp.async and store
//   from them (staged, 12 KB a block), or bulk copies fill and empty four
//   (bulk, 16 KB a block), as the TPU's DMA engine moves both ways. No block
//   fills a stage twice. Each block asks for enough shared memory that an SM
//   holds three.
// Bound on an H100: memory, 4 bytes moved per value and one multiply; every
// byte is touched once, so nothing the L1 or L2 keeps is read again. Why
// these shapes (a sweep of launch shapes, unrolls, stages and cache policies,
// PERF.md §6): the stream is fastest when the blocks in flight cover a narrow
// band of addresses that moves in order. Persistent blocks that walk at a
// stride of the grid drift apart and lose ~5 %; a block that walks more
// chunks than it has stages loses 1-4 %; an SM that keeps much more than
// ~48 KB in flight loses ~1 %.
// -----------------------------------------------------------------------------

__device__ __forceinline__ uint4 twice8(uint4 v) {
  const __nv_bfloat162 two = __float2bfloat162_rn(2.f);
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __hmul2(p[i], two);
  return v;
}

// the n % 8 values after the last whole vector, by block 0
__device__ __forceinline__ void scale_tail(const bf16* a, bf16* y, size_t n) {
  const size_t i = (n / 8) * 8 + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < 8 && i < n) y[i] = __hmul(a[i], __float2bfloat16_rn(2.f));
}

// an L2 policy under which the lines a copy brings in are the first evicted
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes through the non-coherent path, not allocated in L1, under ``policy``
// in L2. Not volatile: a is read-only, so the compiler may hoist the load.
__device__ __forceinline__ uint4 ld_stream(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__global__ void __launch_bounds__(THREADS)
probe_scale_copy_kernel(const bf16* __restrict__ a, bf16* __restrict__ y, size_t n) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < n / 8) __stcs(reinterpret_cast<uint4*>(y) + i, twice8(ld_stream(reinterpret_cast<const uint4*>(a) + i,
                                                                            l2_evict_first())));
  scale_tail(a, y, n);
}

// A staged block asks for this much shared memory, far more than its stages
// use, so that an SM holds three blocks (each also holds 1 KB of the
// system's): 36 KB (staged) or 48 KB (bulk) in flight an SM.
constexpr size_t COPY_BLOCK_SMEM = 228 * 1024 / 3 - 1024;
constexpr int STAGED_STAGES = 3;  // of THREADS vectors, 4 KB
constexpr int BULK_STAGES = 4;    // the same

// The threads' own cp.async: thread t copies vector t of each of the block's
// three 4 KB chunks into stage s, one group a stage, and stores each stage's
// vector from shared memory as it lands. A thread reads back only the slots
// it copied itself, so cp.async.wait_group orders the stages and no
// block-wide barrier is needed.
__global__ void __launch_bounds__(THREADS)
probe_scale_copy_staged_kernel(const bf16* __restrict__ a, bf16* __restrict__ y, size_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* stages = reinterpret_cast<uint4*>(smem_raw) + threadIdx.x;  // this thread's slot of stage 0
  const uint4* av = reinterpret_cast<const uint4*>(a);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const size_t nvec = n / 8;
  const size_t first = (size_t)blockIdx.x * STAGED_STAGES * THREADS + threadIdx.x;
#pragma unroll
  for (int s = 0; s < STAGED_STAGES; ++s) {
    if (first + s * THREADS < nvec) cp_async16(stages + s * THREADS, av + first + s * THREADS);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < STAGED_STAGES; ++s) {
    cp_async_wait<STAGED_STAGES - 1>();  // stage s has landed: s + 1 of the groups committed
    if (first + s * THREADS < nvec) yv[first + s * THREADS] = twice8(stages[s * THREADS]);
    cp_async_commit();  // an empty group, so that the next wait, too, leaves STAGED_STAGES - 1 open
  }
  scale_tail(a, y, n);
}

// The bulk copies, the counterpart of dbuf_kernel's DMA both ways: no core
// instruction touches device memory. Lane 0 of a ninth warp loads each of the
// block's four 4 KB chunks into its stage with one bulk copy (cp.async.bulk,
// 1-D) that reports its bytes to the stage's "full" mbarrier; the 256 threads
// double a stage in place as it lands, each fences its write for the async
// proxy and arrives on the stage's "doubled" mbarrier; lane 0, once every
// thread has arrived, stores the stage with one bulk copy (a bulk group of
// its own). The threads wait only for data, and no block-wide barrier follows
// the set-up. Loads and stores go under the L2 evict-first policy.
constexpr int BULK_THREADS = THREADS + 32;  // 8 warps that double, 1 whose lane 0 issues the copies

__global__ void __launch_bounds__(BULK_THREADS)
probe_scale_copy_bulk_kernel(const bf16* __restrict__ a, bf16* __restrict__ y, size_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* stages = reinterpret_cast<uint4*>(smem_raw);  // [BULK_STAGES][THREADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + BULK_STAGES * THREADS);  // [BULK_STAGES]: the chunk has landed
  uint64_t* doubled = full + BULK_STAGES;  // [BULK_STAGES]: every thread has doubled its vector of the stage
  const int tid = threadIdx.x;
  const size_t nvec = n / 8;
  const size_t first = (size_t)blockIdx.x * BULK_STAGES * THREADS;
  auto vectors = [&](int s) -> uint32_t {  // of the block's s-th chunk: THREADS but for the last chunks
    const size_t v0 = first + (size_t)s * THREADS;
    return v0 >= nvec ? 0 : nvec - v0 < (size_t)THREADS ? (uint32_t)(nvec - v0) : (uint32_t)THREADS;
  };

  if (tid == 0) {
    for (int s = 0; s < BULK_STAGES; ++s) {
      mbarrier_init(full + s, 1);
      mbarrier_init(doubled + s, THREADS);
    }
  }
  __syncthreads();
  if (tid < THREADS) {
    for (int s = 0; s < BULK_STAGES && vectors(s) > 0; ++s) {
      mbarrier_wait(full + s, 0);
      uint4* v = stages + s * THREADS + tid;
      if (tid < (int)vectors(s)) *v = twice8(*v);
      fence_proxy_async();  // this write, before the bulk store reads it
      mbarrier_arrive(doubled + s);
    }
  } else if (tid == THREADS) {
    const uint64_t policy = l2_evict_first();
    for (int s = 0; s < BULK_STAGES && vectors(s) > 0; ++s) {
      mbarrier_arrive_expect_tx(full + s, 16 * vectors(s));
      bulk_copy_g2s_hint(stages + s * THREADS, a + 8 * (first + s * THREADS), 16 * vectors(s), full + s, policy);
    }
    for (int s = 0; s < BULK_STAGES && vectors(s) > 0; ++s) {
      mbarrier_wait(doubled + s, 0);
      bulk_copy_s2g_hint(y + 8 * (first + s * THREADS), stages + s * THREADS, 16 * vectors(s), policy);
      bulk_commit();
    }
    bulk_wait<0>();  // every store has written before the block's shared memory is released
  }
  scale_tail(a, y, n);
}

// -----------------------------------------------------------------------------
// probe_conv1: out = round(relu(cat(s0..s_{n-1}).a + b)) . W1, (P,C) -> (P,128).
//
// Replaces tools/probe_pallas5.py:69 seg_conv1 (body _seg_kernel :58) and :99
// mono_conv1 (body _mono_kernel :91): a kernel that takes 1 to 8 segment
// arrays (P, width_i) by pointer and width and never forms their concat in
// device memory; with one segment it reads the concatenated array. It is
// the dense layer's t.W1 stage with the x loader finding each 8-channel
// vector's segment; a and b are indexed by the channel's place in the
// virtual concat. Two bodies:
// - "mma": gemm1_bf16 of mma_bf16.cuh (mma.sync fragments loaded by every
//   warp); one block per 128 pixels, two per SM; W1 staged chunk by chunk
//   from L2 with block barriers.
// - "wgmma": K2's body, tw1_stream of wgmma_bf16.cuh (persistent blocks of
//   two warpgroups, W1 resident, t staged under the products), with an
//   epilogue that rounds h and stores it.
// Both results leave through shared memory in 16-byte rows.
//
// Bound on an H100: memory, 2*P*(C + 128) bytes against 2*P*C*128 FLOP (71
// FLOP per byte at C = 160). Segments change nothing in the bytes, only the
// row stride of each read, which is what the probe measures.
// -----------------------------------------------------------------------------

constexpr int MAX_SEGS = 8;
constexpr int C1_ROWS = 128;

struct Segments {
  const bf16* ptr[MAX_SEGS];
  int width[MAX_SEGS];
  int n;
  // where the 8 channels c .. c+7 of the virtual concat lie; every width is
  // a multiple of 8, so they lie in one segment
  __device__ __forceinline__ XColumn column(int c) const {
    XColumn col = {ptr[0], width[0]};
    int start = 0;
#pragma unroll
    for (int i = 0; i < MAX_SEGS; ++i) {
      const int w = i < n ? width[i] : 0;
      if (c >= start && c < start + w) col = {ptr[i] + (c - start), w};
      start += w;
    }
    return col;
  }
};

struct SegmentAt {
  const Segments& s;
  __device__ __forceinline__ const bf16* operator()(int gp, int c) const {
    const XColumn col = s.column(c);
    return col.base + (size_t)gp * col.ld;
  }
};

constexpr size_t C1_SMEM = 2 * (size_t)(C1_ROWS * TB_LD + INTER * TB_LD + C1_ROWS * ROW_LD) + 4 * C1_ROWS;

__global__ void __launch_bounds__(THREADS, 2)
probe_conv1_kernel(const __grid_constant__ Segments segs, const float* __restrict__ a, const float* __restrict__ b,
                   const bf16* __restrict__ w1t, bf16* __restrict__ out, int npix, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ts = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1s = ts + C1_ROWS * TB_LD;
  bf16* os = w1s + INTER * TB_LD;  // the block's (128, 128) result
  int* pix = reinterpret_cast<int*>(os + C1_ROWS * ROW_LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * C1_ROWS;
  for (int row = tid; row < C1_ROWS; row += THREADS) pix[row] = p0 + row < npix ? p0 + row : -1;

  float acc[C1_ROWS / 64][8][4];
  gemm1_bf16<C1_ROWS / 64>(SegmentAt{segs}, a, b, w1t, C, pix, ts, w1s, acc);

  const int m0 = 16 * (C1_ROWS / 64) * (warp % 4), n0 = 64 * (warp / 4);
#pragma unroll
  for (int mi = 0; mi < C1_ROWS / 64; ++mi) store_fragments<8>(os + (m0 + 16 * mi) * ROW_LD + n0, ROW_LD, acc[mi], gq, tq);
  __syncthreads();
  for (int v = tid; v < C1_ROWS * 16; v += THREADS) {
    const int r = v / 16, kq = v % 16;
    if (p0 + r < npix)
      *reinterpret_cast<uint4*>(out + (size_t)(p0 + r) * INTER + 8 * kq) =
          *reinterpret_cast<const uint4*>(os + r * ROW_LD + 8 * kq);
  }
}

constexpr int C1W_RES = 4;                        // W1 chunks resident: C <= 256 (the probe's C is 160)
typedef TW1Smem<C1W_RES> C1WS;
constexpr uint32_t C1W_OS = (C1WS::BYTES + 127) / 128 * 128;  // the staged rows of h
constexpr uint32_t C1W_OS_LD = 2 * INTER + 16;    // bytes of a staged row, padded: conflict-free stmatrix
constexpr size_t C1W_SMEM = C1W_OS + TW1_ROWS * C1W_OS_LD;
static_assert(C1W_SMEM <= 232448, "a block's shared memory");

__global__ void __launch_bounds__(TW1_THREADS, 1)
probe_conv1_wgmma_kernel(const __grid_constant__ Segments segs, const float* __restrict__ a,
                         const float* __restrict__ b, const bf16* __restrict__ w1p, bf16* __restrict__ out, int npix,
                         int C) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* os = smem_wg + C1W_OS;
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lw = tid % WG_THREADS, warp = lw / 32, lane = tid % 32;
  // the warpgroup's 64 rows of h, rounded, into os by stmatrix (the blocks as in
  // conv2_flat_stage), then 16-byte rows to out; a warpgroup stores what it staged
  auto store = [&](const float (&acc)[64], int tile) {
    const uint32_t orow = smem_u32(os) + (64 * wg + 16 * warp + lane % 16) * C1W_OS_LD + (lane / 16) * 16;
#pragma unroll
    for (int j = 0; j < INTER / 8; j += 2) {
      const uint32_t v[4] = {pack_pair(acc[4 * j], acc[4 * j + 1]), pack_pair(acc[4 * j + 2], acc[4 * j + 3]),
                             pack_pair(acc[4 * j + 4], acc[4 * j + 5]), pack_pair(acc[4 * j + 6], acc[4 * j + 7])};
      stmatrix_x4(orow + j * 16, v);
    }
    warpgroup_sync(wg);
#pragma unroll
    for (int v = lw; v < 64 * (INTER / 8); v += WG_THREADS) {
      const int row = 64 * wg + v / (INTER / 8), part = v % (INTER / 8);
      const int p = tile * TW1_ROWS + row;
      if (p < npix)
        *reinterpret_cast<uint4*>(out + (size_t)p * INTER + 8 * part) =
            *reinterpret_cast<const uint4*>(os + row * C1W_OS_LD + 16 * part);
    }
    // os is next written in the next tile's epilogue, after at least one block barrier
  };
  tw1_stream<C1W_RES>(segs, a, b, w1p, npix, C, smem_wg, store);
}

// -----------------------------------------------------------------------------
// probe_conv2: f = 3x3 conv of g, zero padding, 128 -> 32 channels, two bodies.
//
// Replaces tools/probe_pallas5.py:158 conv2 with its bodies :123
// _conv2_9dot_kernel and :139 _conv2_packed_kernel (which Mosaic never
// compiled: its record on the TPU is interpret mode).
//
// Bound on an H100: memory by a little, 2*P*(128 + 32) bytes (0.20 ms at
// P = 2^21) against 2*P*9*128*32 FLOP (0.16 ms), so the design has to do both
// well: W2 (72 KB as (9, 32, 128), per tap and output channel its 128
// inputs) is staged once per persistent block and stays, the halo tile of g
// arrives through a two-stage cp.async ring, read from g with the positions
// outside the image set to zero (no halo array), and warp w owns output row
// w of the tile, whose 32 channels leave through shared memory in 16-byte
// vectors.
//
// taps9: the tile is 8 x 16 pixels (halo 10 x 18). Per tap, a
// (16, 128) x (128, 32) product of the tile row shifted by (dy, dx),
// accumulated in registers: K1's second stage.
//
// packed: one product with all nine taps side by side, N = 288, and the nine
// 32-wide slices of its result added at their shifts. The (halo pixels, 288)
// fp32 result of an 8 x 16 tile would be 207 KB, all the shared memory a block
// has. Chosen instead: the tile is 8 x 14 pixels, so that a halo row is 16
// pixels, exactly one m16 fragment tile, and the product is taken a tap row
// at a time: for dy = 0..2 warp w multiplies halo row w + dy by the 96
// columns of that tap row. All three land on output row w, so the dy shift is
// the accumulator itself (K = 3*128), and the dx shift moves a value from
// halo pixel x + dx to output pixel x: to the lane 4*dx further on, by warp
// shuffle. The 288-wide result never leaves registers. The price is 16 halo
// pixels multiplied for 14 outputs (1.14x taps9's tensor-core work, not the
// 1.4x of a full halo tile); the gain is one A fragment per 12 products
// instead of per 4. The two bodies add the nine terms in different orders.
// -----------------------------------------------------------------------------

constexpr int C2_TH = 8;
constexpr int C2_TAPS = 9;
constexpr int C2_OS_LD = GROWTH + 8;

template <bool PACKED>
struct Conv2Tile {
  static constexpr int TW = PACKED ? 14 : 16;  // output tile width
  static constexpr int HW = TW + 2;            // halo width
  static constexpr int HPIX = (C2_TH + 2) * HW;
  static constexpr size_t SMEM =
      2 * (size_t)(C2_TAPS * GROWTH * ROW_LD + 2 * HPIX * ROW_LD + C2_TH * 16 * C2_OS_LD);
};

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
probe_conv2_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w2r, bf16* __restrict__ out,
                   int B, int H, int W) {
  typedef Conv2Tile<PACKED> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw);    // [9*32][128]: tap, output channel, inputs
  bf16* ring = w2s + C2_TAPS * GROWTH * ROW_LD;     // [2][HPIX][128]
  bf16* os = ring + 2 * T::HPIX * ROW_LD;           // [8 * 16][32], warp w's row at 16*w

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int tiles_x = (W + T::TW - 1) / T::TW, tiles_y = (H + C2_TH - 1) / C2_TH;
  const int ntiles = B * tiles_y * tiles_x;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_tile = [&](int tile, bf16* dst) {
    const int x0 = (tile % tiles_x) * T::TW, y0 = (tile / tiles_x % tiles_y) * C2_TH;
    const int b = tile / (tiles_x * tiles_y);
    for (int v = tid; v < T::HPIX * 16; v += THREADS) {
      const int r = v / 16, kq = v % 16;
      const int iy = y0 - 1 + r / T::HW, ix = x0 - 1 + r % T::HW;
      bf16* d = dst + r * ROW_LD + 8 * kq;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) cp_async16(d, g + ((size_t)(b * H + iy) * W + ix) * INTER + 8 * kq);
      else *reinterpret_cast<uint4*>(d) = zero;  // conv2's zero padding
    }
  };

  for (int v = tid; v < C2_TAPS * GROWTH * 16; v += THREADS)
    cp_async16(w2s + (v / 16) * ROW_LD + 8 * (v % 16), w2r + (size_t)v * 8);
  int tile = blockIdx.x;
  if (tile < ntiles) load_tile(tile, ring);
  cp_async_commit();

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const bf16* cur = ring + (it & 1) * T::HPIX * ROW_LD;
    if (tile + (int)gridDim.x < ntiles) load_tile(tile + gridDim.x, ring + ((it & 1) ^ 1) * T::HPIX * ROW_LD);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and W2) has landed; the next may be in flight
    __syncthreads();

    bf16* orow = os + warp * 16 * C2_OS_LD;
    if constexpr (!PACKED) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int tap = 0; tap < C2_TAPS; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const bf16* g_lo = cur + ((warp + dy) * T::HW + gq + dx) * ROW_LD + 2 * tq;  // pixel x = gq
        const bf16* g_hi = g_lo + 8 * ROW_LD;                                        // pixel x = gq + 8
        const bf16* wt = w2s + (tap * GROWTH + gq) * ROW_LD + 2 * tq;
#pragma unroll
        for (int ks = 0; ks < INTER; ks += 16) {
          const uint32_t afr[4] = {ld_pair(g_lo + ks), ld_pair(g_hi + ks), ld_pair(g_lo + ks + 8),
                                   ld_pair(g_hi + ks + 8)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* p = wt + 8 * j * ROW_LD + ks;
            const uint32_t bfr[2] = {ld_pair(p), ld_pair(p + 8)};
            mma_bf16_16816(acc[j], afr, bfr);
          }
        }
      }
      store_fragments<4>(orow, C2_OS_LD, acc, gq, tq);
    } else {
      // acc[4*dx + j]: halo pixels gq and gq + 8 of the row, tap column dx, channels 8*j ..
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int dy = 0; dy < 3; ++dy) {
        const bf16* g_lo = cur + ((warp + dy) * T::HW + gq) * ROW_LD + 2 * tq;  // halo pixel gq
        const bf16* g_hi = g_lo + 8 * ROW_LD;                                   // halo pixel gq + 8
        const bf16* wt = w2s + (dy * 3 * GROWTH + gq) * ROW_LD + 2 * tq;
#pragma unroll
        for (int ks = 0; ks < INTER; ks += 16) {
          const uint32_t afr[4] = {ld_pair(g_lo + ks), ld_pair(g_hi + ks), ld_pair(g_lo + ks + 8),
                                   ld_pair(g_hi + ks + 8)};
#pragma unroll
          for (int j = 0; j < 12; ++j) {
            const bf16* p = wt + 8 * j * ROW_LD + ks;
            const uint32_t bfr[2] = {ld_pair(p), ld_pair(p + 8)};
            mma_bf16_16816(acc[j], afr, bfr);
          }
        }
      }
      // output pixel x takes tap column dx from halo pixel x + dx, which the
      // lane 4*dx further on holds: as its pixel gq' = gq + dx, or, past the
      // warp's end (gq + dx >= 8), as pixel gq' + 8 of lane gq' = gq + dx - 8.
      // Pixels 14 and 15 are no outputs, so pixel gq + 8 never needs the wrap.
#pragma unroll
      for (int dx = 1; dx < 3; ++dx) {
        const int src = (lane + 4 * dx) % 32;
        const bool wrapped = gq + dx >= 8;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lo = __shfl_sync(0xffffffffu, acc[4 * dx + j][e], src);
            const float hi = __shfl_sync(0xffffffffu, acc[4 * dx + j][2 + e], src);
            acc[j][e] += wrapped ? hi : lo;
            acc[j][2 + e] += wrapped ? 0.f : hi;
          }
      }
      store_fragments<4>(orow, C2_OS_LD, acc, gq, tq);
    }
    __syncthreads();  // the tile's outputs are staged, and every warp is done reading g
    {
      const int x0 = (tile % tiles_x) * T::TW, y0 = (tile / tiles_x % tiles_y) * C2_TH;
      const int b = tile / (tiles_x * tiles_y);
      for (int v = tid; v < C2_TH * T::TW * 4; v += THREADS) {
        const int q = v / 4, kq = v % 4;
        const int ty = q / T::TW, tx = q % T::TW;
        const int oy = y0 + ty, ox = x0 + tx;
        if (oy < H && ox < W)
          *reinterpret_cast<uint4*>(out + ((size_t)(b * H + oy) * W + ox) * GROWTH + 8 * kq) =
              *reinterpret_cast<const uint4*>(os + (ty * 16 + tx) * C2_OS_LD + 8 * kq);
      }
    }
    __syncthreads();  // os and the stage are free for the tile after next
  }
  cp_async_wait<0>();
}

// -----------------------------------------------------------------------------
// probe_conv2, third body "wgmma": the same function on Hopper's warpgroup
// products (wgmma_bf16.cuh has the layout and the reasoning).
//
// What held taps9 and packed at 19-20 % of the bound: with mma.sync every warp
// loads its own A and B fragments from shared memory, 1,536 bytes per 16,384
// FLOP, three times what the shared memory delivers in the time the tensor
// cores need for them, and W2 is read again by each of 8 warps. Here the
// tensor core reads g and W2 from shared memory itself, once per 64 rows, and
// no fragment load is in the instruction stream.
//
// The tile is 8 x TW pixels, its halo stored by flat index so that a tap is a
// row offset of the A descriptor (no gather); M2 warpgroups each own 64 flat
// indices and start the 24 products of their rows (N = 96: a kernel row's
// three taps side by side) back to back under one commit, then bring the
// three shares of each output together. TW = 22: the halo is 24 wide, 190
// flat indices hold the 176 outputs, so three 64-row tiles compute 192 rows
// for 176 results (1.09x the conv's work; TW = 16 would be 192 for 128,
// 1.5x), and two halo stages, W2 and the staged outputs fit in 220 KB. W2 is
// resident, halo tiles arrive through the two-stage cp.async ring straight
// into the descriptor layout (positions outside the image are written as
// zeros: conv2's zero padding), and the 32 channels leave through shared
// memory in 16-byte vectors. On an H100 the products of a tile take ~2.2 us
// of its ~4.9; the rest is the tile's 3,840 16-byte copies being sent off by
// the threads that also start the products, and the epilogue, neither of
// which runs under another tile's products.
// -----------------------------------------------------------------------------

template <int TW>
constexpr size_t conv2_wgmma_smem() {
  return W2_BYTES + 2 * (size_t)FlatTile<TW>::G_BYTES + FlatTile<TW>::OS_BYTES +
         (4 * FlatTile<TW>::M2 + 1) * XCH_WARP * sizeof(float);
}
static_assert(conv2_wgmma_smem<22>() <= 232448, "a block's shared memory");

template <int TW>
__global__ void __launch_bounds__(WG_THREADS * FlatTile<TW>::M2, 1)
probe_conv2_wgmma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w2r, bf16* __restrict__ out,
                         int B, int H, int W) {
  typedef FlatTile<TW> T;
  constexpr int NT = WG_THREADS * T::M2;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* w2s = smem_wg;
  unsigned char* ring = w2s + W2_BYTES;          // [2] halo tiles, [k / 8][flat index][8]
  unsigned char* os = ring + 2 * T::G_BYTES;     // staged outputs
  float* xch = reinterpret_cast<float*>(os + T::OS_BYTES);  // rows handed from warp to warp (conv2_flat_share)

  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + T::TH - 1) / T::TH;
  const int ntiles = B * tiles_y * tiles_x;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_tile = [&](const TileWalk& at, unsigned char* dst) {
    const int x0 = at.tx * TW, y0 = at.ty * T::TH, b = at.b;
    for (int v = tid; v < T::HPIX * (INTER / 8); v += NT) {
      const int r = v / (INTER / 8), oct = v % (INTER / 8);
      const int iy = y0 - 1 + r / T::HW, ix = x0 - 1 + r % T::HW;
      unsigned char* d = dst + oct * T::G_PLANE + r * 16;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) cp_async16(d, g + ((size_t)(b * H + iy) * W + ix) * INTER + 8 * oct);
      else *reinterpret_cast<uint4*>(d) = zero;  // conv2's zero padding
    }
  };

  // the rows past the halo feed only results that are dropped; zero them once
  for (int v = tid; v < 2 * (INTER / 8) * (T::G_ROWS - T::HPIX); v += NT) {
    const int r = T::HPIX + v % (T::G_ROWS - T::HPIX), plane = v / (T::G_ROWS - T::HPIX);
    *reinterpret_cast<uint4*>(ring + plane * T::G_PLANE + r * 16) = zero;
  }
  stage_w2(w2s, w2r, tid, NT);
  int tile = blockIdx.x;
  TileWalk at(tile, gridDim.x, tiles_x, tiles_y);  // the tile that is loaded next
  if (tile < ntiles) load_tile(at, ring);
  cp_async_commit();

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int x0 = at.tx * TW, y0 = at.ty * T::TH, b = at.b;
    cp_async_wait<0>();   // this tile (and W2) has landed
    fence_proxy_async();  // ... and is visible to the tensor core's reads
    __syncthreads();      // every thread also waited for the last tile's products: its stage is free
    at.advance();
    if (tile + (int)gridDim.x < ntiles) load_tile(at, ring + ((it & 1) ^ 1) * T::G_BYTES);
    cp_async_commit();    // in flight under this tile's products

    // The wait stands in straight code right after the products: with products
    // in flight across a loop or a branch (the last tile's results stored under
    // them, say) the compiler adds waits of its own or serialises them all.
    float acc3[48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc3[i] = 0.f;
    wgmma_fence_acc(acc3);
    wgmma_fence();
    conv2_flat_mma<TW>(acc3, smem_u32(ring + (it & 1) * T::G_BYTES), 64 * wg, smem_u32(w2s));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(acc3);
    conv2_flat_share(xch, acc3, tid / 32, tid % 32);
    __syncthreads();
    float acc[16];
    conv2_flat_combine(acc, acc3, xch, tid / 32, tid % 32);
    // a warpgroup stages and stores its own 64 rows: its barrier, not the block's
    conv2_flat_stage<TW>(os, acc, 64 * wg, tid % WG_THREADS);
    warpgroup_sync(wg);
    conv2_flat_store<TW>(os, out, GROWTH, 64 * wg, b, y0, x0, H, W, tid % WG_THREADS);
  }
  cp_async_wait<0>();
}

// -----------------------------------------------------------------------------
// The wgmma self-check: d (64, N) fp32 = reps * a[row_off .. row_off + 64] . b^T
// for a (rows, k) and b (N, k), through the descriptor helper and the
// m64nNk16 wrappers of wgmma_bf16.cuh, by one warpgroup per block. A wrong LBO
// or SBO gives wrong numbers, not an error, so the layout the kernels rely on
// (planes of 8 k values, a_rows >= rows of 16 bytes each; a tile starting at
// any row) is held against torch.matmul for each N they use (96 and 128) and for N = 32,
// the conv's shape before its taps were packed, kept for its rate. With reps > 1
// and many blocks the same launch is a rate measurement: every block repeats
// the product, so its time over the products started is what one wgmma costs an
// SM at that N, alignment (row_off, a_rows) and number of warpgroups. Not a
// kernel of any path.
// -----------------------------------------------------------------------------

constexpr int SC_MAX_ROWS = 137, SC_MAX_K = 128;

template <int N>
constexpr size_t selfcheck_smem() { return (SC_MAX_K / 8) * (size_t)(SC_MAX_ROWS + N + 1) * 16; }

template <int N>
__global__ void __launch_bounds__(WG_THREADS)
wgmma_selfcheck_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ d, int rows, int k,
                       int row_off, int a_rows, int reps) {
  constexpr uint32_t B_PLANE = (N + 1) * 16;
  const uint32_t a_plane = a_rows * 16;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  unsigned char* as = smem_wg;
  unsigned char* bs = as + (SC_MAX_K / 8) * SC_MAX_ROWS * 16;
  const int tid = threadIdx.x, kv = k / 8;
  for (int v = tid; v < rows * kv; v += WG_THREADS) cp_async16(as + (v % kv) * a_plane + (v / kv) * 16, a + (size_t)v * 8);
  for (int v = tid; v < N * kv; v += WG_THREADS) cp_async16(bs + (v % kv) * B_PLANE + (v / kv) * 16, b + (size_t)v * 8);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence_acc(acc);
  const uint64_t da = wgmma_desc(smem_u32(as) + row_off * 16, a_plane, CORE_BYTES);
  const uint64_t db = wgmma_desc(smem_u32(bs), B_PLANE, CORE_BYTES);
  for (int rep = 0; rep < reps; ++rep) {
    wgmma_fence();
    for (int ks = 0; ks < k / 16; ++ks) {
      if constexpr (N == 32) wgmma_m64n32k16(acc, desc_advance(da, ks * 2 * a_plane), desc_advance(db, ks * 2 * B_PLANE), (rep | ks) != 0);
      else if constexpr (N == 96) wgmma_m64n96k16(acc, desc_advance(da, ks * 2 * a_plane), desc_advance(db, ks * 2 * B_PLANE), (rep | ks) != 0);
      else wgmma_m64n128k16(acc, desc_advance(da, ks * 2 * a_plane), desc_advance(db, ks * 2 * B_PLANE), (rep | ks) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // one group stays in flight behind the one being started
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
  if (blockIdx.x != 0) return;
  const int warp = tid / 32, gq = tid % 32 / 4, tq = tid % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(16 * warp + gq + 8 * (e / 2)) * N + 8 * j + 2 * tq + e % 2] = acc[4 * j + e];
}

template <int N>
int launch_selfcheck(const void* a, const void* b, void* d, int rows, int k, int row_off, int a_rows, int reps,
                     int blocks, cudaStream_t stream) {
  if (int err = set_smem(wgmma_selfcheck_kernel<N>, selfcheck_smem<N>())) return err;
  wgmma_selfcheck_kernel<N><<<blocks, WG_THREADS, selfcheck_smem<N>(), stream>>>((const bf16*)a, (const bf16*)b, (float*)d,
                                                                               rows, k, row_off, a_rows, reps);
  return (int)cudaGetLastError();
}

constexpr int C2_WGMMA_TW = 22;

template <int TW>
int launch_conv2_wgmma(const void* g, const void* w2r, void* out, int B, int H, int W, cudaStream_t stream) {
  typedef FlatTile<TW> T;
  constexpr int NT = WG_THREADS * T::M2;
  if (int err = set_smem(probe_conv2_wgmma_kernel<TW>, conv2_wgmma_smem<TW>())) return err;
  const long long ntiles = (long long)B * ((H + T::TH - 1) / T::TH) * ((W + TW - 1) / TW);
  int grid = 0;
  if (int err = persistent_grid(probe_conv2_wgmma_kernel<TW>, NT, conv2_wgmma_smem<TW>(), ntiles, 1, &grid)) return err;
  probe_conv2_wgmma_kernel<TW><<<grid, NT, conv2_wgmma_smem<TW>(), stream>>>((const bf16*)g, (const bf16*)w2r, (bf16*)out,
                                                                            B, H, W);
  return (int)cudaGetLastError();
}

template <int MI>
int launch_mm(const void* a, const void* bt, void* y, int m, cudaStream_t stream) {
  if (int err = set_smem(probe_mm_kernel<MI>, mm_smem<MI>())) return err;
  int grid = 0;
  if (int err = persistent_grid(probe_mm_kernel<MI>, THREADS, mm_smem<MI>(), (m + 64 * MI - 1) / (64 * MI), 8, &grid)) return err;
  probe_mm_kernel<MI><<<grid, THREADS, mm_smem<MI>(), stream>>>((const bf16*)a, (const bf16*)bt, (bf16*)y, m);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_conv2(const void* g, const void* w2r, void* out, int B, int H, int W, cudaStream_t stream) {
  typedef Conv2Tile<PACKED> T;
  if (int err = set_smem(probe_conv2_kernel<PACKED>, T::SMEM)) return err;
  const long long ntiles = (long long)B * ((H + C2_TH - 1) / C2_TH) * ((W + T::TW - 1) / T::TW);
  int grid = 0;
  if (int err = persistent_grid(probe_conv2_kernel<PACKED>, THREADS, T::SMEM, ntiles, 1, &grid)) return err;
  probe_conv2_kernel<PACKED><<<grid, THREADS, T::SMEM, stream>>>((const bf16*)g, (const bf16*)w2r, (bf16*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns a CUDA error code (0 = success): that of its
// set-up calls, or cudaGetLastError() after its launch. All tensors are
// contiguous bf16 and 16-byte aligned unless said otherwise.

// a (m,128), bt = B transposed (128,128), y (m,128); tile_rows 64, 128 or 256
int fdgan_probe_mm(const void* a, const void* bt, void* y, int m, int tile_rows, void* stream) {
  switch (tile_rows) {
    case 64: return launch_mm<1>(a, bt, y, m, (cudaStream_t)stream);
    case 128: return launch_mm<2>(a, bt, y, m, (cudaStream_t)stream);
    case 256: return launch_mm<4>(a, bt, y, m, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y = 2a over n values; mode 0: the plain copy, 1: the cp.async stages, 2:
// the bulk stages
int fdgan_probe_scale_copy(const void* a, void* y, long long n, int mode, void* stream) {
  const bf16* av = (const bf16*)a;
  bf16* yv = (bf16*)y;
  if (n < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const int per_block = mode == 0 ? THREADS : mode == 1 ? STAGED_STAGES * THREADS : BULK_STAGES * THREADS;
  const long long blocks = (n / 8 + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int grid = blocks > 0 ? (int)blocks : 1;
  if (mode == 0) {
    probe_scale_copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(av, yv, (size_t)n);
  } else if (mode == 1) {
    if (int err = set_smem(probe_scale_copy_staged_kernel, COPY_BLOCK_SMEM)) return err;
    probe_scale_copy_staged_kernel<<<grid, THREADS, COPY_BLOCK_SMEM, (cudaStream_t)stream>>>(av, yv, (size_t)n);
  } else {
    if (int err = set_smem(probe_scale_copy_bulk_kernel, COPY_BLOCK_SMEM)) return err;
    probe_scale_copy_bulk_kernel<<<grid, BULK_THREADS, COPY_BLOCK_SMEM, (cudaStream_t)stream>>>(av, yv, (size_t)n);
  }
  return (int)cudaGetLastError();
}

// segs: nseg (1..8) pointers to (npix, widths[i]) arrays, widths multiples of
// 8 summing to C; a, b fp32 (C); out (npix,128). body 0: mma, with w1 = W1
// transposed (128, C); 1: wgmma, with w1 = W1 as planes (C/8, 128, 8)
int fdgan_probe_conv1(const void* const* segs, const int* widths, int nseg, const void* a,
                      const void* b, const void* w1, void* out, int npix, int body, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS) return (int)cudaErrorInvalidValue;
  Segments s = {};
  int C = 0;
  for (int i = 0; i < nseg; ++i) {
    s.ptr[i] = (const bf16*)segs[i];
    s.width[i] = widths[i];
    C += widths[i];
  }
  s.n = nseg;
  if (body == 1) {
    if (int err = set_smem(probe_conv1_wgmma_kernel, C1W_SMEM)) return err;
    static int resident[MAX_DEVICES] = {};
    int grid = 0;
    if (int err = persistent_grid(probe_conv1_wgmma_kernel, TW1_THREADS, C1W_SMEM, (npix + TW1_ROWS - 1) / TW1_ROWS, 1,
                                  &grid, resident))
      return err;
    probe_conv1_wgmma_kernel<<<grid, TW1_THREADS, C1W_SMEM, (cudaStream_t)stream>>>(
        s, (const float*)a, (const float*)b, (const bf16*)w1, (bf16*)out, npix, C);
  } else if (body == 0) {
    if (int err = set_smem(probe_conv1_kernel, C1_SMEM)) return err;
    probe_conv1_kernel<<<(npix + C1_ROWS - 1) / C1_ROWS, THREADS, C1_SMEM, (cudaStream_t)stream>>>(
        s, (const float*)a, (const float*)b, (const bf16*)w1, (bf16*)out, npix, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g (B,H,W,128), w2r (9,32,128), out (B,H,W,32); body 0: taps9, 1: packed,
// 2: wgmma
int fdgan_probe_conv2(const void* g, const void* w2r, void* out, int B, int H, int W, int body,
                      void* stream) {
  switch (body) {
    case 0: return launch_conv2<false>(g, w2r, out, B, H, W, (cudaStream_t)stream);
    case 1: return launch_conv2<true>(g, w2r, out, B, H, W, (cudaStream_t)stream);
    case 2: return launch_conv2_wgmma<C2_WGMMA_TW>(g, w2r, out, B, H, W, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// d (64, n) fp32 = reps * a[row_off .. row_off + 64] . b^T; a (rows, k), b (n, k)
// bf16; n 32, 96 or 128, k a multiple of 16 up to 128, row_off + 64 <= rows <=
// a_rows <= 137 (a_rows: rows of a plane of a in shared memory); every one of
// ``blocks`` blocks computes it, block 0 writes it
int fdgan_wgmma_selfcheck(const void* a, const void* b, void* d, int rows, int n, int k, int row_off,
                          int a_rows, int reps, int blocks, void* stream) {
  if (k < 16 || k % 16 || k > SC_MAX_K || row_off < 0 || row_off + 64 > rows || rows > a_rows ||
      a_rows > SC_MAX_ROWS || reps < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 32: return launch_selfcheck<32>(a, b, d, rows, k, row_off, a_rows, reps, blocks, (cudaStream_t)stream);
    case 96: return launch_selfcheck<96>(a, b, d, rows, k, row_off, a_rows, reps, blocks, (cudaStream_t)stream);
    case 128: return launch_selfcheck<128>(a, b, d, rows, k, row_off, a_rows, reps, blocks, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
