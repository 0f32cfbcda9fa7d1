// K1: VALID 3x3 convolution, stride 1, groups 1, NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pasta_tpu/ops/pallas_conv.py::conv3x3_valid
// (both its C_in=64 lane-packed branch and its C_in=128 direct branch).
// Contract, as there: x [N, H+2, W', C_in] already carries its 1-px halo,
// w is HWIO flattened to [9*C_in, C_out], out is [N, H, out_w, C_out] in the
// input dtype, accumulation in fp32. Columns of x past out_w + 2 are never
// used by a stored output.
//
// bf16 design: an implicit GEMM on the tensor cores (mma.sync m16n8k16 bf16,
// fp32 accumulators in registers, fragments read with ldmatrix). One block
// computes ROWS output rows x BM = 128 output pixels (M = ROWS * 128) by all
// C_out channels (N = BN, 64 or 128); K = 9 taps x C_in in steps of 16.
// The block copies its (ROWS+2) x (BM+2) x C_in input slab into shared
// memory once (cp.async), so each input pixel is read from device memory
// about (ROWS+2)/ROWS times instead of 9, and each tap's weights are
// fetched once per ROWS output rows. Each tap's [C_in, BN] weight slice
// streams through a two-stage cp.async ring, the next tap's copy in flight
// while the current tap computes. Warps tile the block 2*ROWS (M, 64
// pixels each) x 2 (N, BN/2 channels each). Row strides are padded by 16
// bytes (C_in + 8, BN + 8 elements), which keeps every ldmatrix phase free
// of bank conflicts. The epilogue rounds to bf16 in registers, stages the
// tile in shared memory (over the slab) and writes 16-byte vectors.
// Shared memory for 128 -> 128 at ROWS = 2: 141 KB slab + 2 x 34 KB weights.
// The TPU blocking (two W columns packed into 128 lanes, lane rolls,
// double-buffered DMA slabs per grid step) is TPU layout and is not carried
// over; the ragged H and W edges are masked instead of the TPU's
// H % block_rows restriction.
//
// fp32 design: an implicit GEMM on the CUDA cores (FFMA; full fp32 products,
// so R1's gradients keep their accuracy -- one-pass TF32 would keep about
// three digits). The four training shapes are compute bound by ~10x
// (154.6 GFLOP over 0.8 GB at [4,514,514,128]->64: 2.31 ms at the 67 TFLOP/s
// fp32 peak against 0.24 ms of device memory traffic), so what counts is
// FFMAs per load. A thread that reads both operands from global
// memory does 0.5 FFMA per load and is bound by the load/store units; this
// kernel reaches 19 FFMAs per shared-memory load instruction:
//  - The image is taken as one flat run of positions q = y * W' + x. Output
//    q reads inputs q + kr * W' + kc, so a block computes BMQ consecutive
//    positions (256 at BN = 64, 128 at BN = 128) by BN channels whatever the
//    row width: positions with x >= out_w are computed and not stored, a
//    waste of 2 / W' (0.4% at 514, 0.8% at 258) where 2-D tiles of 128
//    pixels waste 25% at the input gradient's 514-wide rows.
//  - Each thread keeps an 8 x 8 accumulator tile in registers: two runs of 4
//    consecutive positions (4 * tx and BMQ/2 + 4 * tx) by two runs of 4
//    channels (4 * ty and BN/2 + 4 * ty), so that a warp's 16-byte
//    shared-memory loads fall on consecutive addresses: no bank conflicts.
//  - C_in is staged in chunks of CK = 8 channels through a two-stage
//    cp.async ring (the whole slab in fp32 would not fit): per chunk the
//    three tap rows' BMQ + 2 positions, transposed on the way in to
//    [row][channel][position] (4-byte cp.async; row stride BMQ + 4 words
//    keeps the transposed writes on 32 distinct banks), and the chunk's
//    [9][CK][BN] weights beside it. The accumulators persist across chunks.
//  - Along a row the 4 + 2 input values a thread loads for one channel and
//    one run serve all three kc taps from registers: per (channel, kr) a
//    thread makes 4 loads of A and 6 of B for 192 FFMAs.
//  - 256 threads and at most 128 registers a thread, 86-98 KB of shared
//    memory a block: two blocks per SM, one computing while the other waits
//    for its copies. The epilogue writes 16-byte vectors straight from
//    registers (a warp's store covers full 64-byte runs of channels).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <int CI, int BN>
struct Cfg {
  static constexpr int ROWS = 2;              // output rows per block
  static constexpr int BM = 128;              // output pixels per row
  static constexpr int WM = 64;               // pixels per warp
  static constexpr int WARPS_M = ROWS * BM / WM;
  static constexpr int WARPS_N = 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WN = BN / WARPS_N;     // channels per warp
  static constexpr int FM = WM / 16;          // m16 tiles per warp
  static constexpr int FN = WN / 8;           // n8 tiles per warp
  static constexpr int SLAB_ROWS = ROWS + 2;
  static constexpr int SLAB_W = BM + 2;       // input columns a block reads
  static constexpr int LDA = CI + 8;          // slab pixel stride (elements)
  static constexpr int LDB = BN + 8;          // weight row stride
  static constexpr int LDC = BN + 8;          // bf16 epilogue row stride
  static constexpr int SLAB_BYTES = SLAB_ROWS * SLAB_W * LDA * 2;
  static constexpr int EPI_BYTES = ROWS * BM * LDC * 2;
  static constexpr int R0 =
      ((SLAB_BYTES > EPI_BYTES ? SLAB_BYTES : EPI_BYTES) + 127) / 128 * 128;
  static constexpr int W_BYTES = CI * LDB * 2;  // one tap's weights
  static constexpr int SMEM = R0 + 2 * W_BYTES;
  // Two blocks per SM where shared memory allows and the accumulators are
  // small enough (BN = 64: 64 fp32 a thread) to fit 128 registers.
  static constexpr int MIN_BLOCKS = (BN == 64 && 2 * SMEM <= 232448) ? 2 : 1;
  static_assert(FN % 2 == 0, "B fragments load in pairs");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tap `tap`'s weights [CI, co] -> wbuf [CI][LDB] (columns >= co zero).
template <int CI, int BN>
__device__ __forceinline__ void load_weights(const __nv_bfloat16* w,
                                             __nv_bfloat16* wbuf, int tap,
                                             int co, int tid) {
  using C = Cfg<CI, BN>;
  if ((co & 7) == 0) {
    for (int i = tid; i < CI * (BN / 8); i += C::THREADS) {
      const int k = i / (BN / 8);
      const int j = (i % (BN / 8)) * 8;
      const bool ok = j < co;
      cp_async16(wbuf + k * C::LDB + j,
                 ok ? w + (size_t)(tap * CI + k) * co + j : w, ok);
    }
  } else {
    for (int i = tid; i < CI * BN; i += C::THREADS) {
      const int k = i / BN;
      const int j = i % BN;
      wbuf[k * C::LDB + j] = j < co ? w[(size_t)(tap * CI + k) * co + j]
                                    : __float2bfloat16(0.0f);
    }
  }
}

template <int CI, int BN>
__global__ void __launch_bounds__(Cfg<CI, BN>::THREADS, Cfg<CI, BN>::MIN_BLOCKS)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out,
                    int h, int hp, int wp, int co, int out_w) {
  using C = Cfg<CI, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ctile = slab;  // epilogue, after the last tap
  __nv_bfloat16* wbuf[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem + C::R0),
      reinterpret_cast<__nv_bfloat16*>(smem + C::R0 + C::W_BYTES)};

  const int row_blocks = (h + C::ROWS - 1) / C::ROWS;
  const int n = blockIdx.x / row_blocks;
  const int y0 = (blockIdx.x - n * row_blocks) * C::ROWS;
  const int x0 = blockIdx.y * C::BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % C::WARPS_M;
  const int wn = warp / C::WARPS_M;
  // Warp wm covers output row wm / (BM/WM) of the block, pixels
  // (wm % (BM/WM)) * WM ..; block-local pixel index m = wm * WM + ...
  const int px_row = wm / (C::BM / C::WM);
  const int px_col = (wm % (C::BM / C::WM)) * C::WM;

  // Input rows y0..y0+ROWS+1, columns x0..x0+SLAB_W-1, all channels; rows
  // past H+2 and columns past W' are zero-filled.
  constexpr int VECS = CI / 8;
  const int cols = min(C::SLAB_W, wp - x0);
  const int rows = min(C::SLAB_ROWS, hp - y0);
  for (int i = tid; i < C::SLAB_ROWS * C::SLAB_W * VECS; i += C::THREADS) {
    const int v = i % VECS;
    const int c = (i / VECS) % C::SLAB_W;
    const int r = i / (VECS * C::SLAB_W);
    const bool ok = c < cols && r < rows;
    const __nv_bfloat16* src =
        ok ? x + (((size_t)n * hp + y0 + r) * wp + x0 + c) * CI + v * 8 : x;
    cp_async16(slab + (r * C::SLAB_W + c) * C::LDA + v * 8, src, ok);
  }
  load_weights<CI, BN>(w, wbuf[0], 0, co, tid);
  cp_async_commit();

  float acc[C::FM][C::FN][4];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses. A (pixels x k): lanes 0-15 rows 0-15 at k, lanes
  // 16-31 rows 0-15 at k+8 -> a0..a3 of m16n8k16. B (k x channels, stored
  // k-major, read transposed): lanes 0-7 k 0-7, 8-15 k 8-15 at channel n;
  // 16-31 the same at n+8 -> (b0, b1) of two n8 tiles.
  const int a_row = lane & 15;
  const int a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_n = (lane >> 4) * 8;

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {
      load_weights<CI, BN>(w, wbuf[(tap + 1) & 1], tap + 1, co, tid);
      cp_async_commit();
      cp_async_wait<1>();               // slab + this tap's weights landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int kr = tap / 3;
    const int kc = tap - kr * 3;
    // A row m = pixel px_col + m reads slab row px_row + kr, column
    // px_col + m + kc.
    const unsigned a_base = smem_u32(
        slab + ((px_row + kr) * C::SLAB_W + px_col + kc + a_row) * C::LDA +
        a_k);
    const unsigned b_base =
        smem_u32(wbuf[tap & 1] + b_k * C::LDB + wn * C::WN + b_n);
#pragma unroll
    for (int k0 = 0; k0 < CI; k0 += 16) {
      unsigned a[C::FM][4];
      unsigned b[C::FN / 2][4];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        ldsm_x4(a_base + (i * 16 * C::LDA + k0) * 2, a[i]);
#pragma unroll
      for (int j = 0; j < C::FN / 2; ++j)
        ldsm_x4_trans(b_base + (k0 * C::LDB + j * 16) * 2, b[j]);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j & 1) * 2],
                   b[j / 2][(j & 1) * 2 + 1]);
    }
    __syncthreads();  // buffer tap&1 is refilled at the next iteration
  }

  // Accumulator (i, j): rows lane/4 and lane/4 + 8 of m16 tile i, channels
  // 2*(lane%4), +1 of n8 tile j.
  const int gid = lane >> 2;
  const int tq = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      const int m = wm * C::WM + i * 16 + gid;
      const int c = wn * C::WN + j * 8 + tq;
      *reinterpret_cast<__nv_bfloat162*>(ctile + m * C::LDC + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(ctile + (m + 8) * C::LDC + c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  const int m_valid = min(C::BM, out_w - x0);
  for (int i = tid; i < C::ROWS * C::BM * (BN / 8); i += C::THREADS) {
    const int m = i / (BN / 8);
    const int j = (i % (BN / 8)) * 8;
    const int r = m / C::BM;
    const int xm = m - r * C::BM;
    if (y0 + r >= h || xm >= m_valid || j >= co) continue;
    const __nv_bfloat16* src = ctile + m * C::LDC + j;
    __nv_bfloat16* dst =
        out + (((size_t)n * h + y0 + r) * out_w + x0 + xm) * co + j;
    if ((co & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && j + e < co; ++e) dst[e] = src[e];
    }
  }
}

template <int CI, int BN>
int launch_bf16(const void* x, const void* w, void* out, int n, int hp,
                int wp, int co, int out_w, cudaStream_t s) {
  using C = Cfg<CI, BN>;
  const int h = hp - 2;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<CI, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n * ((h + C::ROWS - 1) / C::ROWS), (out_w + C::BM - 1) / C::BM);
  conv3x3_bf16_kernel<CI, BN><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), h, hp, wp, co, out_w);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const int bytes = valid ? 4 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void lds128(float* r, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

template <int CI, int BN>
struct CfgF {
  static constexpr int THREADS = 256;
  static constexpr int NTY = BN / 8;          // thread columns (8 channels)
  static constexpr int NTX = THREADS / NTY;   // thread rows (8 positions)
  static constexpr int BMQ = NTX * 8;         // flat positions per block
  static constexpr int HALF_M = BMQ / 2;
  static constexpr int HALF_N = BN / 2;
  static constexpr int CK = 8;                // input channels per stage
  static constexpr int NCH = CI / CK;
  static constexpr int SEG = BMQ + 2;         // positions one tap row reads
  static constexpr int FILL_ITERS = (SEG + 31) / 32;
  static constexpr int S = BMQ + 4;           // slab row stride, 4 mod 32
  static constexpr int SLAB = 3 * CK * S;     // floats: [kr][c][position]
  static constexpr int WTS = 9 * CK * BN;     // floats: [tap][c][channel]
  static constexpr int STAGE = SLAB + WTS;
  static constexpr int SMEM = 2 * STAGE * 4;
  static_assert(S % 32 == 4 && 2 * SMEM + 2048 <= 232448, "two blocks an SM");
};

// Chunk c0..c0+CK of the input slab and of the weights -> one stage.
// `src0` points at this thread's first element of chunk 0 (position q0 + jb,
// channel c, with c = tid % 8 and jb = tid / 8); `lim` is the count of
// positions from there to the end of the image.
template <int CI, int BN>
__device__ __forceinline__ void f32_load_chunk(
    const float* __restrict__ src0, const float* __restrict__ w, float* stage,
    int wp, int lim, int co, int c0, int tid) {
  using C = CfgF<CI, BN>;
  // Slab: thread (c, jb) copies positions jb, jb + 32, .. of each tap row;
  // a warp reads 4 positions x 32 contiguous bytes and writes 32 banks.
  const int c = tid & 7;
  const int jb = tid >> 3;
#pragma unroll
  for (int kr = 0; kr < 3; ++kr) {
    float* dst = stage + (kr * C::CK + c) * C::S + jb;
    const float* src = src0 + c0 + kr * wp * CI;
#pragma unroll
    for (int it = 0; it < C::FILL_ITERS; ++it) {
      if (it < C::FILL_ITERS - 1 || jb + 32 * it < C::SEG) {
        const bool ok = kr * wp + 32 * it < lim;  // past the image: zeros
        cp_async4(dst + 32 * it, ok ? src + 32 * it * CI : w, ok);
      }
    }
  }
  // Weights: rows tap * CK + c of [BN] channels. A thread keeps its column
  // and walks the rows in steps that are whole taps (or whole fractions of
  // one), so every offset below is a compile-time multiple of `co`.
  float* wdst = stage + C::SLAB;
  if ((co & 3) == 0) {
    constexpr int V = BN / 4;                 // 16-byte vectors per row
    constexpr int STEP = C::THREADS / V;      // rows per pass: 16 or 8
    constexpr int ROWS = 9 * C::CK;
    const int j = (tid % V) * 4;
    const int row0 = tid / V;
    const bool ok = j < co;
    const float* src =
        w + (size_t)((row0 / C::CK) * CI + c0 + row0 % C::CK) * co + j;
#pragma unroll
    for (int it = 0; it * STEP < ROWS; ++it) {
      if ((it + 1) * STEP <= ROWS || row0 + it * STEP < ROWS)
        cp_async16(wdst + (row0 + it * STEP) * BN + j,
                   ok ? src + (it * STEP / C::CK) * CI * co : w, ok);
    }
  } else {
    constexpr int STEP = C::THREADS / BN;     // rows per pass: 4 or 2
    const int j = tid % BN;
    const int row0 = tid / BN;                // < STEP, and STEP divides CK
    const bool ok = j < co;
    const float* src = w + (size_t)(c0 + row0) * co + j;
#pragma unroll
    for (int it = 0; it * STEP < 9 * C::CK; ++it) {
      const int r = it * STEP;
      cp_async4(wdst + (row0 + r) * BN + j,
                ok ? src + ((r / C::CK) * CI + r % C::CK) * co : w, ok);
    }
  }
}

template <int CI, int BN>
__global__ void __launch_bounds__(CfgF<CI, BN>::THREADS, 2)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int h, int hp, int wp, int co,
                   int out_w) {
  using C = CfgF<CI, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A warp is 8 thread rows x 4 thread columns: its A loads read 128
  // consecutive bytes (broadcast over the columns), its B loads 64.
  constexpr int WX = C::NTX / 8;
  const int tx = (warp % WX) * 8 + (lane & 7);
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * C::BMQ;
  const int lim = hp * wp - q0 - (tid >> 3);
  const float* src0 =
      x + ((size_t)n * hp * wp + q0 + (tid >> 3)) * CI + (tid & 7);

  float acc[2][4][8];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][i][j] = 0.0f;

  f32_load_chunk<CI, BN>(src0, w, stages, wp, lim, co, 0, tid);
  cp_async_commit();

#pragma unroll 1
  for (int ch = 0; ch < C::NCH; ++ch) {
    if (ch + 1 < C::NCH) {
      f32_load_chunk<CI, BN>(src0, w, stages + ((ch + 1) & 1) * C::STAGE, wp,
                             lim, co, (ch + 1) * C::CK, tid);
      cp_async_commit();
      cp_async_wait<1>();               // this chunk has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* as = stages + (ch & 1) * C::STAGE + 4 * tx;
    const float* bs = stages + (ch & 1) * C::STAGE + C::SLAB + 4 * ty;
#pragma unroll 4
    for (int c = 0; c < C::CK; ++c) {
#pragma unroll
      for (int kr = 0; kr < 3; ++kr) {
        // positions 4tx .. 4tx+5 and BMQ/2 + the same, at channel c
        float a[2][8];
        const float* ap = as + (kr * C::CK + c) * C::S;
        lds128(a[0], ap);
        lds128(a[0] + 4, ap + 4);
        lds128(a[1], ap + C::HALF_M);
        lds128(a[1] + 4, ap + C::HALF_M + 4);
#pragma unroll
        for (int kc = 0; kc < 3; ++kc) {
          float b[8];
          const float* bp = bs + ((kr * 3 + kc) * C::CK + c) * BN;
          lds128(b, bp);
          lds128(b + 4, bp + C::HALF_N);
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[g][i][j] = fmaf(a[g][i + kc], b[j], acc[g][i][j]);
        }
      }
    }
    __syncthreads();  // stage ch&1 is refilled at the next iteration
  }

  const bool vec = (co & 3) == 0;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int q = q0 + g * C::HALF_M + 4 * tx;
    int y = q / wp;
    int xo = q - y * wp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (y < h && xo < out_w) {
        float* o = out + (((size_t)n * h + y) * out_w + xo) * co;
#pragma unroll
        for (int hn = 0; hn < 2; ++hn) {
          const int j0 = hn * C::HALF_N + 4 * ty;
          const float* v = &acc[g][i][hn * 4];
          if (vec) {
            if (j0 < co)
              *reinterpret_cast<float4*>(o + j0) =
                  make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j0 + e < co) o[j0 + e] = v[e];
          }
        }
      }
      if (++xo == wp) {
        xo = 0;
        ++y;
      }
    }
  }
}

template <int CI, int BN>
cudaError_t prepare_f32() {
  static cudaError_t state = cudaErrorNotReady;  // set once per process
  if (state == cudaErrorNotReady) {
    state = cudaFuncSetAttribute(conv3x3_f32_kernel<CI, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 CfgF<CI, BN>::SMEM);
    if (state == cudaSuccess)
      state = cudaFuncSetAttribute(
          conv3x3_f32_kernel<CI, BN>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  }
  return state;
}

template <int CI, int BN>
int launch_f32(const void* x, const void* w, void* out, int n, int hp, int wp,
               int co, int out_w, cudaStream_t s) {
  using C = CfgF<CI, BN>;
  const int h = hp - 2;
  cudaError_t err = prepare_f32<CI, BN>();
  if (err != cudaSuccess) return (int)err;
  const int m_total = (h - 1) * wp + out_w;   // flat positions that hold output
  dim3 grid((m_total + C::BMQ - 1) / C::BMQ, n);
  conv3x3_f32_kernel<CI, BN><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), h, hp, wp, co, out_w);
  return (int)cudaGetLastError();
}

template <int CI, int BN>
int blocks_per_sm_f32() {
  cudaError_t err = prepare_f32<CI, BN>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, conv3x3_f32_kernel<CI, BN>, CfgF<CI, BN>::THREADS,
        CfgF<CI, BN>::SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// dtype: 0 = bf16 (tensor-core kernel), 1 = fp32 (register-tiled FFMA
// kernel). Scope: ci in {64, 128}, 1 <= co <= 128. Launches on `stream`
// without synchronising and returns cudaGetLastError() (cudaErrorInvalidValue
// outside the scope).
extern "C" int pasta_conv3x3_valid(const void* x, const void* w, void* out,
                                   int dtype, int n, int hp, int wp, int ci,
                                   int co, int out_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((ci != 64 && ci != 128) || co < 1 || co > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (ci == 64)
      return co <= 64 ? launch_bf16<64, 64>(x, w, out, n, hp, wp, co, out_w, s)
                      : launch_bf16<64, 128>(x, w, out, n, hp, wp, co, out_w, s);
    return co <= 64 ? launch_bf16<128, 64>(x, w, out, n, hp, wp, co, out_w, s)
                    : launch_bf16<128, 128>(x, w, out, n, hp, wp, co, out_w, s);
  }
  if (ci == 64)
    return co <= 64 ? launch_f32<64, 64>(x, w, out, n, hp, wp, co, out_w, s)
                    : launch_f32<64, 128>(x, w, out, n, hp, wp, co, out_w, s);
  return co <= 64 ? launch_f32<128, 64>(x, w, out, n, hp, wp, co, out_w, s)
                  : launch_f32<128, 128>(x, w, out, n, hp, wp, co, out_w, s);
}

// Resident blocks per SM of the fp32 kernel that serves (ci, co), as the
// runtime's occupancy calculator sees its registers and shared memory;
// a negative CUDA error code on failure.
extern "C" int pasta_conv3x3_f32_blocks_per_sm(int ci, int co) {
  if ((ci != 64 && ci != 128) || co < 1 || co > 128)
    return -(int)cudaErrorInvalidValue;
  if (ci == 64)
    return co <= 64 ? blocks_per_sm_f32<64, 64>() : blocks_per_sm_f32<64, 128>();
  return co <= 64 ? blocks_per_sm_f32<128, 64>() : blocks_per_sm_f32<128, 128>();
}
