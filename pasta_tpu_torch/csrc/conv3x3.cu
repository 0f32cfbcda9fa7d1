// K1: VALID 3x3 convolution, stride 1, groups 1, NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pasta_tpu/ops/pallas_conv.py::conv3x3_valid
// (both its C_in=64 lane-packed branch and its C_in=128 direct branch).
// Contract, as there: x [N, H+2, W', C_in] already carries its 1-px halo,
// out is [N, H, out_w, C_out] in the input dtype, accumulation in fp32.
// Columns of x past out_w + 2 are never used by a stored output. The bf16
// kernel also takes `pad` = 2: x [N, H, W, C_in] is then read as if it had
// a 2-px border of zeros, and out is [N, H+2, out_w, C_out] for any out_w
// (columns whose taps all fall outside x come out zero). That is the input
// gradient of the pad = 0 conv, computed on dY as it lies.
//
// bf16 design. What bounds it: 128 -> 64 at [8,514,514,128] is 309 GFLOP
// over 0.81 GB, 380 FLOP/B against the card's ridge of 295, so operations;
// 64 -> 64 sits at the ridge. So the design has to keep the tensor cores
// fed and read each input pixel from device memory about once.
//  - The products run on wgmma (m64nNk16, bf16 in, fp32 accumulators in
//    registers), both operands read from shared memory by descriptor: no
//    fragment passes through registers. The implicit GEMM has M = 64
//    consecutive output pixels of one row, N = BN channels (64 or 128),
//    K = 9 taps x C_in in steps of 16.
//  - The input arrives by TMA: x is a 4-D tensor map [N, H, W, C] with the
//    128-byte swizzle, a box is one input row of 66 pixels x 64 channels
//    (C_in = 128: two boxes a row). TMA fills what lies outside the tensor
//    with zeros, which serves the ragged right and bottom edges and, with
//    box coordinates that start at (-pad, -pad), the implicit halo. The map
//    is encoded on the host at every launch (cuTensorMapEncodeTiled, found
//    through cudaGetDriverEntryPoint: the library links no libcuda) and
//    passed by value as a __grid_constant__ parameter.
//  - A tap's A tile starts kc pixels = kc * 128 bytes into the row buffer,
//    that is, inside an 8-row swizzle atom. Both TMA and wgmma take the
//    swizzle from the absolute shared-memory address bits (16-byte chunk
//    bits 4-6 xor row bits 7-9; measured on the card), so the descriptor
//    simply starts there with base_offset 0, and row buffers need only
//    128-byte alignment. (Held by the arange and ragged cases of
//    tests/test_torch_cuda.py, where a permuted operand cannot pass.)
//  - Weights come K-major, [9, BN, C_in] with zero rows past C_out (the
//    wrapper's one small copy a launch), arrive by TMA and stay in shared
//    memory for the whole life of a block: 72 KB at 64 -> 64, 144 KB at
//    64 -> 128 and 128 -> 64. 128 -> 128 (288 KB) does not fit: its C_out
//    splits over two blocks of 64 channels each (neighbouring block ids
//    work on the same pixels at the same time, so the second read of the
//    input is an L2 hit).
//  - Blocks are persistent (one an SM) and walk down a strip 64 output
//    pixels wide, one work item being (image, strip, chunk of rows). Input
//    rows go through a ring in shared memory (16 rows at 64 -> 64, 10 at
//    64 -> 128, 5 at C_in = 128), so inside an item an input pixel is read
//    once, not (ROWS+2)/ROWS times, and the rows ahead load while the
//    current ones compute. The chunk height is chosen per launch so that
//    the items fill the blocks' last wave.
//  - Warp roles: the last warp is the producer (one lane starts the TMA
//    loads and waits on the ring's `empty` barriers); before it come the
//    consumer warpgroups (three at C_in = 64, two at C_in = 128 where the
//    ring has no room for a third's rows), which take output rows in turn,
//    so one's epilogue overlaps the others' wgmma. A consumer waits on its
//    three rows' `full` barriers, starts the 36 or 72 wgmma of its tile into
//    one accumulator (32 or 64 registers a thread; nothing spills, and no
//    setmaxnreg is needed), and each of its warps releases the rows it will
//    not read again.
//  - Epilogue: bf16 rounding in registers, then the lanes of a quad exchange
//    so that each holds 8 consecutive channels and writes 16 bytes; only
//    valid pixels and channels are stored. C_out not a multiple of 8 takes
//    single-element stores.
//  - Tile waste. Cutting a row into ceil(out_w / 64) tiles would waste
//    nothing at out_w 512 and 256 but 12.1% at 514 and 24.0% at 258 (the
//    input gradient's widths). So where it pays, the out_w % 64 columns
//    left over are a part of their own with the image's axes swapped (a
//    second tensor map of the same x with dimensions 1 and 2 exchanged):
//    blocks walk across those few columns and tile down the rows. Waste in
//    all: 0% at 512 and 256, 0.1% at 514, 0.2% at 258.
//  - What is left: with N = 64 a wgmma reads 4 KB of operands for 32 cycles
//    of products, all that shared memory can deliver, so the 64-channel
//    tiles (64 -> 64, 128 -> 64 and both halves of 128 -> 128) stay near 3/4
//    of the rate the clocks allow; 128 -> 128 as one N = 128 tile would need
//    its weights streamed through shared memory.
// The TPU blocking (two W columns packed into 128 lanes, lane rolls,
// double-buffered DMA slabs per grid step) is TPU layout and is not carried
// over.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- bf16 ----

constexpr int SMEM_MAX = 232448;  // shared memory a block may ask for

template <int CI, int BN>
struct Cfg {
  static constexpr int KB = CI / 64;            // 64-channel K blocks a pixel
  static constexpr int BW = 64;                 // output pixels a tile
  static constexpr int BOX_W = BW + 2;          // input pixels a row buffer
  static constexpr int HALF_BYTES = BOX_W * 128;  // one K block of one row
  static constexpr int ROW_BYTES = KB * HALF_BYTES;
  static constexpr int WTAP_BYTES = BN * 128;   // one (tap, K block) of w
  static constexpr int W_BYTES = 9 * KB * WTAP_BYTES;
  static constexpr int BAR_BYTES = 512;
  static constexpr int FIT = (SMEM_MAX - W_BYTES - BAR_BYTES) / ROW_BYTES;
  static constexpr int RING = FIT > 16 ? 16 : FIT;  // input rows in flight
  static constexpr int SMEM = W_BYTES + RING * ROW_BYTES + BAR_BYTES;
  // Consumer warpgroups: three where the ring has room for their five rows
  // and rows to load ahead; at C_in = 128 the ring holds five rows in all.
  static constexpr int CONSUMERS = CI == 64 ? 3 : 2;
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  static_assert(RING >= CONSUMERS + 3, "the consumers hold CONSUMERS + 2 rows");
  static_assert(W_BYTES % 1024 == 0 && HALF_BYTES % 128 == 0, "alignment");
};

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), LBO unused, base_offset 0.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// acc (+)= A[64 x 16] * B[16 x BN]; `accumulate` 0 overwrites acc.
template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a,
                                          uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ unsigned pack_bf162(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// v[q] of the caller's four values, q a lane-dependent index, without
// indexing a register array at run time.
__device__ __forceinline__ unsigned pick4(unsigned v0, unsigned v1,
                                          unsigned v2, unsigned v3, int q) {
  const unsigned lo = (q & 1) ? v1 : v0;
  const unsigned hi = (q & 1) ? v3 : v2;
  return (q & 2) ? hi : lo;
}

// A region of the output cut into work items. A block walks along one axis
// of the image (`walk`: down the rows in the main part) and tiles the other
// 64 pixels at a time (`width`: along a row there). The part that takes the
// columns left over by the 64-pixel tiles has the axes swapped: it walks
// across those few columns and tiles down the rows.
struct Bf16Part {
  int walk, width;  // extent along the walked and the tiled axis
  int walk0;        // first walked position in the image
  int strips;       // tiles of 64 pixels across `width`
  int chunks;       // chunks of the walked axis
  int chunk_rows;   // walked positions a chunk (the last may have fewer)
  int items;        // n * chunks * strips
  int step_walk, step_tile;  // output elements from one position to the next
};

// The work of one launch, the same for every block.
struct Bf16Work {
  int co, pad;
  size_t image;     // output elements an image
  Bf16Part main, rest;
};

// One work item: image, first walked position and its count, first tiled
// position and how many of the tile's 64 exist.
struct Item {
  int img, y0, rows, x0, px_valid;
};

__device__ __forceinline__ Item decode_item(const Bf16Work& wk, int item,
                                            bool swapped) {
  // field by field, so that the launch parameters stay where they are
  const int strips = swapped ? wk.rest.strips : wk.main.strips;
  const int chunks = swapped ? wk.rest.chunks : wk.main.chunks;
  const int chunk_rows = swapped ? wk.rest.chunk_rows : wk.main.chunk_rows;
  const int walk = swapped ? wk.rest.walk : wk.main.walk;
  const int width = swapped ? wk.rest.width : wk.main.width;
  const int walk0 = swapped ? wk.rest.walk0 : 0;
  const int local = swapped ? item - wk.main.items : item;
  const int chunk = (local / strips) % chunks;
  Item it;
  it.img = local / (strips * chunks);
  it.rows = min(chunk_rows, walk - chunk * chunk_rows);
  it.y0 = walk0 + chunk * chunk_rows;
  it.x0 = (local % strips) * 64;
  it.px_valid = min(64, width - it.x0);
  return it;
}

// One output row segment of 64 pixels x BN channels: acc -> out, bf16.
// Thread layout of the wgmma accumulator: warp w of the warpgroup holds
// rows 16w + lane/4 and + 8; d[4j], d[4j+1] are channels 8j + 2(lane%4), +1
// of the first row, d[4j+2], d[4j+3] the same of the second.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           __nv_bfloat16* __restrict__ row_out,
                                           int px_step, int px_valid, int co,
                                           int ch0, int warp_in_group,
                                           int lane) {
  const int q = lane & 3;
  const int r0 = warp_in_group * 16 + (lane >> 2);
  const int ch_valid = co - ch0;  // channels of this block that exist
  if ((co & 7) == 0) {
    // Quad exchange: of channel groups 4J..4J+3 (8 channels each), lane q
    // ends up with all of group 4J + q, as four packed pairs in the order
    // of the lanes they came from.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
#pragma unroll
      for (int jj = 0; jj < BN / 32; ++jj) {
        unsigned v[4], o[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = pack_bf162(acc[4 * (4 * jj + t) + 2 * half],
                            acc[4 * (4 * jj + t) + 2 * half + 1]);
        // position q of the lane's vector is its own pair of group q
        const unsigned own = pick4(v[0], v[1], v[2], v[3], q);
        o[0] = o[1] = o[2] = o[3] = own;
#pragma unroll
        for (int s = 1; s < 4; ++s) {
          // lane L hands lane L ^ s its pair of group L ^ s
          const unsigned give = pick4(v[0], v[1], v[2], v[3], q ^ s);
          const unsigned got = __shfl_xor_sync(0xffffffffu, give, s);
          const int from = q ^ s;  // pairs sit in the order of their lanes
          o[0] = from == 0 ? got : o[0];
          o[1] = from == 1 ? got : o[1];
          o[2] = from == 2 ? got : o[2];
          o[3] = from == 3 ? got : o[3];
        }
        const uint4 w = make_uint4(o[0], o[1], o[2], o[3]);
        const int c = (4 * jj + q) * 8;
        if (r < px_valid && c < ch_valid)
          *reinterpret_cast<uint4*>(row_out + (size_t)r * px_step + ch0 +
                                    c) = w;
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r >= px_valid) continue;
      __nv_bfloat16* o = row_out + (size_t)r * px_step + ch0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * q;
        if (c < ch_valid) o[c] = __float2bfloat16(acc[4 * j + 2 * half]);
        if (c + 1 < ch_valid)
          o[c + 1] = __float2bfloat16(acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// The 9 taps of one 64-pixel tile whose three input rows are ring entries
// e0, e0 + 1, e0 + 2: acc = sum over taps and channels, all wgmma started and
// waited for. SWAPPED: the walked axis is the image's columns, so the walked
// tap offset is kc.
template <int CI, int BN, bool SWAPPED>
__device__ __forceinline__ void conv_tile(float (&acc)[BN / 2],
                                          unsigned s_ring, unsigned s_w,
                                          unsigned e0) {
  using C = Cfg<CI, BN>;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int a = 0; a < 3; ++a) {        // offset along the walked axis
    const unsigned a_row = s_ring + ((e0 + a) % C::RING) * C::ROW_BYTES;
#pragma unroll
    for (int kb = 0; kb < C::KB; ++kb) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {    // offset along the tiled axis
        const int tap = SWAPPED ? b * 3 + a : a * 3 + b;
        const uint64_t da = wgmma_desc(a_row + kb * C::HALF_BYTES + b * 128);
        const uint64_t db =
            wgmma_desc(s_w + (tap * C::KB + kb) * C::WTAP_BYTES);
#pragma unroll
        for (int k = 0; k < 4; ++k)    // 16 channels = 32 bytes = 2 units
          wgmma_k16<BN>(acc, da + 2 * k, db + 2 * k, (a | kb | b | k) != 0);
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// SPLIT blocks share the pixels of an item and take BN channels each.
template <int CI, int BN, int SPLIT>
__global__ void __launch_bounds__(Cfg<CI, BN>::THREADS, 1)
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap x_map_swapped,
                    const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ out, const Bf16Work wk) {
  using C = Cfg<CI, BN>;
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const unsigned s_w = smem_u32(smem_bf16);
  const unsigned s_ring = s_w + C::W_BYTES;
  const unsigned s_bar = s_ring + C::RING * C::ROW_BYTES;
  const unsigned bar_w = s_bar;                    // weights landed
  const unsigned bar_full = s_bar + 8;             // [RING] row landed
  const unsigned bar_empty = bar_full + 8 * C::RING;  // [RING] row released

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int part = blockIdx.x % SPLIT;             // which BN channels
  const int first = blockIdx.x / SPLIT;
  const int stride = gridDim.x / SPLIT;
  const int items = wk.main.items + wk.rest.items;

  if (tid == 0) {
    if (s_w & 1023u) __trap();  // the swizzle needs the weights 1024-aligned
    mbar_init(bar_w, 1);
    for (int i = 0; i < C::RING; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, C::CONSUMERS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::CONSUMERS * 4) {
    // ------------------------------------------------------- producer --
    if (lane != 0) return;
    mbar_expect_tx(bar_w, C::W_BYTES);
    for (int tap = 0; tap < 9; ++tap)
      for (int kb = 0; kb < C::KB; ++kb)
        tma_load_2d(s_w + (tap * C::KB + kb) * C::WTAP_BYTES, &w_map, bar_w,
                    kb * 64, (tap * SPLIT + part) * BN);
    unsigned seq = 0;  // ring entries requested so far
    for (int item = first; item < items; item += stride) {
      const bool swapped = item >= wk.main.items;
      const Item it = decode_item(wk, item, swapped);
      const CUtensorMap* map = swapped ? &x_map_swapped : &x_map;
      for (int e = 0; e < it.rows + 2; ++e, ++seq) {
        const unsigned slot = seq % C::RING;
        mbar_wait(bar_empty + 8 * slot, ((seq / C::RING) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * slot, C::ROW_BYTES);
        for (int kb = 0; kb < C::KB; ++kb)
          tma_load_4d(s_ring + slot * C::ROW_BYTES + kb * C::HALF_BYTES, map,
                      bar_full + 8 * slot, kb * 64, it.x0 - wk.pad,
                      it.y0 - wk.pad + e, it.img);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers --
  const int group = warp >> 2;          // output rows group, group + CONSUMERS, ..
  const int warp_in_group = warp & 3;
  mbar_wait(bar_w, 0);
  unsigned seq0 = 0;                    // ring entry of the item's first row
  unsigned seen = 0;                    // entries whose `full` this thread saw
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int item = first; item < items; item += stride) {
    const bool swapped = item >= wk.main.items;
    const Item it = decode_item(wk, item, swapped);
    const int rows = it.rows;
    const int step_walk = swapped ? wk.rest.step_walk : wk.main.step_walk;
    const int step_tile = swapped ? wk.rest.step_tile : wk.main.step_tile;
    __nv_bfloat16* item_out = out + it.img * wk.image +
                              (size_t)it.y0 * step_walk +
                              (size_t)it.x0 * step_tile;
    unsigned released = seq0;           // entries this warp has released
    for (int yy = group; yy < rows; yy += C::CONSUMERS) {
      const unsigned e0 = seq0 + yy;    // entries e0, e0 + 1, e0 + 2
      while (seen <= e0 + 2) {
        mbar_wait(bar_full + 8 * (seen % C::RING), (seen / C::RING) & 1);
        ++seen;
      }
      if (swapped)
        conv_tile<CI, BN, true>(acc, s_ring, s_w, e0);
      else
        conv_tile<CI, BN, false>(acc, s_ring, s_w, e0);
      // This warp's next row is yy + CONSUMERS: it reads the entries before
      // that row's first no more.
      __syncwarp();
      if (lane == 0)
        for (; released < e0 + C::CONSUMERS; ++released)
          mbar_arrive(bar_empty + 8 * (released % C::RING));
      released = e0 + C::CONSUMERS;
      store_tile<BN>(acc, item_out + (size_t)yy * step_walk, step_tile,
                     it.px_valid, wk.co, part * BN, warp_in_group, lane);
    }
    // The rest of the item's rows, seen first so that no arrival runs ahead
    // of the phase it belongs to.
    const unsigned end = seq0 + rows + 2;
    while (seen < end) {
      mbar_wait(bar_full + 8 * (seen % C::RING), (seen / C::RING) & 1);
      ++seen;
    }
    __syncwarp();
    if (lane == 0)
      for (; released < end; ++released)
        mbar_arrive(bar_empty + 8 * (released % C::RING));
    seq0 = end;
  }
}

typedef CUresult (*TensorMapEncodeFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the loaded libcuda, found through the runtime
// (this library links none); null where it has no such entry point.
TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<TensorMapEncodeFn>(p);
  }();
  return fn;
}

// A contiguous bf16 tensor (`dims` innermost first) as a tensor map of `rank`
// dimensions with the 128-byte swizzle; `swap12` lists dimensions 1 and 2 in
// the other order, so that a box's second axis runs down the image's rows.
// 0 or 20000 + CUresult.
int encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint32_t* box,
                    bool swap12) {
  TensorMapEncodeFn encode = tensor_map_encoder();
  if (!encode) return 20000;
  cuuint64_t extent[4], strides[4];  // strides[i]: bytes a step of dim i + 1
  cuuint64_t pitch = 2;
  for (int i = 0; i < rank; ++i) {
    extent[i] = dims[i];
    pitch *= dims[i];
    strides[i] = pitch;
  }
  if (swap12) {
    extent[1] = dims[2];
    extent[2] = dims[1];
    const cuuint64_t s = strides[0];
    strides[0] = strides[1];
    strides[1] = s;
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      extent, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 20000 + (int)res;
}

// SMs of the current device; 0 on failure.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 0;
  return sms;
}

// Rows a chunk: the split of the walked axis that needs the fewest row steps
// of the slowest block, an item costing its rows, the two halo rows it loads
// again and about two rows of pipeline fill.
void choose_chunks(Bf16Part* p, int n, int blocks) {
  long best = -1;
  const int columns = n * p->strips;
  for (int chunks = 1; chunks <= (p->walk + 7) / 8; ++chunks) {
    const int rows = (p->walk + chunks - 1) / chunks;
    const int real = (p->walk + rows - 1) / rows;
    const long items = (long)columns * real;
    const long waves = (items + blocks - 1) / blocks;
    const long cost = waves * (rows + 4);
    if (best < 0 || cost < best) {
      best = cost;
      p->chunks = real;
      p->chunk_rows = rows;
    }
  }
  p->items = columns * p->chunks;
}

// Cuts [hout, out_w] into the main part (whole 64-pixel tiles along the rows,
// and the ragged last tile too where swapping would not pay) and the rest
// (the out_w % 64 columns left over, walked across and tiled down the rows:
// 2 columns of a 258-wide row cost 2 x 5 tiles a strip of rows instead of
// 258).
void plan_bf16(Bf16Work* wk, int n, int hout, int out_w, int blocks) {
  const int left = out_w % 64;
  const int down = (hout + 63) / 64;
  const bool swap = left > 0 && (long)left * down < hout;
  Bf16Part& m = wk->main;
  m.walk = hout;
  m.width = swap ? out_w - left : out_w;
  m.walk0 = 0;
  m.strips = (m.width + 63) / 64;
  m.step_walk = out_w * wk->co;
  m.step_tile = wk->co;
  m.chunks = m.chunk_rows = 1;
  m.items = 0;
  if (m.strips) choose_chunks(&m, n, blocks);
  Bf16Part& r = wk->rest;
  r.walk = left;
  r.width = hout;
  r.walk0 = out_w - left;
  r.strips = down;
  r.chunks = 1;
  r.chunk_rows = left;
  r.items = swap ? n * down : 0;
  r.step_walk = wk->co;
  r.step_tile = out_w * wk->co;
}

// x [n, hin, win, CI]; w [9, SPLIT * BN, CI] (K-major, zero rows past co);
// out [n, hin + 2 pad - 2, out_w, co].
template <int CI, int BN, int SPLIT>
int launch_bf16(const void* x, const void* w, void* out, int n, int hin,
                int win, int co, int out_w, int pad, cudaStream_t s) {
  using C = Cfg<CI, BN>;
  // per launch: the attribute belongs to the current device
  const cudaError_t prepared = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<CI, BN, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (prepared != cudaSuccess) return (int)prepared;
  const int sms = sm_count();
  if (sms < SPLIT) return (int)cudaErrorInvalidDevice;

  CUtensorMap x_map, x_map_swapped, w_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)CI, (cuuint64_t)win,
                                (cuuint64_t)hin, (cuuint64_t)n};
  const cuuint32_t x_box[4] = {64, C::BOX_W, 1, 1};
  int err = encode_bf16_map(&x_map, x, 4, x_dims, x_box, false);
  if (err) return err;
  err = encode_bf16_map(&x_map_swapped, x, 4, x_dims, x_box, true);
  if (err) return err;
  const cuuint64_t w_dims[2] = {(cuuint64_t)CI, (cuuint64_t)(9 * SPLIT * BN)};
  const cuuint32_t w_box[2] = {64, BN};
  err = encode_bf16_map(&w_map, w, 2, w_dims, w_box, false);
  if (err) return err;

  Bf16Work wk;
  const int hout = hin + 2 * pad - 2;
  wk.co = co;
  wk.pad = pad;
  wk.image = (size_t)hout * out_w * co;
  const int blocks = sms / SPLIT;
  plan_bf16(&wk, n, hout, out_w, blocks);
  const int items = wk.main.items + wk.rest.items;
  const int grid = SPLIT * (items < blocks ? items : blocks);
  conv3x3_bf16_kernel<CI, BN, SPLIT><<<grid, C::THREADS, C::SMEM, s>>>(
      x_map, x_map_swapped, w_map, static_cast<__nv_bfloat16*>(out), wk);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- fp32 ----

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

// Per call: a function attribute belongs to the device that is current when
// it is set, and one process may launch on several devices.
template <int CI, int BN>
cudaError_t prepare_f32() {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32_kernel<CI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CfgF<CI, BN>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_f32_kernel<CI, BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
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

// dtype: 0 = bf16 (wgmma kernel; `w` is [9, 64 or 128, ci], K-major, rows
// past co zero; pad 0 or 2), 1 = fp32 (register-tiled FFMA kernel; `w` is
// HWIO [9 * ci, co]; pad 0). x is [n, hin, win, ci], out [n, hin + 2 pad - 2,
// out_w, co]. Scope: ci in {64, 128}, 1 <= co <= 128. Launches on `stream`
// without synchronising and returns cudaGetLastError(), cudaErrorInvalidValue
// outside the scope, or 20000 + the CUresult if a tensor map cannot be
// encoded.
extern "C" int pasta_conv3x3_valid(const void* x, const void* w, void* out,
                                   int dtype, int n, int hin, int win, int ci,
                                   int co, int out_w, int pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((ci != 64 && ci != 128) || co < 1 || co > 128 || n < 1 || out_w < 1 ||
      hin + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (pad != 0 && pad != 2) return (int)cudaErrorInvalidValue;
    if (ci == 64)
      return co <= 64
                 ? launch_bf16<64, 64, 1>(x, w, out, n, hin, win, co, out_w,
                                          pad, s)
                 : launch_bf16<64, 128, 1>(x, w, out, n, hin, win, co, out_w,
                                           pad, s);
    return co <= 64 ? launch_bf16<128, 64, 1>(x, w, out, n, hin, win, co,
                                              out_w, pad, s)
                    : launch_bf16<128, 64, 2>(x, w, out, n, hin, win, co,
                                              out_w, pad, s);
  }
  if (pad != 0) return (int)cudaErrorInvalidValue;
  if (ci == 64)
    return co <= 64 ? launch_f32<64, 64>(x, w, out, n, hin, win, co, out_w, s)
                    : launch_f32<64, 128>(x, w, out, n, hin, win, co, out_w, s);
  return co <= 64 ? launch_f32<128, 64>(x, w, out, n, hin, win, co, out_w, s)
                  : launch_f32<128, 128>(x, w, out, n, hin, win, co, out_w, s);
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

// 64-pixel tiles the bf16 kernel computes for one image of [hout, out_w]
// output pixels (both parts of its plan), for the caller to hold against
// hout * out_w / 64; a negative CUDA error code on failure.
extern "C" int pasta_conv3x3_bf16_tiles(int hout, int out_w) {
  if (hout < 1 || out_w < 1) return -(int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return -(int)cudaErrorInvalidDevice;
  Bf16Work wk;
  wk.co = 64;
  plan_bf16(&wk, 1, hout, out_w, sms);
  const bool swapped = wk.rest.items > 0;
  return wk.main.walk * wk.main.strips +
         (swapped ? wk.rest.walk * wk.rest.strips : 0);
}
