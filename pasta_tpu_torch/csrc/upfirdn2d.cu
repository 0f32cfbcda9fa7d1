// upfirdn2d: pad -> zero-upsample -> 2-D FIR filter -> downsample of NHWC
// images in one pass, for Hopper (sm_90a).
//
// This kernel replaces no TPU kernel. The JAX package leaves this op to
// lax.conv_general_dilated (lhs_dilation for the zero insertion, negative
// padding for crops, a stride for the downsampling); the port spelled it as
// PyTorch's plain ops do -- a zero insertion by reshape and pad, a pad and a
// crop, a depthwise grouped convolution in NCHW over a tensor that is 75%
// zeros for up = 2, and a copy back to NHWC -- which ran at about 4% of the
// card's byte bound. Here, for output pixel (oy, ox) and channel c,
//
//   y[n, oy, ox, c] = sum_{a < fh, b < fw} taps[a][b]
//                     * xu[n, oy * downy + a - py0, ox * downx + b - px0, c]
//
// where xu is x with upy - 1 (upx - 1) zeros after every row (column) and
// zeros outside it, and taps is the filter in correlation order (flipped
// unless `flip`), times `gain`, rounded to the input's type as the plain
// version rounds it. Only the taps that meet a sample of x are computed:
// for up = 2 an output reads its 2 x 2 live taps of a 4 x 4 filter (its
// phase's), and for down = 2 only the kept outputs are computed.
//
// What bounds it on an H100: memory. At most 16 multiply-adds an output
// against 8 (fp32) or 4 (bf16) bytes of input and output leave the
// arithmetic far under the card's rate, so the floor is each input byte
// read once and each output byte written once at 3.35 TB/s. The design:
//   - a block owns an output tile (16 rows x 8 columns for 8 channel
//     vectors; 8 rows for down = 2) and a chunk of up to 8 channel
//     vectors of 16 bytes (4 fp32 or 8 bf16 channels), and stages the input
//     patch the tile reads (tile / up + taps - 1 of halo) in shared memory
//     once, by cp.async with zero fill for rows and columns outside x: a
//     pixel's chunk is 128 contiguous bytes, and every copy is in flight
//     before the block waits;
//   - a thread computes one channel vector of a vertical run of 4 outputs
//     of one phase (2 for down = 2), with the taps of its phase in
//     registers, sliding down the patch one input row at a time, so each
//     input vector is read from shared memory once for all the outputs of
//     the run that use it; sums are fp32, and each output is stored once,
//     16 bytes at a time;
//   - the two rows of an up = 2 pair are two phases: separate runs, so
//     the taps and the row offsets of a run are fixed;
//   - channel counts that are not a multiple of a 16-byte vector (the
//     3-channel images) take the same kernel with one channel a vector and
//     plain loads.
// The output is NHWC and contiguous, so the conv that follows takes it as
// it lies. The filter is read through a device pointer (null: the 1 x 1
// identity) with the flip and the gain as arguments, so a call runs no
// other device op and never reads the taps on the host.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 4;      // taps a filter axis
constexpr int RUNS = 4;          // vertical runs of outputs a block
constexpr int TAP_BYTES = 64;    // the rounded taps, ahead of the patch

struct Params {
  const void* x;
  const float* f;        // [fh, fw] fp32 as given, or null (identity)
  void* y;
  int n, h, w;           // input images
  int oh, ow;            // output images
  int cvt;               // channel vectors a pixel
  int upx, upy, downx, downy, px0, py0, fw, fh;
  int flip;
  float gain;
  int cv_log2;           // channel vectors a block
  int bw_log2;           // output columns a block
  int ph;                // row phases a tile: 2 for up 2 and down 1 in y
  int tiles_x;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
// A tap rounded to the input's type, as the plain version's f.to(dtype).
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int ceil_div(int a, int b) {
  return -floor_div(-a, b);
}
__device__ __forceinline__ int pmod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// One element of the patch: 16 bytes by cp.async (zero-filled where `ok`
// is false), or a narrower element by a plain load.
template <typename VT>
__device__ __forceinline__ void stage(VT* dst, const VT* src, bool ok) {
  if constexpr (sizeof(VT) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int bytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes));
  } else {
    *dst = ok ? *src : VT{};
  }
}

template <typename VT>
__device__ __forceinline__ void stage_wait() {
  if constexpr (sizeof(VT) == 16) {
    asm volatile("cp.async.wait_all;\n" ::);
  }
}

// SHY: input rows between two outputs of one run (2 for up 1 and down 2 in
// y, else 1); R: outputs a run.
template <typename T, int V, int SHY>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_kernel(const Params p) {
  constexpr int R = SHY == 2 ? 2 : 4;
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);
  VT* patch = reinterpret_cast<VT*>(smem + TAP_BYTES);

  const int cv_n = 1 << p.cv_log2;
  const int bw = 1 << p.bw_log2;
  const int bh = RUNS * R;
  const int tile_x = blockIdx.x % p.tiles_x;
  const int cv0 = (blockIdx.x / p.tiles_x) * cv_n;
  const int oy0 = blockIdx.y * bh;
  const int ox0 = tile_x * bw;
  const int img = blockIdx.z;

  // the taps in correlation order, gain applied, rounded to T
  const int nt = p.fh * p.fw;
  if (threadIdx.x < nt) {
    const int i = threadIdx.x;
    float v = 1.0f;
    if (p.f != nullptr) {
      const int src = p.flip ? i : nt - 1 - i;
      v = __fmul_rn(p.f[src], p.gain);
    } else {
      v = p.gain;
    }
    taps[i] = round_to(v, static_cast<T*>(nullptr));
  }

  // the input rows and columns the tile reads
  const int r_lo = ceil_div(oy0 * p.downy - p.py0, p.upy);
  const int r_hi = floor_div((oy0 + bh - 1) * p.downy + p.fh - 1 - p.py0,
                             p.upy);
  const int c_lo = ceil_div(ox0 * p.downx - p.px0, p.upx);
  const int c_hi = floor_div((ox0 + bw - 1) * p.downx + p.fw - 1 - p.px0,
                             p.upx);
  const int rows = r_hi - r_lo + 1;
  const int cols = c_hi - c_lo + 1;

  const VT* x = reinterpret_cast<const VT*>(p.x) +
                static_cast<size_t>(img) * p.h * p.w * p.cvt;
  if (rows > 0 && cols > 0) {
    const int total = rows * cols * cv_n;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int cl = i & (cv_n - 1);
      const int rest = i >> p.cv_log2;
      const int rr = rest / cols;
      const int cc = rest - rr * cols;
      const int r = r_lo + rr, c = c_lo + cc, cv = cv0 + cl;
      const bool ok = r >= 0 && r < p.h && c >= 0 && c < p.w && cv < p.cvt;
      const VT* src =
          ok ? x + (static_cast<size_t>(r) * p.w + c) * p.cvt + cv : x;
      stage(patch + i, src, ok);
    }
  }
  stage_wait<VT>();
  __syncthreads();

  // this thread's channel vector, output column and run
  const int t = threadIdx.x;
  const int cl = t & (cv_n - 1);
  const int rest = t >> p.cv_log2;
  const int ox = ox0 + (rest & (bw - 1));
  const int run = rest >> p.bw_log2;
  const int phase = run % p.ph;
  const int oy_first = oy0 + phase + p.ph * (run / p.ph) * R;
  const int cv = cv0 + cl;
  if (ox >= p.ow || cv >= p.cvt || oy_first >= p.oh) return;

  // the first live tap on each axis, the input sample it meets, and how
  // many live taps there are (taps b0, b0 + upx, ... below fw)
  const int b0 = pmod(p.px0 - ox * p.downx, p.upx);
  const int c0 = (ox * p.downx + b0 - p.px0) / p.upx;
  const int tx_n = (p.fw - b0 + p.upx - 1) / p.upx;
  const int a0 = pmod(p.py0 - oy_first * p.downy, p.upy);
  const int r0 = (oy_first * p.downy + a0 - p.py0) / p.upy;
  const int ty_n = (p.fh - a0 + p.upy - 1) / p.upy;

  float tap[MAX_TAPS][MAX_TAPS];
#pragma unroll
  for (int ty = 0; ty < MAX_TAPS; ++ty) {
#pragma unroll
    for (int tx = 0; tx < MAX_TAPS; ++tx) {
      tap[ty][tx] = 0.0f;
      if (ty < ty_n && tx < tx_n)
        tap[ty][tx] = taps[(a0 + ty * p.upy) * p.fw + b0 + tx * p.upx];
    }
  }

  float acc[R][V];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.0f;

  // input row r0 + k serves output j of the run with tap row k - j * SHY
  const VT* base = patch + ((r0 - r_lo) * cols + (c0 - c_lo)) * cv_n + cl;
  const int k_n = (R - 1) * SHY + ty_n;
#pragma unroll
  for (int k = 0; k < (R - 1) * SHY + MAX_TAPS; ++k) {
    if (k < k_n) {
      float in[MAX_TAPS][V];
#pragma unroll
      for (int tx = 0; tx < MAX_TAPS; ++tx) {
        if (tx < tx_n) {
          const VT v = base[(k * cols + tx) * cv_n];
#pragma unroll
          for (int e = 0; e < V; ++e) in[tx][e] = to_f(v.v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) in[tx][e] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ty = k - j * SHY;
        if (ty >= 0 && ty < MAX_TAPS && ty < ty_n) {
#pragma unroll
          for (int tx = 0; tx < MAX_TAPS; ++tx) {
            if (tx < tx_n) {
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[j][e] = fmaf(in[tx][e], tap[ty][tx], acc[j][e]);
            }
          }
        }
      }
    }
  }

  VT* y = reinterpret_cast<VT*>(p.y);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int oy = oy_first + j * p.ph;
    if (oy < p.oh) {
      VT o;
#pragma unroll
      for (int e = 0; e < V; ++e) from_f(acc[j][e], &o.v[e]);
      y[((static_cast<size_t>(img) * p.oh + oy) * p.ow + ox) * p.cvt + cv] =
          o;
    }
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T, int V, int SHY>
int launch(Params p, cudaStream_t stream) {
  constexpr int R = SHY == 2 ? 2 : 4;
  // channel vectors a block: the largest power of two up to 8 that divides
  // the pixel's vectors; the columns fill the block's 256 threads
  int cv_log2 = 3;
  while (cv_log2 > 0 && (p.cvt % (1 << cv_log2)) != 0) --cv_log2;
  const int cv_n = 1 << cv_log2;
  const int bw_log2 = 6 - cv_log2;  // THREADS / RUNS / cv_n columns
  const int bw = 1 << bw_log2;
  const int bh = RUNS * R;
  p.cv_log2 = cv_log2;
  p.bw_log2 = bw_log2;
  p.tiles_x = (p.ow + bw - 1) / bw;
  const long long chunks = (p.cvt + cv_n - 1) / cv_n;
  const long long gx = static_cast<long long>(p.tiles_x) * chunks;
  const int gy = (p.oh + bh - 1) / bh;
  if (gx > 0x7fffffffLL || gy > 65535 || p.n > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int rows = ((bh - 1) * p.downy + p.fh - 1) / p.upy + 2;
  const int cols = ((bw - 1) * p.downx + p.fw - 1) / p.upx + 2;
  const size_t smem =
      TAP_BYTES + static_cast<size_t>(rows) * cols * cv_n * sizeof(Vec<T, V>);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  upfirdn2d_kernel<T, V, SHY>
      <<<dim3(static_cast<unsigned>(gx), gy, p.n), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_rows(const Params& p, cudaStream_t stream) {
  if (p.upy == 1 && p.downy == 2) return launch<T, V, 2>(p, stream);
  return launch<T, V, 1>(p, stream);
}

template <typename T>
int launch_dtype(Params p, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (c % V == 0 && aligned16(p.x) && aligned16(p.y)) {
    p.cvt = c / V;
    return launch_rows<T, V>(p, stream);
  }
  p.cvt = c;
  return launch_rows<T, 1>(p, stream);
}

}  // namespace

// y [n, out_h, out_w, c] = upfirdn2d(x [n, h, w, c]), both contiguous NHWC
// of `dtype` (0 bf16, 1 fp32); f [fh, fw] fp32 on the device, or null for
// the 1 x 1 identity. up, down in {1, 2} a axis, fh, fw <= 4, any padding
// (negative crops). out_h = (h * upy + py0 + py1 - fh) / downy + 1, as the
// caller computes it. Returns 0 or a CUDA error code.
extern "C" int pasta_upfirdn2d(const void* x, const void* f, void* y,
                               int dtype, int n, int h, int w, int c,
                               int out_h, int out_w, int upx, int upy,
                               int downx, int downy, int px0, int py0,
                               int fh, int fw, int flip, float gain,
                               void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || out_h < 1 || out_w < 1 ||
      upx < 1 || upx > 2 || upy < 1 || upy > 2 || downx < 1 || downx > 2 ||
      downy < 1 || downy > 2 || fh < 1 || fh > MAX_TAPS || fw < 1 ||
      fw > MAX_TAPS || (f == nullptr && (fh != 1 || fw != 1)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.f = static_cast<const float*>(f);
  p.y = y;
  p.n = n;
  p.h = h;
  p.w = w;
  p.oh = out_h;
  p.ow = out_w;
  p.upx = upx;
  p.upy = upy;
  p.downx = downx;
  p.downy = downy;
  p.px0 = px0;
  p.py0 = py0;
  p.fw = fw;
  p.fh = fh;
  p.flip = flip;
  p.gain = gain;
  p.ph = (upy == 2 && downy == 1) ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<__nv_bfloat16>(p, c, s);
  if (dtype == 1) return launch_dtype<float>(p, c, s);
  return (int)cudaErrorInvalidValue;
}
