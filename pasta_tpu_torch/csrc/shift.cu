// K2 / K3: the per-row fractional shift of the two-pass ADA warp and its
// exact adjoint, for Hopper (sm_90a).
//
// Replace the Pallas kernels pasta_tpu/ops/affine_warp.py::_shift_fwd_pallas
// (K2) and ::_shift_bwd_pallas (K3). Both take a per-row window start
// `start[r]` and per-row tap weights `w[r, t]` (fp32, TAPS of them):
//
//   K2  out[r, x]          = sum_t w[r, t] * wide[r, start[r] + t + x]
//                            (columns of `wide` at or past V read as 0)
//   K3  dwide[r, start+j]  = sum_t w[r, t] * dout[r, j - t]
//                            for 0 <= j < out_w + TAPS, every other column
//                            of the [R, V] result 0 -- a gather, no atomics.
//
// For K2/K3 themselves the start is the Pallas kernel's base + rem, the
// same for the 8 rows of a block, and w is _shift_prep's per-row one-hot
// pair (which already folds in the per-block clamp of the tap offset); the
// kernels compute the function for any per-row start and taps, which also
// covers the TPU design probes of K2 (two taps, a start per row).
//
// What bounds it on an H100: memory. K2 reads a row's out_w + TAPS window
// and writes out_w outputs -- about 4 bytes of traffic per bf16 output
// against TAPS FMAs -- so its floor is those bytes at 3.35 TB/s. K3 reads
// out_w values and writes all V columns of its row. The design keeps each
// byte to one pass: one warp per row (8 rows a block), the row's window
// staged once in shared memory as fp32 with 16-byte global loads, each
// lane then computing 4 adjacent outputs from float4 shared-memory reads
// (4 + TAPS - 1 values feed 4 * TAPS FMAs, all in fp32 registers, taps in
// ascending order as the TPU kernel sums them), and the results stored as
// 4-element vectors (8 bytes in bf16, 16 in fp32). The TPU blocking -- the
// 128-aligned base, rolls in f32, grouping row blocks per grid step --
// exists to reach unaligned lane offsets and amortise grid steps; shared
// memory takes any offset, so it is not carried over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows per block, one warp each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dst[j] = src[j] (as fp32) for 0 <= j < n, 0 for n <= j < m; one warp.
// 16-byte loads over the aligned middle, scalar loads at the ends.
template <typename T>
__device__ void stage_row(const T* __restrict__ src, int n, float* dst,
                          int m, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(src) & 15u);
  int head = (int)(((16u - mis) & 15u) / sizeof(T));
  if (head > n) head = n;
  for (int j = lane; j < head; j += 32) dst[j] = to_f(src[j]);
  const int nv = (n - head) / VEC;
  const uint4* v = reinterpret_cast<const uint4*>(src + head);
  for (int i = lane; i < nv; i += 32) {
    const uint4 u = v[i];
    const T* e = reinterpret_cast<const T*>(&u);
    float* d = dst + head + i * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = to_f(e[k]);
  }
  for (int j = head + nv * VEC + lane; j < m; j += 32)
    dst[j] = j < n ? to_f(src[j]) : 0.0f;
}

// row[c0 .. c0+3] = v (columns at or past lim dropped); one vector store
// where the 4 elements are whole and aligned.
__device__ __forceinline__ void store4(float* row, int c0, int lim,
                                       const float* v) {
  float* q = row + c0;
  if (c0 + 3 < lim && (reinterpret_cast<uintptr_t>(q) & 15u) == 0) {
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && c0 + k < lim; ++k) q[k] = v[k];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int c0, int lim,
                                       const float* v) {
  __nv_bfloat16* q = row + c0;
  if (c0 + 3 < lim && (reinterpret_cast<uintptr_t>(q) & 7u) == 0) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(q) = u;
  } else {
    for (int k = 0; k < 4 && c0 + k < lim; ++k) q[k] = __float2bfloat16(v[k]);
  }
}

// Shared-memory floats per warp.
template <int TAPS>
struct Win {
  static constexpr int NV = (TAPS + 3 + 3) / 4;     // K2 float4 reads
  static constexpr int TP = (TAPS - 1 + 3) / 4 * 4;  // K3 left zero pad
  static constexpr int NQ = TP / 4 + 1;             // K3 float4 reads
  static int fwd(int out_w) { return (out_w + 3) / 4 * 4 + 4 * NV; }
  static int bwd(int out_w) { return (out_w + TAPS + TP + 6 + 3) / 4 * 4; }
};

template <typename T, int TAPS>
__global__ void __launch_bounds__(WARPS * 32)
shift_fwd_kernel(const T* __restrict__ wide, const int* __restrict__ start,
                 const float* __restrict__ w, T* __restrict__ out, int rows,
                 int v_dim, int out_w, int win) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  float* sw = smem + warp * win;
  const int s0 = start[r];
  // the window wide[r, s0 : s0 + out_w + TAPS], zero past V (start >= 0)
  const int n = s0 < 0 ? 0 : max(0, min(out_w + TAPS, v_dim - s0));
  stage_row(wide + (size_t)r * v_dim + (s0 < 0 ? 0 : s0), n, sw, win, lane);
  float wt[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) wt[t] = w[(size_t)r * TAPS + t];
  __syncwarp();
  T* orow = out + (size_t)r * out_w;
  for (int x0 = lane * 4; x0 < out_w; x0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* s4 = reinterpret_cast<const float4*>(sw + x0);
#pragma unroll
    for (int q = 0; q < Win<TAPS>::NV; ++q) {
      const float4 v = s4[q];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * q + k - j;       // ascending in (q, k)
          if (t >= 0 && t < TAPS) acc[j] = fmaf(wt[t], e[k], acc[j]);
        }
      }
    }
    store4(orow, x0, out_w, acc);
  }
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(WARPS * 32)
shift_bwd_kernel(const T* __restrict__ dout, const int* __restrict__ start,
                 const float* __restrict__ w, T* __restrict__ dwide, int rows,
                 int v_dim, int out_w, int win) {
  using W = Win<TAPS>;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  float* sd = smem + warp * win;
  const int s0 = start[r];
  const int sm = s0 & 3;
  const int a0 = s0 - sm;                  // 4-aligned column below s0
  // sd[k] = dout[r, k - TP - sm] inside the row, 0 outside
  for (int k = lane; k < W::TP + sm; k += 32) sd[k] = 0.0f;
  stage_row(dout + (size_t)r * out_w, out_w, sd + W::TP + sm,
            win - W::TP - sm, lane);
  float wt[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) wt[t] = w[(size_t)r * TAPS + t];
  __syncwarp();
  const int len = out_w + TAPS;
  T* orow = dwide + (size_t)r * v_dim;
  for (int c0 = lane * 4; c0 < v_dim; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (c0 + 3 >= s0 && c0 < s0 + len) {
      // column c0 + j reads sd[(c0 - a0) + TP + j - t]
      const float4* s4 = reinterpret_cast<const float4*>(sd + (c0 - a0));
#pragma unroll
      for (int q = W::NQ - 1; q >= 0; --q) {
        const float4 v = s4[q];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 3; k >= 0; --k) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = j + W::TP - 4 * q - k;   // ascending
            if (t >= 0 && t < TAPS) acc[j] = fmaf(wt[t], e[k], acc[j]);
          }
        }
      }
    }
    store4(orow, c0, v_dim, acc);
  }
}

template <typename T, int TAPS>
int fwd(const void* wide, const void* start, const void* w, void* out,
        int rows, int v_dim, int out_w, cudaStream_t s) {
  const int win = Win<TAPS>::fwd(out_w);
  const int smem = WARPS * win * (int)sizeof(float);
  auto kernel = shift_fwd_kernel<T, TAPS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, smem, s>>>(
      static_cast<const T*>(wide), static_cast<const int*>(start),
      static_cast<const float*>(w), static_cast<T*>(out), rows, v_dim, out_w,
      win);
  return (int)cudaGetLastError();
}

template <typename T, int TAPS>
int bwd(const void* dout, const void* start, const void* w, void* dwide,
        int rows, int v_dim, int out_w, cudaStream_t s) {
  const int win = Win<TAPS>::bwd(out_w);
  const int smem = WARPS * win * (int)sizeof(float);
  auto kernel = shift_bwd_kernel<T, TAPS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, smem, s>>>(
      static_cast<const T*>(dout), static_cast<const int*>(start),
      static_cast<const float*>(w), static_cast<T*>(dwide), rows, v_dim,
      out_w, win);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (data and result; w is fp32, start int32).
// taps: 40 (K2/K3) or 2 (the probes' two-tap shift). Launch on `stream`
// without synchronising and return cudaGetLastError()
// (cudaErrorInvalidValue outside that scope).
extern "C" int pasta_shift_fwd(const void* wide, const void* start,
                               const void* w, void* out, int dtype, int rows,
                               int v_dim, int out_w, int taps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || out_w < 1 || v_dim < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && taps == 40)
    return fwd<__nv_bfloat16, 40>(wide, start, w, out, rows, v_dim, out_w, s);
  if (dtype == 1 && taps == 40)
    return fwd<float, 40>(wide, start, w, out, rows, v_dim, out_w, s);
  if (dtype == 0 && taps == 2)
    return fwd<__nv_bfloat16, 2>(wide, start, w, out, rows, v_dim, out_w, s);
  if (dtype == 1 && taps == 2)
    return fwd<float, 2>(wide, start, w, out, rows, v_dim, out_w, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pasta_shift_bwd(const void* dout, const void* start,
                               const void* w, void* dwide, int dtype,
                               int rows, int v_dim, int out_w, int taps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || out_w < 1 || v_dim < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && taps == 40)
    return bwd<__nv_bfloat16, 40>(dout, start, w, dwide, rows, v_dim, out_w,
                                  s);
  if (dtype == 1 && taps == 40)
    return bwd<float, 40>(dout, start, w, dwide, rows, v_dim, out_w, s);
  if (dtype == 0 && taps == 2)
    return bwd<__nv_bfloat16, 2>(dout, start, w, dwide, rows, v_dim, out_w,
                                 s);
  if (dtype == 1 && taps == 2)
    return bwd<float, 2>(dout, start, w, dwide, rows, v_dim, out_w, s);
  return (int)cudaErrorInvalidValue;
}
