// K2 / K3: the per-row fractional shift of the two-pass ADA warp and its
// exact adjoint, for Hopper (sm_90a).
//
// Replace the Pallas kernels pasta_tpu/ops/affine_warp.py::_shift_fwd_pallas
// (K2) and ::_shift_bwd_pallas (K3). A row r has a window start s[r] and a
// fraction f[r]:
//
//   K2  out[r, x]   = (1 - f) * wide[r, s + x] + f * wide[r, s + x + 1]
//                     (columns of `wide` outside [0, V) read as 0)
//   K3  dwide[r, c] = (1 - f) * dout[r, c - s] + f * dout[r, c - s - 1]
//                     (columns of `dout` outside [0, out_w) read as 0), every
//                     column of the [R, V] result written -- a gather, no
//                     atomics.
//
// Each product is rounded to fp32 and the two are added, tap 0 first, with
// no fused multiply-add, so a result equals the plain PyTorch version's bit
// for bit on finite inputs.
//
// (s, f) come from one of two entries. From `q` ([R] fp32, R a multiple of
// 8), the kernel derives them as pasta_tpu's _shift_prep does, in exact
// fp32 / int steps: q clamped to [0, V - out_w - 42], k = floor(q),
// f = q - k, kmin = the least k of the row's block of 8 rows, and
// s = kmin + clamp(k - kmin, 0, 38). Or (start, f) are given per row, as
// the design probes of K2 have them.
//
// The TPU kernel sums 40 statically shifted slices weighted by a one-hot
// pair, because a vector lane there cannot take a per-row dynamic offset;
// 38 of its 40 products are by zero. A thread here can, so this kernel has
// two taps and needs neither [R, 40] weights nor the ops that build them.
//
// What bounds it on an H100: memory. Two multiplies and an add per output
// against 4 bytes of traffic (bf16: 2 read, 2 written) leave the arithmetic
// two orders of magnitude under the card's rate, so the floor is each byte
// moved once at 3.35 TB/s, and what sets the pace is how many bytes the card
// has in flight and whether each request is a full 16 bytes. The design:
//   - a block takes 8 rows (the unit of kmin); its first warp derives the 8
//     (s, f) pairs into shared memory, one row a lane, kmin by shuffles;
//   - the block's outputs are cut into 16-byte chunks, dealt to the threads
//     flat across the 8 rows (no tail of idle lanes at the end of each row:
//     1048 bf16 outputs are 131 chunks), with the thread count chosen on the
//     host so that every thread has the same number of chunks;
//   - a chunk needs 9 (bf16) or 5 (fp32) source elements from an offset that
//     is not aligned. The thread reads the two 16-byte aligned chunks that
//     hold them straight from global memory into registers (the second is
//     its neighbour's first: L1 serves it), picks the window out of the 8
//     words with selects and one funnel shift for an odd bf16 offset, and
//     stores 16 aligned bytes. Nothing is staged in shared memory;
//   - a thread starts the loads of two chunks before it computes the first
//     (64 bytes a thread in flight, 40 registers, 1408 threads an SM at the
//     training shape). More does not help: on an H100 at 700 W, 1 to 6
//     chunks ahead and 128 to 1024 threads a block all landed within a few
//     percent of each other and of the time torch's device-to-device copy
//     takes for as many bytes (chip_smoke.py prints both), so the pace is
//     the memory system's and not this kernel's instruction rate.
// K3 is the same kernel with the roles swapped: chunks run over the V
// columns of dwide, the source is dout at offset c - s - 1, the weights
// change places; chunks outside the window load nothing and store zeros.
// Rows whose width or address is not a multiple of 16 bytes take a scalar
// kernel of the same arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;          // rows a block: the unit kmin is taken over
constexpr int MAX_OFFSET = 38;   // a row's start is at most this past kmin
constexpr int WINDOW_PAD = 42;   // q is clamped to [0, V - out_w - 42]
constexpr int THREADS = 512;     // most threads a block
constexpr int UNROLL = 2;        // chunks a thread loads before it computes

__device__ __forceinline__ float two_tap(float wa, float a, float wb,
                                         float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// The block's 8 (s, f) pairs into shared memory; called by the whole first
// warp, lane l working on row r0 + (l & 7).
__device__ __forceinline__ void row_params(
    const float* __restrict__ q, const int* __restrict__ start,
    const float* __restrict__ frac, int* __restrict__ s_out,
    float* __restrict__ f_out, int r0, int rows, float q_hi, int* s_sh,
    float* f_sh) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & (ROWS - 1));
  int s = 0;
  float f = 0.0f;
  if (q != nullptr) {            // rows is a multiple of 8 here
    const float qc = fminf(fmaxf(q[r], 0.0f), q_hi);
    const float kf = floorf(qc);
    f = qc - kf;
    const int k = (int)kf;
    int kmin = k;
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 1));
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 2));
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 4));
    s = kmin + min(max(k - kmin, 0), MAX_OFFSET);
  } else if (r < rows) {
    s = start[r];
    f = frac[r];
  }
  if (lane < ROWS && r < rows) {
    s_sh[lane] = s;
    f_sh[lane] = f;
    if (s_out != nullptr) {
      s_out[r] = s;
      f_out[r] = f;
    }
  }
}

// The aligned 16-byte chunk row[j .. j + VEC), zeros outside [0, len);
// j and len are multiples of VEC.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int j,
                                            int len) {
  if (j >= 0 && j < len) return __ldg(reinterpret_cast<const uint4*>(row + j));
  return make_uint4(0u, 0u, 0u, 0u);
}

// u[i] = word wo + i of the 8 loaded words (a ninth reads as 0), wo in 0..3.
__device__ __forceinline__ void window(const uint4 lo, const uint4 hi, int wo,
                                       unsigned (&u)[6]) {
  const unsigned w[9] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, 0u};
  unsigned a[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) a[i] = (wo & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = (wo & 1) ? a[i + 1] : a[i];
}

// blend(lo, hi, m, wa, wb): the chunk out[i] = wa * e[i] + wb * e[i + 1],
// where e[k] is element m + k of the 2 * VEC loaded ones, 0 <= m < VEC.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ uint4 blend(const uint4 lo, const uint4 hi,
                                                int m, float wa, float wb) {
    unsigned u[6];
    window(lo, hi, m, u);
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = two_tap(wa, __uint_as_float(u[i]), wb, __uint_as_float(u[i + 1]));
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                      __float_as_uint(o[2]), __float_as_uint(o[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ uint4 blend(const uint4 lo, const uint4 hi,
                                                int m, float wa, float wb) {
    unsigned u[6];
    window(lo, hi, m >> 1, u);
    const unsigned odd = (m & 1) * 16;   // an odd offset starts in a high half
    float e[10];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const unsigned v = __funnelshift_r(u[i], u[i + 1], odd);
      e[2 * i] = __uint_as_float(v << 16);
      e[2 * i + 1] = __uint_as_float(v & 0xffff0000u);
    }
    unsigned o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          two_tap(wa, e[2 * i], wb, e[2 * i + 1]),
          two_tap(wa, e[2 * i + 1], wb, e[2 * i + 2]));
      o[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// ADJ false: K2, src = wide [rows, src_w = V], dst = out [rows, dst_w =
// out_w]. ADJ true: K3, src = dout [rows, out_w], dst = dwide [rows, V].
template <typename T, bool ADJ>
__global__ void __launch_bounds__(THREADS)
shift_vec_kernel(const T* __restrict__ src, const float* __restrict__ q,
                 const int* __restrict__ start, const float* __restrict__ frac,
                 T* __restrict__ dst, int* __restrict__ s_out,
                 float* __restrict__ f_out, int rows, int src_w, int dst_w,
                 float q_hi) {
  constexpr int VEC = Chunk<T>::VEC;
  constexpr int U = UNROLL;
  __shared__ int s_sh[ROWS];
  __shared__ float f_sh[ROWS];
  const int r0 = blockIdx.x * ROWS;
  if (threadIdx.x < 32)
    row_params(q, start, frac, s_out, f_out, r0, rows, q_hi, s_sh, f_sh);
  __syncthreads();
  const int cpr = dst_w / VEC;                    // chunks a row
  const int total = min(ROWS, rows - r0) * cpr;
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += step * U) {
    uint4 lo[U], hi[U];
    int m[U];
    float wa[U], wb[U];
    T* out[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * step;
      if (i < total) {
        const int row = i / cpr;
        const int c0 = (i - row * cpr) * VEC;
        const int s = s_sh[row];
        const float f = f_sh[row];
        const int j0 = ADJ ? c0 - s - 1 : c0 + s;  // source element of e[0]
        const int ja = j0 & ~(VEC - 1);            // the aligned one below
        m[u] = j0 - ja;
        wa[u] = ADJ ? f : 1.0f - f;
        wb[u] = ADJ ? 1.0f - f : f;
        const T* srow = src + (size_t)(r0 + row) * src_w;
        lo[u] = load_chunk(srow, ja, src_w);
        hi[u] = load_chunk(srow, ja + VEC, src_w);
        out[u] = dst + (size_t)(r0 + row) * dst_w + c0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * step < total)
        *reinterpret_cast<uint4*>(out[u]) =
            Chunk<T>::blend(lo[u], hi[u], m[u], wa[u], wb[u]);
    }
  }
}

// The same function an element a thread, for rows that are not whole
// 16-byte chunks at 16-byte aligned addresses.
template <typename T, bool ADJ>
__global__ void __launch_bounds__(THREADS)
shift_scalar_kernel(const T* __restrict__ src, const float* __restrict__ q,
                    const int* __restrict__ start,
                    const float* __restrict__ frac, T* __restrict__ dst,
                    int* __restrict__ s_out, float* __restrict__ f_out,
                    int rows, int src_w, int dst_w, float q_hi) {
  __shared__ int s_sh[ROWS];
  __shared__ float f_sh[ROWS];
  const int r0 = blockIdx.x * ROWS;
  if (threadIdx.x < 32)
    row_params(q, start, frac, s_out, f_out, r0, rows, q_hi, s_sh, f_sh);
  __syncthreads();
  const int total = min(ROWS, rows - r0) * dst_w;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = i / dst_w;
    const int c = i - row * dst_w;
    const int s = s_sh[row];
    const float f = f_sh[row];
    const int j0 = ADJ ? c - s - 1 : c + s;
    const T* srow = src + (size_t)(r0 + row) * src_w;
    const float a = (j0 >= 0 && j0 < src_w) ? to_f(srow[j0]) : 0.0f;
    const float b = (j0 + 1 >= 0 && j0 + 1 < src_w) ? to_f(srow[j0 + 1]) : 0.0f;
    from_f(two_tap(ADJ ? f : 1.0f - f, a, ADJ ? 1.0f - f : f, b),
           dst + (size_t)(r0 + row) * dst_w + c);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool ADJ>
int launch(const void* src, const float* q, const int* start,
           const float* frac, void* dst, int* s_out, float* f_out, int rows,
           int v_dim, int out_w, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int src_w = ADJ ? out_w : v_dim, dst_w = ADJ ? v_dim : out_w;
  const float q_hi = (float)(v_dim - out_w - WINDOW_PAD);
  const int blocks = (rows + ROWS - 1) / ROWS;
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (src_w % VEC == 0 && dst_w % VEC == 0 && aligned16(src) &&
      aligned16(dst)) {
    // the fewest chunks a thread that THREADS threads allow, then the fewest
    // threads that still take that many: every thread has the same work, to
    // within one chunk
    const int total = ROWS * (dst_w / VEC);
    const int each = (total + THREADS - 1) / THREADS;
    const int need = ((total + each - 1) / each + 31) / 32 * 32;
    const int threads = need < THREADS ? need : THREADS;
    shift_vec_kernel<T, ADJ><<<blocks, threads, 0, st>>>(
        s, q, start, frac, d, s_out, f_out, rows, src_w, dst_w, q_hi);
  } else {
    shift_scalar_kernel<T, ADJ><<<blocks, THREADS, 0, st>>>(
        s, q, start, frac, d, s_out, f_out, rows, src_w, dst_w, q_hi);
  }
  return (int)cudaGetLastError();
}

template <bool ADJ>
int dispatch(const void* src, const void* q, const void* start,
             const void* frac, void* dst, void* s_out, void* f_out, int dtype,
             int rows, int v_dim, int out_w, void* stream) {
  if (rows < 1 || out_w < 1 || v_dim < 1) return (int)cudaErrorInvalidValue;
  if (q != nullptr) {
    if (rows % ROWS != 0 || v_dim - out_w - WINDOW_PAD < 0)
      return (int)cudaErrorInvalidValue;
  } else if (start == nullptr || frac == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if ((s_out == nullptr) != (f_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* si = static_cast<const int*>(start);
  const float* ff = static_cast<const float*>(frac);
  int* so = static_cast<int*>(s_out);
  float* fo = static_cast<float*>(f_out);
  if (dtype == 0)
    return launch<__nv_bfloat16, ADJ>(src, qf, si, ff, dst, so, fo, rows,
                                      v_dim, out_w, st);
  if (dtype == 1)
    return launch<float, ADJ>(src, qf, si, ff, dst, so, fo, rows, v_dim,
                              out_w, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2: out [rows, out_w] from wide [rows, v_dim]. dtype: 0 = bf16, 1 = fp32
// (data and result). Either q ([rows] fp32, rows a multiple of 8, v_dim >=
// out_w + 42) or start ([rows] int32) and frac ([rows] fp32), the other(s)
// null. s_out / f_out: null, or [rows] int32 / fp32 that receive the (s, f)
// the kernel used. Launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue outside that scope).
extern "C" int pasta_shift_fwd(const void* wide, const void* q,
                               const void* start, const void* frac, void* out,
                               void* s_out, void* f_out, int dtype, int rows,
                               int v_dim, int out_w, void* stream) {
  return dispatch<false>(wide, q, start, frac, out, s_out, f_out, dtype, rows,
                         v_dim, out_w, stream);
}

// K3, the adjoint: dwide [rows, v_dim] from dout [rows, out_w]; the other
// arguments as for K2.
extern "C" int pasta_shift_bwd(const void* dout, const void* q,
                               const void* start, const void* frac,
                               void* dwide, void* s_out, void* f_out,
                               int dtype, int rows, int v_dim, int out_w,
                               void* stream) {
  return dispatch<true>(dout, q, start, frac, dwide, s_out, f_out, dtype, rows,
                        v_dim, out_w, stream);
}
