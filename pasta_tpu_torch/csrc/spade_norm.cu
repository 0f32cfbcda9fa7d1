// spade_norm: SPADE's instance normalisation fused with the pre-activation
// of the conv that takes its result, fp32 NHWC, for Hopper (sm_90a).
//
// This kernel pair replaces no TPU kernel. The JAX package leaves the op to
// XLA's fusion; the port spelled it as PyTorch's plain ops do, some twelve
// passes over the activation: the moments (x - mean, its square, a mean,
// x - mean again, * rsqrt), the affine of the chunked gamma / beta views
// (1 + gamma, *, + beta) through ATen's strided elementwise kernel, then
// the next conv's relu, * gain and clamp. For x [N, H, W, C] and
// gb [N, H, W, 2C] (gamma = channels [0, C), beta = [C, 2C)) it computes
//
//   mean, rstd = per-(n, c) moments of x over H, W (biased variance, eps)
//   y = clamp(relu(((x - mean) * rstd) * (1 + gamma) + beta) * gain,
//             -clamp, clamp)
//
// and, for the backward, dx and dgb of y from dy, recomputing the relu and
// clamp masks from x, the moments and gb (y is not kept).
//
// What bounds it on an H100: memory. A few operations an element against
// 12 (forward apply), 4 (moments) or 32 (backward) bytes leave the
// arithmetic far under the card's rate, so the floor is each input byte
// read once and each output byte written once at 3.35 TB/s. The design:
//   - moments: one read of x. A block owns a run of rows of one image, a
//     thread one 16-byte channel vector of every (THREADS / vectors)-th
//     pixel; it merges batches of 4 pixels into its running (count, mean,
//     M2) by Chan's formula, the block merges its threads in a fixed
//     order, and a second small kernel merges the blocks' partials of each
//     (n, c) in block order (Chan again; never E[x^2] - E[x]^2). No
//     atomics: two runs give the same bits, and a CUDA graph captures it;
//   - apply: one pass over NHWC, a block a run of pixels along W and every
//     channel, 16-byte loads and stores along C. gamma and beta are read
//     where they lie, through gb's strides: 16-byte vectors where the
//     channels are contiguous (K1's NHWC output), else (a permuted view of
//     an NCHW conv output: W contiguous) staged through shared memory by
//     coalesced loads along W and read back as vectors, conflict-free;
//   - backward: one reduction pass over dy, x and gb for the two
//     per-(n, c) sums of instance-norm backward (blocks' partials merged in
//     order as above), then one pass that writes dx and dgb, contiguous
//     NHWC. dy is read through its strides as 16-byte channel vectors
//     (G's backward hands it NHWC, whole or as a pad's gradient slices
//     it; the wrapper copies any other layout).
// Every sum is fp32. The element-wise arithmetic keeps the plain chain's
// roundings (no contraction into fma), so the kernels differ from it only
// by the order of the moments' sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_ITEMS = 4;   // channel vectors a thread a tile: apply
constexpr int BWD_ITEMS = 2;   // backward
constexpr int BATCH = 4;       // pixels a thread reads, then merges

// An fp32 [N, H, W, C'] operand and its strides in elements: read as
// 16-byte channel vectors (sc == 1) or staged along W (sw == 1).
struct Op {
  const float* p;
  long long sn, sh, sw, sc;
};

struct Params {
  const float* x;      // [n, h, w, c] contiguous
  Op gb;               // [n, h, w, 2c]
  Op dy;               // [n, h, w, c], backward
  const float* mean;   // [n, c]
  const float* rstd;   // [n, c]
  const float* s1;     // [n, c]: mean over H, W of dxhat (backward)
  const float* s2;     // [n, c]: mean over H, W of dxhat * xhat
  float* y;            // apply: y; backward: dx [n, h, w, c] contiguous
  float* dgb;          // [n, h, w, 2c] contiguous
  float* part0;        // the reduction blocks' partials [n, blocks, c]
  float* part1;
  float* out0;         // merged: mean / s1 [n, c]
  float* out1;         // rstd / s2 [n, c]
  int n, h, w, c;
  int cvn, cv_log2;    // 16-byte channel vectors a pixel (power of two)
  int tile_log2;       // pixels a tile, a run along W
  int rows;            // rows of one image a reduction block takes
  int blocks;          // reduction blocks an image
  float gain, clamp, eps;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float& at(float4& v, int e) {
  return (&v.x)[e];
}
__device__ __forceinline__ float at(const float4& v, int e) {
  return (&v.x)[e];
}

// Stage channel vectors [0, nv) of pixels w0 .. w0 + npix of row (n, h) of
// an operand whose W stride is 1 into tile[v * (P + 1) + pix]: lanes take
// neighbouring pixels, so each of the four loads is coalesced, and the odd
// row pitch keeps both the stores and the vector reads free of bank
// conflicts.
__device__ __forceinline__ void stage(float4* tile, const Op& op, int n,
                                      int h, int w0, int npix, int nv,
                                      int tile_log2) {
  const int pitch = (1 << tile_log2) + 1;
  const float* base = op.p + n * op.sn + h * op.sh + w0;
  for (int i = threadIdx.x; i < (nv << tile_log2); i += THREADS) {
    const int v = i >> tile_log2;
    const int pix = i & ((1 << tile_log2) - 1);
    if (pix < npix) {
      const float* q = base + pix + 4 * v * op.sc;
      tile[v * pitch + pix] =
          make_float4(q[0], q[op.sc], q[2 * op.sc], q[3 * op.sc]);
    }
  }
}

// Channel vector v of pixel (n, h, w) -- pix in the tile -- of an operand.
template <bool STAGED>
__device__ __forceinline__ float4 read(const float4* tile, const Op& op,
                                       int n, int h, int w, int pix, int v,
                                       int tile_log2) {
  if (STAGED) return tile[v * ((1 << tile_log2) + 1) + pix];
  return ld4(op.p + n * op.sn + h * op.sh + w * op.sw + 4 * v);
}

__device__ __forceinline__ size_t pixel(const Params& p, int n, int h,
                                        int w) {
  return (static_cast<size_t>(n) * p.h + h) * p.w + w;
}

// One channel, forward: the plain chain's roundings in its order.
__device__ __forceinline__ float act_fwd(float x, float m, float r, float g,
                                         float b, float gain, float cl) {
  const float xh = __fmul_rn(__fsub_rn(x, m), r);
  const float z = __fadd_rn(__fmul_rn(xh, __fadd_rn(1.0f, g)), b);
  const float u = __fmul_rn(z < 0.0f ? 0.0f : z, gain);
  return u < -cl ? -cl : (u > cl ? cl : u);
}

// One channel, backward: xhat, the gradient at the affine's output (dz,
// which is dbeta; dgamma is dz * xhat) and at xhat. relu passes where its
// output is positive, clamp where its input lies in [-cl, cl], as autograd
// has them.
__device__ __forceinline__ void act_bwd(float dy, float x, float m, float r,
                                        float g, float b, float gain,
                                        float cl, float& xh, float& dz,
                                        float& dxh) {
  xh = __fmul_rn(__fsub_rn(x, m), r);
  const float g1 = __fadd_rn(1.0f, g);
  const float z = __fadd_rn(__fmul_rn(xh, g1), b);
  const float u = __fmul_rn(z < 0.0f ? 0.0f : z, gain);
  dz = (z > 0.0f && u >= -cl && u <= cl) ? __fmul_rn(dy, gain) : 0.0f;
  dxh = __fmul_rn(dz, g1);
}

// Chan's merge of (nb, mb, qb) into (na, ma, qa): counts, means, sums of
// squared deviations.
__device__ __forceinline__ void chan(float& na, float& ma, float& qa,
                                     float nb, float mb, float qb) {
  const float n = na + nb;
  const float d = mb - ma;
  const float f = nb / n;
  ma = fmaf(d, f, ma);
  qa = qa + qb + d * d * na * f;
  na = n;
}

__global__ void __launch_bounds__(THREADS)
spade_norm_stats_kernel(const Params p) {
  __shared__ float cnt_s[THREADS];
  __shared__ float4 mean_s[THREADS], m2_s[THREADS];
  const int n = blockIdx.y;
  const int cv = threadIdx.x & (p.cvn - 1);
  const int lane = threadIdx.x >> p.cv_log2;
  const int lanes = THREADS >> p.cv_log2;
  const int h0 = blockIdx.x * p.rows;
  const long long q1 =
      static_cast<long long>(min(p.h, h0 + p.rows) - h0) * p.w;
  const float* x = p.x + pixel(p, n, h0, 0) * p.c + 4 * cv;

  float cnt = 0.0f;
  float4 mean = make_float4(0.f, 0.f, 0.f, 0.f), m2 = mean;
  for (long long q = lane; q < q1; q += BATCH * lanes) {
    float4 v[BATCH];
    int nb = 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (q + k * lanes < q1) {
        v[k] = ld4(x + (q + k * lanes) * p.c);
        ++nb;
      }
    }
    const float inv = 1.0f / nb;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (k < nb) s += at(v[k], e);
      const float bm = s * inv;
      float bq = 0.0f;
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (k < nb) {
          const float d = at(v[k], e) - bm;
          bq = fmaf(d, d, bq);
        }
      }
      float na = cnt;
      chan(na, at(mean, e), at(m2, e), static_cast<float>(nb), bm, bq);
    }
    cnt += nb;
  }
  cnt_s[threadIdx.x] = cnt;
  mean_s[threadIdx.x] = mean;
  m2_s[threadIdx.x] = m2;
  __syncthreads();
  if (threadIdx.x < p.cvn) {
    float nt = 0.0f;
    float4 mt = make_float4(0.f, 0.f, 0.f, 0.f), qt = mt;
    for (int l = 0; l < lanes; ++l) {
      const int i = (l << p.cv_log2) + threadIdx.x;
      if (cnt_s[i] > 0.0f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float na = nt;
          chan(na, at(mt, e), at(qt, e), cnt_s[i], at(mean_s[i], e),
               at(m2_s[i], e));
        }
        nt += cnt_s[i];
      }
    }
    const size_t o =
        (static_cast<size_t>(n) * p.blocks + blockIdx.x) * p.c + 4 * cv;
    st4(p.part0 + o, mt);
    st4(p.part1 + o, qt);
  }
}

// MOMENTS: the moments' partials (mean, M2) -> mean, rstd; else the
// backward's partial sums -> their means over H, W. One thread a (n, c),
// the blocks in order.
template <bool MOMENTS>
__global__ void __launch_bounds__(THREADS)
spade_norm_merge_kernel(const Params p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.n * p.c) return;
  const int n = i / p.c, ch = i - n * p.c;
  const float hw = static_cast<float>(p.h) * p.w;
  float a = 0.0f, b = 0.0f, cnt = 0.0f;
  for (int k = 0; k < p.blocks; ++k) {
    const size_t o = (static_cast<size_t>(n) * p.blocks + k) * p.c + ch;
    if (MOMENTS) {
      const float rows = min(p.h, (k + 1) * p.rows) - k * p.rows;
      chan(cnt, a, b, rows * p.w, p.part0[o], p.part1[o]);
    } else {
      a += p.part0[o];
      b += p.part1[o];
    }
  }
  if (MOMENTS) {
    p.out0[i] = a;
    p.out1[i] = 1.0f / sqrtf(b / hw + p.eps);
  } else {
    p.out0[i] = a / hw;
    p.out1[i] = b / hw;
  }
}

template <bool GB_STAGED>
__global__ void __launch_bounds__(THREADS)
spade_norm_apply_kernel(const Params p) {
  extern __shared__ float4 smem[];
  const int w0 = blockIdx.x << p.tile_log2;
  const int h = blockIdx.y, n = blockIdx.z;
  const int npix = min(1 << p.tile_log2, p.w - w0);
  if (GB_STAGED) {
    stage(smem, p.gb, n, h, w0, npix, 2 * p.cvn, p.tile_log2);
    __syncthreads();
  }
  const int cv = threadIdx.x & (p.cvn - 1);
  const float4 m = ld4(p.mean + n * p.c + 4 * cv);
  const float4 r = ld4(p.rstd + n * p.c + 4 * cv);
  const int total = npix << p.cv_log2;
  float4 xv[FWD_ITEMS], gv[FWD_ITEMS], bv[FWD_ITEMS];
#pragma unroll
  for (int j = 0; j < FWD_ITEMS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < total) {
      const int pix = i >> p.cv_log2;
      const int w = w0 + pix;
      xv[j] = ld4(p.x + pixel(p, n, h, w) * p.c + 4 * cv);
      gv[j] = read<GB_STAGED>(smem, p.gb, n, h, w, pix, cv, p.tile_log2);
      bv[j] = read<GB_STAGED>(smem, p.gb, n, h, w, pix, p.cvn + cv,
                              p.tile_log2);
    }
  }
#pragma unroll
  for (int j = 0; j < FWD_ITEMS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < total) {
      float4 o;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        at(o, e) = act_fwd(at(xv[j], e), at(m, e), at(r, e), at(gv[j], e),
                           at(bv[j], e), p.gain, p.clamp);
      st4(p.y + pixel(p, n, h, w0 + (i >> p.cv_log2)) * p.c + 4 * cv, o);
    }
  }
}

template <bool GB_STAGED>
__global__ void __launch_bounds__(THREADS)
spade_norm_bwd_reduce_kernel(const Params p) {
  extern __shared__ float4 smem[];
  __shared__ float4 s1_s[THREADS], s2_s[THREADS];
  const int n = blockIdx.y;
  const int h0 = blockIdx.x * p.rows, h1 = min(p.h, h0 + p.rows);
  const int cv = threadIdx.x & (p.cvn - 1);
  const float4 m = ld4(p.mean + n * p.c + 4 * cv);
  const float4 r = ld4(p.rstd + n * p.c + 4 * cv);
  float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f), a2 = a1;
  for (int h = h0; h < h1; ++h) {
    for (int w0 = 0; w0 < p.w; w0 += 1 << p.tile_log2) {
      const int npix = min(1 << p.tile_log2, p.w - w0);
      if (GB_STAGED) {
        __syncthreads();  // the last tile's reads are done
        stage(smem, p.gb, n, h, w0, npix, 2 * p.cvn, p.tile_log2);
        __syncthreads();
      }
      const int total = npix << p.cv_log2;
#pragma unroll
      for (int j = 0; j < BWD_ITEMS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i < total) {
          const int pix = i >> p.cv_log2;
          const int w = w0 + pix;
          const float4 xv = ld4(p.x + pixel(p, n, h, w) * p.c + 4 * cv);
          const float4 gv =
              read<GB_STAGED>(smem, p.gb, n, h, w, pix, cv, p.tile_log2);
          const float4 bv = read<GB_STAGED>(smem, p.gb, n, h, w, pix,
                                            p.cvn + cv, p.tile_log2);
          const float4 dv =
              read<false>(smem, p.dy, n, h, w, pix, cv, p.tile_log2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float xh, dz, dxh;
            act_bwd(at(dv, e), at(xv, e), at(m, e), at(r, e), at(gv, e),
                    at(bv, e), p.gain, p.clamp, xh, dz, dxh);
            at(a1, e) += dxh;
            at(a2, e) = fmaf(dxh, xh, at(a2, e));
          }
        }
      }
    }
  }
  s1_s[threadIdx.x] = a1;
  s2_s[threadIdx.x] = a2;
  __syncthreads();
  if (threadIdx.x < p.cvn) {
    float4 t1 = make_float4(0.f, 0.f, 0.f, 0.f), t2 = t1;
    for (int l = 0; l < (THREADS >> p.cv_log2); ++l) {
      const int i = (l << p.cv_log2) + threadIdx.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        at(t1, e) += at(s1_s[i], e);
        at(t2, e) += at(s2_s[i], e);
      }
    }
    const size_t o =
        (static_cast<size_t>(n) * p.blocks + blockIdx.x) * p.c + 4 * cv;
    st4(p.part0 + o, t1);
    st4(p.part1 + o, t2);
  }
}

template <bool GB_STAGED>
__global__ void __launch_bounds__(THREADS)
spade_norm_bwd_apply_kernel(const Params p) {
  extern __shared__ float4 smem[];
  const int w0 = blockIdx.x << p.tile_log2;
  const int h = blockIdx.y, n = blockIdx.z;
  const int npix = min(1 << p.tile_log2, p.w - w0);
  if (GB_STAGED) {
    stage(smem, p.gb, n, h, w0, npix, 2 * p.cvn, p.tile_log2);
    __syncthreads();
  }
  const int cv = threadIdx.x & (p.cvn - 1);
  const int nc = n * p.c + 4 * cv;
  const float4 m = ld4(p.mean + nc), r = ld4(p.rstd + nc);
  const float4 s1 = ld4(p.s1 + nc), s2 = ld4(p.s2 + nc);
  const int total = npix << p.cv_log2;
#pragma unroll
  for (int j = 0; j < BWD_ITEMS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < total) {
      const int pix = i >> p.cv_log2;
      const int w = w0 + pix;
      const size_t px = pixel(p, n, h, w);
      const float4 xv = ld4(p.x + px * p.c + 4 * cv);
      const float4 gv =
          read<GB_STAGED>(smem, p.gb, n, h, w, pix, cv, p.tile_log2);
      const float4 bv = read<GB_STAGED>(smem, p.gb, n, h, w, pix,
                                        p.cvn + cv, p.tile_log2);
      const float4 dv =
          read<false>(smem, p.dy, n, h, w, pix, cv, p.tile_log2);
      float4 dx, dg, db;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xh, dz, dxh;
        act_bwd(at(dv, e), at(xv, e), at(m, e), at(r, e), at(gv, e),
                at(bv, e), p.gain, p.clamp, xh, dz, dxh);
        at(dx, e) = at(r, e) * (dxh - at(s1, e) - xh * at(s2, e));
        at(dg, e) = dz * xh;
        at(db, e) = dz;
      }
      st4(p.y + px * p.c + 4 * cv, dx);
      st4(p.dgb + px * 2 * p.c + 4 * cv, dg);
      st4(p.dgb + px * 2 * p.c + p.c + 4 * cv, db);
    }
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Whether an operand of `dims` can be read as it lies; *staged is set for
// one read along W. A stride of a dimension of size 1 is never used.
bool readable(const Op& op, const int* dims, bool* staged) {
  const long long s[3] = {op.sn, op.sh, op.sw};
  if (op.sc == 1) {
    if (!aligned16(op.p)) return false;
    for (int k = 0; k < 3; ++k)
      if (dims[k] > 1 && (s[k] & 3) != 0) return false;
    *staged = false;
    return true;
  }
  if (op.sw == 1 || dims[2] == 1) {
    *staged = true;
    return true;
  }
  return false;
}

int setup(Params& p, int n, int h, int w, int c) {
  if (n < 1 || h < 1 || w < 1 || c < 4 || (c & 3) != 0 || n > 65535 ||
      h > 65535)
    return -1;
  p.n = n;
  p.h = h;
  p.w = w;
  p.c = c;
  p.cvn = c / 4;
  if (p.cvn > THREADS || (p.cvn & (p.cvn - 1)) != 0) return -1;
  p.cv_log2 = 0;
  while ((1 << p.cv_log2) < p.cvn) ++p.cv_log2;
  return 0;
}

// Shared memory of a tile of gb staged along W (gamma's and beta's vectors).
size_t tile_smem(const Params& p, bool gb_staged) {
  const size_t pitch = (1u << p.tile_log2) + 1;
  return gb_staged ? 2 * p.cvn * pitch * sizeof(float4) : 0;
}

template <bool GB_STAGED>
int launch_apply(Params p, cudaStream_t stream) {
  p.tile_log2 = 0;
  while ((p.cvn << (p.tile_log2 + 1)) <= FWD_ITEMS * THREADS) ++p.tile_log2;
  const int tiles = (p.w + (1 << p.tile_log2) - 1) >> p.tile_log2;
  spade_norm_apply_kernel<GB_STAGED>
      <<<dim3(tiles, p.h, p.n), THREADS, tile_smem(p, GB_STAGED),
         stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool GB_STAGED>
int launch_bwd(Params p, cudaStream_t stream) {
  p.tile_log2 = 0;
  while ((p.cvn << (p.tile_log2 + 1)) <= BWD_ITEMS * THREADS) ++p.tile_log2;
  const size_t smem = tile_smem(p, GB_STAGED);
  spade_norm_bwd_reduce_kernel<GB_STAGED>
      <<<dim3(p.blocks, p.n), THREADS, smem, stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int merges = (p.n * p.c + THREADS - 1) / THREADS;
  Params q = p;
  q.out0 = const_cast<float*>(p.s1);
  q.out1 = const_cast<float*>(p.s2);
  spade_norm_merge_kernel<false><<<merges, THREADS, 0, stream>>>(q);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int tiles = (p.w + (1 << p.tile_log2) - 1) >> p.tile_log2;
  spade_norm_bwd_apply_kernel<GB_STAGED>
      <<<dim3(tiles, p.h, p.n), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The moments of x [n, h, w, c] (contiguous NHWC fp32) over h, w: mean and
// rstd = 1 / sqrt(var + eps), [n, c] each. part0 / part1: scratch of
// n * blocks * c floats each, `blocks` = ceil(h / rows). Two launches.
// Returns 0 or a CUDA error code (-1: a shape outside the kernels' scope:
// c a multiple of 4 with c / 4 a power of two up to 256).
extern "C" int pasta_spade_norm_stats(const void* x, void* part0,
                                      void* part1, void* mean, void* rstd,
                                      int n, int h, int w, int c, int rows,
                                      float eps, void* stream) {
  Params p{};
  if (setup(p, n, h, w, c) != 0 || rows < 1 || !aligned16(x))
    return -1;
  p.x = static_cast<const float*>(x);
  p.part0 = static_cast<float*>(part0);
  p.part1 = static_cast<float*>(part1);
  p.out0 = static_cast<float*>(mean);
  p.out1 = static_cast<float*>(rstd);
  p.rows = rows;
  p.blocks = (h + rows - 1) / rows;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spade_norm_stats_kernel<<<dim3(p.blocks, n), THREADS, 0, s>>>(p);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  spade_norm_merge_kernel<true>
      <<<(n * c + THREADS - 1) / THREADS, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// y [n, h, w, c] (contiguous) = clamp(relu(((x - mean) * rstd)
// * (1 + gamma) + beta) * gain, -clamp, clamp), gamma / beta channels
// [0, c) / [c, 2c) of gb, read through its strides (elements): either the
// channel stride is 1 (16-byte aligned) or the W stride is. One launch.
extern "C" int pasta_spade_norm_apply(
    const void* x, const void* gb, long long gb_sn, long long gb_sh,
    long long gb_sw, long long gb_sc, const void* mean, const void* rstd,
    void* y, int n, int h, int w, int c, float gain, float clamp,
    void* stream) {
  Params p{};
  if (setup(p, n, h, w, c) != 0 || !aligned16(x) || !aligned16(y))
    return -1;
  p.x = static_cast<const float*>(x);
  p.gb = Op{static_cast<const float*>(gb), gb_sn, gb_sh, gb_sw, gb_sc};
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.y = static_cast<float*>(y);
  p.gain = gain;
  p.clamp = clamp;
  const int dims[3] = {n, h, w};
  bool gb_staged = false;
  if (!readable(p.gb, dims, &gb_staged)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gb_staged ? launch_apply<true>(p, s) : launch_apply<false>(p, s);
}

// The backward of pasta_spade_norm_apply with respect to x (through the
// moments too) and gb: dx [n, h, w, c] and dgb [n, h, w, 2c], contiguous.
// dy is read through its strides as channel vectors (channel stride 1,
// 16-byte aligned), gb as in the apply; part0 / part1
// scratch of n * blocks * c floats, s1 / s2 of n * c. Three launches.
extern "C" int pasta_spade_norm_backward(
    const void* dy, long long dy_sn, long long dy_sh, long long dy_sw,
    long long dy_sc, const void* x, const void* gb, long long gb_sn,
    long long gb_sh, long long gb_sw, long long gb_sc, const void* mean,
    const void* rstd, void* part0, void* part1, void* s1, void* s2,
    void* dx, void* dgb, int n, int h, int w, int c, int rows, float gain,
    float clamp, void* stream) {
  Params p{};
  if (setup(p, n, h, w, c) != 0 || rows < 1 || !aligned16(x) ||
      !aligned16(dx) || !aligned16(dgb) || !aligned16(s1) || !aligned16(s2))
    return -1;
  p.x = static_cast<const float*>(x);
  p.dy = Op{static_cast<const float*>(dy), dy_sn, dy_sh, dy_sw, dy_sc};
  p.gb = Op{static_cast<const float*>(gb), gb_sn, gb_sh, gb_sw, gb_sc};
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.part0 = static_cast<float*>(part0);
  p.part1 = static_cast<float*>(part1);
  p.s1 = static_cast<const float*>(s1);
  p.s2 = static_cast<const float*>(s2);
  p.y = static_cast<float*>(dx);
  p.dgb = static_cast<float*>(dgb);
  p.rows = rows;
  p.blocks = (h + rows - 1) / rows;
  p.gain = gain;
  p.clamp = clamp;
  const int dims[3] = {n, h, w};
  bool dy_staged = false, gb_staged = false;
  if (!readable(p.dy, dims, &dy_staged) || dy_staged ||
      !readable(p.gb, dims, &gb_staged))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gb_staged ? launch_bwd<true>(p, s) : launch_bwd<false>(p, s);
}
