// LayerNorm forward and backward for Hopper (sm_90a), built by
// ops/_kernels.py into the port's kernel library and bound with ctypes.
//
// Replaces: paddle_tpu/ops/layernorm.py::_fwd_kernel (launched by
// _fused_fwd), the TPU kernel that normalises a VMEM-resident block of rows
// in one pass with fp32 statistics and a fused affine, writing y in the
// input dtype plus the per-row mean and rstd in fp32; and
// paddle_tpu/ops/layernorm.py::_bwd_kernel (launched by _fused_bwd), which
// writes dx in one pass from the saved statistics and sums dw/db over the
// rows into an fp32 accumulator carried across its sequential grid.
//
// What bounds it on this card: bytes. Per row the forward reads N inputs
// and writes N outputs (plus 8 bytes of statistics), the backward reads x
// and dy and writes dx; the arithmetic is a few operations per element,
// far below the ~295 operations per byte where the H100's tensor cores
// (let alone its CUDA cores) would become the limit. So the least time is
// (2·R·N·sizeof(T) + |w| + |b| + 8·R) / 3.35 TB/s forward and
// (3·R·N·sizeof(T) + |w| + 8·R + |dw| + |db|) / 3.35 TB/s backward.
//
// Forward design: one CTA of 256 threads per row. Each thread loads its
// strided share of the row into registers once (at most 32 values, so
// N <= 8192), the CTA reduces the sum (mean) and then the sum of squared
// deviations (variance) in fp32 -- the same two-step formula as the JAX
// kernel -- and every thread writes its normalised, scaled and shifted
// values straight from registers. Device memory is touched exactly once
// per element each way; nothing is staged in shared memory except the 8
// warp partials of each reduction. Neighbouring threads touch neighbouring
// addresses, so loads and stores coalesce. (Vectorised 16-byte accesses
// and several rows per CTA for narrow N are left for a later tuning pass.)
//
// Backward design: Hopper's blocks run in no order, so the TPU kernel's
// sequential dw/db accumulator becomes two passes and no atomics. Pass 1:
// G CTAs of 256 threads (G ~ 2 per SM, fixed by R alone), each walking a
// contiguous run of rows; per row a thread holds its columns of x and dy
// in registers, the CTA reduces c1 = mean(a * xhat) and c2 = mean(a) with
// a = dy * w (the JAX kernel's formula), writes
// dx = (a - c2 - xhat * c1) * rstd, and each thread adds dy * xhat and dy
// into fp32 registers for its columns; at the end the CTA writes its dw
// and db partials, [G, N] fp32 each. Pass 2 sums the G partials of every
// column in a fixed order (8 strided groups, then the 8 group sums in
// order) and writes dw, db cast to w's dtype. The order depends on R and N
// only, so two runs are bit-equal. The partials add 16·G·N bytes of
// traffic (4 MB at the training shape, against 50 MB of x, dy and dx).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 32;  // 256 * 32 = 8192 = largest N accepted

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

// Sum over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += scratch[i];
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ b, T* __restrict__ y,
                         float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, int N, float eps) {
  __shared__ float scratch[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * N;
  T* yr = y + row * N;

  float v[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < N ? to_float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mu = block_sum(sum, scratch) / static_cast<float>(N);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < N) {
      const float d = v[i] - mu;
      sq += d * d;
    }
  }
  const float var = block_sum(sq, scratch) / static_cast<float>(N);
  const float rstd = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < N) {
      // unfused multiply and add, in the JAX kernel's order
      // (xhat * w + b), so no FMA contraction changes the rounding
      const float xhat = __fmul_rn(v[i] - mu, rstd);
      yr[c] = from_float<T>(__fadd_rn(__fmul_rn(xhat, to_float(w[c])),
                                      to_float(b[c])));
    }
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// Two sums over the CTA at once; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kThreads / 32 + warp] = b;
  }
  __syncthreads();
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    ta += scratch[i];
    tb += scratch[kThreads / 32 + i];
  }
  __syncthreads();  // scratch is reused by the next row
  a = ta;
  b = tb;
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, long long R, int N,
                         int rows_per_cta) {
  __shared__ float scratch[2 * kThreads / 32];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long r1 = min(r0 + rows_per_cta, R);
  const float inv_n = 1.f / static_cast<float>(N);

  float wv[kPer], dwa[kPer], dba[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    wv[i] = c < N ? to_float(w[c]) : 0.f;
    dwa[i] = dba[i] = 0.f;
  }
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * N;
    const T* dyr = dy + r * N;
    const float m = mu[r], rs = rstd[r];
    float xh[kPer], a[kPer];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < N) {
        const float g = to_float(dyr[c]);
        xh[i] = (to_float(xr[c]) - m) * rs;
        a[i] = g * wv[i];
        s1 += a[i] * xh[i];
        s2 += a[i];
        dwa[i] += g * xh[i];
        dba[i] += g;
      } else {
        xh[i] = a[i] = 0.f;
      }
    }
    block_sum2(s1, s2, scratch);
    const float c1 = s1 * inv_n, c2 = s2 * inv_n;
    T* dxr = dx + r * N;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < N)
        dxr[c] = from_float<T>((a[i] - c2 - __fmul_rn(xh[i], c1)) * rs);
    }
  }
  float* dwp = dw_part + static_cast<long long>(blockIdx.x) * N;
  float* dbp = db_part + static_cast<long long>(blockIdx.x) * N;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < N) {
      dwp[c] = dwa[i];
      dbp[c] = dba[i];
    }
  }
}

// 32 columns a CTA; 8 groups of 32 threads sum every 8th partial, then the
// 8 group sums are added in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                const float* __restrict__ db_part,
                                T* __restrict__ dw, T* __restrict__ db, int G,
                                int N) {
  __shared__ float sw[kThreads / 32][33];
  __shared__ float sb[kThreads / 32][33];
  const int cx = threadIdx.x & 31;
  const int gy = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cx;
  float aw = 0.f, ab = 0.f;
  if (c < N) {
    for (int gi = gy; gi < G; gi += kThreads / 32) {
      aw += dw_part[static_cast<long long>(gi) * N + c];
      ab += db_part[static_cast<long long>(gi) * N + c];
    }
  }
  sw[gy][cx] = aw;
  sb[gy][cx] = ab;
  __syncthreads();
  if (gy == 0 && c < N) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      tw += sw[i][cx];
      tb += sb[i][cx];
    }
    dw[c] = from_float<T>(tw);
    db[c] = from_float<T>(tb);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* mu,
               const void* rstd, const void* dy, void* dx, void* dw,
               void* db, void* part, long long R, int N, int rows_per_cta,
               cudaStream_t s) {
  const long long G = (R + rows_per_cta - 1) / rows_per_cta;
  float* dw_part = static_cast<float*>(part);
  float* db_part = dw_part + G * N;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* mut = static_cast<const float*>(mu);
  const float* rst = static_cast<const float*>(rstd);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const dim3 grid(static_cast<unsigned>(G));
  if (N <= 8 * kThreads) {
    layernorm_bwd_kernel<T, 8><<<grid, kThreads, 0, s>>>(
        xt, wt, mut, rst, dyt, dxt, dw_part, db_part, R, N, rows_per_cta);
  } else {
    layernorm_bwd_kernel<T, kMaxPerThread><<<grid, kThreads, 0, s>>>(
        xt, wt, mut, rst, dyt, dxt, dw_part, db_part, R, N, rows_per_cta);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  layernorm_bwd_reduce_kernel<T><<<(N + 31) / 32, kThreads, 0, s>>>(
      dw_part, db_part, static_cast<T*>(dw), static_cast<T*>(db),
      static_cast<int>(G), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int pdtt_layernorm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mu, void* rstd, long long R,
                                  int N, float eps, int dtype, void* stream) {
  if (R < 1 || R > 0x7fffffffLL || N < 1 || N > kThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(R));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    layernorm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), N, eps);
  } else if (dtype == 1) {
    layernorm_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), N, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx [R, N] and w, dw, db [N] of one dtype (0 = float32,
// 1 = bfloat16); mu, rstd [R] fp32; part: fp32 scratch of 2 * G * N with
// G = ceil(R / rows_per_cta). Returns cudaGetLastError() after the two
// launches (0 on success); the caller raises on anything else.
extern "C" int pdtt_layernorm_bwd(const void* x, const void* w,
                                  const void* mu, const void* rstd,
                                  const void* dy, void* dx, void* dw,
                                  void* db, void* part, long long R, int N,
                                  int rows_per_cta, int dtype, void* stream) {
  if (R < 1 || N < 1 || N > kThreads * kMaxPerThread || rows_per_cta < 1 ||
      (R + rows_per_cta - 1) / rows_per_cta > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, mu, rstd, dy, dx, dw, db, part, R, N,
                             rows_per_cta, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, mu, rstd, dy, dx, dw, db, part, R,
                                     N, rows_per_cta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
