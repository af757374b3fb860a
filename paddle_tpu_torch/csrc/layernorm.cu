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
// and dy and writes dx; the arithmetic is about 8 (forward) and 13
// (backward) operations an element, far below the ~295 operations per byte
// where the H100's tensor cores (let alone its CUDA cores) would become the
// limit. So the least time is
// (2·R·N·sizeof(T) + |w| + |b| + 8·R) / 3.35 TB/s forward and
// (3·R·N·sizeof(T) + |w| + 8·R + |dw| + |db|) / 3.35 TB/s backward. The
// design's job is to keep enough 16-byte requests in flight and to spend
// nothing per element that the row does not need.
//
// Layout of a row, both kernels: N values are P = ceil(N / kPack) packs of
// 16 bytes (kPack = 8 bf16 or fp16, 4 fp32). A row belongs to kTpr consecutive
// threads (a power of two); thread t owns packs t, t + kTpr, ... (kPer of
// them, the last ones masked past N), so neighbouring threads touch
// neighbouring 16 bytes. kTpr and kPer come from N and the dtype alone,
// through the tables below (the smallest entry whose kTpr·kPer covers P),
// so every sum over a row runs in one order for a given N and dtype: a
// row's result does not depend on R, on the other rows of its CTA, or on
// the grid. The engine's 512-row steps and generate()'s 64-row prefill
// rely on that (their LayerNorm outputs are bit-equal).
//
// Where N·sizeof(T) % 16 == 0 and every pointer is 16-byte aligned a pack
// is one 16-byte load or store (kWide); otherwise the same kernel moves it
// as kPack scalar accesses, each masked at N. Both widths visit the same
// elements in the same order, so they give the same bits.
//
// Forward: a CTA of max(kTpr, 128) threads holds 128 / kTpr rows (one row
// for kTpr >= 128) and walks the rows with a grid-stride loop, w and b
// packed in registers. A thread loads its packs of x once and keeps them
// packed, the row reduces the sum (mean) and then the sum of squared
// deviations (variance) in fp32 -- the JAX kernel's two-step formula --
// and writes its normalised, scaled and shifted values straight from
// registers. A reduction is a butterfly of warp shuffles; a row wider than
// a warp adds its warps' partials in warp order after one __syncthreads
// (two shared buffers, one per reduction, so the next reduction needs no
// second barrier).
//
// Backward: Hopper's blocks run in no order, so the TPU kernel's
// sequential dw/db accumulator becomes two passes and no atomics. Pass 1:
// G CTAs of kTpr threads, each walking a contiguous run of rows in batches
// of kK rows (the wrapper fixes the run from R alone: about two CTAs an SM,
// at most 64 rows a run). The loads of x and dy go through a
// ring of kStages batches in shared memory, filled by cp.async kStages - 1
// batches ahead of the batch being reduced (at N = 2048 bf16: 4 rows,
// 32 KB, in flight a CTA), so registers no longer bound the bytes in
// flight; a thread copies and reads back only its own packs, so waiting
// for its own copies is all the ordering it needs. Per batch the CTA
// reduces the 2·kK row sums c1 = mean(a * xhat) and c2 = mean(a),
// a = dy * w (the JAX kernel's formula), with one __syncthreads, writes
// dx = (a - c2 - xhat * c1) * rstd, and each thread adds dy * xhat and dy
// into fp32 registers for its columns, row after row in row order. At the
// end the CTA writes its dw and db partials, [G, N] fp32 each. Pass 2 sums
// the G partials of every column in a fixed order (32 strided groups,
// then the 32 group sums in order) and writes dw, db cast to w's dtype.
// The order depends on R and N only, so two runs are bit-equal. The
// partials add 16·G·N bytes of traffic (written once and read once: 8.4 MB
// at the training shape, R = 4096, N = 2048, G = 256, against 50.4 MB of
// x, dy and dx).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

// The instantiations, smallest first: X(threads a row, packs a thread) for
// the forward, X(threads a row, packs a thread, rows a batch, stages) for
// the backward. ops/layernorm.py mirrors these tables (its tests hold the
// two equal); tools/sweep_layernorm.py rebuilds this file with other
// entries to time them.
#define PDTT_LN_FWD_FP32(X) \
  X(8, 1) X(16, 1) X(32, 1) X(32, 2) X(32, 4) X(64, 4) X(128, 4) X(256, 4) \
  X(512, 4)
#define PDTT_LN_FWD_BF16(X) \
  X(8, 1) X(16, 1) X(32, 1) X(32, 2) X(32, 4) X(128, 2) X(128, 4) X(256, 4)
#define PDTT_LN_BWD_FP32(X)                                                 \
  X(32, 1, 4, 3) X(64, 1, 4, 3) X(128, 1, 4, 3) X(256, 1, 2, 3)           \
  X(256, 2, 2, 3) X(256, 4, 1, 3) X(256, 8, 1, 2)
#define PDTT_LN_BWD_BF16(X)                                                 \
  X(32, 1, 4, 3) X(64, 1, 4, 3) X(128, 1, 4, 3) X(256, 1, 2, 3)           \
  X(256, 2, 1, 4) X(256, 4, 1, 3)
// fp16 (pure-fp16 O2 training, fp16 serving) has bf16's pack of 8 values in
// 16 bytes and the same arithmetic (fp32 from the pack, one rounding to
// fp16 at the store), so it takes bf16's entries
#define PDTT_LN_FWD_FP16(X) PDTT_LN_FWD_BF16(X)
#define PDTT_LN_BWD_FP16(X) PDTT_LN_BWD_BF16(X)

namespace {

constexpr int kFwdThreads = 128;  // a forward CTA, unless a row takes more
constexpr int kMaxN = 8192;

template <typename T>
constexpr int kPack = 16 / static_cast<int>(sizeof(T));

__host__ __device__ constexpr int fwd_threads(int tpr) {
  return tpr > kFwdThreads ? tpr : kFwdThreads;
}

// ---- a pack: 16 bytes of T held as a uint4 of raw bits

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ void set_word(uint4& u, int i, unsigned v) {
  if (i == 0) u.x = v;
  else if (i == 1) u.y = v;
  else if (i == 2) u.z = v;
  else u.w = v;
}

template <typename T>
__device__ __forceinline__ unsigned get_bits(const uint4& u, int j) {
  if constexpr (std::is_same<T, float>::value) {
    return word(u, j);
  } else {
    return (word(u, j >> 1) >> (16 * (j & 1))) & 0xffffu;
  }
}

template <typename T>
__device__ __forceinline__ void put_bits(uint4& u, int j, unsigned bits) {
  if constexpr (std::is_same<T, float>::value) {
    set_word(u, j, bits);
  } else {
    const unsigned w = word(u, j >> 1);
    set_word(u, j >> 1, (j & 1) ? (w & 0xffffu) | (bits << 16)
                                : (w & 0xffff0000u) | bits);
  }
}

__device__ __forceinline__ unsigned raw_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned raw_bits(__half v) {
  return __half_as_ushort(v);
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned bits);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned bits) {
  return __uint_as_float(bits);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(
    unsigned bits) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits));
}
template <>
__device__ __forceinline__ __half from_bits<__half>(unsigned bits) {
  return __ushort_as_half(static_cast<unsigned short>(bits));
}

// value j of a pack in fp32 (a bf16 or an fp16 widens exactly)
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(get_bits<T>(u, j));
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(from_bits<__half>(get_bits<T>(u, j)));
  } else {
    return __uint_as_float(get_bits<T>(u, j) << 16);
  }
}

// v rounded to T (to nearest even, like astype)
template <typename T>
__device__ __forceinline__ T cast_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(v);
  } else {
    return __float2bfloat16(v);
  }
}

// v rounded to T into value j of a pack
template <typename T>
__device__ __forceinline__ void put(uint4& u, int j, float v) {
  put_bits<T>(u, j, raw_bits(cast_to<T>(v)));
}

// The pack at columns [c0, c0 + kPack) of a row of n values (n = 0: a row
// past the end), columns at or past n read as 0: one 16-byte load (kWide,
// where n is a whole number of packs) or kPack scalar loads.
template <typename T, bool kWide>
__device__ __forceinline__ uint4 load_pack(const T* __restrict__ p, int c0,
                                           int n) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kWide) {
    if (c0 < n) r = *reinterpret_cast<const uint4*>(p + c0);
  } else {
#pragma unroll
    for (int j = 0; j < kPack<T>; ++j)
      if (c0 + j < n) put_bits<T>(r, j, raw_bits(p[c0 + j]));
  }
  return r;
}

template <typename T, bool kWide>
__device__ __forceinline__ void store_pack(T* __restrict__ p, int c0, int n,
                                           const uint4& v) {
  if constexpr (kWide) {
    if (c0 < n) *reinterpret_cast<uint4*>(p + c0) = v;
  } else {
#pragma unroll
    for (int j = 0; j < kPack<T>; ++j)
      if (c0 + j < n) p[c0 + j] = from_bits<T>(get_bits<T>(v, j));
  }
}

// ---- sums over the kTpr consecutive threads that own a row

// Adds each of v[0..kM) over the row's threads; every one of them gets the
// same totals, in an order fixed by kTpr: a butterfly of shuffles within
// the warp (or the row's part of it; a + b == b + a, so every lane ends
// with the same bits), then, for rows wider than a warp, the warps'
// partials in warp order, read back after one __syncthreads from `slot`
// ([kM][kTpr / 32] floats of shared memory owned by this row).
template <int kTpr, int kM>
__device__ __forceinline__ void row_sums(float (&v)[kM], float* slot) {
  constexpr int kLanes = kTpr < 32 ? kTpr : 32;
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
      v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
  }
  if constexpr (kTpr > 32) {
    constexpr int kWarps = kTpr / 32;
    const int t = threadIdx.x & (kTpr - 1);
    if ((t & 31) == 0) {
#pragma unroll
      for (int m = 0; m < kM; ++m) slot[m * kWarps + (t >> 5)] = v[m];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float total = slot[m * kWarps];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) total += slot[m * kWarps + i];
      v[m] = total;
    }
  }
}

// ---- forward

template <typename T, bool kWide, int kTpr, int kPer>
__global__ void __launch_bounds__(fwd_threads(kTpr))
    layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ b, T* __restrict__ y,
                         float* __restrict__ mu_out,
                         float* __restrict__ rstd_out, long long R, int N,
                         float inv_n, float eps) {
  constexpr int kV = kPack<T>;
  constexpr int kRows = fwd_threads(kTpr) / kTpr;
  constexpr int kWarps = kTpr > 32 ? kTpr / 32 : 1;
  // one buffer for the mean's reduction, one for the variance's
  __shared__ float red[2][kRows][kWarps];
  const int sub = threadIdx.x / kTpr;
  const int t = threadIdx.x % kTpr;

  uint4 wp[kPer], bp[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    wp[i] = load_pack<T, kWide>(w, (i * kTpr + t) * kV, N);
    bp[i] = load_pack<T, kWide>(b, (i * kTpr + t) * kV, N);
  }
  const long long groups = (R + kRows - 1) / kRows;
  // x of this thread's row in group g, packed (nothing past the end)
  auto load_x = [&](long long g, uint4 (&out)[kPer]) {
    const long long row = g * kRows + sub;
    const int n = row < R ? N : 0;
    const T* xr = x + (row < R ? row : 0) * N;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      out[i] = load_pack<T, kWide>(xr, (i * kTpr + t) * kV, n);
  };
  uint4 xp[kPer];  // x stays packed: 16 bytes of registers a pack
  load_x(blockIdx.x, xp);
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row = g * kRows + sub;
    const bool live = row < R;
    const int n = live ? N : 0;  // a row past the end moves nothing
    T* yr = y + (live ? row : 0) * N;
    uint4 xn[kPer];  // the next row's loads fly while this one is reduced
    load_x(g + gridDim.x, xn);

    float s[1] = {0.f};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kV; ++j) s[0] += elem<T>(xp[i], j);
    }
    row_sums<kTpr, 1>(s, &red[0][sub][0]);
    const float mu = s[0] * inv_n;

    float sq[1] = {0.f};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if ((i * kTpr + t) * kV + j < n) {
          const float d = elem<T>(xp[i], j) - mu;
          sq[0] += d * d;
        }
      }
    }
    row_sums<kTpr, 1>(sq, &red[1][sub][0]);
    const float rstd = rsqrtf(sq[0] * inv_n + eps);

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        // unfused multiply and add, in the JAX kernel's order
        // (xhat * w + b), so no FMA contraction changes the rounding
        const float xhat = __fmul_rn(elem<T>(xp[i], j) - mu, rstd);
        put<T>(o, j, __fadd_rn(__fmul_rn(xhat, elem<T>(wp[i], j)),
                               elem<T>(bp[i], j)));
      }
      store_pack<T, kWide>(yr, (i * kTpr + t) * kV, n, o);
    }
    if (t == 0 && live) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) xp[i] = xn[i];
  }
}

// CTAs the card holds at once for `kern` (asked once per instantiation):
// the forward's grid-stride loop launches no more than that.
template <typename K>
int resident_ctas(K kern, int threads, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (!rc)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!rc)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, threads, 0));
  *out = sms * per_sm > 0 ? sms * per_sm : 1;
  return rc;
}

template <typename T, bool kWide, int kTpr, int kPer>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* mu, void* rstd, long long R, int N, float eps,
               cudaStream_t s) {
  constexpr int kThreads = fwd_threads(kTpr);
  constexpr int kRows = kThreads / kTpr;
  auto kern = layernorm_fwd_kernel<T, kWide, kTpr, kPer>;
  static int resident = 0;
  if (resident == 0) {
    int r = 0;
    const int rc = resident_ctas(kern, kThreads, &r);
    if (rc) return rc;
    resident = r;
  }
  const long long groups = (R + kRows - 1) / kRows;
  const unsigned grid =
      static_cast<unsigned>(groups < resident ? groups : resident);
  kern<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), R, N, 1.f / static_cast<float>(N), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWide>
int fwd_dispatch(const void* x, const void* w, const void* b, void* y,
                 void* mu, void* rstd, long long R, int N, float eps,
                 cudaStream_t s) {
  const int packs = (N + kPack<T> - 1) / kPack<T>;
#define PDTT_X(tpr, per)                                                \
  if (packs <= (tpr) * (per))                                           \
    return launch_fwd<T, kWide, tpr, per>(x, w, b, y, mu, rstd, R, N,   \
                                          eps, s);
  if constexpr (std::is_same<T, float>::value) {
    PDTT_LN_FWD_FP32(PDTT_X)
  } else if constexpr (std::is_same<T, __half>::value) {
    PDTT_LN_FWD_FP16(PDTT_X)
  } else {
    PDTT_LN_FWD_BF16(PDTT_X)
  }
#undef PDTT_X
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- backward, pass 1

// Copies the pack at columns [c0, c0 + kPack) of a row of n values into
// this thread's slot of a stage: an asynchronous 16-byte cp.async (kWide;
// columns past n are zero-filled), or kPack scalar loads stored at once.
template <typename T, bool kWide>
__device__ __forceinline__ void stage_pack(uint4* dst,
                                           const T* __restrict__ src, int c0,
                                           int n) {
  if constexpr (kWide) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(c0 < n ? src + c0 : src), "r"(c0 < n ? 16 : 0)
                 : "memory");
  } else {
    *dst = load_pack<T, false>(src, c0, n);
  }
}

template <typename T, bool kWide, int kTpr, int kPer, int kK, int kStages>
__global__ void __launch_bounds__(kTpr)
    layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, long long R, int N,
                         float inv_n, int rows_per_cta) {
  constexpr int kV = kPack<T>;
  constexpr int kWarps = kTpr > 32 ? kTpr / 32 : 1;
  constexpr int kStage = kK * 2 * kPer * kTpr;  // packs a stage
  // kStages stages of kK rows of x and dy: [stage][row][x|dy][pack][thread]
  extern __shared__ uint4 stages[];
  // one buffer for even batches, one for odd: a reduction needs one barrier
  __shared__ float red[2][2 * kK * kWarps];
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int rows = static_cast<int>(r0 + rows_per_cta < R ? rows_per_cta
                                                          : R - r0);
  const int batches = (rows + kK - 1) / kK;

  uint4 wp[kPer];
  float dwa[kPer][kV], dba[kPer][kV];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    wp[i] = load_pack<T, kWide>(w, (i * kTpr + t) * kV, N);
#pragma unroll
    for (int j = 0; j < kV; ++j) dwa[i][j] = dba[i][j] = 0.f;
  }

  // batch bi's x and dy into stage `slot` (rows past the run read as 0),
  // one commit group a batch. A thread reads back only the packs it copied
  // itself, so waiting for its own groups is all the ordering it needs.
  auto copy_batch = [&](int bi, int slot) {
    if (bi < batches) {
      uint4* st = stages + slot * kStage;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const int r = bi * kK + k;
        const bool live = r < rows;
        const int n = live ? N : 0;
        const long long off = (live ? r0 + r : 0) * N;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c0 = (i * kTpr + t) * kV;
          stage_pack<T, kWide>(st + ((2 * k) * kPer + i) * kTpr + t, x + off,
                               c0, n);
          stage_pack<T, kWide>(st + ((2 * k + 1) * kPer + i) * kTpr + t,
                               dy + off, c0, n);
        }
      }
    }
    if constexpr (kWide) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto stats = [&](int bi, float (&m)[kK], float (&rs)[kK]) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int r = bi * kK + k;
      m[k] = r < rows ? mu[r0 + r] : 0.f;
      rs[k] = r < rows ? rstd[r0 + r] : 0.f;
    }
  };

#pragma unroll
  for (int bi = 0; bi < kStages - 1; ++bi) copy_batch(bi, bi);
  float m[kK], rs[kK];
  stats(0, m, rs);
  int parity = 0;
  int rd = 0, wr = kStages - 1;  // the stages read and filled next
  for (int bi = 0; bi < batches; ++bi) {
    copy_batch(bi + kStages - 1, wr);  // the stage batch bi - 1 finished with
    wr = wr + 1 == kStages ? 0 : wr + 1;
    float mn[kK], rsn[kK];
    stats(bi + 1, mn, rsn);
    if constexpr (kWide)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const uint4* st = stages + rd * kStage;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    uint4 xb[kK][kPer], gb[kK][kPer];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        xb[k][i] = st[((2 * k) * kPer + i) * kTpr + t];
        gb[k][i] = st[((2 * k + 1) * kPer + i) * kTpr + t];
      }
    }
    // a masked value reads as 0 (and its row's statistics as 0), so it
    // adds 0 to every sum below
    float s[2 * kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float g = elem<T>(gb[k][i], j);
          const float xh = (elem<T>(xb[k][i], j) - m[k]) * rs[k];
          const float a = g * elem<T>(wp[i], j);
          s1 += a * xh;
          s2 += a;
          dwa[i][j] += g * xh;
          dba[i][j] += g;
        }
      }
      s[2 * k] = s1;
      s[2 * k + 1] = s2;
    }
    row_sums<kTpr, 2 * kK>(s, red[parity]);
    parity ^= 1;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int r = bi * kK + k;
      const bool live = r < rows;
      const int n = live ? N : 0;
      T* dxr = dx + (live ? r0 + r : 0) * N;
      const float c1 = s[2 * k] * inv_n, c2 = s[2 * k + 1] * inv_n;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float g = elem<T>(gb[k][i], j);
          const float xh = (elem<T>(xb[k][i], j) - m[k]) * rs[k];
          const float a = g * elem<T>(wp[i], j);
          put<T>(o, j, (a - c2 - __fmul_rn(xh, c1)) * rs[k]);
        }
        store_pack<T, kWide>(dxr, (i * kTpr + t) * kV, n, o);
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      m[k] = mn[k];
      rs[k] = rsn[k];
    }
  }
  if constexpr (kWide) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float* dwp = dw_part + static_cast<long long>(blockIdx.x) * N;
  float* dbp = db_part + static_cast<long long>(blockIdx.x) * N;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c0 = (i * kTpr + t) * kV;
    if constexpr (kWide) {
      if (c0 < N) {
#pragma unroll
        for (int q = 0; q < kV / 4; ++q) {
          reinterpret_cast<float4*>(dwp + c0)[q] =
              make_float4(dwa[i][4 * q], dwa[i][4 * q + 1],
                          dwa[i][4 * q + 2], dwa[i][4 * q + 3]);
          reinterpret_cast<float4*>(dbp + c0)[q] =
              make_float4(dba[i][4 * q], dba[i][4 * q + 1],
                          dba[i][4 * q + 2], dba[i][4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (c0 + j < N) {
          dwp[c0 + j] = dwa[i][j];
          dbp[c0 + j] = dba[i][j];
        }
      }
    }
  }
}

// ---- backward, pass 2: kRedCols columns a CTA; kRedGroups groups of
// threads sum every kRedGroups-th partial, then the group sums are added in
// group order.
constexpr int kRedCols = 8;
constexpr int kRedGroups = 32;

template <typename T>
__global__ void __launch_bounds__(kRedCols * kRedGroups)
    layernorm_bwd_reduce_kernel(const float* __restrict__ dw_part,
                                const float* __restrict__ db_part,
                                T* __restrict__ dw, T* __restrict__ db, int G,
                                int N) {
  __shared__ float sw[kRedGroups][kRedCols + 1];
  __shared__ float sb[kRedGroups][kRedCols + 1];
  const int cx = threadIdx.x % kRedCols;
  const int gy = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + cx;
  float aw = 0.f, ab = 0.f;
  if (c < N) {
#pragma unroll 4
    for (int gi = gy; gi < G; gi += kRedGroups) {
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
    for (int i = 0; i < kRedGroups; ++i) {
      tw += sw[i][cx];
      tb += sb[i][cx];
    }
    dw[c] = cast_to<T>(tw);
    db[c] = cast_to<T>(tb);
  }
}

template <typename T, bool kWide, int kTpr, int kPer, int kK, int kStages>
int launch_bwd(const void* x, const void* w, const void* mu,
               const void* rstd, const void* dy, void* dx, void* dw,
               void* db, void* part, long long R, int N, int rows_per_cta,
               cudaStream_t s) {
  constexpr int kSmem = kStages * kK * 2 * kPer * kTpr * 16;
  auto kern = layernorm_bwd_kernel<T, kWide, kTpr, kPer, kK, kStages>;
  static bool ready = false;  // the stages' shared memory granted once
  if (!ready) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
    if (rc) return rc;
    ready = true;
  }
  const long long G = (R + rows_per_cta - 1) / rows_per_cta;
  float* dw_part = static_cast<float*>(part);
  float* db_part = dw_part + G * N;
  kern<<<static_cast<unsigned>(G), kTpr, kSmem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(mu), static_cast<const float*>(rstd),
          static_cast<const T*>(dy), static_cast<T*>(dx), dw_part, db_part,
          R, N, 1.f / static_cast<float>(N), rows_per_cta);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  layernorm_bwd_reduce_kernel<T>
      <<<(N + kRedCols - 1) / kRedCols, kRedCols * kRedGroups, 0, s>>>(
          dw_part, db_part, static_cast<T*>(dw), static_cast<T*>(db),
          static_cast<int>(G), N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWide>
int bwd_dispatch(const void* x, const void* w, const void* mu,
                 const void* rstd, const void* dy, void* dx, void* dw,
                 void* db, void* part, long long R, int N, int rows_per_cta,
                 cudaStream_t s) {
  const int packs = (N + kPack<T> - 1) / kPack<T>;
#define PDTT_X(tpr, per, rows, stages)                                    \
  if (packs <= (tpr) * (per))                                             \
    return launch_bwd<T, kWide, tpr, per, rows, stages>(                  \
        x, w, mu, rstd, dy, dx, dw, db, part, R, N, rows_per_cta, s);
  if constexpr (std::is_same<T, float>::value) {
    PDTT_LN_BWD_FP32(PDTT_X)
  } else if constexpr (std::is_same<T, __half>::value) {
    PDTT_LN_BWD_FP16(PDTT_X)
  } else {
    PDTT_LN_BWD_BF16(PDTT_X)
  }
#undef PDTT_X
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

int pack_of(int dtype) { return dtype == 0 ? 4 : 8; }

template <typename T>
int fwd_width(bool wide, const void* x, const void* w, const void* b, void* y,
              void* mu, void* rstd, long long R, int N, float eps,
              cudaStream_t s) {
  return wide ? fwd_dispatch<T, true>(x, w, b, y, mu, rstd, R, N, eps, s)
              : fwd_dispatch<T, false>(x, w, b, y, mu, rstd, R, N, eps, s);
}

template <typename T>
int bwd_width(bool wide, const void* x, const void* w, const void* mu,
              const void* rstd, const void* dy, void* dx, void* dw, void* db,
              void* part, long long R, int N, int rows_per_cta,
              cudaStream_t s) {
  return wide ? bwd_dispatch<T, true>(x, w, mu, rstd, dy, dx, dw, db, part, R,
                                      N, rows_per_cta, s)
              : bwd_dispatch<T, false>(x, w, mu, rstd, dy, dx, dw, db, part,
                                       R, N, rows_per_cta, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int pdtt_layernorm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mu, void* rstd, long long R,
                                  int N, float eps, int dtype, void* stream) {
  if (R < 1 || N < 1 || N > kMaxN || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N % pack_of(dtype) == 0 && aligned16(x) &&
                    aligned16(w) && aligned16(b) && aligned16(y);
  if (dtype == 0)
    return fwd_width<float>(wide, x, w, b, y, mu, rstd, R, N, eps, s);
  if (dtype == 1)
    return fwd_width<__nv_bfloat16>(wide, x, w, b, y, mu, rstd, R, N, eps, s);
  return fwd_width<__half>(wide, x, w, b, y, mu, rstd, R, N, eps, s);
}

// x, dy, dx [R, N] and w, dw, db [N] of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16); mu, rstd [R] fp32; part: fp32 scratch of
// 2 * G * N with G = ceil(R / rows_per_cta). Returns cudaGetLastError() after the two
// launches (0 on success); the caller raises on anything else.
extern "C" int pdtt_layernorm_bwd(const void* x, const void* w,
                                  const void* mu, const void* rstd,
                                  const void* dy, void* dx, void* dw,
                                  void* db, void* part, long long R, int N,
                                  int rows_per_cta, int dtype, void* stream) {
  if (R < 1 || N < 1 || N > kMaxN || rows_per_cta < 1 ||
      (R + rows_per_cta - 1) / rows_per_cta > 0x7fffffffLL || dtype < 0 ||
      dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N % pack_of(dtype) == 0 && aligned16(x) &&
                    aligned16(w) && aligned16(dy) && aligned16(dx) &&
                    aligned16(part);
  if (dtype == 0)
    return bwd_width<float>(wide, x, w, mu, rstd, dy, dx, dw, db, part, R, N,
                            rows_per_cta, s);
  if (dtype == 1)
    return bwd_width<__nv_bfloat16>(wide, x, w, mu, rstd, dy, dx, dw, db,
                                    part, R, N, rows_per_cta, s);
  return bwd_width<__half>(wide, x, w, mu, rstd, dy, dx, dw, db, part, R, N,
                           rows_per_cta, s);
}
