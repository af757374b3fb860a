// Flash attention forward, dq and dk/dv for Hopper (sm_90a), built by
// ops/_kernels.py into the port's kernel library and bound with ctypes.
//
// Replaces: paddle_tpu/ops/attention.py::_fwd_kernel, ::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_fwd / _flash_bwd), the TPU kernels
// behind every no-cache attention of GPT training: a (batch*heads, q_blocks,
// k_blocks) grid with the online-softmax state in VMEM scratch across the
// sequential k steps, and a backward split into a dq pass (k innermost) and
// a dk/dv pass (q innermost) that needs no atomics.
//
// Contract (attention.py:174-354), kept exactly:
//   q [BH, Sq, D], k and v [BH, Sk, D] in one dtype (fp32, bf16 or fp16),
//   D a multiple of 16 up to 128; out [BH, Sq, D] in that dtype, lse
//   [BH, Sq] fp32 (the TPU's [bh, 1, Sq] lane layout is dropped).
//   s = (q . k) in fp32, then * scale, rounded before anything else uses it;
//   causal keeps col <= row + (Sk - Sq) (bottom-right alignment) and masks
//   the rest to -1e30; p = 0 exactly where s <= -5e29; k tiles wholly in
//   the future are skipped; l is floored at 1e-30, so a row with no
//   visible key outputs 0 and lse = m + log(l) = -1e30.
//   Forward: p (against the running max) is rounded to v's dtype before PV.
//   dq:  p = exp(s - lse), ds = p * (dp - delta) * scale with dp = g . v,
//        ds rounded to k's dtype before ds @ k.
//   dkv: p rounded to g's dtype for dv = p^T @ g, ds rounded to q's dtype
//        for dk = ds^T @ q.
//   delta = rowsum(g * out) in fp32 is computed outside, as JAX does.
// Variants (has_mask and dropout_p > 0 in the TPU kernels; compile-time
// flags here, so the plain instantiation is unchanged):
//   mask: s += mask[bh / row_div][row][col] in fp32 after the causal
//        -1e30, then the p = 0 test (a -inf or finfo.min mask gives an
//        exact 0; a row masked whole outputs 0 and zero gradients).
//   dropout: keep bits from philox.cuh (per element, so every kernel and
//        tiling draws the same bit); the forward's l sums the undropped
//        p and PV takes keep ? p / (1 - p_drop) : 0; dq and dk/dv drop dp
//        alike, dk/dv drops p for dV, and ds takes the undropped p.
//   Each costs one fp32 load (mask) or one Philox4x32-10 (dropout) per
//   score element on top of the plain kernel.
// The TPU rules that only served its tiling are dropped: no S >= 512
// threshold and no block divisibility; ragged tiles are masked here (key
// columns >= Sk score -1e30, query rows >= Sq are never stored and, in
// dk/dv, contribute nothing).
//
// What bounds it on this card: operations. At the training shape
// (B=4, H=16, S=1024, D=128, causal, bf16) the forward does ~17.2 GFLOP on
// ~67 MB, dq ~25.8 GFLOP and dk/dv ~34.4 GFLOP on under 101 MB: ~250
// operations a byte or more, near the H100's bf16 ridge point, so the
// least time is set by the tensor cores' 989 TFLOP/s.
//
// Routes: bf16 (dtype 1) and fp16 (dtype 2) forward, dq and dk/dv, with
// their mask and dropout variants, run on the tensor cores, in
// flash_attention_tc.cu (wgmma fed by TMA through mbarrier rings, P, dS
// and dS^T kept in registers; see its note). The fp32 path of all three
// kernels is the scalar design below, kept true fp32: no TF32, since the
// model phase holds fp32 train steps to a CPU twin within 1e-4.
//
// Scalar design (a simple, correct first kernel; no tensor cores, TMA or
// pipelining, so it runs on the CUDA cores at fp32 rate, far from that
// bound): one CTA of 256 threads per (64-row tile, batch*head). Tiles of q,
// k, v (and g) are staged in shared memory, 64 rows x D, padded to 129
// floats a row so the strided reads hit distinct banks. Each thread owns
// a 4 x 4 block of the 64 x 64 score tile
// (rows ty + 16i, columns tx + 16j) and, for the same rows, 4 x D/16
// output columns, so the online-softmax rescale needs no exchange: the
// row max and row sum are reduced across the 16 lanes that share a row
// with warp shuffles. Each score-tile read from shared memory feeds four
// fused multiply-adds. The forward's and dq's loops stop at the last k
// tile a causal q tile can see; dk/dv's loop starts at the first q tile
// that can see its k tile; the forward schedules its longest (last) q
// tiles first. Every sum runs in a fixed order inside one CTA, so two runs
// are bit-equal.
#include <cuda_runtime.h>

#include "flash_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;                 // query rows per tile
constexpr int kBK = 64;                 // key rows per tile
constexpr int kDMax = 128;              // largest head_dim accepted
constexpr int kStride = kDMax + 1;      // floats per row of a D-wide tile
constexpr int kPStride = kBK + 1;       // floats per row of a score tile
constexpr int kR = 4;                   // score rows per thread (64 / 16)
constexpr int kC = 4;                   // score columns per thread
constexpr int kDC = kDMax / 16;         // output columns per thread (max)

__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
// x.astype(T) seen again as fp32: the roundings of p and ds before a dot
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Reduce over the 16 lanes that share a score row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of a [n_rows, D] matrix into a 64 x kStride fp32
// tile; rows past n_rows are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int D) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int gr = row0 + r;
    dst[r * kStride + d] =
        gr < n_rows ? to_float(src[static_cast<long long>(gr) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk,
                                        int offset, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row + offset);
}

// number of k tiles the q tile starting at q0 can see
__device__ __forceinline__ int k_tiles_for(int q0, int Sq, int Sk, int offset,
                                           int causal) {
  int n = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_col = min(q0 + kBQ, Sq) - 1 + offset;
    n = last_col < 0 ? 0 : min(n, last_col / kBK + 1);
  }
  return n;
}

// The first element of batch*head bh's mask row (nullptr without a mask).
template <bool kMask>
__device__ __forceinline__ const float* mask_rows(const AttnMask& mask,
                                                  long long bh, int Sq,
                                                  int Sk) {
  if constexpr (!kMask) return nullptr;
  return mask.ptr + (bh / mask.row_div) * Sq * static_cast<long long>(Sk);
}

// s + mask[row][col] in fp32 (after the causal -1e30, as
// _apply_mask_block adds it); elements past Sq or Sk keep s.
template <bool kMask>
__device__ __forceinline__ float add_mask(float s, const float* mb, int row,
                                          int col, int Sq, int Sk) {
  if constexpr (!kMask) return s;
  return row < Sq && col < Sk
             ? s + mb[static_cast<long long>(row) * Sk + col]
             : s;
}

// keep ? x / (1 - p) : 0 (by the fp32 reciprocal) for element (row, col)
template <bool kDrop>
__device__ __forceinline__ float dropped(float x, const DropoutParams& d,
                                         long long bh, int row, int col) {
  if constexpr (!kDrop) return x;
  return dropout_keep(d, static_cast<uint32_t>(bh),
                      static_cast<uint32_t>(row), static_cast<uint32_t>(col))
             ? __fmul_rn(x, d.rescale)
             : 0.f;
}

// ---------------------------------------------------------------- forward
template <typename T, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int D,
                     float scale, int causal, AttnMask mask,
                     DropoutParams drop) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * kStride;
  float* v_s = k_s + kBK * kStride;
  float* p_s = v_s + kBK * kStride;

  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // longest first
  const long long bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* mb = mask_rows<kMask>(mask, bh, Sq, Sk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Sk - Sq;
  const int nd = D >> 4;

  load_tile(q_s, qb, q0, Sq, D);
  float m[kR], l[kR], acc[kR][kDC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = k_tiles_for(q0, Sq, Sk, offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads are done (q_s ready at first)
    load_tile(k_s, kb, k0, Sk, D);
    load_tile(v_s, vb, k0, Sk, D);
    __syncthreads();

    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kR], b[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = q_s[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < kC; ++j) b[j] = k_s[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = __fmul_rn(s[i][j], scale);
        s[i][j] = add_mask<kMask>(
            visible(row, col, Sq, Sk, offset, causal) ? x : kNegInf, mb, row,
            col, Sq, Sk);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p =
            s[i][j] <= kNegInf / 2 ? 0.f : expf(s[i][j] - m_new);
        ps += p;  // l sums the undropped p; the numerator the dropped one
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(
            dropped<kDrop>(p, drop, bh, row, k0 + tx + 16 * j));
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p_s complete

    for (int c = 0; c < kBK; ++c) {
      float a[kR], b[kDC];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = p_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) b[j] = v_s[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      const float lf = fmaxf(l[i], 1e-30f);
      T* orow = out + (bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        if (j < nd) orow[tx + 16 * j] = from_float<T>(acc[i][j] / lf);
      if (tx == 0) lse[bh * Sq + row] = m[i] + logf(lf);
    }
  }
}

// --------------------------------------------------------------------- dq
template <typename T, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int D, float scale, int causal,
                        AttnMask mask, DropoutParams drop) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* g_s = q_s + kBQ * kStride;
  float* k_s = g_s + kBQ * kStride;
  float* v_s = k_s + kBK * kStride;
  float* ds_s = v_s + kBK * kStride;

  const int n_qt = gridDim.x;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const long long bh = blockIdx.y;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* mb = mask_rows<kMask>(mask, bh, Sq, Sk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Sk - Sq;
  const int nd = D >> 4;

  load_tile(q_s, q + bh * Sq * D, q0, Sq, D);
  load_tile(g_s, g + bh * Sq * D, q0, Sq, D);
  float lse_r[kR], delta_r[kR], acc[kR][kDC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = k_tiles_for(q0, Sq, Sk, offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile(k_s, kb, k0, Sk, D);
    load_tile(v_s, vb, k0, Sk, D);
    __syncthreads();

    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float aq[kR], ag[kR], bk[kC], bv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        aq[i] = q_s[(ty + 16 * i) * kStride + d];
        ag[i] = g_s[(ty + 16 * i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        bk[j] = k_s[(tx + 16 * j) * kStride + d];
        bv[j] = v_s[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ag[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = add_mask<kMask>(
            visible(row, col, Sq, Sk, offset, causal)
                ? __fmul_rn(s[i][j], scale)
                : kNegInf,
            mb, row, col, Sq, Sk);
        const float p = x <= kNegInf / 2 ? 0.f : expf(x - lse_r[i]);
        const float dpd = dropped<kDrop>(dp[i][j], drop, bh, row, col);
        const float ds = __fmul_rn(__fmul_rn(p, dpd - delta_r[i]), scale);
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();  // ds_s complete

    for (int c = 0; c < kBK; ++c) {
      float a[kR], b[kDC];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = ds_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) b[j] = k_s[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      T* drow = dq + (bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        if (j < nd) drow[tx + 16 * j] = from_float<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ dk/dv
template <typename T, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int D,
                         float scale, int causal, AttnMask mask,
                         DropoutParams drop) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBK * kStride;
  float* q_s = v_s + kBK * kStride;
  float* g_s = q_s + kBQ * kStride;
  float* pt_s = g_s + kBQ * kStride;   // [key row][query row]
  float* dst_s = pt_s + kBK * kPStride;
  float* lse_s = dst_s + kBK * kPStride;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;  // the first k tiles see the most q tiles
  const long long bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* gb = g + bh * Sq * D;
  const float* mb = mask_rows<kMask>(mask, bh, Sq, Sk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Sk - Sq;
  const int nd = D >> 4;

  load_tile(k_s, k + bh * Sk * D, k0, Sk, D);
  load_tile(v_s, v + bh * Sk * D, k0, Sk, D);
  float dk_acc[kR][kDC], dv_acc[kR][kDC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  // causal: the first query row that sees key k0 is k0 - offset
  const int qt_first = causal ? max(0, k0 - offset) / kBQ : 0;
  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile(q_s, qb, q0, Sq, D);
    load_tile(g_s, gb, q0, Sq, D);
    if (tid < kBQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < Sq ? lse[bh * Sq + row] : 0.f;
      delta_s[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // transposed tiles: st[i][j] = s(query q0 + tx + 16j, key k0 + ty + 16i)
    float st[kR][kC], dpt[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float ak[kR], av[kR], bq[kC], bg[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        ak[i] = k_s[(ty + 16 * i) * kStride + d];
        av[i] = v_s[(ty + 16 * i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        bq[j] = q_s[(tx + 16 * j) * kStride + d];
        bg[j] = g_s[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          st[i][j] = fmaf(ak[i], bq[j], st[i][j]);
          dpt[i][j] = fmaf(av[i], bg[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = tx + 16 * j;
        const float x = add_mask<kMask>(
            visible(q0 + r, col, Sq, Sk, offset, causal)
                ? __fmul_rn(st[i][j], scale)
                : kNegInf,
            mb, q0 + r, col, Sq, Sk);
        const float p = x <= kNegInf / 2 ? 0.f : expf(x - lse_s[r]);
        // the same keep bit drops p for dV and dp for dS; dS takes the
        // undropped p
        const bool keep = !kDrop || dropout_keep(drop, bh, q0 + r, col);
        const float dpd =
            kDrop ? (keep ? __fmul_rn(dpt[i][j], drop.rescale) : 0.f)
                  : dpt[i][j];
        const float ds = __fmul_rn(__fmul_rn(p, dpd - delta_s[r]), scale);
        const float pv =
            kDrop ? (keep ? __fmul_rn(p, drop.rescale) : 0.f) : p;
        pt_s[(ty + 16 * i) * kPStride + r] = round_to<T>(pv);
        dst_s[(ty + 16 * i) * kPStride + r] = round_to<T>(ds);
      }
    }
    __syncthreads();  // pt_s, dst_s complete

    for (int r = 0; r < kBQ; ++r) {
      float ap[kR], ads[kR], bg[kDC], bq[kDC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        ap[i] = pt_s[(ty + 16 * i) * kPStride + r];
        ads[i] = dst_s[(ty + 16 * i) * kPStride + r];
      }
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        bg[j] = g_s[r * kStride + tx + 16 * j];
        bq[j] = q_s[r * kStride + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          dv_acc[i][j] = fmaf(ap[i], bg[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ads[i], bq[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < Sk) {
      T* dkr = dk + (bh * Sk + row) * D;
      T* dvr = dv + (bh * Sk + row) * D;
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        if (j < nd) {
          dkr[tx + 16 * j] = from_float<T>(dk_acc[i][j]);
          dvr[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
        }
    }
  }
}

constexpr size_t kTileBytes = sizeof(float) * 64 * kStride;
constexpr size_t kScoreBytes = sizeof(float) * 64 * kPStride;
constexpr size_t kFwdSmem = 3 * kTileBytes + kScoreBytes;
constexpr size_t kDqSmem = 4 * kTileBytes + kScoreBytes;
constexpr size_t kDkvSmem =
    4 * kTileBytes + 2 * kScoreBytes + 2 * sizeof(float) * kBQ;

// Shared memory above 48 KB must be opted into, once per kernel.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool shapes_ok(int BH, int Sq, int Sk, int D) {
  return BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 && D >= 16 &&
         D <= kDMax && D % 16 == 0;
}

template <typename T, bool kMask, bool kDrop>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int BH, int Sq, int Sk, int D, float scale, int causal,
        AttnMask mask, DropoutParams drop, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, kMask, kDrop>;
  int rc = allow_smem(kernel, kFwdSmem);
  if (rc) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, D, scale, causal, mask, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMask, bool kDrop>
int bwd_dq(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int BH, int Sq,
           int Sk, int D, float scale, int causal, AttnMask mask,
           DropoutParams drop, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<T, kMask, kDrop>;
  int rc = allow_smem(kernel, kDqSmem);
  if (rc) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, D, scale, causal, mask, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMask, bool kDrop>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int BH,
            int Sq, int Sk, int D, float scale, int causal, AttnMask mask,
            DropoutParams drop, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_kernel<T, kMask, kDrop>;
  int rc = allow_smem(kernel, kDkvSmem);
  if (rc) return rc;
  const dim3 grid((Sk + kBK - 1) / kBK, BH);
  kernel<<<grid, kThreads, kDkvSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D, scale, causal,
      mask, drop);
  return static_cast<int>(cudaGetLastError());
}

// The keep-mask as the kernels draw it, one element a thread (tests hold
// it against ops/attention.py::dropout_keep_mask bit for bit).
__global__ void dropout_keep_mask_kernel(bool* __restrict__ keep, int Sq,
                                         int Sk, long long n,
                                         DropoutParams drop) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / Sk;
    keep[e] = dropout_keep(drop, static_cast<uint32_t>(row / Sq),
                           static_cast<uint32_t>(row % Sq),
                           static_cast<uint32_t>(e % Sk));
  }
}

// The variant's arguments from the C entry point's: the mask (nullptr:
// none), its row divisor, the seed and dropout_p. 0, or an error: a mask
// and dropout together, a bad divisor or p outside [0, 1).
int variant(const void* mask_ptr, int mask_div, unsigned long long seed,
            double dropout_p, AttnMask* mask, DropoutParams* drop) {
  if (!(dropout_p >= 0.0 && dropout_p < 1.0) ||
      (mask_ptr && (mask_div < 1 || dropout_p > 0.0)))
    return static_cast<int>(cudaErrorInvalidValue);
  *mask = AttnMask{static_cast<const float*>(mask_ptr), mask_div};
  *drop = make_dropout_params(seed, dropout_p);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. mask_rows: fp32
// [rows, Sq, Sk] or null; batch*head bh reads row bh / mask_div.
// dropout_p > 0: in-kernel dropout keyed by seed (philox.cuh). A mask and dropout are not taken
// together. Each returns cudaGetLastError() after its launch (0 on
// success); the caller raises on anything else.
extern "C" int pdtt_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Sq, int Sk,
                              int D, float scale, int causal,
                              const void* mask_rows, int mask_div,
                              unsigned long long seed, double dropout_p,
                              int dtype, void* stream) {
  AttnMask mask;
  DropoutParams drop;
  if (!shapes_ok(BH, Sq, Sk, D) ||
      variant(mask_rows, mask_div, seed, dropout_p, &mask, &drop))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dropout = dropout_p > 0.0;
  if (dtype == 0)
    PDTT_VARIANT_RETURN(fwd, float, q, k, v, out, lse, BH, Sq, Sk, D, scale,
                        causal, mask, drop, s);
  if (dtype == 1)
    return flash_fwd_bf16_tc(q, k, v, out, lse, BH, Sq, Sk, D, scale, causal,
                             mask, drop, dropout, s);
  if (dtype == 2)
    return flash_fwd_fp16_tc(q, k, v, out, lse, BH, Sq, Sk, D, scale, causal,
                             mask, drop, dropout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pdtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, int BH, int Sq,
                                 int Sk, int D, float scale, int causal,
                                 const void* mask_rows, int mask_div,
                                 unsigned long long seed, double dropout_p,
                                 int dtype, void* stream) {
  AttnMask mask;
  DropoutParams drop;
  if (!shapes_ok(BH, Sq, Sk, D) ||
      variant(mask_rows, mask_div, seed, dropout_p, &mask, &drop))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dropout = dropout_p > 0.0;
  if (dtype == 0)
    PDTT_VARIANT_RETURN(bwd_dq, float, q, k, v, g, lse, delta, dq, BH, Sq,
                        Sk, D, scale, causal, mask, drop, s);
  if (dtype == 1)
    return flash_bwd_dq_bf16_tc(q, k, v, g, lse, delta, dq, BH, Sq, Sk, D,
                                scale, causal, mask, drop, dropout, s);
  if (dtype == 2)
    return flash_bwd_dq_fp16_tc(q, k, v, g, lse, delta, dq, BH, Sq, Sk, D,
                                scale, causal, mask, drop, dropout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pdtt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int BH, int Sq, int Sk,
                                  int D, float scale, int causal,
                                  const void* mask_rows, int mask_div,
                                  unsigned long long seed, double dropout_p,
                                  int dtype, void* stream) {
  AttnMask mask;
  DropoutParams drop;
  if (!shapes_ok(BH, Sq, Sk, D) ||
      variant(mask_rows, mask_div, seed, dropout_p, &mask, &drop))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dropout = dropout_p > 0.0;
  if (dtype == 0)
    PDTT_VARIANT_RETURN(bwd_dkv, float, q, k, v, g, lse, delta, dk, dv, BH,
                        Sq, Sk, D, scale, causal, mask, drop, s);
  if (dtype == 1)
    return flash_bwd_dkv_bf16_tc(q, k, v, g, lse, delta, dk, dv, BH, Sq, Sk,
                                 D, scale, causal, mask, drop, dropout, s);
  if (dtype == 2)
    return flash_bwd_dkv_fp16_tc(q, k, v, g, lse, delta, dk, dv, BH, Sq, Sk,
                                 D, scale, causal, mask, drop, dropout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// keep: bool [BH, Sq, Sk], written with the kernels' keep-mask for seed
// and p.
extern "C" int pdtt_dropout_keep_mask(void* keep, int BH, int Sq, int Sk,
                                      unsigned long long seed, double p,
                                      void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || !(p >= 0.0 && p < 1.0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(BH) * Sq * Sk;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 65536 ? n / 256 + 1 : 65536);
  dropout_keep_mask_kernel<<<blocks, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<bool*>(keep), Sq, Sk, n, make_dropout_params(seed, p));
  return static_cast<int>(cudaGetLastError());
}
