// Ragged paged attention for Hopper (sm_90a), built by ops/_kernels.py into
// the port's kernel library and bound with ctypes.
//
// Replaces: paddle_tpu/ops/paged_attention.py::_paged_kernel (launched by
// _pallas_impl), the TPU kernel behind every cached-decode attention in the
// serving engine and generate(): grid (B, H, n_blocks) with the block table,
// seq_lens and q_pos scalar-prefetched, online softmax in VMEM scratch
// across one (b, h) row's blocks, compute skipped for blocks past the row's
// length.
//
// Contract (paged_attention.py:11-46), kept exactly:
//   q       [B, H, Tq, D]            out has the same shape and dtype
//   k, v    [N, Hkv, L_slab, D]      slabs; page g lives in slab row
//                                    g / pages_per_row at column
//                                    (g % pages_per_row) * block_len
//   table   [B, n_blocks] int32      -1 pads clamp to page 0
//   lens    [B] int32                key columns >= lens[b] are masked
//   q_pos   [B] int32                causal mask col <= q_pos[b] + t
// and per logical block, walked IN TABLE ORDER, the JAX op sequence:
//   s = (q . k) * scale, masked to -1e30; m_new = max(m, rowmax(s));
//   p = 0 exactly where s <= -5e29, else exp(s - m_new);
//   alpha = exp(m - m_new); l = l * alpha + rowsum(p);
//   acc = acc * alpha + p @ v with p rounded to the cache dtype;
//   finally acc / max(l, 1e-30).
// A fully masked block is an exact no-op (alpha = 1, p = 0), which is what
// makes chunked prefill bit-identical to whole-prompt prefill; there is
// deliberately no split-KV reduction, which would regroup the sums.
// The slabs are addressed directly: the JAX wrapper's _as_pages transpose
// would copy every layer's whole cache on every step.
//
// What bounds it on this card: bytes. Each (b, kv head) must read the K and
// V pages its row occupies (lens[b] columns of D values each), plus q and
// out once; at head_dim 128 and one q-tile the arithmetic is ~2 operations
// per byte of K/V per query row, far under the H100's ridge point.
//
// Routes: bf16 and fp16 at a block_len that is a multiple of 8 (the
// engine's 8 and DEFAULT_KV_BLOCK among them) and D 64 or 128 run on the
// tensor cores, in paged_attention_tc.cu (mma.sync fed by cp.async page
// gathers; see its note). fp32, kept true fp32 (the model phase holds fp32
// served steps to a CPU twin), and bf16 and fp16 at other block lengths run
// the scalar kernel below (a template over the element type: fp32 math on
// widened values, p and the output rounded to T).
//
// Scalar design (a simple, correct first kernel; no tensor cores, TMA or
// pipelining): one CTA of 128 threads per (q-tile of 16 query rows, head, batch
// row), so a 64-wide prefill chunk over 8 rows and 16 heads gives 512 CTAs
// for the 132 SMs. The CTA loads its own table row, length and position in
// place of scalar prefetch, stages the q tile in shared memory as fp32,
// then walks the occupied logical blocks: the block's K columns are staged
// (16 keys at a time), the 16 x block_len scores land in shared memory,
// the row statistics are computed by the 8 threads that own each query
// row, and V is streamed through shared memory into per-thread fp32
// accumulators (each thread owns 16 of the row's 128 output columns).
// Shared arrays are padded by one float per row so the strided dot
// products hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kQT = 16;      // query rows per CTA
constexpr int kKT = 16;      // keys staged in shared memory at a time
constexpr int kMaxBlock = 64;  // largest block_len accepted
constexpr int kRowThreads = kThreads / kQT;  // 8 threads own one query row

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
// p.astype(v.dtype): the probabilities are rounded to the cache dtype
// before the PV product, as in the JAX kernel.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ table,
                           const int* __restrict__ seq_lens,
                           const int* __restrict__ q_pos, T* __restrict__ out,
                           int H, int Tq, int Hkv, int L_slab, int n_blocks,
                           int block_len, int pages_per_row, float scale) {
  constexpr int kDPerThread = D / kRowThreads;  // output columns per thread
  __shared__ float q_s[kQT][D + 1];
  __shared__ float kv_s[kKT][D + 1];
  __shared__ float s_s[kQT][kMaxBlock + 1];

  const int t0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (H / Hkv);
  const int tid = threadIdx.x;

  const int len = seq_lens[b];
  const int qp = q_pos[b];
  const int* trow = table + static_cast<long long>(b) * n_blocks;

  // stage the q tile (rows past Tq are zero and never stored)
  const T* qb = q + ((static_cast<long long>(b) * H + h) * Tq) * D;
  for (int i = tid; i < kQT * D; i += kThreads) {
    const int t = i / D, d = i % D;
    q_s[t][d] = (t0 + t < Tq) ? to_float(qb[(t0 + t) * D + d]) : 0.f;
  }

  // this thread's query row and output columns
  const int my_t = tid / kRowThreads;
  const int my_c = tid % kRowThreads;
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  // occupied blocks only: a block wholly past the row's length is an exact
  // no-op, so the walk stops there
  int n_active = len > 0 ? (len + block_len - 1) / block_len : 0;
  if (n_active > n_blocks) n_active = n_blocks;

  for (int j = 0; j < n_active; ++j) {
    int g = trow[j];
    g = g < 0 ? 0 : g;  // -1 pads clamp to page 0
    const int prow = g / pages_per_row;
    const int col0 = (g % pages_per_row) * block_len;
    const long long base =
        ((static_cast<long long>(prow) * Hkv + hkv) * L_slab + col0) * D;
    const T* kp = k + base;
    const T* vp = v + base;

    // ---- scores s[t][c] for the block's block_len keys ----
    for (int c0 = 0; c0 < block_len; c0 += kKT) {
      const int nk = min(kKT, block_len - c0);
      __syncthreads();  // kv_s (and q_s on the first pass) are free/ready
      for (int i = tid; i < nk * D; i += kThreads) {
        const int c = i / D, d = i % D;
        kv_s[c][d] = to_float(kp[(c0 + c) * D + d]);
      }
      __syncthreads();
      for (int i = tid; i < kQT * nk; i += kThreads) {
        const int t = i / nk, c = i % nk;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += q_s[t][d] * kv_s[c][d];
        float s = dot * scale;
        const int col = j * block_len + c0 + c;
        const int row = qp + t0 + t;
        if (!(col <= row && col < len)) s = kNegInf;
        s_s[t][c0 + c] = s;
      }
    }
    __syncthreads();

    // ---- online-softmax statistics of my row (8 threads, same values) ----
    float m_cur = kNegInf;
    for (int c = 0; c < block_len; ++c) m_cur = fmaxf(m_cur, s_s[my_t][c]);
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    __syncthreads();  // every thread has read the scores it needs for m
    for (int c = my_c; c < block_len; c += kRowThreads) {
      const float s = s_s[my_t][c];
      const float p = (s <= kNegInf / 2) ? 0.f : expf(s - m_new);
      psum += p;
      s_s[my_t][c] = round_to<T>(p);
    }
    // the row's 8 threads are 8 consecutive lanes of one warp
#pragma unroll
    for (int o = kRowThreads / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;

    // ---- acc = acc * alpha + p @ v over the block ----
    float pv[kDPerThread];
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) pv[i] = 0.f;
    for (int c0 = 0; c0 < block_len; c0 += kKT) {
      const int nk = min(kKT, block_len - c0);
      __syncthreads();  // p written; kv_s free
      for (int i = tid; i < nk * D; i += kThreads) {
        const int c = i / D, d = i % D;
        kv_s[c][d] = to_float(vp[(c0 + c) * D + d]);
      }
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        const float p = s_s[my_t][c0 + c];
#pragma unroll
        for (int i = 0; i < kDPerThread; ++i)
          pv[i] += p * kv_s[c][my_c + i * kRowThreads];
      }
    }
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) acc[i] = acc[i] * alpha + pv[i];
  }

  if (t0 + my_t < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = out + (((static_cast<long long>(b) * H + h) * Tq) + t0 + my_t) * D;
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i)
      ob[my_c + i * kRowThreads] = from_float<T>(acc[i] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* seq_lens, const int* q_pos, void* out, int B, int H,
           int Tq, int D, int Hkv, int L_slab, int n_blocks, int block_len,
           int pages_per_row, float scale, cudaStream_t s) {
  const dim3 grid((Tq + kQT - 1) / kQT, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D == 128) {
    paged_attention_kernel<T, 128><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, table, seq_lens, q_pos, ot, H, Tq, Hkv, L_slab, n_blocks,
        block_len, pages_per_row, scale);
  } else if (D == 64) {
    paged_attention_kernel<T, 64><<<grid, kThreads, 0, s>>>(
        qt, kt, vt, table, seq_lens, q_pos, ot, H, Tq, Hkv, L_slab, n_blocks,
        block_len, pages_per_row, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 (dtype 1) and fp16 (dtype 2) on the tensor cores
// (paged_attention_tc.cu).
int paged_attention_tc(const void* q, const void* k, const void* v,
                       const int* table, const int* seq_lens,
                       const int* q_pos, void* out, int B, int H, int Tq,
                       int D, int Hkv, int L_slab, int n_blocks,
                       int block_len, int pages_per_row, float scale,
                       int dtype, cudaStream_t s);

// The route rule, in this one place (ops/paged_attention.py::paged_route
// mirrors it): bf16 and fp16 at a block_len that is a multiple of 8 and a
// head dim of 64 or 128 run on the tensor cores; everything else on the
// scalar kernel above.
static bool tensor_core_route(int dtype, int block_len, int D) {
  return (dtype == 1 || dtype == 2) && block_len % 8 == 0 &&
         (D == 64 || D == 128);
}

// The route pdtt_paged_attention takes for these arguments, for the
// caller's launch counts: 1 on the tensor cores, 0 on the scalar kernel.
extern "C" int pdtt_paged_attention_route(int dtype, int block_len, int D) {
  return tensor_core_route(dtype, block_len, D) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int pdtt_paged_attention(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* seq_lens, const void* q_pos,
                                    void* out, int B, int H, int Tq, int D,
                                    int Hkv, int L_slab, int n_blocks,
                                    int block_len, int pages_per_row,
                                    float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Hkv < 1 || H % Hkv != 0 ||
      block_len < 1 || block_len > kMaxBlock || pages_per_row < 1 ||
      n_blocks < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* qp = static_cast<const int*>(q_pos);
  if (tensor_core_route(dtype, block_len, D))
    return paged_attention_tc(q, k, v, tb, sl, qp, out, B, H, Tq, D, Hkv,
                              L_slab, n_blocks, block_len, pages_per_row,
                              scale, dtype, s);
  if (dtype == 0)
    return launch<float>(q, k, v, tb, sl, qp, out, B, H, Tq, D, Hkv, L_slab,
                         n_blocks, block_len, pages_per_row, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, tb, sl, qp, out, B, H, Tq, D, Hkv,
                                 L_slab, n_blocks, block_len, pages_per_row,
                                 scale, s);
  if (dtype == 2)
    return launch<__half>(q, k, v, tb, sl, qp, out, B, H, Tq, D, Hkv, L_slab,
                          n_blocks, block_len, pages_per_row, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
