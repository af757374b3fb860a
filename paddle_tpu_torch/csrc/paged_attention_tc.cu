// Ragged paged attention in bf16 and fp16 on Hopper's tensor cores
// (sm_90a), built by ops/_kernels.py into the port's kernel library and
// reached through pdtt_paged_attention (paged_attention.cu) for bf16 or
// fp16 at a block_len that is a multiple of 8 and a head dim of 64 or 128.
// fp32, and 16-bit types at other block lengths, stay paged_attention.cu's
// scalar kernel. The kernel is a template over the element type T: only
// the mma.sync operand type (.bf16 or .f16) and the rounding of P and the
// output to T (pack<T>) depend on it; ldmatrix moves 16-bit values of
// either type alike.
//
// Replaces: paddle_tpu/ops/paged_attention.py::_paged_kernel, as
// paged_attention.cu's scalar kernel does, under its contract
// (paged_attention.cu:11-27), kept exactly: per query row the logical
// blocks are walked in table order with the per-block online-softmax
// update (s = (q . k) * scale masked to -1e30; m_new = max(m, rowmax(s));
// p = 0 exactly where s <= -5e29, else exp(s - m_new); alpha =
// exp(m - m_new); l = l alpha + rowsum(p); acc = acc alpha + T(p) v),
// then out = acc / max(l, 1e-30). No split-KV. A block fully masked for a
// row leaves that row's (m, l, acc) bit-unchanged (alpha = 1, p = 0), and
// every row is computed alone, so chunked prefill equals whole-prompt
// prefill bit for bit. exp is the accurate expf, as the plain version's.
//
// What bounds it on this card: bytes. At the serve shape (B=8, H=Hkv=16,
// Tq=64, D=128, block_len 8, 1,691 cached tokens over the 8 rows) it must
// read 13.9 MB of K and V and 4.2 MB of q and out for 0.80 GFLOP: 0.0054
// ms at 3.35 TB/s against 0.0008 ms at 989 TFLOP/s.
//
// Design (mma.sync on the tensor cores, cp.async to gather the pages):
//   - A CTA of four warps owns 64 query rows of one (batch row, kv head):
//     the rows of the kv group's H/Hkv query heads, flattened (head, t), so
//     the serve shape is one CTA per (b, kv head) and a kv head's pages are
//     read once, not once per query head or per 16-row tile. Larger groups
//     take more CTAs along the rows; keys are never split.
//   - A warp owns 16 rows. Its q fragments (the A operand of Q K^T) stay in
//     registers for the whole walk. Per 8 keys, S is one m16n8k16 tile per
//     16 columns of D (HMMA, fp32 sums); the row max, alpha and row sum are
//     reduced across the quad of lanes that shares a row; P is packed to
//     T straight from the S fragment as the A operand of an m16n8k8
//     product per 8 keys and 8 columns, and acc alpha is that product's C
//     input: P never touches shared memory and no key is padded.
//   - K and V pages are gathered by 16-byte cp.async into a four-stage
//     ring of 64 keys a stage (8 pages at block_len 8), three stages in
//     flight under the products, one __syncthreads a stage. Rows are
//     swizzled (16-byte chunk c of key r at c ^ (r % 8)) so that ldmatrix
//     (K) and ldmatrix.trans (V) read them without bank conflicts.
//   - A stage's S tiles are all issued first, then its blocks' online
//     updates run in phases over the whole stage (masks and block maxima,
//     the running max and alpha of each block, p and the row sums), which
//     overlaps the blocks' work; only l and acc = acc alpha + P V run
//     block by block, in table order. The values are those of the
//     block-by-block walk. acc alpha is skipped when alpha is 1 for every
//     row of the warp (acc * 1 is acc).
//   - The walk stops at n_active = min(ceil(len / bl), ceil((q_pos +
//     t_max + 1) / bl)), t_max the CTA's largest query position: the blocks
//     past it are fully masked for every row of the CTA, so skipping them
//     is exact.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a CTA
constexpr int kStageKeys = 64;      // keys a stage holds at most
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, m16n8k16, T (bf16 or fp16) in, fp32 sums
#define PDTT_MMA_K16(TY)                                                    \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename T>
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    PDTT_MMA_K16("f16");
  } else {
    PDTT_MMA_K16("bf16");
  }
}
#undef PDTT_MMA_K16
// d += a b, m16n8k8, T in, fp32 sums
#define PDTT_MMA_K8(TY)                                                     \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k8.row.col.f32." TY "." TY ".f32 "             \
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                      \
      : "r"(a0), "r"(a1), "r"(b0))
template <typename T>
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  if constexpr (std::is_same<T, __half>::value) {
    PDTT_MMA_K8("f16");
  } else {
    PDTT_MMA_K8("bf16");
  }
}
#undef PDTT_MMA_K8

// two fp32 values rounded to nearest even into a T pair (lo first)
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// byte offset of 16-byte chunk c of key row r in a stage of kD-wide rows
template <int kD>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return static_cast<uint32_t>(r * kD * 2 + ((c ^ (r & 7)) << 4));
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d's multiplier and
// shift from fast_div_params)
struct FastDiv {
  uint32_t d, mul, shift;
};

FastDiv fast_div_params(uint32_t d) {
  uint32_t shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t one = 1;
  return {d, static_cast<uint32_t>(((one << 32) * ((one << shift) - d)) / d +
                                   1),
          shift};
}

__device__ __forceinline__ uint32_t div_of(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

// kNT = block_len / 8
template <typename T, int kD, int kNT>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_kernel_tc(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ table,
                              const int* __restrict__ seq_lens,
                              const int* __restrict__ q_pos,
                              T* __restrict__ out, int H, int Tq, int Hkv,
                              int L_slab, int n_blocks, FastDiv ppr,
                              float scale) {
  constexpr int kBL = 8 * kNT;              // block_len
  constexpr int kBPS = kStageKeys / kBL;    // whole blocks a stage holds
  constexpr int kChunks = kD / 8;           // 16-byte chunks of a key row
  constexpr int kTile = kStageKeys * kD * 2;
  extern __shared__ __align__(128) uint8_t smem_pa[];

  const int hkv = static_cast<int>(blockIdx.y);
  const int b = static_cast<int>(blockIdx.z);
  const int n_rep = H / Hkv;
  const int rows = n_rep * Tq;      // the kv group's rows, (head, t) flat
  const int r0 = static_cast<int>(blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = seq_lens[b];
  const int qp = q_pos[b];
  const int* trow = table + static_cast<long long>(b) * n_blocks;

  // the walk: occupied blocks up to the causal horizon of the CTA's
  // largest query position (every later block is masked for all its rows)
  const int r_last = min(r0 + kRows, rows) - 1;
  const int t_max = r0 / Tq != r_last / Tq ? Tq - 1 : r_last % Tq;
  const int horizon = qp + t_max + 1;
  int n_active = min((max(len, 0) + kBL - 1) / kBL, n_blocks);
  n_active = min(n_active, horizon > 0 ? (horizon + kBL - 1) / kBL : 0);
  const int n_stages = (n_active + kBPS - 1) / kBPS;

  // K and V of the blocks of stage st into ring slot st % kStages
  auto load_stage = [&](int st) {
    uint8_t* ks = smem_pa + (st % kStages) * 2 * kTile;
    uint8_t* vs = ks + kTile;
    const int j0 = st * kBPS;
    const int n_keys = min(kBPS, n_active - j0) * kBL;
    for (int i = threadIdx.x; i < n_keys * kChunks; i += kThreads) {
      const int key = i / kChunks, c = i % kChunks;
      int pg = __ldg(trow + j0 + key / kBL);
      pg = pg < 0 ? 0 : pg;  // -1 pads clamp to page 0
      const uint32_t prow = div_of(static_cast<uint32_t>(pg), ppr);
      const long long off =
          ((static_cast<long long>(prow) * Hkv + hkv) * L_slab +
           (pg - prow * ppr.d) * kBL + key % kBL) *
              kD +
          c * 8;
      const uint32_t dst = chunk_at<kD>(key, c);
      cp_async16(smem_u32(ks + dst), k + off);
      cp_async16(smem_u32(vs + dst), v + off);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_commit();
  }

  // this thread's rows g and g + 8 of the warp's 16: causal position and
  // the q fragments
  const int wr0 = r0 + 16 * warp;
  const bool warp_live = wr0 < rows;
  int rpos[2];
  bool rvalid[2];
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    rvalid[h] = r < rows;
    const int head = hkv * n_rep + r / Tq, t = r % Tq;
    rpos[h] = qp + t;
    qrow[h] = q + ((static_cast<long long>(b) * H + head) * Tq + t) * kD;
  }
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1;
      qa[kk][i] = rvalid[h] ? *reinterpret_cast<const uint32_t*>(
                                  qrow[h] + 16 * kk + 8 * (i >> 1) + 2 * t4)
                            : 0u;
    }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage st landed; slot (st - 1) % kStages is free
    if (st + kStages - 1 < n_stages) load_stage(st + kStages - 1);
    cp_commit();
    if (!warp_live) continue;
    const uint32_t ks = smem_u32(smem_pa + (st % kStages) * 2 * kTile);
    const uint32_t vs = ks + kTile;

    // S of every block of the stage: per 8 keys one n8 tile, rows g / g + 8
    // in elements 0, 1 / 2, 3, key columns 2 t4 (+1)
    float s[kBPS][kNT][4];
#pragma unroll
    for (int bi = 0; bi < kBPS; ++bi)
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[bi][jj][e] = 0.f;
        const int key = bi * kBL + 8 * jj + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < kD / 32; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + chunk_at<kD>(key, 4 * kk + (lane >> 3)));
          mma_k16<T>(s[bi][jj], qa[2 * kk], kb[0], kb[1]);
          mma_k16<T>(s[bi][jj], qa[2 * kk + 1], kb[2], kb[3]);
        }
      }

    // The blocks' online updates, in table order, computed in phases so
    // that the work of the stage's blocks overlaps: the values are those
    // of the block-by-block walk. Blocks past n_active (in the last stage)
    // change nothing: their m update is not taken and they are left out of
    // the serial part.
    const int j0 = st * kBPS;
    // scale, mask and each block's row max
    float mrun[kBPS][2];
#pragma unroll
    for (int bi = 0; bi < kBPS; ++bi) {
      const int c0 = (j0 + bi) * kBL;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = c0 + 8 * jj + 2 * t4 + (e & 1);
          float x = __fmul_rn(s[bi][jj][e], scale);
          if (!(col <= rpos[h] && col < len)) x = kNegInf;
          s[bi][jj][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) mrun[bi][h] = quad_max(mx[h]);
    }
    // the running max after each block and its rescale factor alpha
    float al[kBPS][2];
#pragma unroll
    for (int bi = 0; bi < kBPS; ++bi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn =
            j0 + bi < n_active ? fmaxf(m[h], mrun[bi][h]) : m[h];
        al[bi][h] = expf(m[h] - mn);
        m[h] = mn;
        mrun[bi][h] = mn;
      }
    // p against the block's running max, and the block's row sums
    float ps[kBPS][2];
#pragma unroll
    for (int bi = 0; bi < kBPS; ++bi) {
      ps[bi][0] = ps[bi][1] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float x = s[bi][jj][e];
          const float p = x <= kNegInf / 2 ? 0.f : expf(x - mrun[bi][h]);
          s[bi][jj][e] = p;
          ps[bi][h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) ps[bi][h] = quad_sum(ps[bi][h]);
    }
    // the serial part: l = l alpha + sum p, acc = acc alpha + P V
#pragma unroll
    for (int bi = 0; bi < kBPS; ++bi) {
      if (j0 + bi >= n_active) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * al[bi][h] + ps[bi][h];
      // acc * 1 is acc: skipped when no row of the warp moved its max
      if (__any_sync(0xffffffffu, al[bi][0] != 1.f || al[bi][1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = __fmul_rn(acc[n][e], al[bi][e >> 1]);
      }
      // per 8 keys an m16n8k8 product for each 8 columns of D, P's A
      // operand packed from its S fragment, V through ldmatrix.trans
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) {
        const uint32_t a0 = pack<T>(s[bi][jj][0], s[bi][jj][1]);
        const uint32_t a1 = pack<T>(s[bi][jj][2], s[bi][jj][3]);
        const int key = bi * kBL + 8 * jj + (lane & 7);
#pragma unroll
        for (int n4 = 0; n4 < kD / 32; ++n4) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + chunk_at<kD>(key, 4 * n4 + (lane >> 3)));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_k8<T>(acc[4 * n4 + i], a0, a1, vb[i]);
        }
      }
    }
  }
  cp_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rvalid[h]) continue;
    const float den = fmaxf(l[h], 1e-30f);
    T* orow = out + (qrow[h] - q);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
          pack<T>(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
  }
}

template <typename T, int kD, int kNT>
int launch_tc(const void* q, const void* k, const void* v, const int* table,
              const int* seq_lens, const int* q_pos, void* out, int B, int H,
              int Tq, int Hkv, int L_slab, int n_blocks, int pages_per_row,
              float scale, cudaStream_t s) {
  constexpr int smem = kStages * 2 * kStageKeys * kD * 2;
  const long long n_rt = (static_cast<long long>(H / Hkv) * Tq + kRows - 1) /
                         kRows;
  if (n_rt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      paged_attention_kernel_tc<T, kD, kNT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  paged_attention_kernel_tc<T, kD, kNT>
      <<<dim3(static_cast<unsigned>(n_rt), Hkv, B), kThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), table, seq_lens, q_pos,
          static_cast<T*>(out), H, Tq, Hkv, L_slab, n_blocks,
          fast_div_params(static_cast<uint32_t>(pages_per_row)), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_tc_d(const void* q, const void* k, const void* v,
                const int* table, const int* seq_lens, const int* q_pos,
                void* out, int B, int H, int Tq, int Hkv, int L_slab,
                int n_blocks, int block_len, int pages_per_row, float scale,
                cudaStream_t s) {
#define PDTT_PAGED_TC(NT)                                                  \
  case NT:                                                                 \
    return launch_tc<T, kD, NT>(q, k, v, table, seq_lens, q_pos, out, B,  \
                                H, Tq, Hkv, L_slab, n_blocks,             \
                                pages_per_row, scale, s);
  switch (block_len / 8) {
    PDTT_PAGED_TC(1)
    PDTT_PAGED_TC(2)
    PDTT_PAGED_TC(3)
    PDTT_PAGED_TC(4)
    PDTT_PAGED_TC(5)
    PDTT_PAGED_TC(6)
    PDTT_PAGED_TC(7)
    PDTT_PAGED_TC(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDTT_PAGED_TC
}

template <typename T>
int launch_tc_t(const void* q, const void* k, const void* v,
                const int* table, const int* seq_lens, const int* q_pos,
                void* out, int B, int H, int Tq, int D, int Hkv, int L_slab,
                int n_blocks, int block_len, int pages_per_row, float scale,
                cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (block_len % 8 || block_len > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return launch_tc_d<T, 128>(q, k, v, table, seq_lens, q_pos, out, B, H,
                               Tq, Hkv, L_slab, n_blocks, block_len,
                               pages_per_row, scale, s);
  if (D == 64)
    return launch_tc_d<T, 64>(q, k, v, table, seq_lens, q_pos, out, B, H, Tq,
                              Hkv, L_slab, n_blocks, block_len,
                              pages_per_row, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The launcher for paged_attention.cu's entry point: dtype 1 (bf16) or 2
// (fp16), block_len a multiple of 8 up to 64, D 64 or 128, every pointer
// 16-byte aligned (the wrapper checks). Returns cudaGetLastError() after
// the launch.
int paged_attention_tc(const void* q, const void* k, const void* v,
                       const int* table, const int* seq_lens,
                       const int* q_pos, void* out, int B, int H, int Tq,
                       int D, int Hkv, int L_slab, int n_blocks,
                       int block_len, int pages_per_row, float scale,
                       int dtype, cudaStream_t s) {
  if (dtype == 1)
    return launch_tc_t<bf16>(q, k, v, table, seq_lens, q_pos, out, B, H, Tq,
                             D, Hkv, L_slab, n_blocks, block_len,
                             pages_per_row, scale, s);
  if (dtype == 2)
    return launch_tc_t<__half>(q, k, v, table, seq_lens, q_pos, out, B, H,
                               Tq, D, Hkv, L_slab, n_blocks, block_len,
                               pages_per_row, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
