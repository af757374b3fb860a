// Flash attention forward, dq and dk/dv in bf16 and fp16 on Hopper's tensor
// cores (sm_90a), built by ops/_kernels.py into the port's kernel library
// and reached through pdtt_flash_fwd / pdtt_flash_bwd_dq /
// pdtt_flash_bwd_dkv (flash_attention.cu) when dtype == 1 (bf16) or 2
// (fp16, for AMP or pure training in float16), each with its mask and
// dropout variants. The kernels are templates over the element type T:
// only the rounding of P, dS and the outputs to T (pack2), wgmma's operand
// type and TMA's data type depend on it. The fp32 path stays
// flash_attention.cu's scalar kernels.
//
// Replaces: paddle_tpu/ops/attention.py::_fwd_kernel (flash_fwd_kernel_tc),
// ::_bwd_dq_kernel (flash_bwd_dq_kernel_tc) and ::_bwd_dkv_kernel
// (flash_bwd_dkv_kernel_tc), the TPU kernels of every no-cache attention of
// GPT training.
//
// Contract: flash_attention.cu's (attention.py:174-362), kept exactly:
//   s = (q . k) summed in fp32, then * scale; causal keeps col <= row +
//   (Sk - Sq) and masks the rest to -1e30; p = 0 exactly where the masked
//   score is <= -5e29; l floored at 1e-30, so a row with no visible key
//   outputs 0 and lse = -1e30. Forward: p (against the running max) is
//   rounded to T before PV. dk/dv: p = exp(s - lse) rounded to T for
//   dv = p^T g, ds = p (dp - delta) scale rounded to T for dk = ds^T q;
//   dq: the same ds rounded to T for dq = ds k; every sum in fp32. Any
//   Sq, Sk >= 1 (rows and keys past the end are zero-filled and never
//   stored); D a multiple of 16 up to 128, run at a
//   padded head dim of 64 or 128 (the padded columns are zero and add exact
//   zeros). No atomics and a fixed summation order: two runs are bit-equal.
//   exp(x - m) is computed as 2^(x log2 e - m log2 e) on the SFU
//   (ex2.approx.ftz), which moves p by ulps and flushes p < 2^-126 to 0.
//
// What bounds it on this card: both limits are close. At the training
// shape (B=4, H=16, S=1024, D=128, causal) the forward does 17.2 GFLOP on
// 67.4 MB (0.0174 ms at 989 TFLOP/s, 0.0201 ms at 3.35 TB/s: bytes by a
// little), dq 25.8 GFLOP on 84.4 MB (0.0261 ms against 0.0252 ms:
// operations) and dk/dv 34.4 GFLOP on 101 MB (0.0348 ms against 0.0302 ms:
// operations), ~250 operations a byte, near the H100's bf16 ridge. So the
// work belongs on the tensor cores, with every input read once from DRAM.
//
// Design (Hopper's warpgroup products fed by the TMA):
//   - A CTA has two consumer warpgroups (256 threads). Every product is a
//     wgmma.mma_async m64nNk16 bf16 -> fp32: a warpgroup owns 64 rows of
//     the output tile (query rows in the forward, keys in dk/dv), a warp 16
//     of them, with the fp32 sums in registers.
//   - Tiles come in by TMA (cp.async.bulk.tensor, one 3-D map per operand
//     built in the C entry point from the pointer and shapes), each stage
//     of a two-stage ring completing on its own mbarrier. The map
//     zero-fills rows past Sq/Sk and columns past D: the ragged edge costs
//     no code. A tile is kD/64 blocks of 128-byte rows in the TMA's 128-byte
//     swizzle, which the wgmma descriptors name (layout 1), so shared
//     memory is read without bank conflicts and without ldmatrix.
//   - S = Q K^T (and S^T = K Q^T, dP^T = V dO^T) take both operands from
//     shared memory, K-major. The softmax, exp(s - lse) and ds run on the
//     fp32 accumulator fragments, with row max and row sum reduced across
//     the four lanes that share a row. The accumulator layout of two
//     adjacent n8 groups is the register A layout of a k16 step, so P (and
//     dS^T) are packed to bf16 in registers and fed straight into
//     O += P V (dV += P^T dO, dK += dS^T Q) with the other operand an
//     MN-major B in shared memory (V, dO, Q as stored). P never touches
//     shared memory.
//   - Forward: a CTA owns 128 query rows of one (batch*head) and streams
//     64-key tiles of K and V through separate two-stage rings, filled by
//     a ninth, producer warp; each consumer warpgroup hands a stage back
//     through a second mbarrier as soon as its products have read it, so
//     the warpgroups never wait for each other. Tile kt's S is issued
//     together with tile kt-1's P V, so the softmax of tile kt runs while
//     P V is on the tensor cores. The longest causal q tiles are scheduled
//     first (the q tile index is the slow grid dimension) and the loop
//     stops at the last visible k tile. The output is staged through the
//     warp's own rows of the Q tile and written with 16-byte stores.
//   - dk/dv: a CTA owns 128 keys of one (batch*head); K and V stay in
//     shared memory, and Q and dO (TMA) with lse and delta (4-byte
//     cp.async) stream through a two-stage ring in 64-row tiles, from the
//     first q tile that can see the CTA's first key, refilled by one thread
//     after a CTA barrier. Per tile a warpgroup issues S^T and dP^T
//     together and turns S^T into P^T while dP^T runs, issues dV += P^T dO
//     and computes dS^T while it runs, then issues dK += dS^T Q. dK and dV
//     stay in registers and are stored once (no atomics; dq is the
//     separate kernel). The k tiles that see the most q tiles run first.
//   - dq: the forward's shape. A CTA owns 128 query rows of one
//     (batch*head); Q and dO come in once by TMA and stay, lse and delta sit
//     in registers, and a producer warpgroup (one thread issues; the
//     warpgroup gives its registers to the consumers with setmaxnreg)
//     streams 64-key tiles of V and K through two-stage rings with free
//     mbarriers (V is let go as soon as
//     dP has read it, K a step later, after dQ += dS K). Per tile a
//     warpgroup issues S = Q K^T and dP = dO V^T together with the last
//     tile's dQ += dS K (K as an MN-major B, as V is in the forward's P V),
//     turns S into P while dP runs and dP into dS while dS K runs, then
//     packs dS to bf16 in registers as the next dS K's A operand. dQ stays
//     in registers and is stored once; the longest causal q tiles run first
//     and the loop stops at the last visible k tile.
// Variants (the TPU kernels' has_mask and dropout_p > 0), compile-time
// flags <kD, kMask, kDrop>, so the instantiation the train step runs
// (<kD, false, false>) is the code it was:
//   - mask: fp32 rows (flash_attention.cuh's AttnMask) added to the scaled
//     scores in the natural-log domain after the causal -1e30 and before
//     the -5e29 test and the exp2; every visited tile adds it (the skip of
//     tiles wholly above the causal diagonal stays). Read in the
//     accumulator layout: a column pair as one 8-byte load where Sk is
//     even, predicated 4-byte loads otherwise and at ragged edges (the
//     forward and dq); dk/dv, whose fragments hold keys in rows, first
//     copies its 64 x 128 tile of the mask into shared memory, coalesced
//     (cp.async), while S^T and dP^T run.
//   - dropout: the keep bits of philox.cuh (per element), drawn into one
//     32-bit register per tile (the forward and dk/dv right after the
//     tile's products are issued, so Philox runs while they are on the
//     tensor cores; dq just before, where its registers allow); lanes
//     that hold neighbouring key columns share each Philox call. The
//     forward sums the undropped p into l and feeds keep ? p / (1 - p) :
//     0 to P V; dq drops dp; dk/dv drops p for dV and dp for dS^T.
//   No branch encloses a wgmma: the variants change only the elementwise
//   work between the products. A simple, correct first version: the
//   mask loads and Philox are not yet hidden further.
// <cuda.h> for CUtensorMap's types only: the encoder is fetched at run time
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFwdBQ = 16 * kWarps;  // query rows of a forward CTA
constexpr int kFwdThreads = kThreads + 32;  // and one producer warp
constexpr int kDqThreads = kThreads + 128;  // and a producer warpgroup
constexpr int kFwdBK = 64;           // keys of a streamed K/V tile
constexpr int kBwdBK = 16 * kWarps;  // keys of a dk/dv CTA
constexpr int kBwdBQ = 64;           // query rows of a streamed Q/dO tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// wait until every committed group has landed
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two fp32 values rounded to nearest even into a pair of T (lo first).
// This, wgmma's operand type and TMA's data type are all that an element
// type (bf16, or fp16 for AMP in float16) changes in these kernels.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// n fp32 values from src[row0..] by threads [first, first + n); past
// n_rows zero
__device__ __forceinline__ void load_row_values(float* dst, const float* src,
                                                int row0, int n_rows,
                                                int first, int n) {
  const int t = static_cast<int>(threadIdx.x) - first;
  if (t >= 0 && t < n) {
    const bool ok = row0 + t < n_rows;
    cp_async4(smem_u32(dst + t), ok ? src + row0 + t : src, ok);
  }
}

// 2^x on the SFU; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk,
                                        int offset, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row + offset);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------- the mask and dropout variants
// An accumulator fragment of 16 rows x 64 columns: this thread's element i
// sits at row row0 + 8 ((i >> 1) & 1), column col0 + 8 (i >> 2) + (i & 1)
// (row0 = the warp's first row + lane / 4, col0 = the tile's first column
// + 2 (lane % 4)).

// The first element of batch*head bh's mask row.
__device__ __forceinline__ const float* mask_rows(const AttnMask& mask,
                                                  int bh, int Sq, int Sk) {
  return mask.ptr + static_cast<long long>(bh / mask.row_div) * Sq *
                        static_cast<long long>(Sk);
}

// x[i] += mask[row][col] in fp32 for the fragment's elements inside Sq x
// Sk (the rest keep their -1e30): a column pair as one 8-byte load where
// Sk is even and the rows 8-byte aligned, else two predicated 4-byte ones.
__device__ __forceinline__ void add_mask_frag(float (&x)[32], const float* mb,
                                              int row0, int col0, int Sq,
                                              int Sk) {
  const bool pairs =
      (Sk & 1) == 0 && (reinterpret_cast<uintptr_t>(mb) & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const float* mr = mb + static_cast<long long>(row) * Sk;
    const bool rok = row < Sq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = col0 + 8 * jj;
      float2 v = make_float2(0.f, 0.f);
      if (pairs) {
        if (rok && col < Sk) v = *reinterpret_cast<const float2*>(mr + col);
      } else {
        if (rok && col < Sk) v.x = mr[col];
        if (rok && col + 1 < Sk) v.y = mr[col + 1];
      }
      x[4 * jj + 2 * h] += v.x;
      x[4 * jj + 2 * h + 1] += v.y;
    }
    // one row's eight loads in flight at a time: all sixteen at once
    // spill the forward past its 168 registers
    asm volatile("" ::: "memory");
  }
}

// dk/dv's mask: its fragments hold keys in rows and query rows in columns,
// so a thread's mask reads would stride Sk apart. The CTA's tile of the
// mask (kBwdBQ query rows x kBwdBK keys, fp32) is copied into shared
// memory first, coalesced, by cp.async (16 bytes where Sk % 4 == 0 and the
// rows are 16-byte aligned, else 4): zeros past Sq and Sk. A row of
// kMaskStride floats: the 8 keys x 4 query rows a warp reads at once fall
// in 32 different banks.
constexpr int kMaskStride = 128 + 4;
template <int kRows, int kCols>
__device__ __forceinline__ void load_mask_tile(float* tile, const float* mb,
                                               int q0, int k0, int Sq,
                                               int Sk) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nthreads = static_cast<int>(blockDim.x);
  if ((Sk & 3) == 0 && (reinterpret_cast<uintptr_t>(mb) & 15) == 0) {
    for (int c = tid; c < kRows * kCols / 4; c += nthreads) {
      const int r = c / (kCols / 4), col = 4 * (c % (kCols / 4));
      const bool ok = q0 + r < Sq && k0 + col < Sk;
      cp_async16(smem_u32(tile + r * kMaskStride + col),
                 ok ? mb + static_cast<long long>(q0 + r) * Sk + k0 + col
                    : mb,
                 ok);
    }
  } else {
    for (int c = tid; c < kRows * kCols; c += nthreads) {
      const int r = c / kCols, col = c % kCols;
      const bool ok = q0 + r < Sq && k0 + col < Sk;
      cp_async4(smem_u32(tile + r * kMaskStride + col),
                ok ? mb + static_cast<long long>(q0 + r) * Sk + k0 + col
                   : mb,
                ok);
    }
  }
}

// One Philox call gives the keep words of four neighbouring key columns,
// and the lanes that hold those columns share the call: each computes a
// share of the calls and passes the words along with shuffles. The calls
// run one after another (not unrolled): interleaved, their temporaries
// spill the kernels whose accumulators are in flight meanwhile.
__device__ __forceinline__ uint32_t pick_word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// The keep bits of a fragment whose rows are query rows (forward, dq): bit
// i for element i. Lanes 2b and 2b + 1 of a quad hold columns 4b..4b+3 of
// the same rows, so one Philox call serves both: the lane of parity par
// draws the calls of row row0 + 8 par and hands the other lane its two
// words (8 calls a lane, not 16).
__device__ __forceinline__ uint32_t keep_bits(const DropoutParams& d, int bh,
                                              int row0, int col0) {
  const int par = static_cast<int>(threadIdx.x) & 1;
  uint32_t bits = 0;
#pragma unroll 1
  for (int jj = 0; jj < 8; ++jj) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(col0 + 8 * jj) >> 2,
                   static_cast<uint32_t>(row0 + 8 * par),
                   static_cast<uint32_t>(bh), 0u),
        d.key0, d.key1);
    const uint32_t m0 = par ? w.z : w.x, m1 = par ? w.w : w.y;
    const uint32_t o0 = __shfl_xor_sync(0xffffffffu, par ? w.x : w.z, 1);
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, par ? w.y : w.w, 1);
    bits |= (static_cast<uint32_t>(m0 >= d.threshold) |
             static_cast<uint32_t>(m1 >= d.threshold) << 1)
            << (4 * jj + 2 * par);
    bits |= (static_cast<uint32_t>(o0 >= d.threshold) |
             static_cast<uint32_t>(o1 >= d.threshold) << 1)
            << (4 * jj + 2 * (1 - par));
  }
  return bits;
}

// The keep bits of a transposed fragment (dk/dv: rows are keys, columns
// query rows): bit i for element i. The four lanes whose keys are
// key0 - (key0 & 3) .. + 3 (lane / 4 = 4a .. 4a + 3, one lane % 4) need
// the same 32 calls, each one word of it: member m draws the calls of
// elements 4t + m and deals their words round the four in three
// shuffles (8 calls a lane, not 32).
__device__ __forceinline__ uint32_t keep_bits_t(const DropoutParams& d,
                                                int bh, int key0, int q0) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int m = (lane >> 2) & 3;
  uint32_t bits = 0;
#pragma unroll 1
  for (int t = 0; t < 8; ++t) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(key0 + 8 * ((m >> 1) & 1)) >> 2,
                   static_cast<uint32_t>(q0 + 8 * t + (m & 1)),
                   static_cast<uint32_t>(bh), 0u),
        d.key0, d.key1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // round r: read member (m + r) % 4's call, which offers the word
      // of member (its index - r) % 4, that is, this lane's
      const int src = (m + r) & 3;
      const uint32_t give = pick_word(w, (m - r) & 3);
      const uint32_t got =
          r == 0 ? give
                 : __shfl_sync(0xffffffffu, give, lane + 4 * (src - m));
      bits |= static_cast<uint32_t>(got >= d.threshold) << (4 * t + src);
    }
  }
  return bits;
}

// keep ? x / (1 - p) : 0 (by the fp32 reciprocal), element by element
__device__ __forceinline__ float keep_or_zero(float x, uint32_t bits, int i,
                                              float rescale) {
  return (bits >> i) & 1u ? __fmul_rn(x, rescale) : 0.f;
}

// ------------------------------------------ TMA, mbarrier and wgmma pieces
// A tile of R rows x kD bf16 lives in shared memory as kD/64 blocks of
// R rows x 128 bytes, each block in the 128-byte swizzle that the TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads (layout type 1): the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). Blocks start on 1024 bytes.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrive once and expect `bytes` of TMA writes before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [row0, row0 + kRows) of batch*head bh, all kD columns, by TMA into a
// swizzled tile; the map zero-fills rows past the sequence and columns
// past D. Completes kRows * kD * 2 bytes on `bar`.
template <int kD, int kRows>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int b = 0; b < kD / 64; ++b)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            smem_u32(dst + b * kRows * 128)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(64 * b),
        "r"(row0), "r"(bh)
        : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t sw128_desc(const uint8_t* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// rows r0..r0+63 (or the 64 columns of B) of a kRows-row tile as a K-major
// operand (the row's own columns are the reduction), reduction columns
// 16 kk..16 kk+15: 8-row groups 1024 bytes apart
template <int kRows>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int r0,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * kRows * 128 + r0 * 128 + (kk & 3) * 32,
                    16, 1024);
}
// a kRows-row tile as an MN-major B operand whose rows 16 kk..16 kk+15 are
// the reduction (P V): column blocks of 64 kRows * 128 bytes apart, 8-row
// groups 1024 bytes apart
template <int kRows>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kRows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (shared memory, K-major) * B (shared memory, K-major),
// m64n64k16; d is overwritten where scale_d == 0
#define PDTT_WGMMA_SS_N64(TY)                                     \
  asm volatile(                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{"                                                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                          \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                  \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                 \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),           \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),       \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])        \
      : "l"(da), "l"(db), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    PDTT_WGMMA_SS_N64("f16");
  else
    PDTT_WGMMA_SS_N64("bf16");
}

// d += A (registers) * B (shared memory, MN-major), m64n64k16
#define PDTT_WGMMA_RS_N64(TY)                                        \
  asm volatile(                                                      \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "    \
      "{"                                                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),              \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),              \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),            \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    PDTT_WGMMA_RS_N64("f16");
  else
    PDTT_WGMMA_RS_N64("bf16");
}

// d += A (registers) * B (shared memory, MN-major), m64n128k16
#define PDTT_WGMMA_RS_N128(TY)                                       \
  asm volatile(                                                      \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                   \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "   \
      "{"                                                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                     \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                     \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                     \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                     \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                    \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),              \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),              \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),            \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),          \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    PDTT_WGMMA_RS_N128("f16");
  else
    PDTT_WGMMA_RS_N128("bf16");
}

// d += A (registers) * B (shared memory, MN-major), m64n{kD}k16
template <typename T, int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kD == 128)
    wgmma_rs_n128<T>(d, a, db);
  else
    wgmma_rs_n64<T>(d, a, db);
}

// The A operand (m64k16, this warp's 16 rows) from two adjacent n8 groups
// of a wgmma accumulator (elements 4 j .. 4 j + 7), as acc_to_a
template <typename T>
__device__ __forceinline__ void frag_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack2<T>(c[0], c[1]);
  a[1] = pack2<T>(c[2], c[3]);
  a[2] = pack2<T>(c[4], c[5]);
  a[3] = pack2<T>(c[6], c[7]);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 16-byte chunk c (of kD/8) of row r in a swizzled tile of kRows rows
template <int kRows>
__device__ __forceinline__ int tile_chunk(int r, int c) {
  return (c >> 3) * kRows * 8 + r * 8 + ((c & 7) ^ (r & 7));
}

// The warp's 16 x kD accumulator (rows g and g + 8 of each n8 group,
// divided by div0 and div1) rounded to T into its own rows rb..rb+15 of
// a kRows-row tile (the warp's own: nothing else reads them any more),
// then copied out to rows row0.. of dst (those below n_rows, columns below
// D) with 16-byte stores.
template <int kD, int kRows, typename T>
__device__ __forceinline__ void store_rows(uint8_t* tile_bytes, int rb,
                                           const float (&acc)[kD / 2],
                                           float div0, float div1, T* dst,
                                           int row0, int n_rows, int D,
                                           int lane) {
  constexpr int kChunks = kD / 8;
  uint4* tile = reinterpret_cast<uint4*>(tile_bytes);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    reinterpret_cast<uint32_t*>(tile + tile_chunk<kRows>(rb + g, j))[t4] =
        pack2<T>(acc[4 * j] / div0, acc[4 * j + 1] / div0);
    reinterpret_cast<uint32_t*>(tile + tile_chunk<kRows>(rb + g + 8, j))[t4] =
        pack2<T>(acc[4 * j + 2] / div1, acc[4 * j + 3] / div1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < n_rows && c * 8 < D)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) * D +
                                c * 8) = tile[tile_chunk<kRows>(rb + r, c)];
  }
}

// ---------------------------------------------------------------- forward
// Scale, mask and online softmax of one S tile on its fragments: this
// thread holds rows wq0 + g (elements 4 j, 4 j + 1) and wq0 + g + 8
// (4 j + 2, 4 j + 3), key columns k0 + 8 j + 2 t4 (+1). Leaves p in s and
// updates the running max m and this lane's part of the row sum l; returns
// the rescale factors of the earlier output in al.
// With kMask the mask (rows of mask_row0) is added after the causal -1e30, and
// the -5e29 test runs after the add; with kDrop, p is summed into l
// undropped and then dropped by `keep` (keep_bits) for the P V product.
template <bool kMask, bool kDrop>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&al)[2],
    bool masked, int wq0, int k0, int g, int t4, int Sq, int Sk, int offset,
    int causal, float scale, const float* mask_row0, uint32_t keep,
    float rescale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = __fmul_rn(s[i], scale);
    if (masked) {
      const int row = wq0 + g + ((i >> 1) & 1) * 8;
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (!visible(row, col, Sq, Sk, offset, causal)) x = kNegInf;
    }
    s[i] = x;
    // (the plain instantiation keeps its one loop: same machine code)
    if constexpr (!kMask) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  if constexpr (kMask) {
    add_mask_frag(s, mask_row0, wq0 + g, k0 + 2 * t4, Sq, Sk);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mb[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]));
    al[h] = exp2_ftz((m[h] - mn) * kLog2e);
    m[h] = mn;
    mb[h] = mn * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p =
        s[i] <= kNegInf / 2 ? 0.f : exp2_ftz(fmaf(s[i], kLog2e, -mb[h]));
    s[i] = p;
    ps[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + ps[h];
  if constexpr (kDrop) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = keep_or_zero(s[i], keep, i, rescale);
  }
}

template <typename T, int kD, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ out, float* __restrict__ lse,
                        int Sq, int Sk, int D, float scale, int causal,
                        AttnMask mask, DropoutParams drop) {
  constexpr int kQBytes = kFwdBQ * kD * 2;
  constexpr int kKBytes = kFwdBK * kD * 2;
  extern __shared__ uint8_t smem_tc[];
  uint8_t* q_s = align1024(smem_tc);
  uint8_t* k_s = q_s + kQBytes;          // 2 stages
  uint8_t* v_s = k_s + 2 * kKBytes;      // 2 stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + 2 * kKBytes);
  // bar[0]: Q landed; bar[1 + s] / bar[3 + s]: K / V of stage s landed;
  // bar[5 + s] / bar[7 + s]: both warpgroups are done with K / V of stage s
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 3;
  uint64_t* k_free = bar + 5;
  uint64_t* v_free = bar + 7;

  const int q0 =
      (static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)) *
      kFwdBQ;
  const int bh = static_cast<int>(blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int offset = Sk - Sq;
  int n_kt = (Sk + kFwdBK - 1) / kFwdBK;
  if (causal) {
    const int last_col = min(q0 + kFwdBQ, Sq) - 1 + offset;
    n_kt = last_col < 0 ? 0 : min(n_kt, last_col / kFwdBK + 1);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bar[i]);
    for (int i = 5; i < 9; ++i) mbar_init(&bar[i], 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: Q once, then K and V of every tile, each into a stage
    // as soon as both warpgroups have let go of it
    if (lane == 0 && n_kt > 0) {
      mbar_expect_tx(q_full, kQBytes);
      tma_tile<kD, kFwdBQ>(q_s, &tq, q_full, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1;
        if (kt >= 2) mbar_wait(&k_free[st], ((kt >> 1) - 1) & 1);
        mbar_expect_tx(&k_full[st], kKBytes);
        tma_tile<kD, kFwdBK>(k_s + st * kKBytes, &tk, &k_full[st],
                             kt * kFwdBK, bh);
        if (kt >= 2) mbar_wait(&v_free[st], ((kt >> 1) - 1) & 1);
        mbar_expect_tx(&v_full[st], kKBytes);
        tma_tile<kD, kFwdBK>(v_s + st * kKBytes, &tv, &v_full[st],
                             kt * kFwdBK, bh);
      }
    }
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int rb = 16 * warp;      // the warp's rows in the tile
  const int wg_row = 64 * wg;    // its warpgroup's
  const int wq0 = q0 + rb;
  const bool wg_leader = (threadIdx.x & 127) == 0;

  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, al[2];
  float s[32];
  uint32_t a[kFwdBK / 16][4];  // P of the last tile, the A operand of PV
  const float* mb = kMask ? mask_rows(mask, bh, Sq, Sk) : nullptr;
  uint32_t keep = 0;  // dropout's keep bits of the tile being softmaxed
  // drawn while the tile's S is on the tensor cores
  auto draw_keep = [&](int kt) {
    if constexpr (kDrop) keep = keep_bits(drop, bh, wq0 + g,
                                          kt * kFwdBK + 2 * t4);
  };
  // S = Q K^T of tile kt: the warpgroup's 64 rows x 64 keys
  auto issue_s = [&](int kt) {
    const uint8_t* ks = k_s + (kt & 1) * kKBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(s, kmajor_desc<kFwdBQ>(q_s, wg_row, kk),
                   kmajor_desc<kFwdBK>(ks, 0, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of tile kt, P from registers
  auto issue_pv = [&](int kt) {
    const uint8_t* vs = v_s + (kt & 1) * kKBytes;
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk)
      wgmma_rs<T, kD>(o, a[kk], mnmajor_desc<kFwdBK>(vs, kk));
    wgmma_commit();
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * kFwdBK;
    const bool masked = wq0 + 16 > Sq || k0 + kFwdBK > Sk ||
                        (causal && k0 + kFwdBK - 1 > wq0 + offset);
    online_softmax<kMask, kDrop>(s, m, l, al, masked, wq0, k0, g, t4, Sq,
                                 Sk, offset, causal, scale, mb, keep,
                                 drop.rescale);
  };
  if (n_kt > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    issue_s(0);
    draw_keep(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (wg_leader) mbar_arrive(&k_free[0]);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk) frag_to_a<T>(a[kk], s + 8 * kk);
  }
  // Tile kt's S is issued together with tile kt-1's P V, so the softmax of
  // tile kt runs while P V is on the tensor cores.
  for (int kt = 1; kt < n_kt; ++kt) {
    mbar_wait(&k_full[kt & 1], (kt >> 1) & 1);
    mbar_wait(&v_full[(kt - 1) & 1], ((kt - 1) >> 1) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_s(kt);
    issue_pv(kt - 1);
    draw_keep(kt);
    wgmma_wait<1>();  // S landed; P V may still run
    fence_regs(s);
    if (wg_leader) mbar_arrive(&k_free[kt & 1]);
    softmax(kt);
    wgmma_wait<0>();
    fence_regs(o);
    if (wg_leader) mbar_arrive(&v_free[(kt - 1) & 1]);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] *= al[(i >> 1) & 1];
    // P rounded to bf16 in registers as the next P V's A operand
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk) frag_to_a<T>(a[kk], s + 8 * kk);
  }
  if (n_kt > 0) {
    mbar_wait(&v_full[(n_kt - 1) & 1], ((n_kt - 1) >> 1) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_pv(n_kt - 1);
    wgmma_wait<0>();
    fence_regs(o);
  }

  const float lf0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float lf1 = fmaxf(quad_sum(l[1]), 1e-30f);
  // stage the output in the warp's own rows of Q (only its warpgroup's
  // products read them, and those are done)
  const long long obh = static_cast<long long>(bh) * Sq;
  store_rows<kD, kFwdBQ>(q_s, rb, o, lf0, lf1, out + obh * D, wq0, Sq, D,
                         lane);
  if (t4 == 0) {
    if (wq0 + g < Sq) lse[obh + wq0 + g] = m[0] + logf(lf0);
    if (wq0 + g + 8 < Sq) lse[obh + wq0 + g + 8] = m[1] + logf(lf1);
  }
}

// ------------------------------------------------------------------ dk/dv
template <typename T, int kD, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tg,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv,
                            int Sq, int Sk, int D, float scale, int causal,
                            AttnMask mask, DropoutParams drop) {
  constexpr int kKVBytes = kBwdBK * kD * 2;
  constexpr int kQBytes = kBwdBQ * kD * 2;
  extern __shared__ uint8_t smem_tc[];
  uint8_t* k_s = align1024(smem_tc);
  uint8_t* v_s = k_s + kKVBytes;
  uint8_t* q_s = v_s + kKVBytes;         // 2 stages
  uint8_t* g_s = q_s + 2 * kQBytes;      // 2 stages
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kQBytes);
  float* delta_s = lse_s + 2 * kBwdBQ;   // 2 stages each
  // with the mask: its tile for the q tile in hand (load_mask_tile)
  float* mask_s = delta_s + 2 * kBwdBQ;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      mask_s + (kMask ? kBwdBQ * kMaskStride : 0));
  // bar[0]: K and V; bar[1 + s]: Q and dO of stage s

  const int k0 = static_cast<int>(blockIdx.y) * kBwdBK;
  const int bh = static_cast<int>(blockIdx.x);
  const long long rbh = static_cast<long long>(bh) * Sq;
  const float* lb = lse + rbh;
  const float* db = delta + rbh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int rb = 16 * warp;             // the warp's keys in the tile
  const int wg_row = 64 * (warp >> 2);  // its warpgroup's
  const int wk0 = k0 + rb;
  const int offset = Sk - Sq;
  const int n_qt = (Sq + kBwdBQ - 1) / kBwdBQ;
  const int qt_first = causal ? max(0, k0 - offset) / kBwdBQ : 0;
  const float* mb = kMask ? mask_rows(mask, bh, Sq, Sk) : nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  auto load_q_tile = [&](int qt, int stage) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar[1 + stage], 2 * kQBytes);
      tma_tile<kD, kBwdBQ>(q_s + stage * kQBytes, &tq, &bar[1 + stage],
                           qt * kBwdBQ, bh);
      tma_tile<kD, kBwdBQ>(g_s + stage * kQBytes, &tg, &bar[1 + stage],
                           qt * kBwdBQ, bh);
    }
    load_row_values(lse_s + stage * kBwdBQ, lb, qt * kBwdBQ, Sq, 0, kBwdBQ);
    load_row_values(delta_s + stage * kBwdBQ, db, qt * kBwdBQ, Sq, kBwdBQ,
                    kBwdBQ);
  };
  if (qt_first < n_qt) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar[0], 2 * kKVBytes);
      tma_tile<kD, kBwdBK>(k_s, &tk, &bar[0], k0, bh);
      tma_tile<kD, kBwdBK>(v_s, &tv, &bar[0], k0, bh);
    }
    load_q_tile(qt_first, 0);
  }
  cp_commit();
  if (qt_first + 1 < n_qt) load_q_tile(qt_first + 1, 1);
  cp_commit();

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (qt_first < n_qt) mbar_wait(&bar[0], 0);

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int stage = (qt - qt_first) & 1;
    mbar_wait(&bar[1 + stage], ((qt - qt_first) >> 1) & 1);
    cp_wait_but_one();
    __syncthreads();  // lse and delta of this stage landed for every thread
    const uint8_t* qs = q_s + stage * kQBytes;
    const uint8_t* gs = g_s + stage * kQBytes;
    const float* ls = lse_s + stage * kBwdBQ;
    const float* ds = delta_s + stage * kBwdBQ;
    const int q0 = qt * kBwdBQ;

    // S^T = K Q^T and dP^T = V dO^T, the warpgroup's 64 keys x 64
    // queries each, issued together; this thread holds keys wk0 + gr
    // (elements 4 j, 4 j + 1) and wk0 + gr + 8 (4 j + 2, 4 j + 3), query
    // columns 8 j + 2 t4 (+1)
    float p[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(p, kmajor_desc<kBwdBK>(k_s, wg_row, kk),
                   kmajor_desc<kBwdBQ>(qs, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(dp, kmajor_desc<kBwdBK>(v_s, wg_row, kk),
                   kmajor_desc<kBwdBQ>(gs, 0, kk), kk > 0);
    wgmma_commit();
    // dropout's keep bits, drawn while S^T and dP^T are on the tensor cores
    const uint32_t keep =
        kDrop ? keep_bits_t(drop, bh, wk0 + gr, q0 + 2 * t4) : 0u;
    if constexpr (kMask) {
      // the mask tile, copied while they run (the last reads of the
      // buffer ended before the previous step's closing barrier)
      load_mask_tile<kBwdBQ, kBwdBK>(mask_s, mb, q0, k0, Sq, Sk);
      cp_commit();
      cp_wait_all();
      __syncthreads();
    }
    wgmma_wait<1>();  // S^T landed; dP^T may still run
    fence_regs(p);
    const bool masked = q0 + kBwdBQ > Sq || wk0 + 16 > Sk ||
                        (causal && wk0 + 15 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int key = wk0 + gr + ((i >> 1) & 1) * 8;
      float x = __fmul_rn(p[i], scale);
      if (masked && !visible(q0 + qi, key, Sq, Sk, offset, causal))
        x = kNegInf;
      if constexpr (kMask) x += mask_s[qi * kMaskStride + (key - k0)];
      p[i] = x <= kNegInf / 2 ? 0.f
                              : exp2_ftz(fmaf(x, kLog2e, -ls[qi] * kLog2e));
    }

    // dV += P^T dO with P^T (dropped, with dropout) rounded to bf16 in
    // registers, issued at once: dS^T is computed while it runs
    uint32_t a[kBwdBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk) {
      if constexpr (kDrop) {
        float pd[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pd[e] = keep_or_zero(p[8 * kk + e], keep, 8 * kk + e,
                               drop.rescale);
        frag_to_a<T>(a[kk], pd);
      } else {
        frag_to_a<T>(a[kk], p + 8 * kk);
      }
    }
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk)
      wgmma_rs<T, kD>(dv_acc, a[kk], mnmajor_desc<kBwdBQ>(gs, kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T landed; dV may still run
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta) scale, dP^T dropped with dropout and P^T
    // not
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float dpd =
          kDrop ? keep_or_zero(dp[i], keep, i, drop.rescale) : dp[i];
      dp[i] = __fmul_rn(__fmul_rn(p[i], dpd - ds[qi]), scale);
    }
    wgmma_wait<0>();  // dV is done with the P^T registers
    fence_regs(dv_acc);
    // dK += dS^T Q, dS^T rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk) frag_to_a<T>(a[kk], dp + 8 * kk);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk)
      wgmma_rs<T, kD>(dk_acc, a[kk], mnmajor_desc<kBwdBQ>(qs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);

    __syncthreads();  // both warpgroups are done with this stage
    if (qt + 2 < n_qt) load_q_tile(qt + 2, stage);
    cp_commit();
  }

  // nothing reads K or V any more (the loop ended on a barrier): stage there
  const long long kbh = static_cast<long long>(bh) * Sk;
  store_rows<kD, kBwdBK>(k_s, rb, dk_acc, 1.f, 1.f, dk + kbh * D, wk0, Sk,
                         D, lane);
  store_rows<kD, kBwdBK>(v_s, rb, dv_acc, 1.f, 1.f, dv + kbh * D, wk0, Sk,
                         D, lane);
}

// --------------------------------------------------------------------- dq
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <typename T, int kD, bool kMask, bool kDrop>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Sk, int D,
                           float scale, int causal, AttnMask mask,
                           DropoutParams drop) {
  constexpr int kQBytes = kFwdBQ * kD * 2;
  constexpr int kKBytes = kFwdBK * kD * 2;
  extern __shared__ uint8_t smem_tc[];
  uint8_t* q_s = align1024(smem_tc);
  uint8_t* g_s = q_s + kQBytes;
  uint8_t* k_s = g_s + kQBytes;          // 2 stages
  uint8_t* v_s = k_s + 2 * kKBytes;      // 2 stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + 2 * kKBytes);
  // bar[0]: Q and dO landed; bar[1 + s] / bar[3 + s]: K / V of stage s
  // landed; bar[5 + s] / bar[7 + s]: both warpgroups are done with K / V of
  // stage s
  uint64_t* qg_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 3;
  uint64_t* k_free = bar + 5;
  uint64_t* v_free = bar + 7;

  const int q0 =
      (static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)) *
      kFwdBQ;
  const int bh = static_cast<int>(blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int offset = Sk - Sq;
  int n_kt = (Sk + kFwdBK - 1) / kFwdBK;
  if (causal) {
    const int last_col = min(q0 + kFwdBQ, Sq) - 1 + offset;
    n_kt = last_col < 0 ? 0 : min(n_kt, last_col / kFwdBK + 1);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bar[i]);
    for (int i = 5; i < 9; ++i) mbar_init(&bar[i], 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWarps) {
    // the producer warpgroup: one thread loads Q and dO once, then V and K
    // of every tile, each into a stage as soon as both consumer warpgroups
    // have let go of it (V is let go one step before K, whose dQ product
    // runs a step later). The warpgroup hands its registers to the
    // consumers, whose S, dP, dS and dQ fragments need more than the 168
    // a thread that ptxas gives a 384-thread CTA. setmaxnreg moves them
    // through the CTA's own pool: the producers free 4 x 32 x (168 - 24) =
    // 18,432 and the consumers take 8 x 32 x (232 - 168) = 16,384 (taking
    // more than is freed would leave setmaxnreg.inc waiting forever).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kWarps && lane == 0 && n_kt > 0) {
      mbar_expect_tx(qg_full, 2 * kQBytes);
      tma_tile<kD, kFwdBQ>(q_s, &tq, qg_full, q0, bh);
      tma_tile<kD, kFwdBQ>(g_s, &tg, qg_full, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1;
        if (kt >= 2) mbar_wait(&v_free[st], ((kt >> 1) - 1) & 1);
        mbar_expect_tx(&v_full[st], kKBytes);
        tma_tile<kD, kFwdBK>(v_s + st * kKBytes, &tv, &v_full[st],
                             kt * kFwdBK, bh);
        if (kt >= 2) mbar_wait(&k_free[st], ((kt >> 1) - 1) & 1);
        mbar_expect_tx(&k_full[st], kKBytes);
        tma_tile<kD, kFwdBK>(k_s + st * kKBytes, &tk, &k_full[st],
                             kt * kFwdBK, bh);
      }
    }
  } else {
    // the consumers (one path to the end: setmaxnreg needs paths that never
    // reconverge)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2, t4 = lane & 3;
    const int wg = warp >> 2;
    const int rb = 16 * warp;      // the warp's rows in the tile
    const int wg_row = 64 * wg;    // its warpgroup's
    const int wq0 = q0 + rb;
    const bool wg_leader = (threadIdx.x & 127) == 0;
    const long long rbh = static_cast<long long>(bh) * Sq;
    // -lse log2 e and delta of this thread's rows wq0 + g and wq0 + g + 8
    float nl[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wq0 + g + 8 * h;
      nl[h] = row < Sq ? -(lse[rbh + row] * kLog2e) : 0.f;
      dl[h] = row < Sq ? delta[rbh + row] : 0.f;
    }

    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t a[kFwdBK / 16][4];  // dS of the last tile, the A operand of dS K
    const float* mb = kMask ? mask_rows(mask, bh, Sq, Sk) : nullptr;
    uint32_t keep = 0;  // dropout's keep bits of the tile in hand
    // drawn before the tile's products are issued: with S, dP and dQ in
    // flight the consumers have no registers left for Philox, and ptxas
    // serialises the wgmmas (C7511)
    auto draw_keep = [&](int kt) {
      if constexpr (kDrop) keep = keep_bits(drop, bh, wq0 + g,
                                            kt * kFwdBK + 2 * t4);
    };
    // S = Q K^T and dP = dO V^T of tile kt, the warpgroup's 64 rows x 64 keys
    auto issue_s_dp = [&](int kt) {
      const uint8_t* ks = k_s + (kt & 1) * kKBytes;
      const uint8_t* vs = v_s + (kt & 1) * kKBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64<T>(s, kmajor_desc<kFwdBQ>(q_s, wg_row, kk),
                     kmajor_desc<kFwdBK>(ks, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64<T>(dp, kmajor_desc<kFwdBQ>(g_s, wg_row, kk),
                     kmajor_desc<kFwdBK>(vs, 0, kk), kk > 0);
      wgmma_commit();
    };
    // dQ += dS K of tile kt, dS from registers, K as an MN-major B
    auto issue_dq = [&](int kt) {
      const uint8_t* ks = k_s + (kt & 1) * kKBytes;
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk)
        wgmma_rs<T, kD>(acc, a[kk], mnmajor_desc<kFwdBK>(ks, kk));
      wgmma_commit();
    };
    // s -> p = exp(s scale - lse), an exact 0 where masked; this thread
    // holds rows wq0 + g (elements 4 j, 4 j + 1) and wq0 + g + 8 (4 j + 2,
    // 4 j + 3), key columns k0 + 8 j + 2 t4 (+1)
    auto probs = [&](int kt) {
      const int k0 = kt * kFwdBK;
      const bool masked = wq0 + 16 > Sq || k0 + kFwdBK > Sk ||
                          (causal && k0 + kFwdBK - 1 > wq0 + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float x = __fmul_rn(s[i], scale);
        if (masked && !visible(wq0 + g + 8 * h, k0 + 8 * (i >> 2) + 2 * t4 +
                                                    (i & 1),
                               Sq, Sk, offset, causal))
          x = kNegInf;
        // (the plain instantiation keeps its one loop: same machine code)
        if constexpr (kMask)
          s[i] = x;
        else
          s[i] = x <= kNegInf / 2 ? 0.f : exp2_ftz(fmaf(x, kLog2e, nl[h]));
      }
      if constexpr (kMask) {
        add_mask_frag(s, mb, wq0 + g, k0 + 2 * t4, Sq, Sk);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          s[i] = s[i] <= kNegInf / 2 ? 0.f
                                     : exp2_ftz(fmaf(s[i], kLog2e, nl[h]));
        }
      }
    };
    // dp -> ds = p (dp - delta) scale, dp dropped with dropout
    auto dsoft = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float dpd =
            kDrop ? keep_or_zero(dp[i], keep, i, drop.rescale) : dp[i];
        dp[i] = __fmul_rn(__fmul_rn(s[i], dpd - dl[(i >> 1) & 1]), scale);
      }
    };

    if (n_kt > 0) {
      mbar_wait(qg_full, 0);
      mbar_wait(&k_full[0], 0);
      mbar_wait(&v_full[0], 0);
      draw_keep(0);
      wgmma_fence();
      issue_s_dp(0);
      wgmma_wait<1>();  // S landed; dP may still run
      fence_regs(s);
      probs(0);
      wgmma_wait<0>();
      fence_regs(dp);
      if (wg_leader) mbar_arrive(&v_free[0]);
      dsoft();
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk) frag_to_a<T>(a[kk], dp + 8 * kk);
    }
    // Tile kt's S and dP are issued together with tile kt-1's dS K, so the
    // probabilities and dS of tile kt are computed while dS K runs.
    for (int kt = 1; kt < n_kt; ++kt) {
      mbar_wait(&k_full[kt & 1], (kt >> 1) & 1);
      mbar_wait(&v_full[kt & 1], (kt >> 1) & 1);
      draw_keep(kt);
      fence_regs(acc);
      wgmma_fence();
      issue_s_dp(kt);
      issue_dq(kt - 1);
      wgmma_wait<2>();  // S landed
      fence_regs(s);
      probs(kt);
      wgmma_wait<1>();  // dP landed; dS K of tile kt-1 may still run
      fence_regs(dp);
      if (wg_leader) mbar_arrive(&v_free[kt & 1]);
      dsoft();
      wgmma_wait<0>();  // dS K is done with K of tile kt-1 and the registers
      fence_regs(acc);
      fence_frags(a);
      if (wg_leader) mbar_arrive(&k_free[(kt - 1) & 1]);
      // dS rounded to bf16 in registers as the next dS K's A operand
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk) frag_to_a<T>(a[kk], dp + 8 * kk);
    }
    if (n_kt > 0) {
      fence_regs(acc);
      wgmma_fence();
      issue_dq(n_kt - 1);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // stage dQ in the warp's own rows of Q (only its warpgroup's products
    // read them, and those are done)
    store_rows<kD, kFwdBQ>(q_s, rb, acc, 1.f, 1.f, dq + rbh * D, wq0, Sq, D,
                           lane);
  }
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (no link against libcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn load_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t rc = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                           cudaEnableDefault, &found);
#endif
  if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// TMA's data type of an element type
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The TMA map of a [BH, S, D] tensor of T (2 bytes) read in boxes of 64
// columns x `rows` rows of one batch*head, 128-byte swizzled; reads past S
// or D fill zeros.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
             int rows) {
  static const EncodeTiledFn encode = load_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tma_type<T>(), 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int kD, bool kMask, bool kDrop, typename T = bf16>
int fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Sq, int Sk, int D, float scale, int causal,
           AttnMask mask, DropoutParams drop, cudaStream_t s) {
  constexpr size_t smem = 1024 + (kFwdBQ + 4 * kFwdBK) * kD * 2 + 9 * 8;
  const int n_qt = (Sq + kFwdBQ - 1) / kFwdBQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_map<T>(&tq, q, BH, Sq, D, kFwdBQ);
  if (!rc) rc = make_map<T>(&tk, k, BH, Sk, D, kFwdBK);
  if (!rc) rc = make_map<T>(&tv, v, BH, Sk, D, kFwdBK);
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_kernel_tc<T, kD, kMask, kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc) return rc;
  flash_fwd_kernel_tc<T, kD, kMask, kDrop>
      <<<dim3(BH, n_qt), kFwdThreads, smem, s>>>(
          tq, tk, tv, static_cast<T*>(out), static_cast<float*>(lse), Sq,
          Sk, D, scale, causal, mask, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kMask, bool kDrop, typename T = bf16>
int bwd_dkv_tc(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dk, void* dv,
               int BH, int Sq, int Sk, int D, float scale, int causal,
               AttnMask mask, DropoutParams drop, cudaStream_t s) {
  constexpr size_t smem =
      1024 + (2 * kBwdBK + 4 * kBwdBQ) * kD * 2 +
      (4 * kBwdBQ + (kMask ? kBwdBQ * kMaskStride : 0)) * sizeof(float) +
      3 * 8;
  const int n_kt = (Sk + kBwdBK - 1) / kBwdBK;
  if (n_kt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tg;
  int rc = make_map<T>(&tq, q, BH, Sq, D, kBwdBQ);
  if (!rc) rc = make_map<T>(&tg, g, BH, Sq, D, kBwdBQ);
  if (!rc) rc = make_map<T>(&tk, k, BH, Sk, D, kBwdBK);
  if (!rc) rc = make_map<T>(&tv, v, BH, Sk, D, kBwdBK);
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_tc<T, kD, kMask, kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc) return rc;
  flash_bwd_dkv_kernel_tc<T, kD, kMask, kDrop>
      <<<dim3(BH, n_kt), kThreads, smem, s>>>(
          tq, tk, tv, tg, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Sk, D, scale, causal, mask, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kMask, bool kDrop, typename T = bf16>
int bwd_dq_tc(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* delta, void* dq, int BH, int Sq,
              int Sk, int D, float scale, int causal, AttnMask mask,
              DropoutParams drop, cudaStream_t s) {
  constexpr size_t smem = 1024 + (2 * kFwdBQ + 4 * kFwdBK) * kD * 2 + 9 * 8;
  const int n_qt = (Sq + kFwdBQ - 1) / kFwdBQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tg;
  int rc = make_map<T>(&tq, q, BH, Sq, D, kFwdBQ);
  if (!rc) rc = make_map<T>(&tg, g, BH, Sq, D, kFwdBQ);
  if (!rc) rc = make_map<T>(&tk, k, BH, Sk, D, kFwdBK);
  if (!rc) rc = make_map<T>(&tv, v, BH, Sk, D, kFwdBK);
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dq_kernel_tc<T, kD, kMask, kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc) return rc;
  flash_bwd_dq_kernel_tc<T, kD, kMask, kDrop>
      <<<dim3(BH, n_qt), kDqThreads, smem, s>>>(
          tq, tk, tv, tg, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk,
          D, scale, causal, mask, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The variant's instantiation over the element type T: the mask, dropout
// or neither (the one the train step runs), at a padded head dim of 64 or
// 128.
#define PDTT_TC_VARIANT(fn, kD, T, ...)                                \
  do {                                                                \
    if (mask.ptr) return fn<kD, true, false, T>(__VA_ARGS__);         \
    if (dropout) return fn<kD, false, true, T>(__VA_ARGS__);          \
    return fn<kD, false, false, T>(__VA_ARGS__);                      \
  } while (0)
#define PDTT_TC_DISPATCH(fn, T, ...)                                  \
  do {                                                                \
    if (D <= 64) PDTT_TC_VARIANT(fn, 64, T, __VA_ARGS__);             \
    PDTT_TC_VARIANT(fn, 128, T, __VA_ARGS__);                         \
  } while (0)

// bf16 and fp16 launchers for flash_attention.cu's entry points (declared
// in flash_attention.cuh); pointers must be 16-byte aligned (the wrapper
// checks). Each returns cudaGetLastError().
int flash_fwd_bf16_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int BH, int Sq, int Sk, int D, float scale,
                      int causal, AttnMask mask, DropoutParams drop,
                      bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(fwd_tc, bf16, q, k, v, out, lse, BH, Sq, Sk, D, scale,
                   causal, mask, drop, s);
}

int flash_bwd_dkv_bf16_tc(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int BH, int Sq, int Sk, int D,
                          float scale, int causal, AttnMask mask,
                          DropoutParams drop, bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(bwd_dkv_tc, bf16, q, k, v, g, lse, delta, dk, dv, BH, Sq,
                   Sk, D, scale, causal, mask, drop, s);
}

int flash_bwd_dq_bf16_tc(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, int BH, int Sq, int Sk, int D, float scale,
                         int causal, AttnMask mask, DropoutParams drop,
                         bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(bwd_dq_tc, bf16, q, k, v, g, lse, delta, dq, BH, Sq, Sk,
                   D, scale, causal, mask, drop, s);
}

// fp16 (AMP or pure training in float16): the same kernels over __half,
// with the mask and dropout variants too.
int flash_fwd_fp16_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int BH, int Sq, int Sk, int D, float scale,
                      int causal, AttnMask mask, DropoutParams drop,
                      bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(fwd_tc, __half, q, k, v, out, lse, BH, Sq, Sk, D, scale,
                   causal, mask, drop, s);
}

int flash_bwd_dkv_fp16_tc(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int BH, int Sq, int Sk, int D,
                          float scale, int causal, AttnMask mask,
                          DropoutParams drop, bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(bwd_dkv_tc, __half, q, k, v, g, lse, delta, dk, dv, BH,
                   Sq, Sk, D, scale, causal, mask, drop, s);
}

int flash_bwd_dq_fp16_tc(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, int BH, int Sq, int Sk, int D, float scale,
                         int causal, AttnMask mask, DropoutParams drop,
                         bool dropout, cudaStream_t s) {
  PDTT_TC_DISPATCH(bwd_dq_tc, __half, q, k, v, g, lse, delta, dq, BH, Sq,
                   Sk, D, scale, causal, mask, drop, s);
}
