// Fused Adam / AdamW update for Hopper (sm_90a), built by ops/_kernels.py
// into the port's kernel library and bound with ctypes.
//
// Replaces: paddle_tpu/ops/fused_adam.py::_adam_kernel (launched by
// fused_adam), the TPU kernel that walks a parameter viewed as (rows, 128)
// lane tiles and updates p, moment1 and moment2 in one pass with fp32
// math, reading lr, beta1^t and beta2^t from SMEM scalars so a schedule
// never retraces. Its (rows, 128) tiling, the rows % 8 main part, the XLA
// epilogue for the last < 1152 elements and the n >= 1024 threshold are
// TPU layout rules and are not carried over: this kernel takes any n.
//
// What bounds it on this card: bytes. Per element it reads p, g, m1 and m2
// and writes p, m1 and m2 (with a master weight it reads the fp32 master
// in p's place and writes both) and does about 15 fp32 operations, far
// below the ~295 operations per byte where the card's arithmetic would
// become the limit. With bf16 (or fp16) p and g the least time is 22 bytes
// an element (fp32 moments) or 14 (16-bit moments) over 3.35 TB/s;
// pure-fp16 training (fp16 p and g, fp32 master and moments) moves 28.
//
// Types: p, g and the two moments each fp32, bf16 or fp16 (the JAX kernel
// takes any float dtype and computes in fp32), every combination
// instantiated; an fp32 master weight beside a bf16 or fp16 p
// (multi_precision).
//
// Design: one flat pass, a grid-stride loop. Each thread takes 8
// consecutive elements at a time with 16-byte loads and stores (one word of
// bf16 or fp16, two of fp32) when every pointer is 16-byte aligned, and the
// rest (the ragged tail, or everything when a pointer is not aligned) one
// element at a time. Each element is read and written by one thread only,
// so p, m1, m2 and the master are updated in place. lr, beta1^t and beta2^t
// are read from device memory (the TPU kernel's SMEM scalars): the caller
// stages them on the device, and the update stays replayable by a CUDA
// graph. The beta powers are advanced by the caller before the launch, not
// here: a block that wrote them back would race with blocks still reading.
// An optional device flag (do_update, one byte) is read the same way: where
// it is 0 every thread returns at once and p, m1, m2 and the master stay
// bit for bit as they were. That is the train step's skipped update (an
// fp16 overflow, or a gradient-merge step that banks), decided on the
// device with no host sync; the caller gates the beta powers' advance by
// the same flag. A null flag updates unconditionally, as before.
//
// Same result as the plain version (ops/fused_adam.py::adam_math): the
// arithmetic runs in fp32 in _adam_math's exact order, every operation an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so the compiler contracts nothing into an FMA. PyTorch's
// elementwise kernels round every operation alike, so fp32 outputs equal
// the plain version on the card bit for bit; bf16 and fp16 outputs (p, or
// moments kept in 16 bits) are one round-to-nearest-even of the same fp32
// value.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements per vector step
constexpr long long kMaxBlocks = 132 * 8;   // 8 blocks on each of 132 SMs

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
  return __float2bfloat16(v);  // round to nearest even, like .to(bf16)
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);  // round to nearest even, like .to(fp16)
}

// kVec consecutive elements as 16-byte words (src 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float (&dst)[kVec]) {
  constexpr int kPerWord = 16 / sizeof(T);
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int w = 0; w < kVec / kPerWord; ++w) {
    union {
      uint4 word;
      T e[kPerWord];
    } u;
    u.word = s[w];
#pragma unroll
    for (int j = 0; j < kPerWord; ++j) dst[w * kPerWord + j] = to_float(u.e[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float (&src)[kVec]) {
  constexpr int kPerWord = 16 / sizeof(T);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int w = 0; w < kVec / kPerWord; ++w) {
    union {
      uint4 word;
      T e[kPerWord];
    } u;
#pragma unroll
    for (int j = 0; j < kPerWord; ++j)
      u.e[j] = from_float<T>(src[w * kPerWord + j]);
    d[w] = u.word;
  }
}

struct AdamConsts {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - beta, rounded on the host
  int decoupled;
};

// _adam_math for one element: returns the new p (fp32); m1 and m2 are
// replaced by their new fp32 values. omb1p = 1 - beta1^t, omb2p likewise.
__device__ __forceinline__ float adam_elem(float p32, float g, float& m1,
                                           float& m2, float lr, float omb1p,
                                           float omb2p, const AdamConsts& c) {
  if (!c.decoupled) g = __fadd_rn(g, __fmul_rn(c.wd, p32));
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(__fmul_rn(c.omb2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(m1, omb1p),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(m2, omb2p)), c.eps));
  if (c.decoupled) upd = __fadd_rn(upd, __fmul_rn(c.wd, p32));
  return __fsub_rn(p32, __fmul_rn(lr, upd));
}

// P: parameter, G: gradient, M: both moments; kMaster: an fp32 master
// weight is read, updated and written, and p is written from it.
template <typename P, typename G, typename M, bool kMaster>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(P* __restrict__ p, const G* __restrict__ g,
                      M* __restrict__ m1, M* __restrict__ m2,
                      float* __restrict__ master,
                      const float* __restrict__ lr_ptr,
                      const float* __restrict__ b1p_ptr,
                      const float* __restrict__ b2p_ptr,
                      const uint8_t* __restrict__ do_update, long long n,
                      long long n_vec, AdamConsts c) {
  if (do_update != nullptr && *do_update == 0) return;
  const float lr = *lr_ptr;
  const float omb1p = __fsub_rn(1.f, *b1p_ptr);
  const float omb2p = __fsub_rn(1.f, *b2p_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;

  for (long long v = tid; v < n_vec; v += stride) {
    const long long i = v * kVec;
    float pv[kVec], gv[kVec], m1v[kVec], m2v[kVec];
    if constexpr (kMaster) {
      load_vec(master + i, pv);
    } else {
      load_vec(p + i, pv);
    }
    load_vec(g + i, gv);
    load_vec(m1 + i, m1v);
    load_vec(m2 + i, m2v);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      pv[j] = adam_elem(pv[j], gv[j], m1v[j], m2v[j], lr, omb1p, omb2p, c);
    store_vec(p + i, pv);
    if constexpr (kMaster) store_vec(master + i, pv);
    store_vec(m1 + i, m1v);
    store_vec(m2 + i, m2v);
  }
  for (long long i = n_vec * kVec + tid; i < n; i += stride) {
    float a = to_float(m1[i]);
    float b = to_float(m2[i]);
    float p32;
    if constexpr (kMaster) {
      p32 = master[i];
    } else {
      p32 = to_float(p[i]);
    }
    const float np = adam_elem(p32, to_float(g[i]), a, b, lr, omb1p, omb2p, c);
    p[i] = from_float<P>(np);
    if constexpr (kMaster) master[i] = np;
    m1[i] = from_float<M>(a);
    m2[i] = from_float<M>(b);
  }
}

struct AdamBuffers {
  void* p;
  const void* g;
  void* m1;
  void* m2;
  float* master;
  const float* lr;
  const float* b1p;
  const float* b2p;
  const uint8_t* do_update;
  long long n;
};

template <typename P, typename G, typename M, bool kMaster>
int launch(const AdamBuffers& b, const AdamConsts& c, cudaStream_t s) {
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(b.p) | reinterpret_cast<uintptr_t>(b.g) |
      reinterpret_cast<uintptr_t>(b.m1) | reinterpret_cast<uintptr_t>(b.m2) |
      reinterpret_cast<uintptr_t>(b.master);
  const long long n_vec = (any % 16 == 0) ? b.n / kVec : 0;
  const long long rest = b.n - n_vec * kVec;
  const long long work = n_vec > rest ? n_vec : rest;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fused_adam_kernel<P, G, M, kMaster>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<P*>(b.p), static_cast<const G*>(b.g),
          static_cast<M*>(b.m1), static_cast<M*>(b.m2), b.master, b.lr,
          b.b1p, b.b2p, b.do_update, b.n, n_vec, c);
  return static_cast<int>(cudaGetLastError());
}

// A master weight only beside a 16-bit parameter (multi_precision).
template <typename P, typename G, typename M>
int dispatch_master(const AdamBuffers& b, const AdamConsts& c,
                    cudaStream_t s) {
  if (b.master == nullptr) return launch<P, G, M, false>(b, c, s);
  if constexpr (!std::is_same<P, float>::value) {
    return launch<P, G, M, true>(b, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename P, typename G>
int dispatch_m(int m_dtype, const AdamBuffers& b, const AdamConsts& c,
               cudaStream_t s) {
  if (m_dtype == 0) return dispatch_master<P, G, float>(b, c, s);
  if (m_dtype == 1) return dispatch_master<P, G, __nv_bfloat16>(b, c, s);
  if (m_dtype == 2) return dispatch_master<P, G, __half>(b, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
int dispatch_g(int g_dtype, int m_dtype, const AdamBuffers& b,
               const AdamConsts& c, cudaStream_t s) {
  if (g_dtype == 0) return dispatch_m<P, float>(m_dtype, b, c, s);
  if (g_dtype == 1) return dispatch_m<P, __nv_bfloat16>(m_dtype, b, c, s);
  if (g_dtype == 2) return dispatch_m<P, __half>(m_dtype, b, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// p, g, m1, m2 (and the optional fp32 master of a bf16 or fp16 p, or null)
// of n elements each, contiguous; dtype codes 0 = float32, 1 = bfloat16,
// 2 = float16 for p, g and the two moments; lr, b1p, b2p: one fp32 each
// in device memory (b1p = beta1^t already advanced for this step).
// omb1 = 1 - b1 and omb2 = 1 - b2 are rounded to fp32 by the caller.
// do_update: one byte in device memory (a torch.bool) or null; 0 leaves
// everything untouched. Updates p, m1, m2 and the master in place.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int pdtt_fused_adam(void* p, const void* g, void* m1, void* m2,
                               void* master, const void* lr, const void* b1p,
                               const void* b2p, const void* do_update,
                               long long n, float b1,
                               float omb1, float b2, float omb2, float eps,
                               float wd, int decoupled, int p_dtype,
                               int g_dtype, int m_dtype, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const AdamBuffers b{p, g, m1, m2, static_cast<float*>(master),
                      static_cast<const float*>(lr),
                      static_cast<const float*>(b1p),
                      static_cast<const float*>(b2p),
                      static_cast<const uint8_t*>(do_update), n};
  const AdamConsts c{b1, omb1, b2, omb2, eps, wd, decoupled};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0) return dispatch_g<float>(g_dtype, m_dtype, b, c, s);
  if (p_dtype == 1)
    return dispatch_g<__nv_bfloat16>(g_dtype, m_dtype, b, c, s);
  if (p_dtype == 2) return dispatch_g<__half>(g_dtype, m_dtype, b, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
