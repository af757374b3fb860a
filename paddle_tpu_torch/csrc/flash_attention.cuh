// Declarations shared by flash_attention.cu (the C entry points and the
// fp32 kernels) and flash_attention_tc.cu (the bf16 and fp16 tensor-core
// kernels): the mask and dropout variants' arguments and the launchers.
#pragma once

#include <cuda_runtime.h>

#include "philox.cuh"

// The additive mask of paddle_tpu/ops/attention.py::_apply_mask_block, as
// ops/attention.py::_mask_3d lays it out: fp32 rows [rows, Sq, Sk], batch*
// head bh reading row bh / row_div. ptr == nullptr: no mask.
struct AttnMask {
  const float* ptr;
  int row_div;
};

// Returns fn<first, kMask, kDrop>(...) for the variant the caller's `mask`
// (AttnMask) and `dropout` (bool) select: mask.ptr, dropout_p > 0 (never
// both) or neither. The fp32 entry points dispatch through it;
// flash_attention_tc.cu's launchers take the same rule over the element
// type (PDTT_TC_VARIANT).
#define PDTT_VARIANT_RETURN(fn, first, ...)                     \
  do {                                                          \
    if (mask.ptr) return fn<first, true, false>(__VA_ARGS__);   \
    if (dropout) return fn<first, false, true>(__VA_ARGS__);    \
    return fn<first, false, false>(__VA_ARGS__);                \
  } while (0)

// bf16 launchers (flash_attention_tc.cu). A variant is chosen by which of
// mask.ptr and dropout_p > 0 is set (never both); neither selects the
// instantiation the train step runs. Each returns cudaGetLastError().
int flash_fwd_bf16_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int BH, int Sq, int Sk, int D, float scale,
                      int causal, AttnMask mask, DropoutParams drop,
                      bool dropout, cudaStream_t s);
int flash_bwd_dq_bf16_tc(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, int BH, int Sq, int Sk, int D, float scale,
                         int causal, AttnMask mask, DropoutParams drop,
                         bool dropout, cudaStream_t s);
int flash_bwd_dkv_bf16_tc(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int BH, int Sq, int Sk, int D,
                          float scale, int causal, AttnMask mask,
                          DropoutParams drop, bool dropout, cudaStream_t s);

// fp16 launchers (flash_attention_tc.cu): the same tensor-core kernels
// over __half, their variants chosen as the bf16 ones'. Each returns
// cudaGetLastError().
int flash_fwd_fp16_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int BH, int Sq, int Sk, int D, float scale,
                      int causal, AttnMask mask, DropoutParams drop,
                      bool dropout, cudaStream_t s);
int flash_bwd_dq_fp16_tc(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, int BH, int Sq, int Sk, int D, float scale,
                         int causal, AttnMask mask, DropoutParams drop,
                         bool dropout, cudaStream_t s);
int flash_bwd_dkv_fp16_tc(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int BH, int Sq, int Sk, int D,
                          float scale, int causal, AttnMask mask,
                          DropoutParams drop, bool dropout, cudaStream_t s);
