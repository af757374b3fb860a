// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; Random123's constants and round order) and the dropout
// keep-mask of the flash-attention kernels, which takes the place of the
// TPU PRNG that paddle_tpu/ops/attention.py::_block_keep seeds per tile.
//
// Contract, kept bit for bit by ops/attention.py::dropout_keep_mask (its
// plain twin): element (bh = b*H + h, query row i, key column j) is kept
// when word j & 3 of Philox4x32-10(counter = (j >> 2, i, bh, 0),
// key = (seed & 0xffffffff, seed >> 32)) is >= threshold = int(p *
// (2^32 - 1)). Keyed per element, not per tile, so the forward, dq and
// dk/dv kernels, whatever their tiling, and the bf16 and fp32 routes all
// draw the same bit for (bh, i, j).
#pragma once

#include <cstdint>

struct DropoutParams {
  uint32_t key0, key1;  // the seed's low and high words
  uint32_t threshold;   // a word below it drops its element
  float rescale;        // 1 / (1 - p), rounded to fp32 once
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// keep bit of column j of query row i
__device__ __forceinline__ bool dropout_keep(const DropoutParams& d,
                                             uint32_t bh, uint32_t i,
                                             uint32_t j) {
  const uint4 w = philox4x32_10(make_uint4(j >> 2, i, bh, 0u), d.key0,
                                d.key1);
  const uint32_t x = (j & 2) ? ((j & 1) ? w.w : w.z)
                             : ((j & 1) ? w.y : w.x);
  return x >= d.threshold;
}

// The host side: seed and p as the wrapper passes them.
inline DropoutParams make_dropout_params(unsigned long long seed,
                                         double p) {
  DropoutParams d;
  d.key0 = static_cast<uint32_t>(seed & 0xffffffffull);
  d.key1 = static_cast<uint32_t>(seed >> 32);
  d.threshold = static_cast<uint32_t>(p * 4294967295.0);
  d.rescale = static_cast<float>(1.0 / (1.0 - p));
  return d;
}
