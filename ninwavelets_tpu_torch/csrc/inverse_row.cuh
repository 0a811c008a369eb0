// Stage 0 and the inverse FFT of one (signal, bank row) pair, shared by the
// forward reductions (fused_cwt.cu) and the synchrosqueezing kernel
// (fused_ssq.cu), so that every kernel computes a coefficient row through
// the identical code path.
//
// `stage0(i, k)` returns the spectrum value of bin k (k = tid + i * threads,
// k < k_bins): bank x spectrum for the coefficients, times i 2 pi nu for
// their time derivative.  It is stored bit-reversed, bins k >= k_bins as 0,
// then the radix-2 decimation-in-time passes run; on return buf holds x[n]
// in natural order.  The caller stages `tw` first; the barrier after stage
// 0 publishes it too.
#pragma once

#include <cuda_runtime.h>

#include "radix2.cuh"

template <int PER, typename Stage0>
__device__ __forceinline__ void inverse_row(float2* buf, const float2* tw,
                                            Stage0 stage0, int k_bins,
                                            int log2n, int tid, int threads) {
  const int rev_shift = 32 - log2n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * threads;
    buf[__brev(k) >> rev_shift] =
        k < k_bins ? stage0(i, k) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  for (int s = 1; s <= log2n; ++s) {
    radix2_dit_pass(buf, tw, s, log2n, tid, threads);
    __syncthreads();
  }
}

// bank x spectrum for one bin, the product every stage 0 starts from.
__device__ __forceinline__ float2 bank_times(float2 s, float b) {
  return make_float2(s.x * b, s.y * b);
}
