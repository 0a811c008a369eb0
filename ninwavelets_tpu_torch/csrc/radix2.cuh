// In-place radix-2 FFT passes over n = 2^log2n complex samples in shared
// memory, shared by the forward (fused_cwt.cu) and backward
// (fused_cwt_bwd.cu) kernels.
//
// `tw` holds the n/2 twiddles exp(+2 pi i m / n) (computed on the host in
// float64, stored float32).  Pass s (1 <= s <= log2n) combines pairs
// half = 2^(s-1) apart inside blocks of 2^s samples; the threads of the
// block split the n/2 butterflies of a pass, and the caller puts a
// __syncthreads() between passes.
//
//  * radix2_dit_pass: decimation in time with exp(+...) twiddles.  Passes
//    s = 1 .. log2n on bit-reversed input give the unnormalised INVERSE DFT
//    in natural order.
//  * radix2_dif_pass: decimation in frequency with the conjugate twiddles.
//    Passes s = log2n .. 1 on natural-order input give the FORWARD DFT in
//    bit-reversed order: bin k sits at __brev(k) >> (32 - log2n).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ void radix2_dit_pass(float2* buf, const float2* tw,
                                                int s, int log2n, int tid,
                                                int threads) {
  const int half_n = 1 << (log2n - 1);
  const int half = 1 << (s - 1);
  const int tw_shift = log2n - s;
  for (int j = tid; j < half_n; j += threads) {
    const int pos = j & (half - 1);
    const int i0 = ((j >> (s - 1)) << s) + pos;
    const int i1 = i0 + half;
    const float2 a = buf[i0];
    const float2 t = cmul(buf[i1], tw[pos << tw_shift]);
    buf[i0] = make_float2(a.x + t.x, a.y + t.y);
    buf[i1] = make_float2(a.x - t.x, a.y - t.y);
  }
}

__device__ __forceinline__ void radix2_dif_pass(float2* buf, const float2* tw,
                                                int s, int log2n, int tid,
                                                int threads) {
  const int half_n = 1 << (log2n - 1);
  const int half = 1 << (s - 1);
  const int tw_shift = log2n - s;
  for (int j = tid; j < half_n; j += threads) {
    const int pos = j & (half - 1);
    const int i0 = ((j >> (s - 1)) << s) + pos;
    const int i1 = i0 + half;
    const float2 a = buf[i0];
    const float2 b = buf[i1];
    buf[i0] = make_float2(a.x + b.x, a.y + b.y);
    buf[i1] = cmul_conj(make_float2(a.x - b.x, a.y - b.y), tw[pos << tw_shift]);
  }
}
