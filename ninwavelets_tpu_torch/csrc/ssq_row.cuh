// The coefficient row W of synchrosqueezing and its power, shared by the
// noise gate's peaks ("amax", fused_cwt.cu: fused_amax_kernel) and the
// reassignment (fused_ssq.cu: fused_ssq_kernel).
//
// The reassignment gates each cell on p >= rel_threshold x the peak that
// "amax" found, so at rel_threshold = 1 the peak cell must pass its own
// gate: both kernels must form the same p bit for bit.  They do, because
// both build W from these functions on the same core (fft_regs.cuh: the
// same Plan<LOG2N>, the same twiddle table), and every operation here and
// there is an explicitly rounded intrinsic, so nvcc contracts nothing
// differently in the two kernels:
//     S[k] = spec[k] x (bank[k] / N)    for k < K (= N/2), 0 above
//     W    = the core's inverse DFT of S  (the 1/N is exact: N = 2^LOG2N)
//     p    = Re(W)^2 + Im(W)^2, each square and the sum rounded on its own.
#pragma once

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace ssq {

// A bank value scaled by 1/N.
__device__ __forceinline__ float bank_scale(float b, float inv_n) {
  return __fmul_rn(b, inv_n);
}

// Bin k of the bank row, scaled by 1/N; 0 at k >= k_bins.
__device__ __forceinline__ float scaled_bank(const float* bank_row, int k,
                                             int k_bins, float inv_n) {
  return k < k_bins ? bank_scale(bank_row[k], inv_n) : 0.f;
}

// Stage 0 of W for one bin: spec x scaled bank.  At k >= k_bins it is
// (+0, +0): "amax" loads a bin of 0 there (fft_regs::load_bins) and meets
// a bank value of 0; fused_ssq.cu writes the zero itself.
__device__ __forceinline__ float2 stage0(float2 bin, float scaled) {
  return fft_regs::bank_times_rn(bin, scaled);
}

// |w|^2, rounded as numpy rounds w.real * w.real + w.imag * w.imag in
// float32.
__device__ __forceinline__ float power(float2 w) {
  return __fadd_rn(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y));
}

}  // namespace ssq
