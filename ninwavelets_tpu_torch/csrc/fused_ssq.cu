// Fused synchrosqueezing for Hopper (sm_90a): the coefficients and their
// time derivative, the instantaneous frequency, the row map, the noise gate
// and the reassignment, summed over epochs, for a real (F, N) bank on the
// analytic path (bins k < N/2).
//
// Replaces the Pallas TPU kernel ninwavelets_tpu/ops/fused.py:_ssq_kernel
// (launched by _fused_ssq_call).
//
// What it computes, for every signal (e, c), bank row f and sample n, with
// the bank folded 1/N (so p is at the plain path's 1/N^2 scale):
//     S      = spec[e, c, k] * bank[f, k] / N                    (k < N/2)
//     W[n]   = sum_k S[k] exp(+2 pi i k n / N)
//     dW[n]  = sum_k (i 2 pi nu_k S[k]) exp(+2 pi i k n / N),  2 pi nu_k = nu_scale * k
//     p      = |W|^2
//     omega  = Im(dW conj W) / (2 pi max(p, 1e-30))               (Hz)
//     row    = clip(ceil((omega - e0) / step), 0, F - 1)          "lin"
//              omega > 0 ? clip(ceil((log omega - e0) / step)) : 0 "log"
//     row    = f where p < floors[c, e]                           (noise gate)
//     out[c, row, n] += p, summed over e                          (wrapper: / E)
// as ninwavelets_tpu/ops/sst.py:_reassigned_power does with a closed-form
// ("lin" / "log") row map.  `out` is zero-filled by the wrapper; floors are
// the per-(epoch, channel) gates from the "amax" epilogue of fused_cwt.cu.
//
// What bounds it on this card: each (f, c) block runs 2 E in-place radix-2
// inverse FFTs in shared memory, log2(N) passes with a barrier each, twice
// the work of the "power" reduction; then E N scattered float atomics.
//
// What the design does about it:
//  * Grid (F, C), the epochs looped inside the block, as for the reductions
//    in fused_cwt.cu: blocks in flight share one channel's spectra in L2, and
//    a ragged epoch count needs no chunking or padding.
//  * Both transforms go through inverse_row.cuh, the same stage 0 + radix-2
//    code as the "amax" epilogue, so p here is p there bit for bit and the
//    peak cell of every (epoch, channel) passes its own floor.
//  * W stays in registers between the two transforms (PER float2 a
//    thread), so the block needs only the 12 N bytes of shared memory of
//    the reductions and N runs up to 16384.  The bank row is re-read through
//    the read-only cache at each stage 0 rather than held in registers, and
//    nu is computed from k on the fly.
//  * The reassignment is a float atomicAdd (a RED, the result unused) into
//    the (C, F, N) plane: the TPU kernel's select-reduce over all F output
//    rows is F times the work.  Neighbouring threads own neighbouring samples,
//    so a warp's adds to one row coalesce.  The order of the adds differs
//    from run to run, so repeated runs differ at the ulp level (the plain
//    path's scatter_add_ on the card does too).
// Everything runs in float32; the division is IEEE (no fast-math).

#include <cuda_runtime.h>

#include "inverse_row.cuh"

namespace {

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384: 12 N bytes = 192 KB of shared memory

template <int PER, bool LOG>
__global__ void __launch_bounds__(1024)
fused_ssq_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= N/2
                 const float* __restrict__ bank,      // (F, N)
                 const float2* __restrict__ twiddle,  // (N/2,) exp(+2 pi i m / N)
                 const float* __restrict__ floors,    // (C, E)
                 float* __restrict__ out,             // (C, F, N), zero-filled
                 int n_epochs, int n_channels, int n_freqs, int log2n,
                 int row_len, float nu_scale, float e0, float step) {
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  const int half_n = n >> 1;
  float2* buf = smem;        // n complex samples
  float2* tw = smem + n;     // n/2 twiddles

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;   // threads * PER == n

  for (int m = tid; m < half_n; m += threads) tw[m] = twiddle[m];

  const float inv_n = 1.f / static_cast<float>(n);   // exact: N = 2^log2n
  const float* bank_row = bank + static_cast<size_t>(f) * n;
  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  float* plane = out + static_cast<size_t>(c) * n_freqs * n;
  const float last_row = static_cast<float>(n_freqs - 1);

  float2 w[PER];
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    const float floor_ce = floors[static_cast<size_t>(c) * n_epochs + e];

    inverse_row<PER>(
        buf, tw,
        [&](int, int k) { return bank_times(sp[k], __ldg(bank_row + k) * inv_n); },
        half_n, log2n, tid, threads);
#pragma unroll
    for (int i = 0; i < PER; ++i) w[i] = buf[tid + i * threads];
    __syncthreads();   // stage 0 of the derivative overwrites buf

    inverse_row<PER>(
        buf, tw,
        [&](int, int k) {
          const float2 bs = bank_times(sp[k], __ldg(bank_row + k) * inv_n);
          const float nu = nu_scale * static_cast<float>(k);
          return make_float2(-(nu * bs.y), nu * bs.x);
        },
        half_n, log2n, tid, threads);

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * threads;
      const float2 x = w[i];
      const float2 d = buf[idx];
      const float p = x.x * x.x + x.y * x.y;
      const float num = d.y * x.x - d.x * x.y;
      const float omega = num / (6.283185307179586f * fmaxf(p, 1e-30f));
      float cnt;
      if (LOG) {
        cnt = omega > 0.f ? ceilf((logf(fmaxf(omega, 1e-30f)) - e0) / step) : 0.f;
      } else {
        cnt = ceilf((omega - e0) / step);
      }
      const int row = p >= floor_ce
                          ? static_cast<int>(fminf(fmaxf(cnt, 0.f), last_row))
                          : f;
      atomicAdd(plane + static_cast<size_t>(row) * n + idx, p);
    }
    __syncthreads();   // the next epoch's stage 0 overwrites buf
  }
}

template <int PER, bool LOG>
cudaError_t launch(const float2* spec, const float* bank, const float2* twiddle,
                   const float* floors, float* out, int n_epochs, int n_channels,
                   int n_freqs, int log2n, int row_len, float nu_scale, float e0,
                   float step, cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t smem = static_cast<size_t>(n) * sizeof(float2) * 3 / 2;
  auto kernel = fused_ssq_kernel<PER, LOG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_freqs, n_channels);
  kernel<<<grid, n / PER, smem, stream>>>(spec, bank, twiddle, floors, out,
                                          n_epochs, n_channels, n_freqs, log2n,
                                          row_len, nu_scale, e0, step);
  return cudaGetLastError();
}

template <bool LOG>
cudaError_t launch_per(const float2* spec, const float* bank,
                       const float2* twiddle, const float* floors, float* out,
                       int n_epochs, int n_channels, int n_freqs, int log2n,
                       int row_len, float nu_scale, float e0, float step,
                       cudaStream_t stream) {
  // 8 samples a thread up to N = 8192 (1024 threads); N = 16384 takes 16.
  return log2n <= 13
             ? launch<8, LOG>(spec, bank, twiddle, floors, out, n_epochs,
                              n_channels, n_freqs, log2n, row_len, nu_scale, e0,
                              step, stream)
             : launch<16, LOG>(spec, bank, twiddle, floors, out, n_epochs,
                               n_channels, n_freqs, log2n, row_len, nu_scale, e0,
                               step, stream);
}

}  // namespace

// Launch the fused synchrosqueezing kernel on `stream`: out (C, F, N),
// zero-filled by the caller, receives the epoch SUM of the reassigned power.
// log_grid selects the "log" row map (else "lin"); nu_scale = 2 pi sfreq / N.
// Returns the cudaError_t of the launch (0 on success); arguments the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int ninw_fused_ssq(const void* spec, const void* bank,
                              const void* twiddle, const void* floors, void* out,
                              int n_epochs, int n_channels, int n_freqs, int n,
                              int row_len, int log_grid, float nu_scale, float e0,
                              float step, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n || log2n < kMinLog2N || log2n > kMaxLog2N ||
      row_len < n / 2 || n_epochs < 1 || n_channels < 1 || n_channels > 65535 ||
      n_freqs < 1 || !(step > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float2* sp = static_cast<const float2*>(spec);
  const float* bk = static_cast<const float*>(bank);
  const float2* tw = static_cast<const float2*>(twiddle);
  const float* fl = static_cast<const float*>(floors);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      log_grid ? launch_per<true>(sp, bk, tw, fl, o, n_epochs, n_channels, n_freqs,
                                  log2n, row_len, nu_scale, e0, step, s)
               : launch_per<false>(sp, bk, tw, fl, o, n_epochs, n_channels, n_freqs,
                                   log2n, row_len, nu_scale, e0, step, s);
  return static_cast<int>(err);
}
