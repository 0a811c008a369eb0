// Fused forward CWT for Hopper (sm_90a):
//     bank x spectrum -> inverse DFT -> |.|^2 / unit phase -> epoch reduction,
// or, per signal with no reduction, -> |.|^2.
//
// Replaces the Pallas TPU kernel ninwavelets_tpu/ops/fused.py:_kernel with
// its "power", "itc", "power_itc" and "amax" epilogues (fused_cwt_kernel)
// and its "power_each" epilogue (fused_cwt_each_kernel), for a real (F, N)
// bank.
//
// What it computes, for every signal (e, c), bank row f and sample n:
//     x_e[n]  = sum_{k < K} bank[f, k] * spec[e, c, k] * exp(+2 pi i k n / N)
//     power   = (1 / (N^2 E)) * sum_e |x_e[n]|^2          (mean |cwt|^2)
//     itc     = (1 / E) * | sum_e x_e[n] / |x_e[n]| |      (mean unit phase)
//     each    = (1 / N^2) * |x_e[n]|^2, for every (e, c)  (|cwt|^2 per signal)
//     amax    = max_n (1 / N^2) |x_e[n]|^2, out[c, f, e]   (per-row peak)
// "amax" gives the synchrosqueezing noise gate (fused_ssq.cu) each epoch's
// peak power: torch finishes the max over f.  It folds the 1/N into the
// bank before the transform, as fused_ssq.cu does, so both kernels compute
// the same |x|^2 through the same code (inverse_row.cuh); a block's
// per-epoch max is a warp-shuffle reduction, then one over the warps in
// shared memory, written by one thread: deterministic, no atomics.
// K = N/2 on the analytic (interpolate=True) path: the upper bins are zero.
// K = N otherwise.  The signal FFT runs outside the kernel (as it does for
// the TPU kernel); this kernel starts at the bank x spectrum product.
//
// What bounds the reductions on this card: each (c, f) block runs E
// in-place radix-2 inverse FFTs in shared memory, log2(N) passes of N/2
// butterflies each, with a barrier between passes, so the shared-memory FFT
// passes bound it.  The spectra are read F times (once per bank row), which
// is the second bound: at 64 channels x 200 epochs x 2048 samples they are
// 105 MB, more than the 50 MB L2.
//
// What the design does about that:
//  * blockIdx.x walks the bank rows f and blockIdx.y the channels c, so the
//    blocks in flight share one channel's spectra and the F-fold re-read is
//    served from L2; device memory sees the spectra about once.
//  * The bank row is loaded once per block into registers and reused for
//    every epoch; the twiddle table (computed on the host in float64, stored
//    as float32) is staged once per block in shared memory.
//  * Each thread owns fixed sample positions and accumulates the epoch
//    reduction in registers, so the (C, F, N) output is written exactly
//    once, in its natural layout, with the 1/N and 1/E scales applied at the
//    write.  No coefficient ever reaches device memory.
//  * All E epochs run inside the block, so a ragged epoch count needs no
//    chunking and no epoch is ever padded in.
// Everything runs in float32.  The unit phase is x * rsqrtf(|x|^2) with no
// guard: |x| = 0 yields NaN, as the reference's 0/0 does.
//
// "power_each" (the long-recording paths: one signal is one window of one
// channel) has no reduction, so every (signal, row) pair is independent and
// gets a block of its own: blockIdx.x walks f, as above, so the blocks in
// flight share one signal's spectrum in L2, and the flattened signal index
// e * C + c rides blockIdx.y and blockIdx.z, so no grid axis passes its
// 65535 limit.  Its output, E*C*F*N floats written once, is its compulsory
// traffic (3.4 GB at 512 windows x channels of 16384 samples, 100 rows);
// its radix-2 passes through shared memory are what bound it in practice,
// as for the reductions.  Offsets into the spectra and the output are
// size_t: E*C*F*N passes 2^31 at large batches.

#include <cuda_runtime.h>

#include "inverse_row.cuh"

namespace {

enum Epilogue { kPower = 0, kItc = 1, kPowerItc = 2, kPowerEach = 3, kAmax = 4 };

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384: 12 N bytes = 192 KB of shared memory
constexpr int kMaxWarps = 32;   // 1024 threads

// The max of v over the block, in thread 0 (v >= 0 everywhere).  `red`
// holds one float a warp; the caller's next barrier orders its reuse.
__device__ __forceinline__ float block_max(float v, float* red, int tid,
                                           int threads) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (threads >> 5); ++w) v = fmaxf(v, red[w]);
  }
  return v;
}

template <int EPI, int PER>
__global__ void __launch_bounds__(1024)
fused_cwt_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= K
                 const float* __restrict__ bank,      // (F, N)
                 const float2* __restrict__ twiddle,  // (N/2,) exp(+2 pi i m / N)
                 float* __restrict__ out0,            // (C, F, N); amax: (C, F, E)
                 float* __restrict__ out1,            // (C, F, N), power_itc only
                 int n_epochs, int n_channels, int n_freqs, int log2n,
                 int k_bins, int row_len, float power_scale, float itc_scale) {
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  const int half_n = n >> 1;
  float2* buf = smem;        // n complex samples
  float2* tw = smem + n;     // n/2 twiddles
  float* red = reinterpret_cast<float*>(tw + half_n);   // amax: one float a warp

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;   // threads * PER == n

  for (int m = tid; m < half_n; m += threads) tw[m] = twiddle[m];

  // "amax" folds the inverse DFT's 1/N into the bank (exact: N = 2^log2n).
  const float bank_scale = EPI == kAmax ? 1.f / static_cast<float>(n) : 1.f;
  float bank_reg[PER];
  const float* bank_row = bank + static_cast<size_t>(f) * n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * threads;
    bank_reg[i] = k < k_bins ? bank_row[k] * bank_scale : 0.f;
  }

  float acc_p[PER], acc_r[PER], acc_i[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc_p[i] = acc_r[i] = acc_i[i] = 0.f;

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;

  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    inverse_row<PER>(
        buf, tw, [&](int i, int k) { return bank_times(sp[k], bank_reg[i]); },
        k_bins, log2n, tid, threads);

    // Epilogue: fold this epoch into the register accumulators.
    float peak = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float2 x = buf[tid + i * threads];
      const float p = x.x * x.x + x.y * x.y;
      if (EPI == kAmax) {
        peak = fmaxf(peak, p);
      } else {
        if (EPI != kItc) acc_p[i] += p;
        if (EPI != kPower) {
          const float inv = rsqrtf(p);
          acc_r[i] += x.x * inv;
          acc_i[i] += x.y * inv;
        }
      }
    }
    if (EPI == kAmax) {
      peak = block_max(peak, red, tid, threads);
      if (tid == 0) {
        out0[(static_cast<size_t>(c) * n_freqs + f) * n_epochs + e] = peak;
      }
    }
    __syncthreads();   // the next epoch's stage 0 overwrites buf (and red)
  }
  if (EPI == kAmax) return;

  const size_t base = (static_cast<size_t>(c) * n_freqs + f) * n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * threads;
    if (EPI == kPower) {
      out0[base + idx] = acc_p[i] * power_scale;
    } else if (EPI == kItc) {
      out0[base + idx] = sqrtf(acc_r[i] * acc_r[i] + acc_i[i] * acc_i[i]) * itc_scale;
    } else {
      out0[base + idx] = acc_p[i] * power_scale;
      out1[base + idx] = sqrtf(acc_r[i] * acc_r[i] + acc_i[i] * acc_i[i]) * itc_scale;
    }
  }
}

// "power_each": |x|^2 / N^2 of every (signal, bank row) pair, one block
// each.  Signal b = e * C + c (the row of the contiguous (E, C, L) spectra)
// is blockIdx.z * gridDim.y + blockIdx.y; the last z-slice may be ragged.
template <int PER>
__global__ void __launch_bounds__(1024)
fused_cwt_each_kernel(const float2* __restrict__ spec,     // (E*C, L), L >= K
                      const float* __restrict__ bank,      // (F, N)
                      const float2* __restrict__ twiddle,  // (N/2,)
                      float* __restrict__ out,             // (E*C, F, N)
                      int n_signals, int n_freqs, int log2n, int k_bins,
                      int row_len, float power_scale) {
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  if (b >= n_signals) return;   // uniform over the block: no barrier skipped
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  float2* buf = smem;        // n complex samples
  float2* tw = smem + n;     // n/2 twiddles
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;   // threads * PER == n

  for (int m = tid; m < (n >> 1); m += threads) tw[m] = twiddle[m];
  float bank_reg[PER];
  const float* bank_row = bank + static_cast<size_t>(f) * n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * threads;
    bank_reg[i] = k < k_bins ? bank_row[k] : 0.f;
  }

  const float2* sp = spec + static_cast<size_t>(b) * row_len;
  inverse_row<PER>(
      buf, tw, [&](int i, int k) { return bank_times(sp[k], bank_reg[i]); },
      k_bins, log2n, tid, threads);

  float* dst = out + ((static_cast<size_t>(b) * n_freqs + f) << log2n);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * threads;
    const float2 x = buf[idx];
    dst[idx] = (x.x * x.x + x.y * x.y) * power_scale;
  }
}

struct Args {
  const float2* spec;
  const float* bank;
  const float2* twiddle;
  float* out0;
  float* out1;
  int n_epochs, n_channels, n_freqs, log2n, k_bins, row_len;
  float power_scale, itc_scale;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int EPI, int PER>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = 1 << a.log2n;
  const size_t smem = static_cast<size_t>(n) * sizeof(float2) * 3 / 2 +
                      (EPI == kAmax ? kMaxWarps * sizeof(float) : 0);
  if constexpr (EPI == kPowerEach) {
    auto kernel = fused_cwt_each_kernel<PER>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int n_signals = a.n_epochs * a.n_channels;   // checked by the caller
    const int rows_y = n_signals < 65535 ? n_signals : 65535;
    const dim3 grid(a.n_freqs, rows_y, (n_signals + rows_y - 1) / rows_y);
    kernel<<<grid, n / PER, smem, stream>>>(
        a.spec, a.bank, a.twiddle, a.out0, n_signals, a.n_freqs, a.log2n,
        a.k_bins, a.row_len, a.power_scale);
    return cudaGetLastError();
  } else {
    auto kernel = fused_cwt_kernel<EPI, PER>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.n_freqs, a.n_channels);
    kernel<<<grid, n / PER, smem, stream>>>(
        a.spec, a.bank, a.twiddle, a.out0, a.out1, a.n_epochs, a.n_channels,
        a.n_freqs, a.log2n, a.k_bins, a.row_len, a.power_scale, a.itc_scale);
    return cudaGetLastError();
  }
}

template <int EPI>
cudaError_t launch_per(const Args& a, cudaStream_t stream) {
  // 8 samples a thread up to N = 8192 (1024 threads); N = 16384 takes 16.
  return a.log2n <= 13 ? launch<EPI, 8>(a, stream) : launch<EPI, 16>(a, stream);
}

}  // namespace

// Launch one fused reduction (or, for "power_each", the per-signal power)
// on `stream`.  Returns the cudaError_t of the launch (0 on success);
// arguments the kernel does not take return cudaErrorInvalidValue without
// launching.  The reductions put C on a grid axis (C <= 65535);
// "power_each" flattens E * C onto two (E * C < 2^31).
extern "C" int ninw_fused_cwt(int epilogue, const void* spec, const void* bank,
                              const void* twiddle, void* out0, void* out1,
                              int n_epochs, int n_channels, int n_freqs, int n,
                              int k_bins, int row_len, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n || log2n < kMinLog2N || log2n > kMaxLog2N ||
      k_bins < 1 || k_bins > n || row_len < k_bins || n_epochs < 1 ||
      n_channels < 1 || n_freqs < 1 ||
      (epilogue != kPowerEach && n_channels > 65535) ||
      (epilogue == kPowerEach &&
       static_cast<long long>(n_epochs) * n_channels > 2147483647LL) ||
      epilogue < kPower || epilogue > kAmax ||
      (epilogue == kPowerItc && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.log2n = log2n;
  a.k_bins = k_bins;
  a.row_len = row_len;
  const double power_epochs = epilogue == kPower || epilogue == kPowerItc ? n_epochs : 1.0;
  a.power_scale = static_cast<float>(1.0 / (static_cast<double>(n) * n * power_epochs));
  a.itc_scale = static_cast<float>(1.0 / n_epochs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kPower: return static_cast<int>(launch_per<kPower>(a, s));
    case kItc: return static_cast<int>(launch_per<kItc>(a, s));
    case kPowerItc: return static_cast<int>(launch_per<kPowerItc>(a, s));
    case kAmax: return static_cast<int>(launch_per<kAmax>(a, s));
    default: return static_cast<int>(launch_per<kPowerEach>(a, s));
  }
}
