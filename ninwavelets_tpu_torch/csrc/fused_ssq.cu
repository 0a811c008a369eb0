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
// the per-(epoch, channel) gates from the "amax" kernel of fused_cwt.cu.
//
// What bounds it on this card: each (f, c) block runs 2 E inverse FFTs,
// twice the transforms of the "power" reduction (2.56 M of 2048 points at
// 200 epochs x 64 channels x 100 rows, about 4.3 ms of fp32 arithmetic at
// the card's peak), then E N scattered float atomics (2.6 G there).
//
// What the design does about it:
//  * Grid (F, C), the epochs looped inside the block, as for the reductions
//    in fused_cwt.cu: blocks in flight share one channel's spectra in L2, and
//    a ragged epoch count needs no chunking or padding.
//  * Both transforms run on the register-resident core of fft_regs.cuh, as
//    the cross-pair kernel's two rows do (fused_pair.cu): each epoch's bins
//    are loaded once, S is formed once, dS = i nu_k S from it with nu_k
//    computed from k, then W = IFFT(S) and dW = IFFT(dS) through the same
//    exchange buffer.  No bins are loaded ahead of their epoch: the
//    registers that would take cost more in occupancy than they hid.
//    Thread t holds samples t + T i of both, so the epilogue reads them
//    from its own registers with no barrier.
//  * The analytic bins k < N/2 are the first half of every thread's slots
//    (k = t + T i < N/2 exactly for i < R/2), so the upper half of S and dS
//    is zero by construction: no loads, no products, no per-bin tests.
//  * W is W of the "amax" kernel bit for bit: the same plan, the same
//    twiddle table, the same stage 0 and the same p (ssq_row.cuh), so the
//    peak cell of every (epoch, channel) passes its own floor.
//  * Registers: up to N = 8192 a thread holds W while dW transforms (up to
//    255 registers with __launch_bounds__(T, 1); the bank row in registers
//    to N = 4096, reloaded at each stage 0 above).  At N = 16384
//    (1024 threads of 64 registers) W and dW alone would be 64 floats, and
//    W (128 KB) does not fit beside the 136 KB exchange buffer: W waits in
//    shared memory where its own transform's buffer was, each thread at its
//    own samples, and dW transforms through a split exchange (real parts,
//    then imaginary parts, through 68 KB of floats: two more barriers an
//    exchange, the same bits).  dS is formed again from the bins after W's
//    transform rather than held through it.
//  * The spectrum and the bank are read by plain loads through pointers
//    that are not __restrict__, as in fused_cwt_bwd.cu: with __restrict__
//    the compiler may hoist the reloads of dS's bins above W's transform
//    and its barriers, and hold them there.
//  * The reassignment is a float atomicAdd (a RED, the result unused) into
//    the (C, F, N) plane: the TPU kernel's select-reduce over all F output
//    rows is F times the work.  A warp owns 32 consecutive samples of each
//    slot, so its adds coalesce wherever their rows agree.  The order of
//    the adds differs from run to run, so repeated runs differ at the ulp
//    level (the plain path's scatter_add_ on the card does too).
// Everything runs in float32; the division and logf are IEEE (no
// fast-math).

#include <cuda_runtime.h>

#include "fft_regs.cuh"
#include "ssq_row.cuh"

namespace {

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384

// Where the kernel keeps what is not the transform, by N (see the header):
// kBankReg, the scaled bank row in registers; kStash, W in shared memory
// while dW transforms.  With kStash, W transforms through the whole
// exchange buffer at the start of shared memory; W then sits in the first
// 8 N bytes, and dW transforms through a split exchange (fft_regs.cuh) in
// the Plan::kBufLen floats after it.
template <int LOG2N>
struct SsqPlan {
  using PL = fft_regs::Plan<LOG2N>;
  static constexpr bool kBankReg = LOG2N <= 12;
  static constexpr bool kStash = LOG2N == 14;
  static constexpr size_t kBufBytes =
      sizeof(float2) * fft_regs::SmemLayout<LOG2N, 0>::kSumsOffset;
  static constexpr size_t kStashBytes =
      sizeof(float2) * PL::kN + sizeof(float) * PL::kBufLen;
  static constexpr size_t kBytes =
      kStash && kStashBytes > kBufBytes ? kStashBytes : kBufBytes;
  static_assert(!kStash || !PL::kTwSmem, "the twiddles stay in device memory");
  static_assert(kBytes <= 232448, "shared memory per block");
};

// i nu_k s: the derivative's spectrum at bin k, nu_k = nu_scale k.
__device__ __forceinline__ float2 times_i_nu(float2 s, float nu_scale, int k) {
  const float nu = __fmul_rn(nu_scale, static_cast<float>(k));
  return make_float2(-__fmul_rn(nu, s.y), __fmul_rn(nu, s.x));
}

// Im(dW conj W), the numerator of the instantaneous frequency.
__device__ __forceinline__ float cross_im(float2 w, float2 dw) {
  return __fsub_rn(__fmul_rn(dw.y, w.x), __fmul_rn(dw.x, w.y));
}

// One cell from its power p and cross_im: its instantaneous frequency, row
// and gate, and the add.
template <bool LOG>
__device__ __forceinline__ void reassign(float* plane, float p, float num,
                                         int f, int n, int n_samples,
                                         float floor_ce, float e0, float step,
                                         float last_row) {
  const float omega = num / __fmul_rn(6.283185307179586f, fmaxf(p, 1e-30f));
  float cnt;
  if (LOG) {
    cnt = omega > 0.f ? ceilf((logf(fmaxf(omega, 1e-30f)) - e0) / step) : 0.f;
  } else {
    cnt = ceilf((omega - e0) / step);
  }
  const int row = p >= floor_ce
                      ? static_cast<int>(fminf(fmaxf(cnt, 0.f), last_row))
                      : f;
  atomicAdd(plane + static_cast<size_t>(row) * n_samples + n, p);
}

// spec and bank are read by plain loads and are not __restrict__ (see the
// header).
template <int LOG2N, bool LOG>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads, 1)
fused_ssq_kernel(const float2* spec,                  // (E, C, L), L >= N/2
                 const float* bank,                   // (F, N)
                 const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                 const float* __restrict__ floors,    // (C, E)
                 float* __restrict__ out,             // (C, F, N), zero-filled
                 int n_epochs, int n_channels, int n_freqs, int row_len,
                 float nu_scale, float e0, float step) {
  using PL = fft_regs::Plan<LOG2N>;
  using SP = SsqPlan<LOG2N>;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  constexpr int K = N / 2;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2N, 0>(smem, twiddle, tid);
  float2* stash = smem;      // kStash: W, after W's transform
  float2* split = smem + N;  // kStash: dW's split exchange, kBufLen floats

  const float inv_n = 1.f / static_cast<float>(N);   // exact: N = 2^LOG2N
  const float* bank_row = bank + static_cast<size_t>(f) * N;
  // Slots i < kLive hold the bins k = tid + T i < K of every thread; the
  // rest hold k >= K, where S is (+0, +0) (ssq_row.cuh) and so is dS.
  constexpr int kLive = kR / 2;
  static_assert(kLive * T == K, "the analytic bins fill half the slots");
  float bank_reg[SP::kBankReg ? kLive : 1];
  if constexpr (SP::kBankReg) {
#pragma unroll
    for (int i = 0; i < kLive; ++i) {
      bank_reg[i] = ssq::bank_scale(bank_row[tid + i * T], inv_n);
    }
  }
  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  // S at bin tid + T i of this epoch, i < kLive.
  auto stage0 = [&](int i) {
    const int k = tid + i * T;
    if constexpr (SP::kBankReg) {
      return ssq::stage0(sp[k], bank_reg[i]);
    } else {
      return ssq::stage0(sp[k], ssq::bank_scale(bank_row[k], inv_n));
    }
  };
  const float2 zero = make_float2(0.f, 0.f);
  float* plane = out + static_cast<size_t>(c) * n_freqs * N;
  const float last_row = static_cast<float>(n_freqs - 1);

  // No loads ahead (Plan::kAhead): the next epoch's bins in registers cost
  // this kernel more in occupancy than they hid (core_variants.py, PERF.md
  // section 6).
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    float2 w[kR], d[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      w[i] = i < kLive ? stage0(i) : zero;
      if constexpr (!SP::kStash) {
        d[i] = i < kLive ? times_i_nu(w[i], nu_scale, tid + i * T) : zero;
      }
    }
    fft_regs::inverse_fft<LOG2N>(w, buf, tw, tid);

    if constexpr (SP::kStash) {
      // W to shared memory at the thread's own samples: every thread has
      // read the exchange buffer for the last time (inverse_fft's last
      // barrier).  dS formed again from the bins (the same bits as before
      // W's transform).
#pragma unroll
      for (int i = 0; i < kR; ++i) stash[tid + i * T] = w[i];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        d[i] = i < kLive ? times_i_nu(stage0(i), nu_scale, tid + i * T) : zero;
      }
      fft_regs::inverse_fft<LOG2N, true>(d, split, tw, tid);
      const float floor_ce = floors[static_cast<size_t>(c) * n_epochs + e];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float2 wi = stash[tid + i * T];
        reassign<LOG>(plane, ssq::power(wi), cross_im(wi, d[i]), f,
                      tid + i * T, N, floor_ce, e0, step, last_row);
      }
      __syncthreads();   // the next W transform writes over the stash
    } else {
      fft_regs::inverse_fft<LOG2N>(d, buf, tw, tid);
      const float floor_ce = floors[static_cast<size_t>(c) * n_epochs + e];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        reassign<LOG>(plane, ssq::power(w[i]), cross_im(w[i], d[i]), f,
                      tid + i * T, N, floor_ce, e0, step, last_row);
      }
    }
  }
}

struct SsqArgs {
  const float2* spec;
  const float* bank;
  const float2* twiddle;
  const float* floors;
  float* out;
  int n_epochs, n_channels, n_freqs, row_len;
  float nu_scale, e0, step;
};

template <int LOG2N, bool LOG>
cudaError_t launch(const SsqArgs& a, cudaStream_t stream) {
  constexpr size_t smem = SsqPlan<LOG2N>::kBytes;
  auto kernel = fused_ssq_kernel<LOG2N, LOG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, fft_regs::Plan<LOG2N>::kThreads, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.floors, a.out, a.n_epochs, a.n_channels,
      a.n_freqs, a.row_len, a.nu_scale, a.e0, a.step);
  return cudaGetLastError();
}

template <bool LOG>
cudaError_t launch_n(int log2n, const SsqArgs& a, cudaStream_t s) {
  switch (log2n) {
    case 8: return launch<8, LOG>(a, s);
    case 9: return launch<9, LOG>(a, s);
    case 10: return launch<10, LOG>(a, s);
    case 11: return launch<11, LOG>(a, s);
    case 12: return launch<12, LOG>(a, s);
    case 13: return launch<13, LOG>(a, s);
    default: return launch<14, LOG>(a, s);
  }
}

}  // namespace

// Launch the fused synchrosqueezing kernel on `stream`: out (C, F, N),
// zero-filled by the caller, receives the epoch SUM of the reassigned power.
// log_grid selects the "log" row map (else "lin"); nu_scale = 2 pi sfreq / N.
// `twiddle` is the core's table (kernels/__init__.py: core_twiddles).
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
  SsqArgs a;
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.floors = static_cast<const float*>(floors);
  a.out = static_cast<float*>(out);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.row_len = row_len;
  a.nu_scale = nu_scale;
  a.e0 = e0;
  a.step = step;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(log_grid ? launch_n<true>(log2n, a, s)
                                   : launch_n<false>(log2n, a, s));
}
