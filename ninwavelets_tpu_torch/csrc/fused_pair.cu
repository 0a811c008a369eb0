// Fused cross-pair epoch sums for Hopper (sm_90a): two channels a and b of
// every (epoch, pair) through bank x spectrum -> inverse FFT, then one of
// three epilogues summed over epochs, for a real (F, N) bank.
//
// Replaces the cross-pair epilogues of the Pallas TPU kernel
// ninwavelets_tpu/ops/fused.py:_kernel ("coherence", "phaselag" and "plv",
// reached through fused_coherence_sums, fused_phase_lag_sums and
// fused_plv_sums), which carry the pair stacked on the epoch axis.
//
// What it computes, for pair c, bank row f and sample n, with
//     a_e[n] = sum_{k < K} (bank[f, k] / N) spec_a[e, c, k] exp(+2 pi i k n / N)
// and b_e likewise (the plain path's ifft scale; the 1/N folds into the bank,
// exact for N = 2^k, as the "amax" epilogue of fused_cwt.cu does):
//   "coherence": out[0..3] = sum_e Re(a conj b), Im(a conj b), |a|^2, |b|^2
//                (ops.extensions.coherence_sums);
//   "phaselag":  with p = Im a Re b and q = Re a Im b, each rounded on its own
//                (__fmul_rn: nvcc cannot contract p - q into an FMA), and
//                im = (p == q) ? 0 : p - q:
//                out[0..3] = sum_e im, |im|, sign(im) (sign(0) = 0), im^2
//                (ops.connectivity.phase_lag_sums, with its pin);
//   "plv":       out[0..1] = sum_e Re, Im of (a / |a|) conj(b / |b|)
//                (ops.connectivity.plv_sums at eps = 0).
// The pin makes a self-pair (a = b, bit-identical transforms) and a zero
// channel read im = 0 exactly, so wPLI / dwPLI take the documented 0/0 -> NaN
// and PLI reads 0, as on the plain path.  a and b go through the same
// stage 0 and the same core (fft_regs.cuh), whose every operation is an
// explicitly rounded intrinsic, so equal spectra give equal bits.  "plv" has
// no guard: a zero coefficient gives NaN, as the plain x / |x| does.  It
// normalises a and b each by rsqrtf(|.|^2) (as the "itc" epilogue does)
// rather than a conj b by rsqrtf(|a conj b|^2): the fourth power of a weak
// coefficient (1e-12 in a row whose bank barely reaches the FFT grid)
// underflows float32 and would give NaN where the plain path, which takes
// |x| by hypot, gives a phase.
//
// What bounds it on this card: each (f, c) block runs 2 E inverse FFTs,
// twice the transforms of the "power" reduction (2.56 M of 2048 points at
// 200 epochs x 64 pairs x 100 rows, about 4.3 ms of fp32 arithmetic at the
// card's peak).  The two spectra are read F times (once per bank row): at
// that shape each is 105 MB, both together more than the 50 MB L2.
//
// What the design does about it:
//  * Grid (F, C), blockIdx.x = f: blocks in flight share one pair's spectra
//    in L2, so device memory sees them about once.
//  * All E epochs run inside the block: a ragged epoch count needs no
//    chunking, and no epoch is ever padded in.
//  * The transforms run on the register-resident core of fft_regs.cuh
//    (N/16 threads of 16 samples, two exchanges through shared memory at
//    N = 2048).  a is transformed, then b through the same exchange buffer;
//    thread t owns samples t + T i of both, so the epilogue reads a and b
//    from its own registers with no copy and no barrier of its own.
//  * For "plv", up to N = 4096, the bins of the next row (b's, then the
//    next epoch's a's) are loaded into registers while the row before is
//    transformed.
//  * Registers: a thread holds a's and b's samples and 2 or 4 epoch sums a
//    sample.  At N = 8192 the block has 256 threads of 32 samples and the
//    sums move to shared memory, each thread at its own samples
//    (fft_regs.cuh, kR and kAccSmem); at N = 16384 (1024 threads, 64
//    registers) they do
//    not fit beside the exchange buffer and spill (ptxas -v, in the build
//    log).  The bank row is read through the read-only cache at each
//    stage 0.
//  * Each output plane is written once, coalesced, in its natural (C, F, N)
//    layout.
// Everything runs in float32.

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace {

enum PairEpilogue { kCoherence = 0, kPhaseLag = 1, kPlv = 2 };

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// Stage 0 of one row, the same for a and b: bins times bank / N.
template <int LOG2N>
__device__ __forceinline__ void stage0(float2 (&x)[fft_regs::Plan<LOG2N>::kR],
                                       const float2 (&bins)[fft_regs::Plan<LOG2N>::kR],
                                       const float* __restrict__ bank_row,
                                       float inv_n, int k_bins, int tid) {
#pragma unroll
  for (int i = 0; i < fft_regs::Plan<LOG2N>::kR; ++i) {
    const int k = tid + i * fft_regs::Plan<LOG2N>::kThreads;
    x[i] = k < k_bins
               ? fft_regs::bank_times_rn(bins[i], __fmul_rn(__ldg(bank_row + k), inv_n))
               : make_float2(0.f, 0.f);
  }
}

// minBlocksPerSM = 1: with the default heuristics ptxas spilled "plv" at
// N = 8192 (256 threads of 32 samples, 255 registers); with it, nothing
// spills at N <= 8192 (ptxas -v, in the build log).
template <int EPI, int LOG2N>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads, 1)
fused_pair_kernel(const float2* __restrict__ spec_a,   // (E, C, L), L >= K
                  const float2* __restrict__ spec_b,   // (E, C, L)
                  const float* __restrict__ bank,      // (F, N)
                  const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                  float* __restrict__ out,             // (n_out, C, F, N)
                  int n_epochs, int n_channels, int n_freqs, int k_bins,
                  int row_len) {
  using PL = fft_regs::Plan<LOG2N>;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  constexpr int kOuts = EPI == kPlv ? 2 : 4;
  // Loading the next row's bins during a transform (Plan::kAhead) costs 32
  // registers a thread.  With four sums a sample that costs a block an SM:
  // "coherence" / "phaselag" ran faster without it, "plv" faster with it
  // (core_variants.py, PERF.md section 6).
  constexpr bool kAhead = PL::kAhead && EPI == kPlv;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2N, kOuts>(smem, twiddle, tid);

  const float inv_n = 1.f / static_cast<float>(N);   // exact: N = 2^LOG2N
  const float* bank_row = bank + static_cast<size_t>(f) * N;
  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sa = spec_a + static_cast<size_t>(c) * row_len;
  const float2* sb = spec_b + static_cast<size_t>(c) * row_len;

  fft_regs::EpochSums<LOG2N, kOuts> acc(smem, tid);

  float2 bins[kR];   // kAhead: the bins of the next row to transform
  if constexpr (kAhead) fft_regs::load_bins<LOG2N>(bins, sa, k_bins, tid);
  for (int e = 0; e < n_epochs; ++e, sa += epoch_stride, sb += epoch_stride) {
    float2 a[kR], b[kR];
    if constexpr (!kAhead) fft_regs::load_bins<LOG2N>(bins, sa, k_bins, tid);
    stage0<LOG2N>(a, bins, bank_row, inv_n, k_bins, tid);
    if constexpr (kAhead) fft_regs::load_bins<LOG2N>(bins, sb, k_bins, tid);
    fft_regs::inverse_fft<LOG2N>(a, buf, tw, tid);

    if constexpr (!kAhead) fft_regs::load_bins<LOG2N>(bins, sb, k_bins, tid);
    stage0<LOG2N>(b, bins, bank_row, inv_n, k_bins, tid);
    if constexpr (kAhead) {
      if (e + 1 < n_epochs) {
        fft_regs::load_bins<LOG2N>(bins, sa + epoch_stride, k_bins, tid);
      }
    }
    fft_regs::inverse_fft<LOG2N>(b, buf, tw, tid);

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float2 x = a[i];
      const float2 y = b[i];
      if (EPI == kCoherence) {
        const float2 cross = cmul_conj(x, y);
        acc(0, i) += cross.x;
        acc(1, i) += cross.y;
        acc(2, i) += x.x * x.x + x.y * x.y;
        acc(3, i) += y.x * y.x + y.y * y.y;
      } else if (EPI == kPhaseLag) {
        const float p = __fmul_rn(x.y, y.x);
        const float q = __fmul_rn(x.x, y.y);
        const float im = p == q ? 0.f : __fsub_rn(p, q);
        acc(0, i) += im;
        acc(1, i) += fabsf(im);
        acc(2, i) += static_cast<float>((im > 0.f) - (im < 0.f));
        acc(3, i) += im * im;
      } else {
        const float ra = rsqrtf(x.x * x.x + x.y * x.y);
        const float rb = rsqrtf(y.x * y.x + y.y * y.y);
        const float2 u = cmul_conj(make_float2(x.x * ra, x.y * ra),
                                   make_float2(y.x * rb, y.y * rb));
        acc(0, i) += u.x;
        acc(1, i) += u.y;
      }
    }
  }

  const size_t plane = static_cast<size_t>(n_channels) * n_freqs * N;
  const size_t base = (static_cast<size_t>(c) * n_freqs + f) * N;
#pragma unroll
  for (int j = 0; j < kOuts; ++j) {
#pragma unroll
    for (int i = 0; i < kR; ++i) out[j * plane + base + tid + i * T] = acc(j, i);
  }
}

struct PairArgs {
  const float2* spec_a;
  const float2* spec_b;
  const float* bank;
  const float2* twiddle;
  float* out;
  int n_epochs, n_channels, n_freqs, k_bins, row_len;
};

template <int EPI, int LOG2N>
cudaError_t launch(const PairArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fft_regs::SmemLayout<LOG2N, EPI == kPlv ? 2 : 4>::kBytes;
  auto kernel = fused_pair_kernel<EPI, LOG2N>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, fft_regs::Plan<LOG2N>::kThreads, smem, stream>>>(
      a.spec_a, a.spec_b, a.bank, a.twiddle, a.out, a.n_epochs, a.n_channels,
      a.n_freqs, a.k_bins, a.row_len);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_n(int log2n, const PairArgs& a, cudaStream_t s) {
  switch (log2n) {
    case 8: return launch<EPI, 8>(a, s);
    case 9: return launch<EPI, 9>(a, s);
    case 10: return launch<EPI, 10>(a, s);
    case 11: return launch<EPI, 11>(a, s);
    case 12: return launch<EPI, 12>(a, s);
    case 13: return launch<EPI, 13>(a, s);
    default: return launch<EPI, 14>(a, s);
  }
}

}  // namespace

// Launch one cross-pair epoch reduction on `stream`: out is (n_out, C, F, N)
// float32, n_out = 4 for "coherence" (0) and "phaselag" (1), 2 for "plv" (2).
// `twiddle` is the core's table (kernels/__init__.py: core_twiddles).
// Returns the cudaError_t of the launch (0 on success); arguments the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int ninw_fused_pair(int epilogue, const void* spec_a, const void* spec_b,
                               const void* bank, const void* twiddle, void* out,
                               int n_epochs, int n_channels, int n_freqs, int n,
                               int k_bins, int row_len, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n || log2n < kMinLog2N || log2n > kMaxLog2N ||
      k_bins < 1 || k_bins > n || row_len < k_bins || n_epochs < 1 ||
      n_channels < 1 || n_channels > 65535 || n_freqs < 1 ||
      epilogue < kCoherence || epilogue > kPlv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairArgs a;
  a.spec_a = static_cast<const float2*>(spec_a);
  a.spec_b = static_cast<const float2*>(spec_b);
  a.bank = static_cast<const float*>(bank);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.out = static_cast<float*>(out);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.k_bins = k_bins;
  a.row_len = row_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kCoherence: return static_cast<int>(launch_n<kCoherence>(log2n, a, s));
    case kPhaseLag: return static_cast<int>(launch_n<kPhaseLag>(log2n, a, s));
    default: return static_cast<int>(launch_n<kPlv>(log2n, a, s));
  }
}
