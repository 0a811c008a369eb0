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
// and PLI reads 0, as on the plain path.  "plv" has no guard: a zero
// coefficient gives NaN, as the plain x / |x| does.  It normalises a and b
// each by rsqrtf(|.|^2) (as the "itc" epilogue does) rather than a conj b by
// rsqrtf(|a conj b|^2): the fourth power of a weak coefficient (1e-12 in a
// row whose bank barely reaches the FFT grid) underflows float32 and would
// give NaN where the plain path, which takes |x| by hypot, gives a phase.
//
// What bounds it on this card: each (f, c) block runs 2 E in-place radix-2
// inverse FFTs in shared memory (log2(N) passes with a barrier each), the
// transform count of the synchrosqueezing kernel, without its atomics.  The
// two spectra are read F times (once per bank row): at 200 epochs x 64 pairs
// x 2048 samples each is 105 MB, both together more than the 50 MB L2.
//
// What the design does about it:
//  * Grid (F, C), blockIdx.x = f: blocks in flight share one pair's spectra
//    in L2, so device memory sees them about once.
//  * All E epochs run inside the block: a ragged epoch count needs no
//    chunking, and no epoch is ever padded in.
//  * Per epoch, a is transformed in buf and its PER samples a thread copied
//    to registers (as fused_ssq.cu keeps W); then b is transformed in the
//    same buf and the epilogue reads both.  Shared memory stays at the 12 N
//    bytes of the reductions, so N runs from 256 to 16384.  The bank row is
//    re-read through the read-only cache at each stage 0 to spare registers.
//  * The accumulators stay in registers and each output plane is written
//    once, in its natural (C, F, N) layout.
// Everything runs in float32.  At N >= 8192 a block has 1024 threads, so a
// thread gets at most 64 registers; a's samples and the four accumulators a
// sample do not fit and spill (ptxas -v, in the build log).

#include <cuda_runtime.h>

#include "inverse_row.cuh"

namespace {

enum PairEpilogue { kCoherence = 0, kPhaseLag = 1, kPlv = 2 };

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384: 12 N bytes = 192 KB of shared memory

template <int EPI, int PER>
__global__ void __launch_bounds__(1024)
fused_pair_kernel(const float2* __restrict__ spec_a,   // (E, C, L), L >= K
                  const float2* __restrict__ spec_b,   // (E, C, L)
                  const float* __restrict__ bank,      // (F, N)
                  const float2* __restrict__ twiddle,  // (N/2,) exp(+2 pi i m / N)
                  float* __restrict__ out,             // (n_out, C, F, N)
                  int n_epochs, int n_channels, int n_freqs, int log2n,
                  int k_bins, int row_len) {
  constexpr int kOuts = EPI == kPlv ? 2 : 4;
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
  const float2* sa = spec_a + static_cast<size_t>(c) * row_len;
  const float2* sb = spec_b + static_cast<size_t>(c) * row_len;

  float acc[kOuts][PER];
#pragma unroll
  for (int j = 0; j < kOuts; ++j) {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[j][i] = 0.f;
  }

  float2 a[PER];
  for (int e = 0; e < n_epochs; ++e, sa += epoch_stride, sb += epoch_stride) {
    inverse_row<PER>(
        buf, tw,
        [&](int, int k) { return bank_times(sa[k], __ldg(bank_row + k) * inv_n); },
        k_bins, log2n, tid, threads);
#pragma unroll
    for (int i = 0; i < PER; ++i) a[i] = buf[tid + i * threads];
    __syncthreads();   // stage 0 of b overwrites buf

    inverse_row<PER>(
        buf, tw,
        [&](int, int k) { return bank_times(sb[k], __ldg(bank_row + k) * inv_n); },
        k_bins, log2n, tid, threads);

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float2 x = a[i];
      const float2 y = buf[tid + i * threads];
      if (EPI == kCoherence) {
        const float2 cross = cmul_conj(x, y);
        acc[0][i] += cross.x;
        acc[1][i] += cross.y;
        acc[2][i] += x.x * x.x + x.y * x.y;
        acc[3][i] += y.x * y.x + y.y * y.y;
      } else if (EPI == kPhaseLag) {
        const float p = __fmul_rn(x.y, y.x);
        const float q = __fmul_rn(x.x, y.y);
        const float im = p == q ? 0.f : __fsub_rn(p, q);
        acc[0][i] += im;
        acc[1][i] += fabsf(im);
        acc[2][i] += static_cast<float>((im > 0.f) - (im < 0.f));
        acc[3][i] += im * im;
      } else {
        const float ra = rsqrtf(x.x * x.x + x.y * x.y);
        const float rb = rsqrtf(y.x * y.x + y.y * y.y);
        const float2 u = cmul_conj(make_float2(x.x * ra, x.y * ra),
                                   make_float2(y.x * rb, y.y * rb));
        acc[0][i] += u.x;
        acc[1][i] += u.y;
      }
    }
    __syncthreads();   // the next epoch's stage 0 overwrites buf
  }

  const size_t plane = static_cast<size_t>(n_channels) * n_freqs * n;
  const size_t base = (static_cast<size_t>(c) * n_freqs + f) * n;
#pragma unroll
  for (int j = 0; j < kOuts; ++j) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      out[j * plane + base + tid + i * threads] = acc[j][i];
    }
  }
}

template <int EPI, int PER>
cudaError_t launch(const float2* spec_a, const float2* spec_b, const float* bank,
                   const float2* twiddle, float* out, int n_epochs, int n_channels,
                   int n_freqs, int log2n, int k_bins, int row_len,
                   cudaStream_t stream) {
  const int n = 1 << log2n;
  const size_t smem = static_cast<size_t>(n) * sizeof(float2) * 3 / 2;
  auto kernel = fused_pair_kernel<EPI, PER>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_freqs, n_channels);
  kernel<<<grid, n / PER, smem, stream>>>(spec_a, spec_b, bank, twiddle, out,
                                          n_epochs, n_channels, n_freqs, log2n,
                                          k_bins, row_len);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_per(const float2* spec_a, const float2* spec_b, const float* bank,
                       const float2* twiddle, float* out, int n_epochs,
                       int n_channels, int n_freqs, int log2n, int k_bins,
                       int row_len, cudaStream_t stream) {
  // 8 samples a thread up to N = 8192 (1024 threads); N = 16384 takes 16.
  return log2n <= 13
             ? launch<EPI, 8>(spec_a, spec_b, bank, twiddle, out, n_epochs,
                              n_channels, n_freqs, log2n, k_bins, row_len, stream)
             : launch<EPI, 16>(spec_a, spec_b, bank, twiddle, out, n_epochs,
                               n_channels, n_freqs, log2n, k_bins, row_len, stream);
}

}  // namespace

// Launch one cross-pair epoch reduction on `stream`: out is (n_out, C, F, N)
// float32, n_out = 4 for "coherence" (0) and "phaselag" (1), 2 for "plv" (2).
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
  const float2* sa = static_cast<const float2*>(spec_a);
  const float2* sb = static_cast<const float2*>(spec_b);
  const float* bk = static_cast<const float*>(bank);
  const float2* tw = static_cast<const float2*>(twiddle);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (epilogue) {
    case kCoherence:
      err = launch_per<kCoherence>(sa, sb, bk, tw, o, n_epochs, n_channels, n_freqs,
                                   log2n, k_bins, row_len, s);
      break;
    case kPhaseLag:
      err = launch_per<kPhaseLag>(sa, sb, bk, tw, o, n_epochs, n_channels, n_freqs,
                                  log2n, k_bins, row_len, s);
      break;
    default:
      err = launch_per<kPlv>(sa, sb, bk, tw, o, n_epochs, n_channels, n_freqs,
                             log2n, k_bins, row_len, s);
      break;
  }
  return static_cast<int>(err);
}
