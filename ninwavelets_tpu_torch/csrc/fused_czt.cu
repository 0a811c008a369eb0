// Fused epoch reductions at N not a power of two, for Hopper (sm_90a):
//     bank x spectrum -> N-point inverse DFT as a chirp-z (Bluestein) over
//     M-point transforms of the register core -> |.|^2 / unit phase ->
//     epoch reduction,
// for the "power", "itc" and "power_itc" epilogues and a real (F, N) bank.
//
// It replaces no TPU kernel: the JAX package's fused kernel
// (ninwavelets_tpu/ops/fused.py:_kernel) takes N a power of two only, and
// ran every other length on its plain XLA chain.  It was added for the
// epoch length MNE gives (2001 samples for -0.5..1.5 s at 1 kHz, 3 x 23 x
// 29), where the port's plain torch.fft route makes a pass over the whole
// (C, F, N) complex plane of every epoch for each elementwise step.
//
// What it computes is what fused_cwt_kernel computes (fused_cwt.cu), for
// every signal (e, c), bank row f and sample n < N:
//     x_e[n]  = sum_{k < K} bank[f, k] * spec[e, c, k] * exp(+2 pi i k n / N)
//     power   = (1 / (N^2 E)) * sum_e |x_e[n]|^2
//     itc     = (1 / E) * | sum_e x_e[n] / |x_e[n]| |
// with K = N/2 on the analytic (interpolate=True) path and K = N otherwise.
// The N-point sum is Bluestein's: with w[m] = exp(+i pi m^2 / N) and
// 2 k n = k^2 + n^2 - (n - k)^2,
//     x[n] = w[n] * conv[n],  conv[n] = sum_k a[k] h[n - k],
//     a[k] = bank[f, k] spec[k] w[k]  (k < K; zero up to M),
//     h[m] = conj(w[|m|])  (|m| < N, wrapped mod M),
// a circular convolution of length M >= 2N - 1, a power of two (1024,
// 2048 or 4096: 256 < N <= 2048).  With F+ the unnormalised inverse DFT of
// the core (fft_regs::inverse_fft) and H = F+(h) / M,
//     conj(conv) = F+( conj( F+(a) * H ) ),
// two inverse transforms of the core and no forward one.  The tables w (N
// values) and H (M values) depend on N alone: built on the host in float64,
// the chirp's phase from k^2 mod 2N in integers, stored as complex64
// (kernels/__init__.py: czt_tables), cached per (N, device).
//
// No output chirp: |x[n]| = |conv[n]| since |w[n]| = 1, and
// |sum_e x_e / |x_e|| = |sum_e conj(conv_e) / |conv_e||, so both epilogues
// are exact on conj(conv) as it leaves the second transform.
// (ninw_fused_cwt_sums hands out Re and Im of the phase sums, which would
// need w[n]; it keeps refusing N not a power of two.)
//
// What bounds it on this card is the two M-point transforms a row: at the
// serving shape (200 epochs x 64 channels x 100 rows, N = 2001, M = 4096)
// 1.28 M rows x 2 x 5 M log2 M flops = 629 GFLOP, 9.4 ms of fp32 arithmetic
// at the card's peak (K2 at N = 2048: 144 GFLOP, 2.16 ms), against 0.2 GB
// of compulsory traffic.  The design is
// fused_cwt_kernel's, on the same core:
//  * One block of T = M/16 threads per (bank row f, channel c); blockIdx.x
//    walks f, so the blocks in flight share one channel's spectra in L2.
//  * All E epochs run inside the block (no chunking, no epoch padded in).
//  * The spectra are the signals' rFFT rows (N/2 + 1 bins): the bins above
//    N/2 of a real signal are the conjugates of those below, read mirrored
//    (bin k > N/2 is conj(row[N - k])).  A full FFT row would hold the same
//    values at twice the bytes, and torch.fft.fft of a real signal makes
//    it from the rFFT with one more pass over the plane.
//  * The block multiplies its bank row by w once, and each thread keeps
//    the H bins it owns in registers, for all E epochs.
//  * N <= M/2, so thread t's bins (t + T i) and valid outputs are those of
//    slots i < R/2: the loads, the stage-0 products and the epoch sums
//    hold half a row; slots i >= R/2 enter the first transform as zeros,
//    and their outputs (n >= M/2 >= N) are dropped.
//  * No reorder between the two transforms: the core's Stockham passes
//    take and leave samples in natural order (thread t, slot i: t + T i),
//    so the H product is made in registers where the first transform
//    leaves its bins, and the second transform reads them there.
//  * Only the N valid outputs are accumulated, and the (C, F, N) planes are
//    written once with the 1/(N^2 E) and 1/E scales applied.
//  * Two blocks an SM (__launch_bounds__(T, 2)): while one block waits on
//    an exchange's barrier or its loads, the other transforms.  At
//    M = 4096 (256 threads, 102 KB of shared memory a block) that caps a
//    thread at 128 registers, which hold its H bins, its half row of
//    bank x w, its row and its epoch sums without a spill only if each
//    epoch's bins are loaded at that epoch and not during the one before
//    (fused_cwt_kernel's kAhead): 23.4 ms a launch at the serving shape on
//    an H100 80GB HBM3 at 700 W, against 30.9 ms for one block an SM with
//    the loads ahead (165 registers).  ptxas -v in the build log reports
//    any spill.
// Everything runs in float32.  The unit phase is x * rsqrtf(|x|^2), and
// x * rhypotf(Re x, Im x) where |x|^2 falls below float32's normal range
// (a row whose power underflows, as the 1 Hz row of a 421-sample epoch
// does, keeps the reference's finite phase); |x| = 0 yields NaN, as the
// reference's 0/0 does.

#include <cfloat>

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace {

// The codes of ninw_fused_cwt's epoch reductions (fused_cwt.cu).
enum Epilogue { kPower = 0, kItc = 1, kPowerItc = 2 };

constexpr int kMinLog2M = 10;   // M = 1024: N = 257 ...
constexpr int kMaxLog2M = 12;   // M = 4096: ... N = 2048

// Bins k < k_bins of thread tid's half row, bin tid + T i in bins[i], from
// the rFFT row of a real signal: bin k > N/2 is conj(row[N - k]).  As
// M/4 < N < M/2, slots i < R/8 (k < M/8) are always below N/2 and slots
// i >= R/4 (k >= M/4) always above it; only the two slots between ask.
template <int LOG2M>
__device__ __forceinline__ void load_half(float2 (&bins)[fft_regs::Plan<LOG2M>::kR / 2],
                                          const float2* __restrict__ row, int n,
                                          int k_bins, int tid) {
  constexpr int kR = fft_regs::Plan<LOG2M>::kR;
  constexpr int T = fft_regs::Plan<LOG2M>::kThreads;
#pragma unroll
  for (int i = 0; i < kR / 2; ++i) {
    const int k = tid + i * T;
    float2 v = make_float2(0.f, 0.f);
    if (k < k_bins) {
      const bool below = i < kR / 8 || (i < kR / 4 && 2 * k <= n);
      v = row[below ? k : n - k];
      if (!below) v.y = -v.y;
    }
    bins[i] = v;
  }
}

template <int EPI, int LOG2M>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2M>::kThreads, 2)
fused_czt_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= N/2 + 1
                 const float* __restrict__ bank,      // (F, N)
                 const float2* __restrict__ chirp,    // (N): w
                 const float2* __restrict__ filt,     // (M): H = F+(h) / M
                 const float2* __restrict__ twiddle,  // core table at M
                 float* __restrict__ out0,            // (C, F, N)
                 float* __restrict__ out1,            // (C, F, N), power_itc only
                 int n_epochs, int n_channels, int n_freqs, int n, int k_bins,
                 int row_len, float power_scale, float itc_scale) {
  using PL = fft_regs::Plan<LOG2M>;
  constexpr int kR = PL::kR;
  constexpr int kHalf = kR / 2;
  constexpr int T = PL::kThreads;
  static_assert(!PL::kAccSmem, "the epoch sums live in registers");
  constexpr int kSums = EPI == kPowerItc ? 3 : EPI == kItc ? 2 : 1;
  constexpr int kP = 0, kRe = EPI == kItc ? 0 : 1, kIm = kRe + 1;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2M, 0>(smem, twiddle, tid);

  float2 h[kR];   // H at bin tid + T i
#pragma unroll
  for (int i = 0; i < kR; ++i) h[i] = __ldg(filt + tid + i * T);
  float2 bw[kHalf];   // bank[f, k] w[k] at bin k = tid + T i, k < K
  const float* bank_row = bank + static_cast<size_t>(f) * n;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int k = tid + i * T;
    bw[i] = k < k_bins ? fft_regs::bank_times_rn(__ldg(chirp + k), bank_row[k])
                       : make_float2(0.f, 0.f);
  }

  float acc[kSums][kHalf];
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[j][i] = 0.f;
  }

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    float2 bins[kHalf];
    load_half<LOG2M>(bins, sp, n, k_bins, tid);
    float2 x[kR];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      x[i] = fft_regs::cmul_rn(bins[i], bw[i]);
      x[kHalf + i] = make_float2(0.f, 0.f);
    }
    fft_regs::inverse_fft<LOG2M>(x, buf, tw, tid);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float2 y = fft_regs::cmul_rn(x[i], h[i]);
      x[i] = make_float2(y.x, -y.y);
    }
    fft_regs::inverse_fft<LOG2M>(x, buf, tw, tid);   // conj(conv)

    // Epilogue: fold the N valid samples of this epoch into the sums.
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if (tid + i * T < n) {
        const float p = x[i].x * x[i].x + x[i].y * x[i].y;
        if constexpr (EPI != kItc) acc[kP][i] += p;
        if constexpr (EPI != kPower) {
          const float inv = p < FLT_MIN ? rhypotf(x[i].x, x[i].y) : rsqrtf(p);
          acc[kRe][i] += x[i].x * inv;
          acc[kIm][i] += x[i].y * inv;
        }
      }
    }
  }

  const size_t base = (static_cast<size_t>(c) * n_freqs + f) * n;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int idx = tid + i * T;
    if (idx < n) {
      if constexpr (EPI != kItc) out0[base + idx] = acc[kP][i] * power_scale;
      if constexpr (EPI != kPower) {
        const float re = acc[kRe][i], im = acc[kIm][i];
        (EPI == kItc ? out0 : out1)[base + idx] = sqrtf(re * re + im * im) * itc_scale;
      }
    }
  }
}

struct Args {
  const float2* spec;
  const float* bank;
  const float2* chirp;
  const float2* filt;
  const float2* twiddle;
  float* out0;
  float* out1;
  int n_epochs, n_channels, n_freqs, n, k_bins, row_len;
  float power_scale, itc_scale;
};

template <int EPI, int LOG2M>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fft_regs::SmemLayout<LOG2M, 0>::kBytes;
  auto kernel = fused_czt_kernel<EPI, LOG2M>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, fft_regs::Plan<LOG2M>::kThreads, smem, stream>>>(
      a.spec, a.bank, a.chirp, a.filt, a.twiddle, a.out0, a.out1, a.n_epochs,
      a.n_channels, a.n_freqs, a.n, a.k_bins, a.row_len, a.power_scale, a.itc_scale);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_m(int log2m, const Args& a, cudaStream_t s) {
  switch (log2m) {
    case 10: return launch<EPI, 10>(a, s);
    case 11: return launch<EPI, 11>(a, s);
    default: return launch<EPI, 12>(a, s);
  }
}

// log2 M, M the least power of two >= 2N - 1, for the N the kernel takes
// (not a power of two, M in [1024, 4096]); -1 otherwise.
int log2_czt(int n) {
  if (n < 2 || (n & (n - 1)) == 0) return -1;
  int log2m = 0;
  while ((1 << log2m) < 2 * n - 1) ++log2m;
  return log2m >= kMinLog2M && log2m <= kMaxLog2M ? log2m : -1;
}

}  // namespace

// Launch one chirp-z epoch reduction on `stream`: "power" (0) -> out0;
// "itc" (1) -> out0; "power_itc" (2) -> power in out0, itc in out1, each
// (C, F, N) float32.  spec is (E, C, row_len) complex64, row_len >= N/2 + 1:
// the rFFT rows of real signals, of which the first k_bins bins (N/2 or N)
// are used, those above N/2 mirrored; bank (F, N) float32; chirp the N values
// of w and filt the M values of H (kernels/__init__.py: czt_tables), both
// complex64; twiddle the core's table at M.  Returns the cudaError_t of
// the launch (0 on success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int ninw_fused_czt(int epilogue, const void* spec, const void* bank,
                              const void* chirp, const void* filt,
                              const void* twiddle, void* out0, void* out1,
                              int n_epochs, int n_channels, int n_freqs, int n,
                              int k_bins, int row_len, void* stream) {
  const int log2m = log2_czt(n);
  if (log2m < 0 || k_bins < 1 || k_bins > n || row_len < n / 2 + 1 ||
      n_epochs < 1 || n_channels < 1 || n_channels > 65535 || n_freqs < 1 ||
      epilogue < kPower || epilogue > kPowerItc ||
      (epilogue == kPowerItc && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.chirp = static_cast<const float2*>(chirp);
  a.filt = static_cast<const float2*>(filt);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.n = n;
  a.k_bins = k_bins;
  a.row_len = row_len;
  const double power_epochs = epilogue == kItc ? 1.0 : n_epochs;
  a.power_scale = static_cast<float>(1.0 / (static_cast<double>(n) * n * power_epochs));
  a.itc_scale = static_cast<float>(1.0 / n_epochs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kPower: return static_cast<int>(launch_m<kPower>(log2m, a, s));
    case kItc: return static_cast<int>(launch_m<kItc>(log2m, a, s));
    default: return static_cast<int>(launch_m<kPowerItc>(log2m, a, s));
  }
}
