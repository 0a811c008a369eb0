// Fused forward CWT for Hopper (sm_90a):
//     bank x spectrum -> inverse DFT -> |.|^2 / unit phase -> epoch reduction,
// or, per signal with no reduction, -> |.|^2.
//
// Replaces the Pallas TPU kernel ninwavelets_tpu/ops/fused.py:_kernel with
// its "power", "itc" and "power_itc" epilogues (fused_cwt_kernel), its
// "amax" epilogue (fused_amax_kernel), launched by ninw_fused_cwt, and its
// "power_each" epilogue (fused_each_kernel), launched by
// ninw_fused_power_each, for a real (F, N) bank; and its complex-bank
// stage 0 (complex_bank=True) for the "power", "itc" and "power_itc"
// epilogues (fused_cwt_kernel<..., CX = true>), the only ones the reference
// sends a complex (Normal/Twice-mode: MexicanHat, Haar) bank to.
//
// What it computes, for every signal (e, c), bank row f and sample n:
//     x_e[n]  = sum_{k < K} bank[f, k] * spec[e, c, k] * exp(+2 pi i k n / N)
//     power   = (1 / (N^2 E)) * sum_e |x_e[n]|^2          (mean |cwt|^2)
//     itc     = (1 / E) * | sum_e x_e[n] / |x_e[n]| |      (mean unit phase)
//     each    = (1 / N^2) * |x_e[n]|^2, for every (e, c)  (|cwt|^2 per signal)
//     amax    = max_n (1 / N^2) |x_e[n]|^2, out[c, f, e]   (per-row peak)
//     and, through ninw_fused_cwt_sums, the epoch SUMS behind power and itc
//     (sum_e |x_e[n]|^2 / N^2, Re and Im of sum_e x_e[n] / |x_e[n]|), which
//     a sharded caller adds across devices before it finishes the means.
// K = N/2 on the analytic (interpolate=True) path: the upper bins are zero.
// K = N otherwise.  The signal FFT runs outside the kernel (as it does for
// the TPU kernel); this kernel starts at the bank x spectrum product.
//
// Every kernel here runs on the register-resident FFT core of
// fft_regs.cuh.  What bounds the epoch reductions (fused_cwt_kernel) on
// this card is the transform: E inverse FFTs per (c, f) block, 1.28 M of
// 2048 points at the serving shape (200 epochs x 64 channels x 100 rows),
// about 2.2 ms of fp32 arithmetic at the card's peak against 0.04 GB of
// compulsory traffic.  The design:
//  * One block of T = N/16 threads (N/32 at N = 8192) per (bank row f,
//    channel c); blockIdx.x walks f, so the blocks in flight share one
//    channel's spectra in L2 and device memory sees them about once (the
//    F-fold re-read of 105 MB at the serving shape would not fit the 50 MB
//    L2 otherwise).
//  * Stage 0 goes straight into registers: thread t loads bins t + T i
//    (coalesced), multiplies by the bank and transforms in registers;
//    shared memory sees each sample twice per exchange, in passes - 1
//    exchanges (2 at N = 2048).
//  * Up to N = 4096 each epoch's spectrum bins are loaded into registers
//    while the epoch before is transformed, so the loads wait on no
//    transform.
//  * The core leaves sample t + T i in slot i, the layout of the loads, so
//    each thread owns fixed samples in every epoch, the epilogue folds each
//    epoch into its epoch sums, and the (C, F, N) planes are written once,
//    coalesced, with the 1/N^2 and 1/E scales applied at the write.  No
//    coefficient ever reaches device memory.
//  * All E epochs run inside the block, so a ragged epoch count needs no
//    chunking and no epoch is ever padded in.
//  * __launch_bounds__(T) lets each thread keep its epoch sums in
//    registers up to N = 4096; at N = 8192 they sit in shared memory at
//    the thread's own samples (fft_regs.cuh, kAccSmem).  ptxas -v in the
//    build log reports any spill.
// Everything runs in float32.  The unit phase is x * rsqrtf(|x|^2) with no
// guard: |x| = 0 yields NaN, as the reference's 0/0 does.
//
// A complex bank (CX) arrives as contiguous complex64 (F, N), read as
// float2 through the read-only cache in each epoch's stage 0 (8 N bytes a
// row, 16 KB at N = 2048: L1-resident across the epochs); the real bank
// row sits in registers.  Stage 0 is then the complex product s * b, and
// everything after it is the real kernel's.
//
// "amax" gives the synchrosqueezing noise gate (fused_ssq.cu) each epoch's
// peak power: torch finishes the max over f.  fused_ssq.cu gates each cell
// on p >= rel_threshold x that peak, so both kernels must form p bit for
// bit; both take W's stage 0 (spectrum x bank / N: the inverse DFT's 1/N
// folded into the bank, exact for N = 2^k) and p from ssq_row.cuh, on the
// same core.  It is "power_each" (below) with a max in place of the write:
// the same plan, the bank row where "power_each" keeps it, all E epochs in
// the block.  A thread's max over its samples, then a shuffle over its
// warp, then one integer atomicMax a warp into the zero-filled (C, F, E)
// output: no barrier of its own, and a result that does not depend on the
// order of the warps.
//
// "power_each" (the long-recording paths: one signal is one window of one
// channel; superlets, single-trial power, scattering) has no reduction.
// What bounds it is its output, written once: E*C*F*N floats at most (3.4
// GB at 512 windows x channels of 16384 samples, 100 rows; 2.4 GB of it
// is what the streaming caller keeps), against 51,200 transforms of 16384
// points there (about 1.1 ms of fp32 arithmetic at the card's peak).  It
// runs on the register-resident core too (fused_each_kernel):
//  * One block per (bank row f, slice of signals); blockIdx.x walks f, so
//    the blocks in flight share a signal's spectrum in L2.  A block loops
//    over its signals (up to kEachSignals, more where the signal count
//    passes the grid's 65535 slices) as the reductions loop over epochs,
//    so its bank row and staged twiddles are loaded once, not once per
//    transform; up to N = 4096 the next signal's bins are loaded while the
//    signal before is transformed.
//  * The bank row sits in registers, and at N = 16384 (1024 threads of 64
//    registers) in shared memory beside the exchange buffer, each thread
//    reading its own bins.
//  * Only what the caller keeps is written: the columns [keep_lo, keep_hi)
//    of each signal's rows, at out + (b / group) stride_group +
//    (b % group) stride_signal + f stride_row + (n - keep_lo) for signal b.
//    The whole-window (E*C, F, N) plane is the case group = 1,
//    stride_group = F N, stride_row = N, [0, N); the long-recording path
//    writes each window's interior straight into its place in the
//    (channels, F, span) plane, with no crop-and-paste pass after it.
//
// "power_each" at N = 32768 (fused_each_split_kernel: the long recording
// at RawWavelet's default window of 16384, extended by its halos to
// 32768).  A 32768-point complex row is 256 KB, the whole register file
// of an SM, and the 16384-point plan already runs 1024 threads of 64
// registers, so no block holds the row.  One exact radix-2 decimation in
// frequency on the output index splits it instead.  With H = N / 2,
// Z[k] = bank[f, k] spec[b, k] and w = exp(+2 pi i / N):
//     x[2m]     = sum_{k < H} (Z[k] + Z[k + H]) exp(+2 pi i k m / H)
//     x[2m + 1] = sum_{k < H} (Z[k] - Z[k + H]) w^k exp(+2 pi i k m / H)
// Each output parity is one 16384-point inverse DFT of the core
// (Plan<14>), whose stage 0 is the product, the butterfly and, for the
// odd parity, w^k from a float32 table built on the host in float64
// (kernels/__init__.py: split_twiddles), read after the core's table.
// What bounds it is the transform: 102,400 of 16384 points a batch of 512
// windows x channels and 100 rows, 117 GFLOP, about 1.8 ms of fp32
// arithmetic at the card's peak, against 3.4 GB of kept output written
// once (1.0 ms).  The design is fused_each_kernel's, with these
// differences:
//  * One block per (bank row f, slice of signals), blockIdx.x walking f,
//    so the blocks in flight share a signal's spectrum in L2.  A block
//    runs the even parity, keeps |x[2m]|^2 / N^2 in shared memory (H
//    floats beside the 136 KB exchange buffer, each thread at its own m:
//    no barrier), then runs the odd parity: the core leaves x[2m + 1] in
//    the slot where the thread kept x[2m], so each thread writes its
//    (x[2m], x[2m + 1]) pairs as one float2, coalesced, into the columns
//    it keeps.
//  * The 128 KB bank row does not fit beside them: both parities read the
//    bins k and k + H of the bank, the spectrum and the odd parity's w^k
//    through the read-only path; the 13 MB bank and the spectra of the
//    signals in flight stay in the 50 MB L2.
// Offsets into the spectra and the output are size_t / long long: E*C*F*N
// passes 2^31 at large batches.

#include <cuda_runtime.h>

#include "fft_regs.cuh"
#include "ssq_row.cuh"

namespace {

enum Epilogue { kPower = 0, kItc = 1, kPowerItc = 2, kAmax = 3 };

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384; "power_each" also 2N

// The epoch reductions on the register-resident core.  EPI is one of
// kPower, kItc, kPowerItc.
template <int EPI, int LOG2N, bool CX>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads)
fused_cwt_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= K
                 const float* __restrict__ bank,      // (F, N); CX: (F, N) float2
                 const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                 float* __restrict__ out0,            // (C, F, N)
                 float* __restrict__ out1,            // (C, F, N), power_itc only
                 float* __restrict__ out_im,          // (C, F, N) or null, below
                 int n_epochs, int n_channels, int n_freqs, int k_bins,
                 int row_len, float power_scale, float itc_scale) {
  using PL = fft_regs::Plan<LOG2N>;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  // The epoch sums a sample: |x|^2 (power), Re and Im of x / |x| (itc).
  constexpr int kSums = EPI == kPowerItc ? 3 : EPI == kItc ? 2 : 1;
  constexpr int kP = 0, kRe = EPI == kItc ? 0 : 1, kIm = kRe + 1;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2N, kSums>(smem, twiddle, tid);

  float bank_reg[kR];
  const float* bank_row = bank + static_cast<size_t>(f) * N;
  // CX: row f of the float2 bank, read in every epoch's stage 0.
  const float2* cbank_row = reinterpret_cast<const float2*>(bank) +
                            static_cast<size_t>(f) * N;
  if constexpr (!CX) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k = tid + i * T;
      bank_reg[i] = k < k_bins ? bank_row[k] : 0.f;
    }
  }

  fft_regs::EpochSums<LOG2N, kSums> acc(smem, tid);

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  float2 bins[kR];   // kAhead: epoch e + 1's bins, loaded during epoch e
  if constexpr (PL::kAhead) fft_regs::load_bins<LOG2N>(bins, sp, k_bins, tid);
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    if constexpr (!PL::kAhead) fft_regs::load_bins<LOG2N>(bins, sp, k_bins, tid);
    float2 x[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k = tid + i * T;
      if constexpr (CX) {
        x[i] = k < k_bins ? fft_regs::bank_times_rn(bins[i], __ldg(cbank_row + k))
                          : make_float2(0.f, 0.f);
      } else {
        x[i] = fft_regs::bank_times_rn(bins[i], bank_reg[i]);
      }
    }
    if constexpr (PL::kAhead) {
      if (e + 1 < n_epochs) {
        fft_regs::load_bins<LOG2N>(bins, sp + epoch_stride, k_bins, tid);
      }
    }
    fft_regs::inverse_fft<LOG2N>(x, buf, tw, tid);

    // Epilogue: fold this epoch into the accumulators.
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float p = x[i].x * x[i].x + x[i].y * x[i].y;
      if (EPI != kItc) acc(kP, i) += p;
      if (EPI != kPower) {
        const float inv = rsqrtf(p);
        acc(kRe, i) += x[i].x * inv;
        acc(kIm, i) += x[i].y * inv;
      }
    }
  }

  const size_t base = (static_cast<size_t>(c) * n_freqs + f) * N;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int idx = tid + i * T;
    if (EPI != kItc) out0[base + idx] = acc(kP, i) * power_scale;
    if (EPI != kPower) {
      const float re = acc(kRe, i), im = acc(kIm, i);
      float* itc_out = EPI == kItc ? out0 : out1;
      if (out_im != nullptr) {
        // The unit-phase sums themselves (ninw_fused_cwt_sums): a sharded
        // caller adds them across devices before it takes |.|.
        itc_out[base + idx] = re * itc_scale;
        out_im[base + idx] = im * itc_scale;
      } else {
        itc_out[base + idx] = sqrtf(re * re + im * im) * itc_scale;
      }
    }
  }
}

// Signals a "power_each" block transforms with one load of its bank row.
constexpr int kEachSignals = 8;
constexpr int kMaxSlices = 65535;   // grid y

// "power_each" and "amax" on the register-resident core: the bank row in
// registers, or (kBankSmem, N = 16384, where a thread has 64 registers) in
// shared memory after the exchange buffer, each thread staging and
// reading its own bins, so that no barrier orders them.
template <int LOG2N>
struct EachPlan {
  using PL = fft_regs::Plan<LOG2N>;
  static constexpr bool kBankSmem = LOG2N == 14;
  static constexpr int kBankOffset = fft_regs::SmemLayout<LOG2N, 0>::kSumsOffset;
  static constexpr size_t kBytes =
      sizeof(float2) * kBankOffset + (kBankSmem ? sizeof(float) * PL::kN : 0);
  static_assert(kBytes <= 232448, "shared memory per block");
};

// The max of v >= 0 over the T threads of a warp, or over the block where
// it is narrower than a warp (T = 16 at N = 256): the shuffle's mask and
// width name only the threads that exist.
template <int T>
__device__ __forceinline__ float warp_max(float v) {
  constexpr int kWidth = T < 32 ? T : 32;
  constexpr unsigned kMask = T < 32 ? (1u << (T % 32)) - 1u : 0xffffffffu;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kMask, v, o, kWidth));
  }
  return v;
}

// "amax": the per-(channel, row, epoch) peak of |x|^2 / N^2, with W and p
// formed as fused_ssq.cu forms them (ssq_row.cuh).  Each warp's peak goes
// into the zero-filled output by an integer atomicMax on the float's bits:
// p >= 0, so the integer order is the float order, and the max is exact
// and the same whatever order the warps arrive in.
template <int LOG2N>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads)
fused_amax_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= K
                  const float* __restrict__ bank,      // (F, N)
                  const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                  float* __restrict__ out,             // (C, F, E), zero-filled
                  int n_epochs, int n_channels, int n_freqs, int k_bins,
                  int row_len) {
  using PL = fft_regs::Plan<LOG2N>;
  using EP = EachPlan<LOG2N>;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2N, 0>(smem, twiddle, tid);

  const float inv_n = 1.f / static_cast<float>(N);   // exact: N = 2^LOG2N
  float bank_reg[EP::kBankSmem ? 1 : kR];
  float* bank_smem = reinterpret_cast<float*>(smem + EP::kBankOffset);
  const float* bank_row = bank + static_cast<size_t>(f) * N;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int k = tid + i * T;
    const float b = ssq::scaled_bank(bank_row, k, k_bins, inv_n);
    if constexpr (EP::kBankSmem) {
      bank_smem[k] = b;
    } else {
      bank_reg[i] = b;
    }
  }

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  int* peaks = reinterpret_cast<int*>(out) +
               (static_cast<size_t>(c) * n_freqs + f) * n_epochs;
  // No loads ahead (Plan::kAhead): the next epoch's bins in registers cost
  // this kernel more in occupancy than they hid (core_variants.py, PERF.md
  // section 6).
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    float2 x[kR];
    fft_regs::load_bins<LOG2N>(x, sp, k_bins, tid);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      x[i] = ssq::stage0(x[i], EP::kBankSmem ? bank_smem[tid + i * T]
                                             : bank_reg[i]);
    }
    fft_regs::inverse_fft<LOG2N>(x, buf, tw, tid);

    float peak = 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) peak = fmaxf(peak, ssq::power(x[i]));
    peak = warp_max<T>(peak);
    if ((tid & 31) == 0) atomicMax(peaks + e, __float_as_int(peak));
  }
}

// |x|^2 / N^2 of every (signal, bank row) pair, columns [keep_lo, keep_hi)
// (see the header).  Block (f, slice) takes signals slice, slice + slices,
// ... of the contiguous (E*C, L) spectra.
template <int LOG2N>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads)
fused_each_kernel(const float2* __restrict__ spec,     // (E*C, L), L >= K
                  const float* __restrict__ bank,      // (F, N)
                  const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                  float* __restrict__ out,
                  int n_signals, int k_bins, int row_len, int group,
                  long long stride_group, long long stride_signal,
                  long long stride_row, int keep_lo, int keep_hi,
                  float power_scale) {
  using PL = fft_regs::Plan<LOG2N>;
  using EP = EachPlan<LOG2N>;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* tw = fft_regs::stage_twiddles<LOG2N, 0>(smem, twiddle, tid);

  // Bin tid + T i of the bank row; kBankSmem: staged by the thread that
  // reads it, so no barrier orders it.
  float bank_reg[EP::kBankSmem ? 1 : kR];
  float* bank_smem = reinterpret_cast<float*>(smem + EP::kBankOffset);
  const float* bank_row = bank + static_cast<size_t>(f) * N;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int k = tid + i * T;
    const float b = k < k_bins ? bank_row[k] : 0.f;
    if constexpr (EP::kBankSmem) {
      bank_smem[k] = b;
    } else {
      bank_reg[i] = b;
    }
  }

  const int slices = gridDim.y;
  int b = blockIdx.y;
  float2 bins[kR];   // kAhead: the next signal's bins, loaded meanwhile
  if constexpr (PL::kAhead) {
    fft_regs::load_bins<LOG2N>(bins, spec + static_cast<size_t>(b) * row_len,
                               k_bins, tid);
  }
  for (; b < n_signals; b += slices) {   // b is the same over the block
    if constexpr (!PL::kAhead) {
      fft_regs::load_bins<LOG2N>(bins, spec + static_cast<size_t>(b) * row_len,
                                 k_bins, tid);
    }
    float2 x[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float bk = EP::kBankSmem ? bank_smem[tid + i * T] : bank_reg[i];
      x[i] = fft_regs::bank_times_rn(bins[i], bk);
    }
    if constexpr (PL::kAhead) {
      if (b + slices < n_signals) {
        fft_regs::load_bins<LOG2N>(
            bins, spec + static_cast<size_t>(b + slices) * row_len, k_bins, tid);
      }
    }
    fft_regs::inverse_fft<LOG2N>(x, buf, tw, tid);

    const long long base = (b / group) * stride_group +
                           (b % group) * stride_signal + f * stride_row - keep_lo;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int n = tid + i * T;
      if (n >= keep_lo && n < keep_hi) {
        out[base + n] = (x[i].x * x[i].x + x[i].y * x[i].y) * power_scale;
      }
    }
  }
}

// "power_each" at N = 2 H = 32768 on the 16384-point core (see the
// header): shared memory holds the exchange buffer, then the even
// parity's powers.
struct SplitPlan {
  using PL = fft_regs::Plan<kMaxLog2N>;
  static constexpr int kH = PL::kN;
  static constexpr int kEvenOffset = fft_regs::SmemLayout<kMaxLog2N, 0>::kSumsOffset;
  static constexpr size_t kBytes = sizeof(float2) * kEvenOffset + sizeof(float) * kH;
  static_assert(!PL::kTwSmem && !PL::kPingPong, "one buffer, the table read");
  static_assert(kBytes <= 232448, "shared memory per block");
};

// Stage 0 of output parity `odd` of one signal: thread slot i holds bin
// k = tid + T i of Z[k] + Z[k + H] (even) or of (Z[k] - Z[k + H]) w^k
// (odd), Z = bank x spectrum on the k < k_bins bins.
__device__ __forceinline__ void split_stage0(
    float2 (&x)[SplitPlan::PL::kR], const float2* __restrict__ row,
    const float* __restrict__ bank_row, const float2* __restrict__ wk,
    int k_bins, bool odd, int tid) {
  constexpr int T = SplitPlan::PL::kThreads, H = SplitPlan::kH;
  const bool upper = k_bins > H;   // K = N: the bins k + H are read too
#pragma unroll
  for (int i = 0; i < SplitPlan::PL::kR; ++i) {
    const int k = tid + i * T;
    const float2 lo = fft_regs::bank_times_rn(__ldg(row + k), __ldg(bank_row + k));
    const float2 hi = upper ? fft_regs::bank_times_rn(__ldg(row + k + H),
                                                      __ldg(bank_row + k + H))
                            : make_float2(0.f, 0.f);
    x[i] = odd ? fft_regs::cmul_rn(fft_regs::csub(lo, hi), __ldg(wk + k))
               : fft_regs::cadd(lo, hi);
  }
}

// |x|^2 / N^2 of every (signal, bank row) pair at N = 32768, columns
// [keep_lo, keep_hi), written as fused_each_kernel writes them.  `twiddle`
// is the core's table at H, then w^k for k < H.  The two parities run
// through one copy of the core (a loop, not unrolled): with two inlined
// copies ptxas spilled 1400 bytes a thread at the 64 registers of 1024
// threads, and a 512 x 32768 x 100 batch took 54.1 ms against 10.2 ms
// (NVIDIA H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(SplitPlan::PL::kThreads)
fused_each_split_kernel(const float2* __restrict__ spec,     // (E*C, L), L >= K
                        const float* __restrict__ bank,      // (F, N)
                        const float2* __restrict__ twiddle,
                        float* __restrict__ out,
                        int n_signals, int k_bins, int row_len, int group,
                        long long stride_group, long long stride_signal,
                        long long stride_row, int keep_lo, int keep_hi,
                        float power_scale) {
  using PL = SplitPlan::PL;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer
  float* even = reinterpret_cast<float*>(smem + SplitPlan::kEvenOffset);

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* wk = twiddle + PL::kTwiddles;
  const float* bank_row = bank + static_cast<size_t>(f) * (2 * SplitPlan::kH);

  for (int b = blockIdx.y; b < n_signals; b += gridDim.y) {
    const float2* row = spec + static_cast<size_t>(b) * row_len;
#pragma unroll 1
    for (int odd = 0; odd < 2; ++odd) {
      float2 x[kR];
      split_stage0(x, row, bank_row, wk, k_bins, odd, tid);
      fft_regs::inverse_fft<kMaxLog2N>(x, buf, twiddle, tid);
      if (!odd) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          even[tid + i * T] = (x[i].x * x[i].x + x[i].y * x[i].y) * power_scale;
        }
        continue;
      }
      // Column n of this (signal, row) lands at o[n - keep_lo]; a pair
      // (2m, 2m + 1) goes out as one float2 where that address is
      // 8-aligned.
      float* o = out + ((b / group) * stride_group +
                        (b % group) * stride_signal + f * stride_row);
      const bool pairs =
          (((reinterpret_cast<unsigned long long>(o) >> 2) ^ keep_lo) & 1) == 0;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int m = tid + i * T, n = 2 * m;
        const float pe = even[m];
        const float po = (x[i].x * x[i].x + x[i].y * x[i].y) * power_scale;
        if (pairs && n >= keep_lo && n + 1 < keep_hi) {
          *reinterpret_cast<float2*>(o + (n - keep_lo)) = make_float2(pe, po);
        } else {
          if (n >= keep_lo && n < keep_hi) o[n - keep_lo] = pe;
          if (n + 1 >= keep_lo && n + 1 < keep_hi) o[n + 1 - keep_lo] = po;
        }
      }
    }
  }
}

struct Args {
  const float2* spec;
  const float* bank;
  const float2* twiddle;
  float* out0;
  float* out1;
  float* out_im;   // the unit-phase sums' Im plane, or null (fused_cwt_kernel)
  int n_epochs, n_channels, n_freqs, log2n, k_bins, row_len;
  float power_scale, itc_scale;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// "amax" on the register-resident core; `out0` zero-filled by the caller.
template <int LOG2N>
cudaError_t launch_amax(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = EachPlan<LOG2N>::kBytes;
  auto kernel = fused_amax_kernel<LOG2N>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, fft_regs::Plan<LOG2N>::kThreads, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.out0, a.n_epochs, a.n_channels,
      a.n_freqs, a.k_bins, a.row_len);
  return cudaGetLastError();
}

cudaError_t launch_amax_n(const Args& a, cudaStream_t s) {
  switch (a.log2n) {
    case 8: return launch_amax<8>(a, s);
    case 9: return launch_amax<9>(a, s);
    case 10: return launch_amax<10>(a, s);
    case 11: return launch_amax<11>(a, s);
    case 12: return launch_amax<12>(a, s);
    case 13: return launch_amax<13>(a, s);
    default: return launch_amax<14>(a, s);
  }
}

// Where "power_each" writes: see the header.
struct EachLayout {
  int group;
  long long stride_group, stride_signal, stride_row;
  int keep_lo, keep_hi;
};

template <int LOG2N>
cudaError_t launch_each(const Args& a, int n_signals, const EachLayout& o,
                        cudaStream_t stream) {
  constexpr size_t smem = EachPlan<LOG2N>::kBytes;
  auto kernel = fused_each_kernel<LOG2N>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int want = (n_signals + kEachSignals - 1) / kEachSignals;
  const dim3 grid(a.n_freqs, want < kMaxSlices ? want : kMaxSlices);
  kernel<<<grid, fft_regs::Plan<LOG2N>::kThreads, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.out0, n_signals, a.k_bins, a.row_len,
      o.group, o.stride_group, o.stride_signal, o.stride_row, o.keep_lo,
      o.keep_hi, a.power_scale);
  return cudaGetLastError();
}

// "power_each" at N = 32768: the split on the 16384-point core.
cudaError_t launch_each_split(const Args& a, int n_signals, const EachLayout& o,
                              cudaStream_t stream) {
  constexpr size_t smem = SplitPlan::kBytes;
  const cudaError_t err = allow_smem(fused_each_split_kernel, smem);
  if (err != cudaSuccess) return err;
  const int want = (n_signals + kEachSignals - 1) / kEachSignals;
  const dim3 grid(a.n_freqs, want < kMaxSlices ? want : kMaxSlices);
  fused_each_split_kernel<<<grid, SplitPlan::PL::kThreads, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.out0, n_signals, a.k_bins, a.row_len,
      o.group, o.stride_group, o.stride_signal, o.stride_row, o.keep_lo,
      o.keep_hi, a.power_scale);
  return cudaGetLastError();
}

cudaError_t launch_each_n(const Args& a, int n_signals, const EachLayout& o,
                          cudaStream_t s) {
  switch (a.log2n) {
    case kMaxLog2N + 1: return launch_each_split(a, n_signals, o, s);
    case 8: return launch_each<8>(a, n_signals, o, s);
    case 9: return launch_each<9>(a, n_signals, o, s);
    case 10: return launch_each<10>(a, n_signals, o, s);
    case 11: return launch_each<11>(a, n_signals, o, s);
    case 12: return launch_each<12>(a, n_signals, o, s);
    case 13: return launch_each<13>(a, n_signals, o, s);
    default: return launch_each<14>(a, n_signals, o, s);
  }
}

int log2_of(int n) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return (1 << log2n) == n && log2n >= kMinLog2N && log2n <= kMaxLog2N ? log2n : -1;
}

// The epoch reductions on the register-resident core.
template <int EPI, int LOG2N, bool CX>
cudaError_t launch_reduce(const Args& a, cudaStream_t stream) {
  using PL = fft_regs::Plan<LOG2N>;
  constexpr size_t smem =
      fft_regs::SmemLayout<LOG2N, EPI == kPowerItc ? 3 : EPI == kItc ? 2 : 1>::kBytes;
  auto kernel = fused_cwt_kernel<EPI, LOG2N, CX>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, PL::kThreads, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.out0, a.out1, a.out_im, a.n_epochs,
      a.n_channels, a.n_freqs, a.k_bins, a.row_len, a.power_scale, a.itc_scale);
  return cudaGetLastError();
}

template <int EPI, bool CX>
cudaError_t launch_reduce_n(const Args& a, cudaStream_t s) {
  switch (a.log2n) {
    case 8: return launch_reduce<EPI, 8, CX>(a, s);
    case 9: return launch_reduce<EPI, 9, CX>(a, s);
    case 10: return launch_reduce<EPI, 10, CX>(a, s);
    case 11: return launch_reduce<EPI, 11, CX>(a, s);
    case 12: return launch_reduce<EPI, 12, CX>(a, s);
    case 13: return launch_reduce<EPI, 13, CX>(a, s);
    default: return launch_reduce<EPI, 14, CX>(a, s);
  }
}

template <bool CX>
cudaError_t launch_reduce_epi(int epilogue, const Args& a, cudaStream_t s) {
  switch (epilogue) {
    case kPower: return launch_reduce_n<kPower, CX>(a, s);
    case kItc: return launch_reduce_n<kItc, CX>(a, s);
    default: return launch_reduce_n<kPowerItc, CX>(a, s);
  }
}

}  // namespace

// Launch "power_each" on `stream`: |cwt|^2 / N^2 of each of the n_signals
// rows of the contiguous (n_signals, row_len) spectra against each bank
// row, columns [keep_lo, keep_hi) of signal b and row f written at
// out + (b / group) stride_group + (b % group) stride_signal + f stride_row
// + (n - keep_lo) (strides in floats).  N is a power of two in 256 ...
// 32768; `twiddle` is the core's table at N, and at N = 32768 the core's
// table at 16384 followed by w^k = exp(+2 pi i k / N), k < N / 2.
// Returns the cudaError_t of the launch (0 on success); arguments the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int ninw_fused_power_each(const void* spec, const void* bank,
                                     const void* twiddle, void* out,
                                     int n_signals, int n_freqs, int n,
                                     int k_bins, int row_len, int group,
                                     long long stride_group,
                                     long long stride_signal,
                                     long long stride_row, int keep_lo,
                                     int keep_hi, void* stream) {
  const int log2n = n == 2 << kMaxLog2N ? kMaxLog2N + 1 : log2_of(n);
  if (log2n < 0 || k_bins < 1 || k_bins > n || row_len < k_bins ||
      n_signals < 1 || n_freqs < 1 || group < 1 || keep_lo < 0 ||
      keep_hi > n || keep_lo >= keep_hi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.out0 = static_cast<float*>(out);
  a.n_freqs = n_freqs;
  a.log2n = log2n;
  a.k_bins = k_bins;
  a.row_len = row_len;
  a.power_scale = static_cast<float>(1.0 / (static_cast<double>(n) * n));
  const EachLayout o{group, stride_group, stride_signal, stride_row, keep_lo, keep_hi};
  return static_cast<int>(launch_each_n(a, n_signals, o, static_cast<cudaStream_t>(stream)));
}

namespace {

// The checks and launch shared by ninw_fused_cwt and ninw_fused_cwt_sums.
int launch_fused(int epilogue, const void* spec, const void* bank,
                 const void* twiddle, void* out0, void* out1, void* out_im,
                 int n_epochs, int n_channels, int n_freqs, int n, int k_bins,
                 int row_len, int complex_bank, double power_scale,
                 double itc_scale, void* stream) {
  const int log2n = log2_of(n);
  if (log2n < 0 || k_bins < 1 || k_bins > n || row_len < k_bins ||
      n_epochs < 1 || n_channels < 1 || n_channels > 65535 || n_freqs < 1 ||
      epilogue < kPower || epilogue > kAmax ||
      (complex_bank && epilogue > kPowerItc) ||
      (epilogue == kPowerItc && out1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.out_im = static_cast<float*>(out_im);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.log2n = log2n;
  a.k_bins = k_bins;
  a.row_len = row_len;
  a.power_scale = static_cast<float>(power_scale);
  a.itc_scale = static_cast<float>(itc_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kAmax:
      return static_cast<int>(launch_amax_n(a, s));
    default:
      return static_cast<int>(complex_bank ? launch_reduce_epi<true>(epilogue, a, s)
                                           : launch_reduce_epi<false>(epilogue, a, s));
  }
}

}  // namespace

// Launch one fused reduction or "amax" on `stream`.  Returns the
// cudaError_t of the launch (0 on success); arguments the kernel does not
// take return cudaErrorInvalidValue without launching.  C is a grid axis
// (C <= 65535).  complex_bank != 0 reads `bank` as complex64 (F, N), for
// "power", "itc" and "power_itc" only.  `twiddle` is the core's table
// (kernels/__init__.py: core_twiddles).  "amax" adds into `out0` by
// atomicMax, so the caller zero-fills it.
extern "C" int ninw_fused_cwt(int epilogue, const void* spec, const void* bank,
                              const void* twiddle, void* out0, void* out1,
                              int n_epochs, int n_channels, int n_freqs, int n,
                              int k_bins, int row_len, int complex_bank,
                              void* stream) {
  const double power_epochs =
      epilogue == kPower || epilogue == kPowerItc ? n_epochs : 1.0;
  return launch_fused(epilogue, spec, bank, twiddle, out0, out1, nullptr,
                      n_epochs, n_channels, n_freqs, n, k_bins, row_len,
                      complex_bank,
                      1.0 / (static_cast<double>(n) * n * power_epochs),
                      1.0 / n_epochs, stream);
}

// Launch "itc" or "power_itc" on `stream` with the epoch SUMS as outputs,
// for a caller that adds them across devices before it finishes the means:
// "itc" writes Re and Im of sum_e x_e / |x_e| to out_re and out_im;
// "power_itc" also writes sum_e |x_e|^2 / N^2 to out_power.  Otherwise as
// ninw_fused_cwt.
extern "C" int ninw_fused_cwt_sums(int epilogue, const void* spec,
                                   const void* bank, const void* twiddle,
                                   void* out_power, void* out_re, void* out_im,
                                   int n_epochs, int n_channels, int n_freqs,
                                   int n, int k_bins, int row_len,
                                   int complex_bank, void* stream) {
  if ((epilogue != kItc && epilogue != kPowerItc) || out_re == nullptr ||
      out_im == nullptr || (epilogue == kPowerItc && out_power == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool itc = epilogue == kItc;
  return launch_fused(epilogue, spec, bank, twiddle, itc ? out_re : out_power,
                      itc ? nullptr : out_re, out_im, n_epochs, n_channels,
                      n_freqs, n, k_bins, row_len, complex_bank,
                      1.0 / (static_cast<double>(n) * n), 1.0, stream);
}
