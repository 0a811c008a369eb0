// Fused backward (VJP) of the epoch-mean power for Hopper (sm_90a):
//     recompute x = iDFT(bank x spectrum) -> weight by the cotangent ->
//     forward DFT -> the two reductions the adjoint needs.
//
// Replaces the Pallas TPU kernel ninwavelets_tpu/ops/fused.py:_bwd_kernel
// (launched by _fused_power_bwd), for a real (F, N) bank and, with
// CX = true, for a complex (Normal/Twice-mode) one (its complex_bank=True
// branches).
//
// What it computes, for every channel c, bank row f and epoch e, with S_e
// the signal spectrum on its first K bins (K = N/2 on the analytic
// interpolate=True path, K = N otherwise):
//     x[n]   = sum_{k<K} bank[f,k] S_e[k] exp(+2 pi i k n / N)   (unnormalised)
//     u[k]   = sum_n scale g[c,f,n] x[n] exp(-2 pi i k n / N),   k < K
//     dbank_part[c, f, k]      = sum_e Re(u[k] conj(S_e[k]))
//     t_part[grp, e, c, k]     = sum_{f in row group grp} bank[f,k] u[k]
// with scale = 2 / (E N): the adjoint of |.|^2 / E (2/E) times the 1/N the
// normalised iDFT of the reference carries, folded into one constant applied
// to g at its load.  u is then exactly the reference's
// u = fft((2/E) g ifft(bank S)) (ninwavelets_tpu/ops/fused.py:756-763).
// A complex bank (CX) keeps the same u; then
//     dbank_part[c, f, k]      = sum_e u[k] conj(S_e[k])          (complex)
//     t_part[grp, e, c, k]     = sum_{f in grp} conj(bank[f,k]) u[k]
// PyTorch's gradient convention, sum u conj(S) / N, as the port's plain
// adjoint mean_power_bwd computes it: the conjugate of the reference's
// sum conj(u) S / N (fused.py:1002-1005), the same derivative.
// Outside the kernel, in torch: the rFFT / FFT of the signals, the sum of
// dbank_part over c (and its 1/N, as the reference applies it), the zero
// upper bins of dbank, the sum of t_part over row groups, ds = Re(iFFT(t)).
//
// What bounds it on this card: two N-point transforms per (e, c, f), 0.82 M
// of 2048 points at 64 epochs x 64 channels x 100 rows, about 1.4 ms of
// fp32 arithmetic at the card's peak, against about 0.12 GB of compulsory
// traffic and ceil(F / G) E C K complex t partials written and read back
// (0.84 GB at G = 4).
//
// The design, on the register-resident core of fft_regs.cuh (T = N/16
// threads of 16 samples, 32 at N = 8192):
//  * One block per (group of G bank rows, channel c); blockIdx.x walks the
//    groups, so the blocks in flight share one channel's spectra in L2.
//    All E epochs run inside the block: no epoch is padded in.
//  * The forward DFT is the core's inverse between two conjugations
//    (fft_regs::forward_fft).  The inverse leaves sample t + T i in slot i,
//    which is where g is loaded (coalesced) and where the forward transform
//    takes its input; it returns bin t + T i in slot i, the layout of the
//    spectrum's bins.  So a row is stage 0 in registers, the inverse, the
//    product by scale g, the forward, and the epilogue on the thread's own
//    bins: no bit reversal, no radix-2 pass, one twiddle table.
//  * Registers hold the row's samples and, at the thread's own bins
//    (fft_regs.cuh: ThreadPlanes), the epoch's t sums and the G dbank
//    sums: to N = 4096 in registers; at N = 8192, where 32 samples a
//    thread leave no room, in shared memory (at N = 16384, 1024 threads of
//    64 registers, they stay in registers and spill).
//  * The epoch's spectrum bins, which serve the G rows' stage 0 and
//    epilogues, are re-read at each use (8 KB a row at N = 2048,
//    L1-resident across the G rows): held in registers for a complex bank
//    they gained nothing measurable.  So are the bank and cotangent rows,
//    the same for every epoch (a block's G rows: 12 KB a row at N = 2048,
//    L1-resident); holding g would take G x 16 more registers a thread.
//  * Those loads are plain loads through pointers that are not
//    __restrict__.  With __ldg on __restrict__ pointers the compiler
//    hoisted them across the transforms' barriers and held them there:
//    255 registers and spills at most N for a real bank, and a slower
//    kernel (PERF.md).
//  * G rows a block: 4 to N = 4096, 2 at 8192, 1 at 16384; a complex bank
//    doubles the dbank sums (float2), so CX halves G.  G trades the t
//    partials' bytes (1/G) against registers and the grid's size.  G = 2
//    to N = 4096, and the sums in shared memory at every N, were slower on
//    the card (PERF.md).
//  * Each block writes its t partial for (e, c, group) once; torch sums the
//    groups.  The reduction over f is deterministic, with no atomics.
// Everything runs in float32.

#include <cuda_runtime.h>

#include <type_traits>

#include "fft_regs.cuh"

namespace {

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384

template <int LOG2N, bool CX>
struct BwdPlan {
  using PL = fft_regs::Plan<LOG2N>;
  using Acc = std::conditional_t<CX, float2, float>;
  static constexpr int kRealRows = LOG2N <= 12 ? 4 : (LOG2N == 13 ? 2 : 1);
  static constexpr int kRows = CX && kRealRows > 1 ? kRealRows / 2 : kRealRows;
  // The t sums and the dbank sums in shared memory.
  static constexpr bool kSumsSmem = LOG2N == 13;
  // Shared memory in float2: the exchange buffer(s), the staged twiddles
  // (fft_regs::SmemLayout), then (kSumsSmem) N t sums and G N dbank sums.
  static constexpr int kSumsOffset = fft_regs::SmemLayout<LOG2N, 0>::kSumsOffset;
  static constexpr size_t kBytes =
      sizeof(float2) * kSumsOffset +
      (kSumsSmem ? (sizeof(float2) + sizeof(Acc) * kRows) * PL::kN : 0);
  static_assert(kBytes <= 232448, "shared memory per block");
};

// spec, bank and cot are read by plain loads and are not __restrict__: see
// the header.
template <int LOG2N, bool CX>
__global__ void __launch_bounds__(fft_regs::Plan<LOG2N>::kThreads)
fused_cwt_bwd_kernel(const float2* spec,                  // (E, C, L), L >= K
                     const float* bank,                   // (F, N); CX: float2
                     const float* cot,                    // (C, F, N): g
                     const float2* __restrict__ twiddle,  // core table (fft_regs.cuh)
                     float* __restrict__ dbank_part,      // (C, F, K); CX: float2
                     float2* __restrict__ t_part,         // (groups, E, C, K)
                     int n_epochs, int n_channels, int n_freqs, int k_bins,
                     int row_len, float scale) {
  using PL = fft_regs::Plan<LOG2N>;
  using BP = BwdPlan<LOG2N, CX>;
  using Acc = typename BP::Acc;
  constexpr int kR = PL::kR;
  constexpr int T = PL::kThreads;
  constexpr int N = PL::kN;
  constexpr int G = BP::kRows;
  extern __shared__ float2 smem[];
  float2* buf = smem;   // the exchange buffer(s)

  const int grp = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int f0 = grp * G;
  const int rows = min(G, n_freqs - f0);
  const float2* tw = fft_regs::stage_twiddles<LOG2N, 0>(smem, twiddle, tid);

  float2* sums = smem + BP::kSumsOffset;
  fft_regs::ThreadPlanes<float2, 1, LOG2N, BP::kSumsSmem> t_acc(sums, tid);
  fft_regs::ThreadPlanes<Acc, G, LOG2N, BP::kSumsSmem> acc(
      reinterpret_cast<Acc*>(sums + N), tid);
  acc.zero();

  const float* bank_rows = bank + static_cast<size_t>(f0) * N;
  const float2* cbank_rows = reinterpret_cast<const float2*>(bank) +
                             static_cast<size_t>(f0) * N;
  const float* g_rows = cot + (static_cast<size_t>(c) * n_freqs + f0) * N;
  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    // bin(i): bin tid + T i of this epoch's spectrum (0 at k >= K).
    auto bin = [&](int i) {
      const int k = tid + i * T;
      return k < k_bins ? sp[k] : make_float2(0.f, 0.f);
    };
    t_acc.zero();

#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= rows) break;   // block-uniform: the ragged last group
      const float* bank_row = bank_rows + static_cast<size_t>(j) * N;
      const float2* cbank_row = cbank_rows + static_cast<size_t>(j) * N;
      const float* g_row = g_rows + static_cast<size_t>(j) * N;

      float2 x[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = tid + i * T;
        if constexpr (CX) {
          x[i] = k < k_bins ? fft_regs::bank_times_rn(bin(i), cbank_row[k])
                            : make_float2(0.f, 0.f);
        } else {
          x[i] = k < k_bins ? fft_regs::bank_times_rn(bin(i), bank_row[k])
                            : make_float2(0.f, 0.f);
        }
      }
      fft_regs::inverse_fft<LOG2N>(x, buf, tw, tid);
      // Slot i holds sample tid + T i: weigh it by scale g there.
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float w = __fmul_rn(g_row[tid + i * T], scale);
        x[i] = make_float2(__fmul_rn(x[i].x, w), __fmul_rn(x[i].y, w));
      }
      fft_regs::forward_fft<LOG2N>(x, buf, tw, tid);

      // Epilogue on the first K bins (slot i: bin tid + T i): dbank +=
      // Re(u conj S), t += bank u; CX: dbank += u conj S, t += conj(bank) u.
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = tid + i * T;
        if (k < k_bins) {
          const float2 u = x[i];
          const float2 sk = bin(i);
          if constexpr (CX) {
            const float2 b = cbank_row[k];
            Acc& a = acc(j, i);
            a.x += u.x * sk.x + u.y * sk.y;
            a.y += u.y * sk.x - u.x * sk.y;
            float2& t = t_acc(0, i);
            t.x += b.x * u.x + b.y * u.y;
            t.y += b.x * u.y - b.y * u.x;
          } else {
            const float b = bank_row[k];
            acc(j, i) += u.x * sk.x + u.y * sk.y;
            float2& t = t_acc(0, i);
            t.x += b * u.x;
            t.y += b * u.y;
          }
        }
      }
    }

    float2* tp = t_part + ((static_cast<size_t>(grp) * n_epochs + e)
                           * n_channels + c) * k_bins;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k = tid + i * T;
      if (k < k_bins) tp[k] = t_acc(0, i);
    }
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= rows) break;
    Acc* dp = reinterpret_cast<Acc*>(dbank_part) +
              (static_cast<size_t>(c) * n_freqs + f0 + j) * k_bins;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k = tid + i * T;
      if (k < k_bins) dp[k] = acc(j, i);
    }
  }
}

struct BwdArgs {
  const float2* spec;
  const float* bank;
  const float* cot;
  const float2* twiddle;
  float* dbank_part;
  float2* t_part;
  int n_epochs, n_channels, n_freqs, k_bins, row_len;
  float scale;
};

template <int LOG2N, bool CX>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using BP = BwdPlan<LOG2N, CX>;
  constexpr size_t smem = BP::kBytes;
  auto kernel = fused_cwt_bwd_kernel<LOG2N, CX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n_freqs + BP::kRows - 1) / BP::kRows, a.n_channels);
  kernel<<<grid, fft_regs::Plan<LOG2N>::kThreads, smem, stream>>>(
      a.spec, a.bank, a.cot, a.twiddle, a.dbank_part, a.t_part, a.n_epochs,
      a.n_channels, a.n_freqs, a.k_bins, a.row_len, a.scale);
  return cudaGetLastError();
}

int log2_of(int n) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  return (1 << log2n) == n && log2n >= kMinLog2N && log2n <= kMaxLog2N ? log2n : -1;
}

template <bool CX>
int rows_of(int log2n) {
  switch (log2n) {
    case 8: return BwdPlan<8, CX>::kRows;
    case 9: return BwdPlan<9, CX>::kRows;
    case 10: return BwdPlan<10, CX>::kRows;
    case 11: return BwdPlan<11, CX>::kRows;
    case 12: return BwdPlan<12, CX>::kRows;
    case 13: return BwdPlan<13, CX>::kRows;
    case 14: return BwdPlan<14, CX>::kRows;
    default: return 0;
  }
}

template <bool CX>
cudaError_t launch_log2n(int log2n, const BwdArgs& a, cudaStream_t s) {
  switch (log2n) {
    case 8: return launch_bwd<8, CX>(a, s);
    case 9: return launch_bwd<9, CX>(a, s);
    case 10: return launch_bwd<10, CX>(a, s);
    case 11: return launch_bwd<11, CX>(a, s);
    case 12: return launch_bwd<12, CX>(a, s);
    case 13: return launch_bwd<13, CX>(a, s);
    default: return launch_bwd<14, CX>(a, s);
  }
}

}  // namespace

// Bank rows per block at signal length n for a real (complex_bank == 0) or
// complex bank (the row-group size G, which sizes t_part), or 0 when the
// kernel does not take n.
extern "C" int ninw_fused_cwt_bwd_rows(int n, int complex_bank) {
  return complex_bank ? rows_of<true>(log2_of(n)) : rows_of<false>(log2_of(n));
}

// Launch one fused backward on `stream`.  Returns the cudaError_t of the
// launch (0 on success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.  complex_bank != 0 reads `bank`
// as complex64 (F, N) and writes `dbank_part` as complex64 (C, F, K).
// `twiddle` is the core's table (kernels/__init__.py: core_twiddles).
extern "C" int ninw_fused_cwt_bwd(const void* spec, const void* bank,
                                  const void* cot, const void* twiddle,
                                  void* dbank_part, void* t_part, int n_epochs,
                                  int n_channels, int n_freqs, int n, int k_bins,
                                  int row_len, int complex_bank, void* stream) {
  const int log2n = log2_of(n);
  if (log2n < 0 || k_bins < 1 || k_bins > n || row_len < k_bins ||
      n_epochs < 1 || n_channels < 1 || n_channels > 65535 || n_freqs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  a.spec = static_cast<const float2*>(spec);
  a.bank = static_cast<const float*>(bank);
  a.cot = static_cast<const float*>(cot);
  a.twiddle = static_cast<const float2*>(twiddle);
  a.dbank_part = static_cast<float*>(dbank_part);
  a.t_part = static_cast<float2*>(t_part);
  a.n_epochs = n_epochs;
  a.n_channels = n_channels;
  a.n_freqs = n_freqs;
  a.k_bins = k_bins;
  a.row_len = row_len;
  a.scale = static_cast<float>(2.0 / (static_cast<double>(n_epochs) * n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(complex_bank ? launch_log2n<true>(log2n, a, s)
                                       : launch_log2n<false>(log2n, a, s));
}
