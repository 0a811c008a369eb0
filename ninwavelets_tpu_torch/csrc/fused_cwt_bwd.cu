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
// What bounds it on this card: per (e, c, f) it runs two N-point FFTs
// through shared memory (the recompute and the adjoint), log2(N) passes each
// with a barrier between passes.  At 64 epochs x 64 channels x 100 rows x
// 2048 samples that is 9.2e10 flops at 5 N log2 N per FFT (1.4 ms at the
// fp32 peak) against ~0.12 GB of compulsory device traffic (0.04 ms), so
// the shared-memory passes and their barriers bound it, as in the forward.
//
// What the design does about that:
//  * One block per (group of G bank rows, channel c); blockIdx.x walks the
//    groups, so the blocks in flight share one channel's spectra in L2.
//  * Occupancy first: the passes wait on shared memory and barriers, and
//    only other warps hide that.  So each thread owns 4 samples (to
//    N = 4096), and registers hold only what must live across epochs: the
//    G dbank accumulators, plus the epoch's spectrum and t sums.  The bank
//    and cotangent rows, the same for every epoch, are re-read through the
//    read-only cache (a block's G rows are 12 KB a row, L1/L2-resident).
//    The launch bounds ask for 1024 threads (32 warps) an SM, a
//    64-register cap, as the forward kernel runs.
//  * Each epoch's spectrum is loaded once into registers and serves the G
//    rows' stage 0 and their epilogues.
//  * The last inverse pass, the multiply by g and the first forward pass
//    touch the same butterfly pairs (j, j + N/2) with the same twiddle, so
//    they run fused in registers: two shared-memory passes and two barriers
//    fewer per row and epoch.
//  * The forward DFT is the decimation-in-frequency form with conjugated
//    twiddles from the forward's float64-computed table: natural-order
//    input straight from the inverse pass, bit-reversed output read back
//    only on the first K bins.
//  * Each block writes its t partial for (e, c, group) once; torch sums the
//    groups.  The reduction over f is deterministic, with no atomics.
//  * G = 4 rows to N = 4096, 2 at 8192 and 1 at 16384, where a thread owns
//    8 and 16 samples (1024 threads a block); N = 16384 spills (ptxas -v).
//  * A complex bank doubles the dbank accumulators (G x PER float2), so CX
//    halves G (2 rows to N = 4096, 1 above) to stay within the same
//    64-register cap; t_part then has twice the row groups.  Its bank row
//    is a float2 read through the read-only cache, as the real row is.
// Everything runs in float32.

#include <cuda_runtime.h>

#include <type_traits>

#include "radix2.cuh"

namespace {

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384: 12 N bytes = 192 KB of shared memory

template <int LOG2N, bool CX = false>
struct BwdShape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kPer = LOG2N <= 12 ? 4 : (LOG2N == 13 ? 8 : 16);
  static constexpr int kThreads = kN / kPer;     // samples a thread: kPer
  static constexpr int kRealRows = LOG2N <= 12 ? 4 : (LOG2N == 13 ? 2 : 1);
  static constexpr int kRows = CX && kRealRows > 1 ? kRealRows / 2 : kRealRows;
  // Blocks an SM should hold: 1024 threads at 64 registers each.
  static constexpr int kMinBlocks = 1024 / kThreads;
};

template <int LOG2N, bool CX>
__global__ void __launch_bounds__(BwdShape<LOG2N, CX>::kThreads,
                                  BwdShape<LOG2N, CX>::kMinBlocks)
fused_cwt_bwd_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= K
                     const float* __restrict__ bank,      // (F, N); CX: float2
                     const float* __restrict__ cot,       // (C, F, N): g
                     const float2* __restrict__ twiddle,  // (N/2,) exp(+2 pi i m / N)
                     float* __restrict__ dbank_part,      // (C, F, K); CX: float2
                     float2* __restrict__ t_part,         // (groups, E, C, K)
                     int n_epochs, int n_channels, int n_freqs, int k_bins,
                     int row_len, float scale) {
  using S = BwdShape<LOG2N, CX>;
  using Acc = std::conditional_t<CX, float2, float>;
  constexpr int N = S::kN;
  constexpr int PER = S::kPer;
  constexpr int T = S::kThreads;
  constexpr int G = S::kRows;
  constexpr int HALF = N / 2;
  constexpr int REV = 32 - LOG2N;

  extern __shared__ float2 smem[];
  float2* buf = smem;        // N complex samples
  float2* tw = smem + N;     // N/2 twiddles

  const int grp = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int f0 = grp * G;
  const int rows = min(G, n_freqs - f0);

  for (int m = tid; m < HALF; m += T) tw[m] = twiddle[m];

  // Thread-owned positions: sample / bin tid + i * T, i < PER.
  Acc acc[G][PER];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[j][i] = Acc{};
  }

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    float2 s_reg[PER], t_acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * T;
      s_reg[i] = k < k_bins ? sp[k] : make_float2(0.f, 0.f);
      t_acc[i] = make_float2(0.f, 0.f);
    }

#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= rows) break;   // block-uniform: the ragged last group
      const float* bank_row = bank + static_cast<size_t>(f0 + j) * N;
      const float2* cbank_row = reinterpret_cast<const float2*>(bank) +
                                static_cast<size_t>(f0 + j) * N;
      const float* g_row = cot + (static_cast<size_t>(c) * n_freqs + f0 + j) * N;

      // Stage 0: bank x spectrum, stored bit-reversed for the DIT passes.
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = tid + i * T;
        if constexpr (CX) {
          const float2 b = k < k_bins ? __ldg(cbank_row + k) : make_float2(0.f, 0.f);
          buf[__brev(k) >> REV] = cmul(s_reg[i], b);
        } else {
          const float b = k < k_bins ? __ldg(bank_row + k) : 0.f;
          buf[__brev(k) >> REV] = make_float2(s_reg[i].x * b, s_reg[i].y * b);
        }
      }
      __syncthreads();

      // Inverse DFT, all passes but the last.
#pragma unroll
      for (int s = 1; s < LOG2N; ++s) {
        radix2_dit_pass(buf, tw, s, LOG2N, tid, T);
        __syncthreads();
      }

      // Last inverse pass, x g scale, first forward pass, in registers:
      // the pairs (i0, i0 + N/2) with twiddle tw[i0].
#pragma unroll
      for (int m = 0; m < PER / 2; ++m) {
        const int i0 = tid + m * T;
        const int i1 = i0 + HALF;
        const float2 w = tw[i0];
        const float2 a = buf[i0];
        const float2 t = cmul(buf[i1], w);
        const float g0 = __ldg(g_row + i0) * scale;
        const float g1 = __ldg(g_row + i1) * scale;
        const float2 y0 = make_float2((a.x + t.x) * g0, (a.y + t.y) * g0);
        const float2 y1 = make_float2((a.x - t.x) * g1, (a.y - t.y) * g1);
        buf[i0] = make_float2(y0.x + y1.x, y0.y + y1.y);
        buf[i1] = cmul_conj(make_float2(y0.x - y1.x, y0.y - y1.y), w);
      }
      __syncthreads();

      // Forward DFT, the remaining passes: bit-reversed output.
#pragma unroll
      for (int s = LOG2N - 1; s >= 1; --s) {
        radix2_dif_pass(buf, tw, s, LOG2N, tid, T);
        __syncthreads();
      }

      // Epilogue on the first K bins: dbank += Re(u conj S), t += bank u;
      // CX: dbank += u conj S, t += conj(bank) u.
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = tid + i * T;
        if (k < k_bins) {
          const float2 u = buf[__brev(k) >> REV];
          if constexpr (CX) {
            const float2 us = cmul_conj(u, s_reg[i]);
            const float2 bu = cmul_conj(u, __ldg(cbank_row + k));
            acc[j][i].x += us.x;
            acc[j][i].y += us.y;
            t_acc[i].x += bu.x;
            t_acc[i].y += bu.y;
          } else {
            const float b = __ldg(bank_row + k);
            acc[j][i] += u.x * s_reg[i].x + u.y * s_reg[i].y;
            t_acc[i].x += b * u.x;
            t_acc[i].y += b * u.y;
          }
        }
      }
      __syncthreads();   // the next row's stage 0 overwrites buf
    }

    float2* tp = t_part + ((static_cast<size_t>(grp) * n_epochs + e)
                           * n_channels + c) * k_bins;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * T;
      if (k < k_bins) tp[k] = t_acc[i];
    }
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= rows) break;
    Acc* dp = reinterpret_cast<Acc*>(dbank_part) +
              (static_cast<size_t>(c) * n_freqs + f0 + j) * k_bins;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * T;
      if (k < k_bins) dp[k] = acc[j][i];
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
  using S = BwdShape<LOG2N, CX>;
  const size_t smem = static_cast<size_t>(S::kN) * sizeof(float2) * 3 / 2;
  auto kernel = fused_cwt_bwd_kernel<LOG2N, CX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n_freqs + S::kRows - 1) / S::kRows, a.n_channels);
  kernel<<<grid, S::kThreads, smem, stream>>>(
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
    case 8: return BwdShape<8, CX>::kRows;
    case 9: return BwdShape<9, CX>::kRows;
    case 10: return BwdShape<10, CX>::kRows;
    case 11: return BwdShape<11, CX>::kRows;
    case 12: return BwdShape<12, CX>::kRows;
    case 13: return BwdShape<13, CX>::kRows;
    case 14: return BwdShape<14, CX>::kRows;
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
