// Fused forward CWT reduction for Hopper (sm_90a):
//     bank x spectrum -> inverse DFT -> |.|^2 / unit phase -> epoch reduction.
//
// Replaces the Pallas TPU kernel ninwavelets_tpu/ops/fused.py:_kernel with
// its "power", "itc" and "power_itc" epilogues, for a real (F, N) bank.
//
// What it computes, for every channel c, bank row f and sample n:
//     x_e[n]  = sum_{k < K} bank[f, k] * spec[e, c, k] * exp(+2 pi i k n / N)
//     power   = (1 / (N^2 E)) * sum_e |x_e[n]|^2          (mean |cwt|^2)
//     itc     = (1 / E) * | sum_e x_e[n] / |x_e[n]| |      (mean unit phase)
// K = N/2 on the analytic (interpolate=True) path: the upper bins are zero.
// K = N otherwise.  The signal FFT runs outside the kernel (as it does for
// the TPU kernel); this kernel starts at the bank x spectrum product.
//
// What bounds it on this card: each (c, f) block runs E in-place radix-2
// inverse FFTs in shared memory, log2(N) passes of N/2 butterflies each,
// with a barrier between passes, so the shared-memory FFT passes bound it.
// The spectra are read F times (once per bank row), which is the second
// bound: at 64 channels x 200 epochs x 2048 samples they are 105 MB, more
// than the 50 MB L2.
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

#include <cuda_runtime.h>

namespace {

enum Epilogue { kPower = 0, kItc = 1, kPowerItc = 2 };

constexpr int kMinLog2N = 8;    // N = 256
constexpr int kMaxLog2N = 14;   // N = 16384: 12 N bytes = 192 KB of shared memory

template <int EPI, int PER>
__global__ void __launch_bounds__(1024)
fused_cwt_kernel(const float2* __restrict__ spec,     // (E, C, L), L >= K
                 const float* __restrict__ bank,      // (F, N)
                 const float2* __restrict__ twiddle,  // (N/2,) exp(+2 pi i m / N)
                 float* __restrict__ out0,            // (C, F, N)
                 float* __restrict__ out1,            // (C, F, N), power_itc only
                 int n_epochs, int n_channels, int n_freqs, int log2n,
                 int k_bins, int row_len, float power_scale, float itc_scale) {
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

  float bank_reg[PER];
  const float* bank_row = bank + static_cast<size_t>(f) * n;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * threads;
    bank_reg[i] = k < k_bins ? bank_row[k] : 0.f;
  }

  float acc_p[PER], acc_r[PER], acc_i[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc_p[i] = acc_r[i] = acc_i[i] = 0.f;

  const size_t epoch_stride = static_cast<size_t>(n_channels) * row_len;
  const float2* sp = spec + static_cast<size_t>(c) * row_len;
  const int rev_shift = 32 - log2n;

  for (int e = 0; e < n_epochs; ++e, sp += epoch_stride) {
    // Stage 0: bank x spectrum, stored bit-reversed for the in-place DIT FFT.
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * threads;
      float2 v = make_float2(0.f, 0.f);
      if (k < k_bins) {
        const float2 s = sp[k];
        v = make_float2(s.x * bank_reg[i], s.y * bank_reg[i]);
      }
      buf[__brev(k) >> rev_shift] = v;
    }
    __syncthreads();

    // Radix-2 decimation-in-time inverse FFT, natural-order output.
    for (int s = 1; s <= log2n; ++s) {
      const int half = 1 << (s - 1);
      const int tw_shift = log2n - s;
      for (int j = tid; j < half_n; j += threads) {
        const int pos = j & (half - 1);
        const int i0 = ((j >> (s - 1)) << s) + pos;
        const int i1 = i0 + half;
        const float2 w = tw[pos << tw_shift];
        const float2 a = buf[i0];
        const float2 b = buf[i1];
        const float2 t = make_float2(b.x * w.x - b.y * w.y, b.x * w.y + b.y * w.x);
        buf[i0] = make_float2(a.x + t.x, a.y + t.y);
        buf[i1] = make_float2(a.x - t.x, a.y - t.y);
      }
      __syncthreads();
    }

    // Epilogue: fold this epoch into the register accumulators.
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float2 x = buf[tid + i * threads];
      const float p = x.x * x.x + x.y * x.y;
      if (EPI != kItc) acc_p[i] += p;
      if (EPI != kPower) {
        const float inv = rsqrtf(p);
        acc_r[i] += x.x * inv;
        acc_i[i] += x.y * inv;
      }
    }
    __syncthreads();   // the next epoch's stage 0 overwrites buf
  }

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

struct Args {
  const float2* spec;
  const float* bank;
  const float2* twiddle;
  float* out0;
  float* out1;
  int n_epochs, n_channels, n_freqs, log2n, k_bins, row_len;
  float power_scale, itc_scale;
};

template <int EPI, int PER>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = 1 << a.log2n;
  const size_t smem = static_cast<size_t>(n) * sizeof(float2) * 3 / 2;
  auto kernel = fused_cwt_kernel<EPI, PER>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_freqs, a.n_channels);
  kernel<<<grid, n / PER, smem, stream>>>(
      a.spec, a.bank, a.twiddle, a.out0, a.out1, a.n_epochs, a.n_channels,
      a.n_freqs, a.log2n, a.k_bins, a.row_len, a.power_scale, a.itc_scale);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_per(const Args& a, cudaStream_t stream) {
  // 8 samples a thread up to N = 8192 (1024 threads); N = 16384 takes 16.
  return a.log2n <= 13 ? launch<EPI, 8>(a, stream) : launch<EPI, 16>(a, stream);
}

}  // namespace

// Launch one fused reduction on `stream`.  Returns the cudaError_t of the
// launch (0 on success); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int ninw_fused_cwt(int epilogue, const void* spec, const void* bank,
                              const void* twiddle, void* out0, void* out1,
                              int n_epochs, int n_channels, int n_freqs, int n,
                              int k_bins, int row_len, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n || log2n < kMinLog2N || log2n > kMaxLog2N ||
      k_bins < 1 || k_bins > n || row_len < k_bins || n_epochs < 1 ||
      n_channels < 1 || n_channels > 65535 || n_freqs < 1 ||
      epilogue < kPower || epilogue > kPowerItc ||
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
  a.power_scale = static_cast<float>(1.0 / (static_cast<double>(n) * n * n_epochs));
  a.itc_scale = static_cast<float>(1.0 / n_epochs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kPower: return static_cast<int>(launch_per<kPower>(a, s));
    case kItc: return static_cast<int>(launch_per<kItc>(a, s));
    default: return static_cast<int>(launch_per<kPowerItc>(a, s));
  }
}
