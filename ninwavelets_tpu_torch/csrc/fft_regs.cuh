// The register-resident mixed-radix FFT core of every kernel: the epoch
// reductions (fused_cwt.cu: "power", "itc", "power_itc", real and complex
// bank), the per-signal power ("power_each") and the noise gate's peaks
// ("amax", fused_cwt.cu), the power backward (fused_cwt_bwd.cu, real and
// complex bank), the synchrosqueezing kernel (fused_ssq.cu, which forms
// "amax"'s W and p bit for bit through ssq_row.cuh) and the cross-pair
// sums (fused_pair.cu).
// The core is an inverse DFT (inverse_fft); the backward's forward DFT is
// the same transform between two conjugations (forward_fft).
//
// The transform is a Stockham (self-sorting) decimation in time over
// N = 2^LOG2N samples.  Each of T = N/R threads holds R complex samples
// in registers (R = 16; 32 at N = 8192, Plan::kR).  Pass s has radix
// P_s = 16, except the last, whose radix is 2^(LOG2N mod 4) when LOG2N is
// not a multiple of 4; Ns = 16^s is the length of the sub-transforms done
// before it, and each thread runs Q = R/P_s DFTs of P_s points in its
// registers.  Thread t's DFT m (j = t + m T, k = j mod Ns) takes the
// values that sit at positions j + r N/P_s, i.e. its register slots
// m + Q r; multiplies value r by exp(+2 pi i r k / (Ns P_s)) (passes
// s >= 1); runs the DFT; and puts output q at position
// (j / Ns) Ns P_s + k + q Ns.  Between passes the
// block exchanges the samples through `buf`; the last pass keeps them, and
// its output q of DFT m is then sample t + T (m + Q q): thread t owns the
// samples t + T i, the coalesced layout of the loads.
//
//  * Registers instead of shared-memory passes.  A 16-point DFT is four
//    radix-2 stages on registers with constant twiddles.  N = 2048 takes
//    three passes and two exchanges (4 barriers), where radix-2
//    passes through shared memory would take eleven (12 barriers).
//  * Bank conflicts.  An exchange writes position o to buf[o + (o >> 4)]:
//    the stride-16 writes of pass 0 then fall on 16 distinct 8-byte banks
//    in every half-warp, and the runs of 16 consecutive positions that the
//    later writes and all reads make are shifted as a whole.
//  * Twiddles.  One table, built on the host in float64 and stored as
//    complex64 (kernels/__init__.py: core_twiddles), holds for each pass
//    s >= 1 the entries (r - 1) Ns + k at offset Ns - 16.  Thread reads
//    along k are consecutive.  The kernels stage it in shared memory up to
//    N = 4096 and read it through the read-only cache above (kTwSmem).
//  * Rounding.  Every add, multiply and complex product is written with
//    __fadd_rn / __fmul_rn / __fmaf_rn, so the compiler contracts nothing
//    and two calls on equal inputs give equal bits wherever it inlines
//    them: fused_pair.cu relies on this for a self-pair.
#pragma once

#include <cuda_runtime.h>

namespace fft_regs {

// Where the kernels on this core keep what is not the transform, by N:
//  * kTwSmem: the twiddle table is staged in shared memory (to N = 4096);
//    above, it is read through the read-only cache.
//  * kR: the samples a thread holds, 16, and 32 at N = 8192: there 512
//    threads of 16 would get 128 registers each, too few for the cross-pair
//    kernel's two rows and their twiddles (it spilled); 256 threads get
//    255.
//  * kAccSmem: at N = 8192 the epoch sums (2 to 4 a sample) do not fit
//    beside the rows either, and live in shared memory, each thread at its
//    own samples t + T i (read and written by that thread only: no
//    barrier).  At N = 16384 (1024 threads of 16, 64 registers) they do not
//    fit beside the exchange buffer, and stay in registers, spilling.
//  * kAhead: the next row's bins may be loaded while the row before is
//    transformed (to N = 4096, where the registers allow it; the pair
//    kernel does so for "plv" only).
//  * kPingPong: consecutive exchanges alternate between two buffers (to
//    N = 4096), so an exchange needs one barrier, between its writes and
//    its reads: the next write to the same buffer comes after the next
//    exchange's barrier, by which every thread has read.  Only where a
//    transform makes an odd number of exchanges does its last one keep a
//    barrier after the reads.  With one buffer, every exchange has two.
// kAhead and kPingPong may be switched off at build time
// (-DNINW_CORE_AHEAD=0, -DNINW_CORE_PINGPONG=0), to time the kernels
// without them (core_variants.py).
#ifndef NINW_CORE_AHEAD
#define NINW_CORE_AHEAD 1
#endif
#ifndef NINW_CORE_PINGPONG
#define NINW_CORE_PINGPONG 1
#endif

// The exchange buffer's padding: position o sits at o + o / 16.
__host__ __device__ constexpr int pad(int o) { return o + (o >> 4); }

template <int LOG2N>
struct Plan {
  static_assert(LOG2N >= 8 && LOG2N <= 14, "N must be 256 ... 16384");
  static constexpr bool kTwSmem = LOG2N <= 12;
  static constexpr bool kAccSmem = LOG2N == 13;
  static constexpr bool kAhead = NINW_CORE_AHEAD && LOG2N <= 12;
  static constexpr bool kPingPong = NINW_CORE_PINGPONG && LOG2N <= 12;
  static constexpr int kR = LOG2N == 13 ? 32 : 16;
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kThreads = kN / kR;
  static constexpr int kPasses = (LOG2N + 3) / 4;
  // Exchange positions 0 .. N-1 padded by one float2 every 16.
  static constexpr int kBufLen = kN + kN / 16;
  // Entries of the twiddle table: sum over passes s >= 1 of (P_s - 1) Ns.
  static constexpr int kTwiddles = kN - 16;
  __host__ __device__ static constexpr int log2_radix(int s) {
    return s < LOG2N / 4 ? 4 : LOG2N % 4;
  }
  // Where pass s (not the last) writes output q of the DFT of column j:
  // pad((j / Ns) Ns P_s + j mod Ns + q Ns).  pad(base + q Ns) = pad(base)
  // + q Ns + q Ns / 16, since Ns is 1 (then base is a multiple of 16 and
  // q < 16) or a multiple of 16: one register addresses all P_s writes.
  __host__ __device__ static constexpr int exchange_index(int s, int j, int q) {
    const int lns = 4 * s, ns = 1 << lns;
    return pad(((j >> lns) << (lns + log2_radix(s))) + (j & (ns - 1))) + q * ns +
           ((q * ns) >> 4);
  }
  // Where thread t reads its slot i after an exchange: pad(t + T i) =
  // pad(t) + T i + T i / 16, T a multiple of 16.
  __host__ __device__ static constexpr int read_index(int t, int i) {
    return pad(t) + kThreads * i + ((kThreads * i) >> 4);
  }
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// a * w, with the two products of each part rounded in one fixed order.
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 w) {
  return make_float2(__fmaf_rn(a.x, w.x, -__fmul_rn(a.y, w.y)),
                     __fmaf_rn(a.x, w.y, __fmul_rn(a.y, w.x)));
}

// cos(2 pi k / 16), k in [0, 16).
__device__ __forceinline__ constexpr float cos16(int k) {
  constexpr float c1 = 0.923879532511286756f, c2 = 0.707106781186547524f,
                  c3 = 0.382683432365089772f;
  return k == 0 ? 1.f : k == 1 ? c1 : k == 2 ? c2 : k == 3 ? c3
       : k == 4 ? 0.f : k == 5 ? -c3 : k == 6 ? -c2 : k == 7 ? -c1
       : k == 8 ? -1.f : k == 9 ? -c1 : k == 10 ? -c2 : k == 11 ? -c3
       : k == 12 ? 0.f : k == 13 ? c3 : k == 14 ? c2 : c1;
}

// v * exp(+2 pi i k / 16); k is a constant once the caller is unrolled, so
// the quarter turns are exact swaps and the rest one constant product.
__device__ __forceinline__ float2 rot16(float2 v, int k) {
  if (k == 0) return v;
  if (k == 4) return make_float2(-v.y, v.x);
  if (k == 8) return make_float2(-v.x, -v.y);
  if (k == 12) return make_float2(v.y, -v.x);
  return cmul_rn(v, make_float2(cos16(k), cos16((k + 12) & 15)));
}

// q with its low `bits` (<= 4) bits reversed.
__device__ __forceinline__ constexpr int brev(int q, int bits) {
  return (((q & 1) << 3) | ((q & 2) << 1) | ((q & 4) >> 1) | ((q & 8) >> 3)) >>
         (4 - bits);
}

// One radix-2 stage of dft: butterflies H apart.  The stages recurse on H
// as template arguments, so every register index is a compile-time
// constant and x stays in registers.
template <int R, int P, int Q, int M, int H>
__device__ __forceinline__ void dft_stage(float2 (&x)[R]) {
#pragma unroll
  for (int a0 = 0; a0 < P; a0 += 2 * H) {
#pragma unroll
    for (int a = 0; a < H; ++a) {
      const float2 u = x[M + Q * (a0 + a)];
      const float2 v = x[M + Q * (a0 + a + H)];
      x[M + Q * (a0 + a)] = cadd(u, v);
      x[M + Q * (a0 + a + H)] = rot16(csub(u, v), a * (16 / (2 * H)));
    }
  }
  if constexpr (H > 1) dft_stage<R, P, Q, M, H / 2>(x);
}

// Unnormalised inverse DFT of P points held in x[M + Q r], r < P: radix-2
// decimation in frequency, leaving output q in x[M + Q brev(q)].
template <int R, int P, int Q, int M>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  dft_stage<R, P, Q, M, P / 2>(x);
}

template <bool TW_SMEM>
__device__ __forceinline__ float2 twiddle_at(const float2* tw, int idx) {
  if constexpr (TW_SMEM) {
    return tw[idx];
  } else {
    return __ldg(tw + idx);
  }
}

// DFT M of pass S: twiddles, the DFT, and (but for the last pass) the
// writes of its outputs to the exchange buffer: whole, or (SPLIT) their
// real parts to a buffer of floats.
template <int LOG2N, int S, int M, bool SPLIT>
__device__ __forceinline__ void pass_dft(float2 (&x)[Plan<LOG2N>::kR], float2* buf,
                                         const float2* tw, int tid) {
  using PL = Plan<LOG2N>;
  constexpr int LP = PL::log2_radix(S);
  constexpr int P = 1 << LP, Q = PL::kR / P, LNS = 4 * S, NS = 1 << LNS;
  const int j = tid + M * PL::kThreads;
  const int k = j & (NS - 1);
  if constexpr (S > 0) {
    const float2* w = tw + (NS - 16) + k;
#pragma unroll
    for (int r = 1; r < P; ++r) {
      x[M + Q * r] = cmul_rn(x[M + Q * r], twiddle_at<PL::kTwSmem>(w, (r - 1) * NS));
    }
  }
  dft<PL::kR, P, Q, M>(x);
  if constexpr (S + 1 < PL::kPasses) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if constexpr (SPLIT) {
        reinterpret_cast<float*>(buf)[PL::exchange_index(S, j, q)] =
            x[M + Q * brev(q, LP)].x;
      } else {
        buf[PL::exchange_index(S, j, q)] = x[M + Q * brev(q, LP)];
      }
    }
  }
  if constexpr (M + 1 < Q) pass_dft<LOG2N, S, M + 1, SPLIT>(x, buf, tw, tid);
}

// The second half of a split exchange: the imaginary parts of pass S's
// outputs, to the same places as their real parts.
template <int LOG2N, int S>
__device__ __forceinline__ void write_imag(const float2 (&x)[Plan<LOG2N>::kR],
                                           float* fbuf, int tid) {
  using PL = Plan<LOG2N>;
  constexpr int LP = PL::log2_radix(S);
  constexpr int P = 1 << LP, Q = PL::kR / P;
#pragma unroll
  for (int m = 0; m < Q; ++m) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      fbuf[PL::exchange_index(S, tid + m * PL::kThreads, q)] = x[m + Q * brev(q, LP)].y;
    }
  }
}

template <int LOG2N, int S, bool SPLIT>
__device__ __forceinline__ void pass(float2 (&x)[Plan<LOG2N>::kR], float2* buf,
                                     const float2* tw, int tid) {
  using PL = Plan<LOG2N>;
  static_assert(!SPLIT || !PL::kPingPong, "a split exchange uses one buffer");
  // Exchange S's buffer: the second one for odd S (kPingPong).
  float2* xbuf = buf + (PL::kPingPong && (S & 1) ? PL::kBufLen : 0);
  pass_dft<LOG2N, S, 0, SPLIT>(x, xbuf, tw, tid);
  if constexpr (S + 1 < PL::kPasses) {
    __syncthreads();
    if constexpr (SPLIT) {
      // Real parts in, then the imaginary parts through the same floats:
      // the outputs' imaginary parts are still in x, untouched by the reads
      // of the real parts.
      float* fbuf = reinterpret_cast<float*>(xbuf);
#pragma unroll
      for (int i = 0; i < PL::kR; ++i) x[i].x = fbuf[PL::read_index(tid, i)];
      __syncthreads();
      write_imag<LOG2N, S>(x, fbuf, tid);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PL::kR; ++i) x[i].y = fbuf[PL::read_index(tid, i)];
    } else {
#pragma unroll
      for (int i = 0; i < PL::kR; ++i) x[i] = xbuf[PL::read_index(tid, i)];
    }
    constexpr bool kLastExchange = S + 2 == PL::kPasses;
    if constexpr (!PL::kPingPong || (kLastExchange && (PL::kPasses - 1) % 2 == 1)) {
      __syncthreads();   // the next write to this buffer follows
    }
    pass<LOG2N, S + 1, SPLIT>(x, buf, tw, tid);
  } else {
    // Output q of DFT m sits in slot m + Q brev(q) and is sample
    // t + T (m + Q q): put it in slot m + Q q.
    constexpr int LP = PL::log2_radix(S);
    constexpr int P = 1 << LP, Q = PL::kR / P;
    float2 y[PL::kR];
#pragma unroll
    for (int m = 0; m < Q; ++m) {
#pragma unroll
      for (int q = 0; q < P; ++q) y[m + Q * q] = x[m + Q * brev(q, LP)];
    }
#pragma unroll
    for (int i = 0; i < PL::kR; ++i) x[i] = y[i];
  }
}

// The unnormalised inverse DFT of one row.  On entry thread `tid` holds
// bin tid + T i in x[i] (T = N / kR); on return x[i] holds sample tid + T i.
// `buf` is the block's exchange buffer (Plan::kBufLen float2, two of them
// back to back with Plan::kPingPong), `tw` the
// twiddle table, in shared memory (Plan::kTwSmem) or device memory.  Every
// thread of the block must call it; the first read of `tw` follows the
// first barrier, which publishes a table the caller staged before.
// SPLIT (without kPingPong) exchanges the real parts, then the imaginary
// parts, through a buffer of Plan::kBufLen floats, half the bytes, at two
// more barriers an exchange.  The values moved, and so the result, are the
// same bits.  Without kPingPong the last exchange ends in a barrier after
// its reads, so on return no thread reads `buf` any more.
template <int LOG2N, bool SPLIT = false>
__device__ __forceinline__ void inverse_fft(float2 (&x)[Plan<LOG2N>::kR], float2* buf,
                                            const float2* tw, int tid) {
  pass<LOG2N, 0, SPLIT>(x, buf, tw, tid);
}

// The unnormalised forward DFT of one row, in the same layout and under the
// same conditions: FFT(y) = conj(IFFT(conj(y))), the same passes, the same
// twiddle table.  On entry x[i] holds sample tid + T i; on return bin
// tid + T i.  The conjugations are exact.
template <int LOG2N>
__device__ __forceinline__ void forward_fft(float2 (&x)[Plan<LOG2N>::kR], float2* buf,
                                            const float2* tw, int tid) {
#pragma unroll
  for (int i = 0; i < Plan<LOG2N>::kR; ++i) x[i].y = -x[i].y;
  inverse_fft<LOG2N>(x, buf, tw, tid);
#pragma unroll
  for (int i = 0; i < Plan<LOG2N>::kR; ++i) x[i].y = -x[i].y;
}

// Shared memory of a kernel on this core, in float2: the exchange buffer
// (two with kPingPong), then the twiddle table (kTwSmem), then (kAccSmem)
// SUMS planes of N float epoch sums.
template <int LOG2N, int SUMS>
struct SmemLayout {
  using PL = Plan<LOG2N>;
  static constexpr int kTwOffset = PL::kBufLen * (PL::kPingPong ? 2 : 1);
  static constexpr int kSumsOffset = kTwOffset + (PL::kTwSmem ? PL::kTwiddles : 0);
  static constexpr size_t kBytes =
      sizeof(float2) * kSumsOffset + (PL::kAccSmem ? sizeof(float) * SUMS * PL::kN : 0);
};

// The twiddle table the kernel reads: staged into shared memory at
// SmemLayout::kTwOffset (kTwSmem), published by the first exchange's
// barrier; else the table in device memory itself.
template <int LOG2N, int SUMS>
__device__ __forceinline__ const float2* stage_twiddles(float2* smem,
                                                        const float2* twiddle,
                                                        int tid) {
  using PL = Plan<LOG2N>;
  if constexpr (PL::kTwSmem) {
    float2* staged = smem + SmemLayout<LOG2N, SUMS>::kTwOffset;
    for (int m = tid; m < PL::kTwiddles; m += PL::kThreads) staged[m] = twiddle[m];
    return staged;
  } else {
    return twiddle;
  }
}

// The k < k_bins bins of one spectrum row into x[i]: bin tid + T i.
template <int LOG2N>
__device__ __forceinline__ void load_bins(float2 (&x)[Plan<LOG2N>::kR],
                                          const float2* __restrict__ row,
                                          int k_bins, int tid) {
#pragma unroll
  for (int i = 0; i < Plan<LOG2N>::kR; ++i) {
    const int k = tid + i * Plan<LOG2N>::kThreads;
    x[i] = k < k_bins ? row[k] : make_float2(0.f, 0.f);
  }
}

// PLANES values of type V a thread keeps at its own samples, plane(j, i)
// for sample tid + T i: in registers, or (SMEM) in shared memory at
// `planes` (PLANES x N values), each thread at its own samples, so that no
// barrier orders them.
template <typename V, int PLANES, int LOG2N, bool SMEM>
struct ThreadPlanes {
  using PL = Plan<LOG2N>;
  V reg[SMEM ? 1 : PLANES][PL::kR];
  V* smem;
  int tid;

  __device__ __forceinline__ ThreadPlanes(V* planes, int thread)
      : smem(planes), tid(thread) {}

  __device__ __forceinline__ V& operator()(int j, int i) {
    if constexpr (SMEM) {
      return smem[j * PL::kN + tid + i * PL::kThreads];
    } else {
      return reg[j][i];
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < PLANES; ++j) {
#pragma unroll
      for (int i = 0; i < PL::kR; ++i) (*this)(j, i) = V{};
    }
  }
};

// SUMS epoch sums a sample, sum(j, i) for the thread's sample tid + T i:
// in registers, or (kAccSmem) in shared memory at SmemLayout::kSumsOffset.
// Starts at zero.
template <int LOG2N, int SUMS>
struct EpochSums : ThreadPlanes<float, SUMS, LOG2N, Plan<LOG2N>::kAccSmem> {
  __device__ __forceinline__ EpochSums(float2* block_smem, int thread)
      : ThreadPlanes<float, SUMS, LOG2N, Plan<LOG2N>::kAccSmem>(
            reinterpret_cast<float*>(block_smem +
                                     SmemLayout<LOG2N, SUMS>::kSumsOffset),
            thread) {
    this->zero();
  }
};

// bank x spectrum for one bin: the stage-0 product, rounded as the core is.
__device__ __forceinline__ float2 bank_times_rn(float2 s, float b) {
  return make_float2(__fmul_rn(s.x, b), __fmul_rn(s.y, b));
}

__device__ __forceinline__ float2 bank_times_rn(float2 s, float2 b) {
  return cmul_rn(s, b);
}

}  // namespace fft_regs
