// The register-resident core's plan and exchange indices (fft_regs.cuh:
// Plan), computed by the same functions the kernels call, so that the host's
// description of the core (kernels/__init__.py: core_plan, core_r,
// core_twiddles, core_exchange_positions, core_pad), which the CPU tests
// emulate, can be held against it (chip_smoke.py, at every N).
#include "fft_regs.cuh"

namespace {

constexpr int kMaxPasses = 4;   // N = 16384: 16, 16, 16, 4

template <int LOG2N>
int plan(int* out) {
  using PL = fft_regs::Plan<LOG2N>;
  out[0] = PL::kR;
  out[1] = PL::kThreads;
  out[2] = PL::kPasses;
  out[3] = PL::kBufLen;
  out[4] = PL::kTwiddles;
  for (int s = 0; s < kMaxPasses; ++s) {
    out[5 + s] = s < PL::kPasses ? 1 << PL::log2_radix(s) : 0;
  }
  return 0;
}

template <int LOG2N>
int exchange(int s, int* writes, int* reads) {
  using PL = fft_regs::Plan<LOG2N>;
  if (s < 0 || s + 1 >= PL::kPasses) return -1;
  const int p = 1 << PL::log2_radix(s), q_count = PL::kR / p;
  for (int t = 0; t < PL::kThreads; ++t) {
    for (int m = 0; m < q_count; ++m) {
      for (int q = 0; q < p; ++q) {
        writes[t * PL::kR + m + q_count * q] =
            PL::exchange_index(s, t + m * PL::kThreads, q);
      }
    }
    for (int i = 0; i < PL::kR; ++i) reads[t * PL::kR + i] = PL::read_index(t, i);
  }
  return 0;
}

}  // namespace

// The plan at N = 2^log2n into out[9]: samples a thread R, threads T,
// passes, exchange buffer length (float2), twiddle table length, then the
// radix of each pass (0 past the last).  Returns -1 for an N the kernels
// do not take.
extern "C" int ninw_core_plan(int log2n, int* out) {
  switch (log2n) {
    case 8: return plan<8>(out);
    case 9: return plan<9>(out);
    case 10: return plan<10>(out);
    case 11: return plan<11>(out);
    case 12: return plan<12>(out);
    case 13: return plan<13>(out);
    case 14: return plan<14>(out);
    default: return -1;
  }
}

// The exchange after pass s (not the last) at N = 2^log2n, each a (T, R)
// row-major int array: writes[t, m + Q q], the padded index to which thread
// t writes output q of its DFT m (Q = R / P_s DFTs of P_s points a thread);
// reads[t, i], the padded index from which it then reads its slot i.
// Returns -1 for an N or a pass without an exchange.
extern "C" int ninw_core_exchange(int log2n, int s, int* writes, int* reads) {
  switch (log2n) {
    case 8: return exchange<8>(s, writes, reads);
    case 9: return exchange<9>(s, writes, reads);
    case 10: return exchange<10>(s, writes, reads);
    case 11: return exchange<11>(s, writes, reads);
    case 12: return exchange<12>(s, writes, reads);
    case 13: return exchange<13>(s, writes, reads);
    case 14: return exchange<14>(s, writes, reads);
    default: return -1;
  }
}
