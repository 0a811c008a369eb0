// Native window-gather kernels for the long-recording input pipeline.
//
// The streaming paths (parallel/streaming.py, parallel/online.py) consume
// fixed-geometry "extended window" batches: (W, C, window + 2*halo)
// float32 slabs cut from a long recording, halo-overlapped and
// zero-padded at the edges.  Assembling those batches is the host-side
// hot loop of every long-recording workload (RawWavelet, StreamingCWT):
// for EDF files it is a strided gather with per-channel affine scaling
// out of the record-interleaved int16 layout, for raw arrays a block
// copy with edge handling.  Here it is one C call per batch, GIL-free
// (ctypes releases the GIL), so a plain Python thread fills batch i+1
// while the card computes batch i.
//
// The contract is plain C buffers, loaded via ctypes; the code is the
// same as the JAX package's ninwavelets_tpu/io/_native/io.cpp, and
// io/native.py holds numpy versions with identical semantics.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

// Zero [0, n) floats.  memset is fine for IEEE zero.
inline void zero(float* dst, long n) {
    if (n > 0) std::memset(dst, 0, static_cast<size_t>(n) * sizeof(float));
}

}  // namespace

extern "C" {

// Gather one extended-window batch out of a record-interleaved int16
// recording (the EDF/BDF data-record layout).
//
//   data          int16 sample area (mmap'd file past the header)
//   n_records     number of data records in the file
//   rec_stride    int16s per whole record (sum of ns over ALL signals)
//   ch_off[c]     int16 offset of channel c's block within a record
//   scale[c]      physical = scale[c] * digital + dc[c]
//   dc[c]
//   n_ch          channels to gather (selected subset, any order)
//   ns            samples per record for these channels (must agree)
//   starts[w]     window start sample of row w (may be negative-ish via
//                 halo; the halo is applied here: row w covers
//                 [starts[w]-halo, starts[w]+window+halo))
//   n_windows     rows in the batch
//   window, halo  geometry (see parallel/streaming.py:_ext_batches)
//   total         valid samples per channel (n_records*ns, or fewer if
//                 the caller trims a partial tail)
//   out           (n_windows, n_ch, window + 2*halo) float32, fully
//                 written (out-of-range regions zeroed)
//
// Returns 0 on success, -1 on bad geometry.
int ninw_edf_gather(const int16_t* data, long n_records, long rec_stride,
                    const long* ch_off, const double* scale,
                    const double* dc, long n_ch, long ns,
                    const long* starts, long n_windows, long window,
                    long halo, long total, float* out) {
    if (ns <= 0 || rec_stride <= 0 || window <= 0 || halo < 0) return -1;
    if (total > n_records * ns) return -1;
    const long ext = window + 2 * halo;
    for (long w = 0; w < n_windows; ++w) {
        const long lo = starts[w] - halo;        // first wanted sample
        const long hi = starts[w] + window + halo;
        const long src_lo = std::max(lo, 0L);
        const long src_hi = std::min(hi, total);
        if (src_hi <= src_lo) {                  // window fully outside
            zero(out + w * n_ch * ext, n_ch * ext);
            continue;
        }
        for (long c = 0; c < n_ch; ++c) {
            float* row = out + (w * n_ch + c) * ext;
            zero(row, src_lo - lo);
            float* dst = row + (src_lo - lo);
            const float a = static_cast<float>(scale[c]);
            const float b = static_cast<float>(dc[c]);
            long s = src_lo;
            while (s < src_hi) {
                const long rec = s / ns;
                const long k = s % ns;
                const long run = std::min(ns - k, src_hi - s);
                const int16_t* src = data + rec * rec_stride + ch_off[c] + k;
                for (long i = 0; i < run; ++i)
                    dst[i] = a * static_cast<float>(src[i]) + b;
                dst += run;
                s += run;
            }
            zero(row + (src_hi - lo), hi - src_hi);
        }
    }
    return 0;
}

// Same gather out of a contiguous (C, N) float32 array (raw binary
// recordings, or an already-loaded host snapshot).  No scaling — raw
// float recordings are stored in physical units.
int ninw_f32_gather(const float* data, long n_ch, long n_samples,
                    const long* starts, long n_windows, long window,
                    long halo, float* out) {
    if (window <= 0 || halo < 0 || n_samples < 0) return -1;
    const long ext = window + 2 * halo;
    for (long w = 0; w < n_windows; ++w) {
        const long lo = starts[w] - halo;
        const long hi = starts[w] + window + halo;
        const long src_lo = std::max(lo, 0L);
        const long src_hi = std::min(hi, n_samples);
        if (src_hi <= src_lo) {                  // window fully outside
            zero(out + w * n_ch * ext, n_ch * ext);
            continue;
        }
        for (long c = 0; c < n_ch; ++c) {
            float* row = out + (w * n_ch + c) * ext;
            zero(row, src_lo - lo);
            std::memcpy(row + (src_lo - lo), data + c * n_samples + src_lo,
                        static_cast<size_t>(src_hi - src_lo)
                            * sizeof(float));
            zero(row + (src_hi - lo), hi - src_hi);
        }
    }
    return 0;
}

// Bulk int16 -> float32 conversion with per-channel affine scaling, for
// whole-recording loads (EDFRaw.get_data): writes the (n_ch, total)
// channel-major physical-units array in one pass over the mmap.
int ninw_edf_load(const int16_t* data, long n_records, long rec_stride,
                  const long* ch_off, const double* scale, const double* dc,
                  long n_ch, long ns, long total, float* out) {
    if (ns <= 0 || rec_stride <= 0 || total > n_records * ns) return -1;
    for (long c = 0; c < n_ch; ++c) {
        float* dst = out + c * total;
        const float a = static_cast<float>(scale[c]);
        const float b = static_cast<float>(dc[c]);
        long s = 0;
        while (s < total) {
            const long rec = s / ns;
            const long run = std::min(ns, total - s);
            const int16_t* src = data + rec * rec_stride + ch_off[c];
            for (long i = 0; i < run; ++i)
                dst[i] = a * static_cast<float>(src[i]) + b;
            dst += run;
            s += run;
        }
    }
    return 0;
}

}  // extern "C"
