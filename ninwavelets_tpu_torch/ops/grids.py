"""Frequency / time grids for wavelet synthesis (port of
``ninwavelets_tpu.ops.grids``).

Grid semantics, as in the JAX package:

* FFT bin grid: bin *i* carries the physical frequency ``i * sfreq / n``.
* wavelet timeline (time-domain synthesis): exactly ``sfreq * real_length``
  samples spanning ``+-pi * freq / peak_freq`` in phase units, zero-mean.
* reverse timeline (``make_wavelet`` on Reverse/Twice families): values
  ``i / freq`` over ``sfreq * real_wave_length`` samples.

``freq`` / ``peak_freq`` may be tensors (a column of analysis frequencies
broadcasts to one timeline per row); every grid is float32 on ``device``.
"""
from __future__ import annotations

import math

import torch


def fft_bin_freqs(n: int, sfreq: float, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Physical frequency of each FFT bin: ``grid[i] = i * sfreq / n``."""
    i = torch.arange(n, dtype=dtype, device=device)
    return i * (float(sfreq) / float(n))


def analytic_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """1 for bins below ``n // 2``, 0 from there on: the lower half of the
    spectrum is kept, the negative-frequency half zeroed (the analytic-signal
    trick behind ``interpolate=True``)."""
    return (torch.arange(n, device=device) < n // 2).to(dtype)


def wavelet_timeline(sfreq: float, freq, peak_freq, real_length: float = 1.0,
                     zero_mean: bool = True, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Zero-mean phase timeline for time-domain synthesis: always
    ``sfreq * real_length`` samples, step ``2 pi freq / (sfreq peak_freq)``.
    """
    n = int(round(sfreq * real_length))
    freq = torch.as_tensor(freq, dtype=dtype, device=device)
    peak = torch.as_tensor(peak_freq, dtype=dtype, device=device)
    scale = (2.0 * math.pi) * freq / (float(sfreq) * peak)
    i = torch.arange(n, dtype=dtype, device=device)
    if zero_mean:
        return (i - 0.5 * float(sfreq) * float(real_length)) * scale
    return i * scale


def reverse_timeline(sfreq: float, freq, real_wave_length: float,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Grid of ``make_wavelet`` in Reverse/Twice modes: ``sfreq *
    real_wave_length`` samples with values ``i / freq``."""
    n = int(round(sfreq * real_wave_length))
    i = torch.arange(n, dtype=dtype, device=device)
    return i / torch.as_tensor(freq, dtype=dtype, device=device)
