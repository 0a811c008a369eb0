"""The per-signal power ("power_each") at N = 32768 on the card: the split
kernel (``fused_each_split_kernel`` in ``csrc/fused_cwt.cu``), which runs
each output parity of the 32768-point inverse DFT as one 16384-point
transform of the register core.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so it runs on the card with
``--noconftest`` (README).  Each compares the kernel with the plain
``torch.fft`` route on the same tensors: the widest gap of a (signal,
row) over the plane's peak at most 1e-5, the gate ``chip_smoke.py`` holds
K4 to at every other N.  The CPU tests of the split's arithmetic (its
emulation in torch, the route) are in ``tests/test_torch_fused.py`` and
``tests/test_torch_stream.py``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import cwt, fused
from ninwavelets_tpu_torch.parallel import StreamingCWT
from ninwavelets_tpu_torch.utils.observability import debug_nans

from torch_threads import one_torch_thread  # noqa: F401

SFREQ = 1000.0
N = 2 * kernels.MAX_N
FREQS = np.linspace(1.0, 100.0, 100)
TOL = 1e-5


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _recording(shape, seed):
    """Noise and a 10 Hz rhythm of random phase, about 10 uV in volts."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SFREQ
    phase = rng.uniform(-np.pi, np.pi, shape[:-1] + (1,))
    return (1e-5 * (rng.standard_normal(shape)
                    + 2.0 * np.sin(2 * np.pi * 10.0 * t + phase))
            ).astype(np.float32)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.name.startswith("ninw.transform.")]


@pytest.mark.card
@pytest.mark.parametrize("interpolate", [False, True])
def test_card_split_matches_the_plain_power(card, interpolate):
    """64 windows of 32768 samples against 100 Morse rows: the whole plane
    (``fused_power_from_bank``) and the recording's kept interior written
    into place (``_power_each_into``, keep [8192, 24576)), one
    "power_each_split" launch each."""
    x = torch.from_numpy(_recording((64, N), seed=27)).to(card)
    bank = nt.Morse(SFREQ, interpolate=interpolate,
                    device=card).make_fft_wavelets(FREQS, N / SFREQ)
    want = cwt.power_from_bank(x, bank, interpolate)
    kernels.reset_launches()
    got = fused.fused_power_from_bank(x, bank, interpolate)
    assert got.shape == want.shape == (64, 100, N)
    assert _rel(got, want) <= TOL
    keep = (8192, 24576)
    dst = torch.full((1, 64, 100, keep[1] - keep[0]), float("nan"),
                     device=card)
    fused._power_each_into(x[None], bank, interpolate, dst, keep)
    torch.cuda.synchronize()
    assert bool(dst.isfinite().all())
    assert _rel(dst[0], want[..., keep[0]:keep[1]]) <= TOL
    assert kernels.launches["power_each_split"] == 2
    assert sum(kernels.launches.values()) == 2


@pytest.mark.card
def test_card_stream_at_the_recording_geometry(card):
    """``StreamingCWT.power_device`` at the recording cell's geometry (64 x
    600,000 at 1 kHz, 100 Morse rows at 1-100 Hz, ``interpolate=False``,
    window 16384 -> 32768, batch 8): one "power_each_split" launch a window
    batch, none of "power_each", one transform span a batch naming the
    kernel; four channels against ``use_fused=False``."""
    rec = _recording((64, 600_000), seed=2027)
    wdef = nt.Morse(SFREQ, device=card)._wdef()
    kw = dict(window=16384, batch=8, device=card)
    stream = StreamingCWT(wdef, FREQS, SFREQ, **kw)
    assert stream.window + 2 * stream.halo == N and stream._fused
    batches = -(-rec.shape[-1] // (8 * 16384))
    kernels.reset_launches()
    out = {}
    names = _spans(lambda: out.update(plane=stream.power_device(rec)))
    assert kernels.launches["power_each_split"] == batches == 5
    assert kernels.launches["power_each"] == 0
    assert names == ["ninw.transform.kernel:power_each_split"] * batches
    plane = out["plane"]
    assert plane.shape == (64, 100, 600_000)
    plain = StreamingCWT(wdef, FREQS, SFREQ, use_fused=False, **kw)
    want = plain.power_device(rec[:4])
    assert _rel(plane[:4], want) <= TOL
    assert bool(plane.isfinite().all())


@pytest.mark.card
def test_card_split_nan_check(card):
    """Under ``debug_nans`` the launcher checks its output: a NaN in the
    spectra raises ``FloatingPointError`` naming "power_each_split"; clean
    spectra raise nothing."""
    x = torch.from_numpy(_recording((2, N), seed=5)).to(card)
    bank = nt.Morse(SFREQ, device=card).make_fft_wavelets(FREQS[:8],
                                                          N / SFREQ)
    spec = torch.fft.fft(x).reshape(2, 1, N).contiguous()
    bad = spec.clone()
    bad[1, 0, 200] = float("nan")          # 6.1 Hz, inside the rows
    dst = torch.zeros((2, 1, 8, N), device=card)
    with debug_nans(True):
        kernels.fused_power_each(spec, bank, N, dst, (0, N))
        with pytest.raises(FloatingPointError,
                           match="kernel power_each_split"):
            kernels.fused_power_each(bad, bank, N, dst, (0, N))
