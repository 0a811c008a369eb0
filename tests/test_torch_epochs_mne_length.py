"""Epochs of MNE's length (2001 samples: -0.5..1.5 s at 1 kHz, both ends
kept) on the port's plain epoch route, on the CPU at small sizes and,
marked ``card``, on a CUDA card, where that test skips without one.

N = 2001 is not a power of two, so ``why_not()`` gives ``n_not_pow2`` and
``power_itc_auto`` runs the plain route on the CPU (on the card the
chirp-z kernel, ``tests/test_torch_czt.py``): one pass over the epochs,
each epoch's CWT computed once and feeding both the power and the phase
sums.

Gates, each with its reason:

* ``EpochsWavelet.power_itc_all`` against the benchmark's float64 reference
  (``gpubench.reference``), over rows from 1 Hz up, as the cell has them.
  The float32 chain reads about 1e-6 on the epoch-mean power (the widest
  gap of a (channel, frequency) row over that row's peak) and 1e-5 on the
  coherence; bfloat16 keeps 8 bits, 2**-9 of relative round-off a stage,
  and the reference stored in bfloat16 reads 6e-3 to 2e-2 on the power and
  3e-3 to 0.2 on the coherence here.  So the power is held at ``P_TOL`` =
  1e-4 and the coherence at ``ITC_TOL`` = 1e-3 on every row, each two
  decades from the program and from the control, and the test asserts
  that the bfloat16 control fails them;
* the z-scored power, as the benchmark makes it, at ``Z_TOL`` = 1e-3 on the
  rows from 2 Hz up (the program about 1e-5, the control 1e-2 and more),
  and at ``Z1_TOL`` = 1e-2 on the 1 Hz row, which reads 4e-4 to 1.1e-3
  here.  That row's power hardly moves in the 0.2 s baseline, so its
  baseline std is small next to its mean, and the z-score divides the
  float32 round-off of the 2001-point transforms (an FFT of mixed radix,
  3 x 23 x 29, less accurate than a power of two) by that std; the power
  itself is as close there as on every other row.  The control reads 1.1
  to 1.4 on that row;
* the one-pass route against ``mean_power_from_bank`` and
  ``itc_from_bank``: bit for bit (``torch.equal``), since the same
  coefficients are summed in the same order;
* one call transforms each epoch exactly once: E ``ninw.epoch.cwt`` spans,
  none holding the accumulation into the totals;
* on the card, the same equality for ``power_itc_from_bank``, and the
  one-pass peak allocation no higher than the two reductions'.

This file imports neither JAX nor the JAX package, so that the card test
runs on a machine without it (``--noconftest``).
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import ninwavelets_tpu_torch as nt  # noqa: E402
from gpubench.reference import Precision, epochs_planes  # noqa: E402
from gpubench.reference.epoch_power import epochs_power_planes  # noqa: E402
from ninwavelets_tpu_torch.ops import cwt as tcwt  # noqa: E402
from ninwavelets_tpu_torch.ops.fused import (  # noqa: E402
    fused_power_itc_from_bank, power_itc_auto, why_not)

SFREQ = 1000.0
N_MNE = 2001
FREQS = np.array([1.0, 2.0, 4.0, 10.0, 25.0, 40.0, 80.0])
BASELINE = (0.0, 0.2)
P_TOL = 1e-4
Z_TOL = 1e-3
Z1_TOL = 1e-2
ITC_TOL = 1e-3
#: Rows for signals of a few hundred samples: there the Morse bank of 1 and
#: 2 Hz underflows to zero at every FFT bin (3.3 Hz apart and more), and the
#: coherence of an all-zero row is 0/0.
SHORT_FREQS = FREQS[2:]
SPAN = "ninw.epoch.cwt"


def _epochs(shape, seed):
    """Noise and a 10 Hz rhythm of random phase, about 10 uV in volts."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SFREQ
    phase = rng.uniform(-np.pi, np.pi, shape[:-1] + (1,))
    return 1e-5 * (rng.standard_normal(shape)
                   + 2.0 * np.sin(2 * np.pi * 10.0 * t + phase))


def _adapter(x, interpolate=False, device="cpu"):
    return nt.EpochsWavelet(nt.ArrayEpochs(x, SFREQ),
                            nt.Morse(SFREQ, interpolate=interpolate,
                                     device=device))


def _inputs(x, interpolate=False, device="cpu", freqs=FREQS):
    """The (E, C, N) device block and the bank ``power_itc_all`` uses."""
    ew = _adapter(x, interpolate, device)
    waves = ew._all_data()
    return waves, ew._bank_for(waves, freqs)


def _row_gap(got, ref):
    """The widest gap of each frequency row over that row's peak, the
    widest over the channels: (F,)."""
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).amax(0)


def _gaps(x, interpolate, prec, power=None, itc=None):
    """(power row gaps, z-scored power row gaps, widest coherence gap) of
    ``power`` / ``itc`` against the float64 reference, or of the reference
    computed at ``prec`` when ``power`` is None."""
    args = (x, FREQS, SFREQ, 17.5, 3.0, interpolate)
    ref = zip(epochs_power_planes(*args, Precision(), "cpu"),
              epochs_planes(*args, BASELINE, Precision(), "cpu"))
    other = (zip(epochs_power_planes(*args, prec, "cpu"),
                 epochs_planes(*args, BASELINE, prec, "cpu"))
             if power is None else None)
    z = (None if power is None
         else nt.baseline_tf(power, SFREQ, *BASELINE, "zscore"))
    p_gap = z_gap = torch.zeros(len(FREQS), dtype=torch.float64)
    itc_gap = 0.0
    for (sel, p_ref, itc_ref), (_, z_ref, _) in ref:
        if power is None:
            (_, p_got, itc_got), (_, z_got, _) = next(other)
        else:
            p_got, z_got, itc_got = power[sel], z[sel], itc[sel]
        p_gap = torch.maximum(p_gap, _row_gap(p_got, p_ref))
        z_gap = torch.maximum(z_gap, _row_gap(z_got, z_ref))
        itc_gap = max(itc_gap, float((itc_got.double() - itc_ref).abs()
                                     .max()))
    return p_gap, z_gap, itc_gap


@pytest.mark.parametrize("interpolate", [False, True])
def test_power_itc_all_at_2001_samples_matches_the_float64_reference(
        interpolate):
    x = _epochs((5, 3, N_MNE), seed=11)
    ew = _adapter(x, interpolate)
    assert why_not(ew._all_data().shape,
                   ew._bank_for(ew._all_data(), FREQS)) == "n_not_pow2"
    power, itc = ew.power_itc_all(FREQS)
    assert power.shape == itc.shape == (3, len(FREQS), N_MNE)
    p_gap, z_gap, itc_gap = _gaps(x, interpolate, None, power, itc)
    assert float(p_gap.max()) <= P_TOL, p_gap
    assert float(z_gap[1:].max()) <= Z_TOL, z_gap
    assert float(z_gap[0]) <= Z1_TOL, z_gap
    assert itc_gap <= ITC_TOL, itc_gap


def test_the_bfloat16_control_fails_the_tolerances():
    """The tolerances are tight enough to refuse one precision below
    float32: on the power, the z-score from 2 Hz up, the 1 Hz z-score and
    the coherence, each on its own."""
    x = _epochs((5, 3, N_MNE), seed=11)
    p_gap, z_gap, itc_gap = _gaps(x, False, Precision("bfloat16"))
    assert float(p_gap.max()) > P_TOL, p_gap
    assert float(z_gap[1:].max()) > Z_TOL, z_gap
    assert float(z_gap[0]) > Z1_TOL, z_gap
    assert itc_gap > ITC_TOL, itc_gap


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n", [2000, 2001, 1999])
def test_one_pass_equals_the_two_reductions_bit_for_bit(n, interpolate):
    waves, bank = _inputs(_epochs((4, 3, n), seed=n), interpolate)
    power, itc = power_itc_auto(waves, bank, interpolate=interpolate)
    assert torch.equal(power, tcwt.mean_power_from_bank(waves, bank,
                                                        interpolate))
    assert torch.equal(itc, tcwt.itc_from_bank(waves, bank, interpolate))


@pytest.mark.parametrize("interpolate", [False, True])
def test_the_cpu_branch_of_the_fused_wrapper_is_the_one_pass(interpolate):
    """At a power of two the fused wrapper's CPU branch runs the same
    single pass, with the same result as the two reductions."""
    waves, bank = _inputs(_epochs((3, 2, 256), seed=5), interpolate, freqs=SHORT_FREQS)
    power, itc = fused_power_itc_from_bank(waves, bank, interpolate)
    assert torch.equal(power, tcwt.mean_power_from_bank(waves, bank,
                                                        interpolate))
    assert torch.equal(itc, tcwt.itc_from_bank(waves, bank, interpolate))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


@pytest.mark.parametrize("n_epochs", [1, 5])
def test_one_call_transforms_each_epoch_once(n_epochs):
    ew = _adapter(_epochs((n_epochs, 2, N_MNE), seed=3))
    ew._bank_for(ew._all_data(), FREQS)
    events = _profiled(lambda: ew.power_itc_all(FREQS))
    assert sum(e.name == SPAN for e in events) == n_epochs
    assert sum(e.name == "ninw.transform.plain:n_not_pow2"
               for e in events) == 1


def test_the_epoch_span_holds_the_transform_and_not_the_sums():
    waves, bank = _inputs(_epochs((3, 2, N_MNE), seed=4))
    events = _profiled(lambda: power_itc_auto(waves, bank))
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == SPAN]
    assert len(spans) == 3

    def inside(e):
        return any(s <= e.time_range.start and e.time_range.end <= t
                   for s, t in spans)
    ops = {e.name for e in events if inside(e) and e.name != SPAN}
    assert "aten::fft_ifft" in ops
    assert not ops & {"aten::add_", "aten::div", "aten::abs",
                      "aten::square"}


def test_the_term_helpers():
    c = torch.complex(torch.tensor([3.0, 0.0, -2.0 ** -20]),
                      torch.tensor([4.0, 0.0, 0.0]))
    assert torch.equal(tcwt.power_term(c),
                       torch.tensor([25.0, 0.0, 2.0 ** -40]))
    u = tcwt.unit_phase(c)
    assert torch.equal(u[0], torch.tensor(0.6 + 0.8j, dtype=u.dtype))
    assert torch.isnan(u[1].real) and u[2] == -1.0
    floored = tcwt.unit_phase(c, eps=2.0 ** -10)
    assert torch.equal(floored, torch.tensor(
        [0.6 + 0.8j, 0j, -2.0 ** -10 + 0j], dtype=u.dtype))


def test_itc_eps_floors_each_epochs_magnitude():
    waves, bank = _inputs(_epochs((3, 2, 300), seed=8), freqs=SHORT_FREQS)
    waves = waves.clone()
    waves[1, 0] = 0.0                  # zero coefficients in one epoch
    plain = tcwt.itc_from_bank(waves, bank)
    assert torch.isnan(plain[0]).all() and not torch.isnan(plain[1]).any()
    c = tcwt.cwt_from_bank(waves, bank)
    want = torch.abs((c / torch.clamp(torch.abs(c), min=1e-9)).sum(0)) / 3
    got = tcwt.itc_from_bank(waves, bank, eps=1e-9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_mean_power_gradient_is_that_of_the_formula():
    """The running sum adds into the first epoch's term in place; autograd
    still differentiates the epoch mean of |c|^2."""
    waves, bank = _inputs(_epochs((3, 2, 300), seed=9), freqs=SHORT_FREQS)
    s1 = waves.clone().requires_grad_(True)
    tcwt.mean_power_from_bank(s1, bank).sum().backward()
    s2 = waves.clone().requires_grad_(True)
    c = tcwt.cwt_from_bank(s2, bank)
    (torch.square(c.real) + torch.square(c.imag)).mean(0).sum().backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=1e-5,
                               atol=1e-6 * float(s2.grad.abs().max()))


def test_the_one_pass_differentiates_as_the_two_reductions():
    """On the CPU torch differentiates the plain route: the in-place sums
    and divisions give the two reductions' gradients."""
    waves, bank = _inputs(_epochs((3, 2, 300), seed=10), freqs=SHORT_FREQS)
    grads = []
    for one_pass in (True, False):
        s = waves.clone().requires_grad_(True)
        b = bank.clone().requires_grad_(True)
        power, itc = (power_itc_auto(s, b) if one_pass else
                      (tcwt.mean_power_from_bank(s, b),
                       tcwt.itc_from_bank(s, b)))
        (power.sum() + itc.sum()).backward()
        grads.append((s.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_one_pass_equals_the_two_reductions_within_their_memory(card):
    """At the benchmark's 200 x 64 x 2001 x 100 rows: the one-pass route
    equals the two reductions bit for bit, and allocates at its peak no
    more than they did.  It is called directly: on the card
    ``power_itc_auto`` takes the chirp-z kernel at this N
    (``tests/test_torch_czt.py``)."""
    ew = nt.EpochsWavelet(nt.ArrayEpochs(_epochs((200, 64, N_MNE), 2),
                                         SFREQ),
                          nt.Morse(SFREQ, device=card))
    waves = ew._all_data()
    bank = ew._bank_for(waves, np.linspace(1.0, 100.0, 100))
    torch.cuda.synchronize()

    def peak(fn):
        # From an empty cache, so that blocks cached by earlier tests, whose
        # sizes the allocator may hand out whole, do not count.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    (power, itc), one = peak(lambda: tcwt.power_itc_from_bank(waves, bank))
    (power2, itc2), two = peak(lambda: (
        tcwt.mean_power_from_bank(waves, bank),
        tcwt.itc_from_bank(waves, bank)))
    assert torch.equal(power, power2) and torch.equal(itc, itc2)
    assert one <= two, (one, two)
