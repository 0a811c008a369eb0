"""The chirp-z (Bluestein) epoch reductions at N not a power of two
(``csrc/fused_czt.cu``): their plain version and tables on the CPU, the
route to them, and, marked ``card``, the kernel on a CUDA card, where those
tests skip without one.

The kernel computes the N-point inverse DFT of bank x spectrum as
conj(conv), conv = a (*) h, a circular convolution of M >= 2N - 1 points
made of two unnormalised M-point inverse DFTs (``kernels.czt_tables``,
``ops.fused.czt_from_bank``), and leaves out the output chirp w[n], which
changes neither |c| nor |sum_e c_e / |c_e||.

Gates, each with its reason:

* the chirp's phase, taken from k^2 mod 2N in integers, against the direct
  float64 exp(i pi k^2 / N) at 1e-11: the direct phase pi k^2 / N loses
  about 2e-16 x pi k^2 / N < 3e-12 at k < 2048.  The complex64 tables the
  kernel reads are the float64 ones rounded once (2^-24 relative);
* ``czt_from_bank`` in float64 against the float64 N-point CWT times the
  output chirp and conjugated, at 1e-12 of the plane's peak: both are exact
  but for float64 round-off of transforms of at most 4096 points;
* ``czt_reduction`` in float64 against the N-point route's reductions
  (``mean_power_from_bank``, ``itc_from_bank``, ``power_itc_from_bank``).
  On the analytic path (``interpolate=True``) that route is float64
  throughout: 1e-12 of the peak power, 1e-10 on the coherence.  At
  ``interpolate=False`` it takes a complex64 FFT of the signal
  (``analytic_spectrum``), so the two agree to float32 round-off: 1e-5 of
  the peak power and 1e-4 on the coherence (readings 4e-7 and 4e-6); the
  same call is held against the float64 N-point CWT at the float64 gates;
* the route: ``route()`` on shapes, and on stand-ins for CUDA tensors
  (the CPU has none): N = 2001, 421, 257, 2047
  take the chirp-z kernel, 2048 stays on the power-of-two kernel, 4097, 200
  and 32768 stay plain, as do complex signals and a complex bank; on the
  CPU the three ``*_auto`` keep ``ninw.transform.plain:n_not_pow2``;
* on the card: the kernel's three epilogues against the float64 N-point
  reductions at N = 421, 1000, 1001, 2000, 2001 and 2047 (M = 1024, 2048
  and 4096; even N, whose bin N/2 is read once, and odd), E = 7 and 200,
  C = 3 with 50 rows (150 blocks: a partial second wave on 132 SMs), both
  ``interpolate`` settings, the power within ``P_TOL`` = 1e-4 of each
  row's peak and the coherence within ``ITC_TOL`` = 0.006, the limits of
  the benchmark cell ``eeg64_mne_epochs.mne_2001``; one launch and one
  ``ninw.transform.kernel:<epilogue>_czt`` span a call, no
  ``ninw.epoch.cwt`` span; N = 2048 under the power-of-two kernel's key;
  the gradient of the chirp-z route equal to the plain route's, for each
  epilogue, "power_itc" at N = 2001 on both settings with its two planes
  weighted apart; at the cell's shape, a peak allocation below the plain
  route's.

This file imports neither JAX nor the JAX package, so that the card tests
run on a machine without it (``--noconftest``; README).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import fused

from torch_threads import one_torch_thread  # noqa: F401

LENGTHS = [257, 421, 1000, 2001, 2047]
P_TOL = 1e-4
ITC_TOL = 0.006


def _cwt64(signal, bank, interpolate):
    """The N-point CWT in complex128: the first N // 2 bins of a real
    signal's spectrum on the analytic path, all N otherwise."""
    n = signal.shape[-1]
    spec = torch.fft.fft(signal.to(torch.float64))
    if interpolate:
        spec[..., n // 2:] = 0
    return torch.fft.ifft(spec[..., None, :] * bank.to(torch.float64))


def _reductions64(signals, bank, interpolate):
    """(mean power, itc) of ``_cwt64`` over the epochs."""
    power, phase = tcwt._epoch_sum(signals, bank, interpolate,
                                   tcwt.power_term, tcwt.unit_phase,
                                   transform=_cwt64)
    e = signals.shape[0]
    return power / e, torch.abs(phase) / e


def _inputs(n, n_epochs, seed, channels=2, rows=3):
    rng = np.random.default_rng(seed)
    signals = torch.from_numpy(rng.standard_normal((n_epochs, channels, n)))
    bank = torch.from_numpy(np.abs(rng.standard_normal((rows, n))))
    return signals, bank


def _peak_gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _abs_gap(got, want):
    return float((got - want).abs().max())


@pytest.mark.parametrize("n,m", [(257, 1024), (421, 1024), (512, None),
                                 (1000, 2048), (1025, 4096), (2001, 4096),
                                 (2047, 4096), (2048, None), (2049, None),
                                 (256, None), (200, None), (4097, None)])
def test_czt_size_is_the_least_power_of_two_past_2n_minus_1(n, m):
    if m is None:
        with pytest.raises(ValueError, match="chirp-z"):
            kernels.czt_size(n)
    else:
        assert kernels.czt_size(n) == m >= 2 * n - 1 > m // 2


@pytest.mark.parametrize("n", [421, 2001, 2047])
def test_the_chirp_phase_matches_the_direct_exponential(n):
    w, filt = kernels.czt_tables(n)
    k = np.arange(n, dtype=np.float64)
    assert np.abs(w - np.exp(1j * np.pi * k * k / n)).max() <= 1e-11
    m = kernels.czt_size(n)
    h = np.zeros(m, dtype=np.complex128)
    for j in range(1 - n, n):
        h[j % m] = np.exp(-1j * np.pi * j * j / n)
    assert np.abs(filt - np.fft.ifft(h)).max() <= 1e-11 * np.abs(filt).max()
    for table, stored in zip((w, filt),
                             kernels._czt_tables(n, torch.device("cpu"))):
        assert stored.dtype == torch.complex64
        assert np.abs(stored.numpy() - table).max() <= \
            2.0 ** -24 * np.abs(table).max()


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_czt_coefficients_are_the_cwt_without_its_output_chirp(n,
                                                               interpolate):
    signals, bank = _inputs(n, 1, seed=n)
    got = fused.czt_from_bank(signals[0], bank, interpolate)
    c = _cwt64(signals[0], bank, interpolate)
    w = torch.from_numpy(kernels.czt_tables(n)[0])
    assert got.dtype == torch.complex128 and got.shape == c.shape
    assert _peak_gap(got, c.conj() * w) <= 1e-12


@pytest.mark.parametrize("n_epochs", [1, 7])
@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_czt_reductions_match_the_n_point_route(n, interpolate, n_epochs):
    signals, bank = _inputs(n, n_epochs, seed=n + n_epochs)
    power, itc = fused.czt_reduction("power_itc", signals, bank, interpolate)
    # Each epilogue alone is the same sums as the joint one.
    assert torch.equal(fused.czt_reduction("power", signals, bank,
                                           interpolate)[0], power)
    assert torch.equal(fused.czt_reduction("itc", signals, bank,
                                           interpolate)[0], itc)
    p_tol, i_tol = (1e-12, 1e-10) if interpolate else (1e-5, 1e-4)
    p_ref, i_ref = tcwt.power_itc_from_bank(signals, bank, interpolate)
    for ref in (p_ref, tcwt.mean_power_from_bank(signals, bank,
                                                 interpolate)):
        assert _peak_gap(power, ref) <= p_tol
    for ref in (i_ref, tcwt.itc_from_bank(signals, bank, interpolate)):
        assert _abs_gap(itc, ref) <= i_tol
    p64, i64 = _reductions64(signals, bank, interpolate)
    assert _peak_gap(power, p64) <= 1e-12
    assert _abs_gap(itc, i64) <= 1e-10


class _OnCard:
    """What the dispatch reads of a tensor, for a tensor on a card: the
    CPU has no CUDA tensor to route."""

    def __init__(self, shape, complex_=False):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.is_cuda = True
        self.device = torch.device("cuda")
        self._complex = complex_

    def is_complex(self):
        return self._complex

    def is_floating_point(self):
        return not self._complex

    @property
    def real(self):
        return _OnCard(self.shape)


ROUTES = [
    (2001, {}, "czt", "kernel:{}_czt"),
    (421, {}, "czt", "kernel:{}_czt"),
    (257, {}, "czt", "kernel:{}_czt"),
    (2047, {}, "czt", "kernel:{}_czt"),
    (2048, {}, True, "kernel:{}"),
    (4097, {}, False, "plain:n_not_pow2"),
    (200, {}, False, "plain:n_not_pow2"),
    (32768, {}, False, "plain:n_range"),
    (2001, {"signals": True}, False, "plain:n_not_pow2"),
    (2001, {"bank": True}, False, "plain:n_not_pow2"),
]


@pytest.mark.parametrize("epilogue", ["power", "itc", "power_itc"])
@pytest.mark.parametrize("n,complex_,takes,name", ROUTES)
def test_the_route_on_a_card(n, complex_, takes, name, epilogue):
    signals = _OnCard((3, 2, n), complex_.get("signals", False))
    bank = _OnCard((5, n), complex_.get("bank", False))
    r = fused.route(epilogue, signals, bank, czt=True)
    assert r.span == "ninw.transform." + name.format(epilogue)
    # The span names the route; the fused wrapper runs on "kernel:<epilogue>"
    # alone, the chirp-z kernel on "<epilogue>_czt", the plain route
    # otherwise.
    assert r.key == {True: epilogue, "czt": epilogue + "_czt",
                     False: None}[takes]


@pytest.mark.parametrize("shape,bank,takes", [
    ((3, 2, 2001), torch.ones(5, 2001), True),
    ((3, 2, 421), torch.ones(5, 421), True),
    ((1, 1, 257), torch.ones(1, 257), True),
    ((3, 2, 2047), torch.ones(5, 2047), True),
    ((3, 2, 2048), torch.ones(5, 2048), False),            # K1/K2
    ((3, 2, 2049), torch.ones(5, 2049), False),            # M = 8192
    ((3, 2, 4097), torch.ones(5, 4097), False),
    ((3, 2, 32768), torch.ones(5, 32768), False),          # n_range
    ((3, 2, 200), torch.ones(5, 200), False),
    ((3, 2, 256), torch.ones(5, 256), False),
    ((3, 2, 2001), torch.ones(5, 2001, dtype=torch.complex64), False),
    ((3, 2, 2001), torch.ones(5, 2000), False),            # shape
    ((3, 65536, 2001), torch.ones(5, 2001), False),        # channels
    ((3, 2001), torch.ones(5, 2001), False),               # no channel axis
])
def test_czt_route_on_shapes(shape, bank, takes):
    r = fused.route("power", shape, _OnCard(bank.shape, bank.is_complex()),
                    device="cuda", czt=True)
    assert (r.key == "power_czt") == takes


def _span_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("ninw.")]


@pytest.mark.parametrize("auto", [fused.mean_power_auto, fused.itc_auto,
                                  fused.power_itc_auto])
def test_on_the_cpu_the_route_stays_plain(auto):
    signals, bank = _inputs(2001, 2, seed=1)
    signals, bank = signals.float(), bank.float()
    before = dict(kernels.launches)
    names = _span_names(lambda: auto(signals, bank))
    assert kernels.launches == before
    assert [n for n in names if n.startswith("ninw.transform.")] == [
        "ninw.transform.plain:n_not_pow2"]
    assert names.count("ninw.epoch.cwt") == 2


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(n, n_epochs, interpolate, device):
    """Noise and a 10 Hz rhythm of random phase, about 10 uV in volts, at
    1 kHz, 3 channels; the Morse bank of 50 rows, 4 to 100 Hz."""
    rng = np.random.default_rng(n + n_epochs)
    t = np.arange(n) / 1000.0
    phase = rng.uniform(-np.pi, np.pi, (n_epochs, 3, 1))
    x = 1e-5 * (rng.standard_normal((n_epochs, 3, n))
                + 2.0 * np.sin(2 * np.pi * 10.0 * t + phase))
    ew = nt.EpochsWavelet(nt.ArrayEpochs(x, 1000.0),
                          nt.Morse(1000.0, interpolate=interpolate,
                                   device=device))
    waves = ew._all_data()
    return waves, ew._bank_for(waves, np.linspace(4.0, 100.0, 50))


def _row_gap(got, ref):
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


AUTOS = {"power": fused.mean_power_auto, "itc": fused.itc_auto,
         "power_itc": fused.power_itc_auto}


@pytest.mark.card
@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("n_epochs", [7, 200])
@pytest.mark.parametrize("n", [421, 1000, 1001, 2000, 2001, 2047])
@pytest.mark.parametrize("epilogue", ["power", "itc", "power_itc"])
def test_card_czt_matches_the_float64_route(card, epilogue, n, n_epochs,
                                            interpolate):
    waves, bank = _card_inputs(n, n_epochs, interpolate, card)
    kernels.reset_launches()
    names = _span_names(lambda: AUTOS[epilogue](
        waves, bank, interpolate=interpolate))
    torch.cuda.synchronize()
    assert kernels.launches[f"{epilogue}_czt"] == 1
    assert sum(kernels.launches.values()) == 1
    assert "ninw.epoch.cwt" not in names
    assert [n for n in names if n.startswith("ninw.transform.")] == [
        f"ninw.transform.kernel:{epilogue}_czt"]
    out = AUTOS[epilogue](waves, bank, interpolate=interpolate)
    got = out if isinstance(out, tuple) else (out,)
    p64, i64 = _reductions64(waves, bank, interpolate)
    want = {"power": (p64,), "itc": (i64,), "power_itc": (p64, i64)}
    for plane, ref in zip(got, want[epilogue]):
        assert plane.dtype == torch.float32 and plane.shape == ref.shape
    if epilogue != "itc":
        assert _row_gap(got[0], p64) <= P_TOL
    if epilogue != "power":
        assert _abs_gap(got[-1].double(), i64) <= ITC_TOL


@pytest.mark.card
@pytest.mark.parametrize("interpolate", [False, True])
def test_card_czt_keeps_the_phase_of_an_underflowing_row(card, interpolate):
    """At N = 421 the 1 Hz Morse row holds one bin of about 3e-25, so its
    power underflows float32 in both routes while the plain route's unit
    phase stays finite: the kernel gives that row zero power and the same
    finite coherence, not the NaN of 0 * rsqrt(0)."""
    rng = np.random.default_rng(13)
    waves = torch.from_numpy(rng.standard_normal((19, 3, 421),
                                                 dtype=np.float32)).to(card)
    bank = nt.Morse(1000.0, interpolate=interpolate,
                    device=card).make_fft_wavelets(np.arange(1.0, 14.0),
                                                   0.421)
    power, itc = fused.power_itc_auto(waves, bank, interpolate=interpolate)
    p_ref, i_ref = tcwt.power_itc_from_bank(waves, bank, interpolate)
    assert kernels.launches["power_itc_czt"] > 0
    assert float(p_ref[:, 0].abs().max()) == 0.0
    assert float(power[:, 0].abs().max()) == 0.0
    assert bool(i_ref.isfinite().all()) and bool(itc.isfinite().all())
    assert _row_gap(power[:, 1:], p_ref[:, 1:]) <= P_TOL
    assert _abs_gap(itc, i_ref) <= ITC_TOL


@pytest.mark.card
def test_card_power_of_two_stays_on_its_kernel(card):
    waves, bank = _card_inputs(2048, 7, False, card)
    kernels.reset_launches()
    names = _span_names(lambda: fused.power_itc_auto(waves, bank))
    torch.cuda.synchronize()
    assert kernels.launches["power_itc"] == 1
    assert kernels.launches["power_itc_czt"] == 0
    assert "ninw.transform.kernel:power_itc" in names


@pytest.mark.card
@pytest.mark.parametrize("auto,plain,n,interpolate", [
    (fused.mean_power_auto, tcwt.mean_power_from_bank, 421, False),
    (fused.itc_auto, tcwt.itc_from_bank, 421, False),
    (fused.power_itc_auto, tcwt.power_itc_from_bank, 2001, False),
    (fused.power_itc_auto, tcwt.power_itc_from_bank, 2001, True)])
def test_card_czt_gradient_is_the_plain_routes(card, auto, plain, n,
                                               interpolate):
    """The chirp-z route's backward differentiates the plain route: the
    same gradients through autograd, on both planes of "power_itc", each
    weighted apart so that a cotangent given to the wrong plane shows."""
    waves, bank = _card_inputs(n, 7, interpolate, card)
    weights = torch.rand((2, *bank.shape[:1], n), generator=torch.Generator(
        device=card).manual_seed(n), device=card)
    grads = []
    for fn in (auto, plain):
        s = waves.clone().requires_grad_(True)
        b = bank.clone().requires_grad_(True)
        kernels.reset_launches()
        out = (fn(s, b, interpolate=interpolate) if fn is auto
               else fn(s, b, interpolate))
        planes = out if isinstance(out, tuple) else (out,)
        assert sum(kernels.launches.values()) == (fn is auto)
        sum((w * p).sum() for w, p in zip(weights, planes)).backward()
        grads.append((s.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.card
def test_card_czt_peak_allocation_is_below_the_plain_routes(card):
    """At the benchmark cell's 200 x 64 x 2001 x 100 rows: the chirp-z
    route holds the rFFT rows and its two planes, and no epoch's
    coefficients, so its peak allocation is below the plain route's."""
    rng = np.random.default_rng(7)
    ew = nt.EpochsWavelet(
        nt.ArrayEpochs(1e-5 * rng.standard_normal((200, 64, 2001)), 1000.0),
        nt.Morse(1000.0, device=card))
    waves = ew._all_data()
    bank = ew._bank_for(waves, np.linspace(1.0, 100.0, 100))
    torch.cuda.synchronize()

    def peak(fn):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    kernels.reset_launches()
    czt = peak(lambda: fused.power_itc_auto(waves, bank))
    assert kernels.launches["power_itc_czt"] == 1
    plain = peak(lambda: tcwt.power_itc_from_bank(waves, bank))
    assert czt < plain, (czt, plain)
