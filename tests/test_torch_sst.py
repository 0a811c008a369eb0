"""The port's synchrosqueezing path (``ninwavelets_tpu_torch.ops.sst``, the
SSQ wrappers of ``ops.fused``, and the entry points that reach them) against
the JAX package on the same seeded inputs, on the CPU.

The JAX Pallas kernels run in interpret mode at ``precision="exact"``; the
port's kernel wrappers run their plain versions (the tensors lie on the
CPU).  The CUDA kernels themselves are held against those plain versions on
the card by ``chip_smoke.py``.

Gates for two synchrosqueezed planes, ``_ssq_close``:

* each time column's energy (the sum over rows) within rtol 1e-5:
  reassignment only moves energy between rows;
* SNR >= 60 dB;
* the rule for cells that moved: wherever the planes differ by more than
  1e-5 of the max, the difference is covered by the energy of source cells
  whose target row float32 cannot decide.  Those are the cells whose
  float64 instantaneous frequency lies within float32 resolution of a row
  edge (1e-5 of the top analysis frequency, scaled by sqrt(peak / p) for
  weaker cells: a cell's phase error grows as 1 / |W|), which may land in
  either row beside that edge, and the cells below 1e-4 of their signal's
  peak, which may land in any row of their column.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import fused as jfused
from ninwavelets_tpu.ops import sst as jsst
from ninwavelets_tpu.ops.bank import make_fft_bank as jbank
from ninwavelets_tpu.parallel import StreamingCWT as JStreaming
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.convert import wavelet_from_jax
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.ops import sst as tsst
from ninwavelets_tpu_torch.parallel import StreamingCWT

SFREQ = 1000.0
REL = 1e-6
GRIDS = {
    "lin": np.arange(1.0, 51.0, dtype=np.float32),
    "log": (4.0 * 2.0 ** (np.arange(40) / 8.0)).astype(np.float32),
    "pw": np.linspace(2.0, 100.0, 100).astype(np.float32),
    "irregular": np.sort(np.random.default_rng(7).uniform(
        2.0, 100.0, 30)).astype(np.float32),
}


def _bank(freqs, n, interpolate=True):
    return np.array(jbank(nw.Morse(SFREQ)._wdef(), jnp.asarray(freqs), n,
                          SFREQ, interpolate), np.float32)


def _signals(shape, tone=60.0, seed=0):
    """A tone plus 0.1 seeded noise, float32."""
    t = np.arange(shape[-1]) / SFREQ
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * tone * t)
            + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def _ambiguous(sig, bank, freqs):
    """(..., F, N) energy of the source cells whose target row float32
    cannot decide, at every row each may reach (module docstring)."""
    n = sig.shape[-1]
    spec = np.fft.fft(sig.astype(np.float64))
    spec[..., n // 2:] = 0.0
    spec = spec[..., None, :] * bank.astype(np.float64)
    k = np.arange(n)
    nu = np.where(k < (n + 1) // 2, k, k - n) * SFREQ / n
    w = np.fft.ifft(spec)
    dw = np.fft.ifft(spec * (2j * np.pi * nu))
    p = np.abs(w) ** 2
    omega = (dw * np.conj(w)).imag / (2 * np.pi * np.maximum(p, 1e-300))
    f = np.asarray(freqs, np.float64)
    edges = 0.5 * (f[1:] + f[:-1])
    i = np.clip(np.searchsorted(edges, omega), 1, edges.size - 1)
    edge = np.where(omega - edges[i - 1] < edges[i] - omega, i - 1, i)
    peak = p.max(axis=(-2, -1), keepdims=True)
    weak = p < 1e-4 * peak
    tol = 1e-5 * f.max() * np.sqrt(peak / np.maximum(p, 1e-300))
    near = (np.abs(omega - edges[edge]) <= tol) & ~weak
    allow = np.broadcast_to(np.where(weak, p, 0.0).sum(-2, keepdims=True),
                            p.shape).copy()
    flat_a = allow.reshape(-1, *p.shape[-2:])
    flat_e = edge.reshape(flat_a.shape)
    flat_p = np.where(near, p, 0.0).reshape(flat_a.shape)
    cols = np.arange(n)
    for b in range(flat_a.shape[0]):
        for row in np.nonzero(flat_p[b].any(-1))[0]:
            for side in (0, 1):
                np.add.at(flat_a[b], (flat_e[b, row] + side, cols),
                          flat_p[b, row])
    return allow


def _ssq_close(got, want, allow):
    """The module docstring's gates; ``allow`` is ``_ambiguous`` of the
    inputs, reduced like the planes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    colsum_rel = (np.abs(got.sum(-2) - want.sum(-2)).max()
                  / np.abs(want.sum(-2)).max())
    assert colsum_rel <= 1e-5, colsum_rel
    err = ((got - want) ** 2).sum()
    snr = 10 * np.log10((want ** 2).sum() / max(err, 1e-300))
    assert snr >= 60.0, snr
    d = np.abs(got - want)
    unexplained = d > allow + 1e-5 * np.abs(want).max()
    assert not unexplained.any(), (int(unexplained.sum()),
                                   float(d[unexplained].max()))


# -- the row-map hints --------------------------------------------------------

@pytest.mark.parametrize("freqs,kind", [
    (GRIDS["lin"], "lin"),
    (GRIDS["log"], "log"),
    (GRIDS["pw"], "pw"),                     # float32 linspace: 9 segments
    (np.concatenate([np.arange(1.0, 30.0), np.arange(30.0, 90.0, 2.0),
                     np.geomspace(92.0, 300.0, 40)]), "pw"),
    (GRIDS["irregular"], None),
    (np.array([5.0]), None),
    (np.array([10.0, 5.0, 1.0]), None),      # descending
    (np.array([0.0, 1.0, 2.0]), None),       # starts at 0
])
def test_uniform_grid_hint_equals_jax(freqs, kind):
    got = tsst.uniform_grid_hint(freqs)
    assert got == jsst.uniform_grid_hint(freqs)
    assert (got[0] if got else None) == kind
    if kind == "pw" and freqs is GRIDS["pw"]:
        assert len(got[1]) == 9


@pytest.mark.parametrize("edges", [
    0.5 * (GRIDS["pw"][1:] + GRIDS["pw"][:-1]).astype(np.float64),
    np.concatenate([np.arange(1.0, 10.0), np.geomspace(11.0, 200.0, 20)]),
    np.array([1.0, 2.0, 4.0, 8.0, 9.0, 10.0, 11.0]),
    np.array([3.0]),
])
def test_edge_segments_equal_jax(edges):
    assert tsst._edge_segments(edges) == jsst._edge_segments(edges)


# -- the plain path against the JAX package, every row map --------------------

@pytest.mark.parametrize("grid", list(GRIDS))
def test_ssq_power_from_bank_matches_jax(grid):
    freqs = GRIDS[grid]
    n = 1024
    sig = _signals((3, n), seed=1)
    bank = _bank(freqs, n)
    hint = tsst.uniform_grid_hint(freqs)
    got = tsst.ssq_power_from_bank(torch.from_numpy(sig),
                                   torch.from_numpy(bank), freqs, SFREQ,
                                   True, REL, hint)
    want = jsst.ssq_power_from_bank(jnp.asarray(sig), jnp.asarray(bank),
                                    freqs, SFREQ, True, REL, hint)
    assert got.dtype == torch.float32 and got.shape == (3, freqs.size, n)
    _ssq_close(got.numpy(), want, _ambiguous(sig, bank, freqs))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_ssq_mean_power_from_bank_matches_jax(grid):
    freqs = GRIDS[grid]
    n = 2048
    sig = _signals((5, 2, n), seed=2)
    bank = _bank(freqs, n)
    hint = tsst.uniform_grid_hint(freqs)
    got = tsst.ssq_mean_power_from_bank(torch.from_numpy(sig),
                                        torch.from_numpy(bank), freqs, SFREQ,
                                        True, REL, hint)
    want = jsst.ssq_mean_power_from_bank(jnp.asarray(sig), jnp.asarray(bank),
                                         jnp.asarray(freqs), SFREQ, True,
                                         REL, uniform_grid=hint)
    _ssq_close(got.numpy(), want,
               _ambiguous(sig, bank, freqs).mean(0))


def test_epoch_chunks_are_exact():
    """A chunk budget of one epoch gives the same plane as one chunk: the
    floor is per (epoch, channel)."""
    freqs = GRIDS["lin"][:20]
    sig = torch.from_numpy(_signals((4, 2, 512), seed=3))
    bank = torch.from_numpy(_bank(freqs, 512))
    hint = tsst.uniform_grid_hint(freqs)
    assert tsst._epoch_block(sig.shape, 20, budget_bytes=1) == 1
    assert tsst._epoch_block(sig.shape, 20) == (2 << 30) // (2 * 8 * 2 * 20
                                                              * 512)
    whole = tsst.ssq_mean_power_from_bank(sig, bank, freqs, SFREQ, True,
                                          REL, hint)
    each = torch.stack([tsst.ssq_power_from_bank(s, bank, freqs, SFREQ,
                                                 True, REL, hint)
                        for s in sig]).mean(0)
    torch.testing.assert_close(whole, each, rtol=1e-6, atol=0.0)


# -- the kernels' plain versions against the Pallas kernels -------------------

@pytest.mark.parametrize("grid,e", [("lin", 4), ("log", 4),
                                    ("lin", jfused.MAX_EPOCHS_PER_CALL // 2
                                     + 3)])
def test_fused_ssq_mean_power_matches_pallas(grid, e):
    """E = 11 passes the JAX kernel's epoch chunk (MAX_EPOCHS_PER_CALL //
    2 = 8): its two-chunk sum against the port's one launch."""
    freqs = GRIDS[grid]
    n = 1024
    sig = _signals((e, 3, n), tone=25.0, seed=4)
    bank = _bank(freqs, n)
    hint = tsst.uniform_grid_hint(freqs)
    assert hint[0] == grid
    got = tfused.fused_ssq_mean_power(torch.from_numpy(sig),
                                      torch.from_numpy(bank),
                                      uniform_grid=hint, sfreq=SFREQ)
    want = jfused.fused_ssq_mean_power(jnp.asarray(sig), jnp.asarray(bank),
                                       uniform_grid=hint, sfreq=SFREQ,
                                       interpret=True, precision="exact")
    _ssq_close(got.numpy(), want, _ambiguous(sig, bank, freqs).mean(0))


@pytest.mark.parametrize("e,c,n", [(3, 2, 1024), (11, 1, 2048)])
def test_ssq_peaks_match_the_amax_epilogue(e, c, n):
    """The port's K5a plain version (per-(epoch, channel) peak power)
    against the JAX "amax" epilogue in interpret mode, finished as the JAX
    package finishes it."""
    freqs = GRIDS["lin"][:30]
    sig = _signals((e, c, n), seed=5)
    bank = _bank(freqs, n)
    got = tfused.ssq_peaks(torch.from_numpy(sig), torch.from_numpy(bank))
    raw = jfused._fused_call(jnp.asarray(sig), jnp.asarray(bank), True, True,
                             "exact", "amax")
    want = np.asarray(raw).max(axis=(1, 3))[:, :e]
    assert got.shape == (c, e)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("shape,freqs,interpolate,ok", [
    ((4, 2, 2048), GRIDS["lin"][:10], True, True),
    ((4, 2, 2048), GRIDS["log"][:10], True, True),
    ((19, 64, 16384), GRIDS["lin"][:10], True, True),
    ((1, 1, 256), GRIDS["lin"][:10], True, True),
    ((4, 2, 2048), GRIDS["pw"], True, False),           # piecewise map
    ((4, 2, 2048), GRIDS["irregular"], True, False),    # edge count
    ((4, 2, 2048), GRIDS["lin"][:10], False, False),    # not analytic
    ((2, 2048), GRIDS["lin"][:10], True, False),        # no channel axis
    ((4, 2, 2000), GRIDS["lin"][:10], True, False),     # N not 2^k
    ((4, 2, 128), GRIDS["lin"][:10], True, False),      # N below range
    ((4, 2, 32768), GRIDS["lin"][:10], True, False),    # N above range
    ((4, 65536, 256), GRIDS["lin"][:10], True, False),  # C > 65535
])
def test_supports_ssq_gates(shape, freqs, interpolate, ok):
    bank = torch.zeros((freqs.size, shape[-1]))
    hint = tsst.uniform_grid_hint(freqs)
    assert tfused.supports_ssq(shape, bank, hint, interpolate) is ok
    assert not tfused.supports_ssq(shape, bank.to(torch.complex64), hint,
                                   interpolate)
    assert not tfused.supports_ssq(shape, None, hint, interpolate)


def test_cpu_dispatch_is_the_plain_path_and_launches_nothing():
    freqs = GRIDS["lin"][:20]
    sig = torch.from_numpy(_signals((3, 2, 512), seed=6))
    bank = torch.from_numpy(_bank(freqs, 512))
    hint = tsst.uniform_grid_hint(freqs)
    before = dict(kernels.launches)
    assert not tfused.ssq_kernel_takes(sig, bank, hint, True)
    torch.testing.assert_close(
        tsst.ssq_mean_power(sig, bank, freqs, SFREQ),
        tsst.ssq_mean_power_from_bank(sig, bank, freqs, SFREQ, True, REL,
                                      hint), rtol=0.0, atol=0.0)
    torch.testing.assert_close(
        tfused.fused_ssq_power_from_bank(sig, bank, uniform_grid=hint,
                                         sfreq=SFREQ),
        tsst.ssq_power_from_bank(sig, bank, freqs, SFREQ, True, REL, hint),
        rtol=0.0, atol=0.0)
    assert kernels.launches == before


# -- what surrounds the kernels, with the kernels replaced by their contract --

def emulated_amax(epilogue, spec, bank, k_bins, precision):
    """The contract of ``kernels.fused_cwt("amax", ...)``: (C, F, E) maxima
    over N of |ifft(bank x spectrum)|^2, at scale 1/N^2."""
    assert epilogue == "amax"
    n = bank.shape[-1]
    s = torch.nn.functional.pad(spec[..., :k_bins], (0, n - k_bins))
    x = torch.fft.ifft(s[:, :, None] * bank)
    return [(x.real ** 2 + x.imag ** 2).amax(-1).permute(1, 2, 0)
            .contiguous()]


def emulated_fused_ssq(spec, bank, floors, uniform_grid, sfreq):
    """The contract of ``kernels.fused_ssq``: the epoch SUM of the
    reassigned power at scale 1/N^2, gated by ``floors`` (C, E)."""
    f, n = bank.shape
    k = n // 2
    s = torch.nn.functional.pad(spec[..., :k], (0, n - k))[:, :, None]
    # The derivative spectrum as the plain path rounds it, so that both
    # give the same rows and the test sees the assembly alone.
    w = torch.fft.ifft(s * bank)
    dw = torch.fft.ifft(s * (bank * (2j * np.pi * tsst._bin_nu(n, sfreq))))
    p = w.real ** 2 + w.imag ** 2
    omega = (dw.imag * w.real - dw.real * w.imag) / (
        2 * np.pi * p.clamp(min=1e-30))
    kind, e0, step = uniform_grid
    if kind == "log":
        cnt = torch.where(omega > 0, torch.ceil(
            (torch.log(omega.clamp(min=1e-30)) - e0) / step),
            torch.zeros_like(omega))
    else:
        cnt = torch.ceil((omega - e0) / step)
    row = torch.where(p >= floors.T[:, :, None, None],
                      cnt.clamp(0, f - 1).long(),
                      torch.arange(f)[:, None].expand(f, n))
    return torch.zeros_like(p).scatter_add_(-2, row, p).sum(0)


@pytest.fixture
def contract_kernels(monkeypatch):
    calls = []

    def amax(*args):
        calls.append(("amax", tuple(args[1].shape)))
        return emulated_amax(*args)

    def ssq(spec, bank, floors, uniform_grid, sfreq):
        calls.append(("ssq", tuple(spec.shape), tuple(floors.shape)))
        return emulated_fused_ssq(spec, bank, floors, uniform_grid, sfreq)

    monkeypatch.setattr(kernels, "fused_cwt", amax)
    monkeypatch.setattr(kernels, "fused_ssq", ssq)
    return calls


@pytest.mark.parametrize("grid", ["lin", "log"])
def test_mean_wrapper_around_the_kernels(contract_kernels, grid):
    """The spectra, the (C, E) floors from the row peaks, one launch of
    each kernel for any E, and the 1/E."""
    freqs = GRIDS[grid][:24]
    sig = torch.from_numpy(_signals((7, 3, 512), seed=8))
    bank = torch.from_numpy(_bank(freqs, 512))
    hint = tsst.uniform_grid_hint(freqs)
    got = tfused._fused_ssq_sum(sig, bank, hint, SFREQ, REL) / 7
    assert contract_kernels == [("amax", (7, 3, 257)),
                                ("ssq", (7, 3, 257), (3, 7))]
    want = tsst.ssq_mean_power_from_bank(sig, bank, freqs, SFREQ, True, REL,
                                         hint)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tfused._peaks(torch.fft.rfft(sig), bank),
                               tfused.ssq_peaks(sig, bank))


def test_each_wrapper_flattens_and_chunks(contract_kernels, monkeypatch):
    """(2, 5, N) signals ride the channel axis as (1, B, N) in launches of
    at most MAX_SSQ_SIGNALS (4 here: 4 + 4 + 2), each gated on its own
    peak."""
    monkeypatch.setattr(tfused, "MAX_SSQ_SIGNALS", 4)
    freqs = GRIDS["lin"][:16]
    sig = torch.from_numpy(_signals((2, 5, 512), seed=9))
    sig[1, 4] = 0.0                                   # an all-zero signal
    bank = torch.from_numpy(_bank(freqs, 512))
    hint = tsst.uniform_grid_hint(freqs)
    got = tfused._fused_ssq_each(sig, bank, hint, SFREQ, REL)
    assert [c[:2] for c in contract_kernels] == [
        ("amax", (1, 4, 257)), ("ssq", (1, 4, 257)),
        ("amax", (1, 4, 257)), ("ssq", (1, 4, 257)),
        ("amax", (1, 2, 257)), ("ssq", (1, 2, 257))]
    assert got.shape == (2, 5, 16, 512)
    assert bool((got[1, 4] == 0).all())
    want = tsst.ssq_power_from_bank(sig, bank, freqs, SFREQ, True, REL, hint)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_launchers_reject_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("the launcher tried to build")
    monkeypatch.setattr(kernels, "_load", no_build)
    spec = torch.zeros((2, 3, 513), dtype=torch.complex64)
    bank = torch.zeros((5, 1024))
    floors = torch.zeros((3, 2))
    lin = ("lin", 1.5, 1.0)
    before = dict(kernels.launches)
    for args, match in [
            ((spec, bank, floors, lin, SFREQ), "CUDA"),
            ((spec, bank, floors, ("pw", ()), SFREQ), "row map"),
            ((spec, bank, torch.zeros((2, 3)), lin, SFREQ), "floors"),
            ((spec, bank, floors, ("lin", 1.5, 0.0), SFREQ), "step"),
            ((spec, torch.zeros((5, 1000)), floors, lin, SFREQ), "power of"),
            ((spec.real.contiguous(), bank, floors, lin, SFREQ), "spec")]:
        with pytest.raises(ValueError, match=match):
            kernels.fused_ssq(*args)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_cwt("amax", spec, bank, 512, "exact")
    assert kernels.launches == before
    assert {"amax", "ssq"} <= set(kernels.launches)


# -- the entry points against their JAX twins ---------------------------------

def _wavelets(cls="Morse", **kw):
    jw = getattr(nw, cls)(SFREQ, **kw)
    return jw, wavelet_from_jax(jw, device="cpu")


@pytest.mark.parametrize("grid", ["lin", "pw"])
def test_wavelet_ssq_power_matches_jax(grid):
    freqs = GRIDS[grid]
    sig = _signals((2, 1024), seed=10)
    jw, tw = _wavelets()
    got = tw.ssq_power(sig, freqs)
    want = jw.ssq_power(sig, freqs)
    _ssq_close(got.numpy(), want,
               _ambiguous(sig, tw.fft_wavelets.numpy(), freqs))


def test_wavelet_ssq_power_rejects_complex_banks_and_signals():
    _, mh = _wavelets("MexicanHat")
    with pytest.raises(ValueError, match="analytic"):
        mh.ssq_power(_signals((1024,)), GRIDS["lin"][:5])
    _, tw = _wavelets()
    z = _signals((1024,)) + 1j * _signals((1024,), seed=1)
    with pytest.raises(ValueError, match="real signal"):
        tw.ssq_power(z, GRIDS["lin"][:5])


def test_epochs_ssq_power_matches_jax():
    data = _signals((6, 3, 1024), tone=40.0, seed=11)
    freqs = GRIDS["lin"]
    jew = nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ),
                           nw.Morse(SFREQ, interpolate=True))
    tew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                           nt.Morse(SFREQ, interpolate=True, device="cpu"))
    bank = _bank(freqs, 1024)
    allow = _ambiguous(data, bank, freqs).mean(0)
    _ssq_close(tew.ssq_power_all(freqs).numpy(), jew.ssq_power_all(freqs),
               allow)
    _ssq_close(tew.ssq_power("ch1", freqs).numpy(),
               jew.ssq_power("ch1", freqs), allow[1])


def test_epochs_ssq_rejects_complex_banks():
    data = _signals((2, 1, 512))
    ew = nt.EpochsWavelet(nt.ArrayEpochs(data, SFREQ),
                          nt.MexicanHat(SFREQ, device="cpu"))
    with pytest.raises(ValueError, match="analytic"):
        ew.ssq_power_all(GRIDS["lin"][:5])


STREAM_KW = dict(window=1024, halo=512, interpolate=True)


def _stream_allowance(stream, sig, freqs):
    """``_ambiguous`` of every window as the stream cuts it, cropped and
    pasted like the plane: the gate is per window."""
    ext = np.stack([e for _, e in stream._ext_batches(sig)])  # (G, W, ..., L)
    h = stream.halo
    allow = _ambiguous(ext, stream._bank.numpy(), freqs)[..., h:-h]
    allow = np.moveaxis(allow, (0, 1), (-3, -2))      # (..., F, G, W, w)
    return allow.reshape(allow.shape[:-3] + (-1,))[..., :sig.shape[-1]]


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_streaming_ssq_matches_jax(use_fused, lead):
    """5000 = 4 x 1024 + 904 samples in batches of 3 windows: the second
    batch holds two zero-filled windows.  ``use_fused=True`` on the CPU runs
    the fused wrapper's plain version."""
    freqs = GRIDS["lin"][24:40]
    jw, tw = _wavelets()
    js = JStreaming(jw._wdef(), freqs, SFREQ, batch=3, use_fused=False,
                    **STREAM_KW)
    ts = StreamingCWT(tw._wdef(), freqs, SFREQ, batch=3, use_fused=use_fused,
                      device="cpu", **STREAM_KW)
    assert ts._fused is use_fused
    sig = _signals(lead + (5000,), seed=12)
    got = ts.ssq_power_device(sig)
    want = np.asarray(js.ssq_power_device(sig))
    assert got.shape == lead + (16, 5000)
    _ssq_close(got.numpy(), want, _stream_allowance(ts, sig, freqs))


def test_zero_filled_windows_give_zero_planes():
    """The floor of an all-zero window is 0, its omega 0 / (2 pi 1e-30) =
    0: every cell lands in row 0 with power 0, never NaN."""
    freqs = GRIDS["log"][:12]
    bank = torch.from_numpy(_bank(freqs, 1024))
    zero = tsst.ssq_power_from_bank(torch.zeros((3, 2, 1024)), bank, freqs,
                                    SFREQ, True, REL,
                                    tsst.uniform_grid_hint(freqs))
    assert bool((zero == 0).all())


def test_raw_ssq_power_matches_jax():
    data = _signals((3, 5000), seed=13)
    freqs = GRIDS["lin"][24:40]
    picks = ["EEG000", "EEG002"]
    jr = nw.RawWavelet(_ArrayRaw(data), nw.Morse(SFREQ, interpolate=True),
                       window=1024, halo=512, batch=2)
    tr = nt.RawWavelet(_ArrayRaw(data),
                       nt.Morse(SFREQ, interpolate=True, device="cpu"),
                       window=1024, halo=512, batch=2)
    got = tr.ssq_power(freqs, picks=picks)
    want = np.asarray(jr.ssq_power(freqs, picks=picks))
    assert got.shape == (2, 16, 5000)
    _ssq_close(got.numpy(), want,
               _stream_allowance(tr._stream_for(freqs), data[[0, 2]], freqs))


class _ArrayRaw:
    def __init__(self, data):
        self._data = data
        self.info = {"sfreq": SFREQ}
        self.ch_names = [f"EEG{i:03d}" for i in range(data.shape[0])]

    def get_data(self):
        return self._data


def test_ssq_entry_points_default_to_the_card():
    """Without a device, the synchrosqueezing entry points place their data
    on the card, and raise without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        nt.Morse(SFREQ).ssq_power(_signals((512,)), GRIDS["lin"][:5])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        nt.RawWavelet(_ArrayRaw(_signals((1, 4096))),
                      nt.Morse(SFREQ, interpolate=True),
                      window=1024).ssq_power(GRIDS["lin"][24:40])
