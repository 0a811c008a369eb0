"""The single-device hooks the port's sharded functions call, on one device:
the fused epoch sums (``ops.fused._itc_sums`` / ``_power_itc_sums``), the
sharding parameters of synchrosqueezing's core (``ops.sst._reassigned_power``:
``row_offset``, ``n_rows_out``, ``freq_group``) and of reassignment
(``ops.reassign._reassign_one``: ``f_own``, ``freq_group``), and the
``freq_group`` of the coherence floors.  Their defaults leave every
single-device result as it was, bit for bit; the row split adds up to the
whole plane.
"""
import math

import numpy as np
import pytest
import torch

import ninwavelets_tpu_torch as nt
from ninwavelets_tpu_torch.ops import cwt as tcwt
from ninwavelets_tpu_torch.ops import extensions as text
from ninwavelets_tpu_torch.ops import fused as tfused
from ninwavelets_tpu_torch.ops import reassign as treassign
from ninwavelets_tpu_torch.ops import sst as tsst
from ninwavelets_tpu_torch.ops.bank import make_fft_bank

from torch_threads import one_torch_thread  # noqa: F401

SF = 1000.0
FREQS = np.arange(10.0, 90.0, 5.0, dtype=np.float32)     # 16 rows


def _inputs(e=3, c=2, n=256, seed=0, interpolate=True):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SF
    x = (np.sin(2 * np.pi * 40 * t) + 0.3 * rng.standard_normal((e, c, n)))
    bank = make_fft_bank(nt.Morse(SF, device="cpu")._wdef(), FREQS, n, SF,
                         interpolate, device="cpu")
    return torch.from_numpy(x.astype(np.float32)), bank


def _parent_reassigned_power(signal, bank, f_grid, sfreq, interpolate,
                             rel_threshold, uniform_grid=None):
    """The single-device core as it stood before the sharding parameters."""
    n = signal.shape[-1]
    n_f = bank.shape[0]
    spec = tcwt.analytic_spectrum(signal, interpolate)[..., None, :]
    w = torch.fft.ifft(spec * bank)
    dw = torch.fft.ifft(spec * (bank * (2j * math.pi
                                        * tsst._bin_nu(n, sfreq,
                                                       bank.device))))
    power = torch.square(w.real) + torch.square(w.imag)
    num = dw.imag * w.real - dw.real * w.imag
    omega = num / (2.0 * math.pi * torch.clamp(power, min=1e-30))
    idx = tsst._row_index(omega, n_f - 1, f_grid, uniform_grid)
    floor = rel_threshold * torch.amax(power, dim=(-2, -1), keepdim=True)
    src = torch.arange(n_f, device=idx.device)[:, None].expand(n_f, n)
    idx = torch.where(power >= floor, idx, src)
    return torch.zeros_like(power).scatter_add_(-2, idx, power)


# -- the fused epoch sums -------------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
def test_itc_sums_finish_to_itc_bit_for_bit(interpolate):
    x, bank = _inputs(interpolate=interpolate)
    sr, si = tfused._itc_sums(x, bank, interpolate)
    assert sr.shape == si.shape == (2, FREQS.size, 256)
    itc = torch.abs(torch.complex(sr, si) / x.shape[0])
    assert torch.equal(itc, tcwt.itc_from_bank(x, bank, interpolate))
    assert torch.equal(itc, tfused.fused_itc_from_bank(x, bank,
                                                       interpolate))


@pytest.mark.parametrize("interpolate", [True, False])
def test_power_itc_sums_finish_to_both_bit_for_bit(interpolate):
    x, bank = _inputs(interpolate=interpolate, seed=1)
    ps, sr, si = tfused._power_itc_sums(x, bank, interpolate)
    assert torch.equal(ps / x.shape[0],
                       tcwt.mean_power_from_bank(x, bank, interpolate))
    r2, i2 = tfused._itc_sums(x, bank, interpolate)
    assert torch.equal(sr, r2) and torch.equal(si, i2)


def test_itc_sums_take_a_complex_bank():
    x, _ = _inputs()
    bank = make_fft_bank(nt.MexicanHat(SF, device="cpu")._wdef(), FREQS,
                         256, SF, False, device="cpu")
    sr, si = tfused._itc_sums(x, bank, False)
    assert torch.equal(torch.abs(torch.complex(sr, si) / 3),
                       tcwt.itc_from_bank(x, bank, False))


# -- synchrosqueezing's core ----------------------------------------------------------

@pytest.mark.parametrize("hint", [False, True])
def test_reassigned_power_defaults_are_the_parent_core(hint):
    x, bank = _inputs(seed=2)
    grid = tsst.uniform_grid_hint(FREQS) if hint else None
    got = tsst._reassigned_power(x, bank, FREQS, SF, True, 1e-6, grid)
    want = _parent_reassigned_power(x, bank, FREQS, SF, True, 1e-6, grid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hint", [False, True])
def test_reassigned_power_row_blocks_add_up(hint):
    """Row blocks of the bank scattered into the full-height plane add up
    to the whole plane (gate off: one device has no group to take the
    global floor from)."""
    x, bank = _inputs(seed=3)
    grid = tsst.uniform_grid_hint(FREQS) if hint else None
    whole = tsst._reassigned_power(x, bank, FREQS, SF, True, 0.0, grid)
    parts = sum(tsst._reassigned_power(
        x, bank[lo:lo + 4], FREQS, SF, True, 0.0, grid, row_offset=lo,
        n_rows_out=FREQS.size) for lo in range(0, FREQS.size, 4))
    assert parts.shape == whole.shape
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7 * whole.abs().max().item())


def test_reassign_one_defaults_and_own_rows():
    x, bank = _inputs(seed=4)
    f_grid = torch.from_numpy(FREQS)
    sig = x[0, 0]
    base = treassign._reassign_one(sig, bank, f_grid, SF, True, 1e-6, 16)
    again = treassign._reassign_one(sig, bank, f_grid, SF, True, 1e-6, 16,
                                    f_own=f_grid)
    assert torch.equal(base, again)
    want = treassign.reassigned_power(x[:1, :1], bank, FREQS, SF,
                                      interpolate=True)[0, 0]
    assert torch.equal(base, want)
    parts = sum(treassign._reassign_one(
        sig, bank[lo:lo + 8], f_grid, SF, True, 0.0, 16,
        f_own=f_grid[lo:lo + 8]) for lo in (0, 8))
    whole = treassign._reassign_one(sig, bank, f_grid, SF, True, 0.0, 16)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7 * whole.abs().max().item())


# -- the coherence floors ---------------------------------------------------------------

def test_coherence_floors_default_to_the_local_max():
    x, bank = _inputs(seed=5)
    sums = text.coherence_sums(x, x.flip(0), bank, True)
    for fn, args in ((text.coherence_from_sums, (3, 1e-12)),
                     (text.imcoh_from_sums, (1e-12,))):
        assert torch.equal(fn(*sums, *args), fn(*sums, *args,
                                                freq_group=None))
