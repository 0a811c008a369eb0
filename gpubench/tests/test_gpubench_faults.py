"""``correct`` has to come out false for the control (the reference in
bfloat16 in the program's place) and for a run whose timed path is broken
underneath: half of a batch left out, one answer altered where it is
produced.  The cells have no steps, no state carried between calls and no
exchange between chips, so those faults do not apply."""
import pytest

from ninwavelets_tpu_torch.parallel import streaming
from ninwavelets_tpu_torch.utils import mne_adapter

from gpubench.calibrate import control
from gpubench.harness import measure
from conftest import SMALL


def _run(name, **kw):
    return measure(name, 2 ** 31 + 99, 0.1, device="cpu",
                   overrides=SMALL[name], **kw)


def test_control_is_not_correct(small_cell):
    name, small = small_cell
    checks = control(name, 2 ** 31 + 99, device="cpu", overrides=small)
    assert not all(c["ok"] for c in checks.values()), checks


def _half_epochs(original):
    def broken(signals, bank, **kw):
        return original(signals[:signals.shape[0] // 2], bank, **kw)
    return broken


def _altered_power(original):
    def broken(signals, bank, **kw):
        power, itc = original(signals, bank, **kw)
        power[0, 3, 100] *= 2.0
        return power, itc
    return broken


def _half_windows(original):
    def broken(ext, bank, halo, interpolate):
        p = original(ext, bank, halo, interpolate).clone()
        p[1::2] = 0.0          # every other window of the batch
        return p
    return broken


def _altered_window(original):
    def broken(ext, bank, halo, interpolate):
        p = original(ext, bank, halo, interpolate).clone()
        p[0, 1, 3, 200] *= 2.0
        return p
    return broken


@pytest.mark.parametrize("name, module, attr, fault", [
    ("eeg64_epochs.pow2_2048", mne_adapter, "power_itc_auto", _half_epochs),
    ("eeg64_epochs.pow2_2048", mne_adapter, "power_itc_auto",
     _altered_power),
    ("eeg64_recording.default_window", streaming, "_window_power",
     _half_windows),
    ("eeg64_recording.default_window", streaming, "_window_power",
     _altered_window),
], ids=["epochs-half-batch", "epochs-altered", "recording-half-batch",
        "recording-altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, name, module, attr,
                                          fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    r = _run(name)
    assert not r["correct"], r["checks"]
    assert r["failed"] == 1
