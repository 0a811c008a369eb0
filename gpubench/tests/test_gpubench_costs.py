"""The cost counts against hand-worked numbers."""
import pytest

from gpubench.harness import load_cell
from gpubench.costs import epochs_power_itc, raw_power
from gpubench.peaks import least_seconds


def test_epochs_cost():
    _, _, cell, config = load_cell("eeg64_epochs.pow2_2048")
    c = epochs_power_itc.cost(config, cell["traffic"])
    # 200 x 64 real FFTs (2.5 N log2 N) and 200 x 64 x 100 complex inverse
    # ones (5 N log2 N) at N = 2048
    assert c["flops"] == pytest.approx(12800 * (56320 + 100 * 112640))
    # signal, the whole bank (interpolate=False), two planes, float32
    assert c["bytes"] == pytest.approx(4 * (26214400 + 204800 + 26214400))
    assert least_seconds(c["flops"], c["bytes"]) * 1e3 == pytest.approx(
        2.1626879, rel=1e-6)     # PERF.md's K2 bound


def test_recording_cost():
    _, _, cell, config = load_cell("eeg64_recording.default_window")
    c = raw_power.cost(config, cell["traffic"])
    # 37 windows x 64 channels at the extended length 32768
    assert c["flops"] == pytest.approx(37 * 64 * (0.5 + 100) * 5 * 32768
                                       * 15)
    assert c["bytes"] == pytest.approx(
        4 * (64 * 600000 + 100 * 32768 + 64 * 100 * 600000))
    assert least_seconds(c["flops"], c["bytes"]) == pytest.approx(
        c["flops"] / 67e12)
