"""The benchmark's tests: on the CPU at small sizes, and (marked ``card``)
on a CUDA card, where they skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Small sizes that keep each CPU run to seconds: a few channels and epochs,
#: 20 analysis rows, a recording of three windows.
SMALL = {
    "eeg64_epochs.pow2_2048": {
        "traffic": {"shape": [16, 2, 2048], "pool": 2},
        "config": {"channels": 2,
                   "freqs": {"start": 1.0, "stop": 100.0, "count": 20}}},
    "eeg64_recording.default_window": {
        "traffic": {"shape": [2, 40000], "pool": 2},
        "config": {"channels": 2,
                   "freqs": {"start": 1.0, "stop": 100.0, "count": 20}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(params=sorted(SMALL))
def small_cell(request):
    return request.param, SMALL[request.param]
