"""The command refuses to report without the card a cell asks for, and the
card tests drive it there (marked ``card``)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _command(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "gpubench.run", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = _command("--workload", "eeg64_epochs.pow2_2048", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


def test_no_result_for_an_unknown_cell():
    r = _command("--workload", "no_such.cell", "--seed", "1", "--seconds",
                 "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["eeg64_epochs.pow2_2048",
                                  "eeg64_recording.default_window"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(card, cell, trace):
    r = _command("--workload", cell, "--seed", str(2 ** 31 + 3),
                 "--seconds", "2", "--trace", trace, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace == "1":
        assert line["device"]["busy_s"] > 0
        assert set(line["metrics"]) == {"device_idle_pct",
                                        "h2d_ms_per_call",
                                        "cwt_roofline_pct"}
