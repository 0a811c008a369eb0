"""The float64 reference against the formulas and against the program at
small sizes on the CPU, through the harness's whole run."""
import math

import numpy as np
import torch

from gpubench.harness import benchmark, measure, metrics_for
from gpubench.reference import (Precision, halo_samples, morse_bank,
                                window_geometry)


def test_bank_is_the_morse_formula():
    n, sfreq, f = 64, 1000.0, 40.0
    bank = morse_bank([f], n, sfreq, 17.5, 3.0, False, Precision(), "cpu")
    k = 3
    w = k * sfreq / n / f
    want = 2 * w ** 17.5 * math.exp(17.5 / 3 * (1 - w ** 3))
    assert bank.dtype == torch.float64
    assert math.isclose(float(bank[0, k]), want, rel_tol=1e-12)
    assert float(bank[0, 0]) == 0.0
    analytic = morse_bank([f], n, sfreq, 17.5, 3.0, True, Precision(), "cpu")
    assert torch.all(analytic[0, n // 2:] == 0)
    assert torch.equal(analytic[0, :n // 2], bank[0, :n // 2])


def test_bfloat16_precision_rounds_every_stage():
    x = torch.tensor([1.0 + 2 ** -12], dtype=torch.float64)
    assert float(Precision().round(x)) == 1.0 + 2 ** -12
    assert float(Precision("bfloat16").round(x.float())) == 1.0


def test_halo_and_geometry_match_the_program():
    import ninwavelets_tpu_torch as nt
    from ninwavelets_tpu_torch.parallel.chunked import halo_samples as prog
    from ninwavelets_tpu_torch.parallel.chunked import pow2_halo
    mine = halo_samples(17.5, 3.0, 1.0, 1000.0, 1e-4)
    theirs = prog(nt.Morse(1000.0, device="cpu")._wdef(), 1.0, 1000.0,
                  tol=1e-4)
    assert abs(mine - theirs) <= 2
    halo, ext, starts = window_geometry(600000, 16384, mine)
    assert (halo, ext) == (pow2_halo(16384, theirs), 32768)
    assert starts[-1] == 36 * 16384 and len(starts) == 37


def test_reference_agrees_with_the_program_on_the_cpu(small_cell):
    name, small = small_cell
    r = measure(name, 2 ** 31 + 17, 0.2, device="cpu", overrides=small)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    bench = benchmark()
    want = {m["name"] for m in metrics_for(bench, name, False)}
    assert set(r["metrics"]) == want - {"peak_mem_GiB"}    # none off the card
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


def test_same_seed_same_inputs():
    from gpubench import traffic
    t = {"shape": [2, 3, 8], "pool": 2, "noise_std": 1.0,
         "tones": [{"hz": 10.0, "amp": 1.0, "phase_jitter": 0.5}],
         "scale": 1e-5}
    a = traffic.make_pool(t, 1000.0, 2 ** 31 + 5, "cpu")
    b = traffic.make_pool(t, 1000.0, 2 ** 31 + 5, "cpu")
    c = traffic.make_pool(t, 1000.0, 2 ** 31 + 6, "cpu")
    assert all(x.dtype == np.float64 and x.shape == (2, 3, 8) for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
