"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the measured program (modules compared by their
top-level name, whole)."""
import json
import os
import subprocess
import sys

from conftest import ROOT, SMALL

RUN_ALL = f"""
import importlib, json, pkgutil, sys
import gpubench, gpubench.entries, gpubench.metrics, gpubench.costs
from gpubench import harness, calibrate, trace
for pkg in (gpubench.entries, gpubench.metrics, gpubench.costs):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
small = json.loads({json.dumps(json.dumps(SMALL))})
for cell, o in small.items():
    assert harness.measure(cell, 5, 0.05, device="cpu", overrides=o)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
import numpy as np
from gpubench import reference as ref
x = np.random.default_rng(0).standard_normal((4, 2, 256))
list(ref.epochs_planes(x, [10.0, 20.0], 1000.0, 17.5, 3.0, True, (0, 0.1),
                       ref.Precision(), "cpu"))
list(ref.recording_power_blocks(x[0], [10.0, 20.0], 1000.0, 17.5, 3.0, True,
                                1024, 1e-4, ref.Precision("bfloat16"), "cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_runs_load_no_jax():
    loaded = _top_level(RUN_ALL)
    assert "ninwavelets_tpu_torch" in loaded and "gpubench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ninwavelets_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & {"jax", "jaxlib", "flax", "ninwavelets_tpu",
                         "ninwavelets_tpu_torch"}
