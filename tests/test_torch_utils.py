"""The port's utilities (``ninwavelets_tpu_torch.utils.observability``,
``tooltip``, ``report``, ``plotting``, ``WaveletBase.plot``) and its public
surface against the JAX package, on the CPU.

Gates, each with its reason:

* ``cwt_cost``: equal to JAX's (the same arithmetic, copied);
* the tooltip cases of ``tests/test_utils.py::TestTooltip`` and its
  process-pool cases, on the port's module;
* report HTML: equal to JAX's for the same text, table and dict sections,
  its default title included; a figure renders inline as a base64 PNG;
* ``_topo_grid``: within 1e-5 of the max of JAX's (the same float64 host
  spline on both sides); the Agg image data of ``plot_tf``,
  ``plot_topomap``, ``plot_microstates`` and ``plot_wavelet`` equal to
  JAX's for the same values (the port's given as tensors);
* ``debug_nans``: ``FloatingPointError`` inside the context, for an op and
  for a kernel launcher's output, nothing outside it or inside
  ``debug_nans(False)``, no false alarm from an uninitialized buffer;
* the surface: every name of JAX's ``__all__`` (package, ``utils``, ``io``)
  in the port's counterpart, and by an AST count every method of JAX's
  ``RawWavelet`` (36) and ``EpochsWavelet`` (93) in the port's, and
  ``WaveletBase.plot``;
* imports: the package and every module import with ``matplotlib``
  blocked (``tests/test_torch_slice.py`` blocks ``jax`` the same way).
"""
import ast
import doctest
import logging
import operator
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ninwavelets_tpu as nw
import ninwavelets_tpu_torch as nt
from ninwavelets_tpu.utils import observability as jobs
from ninwavelets_tpu.utils import plotting as jplot
from ninwavelets_tpu.utils import report as jreport
from ninwavelets_tpu_torch import kernels
from ninwavelets_tpu_torch.utils import observability as tobs
from ninwavelets_tpu_torch.utils import plotting as tplot
from ninwavelets_tpu_torch.utils import report as treport
from ninwavelets_tpu_torch.utils import tooltip

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- observability ----------------------------------------------------------

@pytest.mark.parametrize("batch,n_freqs,n,analytic", [
    (8, 100, 2048, True), (12800, 100, 2048, False), (1, 1, 2, True),
    (3, 7, 1000, True)])
def test_cwt_cost_equals_jax(batch, n_freqs, n, analytic):
    got = tobs.cwt_cost(batch, n_freqs, n, analytic)
    want = jobs.cwt_cost(batch, n_freqs, n, analytic)
    assert (got.flops, got.hbm_bytes, got.coeff_bytes) == (
        want.flops, want.hbm_bytes, want.coeff_bytes)
    assert got.arithmetic_intensity == want.arithmetic_intensity


def test_timer_blocks_on_nested_tensors():
    w = nt.Morse(1000.0, device="cpu")
    sig = torch.ones((8, 256))
    with tobs.Timer("t") as t:
        out = w.power(sig, [10.0, 20.0])
        t.block(out, (out, [out]), {"a": out}, None)
    assert t.elapsed > 0


def test_timer_logs_at_debug(caplog):
    with caplog.at_level(logging.DEBUG, logger="ninwavelets_tpu_torch"):
        with tobs.Timer("named"):
            pass
    assert [r.args[0] for r in caplog.records] == ["named"]


def test_logger_is_quiet():
    log = logging.getLogger("ninwavelets_tpu_torch")
    assert tobs.log is log
    assert any(isinstance(h, logging.NullHandler) for h in log.handlers)


def test_trace_writes_files(tmp_path):
    with tobs.trace(str(tmp_path)):
        torch.square(torch.arange(8.0)).sum()
    assert any(tmp_path.iterdir())          # trace files written


def test_debug_nans():
    x = torch.zeros(3)
    nan = x / 0
    assert torch.isnan(nan).all()           # off: no check
    with tobs.debug_nans(True):
        assert kernels.nan_check
        y = x + 1                            # clean ops pass
        with pytest.raises(FloatingPointError, match="div"):
            x / 0
        with tobs.debug_nans(False):
            assert torch.isnan(x / 0).all()
        with pytest.raises(FloatingPointError):
            torch.log(-y)
        # an uninitialized buffer, partly written, is not a NaN
        buf = torch.empty(1000)
        buf[:10] = 1.0
        assert float(buf.sum()) == 10.0
        # a kernel launcher's own check (the dispatcher never sees it)
        kernels._check_nans("power", [torch.ones(2)])
        with pytest.raises(FloatingPointError, match="kernel power_each"):
            kernels._check_nans("power_each", [nan])
        with pytest.raises(FloatingPointError, match="lift_fresh"):
            torch.tensor([float("nan")])     # a NaN made inside is caught
        # an entry point on clean data raises nothing
        nt.Morse(1000.0, device="cpu").power(torch.ones(256), [10.0])
    assert not kernels.nan_check
    kernels._check_nans("power", [nan])
    assert torch.isnan(x / 0).all()


# -- tooltip (tests/test_utils.py::TestTooltip and the process pools) --------

def test_tooltip_doctests():
    assert doctest.testmod(tooltip).failed == 0


def test_tooltip_cases():
    p = tooltip.Parallel(3)
    for i in range(5):
        p.append(operator.mul, i, 10)
    assert p.run() == [0, 10, 20, 30, 40] and "mul" in repr(p)
    out = (tooltip.Sequence([1, 2, 3, 4]).map(lambda x: x * 2)
           .filter(lambda x: x > 2).reduce(operator.add))
    assert out == 18
    seq = tooltip.Sequence(range(10), core=4)
    assert seq.map(lambda x: x * x).get() == [i * i for i in range(10)]
    s = tooltip.Sequence([5, 6, 7])
    assert len(s) == 3 and s[1] == 6 and list(s) == [5, 6, 7]
    assert (s & [8]).to_list() == [5, 6, 7, 8]
    assert str(s) == "Sequence: [5, 6, 7]"
    assert tooltip.Sequence(zip([1, 2], [3, 4])).starmap(
        operator.mul).get() == [3, 8]
    assert tooltip.Sequence(zip([1, 2], [3, 4]), core=2).starmap(
        operator.mul).get() == [3, 8]
    assert tooltip.compose(str, len)(1234) == 4
    assert tooltip.dict_map(abs, {"a": -1}) == {"a": 1}
    assert tooltip.oneline_csv(1, "x") == "1,x\n"
    assert tooltip.not_none(0) and not tooltip.not_none(None)


def test_tooltip_process_pools():
    p = tooltip.Parallel(2, processes=True)
    p.append(abs, -3).append(abs, -4)
    assert p.run() == [3, 4]
    s = tooltip.Sequence([1, 2, 3], core=2, processes=True)
    assert s.map(abs).get() == [1, 2, 3]


# -- report ------------------------------------------------------------------

def _fill(rep):
    rep.add_text("Notes", "artifact <run> excluded\nsecond line")
    rep.add_table("Peaks", {"channel": ["Fz", "Cz", "P&z"],
                            "latency_ms": np.array([101.5, 99.25, 1e-7]),
                            "n": np.array([3, 4, 5])})
    rep.add_table("Fmt", {"x": [0.123456789]}, float_fmt="%.2f")
    rep.add_dict("Summary", {"gev": np.float32(0.8125), "maps": np.ones((4, 3)),
                             "k": 4})
    return rep


def test_report_html_equals_jax(tmp_path):
    assert treport.Report().render() == jreport.Report().render()
    got, want = _fill(treport.Report("S01")), _fill(jreport.Report("S01"))
    assert got.render() == want.render()
    path = got.save(str(tmp_path / "r.html"))
    assert open(path, encoding="utf-8").read() == want.render()
    with pytest.raises(ValueError, match="share a length"):
        treport.Report().add_table("bad", {"a": [1, 2], "b": [1]})


def test_report_figure_inline():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    rep = treport.Report()
    rep.add_figure("Fig", fig, caption="a <caption>")
    html = rep.render()
    assert 'src="data:image/png;base64,' in html
    assert "<em>a &lt;caption&gt;</em>" in html
    assert not plt.fignum_exists(fig.number)


# -- plotting ----------------------------------------------------------------

def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.fixture
def agg():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def _montage(c=16):
    i = np.arange(c) + 0.5
    polar = np.arccos(1 - i / c)             # upper hemisphere
    az = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(polar) * np.cos(az), np.sin(polar) * np.sin(az),
                     np.cos(polar)], 1)


def test_topo_grid_matches_jax():
    pos = _montage()
    vals = np.random.default_rng(0).standard_normal(16)
    got, rad = tplot._topo_grid(torch.from_numpy(vals), torch.from_numpy(pos),
                                48)
    want, jrad = jplot._topo_grid(vals, pos, 48)
    assert rad == jrad
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(np.abs(got - want)) <= 1e-5 * np.nanmax(np.abs(want))


def test_plot_tf_and_topomap_images_equal_jax(agg):
    data = np.random.default_rng(1).random((20, 300)).astype(np.float32)
    kw = dict(sfreq=100.0, frange=(1, 21, 5), trange=(0, 3, 1), show=False)
    got = tplot.plot_tf(torch.from_numpy(data), **kw).figure
    want = jplot.plot_tf(data, **kw).figure
    assert np.array_equal(_pixels(got), _pixels(want))
    pos = _montage()
    vals = np.random.default_rng(2).standard_normal(16)
    got = tplot.plot_topomap(torch.from_numpy(vals), pos, show=False).figure
    want = jplot.plot_topomap(vals, pos, show=False).figure
    assert np.array_equal(_pixels(got), _pixels(want))


def test_plot_microstates_and_wavelet_images_equal_jax(agg):
    pos = _montage()
    maps = np.random.default_rng(3).standard_normal((3, 16))
    stats = {"coverage": np.array([0.5, 0.3, 0.2])}
    got = tplot.plot_microstates(torch.from_numpy(maps), pos,
                                 {"coverage": torch.tensor([0.5, 0.3, 0.2])},
                                 show=False)
    want = jplot.plot_microstates(maps, pos, stats, show=False)
    assert [a.get_title() for a in got.axes] == ["A  50%", "B  30%",
                                                 "C  20%"]
    assert np.array_equal(_pixels(got), _pixels(want))
    for family in ("Morse", "MexicanHat"):
        tw = getattr(nt, family)(1000.0, device="cpu")
        got = tw.plot(40.0, show=False)
        want = getattr(nw, family)(1000.0).plot(40.0, show=False)
        assert len(got.axes) == len(want.axes)
        assert np.array_equal(_pixels(got), _pixels(want)), family


# -- the surface ---------------------------------------------------------------

def test_every_jax_export_exists_in_the_port():
    import ninwavelets_tpu.io as jio
    import ninwavelets_tpu.utils as jutils
    for jmod, tmod in ((nw, nt), (jutils, nt.utils), (jio, nt.io)):
        missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
        assert not missing, (jmod.__name__, missing)
        assert set(jmod.__all__) <= set(tmod.__all__), jmod.__name__


def _methods(path, cls):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    return {n.name for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("cls,count", [("RawWavelet", 36),
                                       ("EpochsWavelet", 93)])
def test_ast_method_count(cls, count):
    path = os.path.join("utils", "mne_adapter.py")
    want = _methods(os.path.join("ninwavelets_tpu", path), cls)
    got = _methods(os.path.join("ninwavelets_tpu_torch", path), cls)
    assert len(want) == count
    assert want <= got, sorted(want - got)


def test_wavelet_base_has_plot():
    """``WaveletBase.plot``; JAX's other two extras, ``_params`` and
    ``_bank_for`` (its float-pair bank cache), have no port by design."""
    path = os.path.join("models", "base.py")
    want = _methods(os.path.join("ninwavelets_tpu", path), "WaveletBase")
    got = _methods(os.path.join("ninwavelets_tpu_torch", path),
                   "WaveletBase")
    assert "plot" in want and "plot" in got
    assert want - got == {"_params", "_bank_for"}


def test_imports_without_matplotlib():
    """The package and every module import with ``matplotlib`` blocked;
    a plot then fails at its call, not at import."""
    code = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('matplotlib', 'jax', 'ninwavelets_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import pkgutil, ninwavelets_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
assert not {'matplotlib', 'jax'} & set(sys.modules)
try:
    pkg.plot_tf([[0.0]], show=False)
except ImportError as exc:
    print('ok', exc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok blocked: matplotlib")
