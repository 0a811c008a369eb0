"""One module per metric, named as in ``BENCHMARK.json`` (a ``.`` in the
name is ``__`` in the module's).  Each defines ``read(run)``, which takes
the harness's ``Run`` record and returns the metric's value, or None when
the run holds nothing to read it from: the harness then leaves the metric
out of the result line."""
