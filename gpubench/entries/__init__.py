"""One module per entry point the cells time.

An entry module defines ``Entry(config, cell, seed, device)`` with:

* ``call(i) -> (key, output)``: the timed call ``i``, from the user's host
  data to a result on the device; ``key`` says which input it took;
* ``channel_seconds``: the channel-seconds of signal one call turns into
  planes;
* ``release()``: drops the program's state (wavelets, banks, adapters);
* ``numbers(key, output) -> {name: value}``: the comparison with the
  float64 reference (``gpubench.reference``), which decides ``correct``;
* ``control(key)``: the reference in bfloat16 put in the program's place,
  an output to hand ``numbers``; read by ``gpubench.calibrate`` and the
  tests, never by a run.
"""
