"""Functional / parallel convenience utilities (port of
``ninwavelets_tpu.utils.tooltip``; pure Python, no tensor code).

API-parity rebuild of the reference's ``tooltip`` module: a small
deferred-call pool (``Parallel``), a chainable ``Sequence`` with optional
parallel ``map``/``starmap``, ``compose``, ``dict_map`` and ``oneline_csv``.

They serve host-side work (file IO, per-recording preprocessing); the
device work is batched on the card.  ``Sequence`` here is this module's
chainable list, not ``typing.Sequence``: import one of them under another
name where both are needed.  Two deliberate deviations from the reference:

* workers default to *threads* (``concurrent.futures``), because host-side
  workloads here are IO- or device-dispatch-bound and thread pools accept
  lambdas/closures that ``multiprocessing`` cannot pickle; pass
  ``processes=True`` for CPU-bound fan-out — process pools use the *spawn*
  context (fork deadlocks under multithreaded runtimes, and a forked child
  cannot use CUDA), so their callables must be picklable module-level
  functions and user scripts need an ``if __name__ == "__main__"`` guard;
* ``Sequence`` is immutable-by-convention: every operation returns a new
  ``Sequence``.
"""
from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import partial, reduce
from itertools import starmap as _starmap
from os import cpu_count
from typing import Any, Callable, Dict, Iterable, List, Optional


def oneline_csv(*args: Any) -> str:
    """One CSV line from the arguments (reference ``tooltip.py:9-15``).

    >>> oneline_csv(1, 'a', 2.5)
    '1,a,2.5\\n'
    """
    return ",".join(str(a) for a in args) + "\n"


def not_none(x: Any) -> bool:
    """True unless ``x`` is None (reference ``tooltip.py:18-21``).

    >>> list(filter(not_none, [1, None, 2]))
    [1, 2]
    """
    return x is not None


def compose(*funcs: Callable) -> Callable:
    """Left-to-right composition (reference ``tooltip.py:72-75``).

    >>> compose(lambda x: x + 1, lambda x: x * 2)(3)
    8
    """
    def wrap(arg: Any) -> Any:
        for f in funcs:
            arg = f(arg)
        return arg
    return wrap


def dict_map(func: Callable, dictionary: Dict) -> Dict:
    """Map over the values of a dict (reference ``tooltip.py:61-69``).

    >>> dict_map(lambda v: v * 2, {'a': 3, 'b': 4})
    {'a': 6, 'b': 8}
    """
    return {k: func(v) for k, v in dictionary.items()}


def _n_workers(core: Optional[int]) -> int:
    if not core:   # 0 or None -> all cores
        return cpu_count() or 1
    return core


def _pool(core: int, processes: bool):
    if processes:
        # spawn, not fork: fork deadlocks under multithreaded runtimes
        # (torch's thread pools), and a forked child cannot use CUDA.
        import multiprocessing
        return ProcessPoolExecutor(
            max_workers=core, mp_context=multiprocessing.get_context("spawn"))
    return ThreadPoolExecutor(max_workers=core)


class Parallel:
    """Deferred heterogeneous calls executed on a worker pool (reference
    ``tooltip.py:29-58``): ``append(fn, *args)`` queues a call, ``run()``
    executes all of them and returns their results in order.

    >>> p = Parallel(2)
    >>> _ = p.append(pow, 2, 3).append(pow, 3, 2)
    >>> p
    Parallel: pow pow
    >>> p.run()
    [8, 9]
    """

    def __init__(self, core: int = 2, processes: bool = False) -> None:
        self.calls: List[tuple] = []
        self.core = _n_workers(core)
        self.processes = processes

    def append(self, func: Callable, *args: Any, **kwargs: Any) -> "Parallel":
        self.calls.append((func, args, kwargs))
        return self

    def __repr__(self) -> str:
        return "Parallel:" + "".join(
            " " + c[0].__name__ for c in self.calls)

    def run(self) -> list:
        with _pool(self.core, self.processes) as pool:
            futures = [pool.submit(f, *a, **kw) for f, a, kw in self.calls]
            return [f.result() for f in futures]


class Sequence:
    """Chainable list with optional parallel map (reference
    ``tooltip.py:78-200``).

    >>> Sequence([1, 2, 3]).map(lambda x: x * 2).get()
    [2, 4, 6]
    >>> Sequence(zip([1, 2], [3, 4])).starmap(lambda a, b: a * b)
    Sequence: [3, 8]
    >>> Sequence([1]) & [4]
    Sequence: [1, 4]
    >>> Sequence([3, 4, 5]).filter(lambda x: x != 4)
    Sequence: [3, 5]
    >>> from operator import add
    >>> Sequence([3, 4, 5]).reduce(add)
    12
    """

    def __init__(self, itr: Iterable, core: Optional[int] = 1,
                 processes: bool = False) -> None:
        self.data: list = list(itr)
        self.core = _n_workers(core)
        self.processes = processes

    def _spawn(self, data: list) -> "Sequence":
        seq = Sequence(data, core=1, processes=self.processes)
        seq.core = self.core
        return seq

    def map(self, func: Callable, **opt: Any) -> "Sequence":
        if opt:
            func = partial(func, **opt)
        if self.core == 1:
            return self._spawn([func(x) for x in self.data])
        with _pool(self.core, self.processes) as pool:
            return self._spawn(list(pool.map(func, self.data)))

    def starmap(self, func: Callable, **opt: Any) -> "Sequence":
        if opt:
            func = partial(func, **opt)
        if self.core == 1:
            return self._spawn(list(_starmap(func, self.data)))
        with _pool(self.core, self.processes) as pool:
            return self._spawn(
                [f.result() for f in
                 [pool.submit(func, *args) for args in self.data]])

    def filter(self, func: Callable, **opt: Any) -> "Sequence":
        if opt:
            func = partial(func, **opt)
        return self._spawn([x for x in self.data if func(x)])

    def reduce(self, func: Callable, **opt: Any) -> Any:
        if opt:
            func = partial(func, **opt)
        return reduce(func, self.data)

    def __and__(self, itr: Iterable) -> "Sequence":
        return self._spawn(self.data + list(itr))

    def __iter__(self):
        return iter(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, key):
        return self.data[key]

    def get(self) -> list:
        return self.data

    def to_list(self) -> list:
        return list(self.data)

    def __str__(self) -> str:
        return "Sequence: " + str(self.data)

    __repr__ = __str__
