"""The benchmark of ``ninwavelets_tpu_torch`` on NVIDIA cards.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of the repository.  ``BENCHMARK.json`` names the cells and
metrics; each cell, configuration, entry, cost count and metric lives in a
file of its own here, found by its name (``harness``).
"""
