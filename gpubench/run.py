"""The benchmark's command, run from the root of the repository:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without enough CUDA devices for the
cell or when the JAX package or JAX is loaded in this process.
"""
import os
import sys

# Compiled bytecode goes to a fixed directory of the checkout, also where
# the environment forbids writing it: otherwise every run compiles torch's
# Python sources anew, seconds of set-up that vary from run to run.
sys.pycache_prefix = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".gpubench_cache", "pyc")
sys.dont_write_bytecode = False

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
