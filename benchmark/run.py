"""Run one cell of the benchmark of ``mpsnerf_torch`` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It sets up, warms up, measures for ``--seconds``, checks what the window
produced against the plain reference and prints one JSON line last on
standard output (``benchmark/harness/main.py`` says what it holds)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's spare cores are not the run's
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.harness.main import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T_START))
