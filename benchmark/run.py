"""Run one cell of the benchmark once (see ``benchmark/harness.py``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
