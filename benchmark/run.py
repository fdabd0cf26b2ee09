"""Entry of the benchmark: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Run from the root of a checkout; see ``harness.py``."""

import sys
from pathlib import Path

# the checkout's root in place of this directory, so that the program and the
# benchmark import as packages and no module here shadows one of the library's
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
