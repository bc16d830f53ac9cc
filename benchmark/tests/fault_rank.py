"""A rank of the benchmark with the timed path broken underneath (for
test_bench_control.py): `python -m benchmark.tests.fault_rank <fault>
<run.py's arguments>`."""
from __future__ import annotations

import sys

from benchmark import run
from benchmark.tests.test_bench_control import install


if __name__ == "__main__":
    install(sys.argv[1])
    sys.exit(run.main(sys.argv[2:]))
