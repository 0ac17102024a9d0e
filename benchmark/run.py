"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as the last line of standard output and each compared
number beside its limit as the last lines of standard error.  Refuses
(exit code other than 0, no result) without a CUDA card.  The process
keeps to one host thread for its numerical libraries: the port's host
work is many small operations, which a thread pool slows down and makes
depend on the host's other load."""
import time

T_PROC = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

THREADS = "1"

if __name__ == "__main__":
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], T_PROC))
