"""One run of one cell of the tidb_tpu_torch benchmark on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device, and
with --trace 1 a breakdown; the numbers compared last, under "checks")
and exits 0; without the cards the cell asks for it prints no result and
exits 2. See benchmark/README.md. Only the standard library is imported
here: the client process that multiprocessing spawns from this file
loads neither torch nor the program.
"""

import os
import sys
import time

T_START = time.monotonic()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    from harness import runner

    return runner.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the server is shut down and the client process joined; leave without
    # waiting on interpreter teardown of the program's remaining threads
    os._exit(code)
