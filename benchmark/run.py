"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
compared are also the last lines of standard error. Without a card, with
fewer cards than the cell asks for, or with any module of JAX or of the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# one process on the card, its host work on one thread: a host-bound cell's
# times then do not depend on how the libraries' thread pools are scheduled
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from harness import checks, device, manifest, runner  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.argv[1:] = []  # the program's Config reads --key=value arguments as overrides
    device.cache_dirs(ROOT)
    cell = manifest.load_cell(args.workload)
    try:
        dev = device.require_cuda(cell.chips)
    except device.NoDevice as e:
        print(f"run.py: {e}", file=sys.stderr, flush=True)
        return 3
    print(f"card: {device.power_limit()}", file=sys.stderr, flush=True)
    work_dir = tempfile.mkdtemp(prefix="bench-run-")
    try:
        result = runner.execute(cell, args.seed, args.seconds, bool(args.trace), dev, work_dir,
                                T_START)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    loaded = device.forbidden_modules()
    if loaded:
        print(f"run.py: modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr, flush=True)
        return 4
    checks.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
