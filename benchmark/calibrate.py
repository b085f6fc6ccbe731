"""Readings that the limits of ``correct`` are set from, on the card, in one
process: for each seed, a run of the cell (its set-up, a window of
``--seconds`` and the comparison with the reference), and beside the
program's numbers those of the control (the reference in the precision
below the configuration's, in the program's place) and of the planted
faults the cell can have.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# one process on the card, its host work on one thread: a host-bound cell's
# times then do not depend on how the libraries' thread pools are scheduled
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from harness import device, manifest, runner  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    sys.argv[1:] = []
    device.cache_dirs(ROOT)
    dev = device.require_cuda(1)
    print(f"card: {device.power_limit()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        cell = manifest.load_cell(args.workload)
        work_dir = tempfile.mkdtemp(prefix="bench-calibrate-")
        try:
            result = runner.execute(cell, seed, args.seconds, False, dev, work_dir,
                                    time.perf_counter(), calibrate=True)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "program": numbers,
                          "calibration": result["calibration"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
