#!/usr/bin/env python3
"""Time the port's fused score + top-k' kernel across k' and batch size.

    python3 kernel_sweep.py [--out PATH]

Needs one CUDA card. Gaussian inputs from a seeded generator at d = 64
against the ml-1M-scale catalogue (3,630 rows with PAD); for each (B, k')
prints one JSON line with the kernel's median time, the plain version's and
``torch.topk(U @ T.T)``'s, beside the card's name and power limit. How the
kernel's time grows with k' separates the selection's cost from the
products' (k' = 1 is almost only products).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def _median_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also append the JSON lines to this file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: needs a CUDA card")
    sys.path.insert(0, REPO)
    from recbole_fairrec_tpu_torch.ops import fused_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    fused_topk.build()
    gen = torch.Generator().manual_seed(0)
    I, d = 3630, 64
    T = torch.randn((I, d), generator=gen).cuda()
    lines = []
    for B in (1024, 6144):
        U = torch.randn((B, d), generator=gen).cuda()
        for k in (1, 8, 32, 173, 512, 1024):
            def library():
                s = U @ T.T
                s[:, 0] = float("-inf")
                return torch.topk(s, k, dim=1)

            row = {
                "B": B, "I": I, "d": d, "k": k,
                "ms": _median_ms(lambda: fused_topk.fused_topk_scores(U, T, k)),
                "plain_ms": _median_ms(lambda: fused_topk.fused_topk_scores_reference(U, T, k), 5),
                "library_ms": _median_ms(library),
                "card": card,
            }
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
