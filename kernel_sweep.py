#!/usr/bin/env python3
"""Time the port's fused score + top-k' kernel across k' and batch size,
or its CSR product at FairGo's Last.fm-360K shapes.

    python3 kernel_sweep.py [--out PATH] [--profile] [--scale [--modes]]
    python3 kernel_sweep.py --spmm [--out PATH]

Needs one CUDA card. Gaussian inputs from a seeded generator at d = 64
against the ml-1M-scale catalogue (3,630 rows with PAD; 16,384 rows for
k' 4096, the largest the kernel takes); for each (B, k')
prints one JSON line with the kernel's median time of one call (``ms``) and
of a call among 10 back to back (``ms_back_to_back``), the wrapper's host
time per call (``host_us``), the plain version's and ``torch.topk(U @
T.T)``'s times of one call, beside the card's name and power limit. How the
kernel's time grows with k' separates the selection's cost from the
products' (k' = 1 is almost only products). ``--profile`` adds the device
time of each CUDA kernel of one call (``torch.profiler``, mean over 10
calls), which splits the score + select kernel from the merge.
``--scale`` times bench.py's catalog instead (``chip_smoke.py``'s scale
rows: a 2,097,152 x 128 table and users in bfloat16, then in float16, at B
128 and 1024, k' 10, each checked against the plain version, with the
split, the bound and the library call). ``--modes`` then times the
bfloat16 table at each B again with range mode off (a list per chunk on
the tensor-core kernel, ``mma.sync``) and on (the Hopper range kernel, TMA
+ ``wgmma``, the plan's default), at k' 1 and 10, each with its split:
what the selection costs beside the products, and what range mode
saves.

``--spmm`` times ``ops/spmm_csr.py`` instead: ``chip_smoke.graph_rows``
alone (chip_smoke's ``graph`` phase), the kernel forward over a D⁻¹A of the
shapes of the benchmark's ``fairgo_pmf-lastfm360k`` and backward over Aᵀ,
checked and timed beside its bound, the plain version, the hop that
builds its pair for the call and cuSPARSE (``library_ms``, a yardstick the
port never calls).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _host_us(fn, calls=20):
    """Host time of one call while the card is busy with the calls before
    it (none of them waits for the card): the wrapper's own cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also append the JSON lines to this file")
    parser.add_argument("--profile", action="store_true",
                        help="also report the device time of each CUDA kernel per call")
    parser.add_argument("--scale", action="store_true",
                        help="time bench.py's 2M-item catalog in bfloat16 and float16 instead")
    parser.add_argument("--modes", action="store_true",
                        help="with --scale, also range mode off and on at k' 1 and 10")
    parser.add_argument("--spmm", action="store_true",
                        help="time the CSR product at FairGo's Last.fm-360K shapes instead")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: needs a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import _median_ms, kernel_times_us
    from recbole_fairrec_tpu_torch.ops import fused_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.spmm:
        return _spmm(card, args.out)
    fused_topk.build()
    if args.scale:
        return _scale(card, args.out, args.modes)
    gen = torch.Generator().manual_seed(0)
    d = 64
    tables = {I: torch.randn((I, d), generator=gen).cuda() for I in (3630, 16384)}
    users = {B: torch.randn((B, d), generator=gen).cuda() for B in (1024, 6144)}
    cases = [(B, 3630, k) for B in (1024, 6144) for k in (1, 8, 32, 173, 512, 1024, 2048)]
    cases.append((6144, 16384, 4096))  # the largest k' the kernel takes
    lines = []
    for B, I, k in cases:
        U, T = users[B], tables[I]

        def library():
            s = U @ T.T
            s[:, 0] = float("-inf")
            return torch.topk(s, k, dim=1)

        def kernel():
            return fused_topk.fused_topk_scores(U, T, k)

        row = {
            "B": B, "I": I, "d": d, "k": k,
            "ms": _median_ms(kernel),
            "ms_back_to_back": _median_ms(kernel, calls=10),
            "host_us": _host_us(kernel),
            "plain_ms": _median_ms(lambda: fused_topk.fused_topk_scores_reference(U, T, k), 5),
            "library_ms": _median_ms(library),
            "card": card,
        }
        if args.profile:
            row["kernels_us"] = kernel_times_us(kernel)
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")


def _scale(card, out, modes):
    """chip_smoke's catalog-scale rows (``scale_kernel_row``), one table
    type at a time; with ``modes``, the bfloat16 table's selection and
    range-mode breakdown (``_modes``)."""
    import torch

    import chip_smoke as cs
    from recbole_fairrec_tpu_torch.ops import fused_topk

    rows = []
    for name in cs.SCALE_DTYPES:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(11)
        T = torch.randn((cs.SCALE_ITEMS, cs.SCALE_DIM), generator=gen, device="cuda", dtype=dtype)
        users = {}
        for B in cs.SCALE_BLOCKS:
            U = users[B] = torch.randn((B, cs.SCALE_DIM), generator=gen, device="cuda",
                                       dtype=dtype)
            rows.append(json.dumps(cs.scale_kernel_row(fused_topk, U, T, cs.SCALE_K,
                                                       f"scale {name} B{B}", card)))
        if modes and dtype == torch.bfloat16:
            rows += _modes(fused_topk, users, T, card)
        del T, users
        torch.cuda.empty_cache()
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")


def _modes(fused_topk, users, T, card):
    """Each B at k' 1 and 10 with range mode off (RANGE_MAX_K 0 and
    WGMMA_MAX_D 0: the tensor-core kernel, a list per chunk, the split
    merge) and on the Hopper range kernel (the plan's default): the median
    of one call and the split into the two CUDA kernels. The module's plan
    is put back afterwards."""
    import chip_smoke as cs

    rows = []
    saved = fused_topk.RANGE_MAX_K, fused_topk.WGMMA_MAX_D
    try:
        for B, U in users.items():
            for mode, max_k, max_d in (("chunk", 0, 0), ("wgmma", *saved)):
                for k in (1, cs.SCALE_K):
                    fused_topk.RANGE_MAX_K, fused_topk.WGMMA_MAX_D = max_k, max_d
                    fused_topk._LAUNCH_ARGS.clear()
                    call = lambda: fused_topk.fused_topk_scores(U, T, k)  # noqa: E731
                    args = fused_topk.launch_args(U.device, B, T.shape[0], T.shape[1], k,
                                                  U.dtype, T.dtype)
                    row = {"label": f"modes {mode} B{B} k{k}", "B": B, "k": k, "mode": mode,
                           "path": args[3], "launch_shape": args[1],
                           "ms": cs._median_ms(call, 5),
                           "kernels_us": cs.kernel_times_us(call, calls=3), "card": card}
                    rows.append(json.dumps(row))
                    print(f"kernel: fused_topk {rows[-1]}", flush=True)
    finally:
        fused_topk.RANGE_MAX_K, fused_topk.WGMMA_MAX_D = saved
        fused_topk._LAUNCH_ARGS.clear()
    return rows


def _spmm(card, out):
    """The CSR product's rows (``chip_smoke.graph_rows``), one JSON line each."""
    import chip_smoke
    from recbole_fairrec_tpu_torch.ops import spmm_csr

    t0 = time.perf_counter()
    spmm_csr.build(verbose=True)
    print(f"build: spmm_csr {time.perf_counter() - t0:.2f} s", flush=True)
    lines = [json.dumps(row) for row in chip_smoke.graph_rows(card)[1]]
    print("\n".join(lines), flush=True)
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
