#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
serves full-sort evaluation of BPR-MF (PFCN_PMF, ``filter_mode: none``,
``embedding_size: 64``) at ml-1M scale through the serving entry points
(``load_data_and_model`` then ``Trainer.evaluate``), checks that the path
went through the kernels, and holds every kernel against its plain PyTorch
version at the shapes the serving path gives it. Imports nothing of JAX.

Phases, each of which exits non-zero when it fails:
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
  2. build: every kernel of the path, built in parallel (one nvcc each);
  3. serve: synthetic ml-1M-scale data (numpy, seed 2020) -> Config ->
     create_dataset -> data_preparation -> a checkpoint of seeded random
     weights -> load_data_and_model -> evaluate(valid), evaluate(test) on the
     streaming path, with every launch count set to 0 just before and read
     just after; then the plain-torch dense path must give the same metrics;
  4. kernels: each kernel against its plain version on the inputs the
     serving path gave it, on gaussian inputs of the same shapes (at the
     serving k', at k' 1 and at real ml-1M's k' 2048), at the largest k'
     (4096, over 16,384 items), on a tie-heavy integer input and at d 30,
     with times, the bound and the library yardstick.

The second-to-last line is ``{"kernels": [...]}`` and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "recbole_fairrec_tpu_torch"

# ml-1M scale, as bench.py synthesises it (bench.py:44-71)
N_USERS, N_ITEMS, N_INTER = 6040, 3629, 836478
DATASET = "ml1m-smoke"
TOPK = 10

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12

KERNELS = [
    {
        "name": "fused_topk",
        "route": "cuda",
        "module": "ops.fused_topk",
        "source": f"{PACKAGE}/csrc/fused_topk.cu",
        "replaces": "recbole_fairrec_tpu/ops/pallas/fused_topk.py:134",
    },
]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def write_dataset(root, n_users=N_USERS, n_items=N_ITEMS, n_inter=N_INTER, seed=2020,
                  name=DATASET):
    """bench.py's synthetic recipe, written with numpy alone: unique random
    (user, item) pairs with ratings 1-5, and a binary gender per user."""
    ddir = os.path.join(root, name)
    os.makedirs(ddir, exist_ok=True)
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, n_users * n_items, int(n_inter * 1.35)))
    rng.shuffle(keys)
    if len(keys) < n_inter:
        fail(f"dataset recipe drew {len(keys)} unique pairs, fewer than {n_inter}")
    keys = keys[:n_inter]
    u = keys // n_items + 1
    i = keys % n_items + 1
    r = rng.randint(1, 6, n_inter)
    np.savetxt(
        os.path.join(ddir, f"{name}.inter"), np.stack([u, i, r], axis=1), fmt="%d",
        delimiter="\t", header="user_id:token\titem_id:token\trating:float", comments="",
    )
    users = np.arange(1, n_users + 1)
    np.savetxt(
        os.path.join(ddir, f"{name}.user"), np.stack([users, users % 2], axis=1), fmt="%d",
        delimiter="\t", header="user_id:token\tgender:float", comments="",
    )
    return root


def serving_config(data_root, work_dir, extra=None):
    return {
        "data_path": data_root,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "filter_mode": "none",  # PFCN_PMF is then BPR-MF
        "embedding_size": 64,
        "metrics": ["NDCG", "Recall", "Hit", "MRR"],
        "topk": [TOPK],
        "valid_metric": f"NDCG@{TOPK}",
        "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "RO",
                      "group_by": "user", "mode": "full"},
        "show_progress": False,
        "state": "WARNING",
        "checkpoint_dir": os.path.join(work_dir, "saved"),
        "log_root": os.path.join(work_dir, "log"),
        **(extra or {}),
    }


def seeded_weights(model, generator, std=0.3, quantum=1.0 / 64):
    """Random tables from ``generator``: N(0, std^2) rounded to multiples of
    ``quantum``. Every dot product is then a multiple of quantum^2 below 2^24
    quanta, so it is exact in float32 in any summation order, and two distinct
    scores differ by at least quantum^2. The dense path ranks sigmoid(score);
    at std 0.3 and d = 64 the scores stay within about +-5, where sigmoid keeps
    that gap, so both paths rank the same order (equal scores by item index)."""
    import torch

    with torch.no_grad():
        for emb in (model.user_embedding, model.item_embedding):
            w = torch.randn(emb.weight.shape, generator=generator) * std
            emb.weight.copy_(torch.round(w / quantum) * quantum)


def serve(data_root, work_dir, extra_cfg=None):
    """Phase 3: the serving main path. Returns the launch counts of its run,
    the serving trainer and its test loader."""
    from recbole_fairrec_tpu_torch import Config, load_data_and_model
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    cfg = serving_config(data_root, work_dir, extra_cfg)
    config = Config(model="PFCN_PMF", dataset=DATASET, config_dict=cfg)
    generator = init_seed(config["seed"], config["reproducibility"])
    t0 = time.perf_counter()
    dataset = create_dataset(config)
    train_data, valid_data, test_data = data_preparation(config, dataset)
    print(f"serve: dataset {dataset.user_num - 1} users x {dataset.item_num - 1} items, "
          f"{len(dataset.inter_feat)} interactions, ETL {time.perf_counter() - t0:.3f} s",
          flush=True)
    model = get_model("PFCN_PMF")(config, train_data.dataset, generator=generator)
    seeded_weights(model, generator)
    trainer = get_trainer(config["MODEL_TYPE"], "PFCN_PMF")(config, model)
    ckpt = os.path.join(work_dir, "saved", "PFCN_PMF-smoke.pth")
    trainer._save_checkpoint(0, verbose=False, saved_model_file=ckpt)

    modules = {k["name"]: _kernel_module(k) for k in KERNELS}
    for mod in modules.values():
        mod.launches = 0
    config2, _, trainer2, _, _, valid2, test2 = load_data_and_model(
        ckpt, config_dict={**(extra_cfg or {}), "streaming_eval": True,
                           "log_root": cfg["log_root"]},
    )
    stream = {}
    for name, loader in (("valid", valid2), ("test", test2)):
        t0 = time.perf_counter()
        stream[name] = dict(trainer2.evaluate(loader))
        _sync()
        stream[name + "_s"] = time.perf_counter() - t0
        if trainer2._last_eval_path != _streaming_path_name(trainer2):
            fail(f"evaluate({name}) took the path {trainer2._last_eval_path!r}")
    launches = {name: mod.launches for name, mod in modules.items()}
    for name, n in launches.items():
        if n == 0 and trainer2.device.type == "cuda":
            fail(f"the serving path launched the kernel {name} no time")

    config2["streaming_eval"] = False
    dense = {}
    for name, loader in (("valid", valid2), ("test", test2)):
        t0 = time.perf_counter()
        dense[name] = dict(trainer2.evaluate(loader))
        _sync()
        dense[name + "_s"] = time.perf_counter() - t0
        if trainer2._last_eval_path != "fused":
            fail(f"dense evaluate({name}) took the path {trainer2._last_eval_path!r}")
    for name in ("valid", "test"):
        print(f"serve: {name} streaming {stream[name]} in {stream[name + '_s']:.4f} s",
              flush=True)
        print(f"serve: {name} dense     {dense[name]} in {dense[name + '_s']:.4f} s",
              flush=True)
        if stream[name] != dense[name]:
            fail(f"{name}: streaming and dense metrics differ")
        for metric, value in stream[name].items():
            if not (math.isfinite(value) and 0.0 <= value <= 1.0):
                fail(f"{name}: metric {metric} = {value} is not in [0, 1]")
    print(f"serve: launches on the main path {launches}", flush=True)
    return launches, trainer2, test2


def _streaming_path_name(trainer):
    return "streaming-kernel" if trainer.device.type == "cuda" else "streaming"


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kernel_module(kernel):
    import importlib

    return importlib.import_module(f"{PACKAGE}.{kernel['module']}")


def serving_inputs(trainer, loader):
    """The fused top-k's inputs exactly as the streaming path builds them for
    the first macro-batch of ``loader`` (after an ``evaluate`` of it)."""
    import torch

    from recbole_fairrec_tpu_torch.utils import _bucket

    interaction = next(iter(trainer._macro_batches(loader)))[0]
    n = len(interaction)
    pad_to = max(trainer._full_sort_pad or n, _bucket(n, 512))
    with torch.no_grad():
        U, T = trainer._get_retrieval_fn()(trainer._to_batch(interaction, pad_to=pad_to))
    return U.detach().contiguous(), T.detach().contiguous(), trainer._stream_kprime


def _median_ms(fn, reps=20, calls=1):
    """Median over ``reps`` runs of the device time from before ``calls``
    calls to after them, divided by ``calls``. With one call (the figure
    reported as ``ms``) the card idles while the host prepares the launch,
    as it does once per ``evaluate``, so the wrapper's host work counts.
    With several back-to-back calls the host's work for one call overlaps
    the card's work for the one before, and the figure approaches the
    device time alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _library_topk(U, T, k):
    """One PyTorch call per step computing the same function: the yardstick
    (torch.topk does not promise the tie order; the port never calls this)."""
    import torch

    s = torch.matmul(U, T.T)
    s[:, 0] = float("-inf")
    return torch.topk(s, k, dim=1)


def check_fused_topk(mod, U, T, k, label, card, reps=20):
    """Kernel against its plain version on the same inputs.

    Tolerance: a float32 dot product of length d summed in any order is
    within d * 2^-24 * sum|u_j t_j| of the exact value, so two orders differ
    by at most twice that (``tol``). Scores must agree within rtol 1e-5 plus
    ``tol``; indices must be equal except where the plain version's adjacent
    scores are within max(1e-6 |s|, tol) of each other (a near tie that the
    two summation orders may rank either way). -inf slots must carry index 0
    in both."""
    import torch

    s_k, i_k = mod.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    s_p, i_p = mod.fused_topk_scores_reference(U, T, k)
    B, d = U.shape
    if s_k.shape != (B, k) or i_k.shape != (B, k):
        fail(f"fused_topk[{label}]: output shapes {tuple(s_k.shape)}, {tuple(i_k.shape)}")
    if s_k.dtype != torch.float32 or i_k.dtype != torch.int32:
        fail(f"fused_topk[{label}]: output types {s_k.dtype}, {i_k.dtype}")
    inf_k, inf_p = torch.isneginf(s_k), torch.isneginf(s_p)
    if not torch.equal(inf_k, inf_p):
        fail(f"fused_topk[{label}]: -inf slots differ")
    if bool((i_k[inf_k] != 0).any()):
        fail(f"fused_topk[{label}]: a -inf slot carries an index other than 0")
    if bool((i_k[~inf_k] == 0).any()):
        fail(f"fused_topk[{label}]: the PAD item 0 was selected")
    fin = ~inf_p
    i_safe = i_p.long().clamp_min(0)
    abs_dot = torch.gather(U.abs() @ T.abs().T, 1, i_safe)
    tol = 2 * d * 2.0 ** -24 * abs_dot
    diff = (s_k - s_p).abs()
    diff[~fin] = 0
    err = float(diff.max()) if diff.numel() else 0.0
    if bool((diff > 1e-5 * s_p.abs().where(fin, torch.zeros_like(s_p)) + tol).any()):
        fail(f"fused_topk[{label}]: scores differ by up to {err}")
    near = torch.zeros_like(fin)
    gap = (s_p[:, 1:] - s_p[:, :-1]).abs()
    gap_tol = torch.maximum(1e-6 * s_p[:, 1:].abs(), tol[:, 1:])
    close = (gap <= gap_tol) & fin[:, 1:]
    near[:, 1:] |= close
    near[:, :-1] |= close
    bad = (i_k != i_p) & ~near
    if bool(bad.any()):
        b, j = (int(x) for x in torch.nonzero(bad)[0])
        fail(f"fused_topk[{label}]: index {int(i_k[b, j])} != {int(i_p[b, j])} at "
             f"row {b} slot {j} (scores {float(s_k[b, j])}, {float(s_p[b, j])})")
    n_near = int(((i_k != i_p) & near).sum())

    ms = _median_ms(lambda: mod.fused_topk_scores(U, T, k), reps)
    ms_back_to_back = _median_ms(lambda: mod.fused_topk_scores(U, T, k), reps, calls=10)
    plain_ms = _median_ms(lambda: mod.fused_topk_scores_reference(U, T, k), max(reps // 4, 3))
    library_ms = _median_ms(lambda: _library_topk(U, T, k), reps)
    I = T.shape[0]
    ops_ms = 2.0 * B * I * d / PEAK_F32_FLOPS * 1e3
    bytes_ms = (4.0 * (B * d + I * d) + 8.0 * B * k) / PEAK_BYTES * 1e3
    row = {
        "label": label, "B": B, "I": I, "d": d, "k": k, "max_abs_err": err,
        "near_tie_swaps": n_near, "ms": ms, "ms_back_to_back": ms_back_to_back,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "card": card,
    }
    print(f"kernel: fused_topk {json.dumps(row)}", flush=True)
    return row


def main():
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        fail(f"the package {PACKAGE}/ is not beside this script; run it from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, REPO)

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
    if not card:
        fail(f"nvidia-smi gave no card ({smi.returncode}): {smi.stderr.strip()}")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN", flush=True)

    # phase 2: build every kernel, one nvcc each, all started together
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        futures = {k["name"]: pool.submit(_kernel_module(k).build, True) for k in KERNELS}
        for name, fut in futures.items():
            print(f"build: {name} -> {os.path.relpath(fut.result(), REPO)}", flush=True)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: the serving main path
    work = os.path.join(REPO, PACKAGE, "_build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    data_root = write_dataset(os.path.join(work, "data"))
    print(f"serve: wrote the dataset in {time.perf_counter() - t0:.3f} s", flush=True)
    launches, trainer, test_data = serve(data_root, work)

    # phase 4: every kernel against its plain version
    mod = _kernel_module(KERNELS[0])
    U, T, k_prime = serving_inputs(trainer, test_data)
    gen = torch.Generator().manual_seed(2020)
    rows = [check_fused_topk(mod, U, T, k_prime, "serving", card)]
    Ug = torch.randn(U.shape, generator=gen).cuda()
    Tg = torch.randn(T.shape, generator=gen).cuda()
    rows.append(check_fused_topk(mod, Ug, Tg, k_prime, "gaussian", card))
    rows.append(check_fused_topk(mod, Ug, Tg, 1, "k1", card))
    rows.append(check_fused_topk(mod, Ug, Tg, 2048, "k2048", card, reps=10))
    Tbig = torch.randn((4 * mod.MAX_K, T.shape[1]), generator=gen).cuda()
    rows.append(check_fused_topk(mod, Ug, Tbig, mod.MAX_K, "k4096", card, reps=5))
    Ui = torch.randint(-2, 3, (1024, U.shape[1]), generator=gen).float().cuda()
    Ti = torch.randint(-2, 3, tuple(T.shape), generator=gen).float().cuda()
    rows.append(check_fused_topk(mod, Ui, Ti, k_prime, "ties", card))
    Un = torch.randn((1024, 30), generator=gen).cuda()
    Tn = torch.randn((T.shape[0], 30), generator=gen).cuda()
    rows.append(check_fused_topk(mod, Un, Tn, k_prime, "d30", card))

    main_row = rows[0]
    summary = [{
        "name": k["name"], "route": k["route"], "source": k["source"],
        "replaces": k["replaces"], "launches": launches[k["name"]],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    } for k in KERNELS]
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
