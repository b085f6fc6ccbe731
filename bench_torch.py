#!/usr/bin/env python3
"""Framework benchmarks of the PyTorch/CUDA port on one NVIDIA card, at
ml-1M scale: one JSON line.

    python3 bench_torch.py [--repeats N]

The port's counterpart of ``bench.py``: its legs, in its order, through the
port's real entry points (Config -> create_dataset -> data_preparation ->
get_model / get_trainer -> ``Trainer._train_step`` / ``_train_epoch`` /
``evaluate``) on bench.py's synthetic ml-1M-scale data (6,040 users, 3,629
items, 836,478 ratings, numpy seed 2020). The last line of standard output
is one JSON object with every key that bench.py prints, under bench.py's
names and meanings, so the two outputs read side by side, and one key more:
``device`` (the card's name, its power limit in watts as nvidia-smi gives
it, and the number of cards). Stage messages go to standard error.

Every clock stops after ``torch.cuda.synchronize()``. Where bench.py takes
several samples the port reports their min (the figure under bench.py's
name), p50 and max. ``--repeats N`` caps every leg's sample count at N;
widths, sizes and step counts stay as they are. Without a CUDA card the
script exits non-zero: it does not run on the CPU. A leg that fails ends the
run with a non-zero exit.

Legs (bench.py's line in brackets):
  * train step (``bench_train_step`` :213): 408 steps of
    ``Trainer._train_step`` on 64 batches of 2,048 from RandomState(0) that
    carry their negatives (the trainer must not draw others);
  * train epoch (:131) and resident epoch (:146): ``_train_epoch`` of
    BPR-MF (PFCN_PMF ``filter_mode: none``, d 64, batch 2048, negatives drawn
    on the card), per step and with ``device_epoch_shuffle``; each timed
    epoch must have taken the path it is reported under;
  * full-sort evaluation (:175): ``evaluate`` of the validation split on the
    dense path and on the streaming path, which must launch the kernel
    (``ops/fused_topk.py``) while the dense path must not; bench.py's
    agreement rule between their dicts;
  * uni100 evaluation (:245) through ``NegSampleEvalDataLoader`` and the
    sampled device path;
  * the adversarial ``cm`` epoch over gender (:306), per step and resident;
  * the FairGo_PMF finetune epoch (:371), float32 and bfloat16 propagation;
  * roofline (:440): a bfloat16 product probe and a memory probe on the
    card, against the H100's published peaks, and each path's modeled
    demand (``modeled_demands``, bench.py's formulas) over its wall time;
  * catalog scale (:589): a 2,097,152 x 128 bfloat16 table made on the card
    from a seed; the kernel at B 128, ``approx_topk_scores`` at B 128 and
    B 1024 (an exact selection: its recall must be 1.0), and the train step
    at 1,048,576 users x 2,097,152 items x 128, batch 65,536;
  * the kernel against ``topk`` of the exact float32 product (:550) at
    B 1024 x I 65,536 x d 64, k 10, by chip_smoke.py's near-tie rule.

Before the last line come ``card: <nvidia-smi line>``, ``launches: {...}``
(the kernel's launches in this run) and ``pallas_topk: {...}`` (its
max_abs_err and near-tie swaps against the library call).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

import chip_smoke

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "recbole_fairrec_tpu_torch"
N_USERS, N_ITEMS, N_INTER = 6040, 3629, 836478
EMB = 64
# upstream RecBole's BPRMF on a TITAN V: 0.89 s a training epoch, 0.71 s a
# full-sort evaluation (bench.py:38-39)
TRAIN_BASELINE_EX_S = 836478 / 0.89
EVAL_BASELINE_ITEMS_S = 6040 * 3629 / 0.71
DATA_DIR = os.path.join(REPO, PACKAGE, "_build", "bench_data")
DS = "ml1m-bench"
# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
PEAKS = {"flops_bf16": 989e12, "flops_f32": 67e12, "hbm_gbps": 3350.0}

# bench.py's output keys, in its order (bench.py:796-829 and its legs' dicts)
KEYS = (
    "metric", "value", "unit", "vs_baseline", "backend", "train_epoch_s",
    "train_step_examples_per_s", "fullsort_eval_items_per_s",
    "fullsort_eval_items_per_s_vs_baseline", "fullsort_eval_s",
    "fullsort_eval_items_per_s_streaming", "fullsort_eval_s_streaming", "eval_variants_agree",
    "uni100_eval_users_per_s", "uni100_eval_s", "adv_train_epoch_examples_per_s",
    "adv_train_epoch_s", "adv_train_epoch_resident_s", "adv_train_epoch_resident_examples_per_s",
    "fairgo_finetune_epoch_examples_per_s", "fairgo_finetune_epoch_s",
    "fairgo_finetune_epoch_s_bf16prop", "train_epoch_s_p50", "train_epoch_s_max",
    "train_epoch_timing_n", "train_epoch_resident_s", "train_epoch_resident_s_p50",
    "train_epoch_resident_s_max", "train_epoch_resident_examples_per_s",
    "train_epoch_resident_vs_baseline", "fullsort_eval_s_p50", "fullsort_eval_s_max",
    "uni100_eval_s_p50", "uni100_eval_s_max", "uni100_timing_n", "chip",
    "mxu_probe_tflops_bf16", "hbm_probe_gbps", "mxu_probe_pct_of_nominal",
    "hbm_probe_pct_of_nominal",
    *(f"roofline_{path}_{metric}" for path in ("train_epoch", "fullsort_eval", "uni100_eval")
      for metric in ("achieved_tflops", "achieved_hbm_gbps", "pct_of_measured_hbm")),
    "roofline_binding_side", "scale_catalog_items", "scale_dim", "scale_block_users",
    "scale_fullsort_exact_items_per_s", "scale_fullsort_exact_ms_per_block",
    "scale_fullsort_exact_pct_of_measured_hbm", "scale_fullsort_exact_pct_of_measured_mxu",
    "scale_fullsort_approx_items_per_s", "scale_fullsort_approx_ms_per_block",
    "scale_fullsort_approx_pct_of_measured_hbm", "scale_fullsort_approx_recall_vs_exact",
    "scale_fullsort_approx_b1024_items_per_s", "scale_fullsort_approx_b1024_ms",
    "scale_fullsort_approx_b1024_pct_of_measured_mxu", "scale_fullsort_binder",
    "scale_train_step_examples_per_s", "scale_train_step_ms",
    "scale_train_step_pct_of_measured_hbm", "scale_train_tables_rows", "pallas_topk_exact",
    "pallas_topk_ms", "dense_topk_ms",
)


class Size(NamedTuple):
    """The ml-1M legs' data: users, items, interactions, train batch."""
    users: int = N_USERS
    items: int = N_ITEMS
    inter: int = N_INTER
    batch: int = 2048


class ScaleSize(NamedTuple):
    """The catalog-scale leg (bench_scale): table rows and width, the two
    retrieval blocks, the train step's users, batch and timed steps."""
    items: int = 2 * 1024 * 1024
    dim: int = 128
    block: int = 128
    block2: int = 1024
    users: int = 1024 * 1024
    batch: int = 65536
    steps: int = 10


# the probes of bench_roofline: an N x N bf16 product chained K times, and K
# passes over M float32 elements (256 MB)
PROBE = (4096, 64, 64 * 1024 * 1024)
# bench_pallas_topk: B, I, d, k
PALLAS = (1024, 65536, EMB, 10)

def _stage(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _cap(n, repeats):
    return n if repeats is None else max(1, min(n, repeats))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device):
    """Wall seconds of ``fn()`` from a synchronised card to a synchronised
    card."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def timed_stats(fn, n):
    """(min, p50, max, n) of ``n`` calls of ``fn`` (each returns seconds)."""
    times = sorted(fn() for _ in range(n))
    return times[0], times[len(times) // 2], times[-1], n


@contextlib.contextmanager
def _recording(obj, name):
    """The results of the calls of ``obj``'s method ``name`` inside the
    block, in their order."""
    results = []
    method = getattr(obj, name)

    def recorded(*args, **kwargs):
        results.append(method(*args, **kwargs))
        return results[-1]

    setattr(obj, name, recorded)
    try:
        yield results
    finally:
        delattr(obj, name)


# ------------------------------------------------------------------- data

def ensure_dataset(data_dir=DATA_DIR, size=Size()):
    """bench.py's synthetic dataset (bench.py:44-71) in ``data_dir``, written
    once (chip_smoke's ``write_dataset``, the same recipe with numpy: unique
    (user, item) pairs from RandomState(2020) oversampled 1.35 times,
    shuffled and cut to ``size.inter``, ratings 1-5, ``gender = user %
    2``)."""
    marker = os.path.join(data_dir, DS, ".complete")
    if not os.path.exists(marker):
        chip_smoke.write_dataset(data_dir, size.users, size.items, size.inter, name=DS)
        with open(marker, "w") as f:
            f.write("ok")
    return data_dir


def _config(model, data_dir, device, size, extra):
    from recbole_fairrec_tpu_torch import Config

    return Config(model=model, dataset=DS, config_dict={
        "data_path": ensure_dataset(data_dir, size),
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "embedding_size": EMB,
        "topk": [10],
        "valid_metric": "NDCG@10",
        "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "RO", "group_by": "user",
                      "mode": "full"},
        "show_progress": False,
        "save_dataset": True,
        "checkpoint_dir": os.path.join(data_dir, "saved"),
        "use_gpu": device.type == "cuda",
        **extra,
    })


def _pipeline(config, trainer_cls=None):
    """init_seed -> create_dataset -> data_preparation -> the model -> its
    trainer (``trainer_cls``, else the registry's)."""
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    generator = init_seed(config["seed"], config["reproducibility"])
    dataset = create_dataset(config)
    train_data, valid_data, _ = data_preparation(config, dataset)
    model = get_model(config["model"])(config, train_data.dataset, generator=generator)
    cls = trainer_cls or get_trainer(config["MODEL_TYPE"], config["model"])
    return cls(config, model), train_data, valid_data


def build(device, data_dir=DATA_DIR, size=Size()):
    """bench.py's ``_build``: BPR-MF (PFCN_PMF ``filter_mode: none``) under
    the base ``Trainer``, negatives drawn on the card, full-sort RS 8/1/1
    by user, NDCG/Recall/Hit/MRR@10. Returns (trainer, train, valid)."""
    from recbole_fairrec_tpu_torch.trainer import Trainer

    config = _config("PFCN_PMF", data_dir, device, size, {
        "filter_mode": "none",
        "train_batch_size": size.batch,
        "neg_sampling": {"uniform": 1},
        "device_neg_sampling": True,
        "metrics": ["NDCG", "Recall", "Hit", "MRR"],
        "save_dataloaders": True,
    })
    # the base Trainer: with filter_mode none the model is BPR-MF
    return _pipeline(config, Trainer)


# ------------------------------------------------------------------- legs

def bench_train_step(trainer, train_data, device, size=Size()):
    """Examples/s of ``Trainer._train_step`` alone: ``size.inter // batch``
    steps over 64 batches made from RandomState(0) before the clock, each
    with its negatives and ratings (bench.py:213-242)."""
    import torch

    rng = np.random.RandomState(0)
    batches = [{
        "user_id": torch.from_numpy(rng.randint(1, size.users, size.batch)).to(device),
        "item_id": torch.from_numpy(rng.randint(1, size.items, size.batch)).to(device),
        "neg_item_id": torch.from_numpy(rng.randint(1, size.items, size.batch)).to(device),
        "rating": torch.from_numpy(rng.randint(1, 6, size.batch).astype(np.float32)).to(device),
    } for _ in range(64)]
    # device sampling on, as in an epoch: the batches' own negatives must stay
    trainer._maybe_enable_device_sampling(train_data)
    neg = trainer.model.NEG_ITEM_ID
    trainer.model.train()
    with _recording(trainer, "_inject_negatives") as injected:
        trainer._train_step(dict(batches[0]), "calculate_loss", None, trainer.optimizer)
    if len(injected) != 1 or injected[0][neg] is not batches[0][neg]:
        raise RuntimeError("train step: _inject_negatives replaced the batch's own negatives")
    n_steps = size.inter // size.batch

    def steps():
        for s in range(n_steps):
            trainer._train_step(dict(batches[s % 64]), "calculate_loss", None, trainer.optimizer)

    dt = _seconds(steps, device)
    return {"train_step_examples_per_s": n_steps * size.batch / dt}


def bench_train_epoch(trainer, train_data, device, repeats=None):
    """``_train_epoch`` per step: one epoch to warm up, then the min, p50 and
    max of 8 (bench.py:131-143)."""
    n_examples = len(train_data.dataset.inter_feat)
    with _recording(trainer, "_run_epoch_resident") as resident:
        trainer._train_epoch(train_data, 0)
        dt, p50, mx, n = timed_stats(
            lambda: _seconds(lambda: trainer._train_epoch(train_data, 1), device),
            _cap(8, repeats))
    if resident:
        raise RuntimeError("train epoch: an epoch took the resident path")
    return {"value": n_examples / dt, "vs_baseline": n_examples / dt / TRAIN_BASELINE_EX_S,
            "train_epoch_s": dt, "train_epoch_s_p50": p50, "train_epoch_s_max": mx,
            "train_epoch_timing_n": n}


def bench_resident_epoch(trainer, train_data, device, repeats=None):
    """``_train_epoch`` with ``device_epoch_shuffle`` (the train table on the
    card, shuffle and negatives drawn there); every epoch must take the
    resident path (bench.py:146-172)."""
    n_examples = len(train_data.dataset.inter_feat)
    trainer.config["device_epoch_shuffle"] = True
    try:
        with _recording(trainer, "_run_epoch_resident") as resident:
            trainer._train_epoch(train_data, 0)
            dt, p50, mx, n = timed_stats(
                lambda: _seconds(lambda: trainer._train_epoch(train_data, 1), device),
                _cap(8, repeats))
    finally:
        trainer.config["device_epoch_shuffle"] = False
    if len(resident) != 1 + n:
        raise RuntimeError(f"resident epoch: {len(resident)} of {1 + n} epochs were resident")
    return {"train_epoch_resident_s": dt, "train_epoch_resident_s_p50": p50,
            "train_epoch_resident_s_max": mx,
            "train_epoch_resident_examples_per_s": n_examples / dt,
            "train_epoch_resident_vs_baseline": n_examples / dt / TRAIN_BASELINE_EX_S}


def variants_agree(dense, stream):
    """bench.py's rule (bench.py:202-207): the same keys, Recall and Hit
    equal, every other metric within 2e-3."""
    return set(dense) == set(stream) and all(
        dense[k] == stream[k] if k.startswith(("recall", "hit"))
        else abs(dense[k] - stream[k]) < 2e-3
        for k in dense)


def bench_eval(trainer, valid_data, device, repeats=None, launches=None):
    """Items/s of ``evaluate`` over the validation split, dense then
    streaming: a warm-up, then the min of 4 (bench.py:175-210). The kernel's
    launch count is set to 0 before each variant and read after: the
    streaming variant must launch it on the card and the dense one never.
    The launches are added to ``launches["fused_topk"]``."""
    from recbole_fairrec_tpu_torch.ops import fused_topk

    items_total = valid_data.pr_end * valid_data.dataset.item_num
    want_path = {False: "fused", True: "streaming-kernel" if device.type == "cuda"
                 else "streaming"}

    def variant(streaming):
        trainer.config["streaming_eval"] = streaming
        fused_topk.launches = 0
        trainer.evaluate(valid_data, load_best_model=False)
        result = None

        def once():
            nonlocal result
            result = trainer.evaluate(valid_data, load_best_model=False)

        dt, p50, mx, _ = timed_stats(lambda: _seconds(once, device), _cap(4, repeats))
        launched = fused_topk.launches
        if trainer._last_eval_path != want_path[streaming]:
            raise RuntimeError(f"eval: the {'streaming' if streaming else 'dense'} variant took "
                               f"the {trainer._last_eval_path} path")
        if streaming and device.type == "cuda" and launched == 0:
            raise RuntimeError("eval: the streaming variant launched no kernel")
        if not streaming and launched:
            raise RuntimeError(f"eval: the dense variant launched the kernel {launched} times")
        return dict(result), dt, p50, mx, launched

    try:
        dense, dense_dt, dense_p50, dense_max, _ = variant(False)
        stream, stream_dt, _, _, launched = variant(True)
    finally:
        trainer.config["streaming_eval"] = False
    if launches is not None:
        launches["fused_topk"] += launched
    return {
        "fullsort_eval_items_per_s": items_total / dense_dt,
        "fullsort_eval_items_per_s_vs_baseline": items_total / dense_dt / EVAL_BASELINE_ITEMS_S,
        "fullsort_eval_s": dense_dt,
        "fullsort_eval_items_per_s_streaming": items_total / stream_dt,
        "fullsort_eval_s_streaming": stream_dt,
        "eval_variants_agree": variants_agree(dense, stream),
        "fullsort_eval_s_p50": dense_p50, "fullsort_eval_s_max": dense_max,
    }


def bench_uni100_eval(device, data_dir=DATA_DIR, size=Size(), repeats=None):
    """Users/s of ``evaluate`` under ``mode: uni100`` (100 uniform
    negatives a user) through ``NegSampleEvalDataLoader`` and the sampled
    device path: a warm-up, then the min of 6 (bench.py:245-303)."""
    from recbole_fairrec_tpu_torch.data import NegSampleEvalDataLoader
    from recbole_fairrec_tpu_torch.trainer import Trainer

    config = _config("PFCN_PMF", data_dir, device, size, {
        "filter_mode": "none",
        "metrics": ["NDCG", "Recall", "Hit", "MRR"],
        "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "RO", "group_by": "user",
                      "mode": "uni100"},
    })
    trainer, _, valid_data = _pipeline(config, Trainer)
    if not isinstance(valid_data, NegSampleEvalDataLoader):
        raise RuntimeError(f"uni100: the loader is a {type(valid_data).__name__}")
    n_users = valid_data.pr_end
    trainer.evaluate(valid_data, load_best_model=False)
    dt, p50, mx, n = timed_stats(
        lambda: _seconds(lambda: trainer.evaluate(valid_data, load_best_model=False), device),
        _cap(6, repeats))
    if trainer._last_eval_path != "sampled-fused":
        raise RuntimeError(f"uni100: evaluate took the {trainer._last_eval_path} path")
    return {"uni100_eval_users_per_s": n_users / dt, "uni100_eval_s": dt,
            "uni100_eval_s_p50": p50, "uni100_eval_s_max": mx, "uni100_timing_n": n}


def _schedule_epoch(trainer, train_data, device):
    """Seconds of one epoch under ``train_epoch_interval`` 5: the mean of
    epochs 0-4 (a filter + discriminator epoch, then 4 discriminator-only;
    bench.py:348-355)."""
    def five():
        for e in range(5):
            trainer._train_epoch(train_data, e)

    return _seconds(five, device) / 5


def bench_adversarial_epoch(device, data_dir=DATA_DIR, size=Size(), repeats=None):
    """PFCN_PMF ``filter_mode: cm`` over gender through ``get_trainer``: two
    warm-up epochs, the best of 3 schedule-true 5-epoch means, then the
    same with ``device_epoch_shuffle`` (bench.py:306-368)."""
    config = _config("PFCN_PMF", data_dir, device, size, {
        "filter_mode": "cm", "sst_attr_list": ["gender"], "train_batch_size": size.batch,
        "neg_sampling": {"uniform": 1}, "device_neg_sampling": True, "metrics": ["NDCG"],
    })
    trainer, train_data, _ = _pipeline(config)
    n_examples = len(train_data.dataset.inter_feat)
    with _recording(trainer, "_run_epoch_resident") as resident:
        trainer._train_epoch(train_data, 0)
        trainer._train_epoch(train_data, 1)
        dt = timed_stats(lambda: _schedule_epoch(trainer, train_data, device),
                         _cap(3, repeats))[0]
    if resident:
        raise RuntimeError("adversarial: a per-step pass took the resident path")
    trainer.config["device_epoch_shuffle"] = True
    try:
        with _recording(trainer, "_run_epoch") as passes, \
                _recording(trainer, "_run_epoch_resident") as resident:
            trainer._train_epoch(train_data, 0)
            trainer._train_epoch(train_data, 1)
            res_dt = timed_stats(lambda: _schedule_epoch(trainer, train_data, device),
                                 _cap(3, repeats))[0]
    finally:
        trainer.config["device_epoch_shuffle"] = False
    if len(resident) != len(passes):
        raise RuntimeError(f"adversarial: {len(resident)} of {len(passes)} passes were resident")
    return {"adv_train_epoch_examples_per_s": n_examples / dt, "adv_train_epoch_s": dt,
            "adv_train_epoch_resident_s": res_dt,
            "adv_train_epoch_resident_examples_per_s": n_examples / res_dt}


def bench_fairgo_finetune_epoch(device, propagation_dtype="float32", data_dir=DATA_DIR,
                                size=Size(), repeats=None):
    """FairGo_PMF (LBA, 2 hops) in the finetune stage, entered directly by
    setting ``train_stage`` (the port caches nothing across it): two warm-up
    epochs, then the best of 3 schedule-true 5-epoch means (bench.py:371-429).
    Returns (examples/s, seconds)."""
    config = _config("FairGo_PMF", data_dir, device, size, {
        "sst_attr_list": ["gender"], "n_layers": 2, "aggr_method": "LBA",
        "propagation_dtype": propagation_dtype, "train_batch_size": size.batch,
        "metrics": ["NDCG"],
    })
    trainer, train_data, _ = _pipeline(config)
    trainer.model.train_stage = "finetune"
    n_examples = len(train_data.dataset.inter_feat)
    trainer._train_epoch(train_data, 0)
    trainer._train_epoch(train_data, 1)
    dt = timed_stats(lambda: _schedule_epoch(trainer, train_data, device), _cap(3, repeats))[0]
    if trainer.model.train_stage != "finetune":
        raise RuntimeError(f"fairgo: the model left the finetune stage: "
                           f"{trainer.model.train_stage}")
    return n_examples / dt, dt


def modeled_demands(size=Size(), d=EMB, scale=ScaleSize()):
    """bench.py's modeled work, unchanged (bench.py:500-516, 657-664,
    710-712; its batch of 2,048 is ``size.batch``): flops and bytes of a
    train epoch (dense Adam over both tables, batch gathers), a full-sort
    evaluation ([U, I] scores written and read) and a uni100 evaluation; at
    catalog scale the bf16 table streamed once (exact and approx), the
    B-blocks' products and the train step's bytes."""
    valid_users = size.users  # RS 8/1/1 grouped by user keeps every user
    steps = size.inter // size.batch
    p_bytes = (size.users + size.items + 2) * d * 4
    I, D, B, B2 = scale.items, scale.dim, scale.block, scale.block2
    uni_rows = int(size.inter * 0.1) * 101
    table_bytes = I * D * 2
    p_rows = (scale.users + 2) * D + (I + 2) * D
    return {
        "train_bytes": steps * (6 * p_bytes + size.batch * 3 * d * 4 * 2),
        "train_flops": steps * size.batch * (2 * 2 * d),
        "eval_flops": 2 * valid_users * size.items * d,
        "eval_bytes": valid_users * size.items * 4 * 2,
        "uni_flops": uni_rows * 2 * d,
        "uni_bytes": uni_rows * (2 * d * 4) + valid_users * size.items * 4 * 2,
        "table_bytes": table_bytes,
        "flops": 2 * B * I * D,
        "approx_bytes": table_bytes,
        "b1024_flops": 2 * B2 * I * D,
        "step_bytes": 6 * p_rows * 4 + scale.batch * 3 * D * 4 * 2,
    }


def binding_side(demands, walls):
    """Which side binds each ml-1M path on this card: its modeled work at the
    published peaks (float32 operations, the paths' type, or bytes,
    whichever takes longer) as a share of its wall time. Under half the wall
    on every path, the rest is the host's."""
    parts, worst = [], 0.0
    for name, (flops, byts), wall in walls:
        ops_s = flops / PEAKS["flops_f32"]
        bytes_s = byts / (PEAKS["hbm_gbps"] * 1e9)
        share = max(ops_s, bytes_s) / wall
        worst = max(worst, share)
        side = "bytes" if bytes_s >= ops_s else "f32 operations"
        parts.append(f"{name} {100 * share:.3g}% ({side})")
    side = "host" if worst < 0.5 else "device"
    return (f"{side}: the modeled device work at the card's peaks is " + ", ".join(parts)
            + " of the wall time")


def bench_roofline(device, epoch_s, fullsort_s, uni100_s, size=Size(), probe=PROBE):
    """Two probes on the card (bench.py:440-547): K chained N x N bfloat16
    products (TFLOP/s) and K passes over M float32 elements, each read and
    written once (GB/s); against the H100's published peaks. Then each
    path's modeled demand over its wall time."""
    import torch

    N, K, M = probe
    a = torch.ones((N, N), dtype=torch.bfloat16, device=device)
    b = torch.ones((N, N), dtype=torch.bfloat16, device=device)

    def mxu_chain():
        x = a
        for _ in range(K):
            x = x @ b
        return x

    mxu_chain()
    mxu_tflops = 2 * N * N * N * K / _seconds(mxu_chain, device) / 1e12
    del a, b
    v = torch.ones(M, dtype=torch.float32, device=device)

    def hbm_chain():
        for _ in range(K):
            v.add_(1.0)

    hbm_chain()
    hbm_gbps = 2 * 4 * M * K / _seconds(hbm_chain, device) / 1e9
    del v
    dem = modeled_demands(size)
    walls = [("train_epoch", (dem["train_flops"], dem["train_bytes"]), epoch_s),
             ("fullsort_eval", (dem["eval_flops"], dem["eval_bytes"]), fullsort_s),
             ("uni100_eval", (dem["uni_flops"], dem["uni_bytes"]), uni100_s)]
    out = {
        "chip": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "mxu_probe_tflops_bf16": mxu_tflops,
        "hbm_probe_gbps": hbm_gbps,
        "mxu_probe_pct_of_nominal": 100 * mxu_tflops * 1e12 / PEAKS["flops_bf16"],
        "hbm_probe_pct_of_nominal": 100 * hbm_gbps / PEAKS["hbm_gbps"],
    }
    for name, (flops, byts), wall in walls:
        out[f"roofline_{name}_achieved_tflops"] = flops / wall / 1e12
        out[f"roofline_{name}_achieved_hbm_gbps"] = byts / wall / 1e9
        out[f"roofline_{name}_pct_of_measured_hbm"] = 100 * (byts / wall / 1e9) / hbm_gbps
    out["roofline_binding_side"] = binding_side(dem, walls)
    return out


def _scale_step(device, work_dir, scale):
    """Seconds a step of ``Trainer._train_step`` (PFCN_PMF as pure BPR-MF,
    dense Adam over both tables; chip_smoke's ``scale_trainer``) on 4
    batches from RandomState(3) (``scale_batches``): one to warm up, then
    ``scale.steps`` (bench.py:666-712)."""
    import torch

    trainer = chip_smoke.scale_trainer(work_dir, scale.users, scale.items, scale.dim,
                                       {"use_gpu": device.type == "cuda"})
    batches = [{key: torch.from_numpy(v).long().to(device) for key, v in b.items()}
               for b in chip_smoke.scale_batches(scale.users, scale.items, scale.batch)]
    trainer.model.train()
    trainer._train_step(dict(batches[0]), "calculate_loss", None, trainer.optimizer)

    def steps():
        for s in range(scale.steps):
            trainer._train_step(dict(batches[s % 4]), "calculate_loss", None, trainer.optimizer)

    return _seconds(steps, device) / scale.steps


def bench_scale(device, hbm_gbps, mxu_tflops, scale=ScaleSize(), data_dir=DATA_DIR,
                repeats=None, launches=None):
    """bench_scale (bench.py:589-752) on the card: a ``scale.items`` x
    ``scale.dim`` bfloat16 table and bfloat16 users made there from a seed;
    the kernel (``fused_topk_scores``) at B ``block``, ``approx_topk_scores``
    at B ``block`` and ``block2`` (the port's selection is exact: its recall
    against the kernel must be 1.0), then the scale train step. Rates are
    against the probes of ``bench_roofline`` (``hbm_gbps``, ``mxu_tflops``);
    the kernel's launches are added to ``launches["fused_topk"]``."""
    import torch

    from recbole_fairrec_tpu_torch.ops import fused_topk
    from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores

    I, D, B, B2 = scale.items, scale.dim, scale.block, scale.block2
    gen = torch.Generator(device=device).manual_seed(11)
    items = torch.randn((I, D), generator=gen, device=device, dtype=torch.bfloat16)
    users = torch.randn((B, D), generator=gen, device=device, dtype=torch.bfloat16)
    users2 = torch.randn((B2, D), generator=gen, device=device, dtype=torch.bfloat16)

    def best(fn, n):
        fn()
        return min(_seconds(fn, device) for _ in range(n))

    before = fused_topk.launches
    t_exact = best(lambda: fused_topk.fused_topk_scores(users, items, 10), _cap(6, repeats))
    t_approx = best(lambda: approx_topk_scores(users, items, 10, recall_target=0.95),
                    _cap(6, repeats))
    t_approx_b = best(lambda: approx_topk_scores(users2, items, 10, recall_target=0.95),
                      _cap(4, repeats))
    _, ei = fused_topk.fused_topk_scores(users, items, 10)
    _, ai = approx_topk_scores(users, items, 10, recall_target=0.95)
    ei, ai = ei.cpu().numpy(), ai.cpu().numpy()
    recall = float(np.mean([len(set(ei[r]) & set(ai[r])) / 10 for r in range(B)]))
    if recall != 1.0:
        raise RuntimeError(f"scale: approx_topk_scores recalled {recall} of the exact top 10")
    # the split of a call into its two CUDA kernels (µs), from the profiler:
    # this process's first profiler session (late in a long process it has
    # shown no fused_topk kernel)
    split = chip_smoke.kernel_times_us(
        lambda: fused_topk.fused_topk_scores(users, items, 10), calls=5) \
        if device.type == "cuda" else None
    if split is not None and not split["score_select"]:
        raise RuntimeError("scale: the profiler saw no score kernel of a fused_topk call")
    if launches is not None:
        launches["fused_topk"] += fused_topk.launches - before
    del items, users, users2
    dem = modeled_demands(scale=scale)
    exact_hbm_pct = 100 * (dem["table_bytes"] / t_exact / 1e9) / hbm_gbps
    if split is None:
        binder = "not measured: no card (the kernel's plain version ran)"
    else:
        share = split["score_select"] / (split["score_select"] + split["merge"])
        binder = (f"the score + select kernel: {100 * share:.1f}% of a B {B} call's device time "
                  f"({split['score_select'] / 1e3:.4f} ms; the merge {split['merge'] / 1e3:.4f} "
                  f"ms); the call reads its table at {exact_hbm_pct:.1f}% of the measured HBM "
                  "rate")
    t_step = _scale_step(device, os.path.join(data_dir, "scale"), scale)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "scale_catalog_items": I,
        "scale_dim": D,
        "scale_block_users": B,
        "scale_fullsort_exact_items_per_s": B * I / t_exact,
        "scale_fullsort_exact_ms_per_block": t_exact * 1e3,
        "scale_fullsort_exact_pct_of_measured_hbm": exact_hbm_pct,
        "scale_fullsort_exact_pct_of_measured_mxu":
            100 * (dem["flops"] / t_exact / 1e12) / mxu_tflops,
        "scale_fullsort_approx_items_per_s": B * I / t_approx,
        "scale_fullsort_approx_ms_per_block": t_approx * 1e3,
        "scale_fullsort_approx_pct_of_measured_hbm":
            100 * (dem["approx_bytes"] / t_approx / 1e9) / hbm_gbps,
        "scale_fullsort_approx_recall_vs_exact": recall,
        "scale_fullsort_approx_b1024_items_per_s": B2 * I / t_approx_b,
        "scale_fullsort_approx_b1024_ms": t_approx_b * 1e3,
        "scale_fullsort_approx_b1024_pct_of_measured_mxu":
            100 * (dem["b1024_flops"] / t_approx_b / 1e12) / mxu_tflops,
        "scale_fullsort_binder": binder,
        "scale_train_step_examples_per_s": scale.batch / t_step,
        "scale_train_step_ms": t_step * 1e3,
        "scale_train_step_pct_of_measured_hbm":
            100 * (dem["step_bytes"] / t_step / 1e9) / hbm_gbps,
        "scale_train_tables_rows": scale.users + I,
    }


def bench_pallas_topk(device, shape=PALLAS, repeats=None, launches=None):
    """The kernel against ``topk`` of the exact float32 product with column
    0 at -inf (bench.py:550-586; TF32 off): exact by chip_smoke.py's
    near-tie rule (``topk_disagreement``: scores within the summation-order
    bound, indices equal but where the library's adjacent scores are a near
    tie), and the mean ms of 20 calls of each, back to back. Returns (exact,
    kernel ms, library ms, max_abs_err, near-tie swaps); the kernel's
    launches are added to ``launches["fused_topk"]``."""
    import torch

    from recbole_fairrec_tpu_torch.ops import fused_topk

    B, I, d, k = shape
    gen = torch.Generator(device=device).manual_seed(7)
    user = torch.randn((B, d), generator=gen, device=device)
    items = torch.randn((I, d), generator=gen, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def dense(kk=k):
            s = user @ items.T
            s[:, 0] = float("-inf")
            return torch.topk(s, kk, dim=1)

        before = fused_topk.launches
        fs, fi = fused_topk.fused_topk_scores(user, items, k)
        s_all, i_all = dense(k + 1)
        problem, err, near = chip_smoke.topk_disagreement(
            user, items, k, fs, fi, s_all[:, :k].contiguous(), i_all[:, :k].int().contiguous(),
            s_next=s_all[:, k].contiguous())
        del s_all, i_all

        def timeit(fn, n):
            fn()
            return _seconds(lambda: [fn() for _ in range(n)], device) / n * 1e3

        n = _cap(20, repeats)
        fused_ms = timeit(lambda: fused_topk.fused_topk_scores(user, items, k), n)
        dense_ms = timeit(dense, n)
        if launches is not None:
            launches["fused_topk"] += fused_topk.launches - before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if problem:
        _stage(f"pallas top-k: the kernel disagrees with the library call: {problem}")
    return problem is None, fused_ms, dense_ms, err, near


# ------------------------------------------------------------------- main

def device_info():
    """(the ``device`` key, nvidia-smi's line) for card 0."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
    if not line:
        raise RuntimeError(f"nvidia-smi gave no card ({smi.returncode}): {smi.stderr.strip()}")
    watts = float(line.rsplit(",", 1)[1].split()[0])
    return {"name": torch.cuda.get_device_name(0), "power_limit_w": watts,
            "count": torch.cuda.device_count()}, line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=None,
                        help="cap every leg's sample count at N (sizes stay)")
    args = parser.parse_args(argv)
    if args.repeats is not None and args.repeats < 1:
        parser.error("--repeats must be at least 1")
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is false); this benchmark "
              "runs only on the card", file=sys.stderr, flush=True)
        sys.exit(1)
    from recbole_fairrec_tpu_torch.ops import fused_topk

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = device_info()
    _stage(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    so = fused_topk.build()
    _stage(f"kernel library {os.path.relpath(so, REPO)} in {time.perf_counter() - t0:.2f} s")
    repeats = args.repeats
    launches = {"fused_topk": 0}  # the kernel's launches in this run
    _stage("building pipeline (dataset ETL + loaders)")
    trainer, train_data, valid_data = build(device)
    res = {}
    _stage("raw train-step throughput")
    res.update(bench_train_step(trainer, train_data, device))
    _stage("e2e train epochs")
    res.update(bench_train_epoch(trainer, train_data, device, repeats))
    _stage("epoch-resident train epochs")
    res.update(bench_resident_epoch(trainer, train_data, device, repeats))
    _stage("full-sort eval variants")
    res.update(bench_eval(trainer, valid_data, device, repeats, launches))
    del trainer, train_data, valid_data
    _stage("uni100 sampled eval")
    res.update(bench_uni100_eval(device, repeats=repeats))
    _stage("adversarial (cm) train epoch")
    res.update(bench_adversarial_epoch(device, repeats=repeats))
    _stage("fairgo finetune epoch (sparse propagation)")
    ex_s, res["fairgo_finetune_epoch_s"] = bench_fairgo_finetune_epoch(device, repeats=repeats)
    res["fairgo_finetune_epoch_examples_per_s"] = ex_s
    _stage("fairgo finetune epoch (bf16 propagation)")
    res["fairgo_finetune_epoch_s_bf16prop"] = bench_fairgo_finetune_epoch(
        device, "bfloat16", repeats=repeats)[1]
    torch.cuda.empty_cache()
    _stage("roofline probes + accounting")
    res.update(bench_roofline(device, res["train_epoch_s"], res["fullsort_eval_s"],
                              res["uni100_eval_s"]))
    _stage("scale leg (2M-item catalog)")
    res.update(bench_scale(device, res["hbm_probe_gbps"], res["mxu_probe_tflops_bf16"],
                           repeats=repeats, launches=launches))
    _stage("pallas top-k exactness")
    exact, fused_ms, dense_ms, err, near = bench_pallas_topk(device, repeats=repeats,
                                                             launches=launches)
    res.update(pallas_topk_exact=exact, pallas_topk_ms=fused_ms, dense_topk_ms=dense_ms,
               metric="e2e_train_epoch_examples_per_s_per_chip", unit="examples/s/chip",
               backend="cuda")
    out = {key: res[key] for key in KEYS}
    out["device"] = dev
    bad = [key for key, v in out.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite values: {bad}")
    print(f"card: {card}", flush=True)
    print(f"launches: {json.dumps(launches)}", flush=True)
    print(f"pallas_topk: {json.dumps({'max_abs_err': err, 'near_tie_swaps': near})}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
