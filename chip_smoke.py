#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--parent CHECKOUT]

Builds the port's hand-written kernels from the sources in this checkout,
serves full-sort evaluation of BPR-MF (PFCN_PMF, ``filter_mode: none``,
``embedding_size: 64``) at ml-1M scale through the serving entry points
(``load_data_and_model`` then ``evaluate``), trains the same model on the
same data through ``run_recbole``, trains the adversarial PFCN family
(filters, discriminators and their alternation), the fair models with
their published protocol and FairGo (graph propagation, pretrain then
adversarial finetune) through ``run_recbole``, trains with resident epochs
and runs a hyper-parameter search, runs the parallel layer on a world of
one NCCL rank, serves a catalog of 2M items stored in bfloat16 and in
float16 and takes the train step at that scale, runs ``bench_torch.py``
(bench.py's legs on the port) in a process of its own, trains FOCF to
convergence on ml-100k-fair through the whole-run parity runner in another,
checks that every path that has a kernel went through it, and holds every
kernel against its plain PyTorch version at the shapes the paths give it.
Imports nothing of JAX.

Phases, each of which exits non-zero when it fails:
  1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
  2. build: every kernel of the path, built in parallel (one nvcc each);
     with ``--parent CHECKOUT`` (a checkout of the parent commit, for example
     ``git archive 98b4f0a`` unpacked) that checkout's kernel is built beside
     them and run in a process of its own; then float32 outputs are held bit
     for bit against the parent build's at eight shapes (serving, k' 1 /
     2048 / 4096, d 30 / 65, I 65,536, shard mode) and one that takes the
     split merge (pinned digests, and the parent's from this run
     where given);
  3. scale: bench.py's catalog (bench_scale): a 2,097,152 x 128 item table
     made on the card from a seed, in bfloat16 and then in float16 (users of
     the same type: the tensor cores), served through certified_topk_scores
     (B 128) and approx_topk_scores (B 1024) with the launch counts set to 0
     before and read after; the kernel against its plain version at B 128
     and B 1024 over each table and at bench_pallas_topk's float32 shape (B
     1024, I 65,536, d 64), with times, the split into its two CUDA kernels,
     the bound and the library call, a call allocating no float32 copy of
     its table; then the port's
     Trainer._train_step at 1,048,576 users x 2,097,152 items x 128, batch
     65,536, dense Adam: 10 timed steps, every batch's loss falling, with
     examples/s, ms a step and peak memory (the first of the paths: late in
     a process that has run the other phases the profiler has shown no
     kernel of a fused_topk call, so the split would be lost);
  4. serve: synthetic ml-1M-scale data (numpy, seed 2020) -> Config ->
     create_dataset -> data_preparation -> a checkpoint of seeded random
     weights -> load_data_and_model -> evaluate(valid), evaluate(test) on the
     streaming path, with every launch count set to 0 just before and read
     just after; then the plain-torch dense path must give the same metrics;
  5. train: run_recbole on the same data (batch 2048, one uniform negative
     drawn on the card, Adam, streaming evaluation, 3 epochs, a validation
     after each), launch counts again set to 0 before and read after; the
     losses fall, the validations and the test went through the kernel, the
     checkpoint read back gives the same test metrics; negatives drawn on
     the card are unused pairs and uniform; one step on the card equals one
     on the CPU; seconds per epoch and per validation and the split of one
     step are printed;
  6. adversarial: the same interactions with ml-1M's age and occupation
     codes added per user (a separate numpy seed); run_recbole of PFCN_PMF
     at its published widths with filter_mode sm over gender, age and
     occupation (7 filters, 3 discriminators), 3 epochs (epoch 0 filter +
     discriminator, epochs 1-2 discriminator only), streaming validation of
     all 7 subsets after each; launch counts set to 0 before and read after
     (one launch per subset per macro batch of every validation and of the
     test); the checkpoint read back gives the same 7 dicts; one filter step
     and one discriminator step on the card equal the CPU's, BatchNorm
     statistics included; then 1-epoch runs of PFCN_BiasedMF (cm, d + 1 =
     65 through the kernel), PFCN_DMF (sm, unit vectors through the kernel)
     and PFCN_MLP (sm, the dense path); seconds per epoch kind, per
     validation and per test, and the split of a filter and a discriminator
     step are printed;
  7. published: PFCN_PMF, FOCF and NFCF with their published YAMLs (uni100,
     the 12 metrics): the sampled device path against the host path and the
     card against the CPU, labeled and GAUC evaluations;
  8. fairgo: FairGo_PMF and FairGo_GCN with their published YAMLs, cut to
     one pretrain and one finetune epoch, through run_recbole on the card
     (dense float32 propagation over the ml-1M-scale graph, 9,671 nodes):
     the passes, both stages' evaluations and the checkpoints (no
     propagation matrix in them) read back to the same dict; a pretrain, a
     filter and a discriminator step on the card equal the CPU's; dense
     propagation equals COO and bfloat16 stays within its bound; seconds
     per epoch, validation and test, the split of each step kind, and one
     hop against its bound are printed;
  9. resident: run_recbole of the training phase's BPR-MF with resident
     epochs (device_epoch_shuffle: the train table on the card, the
     shuffle and the negatives drawn there), 3 epochs, streaming validation
     and test through the kernel, launch counts set to 0 before and read
     after; one resident epoch with an injected permutation and negatives
     equals the card's per-step path on the same batches and the CPU's
     resident epoch; per-step and resident epochs side by side with their
     idle shares; a resident PFCN_PMF sm epoch (filter + discriminators) at
     the YAML's widths; a 2-trial exhaustive search over the learning rate;
     certified_topk_scores on the serving inputs against the plain version.
     (The published phase also times a uni100 validation with the device
     paths' emits deferred and immediate; the serve, published and fairgo
     phases check with the profiler that no collect call of the dense or
     sampled device path synchronises.)
 10. parallel: init_multihost starts a world of one (NCCL on cuda:0);
     run_recbole of the training phase's BPR-MF for 2 epochs without a mesh
     and over mesh_shape [1, 1] (the NCCL group, the sharded tables, the
     exchange lookups and the trainer's sharded paths, collectives of one
     rank): equal losses and dicts, both epoch times printed; the
     item-sharded top-k over the world of one; the serving inputs cut into
     4 item shards, each through the kernel's shard mode (column offset,
     PAD mask off), merged, against the plain version over the whole table;
     the shard call timed beside topk(matmul) on the same shard;
     sharded_propagate at FairGo's n (9,671) and the exchange lookup equal
     their single-device forms; the group is destroyed;
 11. bench: ``bench_torch.py --repeats 1`` (bench.py's legs on the port) in a
     process of its own that loads the kernel library phase 2 built and
     builds nothing: it must exit 0 with every key of bench.py, the dense and
     streaming evaluations agreeing (the streaming one through the kernel,
     the dense one without it), the kernel exact against the library call by
     the near-tie rule, the approx recall 1.0 and every number finite and
     positive; its JSON line, wall time and launches are printed;
 12. parity: ``python -m recbole_fairrec_tpu_torch.scripts.parity_runs --run
     FOCF --seed 2020`` (one whole run of the published protocol unchanged:
     uni100, the 12 metrics, epochs 300 with early stopping after 10
     validations without a better NDCG@5, the best checkpoint reloaded for
     the test) in a process of its own, its record written to a temporary
     directory: it must exit 0 with a record that names the card and 12
     finite test metrics, the headline's among them; its wall time,
     epochs trained and test NDCG@5 are printed, and its kernel launches
     (the sampled path: none) join the count;
 13. kernels: each kernel against its plain version on the inputs the
     serving path gave it, on the filtered, d 65 and unit-vector inputs of
     the adversarial phase, on gaussian inputs of the serving shapes (at the
     serving k', at k' 1 and at real ml-1M's k' 2048), at the largest k'
     (4096, over 16,384 items), on a tie-heavy integer input and at d 30;
     then the tensor-core path (bfloat16 and float16 users and tables) on
     the gaussian, k' 1, k' 4096, tie-heavy and d 30 inputs, and float16
     users over a bfloat16 table on the CUDA cores; with times, the bound
     and the library yardstick.

The second-to-last line is ``{"kernels": [...]}`` and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
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
ADV_DATASET = "ml1m-smoke-adv"
ADV_ATTRS = ["gender", "age", "occupation"]
ML1M_AGE_CODES = (1, 18, 25, 35, 45, 50, 56)  # ml-1M's users.dat age groups
ML1M_OCCUPATIONS = 21  # ml-1M's occupation codes 0-20
# the largest |m_hat / sqrt(v_hat)| of one Adam step (beta1 0.9, beta2 0.999),
# reached when the step's gradient dwarfs the moments' history
ADAM_STEP_BOUND = (1 - 0.9) / math.sqrt(1 - 0.999)
TOPK = 10
TRAIN_EPOCHS = 3
SPLIT_STEPS = 60  # steps over which one train step is split into its parts

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
                  name=DATASET, attributes=False):
    """bench.py's synthetic recipe, written with numpy alone: unique random
    (user, item) pairs with ratings 1-5, and a binary gender per user. With
    ``attributes`` each user also gets an ml-1M age code and occupation code,
    drawn from a generator of their own, so the interactions and genders are
    those of the plain dataset."""
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
    columns, header = [users, users % 2], "user_id:token\tgender:float"
    if attributes:
        attr_rng = np.random.RandomState(seed + 1)
        columns += [np.asarray(ML1M_AGE_CODES)[attr_rng.randint(0, len(ML1M_AGE_CODES), n_users)],
                    attr_rng.randint(0, ML1M_OCCUPATIONS, n_users)]
        header += "\tage:token\toccupation:token"
    np.savetxt(
        os.path.join(ddir, f"{name}.user"), np.stack(columns, axis=1), fmt="%d",
        delimiter="\t", header=header, comments="",
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
        # the first ETL of a run is cached beside the checkpoints; the later
        # entry points (load_data_and_model, run_recbole) read it back
        "save_dataset": True,
        "save_dataloaders": True,
        **(extra or {}),
    }


def train_config(data_root, work_dir, extra=None):
    """bench.py's training settings (bench.py:80-104) on the serving
    configuration, with streaming evaluation and a validation every epoch."""
    return serving_config(data_root, work_dir, {
        "train_batch_size": 2048,
        "neg_sampling": {"uniform": 1},
        "device_neg_sampling": True,
        "learner": "adam",
        "streaming_eval": True,
        "epochs": TRAIN_EPOCHS,
        "eval_step": 1,
        **(extra or {}),
    })


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
    """Phase 4: the serving main path. Returns the launch counts of its run,
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
    _require_card_trainer(trainer2, "serve")
    stream = {}
    for name, loader in (("valid", valid2), ("test", test2)):
        t0 = time.perf_counter()
        stream[name] = dict(trainer2.evaluate(loader)["none"])
        _sync()
        stream[name + "_s"] = time.perf_counter() - t0
        if trainer2._last_eval_path != "streaming-kernel":
            fail(f"evaluate({name}) took the path {trainer2._last_eval_path!r}")
    launches = {name: mod.launches for name, mod in modules.items()}
    for name, n in launches.items():
        if n == 0:
            fail(f"the serving path launched the kernel {name} no time")

    config2["streaming_eval"] = False
    dense = {}
    for name, loader in (("valid", valid2), ("test", test2)):
        t0 = time.perf_counter()
        dense[name] = dict(trainer2.evaluate(loader)["none"])
        _sync()
        dense[name + "_s"] = time.perf_counter() - t0
        if trainer2._last_eval_path != "fused":
            fail(f"dense evaluate({name}) took the path {trainer2._last_eval_path!r}")
    check_no_sync_in_collect("serve: dense evaluate(test)", trainer2,
                             lambda: trainer2.evaluate(test2))
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


@contextlib.contextmanager
def _timed_fit(modules):
    """While installed, every pass over the train loader (with its optimizer
    tag and attribute subset), every trained epoch, every validation and
    every final ``evaluate`` of the port's trainers (the base ``Trainer``'s,
    ``PFCNTrainer``'s and ``FairGoTrainer``'s) is timed (host clock, the card
    synchronised before and after) and the kernels' launch counts are read
    around each validation and each ``evaluate``; an evaluation inside
    another one (FairGo's two stages, a validation's ``evaluate``) is part of
    the outer one. Each pass records its loss, and each final ``evaluate``
    the state of numpy's generator at its start (the sampled negatives draw
    from it). Each validation and ``evaluate`` also
    records its split: the host's time in the sampled loader (the negative
    draws and the batch assembly), the span of the sampled device path on
    the card's timeline (CUDA events around each call, read after the
    evaluation, so the deferred emits keep their overlap) and its number of
    calls, and the loader batches. Yields the record (with each trainer's
    train loader); the methods are put back on exit."""
    from recbole_fairrec_tpu_torch.data import NegSampleEvalDataLoader
    from recbole_fairrec_tpu_torch.trainer import FairGoTrainer, PFCNTrainer, Trainer

    import torch

    record = {"trainers": [], "train_data": [], "epoch_s": [], "examples": [], "valid_s": [],
              "valid_results": [], "valid_launches": [], "valid_paths": [], "valid_split": [],
              "train_epoch_s": [], "train_epoch_losses": [], "test_s": [], "test_launches": [],
              "test_paths": [], "test_split": [], "test_rng": [], "passes": [],
              "pass_losses": []}
    counters = {"draws_s": 0.0, "device_s": 0.0, "sampled_calls": 0, "batches": 0}
    spans = []  # CUDA events around each sampled call, read after the evaluation
    in_eval = []
    originals = {}

    def patch(cls, name, wrap):
        originals[(cls, name)] = cls.__dict__[name]
        setattr(cls, name, wrap(originals[(cls, name)]))

    def timed_run_epoch(run_epoch):
        def run(self, train_data, *args, **kwargs):
            if not any(self is t for t in record["trainers"]):
                record["trainers"].append(self)
                record["train_data"].append(train_data)
            _sync()
            t0 = time.perf_counter()
            out = run_epoch(self, train_data, *args, **kwargs)
            _sync()
            record["epoch_s"].append(time.perf_counter() - t0)
            record["examples"].append(len(train_data.dataset))
            record["pass_losses"].append(out)
            if len(args) == 3:  # (loss name, attribute subset, optimizer tag)
                record["passes"].append([args[2], list(args[1] or [])])
            return out
        return run

    def timed_eval(kind):
        def wrap(fn):
            def run(self, *args, **kwargs):
                if in_eval:  # part of an evaluation timed already
                    return fn(self, *args, **kwargs)
                before = {name: mod.launches for name, mod in modules.items()}
                split0 = dict(counters)
                if kind == "test":
                    record["test_rng"].append(np.random.get_state())
                in_eval.append(kind)
                _sync()
                t0 = time.perf_counter()
                try:
                    out = fn(self, *args, **kwargs)
                finally:
                    in_eval.pop()
                _sync()
                record[f"{kind}_s"].append(time.perf_counter() - t0)
                counters["device_s"] += sum(a.elapsed_time(b) for a, b in spans) / 1e3
                spans.clear()
                if kind == "valid":
                    record["valid_results"].append(dict(out[1]))
                record[f"{kind}_launches"].append(
                    {name: mod.launches - before[name] for name, mod in modules.items()})
                record[f"{kind}_paths"].append(self._last_eval_path)
                record[f"{kind}_split"].append(
                    {key: counters[key] - split0[key] for key in counters})
                return out
            return run
        return wrap

    def timed_train_epoch(train_epoch):
        def run(self, *args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = train_epoch(self, *args, **kwargs)
            _sync()
            record["train_epoch_s"].append(time.perf_counter() - t0)
            record["train_epoch_losses"].append(out)
            return out
        return run

    def timed_draws(next_batch):
        def run(self):
            t0 = time.perf_counter()
            out = next_batch(self)
            counters["draws_s"] += time.perf_counter() - t0
            counters["batches"] += 1
            return out
        return run

    def timed_sampled(collect):
        def run(self, *args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = collect(self, *args, **kwargs)
            ev[1].record()
            spans.append(ev)
            counters["sampled_calls"] += 1
            return out
        return run

    patch(Trainer, "_run_epoch", timed_run_epoch)
    patch(Trainer, "_collect_sampled_fused", timed_sampled)
    patch(NegSampleEvalDataLoader, "_next_batch_data", timed_draws)
    for cls in (Trainer, PFCNTrainer):
        patch(cls, "_valid_epoch", timed_eval("valid"))
    for cls in (Trainer, PFCNTrainer, FairGoTrainer):
        patch(cls, "evaluate", timed_eval("test"))
        patch(cls, "_train_epoch", timed_train_epoch)
    try:
        yield record
    finally:
        for (cls, name), fn in originals.items():
            setattr(cls, name, fn)


def _check_metrics(label, result):
    for metric, value in result.items():
        if not (math.isfinite(value) and 0.0 <= value <= 1.0):
            fail(f"{label}: metric {metric} = {value} is not in [0, 1]")


def _bpr_run(data_root, work_dir, card, label, extra_cfg=None):
    """BPR-MF through ``run_recbole`` with the training phase's settings
    (``extra_cfg`` on top), the launch counts set to 0 just before and read
    just after: the trainer on the card, epochs whose loss falls, every
    validation and the test through the kernel, the result's structure.
    Prints ``<label>: epochs`` and returns (result, record, trainer, cfg,
    launches)."""
    from recbole_fairrec_tpu_torch import run_recbole

    cfg = train_config(data_root, work_dir, extra_cfg)
    modules = {k["name"]: _kernel_module(k) for k in KERNELS}
    for mod in modules.values():
        mod.launches = 0
    with _timed_fit(modules) as rec:
        t0 = time.perf_counter()
        result = run_recbole(model="PFCN_PMF", dataset=DATASET, config_dict=cfg)
        _sync()
        total_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in modules.items()}

    if len(rec["trainers"]) != 1:
        fail(f"{label}: run_recbole trained {len(rec['trainers'])} trainers, expected 1")
    trainer = rec["trainers"][0]
    _require_card_trainer(trainer, label)
    losses = [trainer.train_loss_dict[e] for e in sorted(trainer.train_loss_dict)]
    epochs = cfg["epochs"]
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: epoch losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall over {epochs} epochs: {losses}")
    if len(rec["valid_s"]) != epochs:
        fail(f"{label}: {len(rec['valid_s'])} validations, expected {epochs}")
    for epoch, (res, n, path) in enumerate(
            zip(rec["valid_results"], rec["valid_launches"], rec["valid_paths"])):
        _check_metrics(f"{label}: validation {epoch}", res)
        if path != "streaming-kernel":
            fail(f"{label}: validation {epoch} took the path {path!r}")
        for name, count in n.items():
            if count < 1:
                fail(f"{label}: validation {epoch} launched the kernel {name} no time")
    if trainer._last_eval_path != "streaming-kernel":
        fail(f"{label}: the test evaluation took the path {trainer._last_eval_path!r}")
    for name, count in launches.items():
        in_valid = sum(n[name] for n in rec["valid_launches"])
        if count - in_valid < 1:
            fail(f"{label}: the test evaluation launched the kernel {name} no time")
    if list(result["test_result"]) != ["none"]:
        fail(f"{label}: test_result keys {list(result['test_result'])}")
    _check_metrics(f"{label}: test", result["test_result"]["none"])
    if result["best_valid_result"] not in rec["valid_results"]:
        fail(f"{label}: best_valid_result is none of the validations' results")

    examples = rec["examples"][0]
    first_s, later_s = rec["epoch_s"][0], rec["epoch_s"][1:]
    row = {
        "run_recbole_s": total_s, "examples_per_epoch": examples,
        "steps_per_epoch": -(-examples // cfg["train_batch_size"]),
        "first_epoch_s": first_s, "first_epoch_examples_per_s": examples / first_s,
        "later_epochs_s": later_s,
        "later_epochs_examples_per_s": [examples / t for t in later_s],
        "validation_s": rec["valid_s"], "test_s": rec["test_s"], "epoch_losses": losses,
        "card": card,
    }
    print(f"{label}: epochs {json.dumps(row)}", flush=True)
    print(f"{label}: best valid {result['best_valid_result']}; test {result['test_result']}; "
          f"launches on the main path {launches}", flush=True)
    return result, rec, trainer, cfg, launches


def train(data_root, work_dir, card, extra_cfg=None):
    """Phase 5: the training main path through ``run_recbole``, then the
    checkpoint read back, the negatives, one step against the CPU and the
    step split. Returns the launch counts of its run."""
    from recbole_fairrec_tpu_torch import load_data_and_model

    result, _, trainer, cfg, launches = _bpr_run(data_root, work_dir, card, "train", extra_cfg)

    # the checkpoint fit saved, read back through the serving entry point
    config2, _, trainer2, _, train2, _, test2 = load_data_and_model(
        trainer.saved_model_file, config_dict={"log_root": cfg["log_root"]})
    _require_card_trainer(trainer2, "train read-back")
    back = trainer2.evaluate(test2)
    if {k: dict(v) for k, v in back.items()} != \
            {k: dict(v) for k, v in result["test_result"].items()}:
        fail(f"train: the checkpoint read back gives {back}, run_recbole gave "
             f"{result['test_result']}")
    print("train: the checkpoint read back gives the same test metrics", flush=True)

    check_negatives(trainer2, train2, card)
    check_step_card_against_cpu(trainer2, train2, cfg, trainer.saved_model_file)
    time_step_split(trainer2, train2, card)
    return launches


def adversarial_config(data_root, work_dir, extra=None):
    """The training phase's settings on the dataset with attributes, with
    ``filter_mode: sm`` over gender, age and occupation; every other width
    and setting (embedding 64, discriminators [128, 256, 128, 128, 64, 32],
    leaky ReLU, dis_dropout 0.3, dis_weight 10, weight_decay 1e-4,
    train_epoch_interval 5 for PFCN_PMF) is the model's published one from
    its properties."""
    return train_config(data_root, work_dir, {
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", *ADV_ATTRS]},
        "filter_mode": "sm",
        "sst_attr_list": list(ADV_ATTRS),
        **(extra or {}),
    })


def _subset_keys(mode, attrs):
    import itertools

    return [f"{mode}-{list(c)}" for i in range(1, len(attrs) + 1)
            for c in itertools.combinations(attrs, i)]


def _adversarial_run(data_root, work_dir, model, extra, expected_path):
    """One ``run_recbole`` of an adversarial model with the launch counts
    set to 0 just before and read just after. Checks the trainer, the epoch
    losses, the paths and launch counts of every validation and of the test
    and the result's keys; returns (result, record, launches, trainer)."""
    from recbole_fairrec_tpu_torch import run_recbole

    cfg = adversarial_config(data_root, work_dir, extra)
    modules = {k["name"]: _kernel_module(k) for k in KERNELS}
    for mod in modules.values():
        mod.launches = 0
    with _timed_fit(modules) as rec:
        t0 = time.perf_counter()
        result = run_recbole(model=model, dataset=ADV_DATASET, config_dict=cfg)
        _sync()
        rec["run_recbole_s"] = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in modules.items()}
    label = f"adversarial {model}"
    if len(rec["trainers"]) != 1:
        fail(f"{label}: run_recbole trained {len(rec['trainers'])} trainers, expected 1")
    trainer = rec["trainers"][0]
    _require_card_trainer(trainer, label, model)
    epochs, interval = trainer.epochs, trainer.train_epoch_interval
    losses = rec["train_epoch_losses"]
    if len(losses) != epochs:
        fail(f"{label}: {len(losses)} epochs trained, expected {epochs}")
    for epoch, pair in enumerate(losses):
        if not (isinstance(pair, tuple) and len(pair) == 2
                and all(math.isfinite(x) for x in pair)):
            fail(f"{label}: epoch {epoch} losses {pair}: not a finite (filter, dis) pair")
        if (pair[0] != 0.0) != (epoch % interval == 0) or pair[1] == 0.0:
            fail(f"{label}: epoch {epoch} losses {pair}: a pass ran or was skipped wrongly")
    keys = _subset_keys(cfg["filter_mode"], cfg["sst_attr_list"])
    if list(result["test_result"]) != keys:
        fail(f"{label}: test_result keys {list(result['test_result'])}, expected {keys}")
    for key, res in result["test_result"].items():
        _check_metrics(f"{label}: test {key}", res)
    if len(rec["valid_s"]) != epochs or len(rec["test_s"]) != 1:
        fail(f"{label}: {len(rec['valid_s'])} validations and {len(rec['test_s'])} tests")
    for epoch, (res, path) in enumerate(zip(rec["valid_results"], rec["valid_paths"])):
        _check_metrics(f"{label}: validation {epoch}", res)
        if path != expected_path:
            fail(f"{label}: validation {epoch} took the path {path!r}, not {expected_path!r}")
    if rec["test_paths"][0] != expected_path:
        fail(f"{label}: the test took the path {rec['test_paths'][0]!r}")
    if result["best_valid_result"] not in rec["valid_results"]:
        fail(f"{label}: best_valid_result is none of the validations' results")
    rec["subsets"] = len(keys)
    return result, rec, launches, trainer


def _check_launches(label, rec, launches, n_macro_valid, n_macro_test):
    """``fused_topk`` once per subset per macro batch of every validation
    and of the test, and nowhere else."""
    for epoch, n in enumerate(rec["valid_launches"]):
        if n["fused_topk"] != rec["subsets"] * n_macro_valid:
            fail(f"{label}: validation {epoch} launched fused_topk {n['fused_topk']} times, "
                 f"expected {rec['subsets']} subsets x {n_macro_valid} macro batches")
    if rec["test_launches"][0]["fused_topk"] != rec["subsets"] * n_macro_test:
        fail(f"{label}: the test launched fused_topk {rec['test_launches'][0]['fused_topk']} "
             f"times, expected {rec['subsets']} x {n_macro_test}")
    in_evals = sum(n["fused_topk"] for n in rec["valid_launches"] + rec["test_launches"])
    if launches["fused_topk"] != in_evals:
        fail(f"{label}: fused_topk launched {launches['fused_topk']} times, "
             f"{in_evals} of them in evaluations")


def _read_back(trainer, cfg, result, label, model):
    """The checkpoint ``fit`` saved, through ``load_data_and_model`` then
    ``evaluate``: the same dict per subset. Returns the serving trainer and
    its loaders."""
    from recbole_fairrec_tpu_torch import load_data_and_model

    _, _, trainer2, _, train2, valid2, test2 = load_data_and_model(
        trainer.saved_model_file, config_dict={"log_root": cfg["log_root"]})
    _require_card_trainer(trainer2, f"{label} read-back", model)
    back = trainer2.evaluate(test2)
    if {k: dict(v) for k, v in back.items()} != \
            {k: dict(v) for k, v in result["test_result"].items()}:
        fail(f"{label}: the checkpoint read back gives {back}, run_recbole gave "
             f"{result['test_result']}")
    return trainer2, train2, valid2, test2


def _n_macro(trainer, loader):
    return sum(1 for _ in trainer._macro_batches(loader, "full"))


def adversarial(data_root, work_dir, card):
    """Phase 6: the adversarial main path (PFCN_PMF, sm over three
    attributes, 3 epochs) and the short runs of the other backbones. Returns
    the launch counts by run and the kernel's rows on the new inputs."""
    cfg = adversarial_config(data_root, work_dir)
    result, rec, launches, trainer = _adversarial_run(
        data_root, work_dir, "PFCN_PMF", None, "streaming-kernel")
    trainer2, train2, valid2, test2 = _read_back(trainer, cfg, result, "adversarial", "PFCN_PMF")
    _check_launches("adversarial", rec, launches, _n_macro(trainer2, valid2),
                    _n_macro(trainer2, test2))
    print("adversarial: the checkpoint read back gives the same 7 dicts", flush=True)
    epochs = rec["train_epoch_s"]
    row = {
        "run_recbole_s": rec["run_recbole_s"], "examples_per_epoch": rec["examples"][0],
        "filter_and_dis_epoch_s": [t for t, l in zip(epochs, rec["train_epoch_losses"]) if l[0]],
        "dis_only_epoch_s": [t for t, l in zip(epochs, rec["train_epoch_losses"]) if not l[0]],
        "pass_s": rec["epoch_s"],
        "validation_s": rec["valid_s"], "subsets_per_validation": rec["subsets"],
        "test_s": rec["test_s"][0], "epoch_losses": rec["train_epoch_losses"],
        "passes": rec["passes"], "launches": launches, "config": {k: trainer.config[k] for k in (
            "embedding_size", "dis_hidden_size_list", "activation", "dis_dropout",
            "dis_weight", "weight_decay", "train_epoch_interval", "filter_mode",
            "sst_attr_list")},
        "card": card,
    }
    print(f"adversarial: epochs {json.dumps(row)}", flush=True)
    print(f"adversarial: best valid {result['best_valid_result']}; test {result['test_result']}",
          flush=True)

    check_adversarial_steps(trainer2, train2, cfg, trainer.saved_model_file)
    mod = _kernel_module(KERNELS[0])
    U, T, k = serving_inputs(trainer2, test2, tuple(ADV_ATTRS))
    rows = [check_fused_topk(mod, U, T, k, "filtered-pmf", card)]
    time_adversarial_step_split(trainer2, train2, card)

    runs = {"adversarial": launches["fused_topk"]}
    for model, extra, path, label in (
            ("PFCN_BiasedMF", {"filter_mode": "cm", "sst_attr_list": ["gender"]},
             "streaming-kernel", "biasedmf-d65"),
            ("PFCN_DMF", {"filter_mode": "sm", "sst_attr_list": ["gender", "age"]},
             "streaming-kernel", "dmf-unit"),
            ("PFCN_MLP", {"filter_mode": "sm", "sst_attr_list": ["gender"]}, "fused", None)):
        short_cfg = adversarial_config(data_root, work_dir, {**extra, "epochs": 1})
        res, srec, slaunches, strainer = _adversarial_run(
            data_root, work_dir, model, {**extra, "epochs": 1}, path)
        t2, _, v2, te2 = _read_back(strainer, short_cfg, res, f"adversarial {model}", model)
        if label is None:
            if slaunches["fused_topk"]:
                fail(f"adversarial {model}: the dense path launched fused_topk")
        else:
            _check_launches(f"adversarial {model}", srec, slaunches, _n_macro(t2, v2),
                            _n_macro(t2, te2))
            U, T, k = serving_inputs(t2, te2, tuple(extra["sst_attr_list"]))
            rows.append(check_fused_topk(mod, U, T, k, label, card))
        runs[model] = slaunches["fused_topk"]
        print(f"adversarial: {model} {extra['filter_mode']} {extra['sst_attr_list']}, 1 epoch: "
              f"run_recbole {srec['run_recbole_s']:.3f} s, epoch "
              f"{srec['train_epoch_s'][0]:.3f} s, validation {srec['valid_s'][0]:.3f} s, test "
              f"{srec['test_s'][0]:.3f} s, path {path}, fused_topk launches "
              f"{slaunches['fused_topk']}; test {res['test_result']}; {card}", flush=True)
    return runs, rows


# ------------------------------------------------------- the published protocol

PUBLISHED_ATTRS = ["gender", "age"]
# what every fair model's YAML sets for its evaluation protocol
PROTOCOL_KEYS = ("eval_args", "metrics", "topk", "valid_metric", "LABEL_FIELD", "threshold")
# the 12 metric families of the protocol, by the prefix of their result
# keys; the per-attribute ones carry one key per sensitive attribute
METRIC_FAMILIES = ("ndcg@", "recall@", "hit@", "mrr@", "Differential Fairness", "giniindex@",
                   "popularitypercentage@", "Value Unfairness", "Absolute Unfairness",
                   "Underestimation Unfairness", "Overestimation Unfairness",
                   "NonParity Unfairness")
PER_ATTRIBUTE = ("Differential Fairness", "NonParity Unfairness")
# metrics that only count ranks; the others average scores
RANK_METRICS = ("ndcg@", "recall@", "hit@", "mrr@", "giniindex@", "popularitypercentage@",
                "gauc")
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-7


def published_yaml(model):
    """The model's published YAML, as the port carries it."""
    with open(os.path.join(REPO, PACKAGE, "config", "properties.json"), encoding="utf-8") as f:
        return json.load(f)[f"model/{model}"]


def published_config(data_root, work_dir, model, extra=None):
    """A run of ``model`` with its published YAML unchanged: the protocol and
    every width come from the YAML through ``Config``. A dataset's defaults
    take precedence over a model YAML's columns, label and threshold, so
    those three are given here exactly as the YAML gives them."""
    yaml = published_yaml(model)
    return {
        "data_path": data_root,
        **{key: yaml[key] for key in ("load_col", "LABEL_FIELD", "threshold")},
        "show_progress": False,
        "state": "WARNING",
        "checkpoint_dir": os.path.join(work_dir, "saved"),
        "log_root": os.path.join(work_dir, "log"),
        "save_dataset": True,
        **(extra or {}),
    }


def _check_protocol(label, config, model):
    yaml = published_yaml(model)
    for key in PROTOCOL_KEYS:
        if config[key] != yaml[key]:
            fail(f"{label}: {key} is {config[key]!r}, the YAML gives {yaml[key]!r}")


def _check_families(label, result, attrs):
    """All 12 metric families, finite; the per-attribute ones for each
    attribute."""
    for family in METRIC_FAMILIES:
        keys = [k for k in result if k.startswith(family)]
        want = len(attrs) if family in PER_ATTRIBUTE else 1
        if len(keys) != want:
            fail(f"{label}: {len(keys)} keys of the family {family!r}, expected {want}: "
                 f"{list(result)}")
        for attr in attrs if family in PER_ATTRIBUTE else ():
            if not any(k.endswith(f"attribute {attr}") for k in keys):
                fail(f"{label}: no {family!r} of the attribute {attr}")
        for k in keys:
            if not math.isfinite(result[k]):
                fail(f"{label}: {k} = {result[k]} is not finite")


def _published_run(data_root, work_dir, model, extra, attrs, modules):
    """One ``run_recbole`` of ``model`` with its published YAML, the launch
    counts set to 0 just before and read just after. Checks the trainer,
    the protocol, the sampled path of every validation and of the test and
    the metric families; returns (result, record, trainer, cfg)."""
    from recbole_fairrec_tpu_torch import run_recbole

    cfg = published_config(data_root, work_dir, model, extra)
    label = f"published {model}"
    for mod in modules.values():
        mod.launches = 0
    with _timed_fit(modules) as rec:
        t0 = time.perf_counter()
        result = run_recbole(model=model, dataset=ADV_DATASET, config_dict=cfg)
        _sync()
        rec["run_recbole_s"] = time.perf_counter() - t0
    rec["launches"] = {name: mod.launches for name, mod in modules.items()}
    if len(rec["trainers"]) != 1:
        fail(f"{label}: run_recbole trained {len(rec['trainers'])} trainers, expected 1")
    trainer = rec["trainers"][0]
    _require_card_trainer(trainer, label, model)
    _check_protocol(label, trainer.config, model)
    if any(rec["launches"].values()):
        fail(f"{label}: the sampled path launched {rec['launches']}")
    if len(rec["valid_s"]) != trainer.epochs or len(rec["test_s"]) != 1:
        fail(f"{label}: {len(rec['valid_s'])} validations and {len(rec['test_s'])} tests")
    subsets = len(result["test_result"]) if model.startswith("PFCN") else 1
    for what, split, path in zip(["validation"] * len(rec["valid_split"]) + ["test"],
                                 rec["valid_split"] + rec["test_split"],
                                 rec["valid_paths"] + rec["test_paths"]):
        if path != "sampled-fused":
            fail(f"{label}: a {what} took the path {path!r}")
        # validation: one pass, every subset per batch; test: one pass per subset
        per_pass = split["batches"] if what == "validation" else split["batches"] // subsets
        if split["sampled_calls"] != subsets * per_pass or per_pass < 1:
            fail(f"{label}: a {what} made {split['sampled_calls']} device calls over "
                 f"{split['batches']} loader batches and {subsets} subsets")
    for epoch, res in enumerate(rec["valid_results"]):
        _check_families(f"{label}: validation {epoch}", res, attrs)
    tests = result["test_result"]
    for key, res in (tests.items() if model.startswith("PFCN") else [("", tests)]):
        _check_families(f"{label}: test {key}", res, attrs)
    if result["best_valid_result"] not in rec["valid_results"]:
        fail(f"{label}: best_valid_result is none of the validations' results")
    return result, rec, trainer, cfg


def _published_row(model, rec, card, **extra):
    def split(s, entry):
        return {"seconds": s, "host_draws_s": entry["draws_s"], "device_s": entry["device_s"],
                "other_s": s - entry["draws_s"] - entry["device_s"],
                "loader_batches": entry["batches"], "device_calls": entry["sampled_calls"]}

    return {
        "model": model, "run_recbole_s": rec["run_recbole_s"],
        "epoch_s": rec["train_epoch_s"], "examples_per_epoch": rec["examples"][0],
        "validations": [split(s, e) for s, e in zip(rec["valid_s"], rec["valid_split"])],
        "test": split(rec["test_s"][0], rec["test_split"][0]),
        **extra, "card": card,
    }


def _collect_on(trainer, kind, batches, sst, path, k):
    """Feed ``batches`` to ``trainer``'s collector through the device path or
    the host path; returns (unrounded result, top-k ids per user, ties). On
    the host path ``ties`` holds per user whether two of its k + 1 best
    scores are equal ("exact") or within 1e-6 of each other ("near"); on
    the device path it is None."""
    import torch

    exact, near = [], []
    trainer.model.eval()
    with torch.no_grad():
        for batch in batches:
            if path == "device":
                trainer._drain_collect([trainer._collect_batch(kind, batch, sst)])
                continue
            _, scores, pos_u, pos_i = trainer._neg_sample_batch_eval(batch, sst)
            top = -np.sort(-scores, axis=1)[:, : k + 1]
            gap = np.abs(top[:, 1:] - top[:, :-1])
            exact.append((gap == 0).any(axis=1))
            near.append((gap <= 1e-6 * np.abs(top[:, 1:])).any(axis=1))
            trainer.eval_collector.eval_batch_collect(scores, batch[0], pos_u, pos_i)
    struct = trainer.eval_collector.get_data_struct()
    ids = np.asarray(struct.get("rec.items"))
    ties = {"exact": np.concatenate(exact), "near": np.concatenate(near)} if exact else None
    return trainer.evaluator.evaluate(struct), ids, ties


def _compare_results(label, a, b, ties):
    """Two evaluations of the same batches: the top-k ids equal except for
    users with a near tie among their k + 1 best scores, the rank metrics
    equal when no ids differ, the score-averaged metrics within
    ``VALUE_RTOL``. Returns the counts for the record."""
    (res_a, ids_a, _), (res_b, ids_b, _) = a, b
    differ = (ids_a != ids_b).any(axis=1)
    unexplained = differ & ~ties
    if unexplained.any():
        fail(f"{label}: {int(unexplained.sum())} users' top-k differ without a tie")
    if list(res_a) != list(res_b):
        fail(f"{label}: the keys differ: {list(res_a)} / {list(res_b)}")
    gaps = {}
    for key, va in res_a.items():
        vb = res_b[key]
        if key.startswith(RANK_METRICS):
            if not differ.any() and va != vb:
                fail(f"{label}: {key} {va!r} != {vb!r} with the same top-k ids")
        elif abs(va - vb) > VALUE_RTOL * abs(vb) + VALUE_ATOL:
            fail(f"{label}: {key} {va!r} and {vb!r} differ beyond rel {VALUE_RTOL}")
        if va != vb:
            gaps[key] = abs(va - vb)
    printed = [key for key in res_a if round(res_a[key], 4) != round(res_b[key], 4)]
    return {"users": int(len(ids_a)), "tie_users": int(ties.sum()),
            "differing_topk_users": int(differ.sum()), "unrounded_gaps": gaps,
            "keys_differing_at_4_places": printed}


def check_sampled_paths(trainer, valid_data, cpu_trainer, attrs, card):
    """On one list of uni100 validation batches (drawn once), for every
    attribute subset: the device path against the host path on the card
    (``_neg_sample_batch_eval``: ``predict`` on the card, ranking in numpy),
    and the card's device path against the CPU's on the first macro batch.
    Metrics are computed unrounded here (``metric_decimal_place`` 10) and
    compared as ``_compare_results`` says: the two paths on the card may
    rank only exactly equal scores differently, the two devices also scores
    within 1e-6 of each other (ties counted on each device)."""
    import itertools

    from recbole_fairrec_tpu_torch.evaluator import Evaluator

    for t in (trainer, cpu_trainer):
        t.config["metric_decimal_place"] = 10
        t.evaluator = Evaluator(t.config)
    k = max(trainer.config["topk"])
    kind = trainer._prepare_eval(valid_data)
    cpu_trainer._prepare_eval(valid_data)
    np.random.seed(4)
    t0 = time.perf_counter()
    batches = list(trainer._macro_batches(valid_data, kind))
    draws_s = time.perf_counter() - t0
    first_users = int(batches[0][2][-1]) + 1
    rows = []
    for sst in [c for i in range(1, len(attrs) + 1) for c in itertools.combinations(attrs, i)]:
        _sync()
        t0 = time.perf_counter()
        device = _collect_on(trainer, kind, batches, sst, "device", k)
        _sync()
        device_s = time.perf_counter() - t0
        host = _collect_on(trainer, kind, batches, sst, "host", k)
        host_s = time.perf_counter() - t0 - device_s
        # one device's float32 scores: the two paths can part only on equal ones
        paths = _compare_results(f"sampled paths {list(sst)}: device vs host on the card",
                                 device, host, host[2]["exact"])
        card_first = _collect_on(trainer, kind, batches[:1], sst, "device", k)
        cpu_first = _collect_on(cpu_trainer, kind, batches[:1], sst, "device", k)
        cpu_ties = _collect_on(cpu_trainer, kind, batches[:1], sst, "host", k)[2]
        # two devices' float32 scores may part in the last bits: near ties
        devices = _compare_results(f"sampled paths {list(sst)}: card vs CPU", card_first,
                                   cpu_first, host[2]["near"][:first_users] | cpu_ties["near"])
        rows.append({"sst": list(sst), "device_vs_host": paths, "card_vs_cpu": devices,
                     "device_path_s": device_s, "host_path_s": host_s})
    row = {"macro_batches": len(batches), "rows": sum(len(b[0]) for b in batches),
           "users": sum(int(b[2][-1]) + 1 for b in batches), "first_batch_users": first_users,
           "host_draws_s": draws_s, "subsets": rows, "card": card}
    print(f"published: sampled paths {json.dumps(row)}", flush=True)


@contextlib.contextmanager
def _split_evaluation(trainer, immediate):
    """While installed: the host's time in the sampled loader (draws), in
    ``_collect_batch`` (the launches) and in ``_drain_collect`` (the
    payload copies and the collector), and the span of each collect call on
    the card's timeline (CUDA events, read after the evaluation); with
    ``immediate`` each deferred emit runs inside its own collect call, as
    before deferral. Yields the split, filled in on exit."""
    import torch

    from recbole_fairrec_tpu_torch.data import NegSampleEvalDataLoader

    split = {"draws_s": 0.0, "collect_host_s": 0.0, "drain_host_s": 0.0, "calls": 0}
    spans = []
    next_batch = NegSampleEvalDataLoader._next_batch_data
    collect, drain = trainer._collect_batch, trainer._drain_collect

    def timed_next(self):
        t0 = time.perf_counter()
        out = next_batch(self)
        split["draws_s"] += time.perf_counter() - t0
        return out

    def timed_collect(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        emit = collect(*args, **kwargs)
        ev[1].record()
        if immediate and emit is not None:
            emit()
            emit = None
        split["collect_host_s"] += time.perf_counter() - t0
        spans.append(ev)
        split["calls"] += 1
        return emit

    def timed_drain(pending):
        t0 = time.perf_counter()
        drain(pending)
        split["drain_host_s"] += time.perf_counter() - t0

    NegSampleEvalDataLoader._next_batch_data = timed_next
    trainer._collect_batch, trainer._drain_collect = timed_collect, timed_drain
    try:
        yield split
    finally:
        NegSampleEvalDataLoader._next_batch_data = next_batch
        del trainer._collect_batch, trainer._drain_collect
    split["device_span_s"] = sum(a.elapsed_time(b) for a, b in spans) / 1e3


def check_no_sync_in_collect(label, trainer, evaluate):
    """``evaluate()`` (deferred emits) under ``torch.profiler``, each collect
    call of ``trainer`` inside a ``record_function`` range: fails if a
    synchronising CUDA runtime call (stream, device or event synchronise, a
    blocking copy) falls inside a range, naming the operators that made it,
    or if the profiler saw no range or no such call at all (the drain's
    copies synchronise, so a trace without any cannot see them)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy")
    collect = trainer._collect_batch

    def marked(*args, **kwargs):
        with record_function("chip_smoke.collect"):
            return collect(*args, **kwargs)

    trainer._collect_batch = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            evaluate()
            _sync()
    finally:
        del trainer._collect_batch
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "chip_smoke.collect"]
    syncs = [e for e in events if e.name in names]
    inside = [e for e in syncs
              if any(a <= e.time_range.start <= b for a, b in ranges)]
    owners = sorted({(e.cpu_parent.name if e.cpu_parent is not None else e.name)
                     for e in inside})
    counts = {"collect_calls": len(ranges), "syncs_inside_collect": len(inside),
              "syncs_outside_collect": len(syncs) - len(inside)}
    print(f"{label}: under the profiler {json.dumps(counts)}", flush=True)
    if not ranges or not syncs:
        fail(f"{label}: the profiler saw {len(ranges)} collect calls and {len(syncs)} "
             "synchronising calls: the check cannot see them")
    if inside:
        fail(f"{label}: {len(inside)} synchronising calls inside the collect calls, "
             f"from {owners}")


def time_deferral(trainer, valid_data, card):
    """A uni100 validation (every subset per macro batch) with the device
    paths' emits run inside their calls (immediate) and deferred to after
    the loop, in turns (immediate, deferred, deferred, immediate), numpy
    seeded alike before each: the dicts must be identical. Prints each
    run's split (seconds, host draws, host time in the launches and in the
    drain, the device span, the rest). Then the profiler's check that no
    collect call synchronises: nothing between a batch's launch and the
    loader's draws for the next may wait for the card."""
    runs = []
    for immediate in (True, False, False, True):
        with _split_evaluation(trainer, immediate) as split:
            np.random.seed(4)
            _sync()
            t0 = time.perf_counter()
            result = trainer.pfcn_evaluate(valid_data, load_best_model=False)
            _sync()
            seconds = time.perf_counter() - t0
        split.update(seconds=seconds, mode="immediate" if immediate else "deferred",
                     other_s=seconds - split["draws_s"] - split["collect_host_s"]
                     - split["drain_host_s"])
        runs.append((result, split))
        if trainer._last_eval_path != "sampled-fused":
            fail(f"deferral: the validation took the path {trainer._last_eval_path!r}")
    if any(r != runs[0][0] for r, _ in runs[1:]):
        fail("deferral: deferred and immediate emits give different validation dicts")
    row = {"runs": [split for _, split in runs], "card": card}
    print(f"published: deferral {json.dumps(row)}", flush=True)
    np.random.seed(4)
    check_no_sync_in_collect("published: deferred validation", trainer,
                             lambda: trainer.pfcn_evaluate(valid_data, load_best_model=False))


def published(data_root, work_dir, card):
    """Phase 7: the fair models with their published YAMLs unchanged (uni100
    validation and test, top 5, NDCG@5, the 12 metrics, the rating
    threshold): PFCN_PMF sm over gender and age for 2 epochs, FOCF
    (``fair_objective: value``) for 1, NFCF pretrained for 1 and finetuned
    for 1 from that checkpoint; then a labeled-mode evaluation (AUC,
    LogLoss, MAE, RMSE) and a full-sort evaluation with GAUC, both on the
    host paths, of the PFCN_PMF checkpoint. Returns the kernels' launch
    counts of its runs."""
    from recbole_fairrec_tpu_torch import load_data_and_model
    from recbole_fairrec_tpu_torch.data import FOCFDataLoader, create_dataset
    from recbole_fairrec_tpu_torch.quick_start import load_checkpoint

    modules = {k["name"]: _kernel_module(k) for k in KERNELS}
    launches = dict.fromkeys(modules, 0)

    def add(rec):
        for name, n in rec["launches"].items():
            launches[name] += n

    # PFCN_PMF: filter + discriminators in epoch 0, discriminators in epoch 1
    attrs = PUBLISHED_ATTRS
    result, rec, trainer, cfg = _published_run(
        data_root, work_dir, "PFCN_PMF",
        {"filter_mode": "sm", "sst_attr_list": attrs, "epochs": 2}, attrs, modules)
    add(rec)
    losses = rec["train_epoch_losses"]
    if not (losses[0][0] != 0.0 and losses[1][0] == 0.0 and all(l[1] for l in losses)):
        fail(f"published PFCN_PMF: epoch losses {losses}: not filter + dis, then dis only")
    keys = _subset_keys("sm", attrs)
    if list(result["test_result"]) != keys:
        fail(f"published PFCN_PMF: test_result keys {list(result['test_result'])}")
    row = _published_row("PFCN_PMF", rec, card, epoch_losses=losses, passes=rec["passes"])
    print(f"published: epochs {json.dumps(row)}", flush=True)
    print(f"published: PFCN_PMF best valid {result['best_valid_result']}; "
          f"test {result['test_result']}", flush=True)
    ckpt = trainer.saved_model_file
    over = {"log_root": cfg["log_root"]}
    _, _, trainer2, _, _, valid2, _ = load_data_and_model(ckpt, over)
    _require_card_trainer(trainer2, "published PFCN_PMF read-back", "PFCN_PMF")
    time_deferral(trainer2, valid2, card)
    _, _, cpu_trainer, _, _, _, _ = load_data_and_model(ckpt, {**over, "use_gpu": False})
    if cpu_trainer.device.type != "cpu":
        fail("published: the comparison trainer is not on the CPU")
    check_sampled_paths(trainer2, valid2, cpu_trainer, attrs, card)
    del cpu_trainer

    # labeled evaluation and full-sort GAUC of the same checkpoint
    for mode, metrics, valid_metric, want, path in (
            ("labeled", ["AUC", "LogLoss", "MAE", "RMSE"], "AUC",
             {"auc", "logloss", "mae", "rmse"}, "sampled-host"),
            ("full", ["GAUC", "NDCG", "Hit"], "NDCG@5", {"gauc", "ndcg@5", "hit@5"}, "host")):
        eval_args = {**published_yaml("PFCN_PMF")["eval_args"], "mode": mode}
        _, _, t3, _, _, _, test3 = load_data_and_model(ckpt, {
            **over, "eval_args": eval_args, "metrics": metrics, "valid_metric": valid_metric})
        _require_card_trainer(t3, f"published {mode}", "PFCN_PMF")
        _sync()
        t0 = time.perf_counter()
        res = t3.evaluate(test3)
        _sync()
        took = time.perf_counter() - t0
        if t3._last_eval_path != path:
            fail(f"published {mode}: the evaluation took the path {t3._last_eval_path!r}")
        if list(res) != keys:
            fail(f"published {mode}: keys {list(res)}")
        for key, r in res.items():
            if set(r) != want:
                fail(f"published {mode} {key}: metrics {list(r)}")
            # every one lies in [0, 1] but the log loss, which is finite and >= 0
            _check_metrics(f"published {mode} {key}",
                           {m: v for m, v in r.items() if m != "logloss"})
            if not (math.isfinite(r.get("logloss", 0.0)) and r.get("logloss", 0.0) >= 0):
                fail(f"published {mode} {key}: log loss {r['logloss']}")
        print(f"published: {mode} evaluation of the PFCN_PMF checkpoint, path {path}, "
              f"{took:.3f} s: {res}; {card}", flush=True)

    # FOCF: every train batch holds whole item groups
    seen = {"batches": 0}
    next_batch = FOCFDataLoader._next_batch_data

    def whole_groups(self):
        out = next_batch(self)
        items, counts = np.unique(out[self.iid_field].numpy(), return_counts=True)
        seg = self.item_segments
        if not np.array_equal(counts, seg.rows[np.searchsorted(seg.uid, items)]):
            fail("published FOCF: a train batch holds part of an item's rows")
        seen["batches"] += 1
        return out

    FOCFDataLoader._next_batch_data = whole_groups
    try:
        result, rec, focf, _ = _published_run(
            data_root, work_dir, "FOCF", {"fair_objective": "value", "epochs": 1},
            ["gender"], modules)
    finally:
        FOCFDataLoader._next_batch_data = next_batch
    add(rec)
    steps = -(-rec["examples"][0] // focf.config["train_batch_size"])
    if seen["batches"] != steps:
        fail(f"published FOCF: {seen['batches']} train batches checked, {steps} expected")
    row = _published_row("FOCF", rec, card, train_batches=seen["batches"],
                         epoch_losses=rec["train_epoch_losses"])
    print(f"published: epochs {json.dumps(row)}", flush=True)
    print(f"published: FOCF test {result['test_result']}", flush=True)

    # NFCF: pretrain, then finetune from that checkpoint with users frozen
    result, rec, pre_trainer, _ = _published_run(
        data_root, work_dir, "NFCF", {"epochs": 1}, ["gender"], modules)
    add(rec)
    pre_row = _published_row("NFCF pretrain", rec, card)
    pre_ckpt = pre_trainer.saved_model_file
    pre = load_checkpoint(pre_ckpt)["params"]
    result, rec, fine_trainer, _ = _published_run(
        data_root, work_dir, "NFCF", {"epochs": 1, "load_pretrain_path": pre_ckpt},
        ["gender"], modules)
    add(rec)
    fine = fine_trainer.model
    gender = np.asarray(create_dataset(fine_trainer.config).get_user_feature()["gender"])[1:]
    expected = _debiased_users(pre["user_embedding"], gender)
    got = fine.user_embedding.weight.detach().cpu().numpy()
    if fine.user_embedding.weight.requires_grad or not np.array_equal(got, expected):
        fail("published NFCF: the finetuned user table is not the debiased pretrain table")
    if np.array_equal(fine.item_embedding.weight.detach().cpu().numpy(), pre["item_embedding"]):
        fail("published NFCF: the item table was not re-initialised")
    print(f"published: epochs {json.dumps(pre_row)}", flush=True)
    print(f"published: epochs {json.dumps(_published_row('NFCF finetune', rec, card))}",
          flush=True)
    print(f"published: NFCF finetune test {result['test_result']}; the user table is the "
          f"debiased pretrain table bit for bit, the item table re-initialised", flush=True)
    return launches


def _debiased_users(table, sst_value):
    """NFCF's finetune user table from a pretrain one, recomputed here in
    numpy float32: the difference of the two groups' mean embeddings,
    normalised, projected out of every user row (row 0, PAD, is kept)."""
    table = np.asarray(table, dtype=np.float32)
    users = table[1:].copy()
    groups = np.unique(sst_value)
    e1 = users[sst_value == groups[0]].mean(axis=0)
    e2 = users[sst_value == groups[1]].mean(axis=0)
    direction = (e1 - e2) / np.linalg.norm(e1 - e2)
    out = table.copy()
    out[1:] = users - (users @ direction)[:, None] * direction[None, :]
    return out


def _step_capturing_grads(trainer, batch, loss_name, sst, tag):
    """``trainer._train_step`` with the optimizer of ``tag``; returns the
    loss and the gradients the optimizer stepped with (on the host)."""
    optimizer = trainer._tx_by_tag(tag)
    grads = {}
    step = optimizer.step

    def capture(*args, **kwargs):
        for name, p in trainer.model.named_parameters():
            if p.grad is not None:
                grads[name] = p.grad.detach().cpu().clone()
        return step(*args, **kwargs)

    optimizer.step = capture
    try:
        loss = float(trainer._train_step(batch, loss_name, sst, optimizer))
    finally:
        del optimizer.step
    return loss, grads


def _pre_bn_bias(name):
    """A linear bias of a filter or discriminator: it feeds a BatchNorm, so
    its gradient is analytically 0 and what a device computes is rounding."""
    parts = name.split(".")
    return parts[0] in ("filters", "discriminators") and parts[-3] == "linear" \
        and parts[-1] == "b"


def _float64_grads(model, state, batch, loss_name, sst):
    """The loss and gradients of ``loss_name`` computed in float64 on the CPU
    from ``state`` (float32 tensors); ``model`` is left in float32."""
    model.double().load_state_dict(state)
    model.train()
    model.zero_grad(set_to_none=True)
    loss = getattr(model, loss_name)(dict(batch), sst_list=sst)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.float()
    return float(loss.detach()), grads


def check_adversarial_steps(trainer, train_data, cfg, ckpt, atol=1e-5, loss_rtol=1e-6,
                            grad_factor=4.0, grad_floor=1e-6, max_unheld=0.25):
    """One filter step and one discriminator step over the three attributes
    on the card and on the CPU, on the same batch and negatives, dropout 0,
    from two starting points: the model's seeded initialisation (fresh
    optimizers) and the best checkpoint (its weights, BatchNorm statistics
    and optimizer states). The float64 gradient on the CPU is the reference.

    Limits:
    * losses within ``loss_rtol`` (rel); BatchNorm running statistics within
      ``atol`` (abs);
    * gradients, per tensor the optimizer steps: the card's largest distance
      from the float64 gradient at most ``grad_factor`` times the CPU's
      float32 one plus ``grad_floor`` of the tensor's largest float64
      gradient (the "error bound");
    * parameters within ``atol`` (abs), except the elements whose gradient
      float32 does not resolve: the biases that feed a BatchNorm (gradient
      analytically 0) and the elements the loss reaches (a nonzero gradient
      in float64 or on the CPU) whose float64 gradient is within the error
      bound. Adam steps those by up to ``ADAM_STEP_BOUND`` learning rates
      either way on each device, so they are held within twice that +
      ``atol``. From the initialisation at most ``max_unheld`` of the reached
      elements may be such; from the checkpoint the filters and
      discriminators that the drawn subsets left to weight decay alone have
      collapsed, and nearly all of theirs are (PERF.md, PR 4)."""
    import torch

    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.utils import get_model

    dataset = train_data.dataset
    trainers = []
    for use_gpu in (True, False):
        config = Config(model="PFCN_PMF", dataset=ADV_DATASET,
                        config_dict={**cfg, "use_gpu": use_gpu, "dis_dropout": 0.0})
        trainers.append(type(trainer)(config, get_model("PFCN_PMF")(config, dataset)))
    card, cpu = trainers
    if card.device.type != "cuda" or cpu.device.type != "cpu":
        fail(f"adversarial step: trainers on {card.device} and {cpu.device}")
    model64 = get_model("PFCN_PMF")(cpu.config, dataset)
    init_state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    sst = tuple(ADV_ATTRS)
    card._maybe_enable_device_sampling(train_data)
    interaction = next(iter(train_data))
    train_data.pr = 0
    fields = card.model.loss_batch_fields("calculate_loss", sst)
    batch = card._inject_negatives(card._train_batch(interaction, fields), "calculate_loss")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    noise_atol = 2 * ADAM_STEP_BOUND * cpu.config["learning_rate"] + atol
    buffers = {name for name, _ in cpu.model.named_buffers()}
    for start in ("initialisation", "checkpoint"):
        for loss_name, tag in (("calculate_loss", "filter"), ("calculate_dis_loss", "dis")):
            for t in trainers:
                if start == "initialisation":
                    t.model.load_state_dict(init_state)
                else:
                    t.resume_checkpoint(ckpt)
                t.model.train()
            loss64, g64 = _float64_grads(model64, cpu.model.state_dict(), cpu_batch, loss_name,
                                         sst)
            loss, grads = _step_capturing_grads(card, dict(batch), loss_name, sst, tag)
            cpu_loss, cpu_grads = _step_capturing_grads(cpu, dict(cpu_batch), loss_name, sst,
                                                        tag)
            stepped = {id(p) for group in cpu._tx_by_tag(tag).param_groups
                       for p in group["params"]}
            stepped = {name for name, p in cpu.model.named_parameters() if id(p) in stepped}
            cpu_state = cpu.model.state_dict()
            gaps = dict.fromkeys(("parameters", "bn_statistics", "unheld"), 0.0)
            grad_use, held, n_reached, modules = 0.0, 0, 0, {}
            for name, value in card.model.state_dict().items():
                gap = (value.detach().cpu() - cpu_state[name]).abs()
                if name in buffers:
                    gaps["bn_statistics"] = max(gaps["bn_statistics"], float(gap.max()))
                    continue
                unheld = torch.zeros(gap.shape, dtype=torch.bool)
                if name in stepped:
                    ref = g64.get(name, torch.zeros(value.shape, dtype=torch.float64))
                    scale = float(ref.abs().max())
                    cpu_err = float((cpu_grads[name].double() - ref).abs().max())
                    card_err = float((grads[name].double() - ref).abs().max())
                    bound = grad_factor * cpu_err + grad_floor * scale
                    grad_use = max(grad_use, card_err / bound if bound else float(card_err > 0))
                    if _pre_bn_bias(name):
                        unheld[...] = True
                    else:
                        # reached: a nonzero gradient in float64 or on the CPU
                        reached = (ref != 0) | (cpu_grads[name] != 0)
                        unheld = reached & (ref.abs() <= bound)
                        n_reached += int(reached.sum())
                        if unheld.any():
                            module = ".".join(name.split(".")[:2])
                            entry = modules.setdefault(module, {"unheld": 0, "of": 0, "error": 0.0})
                            entry["unheld"] += int(unheld.sum())
                            entry["of"] += int(reached.sum())
                            entry["error"] = max(entry["error"], float(f"{cpu_err / scale:.3g}"))
                held += int((~unheld).sum())
                gaps["parameters"] = max(gaps["parameters"], float(gap.where(~unheld, 0.0).max()))
                gaps["unheld"] = max(gaps["unheld"], float(gap.where(unheld, 0.0).max()))
            n_unheld = sum(m["unheld"] for m in modules.values())
            for module, entry in modules.items():
                weights = [v.double().flatten() for k, v in cpu_state.items()
                           if k.startswith(module + ".") and k.endswith(".w")]
                entry["weight_rms"] = float(torch.cat(weights).pow(2).mean().sqrt()) \
                    if weights else None
            label = f"adversarial step from the {start}, {tag}"
            print(f"{label}: card loss {loss!r}, CPU loss {cpu_loss!r}, float64 {loss64!r}; "
                  f"largest gaps {json.dumps(gaps)}; card gradient error at most {grad_use:.3f} of "
                  f"its bound; {held} parameter elements held at {atol}; {n_unheld} of the "
                  f"{n_reached} that the loss reaches are within the error bound (by "
                  f"module, with the CPU's largest error over the largest float64 gradient and "
                  f"the RMS of the module's linear weights: {json.dumps(modules)})", flush=True)
            if not math.isfinite(loss) or abs(loss - cpu_loss) > loss_rtol * abs(cpu_loss):
                fail(f"{label}: the card's loss {loss} and the CPU's {cpu_loss} differ")
            if grad_use > 1.0:
                fail(f"{label}: the card's gradient error is {grad_use:.3f} times its bound")
            if gaps["parameters"] > atol or gaps["bn_statistics"] > atol \
                    or gaps["unheld"] > noise_atol:
                fail(f"{label}: card and CPU differ by {gaps}")
            if start == "initialisation" and n_unheld > max_unheld * n_reached:
                fail(f"{label}: {n_unheld} of {n_reached} elements are within the error bound, "
                     f"more than {max_unheld} of them")


def time_adversarial_step_split(trainer, train_data, card, steps=SPLIT_STEPS):
    """A filter step and a discriminator step over the three attributes,
    each over ``steps`` steps of the real loader: the wall time per step
    (host clock, the card synchronised at the end), the host's time in the
    loader, the copy and ``_train_step`` (which returns before the card
    finishes), and the card's busy time per step from the profiler on one
    batch."""
    model = trainer.model
    sst = tuple(ADV_ATTRS)
    trainer._maybe_enable_device_sampling(train_data)
    row = {"steps": steps, "sst_list": list(sst), "card": card}
    model.train()
    for loss_name, tag in (("calculate_loss", "filter"), ("calculate_dis_loss", "dis")):
        optimizer = trainer._tx_by_tag(tag)
        fields = model.loss_batch_fields(loss_name, sst)
        it = iter(train_data)
        for _ in range(5):  # warm-up
            trainer._train_step(trainer._train_batch(next(it), fields), loss_name, sst, optimizer)
        _sync()
        host = 0.0
        t_start = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = trainer._train_batch(next(it), fields)
            loss = trainer._train_step(batch, loss_name, sst, optimizer)
            host += time.perf_counter() - t0
        _sync()
        wall_ms = (time.perf_counter() - t_start) / steps * 1e3
        train_data.pr = 0
        if not math.isfinite(float(loss)):
            fail(f"adversarial step split: the {tag} loss is not finite")
        raw = {k: v for k, v in batch.items() if k != model.NEG_ITEM_ID}
        busy = _device_busy_ms(lambda: trainer._train_step(dict(raw), loss_name, sst, optimizer))
        row[tag] = {"batch": int(batch[model.USER_ID].shape[0]), "wall_ms_per_step": wall_ms,
                    "host_ms_per_step": host / steps * 1e3, "device_busy_ms_per_step": busy,
                    "device_idle_share": 1.0 - busy / wall_ms}
    print(f"adversarial: step split {json.dumps(row)}", flush=True)


def check_negatives(trainer, train_data, card):
    """Negatives drawn on the card: one batch against the host's used-pair
    set, and a histogram of 2^20 draws for the PAD user (no history).

    Uniformity bound: Pearson's chi-square over the n = item_num - 1 items
    has mean n - 1 and standard deviation sqrt(2 (n - 1)); the draws pass
    below the mean plus 6 standard deviations."""
    import torch

    from recbole_fairrec_tpu_torch.ops.neg_sampling import sample_negatives

    trainer._maybe_enable_device_sampling(train_data)
    used = trainer._device_used_keys
    if used is None or used.device.type != "cuda":
        fail("negatives: the used-pair table is not on the card")
    ds = train_data.dataset
    item_num = ds.item_num
    u = np.asarray(ds.inter_feat[ds.uid_field])
    i = np.asarray(ds.inter_feat[ds.iid_field])
    users = torch.as_tensor(u[: train_data.batch_size]).to(trainer.device)
    negs = sample_negatives(trainer.generator, users, used, item_num)
    if negs.device.type != "cuda" or negs.shape != users.shape:
        fail(f"negatives: output on {negs.device} of shape {tuple(negs.shape)}")
    negs = negs.cpu().numpy()
    if negs.min() < 1 or negs.max() >= item_num:
        fail(f"negatives: ids in [{negs.min()}, {negs.max()}], item_num {item_num}")
    used_keys = np.unique(u.astype(np.int64) * item_num + i)
    drawn = users.cpu().numpy().astype(np.int64) * item_num + negs
    if np.isin(drawn, used_keys).any():
        fail("negatives: a drawn pair is a used pair")

    if (u == 0).any():
        fail("negatives: the PAD user has interactions")
    n_draws = 1 << 20
    pad_users = torch.zeros(n_draws, dtype=torch.int64, device=trainer.device)
    draws = sample_negatives(trainer.generator, pad_users, used, item_num)
    counts = torch.bincount(draws, minlength=item_num).cpu().numpy()
    if counts[0] != 0:
        fail("negatives: the PAD item 0 was drawn")
    bins = item_num - 1
    expected = n_draws / bins
    chi2 = float(((counts[1:] - expected) ** 2 / expected).sum())
    bound = (bins - 1) + 6.0 * math.sqrt(2.0 * (bins - 1))
    print(f"negatives: {len(negs)} draws for one batch hit no used pair; {n_draws} draws "
          f"over {bins} items: chi-square {chi2:.1f} (bound {bound:.1f}); {card}", flush=True)
    if chi2 > bound:
        fail(f"negatives: chi-square {chi2:.1f} above {bound:.1f}: the draws are not uniform")


def check_step_card_against_cpu(trainer, train_data, cfg, ckpt,
                                param_atol=1e-5, loss_rtol=1e-6):
    """One train step on the card and one on the CPU from the same weights,
    Adam state (both resume the checkpoint), batch and negatives: parameters
    within ``param_atol`` (abs), losses within ``loss_rtol`` (rel)."""
    from recbole_fairrec_tpu_torch import Config

    cpu_config = Config(model="PFCN_PMF", dataset=DATASET,
                        config_dict={**cfg, "use_gpu": False})
    cpu_trainer = type(trainer)(cpu_config, copy.deepcopy(trainer.model))
    if cpu_trainer.device.type != "cpu":
        fail("step: the comparison trainer is not on the CPU")
    for t in (trainer, cpu_trainer):
        t.resume_checkpoint(ckpt)
        t.model.train()
    interaction = next(iter(train_data))
    train_data.pr = 0
    fields = trainer.model.loss_batch_fields("calculate_loss")
    batch = trainer._inject_negatives(trainer._train_batch(interaction, fields), "calculate_loss")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss = float(trainer._train_step(batch, "calculate_loss", None, trainer.optimizer))
    cpu_loss = float(cpu_trainer._train_step(cpu_batch, "calculate_loss", None,
                                             cpu_trainer.optimizer))
    gap = max(
        float((p.detach().cpu() - q.detach()).abs().max())
        for p, q in zip(trainer.model.parameters(), cpu_trainer.model.parameters())
    )
    print(f"step: card loss {loss!r}, CPU loss {cpu_loss!r}, largest parameter gap {gap:.3e} "
          f"(limits: rel {loss_rtol}, abs {param_atol})", flush=True)
    if not math.isfinite(loss) or abs(loss - cpu_loss) > loss_rtol * abs(cpu_loss):
        fail(f"step: the card's loss {loss} and the CPU's {cpu_loss} differ")
    if not gap <= param_atol:
        fail(f"step: parameters differ by {gap} after one step")


def _device_profile(fn, calls=20):
    """The device time per call of every kernel, copy and fill ``fn``
    launches (``torch.profiler``), by name, in ms. The profiler lists each
    kernel twice, as a device event and again in the self device time of
    the operator that launched it; only the device events count here. A
    user annotation's span on the card (``Optimizer.step#Adam.step``) is a
    device event too, and overlaps the kernels inside it: it does not
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        _sync()
    return {ev.key: ev.self_device_time_total / calls / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)}


def _device_busy_ms(fn, calls=20):
    """The card's busy time per call of ``fn``, without its waits: the sum
    of ``_device_profile``."""
    return sum(_device_profile(fn, calls).values())


def time_step_split(trainer, train_data, card, steps=SPLIT_STEPS):
    """One train step split into its parts over ``steps`` steps of the real
    loader: for each part the span between CUDA events on the card's
    timeline (which holds the card's waits for the host) and the host's time,
    beside the loader's and the copy's host time and the whole step's wall
    time; then the card's busy time per part, from the profiler, on one
    batch. The parts are those of ``Trainer._train_step``, in its order."""
    import torch

    from recbole_fairrec_tpu_torch.ops.neg_sampling import sample_negatives

    model, optimizer = trainer.model, trainer.optimizer
    fields = model.loss_batch_fields("calculate_loss")
    model.train()
    it = iter(train_data)
    for _ in range(5):  # warm-up
        trainer._train_step(trainer._train_batch(next(it), fields), "calculate_loss", None,
                            optimizer)
    marks = []
    host = dict.fromkeys(("loader", "copy", "sample_negatives", "forward_backward", "optimizer"),
                         0.0)
    _sync()
    t_start = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        interaction = next(it)
        t1 = time.perf_counter()
        batch = trainer._train_batch(interaction, fields)
        t2 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        batch = trainer._inject_negatives(batch, "calculate_loss")
        t3 = time.perf_counter()
        ev[1].record()
        loss = model.calculate_loss(batch)
        loss.backward()
        t4 = time.perf_counter()
        ev[2].record()
        optimizer.step()
        t5 = time.perf_counter()
        ev[3].record()
        marks.append(ev)
        for key, dt in zip(host, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            host[key] += dt
    _sync()
    wall_ms = (time.perf_counter() - t_start) / steps * 1e3
    train_data.pr = 0
    if not math.isfinite(float(loss.detach())):
        fail("step split: the loss is not finite")
    parts = ("sample_negatives", "forward_backward", "optimizer")
    span_ms = {part: sum(ev[j].elapsed_time(ev[j + 1]) for ev in marks) / steps
               for j, part in enumerate(parts)}
    host_ms = {key: value / steps * 1e3 for key, value in host.items()}

    users = batch[model.USER_ID]
    used, n_items = trainer._device_used_keys, model.n_items

    def forward_backward():
        optimizer.zero_grad(set_to_none=True)
        model.calculate_loss(batch).backward()

    busy_ms = {
        "sample_negatives": _device_busy_ms(
            lambda: sample_negatives(trainer.generator, users, used, n_items)),
        "forward_backward": _device_busy_ms(forward_backward),
        "optimizer": _device_busy_ms(optimizer.step),
    }
    busy_total = sum(busy_ms.values())
    row = {
        "steps": steps, "batch": int(users.shape[0]), "wall_ms_per_step": wall_ms,
        "host_ms": host_ms, "host_ms_per_step": sum(host_ms.values()),
        "event_span_ms": span_ms, "device_busy_ms": busy_ms,
        "device_busy_ms_per_step": busy_total,
        "device_idle_share": 1.0 - busy_total / wall_ms, "card": card,
    }
    print(f"train: step split {json.dumps(row)}", flush=True)


# ----------------------------------------------------------------- FairGo

FAIRGO_MODELS = ("FairGo_PMF", "FairGo_GCN")
# the published depth is 600 pretrain epochs; one of each stage here, and
# epoch 0 of finetune runs both the filter and the discriminator pass
FAIRGO_DEPTH = {"pretrain_epochs": 1, "epochs": 1}
FAIRGO_SPLIT_STEPS = 40
PEAK_BF16_FLOPS = 989e12  # bfloat16 (and float16) in the tensor cores, dense
# bound of the bfloat16 hop's norm-relative gap from float32, ~2x the reading
# of 1.0159e-3 (PERF.md §6, FairGo)
FAIRGO_BF16_GAP = 2.0 ** -9
# per step kind, the share of the reached elements that may be within the
# gradient's error bound, ~2x the largest reading of FairGo_PMF / FairGo_GCN
# from the seeded initialisation: 3/158,272 and 5/623,008 (pretrain),
# 21/20,736 (filter), 2,936/17,793 (dis; PERF.md §6, FairGo)
FAIRGO_MAX_UNHELD = {"pretrain": 4e-5, "filter": 2e-3, "dis": 0.33}


def fairgo_config(data_root, work_dir, model, extra=None):
    """``model`` with its published YAML unchanged (widths, LBA, vs_weights,
    fair_weight, the uni100 protocol) but for the depth, ``FAIRGO_DEPTH``."""
    return published_config(data_root, work_dir, model, {**FAIRGO_DEPTH, **(extra or {})})


def _fairgo_run(data_root, work_dir, model, modules):
    """One ``run_recbole`` of ``model``, pretrain then finetune on the card,
    with the launch counts set to 0 just before and read just after. Checks
    the trainer (the registry's, every tensor on the card, dense float32
    propagation), the protocol, the passes (pretrain; then filter and
    discriminator over the YAML's attribute), the sampled path of both
    validations and of the test and the ``pretrain-*`` and ``finetune-*``
    metric families; returns (result, record, trainer, cfg)."""
    import torch

    from recbole_fairrec_tpu_torch import run_recbole

    cfg = fairgo_config(data_root, work_dir, model)
    label = f"fairgo {model}"
    for mod in modules.values():
        mod.launches = 0
    with _timed_fit(modules) as rec:
        t0 = time.perf_counter()
        result = run_recbole(model=model, dataset=ADV_DATASET, config_dict=cfg)
        _sync()
        rec["run_recbole_s"] = time.perf_counter() - t0
    rec["launches"] = {name: mod.launches for name, mod in modules.items()}
    if len(rec["trainers"]) != 1:
        fail(f"{label}: run_recbole trained {len(rec['trainers'])} trainers, expected 1")
    trainer = rec["trainers"][0]
    _require_card_trainer(trainer, label, model)
    _check_protocol(label, trainer.config, model)
    attrs = list(trainer.config["sst_attr_list"])
    dense = trainer.model._buffers.get("prop_dense")
    if dense is None or dense.dtype != torch.float32:
        fail(f"{label}: propagation is not dense float32 "
             f"({None if dense is None else dense.dtype})")
    passes = [["pretrain", []], ["filter", attrs], ["dis", attrs]]
    if rec["passes"] != passes:
        fail(f"{label}: the passes were {rec['passes']}, expected {passes}")
    if not all(math.isfinite(x) and x != 0.0 for x in rec["pass_losses"]):
        fail(f"{label}: pass losses {rec['pass_losses']}")
    if rec["train_epoch_losses"] != [tuple(rec["pass_losses"][:0:-1])]:
        fail(f"{label}: finetune epoch losses {rec['train_epoch_losses']}: not (dis, filter)")
    if any(rec["launches"].values()):
        fail(f"{label}: FairGo launched {rec['launches']}")
    if len(rec["valid_s"]) != 2 or len(rec["test_s"]) != 1:
        fail(f"{label}: {len(rec['valid_s'])} validations and {len(rec['test_s'])} tests, "
             "expected one validation per stage and one test")
    for what, path in zip(["validation", "validation", "test"],
                          rec["valid_paths"] + rec["test_paths"]):
        if path != "sampled-fused":
            fail(f"{label}: a {what} took the path {path!r}")
    for epoch, res in enumerate(rec["valid_results"]):
        _check_families(f"{label}: validation {epoch}", res, attrs)
    if result["best_valid_result"] != rec["valid_results"][1]:
        fail(f"{label}: best_valid_result is not the finetune validation's result")
    tests = result["test_result"]
    for stage in ("pretrain", "finetune"):
        half = {k[len(stage) + 1:]: v for k, v in tests.items() if k.startswith(stage + "-")}
        _check_families(f"{label}: test {stage}", half, attrs)
    if len(tests) != 2 * len(rec["valid_results"][0]):
        fail(f"{label}: test keys {list(tests)}")
    return result, rec, trainer, cfg


def _check_fairgo_checkpoints(trainer, label):
    """The pretrain and finetune checkpoints hold the parameters and the
    optimizers' moments, no propagation matrix: no array of n x n elements
    and at most 4 x the parameters' bytes + 1 MiB on disk (the matrix alone
    is n^2 x 4 bytes). Returns the sizes."""
    from recbole_fairrec_tpu_torch.quick_start import load_checkpoint

    model = trainer.model
    n = model.n_users + model.n_items
    params_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    limit = 4 * params_bytes + (1 << 20)
    sizes = {"params_bytes": params_bytes, "matrix_bytes": n * n * 4, "limit": limit}

    def arrays(node):
        if isinstance(node, np.ndarray):
            yield node
        elif isinstance(node, dict):
            for v in node.values():
                yield from arrays(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from arrays(v)

    for stage, path in (("pretrain", trainer.saved_pretrain_model_file),
                        ("finetune", trainer.saved_model_file)):
        size = os.path.getsize(path)
        checkpoint = load_checkpoint(path)
        if checkpoint["model_state"] != {} or checkpoint.get("train_stage") != stage:
            fail(f"{label}: the {stage} checkpoint has state {list(checkpoint['model_state'])} "
                 f"and stage {checkpoint.get('train_stage')!r}")
        if size > limit or any(a.size >= n * n for a in arrays(checkpoint)):
            fail(f"{label}: the {stage} checkpoint ({size} bytes) holds a propagation matrix")
        sizes[f"{stage}_bytes"] = size
    return sizes


def _fairgo_read_back(trainer, cfg, result, rec, label, model):
    """The finetune checkpoint through ``load_data_and_model`` (the pretrain
    one as ``pretrain_model_file_path``), then ``evaluate`` from numpy's
    state at the start of run_recbole's test: the same dict."""
    from recbole_fairrec_tpu_torch import load_data_and_model

    _, _, trainer2, _, train2, _, test2 = load_data_and_model(trainer.saved_model_file, {
        "log_root": cfg["log_root"],
        "pretrain_model_file_path": trainer.saved_pretrain_model_file})
    _require_card_trainer(trainer2, f"{label} read-back", model)
    if trainer2.model.train_stage != "finetune":
        fail(f"{label} read-back: the stage is {trainer2.model.train_stage!r}")
    np.random.set_state(rec["test_rng"][0])
    back = trainer2.evaluate(test2)
    if dict(back) != dict(result["test_result"]):
        fail(f"{label}: the checkpoints read back give {back}, run_recbole gave "
             f"{result['test_result']}")
    return trainer2, train2, test2


def _fairgo_attrs(trainer):
    return tuple(trainer.config["sst_attr_list"])


FAIRGO_STEPS = (("pretrain", "calculate_loss", "pretrain"),
                ("finetune", "calculate_loss", "filter"),
                ("finetune", "calculate_dis_loss", "dis"))


def check_fairgo_steps(trainer, train_data, cfg, model, atol=1e-5, loss_rtol=1e-5,
                       grad_factor=4.0, grad_floor=1e-6, max_unheld=FAIRGO_MAX_UNHELD):
    """A pretrain step, a filter step and a discriminator step (over the
    YAML's attributes) on the card and on the CPU from the seeded
    initialisation (``gcn_dropout`` 0), each step from the same parameters
    on both (the card's are copied to the CPU before it) and the same
    batch. The float64 gradient on the CPU is the reference.

    Limits: losses within ``loss_rtol`` (rel; float32 sums over up to
    9,671 terms per hop in other orders); per stepped tensor the card's
    largest distance from the float64 gradient at most ``grad_factor``
    times the CPU's float32 one plus ``grad_floor`` of the tensor's largest
    float64 gradient (the "error bound"); parameters within ``atol`` (abs),
    except the elements the loss reaches whose float64 gradient is within
    the error bound: Adam's first step moves those by up to
    ``ADAM_STEP_BOUND`` learning rates either way on each device, so they
    are held within twice that + ``atol``, and at most ``max_unheld[tag]``
    of the reached elements may be such."""
    import torch

    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.utils import get_model

    dataset = train_data.dataset
    trainers = []
    for use_gpu in (True, False):
        config = Config(model=model, dataset=ADV_DATASET,
                        config_dict={**cfg, "use_gpu": use_gpu, "gcn_dropout": 0.0})
        built = get_model(model)(config, dataset, generator=torch.Generator().manual_seed(0))
        trainers.append(type(trainer)(config, built))
    card, cpu = trainers
    if card.device.type != "cuda" or cpu.device.type != "cpu":
        fail(f"fairgo step: trainers on {card.device} and {cpu.device}")
    _require_card_trainer(card, f"fairgo {model} step", model)
    model64 = get_model(model)(cpu.config, dataset)
    sst = _fairgo_attrs(card)
    interaction = next(iter(train_data))
    train_data.pr = 0
    noise_atol = 2 * ADAM_STEP_BOUND * cpu.config["learning_rate"] + atol
    rows = {}
    for stage, loss_name, tag in FAIRGO_STEPS:
        subset = None if stage == "pretrain" else sst
        fields = card.model.loss_batch_fields(loss_name, subset)
        batch = card._train_batch(interaction, fields)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
        for m in (card.model, cpu.model, model64):
            m.train_stage = stage
        loss64, g64 = _float64_grads(model64, cpu.model.state_dict(), cpu_batch, loss_name,
                                     subset)
        loss, grads = _step_capturing_grads(card, dict(batch), loss_name, subset, tag)
        cpu_loss, cpu_grads = _step_capturing_grads(cpu, cpu_batch, loss_name, subset, tag)
        if set(grads) != set(cpu_grads) or not grads:
            fail(f"fairgo {model} {tag} step: gradients of {sorted(grads)} on the card, "
                 f"{sorted(cpu_grads)} on the CPU")
        groups = card.model.param_groups()[tag]
        if any(name.split(".")[0] not in groups for name in grads):
            fail(f"fairgo {model} {tag} step: gradients outside the group {groups}")
        cpu_state = cpu.model.state_dict()
        grad_use, gap, unheld_gap, n_unheld, n_reached = 0.0, 0.0, 0.0, 0, 0
        for name, value in card.model.state_dict().items():
            diff = (value.detach().cpu() - cpu_state[name]).abs()
            unheld = torch.zeros(diff.shape, dtype=torch.bool)
            if name in grads:
                ref = g64[name]
                scale = float(ref.abs().max())
                cpu_err = float((cpu_grads[name].double() - ref).abs().max())
                card_err = float((grads[name].double() - ref).abs().max())
                bound = grad_factor * cpu_err + grad_floor * scale
                grad_use = max(grad_use, card_err / bound if bound else float(card_err > 0))
                reached = (ref != 0) | (cpu_grads[name] != 0)
                unheld = reached & (ref.abs() <= bound)
                n_reached += int(reached.sum())
                n_unheld += int(unheld.sum())
            gap = max(gap, float(diff.where(~unheld, 0.0).max()))
            unheld_gap = max(unheld_gap, float(diff.where(unheld, 0.0).max()))
        rows[tag] = {"loss": loss, "cpu_loss": cpu_loss, "float64_loss": loss64,
                     "gradient_error_of_bound": grad_use, "parameter_gap": gap,
                     "unheld_elements": n_unheld, "reached_elements": n_reached,
                     "unheld_share": n_unheld / n_reached, "unheld_gap": unheld_gap}
        label = f"fairgo {model} {tag} step"
        if not math.isfinite(loss) or abs(loss - cpu_loss) > loss_rtol * abs(cpu_loss):
            fail(f"{label}: the card's loss {loss} and the CPU's {cpu_loss} differ")
        if grad_use > 1.0:
            fail(f"{label}: the card's gradient error is {grad_use:.3f} times its bound")
        if gap > atol or unheld_gap > noise_atol or n_unheld > max_unheld[tag] * n_reached:
            fail(f"{label}: card and CPU differ: {rows[tag]}")
    print(f"fairgo: {model} steps card vs CPU {json.dumps(rows)}", flush=True)


def check_fairgo_propagation(trainer, train_data, cfg, model, card):
    """On one finetune batch of the read-back trainer (card): one hop through
    the dense float32 matrix against the COO form, within the float32 bound
    of each row's sum in another order (2 x degree x 2^-24 x sum |a x|);
    the discriminator loss of a ``dense_propagation: False`` model (the
    same weights) within 1e-5 (rel) of the dense model's; a
    ``propagation_dtype: bfloat16`` model's two hops: each a float32 result,
    not rounded to bfloat16, within the float32 bound of each element's sum
    in another order (2 x n x 2^-24 x sum |a x|; the products are exact) of
    the same hop on the CPU from the same input (bfloat16 operands widened
    to float32), and within ``FAIRGO_BF16_GAP`` (norm-relative) of the
    float32 hops; and one filter step of it that gives finite gradients."""
    import torch

    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.ops.spmm import propagate
    from recbole_fairrec_tpu_torch.utils import get_model

    m = trainer.model
    m.train_stage = "finetune"
    sst = _fairgo_attrs(trainer)
    n = m.n_users + m.n_items
    interaction = next(iter(train_data))
    train_data.pr = 0
    fields = m.loss_batch_fields("calculate_dis_loss", sst)
    batch = trainer._train_batch(interaction, fields)
    row = {"n": n, "edges": int(m.norm_rows.numel()), "card": card}
    with torch.no_grad():
        x = torch.cat(m.forward(sst))
        dense_hop = propagate(x, m.norm_rows, m.norm_cols, m.norm_vals, n, dense=m.prop_dense)
        coo_hop = propagate(x, m.norm_rows, m.norm_cols, m.norm_vals, n)
        degree = torch.bincount(m.norm_rows, minlength=n).double()[:, None]
        bound = 2 * degree * 2.0 ** -24 * (m.prop_dense.abs() @ x.abs()).double()
        err = (dense_hop - coo_hop).abs().double()
        row["dense_vs_coo_max_abs"] = float(err.max())
        row["dense_vs_coo_of_bound"] = float((err / bound.clamp_min(1e-30)).max())
        if bool((err > bound).any()):
            fail(f"fairgo propagation: dense and COO hops differ by {float(err.max())}")
        dense_loss = float(m.calculate_dis_loss(batch, sst_list=sst))
    state = m.state_dict()
    others = {}
    for key, extra in (("coo", {"dense_propagation": False}),
                       ("bf16", {"propagation_dtype": "bfloat16"})):
        config = Config(model=model, dataset=ADV_DATASET, config_dict={**cfg, **extra})
        other = get_model(model)(config, train_data.dataset)
        other.load_state_dict(state)
        others[key] = type(trainer)(config, other)
        _require_card_trainer(others[key], f"fairgo propagation {key}", model)
        others[key].model.train_stage = "finetune"
    coo_model, bf16_model = others["coo"].model, others["bf16"].model
    if "prop_dense" in coo_model._buffers or bf16_model.prop_dense.dtype != torch.bfloat16:
        fail("fairgo propagation: the COO or bfloat16 model has the wrong matrix")
    with torch.no_grad():
        coo_loss = float(coo_model.calculate_dis_loss(batch, sst_list=sst))
        row["dis_loss_dense"], row["dis_loss_coo"] = dense_loss, coo_loss
        if abs(dense_loss - coo_loss) > 1e-5 * abs(dense_loss):
            fail(f"fairgo propagation: dis loss {dense_loss} dense, {coo_loss} COO")
        dense16 = bf16_model.prop_dense
        dense16_cpu = dense16.cpu()
        h32, h16 = x, x
        gaps, of_bound = [], []
        for _ in range(m.n_layers):
            h32 = propagate(h32, None, None, None, n, dense=m.prop_dense)
            x16 = h16.to(torch.bfloat16)
            cpu_hop = propagate(h16.cpu(), None, None, None, n, dense=dense16_cpu)
            h16 = propagate(h16, None, None, None, n, dense=dense16)
            if h16.dtype != torch.float32 or torch.equal(h16, h16.to(torch.bfloat16).float()):
                fail(f"fairgo propagation: the bfloat16 hop returns {h16.dtype}, rounded")
            bound = 2 * n * 2.0 ** -24 * propagate(x16.float().abs(), None, None, None, n,
                                                   dense=dense16.float().abs())
            err = (h16 - cpu_hop.to(h16.device)).abs()
            of_bound.append(float((err / bound.clamp_min(1e-30)).max()))
            if bool((err > bound).any()):
                fail(f"fairgo propagation: the bfloat16 hop on the card differs from the "
                     f"CPU's by {float(err.max())}")
            gaps.append(float((h16 - h32).norm() / h32.norm()))
        row["bf16_card_vs_cpu_of_bound"] = of_bound
        row["bf16_hop_gaps"] = gaps
        row["bf16_dis_loss"] = float(bf16_model.calculate_dis_loss(batch, sst_list=sst))
    if not max(gaps) <= FAIRGO_BF16_GAP:
        fail(f"fairgo propagation: bfloat16 hops part from float32 by {gaps}")
    t16 = others["bf16"]
    loss, grads = _step_capturing_grads(t16, dict(batch), "calculate_loss", sst, "filter")
    row["bf16_filter_loss"] = loss
    if not math.isfinite(loss) or not grads or \
            not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        fail(f"fairgo propagation: the bfloat16 filter step gives loss {loss}")
    print(f"fairgo: propagation {json.dumps(row)}", flush=True)


def time_fairgo_step_split(trainer, train_data, card, model, steps=FAIRGO_SPLIT_STEPS):
    """A pretrain, a filter and a discriminator step, each over ``steps``
    steps of the real loader: the wall time per step (host clock, the card
    synchronised at the end), the host's time in the loader, the copy and
    ``_train_step``, and the card's busy time per step from the profiler on
    one batch (``time_adversarial_step_split``'s way)."""
    m = trainer.model
    sst = _fairgo_attrs(trainer)
    row = {"model": model, "steps": steps, "card": card}
    m.train()
    for stage, loss_name, tag in FAIRGO_STEPS:
        m.train_stage = stage
        subset = None if stage == "pretrain" else sst
        optimizer = trainer._tx_by_tag(tag)
        fields = m.loss_batch_fields(loss_name, subset)
        it = iter(train_data)
        for _ in range(3):  # warm-up
            trainer._train_step(trainer._train_batch(next(it), fields), loss_name, subset,
                                optimizer)
        _sync()
        host = 0.0
        t_start = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = trainer._train_batch(next(it), fields)
            loss = trainer._train_step(batch, loss_name, subset, optimizer)
            host += time.perf_counter() - t0
        _sync()
        wall_ms = (time.perf_counter() - t_start) / steps * 1e3
        train_data.pr = 0
        if not math.isfinite(float(loss)):
            fail(f"fairgo step split: the {tag} loss is not finite")
        kernels = _device_profile(
            lambda: trainer._train_step(dict(batch), loss_name, subset, optimizer), calls=10)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        row[tag] = {"batch": int(batch[m.USER_ID].shape[0]), "wall_ms_per_step": wall_ms,
                    "host_ms_per_step": host / steps * 1e3, "device_busy_ms_per_step": busy,
                    "device_idle_share": 1.0 - busy / wall_ms, "kernels": len(kernels),
                    "top_kernels_ms": [[name[:60], ms] for name, ms in top]}
    print(f"fairgo: step split {json.dumps(row)}", flush=True)


def time_fairgo_hop(model, card):
    """One propagation hop of ``model``'s matrix over a seeded [n, d] table
    through the port's ``propagate``: the dense float32 product (cuBLAS,
    TF32 off) and the bfloat16 one (``torch.mm(..., out_dtype=float32)``
    after casting the table), each against its bound: the larger of its
    operations over the card's peak for their type and its bytes (each
    input read once, the output written once) over the memory rate."""
    import torch

    from recbole_fairrec_tpu_torch.ops.spmm import propagate

    n = model.n_users + model.n_items
    d = model.embedding_size
    gen = torch.Generator(device="cuda").manual_seed(2020)
    x = torch.randn((n, d), generator=gen, device="cuda")
    ops = 2.0 * n * n * d
    routes = {
        "f32": (model.prop_dense, ops / PEAK_F32_FLOPS,
                (4.0 * n * n + 8.0 * n * d) / PEAK_BYTES),
        "bf16": (model.prop_dense.to(torch.bfloat16), ops / PEAK_BF16_FLOPS,
                 (2.0 * n * n + 8.0 * n * d) / PEAK_BYTES),
    }
    row = {"n": n, "d": d, "card": card}
    for name, (matrix, ops_s, bytes_s) in routes.items():
        def hop(matrix=matrix):
            return propagate(x, None, None, None, n, dense=matrix)
        ms = _median_ms(hop)
        bound_ms = max(ops_s, bytes_s) * 1e3
        row[name] = {"ms": ms, "ms_back_to_back": _median_ms(hop, calls=10),
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                     "share_of_bound": bound_ms / ms}
    print(f"fairgo: hop {json.dumps(row)}", flush=True)


def fairgo(data_root, work_dir, card):
    """Phase 8: FairGo_PMF and FairGo_GCN with their published YAMLs, one
    pretrain and one finetune epoch each, through ``run_recbole`` on the
    card (dense float32 propagation): the checks of ``_fairgo_run``, the
    checkpoints' contents, the checkpoints read back, one step of each kind
    on the card against the CPU, the propagation forms (FairGo_PMF) and the
    timings: seconds per pretrain epoch, finetune epoch, validation and
    test, the split of each step kind, and one hop against its bound.
    Returns the kernels' launch counts of its runs (FairGo launches none)."""
    import torch

    modules = {k["name"]: _kernel_module(k) for k in KERNELS}
    launches = dict.fromkeys(modules, 0)
    hop_model = None
    for model in FAIRGO_MODELS:
        label = f"fairgo {model}"
        result, rec, trainer, cfg = _fairgo_run(data_root, work_dir, model, modules)
        for name, count in rec["launches"].items():
            launches[name] += count
        sizes = _check_fairgo_checkpoints(trainer, label)
        pretrain_s = [s for s, p in zip(rec["epoch_s"], rec["passes"]) if p[0] == "pretrain"]
        kinds = ("pretrain", "filter", "dis")
        row = _published_row(model, rec, card, pretrain_epoch_s=pretrain_s,
                             finetune_epoch_s=rec["train_epoch_s"],
                             pass_s=dict(zip(kinds, rec["epoch_s"])),
                             pass_losses=dict(zip(kinds, rec["pass_losses"])),
                             checkpoints=sizes)
        print(f"fairgo: epochs {json.dumps(row)}", flush=True)
        print(f"fairgo: {model} test {result['test_result']}", flush=True)
        trainer2, train2, test2 = _fairgo_read_back(trainer, cfg, result, rec, label, model)
        print(f"fairgo: {model} checkpoints read back give the same test dict", flush=True)
        check_no_sync_in_collect(f"fairgo: {model} deferred evaluate(test)", trainer2,
                                 lambda: trainer2.evaluate(test2, load_best_model=False))
        del trainer
        check_fairgo_steps(trainer2, train2, cfg, model)
        if model == "FairGo_PMF":
            check_fairgo_propagation(trainer2, train2, cfg, model, card)
            hop_model = trainer2.model
        time_fairgo_step_split(trainer2, train2, card, model)
        del trainer2
        torch.cuda.empty_cache()
    time_fairgo_hop(hop_model, card)
    return launches


# ------------------------------------------------------------ resident epochs

# the resident equality check: a wrong row, a pad row counted or a lost
# negative moves the loss by ~1/2048 relative and a parameter by ~lr = 1e-3
RESIDENT_LOSS_RTOL, RESIDENT_PARAM_ATOL = 1e-5, 1e-4


def _real_row_batches(train_data, fields, perm, negs):
    """The real rows of each resident batch (``perm`` cut into batches), in
    its order, with its negatives: what the per-step path takes for the same
    steps."""
    import torch

    from recbole_fairrec_tpu_torch.data.interaction import Interaction

    ds = train_data.dataset
    n, batch = len(ds), train_data.batch_size
    joined = ds[0:n]
    out = []
    for rows, neg in zip(perm.reshape(-1, batch), negs.reshape(-1, batch)):
        keep = rows < n
        cols = {f: joined[f][torch.from_numpy(rows[keep])] for f in fields}
        cols["neg_item_id"] = torch.from_numpy(neg[keep])
        out.append(Interaction(cols))
    return out


def _param_gap(a, b):
    theirs = b.model.state_dict()
    return max(float((v.detach().cpu() - theirs[k].detach().cpu()).abs().max())
               for k, v in a.model.state_dict().items())


def check_resident_epoch(trainer, train_data, cfg, ckpt, card):
    """From the checkpoint (weights and Adam state): one resident epoch on
    the card with an injected permutation and negatives, the card's per-step
    path over the real rows of the same batches, and the CPU's resident
    epoch on the same injections. Losses within ``RESIDENT_LOSS_RTOL`` (rel),
    parameters within ``RESIDENT_PARAM_ATOL`` (abs)."""
    from recbole_fairrec_tpu_torch import Config

    cpu_config = Config(model="PFCN_PMF", dataset=DATASET, config_dict={**cfg, "use_gpu": False})
    trainers = {"resident": trainer,
                "per_step": type(trainer)(trainer.config, copy.deepcopy(trainer.model)),
                "cpu_resident": type(trainer)(cpu_config, copy.deepcopy(trainer.model))}
    if trainers["cpu_resident"].device.type != "cpu":
        fail("resident: the comparison trainer is not on the CPU")
    for t in trainers.values():
        t.resume_checkpoint(ckpt)
    n = len(train_data.dataset)
    batch = train_data.batch_size
    n_pad = -(-n // batch) * batch
    rng = np.random.RandomState(7)
    perm = rng.permutation(n_pad)
    negs = rng.randint(1, train_data.dataset.item_num, n_pad)
    fields = set(trainer.model.loss_batch_fields("calculate_loss")) - {"neg_item_id",
                                                                      "__weight__"}
    losses, seconds = {}, {}
    for name, t in trainers.items():
        t0 = time.perf_counter()
        if name == "per_step":
            losses[name] = t._run_epoch(_real_row_batches(train_data, fields, perm, negs))
        else:
            losses[name] = t._run_epoch_resident(train_data, perm=perm, negatives=negs)
        if t.device.type == "cuda":
            _sync()
        seconds[name] = time.perf_counter() - t0
    gaps = {"per_step": _param_gap(trainer, trainers["per_step"]),
            "cpu_resident": _param_gap(trainer, trainers["cpu_resident"])}
    row = {"steps": n_pad // batch, "pad_rows": n_pad - n, "losses": losses,
           "param_gap": gaps, "seconds": seconds,
           "limits": {"loss_rtol": RESIDENT_LOSS_RTOL, "param_atol": RESIDENT_PARAM_ATOL},
           "card": card}
    print(f"resident: injected epoch {json.dumps(row)}", flush=True)
    for other in ("per_step", "cpu_resident"):
        if not abs(losses["resident"] - losses[other]) <= RESIDENT_LOSS_RTOL * abs(losses[other]):
            fail(f"resident: the card's resident epoch loss {losses['resident']} and the "
                 f"{other} loss {losses[other]} differ")
        if not gaps[other] <= RESIDENT_PARAM_ATOL:
            fail(f"resident: parameters differ from the {other} epoch's by {gaps[other]}")


def time_resident_epochs(trainer, train_data, card):
    """Per-step and resident epochs of the same trainer in turns (per-step,
    resident, resident, per-step), each timed on the host clock to the
    card's synchronisation; then one epoch of each under the profiler: the
    card's busy time and its idle share of the epoch."""
    def epoch(resident):
        trainer.config["device_epoch_shuffle"] = resident
        return trainer._run_epoch(train_data)

    walls = {"per_step": [], "resident": []}
    try:
        for resident in (False, True, True, False):
            _sync()
            t0 = time.perf_counter()
            loss = epoch(resident)
            _sync()
            walls["resident" if resident else "per_step"].append(time.perf_counter() - t0)
            if not math.isfinite(loss):
                fail(f"resident: an epoch's loss is {loss}")
        busy = {mode: _device_busy_ms(lambda: epoch(mode == "resident"), calls=1) / 1e3
                for mode in walls}
    finally:
        trainer.config["device_epoch_shuffle"] = True
    steps = len(train_data)
    row = {"steps_per_epoch": steps, "epoch_s": walls,
           "step_ms": {m: statistics.mean(w) / steps * 1e3 for m, w in walls.items()},
           "device_busy_s_per_epoch": busy,
           "device_idle_share": {m: 1.0 - busy[m] / statistics.mean(w) for m, w in walls.items()},
           "card": card}
    print(f"resident: epochs side by side {json.dumps(row)}", flush=True)
    return row


def check_certified_topk(U, T, k, card):
    """``certified_topk_scores`` and ``approx_topk_scores`` on the serving
    inputs go through the kernel (one launch each) and agree with the plain
    version as ``check_fused_topk`` says; every row is certified."""
    import torch

    from recbole_fairrec_tpu_torch.ops import fused_topk
    from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores

    before = fused_topk.launches
    s, i = certified_topk_scores(U, T, k)
    _, i2, certified = approx_topk_scores(U, T, k, verify=True)
    _sync()
    if fused_topk.launches != before + 2:
        fail(f"certified top-k: {fused_topk.launches - before} kernel launches, expected 2")
    if not bool(certified.all()) or certified.device.type != "cuda":
        fail("certified top-k: a row is not certified")
    if not torch.equal(i, i2):
        fail("certified top-k: the certified and approximate selections differ")
    s_p, i_p = fused_topk.fused_topk_scores_reference(U, T, k)
    err, n_near = _compare_topk("certified", U, T, k, s, i, s_p, i_p)
    print(f"resident: certified_topk_scores on the serving inputs (B {U.shape[0]}, I "
          f"{T.shape[0]}, d {U.shape[1]}, k' {k}) through the kernel: max_abs_err {err}, "
          f"near-tie swaps {n_near}, every row certified; {card}", flush=True)


def resident(data_root, work_dir, card, serving, extra_cfg=None):
    """Phase 9: resident epochs (``device_epoch_shuffle``) on the main path.
    ``run_recbole`` of BPR-MF at bench.py's settings with resident epochs, 3
    epochs, streaming validation and test through the kernel (launch counts
    set to 0 before and read after); the losses fall; an injected resident
    epoch on the card equals the card's per-step path and the CPU's resident
    epoch; per-step and resident epochs side by side; one PFCN_PMF ``sm``
    resident epoch (filter + discriminators) at the YAML's widths; a 2-trial
    exhaustive search over the learning rate at 1 epoch; the certified top-k
    on ``serving`` (U, T, k'). Returns the kernels' launch counts of its
    main path."""
    from recbole_fairrec_tpu_torch import objective_function
    from recbole_fairrec_tpu_torch.trainer.hyper_tuning import HyperTuning

    _, rec, trainer, cfg, launches = _bpr_run(
        data_root, work_dir, card, "resident", {"device_epoch_shuffle": True, **(extra_cfg or {})})
    train_data = rec["train_data"][0]
    if trainer._resident_cache is None or not train_data.device_neg_sampling:
        fail("resident: the epochs did not run resident")

    check_resident_epoch(trainer, train_data, cfg, trainer.saved_model_file, card)
    time_resident_epochs(trainer, train_data, card)

    # PFCN_PMF sm: one resident filter + discriminator epoch at the YAML's widths
    _, arec, alaunches, atrainer = _adversarial_run(
        data_root, os.path.join(work_dir, "adversarial"), "PFCN_PMF",
        {"epochs": 1, "device_epoch_shuffle": True, **(extra_cfg or {})}, "streaming-kernel")
    if atrainer._resident_cache is None:
        fail("resident PFCN_PMF: the passes did not run resident")
    for name, n in alaunches.items():
        launches[name] += n
    print(f"resident: PFCN_PMF sm over {ADV_ATTRS}, 1 resident epoch: passes "
          f"{json.dumps(arec['passes'])} in {json.dumps(arec['epoch_s'])} s, losses "
          f"{arec['train_epoch_losses']}; launches {alaunches}; {card}", flush=True)

    # the hyper-parameter search: 2 trials of 1 resident epoch each
    base = {**cfg, "model": "PFCN_PMF", "dataset": DATASET, "epochs": 1,
            "save_sst_embed": False}
    t0 = time.perf_counter()
    hp = HyperTuning(lambda c, files: objective_function({**base, **c}, files, saved=False),
                     params_dict={"choice": {"learning_rate": [0.001, 0.005]}},
                     algo="exhaustive")
    hp.run()
    _sync()
    if list(hp.params2result) != ["learning_rate:0.001", "learning_rate:0.005"]:
        fail(f"resident: the search ran {list(hp.params2result)}")
    for params, res in hp.params2result.items():
        _check_metrics(f"resident: search trial {params}", res["test_result"]["none"])
    print(f"resident: exhaustive search over learning_rate, 2 trials in "
          f"{time.perf_counter() - t0:.3f} s; best {hp.best_params} score {hp.best_score}; "
          f"{card}", flush=True)

    check_certified_topk(*serving, card)
    return launches


PARALLEL_SHARDS = 4  # item shards of the serving table in the parallel phase
PARALLEL_EPOCHS = 2
FAIRGO_NODES = 9671  # FairGo's graph at ml-1M scale: 6,041 user + 3,630 item rows


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _shard_row(mod, U, shard, k, col0, card, reps=20):
    """The kernel's shard mode on one item shard against its plain version,
    and its times beside the plain version's, ``topk(matmul)`` on the same
    shard and the bound."""
    import torch

    def kernel():
        return mod.fused_topk_scores(U, shard, k, col_offset=col0, mask_pad=False)

    def plain():
        return mod.fused_topk_scores_reference(U, shard, k, col_offset=col0, mask_pad=False)

    def library():
        return torch.topk(torch.matmul(U, shard.T), k, dim=1)

    s_k, i_k = kernel()
    s_p, i_p = plain()
    err, n_near = _compare_topk("shard", U, shard, k, s_k, i_k, s_p, i_p, pad_masked=False,
                                col_offset=col0)
    bound, bound_by = _bound_ms(U, shard, k)
    return {
        "label": "shard", "B": U.shape[0], "I": shard.shape[0], "d": U.shape[1], "k": k,
        "col_offset": col0,
        "max_abs_err": err, "near_tie_swaps": n_near, "ms": _median_ms(kernel, reps),
        "ms_back_to_back": _median_ms(kernel, reps, calls=10),
        "plain_ms": _median_ms(plain, max(reps // 4, 3)), "library_ms": _median_ms(library, reps),
        "bound_ms": bound, "bound_by": bound_by, "card": card,
    }


def parallel(data_root, work_dir, card, serving):
    """Phase 10: the parallel layer on the one card, a world of one NCCL rank
    started by ``init_multihost``: BPR-MF through ``run_recbole`` without a
    mesh and over ``mesh_shape: [1, 1]`` (collectives over one rank are
    identities, so the losses and dicts must be equal); the item-sharded
    top-k over the world of one; the serving table cut into PARALLEL_SHARDS
    shards through the kernel's shard mode and merged, against the plain
    version over the whole table; ``sharded_propagate`` at FairGo's n and
    the exchange lookup against their single-device forms. The launch
    counts are set to 0 just before the meshed run and read after the
    distributed top-k. Returns (launches, the shard row)."""
    import torch
    import torch.distributed as dist

    from recbole_fairrec_tpu_torch.ops.spmm import propagate
    from recbole_fairrec_tpu_torch.ops.topk import streaming_topk_scores
    from recbole_fairrec_tpu_torch.parallel import (
        bucket_allgather_lookup,
        distributed_topk_scores,
        local_candidates,
        merge_candidates,
        pad_table_rows,
        shard_propagation_matrix,
        shard_table,
        sharded_propagate,
    )
    from recbole_fairrec_tpu_torch.quick_start import init_multihost

    ok = init_multihost({"multihost": True, "coordinator_address": f"localhost:{_free_port()}",
                         "num_processes": 1, "process_id": 0})
    if not ok or dist.get_backend() != "nccl" or torch.cuda.current_device() != 0:
        fail(f"parallel: init_multihost gave backend {dist.get_backend()} on "
             f"cuda:{torch.cuda.current_device()}, expected nccl on cuda:0")
    print(f"parallel: world of {dist.get_world_size()} ({dist.get_backend()}, cuda:0); {card}",
          flush=True)
    mod = _kernel_module(KERNELS[0])
    try:
        extra = {"epochs": PARALLEL_EPOCHS}
        ref, ref_rec, ref_trainer, _, _ = _bpr_run(data_root, work_dir, card,
                                                   "parallel: meshless", extra)
        res, rec, trainer, _, launches = _bpr_run(data_root, work_dir, card,
                                                  "parallel: mesh [1, 1]",
                                                  {**extra, "mesh_shape": [1, 1]})
        mesh = trainer.mesh
        if mesh is None or mesh.shape != {"data": 1, "model": 1} or \
                set(trainer.model.row_shards) != {"user_embedding", "item_embedding"}:
            fail(f"parallel: the meshed trainer has mesh {mesh} and shards "
                 f"{trainer.model.row_shards}")
        U, T, k = serving
        table, n_valid = pad_table_rows(T, PARALLEL_SHARDS)
        before = mod.launches
        s_w, i_w = distributed_topk_scores(mesh, U, shard_table(mesh, table), k,
                                           valid_rows=n_valid)
        torch.cuda.synchronize()
        launches = {name: count + mod.launches - before for name, count in launches.items()}
        if ref_trainer.train_loss_dict != trainer.train_loss_dict:
            fail(f"parallel: losses {trainer.train_loss_dict} over the mesh, "
                 f"{ref_trainer.train_loss_dict} without")
        for key in ("test_result", "best_valid_result"):
            if json.dumps(res[key], sort_keys=True) != json.dumps(ref[key], sort_keys=True):
                fail(f"parallel: {key} {res[key]} over the mesh, {ref[key]} without")
        print(f"parallel: mesh [1, 1] = meshless: losses {trainer.train_loss_dict}; "
              f"epochs {rec['epoch_s']} s against {ref_rec['epoch_s']} s; {card}", flush=True)

        # the shards through the kernel's shard mode, merged, against the
        # plain version over the whole table (PAD not masked)
        s_p, i_p = streaming_topk_scores(U, T, k, mask_pad=False)
        rows = table.shape[0] // PARALLEL_SHARDS
        parts = [local_candidates(U, table[j * rows:(j + 1) * rows], k, j * rows, n_valid)
                 for j in range(PARALLEL_SHARDS)]
        s_m, i_m = merge_candidates([p[0] for p in parts], [p[1] for p in parts], k,
                                    table.shape[0])
        err_m, near_m = _compare_topk("4 shards merged", U, T, k, s_m, i_m, s_p, i_p,
                                      pad_masked=False)
        err_w, near_w = _compare_topk("world of one", U, T, k, s_w, i_w, s_p, i_p,
                                      pad_masked=False)
        row = _shard_row(mod, U, table[rows:2 * rows].contiguous(), k, rows, card)
        row.update(merged_max_abs_err=err_m, merged_near_tie_swaps=near_m,
                   world_max_abs_err=err_w, world_near_tie_swaps=near_w)
        print(f"kernel: fused_topk {json.dumps(row)}", flush=True)

        gen = torch.Generator(device="cuda").manual_seed(2020)
        a = torch.rand((FAIRGO_NODES, FAIRGO_NODES), generator=gen, device="cuda")
        a = torch.where(a < 0.018, a, torch.zeros((), device="cuda"))
        a = a / (a.sum(dim=1, keepdim=True) + 1e-7)
        x = torch.randn((FAIRGO_NODES, T.shape[1]), generator=gen, device="cuda")
        hop = sharded_propagate(mesh, shard_propagation_matrix(mesh, a), x)
        if not torch.equal(hop, propagate(x, None, None, None, FAIRGO_NODES, dense=a)):
            fail("parallel: sharded_propagate differs from propagate")
        items = trainer.model.item_embedding.weight.detach()
        ids = torch.randint(0, items.shape[0], (U.shape[0],), generator=gen, device="cuda")
        if not torch.equal(bucket_allgather_lookup(mesh, items, ids), items[ids]):
            fail("parallel: bucket_allgather_lookup differs from table[ids]")
        print(f"parallel: sharded_propagate (n {FAIRGO_NODES}, d {T.shape[1]}) = propagate, "
              f"bucket_allgather_lookup = table[ids]; launches on the main path {launches}; "
              f"{card}", flush=True)
    finally:
        dist.destroy_process_group()
    return launches, row


# bench.py::bench_scale (bench.py:589-760): the catalog where the device, not
# the host, binds. 2,097,152 item rows as bench.py serves them (row 0 is the
# PAD item, masked; no extra row), d 128, a bfloat16 table; blocks of B 128
# and 1024 users, k' 10. The scale train step: 1,048,576 users, the same
# items, batch 65,536, dense Adam. bench_pallas_topk's shape (bench.py:
# 550-588): B 1024, I 65,536, d 64, float32, k' 10.
SCALE_ITEMS = 2 * 1024 * 1024
SCALE_USERS = 1024 * 1024
SCALE_DIM = 128
SCALE_K = 10
SCALE_BLOCKS = (128, 1024)
SCALE_BATCH = 65536
SCALE_STEPS = 10
PALLAS_BENCH = (1024, 65536, 64)  # B, I, d of bench_pallas_topk
# the catalog's table (and users) as bench_scale stores it, then in float16
SCALE_DTYPES = ("bfloat16", "float16")
# float32 outputs held bit for bit against the kernel before the
# tensor-core path and the split merge (commit 98b4f0a): eight shapes and
# one whose lists take the split merge; (B, I, d, k', column offset (shard
# mode where > 0), numpy seed of U then T)
F32_PARITY_CASES = {
    "serving": (6144, 3630, 64, 173, 0, 1), "k1": (6144, 3630, 64, 1, 0, 2),
    "k2048": (1024, 3630, 64, 2048, 0, 3), "k4096": (6144, 16384, 64, 4096, 0, 4),
    "d30": (1024, 3630, 30, 173, 0, 5), "i65536": (1024, 65536, 64, 10, 0, 6),
    "shard": (6144, 908, 64, 173, 908, 7), "d65": (2000, 3001, 65, 300, 0, 8),
    "split": (128, 1048576, 32, 10, 0, 9),
}
# f32_digests of the parent build on those cases, from ``chip_smoke.py
# --parent`` on an H100 (``--parent`` recomputes them from a parent checkout
# in the same run)
F32_PARENT_DIGESTS = {
    "serving": "6a9241e219e368ac", "k1": "2dd8f5339b840889", "k2048": "47172d277f6887d3",
    "k4096": "db6a9c4dd1bbcfcc", "d30": "3c191e4fd4fb5de3", "i65536": "e4cba1c4b84b4621",
    "shard": "e89b4c7557a651d8", "d65": "ddf768be6ef40982", "split": "f52c8f12644ce100",
}


class ScaleDataset:
    """Duck-typed dataset of the scale step: the models read only ``num``
    at construction (bench.py's ``_ScaleDS``)."""

    def __init__(self, n_users, n_items):
        self.sizes = {"user_id": n_users, "item_id": n_items}

    def num(self, field):
        return self.sizes[field]


def scale_config_dict(work_dir, dim=SCALE_DIM, extra=None):
    """bench_scale's configuration: PFCN_PMF as pure BPR-MF (``filter_mode:
    none``, no attribute lookups), the YAML's Adam defaults."""
    return {
        "data_path": os.path.join(work_dir, "data"), "filter_mode": "none",
        "sst_attr_list": [], "embedding_size": dim, "metrics": ["NDCG"], "topk": [TOPK],
        "valid_metric": f"NDCG@{TOPK}", "show_progress": False, "state": "WARNING",
        "checkpoint_dir": os.path.join(work_dir, "saved"), **(extra or {}),
    }


def scale_trainer(work_dir, n_users=SCALE_USERS, n_items=SCALE_ITEMS, dim=SCALE_DIM,
                  extra=None, generator=None):
    """The port's base ``Trainer`` over PFCN_PMF on a ``ScaleDataset``."""
    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.trainer import Trainer
    from recbole_fairrec_tpu_torch.utils import get_model

    config = Config(model="PFCN_PMF", dataset="scale",
                    config_dict=scale_config_dict(work_dir, dim, extra))
    model = get_model("PFCN_PMF")(config, ScaleDataset(n_users, n_items), generator=generator)
    return Trainer(config, model)


def scale_batches(n_users, n_items, batch_size, n=4, seed=3):
    """bench_scale's batches: (user, pos, neg) from RandomState(seed), in its
    draw order (bench.py:691-699), as int32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return [{"user_id": rng.randint(1, n_users, batch_size, dtype=np.int32),
             "item_id": rng.randint(1, n_items, batch_size, dtype=np.int32),
             "neg_item_id": rng.randint(1, n_items, batch_size, dtype=np.int32)}
            for _ in range(n)]


def _bound_ms(U, T, k):
    """The least time of one top-k' call: each input read once and each
    output written once at the memory rate, or 2 B I d operations at the
    peak of the inputs' type (the tensor cores when both are bf16 or both
    f16, else float32 outside the tensor cores), whichever is larger."""
    import torch

    B, d = U.shape
    I = T.shape[0]
    half = U.dtype == T.dtype and T.dtype in (torch.bfloat16, torch.float16)
    ops_ms = 2.0 * B * I * d / (PEAK_BF16_FLOPS if half else PEAK_F32_FLOPS) * 1e3
    bytes_ms = (U.element_size() * B * d + T.element_size() * I * d + 8.0 * B * k) \
        / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def kernel_times_us(fn, calls=10):
    """Mean device time per call, in µs, of each of the two CUDA kernels of
    a ``fused_topk`` call that ``fn`` makes: score + select (either path's
    kernel) apart from the merge (either form), 0 where the profiler saw
    none."""
    times = _device_profile(fn, calls)
    return {name: sum(ms for key, ms in times.items() if name in key) * 1e3
            for name in ("score_select", "merge")}


def _no_table_copy(mod, U, T, k, label):
    """One kernel call on ``T`` allocates its outputs and its scratch and
    nothing else: the rise of the peak allocation, less the scratch, stays
    below the size of a float32 copy of ``T``. Returns (rise, scratch)
    bytes."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = mod.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    del out
    words = mod.launch_args(U.device, U.shape[0], T.shape[0], U.shape[1], k, U.dtype,
                            T.dtype)[0]
    if rise - 8 * words >= 4 * T.numel():
        fail(f"scale[{label}]: a call raised the allocation by {rise} bytes, {8 * words} of "
             f"scratch: room for a float32 copy of the table ({4 * T.numel()} bytes)")
    return rise, 8 * words


def scale_kernel_row(mod, U, T, k, label, card, reps=5):
    """``check_fused_topk`` at catalog scale, after a call that allocates no
    float32 copy of the table (``_no_table_copy``), with the split of a
    call into its two CUDA kernels."""
    import torch

    rise, scratch = _no_table_copy(mod, U, T, k, label)
    split = kernel_times_us(lambda: mod.fused_topk_scores(U, T, k), calls=5)
    row = check_fused_topk(mod, U, T, k, label, card, reps, extra={
        "kernels_us": split, "alloc_rise_bytes": rise, "scratch_bytes": scratch})
    torch.cuda.empty_cache()  # the library call's [B, I] float32 scores
    return row


def time_scale_step(work_dir, card, steps=SCALE_STEPS):
    """bench_scale's train step on the card: the port's ``Trainer._train_step``
    (dense Adam over both tables) at 1,048,576 users x 2,097,152 items x 128,
    batch 65,536; one step to warm up, then ``steps`` timed steps over 4
    batches in turn. Each batch's loss must fall from one visit to the next.
    Prints examples/s, ms a step, peak memory and the bound."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = scale_trainer(work_dir)
    if trainer.device.type != "cuda" or any(p.device.type != "cuda"
                                            for p in trainer.model.parameters()):
        fail(f"scale: the trainer is on {trainer.device}, not on the card")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = [{key: torch.from_numpy(v).long().cuda() for key, v in b.items()}
               for b in scale_batches(SCALE_USERS, SCALE_ITEMS, SCALE_BATCH)]
    trainer.model.train()
    losses = [trainer._train_step(dict(batches[0]), "calculate_loss", None, trainer.optimizer)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        losses.append(trainer._train_step(dict(batches[step % 4]), "calculate_loss", None,
                                          trainer.optimizer))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(x) for x in losses]
    # visits of batch b: the warm-up (b = 0), then steps b, b + 4, ...
    visits = {b: ([losses[0]] if b == 0 else []) + losses[1 + b::4] for b in range(4)}
    for b, seq in visits.items():
        if not all(math.isfinite(x) for x in seq) or any(y >= x for x, y in zip(seq, seq[1:])):
            fail(f"scale: the loss of batch {b} did not fall from visit to visit: {seq}")
    # where the card's time goes: every kernel of 4 more steps, by name
    turn = iter(range(1 << 30))
    split = _device_profile(lambda: trainer._train_step(
        dict(batches[next(turn) % 4]), "calculate_loss", None, trainer.optimizer), calls=4)
    busy = sum(split.values())
    top = dict(sorted(((name[:90], ms) for name, ms in split.items()), key=lambda kv: -kv[1])[:8])
    params = (SCALE_USERS + SCALE_ITEMS) * SCALE_DIM
    gathers = SCALE_BATCH * 3 * SCALE_DIM * 4 * 2
    jax_bytes = 6 * 4 * params + gathers  # bench.py:711-712: p, m, v read and written
    port_bytes = jax_bytes + 2 * 4 * params  # + the dense gradient written, then read
    row = {"users": SCALE_USERS, "items": SCALE_ITEMS, "d": SCALE_DIM, "batch": SCALE_BATCH,
           "steps": steps, "init_s": init_s, "step_ms": step_s * 1e3,
           "examples_per_s": SCALE_BATCH / step_s, "peak_memory_bytes": peak,
           "param_bytes": 4 * params, "bound_ms": port_bytes / PEAK_BYTES * 1e3,
           "bound_ms_without_dense_grad": jax_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (step_s * 1e3),
           "top_kernels_ms": top, "losses": losses, "card": card}
    print(f"scale: train step {json.dumps(row)}", flush=True)
    del trainer, batches
    torch.cuda.empty_cache()
    return row


def f32_digests(topk, cases=None):
    """``topk`` (a ``fused_topk_scores``) on each float32 case of
    ``F32_PARITY_CASES`` (inputs from numpy seeds, on the card): the first
    16 hex digits of the SHA-256 of its scores' and indices' bytes."""
    import hashlib

    import torch

    out = {}
    for name, (B, I, d, k, col0, seed) in (cases or F32_PARITY_CASES).items():
        rng = np.random.RandomState(seed)
        U = torch.from_numpy(rng.randn(B, d).astype(np.float32)).cuda()
        T = torch.from_numpy(rng.randn(I, d).astype(np.float32)).cuda()
        s, i = topk(U, T, k, col_offset=col0, mask_pad=col0 == 0)
        out[name] = hashlib.sha256(s.cpu().numpy().tobytes()
                                   + i.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def parent_digests(parent):
    """``f32_digests`` of the kernel in the checkout ``parent`` (its own
    wrapper, built from its own source), in a process of its own."""
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {parent!r})\n"
        "from recbole_fairrec_tpu_torch.ops import fused_topk\n"
        f"spec = importlib.util.spec_from_file_location('smoke', {os.path.abspath(__file__)!r})\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "fused_topk.build()\n"
        "print(json.dumps(smoke.f32_digests(fused_topk.fused_topk_scores)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"parity: the parent build in {parent} failed ({proc.returncode}): "
             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def check_f32_parity(mod, card, parent=None):
    """float32 outputs bit for bit the parent build's on every case of
    ``F32_PARITY_CASES``: against the pinned digests, and against
    ``parent`` (the digests a parent checkout gave in this run) where
    given."""
    got = f32_digests(mod.fused_topk_scores)
    for name, digest in got.items():
        want = [F32_PARENT_DIGESTS[name]] + ([parent[name]] if parent else [])
        if any(w != digest for w in want):
            fail(f"parity: float32 case {name} gave digest {digest}, the parent {want}")
    print(f"parity: float32 outputs bit for bit the parent build's at {len(got)} shapes "
          f"(pinned digests{' and a parent build in this run' if parent else ''}): "
          f"{json.dumps(got)}; {card}", flush=True)
    return got


def scale(work_dir, card):
    """Phase 3: catalog scale. For each of bfloat16 and float16, a 2,097,152
    x 128 item table (and users) of that type made on the card from a seed;
    the launch counts are set to 0, then ``certified_topk_scores`` (B 128)
    and ``approx_topk_scores(verify=True)`` (B 1024) serve it through the
    kernel (the tensor-core path and the split merge), and the counts are
    read; then the kernel against its plain version at B 128 and B 1024 over
    that table, each call allocating no float32 copy of it. Then
    bench_pallas_topk's float32 shape, and the scale train step. Returns
    (launches, rows, the step's row)."""
    import torch

    from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores

    mod = _kernel_module(KERNELS[0])
    launches = {k["name"]: 0 for k in KERNELS}
    rows = []
    for name in SCALE_DTYPES:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(11)
        T = torch.randn((SCALE_ITEMS, SCALE_DIM), generator=gen, device="cuda", dtype=dtype)
        users = {B: torch.randn((B, SCALE_DIM), generator=gen, device="cuda", dtype=dtype)
                 for B in SCALE_BLOCKS}
        _sync()
        before = mod.launches
        s_c, i_c = certified_topk_scores(users[128], T, SCALE_K)
        s_a, i_a, certified = approx_topk_scores(users[1024], T, SCALE_K, verify=True)
        _sync()
        n = mod.launches - before
        if n != 2:
            fail(f"scale: {n} kernel launches for the 2 {name} retrieval calls")
        launches["fused_topk"] += n
        if not bool(certified.all()) or s_a.dtype != torch.float32 or i_a.dtype != torch.int32:
            fail(f"scale: approx_topk_scores gave {s_a.dtype}, {i_a.dtype}, "
                 f"{int((~certified).sum())} uncertified rows")
        for label, U, s, i in (("certified", users[128], s_c, i_c),
                               ("approx", users[1024], s_a, i_a)):
            s_p, i_p, s_next = plain_topk_with_next(mod, U, T, SCALE_K)
            err, near = _compare_topk(f"scale {label} {name}", U, T, SCALE_K, s, i, s_p, i_p,
                                      s_next=s_next)
            print(f"scale: {label}_topk_scores (B {U.shape[0]}, I {SCALE_ITEMS}, d {SCALE_DIM}, "
                  f"{name}, k' {SCALE_K}) through the kernel: max_abs_err {err}, near-tie swaps "
                  f"{near}; {card}", flush=True)
        del s_c, i_c, s_a, i_a, certified
        rows += [scale_kernel_row(mod, users[B], T, SCALE_K, f"scale {name} B{B}", card)
                 for B in SCALE_BLOCKS]
        del T, users
        torch.cuda.empty_cache()
    B, I, d = PALLAS_BENCH
    gen32 = torch.Generator(device="cuda").manual_seed(7)
    U32 = torch.randn((B, d), generator=gen32, device="cuda")
    T32 = torch.randn((I, d), generator=gen32, device="cuda")
    rows.append(scale_kernel_row(mod, U32, T32, SCALE_K, "pallas bench", card, reps=20))
    del U32, T32
    step = time_scale_step(os.path.join(work_dir, "scale"), card)
    return launches, rows, step


BENCH_REPEATS = 1  # samples per leg of the bench phase (sizes stay bench.py's)


def _built_libraries():
    """{name: mtime} of the kernel libraries in the build directory."""
    build_dir = os.path.join(REPO, PACKAGE, "_build")
    return {name: os.path.getmtime(os.path.join(build_dir, name))
            for name in os.listdir(build_dir) if name.endswith(".so")}


def bench(card):
    """Phase 11: ``bench_torch.py --repeats BENCH_REPEATS`` in a process of
    its own, on the kernel library phase 2 built (no library is built or
    rebuilt). Fails on a non-zero exit, a missing key of bench.py, dense and
    streaming evaluations that disagree, a kernel that is not exact against
    the library call, an approx recall other than 1.0 or a number that is
    not finite and positive. Returns the launch counts of its run."""
    import torch

    import bench_torch

    torch.cuda.empty_cache()  # this process's cached blocks, for the child's scale leg
    libraries = _built_libraries()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), "--repeats",
                           str(BENCH_REPEATS)], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench: bench_torch.py exited {proc.returncode}: {proc.stderr[-3000:]}")
    if _built_libraries() != libraries:
        fail(f"bench: bench_torch.py built a kernel library: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    launches = json.loads(next(line for line in lines if line.startswith("launches: "))[10:])
    missing = [key for key in (*bench_torch.KEYS, "device") if key not in out]
    if missing:
        fail(f"bench: keys of bench.py missing: {missing}")
    if out["eval_variants_agree"] is not True or out["pallas_topk_exact"] is not True:
        fail(f"bench: eval_variants_agree {out['eval_variants_agree']}, pallas_topk_exact "
             f"{out['pallas_topk_exact']}")
    if out["scale_fullsort_approx_recall_vs_exact"] != 1.0:
        fail(f"bench: approx recall {out['scale_fullsort_approx_recall_vs_exact']}, not 1.0")
    bad = [key for key, v in out.items() if isinstance(v, (int, float)) and not isinstance(v, bool)
           and not (math.isfinite(v) and v > 0)]
    if bad:
        fail(f"bench: numbers not finite and positive: {[(key, out[key]) for key in bad]}")
    print(f"bench: {json.dumps(out)}", flush=True)
    print(f"bench: bench_torch.py --repeats {BENCH_REPEATS} in {wall:.3f} s; launches "
          f"{json.dumps(launches)}; {card}", flush=True)
    return launches


PARITY_RUN = ("FOCF", 2020)  # run key and seed of the parity phase


def parity_run(card):
    """Phase 12: one whole run of the parity runner (``PARITY_RUN`` at the
    protocol unchanged) in a process of its own, into a temporary directory.
    Fails on a non-zero exit, a record that does not name the card, or a
    test result without 12 finite metrics, the headline's gender rows among
    them. Returns the kernel launches of the run."""
    import tempfile

    from recbole_fairrec_tpu_torch.scripts import parity_runs

    run_key, seed = PARITY_RUN
    with tempfile.TemporaryDirectory(prefix="parity_") as out:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "recbole_fairrec_tpu_torch.scripts.parity_runs",
                               "--run", run_key, "--seed", str(seed), "--out", out],
                              cwd=REPO, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"parity: {run_key} seed {seed} exited {proc.returncode}: {proc.stderr[-3000:]}")
    prefix = "[parity] record "
    lines = [line for line in proc.stdout.splitlines() if line.startswith(prefix)]
    if len(lines) != 1:
        fail(f"parity: {len(lines)} record lines, not 1: {proc.stdout[-3000:]}")
    rec = json.loads(lines[0][len(prefix):])
    if rec["card"] != card:
        fail(f"parity: the record names the card {rec['card']!r}, not {card!r}")
    test = rec["test_result"]
    bad = {k: v for k, v in test.items() if not math.isfinite(v)}
    headline = [m for m in parity_runs.HEADLINE if m.endswith("gender") or "@" in m]
    if len(test) != 12 or bad or not set(headline) <= set(test):
        fail(f"parity: the test result has {len(test)} metrics, not finite: {bad}, missing: "
             f"{sorted(set(headline) - set(test))}")
    print(f"parity: {run_key} seed {seed} in {wall:.3f} s (run_recbole {rec['wall_s']} s); "
          f"epochs_trained {rec['epochs_trained']}; best valid ndcg@5 "
          f"{rec['best_valid_score']}; test ndcg@5 {test['ndcg@5']}; launches "
          f"{json.dumps(rec['launches'])}; {card}", flush=True)
    return rec["launches"]


def _require_card_trainer(trainer, phase, model="PFCN_PMF"):
    """The registry's trainer for ``model``, on the card with every
    parameter and buffer (FairGo's propagation matrices included): a
    configuration that lands on the CPU would pass every later check
    without a kernel."""
    import itertools

    from recbole_fairrec_tpu_torch.utils import get_trainer

    cls = get_trainer(trainer.config["MODEL_TYPE"], model)
    if type(trainer) is not cls:
        fail(f"{phase}: the trainer is a {type(trainer).__name__}, not a {cls.__name__}")
    if trainer.device.type != "cuda":
        fail(f"{phase}: the trainer is on {trainer.device}, not on the card")
    for name, tensor in itertools.chain(trainer.model.named_parameters(),
                                        trainer.model.named_buffers()):
        if tensor.device.type != "cuda":
            fail(f"{phase}: the model's {name} is on {tensor.device}, not on the card")


def _sync():
    import torch

    torch.cuda.synchronize()


def _kernel_module(kernel):
    import importlib

    return importlib.import_module(f"{PACKAGE}.{kernel['module']}")


def serving_inputs(trainer, loader, sst_list=None):
    """The fused top-k's inputs exactly as the streaming path builds them for
    the first macro-batch of ``loader`` (after an ``evaluate`` of it), for
    the attribute subset ``sst_list`` of a filtered model."""
    import torch

    from recbole_fairrec_tpu_torch.utils import _bucket

    interaction = next(iter(trainer._macro_batches(loader, "full")))[0]
    n = len(interaction)
    pad_to = max(trainer._full_sort_pad or n, _bucket(n, 512))
    with torch.no_grad():
        U, T = trainer._get_retrieval_fn(sst_list)(trainer._to_batch(interaction, pad_to=pad_to))
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
    (torch.topk does not promise the tie order; the port never calls this).
    bfloat16 or float16 inputs multiply into a float32 [B, I] score matrix."""
    import torch

    if T.dtype in (torch.bfloat16, torch.float16) and U.dtype == T.dtype:
        s = torch.mm(U, T.T, out_dtype=torch.float32)
    else:
        s = torch.matmul(U, T.T)
    s[:, 0] = float("-inf")
    return torch.topk(s, k, dim=1)


def _abs_dot(U, T, idx, block_elems=1 << 26):
    """sum_j |U[b, j] T[idx[b, c], j]| in float32 for every slot (b, c) of
    ``idx`` [B, k]: the rows of T gathered a block of users at a time, so
    that no [B, I] matrix is formed (a catalog of 2M items would need 8.6 GB
    at B 1024)."""
    import torch

    B, k = idx.shape
    rows = max(1, block_elems // (k * U.shape[1]))
    Ua = U.abs().float()
    parts = [(Ua[r0:r0 + rows, None, :] * T[idx[r0:r0 + rows]].abs().float()).sum(-1)
             for r0 in range(0, B, rows)]
    return torch.cat(parts)


def plain_topk_with_next(mod, U, T, k):
    """The plain version's top k' of ``U @ T.T`` and, per row, its (k'+1)-th
    score (-inf where the catalog has no more items): the neighbour of the
    last slot in the plain version's whole ranking."""
    s, i = mod.fused_topk_scores_reference(U, T, k + 1)
    return s[:, :k].contiguous(), i[:, :k].contiguous(), s[:, k].contiguous()


def _compare_topk(label, U, T, k, s_k, i_k, s_p, i_p, pad_masked=True, col_offset=0,
                  s_next=None):
    """``topk_disagreement``, failing the run where it finds one; returns
    (max_abs_err, near-tie swaps)."""
    problem, err, near = topk_disagreement(U, T, k, s_k, i_k, s_p, i_p, pad_masked, col_offset,
                                           s_next)
    if problem:
        fail(f"fused_topk[{label}]: {problem}")
    return err, near


def topk_disagreement(U, T, k, s_k, i_k, s_p, i_p, pad_masked=True, col_offset=0, s_next=None):
    """A kernel's top-k' (``s_k``, ``i_k``) against the plain version's on the
    same inputs; returns (what disagrees or None, max_abs_err, near-tie
    swaps). ``pad_masked=False``
    (the shard mode) allows item 0; indices are ``col_offset`` + row of T.
    ``s_next`` (``plain_topk_with_next``) is the plain version's (k'+1)-th
    score, the last slot's neighbour in its whole ranking.

    Tolerance: a float32 dot product of length d summed in any order is
    within d * 2^-24 * sum|u_j t_j| of the exact value, so two orders differ
    by at most twice that (``tol``). Scores must agree within rtol 1e-5 plus
    ``tol``; indices must be equal except where the plain version's adjacent
    scores are within max(1e-6 |s|, tol) of each other (a near tie that the
    two summation orders may rank either way; for the last slot that
    includes the (k'+1)-th score where ``s_next`` gives it, so an item that
    the kernel ranks k'-th in place of the plain version's (k'+1)-th by a
    near tie is a swap too). -inf slots must carry index 0 in both."""
    import torch

    B, d = U.shape
    if s_k.shape != (B, k) or i_k.shape != (B, k):
        return f"output shapes {tuple(s_k.shape)}, {tuple(i_k.shape)}", None, None
    if s_k.dtype != torch.float32 or i_k.dtype != torch.int32:
        return f"output types {s_k.dtype}, {i_k.dtype}", None, None
    inf_k, inf_p = torch.isneginf(s_k), torch.isneginf(s_p)
    if not torch.equal(inf_k, inf_p):
        return "-inf slots differ", None, None
    if bool((i_k[inf_k] != 0).any()):
        return "a -inf slot carries an index other than 0", None, None
    if pad_masked and bool((i_k[~inf_k] == 0).any()):
        return "the PAD item 0 was selected", None, None
    fin = ~inf_p
    i_safe = (i_p.long() - col_offset).clamp_min(0)
    tol = 2 * d * 2.0 ** -24 * _abs_dot(U, T, i_safe)
    diff = (s_k - s_p).abs()
    diff[~fin] = 0
    err = float(diff.max()) if diff.numel() else 0.0
    if bool((diff > 1e-5 * s_p.abs().where(fin, torch.zeros_like(s_p)) + tol).any()):
        return f"scores differ by up to {err}", err, None
    near = torch.zeros_like(fin)
    gap = (s_p[:, 1:] - s_p[:, :-1]).abs()
    gap_tol = torch.maximum(1e-6 * s_p[:, 1:].abs(), tol[:, 1:])
    close = (gap <= gap_tol) & fin[:, 1:]
    near[:, 1:] |= close
    near[:, :-1] |= close
    if s_next is not None:
        near[:, -1] |= fin[:, -1] & torch.isfinite(s_next) & (
            (s_p[:, -1] - s_next).abs() <= torch.maximum(1e-6 * s_next.abs(), tol[:, -1]))
    bad = (i_k != i_p) & ~near
    if bool(bad.any()):
        b, j = (int(x) for x in torch.nonzero(bad)[0])
        return (f"index {int(i_k[b, j])} != {int(i_p[b, j])} at row {b} slot {j} "
                f"(scores {float(s_k[b, j])}, {float(s_p[b, j])})", err, None)
    return None, err, int(((i_k != i_p) & near).sum())


def check_fused_topk(mod, U, T, k, label, card, reps=20, extra=None):
    """Kernel against its plain version on the same inputs (tolerance as
    ``_compare_topk`` says), then its times beside the plain version's, the
    library yardstick's and the bound; ``extra`` fields join the row."""
    import torch

    s_k, i_k = mod.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    s_p, i_p, s_next = plain_topk_with_next(mod, U, T, k)
    B, d = U.shape
    err, n_near = _compare_topk(label, U, T, k, s_k, i_k, s_p, i_p, s_next=s_next)
    del s_k, i_k, s_p, i_p

    ms = _median_ms(lambda: mod.fused_topk_scores(U, T, k), reps)
    ms_back_to_back = _median_ms(lambda: mod.fused_topk_scores(U, T, k), reps, calls=10)
    plain_ms = _median_ms(lambda: mod.fused_topk_scores_reference(U, T, k), max(reps // 4, 3))
    # one PyTorch call computes the function only where U and T share a type
    library_ms = _median_ms(lambda: _library_topk(U, T, k), reps) if U.dtype == T.dtype else None
    bound, bound_by = _bound_ms(U, T, k)
    row = {
        "label": label, "B": B, "I": T.shape[0], "d": d, "k": k,
        "u_dtype": str(U.dtype).replace("torch.", ""),
        "dtype": str(T.dtype).replace("torch.", ""), "max_abs_err": err,
        "near_tie_swaps": n_near, "ms": ms, "ms_back_to_back": ms_back_to_back,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
        "bound_by": bound_by, **(extra or {}), "card": card,
    }
    print(f"kernel: fused_topk {json.dumps(row)}", flush=True)
    return row


def main():
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = os.path.abspath(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--parent CHECKOUT]")
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

    # phase 2: build every kernel, one nvcc each, all started together (and
    # the parent checkout's kernel, where one is given, beside them)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        futures = {k["name"]: pool.submit(_kernel_module(k).build, True) for k in KERNELS}
        parent_future = pool.submit(parent_digests, parent) if parent else None
        for name, fut in futures.items():
            print(f"build: {name} -> {os.path.relpath(fut.result(), REPO)}", flush=True)
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
        parent_result = parent_future.result() if parent_future else None
    parity = check_f32_parity(_kernel_module(KERNELS[0]), card, parent_result)

    # phase 3: catalog scale (the bf16 table of 2M items, the scale step),
    # first of the paths: in a process that has run the later phases, the
    # profiler has shown no kernel of a fused_topk call
    work = os.path.join(REPO, PACKAGE, "_build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    scale_launches, scale_rows, scale_step = scale(work, card)
    print(f"scale: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 4: the serving main path
    t0 = time.perf_counter()
    data_root = write_dataset(os.path.join(work, "data"))
    print(f"serve: wrote the dataset in {time.perf_counter() - t0:.3f} s", flush=True)
    launches, trainer, test_data = serve(data_root, work)

    # phase 5: the training main path
    train_launches = train(data_root, work, card)

    # phase 6: the adversarial main path and the other backbones
    adv_work = os.path.join(work, "adversarial")
    t0 = time.perf_counter()
    write_dataset(data_root, name=ADV_DATASET, attributes=True)
    print(f"adversarial: wrote the dataset in {time.perf_counter() - t0:.3f} s", flush=True)
    adv_launches, adv_rows = adversarial(data_root, adv_work, card)

    # phase 7: the fair models with their published protocol
    t0 = time.perf_counter()
    published_launches = published(data_root, os.path.join(work, "published"), card)
    print(f"published: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 8: FairGo, pretrain then adversarial finetune
    t0 = time.perf_counter()
    fairgo_launches = fairgo(data_root, os.path.join(work, "fairgo"), card)
    print(f"fairgo: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 9: resident epochs, the search and the certified top-k
    U, T, k_prime = serving_inputs(trainer, test_data)
    t0 = time.perf_counter()
    resident_launches = resident(data_root, os.path.join(work, "resident"), card,
                                 (U, T, k_prime))
    print(f"resident: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 10: the parallel layer on a world of one
    t0 = time.perf_counter()
    parallel_launches, shard_row = parallel(data_root, work, card, (U, T, k_prime))
    print(f"parallel: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 11: bench.py's legs on the port, in a process of their own
    bench_launches = bench(card)

    # phase 12: one whole run of the parity protocol, in a process of its own
    t0 = time.perf_counter()
    parity_launches = parity_run(card)
    print(f"parity: phase {time.perf_counter() - t0:.3f} s", flush=True)

    # phase 13: every kernel against its plain version
    mod = _kernel_module(KERNELS[0])
    gen = torch.Generator().manual_seed(2020)
    rows = [check_fused_topk(mod, U, T, k_prime, "serving", card)] + adv_rows
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
    # the tensor-core path (users and table of one half type) and a mixed
    # half pairing on the CUDA cores, at the serving shape and its edges
    for name in SCALE_DTYPES:
        dtype = getattr(torch, name)
        rows.append(check_fused_topk(mod, Ug.to(dtype), Tg.to(dtype), k_prime,
                                     f"gaussian {name}", card))
    rows.append(check_fused_topk(mod, Ug.half(), Tg.bfloat16(), k_prime,
                                 "gaussian float16 users, bfloat16 table", card))
    rows.append(check_fused_topk(mod, Ug.half(), Tg.half(), 1, "k1 float16", card))
    rows.append(check_fused_topk(mod, Ug.bfloat16(), Tbig.bfloat16(), mod.MAX_K,
                                 "k4096 bfloat16", card, reps=5))
    rows.append(check_fused_topk(mod, Ui.half(), Ti.half(), k_prime, "ties float16", card))
    rows.append(check_fused_topk(mod, Un.half(), Tn.half(), k_prime, "d30 float16", card))

    main_row = rows[0]
    by_path = {k["name"]: {"serve": launches[k["name"]], "train": train_launches[k["name"]],
                           **adv_launches, "published": published_launches[k["name"]],
                           "fairgo": fairgo_launches[k["name"]],
                           "resident": resident_launches[k["name"]],
                           "parallel": parallel_launches[k["name"]],
                           "scale": scale_launches[k["name"]],
                           "bench": bench_launches[k["name"]],
                           "parity": parity_launches[k["name"]]} for k in KERNELS}
    summary = [{
        "name": k["name"], "route": k["route"], "source": k["source"],
        "replaces": k["replaces"],
        "launches": sum(by_path[k["name"]].values()),
        "launches_by_path": by_path[k["name"]],
        "max_abs_err": max(r["max_abs_err"] for r in rows + [shard_row] + scale_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shard_mode": {key: shard_row[key] for key in (
            "B", "I", "k", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "scale": {r["label"]: {key: r[key] for key in (
            "B", "I", "d", "k", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in scale_rows},
        "scale_train_step": {key: scale_step[key] for key in (
            "step_ms", "examples_per_s", "peak_memory_bytes", "bound_ms")},
        "paths": {r["label"]: {key: r[key] for key in (
            "B", "I", "d", "k", "u_dtype", "dtype", "max_abs_err", "near_tie_swaps", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms") if key in r}
            for r in rows + [shard_row] + scale_rows},
        "f32_parent_digests": parity,
    } for k in KERNELS]
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
