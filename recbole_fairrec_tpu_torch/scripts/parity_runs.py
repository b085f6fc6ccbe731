"""Whole-run parity of the port: fair models trained to convergence on
ml-100k-fair, each run's record held against the JAX package's and the
reference's records of the same protocol.

The protocol is the repository's ``scripts/parity_runs.py``, copied here
(this module imports nothing of it, of JAX or of the JAX package): the
reference model YAMLs restated in one config file per run (``BASE_CFG`` +
``MODEL_CFG``), RS [8, 1, 1] / RO, uni100, NDCG@5 as the valid metric, the
12 metrics, epochs 300 / early stop 10 (FairGo: 60 pretrain + 100 finetune
epochs), each run key at the seeds of the JAX package's records of it
(2020-2024; PFCN_MLP_refbn 2020-2029). A run goes through the port's
``run_recbole`` (``Trainer.fit`` with a validation every epoch, early
stopping, the best checkpoint reloaded before ``evaluate(test)``) on the
card unless ``--device cpu``.

    python -m recbole_fairrec_tpu_torch.scripts.parity_runs --run FOCF --seed 2020
    python -m recbole_fairrec_tpu_torch.scripts.parity_runs --matrix [--models ...] [--seeds ...]
    python -m recbole_fairrec_tpu_torch.scripts.parity_runs --report

``--out DIR`` puts records and checkpoints under ``DIR`` instead of
``runs/parity_torch/``. A record is ``{run}_torch_{seed}.json``: the JAX
records' form (``runs/parity/*.json``) with ``framework: "torch"`` and the
keys ``card`` (nvidia-smi's name and power limit), ``torch``,
``valid_curve`` (the valid score of every epoch, through ``run_recbole``'s
``callback_fn``; for FairGo the finetune stage, the pretrain stage's in
``pretrain_valid_curve``), ``epochs_trained`` (FairGo also
``pretrain_epochs_trained``) and ``launches`` (the kernel's launches in
the run: the uni100 protocol takes the sampled path, so none). Each record is also printed as one line,
``[parity] record {...}``. NFCF first trains ``NFCF_pre`` of the same seed
and finetunes from its checkpoint. ``--matrix`` runs one process per run,
one after another, and skips records that exist; without ``--seeds`` a
run key takes its JAX records' seeds.

``--report`` writes ``PARITY_TORCH.md``: per run key the port against the
JAX package (its CPU record where both exist; no row can read EXPLAINED;
the multi-attribute PFCN keys subset by subset) and against the reference
(with ``scripts/parity_runs.py``'s EXPLAINED table and its small-batch
``*sb`` values for FairGo's Value, Absolute and Underestimation
Unfairness). A ``_refbn`` key is held against its own JAX records and,
directly (no EXPLAINED row), against its parent's reference records.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS_DIR = os.path.join(REPO, "runs", "parity_torch")
JAX_RUNS_DIR = os.path.join(REPO, "runs", "parity")
REPORT = os.path.join(REPO, "PARITY_TORCH.md")
DATASET = "ml-100k-fair"
FRAMEWORK = "torch"

# Headline metrics reported in PARITY_RUNS.md (full dicts are kept in JSON).
HEADLINE = [
    "ndcg@5", "recall@5", "hit@5", "mrr@5",
    "Differential Fairness of sensitive attribute gender",
    "Value Unfairness of sensitive attribute gender",
    "Absolute Unfairness of sensitive attribute gender",
    "Underestimation Unfairness of sensitive attribute gender",
    "Overestimation Unfairness of sensitive attribute gender",
    "NonParity Unfairness of sensitive attribute gender",
    # present only in the multi-attribute (_ga) runs; rows are skipped
    # where a run has no such metric
    "NonParity Unfairness of sensitive attribute age",
    "Differential Fairness of sensitive attribute age",
]

BASE_CFG = """\
data_path: {data_path}
checkpoint_dir: {ckpt_dir}
seed: {seed}
use_gpu: {use_gpu}
show_progress: False
sst_attr_list: ['gender']
"""

# Per-model run configs mirror the reference model yamls + its test.yaml
# conventions (threshold/load_col restated because sample.yaml clobbers them).
MODEL_CFG = {
    "FOCF": """\
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
fair_objective: value
""",
    "PFCN_PMF_cm": """\
model: PFCN_PMF
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
filter_mode: cm
save_sst_embed: False
""",
    "PFCN_PMF_sm": """\
model: PFCN_PMF
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
filter_mode: sm
save_sst_embed: False
""",
    "FairGo_PMF": """\
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
n_layers: 2
save_sst_embed: False
# reference default is 600; capped identically in both frameworks for
# tractable CPU wall-clock (documented in PARITY_RUNS.md)
pretrain_epochs: 60
epochs: 100
""",
    # NFCF phase A: plain NCF pretrain (implicit feedback, sampled negatives —
    # the reference's NFCF_ml-1M.inter has no rating column)
    "NFCF_pre": """\
model: NFCF
load_col:
  inter: [user_id,item_id]
  user: [user_id,gender]
load_pretrain_path: ~
""",
    # phase B: debiased finetune; {pretrain_path} substituted at run time
    "NFCF": """\
load_col:
  inter: [user_id,item_id]
  user: [user_id,gender]
load_pretrain_path: '{pretrain_path}'
""",
    # The remaining PFCN towers run under their own model-yaml default
    # filter_mode (reference PFCN_MLP.yaml: sm, PFCN_DMF.yaml: sm,
    # PFCN_BiasedMF.yaml: none) so the matrix also covers the un-filtered
    # adversarial mode, which has no other trained run.
    "PFCN_MLP": """\
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
save_sst_embed: False
""",
    "PFCN_BiasedMF": """\
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
save_sst_embed: False
""",
    "PFCN_DMF": """\
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
save_sst_embed: False
""",
    "FairGo_GCN": """\
model: FairGo_GCN
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender]
save_sst_embed: False
# same CPU-tractability caps as the FairGo_PMF runs
pretrain_epochs: 60
epochs: 100
""",
    # Multi-attribute runs: gender + ml-1M-bucketed age (7 classes →
    # multiclass discriminators; sm enumerates 2²−1 = 3 distinct filters,
    # so cm and sm are not the same computation). ValueUnfairness & friends
    # still report gender (the reference metric reads sst_attr_list[0] and
    # enforces binary); NonParity adds an age row via its multi-class std
    # branch.
    "PFCN_PMF_cm_ga": """\
model: PFCN_PMF
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender,age]
sst_attr_list: ['gender', 'age']
filter_mode: cm
save_sst_embed: False
""",
    "PFCN_PMF_sm_ga": """\
model: PFCN_PMF
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender,age]
sst_attr_list: ['gender', 'age']
filter_mode: sm
save_sst_embed: False
""",
    # second filtered head under multi-attr: sm mode with gender+age =>
    # 3 distinct filters feeding the concat-MLP scorer
    "PFCN_MLP_ga": """\
model: PFCN_MLP
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender,age]
sst_attr_list: ['gender', 'age']
save_sst_embed: False
""",
    "FairGo_PMF_ga": """\
model: FairGo_PMF
LABEL_FIELD: label
threshold: {'rating': 3.0}
load_col:
  inter: [user_id,item_id,rating]
  user: [user_id,gender,age]
sst_attr_list: ['gender', 'age']
n_layers: 2
save_sst_embed: False
pretrain_epochs: 60
epochs: 100
""",
}

# Runs of the four filtered PFCN configurations with
# `reference_bn_eval_emulation: True` (eval-time filter BN on per-user batch
# statistics, the reference's eval regime), compared against the parent's
# reference runs.
_REFBN_PARENTS = {
    "PFCN_PMF_cm_refbn": "PFCN_PMF_cm",
    "PFCN_PMF_sm_refbn": "PFCN_PMF_sm",
    "PFCN_MLP_refbn": "PFCN_MLP",
    "PFCN_DMF_refbn": "PFCN_DMF",
}
for _rk, _parent in _REFBN_PARENTS.items():
    MODEL_CFG[_rk] = MODEL_CFG[_parent] + "reference_bn_eval_emulation: True\n"

# Run keys of the port only: a parent run key's config plus lines of its own.
# The records are held against the parent's records.
PORT_RUNS = {
    # FairGo at its protocol depth with the propagation products in bfloat16
    # (float32 results); held against the float32 FairGo_PMF records
    "FairGo_PMF_bf16prop": ("FairGo_PMF", "propagation_dtype: bfloat16\n"),
}

# Early stopping makes final metrics bimodal (runs that escape the early
# valid-score dip reach ~1.5× the NDCG of runs that stop in it), so parity
# needs enough seeds for the spread to capture that variance.
SEEDS = [2020, 2021, 2022, 2023, 2024]
# every run key with JAX records, then the port's own; NFCF trains NFCF_pre
# first
MATRIX = ["FOCF", "NFCF", "FairGo_PMF", "PFCN_PMF_sm_ga", "FairGo_PMF_bf16prop",
          "PFCN_PMF_cm", "PFCN_PMF_sm", "PFCN_PMF_cm_refbn", "PFCN_PMF_sm_refbn",
          "PFCN_MLP", "PFCN_MLP_refbn", "PFCN_MLP_ga",
          "PFCN_DMF", "PFCN_DMF_refbn", "PFCN_BiasedMF",
          "PFCN_PMF_cm_ga", "FairGo_GCN", "FairGo_PMF_ga"]
REPORT_ORDER = ["FOCF", "NFCF_pre", "NFCF",
                "FairGo_PMF", "FairGo_PMF_bf16prop", "FairGo_PMF_ga", "FairGo_GCN",
                "PFCN_PMF_cm", "PFCN_PMF_cm_refbn", "PFCN_PMF_sm", "PFCN_PMF_sm_refbn",
                "PFCN_PMF_cm_ga", "PFCN_PMF_sm_ga",
                "PFCN_MLP", "PFCN_MLP_refbn", "PFCN_MLP_ga",
                "PFCN_DMF", "PFCN_DMF_refbn", "PFCN_BiasedMF"]
# why a run key's section has no reference table
NO_REF = {"FairGo_GCN": "the reference's FairGo_GCN imports `torch_geometric`, "
                        "which its environment lacks (PARITY_RUNS.md §FairGo_GCN)"}


def _model_name(run_key):
    if run_key in _REFBN_PARENTS:
        return _model_name(_REFBN_PARENTS[run_key])
    return {"PFCN_PMF_cm": "PFCN_PMF", "PFCN_PMF_sm": "PFCN_PMF",
            "PFCN_PMF_cm_ga": "PFCN_PMF", "PFCN_PMF_sm_ga": "PFCN_PMF",
            "PFCN_MLP_ga": "PFCN_MLP",
            "FairGo_PMF_ga": "FairGo_PMF",
            "NFCF_pre": "NFCF", "FairGo_PMF_sb": "FairGo_PMF"}.get(run_key, run_key)


def _parent_run(run_key):
    """The run key whose records a run key is held against."""
    return PORT_RUNS[run_key][0] if run_key in PORT_RUNS else run_key


def _ref_run(run_key):
    """The run key whose reference records a run key is held against: a
    ``_refbn`` key's parent, whose reference runs evaluate as it does."""
    parent = _parent_run(run_key)
    return _REFBN_PARENTS.get(parent, parent)


def jax_seeds(run_key, jax_runs_dir=JAX_RUNS_DIR):
    """The seeds of the JAX package's ``ours`` records of the run key that
    ``run_key`` is held against."""
    prefix = f"{_parent_run(run_key)}_ours_"
    return sorted({int(re.match(r"\d+", os.path.basename(path)[len(prefix):]).group())
                   for path in glob.glob(os.path.join(jax_runs_dir, prefix + "*.json"))})


def _write_cfg(run_key, seed, ckpt_dir, extra_subst=None, device="cuda"):
    """The run's config file, as ``scripts/parity_runs.py`` writes it for the
    same run key and device (``use_gpu: False`` only for ``device="cpu"``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    body = MODEL_CFG[_parent_run(run_key)]
    if extra_subst:
        body = body.format(**extra_subst)
    if run_key in PORT_RUNS:
        body += PORT_RUNS[run_key][1]
    cfg = BASE_CFG.format(
        data_path=os.path.join(REPO, "dataset"),
        ckpt_dir=ckpt_dir,
        seed=seed,
        use_gpu="False" if device == "cpu" else "True",
    ) + body
    path = os.path.join(ckpt_dir, f"{run_key}_{FRAMEWORK}_{seed}.yaml")
    with open(path, "w") as f:
        f.write(cfg)
    return path


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def card_name():
    """nvidia-smi's ``name, power.limit`` of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


_ANSI = re.compile(r"\x1b\[[0-9;]*m")
_TRAIN_LINE = re.compile(r"^epoch (\d+) training \[")
_PRETRAIN_VALID_LINE = re.compile(r"^pretrain epoch (\d+) evaluating \[valid_score: (\S+)\]")


class _EpochLog(logging.Filter):
    """Reads the trainer's epoch lines off the root logger (a filter of the
    logger, so it outlives ``init_logger``'s handler reset) and passes every
    record on: the indices of the trained epochs, and FairGo's pretrain
    validations, which ``callback_fn`` does not see."""

    def __init__(self):
        super().__init__()
        self.train_epochs = []
        self.pretrain_valid = []

    def filter(self, record):
        msg = _ANSI.sub("", record.getMessage())
        m = _TRAIN_LINE.match(msg)
        if m:
            self.train_epochs.append(int(m.group(1)))
        m = _PRETRAIN_VALID_LINE.match(msg)
        if m:
            self.pretrain_valid.append(float(m.group(2)))
        return True

    def stages(self):
        """Trained epoch indices split where they restart (FairGo's pretrain,
        then finetune)."""
        out = []
        for idx in self.train_epochs:
            if not out or idx <= out[-1][-1]:
                out.append([])
            out[-1].append(idx)
        return out


def run_one(run_key, seed, device="cuda", runs_dir=RUNS_DIR, overrides=None):
    """Train and test one run through the port's ``run_recbole``; write its
    record to ``runs_dir`` and print it. ``overrides`` (a config dict, above
    the config file) serves short runs in tests."""
    import torch

    from recbole_fairrec_tpu_torch.ops import fused_topk
    from recbole_fairrec_tpu_torch.quick_start import run_recbole

    model = _model_name(_parent_run(run_key))
    tag = f"{run_key}_{FRAMEWORK}_{seed}"
    ckpt_dir = os.path.join(runs_dir, "ckpt", tag)
    extra = None
    if run_key == "NFCF":
        pre_ckpt_dir = os.path.join(runs_dir, "ckpt", f"NFCF_pre_{FRAMEWORK}_{seed}")
        existing = sorted(glob.glob(os.path.join(pre_ckpt_dir, "NFCF-*.pth")))
        if not existing:
            run_one("NFCF_pre", seed, device, runs_dir, overrides)
            existing = sorted(glob.glob(os.path.join(pre_ckpt_dir, "NFCF-*.pth")))
        if not existing:
            raise FileNotFoundError(f"no pretrain checkpoint found in {pre_ckpt_dir}")
        extra = {"pretrain_path": existing[-1]}
    cfg_path = _write_cfg(run_key, seed, ckpt_dir, extra, device)

    curve = []
    epoch_log = _EpochLog()
    root = logging.getLogger()
    root.addFilter(epoch_log)
    fused_topk.launches = 0
    t0 = time.time()
    try:
        result = run_recbole(model=model, dataset=DATASET, config_file_list=[cfg_path],
                             config_dict=overrides,
                             callback_fn=lambda epoch, score: curve.append(float(score)))
    finally:
        root.removeFilter(epoch_log)
    wall = round(time.time() - t0, 1)
    stages = epoch_log.stages()
    payload = {
        "run": run_key, "framework": FRAMEWORK, "seed": seed, "device": device,
        "wall_s": wall,
        "best_valid_score": _jsonable(result.get("best_valid_score")),
        "best_valid_result": _jsonable(result.get("best_valid_result")),
        "test_result": _jsonable(result.get("test_result")),
        "card": card_name() if device != "cpu" else None,
        "torch": torch.__version__,
        "valid_curve": curve,
        "epochs_trained": len(stages[-1]) if stages else 0,
        "launches": {"fused_topk": fused_topk.launches},
    }
    if model.startswith("FairGo"):
        payload["pretrain_valid_curve"] = epoch_log.pretrain_valid
        payload["pretrain_epochs_trained"] = len(stages[0]) if len(stages) > 1 else 0
    os.makedirs(runs_dir, exist_ok=True)
    out_path = os.path.join(runs_dir, f"{tag}.json")
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"[parity] record {json.dumps(payload)}", flush=True)
    print(f"[parity] wrote {out_path} ({wall}s)", flush=True)
    return payload


def run_matrix(models=None, seeds=None, device="cuda", runs_dir=RUNS_DIR):
    """One process per run, one after another, at ``seeds`` or each run
    key's ``jax_seeds``; a run whose record exists is skipped. Each
    process's output goes to ``<runs_dir>/ckpt/<tag>.log``; its record line
    is printed here when it ends. Returns the failed tags."""
    os.makedirs(os.path.join(runs_dir, "ckpt"), exist_ok=True)
    failed = []
    for model in models or MATRIX:
        for seed in seeds or jax_seeds(model):
            tag = f"{model}_{FRAMEWORK}_{seed}"
            if os.path.exists(os.path.join(runs_dir, f"{tag}.json")):
                print(f"[parity] skip {tag} (exists)", flush=True)
                continue
            cmd = [sys.executable, "-m", "recbole_fairrec_tpu_torch.scripts.parity_runs",
                   "--run", model, "--seed", str(seed), "--device", device, "--out", runs_dir]
            print("[parity] running:", " ".join(cmd), flush=True)
            log_path = os.path.join(runs_dir, "ckpt", f"{tag}.log")
            t0 = time.time()
            with open(log_path, "w") as log:
                rc = subprocess.call(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
            with open(log_path) as f:
                text = f.read()
            for line in text.splitlines():
                if line.startswith("[parity] record "):
                    print(line, flush=True)
            print(f"[parity] {tag}: rc {rc}, {time.time() - t0:.1f} s", flush=True)
            if rc != 0:
                failed.append(tag)
                print(f"[parity] FAILED {tag}:\n{text[-3000:]}", flush=True)
    return failed


# ------------------------------------------------------------------ report

def _flat_test_result(payload):
    """Reduce nested adversarial result dicts to one flat metrics dict.

    PFCN test results are keyed '{mode}-{sst_list}' (single entry for one
    attribute); FairGo results carry 'pretrain-'/'finetune-' prefixed keys —
    the finetune set is the headline (reference trainer.py:738-772).
    """
    tr = payload["test_result"]
    if not isinstance(tr, dict):
        return {}
    if any(isinstance(v, dict) for v in tr.values()):  # PFCN per-subset
        key = max(sorted(tr.keys()), key=len)  # full attr subset as headline
        return tr[key]
    if any(k.startswith("finetune-") for k in tr):  # FairGo dual eval
        return {k[len("finetune-"):]: v for k, v in tr.items()
                if k.startswith("finetune-")}
    return tr


# (run_key, metric-substring) → justification for rows whose out-of-bound
# statistic has a pinned cause (PARITY_RUNS.md §Adjudications): those rows
# of the port against the reference read EXPLAINED, not DIVERGENT. They
# explain the JAX package against the reference, so they never apply to the
# port against the JAX package.
_PFCN_FILTERED = ("PFCN_PMF_cm", "PFCN_PMF_sm", "PFCN_MLP", "PFCN_DMF",
                  "PFCN_PMF_cm_ga", "PFCN_PMF_sm_ga", "PFCN_MLP_ga")
_PFCN_BN_WHY = (
    "fixed-eval ours vs BN-degenerate reference eval: every reference "
    "metric is computed from the annihilated-filter scorer "
    "(pfcn_mlp.py:104-120); the direct comparison lives in the _refbn "
    "emulated-eval section"
)
EXPLAINED = {(m, "*"): _PFCN_BN_WHY for m in _PFCN_FILTERED}
EXPLAINED.update({
    (m, sub): why
    for m in ("FairGo_PMF", "FairGo_PMF_ga")
    for sub, why in (
        ("NonParity", "adversarial equilibrium level differs under disjoint "
                      "RNG streams; ours is strictly fairer (lower) — see "
                      "§Adjudications FairGo equilibrium"),
        ("Differential Fairness", "same equilibrium-level cause as NonParity"),
        ("mrr", "driven by ref seed 2022's collapsed run (0.006 ndcg); see "
                "§Adjudications FairGo equilibrium"),
    )
})


def _is_explained(model, metric):
    return (model, "*") in EXPLAINED or any(
        m == model and sub in metric for (m, sub) in EXPLAINED if sub != "*"
    )


def _rank_sum_p(x, y):
    """Two-sided exact Mann-Whitney U p-value (tiny samples)."""
    from scipy.stats import mannwhitneyu

    try:
        return float(mannwhitneyu(x, y, alternative="two-sided",
                                  method="exact").pvalue)
    except ValueError:  # all values identical
        return 1.0


def _fmt_seeds(vals):
    return "/".join(f"{v:.3f}" for v in vals)


def _mean_sd(vals):
    m = sum(vals) / len(vals)
    sd = (sum((v - m) ** 2 for v in vals) / len(vals)) ** 0.5
    return m, sd


def verdict(yard, torch_vals, explained=False):
    """The criterion over two samples of one metric: (Δmean, p, verdict).
    PASS where p ≥ 0.05 or |Δmean| ≤ 0.01 (``PASS (desc.)`` where the exact
    test cannot reach p < 0.05 at these sample sizes and Δ > 0.01), else
    EXPLAINED where ``explained``, else DIVERGENT."""
    ym, _ = _mean_sd(yard)
    tm, _ = _mean_sd(torch_vals)
    delta = abs(ym - tm)
    p_val = _rank_sum_p(yard, torch_vals)
    # smallest p the exact test can produce at these sample sizes; above 0.05
    # the test has no rejection power and a PASS is descriptive
    p_floor = 2.0 / math.comb(len(yard) + len(torch_vals), len(yard))
    if p_val >= 0.05 or delta <= 0.01:
        out = "PASS"
        if p_floor > 0.05 and delta > 0.01:
            out = "PASS (desc.)"
    elif explained:
        out = "EXPLAINED"
    else:
        out = "DIVERGENT"
    return delta, p_val, out


def compare(yard_runs, torch_runs, flat=_flat_test_result, explain_model=None, sb_runs=None):
    """Rows of the criterion over HEADLINE: the yardstick's records
    (``yard_runs``) against the port's. With ``explain_model`` a failing row
    whose (model, metric) has an adjudication reads EXPLAINED; ``sb_runs``
    supply the yardstick's Value, Absolute and Underestimation Unfairness
    (tag ``*sb``). A row is a dict; rows with NaN values carry ``nan``."""
    rows = []
    for metric in HEADLINE:
        src, tag = yard_runs, ""
        if sb_runs and any(s in metric for s in _SB_METRICS):
            src, tag = sb_runs, "*sb"
        yv = [flat(p).get(metric) for p in src]
        tv = [flat(p).get(metric) for p in torch_runs]
        nan = (sum(1 for v in yv if v is not None and v != v),
               sum(1 for v in tv if v is not None and v != v))
        yv = [v for v in yv if v is not None and v == v]
        tv = [v for v in tv if v is not None and v == v]
        if any(nan):
            rows.append({"metric": metric, "tag": tag, "nan": nan})
        if not yv or not tv:
            continue
        delta, p_val, out = verdict(
            yv, tv, explain_model is not None and _is_explained(explain_model, metric))
        rows.append({"metric": metric, "tag": tag, "yard": yv, "torch": tv,
                     "yard_mean_sd": _mean_sd(yv), "torch_mean_sd": _mean_sd(tv),
                     "delta": delta, "p": p_val, "verdict": out})
    return rows


_SB_METRICS = ("Value Unfairness", "Absolute Unfairness", "Underestimation Unfairness")


def format_row(row, names=("ref", "ours")):
    """One markdown row, in PARITY_RUNS.md's layout (yardstick first;
    ``names`` label the two sides' NaN counts)."""
    if "nan" in row:
        return (f"| {row['metric']} | — | — | — | — | — | — | NaN runs: "
                f"{names[0]} {row['nan'][0]}, {names[1]} {row['nan'][1]} |")
    (ym, ysd), (tm, tsd) = row["yard_mean_sd"], row["torch_mean_sd"]
    return (f"| {row['metric']}{row['tag']} | {_fmt_seeds(row['yard'])} "
            f"| {_fmt_seeds(row['torch'])} | {ym:.4f}±{ysd:.4f} | {tm:.4f}±{tsd:.4f} "
            f"| {row['delta']:.4f} | {row['p']:.3f} | {row['verdict']} |")


def load_records(runs_dir, framework):
    """{run key: [record, ...] by seed} of one framework; where a seed has a
    CPU record and another, the CPU one."""
    by_run = {}
    for path in sorted(glob.glob(os.path.join(runs_dir, "*.json"))):
        with open(path) as f:
            p = json.load(f)
        if p.get("framework") != framework:
            continue
        by_run.setdefault(p["run"], []).append(p)
    out = {}
    for run, plist in by_run.items():
        by_seed = {}
        for p in sorted(plist, key=lambda q: q["device"] != "cpu"):
            by_seed.setdefault(p["seed"], p)
        out[run] = [by_seed[s] for s in sorted(by_seed)]
    return out


def _best_epoch(curve):
    return max(range(len(curve)), key=lambda i: curve[i]) if curve else None


def _table(title, yard_name, rows):
    lines = [f"#### {title}", "",
             f"| metric | {yard_name} seeds | torch seeds | {yard_name} mean±sd "
             "| torch mean±sd | Δ | p | verdict |",
             "|---|---|---|---|---|---|---|---|"]
    lines += [format_row(r, (yard_name, "torch")) for r in rows]
    return lines + [""]


def _subsets(runs):
    """The subset keys of multi-attribute PFCN records (shortest first), or
    [] where a test result is flat or holds one subset."""
    tr = runs[0]["test_result"]
    nested = [k for k, v in tr.items() if isinstance(v, dict)]
    return sorted(nested, key=len) if len(nested) > 1 else []


def report(runs_dir=RUNS_DIR, jax_runs_dir=JAX_RUNS_DIR, out=REPORT):
    """Write ``PARITY_TORCH.md`` from the port's records and the JAX
    package's and reference's; returns the DIVERGENT rows as (run key,
    yardstick, table, metric)."""
    port = load_records(runs_dir, FRAMEWORK)
    ours = load_records(jax_runs_dir, "ours")
    ref = {k: [p for p in v if p["device"] == "cpu"]
           for k, v in load_records(jax_runs_dir, "ref").items()}
    divergent = []
    counts = {}
    lines = [
        "# PARITY_TORCH — whole runs of the port against the JAX package and the reference",
        "",
        "Written by `python -m recbole_fairrec_tpu_torch.scripts.parity_runs --report`",
        "from the port's records (`runs/parity_torch/*.json`, trained on the card",
        "by the same module's `--run` / `--matrix`) and the records of",
        "`runs/parity/` (the JAX package: `ours`; the torch reference: `ref`).",
        "",
        "Protocol (`scripts/parity_runs.py`, copied in the port's module):",
        "ml-100k-fair, RS[8,1,1]/RO, uni100, NDCG@5 valid metric, the 12",
        "metrics, epochs 300 / early stop 10 (FairGo: 60 pretrain + 100",
        "finetune epochs), batch 2048, adam 1e-3, each run key at the seeds",
        "of the JAX package's records of it (2020–2024; PFCN_MLP_refbn",
        "2020–2029). The port draws from torch generators, the JAX package",
        "from threefry, so per-seed outcomes differ and the comparison is",
        "distributional.",
        "",
        "**Criterion** (PARITY_RUNS.md's): two-sided exact Mann-Whitney",
        "rank-sum p over the seeds; PASS if p ≥ 0.05 or |Δmean| ≤ 0.01;",
        "`PASS (desc.)` where the seed counts leave the exact test no",
        "rejection power. Against the JAX package no row can read EXPLAINED",
        "(its adjudications explain the JAX package against the reference):",
        "a row that fails reads DIVERGENT; a multi-attribute PFCN key has one",
        "table per subset. Against the reference, the JAX report's EXPLAINED",
        "table applies (PARITY_RUNS.md §Adjudications), and `*sb` rows take",
        "the reference's small-batch dual-eval values. A `_refbn` key",
        "(`reference_bn_eval_emulation: True`: the filters' BatchNorm",
        "evaluates on per-user batch statistics, as the reference's does) is",
        "held against its parent's reference records DIRECTLY: both sides",
        "evaluate the same scorer, so no row can read EXPLAINED.",
        "`FairGo_PMF_bf16prop` (the port's FairGo_PMF with",
        "`propagation_dtype: bfloat16`) is held against the float32",
        "FairGo_PMF records, with FairGo_PMF's adjudications.",
        "",
    ]
    run_keys = [k for k in REPORT_ORDER if k in port] + sorted(set(port) - set(REPORT_ORDER))
    for run_key in run_keys:
        runs = port[run_key]
        parent, ref_key = _parent_run(run_key), _ref_run(run_key)
        yard_ours, yard_ref = ours.get(parent, []), ref.get(ref_key, [])
        ref_name = "ref" if ref_key == parent else f"ref of {ref_key}"
        cards = "; ".join(sorted({str(p.get("card")) for p in runs}))
        lines += [f"## {run_key}  (torch ×{len(runs)}, ours ×{len(yard_ours)}, "
                  f"{ref_name} ×{len(yard_ref)})", "",
                  f"Card: {cards}. Epochs trained: FairGo's pretrain + finetune; "
                  "best epoch: of the valid curve (FairGo: finetune).", "",
                  "| seed | wall s (torch) | epochs trained | best epoch | best valid (torch) "
                  "| best valid (ours, same seed) |", "|---|---|---|---|---|---|"]
        ours_by_seed = {p["seed"]: p for p in yard_ours}
        for p in runs:
            ep = str(p.get("epochs_trained"))
            if "pretrain_epochs_trained" in p:
                ep = f"{p['pretrain_epochs_trained']} + {ep}"
            best = _best_epoch(p.get("valid_curve", []))
            o = ours_by_seed.get(p["seed"], {}).get("best_valid_score", "—")
            lines.append(f"| {p['seed']} | {p['wall_s']} | {ep} | {best} "
                         f"| {p['best_valid_score']} | {o} |")
        lines.append("")
        tables = []
        if yard_ours:
            subsets = _subsets(runs)
            for sub in subsets:
                tables.append(("ours", f"torch against ours: subset `{sub}`",
                               compare(yard_ours, runs,
                                       flat=lambda p, s=sub: p["test_result"].get(s, {}))))
            if not subsets:
                tables.append(("ours", "torch against ours", compare(yard_ours, runs)))
        else:
            lines += ["No JAX-package records for this run key.", ""]
        if yard_ref and ref_key != parent:
            tables.append(("ref", f"torch against ref of `{ref_key}`: DIRECT (both sides "
                                  "evaluate the filters' BatchNorm on per-user batches)",
                           compare(yard_ref, runs)))
        elif yard_ref:
            sb = ref.get(f"{parent}_sb")
            tables.append(("ref", "torch against ref" + (" (`*sb`: small-batch values)"
                                                         if sb else ""),
                           compare(yard_ref, runs, explain_model=parent, sb_runs=sb)))
        else:
            lines += [f"No reference records: {NO_REF.get(run_key, 'none exist')}.", ""]
        for yard_name, title, rows in tables:
            lines += _table(title, yard_name, rows)
            for r in rows:
                if "verdict" in r:
                    key = (yard_name, r["verdict"])
                    counts[key] = counts.get(key, 0) + 1
            divergent += [(run_key, yard_name, title, r["metric"]) for r in rows
                          if r.get("verdict") == "DIVERGENT"]
    lines += ["## Summary", "",
              f"{len(run_keys)} run keys, {sum(len(port[k]) for k in run_keys)} runs of the port.",
              "", "| yardstick | PASS | PASS (desc.) | EXPLAINED | DIVERGENT |",
              "|---|---|---|---|---|"]
    for yard_name in ("ours", "ref"):
        lines.append(f"| {yard_name} | " + " | ".join(
            str(counts.get((yard_name, v), 0))
            for v in ("PASS", "PASS (desc.)", "EXPLAINED", "DIVERGENT")) + " |")
    lines += ["", "Walls (`wall_s`: `run_recbole`'s ETL, fit and test) and epochs trained "
              "(FairGo: pretrain + finetune) by seed; s an epoch is wall over all epochs.", "",
              "| run key | wall s a run | epochs trained | s an epoch |", "|---|---|---|---|"]
    for run_key in run_keys:
        runs = port[run_key]
        epochs = [p.get("pretrain_epochs_trained", 0) + p["epochs_trained"] for p in runs]
        per = [p["wall_s"] / e for p, e in zip(runs, epochs) if e]
        lines.append(f"| {run_key} | {' / '.join(str(p['wall_s']) for p in runs)} | "
                     + " / ".join(f"{p['pretrain_epochs_trained']}+{p['epochs_trained']}"
                                  if "pretrain_epochs_trained" in p else str(p["epochs_trained"])
                                  for p in runs)
                     + (f" | {min(per):.2f}–{max(per):.2f} |" if per else " | — |"))
    lines.append("")
    if divergent:
        lines += [f"- DIVERGENT: {k}, {title}: {m}" for k, _, title, m in divergent]
    else:
        lines.append("No DIVERGENT row.")
    lines.append("")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}; {len(divergent)} DIVERGENT rows", flush=True)
    return divergent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", help="run key (MODEL_CFG or PORT_RUNS)")
    ap.add_argument("--seed", type=int, default=2020)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=RUNS_DIR, help="directory of records and checkpoints")
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--models", nargs="*")
    ap.add_argument("--seeds", nargs="*", type=int)
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args(argv)
    # the port's Config reads --key=value arguments as overrides: none of ours
    sys.argv = sys.argv[:1]
    if args.report:
        report()
    elif args.matrix:
        failed = run_matrix(args.models, args.seeds, args.device, os.path.abspath(args.out))
        if failed:
            sys.exit(f"[parity] failed: {failed}")
    else:
        if not args.run:
            ap.error("give --run, --matrix or --report")
        run_one(args.run, args.seed, args.device, os.path.abspath(args.out))


if __name__ == "__main__":
    main()
