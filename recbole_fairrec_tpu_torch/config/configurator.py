"""Layered configuration system.

Counterpart of ``recbole_fairrec_tpu/config/configurator.py`` with the same
merge order (CLI > config_dict > config files > internal defaults) and the
same derived settings. Two departures:

* The internal defaults (``overall`` → ``model/<M>`` → ``dataset/sample`` →
  ``dataset/<d>``) are read from ``properties.json``, a one-time conversion
  of the JAX package's property YAMLs, so the port needs no YAML library.
  User ``config_file_list`` entries are still YAML; PyYAML is imported only
  when one is given.
* ``device`` is a ``torch.device``: CUDA unless the caller passes
  ``use_gpu: False``. Without a CUDA device and without that opt-out,
  construction raises instead of falling back to the CPU.
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from logging import getLogger

import torch

from ..utils import EvaluatorType, InputType, ModelType, set_color
from ..utils.registry import get_model

_PROPERTIES_FILE = os.path.join(
    os.path.dirname(os.path.realpath(__file__)), "properties.json"
)

# Categories used only for pretty-printing the config dump.
_GENERAL_ARGS = [
    "seed", "state", "reproducibility", "data_path", "checkpoint_dir",
    "show_progress", "save_dataset", "dataset_save_path", "save_dataloaders",
    "dataloaders_save_path", "log_wandb", "use_gpu", "gpu_id", "log_root",
]
_TRAINING_ARGS = [
    "epochs", "train_batch_size", "learner", "learning_rate", "neg_sampling",
    "eval_step", "stopping_step", "clip_grad_norm", "weight_decay",
    "loss_decimal_place", "require_pow", "train_epoch_interval",
    "pretrain_epochs",
]
_EVALUATION_ARGS = [
    "eval_args", "repeatable", "metrics", "topk", "valid_metric",
    "valid_metric_bigger", "eval_batch_size", "metric_decimal_place",
]
_DATASET_ARGS = [
    "field_separator", "seq_separator", "USER_ID_FIELD", "ITEM_ID_FIELD",
    "RATING_FIELD", "TIME_FIELD", "LABEL_FIELD", "threshold", "NEG_PREFIX",
    "load_col", "unload_col", "unused_col", "additional_feat_suffix",
    "rm_dup_inter", "val_interval", "filter_inter_by_user_or_item",
    "user_inter_num_interval", "item_inter_num_interval", "alias_of_user_id",
    "alias_of_item_id", "preload_weight", "normalize_field", "normalize_all",
    "benchmark_filename", "sst_attr_list",
]

# bare scientific notation (``1e-3``) resolves as float in user YAML files,
# as in the JAX package's loader
_FLOAT_TAG_RE = re.compile(
    r"""^(?:
     [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)

_PROPERTIES = None


def _properties():
    """The shipped property defaults, keyed ``overall``, ``model/<M>``,
    ``dataset/<d>`` (loaded once per process, read-only)."""
    global _PROPERTIES
    if _PROPERTIES is None:
        with open(_PROPERTIES_FILE, "r", encoding="utf-8") as f:
            _PROPERTIES = json.load(f)
    return _PROPERTIES


def _load_user_yaml(path):
    """Parse one user config file. PyYAML is needed only here."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the config file [{path}] needs PyYAML, which is not "
            "installed; pass the settings as config_dict instead"
        ) from e

    class _Loader(yaml.FullLoader):
        pass

    _Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float", _FLOAT_TAG_RE, list("-+0123456789.")
    )
    with open(path, "r", encoding="utf-8") as f:
        return yaml.load(f.read(), Loader=_Loader)


def _coerce(value):
    """Parse a CLI/string value into a Python literal when possible."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    # the bare string "none" stays a string (a legal filter_mode value)
    if low in ("~", "null"):
        return None
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    if parsed is not None and not isinstance(
        parsed, (str, int, float, list, tuple, dict, bool)
    ):
        return value
    return parsed


class Config:
    """Dict-like configuration with layered merge and derived parameters.

    Args:
        model: model name (str) or model class; if ``None``, searched in the
            external layers under key ``model``.
        dataset: dataset name; same fallback rule.
        config_file_list: list of YAML file paths (lowest external priority).
        config_dict: parameter dict (middle priority).
    """

    def __init__(self, model=None, dataset=None, config_file_list=None, config_dict=None):
        self.parameters = {
            "General": list(_GENERAL_ARGS),
            "Training": list(_TRAINING_ARGS),
            "Evaluation": list(_EVALUATION_ARGS),
            "Dataset": list(_DATASET_ARGS),
        }

        file_cfg = self._load_config_files(config_file_list)
        dict_cfg = {k: _coerce(v) for k, v in (config_dict or {}).items()}
        cmd_cfg = self._load_cmd_line()
        self.external_config_dict = {}
        self.external_config_dict.update(file_cfg)
        self.external_config_dict.update(dict_cfg)
        self.external_config_dict.update(cmd_cfg)

        self.model, self.model_class, self.dataset = self._resolve_model_and_dataset(
            model, dataset
        )
        self.internal_config_dict = self._load_internal_defaults()

        self.final_config_dict = {}
        self.final_config_dict.update(self.internal_config_dict)
        self.final_config_dict.update(self.external_config_dict)

        self._set_default_parameters()
        self._init_device()
        self._set_train_neg_sample_args()
        self._set_eval_neg_sample_args()

    # ------------------------------------------------------------------ load

    def _load_config_files(self, file_list):
        merged = {}
        for path in file_list or []:
            loaded = _load_user_yaml(path)
            if loaded:
                merged.update(loaded)
        return merged

    def _load_cmd_line(self):
        """``--key=value`` args; unrecognized forms are warned and skipped."""
        cmd_cfg = {}
        unrecognized = []
        if "ipykernel_launcher" in sys.argv[0] or "pytest" in sys.argv[0]:
            return cmd_cfg
        for arg in sys.argv[1:]:
            if not arg.startswith("--") or len(arg[2:].split("=")) != 2:
                unrecognized.append(arg)
                continue
            name, value = arg[2:].split("=")
            if name in cmd_cfg and cmd_cfg[name] != value:
                raise SyntaxError(f"duplicate command arg '{arg}' with different value")
            cmd_cfg[name] = value
        if unrecognized:
            getLogger().warning(
                "command line args [%s] will not be used", " ".join(unrecognized)
            )
        return {k: _coerce(v) for k, v in cmd_cfg.items()}

    def _resolve_model_and_dataset(self, model, dataset):
        if model is None:
            if "model" not in self.external_config_dict:
                raise KeyError(
                    "model must be given via argument, config file, config dict "
                    "or command line"
                )
            model = self.external_config_dict["model"]
        if isinstance(model, str):
            model_name, model_class = model, get_model(model)
        else:
            model_name, model_class = model.__name__, model

        if dataset is None:
            if "dataset" not in self.external_config_dict:
                raise KeyError(
                    "dataset must be given via argument, config file, config dict "
                    "or command line"
                )
            dataset = self.external_config_dict["dataset"]
        return model_name, model_class, dataset

    def _load_internal_defaults(self):
        props = _properties()
        internal = {}
        layers = ["overall", f"model/{self.model}", "dataset/sample", f"dataset/{self.dataset}"]
        for name in layers:
            loaded = props.get(name)
            if loaded:
                # deep copy through JSON types: callers mutate nested dicts
                internal.update(json.loads(json.dumps(loaded)))
                if name == layers[-1]:
                    self.parameters["Dataset"] += [
                        k for k in loaded if k not in self.parameters["Dataset"]
                    ]
        internal["MODEL_TYPE"] = getattr(self.model_class, "type", ModelType.GENERAL)
        return internal

    # --------------------------------------------------------------- derived

    def _set_default_parameters(self):
        cfg = self.final_config_dict
        cfg["dataset"] = self.dataset
        cfg["model"] = self.model
        cfg["data_path"] = os.path.join(cfg.get("data_path", "dataset/"), self.dataset)

        if hasattr(self.model_class, "input_type"):
            cfg["MODEL_INPUT_TYPE"] = self.model_class.input_type
        elif "loss_type" in cfg:
            cfg["MODEL_INPUT_TYPE"] = (
                InputType.POINTWISE if cfg["loss_type"] == "CE" else InputType.PAIRWISE
            )
        else:
            raise ValueError(
                "model must define `input_type` or config must carry `loss_type`"
            )

        metrics = cfg["metrics"]
        if isinstance(metrics, str):
            metrics = [metrics]
            cfg["metrics"] = metrics

        from ..evaluator.register import metric_types, smaller_metrics

        eval_types = set()
        for metric in metrics:
            if metric.lower() not in metric_types:
                raise NotImplementedError(f"There is no metric named '{metric}'")
            eval_types.add(metric_types[metric.lower()])
        if len(eval_types) > 1:
            raise RuntimeError(
                "Ranking metrics and value metrics can not be used at the same time."
            )
        cfg["eval_type"] = eval_types.pop()

        head = cfg["valid_metric"].split("@")[0]
        cfg["valid_metric_bigger"] = head.lower() not in smaller_metrics

        topk = cfg["topk"]
        if isinstance(topk, int):
            topk = [topk]
        if not isinstance(topk, list):
            raise TypeError(f"The topk [{topk}] must be an integer or list")
        for k in topk:
            if k <= 0:
                raise ValueError(f"topk must be positive, got `{k}`")
        cfg["topk"] = topk

        if isinstance(cfg.get("additional_feat_suffix"), str):
            cfg["additional_feat_suffix"] = [cfg["additional_feat_suffix"]]

        defaults = {
            "split": {"RS": [0.8, 0.1, 0.1]},
            "order": "RO",
            "group_by": "user",
            "mode": "full",
        }
        eval_args = cfg.get("eval_args")
        if not isinstance(eval_args, dict):
            raise ValueError(f"eval_args:[{eval_args}] should be a dict.")
        for key, val in defaults.items():
            eval_args.setdefault(key, val)

        if eval_args["mode"] == "full" and cfg["eval_type"] == EvaluatorType.VALUE:
            raise NotImplementedError(
                "Full sort evaluation do not match value-based metrics!"
            )

    def _init_device(self):
        """CUDA unless ``use_gpu: False`` asks for the CPU (the reference's
        CPU escape hatch). No CUDA device and no opt-out is an error."""
        cfg = self.final_config_dict
        if cfg.get("use_gpu") is False:
            cfg["device"] = torch.device("cpu")
        elif torch.cuda.is_available():
            cfg["device"] = torch.device("cuda")
        else:
            raise RuntimeError(
                "no CUDA device is available; pass use_gpu: False to run on the CPU"
            )
        cfg["backend"] = cfg["device"].type

    def _set_train_neg_sample_args(self):
        neg_sampling = self.final_config_dict.get("neg_sampling")
        if neg_sampling is None:
            self.final_config_dict["train_neg_sample_args"] = {"strategy": "none"}
            return
        if not isinstance(neg_sampling, dict):
            raise ValueError(f"neg_sampling:[{neg_sampling}] should be a dict.")
        distribution = next(iter(neg_sampling))
        if distribution not in ("uniform", "popularity"):
            raise ValueError(
                f"neg_sampling distribution [{distribution}] should be "
                "'uniform' or 'popularity'"
            )
        self.final_config_dict["train_neg_sample_args"] = {
            "strategy": "by",
            "by": neg_sampling[distribution],
            "distribution": distribution,
            "dynamic": neg_sampling.get("dynamic", "none"),
        }

    def _set_eval_neg_sample_args(self):
        mode = self.final_config_dict["eval_args"]["mode"]
        if not isinstance(mode, str):
            raise ValueError(f"mode [{mode}] in eval_args should be a str.")
        if mode == "labeled":
            args = {"strategy": "none", "distribution": "none"}
        elif mode == "full":
            args = {"strategy": "full", "distribution": "uniform"}
        elif mode.startswith("uni"):
            args = {"strategy": "by", "by": int(mode[3:]), "distribution": "uniform"}
        elif mode.startswith("pop"):
            args = {"strategy": "by", "by": int(mode[3:]), "distribution": "popularity"}
        else:
            raise ValueError(f"the mode [{mode}] in eval_args is not supported.")
        self.final_config_dict["eval_neg_sample_args"] = args

    # ------------------------------------------------------------- dict-like

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        self.final_config_dict[key] = value

    def __getitem__(self, item):
        return self.final_config_dict.get(item)

    def __getattr__(self, item):
        if "final_config_dict" not in self.__dict__:
            raise AttributeError("'Config' object has no attribute 'final_config_dict'")
        if item in self.final_config_dict:
            return self.final_config_dict[item]
        raise AttributeError(f"'Config' object has no attribute '{item}'")

    def __contains__(self, key):
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        return key in self.final_config_dict

    def __str__(self):
        lines = ["\n"]
        listed = set()
        for category, names in self.parameters.items():
            lines.append(set_color(f"{category} Hyper Parameters:", "pink"))
            for arg, value in self.final_config_dict.items():
                if arg in names:
                    listed.add(arg)
                    lines.append(
                        set_color(str(arg), "cyan") + " = " + set_color(str(value), "yellow")
                    )
            lines.append("")
        lines.append(set_color("Other Hyper Parameters:", "pink"))
        skip = listed | {"model", "dataset", "config_files"}
        for arg, value in self.final_config_dict.items():
            if arg not in skip:
                lines.append(
                    set_color(str(arg), "cyan") + " = " + set_color(str(value), "yellow")
                )
        return "\n".join(lines) + "\n"

    __repr__ = __str__
