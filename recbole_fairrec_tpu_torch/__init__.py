"""PyTorch/CUDA port of ``recbole_fairrec_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax (nor anything of ``recbole_fairrec_tpu``); the JAX package is
the reference it is tested against. So far it trains BPR-MF (``PFCN_PMF``
with ``filter_mode: none``) with ``run_recbole`` and serves its full-sort
evaluation through the hand-written fused score + top-k kernel in
``csrc/fused_topk.cu``.
"""

from .config import Config
from .quick_start import load_data_and_model, objective_function, run_recbole

__all__ = ["Config", "run_recbole", "objective_function", "load_data_and_model"]
