"""PyTorch/CUDA port of ``recbole_fairrec_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax (nor anything of ``recbole_fairrec_tpu``); the JAX package is
the reference it is tested against. This slice serves full-sort evaluation
of BPR-MF (``PFCN_PMF`` with ``filter_mode: none``) through the
hand-written fused score + top-k kernel in ``csrc/fused_topk.cu``.
"""

from .config import Config
from .quick_start import load_data_and_model

__all__ = ["Config", "load_data_and_model"]
