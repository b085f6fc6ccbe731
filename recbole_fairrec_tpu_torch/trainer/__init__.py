from .trainer import AbstractTrainer, Trainer
from .adversarial import PFCN_PMFTrainer, PFCNTrainer

__all__ = ["AbstractTrainer", "Trainer", "PFCNTrainer", "PFCN_PMFTrainer"]
