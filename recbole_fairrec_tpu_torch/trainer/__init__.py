from .trainer import AbstractTrainer, Trainer
from .adversarial import (
    PFCN_BiasedMFTrainer,
    PFCN_DMFTrainer,
    PFCN_MLPTrainer,
    PFCN_PMFTrainer,
    PFCNTrainer,
)

__all__ = ["AbstractTrainer", "Trainer", "PFCNTrainer", "PFCN_PMFTrainer", "PFCN_MLPTrainer",
           "PFCN_DMFTrainer", "PFCN_BiasedMFTrainer"]
