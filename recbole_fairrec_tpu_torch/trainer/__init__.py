from .trainer import AbstractTrainer, Trainer
from .adversarial import (
    FairGo_GCNTrainer,
    FairGo_PMFTrainer,
    FairGoTrainer,
    PFCN_BiasedMFTrainer,
    PFCN_DMFTrainer,
    PFCN_MLPTrainer,
    PFCN_PMFTrainer,
    PFCNTrainer,
)

__all__ = ["AbstractTrainer", "Trainer", "PFCNTrainer", "PFCN_PMFTrainer", "PFCN_MLPTrainer",
           "PFCN_DMFTrainer", "PFCN_BiasedMFTrainer", "FairGoTrainer", "FairGo_PMFTrainer",
           "FairGo_GCNTrainer"]
