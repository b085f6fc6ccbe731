from .trainer import AbstractTrainer, Trainer

__all__ = ["AbstractTrainer", "Trainer"]
