from .interaction import Interaction, cat_interactions
from .dataset import Dataset
from .dataloader import AbstractDataLoader, FullSortEvalDataLoader, TrainDataLoader
from .utils import create_dataset, create_samplers, data_preparation, get_dataloader

__all__ = [
    "Interaction",
    "cat_interactions",
    "Dataset",
    "AbstractDataLoader",
    "FullSortEvalDataLoader",
    "TrainDataLoader",
    "create_dataset",
    "create_samplers",
    "data_preparation",
    "get_dataloader",
]
