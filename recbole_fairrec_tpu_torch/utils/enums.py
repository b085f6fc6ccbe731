"""Core enumerations for the framework.

Counterpart of ``recbole_fairrec_tpu/utils/enums.py``, with the same names
and values, so checkpoints written by the JAX package unpickle onto these
classes (see ``quick_start.load_data_and_model``).
"""

from enum import Enum


class ModelType(Enum):
    """Type of a recommender model. Only GENERAL is reachable through the fair
    model registry (reference: recbole/utils/utils.py:60 searches only
    ``fair_recommender``), but the full family is kept for API parity."""

    GENERAL = 1
    SEQUENTIAL = 2
    CONTEXT = 3
    KNOWLEDGE = 4
    TRADITIONAL = 5
    DECISIONTREE = 6


class InputType(Enum):
    """How training batches are shaped for a model (reference:
    recbole/utils/enum_type.py). POINTWISE gets a 0/1 ``label`` column;
    PAIRWISE gets ``neg_<item>`` columns; LISTWISE is unused by fair models."""

    POINTWISE = 1
    PAIRWISE = 2
    LISTWISE = 3


class FeatureType(Enum):
    """Dtype class of a dataset field, parsed from ``name:type`` headers of
    atomic files (reference: recbole/data/dataset/dataset.py:_load_feat)."""

    TOKEN = "token"
    FLOAT = "float"
    TOKEN_SEQ = "token_seq"
    FLOAT_SEQ = "float_seq"


class FeatureSource(Enum):
    """Which atomic file a field came from."""

    INTERACTION = "inter"
    USER = "user"
    ITEM = "item"
    USER_ID = "user_id"
    ITEM_ID = "item_id"
    KG = "kg"
    NET = "net"


class EvaluatorType(Enum):
    """Metric family: RANKING metrics consume ranked lists; VALUE metrics
    consume raw (score, label) pairs. Mixing both in one run is a config error
    (reference: recbole/config/configurator.py:292-300)."""

    RANKING = 1
    VALUE = 2


class KGDataLoaderState(Enum):
    KG = 1
    RS = 2
    RSKG = 3
