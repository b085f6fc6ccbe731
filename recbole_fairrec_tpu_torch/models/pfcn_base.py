"""Shared machinery of the PFCN family, ``filter_mode: none`` only.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_base.py``. With
``filter_mode: none`` a PFCN model is its plain backbone trained with BPR
(PFCN_PMF is then BPR-MF). The counterfactual filters and discriminators
(``cm``/``sm``) come with the adversarial slice of the port.
"""

from __future__ import annotations

from ..utils import InputType
from .base import FairRecommender


class PFCNBase(FairRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.sst_attrs = list(config["sst_attr_list"])
        self.filter_mode = config["filter_mode"].lower()
        if self.filter_mode not in ("cm", "sm", "none"):
            raise AssertionError("filter_mode must be cm, sm or none")
        if self.filter_mode != "none":
            raise NotImplementedError(
                f"filter_mode [{self.filter_mode}] needs the counterfactual filters, "
                "which come with the adversarial PFCN slice of the port; use "
                "filter_mode: none"
            )
        self.activation = config["activation"]
        self.sst_lut = {}
        self.sst_size = {}
        for sst in self.sst_attrs:
            lut, k = self._sst_code_map(dataset, sst)
            self.sst_lut[sst] = lut
            self.sst_size[sst] = k

    # ----------------------------------------------------- model API pieces

    def _user_item_embed(self, user, item, sst_list):
        """Backbone-specific: returns (user_repr, item_repr)."""
        raise NotImplementedError
