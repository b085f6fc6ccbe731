"""FairGo_PMF — FairGo over a PMF backbone.

Counterpart of ``recbole_fairrec_tpu/models/fairgo_pmf.py``: the backbone is
the raw embedding tables (optionally preloaded from ``.user_emb`` /
``.item_emb`` atomic files); everything else is in :class:`FairGoBase`.
"""

from __future__ import annotations

from .fairgo_base import FairGoBase


class FairGo_PMF(FairGoBase):
    pass
