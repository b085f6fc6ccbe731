"""Interaction: the universal field→tensor batch container.

Counterpart of ``recbole_fairrec_tpu/data/interaction.py``. Columns are torch
tensors (CPU while the ETL and loaders build them); ``to(device)`` moves a
batch to the card. Row orders that draw randomness (``shuffle``) draw from
numpy, in the same call order as the JAX package, so one seed gives one
order in both packages. Sequence fields are fixed-width padded 2-D tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (list, tuple)):
        first = value[0] if len(value) else None
        if isinstance(first, np.ndarray):  # ragged sequence field -> pad
            maxlen = max((len(v) for v in value), default=0)
            out = np.zeros((len(value), maxlen), dtype=first.dtype)
            for i, row in enumerate(value):
                out[i, : len(row)] = row
            value = out
    arr = np.asarray(value)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).copy()
    return torch.from_numpy(arr)


def _index(index):
    """Row selector for a tensor column: numpy arrays become tensors."""
    if isinstance(index, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(index))
    return index


class Interaction:
    """Immutable-length dict of equally sized tensor columns."""

    def __init__(self, interaction):
        self.interaction = {}
        if isinstance(interaction, dict):
            for key, value in interaction.items():
                self.interaction[key] = _to_tensor(value)
        elif isinstance(interaction, Interaction):
            self.interaction = dict(interaction.interaction)
        else:
            raise ValueError(f"Unexpected interaction type: [{type(interaction)}]")
        lengths = {v.shape[0] for v in self.interaction.values()}
        if len(lengths) > 1:
            raise ValueError(f"Unequal column lengths: {lengths}")
        self.length = lengths.pop() if lengths else 0

    # --------------------------------------------------------------- access

    @property
    def columns(self):
        return list(self.interaction.keys())

    def __getitem__(self, index):
        if isinstance(index, str):
            return self.interaction[index]
        # row selection (slice / int array / bool mask)
        index = _index(index)
        return Interaction({k: v[index] for k, v in self.interaction.items()})

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise KeyError(f"{type(key)} object does not support item assignment")
        self.interaction[key] = _to_tensor(value)

    def __delitem__(self, key):
        if key in self.interaction:
            del self.interaction[key]

    def __contains__(self, key):
        return key in self.interaction

    def __len__(self):
        return self.length

    def __iter__(self):
        return iter(self.interaction)

    def __str__(self):
        info = [f"The batch_size of interaction: {self.length}"]
        for k, v in self.interaction.items():
            info.append(f"    {k}, {tuple(v.shape)}, {v.dtype}, {v.device}")
        return "\n".join(info)

    __repr__ = __str__

    def numpy(self):
        return {k: v.detach().cpu().numpy() for k, v in self.interaction.items()}

    def to(self, device):
        return Interaction({k: v.to(device) for k, v in self.interaction.items()})

    # ------------------------------------------------------------ transforms

    def update(self, new_inter: "Interaction"):
        """Merge columns of ``new_inter`` into self."""
        for k, v in new_inter.interaction.items():
            self.interaction[k] = v

    def drop(self, column: str):
        if column not in self.interaction:
            raise ValueError(f"Column [{column}] is not in [{self}].")
        del self.interaction[column]

    def repeat(self, sizes: int) -> "Interaction":
        """Tile the whole batch ``sizes`` times along axis 0."""
        return Interaction(
            {k: v.repeat((sizes,) + (1,) * (v.dim() - 1)) for k, v in self.interaction.items()}
        )

    def repeat_interleave(self, repeats: int) -> "Interaction":
        return Interaction(
            {k: v.repeat_interleave(repeats, dim=0) for k, v in self.interaction.items()}
        )

    def add_prefix(self, prefix: str):
        """Rename every column with ``prefix`` (used for neg_ columns)."""
        self.interaction = {prefix + k: v for k, v in self.interaction.items()}

    def sort(self, by, ascending=True):
        """Stable multi-key sort; the first key in ``by`` is the most
        significant (numpy ``lexsort``, as in the JAX package)."""
        if isinstance(by, str):
            by = [by]
        if isinstance(ascending, bool):
            ascending = [ascending] * len(by)
        if len(by) != len(ascending):
            raise ValueError(f"by [{by}] and ascending [{ascending}] should have same length.")
        keys = []
        for b, a in zip(by[::-1], ascending[::-1]):
            key = self.interaction[b].cpu().numpy()
            if not a:
                key = -key
            keys.append(key)
        index = torch.from_numpy(np.lexsort(keys))
        self.interaction = {k: v[index] for k, v in self.interaction.items()}

    def shuffle(self):
        index = torch.from_numpy(np.random.permutation(self.length))
        self.interaction = {k: v[index] for k, v in self.interaction.items()}


def cat_interactions(interactions) -> Interaction:
    """Concatenate batches with identical columns."""
    if not isinstance(interactions, (list, tuple)) or len(interactions) == 0:
        raise ValueError(f"Interactions [{interactions}] should be a non-empty list.")
    columns = set(interactions[0].columns)
    for inter in interactions:
        if set(inter.columns) != columns:
            raise ValueError("Interactions should have some interactions.")
    return Interaction(
        {
            col: torch.cat([inter[col] for inter in interactions], dim=0)
            for col in interactions[0].columns
        }
    )
