"""Carry weights written by the JAX package into a port model.

The JAX package keeps parameters in a pytree of arrays keyed like the
port's parameter names (``{"user_embedding": [n_users, d], "item_embedding":
[n_items, d]}`` for PFCN_PMF); its checkpoints store that tree as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def load_jax_params(model, params):
    """Copy a JAX param tree (numpy arrays, nested dicts allowed) into
    ``model``'s state. Embedding tables ``<name>`` fill ``<name>.weight``.
    Every key and shape is checked; a key left over on either side raises.
    """
    state = model.state_dict()
    flat = {}
    for name, value in _flatten(params).items():
        target = name if name in state else f"{name}.weight"
        flat[target] = value
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(
            f"load_jax_params: missing {missing}, unexpected {unexpected} "
            f"for {type(model).__name__}"
        )
    new_state = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        ref = state[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"load_jax_params: {name} has shape {tuple(arr.shape)}, "
                f"the model expects {tuple(ref.shape)}"
            )
        new_state[name] = torch.as_tensor(np.array(arr), dtype=ref.dtype)
    model.load_state_dict(new_state)
    return model
