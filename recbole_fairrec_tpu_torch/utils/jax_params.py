"""Carry training state between the JAX package and the port, both ways.

The JAX package keeps parameters in a pytree of arrays keyed like the
port's parameter names (``{"user_embedding": [n_users, d], "item_embedding":
[n_items, d]}`` for PFCN_PMF); its checkpoints store that tree as numpy.
``load_jax_params`` fills a port model from such a tree, ``to_jax_params``
writes one (the port's checkpoints store their parameters in this layout,
so the JAX package's trainer loads them), and ``load_jax_opt_state`` turns
the JAX package's Adam state into ``torch.optim.Adam``'s.
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


def to_jax_params(model):
    """The inverse of :func:`load_jax_params`: ``model``'s state as a tree of
    numpy arrays keyed as the JAX package keys it (an embedding table
    ``<name>.weight`` becomes ``<name>``; other dotted names nest)."""
    tables = {
        name for name, module in model.named_modules()
        if isinstance(module, torch.nn.Embedding)
    }
    tree = {}
    for name, value in model.state_dict().items():
        stem, _, leaf = name.rpartition(".")
        path = (stem if leaf == "weight" and stem in tables else name).split(".")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().cpu().numpy().copy()
    return tree


# optax states that hold numbers, by class name (the state arrives either
# as optax's own named tuples or, from a checkpoint read without JAX, as
# tuples that keep only the class name and the fields in order)
_ADAM_STATE = "ScaleByAdamState"
_OTHER_LEARNER_STATES = {
    "ScaleByRssState": "adagrad",
    "ScaleByRmsState": "rmsprop",
    "ScaleByRmsWithCountState": "rmsprop",
}


def _find_states(node, names):
    if type(node).__name__ in names:
        yield node
    elif isinstance(node, dict):
        for value in node.values():
            yield from _find_states(value, names)
    elif isinstance(node, (tuple, list)):
        for value in node:
            yield from _find_states(value, names)


def load_jax_opt_state(optimizer, model, opt_state_tree):
    """Fill ``optimizer`` (a ``torch.optim.Adam`` over ``model``'s parameters)
    from the JAX package's optimizer state: the optax chain's
    ``ScaleByAdamState(count, mu, nu)`` becomes ``step``, ``exp_avg`` and
    ``exp_avg_sq`` of every parameter; the chain's empty states (clipping,
    weight decay, the learning-rate scale) carry nothing. Training resumed
    from that state takes the same next step in both packages.

    Raises:
        NotImplementedError: for the state of another learner.
    """
    for state in _find_states(opt_state_tree, set(_OTHER_LEARNER_STATES)):
        learner = _OTHER_LEARNER_STATES[type(state).__name__]
        raise NotImplementedError(
            f"the JAX optimizer state of learner [{learner}] cannot be carried over; "
            "only adam and sparse_adam states are mapped"
        )
    adam = list(_find_states(opt_state_tree, {_ADAM_STATE}))
    if len(adam) != 1 or not isinstance(optimizer, torch.optim.Adam):
        raise NotImplementedError(
            f"expected one Adam state for a torch.optim.Adam, found {len(adam)} for "
            f"{type(optimizer).__name__}; only the learner [adam] is mapped"
        )
    count, mu, nu = adam[0]
    mu, nu = _flatten(mu), _flatten(nu)
    names = {id(p): name for name, p in model.named_parameters()}
    state = {}
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            key = name if name in mu else name.removesuffix(".weight")
            if key not in mu or tuple(np.shape(mu[key])) != tuple(p.shape):
                raise KeyError(f"load_jax_opt_state: no Adam moments for parameter {name}")
            state[index] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.array(mu[key]), dtype=p.dtype),
                "exp_avg_sq": torch.as_tensor(np.array(nu[key]), dtype=p.dtype),
            }
            index += 1
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
    )
    return optimizer
