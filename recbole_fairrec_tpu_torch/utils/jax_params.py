"""Carry training state between the JAX package and the port, both ways.

The JAX package keeps a model's parameters in one pytree and its BatchNorm
running statistics in another (``state``); both nest dicts and lists, and
its checkpoints store them as numpy under ``params`` and ``model_state``.
The port's state dict holds the same leaves under the same path, written
with dots: ``filters.f1.linear.0.w`` is ``params["filters"]["f1"]["linear"]
[0]["w"]``, and the buffer ``filters.f1.bn.0.mean`` is ``state["filters"]
["f1"]["bn"][0]["mean"]``. An embedding table ``<name>.weight`` is the JAX
array ``<name>``. Linear weights need no transpose: the port stores them
``[in, out]``, as the JAX package does (``models/layers.py``).

A model's non-persistent buffers (FairGo's propagation matrices, derived
from the data) are in neither direction: the JAX package keeps them in its
``state`` at run time (``prop_dense``, ``gcn_dense``) and strips them from
its checkpoints, and ``load_jax_params`` skips them.

``load_jax_params`` fills a port model from such trees, ``to_jax_params`` /
``to_jax_state`` write them (the port's checkpoints store both in this
layout, so the JAX package's trainer loads them), and ``load_jax_opt_state``
turns the JAX package's Adam state, whole or masked to one optimizer's
parameters, into ``torch.optim.Adam``'s.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """Dotted path → leaf over nested dicts and lists. Tuples (optax's
    ``MaskedNode`` placeholder of a parameter outside an optimizer's group
    is an empty one) are walked like lists."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def _unflatten(flat):
    """The inverse of :func:`_flatten`: a node whose keys are 0..n−1 is a
    list."""
    tree = {}
    for name, value in flat.items():
        path = name.split(".")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == [str(i) for i in range(len(node))]:
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _jax_name(name, tables):
    stem, _, leaf = name.rpartition(".")
    return stem if leaf == "weight" and stem in tables else name


def _tables(model):
    return {name for name, module in model.named_modules()
            if isinstance(module, torch.nn.Embedding)}


def load_jax_params(model, params, state=None):
    """Copy a JAX param tree and its ``state`` tree (numpy arrays, nested
    dicts and lists) into ``model``'s parameters and buffers. Every key and
    shape is checked; a key left over on either side raises (a model
    without BatchNorm takes an empty or absent ``state``)."""
    own = model.state_dict()
    derived = {name for name, _ in model.named_buffers()} - set(own)
    tables = _tables(model)
    by_jax_name = {_jax_name(name, tables): name for name in own}
    flat = {}
    for tree in (params, state or {}):
        for name, value in _flatten(tree).items():
            if name not in derived:
                flat[by_jax_name.get(name, name)] = value
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"load_jax_params: missing {missing}, unexpected {unexpected} "
            f"for {type(model).__name__}"
        )
    new_state = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        ref = own[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"load_jax_params: {name} has shape {tuple(arr.shape)}, "
                f"the model expects {tuple(ref.shape)}"
            )
        new_state[name] = torch.as_tensor(np.array(arr), dtype=ref.dtype)
    model.load_state_dict(new_state)
    return model


def _tree(model, named):
    tables = _tables(model)
    return _unflatten({
        _jax_name(name, tables): value.detach().cpu().numpy().copy() for name, value in named
    })


def to_jax_params(model):
    """``model``'s parameters as the JAX package's param tree of numpy
    arrays."""
    return _tree(model, model.named_parameters())


def to_jax_state(model):
    """``model``'s persistent buffers (the BatchNorm running statistics) as
    the JAX package's ``state`` tree; ``{}`` for a model without any."""
    own = model.state_dict()
    return _tree(model, [(name, b) for name, b in model.named_buffers() if name in own])


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
    """Fill ``optimizer`` (a ``torch.optim.Adam`` over some of ``model``'s
    parameters) from the JAX package's optimizer state: the optax chain's
    ``ScaleByAdamState(count, mu, nu)`` becomes ``step``, ``exp_avg`` and
    ``exp_avg_sq`` of every parameter of the optimizer; the chain's empty
    states (clipping, weight decay, the learning-rate scale) carry nothing.
    The state of a masked optimizer (the adversarial trainers' two, an optax
    ``multi_transform``) holds one Adam state whose moments cover only its
    group; the parameters outside it are placeholders and are skipped.
    Training resumed from that state takes the same next step in both
    packages.

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
    tables = _tables(model)
    names = {id(p): name for name, p in model.named_parameters()}
    state = {}
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            key = _jax_name(name, tables)
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
