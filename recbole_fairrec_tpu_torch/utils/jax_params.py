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
turns the JAX package's Adam, Adagrad or RMSprop state, whole or masked to
one optimizer's parameters, into the port optimizer's.
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


# optax states that hold numbers, by class name, and the learner each one
# belongs to (the state arrives either as optax's own named tuples or, from a
# checkpoint read without JAX, as tuples that keep only the class name and
# the fields in order)
_LEARNER_OF_STATE = {
    "ScaleByAdamState": "adam",
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


def _learner_of(optimizer):
    from ..trainer.optim import Adagrad, RMSprop

    for cls, learner in ((torch.optim.Adam, "adam"), (Adagrad, "adagrad"),
                         (RMSprop, "rmsprop"), (torch.optim.SGD, "sgd")):
        if isinstance(optimizer, cls):
            return learner
    return type(optimizer).__name__


def _per_parameter_trees(learner, state):
    """The optax state's trees under the port optimizer's state keys, and
    the step count (Adam's only)."""
    if learner == "adam":
        count, mu, nu = state
        return {"exp_avg": mu, "exp_avg_sq": nu}, count
    # ScaleByRssState(sum_of_squares); ScaleByRmsState(nu) or
    # ScaleByRmsWithCountState(count, nu): the accumulator is the last field
    return {"acc": state[-1]}, None


def load_jax_opt_state(optimizer, model, opt_state_tree):
    """Fill ``optimizer`` (over some of ``model``'s parameters) from the JAX
    package's optimizer state of the same learner. The optax chain's one
    state with numbers becomes the port optimizer's per-parameter state:
    ``ScaleByAdamState(count, mu, nu)`` → ``step``, ``exp_avg`` and
    ``exp_avg_sq`` of ``torch.optim.Adam``; ``ScaleByRssState(sum_of_squares)``
    (adagrad) and ``ScaleByRmsState(nu)`` / ``ScaleByRmsWithCountState(count,
    nu)`` (rmsprop) → ``acc`` of ``trainer/optim.py``'s ``Adagrad`` /
    ``RMSprop``, which keep no step count. SGD's chain holds no numbers and
    carries nothing; the chain's other states (clipping, weight decay, the
    learning-rate scale) are empty. The state of a masked optimizer (the
    adversarial trainers', an optax ``multi_transform``) covers only its
    group; the parameters outside it are placeholders and are skipped.
    Training resumed from that state takes the same next step in both
    packages.

    Raises:
        NotImplementedError: for a state of another learner than the
            optimizer's.
    """
    learner = _learner_of(optimizer)
    states = list(_find_states(opt_state_tree, set(_LEARNER_OF_STATE)))
    found = [_LEARNER_OF_STATE[type(s).__name__] for s in states]
    if found != ([] if learner == "sgd" else [learner]):
        raise NotImplementedError(
            f"the JAX optimizer state of learner {found or ['sgd']} cannot be carried "
            f"into a {type(optimizer).__name__} (learner [{learner}]); adam, adagrad, "
            "rmsprop and sgd states are mapped onto their own learner only"
        )
    if not states:
        return optimizer
    trees, count = _per_parameter_trees(learner, states[0])
    trees = {key: _flatten(tree) for key, tree in trees.items()}
    tables = _tables(model)
    names = {id(p): name for name, p in model.named_parameters()}
    state = {}
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            key = _jax_name(name, tables)
            entry = {}
            for slot, flat in trees.items():
                if key not in flat or tuple(np.shape(flat[key])) != tuple(p.shape):
                    raise KeyError(f"load_jax_opt_state: no {learner} state for parameter {name}")
                entry[slot] = torch.as_tensor(np.array(flat[key]), dtype=p.dtype)
            if count is not None:
                entry["step"] = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
            state[index] = entry
            index += 1
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
    )
    return optimizer
