"""Optimizer steps that ``torch.optim`` computes differently from the JAX
package's optax chains, written by hand to the JAX rule.

* ``Adagrad``: optax ``scale_by_rss(0.0, 1e-10)`` — ``g / sqrt(Σg² + eps)``,
  0 where Σg² is 0. ``torch.optim.Adagrad`` divides by ``sqrt(Σg²) + eps``.
* ``RMSprop``: optax ``scale_by_rms(0.99, 1e-8)`` with eps inside the root —
  ``g / sqrt(ν + eps)``. ``torch.optim.RMSprop`` divides by ``sqrt(ν) + eps``.
* ``clip_by_global_norm``: optax's — gradients are left alone while their
  global norm is below ``max_norm``, else scaled by ``max_norm / norm``.
  ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.

Weight decay is added to the gradient before the accumulators, as
``optax.add_decayed_weights`` ahead of the scaler does.
"""

from __future__ import annotations

import torch


class _AccumulatorOptimizer(torch.optim.Optimizer):
    """One accumulator ``acc`` per parameter; subclasses give its update and
    the scale it yields. The step is ``p -= lr * scale * (g + wd * p)``."""

    def __init__(self, params, lr, weight_decay=0.0, eps=1e-8):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay, "eps": eps})

    def _scale(self, acc, grad, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad = p.grad
                if group["weight_decay"]:
                    grad = grad.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["acc"] = torch.zeros_like(p)
                scale = self._scale(state["acc"], grad, group)
                p.addcmul_(grad, scale, value=-group["lr"])
        return loss


class Adagrad(_AccumulatorOptimizer):
    def __init__(self, params, lr, weight_decay=0.0, eps=1e-10):
        super().__init__(params, lr, weight_decay, eps)

    def _scale(self, acc, grad, group):
        acc.addcmul_(grad, grad)
        return torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))


class RMSprop(_AccumulatorOptimizer):
    def __init__(self, params, lr, weight_decay=0.0, eps=1e-8, decay=0.99):
        super().__init__(params, lr, weight_decay, eps)
        for group in self.param_groups:
            group["decay"] = decay

    def _scale(self, acc, grad, group):
        acc.mul_(group["decay"]).addcmul_(grad, grad, value=1.0 - group["decay"])
        return torch.rsqrt(acc + group["eps"])


@torch.no_grad()
def clip_by_global_norm(parameters, max_norm, norms=None):
    """Scale the gradients of ``parameters`` in place so that their global L2
    norm is at most ``max_norm``; returns the norm before clipping. No host
    read: the choice is a ``where`` on the device. ``norms``: each
    gradient's norm where the caller knows better (a row-sharded table's is
    that of all its shards)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return None
    if norms is None:
        norms = [torch.linalg.vector_norm(g) for g in grads]
    norm = torch.linalg.vector_norm(torch.stack(norms))
    below = norm < max_norm
    for g in grads:
        g.copy_(torch.where(below, g, g / norm * max_norm))
    return norm
