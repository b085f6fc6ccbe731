"""The program's readings of its first train steps, for the comparison with
the reference: each step's loss, each optimizer's first gradient as it saw
it (from its first moment after its first step: ``exp_avg / (1 − β1)``)
and the change of every parameter and buffer over the steps; with
``optimizers``, also the whole state the program carries between steps."""

from __future__ import annotations

import torch


class FirstSteps:
    """With ``optimizers`` (tag → optimizer), also a snapshot of everything
    the program carries from step to step, taken before each step and once
    after the last (``snapshots``): parameters and buffers, and each
    optimizer's moments and step count by parameter name. The reference
    checks each step's passage from one snapshot to the next
    (``reference/mf_train.py::train_steps``)."""

    def __init__(self, model, optimizers=None):
        self.model = model
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.initial = {n: t.detach().clone() for n, t in model.state_dict().items()}
        self.out = {"losses": [], "grad": {}}
        self._seen = set()
        self.optimizers = dict(optimizers or {})
        self.snapshots = []

    @torch.no_grad()
    def snapshot(self):
        """The carried state now, on the host: ``{"model": {name: tensor},
        "opt": {tag: {name: (exp_avg, exp_avg_sq, step)}}}``, a parameter
        without optimizer state left out of its tag's map."""
        if not self.optimizers:
            return
        host = {n: t.detach().to("cpu", copy=True) for n, t in self.model.state_dict().items()}
        opt = {}
        for tag, optimizer in self.optimizers.items():
            opt[tag] = {}
            for group in optimizer.param_groups:
                for p in group["params"]:
                    st = optimizer.state.get(p, {})
                    if "exp_avg" in st:
                        opt[tag][self.names[id(p)]] = (st["exp_avg"].to("cpu", copy=True),
                                                       st["exp_avg_sq"].to("cpu", copy=True),
                                                       float(st["step"]))
        self.snapshots.append({"model": host, "opt": opt})

    @torch.no_grad()
    def after_step(self, loss, optimizer):
        self.out["losses"].append(float(loss))
        if id(optimizer) in self._seen:
            return
        self._seen.add(id(optimizer))
        for group in optimizer.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                m = optimizer.state.get(p, {}).get("exp_avg")  # none: no update was applied
                norm = 0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1 - beta1)
                self.out["grad"][self.names[id(p)]] = norm

    @torch.no_grad()
    def finish(self):
        self.snapshot()
        sd = self.model.state_dict()
        self.out["change"] = {n: float(torch.linalg.vector_norm(sd[n].float() - t.float()))
                              for n, t in self.initial.items()}
        self.initial = None
        return self.out
