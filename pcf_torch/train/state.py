"""Train state and optimizer, as pcf_tpu/train/state.py builds them.

`make_optimizer(cfg, iter_per_epoch)` returns (tx, schedule): tx clips the
gradients, runs SGD (momentum 0.9, no decay: optax.trace), Adam (coupled L2
`decay_rate`) or AdamW (decoupled `adamw_decay`) from torch.optim, and scales
the step by schedule(count), where count is the number of earlier updates
(optax.scale_by_schedule: the first update takes schedule(0)). The two clip
formulas are pcf_tpu's:
  * accum_iter == 1: optax.clip_by_global_norm, g * c / |g| when |g| >= c;
  * accum_iter > 1: torch_grad_accum, the reference's loop: every micro-step
    adds g / accum_iter into the accumulation and clips the partial sum with
    clip_grad_norm_'s min(1, c / (|acc| + 1e-6)); the optimizer steps at each
    accumulation boundary with the LR of that micro-step.
`tx.update()` reads each bound parameter's .grad (a missing one counts as
zero, as in a pytree) and leaves it as it was, the raw gradient. It is
`begin()` on the host, which writes schedule(count) into the 0-d LR tensor
that the optimizer reads and says whether this update steps, and `apply()`,
device work only, which a captured train step (parallel/graphs.py) replays.
The inner optimizers are torch's fused ones (fused=True; Adam and AdamW also
capturable=True), which take the LR as a tensor on the CPU and on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pcf_torch.ops.kernels.derived import weights_written
from pcf_torch.train import lr as lr_schedules


class Optimizer:
    """clip -> SGD / Adam / AdamW -> -schedule(count); see the module."""

    def __init__(self, cfg, schedule):
        if cfg.optimizer not in ("SGD", "Adam", "AdamW"):
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        self.kind = cfg.optimizer
        self.decay = cfg.decay_rate if self.kind == "Adam" else cfg.get("adamw_decay", 0.0)
        self.schedule = schedule
        self.accum = cfg.get("accum_iter", 1)
        self.clip_norm = float(cfg.grad_clip_norm)
        self.count = 0
        self.params = None
        self.inner = None
        self.acc = None

    def init(self, params) -> "Optimizer":
        self.params = list(params)
        # the LR is read by the optimizer's kernels from this 0-d tensor, which
        # `begin` fills before each update: a captured step reads the new value
        # at every replay, where a Python float would be frozen at capture
        self.lr = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        kw = dict(lr=self.lr, fused=True)
        if self.kind == "SGD":
            self.inner = torch.optim.SGD(self.params, momentum=0.9, **kw)
        else:
            cls = torch.optim.Adam if self.kind == "Adam" else torch.optim.AdamW
            self.inner = cls(self.params, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=self.decay, capturable=True, **kw)
        if self.accum > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
        return self

    def _step(self, grads) -> None:
        """One step of the inner optimizer on `grads`; the parameters' .grad
        is restored afterwards."""
        raw = [p.grad for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        for p, g in zip(self.params, raw):
            p.grad = g

    def begin(self) -> bool:
        """The host's half of an update: schedule(count) into the LR tensor.
        Returns whether this update steps the optimizer (it ends an
        accumulation), which the host decides from the count."""
        self.lr.fill_(self.schedule(self.count))
        return (self.count + 1) % self.accum == 0

    @torch.no_grad()
    def apply(self, steps: bool) -> None:
        """The device's half of an update, with the LR `begin` wrote: clip,
        accumulate, and step the optimizer when `steps`. Launches only
        device work, so a CUDA graph can capture it."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.accum == 1:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            coef = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            self._step(torch._foreach_mul(grads, coef))
        else:
            torch._foreach_add_(self.acc, torch._foreach_div(grads, self.accum))
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self.acc)))
            torch._foreach_mul_(self.acc, (self.clip_norm / (norm + 1e-6)).clamp(max=1.0))
            if steps:
                self._step(self.acc)
                torch._foreach_zero_(self.acc)

    def update(self) -> None:
        """One update of the bound parameters from their .grad, eagerly."""
        self.apply(self.begin())
        self.count += 1
        weights_written(self.params)  # the fused optimizers move no _version

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict(),
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        """Load in place: the LR tensor, the accumulation and every state
        tensor the optimizer already holds keep their addresses, which a
        captured train step reads."""
        held = [dict(self.inner.state.get(p, {})) for p in self.params]
        self.count = state["count"]
        self.inner.load_state_dict(state["inner"])
        for group in self.inner.param_groups:
            group["lr"] = self.lr
        for p, old in zip(self.params, held):
            new = self.inner.state.get(p, {})
            for k, t in old.items():
                if isinstance(t, torch.Tensor) and isinstance(new.get(k), torch.Tensor) \
                        and new[k].shape == t.shape:
                    new[k] = t.copy_(new[k])
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)


def make_optimizer(cfg, iter_per_epoch: int = 1):
    """(tx, schedule): the optimizer of cfg, not yet bound to parameters
    (create_train_state binds it), and its LR schedule."""
    schedule = lr_schedules.from_config(cfg, iter_per_epoch)
    return Optimizer(cfg, schedule), schedule


@dataclass
class TrainState:
    """The step count, the model (parameters and BN running statistics) and
    its optimizer; a train step updates all three in place."""

    step: int
    model: nn.Module
    tx: Optimizer


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, tx=tx.init(model.parameters()))
