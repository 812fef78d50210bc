"""Optimizer factory (port of ``mammo_clip_tpu/train/optim.py``).

Three rules with optax's semantics, each with the learning rate read from the
schedule at the optimizer's own update count (0 on the first update) and an
optional global-norm clip (``grad_clip_norm``) applied to the gradients first:

* ``adamw``: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
  parameter unless ``no_decay_patterns`` (regexes over the parameter's dotted
  name) exclude it. ``torch.optim.AdamW``'s update equals optax.adamw's:
  p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
* ``sgd``: ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``, the
  decay added to the gradient of every parameter before the momentum trace
  t <- g + wd * p + momentum * t, then p <- p - lr * t: ``torch.optim.SGD``
  with ``weight_decay`` and ``momentum`` (no dampening, no Nesterov), whose
  first trace is the gradient as optax's zero-initialised one is.
* ``adam``: ``optax.adam(lr)`` at its defaults (b1 0.9, b2 0.999, eps 1e-8, no
  decay; the JAX factory passes no other option), ``torch.optim.Adam``.

As in the JAX factory, ``no_decay_patterns`` applies to ``adamw`` only.

``grad_accum_steps`` = k has ``optax.MultiSteps``' semantics: each micro-step
folds its gradient into a running mean, ``acc += (g - acc) / (mini_step + 1)``;
the k-th applies the inner update (clip, schedule, AdamW) to that mean and
resets it, the others leave the parameters as they are. The update count, and
so the schedule, advances once per k micro-steps.

Under tensor parallelism or ZeRO-3 (``parallel/partitioning.py``) a parameter
may be a shard: its moments are shards too, and the clip's global norm sums
each sharded leaf's squares over the ranks of its axis and counts each
replicated leaf once, so every rank clips by the whole model's norm.

``flatten`` and ``flatten_small_bytes`` regroup the optimizer's leaves into
flat vectors to cut per-leaf launch overhead on a TPU; they do not change the
update's values, so the port accepts them and ignores them.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from ..parallel.partitioning import shard_of


class Optimizer:
    """AdamW (or SGD, Adam: ``name``) over named parameters with a schedule, an
    optional global-norm clip and optional gradient accumulation."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 no_decay_patterns: Sequence[str] = (), grad_clip_norm: Optional[float] = None,
                 accum_steps: int = 1, name: str = "adamw", momentum: float = 0.9):
        if name not in ("adamw", "sgd", "adam"):
            raise KeyError(f"unknown optimizer: {name}")
        regexes = [re.compile(p) for p in no_decay_patterns] if name == "adamw" else []
        decay, no_decay = [], []
        for pname, p in named_params:
            (no_decay if any(r.search(pname) for r in regexes) else decay).append(p)
        groups = [{"params": decay, "weight_decay": weight_decay}]
        if no_decay:
            groups.append({"params": no_decay, "weight_decay": 0.0})
        self.params: List[torch.nn.Parameter] = decay + no_decay
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = max(1, int(accum_steps))
        self.count = 0  # inner updates applied
        self.mini_step = 0  # micro-steps folded into the running mean since the last update
        self._acc: Optional[List[torch.Tensor]] = None
        if name == "adamw":
            self.inner = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps)
        elif name == "sgd":
            self.inner = torch.optim.SGD(groups, lr=0.0, momentum=momentum)
        else:
            self.inner = torch.optim.Adam(self.params, lr=0.0)

    def clip_(self) -> None:
        """optax.clip_by_global_norm: g * max_norm / ||g|| when ||g|| >= max_norm."""
        pairs = [(p, p.grad) for p in self.params if p.grad is not None]
        grads = [g for _, g in pairs]
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
        if not any(shard_of(p) is not None for p, _ in pairs):
            norm = torch.linalg.vector_norm(norms)
        else:  # replicated leaves once, each shard's squares summed over its axis
            total, by_axis = norms.new_zeros(()), {}
            for (p, _), n in zip(pairs, norms):
                s = shard_of(p)
                if s is None:
                    total = total + n * n
                else:
                    by_axis.setdefault(s.axis, (s.group, []))[1].append(n * n)
            for group, squares in by_axis.values():  # the same order on every rank
                t = torch.stack(squares).sum().reshape(1)
                total = total + group(t)[0]
            norm = torch.sqrt(total)
        factor = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                             self.grad_clip_norm / norm)
        for g in grads:
            g.mul_(factor)

    def _accumulate(self) -> bool:
        """Fold this micro-step's gradients into the running mean; True when it
        is the k-th, with the mean left in the parameters' ``.grad``."""
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in self.params]
        m = self.mini_step
        for p, acc in zip(self.params, self._acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (m + 1))
        self.inner.zero_grad(set_to_none=True)
        if m < self.accum_steps - 1:
            self.mini_step += 1
            return False
        for p, acc in zip(self.params, self._acc):
            p.grad = acc
        self._acc, self.mini_step = None, 0
        return True

    def step(self) -> None:
        if self.accum_steps > 1 and not self._accumulate():
            return
        if self.grad_clip_norm:
            self.clip_()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self._acc}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self._acc = (None if sd["acc"] is None else
                     [a.to(p.device) for a, p in zip(sd["acc"], self.params)])


def build_optimizer(config: dict, schedule, named_params,
                    no_decay_patterns: Optional[Sequence[str]] = None) -> Optimizer:
    # config["flatten"] / config["flatten_small_bytes"]: TPU dispatch layouts
    # that leave the update's values unchanged; ignored here (module docstring)
    return Optimizer(named_params, schedule, b1=config.get("beta1", 0.9),
                     b2=config.get("beta2", 0.999), eps=config.get("eps", 1e-8),
                     weight_decay=config.get("weight_decay", 1e-4),
                     no_decay_patterns=no_decay_patterns or (),
                     grad_clip_norm=config.get("grad_clip_norm"),
                     accum_steps=int(config.get("grad_accum_steps", 1) or 1),
                     name=config.get("name", "adamw").lower(),
                     momentum=config.get("momentum", 0.9))
