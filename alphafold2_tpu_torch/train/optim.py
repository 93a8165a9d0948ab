"""The optimizer of distogram pretraining, written against optax's semantics.

Port of ``alphafold2_tpu/train/loop.py`` ``build_optimizer`` (:110-125):

    optax.MultiSteps(
        optax.chain(optax.clip_by_global_norm(1.0),
                    optax.adamw(warmup_cosine_decay_schedule(...), weight_decay)),
        every_k_schedule=gradient_accumulate_every)   # only when k > 1

What that means, step by step, and what :class:`Optimizer` does:

- every micro-step folds its gradient into a running mean (optax's Welford
  form ``acc + (g - acc) / (n + 1)``); a gradient the train step zeroed
  because it was not finite still counts in that mean;
- on the k-th micro-step the mean runs through the inner chain and the
  accumulator resets; on the others the parameters do not move;
- the inner chain clips the mean to global norm 1 (``t / norm * 1`` when
  the norm reaches 1), updates Adam's moments (b1 0.9, b2 0.999, eps 1e-8,
  bias-corrected with the incremented count), adds ``weight_decay * param``
  to every leaf, and scales by ``-lr`` where lr is the schedule at the inner
  count *before* it increments: the first applied update uses
  ``schedule(0)``, which is 0 for a warmup from 0.

Scalars (learning rate, bias corrections) are float32, as optax computes
them; tensor math runs in the parameters' dtype with ``torch._foreach`` ops.
The parameters are updated in place.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

_F32 = np.float32


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax's schedule of the same name: a linear ramp from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``, in float32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule
            c = _F32(max(count, 0))
            frac = _F32(1) - c / _F32(warmup_steps)
            return float(_F32(init_value - peak_value) * frac + _F32(peak_value))
        # optax.cosine_decay_schedule at count - warmup_steps
        c = _F32(min(count - warmup_steps, cosine_steps))
        cosine = _F32(0.5) * (_F32(1) + _F32(math.cos(_F32(math.pi) * c / _F32(cosine_steps))))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return float(_F32(peak_value) * decayed)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """MultiSteps(k) over clip_by_global_norm + AdamW, on ``params``.

    ``step(grads)`` takes one micro-step's gradients (one tensor per
    parameter, same order); it returns True on the micro-steps that applied
    an update. State: Adam's ``mu``/``nu`` and ``count``, the accumulator
    ``acc`` and ``mini_step`` (k > 1)."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float = 0.0, every_k: int = 1, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.every_k = int(every_k)
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # inner updates applied
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.every_k > 1 else None

    def state_dict(self) -> dict:
        """Adam's moments and count, the accumulator and its micro-step
        (tensors are the live ones: a caller that keeps them copies)."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count,
                "mini_step": self.mini_step,
                "acc": list(self.acc) if self.acc is not None else None}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this optimizer's tensors (which
        keep their device); the accumulator must match ``every_k``."""
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the checkpoint's gradient accumulation does not "
                             f"match every_k={self.every_k}")
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc or [], state["acc"] or [])):
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state for {len(theirs)} parameters, "
                                 f"expected {len(mine)}")
            for a, b in zip(mine, theirs):
                if a.shape != b.shape:
                    raise ValueError(f"optimizer state of shape {tuple(b.shape)}, "
                                     f"expected {tuple(a.shape)}")
                a.copy_(b)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        grads = list(grads)
        if self.acc is None:
            self._inner(grads)
            return True
        # Welford mean: acc + (g - acc) / (n + 1)
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        self._inner(self.acc)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        return True

    def _inner(self, grads) -> None:
        # clip_by_global_norm: t if norm < max_norm else (t / norm) * max_norm
        g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        updates = torch._foreach_div(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(updates, torch.where(keep, one, one * self.max_norm))
        # scale_by_adam
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(updates, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        sq = torch._foreach_mul(updates, updates)
        torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1 - b2))
        count_inc = self.count + 1
        bc1 = float(_F32(1) - _F32(b1) ** _F32(count_inc))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(count_inc))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(updates, denom)
        # add_decayed_weights, then scale_by_learning_rate at the pre-increment count
        torch._foreach_add_(updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(updates, -float(_F32(self.schedule(self.count))))
        torch._foreach_add_(self.params, updates)
        self.count = count_inc


def build_optimizer(cfg, params: Sequence[torch.Tensor]) -> Optimizer:
    """The optimizer ``cfg.train`` describes (JAX ``build_optimizer``)."""
    t = cfg.train
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=t.learning_rate,
        warmup_steps=t.warmup_steps,
        decay_steps=max(t.num_steps, t.warmup_steps + 1),
        end_value=t.learning_rate * 0.1,
    )
    return Optimizer(params, schedule, weight_decay=t.weight_decay,
                     every_k=max(1, t.gradient_accumulate_every))
