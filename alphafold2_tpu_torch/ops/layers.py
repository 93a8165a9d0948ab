"""Parameterized layers with flax's numerics, named after their flax twins.

- :class:`Dense` computes in its input's dtype (flax ``nn.Dense(dtype=...)``
  casts its f32 kernel to the compute dtype); the weight stays f32.
- :class:`LayerNorm` uses flax's epsilon 1e-6 (PyTorch's default is 1e-5)
  and computes in f32, its weight and bias cast to f32 too (a bf16 serving
  model casts them to bf16 at build), returning the input's dtype: flax's
  numerics, f32 statistics and bf16 out.

Embeddings are plain ``nn.Embedding`` tables; callers cast to their compute
dtype. ``convert.py`` maps flax ``kernel``/``scale``/``embedding`` leaves
onto these layers' ``weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


class Dense(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
            self.eps,
        )
        return y.to(x.dtype)
