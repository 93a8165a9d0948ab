"""Parameters redrawn under PyTorch's module defaults (``model.init_scheme="torch"``).

Port of ``alphafold2_tpu/models/init.py`` ``torch_match_reinit`` (:48): the
reference trains plain ``nn.Linear``/``nn.Embedding``/``nn.LayerNorm``
modules at their defaults, so

- every ``Dense`` weight and its bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  with fan_in as JAX counts it from the flax kernel (in, out): its leading
  axis, which is the port's ``in_features``; the KV compression's
  ``Conv1d`` likewise, with fan_in = ratio * in/groups (the flax kernel's
  leading axes);
- every embedding table ~ N(0, 1);
- LayerNorm stays at ones and zeros.

Each module's draws come from its own ``torch.Generator`` keyed by
``(seed, crc32(flax path))``, the flax path being ``params/`` and the
module's name with ``/`` for ``.`` (the port's modules carry the flax
names). The bits differ from JAX's threefry draws; the distributions are
the same. ``scan_layers`` and the reversible engine stack a depth axis onto
their kernels and are refused by the caller (``train.loop.init_state``),
as in JAX.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
from torch import nn

from alphafold2_tpu_torch.ops.layers import Dense


def path_generator(seed: int, path: str) -> torch.Generator:
    """A CPU generator keyed by ``(seed, crc32(path))``: the same tree and
    seed give the same parameters in every process."""
    key = np.random.SeedSequence([int(seed) % 2**32, zlib.crc32(path.encode())])
    return torch.Generator().manual_seed(int(key.generate_state(1, np.uint64)[0]))


@torch.no_grad()
def torch_match_reinit(model: nn.Module, seed: int) -> nn.Module:
    """Redraw ``model``'s Dense, conv and embedding parameters in place
    under the torch defaults above; LayerNorm and dtypes are kept."""
    for name, mod in model.named_modules():
        path = "/".join(("params",) + tuple(name.split(".")))
        if isinstance(mod, (Dense, nn.Conv1d)):
            gen = path_generator(seed, path)
            fan_in = (mod.in_features if isinstance(mod, Dense)
                      else mod.in_channels // mod.groups * mod.kernel_size[0])
            bound = 1.0 / math.sqrt(fan_in)
            for p in (mod.weight, mod.bias):
                if p is not None:
                    draw = torch.rand(p.shape, generator=gen, dtype=torch.float32)
                    p.copy_((2.0 * draw - 1.0) * bound)
        elif isinstance(mod, nn.Embedding):
            gen = path_generator(seed, path)
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen,
                                         dtype=torch.float32))
    return model
