"""Flax parameters of the JAX ``End2EndModel`` -> the port's ``state_dict``.

Input: the nested dict of numpy arrays that ``jax.tree_util`` gives for the
flax parameter tree (an outer ``"params"`` level is optional). The port's
modules carry the flax names, so a leaf's path is its module path, and the
leaf name alone decides the mapping:

- ``Dense``/``DenseGeneral`` ``kernel`` (in, out) -> ``Dense.weight`` (out, in),
  including the SE(3) ``v_mix`` and ``to_delta`` kernels;
- ``Embed`` ``embedding`` -> ``Embed.weight``;
- ``LayerNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- ``Dense`` ``bias`` -> ``bias``;
- the raw leaf ``sidechain_proj`` of ``SE3TemplateEmbedder`` (a flax
  ``param``) -> the parameter of the same name;
- the KV compression's ``Conv`` ``kv_compress/kernel`` (ratio, in/groups,
  out) -> ``kv_compress.weight`` (out, in/groups, ratio) of the grouped
  ``conv1d``, and its ``bias`` -> ``bias``.

The scanned and reversible trunks stack their layers' parameters on a
leading depth axis (``trunk/scan/layer/...``, ``trunk/reversible/layers/...``,
as the port's ``scan.layer`` and ``reversible.layers`` do): under those
paths a ``kernel`` is (depth, in, out) and maps to (depth, out, in) (a
conv kernel (depth, ratio, in/groups, out) to (depth, out, in/groups,
ratio)), and every other leaf keeps its depth axis.

Every flax leaf must map exactly once onto a parameter of the target module
with the same shape, and every parameter of the module must be filled:
anything else raises. No JAX import is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias", "sidechain_proj": "sidechain_proj"}
# the module paths under which each leaf carries a leading depth axis
_STACKED = (("scan", "layer"), ("reversible", "layers"))


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def to_state_dict(flax_params: Mapping, module: torch.nn.Module) -> dict:
    """Map a flax parameter tree onto ``module``'s parameters; returns a
    state_dict of float32 CPU tensors for ``module.load_state_dict``."""
    tree = flax_params
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out: dict = {}
    sources: dict = {}
    unmapped = []
    for path, value in _leaves(tree):
        leaf = path[-1]
        if leaf not in _LEAF_NAMES:
            unmapped.append("/".join(path))
            continue
        key = ".".join(path[:-1] + (_LEAF_NAMES[leaf],))
        if key not in expected:
            unmapped.append("/".join(path))
            continue
        if key in out:
            raise ValueError(
                f"flax leaves {sources[key]} and {'/'.join(path)} both map to {key}"
            )
        arr = np.array(value, dtype=np.float32)
        if leaf == "kernel":
            stacked = any(pair in zip(path, path[1:]) for pair in _STACKED)
            conv = len(path) > 1 and path[-2] == "kv_compress"
            if arr.ndim != 2 + conv + stacked:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            # Dense (in, out) -> (out, in); Conv (k, in/g, out) -> (out, in/g, k)
            arr = arr.swapaxes(-1, -3) if conv else arr.swapaxes(-1, -2)
        if tuple(arr.shape) != expected[key]:
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {arr.shape} != {expected[key]}"
            )
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
        sources[key] = "/".join(path)
    if unmapped:
        raise ValueError(f"flax leaves with no target parameter: {unmapped}")
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"parameters no flax leaf fills: {missing}")
    return out
