"""Per-tensor numerics telemetry: the stats of tagged tensors.

Port of ``alphafold2_tpu/observe/numerics.py``. ``tag(name, x)`` is an
identity; while a :func:`collect` block is active on the calling thread it
also records ``x``'s statistics (L2 norm and max-abs over the finite
entries, NaN and Inf counts, in float32). The model tags its embeddings,
each trunk layer's streams (the trunk's output under the scanned and
reversible engines), the distogram logits and the loss, in forward order;
each record carries its ``index``, so :func:`first_nonfinite` names the
first tensor that went bad.

Eager PyTorch runs the stats as the forward runs, so they are device
tensors computed on the spot, and the host reads them only where the
training loop logs them. Without a collector ``tag`` launches nothing.
A tag fires where its Python runs: the trunk tags sit outside the
checkpointed layer, so remat's recompute does not tag again, and the
reversible backward's re-evaluation runs no tag.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterable, Optional

import torch

STAT_KEYS = ("l2", "max_abs", "nan_count", "inf_count")


@torch.no_grad()
def tensor_stats(x: torch.Tensor) -> dict:
    """``l2`` and ``max_abs`` over the finite entries of ``x`` in float32
    (one Inf would otherwise hide the magnitude), ``nan_count`` and
    ``inf_count`` as int32; 0-d device tensors."""
    xf = x.detach().float()
    safe = torch.where(torch.isfinite(xf), xf, 0.0)
    max_abs = safe.abs().amax() if safe.numel() else safe.new_zeros(())
    return {"l2": safe.square().sum().sqrt(), "max_abs": max_abs,
            "nan_count": torch.isnan(xf).sum().to(torch.int32),
            "inf_count": torch.isinf(xf).sum().to(torch.int32)}


def tree_stats(tensors: Iterable[torch.Tensor]) -> dict:
    """:func:`tensor_stats` over several tensors (one parameter group's
    gradients): l2 as a global norm, max and counts across them."""
    per = [tensor_stats(t) for t in tensors]
    if not per:
        z = torch.zeros((), dtype=torch.float32)
        return {"l2": z, "max_abs": z, "nan_count": z.to(torch.int32),
                "inf_count": z.to(torch.int32)}
    return {"l2": torch.stack([s["l2"] for s in per]).square().sum().sqrt(),
            "max_abs": torch.stack([s["max_abs"] for s in per]).amax(),
            "nan_count": torch.stack([s["nan_count"] for s in per]).sum().to(torch.int32),
            "inf_count": torch.stack([s["inf_count"] for s in per]).sum().to(torch.int32)}


class Collector:
    """``{name: {"index": i, **tensor_stats}}`` in tag order; a repeated
    name becomes ``name#2``, ``name#3``, ..."""

    def __init__(self):
        self._stats: dict = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        base, n = name, 1
        while name in self._stats:
            n += 1
            name = f"{base}#{n}"
        self._stats[name] = {"index": len(self._stats), **tensor_stats(x)}

    def stats(self) -> dict:
        return dict(self._stats)


class _ThreadState(threading.local):
    collector: Optional[Collector] = None


_STATE = _ThreadState()


def tag(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; its stats are recorded when a collector is active on
    this thread."""
    col = _STATE.collector
    if col is not None:
        col.record(name, x)
    return x


@contextmanager
def collect(enabled: bool = True):
    """Record the tags fired in the block into the yielded
    :class:`Collector`; ``enabled=False`` yields one that stays empty."""
    if not enabled:
        yield Collector()
        return
    prev = _STATE.collector
    col = Collector()
    _STATE.collector = col
    try:
        yield col
    finally:
        _STATE.collector = prev


# --------------------------------------------------------------- host side


def stats_to_host(stats: dict) -> dict:
    """Device scalars -> python floats (reads them)."""
    return {name: {k: float(v) for k, v in s.items()} for name, s in stats.items()}


def _ordered(stats: dict):
    return sorted(stats.items(), key=lambda kv: float(kv[1].get("index", 0)))


def first_nonfinite(stats: dict) -> Optional[str]:
    """The first tensor, in tag order, with a NaN or an Inf; None if none."""
    for name, s in _ordered(stats):
        if float(s.get("nan_count", 0)) or float(s.get("inf_count", 0)):
            return name
    return None


def flatten_stats(stats: dict, prefix: str = "numerics") -> dict:
    """``{"numerics/<name>/<stat>": float}``, the vocabulary metrics.jsonl
    and the trace counters share (``index`` is dropped)."""
    return {f"{prefix}/{name}/{k}": float(v)
            for name, s in stats.items() for k, v in s.items() if k != "index"}


def triage_report(stats: dict, step: Optional[int] = None) -> dict:
    """The NaN-triage record: the first non-finite tensor in tag order,
    every non-finite tensor, and the whole table on the host."""
    host = stats_to_host(stats)
    bad = [name for name, s in _ordered(host) if s.get("nan_count") or s.get("inf_count")]
    return {"event": "nan_triage", **({"step": int(step)} if step is not None else {}),
            "first_nonfinite": bad[0] if bad else None, "nonfinite": bad, "tensors": host}


def counters_to_tracer(stats: dict, tracer, prefix: str = "numerics") -> None:
    """One Chrome-trace counter event a tagged tensor, named
    ``numerics/<name>`` as in :func:`flatten_stats`."""
    if tracer is None or not getattr(tracer, "enabled", False):
        return
    for name, s in stats.items():
        tracer.counter(f"{prefix}/{name}", **{k: float(v) for k, v in s.items() if k != "index"})
