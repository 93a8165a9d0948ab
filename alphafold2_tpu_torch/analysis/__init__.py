"""The port's pre-hardware analysis layer (counterpart of
``alphafold2_tpu/analysis``).

- :mod:`lint` — AST rules over the port's source (host syncs in forward
  passes and kernel wrappers, global RNG, JAX imports, quiet CPU
  fallbacks, the lock rules), pure stdlib. CLI:
  ``python -m alphafold2_tpu_torch.analysis.lint alphafold2_tpu_torch chip_smoke.py``.
- :mod:`audit` — runs the registered targets (:mod:`targets`: model
  forward, train step and gradients, serve forward, the attention
  wrappers) under a dispatch mode that records every aten op, and rejects
  float64, host syncs, large host-built tensors, implicit dtype promotion
  and, on the card, a footprint over the target's budget (:mod:`budgets`);
  folds in the build gate's failures. CLI:
  ``python -m alphafold2_tpu_torch.analysis.audit [--device cpu|cuda]``.
- :mod:`lowering` — the Hopper build gate: every kernel source built for
  sm_90a, ptxas's report and each source's launch plan held against the
  card's limits, and X's negative control refused. CLI:
  ``python -m alphafold2_tpu_torch.analysis.lowering [case ...]``.

Every submodule loads lazily, so importing this package imports nothing
else: the lint stays stdlib-only and fast, and ``python -m`` runs each CLI
without loading it twice. :mod:`audit`, :mod:`budgets`, :mod:`lowering` and
:mod:`targets` import torch.
"""

__all__ = [
    "Finding",
    "RULES",
    "audit",
    "budgets",
    "lint",
    "lint_file",
    "lint_paths",
    "lint_source",
    "lowering",
    "targets",
]


_LINT_NAMES = ("Finding", "RULES", "lint_file", "lint_paths", "lint_source")


def __getattr__(name):
    import importlib

    if name in ("audit", "budgets", "lint", "lowering", "targets"):
        return importlib.import_module(f"alphafold2_tpu_torch.analysis.{name}")
    if name in _LINT_NAMES:
        return getattr(importlib.import_module("alphafold2_tpu_torch.analysis.lint"), name)
    raise AttributeError(name)
