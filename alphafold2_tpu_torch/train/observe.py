"""Re-export shim, as ``alphafold2_tpu/train/observe.py``: the training
telemetry lives in :mod:`alphafold2_tpu_torch.observe`."""

from alphafold2_tpu_torch.observe import MetricsLogger, Profiler, Span, Tracer  # noqa: F401

__all__ = ["MetricsLogger", "Profiler", "Span", "Tracer"]
