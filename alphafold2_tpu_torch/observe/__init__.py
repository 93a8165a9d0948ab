"""The training loops' telemetry, ported from ``alphafold2_tpu/observe/``.

- :mod:`metrics` — ``MetricsLogger`` (one JSON record a line plus stdout)
  and ``flatten_metrics``.
- :mod:`numerics` — ``tag(name, x)`` and ``collect()``: per-tensor
  statistics (L2, max-abs over the finite entries, NaN and Inf counts) of
  the tensors the model tags, for ``train.numerics="full"`` and the NaN
  triage of a skipped step.
- :mod:`tracing` — ``Tracer``/``Span``: host spans as a streaming
  Chrome-trace array (``train.trace_events``).
- :mod:`profiler` — ``Profiler``: a ``torch.profiler`` window over
  ``train.profile_steps``, written as a Chrome trace into
  ``train.profile_dir``.

The serving telemetry plane of the JAX package (tracectx, registry, slo,
flight recorder, histograms, memory, flops) is not ported here.
"""

from alphafold2_tpu_torch.observe.metrics import MetricsLogger, flatten_metrics
from alphafold2_tpu_torch.observe.profiler import Profiler
from alphafold2_tpu_torch.observe.tracing import Span, Tracer

__all__ = ["MetricsLogger", "Profiler", "Span", "Tracer", "flatten_metrics"]
