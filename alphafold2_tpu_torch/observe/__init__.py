"""The telemetry, ported from ``alphafold2_tpu/observe/``.

- :mod:`metrics` — ``MetricsLogger`` (one JSON record a line plus stdout),
  ``flatten_metrics`` and the thread-safe ``EventCounters`` (requests,
  batches, compiles, cache hits).
- :mod:`numerics` — ``tag(name, x)`` and ``collect()``: per-tensor
  statistics (L2, max-abs over the finite entries, NaN and Inf counts) of
  the tensors the model tags, for ``train.numerics="full"`` and the NaN
  triage of a skipped step.
- :mod:`tracing` — ``Tracer``/``Span``: host spans as a streaming
  Chrome-trace array (``train.trace_events``, the serving engine's
  ``tracer``), carrying the active trace context's ids.
- :mod:`tracectx` — the request-scoped ``TraceContext`` (W3C-traceparent
  ids; ``current_trace``/``use_trace``), trace reconstruction and
  completeness over emitted events.
- :mod:`histogram` — the streaming log-bucketed ``Histogram`` with
  p50/p95/p99 snapshots (serving latency, queue wait, occupancy).
- :mod:`memory` — ``MemorySampler`` over ``torch.cuda``'s allocator
  statistics (nothing on the CPU).
- :mod:`profiler` — ``Profiler``: a ``torch.profiler`` window over
  ``train.profile_steps``, written as a Chrome trace into
  ``train.profile_dir``.

Not ported yet: the rest of JAX's serving telemetry plane (registry, slo,
exposition, flightrec, watchdog, workload, regress) and ``flops``.
"""

from alphafold2_tpu_torch.observe.histogram import Histogram
from alphafold2_tpu_torch.observe.memory import MemorySampler
from alphafold2_tpu_torch.observe.metrics import EventCounters, MetricsLogger, flatten_metrics
from alphafold2_tpu_torch.observe.profiler import Profiler
from alphafold2_tpu_torch.observe.tracectx import TraceContext, current_trace, use_trace
from alphafold2_tpu_torch.observe.tracing import Span, Tracer

__all__ = ["EventCounters", "Histogram", "MemorySampler", "MetricsLogger", "Profiler", "Span",
           "TraceContext", "Tracer", "current_trace", "flatten_metrics", "use_trace"]
