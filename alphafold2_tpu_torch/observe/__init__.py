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
- :mod:`registry` — ``MetricsRegistry``: named counters, gauges and
  rolling windows with periodic snapshots; :mod:`exposition` renders a
  snapshot as a Prometheus text endpoint (``/metrics``, ``/healthz``,
  ``AF2TPU_METRICS_PORT``).
- :mod:`slo` — declarative ``SLOSpec`` objectives with multi-window
  burn-rate alerting over the resolved-request stream.
- :mod:`flightrec` — ``FlightRecorder``: bounded rings of recent telemetry
  dumped as a scrubbed incident file on a watchdog fire, a dispatch error
  or SIGTERM.
- :mod:`watchdog` — ``LivenessWatchdog``: per-stage deadlines backed by a
  subprocess probe of the CUDA card.
- :mod:`workload` — ``WorkloadRecorder``: the request stream as a
  scrubbed, replayable JSONL log, the replay builder and the seeded
  synthetic diurnal generator.
- :mod:`flops` — counted flops and peak memory of a serving forward
  (``FlopCounterMode`` plus the kernels' analytic counts), the cards'
  published peaks and MFU.
- :mod:`regress` — the device-keyed perf regression gate over bench and
  serve records.
"""

from alphafold2_tpu_torch.observe import flops, numerics, regress
from alphafold2_tpu_torch.observe.flightrec import FlightRecorder, scrub_env
from alphafold2_tpu_torch.observe.histogram import Histogram
from alphafold2_tpu_torch.observe.memory import MemorySampler
from alphafold2_tpu_torch.observe.metrics import EventCounters, MetricsLogger, flatten_metrics
from alphafold2_tpu_torch.observe.numerics import tag
from alphafold2_tpu_torch.observe.profiler import Profiler
from alphafold2_tpu_torch.observe.registry import MetricsRegistry
from alphafold2_tpu_torch.observe.slo import SLOMonitor, SLOSpec, parse_slo_specs
from alphafold2_tpu_torch.observe.tracectx import TraceContext, current_trace, use_trace
from alphafold2_tpu_torch.observe.tracing import Span, Tracer, device_idle_fraction
from alphafold2_tpu_torch.observe.watchdog import LivenessWatchdog, probe_backend
from alphafold2_tpu_torch.observe.workload import (
    WorkloadRecorder,
    build_replay,
    load_workload,
    synthetic_diurnal,
)

__all__ = ["EventCounters", "FlightRecorder", "Histogram", "LivenessWatchdog", "MemorySampler",
           "MetricsLogger", "MetricsRegistry", "Profiler", "SLOMonitor", "SLOSpec", "Span",
           "TraceContext", "Tracer", "WorkloadRecorder", "build_replay", "current_trace",
           "device_idle_fraction", "flatten_metrics", "flops", "load_workload", "numerics",
           "parse_slo_specs", "probe_backend", "regress", "scrub_env", "synthetic_diurnal", "tag",
           "use_trace"]
