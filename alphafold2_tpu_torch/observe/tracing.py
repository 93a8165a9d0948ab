"""Host span tracing written as Chrome trace events.

Port of ``alphafold2_tpu/observe/tracing.py``: ``Tracer.span("train.step",
step=3)`` times a region and emits one complete (``"ph": "X"``) event. The
file opens with ``[`` and holds one event a line with a trailing comma,
flushed as each event completes, so it is at once a streaming JSONL file
and a Chrome-trace array that Perfetto and ``chrome://tracing`` load
without the closing ``]``; a killed process still leaves a loadable trace.
A tracer without a path and not enabled does nothing.

When a request-scoped :mod:`tracectx` context is active on the thread
(``use_trace``), a span mints a child context for its region and carries
its ids (``trace_id``, ``span_id``, ``parent_id``), and an instant carries
the active context's, as JAX's ``Tracer`` attaches them (:25, :118-143,
:173-187). No context is active in a training loop, so its spans carry
only their own args.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional, Tuple

from alphafold2_tpu_torch.observe.tracectx import current_trace, use_trace

# one timeline origin a process, shared by every tracer
_PROC_T0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _PROC_T0) * 1e6


class Span:
    """What ``Tracer.span`` yields: ``set(key=value)`` attaches args before
    the span ends; ``duration_s`` is set when it ends."""

    __slots__ = ("name", "args", "duration_s")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self.duration_s = 0.0

    def set(self, **kw) -> "Span":
        self.args.update(kw)
        return self


class _NullSpan:
    __slots__ = ()

    def set(self, **kw):
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span tracer. ``path=None`` keeps the events in memory
    only (``events``, ``span_totals``); ``enabled`` defaults to whether a
    path is given."""

    def __init__(self, path: Optional[str] = None, enabled: Optional[bool] = None):
        self.enabled = bool(path) if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._events: list = []
        self._sinks: list = []
        self._file = None
        if self.enabled and path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "w")
            self._file.write("[\n")
            self._file.flush()

    @classmethod
    def from_env(cls, var: str = "AF2TPU_TRACE_EVENTS") -> "Tracer":
        """A tracer writing to ``$AF2TPU_TRACE_EVENTS``, disabled when it
        is unset (JAX's ``observe/tracing.py:87``)."""
        return cls(path=os.environ.get(var) or None)

    def add_sink(self, sink) -> None:
        """Call ``sink(event)`` for every event emitted from now on. Sinks
        run outside the tracer's lock, so a slow or re-entrant sink stalls
        no other emitter."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def _emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
            sinks = list(self._sinks)
            if self._file is not None:
                self._file.write(json.dumps(event) + ",\n")
                self._file.flush()
        for sink in sinks:
            try:
                sink(event)
            except Exception:  # noqa: BLE001 — a broken sink must not lose the trace
                pass

    @contextmanager
    def span(self, name: str, **args):
        """Time the block; one complete event on exit, also when it raises
        (the event then carries ``error``). Under an active trace context
        (and without explicit ids in ``args``) the region runs under a
        child context whose ids the event carries, so nested spans chain
        their parent ids."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        sp = Span(name, dict(args))
        ctx = None
        if "trace_id" not in sp.args:
            cur = current_trace()
            if cur is not None:
                ctx = cur.child()
                sp.args.update(ctx.event_args())
        t0 = _now_us()
        try:
            if ctx is not None:
                with use_trace(ctx):
                    yield sp
            else:
                yield sp
        except BaseException as e:
            sp.args["error"] = type(e).__name__
            raise
        finally:
            t1 = _now_us()
            sp.duration_s = (t1 - t0) / 1e6
            self._emit({"name": name, "ph": "X", "ts": round(t0, 1), "dur": round(t1 - t0, 1),
                        "pid": os.getpid(), "tid": threading.get_ident(),
                        **({"args": sp.args} if sp.args else {})})

    def span_event(self, name: str, t0_s: float, t1_s: float, **args) -> None:
        """A complete span with explicit bounds in ``time.perf_counter``
        seconds, for a region known only after it ended."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "X", "ts": round((t0_s - _PROC_T0) * 1e6, 1),
                    "dur": round(max(0.0, (t1_s - t0_s) * 1e6), 1), "pid": os.getpid(),
                    "tid": threading.get_ident(), **({"args": dict(args)} if args else {})})

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``"ph": "i"``), carrying the active
        trace context's ids unless ``args`` has its own."""
        if not self.enabled:
            return
        if "trace_id" not in args:
            cur = current_trace()
            if cur is not None:
                args = {**args, **cur.event_args()}
        self._emit({"name": name, "ph": "i", "ts": round(_now_us(), 1), "s": "p",
                    "pid": os.getpid(), "tid": threading.get_ident(),
                    **({"args": dict(args)} if args else {})})

    def counter(self, name: str, **values) -> None:
        """A counter sample (``"ph": "C"``)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C", "ts": round(_now_us(), 1), "pid": os.getpid(),
                    "args": dict(values)})

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def span_totals(self) -> dict:
        """``{name: {count, total_s, max_s}}`` over the complete events."""
        out: dict = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            agg = out.setdefault(e["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            dur_s = e.get("dur", 0.0) / 1e6
            agg["count"] += 1
            agg["total_s"] = round(agg["total_s"] + dur_s, 6)
            agg["max_s"] = round(max(agg["max_s"], dur_s), 6)
        return out

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                self._file.close()
                self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from a finalizer
            pass


def merge_intervals(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted spans."""
    merged: list = []
    for start, end in sorted((s, e) for s, e in intervals if e > s):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


# span names whose extent means the device is (or is kept) busy, the names
# JAX's engine uses and the port's engine and pipeline emit as well:
# serve.dispatch covers the forward's launch (the serial path's and the
# pipeline's device stage), serve.device_get the wait until its results
# land on the host, so its extent covers the device's tail
DEVICE_SPAN_NAMES = ("serve.dispatch", "serve.device_get")


def device_idle_fraction(events, names=DEVICE_SPAN_NAMES) -> Optional[dict]:
    """The device's idle share over a serving trace (JAX's
    ``observe/tracing.py:253``): 1 - (union of the ``names`` spans) /
    (first such span's start to the last one's end). Returns
    ``{"device_idle_frac", "busy_s", "window_s", "dispatches"}``, or None
    when the trace holds no ``serve.dispatch`` span."""
    intervals = []
    dispatches = 0
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in names:
            continue
        ts = e.get("ts", 0.0)
        intervals.append((ts / 1e6, (ts + e.get("dur", 0.0)) / 1e6))
        if e.get("name") == "serve.dispatch":
            dispatches += 1
    if not dispatches or not intervals:
        return None
    lo = min(s for s, _ in intervals)
    hi = max(e for _, e in intervals)
    window = hi - lo
    busy = sum(e - s for s, e in merge_intervals(intervals))
    idle = max(0.0, 1.0 - busy / window) if window > 0 else 0.0
    return {"device_idle_frac": round(idle, 4), "busy_s": round(busy, 6),
            "window_s": round(window, 6), "dispatches": dispatches}


def load_trace_events(path: str) -> list:
    """The events of a trace ``Tracer`` wrote (or any Chrome trace-event
    array), the streaming form included; raises on a malformed line."""
    events, errors = load_trace_events_lenient(path)
    if errors:
        raise json.JSONDecodeError(
            f"{len(errors)} malformed trace line(s) in {path} (first: {errors[0]})",
            doc="", pos=0)
    return events


def load_trace_events_lenient(path: str) -> Tuple[list, list]:
    """``(events, errors)``: as :func:`load_trace_events`, but a truncated
    or malformed line becomes a ``"line N: ..."`` entry of ``errors``."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return [], []
    try:  # a well-formed JSON array, or {"traceEvents": [...]}
        doc = json.loads(text)
        if isinstance(doc, dict):
            doc = doc.get("traceEvents", [])
        if isinstance(doc, list):
            return doc, []
        return [], [f"line 1: top-level {type(doc).__name__}, not a list"]
    except json.JSONDecodeError:
        pass
    events, errors = [], []
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip().rstrip(",")
        if not line or line in ("[", "]"):
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {lineno}: {e.msg} ({line[:60]!r})")
            continue
        if isinstance(event, dict):
            events.append(event)
        else:
            errors.append(f"line {lineno}: event is {type(event).__name__}, not dict")
    return events, errors
