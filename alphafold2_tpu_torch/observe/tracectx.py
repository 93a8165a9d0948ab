"""Request-scoped trace context: W3C-traceparent-shaped ids + reconstruction.

Port of ``alphafold2_tpu/observe/tracectx.py`` (pure stdlib, unchanged).

The Tracer (tracing.py) emits spans that are stream-global: nesting is
inferred from ts/dur overlap, so no single request's journey through the
async frontend (queue -> batch formation -> dispatch -> retry / dedup
join) can be reconstructed once requests interleave. This module is the
missing identity layer:

- :class:`TraceContext` — ``trace_id`` (32 hex, one per request lifetime)
  / ``span_id`` (16 hex, one per operation) / ``parent_id`` (the parent
  operation's span_id, ``None`` at the root). ``child()`` mints the next
  link in the chain; ``traceparent()`` round-trips the W3C header form so
  an external frontend can hand a context in (or take one out).
- **Thread-local current context** — ``use_trace(ctx)`` installs a
  context for a ``with`` region and ``current_trace()`` reads it;
  ``Tracer.span`` auto-attaches the current context to every event it
  emits, minting a child per span, so instrumented code needs no explicit
  id plumbing on a single thread. Cross-thread handoff is explicit by
  design (the scheduler carries the context on the request object): an
  ambient context silently inherited by an unrelated worker thread is
  exactly the mislabeling this layer exists to prevent.
- **Reconstruction** — :func:`reconstruct_traces` groups emitted events
  by owning trace (single-owner events via ``args.trace_id``, shared
  batch spans via ``args.trace_ids`` membership) and
  :func:`trace_incomplete_reason` / :func:`trace_completeness` verify a
  request's lifecycle is an unbroken span chain (every ``parent_id``
  resolves inside the trace, submit and resolve both present, a real
  dispatch span behind every non-cached ``ok``). The serve-async bench
  records the completeness fraction and CI gates on it.

Pure stdlib.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import uuid
from contextlib import contextmanager
from typing import Optional

_TRACEPARENT_VERSION = "00"


def _new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars (128 bit)


def _new_span_id() -> str:
    return os.urandom(8).hex()  # 16 hex chars (64 bit)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One node of a request's span chain. Frozen: a context is an
    identity, not a mutable accumulator — derive with :meth:`child`."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    @classmethod
    def new(cls) -> "TraceContext":
        """Mint a root context (a fresh trace)."""
        return cls(trace_id=_new_trace_id(), span_id=_new_span_id())

    def child(self) -> "TraceContext":
        """The next chain link: same trace, fresh span, parented here."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_new_span_id(),
            parent_id=self.span_id,
        )

    def traceparent(self) -> str:
        """W3C ``traceparent`` header form (``00-<trace>-<span>-01``)."""
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: str) -> "TraceContext":
        parts = header.strip().split("-")
        if (
            len(parts) != 4
            or len(parts[1]) != 32
            or len(parts[2]) != 16
            or any(c not in "0123456789abcdef" for c in parts[1] + parts[2])
        ):
            raise ValueError(f"malformed traceparent {header!r}")
        return cls(trace_id=parts[1], span_id=parts[2])

    def event_args(self) -> dict:
        """The id triple as trace-event args (``parent_id`` only when
        set, so root events are recognizable by its absence)."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            out["parent_id"] = self.parent_id
        return out


_tls = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The thread's active context (None outside ``use_trace``)."""
    return getattr(_tls, "ctx", None)


@contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the thread's current context for the region.
    ``None`` explicitly clears it (detaching a worker thread from an
    ambient context it must not inherit)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


# ------------------------------------------------------------ reconstruction


def _args(event: dict) -> dict:
    a = event.get("args")
    return a if isinstance(a, dict) else {}


def reconstruct_traces(events) -> dict:
    """Group trace events by owning trace_id.

    Single-owner events carry ``args.trace_id``; batch-scoped spans (one
    dispatch carrying several requests) list every member trace in
    ``args.trace_ids`` and appear under each. Returns
    ``{trace_id: [events in emission order]}``."""
    traces: dict = {}
    for e in events:
        a = _args(e)
        tid = a.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(e)
        for shared in a.get("trace_ids") or ():
            if shared != tid:
                traces.setdefault(shared, []).append(e)
    return traces


# the lifecycle event names the scheduler/engine emit (serve/scheduler.py,
# serve/engine.py); reconstruction keys on these
SUBMIT_EVENT = "sched.submit"
RESOLVE_EVENT = "sched.resolve"
DEDUP_EVENT = "sched.dedup_join"
CACHE_HIT_EVENT = "sched.cache_hit"
_DISPATCH_EVENTS = ("sched.dispatch", "sched.retry", "serve.batch")


def trace_incomplete_reason(
    trace_id: str, trace_events: list
) -> Optional[str]:
    """Why this trace does NOT reconstruct to a complete, unbroken request
    lifecycle (None = it does).

    Complete means: a ``sched.submit`` root and a ``sched.resolve``
    terminal both present; every ``parent_id`` resolves to a ``span_id``
    within the trace (the unbroken-chain property); an ``ok`` result is
    backed by a dispatch span (or, for cached/deduped results, by the
    cache-hit / dedup-join event that explains why no dispatch exists)."""
    if not trace_events:
        return "no events for trace"
    own = [e for e in trace_events if _args(e).get("trace_id") == trace_id]
    names = {e.get("name") for e in trace_events}
    if not any(e.get("name") == SUBMIT_EVENT for e in own):
        return f"missing {SUBMIT_EVENT} root"
    resolves = [e for e in own if e.get("name") == RESOLVE_EVENT]
    if not resolves:
        return f"missing {RESOLVE_EVENT} terminal"
    span_ids = {
        _args(e).get("span_id") for e in own if _args(e).get("span_id")
    }
    for e in own:
        parent = _args(e).get("parent_id")
        if parent and parent not in span_ids:
            return (
                f"broken span chain: {e.get('name')} parent {parent} "
                "not emitted in this trace"
            )
    terminal = _args(resolves[-1])
    if terminal.get("status") == "ok":
        if terminal.get("cache_hit"):
            if not ({CACHE_HIT_EVENT, DEDUP_EVENT} & names):
                return (
                    "cached ok result without a cache-hit or dedup-join "
                    "event"
                )
        elif not (set(_DISPATCH_EVENTS) & names):
            return "ok result without a dispatch span"
    return None


def trace_completeness(events, trace_ids, max_reasons: int = 8) -> dict:
    """Completeness summary over the given request traces: ``total`` /
    ``complete`` / ``fraction`` plus the first few incompleteness reasons
    (enough to debug, bounded so a systemic break can't bloat a record)."""
    traces = reconstruct_traces(events)
    total = complete = 0
    reasons: dict = {}
    for tid in trace_ids:
        if not tid:
            continue
        total += 1
        reason = trace_incomplete_reason(tid, traces.get(tid, []))
        if reason is None:
            complete += 1
        elif len(reasons) < max_reasons:
            reasons[tid] = reason
    return {
        "total": total,
        "complete": complete,
        "fraction": round(complete / total, 4) if total else 1.0,
        **({"incomplete": reasons} if reasons else {}),
    }
