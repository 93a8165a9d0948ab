"""Async serving frontend: admission control, deadlines, dedup, dispatch.

Port of ``alphafold2_tpu/serve/scheduler.py`` over the port's engine: the
same queue, formation, deadline, shedding, retry, cache, dedup, affinity
and in-flight admission logic, counters and trace events.

``ServeEngine.predict_many`` is a closed loop: the caller assembles a
request list, blocks until every dispatch finishes, and nothing bounds how
much work piles up. This module is the open-loop layer a real frontend
needs between "user request arrives" and "bucketed batch hits the chip":

- **Bounded priority queue + admission control** — ``submit`` never
  blocks and never raises: a full queue yields a structured ``rejected``
  result carrying a ``retry_after_s`` hint, and past a configurable
  watermark (``serve.shed_watermark``) low-priority requests are load-shed
  before the queue is full, so high-priority traffic keeps a reserved
  slice of the queue under overload.
- **Continuous batch formation** — a background dispatcher thread forms
  (bucket, batch) groups and dispatches when a group *fills* to
  ``max_batch`` OR the oldest member has *dwelled* ``serve.dwell_ms``
  (:func:`~alphafold2_tpu_torch.serve.bucketing.formation_ripe`) — the classic
  fill-vs-latency tradeoff, tunable per deployment.
- **In-flight admission (continuous batching)** — with the engine's
  pipelined dispatch (``serve.pipeline_depth > 0``), a request arriving
  while its bucket's previous formation is still in the *host stage*
  joins that in-flight batch (``DispatchHandle.try_join``) instead of
  queueing behind a fresh fill-or-dwell window; dispatches go through
  ``engine.dispatch_batch_async`` and resolve from the pipeline's
  completion worker, so the dispatcher thread never blocks on the device
  and batch N+1 forms while batch N computes.
- **Per-request deadlines** — a request whose deadline passes while
  queued resolves to a structured ``deadline_exceeded`` result instead of
  wasting a dispatch slot (or raising).
- **Result cache + in-flight dedup** — ``(seq, seed)``-keyed LRU
  (:mod:`alphafold2_tpu_torch.serve.cache`): repeats resolve immediately with
  byte-identical arrays, and concurrent identical requests share one
  dispatch.
- **Fault tolerance** — a failed dispatch (structured ``error`` results
  from the engine, e.g. a :class:`~alphafold2_tpu_torch.serve.faults.FaultPlan`
  injection) is retried once against a *different* (bucket, batch)
  executable (the next ladder rung) before the error reaches callers.

Observability: ``sched.*`` counters (rejections,
sheds, deadline misses, cache hits, dedups, retries) share the engine's
``EventCounters``; queue-depth / time-to-dispatch / dwell stream into
``observe.Histogram``; dispatches open ``sched.dispatch`` tracer spans.
Every request carries a :class:`~alphafold2_tpu_torch.observe.tracectx.
TraceContext` from birth and the scheduler emits its full lifecycle as
trace events — ``sched.submit`` (root), ``sched.queue`` (residency span),
``sched.dispatch``/``sched.retry`` (batch spans listing member traces),
``sched.cache_hit``/``sched.dedup_join`` (shared-result provenance, the
join naming the leader's trace), ``sched.resolve`` (terminal, one per
caller) — so one request's journey reconstructs from the trace JSONL
alone (``observe.tracectx.reconstruct_traces``). ``add_observer`` hooks
every resolution (an SLO monitor's ingestion point). ``chip_smoke.py``'s
``phase_serve_async`` drives it open-loop with Poisson arrivals.

Scheduling decisions use an injectable ``clock`` (default
``time.perf_counter``, the engine's queue-wait timebase), and with
``start=False`` the dispatcher can be pumped inline — the fake-clock tests
(JAX's ``tests/test_scheduler.py``, and the port's
``tests/test_torch_port_serve_frontend.py``) are fully deterministic.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Optional, Union

from alphafold2_tpu_torch.observe.histogram import Histogram
from alphafold2_tpu_torch.observe.tracectx import (
    CACHE_HIT_EVENT,
    DEDUP_EVENT,
    RESOLVE_EVENT,
    SUBMIT_EVENT,
    TraceContext,
)
from alphafold2_tpu_torch.observe.tracing import Tracer
from alphafold2_tpu_torch.serve.bucketing import (
    FamilyTracker,
    affinity_take,
    bucket_for,
    formation_ripe,
)
from alphafold2_tpu_torch.serve.cache import ResultCache, result_key
from alphafold2_tpu_torch.serve.pipeline import DispatchHandle, PipelineBatch
from alphafold2_tpu_torch.serve.engine import (
    ServeEngine,
    ServeRequest,
    ServeResult,
    _as_request,
)


class PendingResult:
    """Caller-side handle for one submitted request.

    ``result(timeout)`` blocks until the request resolves (to an ``ok``
    result *or* a structured rejection/deadline/error result — the
    frontend never raises through this) and raises ``TimeoutError`` only
    if the timeout itself expires."""

    __slots__ = ("request", "_event", "_result")

    def __init__(self, request: ServeRequest):
        self.request = request
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request ({self.request.seq[:16]!r}...) not resolved "
                f"within {timeout}s"
            )
        return self._result

    def _resolve(self, result: ServeResult) -> None:
        self._result = result
        self._event.set()


@dataclasses.dataclass
class _Pending:
    """One admitted (leader) request queued for dispatch."""

    req: ServeRequest
    handle: PendingResult
    key: tuple
    bucket: int
    priority: int
    enqueued: float  # scheduler-clock timestamp
    deadline: Optional[float]  # absolute scheduler-clock deadline
    seq_no: int
    # mutant-family label (bucketing.FamilyTracker): None for regular
    # traffic; same-label pendings are packed into one formation
    family: Optional[str] = None

    @property
    def order(self) -> tuple:
        return (-self.priority, self.seq_no)


class AsyncServeFrontend:
    """Open-loop serving frontend over a :class:`ServeEngine`.

    >>> frontend = AsyncServeFrontend(engine)
    >>> handle = frontend.submit("MKTAYIAK...", deadline_s=2.0)
    >>> result = handle.result(timeout=30)   # structured, never raises
    >>> frontend.close()

    Scheduling knobs come from ``engine.cfg.serve``: ``queue_depth``,
    ``dwell_ms``, ``default_deadline_s``, ``cache_size``,
    ``shed_watermark``, ``retry_failed``. ``start=False`` skips the
    dispatcher thread; tests then call :meth:`pump` inline against an
    injected ``clock``.
    """

    def __init__(
        self,
        engine: ServeEngine,
        clock: Optional[Callable[[], float]] = None,
        tracer: Optional[Tracer] = None,
        start: bool = True,
    ):
        scfg = engine.cfg.serve
        self.engine = engine
        self.counters = engine.counters
        self.tracer = tracer if tracer is not None else engine.tracer
        self._clock = clock if clock is not None else time.perf_counter
        self.queue_depth = max(1, int(scfg.queue_depth))
        self.dwell_s = max(0.0, float(scfg.dwell_ms) / 1e3)
        self.default_deadline_s = float(scfg.default_deadline_s or 0.0)
        self.shed_watermark = float(scfg.shed_watermark)
        self.retry_failed = bool(scfg.retry_failed)
        self.cache = ResultCache(scfg.cache_size)
        self.histograms = {
            "queue_depth": Histogram(),
            "time_to_dispatch_s": Histogram(),
            "dwell_s": Histogram(),
            # per-formation padded fraction (slot + length padding over the
            # full bucket*fill rectangle), split by how the batch formed —
            # the variant-scan claim "affinity batches waste less" as a
            # measured distribution, not an assumption
            "affinity_pad_fraction": Histogram(),
            "regular_pad_fraction": Histogram(),
        }
        # parent-affinity batching (variant-scan fast lane): detect mutant
        # families on the arriving stream and pack same-family requests
        # into the same formations
        self.affinity_batching = bool(
            getattr(scfg, "affinity_batching", False)
        )
        self.families = FamilyTracker() if self.affinity_batching else None
        # pipelined dispatch: present when the engine was built with
        # serve.pipeline_depth > 0 (getattr so engine fakes in tests and
        # older engine objects keep the sync path)
        self.pipeline = getattr(engine, "pipeline", None)
        self.inflight_admission = (
            self.pipeline is not None
            and bool(getattr(scfg, "inflight_admission", False))
        )
        self._lock = threading.Condition()
        self._observers: list = []  # fn(result, priority) at every resolve
        self._submit_observers: list = []  # fn(req, bucket, family)
        self._queues: dict = {}  # bucket -> list[_Pending], priority-sorted
        # bucket -> (DispatchHandle, [_Pending]) while that batch's host
        # stage is still joinable; completion pops its own entry
        self._forming: dict = {}
        self._inflight: list = []  # DispatchHandles not yet completed
        self._depth = 0
        self._seq_no = 0
        self._ema_dispatch_s: Optional[float] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="af2-serve-scheduler", daemon=True
        )
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the dispatcher and resolve anything still queued as
        ``rejected`` (reason "frontend closed") — callers never hang on a
        handle whose dispatcher is gone."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # drain pipelined in-flight batches first: their completion
        # callbacks resolve the member handles (joiners included), so the
        # leftover sweep below only sees what never got dispatched
        deadline = time.monotonic() + max(0.0, timeout)
        with self._lock:
            inflight = list(self._inflight)
        for dh in inflight:
            try:
                dh.result(timeout=max(0.1, deadline - time.monotonic()))
            except TimeoutError:
                break  # a wedged batch must not hang close(); sweep on
        leftovers = []
        with self._lock:
            for q in self._queues.values():
                leftovers.extend(q)
                q.clear()
            self._depth = 0
        for p in leftovers:
            self._resolve_leader(
                p,
                ServeResult(
                    seq=p.req.seq, bucket=p.bucket, status="rejected",
                    error="frontend closed",
                ),
                cache_ok=False,
            )

    def __enter__(self) -> "AsyncServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def load_snapshot(self) -> dict:
        """One consistent routing-grade load reading: queued depth,
        batches in flight, and the buckets whose in-flight formation is
        still joinable. The fleet router's health substrate
        (:mod:`~alphafold2_tpu_torch.serve.fleet`) — taken under this
        frontend's lock so a router never has to hold its OWN lock across
        the call."""
        with self._lock:
            return {
                "depth": self._depth,
                "inflight": len(self._inflight),
                "forming": tuple(self._forming),
                "closed": self._stop,
            }

    def evict_queued(self, max_n: int, reason: str = "evicted") -> int:
        """Pop up to ``max_n`` queued (not yet dispatched) requests —
        newest, lowest-priority first — and resolve them as structured
        rejections carrying ``reason``. The fleet router's work-stealing
        hook: the stolen requests resolve through the normal observer
        path, so a fleet tracking them by trace_id can re-submit each to
        another replica. Returns the number evicted."""
        taken: list = []
        with self._lock:
            for bucket in sorted(self._queues, reverse=True):
                q = self._queues[bucket]
                while q and len(taken) < max_n:
                    taken.append(q.pop())  # tail = lowest priority, newest
                if len(taken) >= max_n:
                    break
            self._depth -= len(taken)
        for p in taken:
            self.tracer.instant(
                "sched.evict", bucket=p.bucket, reason=reason,
                **(p.req.trace.child().event_args()
                   if p.req.trace is not None else {}),
            )
            self._resolve_leader(
                p,
                ServeResult(
                    seq=p.req.seq, bucket=p.bucket, status="rejected",
                    error=reason,
                ),
                cache_ok=False,
            )
        return len(taken)

    def stats(self) -> dict:
        return self.counters.snapshot()

    # ------------------------------------------------------------ observers

    def add_observer(self, fn: Callable) -> None:
        """Register ``fn(result, priority)``, called at EVERY resolution
        (ok, error, rejected, deadline, cache hit, dedup follower) — the
        SLO monitor's ingestion point, and a bench's per-class ledger."""
        self._observers.append(fn)

    def _notify(self, result: ServeResult, priority: int) -> None:
        for fn in self._observers:
            try:
                fn(result, priority)
            except Exception:
                pass  # an observer must never take the serving path down

    def add_submit_observer(self, fn: Callable) -> None:
        """Register ``fn(request, bucket, family)``, called once per
        submitted request at arrival — BEFORE admission control, so the
        observer sees the offered stream (rejects and sheds included),
        not just what the queue accepted. ``bucket``/``family`` are None
        for unservable requests / non-family traffic. The workload
        recorder's ingestion point (a workload recorder)."""
        self._submit_observers.append(fn)

    def _notify_submit(self, req: ServeRequest, bucket, family) -> None:
        for fn in self._submit_observers:
            try:
                fn(req, bucket, family)
            except Exception:
                pass  # same contract as _notify: never break serving

    def _trace_resolve(
        self, tctx: Optional[TraceContext], result: ServeResult
    ) -> None:
        """The terminal lifecycle event: one ``sched.resolve`` per caller
        (followers get their own, on their own trace)."""
        args = tctx.child().event_args() if tctx is not None else {}
        self.tracer.instant(
            RESOLVE_EVENT, status=result.status,
            cache_hit=bool(result.cache_hit),
            retried=bool(result.retried), **args,
        )

    def histogram_snapshots(self, unit_scale: float = 1.0) -> dict:
        return {
            name: h.snapshot(
                unit_scale=unit_scale if name.endswith("_s") else 1.0,
                digits=4,
            )
            for name, h in self.histograms.items()
        }

    # --------------------------------------------------------------- submit

    def submit(
        self,
        request: Union[str, ServeRequest],
        priority: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> PendingResult:
        """Admit (or structurally reject) one request; never blocks on the
        device, never raises for a servable-or-not decision."""
        req = _as_request(request)
        now = self._clock()
        if priority is None:
            priority = req.priority
        if deadline_s is None:
            deadline_s = (
                req.deadline_s if req.deadline_s is not None
                else (self.default_deadline_s or None)
            )
        req = dataclasses.replace(
            req, arrival_s=now, priority=priority, deadline_s=deadline_s
        )
        handle = PendingResult(req)
        self.counters.bump("sched.submitted")
        tctx = req.trace
        # the trace root: every request — admitted, shed, or unservable —
        # gets exactly one, carrying the root span (no parent_id)
        self.tracer.instant(
            SUBMIT_EVENT, priority=int(priority),
            **(tctx.event_args() if tctx is not None else {}),
        )

        try:
            if not req.seq:
                raise ValueError("empty sequence")
            bucket = bucket_for(len(req.seq), self.engine.buckets)
        except ValueError as e:
            res = ServeResult(
                seq=req.seq, bucket=0, status="rejected",
                error=f"unservable request: {e}",
                trace_id=tctx.trace_id if tctx is not None else None,
            )
            handle._resolve(res)
            self.counters.bump("sched.rejected")
            self.tracer.instant(
                "sched.reject", reason="unservable",
                **(tctx.child().event_args() if tctx is not None else {}),
            )
            self._notify_submit(req, None, None)
            self._trace_resolve(tctx, res)
            self._notify(res, priority)
            return handle

        # mutant-family detection (variant-scan fast lane): an explicit
        # parent_id hint or an edit-distance-1 match against recent traffic
        # labels this request for parent-affinity batch formation
        family = None
        if self.families is not None:
            family = self.families.observe(req.seq, req.parent_id)
            if family is not None:
                self.counters.bump("sched.family_members")
        self._notify_submit(req, bucket, family)

        # mesh identity rides in the key (serve/cache.py): results from a
        # sharded engine and a single-device one are numerically close but
        # not byte-identical, so they must never dedup onto each other
        key = result_key(req.seq, req.seed, self.engine.mesh_desc)
        status, payload = self.cache.lookup_or_claim(
            key, follower_ctx=(handle, now, tctx, priority)
        )
        if status == "hit":
            self.counters.bump("sched.cache_hits")
            res = self._shared_result(payload, now, trace=tctx)
            handle._resolve(res)
            self.tracer.instant(
                CACHE_HIT_EVENT, bucket=bucket,
                **(tctx.child().event_args() if tctx is not None else {}),
            )
            self._trace_resolve(tctx, res)
            self._notify(res, priority)
            return handle
        if status == "follower":
            # rides the in-flight leader's dispatch; no queue slot consumed.
            # The join event names the leader's trace so the two lifecycles
            # cross-reference from either side of the dedup.
            self.counters.bump("sched.inflight_dedup")
            self.tracer.instant(
                DEDUP_EVENT, bucket=bucket,
                **({"leader_trace": payload.leader_trace}
                   if payload.leader_trace else {}),
                **(tctx.child().event_args() if tctx is not None else {}),
            )
            return handle
        if tctx is not None:
            payload.leader_trace = tctx.trace_id  # the InFlightEntry

        # leader: admission control under the scheduler lock
        with self._lock:
            if self.inflight_admission and not self._stop:
                # continuous batching: if this bucket's previous formation
                # is still in the pipeline's host stage, join it instead of
                # queueing behind a fresh fill-or-dwell window. No queue
                # slot is consumed; the join races the host worker sealing
                # the batch and simply falls through to normal admission
                # when it loses. (Lock order: scheduler lock -> batch
                # membership lock, never the reverse.)
                forming = self._forming.get(bucket)
                # typed so the static concurrency auditor sees this as
                # the AsyncServeFrontend._lock -> PipelineBatch._lock
                # edge (try_join acquires the membership lock)
                dh: Optional[DispatchHandle] = (
                    forming[0] if forming is not None else None
                )
                if dh is not None and dh.try_join(req):
                    pending = _Pending(
                        req=req, handle=handle, key=key, bucket=bucket,
                        priority=priority, enqueued=now, deadline=None,
                        seq_no=self._seq_no, family=family,
                    )
                    self._seq_no += 1
                    forming[1].append(pending)
                    self.counters.bump("sched.inflight_admitted")
                    if family is not None:
                        # a late-arriving sibling caught its family's batch
                        # while the host stage was still featurizing it
                        self.counters.bump("sched.family_inflight_joins")
                    joined_trace = (
                        tctx.child().event_args() if tctx is not None else {}
                    )
                    self.tracer.instant(
                        "sched.inflight_admit", bucket=bucket, **joined_trace
                    )
                    return handle
            rejected = None
            if self._stop:
                # the dispatcher is gone: a request queued now would hang
                # forever. A late arrival racing close() — e.g. a fleet
                # route landing on a replica being drained — gets the
                # same structured rejection close()'s sweep hands out.
                rejected = ("frontend closed", "sched.rejected")
            elif self._depth >= self.queue_depth:
                rejected = ("queue full", "sched.rejected")
            elif (
                self.shed_watermark > 0
                and self._depth + 1 > self.shed_watermark * self.queue_depth
                and priority <= 0
            ):
                rejected = ("load shed (queue past watermark)", "sched.shed")
            if rejected is None:
                deadline = now + deadline_s if deadline_s else None
                pending = _Pending(
                    req=req, handle=handle, key=key, bucket=bucket,
                    priority=priority, enqueued=now, deadline=deadline,
                    seq_no=self._seq_no, family=family,
                )
                self._seq_no += 1
                q = self._queues.setdefault(bucket, [])
                bisect.insort(q, pending, key=lambda p: p.order)
                self._depth += 1
                self.counters.bump("sched.admitted")
                self.histograms["queue_depth"].observe(self._depth)
                self._lock.notify_all()
                return handle
            reason, counter = rejected
            retry_after = self._retry_after_locked()
        # rejection resolves outside the lock (cache fulfill + callbacks)
        self.counters.bump("sched.rejected")
        if counter == "sched.shed":
            self.counters.bump("sched.shed")
        self.tracer.instant(
            "sched.reject", reason=reason, bucket=bucket,
            **(tctx.child().event_args() if tctx is not None else {}),
        )
        self._resolve_leader(
            _Pending(
                req=req, handle=handle, key=key, bucket=bucket,
                priority=priority, enqueued=now, deadline=None, seq_no=-1,
            ),
            ServeResult(
                seq=req.seq, bucket=bucket, status="rejected", error=reason,
                retry_after_s=retry_after,
            ),
            cache_ok=False,
        )
        return handle

    def _retry_after_locked(self) -> float:
        """Backoff hint: roughly how long until the queue drains a batch's
        worth of slack, from the dispatch-duration EMA (or the dwell window
        before any dispatch has been measured)."""
        per_batch = (
            self._ema_dispatch_s
            if self._ema_dispatch_s is not None
            else max(self.dwell_s, 0.05)
        )
        batches_ahead = self._depth // self.engine.max_batch + 1
        return round(batches_ahead * per_batch, 4)

    def _shared_result(
        self,
        result: ServeResult,
        submit_ts: float,
        trace: Optional[TraceContext] = None,
    ) -> ServeResult:
        """A cached/deduped caller's view of a shared result: identical
        arrays (byte-for-byte — same objects), per-caller latency, and the
        CALLER's trace identity (the shared result carries the leader's)."""
        wait = max(0.0, self._clock() - submit_ts)
        return dataclasses.replace(
            result, cache_hit=True, latency_s=wait, queue_wait_s=wait,
            **({"trace_id": trace.trace_id} if trace is not None else {}),
        )

    # ------------------------------------------------------------- dispatch

    def pump(self) -> int:
        """One scheduling pass: expire deadlines, form ripe batches, and
        dispatch them. Returns the number of dispatches executed. The
        dispatcher thread calls this in a loop; tests with ``start=False``
        call it inline for deterministic fake-clock scheduling."""
        now = self._clock()
        expired: list = []
        plans: list = []
        with self._lock:
            for bucket in sorted(self._queues):
                q = self._queues[bucket]
                keep = []
                dead = []
                for p in q:
                    if p.deadline is not None and p.deadline <= now:
                        dead.append(p)
                    else:
                        keep.append(p)
                if dead:
                    q[:] = keep
                    self._depth -= len(dead)
                    expired.extend(dead)
                fill = self.engine.batch_for(bucket)  # long rungs fill small
                while q:
                    oldest = min(p.enqueued for p in q)
                    if not formation_ripe(
                        len(q), fill, now - oldest, self.dwell_s
                    ):
                        break
                    if self.affinity_batching:
                        # parent-affinity formation: same-family pendings
                        # deeper in the queue jump into the head's batch
                        # (the head itself is never delayed)
                        take = affinity_take(q, fill)
                        chosen = {id(p) for p in take}
                        q[:] = [p for p in q if id(p) not in chosen]
                    else:
                        take = q[:fill]
                        del q[: len(take)]
                    self._depth -= len(take)
                    plans.append((bucket, take))
        for p in expired:
            self.counters.bump("sched.deadline_miss")
            self.tracer.instant(
                "sched.deadline_miss", bucket=p.bucket,
                **(p.req.trace.child().event_args()
                   if p.req.trace is not None else {}),
            )
            self._resolve_leader(
                p,
                ServeResult(
                    seq=p.req.seq, bucket=p.bucket,
                    status="deadline_exceeded",
                    error=(
                        f"deadline ({p.req.deadline_s}s) passed after "
                        f"{now - p.enqueued:.4g}s in queue"
                    ),
                    latency_s=max(0.0, now - p.enqueued),
                    queue_wait_s=max(0.0, now - p.enqueued),
                ),
                cache_ok=False,
            )
        for bucket, batch in plans:
            self._execute(bucket, batch, now)
        return len(plans)

    def _execute(self, bucket: int, pendings: list, formed_at: float) -> None:
        self.histograms["dwell_s"].observe(
            max(0.0, formed_at - min(p.enqueued for p in pendings))
        )
        # formation accounting: a batch is affinity-formed when >= 2
        # members share the head's family label. Padded fraction counts
        # the whole bucket*fill rectangle (empty slots + length padding).
        fam = pendings[0].family
        affine = (
            fam is not None
            and sum(1 for p in pendings if p.family == fam) >= 2
        )
        if affine:
            self.counters.bump("sched.affinity_batches")
        fill = max(1, self.engine.batch_for(bucket))
        total = fill * bucket
        padded = total - sum(len(p.req.seq) for p in pendings)
        self.histograms[
            "affinity_pad_fraction" if affine else "regular_pad_fraction"
        ].observe(max(0.0, padded) / total)
        for p in pendings:
            self.histograms["time_to_dispatch_s"].observe(
                max(0.0, formed_at - p.enqueued)
            )
            if p.req.trace is not None:
                # retroactive queue-residency span: the region is only
                # known once the batch forms, so it is emitted with
                # explicit bounds rather than timed live
                self.tracer.span_event(
                    "sched.queue", p.enqueued, formed_at, bucket=bucket,
                    **p.req.trace.child().event_args(),
                )
        if self.pipeline is not None:
            self._execute_pipelined(bucket, pendings)
            return
        reqs = [p.req for p in pendings]
        member_traces = [r.trace.trace_id for r in reqs if r.trace]
        t0 = self._clock()
        mesh_attr = (
            {"mesh": self.engine.mesh_desc} if self.engine.mesh_desc else {}
        )
        with self.tracer.span(
            "sched.dispatch", bucket=bucket, n=len(reqs), **mesh_attr,
            **({"trace_ids": member_traces} if member_traces else {}),
        ):
            results = self.engine.dispatch_batch(bucket, reqs)
        dt = max(0.0, self._clock() - t0)
        self._ema_dispatch_s = (
            dt if self._ema_dispatch_s is None
            else 0.8 * self._ema_dispatch_s + 0.2 * dt
        )
        self._settle(bucket, pendings, results)

    def _execute_pipelined(self, bucket: int, pendings: list) -> None:
        """Hand one formed batch to the engine's pipeline and return
        immediately — the dispatcher thread goes back to forming batch
        N+1 while this one runs. While the batch's host stage runs, its
        membership stays joinable and ``submit`` admits late arrivals into
        it (the ``_forming`` registry); the pipeline's completion worker
        calls :meth:`_finish_pipelined` with the ordered results."""
        t0 = self._clock()
        dh = self.engine.dispatch_batch_async(
            bucket, [p.req for p in pendings],
            joinable=self.inflight_admission,
        )
        entry = (dh, list(pendings))
        with self._lock:
            self._inflight.append(dh)
            if self.inflight_admission:
                self._forming[bucket] = entry
        dh.add_done_callback(
            lambda results: self._finish_pipelined(
                bucket, dh, entry, t0, results
            )
        )

    def _finish_pipelined(
        self, bucket: int, dh, entry: tuple, t0: float, results: list
    ) -> None:
        """Completion callback (pipeline fetch worker thread): un-register
        the batch, account the dispatch, retry failures synchronously, and
        resolve every member — initial pendings plus in-flight joiners."""
        with self._lock:
            if self._forming.get(bucket) is entry:
                del self._forming[bucket]
            # joiners append under this lock before the batch seals, and
            # sealing happens-before completion, so this snapshot is the
            # full membership in the engine's result order
            pendings = list(entry[1])
        try:
            dt = max(0.0, self._clock() - t0)
            self._ema_dispatch_s = (
                dt if self._ema_dispatch_s is None
                else 0.8 * self._ema_dispatch_s + 0.2 * dt
            )
            member_traces = [
                p.req.trace.trace_id for p in pendings if p.req.trace
            ]
            mesh_attr = (
                {"mesh": self.engine.mesh_desc}
                if self.engine.mesh_desc else {}
            )
            # retroactive: the dispatch ran on the pipeline workers, not here
            self.tracer.span_event(
                "sched.dispatch", t0, self._clock(), bucket=bucket,
                n=len(pendings), pipelined=True, **mesh_attr,
                **({"trace_ids": member_traces} if member_traces else {}),
            )
            self._settle(bucket, pendings, results)
        finally:
            # un-register only once fully settled (resolutions + terminal
            # sched.resolve events emitted): close()'s drain treats an
            # empty _inflight as "safe to tear the telemetry plane down"
            with self._lock:
                try:
                    self._inflight.remove(dh)
                except ValueError:
                    pass
                self._lock.notify_all()

    def _settle(self, bucket: int, pendings: list, results: list) -> None:
        """Post-dispatch tail shared by the sync and pipelined paths:
        retry failures against a different executable, then resolve."""
        reqs = [p.req for p in pendings]
        failed = [i for i, r in enumerate(results) if r.status == "error"]
        if failed and self.retry_failed:
            # retry once against a DIFFERENT executable: the next ladder
            # rung when one exists (a fresh (bucket, batch) shape excludes
            # whatever poisoned the first), else the same rung again
            retry_at = self.engine.retry_bucket(bucket) or bucket
            self.counters.bump("sched.retries", len(failed))
            retry_traces = [
                reqs[i].trace.trace_id for i in failed if reqs[i].trace
            ]
            with self.tracer.span(
                "sched.retry", bucket=retry_at, failed_bucket=bucket,
                n=len(failed),
                **({"trace_ids": retry_traces} if retry_traces else {}),
            ):
                retried = self.engine.dispatch_batch(
                    retry_at, [reqs[i] for i in failed]
                )
            for i, rr in zip(failed, retried):
                results[i] = dataclasses.replace(rr, retried=True)

        self.counters.bump("sched.dispatches")
        self.counters.bump("sched.batched_requests", len(pendings))
        for p, res in zip(pendings, results):
            self._resolve_leader(p, res, cache_ok=res.status == "ok")

    def _resolve_leader(
        self, pending: _Pending, result: ServeResult, cache_ok: bool
    ) -> None:
        """Resolve a leader's handle and fan the result out to every
        follower deduped onto its key (sharing failures too — one dispatch,
        one outcome). Only ok results enter the LRU. Every resolution —
        leader and followers — emits its own terminal ``sched.resolve``
        on its own trace and reaches every registered observer."""
        tctx = pending.req.trace
        if tctx is not None and result.trace_id != tctx.trace_id:
            result = dataclasses.replace(result, trace_id=tctx.trace_id)
        # Promote into the cache (and drain followers) BEFORE resolving the
        # leader's handle: once .result() returns, a resubmit of the same key
        # must observe a cache hit, not a still-in-flight entry.
        followers = self.cache.fulfill(pending.key, result, cache=cache_ok)
        pending.handle._resolve(result)
        self._trace_resolve(tctx, result)
        self._notify(result, pending.priority)
        for ctx in followers:
            handle, submit_ts = ctx[0], ctx[1]
            f_trace = ctx[2] if len(ctx) > 2 else None
            f_priority = ctx[3] if len(ctx) > 3 else 0
            shared = self._shared_result(result, submit_ts, trace=f_trace)
            handle._resolve(shared)
            self._trace_resolve(f_trace, shared)
            self._notify(shared, f_priority)

    # --------------------------------------------------------------- thread

    def _next_wakeup_locked(self, now: float) -> Optional[float]:
        """Seconds until the next dwell or deadline expiry (0 = a batch is
        already ripe, None = queue empty: wait for a submit)."""
        horizon = None
        for bucket, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.engine.batch_for(bucket):
                return 0.0
            oldest = min(p.enqueued for p in q)
            times = [oldest + self.dwell_s]
            times.extend(p.deadline for p in q if p.deadline is not None)
            t = min(times)
            horizon = t if horizon is None else min(horizon, t)
        if horizon is None:
            return None
        return max(0.0, horizon - now)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                timeout = self._next_wakeup_locked(self._clock())
                if timeout is None:
                    self._lock.wait(timeout=1.0)
                elif timeout > 0:
                    self._lock.wait(timeout=timeout)
                if self._stop:
                    return
            self.pump()


def _audit_invert_locks(  # af2: gated-defect[AF2TPU_AUDIT_INVERT_LOCKS]
    frontend: AsyncServeFrontend, batch: PipelineBatch
) -> None:
    """Seeded negative control of the concurrency audit
    (``analysis/concurrency.py``), the port's copy of JAX's
    (``alphafold2_tpu/serve/scheduler.py:871``). Never called: the
    ``gated-defect`` marker keeps it out of the audit and of the committed
    contracts unless ``AF2TPU_AUDIT_INVERT_LOCKS=1``; then it adds the
    inverted order (the batch's membership lock first, the scheduler's lock
    inside it), closing a cycle with ``submit``'s
    ``AsyncServeFrontend._lock -> PipelineBatch._lock`` edge, and the audit
    must exit 1 naming it."""
    with batch._lock:
        with frontend._lock:
            pass
