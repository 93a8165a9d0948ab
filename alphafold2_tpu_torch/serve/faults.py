"""Fault injection for the serve dispatch path.

Port of ``alphafold2_tpu/serve/faults.py`` (pure stdlib, unchanged).

A serving frontend's failure handling is only as real as its tests: the
retry-with-exclusion path and the graceful-degradation paths (structured
error results instead of exceptions, rejection under load) are unreachable
on a healthy backend. ``FaultPlan`` is the injection point: the engine
consults it at the top of every dispatch (``ServeEngine(faults=plan)``)
and the plan may *delay* the dispatch (a slow device / congested
interconnect stand-in) or *fail* it (raise :class:`InjectedFault`, which
the engine converts to structured per-request error results the scheduler
retries against a different (bucket, batch) executable).

Plans target a specific dispatch index (``fail_dispatch=N``, 1-based over
the engine's ``serve.batches`` counter) or every dispatch of a bucket
(``fail_bucket=B``), and fire at most ``times`` times (0 = unlimited), so
"the first dispatch of bucket 8 fails once, the retry succeeds" is a
deterministic scenario instead of a race. ``fail_stage`` moves the
injection point from the top of the dispatch into a specific pipeline
stage (``transfer`` = the host-to-device copy, ``compute`` = the forward,
``fetch`` = the device-to-host copy and its wait), so the pipelined
dispatch path's error routing is exercised stage by stage. Pure stdlib.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional


class InjectedFault(RuntimeError):
    """Raised by a :class:`FaultPlan` to simulate a dispatch failure."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic dispatch fault/delay injection.

    ``fail_dispatch`` matches the global 1-based dispatch index (the
    engine's ``serve.batches`` counter value for that dispatch);
    ``fail_bucket`` matches every dispatch of that bucket. With neither
    set the plan is inert. A matching dispatch first sleeps ``delay_s``
    (if any), then raises :class:`InjectedFault` unless ``fail=False``
    (delay-only plans model slowness without failure). ``fired`` records
    every injection for test assertions."""

    fail_dispatch: Optional[int] = None  # 1-based dispatch index to hit
    fail_bucket: Optional[int] = None  # bucket whose dispatches are hit
    # hit EVERY dispatch regardless of index/bucket — the fleet's replica
    # degrade drill (match_all + fail=False + delay_s = a uniformly slow
    # replica the router should route around)
    match_all: bool = False
    times: int = 1  # max injections (0 = unlimited)
    delay_s: float = 0.0  # sleep before (optionally) failing
    fail: bool = True  # False = delay-only plan
    message: str = "injected fault"
    # pipeline stage to hit: "transfer" | "compute" | "fetch"; None keeps
    # the legacy injection point at the top of the dispatch (pre-featurize)
    fail_stage: Optional[str] = None

    _STAGES = ("transfer", "compute", "fetch")

    def __post_init__(self):
        if self.fail_stage is not None and self.fail_stage not in self._STAGES:
            raise ValueError(
                f"fail_stage must be one of {self._STAGES}, "
                f"got {self.fail_stage!r}"
            )
        self._lock = threading.Lock()
        self.fired: list = []

    def _matches(self, dispatch_index: int, bucket: int) -> bool:
        if self.match_all:
            return True
        if self.fail_dispatch is not None and (
            dispatch_index == self.fail_dispatch
        ):
            return True
        return self.fail_bucket is not None and bucket == self.fail_bucket

    def on_dispatch(self, dispatch_index: int, bucket: int) -> None:
        """Engine hook: called once per dispatch before any device work.

        Inert when ``fail_stage`` is set — a staged plan fires from its
        stage hook instead, keeping exactly one injection point per plan."""
        if self.fail_stage is None:
            self._fire(dispatch_index, bucket, stage=None)

    def on_stage(self, stage: str, dispatch_index: int, bucket: int) -> None:
        """Engine hook: called as the named pipeline stage begins.

        Only plans whose ``fail_stage`` names this stage fire; everything
        else (including legacy top-of-dispatch plans) passes through."""
        if self.fail_stage == stage:
            self._fire(dispatch_index, bucket, stage=stage)

    def _fire(
        self, dispatch_index: int, bucket: int, stage: Optional[str]
    ) -> None:
        with self._lock:
            if self.times and len(self.fired) >= self.times:
                return
            if not self._matches(dispatch_index, bucket):
                return
            record = {"dispatch": dispatch_index, "bucket": bucket}
            if stage is not None:
                record["stage"] = stage
            self.fired.append(record)
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.fail:
            where = f" at {stage}" if stage is not None else ""
            raise InjectedFault(
                f"{self.message}{where} "
                f"(dispatch {dispatch_index}, bucket {bucket})"
            )

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse ``"dispatch=2,bucket=16,times=1,delay=0.5,fail=0,
        stage=compute"`` specs (any subset of keys) — the
        ``AF2TPU_SERVE_ASYNC_FAULT`` env hook the serve-async bench uses
        for degradation drills. None/"" -> None."""
        if not spec:
            return None
        kw: dict = {}
        for part in spec.split(","):
            key, _, value = part.partition("=")
            key = key.strip()
            if key == "dispatch":
                kw["fail_dispatch"] = int(value)
            elif key == "bucket":
                kw["fail_bucket"] = int(value)
            elif key == "times":
                kw["times"] = int(value)
            elif key == "delay":
                kw["delay_s"] = float(value)
            elif key == "fail":
                kw["fail"] = value.strip() not in ("0", "false", "no")
            elif key == "stage":
                kw["fail_stage"] = value.strip()
            else:
                raise ValueError(f"unknown fault-spec key {key!r} in {spec!r}")
        return cls(**kw)


@dataclasses.dataclass
class FleetFaultPlan:
    """Replica-scoped fleet fault: kill or degrade one replica at a time
    offset into the run.

    ``replica`` is the target's 0-based index in the fleet; ``at_s`` is
    seconds from fleet start before the fault becomes due. ``degrade_s``
    = 0 means a *kill* (the fleet marks the replica dead and drains it:
    dispatched work completes, queued work re-routes); ``degrade_s`` > 0
    means a *latency injection* instead — the fleet installs a
    ``match_all`` delay-only :class:`FaultPlan` on that replica's engine
    so every one of its dispatches slows by that many seconds, which the
    load-aware router should route around. The fleet's health pump polls
    :meth:`take` each tick; ``fired`` records every action for test and
    bench assertions."""

    replica: int = 0  # 0-based index of the replica to hit
    at_s: float = 0.0  # seconds from fleet start before the fault is due
    degrade_s: float = 0.0  # 0 = kill; >0 = per-dispatch latency injection
    times: int = 1  # max firings (0 = unlimited; kills re-fire inertly)
    message: str = "injected replica fault"

    def __post_init__(self):
        self._lock = threading.Lock()
        self.fired: list = []

    @property
    def kind(self) -> str:
        return "degrade" if self.degrade_s > 0 else "kill"

    def take(self, elapsed_s: float) -> Optional[str]:
        """One-shot poll: ``"kill"`` / ``"degrade"`` when the fault is due
        and its budget remains, else None. Thread-safe; recording and the
        budget check share one critical section so two pump ticks can't
        both claim the same firing."""
        with self._lock:
            if self.times and len(self.fired) >= self.times:
                return None
            if elapsed_s < self.at_s:
                return None
            self.fired.append({
                "replica": self.replica,
                "elapsed_s": round(elapsed_s, 3),
                "kind": self.kind,
            })
            return self.kind

    def degrade_plan(self) -> FaultPlan:
        """The engine-side half of a degrade fault: delay every dispatch
        of the target replica, never fail it."""
        return FaultPlan(
            match_all=True, fail=False, delay_s=self.degrade_s, times=0,
            message=self.message,
        )

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FleetFaultPlan"]:
        """Parse ``"replica=1,at_s=2"`` (kill) / ``"replica=0,at_s=1,
        degrade=0.05"`` (latency) — the ``AF2TPU_SERVE_FLEET_FAULT`` env
        hook the serve-fleet bench uses for the death drill.
        None/"" -> None."""
        if not spec:
            return None
        kw: dict = {}
        for part in spec.split(","):
            key, _, value = part.partition("=")
            key = key.strip()
            if key == "replica":
                kw["replica"] = int(value)
            elif key == "at_s":
                kw["at_s"] = float(value)
            elif key == "degrade":
                kw["degrade_s"] = float(value)
            elif key == "times":
                kw["times"] = int(value)
            else:
                raise ValueError(
                    f"unknown fleet-fault key {key!r} in {spec!r}"
                )
        return cls(**kw)
