"""Pipelined host/device dispatch for ServeEngine, on CUDA streams.

Port of ``alphafold2_tpu/serve/pipeline.py``. The serial path runs
featurize -> copy in -> forward -> copy out -> unpad in one thread, so the
card idles through every host phase. Here three one-thread stages overlap
them, with at most ``serve.pipeline_depth`` batches in flight:

    host stage    featurize and stack batch N+1 into a pinned buffer, copy
                  it to the device (``non_blocking``) on a copy stream and
                  record an event
    device stage  make the compute stream wait on that event, run the
                  forward of batch N on the compute stream, enqueue the
                  device-to-host copies of its outputs into pinned buffers
                  and record a done event
    fetch stage   wait once on batch N-1's done event, copy its outputs out
                  of the pinned buffers, unpad and resolve its future

PyTorch's current stream and inference mode belong to a thread, so the
device stage sets both (and the device) itself. The pinned buffers come
from rings of ``depth + 1`` slots a ``(bucket, batch)`` key, so a buffer
is never rewritten while its copy is in flight; inputs the copy stream
allocated are ``record_stream``-ed to the compute stream for the caching
allocator. On the CPU the same three threads run with no stream, event or
pinned buffer.

While a batch sits in the host stage its membership is still open: the
frontend's in-flight admission joins late requests into it through
:meth:`PipelineBatch.try_join` until the featurize loop drains and seals it.

An exception in any stage (injected ``serve.faults`` stage faults
included) rides the job to the fetch stage, which waits for the job's
recorded copies, converts the error into per-request error results and
resolves the future: the in-flight slot is always released. A device-side
error surfaces at the done event's wait.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import Optional

import torch


class PipelineBatch:
    """One batch's membership while it forms in the host stage.

    ``try_join`` admits a request while the formation is open (the host
    worker has not drained the member list) and below ``fill``; the host
    worker pulls members one at a time through :meth:`next_member`, which
    seals the formation the first time it finds nothing left. Thread-safe.
    """

    def __init__(self, bucket: int, requests: list, fill: int):
        self.bucket = int(bucket)
        self.fill = max(len(requests), int(fill), 1)
        self._lock = threading.Lock()
        self._members = list(requests)
        self._sealed = False

    def try_join(self, req) -> bool:
        """Admit ``req`` into this in-flight batch; False once sealed/full."""
        with self._lock:
            if self._sealed or len(self._members) >= self.fill:
                return False
            self._members.append(req)
            return True

    def next_member(self, i: int):
        """Member ``i`` if admitted, else seal the formation and return
        None (the host worker, ``i`` members featurized so far)."""
        with self._lock:
            if i < len(self._members):
                return self._members[i]
            self._sealed = True
            return None

    def seal(self) -> None:
        with self._lock:
            self._sealed = True

    @property
    def sealed(self) -> bool:
        with self._lock:
            return self._sealed

    @property
    def members(self) -> list:
        with self._lock:
            return list(self._members)


class DispatchHandle:
    """Future over one pipelined batch's ordered ServeResult list."""

    def __init__(self, batch: PipelineBatch):
        self.batch = batch
        self._done = threading.Event()
        self._cb_lock = threading.Lock()
        self._results: Optional[list] = None
        self._callbacks: list = []

    def try_join(self, req) -> bool:
        """Admit ``req`` into the batch while its host stage still runs."""
        return self.batch.try_join(req)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> list:
        """Block until the batch completes; one ServeResult a member in
        admission order (initial requests, then joiners)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"pipelined dispatch (bucket {self.batch.bucket}) did not "
                               f"complete within {timeout}s")
        return self._results

    def add_done_callback(self, fn) -> None:
        """Run ``fn(results)`` on completion: at once (in the caller's
        thread) if resolved, else on the completion worker."""
        with self._cb_lock:
            if self._results is None:
                self._callbacks.append(fn)
                return
        fn(self._results)

    def _resolve(self, results: list) -> None:
        with self._cb_lock:
            self._results = results
            callbacks = list(self._callbacks)
            self._callbacks.clear()
        # callbacks run before the done event: when result() returns, the
        # frontend's completion callback (retry, cache fulfil, terminal
        # trace events) has finished
        for fn in callbacks:
            try:
                fn(results)
            except Exception:  # noqa: BLE001 — a broken observer must not wedge completion
                pass
        self._done.set()


class _Job:
    """Mutable per-batch state riding through the three stages."""

    __slots__ = (
        "bucket", "index", "arrival", "batch", "handle", "members", "n_real", "batch_size",
        "stacked", "compiled", "out", "fetched", "error", "t_host0", "t_device0", "feat",
        "copied_in", "done",
    )

    def __init__(self, bucket: int, index: int, arrival, batch, handle):
        self.bucket = bucket
        self.index = index  # global 1-based dispatch index (serve.batches)
        self.arrival = arrival  # stream-level queue-wait origin (fallback)
        self.batch = batch
        self.handle = handle
        self.members: list = []
        self.n_real = 0
        self.batch_size = 0
        self.stacked = None
        self.compiled = None
        self.out = None
        self.fetched = None
        self.error: Optional[BaseException] = None
        self.t_host0: Optional[float] = None
        self.t_device0: Optional[float] = None
        self.feat: Optional[list] = None  # per-member featurization ledger
        self.copied_in = None  # CUDA event after the host-to-device copy
        self.done = None  # CUDA event after the device-to-host copies


class _PinnedSlot:
    """One slot of a :class:`_PinnedRing`: pinned host tensors by name,
    allocated at first use and again only when a shape or dtype changes."""

    def __init__(self):
        self._bufs: dict = {}

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._bufs[name] = buf
        return buf


class _PinnedRing:
    """``slots`` pinned slots a key, handed out in turn. Batches of a key
    take slots in submission order and at most ``depth`` are in flight, so
    with ``depth + 1`` slots the batch that last held a slot has completed
    (its copies waited on) before the slot comes round again. Each ring is
    used by one stage thread only."""

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._rings: dict = {}
        self._next: dict = {}

    def take(self, key) -> _PinnedSlot:
        ring = self._rings.setdefault(key, [_PinnedSlot() for _ in range(self.slots)])
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.slots
        return ring[i]


class PipelinedDispatcher:
    """The pipeline over one :class:`~alphafold2_tpu_torch.serve.engine.
    ServeEngine`: its three stage workers, its streams and pinned rings on
    the card, and the in-flight bound (``submit`` blocks at ``depth``
    batches in flight: the pipeline's backpressure)."""

    def __init__(self, engine, depth: int = 2):
        self.engine = engine
        self.depth = max(1, int(depth))
        self._slots = threading.BoundedSemaphore(self.depth)
        self._host = ThreadPoolExecutor(max_workers=1, thread_name_prefix="af2-pipe-host")
        self._device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="af2-pipe-device")
        self._fetch = ThreadPoolExecutor(max_workers=1, thread_name_prefix="af2-pipe-fetch")
        self.cuda = engine.device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device=engine.device)
            self.compute_stream = torch.cuda.Stream(device=engine.device)
            self._inputs = _PinnedRing(self.depth + 1)
            self._outputs = _PinnedRing(self.depth + 1)

    def submit(self, bucket: int, requests: list, arrival=None,
               joinable: bool = False) -> DispatchHandle:
        """Enqueue one batch; returns its future. ``joinable`` keeps the
        formation open to ``try_join`` up to the engine's batch target
        while the host stage runs; a pre-formed batch stays closed."""
        eng = self.engine
        fill = eng.batch_for(bucket) if joinable else len(requests)
        batch = PipelineBatch(bucket, list(requests), fill=fill)
        handle = DispatchHandle(batch)
        self._slots.acquire()  # backpressure: <= depth batches in flight
        index = eng.counters.bump("serve.batches")
        job = _Job(bucket, index, arrival, batch, handle)
        try:
            self._host.submit(self._host_stage, job)
        except RuntimeError:  # shut down: release the slot we took
            self._slots.release()
            raise
        return handle

    def _stream(self, stream):
        """The thread's device and ``stream`` for a region (nothing on the
        CPU)."""
        stack = ExitStack()
        if self.cuda:
            stack.enter_context(torch.cuda.device(self.engine.device))
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    # ----------------------------------------------------------- the stages

    def _host_stage(self, job: _Job) -> None:
        eng = self.engine
        try:
            job.t_host0 = time.perf_counter()
            if eng.faults is not None:
                # the top-of-dispatch injection point (plans without a stage)
                eng.faults.on_dispatch(job.index, job.bucket)
            with eng.tracer.span("serve.featurize", bucket=job.bucket,
                                 dispatch_index=job.index):
                items: list = []
                job.feat = []
                while True:  # drain members; joiners may land mid-loop
                    req = job.batch.next_member(len(items))
                    if req is None:
                        break  # nothing left unfeaturized: formation sealed
                    item, reuse = eng._featurize_one(job.bucket, req)
                    items.append(item)
                    job.feat.append(reuse)
            job.members = job.batch.members
            job.n_real = len(job.members)
            job.batch_size = eng._padded_batch(job.bucket, job.n_real)
            eng.counters.bump("serve.padded_slots", job.batch_size - job.n_real)
            with eng.tracer.span("serve.device_put", bucket=job.bucket,
                                 dispatch_index=job.index):
                host = eng._stack_host(job.bucket, items, job.batch_size)
                if self.cuda:
                    with self._stream(self.copy_stream):
                        job.stacked = eng._transfer(
                            host, job.index, job.bucket,
                            pinned=self._inputs.take((job.bucket, job.batch_size)))
                        job.copied_in = torch.cuda.Event()
                        job.copied_in.record(self.copy_stream)
                else:
                    job.stacked = eng._transfer(host, job.index, job.bucket)
        except BaseException as e:  # noqa: BLE001 — carried to completion, never raised
            job.batch.seal()
            job.members = job.batch.members
            job.error = e
        self._device.submit(self._device_stage, job)

    def _device_stage(self, job: _Job) -> None:
        eng = self.engine
        try:
            if job.error is None:
                with self._stream(self.compute_stream if self.cuda else None), \
                        torch.inference_mode():
                    if self.cuda:
                        self.compute_stream.wait_event(job.copied_in)
                        for t in job.stacked.values():
                            t.record_stream(self.compute_stream)
                    with eng.tracer.span("serve.get_executable", bucket=job.bucket,
                                         batch=job.batch_size) as exe_span:
                        before = eng.counters.get("serve.compiles")
                        job.compiled = eng._get_executable(job.bucket, job.batch_size)
                        exe_span.set(compiled_now=eng.counters.get("serve.compiles") > before)
                    job.t_device0 = time.perf_counter()
                    with eng.tracer.span("serve.dispatch", bucket=job.bucket,
                                         dispatch_index=job.index):
                        out = eng._execute_batch(job.compiled, job.stacked, job.index,
                                                 job.bucket)
                    job.stacked = None
                    if self.cuda:
                        slot = self._outputs.take((job.bucket, job.batch_size))
                        job.out = {}
                        for k, v in out.items():
                            v = v.float()
                            job.out[k] = slot.buffer(k, v.shape, v.dtype)
                            job.out[k].copy_(v, non_blocking=True)
                        job.done = torch.cuda.Event()
                        job.done.record(self.compute_stream)
                    else:
                        job.out = out
        except BaseException as e:  # noqa: BLE001 — carried to completion
            job.error = e
        self._fetch.submit(self._fetch_stage, job)

    def _wait_copies(self, job: _Job) -> None:
        """Wait for the job's recorded copies, whatever failed, so its
        pinned slots are free before its in-flight slot is released."""
        for event in (job.copied_in, job.done):
            if event is None:
                continue
            try:
                event.synchronize()
            except RuntimeError as e:  # a device-side error
                if job.error is None:
                    job.error = e

    def _fetch_stage(self, job: _Job) -> None:
        eng = self.engine
        try:
            if job.error is None:
                with eng.tracer.span("serve.device_get", bucket=job.bucket,
                                     dispatch_index=job.index):
                    job.fetched = eng._fetch(job.out, job.index, job.bucket, done=job.done)
                job.out = None
        except BaseException as e:  # noqa: BLE001 — carried to completion
            job.error = e
        finally:
            self._wait_copies(job)
        try:
            results = eng._complete_pipelined(job)
        except BaseException as e:  # noqa: BLE001 — completion itself must never wedge
            job.error = e
            results = eng._completion_fallback(job)
        finally:
            self._slots.release()
        job.handle._resolve(results)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the stage workers (in-flight batches finish when ``wait``)."""
        self._host.shutdown(wait=wait)
        self._device.shutdown(wait=wait)
        self._fetch.shutdown(wait=wait)
