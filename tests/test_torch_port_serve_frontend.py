"""The async frontend (``serve/scheduler.py``) in the port against the JAX
package's, on JAX's scripted scenarios (``tests/test_scheduler.py``): a
fake clock, ``start=False`` (the dispatcher pumped inline) and a fake
engine that records each dispatch and never runs a model. Each scenario
runs through both frontends, each over its own package's request, result,
counter, tracer and pipeline classes, and returns everything a caller or
an operator can observe: the dispatch log, each handle's status, error,
latency, ``retry_after_s``, cache and retry flags, the counters and the
trace events without their random ids. The two must be equal.

Scenarios: dwell against fill, buckets batching apart, deadlines (own and
default), the bounded queue's reject, shedding at the watermark, an
unservable request, close, in-flight dedup, result-cache hits, distinct
seeds, LRU churn under a waiting follower, retry on the next rung, retry
exhaustion, retry off, parent-affinity batching, and in-flight admission
into a pipelined batch that is still forming (and its failure's retry)."""

import types

import numpy as np
import pytest
import torch

import alphafold2_tpu.config as jconfig
import alphafold2_tpu.observe as jobserve
import alphafold2_tpu.observe.tracectx as jtracectx
import alphafold2_tpu.serve as jserve
import alphafold2_tpu_torch.config as config
import alphafold2_tpu_torch.observe as observe
import alphafold2_tpu_torch.observe.tracectx as tracectx
import alphafold2_tpu_torch.serve as serve

PORT = types.SimpleNamespace(config=config, observe=observe, serve=serve, tracectx=tracectx)
JAX = types.SimpleNamespace(config=jconfig, observe=jobserve, serve=jserve, tracectx=jtracectx)
ID_ARGS = ("trace_id", "span_id", "parent_id", "trace_ids", "leader_trace")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(fw, buckets=(8, 16), max_batch=2, **serve_kw):
    """JAX's tests/test_scheduler.py:_cfg in either package."""
    serve_kw.setdefault("mds_iters", 10)
    c = fw.config
    return c.Config(
        model=c.ModelConfig(dim=32, depth=1, heads=2, dim_head=16,
                            max_seq_len=3 * max(buckets), bfloat16=False),
        data=c.DataConfig(msa_depth=2),
        serve=c.ServeConfig(buckets=buckets, max_batch=max_batch, **serve_kw),
    )


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class FakeEngine:
    """JAX's FakeEngine (tests/test_scheduler.py) over either package:
    records every dispatch, fails the first ``fail_first``. With
    ``pipelined`` it also takes ``dispatch_batch_async`` and holds each
    handle until the scenario completes it."""

    def __init__(self, fw, cfg, fail_first=0, pipelined=False):
        self.fw = fw
        self.cfg = cfg
        self.buckets = cfg.serve.buckets
        self.max_batch = cfg.serve.max_batch
        self.mesh_desc = None
        self.counters = fw.observe.EventCounters()
        self.tracer = fw.observe.Tracer(enabled=True)
        self.dispatched = []  # (bucket, [seq, ...]) per dispatch
        self._fail_remaining = fail_first
        self.pipeline = object() if pipelined else None
        self.handles = []

    def batch_for(self, bucket):
        return self.max_batch

    def _results(self, bucket, reqs):
        if self._fail_remaining > 0:
            self._fail_remaining -= 1
            return [self.fw.serve.ServeResult(seq=r.seq, bucket=bucket, status="error",
                                              error="InjectedFault: boom") for r in reqs]
        return [self.fw.serve.ServeResult(seq=r.seq, bucket=bucket,
                                          atom14=np.zeros((len(r.seq), 14, 3), np.float32),
                                          latency_s=1e-3) for r in reqs]

    def dispatch_batch(self, bucket, reqs):
        self.dispatched.append((bucket, [r.seq for r in reqs]))
        return self._results(bucket, reqs)

    def dispatch_batch_async(self, bucket, reqs, joinable=False):
        fill = self.batch_for(bucket) if joinable else len(reqs)
        handle = self.fw.serve.DispatchHandle(self.fw.serve.PipelineBatch(bucket, list(reqs),
                                                                          fill=fill))
        self.handles.append(handle)
        return handle

    def complete(self, i):
        """The host stage drains and seals handle ``i``'s batch, then its
        results resolve it (as the pipeline's fetch worker would)."""
        handle = self.handles[i]
        n = 0
        while handle.batch.next_member(n) is not None:
            n += 1
        members = handle.batch.members
        self.dispatched.append((handle.batch.bucket, [r.seq for r in members]))
        handle._resolve(self._results(handle.batch.bucket, members))

    def retry_bucket(self, bucket):
        i = self.buckets.index(bucket)
        return self.buckets[i + 1] if i + 1 < len(self.buckets) else None


def _frontend(fw, fail_first=0, pipelined=False, **serve_kw):
    serve_kw.setdefault("dwell_ms", 50.0)
    eng = FakeEngine(fw, _cfg(fw, **serve_kw), fail_first=fail_first, pipelined=pipelined)
    clock = FakeClock()
    fe = fw.serve.AsyncServeFrontend(eng, clock=clock, start=False)
    return fe, eng, clock


def _observed(fw, fe, eng, handles, extra):
    """Everything the scenario exposes, ids and wall times left out."""
    out = {"extra": extra, "dispatched": eng.dispatched, "counters": fe.stats(),
           "histograms": {k: v.get("count") for k, v in fe.histogram_snapshots().items()},
           "cache": fe.cache.stats()}
    res = []
    for h in handles:
        if not h.done():
            res.append("pending")
            continue
        r = h.result(0)
        res.append((r.seq, r.bucket, r.status, r.error, r.retry_after_s, r.cache_hit, r.retried,
                    round(r.queue_wait_s, 9), r.trace_id == h.request.trace.trace_id,
                    None if r.atom14 is None else r.atom14.shape))
    out["results"] = res
    events = eng.tracer.events()
    out["events"] = [(e["name"], e["ph"],
                      {k: v for k, v in (e.get("args") or {}).items() if k not in ID_ARGS})
                     for e in events if e["name"].startswith("sched.")]
    done = fw.tracectx.trace_completeness(
        events, [h.request.trace.trace_id for h in handles if h.done()])
    out["completeness"] = {k: done[k] for k in ("total", "complete", "fraction")}
    return out


# ------------------------------------------------------------------ scenarios


def fill_without_dwell(fw):
    fe, eng, clock = _frontend(fw)
    hs = [fe.submit("ACDEFG"), fe.submit("MKVLIT")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def dwell_then_partial(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=50.0)
    hs = [fe.submit("ACDEFG")]
    pumps = [fe.pump(), hs[0].done()]
    clock.advance(0.049)
    pumps.append(fe.pump())
    clock.advance(0.002)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps)


def buckets_batch_apart(fw):
    fe, eng, clock = _frontend(fw)
    hs = [fe.submit("ACDEFG"), fe.submit("ACDEFGHKLMNP")]
    pumps = [fe.pump()]
    clock.advance(0.051)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps)


def deadline_miss(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=10_000.0)
    hs = [fe.submit("ACDEFG", deadline_s=0.2), fe.submit("ACDEFGHKLMNP", deadline_s=1.0)]
    clock.advance(0.3)
    pumps = [fe.pump()]
    clock.advance(1.0)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps)


def default_deadline(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=10_000.0, default_deadline_s=0.1)
    hs = [fe.submit("ACDEFG"), fe.submit("MKVL", deadline_s=5.0)]
    clock.advance(0.2)
    return _observed(fw, fe, eng, hs, [fe.pump()])


def deadline_met(fw):
    fe, eng, clock = _frontend(fw)
    hs = [fe.submit("ACDEFG", deadline_s=1.0), fe.submit("MKVLIT")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def queue_full_reject(fw):
    fe, eng, clock = _frontend(fw, queue_depth=2, dwell_ms=10_000.0, shed_watermark=0.0)
    hs = [fe.submit(s, priority=1) for s in ("ACDE", "MKVL", "GHKL")]
    clock.advance(11.0)
    pumps = [fe.pump()]
    hs.append(fe.submit("WYTS", priority=1))
    return _observed(fw, fe, eng, hs, pumps)


def shed_at_watermark(fw):
    fe, eng, clock = _frontend(fw, queue_depth=4, dwell_ms=10_000.0, shed_watermark=0.5)
    hs = [fe.submit("ACDE"), fe.submit("MKVL"), fe.submit("GHKL"),
          fe.submit("WYTS", priority=1), fe.submit("ACDEFGHKL", priority=-1)]
    return _observed(fw, fe, eng, hs, [])


def unservable(fw):
    fe, eng, clock = _frontend(fw)
    hs = [fe.submit("A" * 40), fe.submit("")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def close_resolves_queued(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=10_000.0)
    hs = [fe.submit("ACDEFG")]
    fe.close()
    hs.append(fe.submit("MKVLIT"))  # a late arrival racing close
    return _observed(fw, fe, eng, hs, [])


def inflight_dedup(fw):
    fe, eng, clock = _frontend(fw)
    req = fw.serve.ServeRequest
    hs = [fe.submit(req("ACDEFG", seed=7)), fe.submit(req("ACDEFG", seed=7))]
    pumps = [fe.pump()]
    clock.advance(0.051)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps + [hs[1].result(0).atom14 is hs[0].result(0).atom14])


def cache_hit_skips_queue(fw):
    fe, eng, clock = _frontend(fw, queue_depth=1, dwell_ms=10_000.0, shed_watermark=0.0)
    req = fw.serve.ServeRequest
    hs = [fe.submit(req("ACDEFG", seed=7)), fe.submit("MKVLIT")]
    clock.advance(11.0)
    pumps = [fe.pump()]
    hs += [fe.submit("XXXX"), fe.submit(req("ACDEFG", seed=7))]
    return _observed(fw, fe, eng, hs, pumps)


def distinct_seeds(fw):
    fe, eng, clock = _frontend(fw)
    req = fw.serve.ServeRequest
    hs = [fe.submit(req("ACDEFG", seed=1)), fe.submit(req("ACDEFG", seed=2))]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def lru_churn_with_follower(fw):
    fe, eng, clock = _frontend(fw, cache_size=1, dwell_ms=10_000.0)
    req = fw.serve.ServeRequest
    hs = [fe.submit(req("ACDEFG", seed=7)), fe.submit(req("ACDEFG", seed=7))]
    pumps = [fe.pump()]
    hs += [fe.submit("ACDEFGHKLMNP"), fe.submit("WWWWWWWWWWWW")]
    pumps += [fe.pump(), fe.cache.stats()]
    clock.advance(10.1)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps)


def retry_next_rung(fw):
    fe, eng, clock = _frontend(fw, fail_first=1)
    hs = [fe.submit("ACDEFG"), fe.submit("MKVLIT")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def retry_exhausted(fw):
    fe, eng, clock = _frontend(fw, fail_first=2)
    hs = [fe.submit("ACDEFG"), fe.submit("MKVLIT")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def retry_off(fw):
    fe, eng, clock = _frontend(fw, fail_first=1, retry_failed=False)
    hs = [fe.submit("ACDEFG"), fe.submit("MKVLIT")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def affinity_batching(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=10_000.0, queue_depth=16, max_batch=3,
                               shed_watermark=0.0)
    req = fw.serve.ServeRequest
    hs = [fe.submit("MKTAYIAKQR"), fe.submit("ACDEFGHIKL"), fe.submit("WYTSRQPNML"),
          fe.submit("MKTAYIAKQW"), fe.submit(req("GGGGGGGGGG", parent_id="p1")),
          fe.submit("MKTAYLAKQR"), fe.submit(req("GGGGGGGGGA", parent_id="p1"))]
    pumps = [fe.pump()]
    clock.advance(11.0)
    pumps.append(fe.pump())
    return _observed(fw, fe, eng, hs, pumps)


def affinity_off(fw):
    fe, eng, clock = _frontend(fw, dwell_ms=10_000.0, queue_depth=16, max_batch=3,
                               shed_watermark=0.0, affinity_batching=False)
    hs = [fe.submit(s) for s in ("MKTAYIAKQR", "ACDEFGHIKL", "WYTSRQPNML", "MKTAYIAKQW")]
    return _observed(fw, fe, eng, hs, [fe.pump()])


def inflight_join(fw):
    fe, eng, clock = _frontend(fw, pipelined=True, dwell_ms=0.0)
    req = fw.serve.ServeRequest
    steps = [fe.inflight_admission]
    hs = [fe.submit(req("ACDEFG", seed=1))]
    steps.append(fe.pump())  # zero dwell: dispatched, still forming
    hs.append(fe.submit(req("MKVLIT", seed=2)))  # joins in flight
    hs.append(fe.submit(req("WYWYWY", seed=3)))  # the batch is full: queued
    steps.append(fe.load_snapshot())
    eng.complete(0)
    steps.append(fe.pump())
    hs.append(fe.submit(req("ACDEFGHKLMNP", seed=4)))
    steps.append(fe.pump())
    steps.append(fe.load_snapshot())
    eng.complete(1)
    eng.complete(2)
    return _observed(fw, fe, eng, hs, steps)


def inflight_failure_retried(fw):
    fe, eng, clock = _frontend(fw, pipelined=True, dwell_ms=0.0, fail_first=1)
    hs = [fe.submit("ACDEFG")]
    steps = [fe.pump()]
    hs.append(fe.submit("MKVLIT"))
    eng.complete(0)  # fails; the frontend retries it on rung 16, serially
    return _observed(fw, fe, eng, hs, steps)


def inflight_admission_off(fw):
    fe, eng, clock = _frontend(fw, pipelined=True, dwell_ms=0.0, inflight_admission=False)
    hs = [fe.submit("ACDEFG")]
    steps = [fe.inflight_admission, fe.pump()]
    hs.append(fe.submit("MKVLIT"))
    steps.append(fe.pump())
    eng.complete(0)
    eng.complete(1)
    return _observed(fw, fe, eng, hs, steps)


SCENARIOS = [fill_without_dwell, dwell_then_partial, buckets_batch_apart, deadline_miss,
             default_deadline, deadline_met, queue_full_reject, shed_at_watermark, unservable,
             close_resolves_queued, inflight_dedup, cache_hit_skips_queue, distinct_seeds,
             lru_churn_with_follower, retry_next_rung, retry_exhausted, retry_off,
             affinity_batching, affinity_off, inflight_join, inflight_failure_retried,
             inflight_admission_off]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_frontend_scenario_equals_jax(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    # each scenario resolves what it submitted, and every resolved trace
    # reconstructs complete
    assert port["completeness"]["fraction"] == 1.0


def test_scenarios_show_what_they_pin():
    """Spot checks that the scenarios exercise their paths (so equality is
    not vacuous)."""
    dedup = inflight_dedup(PORT)
    assert dedup["extra"] == [0, 1, True] and dedup["counters"]["sched.inflight_dedup"] == 1
    shed = shed_at_watermark(PORT)
    assert [r[2] if r != "pending" else r for r in shed["results"]] == [
        "pending", "pending", "rejected", "pending", "rejected"]
    full = queue_full_reject(PORT)
    assert full["results"][2][2] == "rejected" and full["results"][2][4] > 0
    retried = retry_next_rung(PORT)
    assert [b for b, _ in retried["dispatched"]] == [8, 16]
    assert all(r[6] for r in retried["results"])
    joined = inflight_join(PORT)
    assert joined["counters"]["sched.inflight_admitted"] == 1
    assert joined["dispatched"][0] == (8, ["ACDEFG", "MKVLIT"])
    aff = affinity_batching(PORT)
    assert aff["counters"]["sched.affinity_batches"] >= 1
    miss = deadline_miss(PORT)
    assert miss["results"][0][2] == "deadline_exceeded"
