"""The serving slice end to end on the CPU: the port's ServeEngine,
pipelined (``serve.pipeline_depth`` 2, the default), against the JAX
package's on weights converted by ``convert.to_state_dict``, with JAX's
tiny scheduler config (``tests/test_scheduler.py:_cfg``) and
``return_distogram``.

One request stream, a mutant family (a parent and two point mutants at
one seed) and an injected compute-stage fault on the first bucket-8
dispatch among them, must give in both engines the same statuses,
buckets, featurization ledger (``feat_reuse``: miss, delta), ``serve.*``
counters, and one compile a rung; the distogram logits and the
``weights`` of every served request agree within ``ATOL`` (f32, the
module-parity bound). Structures are not compared point by point: the MDS
start is a settled difference. The port pipelined is bit-equal to the
port serial, a request joined into a forming batch to the same batch
served serially, and a fault at each stage ("transfer", "compute",
"fetch") gives structured errors and then a served batch, or, through the
frontend, a retried success on the next rung. A scripted burst through
both frontends over both engines gives the same outcomes and counters.
Every engine is closed, and its stage threads stop."""

import threading

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, ServeConfig as JServeConfig
from alphafold2_tpu.serve import AsyncServeFrontend as JFrontend
from alphafold2_tpu.serve import FaultPlan as JFaultPlan
from alphafold2_tpu.serve import ServeEngine as JServeEngine
from alphafold2_tpu.serve import ServeRequest as JServeRequest
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, ServeConfig
from alphafold2_tpu_torch.observe import Tracer
from alphafold2_tpu_torch.observe.tracectx import trace_completeness
from alphafold2_tpu_torch.observe.tracing import merge_intervals
from alphafold2_tpu_torch.predict import build_model
from alphafold2_tpu_torch.serve import AsyncServeFrontend, FaultPlan, ServeEngine, ServeRequest

ATOL = 1e-4  # distogram logits and weights, port vs JAX (f32)
# (seq, seed): bucket 8 x3 (the first two fail at "compute"; the third
# rides a padded slot), a bucket-16 mutant family at seed 5 (parent, two
# point mutants) and an unrelated bucket-16 chain
STREAM = [("ACDEFG", 0), ("MKVLIT", 1), ("WY", 2), ("MKTAYIAKQR", 5), ("MKTAYIAKQW", 5),
          ("MKTAYLAKQR", 5), ("ACDEFGHKLMNP", 3)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _serve_kw(**kw):
    return dict(dict(buckets=(8, 16), max_batch=2, mds_iters=10, return_distogram=True), **kw)


def _cfg(**serve_kw):
    return Config(model=ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48,
                                    bfloat16=False),
                  data=DataConfig(msa_depth=2), serve=ServeConfig(**_serve_kw(**serve_kw)))


def _stage_fault():
    return dict(fail_bucket=8, times=1, fail_stage="compute")


@pytest.fixture(scope="module")
def jax_side():
    cfg = JConfig(model=JModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48,
                                     bfloat16=False),
                  data=JDataConfig(msa_depth=2), serve=JServeConfig(**_serve_kw()))
    engine = JServeEngine(cfg)
    engine.faults = JFaultPlan(**_stage_fault())
    results = engine.predict_many([JServeRequest(s, seed=i) for s, i in STREAM])
    stats = engine.stats()
    engine.faults = None
    yield engine, results, stats
    engine.close()


@pytest.fixture(scope="module")
def state_dict(jax_side):
    params = jax.tree.map(np.asarray, jax_side[0].params)
    return convert.to_state_dict(params, build_model(_cfg()))


@pytest.fixture(scope="module")
def port_side(state_dict):
    engine = ServeEngine(_cfg(), state_dict=state_dict, device="cpu",
                         faults=FaultPlan(**_stage_fault()))
    results = engine.predict_many([ServeRequest(s, seed=i) for s, i in STREAM])
    stats = engine.stats()
    engine.faults = None
    yield engine, results, stats
    engine.close()


@pytest.fixture
def engines(state_dict):
    """Engines a test builds on the converted weights, closed after it."""
    made = []

    def make(**serve_kw):
        kw = {k: serve_kw.pop(k) for k in ("faults", "tracer") if k in serve_kw}
        made.append(ServeEngine(_cfg(**serve_kw), state_dict=state_dict, device="cpu", **kw))
        return made[-1]

    yield make
    for e in made:
        e.close()


def _outcome(results):
    return [(r.seq, r.bucket, r.status, r.feat_reuse) for r in results]


def test_stream_statuses_ledger_and_counters_equal_jax(jax_side, port_side):
    _, ref, ref_stats = jax_side
    engine, out, stats = port_side
    assert engine.pipeline_desc == "depth2"
    assert _outcome(out) == _outcome(ref)
    assert [r.status for r in out] == ["error", "error", "ok", "ok", "ok", "ok", "ok"]
    assert [r.feat_reuse for r in out[2:]] == ["miss", "miss", "delta", "delta", "miss"]
    assert all("InjectedFault" in r.error and "at compute" in r.error for r in out[:2])
    assert {k: v for k, v in stats.items() if k.startswith("serve.")} == ref_stats
    assert stats["serve.compiles"] == stats["serve.traces"] == len(engine.buckets)
    assert (stats.get("serve.feat_hits", 0) + stats["serve.feat_delta"]
            + stats["serve.feat_misses"]) == stats["serve.requests"]
    assert len(engine.compile_records) == 2
    assert {(r["bucket"], r["batch"]) for r in engine.compile_records} == {(8, 2), (16, 2)}


def test_stream_distogram_and_weights_match_jax(jax_side, port_side):
    for r, o in zip(jax_side[1], port_side[1]):
        if not o.ok:
            continue
        n = 3 * len(o.seq)
        assert o.distogram.shape == r.distogram.shape == (n, n, o.distogram.shape[-1])
        np.testing.assert_allclose(o.distogram, r.distogram, atol=ATOL, rtol=0)
        np.testing.assert_allclose(o.weights, r.weights, atol=ATOL, rtol=0)
        assert o.atom14.shape == (len(o.seq), 14, 3) and np.isfinite(o.atom14).all()


def test_pipelined_is_bit_equal_to_serial(port_side, engines):
    serial = engines(pipeline_depth=0)
    assert serial.pipeline is None and serial.pipeline_desc == "off"
    got = serial.predict_many([ServeRequest(s, seed=i) for s, i in STREAM])
    assert all(r.ok for r in got)
    for p, s in zip(port_side[1], got):
        if not p.ok:
            continue
        assert (p.seq, p.bucket, p.feat_reuse) == (s.seq, s.bucket, s.feat_reuse)
        for k in ("atom14", "backbone", "weights", "distogram"):
            assert getattr(p, k).tobytes() == getattr(s, k).tobytes(), k
    assert all(r.latency_s == pytest.approx(r.queue_wait_s + r.dispatch_s)
               for r in port_side[1])


def test_dispatch_batch_equals_the_pipelined_batch(port_side, engines):
    serial = engines(pipeline_depth=0)
    reqs = [ServeRequest("MKTAYIAKQR", seed=5), ServeRequest("MKTAYIAKQW", seed=5)]
    one = serial.dispatch_batch(16, reqs)
    for p, s in zip(port_side[1][3:5], one):
        assert p.atom14.tobytes() == s.atom14.tobytes()
    with pytest.raises(RuntimeError, match="pipeline_depth > 0"):
        serial.dispatch_batch_async(16, reqs)


@pytest.mark.parametrize("stage", ["transfer", "compute", "fetch"])
def test_stage_fault_gives_errors_then_a_served_batch(engines, stage):
    plan = FaultPlan(fail_bucket=8, times=1, fail_stage=stage)
    eng = engines(faults=plan)
    out = eng.predict_many([ServeRequest("ACDEFG", seed=0), ServeRequest("MK", seed=1)])
    assert [r.status for r in out] == ["error", "error"]
    assert all("InjectedFault" in r.error and stage in r.error and r.atom14 is None
               for r in out)
    assert plan.fired == [{"dispatch": 1, "bucket": 8, "stage": stage}]
    assert eng.stats()["serve.dispatch_errors"] == 1
    ok = eng.predict_many([ServeRequest("ACDEFG", seed=0)])[0]
    assert ok.ok and np.isfinite(ok.atom14).all()


@pytest.mark.parametrize("stage", ["transfer", "compute", "fetch", None])
def test_frontend_retries_a_stage_fault_on_the_next_rung(engines, stage):
    plan = FaultPlan(fail_bucket=8, times=1, fail_stage=stage)
    eng = engines(faults=plan)
    with AsyncServeFrontend(eng) as fe:
        r = fe.submit("ACDEFG").result(120)
    assert r.ok and r.retried and r.bucket == 16
    assert plan.fired == [{"dispatch": 1, "bucket": 8, **({"stage": stage} if stage else {})}]
    s = eng.stats()
    assert s["serve.dispatch_errors"] == 1 and s["sched.retries"] == 1
    assert np.isfinite(r.atom14).all()


def test_an_exception_in_the_forward_becomes_errors(engines):
    eng = engines()
    forward = eng.model.forward

    def poisoned(seq, *args, **kwargs):
        if seq.shape[1] == 8:
            raise TypeError("poison pill")
        return forward(seq, *args, **kwargs)

    eng.model.forward = poisoned
    out = eng.predict_many(["ACDEFG", "MKVLAAGIHK"])
    assert [r.status for r in out] == ["error", "ok"]
    assert out[0].error == "TypeError: poison pill"


def test_inflight_admitted_request_is_bit_equal(engines, monkeypatch):
    eng = engines()
    gate, started = threading.Event(), threading.Event()
    orig = ServeEngine._featurize_one

    def gated(self, bucket, req):
        started.set()
        assert gate.wait(30), "test gate never opened"
        return orig(self, bucket, req)

    monkeypatch.setattr(ServeEngine, "_featurize_one", gated)
    r1, r2 = ServeRequest("ACDEFG", seed=3), ServeRequest("MKVLIT", seed=4)
    handle = eng.dispatch_batch_async(8, [r1], joinable=True)
    assert started.wait(30)  # the host stage is inside member 0's featurize
    assert handle.try_join(r2)
    gate.set()
    got = handle.result(timeout=120)
    monkeypatch.undo()
    assert [r.status for r in got] == ["ok", "ok"]
    assert not handle.try_join(ServeRequest("WY", seed=5))  # sealed
    serial = engines(pipeline_depth=0).dispatch_batch(
        8, [ServeRequest("ACDEFG", seed=3), ServeRequest("MKVLIT", seed=4)])
    for p, s in zip(got, serial):
        assert p.atom14.tobytes() == s.atom14.tobytes()
        assert p.weights.tobytes() == s.weights.tobytes()


def test_predict_many_overlaps_host_and_device_and_spans(engines):
    """Some batch's host stage runs inside another batch's device window
    (the trace intervals overlap), and the pipelined spans carry their
    dispatch index and member trace ids."""
    tracer = Tracer(enabled=True)
    eng = engines(tracer=tracer)
    eng.warmup()
    reqs = [ServeRequest("ACDEFG", seed=i) for i in range(8)]
    eng.predict_many(reqs)
    host, dev = {}, {}
    events = tracer.events()
    for e in events:
        idx = (e.get("args") or {}).get("dispatch_index")
        if e.get("ph") != "X" or idx is None:
            continue
        iv = (e["ts"] / 1e6, (e["ts"] + e.get("dur", 0)) / 1e6)
        if e["name"] in ("serve.featurize", "serve.device_put"):
            host.setdefault(idx, []).append(iv)
        elif e["name"] in ("serve.dispatch", "serve.device_get"):
            dev.setdefault(idx, []).append(iv)
    assert len(dev) == 4
    overlap = 0.0
    for i, ivs in dev.items():
        others = merge_intervals([iv for j, h in host.items() if j != i for iv in h])
        for ds, de in merge_intervals(ivs):
            for hs, he in others:
                overlap += max(0.0, min(de, he) - max(ds, hs))
    assert overlap > 0.0, "no host stage ran inside another device window"
    batches = [e for e in events if e["name"] == "serve.batch"]
    assert len(batches) == 4 and all(e["args"]["pipelined"] for e in batches)
    assert sorted(t for e in batches for t in e["args"]["trace_ids"]) == sorted(
        r.trace.trace_id for r in reqs)
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"serve.compile", "serve.featurize", "serve.device_put", "serve.get_executable",
            "serve.dispatch", "serve.device_get", "serve.unpad", "serve.batch"} <= names


def test_frontend_traces_reconstruct_complete(engines):
    tracer = Tracer(enabled=True)
    eng = engines(tracer=tracer)
    with AsyncServeFrontend(eng) as fe:
        handles = [fe.submit(ServeRequest(s, seed=1))
                   for s in ("ACDEFG", "MKVLIT", "ACDEFGHKLMNP", "ACDEFG", "WY")]
        results = [h.result(120) for h in handles]
    assert all(r.ok for r in results) and results[3].cache_hit
    done = trace_completeness(tracer.events(), [h.request.trace.trace_id for h in handles])
    assert done["fraction"] == 1.0 and done["total"] == 5


def test_warmup_one_compile_a_rung_and_the_cost_ledger(engines):
    eng = engines()
    snap = eng.warmup()
    assert snap["serve.traces"] == snap["serve.compiles"] == 2
    out = eng.predict_many([ServeRequest(s, seed=0) for s in ("AC", "ACDEF", "ACDEFGH", "W")])
    s = eng.stats()
    assert s["serve.compiles"] == 2 and s["serve.cache_hits"] == 2  # 4 requests, 2 batches
    for r in out:
        assert set(r.cost) == {"queue_wait_s", "device_share_s", "compile_share_s",
                               "flops_share", "pad_fraction"}
        assert r.cost["flops_share"] is None and 0 < r.cost["pad_fraction"] < 1
    h = eng.histogram_snapshots(1e3)
    assert h["latency_s"]["count"] == 4 and h["batch_occupancy"]["count"] == 2
    assert h["pad_ratio"]["count"] == 4


def test_depth_one_backpressure_and_refusals(engines):
    eng = engines(pipeline_depth=1)
    assert eng.pipeline_desc == "depth1"
    assert all(r.ok for r in eng.predict_many([ServeRequest("ACDEFG", seed=i)
                                               for i in range(5)]))
    with pytest.raises(ValueError, match="pipeline_depth"):
        engines(pipeline_depth=-1)
    with pytest.raises(NotImplementedError, match="long buckets"):
        engines(long_buckets=(32,))


def test_close_stops_the_stage_threads(engines):
    before = {t.ident for t in threading.enumerate()}
    eng = engines()
    assert eng.predict_many([ServeRequest("AC", seed=0)])[0].ok
    mine = [t for t in threading.enumerate()
            if t.ident not in before and t.name.startswith("af2-pipe-")]
    assert len(mine) == 3
    eng.close()
    for t in mine:
        t.join(10)
    assert not any(t.is_alive() for t in mine)
    with pytest.raises(RuntimeError):
        eng.dispatch_batch_async(8, [ServeRequest("AC", seed=1)])


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _burst(frontend_cls, engine, request_cls, plan):
    """A scripted burst (pumped inline on a fake clock, every request in
    before the one pump, so formation is fixed): duplicates, a mutant
    family, a deadline already passed, a queued stage fault; then repeats
    served from the result cache."""
    engine.faults = plan
    clock = _Clock()
    fe = frontend_cls(engine, clock=clock, start=False)
    try:
        seqs = [("ACDEFG", 0), ("ACDEFG", 0), ("MKTAYIAKQR", 6), ("MKTAYIAKQW", 6),
                ("MKTAYLAKQR", 6), ("WYWYWY", 2)]
        handles = [fe.submit(request_cls(s, seed=i)) for s, i in seqs]
        late = fe.submit(request_cls("GGGG", seed=9), deadline_s=0.5)
        clock.now += 1.0
        fe.pump()
        results = [h.result(120) for h in handles + [late]]
        again = [fe.submit(request_cls(s, seed=i)).result(10) for s, i in seqs[:3]]
        return ([(r.seq, r.bucket, r.status, r.cache_hit, r.retried, r.feat_reuse)
                 for r in results + again],
                {k: v for k, v in fe.stats().items() if k.startswith("sched.")},
                results + again)
    finally:
        fe.close()
        engine.faults = None


def test_frontend_burst_equals_jax(jax_side, port_side):
    jeng, peng = jax_side[0], port_side[0]
    j_out, j_sched, _ = _burst(JFrontend, jeng, JServeRequest,
                               JFaultPlan(fail_bucket=8, times=1, fail_stage="transfer"))
    p_out, p_sched, results = _burst(AsyncServeFrontend, peng, ServeRequest,
                                     FaultPlan(fail_bucket=8, times=1, fail_stage="transfer"))
    assert p_out == j_out and p_sched == j_sched
    assert ({k: v for k, v in peng.stats().items() if k.startswith("serve.")}
            == {k: v for k, v in jeng.stats().items() if k.startswith("serve.")})
    statuses = [o[2] for o in p_out]
    assert statuses.count("deadline_exceeded") == 1 and statuses.count("ok") == 9
    assert p_out[1][3] and all(o[3] for o in p_out[-3:])  # dedup, then the result cache
    assert any(o[4] for o in p_out)  # the fault's batch came back retried
    assert {o[5] for o in p_out} >= {"delta"}
    assert results[1].atom14 is results[0].atom14

