"""The serving slice's pure-host parts in the port against the JAX
package's, on the same inputs: the bucket ladder and the mutant families
(``serve/bucketing.py``), the cache keys, the result cache's LRU and
in-flight dedup, the feature cache's interning and delta parents
(``serve/cache.py``), fault plans (``serve/faults.py``), ``Histogram``
quantiles, ``TraceContext`` and trace reconstruction
(``observe/tracectx.py``), the tracer's trace ids, ``EventCounters``, and
the featurization with its delta plan (``data/pipeline.py``), which must
be byte-identical. All equal, tolerance zero."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from alphafold2_tpu.data import pipeline as jpipe
from alphafold2_tpu.observe import histogram as jhist
from alphafold2_tpu.observe import metrics as jmetrics
from alphafold2_tpu.observe import tracectx as jctx
from alphafold2_tpu.observe import tracing as jtracing
from alphafold2_tpu.serve import bucketing as jbuck
from alphafold2_tpu.serve import cache as jcache
from alphafold2_tpu.serve import faults as jfaults
from alphafold2_tpu_torch.data import pipeline as pipe
from alphafold2_tpu_torch.observe import histogram as hist
from alphafold2_tpu_torch.observe import metrics
from alphafold2_tpu_torch.observe import tracectx as ctx
from alphafold2_tpu_torch.observe import tracing
from alphafold2_tpu_torch.observe.memory import MemorySampler
from alphafold2_tpu_torch.serve import bucketing as buck
from alphafold2_tpu_torch.serve import cache
from alphafold2_tpu_torch.serve import faults

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _both(fn_port, fn_jax, *args, **kwargs):
    """``(port result or exception text, JAX result or exception text)``."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn(*args, **kwargs))
        except (ValueError, TypeError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


# ------------------------------------------------------------------ bucketing


@pytest.mark.parametrize("ladder", [(8, 16), [64, 96, 128, 192, 256], (5,), (), (8, 8),
                                    (16, 8), (0, 4), ("32", 64.0)])
def test_validate_ladder(ladder):
    a, b = _both(buck.validate_ladder, jbuck.validate_ladder, ladder)
    assert a == b


@pytest.mark.parametrize("length", [-1, 0, 1, 8, 9, 16, 50, 64, 65, 129, 256, 257])
def test_bucket_for(length):
    ladder = (8, 16, 64, 128, 256)
    a, b = _both(buck.bucket_for, jbuck.bucket_for, length, ladder)
    assert a == b


@pytest.mark.parametrize("lo,hi,ratio", [(64, 256, 1.5), (8, 16, 1.5), (10, 1000, 1.25),
                                         (16, 16, 2.0), (32, 1024, 2.0), (0, 8, 1.5),
                                         (8, 4, 1.5), (8, 64, 1.0)])
def test_geometric_ladder(lo, hi, ratio):
    a, b = _both(buck.geometric_ladder, jbuck.geometric_ladder, lo, hi, ratio)
    assert a == b


def test_formation_ripe_and_padding_fraction():
    grid = [(n, fill, wait, dwell) for n in (0, 1, 2, 3) for fill in (0, 1, 2)
            for wait in (0.0, 0.01, 0.05) for dwell in (0.0, 0.025)]
    assert ([buck.formation_ripe(*g) for g in grid]
            == [jbuck.formation_ripe(*g) for g in grid])
    for lengths in ([], [8], [1, 9, 17, 64], list(range(1, 129, 7))):
        assert (buck.padding_fraction(lengths, (8, 16, 64, 128))
                == jbuck.padding_fraction(lengths, (8, 16, 64, 128)))


def test_point_mutation():
    rng = np.random.default_rng(0)
    base = "".join(rng.choice(list(ALPHABET), 12))
    others = [base, base[:-1], base + "A", base[:3] + "W" + base[4:],
              base[:3] + "W" + base[4:7] + "Y" + base[8:], "W" + base[1:], base[:-1] + "Y"]
    for o in others:
        assert buck.point_mutation(base, o) == jbuck.point_mutation(base, o)


def _family_stream(seed=3, n=40):
    """Parents, their point mutants, repeats, hints and unrelated chains."""
    rng = np.random.default_rng(seed)
    parents = ["".join(rng.choice(list(ALPHABET), 10)) for _ in range(3)]
    stream = []
    for i in range(n):
        p = parents[int(rng.integers(0, 3))]
        kind = int(rng.integers(0, 4))
        if kind == 0:
            stream.append((p, None))
        elif kind == 1:
            pos = int(rng.integers(0, len(p)))
            stream.append((p[:pos] + ALPHABET[int(rng.integers(0, 20))] + p[pos + 1:], None))
        elif kind == 2:
            stream.append(("".join(rng.choice(list(ALPHABET), 10)), None))
        else:
            stream.append((p, f"scan{i % 2}"))
    return stream


@pytest.mark.parametrize("window", [1, 4, 64])
def test_family_tracker(window):
    port, ref = buck.FamilyTracker(window), jbuck.FamilyTracker(window)
    for seq, hint in _family_stream():
        assert port.observe(seq, hint) == ref.observe(seq, hint)


@dataclasses.dataclass
class _P:
    name: str
    family: object = None


@pytest.mark.parametrize("fill", [0, 1, 2, 3, 8])
def test_affinity_take(fill):
    queues = [[], [_P("a")], [_P("a", "f"), _P("b"), _P("c", "f"), _P("d", "g"), _P("e", "f")],
              [_P("a"), _P("b", "f"), _P("c", "f")], [_P("a", "f"), _P("b", "g"), _P("c")]]
    for q in queues:
        assert ([p.name for p in buck.affinity_take(q, fill)]
                == [p.name for p in jbuck.affinity_take(q, fill)])


# ------------------------------------------------------------------ caches


@pytest.mark.parametrize("args", [("ACDEFG", 0, None), ("ACDEFG", 7, "dp2"), ("", 3, None)])
def test_result_key(args):
    assert cache.result_key(*args) == jcache.result_key(*args)


def test_feature_key_and_fingerprint():
    assert cache.feature_key("MKV", 16, 5, 2) == jcache.feature_key("MKV", 16, 5, 2)
    tokens = np.arange(11, dtype=np.int32) % 20
    item = pipe.featurize_bucketed(tokens, 16, 3, seed=4)
    assert cache.feature_fingerprint(item) == jcache.feature_fingerprint(item)
    other = pipe.featurize_bucketed(tokens, 16, 3, seed=5)
    assert cache.feature_fingerprint(other) != cache.feature_fingerprint(item)


def _result_cache_script(mod):
    """JAX's scripted LRU/dedup protocol (tests/test_scheduler.py) and
    more: every return value, in order."""
    log = []
    c = mod.ResultCache(capacity=2)
    log.append(c.lookup_or_claim("a")[0])
    log.append(c.lookup_or_claim("a", follower_ctx="ctx")[0])
    log.append(c.lookup_or_claim("a", follower_ctx="ctx2")[0])
    log.append(c.fulfill("a", "ra"))
    for key, res in (("b", "rb"), ("c", "rc")):
        log.append(c.lookup_or_claim(key)[0])
        log.append(c.fulfill(key, res))
    log += [c.peek("a"), c.lookup_or_claim("c"), c.lookup_or_claim("d")[0]]
    log += [c.fulfill("d", "err", cache=False), c.peek("d"), c.stats(), len(c)]
    log.append(c.lookup_or_claim("b"))
    log.append(c.fulfill("never-claimed", "x"))
    log += [c.stats(), len(c)]
    nocache = mod.ResultCache(capacity=0)
    log += [nocache.lookup_or_claim("x")[0], nocache.lookup_or_claim("x")[0],
            nocache.fulfill("x", "rx"), nocache.lookup_or_claim("x")[0], nocache.stats()]
    return log


def test_result_cache_lru_and_dedup():
    assert _result_cache_script(cache) == _result_cache_script(jcache)


def _feature_cache_script(mod, featurize, capacity):
    """Puts, lookups, delta parents, evictions and the interning counts of
    a feature cache over one traffic: returns every observable."""
    fc = mod.FeatureCache(capacity)
    log = []
    rng = np.random.default_rng(1)
    parent = rng.integers(0, 20, 10).astype(np.int32)
    for i in range(12):
        tokens = parent.copy()
        if i % 3:
            tokens[i % 10] = (tokens[i % 10] + 1) % 20
        seed = i % 2
        seq = "".join(ALPHABET[t] for t in tokens)
        key = mod.feature_key(seq, 16, 3, seed)
        found = fc.lookup(key)
        log.append(None if found is None else mod.feature_fingerprint(found[0]))
        if found is None:
            item, plan = featurize(tokens, 16, 3, seed=seed)
            stored = fc.put(key, item, plan)
            log.append(mod.feature_fingerprint(stored))
            log.append(all(not a.flags.writeable for a in stored.values()) if capacity else None)
        parents = fc.delta_parent(16, 3, seed, 10)
        log.append([(mod.feature_fingerprint(it), pl["tokens"].tolist()) for it, pl in parents])
        log.append((len(fc), fc.stats()))
    return log


@pytest.mark.parametrize("capacity", [0, 2, 128])
def test_feature_cache_interning_and_delta_parents(capacity):
    assert (_feature_cache_script(cache, pipe.featurize_bucketed_with_plan, capacity)
            == _feature_cache_script(jcache, jpipe.featurize_bucketed_with_plan, capacity))


# ------------------------------------------------------------------ faults


@pytest.mark.parametrize("spec", [None, "", "dispatch=2", "bucket=16,times=2,delay=0,fail=1",
                                  "dispatch=1,fail=0", "bucket=8,times=1,stage=compute",
                                  "stage=fetch,fail=no", "nope=1", "stage=bogus"])
def test_fault_plan_from_spec(spec):
    a, b = _both(faults.FaultPlan.from_spec, jfaults.FaultPlan.from_spec, spec)
    if isinstance(a, str) or a is None:
        assert a == b
    else:
        fields = [f.name for f in dataclasses.fields(jfaults.FaultPlan)]
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


def _fire(mod, kwargs):
    plan = mod.FaultPlan(**kwargs)
    log = []
    for index, bucket, stage in [(1, 8, None), (2, 8, None), (2, 16, "transfer"),
                                 (3, 16, "compute"), (3, 16, "fetch"), (4, 8, "compute"),
                                 (5, 16, None), (6, 8, "fetch"), (7, 8, None)]:
        try:
            if stage is None:
                plan.on_dispatch(index, bucket)
            else:
                plan.on_stage(stage, index, bucket)
            log.append("pass")
        except mod.InjectedFault as e:
            log.append(str(e))
    return log, plan.fired


@pytest.mark.parametrize("kwargs", [dict(fail_dispatch=2), dict(fail_bucket=16, times=2),
                                    dict(fail_bucket=8, times=0), dict(match_all=True, times=3),
                                    dict(fail_bucket=8, fail=False),
                                    dict(fail_bucket=16, fail_stage="compute", times=0),
                                    dict(fail_dispatch=6, fail_stage="fetch"),
                                    dict(fail_bucket=8, fail_stage="transfer", message="boom")])
def test_fault_plan_firing(kwargs):
    assert _fire(faults, kwargs) == _fire(jfaults, kwargs)


def test_fleet_fault_plan():
    for spec in ("replica=1,at_s=2", "replica=0,at_s=1,degrade=0.05,times=0"):
        port, ref = faults.FleetFaultPlan.from_spec(spec), jfaults.FleetFaultPlan.from_spec(spec)
        assert (port.kind, port.replica, port.at_s, port.degrade_s, port.times) == (
            ref.kind, ref.replica, ref.at_s, ref.degrade_s, ref.times)
        assert ([port.take(t) for t in (0.5, 1.0, 2.5, 3.0)]
                == [ref.take(t) for t in (0.5, 1.0, 2.5, 3.0)])
        assert port.fired == ref.fired
        d, r = port.degrade_plan(), ref.degrade_plan()
        assert (d.match_all, d.fail, d.delay_s, d.times) == (r.match_all, r.fail, r.delay_s,
                                                             r.times)
    with pytest.raises(ValueError, match="unknown fleet-fault key"):
        faults.FleetFaultPlan.from_spec("nope=1")


# ------------------------------------------------------------------ histogram


@pytest.mark.parametrize("dist", ["latency", "zeros", "occupancy", "one", "empty"])
@pytest.mark.parametrize("unit_scale", [1.0, 1e3])
def test_histogram_snapshots(dist, unit_scale):
    rng = np.random.default_rng(5)
    values = {"latency": rng.lognormal(-3, 1, 500), "zeros": np.r_[np.zeros(50), rng.random(7)],
              "occupancy": rng.integers(1, 5, 200) / 4, "one": [0.25], "empty": []}[dist]
    port, ref = hist.Histogram(), jhist.Histogram(growth=1.1)
    for v in values:
        port.observe(v)
        ref.observe(v)
    assert port.snapshot(unit_scale=unit_scale, digits=4) == ref.snapshot(
        unit_scale=unit_scale, digits=4)
    assert [port.percentile(q) for q in (0, 10, 50, 90, 99, 100)] == [
        ref.percentile(q) for q in (0, 10, 50, 90, 99, 100)]
    assert port.count == ref.count


def test_histogram_refusals():
    for mod in (hist, jhist):
        with pytest.raises(ValueError):
            mod.Histogram(growth=1.0)
        h = mod.Histogram()
        for bad in (-1.0, float("nan"), float("inf")):
            with pytest.raises(ValueError):
                h.observe(bad)


# ------------------------------------------------------------------ trace context


def test_trace_context_round_trip():
    root = ctx.TraceContext.new()
    assert len(root.trace_id) == 32 and len(root.span_id) == 16 and root.parent_id is None
    child = root.child()
    assert (child.trace_id, child.parent_id) == (root.trace_id, root.span_id)
    header = child.traceparent()
    assert header == jctx.TraceContext(child.trace_id, child.span_id, child.parent_id).traceparent()
    back = ctx.TraceContext.from_traceparent(header)
    assert (back.trace_id, back.span_id) == (child.trace_id, child.span_id)
    assert child.event_args() == jctx.TraceContext(
        child.trace_id, child.span_id, child.parent_id).event_args()
    assert root.event_args() == {"trace_id": root.trace_id, "span_id": root.span_id}
    for bad in ("", "00-abc-def-01", "00-" + "g" * 32 + "-" + "0" * 16 + "-01"):
        with pytest.raises(ValueError, match="malformed traceparent"):
            ctx.TraceContext.from_traceparent(bad)
        with pytest.raises(ValueError, match="malformed traceparent"):
            jctx.TraceContext.from_traceparent(bad)


def test_use_trace_is_thread_local_and_nests():
    a, b = ctx.TraceContext.new(), ctx.TraceContext.new()
    assert ctx.current_trace() is None
    seen = []
    with ctx.use_trace(a):
        t = threading.Thread(target=lambda: seen.append(ctx.current_trace()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        with ctx.use_trace(b):
            assert ctx.current_trace() is b
            with ctx.use_trace(None):
                assert ctx.current_trace() is None
        assert ctx.current_trace() is a
    assert seen == [None] and ctx.current_trace() is None


def _lifecycle_events(mod, ids):
    """A synthetic request lifecycle: complete, cached, deduped, broken
    chain, missing terminal, ok without dispatch, error."""
    ev = []
    roots = {}
    for name in ("done", "cached", "dedup", "broken", "open", "nodispatch", "error"):
        c = mod.TraceContext(trace_id=ids[name], span_id=f"{len(roots):016x}")
        roots[name] = c
        ev.append({"name": "sched.submit", "ph": "i", "args": c.event_args()})
    ev.append({"name": "serve.batch", "ph": "X",
               "args": {"trace_ids": [ids["done"], ids["error"]]}})
    ev.append({"name": "sched.cache_hit", "ph": "i", "args": roots["cached"].child().event_args()})
    ev.append({"name": "sched.dedup_join", "ph": "i", "args": roots["dedup"].child().event_args()})
    ev.append({"name": "sched.queue", "ph": "X",
               "args": {"trace_id": ids["broken"], "span_id": "f" * 16, "parent_id": "e" * 16}})
    for name, status, hit in (("done", "ok", False), ("cached", "ok", True),
                              ("dedup", "ok", True), ("broken", "ok", False),
                              ("nodispatch", "ok", False), ("error", "error", False)):
        args = roots[name].child().event_args()
        ev.append({"name": "sched.resolve", "ph": "i",
                   "args": {"status": status, "cache_hit": hit, "retried": False, **args}})
    return ev


def test_reconstruct_traces_and_completeness():
    ids = {name: f"{i:032x}" for i, name in enumerate(
        ("done", "cached", "dedup", "broken", "open", "nodispatch", "error"))}
    events = _lifecycle_events(ctx, ids)
    port, ref = ctx.reconstruct_traces(events), jctx.reconstruct_traces(events)
    assert port == ref
    for tid in list(ids.values()) + ["f" * 32]:
        assert (ctx.trace_incomplete_reason(tid, port.get(tid, []))
                == jctx.trace_incomplete_reason(tid, ref.get(tid, [])))
    for max_reasons in (1, 8):
        assert (ctx.trace_completeness(events, list(ids.values()) + [None], max_reasons)
                == jctx.trace_completeness(events, list(ids.values()) + [None], max_reasons))
    assert (ctx.SUBMIT_EVENT, ctx.RESOLVE_EVENT, ctx.CACHE_HIT_EVENT, ctx.DEDUP_EVENT) == (
        jctx.SUBMIT_EVENT, jctx.RESOLVE_EVENT, jctx.CACHE_HIT_EVENT, jctx.DEDUP_EVENT)


def _traced(tracing_mod, ctx_mod, root):
    """Spans, instants and a retroactive span under a context: the ids
    each event carries, as (name, which of root/other/none, chained)."""
    tr = tracing_mod.Tracer(enabled=True)
    tr.instant("outside")
    with ctx_mod.use_trace(root):
        with tr.span("outer", bucket=8):
            with tr.span("inner"):
                tr.instant("mark", n=1)
            tr.instant("own", trace_id="x" * 32)
        tr.span_event("retro", 0.0, 0.001, k=1)
    events = tr.events()
    spans = {e["args"]["span_id"]: e["name"] for e in events
             if e["ph"] == "X" and "span_id" in e.get("args", {})}
    return [(e["name"], e.get("args", {}).get("trace_id") == root.trace_id,
             "trace_id" in e.get("args", {}),
             spans.get(e.get("args", {}).get("parent_id"), e.get("args", {}).get("parent_id")))
            for e in events]


def test_tracer_attaches_trace_ids_as_jax_does():
    root = ctx.TraceContext.new()
    jroot = jctx.TraceContext(root.trace_id, root.span_id)
    port = _traced(tracing, ctx, root)
    ref = _traced(jtracing, jctx, jroot)
    # parent names: the root's own span id is the same in both
    assert port == ref
    assert ("inner", True, True, "outer") in port and ("outside", False, False, None) in port


# ------------------------------------------------------------------ counters


def test_event_counters_equal_jax():
    port, ref = metrics.EventCounters(), jmetrics.EventCounters()
    for name, n in (("serve.requests", 4), ("serve.batches", 1), ("serve.requests", 1),
                    ("sched.shed", 0), ("serve.batches", 2)):
        assert port.bump(name, n) == ref.bump(name, n)
    assert port.snapshot() == ref.snapshot()
    assert port.get("serve.batches") == ref.get("serve.batches") == 3
    assert port.get("absent") == ref.get("absent") == 0

    class Logger:
        def __init__(self):
            self.records = []

        def log(self, step, rec):
            self.records.append((step, rec))

    a, b = Logger(), Logger()
    port.log_to(a, step=3)
    ref.log_to(b, step=3)
    assert a.records == b.records


def test_event_counters_lose_no_update_under_threads():
    """More threads than cores bumping one counter with a short switch
    interval: a lost update would show in the total."""
    counters = metrics.EventCounters()
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [counters.bump("n") for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert counters.get("n") == threads * per


def test_memory_sampler_samples_nothing_on_the_cpu():
    sampler = MemorySampler(["cpu"])
    assert sampler.sample() == [] and sampler.peak_bytes() is None
    tr = tracing.Tracer(enabled=True)
    sampler.counter_to(tr)
    assert tr.events() == []


# ------------------------------------------------------------------ featurization


@pytest.mark.parametrize("length,bucket,depth,seed,msa_len",
                         [(6, 8, 2, 0, None), (8, 8, 3, 1, None), (11, 16, 5, 7, None),
                          (16, 16, 1, 3, 8), (5, 16, 0, 2, None), (30, 64, 4, 9, 12)])
def test_featurize_with_plan_is_jax_byte_for_byte(length, bucket, depth, seed, msa_len):
    tokens = np.random.default_rng(seed).integers(0, 20, length).astype(np.int32)
    item, plan = pipe.featurize_bucketed_with_plan(tokens, bucket, depth, seed=seed,
                                                   msa_len=msa_len)
    jitem, jplan = jpipe.featurize_bucketed_with_plan(tokens, bucket, depth, seed=seed,
                                                      msa_len=msa_len)
    assert sorted(item) == sorted(jitem) and sorted(plan) == sorted(jplan)
    for k in item:
        assert item[k].dtype == jitem[k].dtype and item[k].tobytes() == jitem[k].tobytes()
    for k in plan:
        assert np.array_equal(np.asarray(plan[k]), np.asarray(jplan[k]))
        assert np.asarray(plan[k]).dtype == np.asarray(jplan[k]).dtype
    cold = pipe.featurize_bucketed(tokens, bucket, depth, seed=seed, msa_len=msa_len)
    assert all(cold[k].tobytes() == item[k].tobytes() for k in item)


@pytest.mark.parametrize("edits", [1, 2, 8, 20])
@pytest.mark.parametrize("msa_len", [None, 8])
def test_featurize_delta_is_cold_and_jax_byte_for_byte(edits, msa_len):
    rng = np.random.default_rng(edits)
    tokens = rng.integers(0, 20, 14).astype(np.int32)
    item, plan = pipe.featurize_bucketed_with_plan(tokens, 16, 4, seed=3, msa_len=msa_len)
    mutant = tokens.copy()
    pos = rng.choice(14, size=min(edits, 14), replace=False)
    mutant[pos] = (mutant[pos] + rng.integers(1, 20, len(pos))) % 20
    delta = pipe.featurize_delta(item, plan, mutant)
    jdelta = jpipe.featurize_delta(item, plan, mutant)
    cold = pipe.featurize_bucketed(mutant, 16, 4, seed=3, msa_len=msa_len)
    for k in cold:
        assert delta[k].tobytes() == cold[k].tobytes() == jdelta[k].tobytes()
    with pytest.raises(ValueError, match="equal lengths"):
        pipe.featurize_delta(item, plan, mutant[:-1])
