"""The fleet (``serve/fleet.py``) in the port against the JAX package's, and
the counts that keep a fleet's kernel launches exact.

1. JAX's fleet scenarios (``tests/test_fleet.py``) run through both
   packages' ``FleetFrontend``s side by side, each over its own package's
   config, request, result, counter, tracer and frontend classes, with the
   same fake engine, fake clock and ``start=False`` driving
   (``pump_replicas`` / ``pump_health`` inline). Each returns what a caller
   or an operator can observe: which replica served each request (the
   engines' dispatch logs), each handle's status, error and trace identity,
   the fleet's counters, snapshot, liveness, SLO verdicts and aggregation,
   the trace events without their random ids and trace completeness. The
   two must be equal.
2. The lock rule at run time: each replica's scheduler lock is wrapped so
   that taking it while the same thread holds the router lock fails.
3. A real port fleet on the CPU: two replicas of one tiny f32 engine
   serve one parameter set, and their atom14 is bit-equal to the engine's
   own ``predict_many``.
4. The counter repair: threads calling one plain version at once leave its
   ``calls`` exactly at the total (``ops.cuda.build.count``).
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import alphafold2_tpu.config as jconfig
import alphafold2_tpu.observe as jobserve
import alphafold2_tpu.observe.slo as jslo
import alphafold2_tpu.observe.tracectx as jtracectx
import alphafold2_tpu.serve as jserve
import alphafold2_tpu.serve.fleet as jfleet
import alphafold2_tpu_torch.config as config
import alphafold2_tpu_torch.observe as observe
import alphafold2_tpu_torch.observe.slo as slo
import alphafold2_tpu_torch.observe.tracectx as tracectx
import alphafold2_tpu_torch.serve as serve
import alphafold2_tpu_torch.serve.fleet as fleet_mod
from alphafold2_tpu_torch.ops.cuda import axial, build, tied_row

PORT = types.SimpleNamespace(config=config, observe=observe, serve=serve, tracectx=tracectx,
                             slo=slo, fleet=fleet_mod)
JAX = types.SimpleNamespace(config=jconfig, observe=jobserve, serve=jserve, tracectx=jtracectx,
                            slo=jslo, fleet=jfleet)
ID_ARGS = ("trace_id", "span_id", "parent_id", "trace_ids", "leader_trace")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(fw, buckets=(8, 16), max_batch=2, **serve_kw):
    """JAX's tests/test_fleet.py:_cfg in either package."""
    serve_kw.setdefault("mds_iters", 10)
    serve_kw.setdefault("dwell_ms", 50.0)
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
    """JAX's FakeEngine (tests/test_fleet.py) over either package: records
    every dispatch, never runs a model."""

    def __init__(self, fw, cfg):
        self.fw = fw
        self.cfg = cfg
        self.buckets = cfg.serve.buckets
        self.max_batch = cfg.serve.max_batch
        self.mesh_desc = None
        self.counters = fw.observe.EventCounters()
        self.tracer = fw.observe.Tracer(enabled=False)
        self.dispatched = []

    def batch_for(self, bucket):
        return self.max_batch

    def dispatch_batch(self, bucket, reqs):
        self.dispatched.append((bucket, [r.seq for r in reqs]))
        return [self.fw.serve.ServeResult(seq=r.seq, bucket=bucket,
                                          atom14=np.zeros((len(r.seq), 14, 3), np.float32),
                                          latency_s=1e-3)
                for r in reqs]

    def retry_bucket(self, bucket):
        i = self.buckets.index(bucket)
        return self.buckets[i + 1] if i + 1 < len(self.buckets) else None


def _fleet(fw, replicas=2, **kw):
    cfg = _cfg(fw)
    engines = [FakeEngine(fw, cfg) for _ in range(replicas)]
    clock = FakeClock()
    tracer = fw.observe.Tracer(enabled=True)
    fl = fw.fleet.FleetFrontend(engines, clock=clock, tracer=tracer, start=False, **kw)
    return fl, engines, clock


def _seqs(n, length=6):
    alpha = "ACDEFGHIKLMNPQRSTVWY"
    return ["".join(alpha[(i + j) % len(alpha)] for j in range(length)) for i in range(n)]


def _drain(fl, clock, rounds=10):
    for _ in range(rounds):
        clock.advance(1.0)
        if fl.pump_replicas() == 0 and fl.depth == 0:
            break


def _observed(fw, fl, engines, handles, extra):
    """Everything the scenario exposes, ids left out."""
    res = []
    for h in handles:
        if not h.done():
            res.append("pending")
            continue
        r = h.result(0)
        res.append((r.seq, r.bucket, r.status, r.error, r.cache_hit, r.retried,
                    r.trace_id == h.request.trace.trace_id))
    events = fl.tracer.events()
    done = fw.tracectx.trace_completeness(
        events, [h.request.trace.trace_id for h in handles if h.done()])
    return {
        "extra": extra, "results": res,
        "dispatched": [e.dispatched for e in engines],
        "counters": fl.stats(), "snapshot": fl.snapshot(), "alive": fl.alive_replicas(),
        "slo": fl.slo_summary(),
        "events": [(e["name"], e["ph"],
                    {k: v for k, v in (e.get("args") or {}).items() if k not in ID_ARGS})
                   for e in events],
        "completeness": {k: done[k] for k in ("total", "complete", "fraction")},
    }


# ------------------------------------------------------------------ scenarios


def routing_stripes_idle_fleet(fw):
    fl, engines, clock = _fleet(fw)
    hs = [fl.submit(q, deadline_s=None) for q in _seqs(4)]
    extra = [[c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def routing_prefers_less_loaded(fw):
    fl, engines, clock = _fleet(fw)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q) for q in _seqs(3)]
    fl._pick_replica = orig
    hs.append(fl.submit("MKVLITAA"))
    extra = [[c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def forming_bonus_and_buckets(fw):
    fl, engines, clock = _fleet(fw)
    hs = [fl.submit(q) for q in _seqs(3, length=12)] + [fl.submit(q) for q in _seqs(3)]
    extra = [[c.frontend.load_snapshot()["depth"] for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def steal_rebalances_and_reroutes(fw):
    fl, engines, clock = _fleet(fw)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q) for q in _seqs(8)]
    fl._pick_replica = orig
    extra = [[c.frontend.depth for c in fl.cells], fl.pump_health(),
             [c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def steal_needs_margin(fw):
    fl, engines, clock = _fleet(fw)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q) for q in _seqs(3)]
    fl._pick_replica = orig
    extra = [fl.pump_health()]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def steal_margin_set(fw):
    fl, engines, clock = _fleet(fw, steal_margin=1)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q) for q in _seqs(3)]
    fl._pick_replica = orig
    extra = [fl.steal_margin, fl.pump_health(), [c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def kill_drains_with_zero_drops(fw):
    fl, engines, clock = _fleet(fw)
    hs = [fl.submit(q) for q in _seqs(6)]
    extra = [fl.kill_replica(0), fl.alive_replicas(), [c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    extra.append(fl.kill_replica(0))
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def route_racing_close(fw):
    fl, engines, clock = _fleet(fw)
    fl.cells[0].frontend.close(timeout=0.1)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0 if exclude is None else orig(bucket, exclude)
    hs = [fl.submit("ACDEFG")]
    fl._pick_replica = orig
    extra = [[c.frontend.depth for c in fl.cells]]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def no_alive_replicas(fw):
    fl, engines, clock = _fleet(fw)
    extra = [fl.kill_replica(0), fl.kill_replica(1)]
    hs = [fl.submit("ACDEFG")]
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def close_rejects_new_submits(fw):
    fl, engines, clock = _fleet(fw)
    hs = [fl.submit("ACDEFG")]
    fl.close()
    hs.append(fl.submit("MKVLIT"))
    return _observed(fw, fl, engines, hs, [])


def deadline_expires_while_rerouting(fw):
    fl, engines, clock = _fleet(fw)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q, deadline_s=0.5) for q in _seqs(3)]
    fl._pick_replica = orig
    clock.advance(1.0)
    extra = [fl.kill_replica(0)]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def traceparent_hop_through_a_kill(fw):
    fl, engines, clock = _fleet(fw)
    hs = [fl.submit(q) for q in _seqs(6)]
    fl.kill_replica(0)
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, [])
    names_by_tid: dict = {}
    for e in fl.tracer.events():
        tid = (e.get("args") or {}).get("trace_id")
        if tid:
            names_by_tid.setdefault(tid, set()).add(e["name"])
    out["extra"] = [sorted({"fleet.admit", "sched.submit"} <= names_by_tid[h.result(0).trace_id]
                           for h in hs)]
    fl.close()
    return out


def kill_fault_plan(fw):
    fault = fw.serve.FleetFaultPlan(replica=1, at_s=5.0)
    fl, engines, clock = _fleet(fw, fault=fault)
    hs = [fl.submit(q) for q in _seqs(4)]
    extra = [fl.pump_health()]
    clock.advance(6.0)
    extra += [fl.pump_health(), fl.alive_replicas(), fault.fired]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, extra)
    fl.close()
    return out


def degrade_fault_plan(fw):
    fault = fw.serve.FleetFaultPlan(replica=0, at_s=0.0, degrade_s=0.001)
    fl, engines, clock = _fleet(fw, fault=fault)
    clock.advance(1.0)
    extra = [fl.pump_health(), engines[0].faults.match_all, engines[0].faults.fail,
             engines[0].faults.delay_s, fl.alive_replicas()]
    out = _observed(fw, fl, engines, [], extra)
    fl.close()
    return out


def slo_fanout_and_aggregation(fw):
    specs = [fw.slo.SLOSpec(name="availability", objective="availability", target=0.9,
                            min_events=1),
             fw.slo.SLOSpec(name="latency", objective="latency", threshold_ms=0.5,
                            target=0.9, min_events=1)]
    fl, engines, clock = _fleet(fw, slo_specs=specs)
    hs = [fl.submit(q) for q in _seqs(4)]
    _drain(fl, clock)
    out = _observed(fw, fl, engines, hs, [])
    fl.close()
    return out


def zero_seeded_snapshot(fw):
    fl, engines, clock = _fleet(fw, replicas=3)
    out = _observed(fw, fl, engines, [], [sorted(fw.fleet.fleet_counter_zeros(3))])
    fl.close()
    return out


SCENARIOS = [routing_stripes_idle_fleet, routing_prefers_less_loaded, forming_bonus_and_buckets,
             steal_rebalances_and_reroutes, steal_needs_margin, steal_margin_set,
             kill_drains_with_zero_drops, route_racing_close, no_alive_replicas,
             close_rejects_new_submits, deadline_expires_while_rerouting,
             traceparent_hop_through_a_kill, kill_fault_plan, degrade_fault_plan,
             slo_fanout_and_aggregation, zero_seeded_snapshot]


# scenarios whose requests the router turns away before any replica sees
# them: no scheduler lifecycle, so no complete trace (in either package)
ROUTER_REJECTS = (no_alive_replicas, close_rejects_new_submits)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fleet_scenario_equals_jax(scenario):
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    if scenario not in ROUTER_REJECTS:
        assert port["completeness"]["fraction"] == 1.0


def test_scenarios_show_what_they_pin():
    """Spot checks, so the equality above is not vacuous."""
    stripes = routing_stripes_idle_fleet(PORT)
    assert stripes["extra"] == [[2, 2]] and stripes["counters"]["fleet.routed"] == 4
    stolen = steal_rebalances_and_reroutes(PORT)
    assert stolen["extra"][0] == [8, 0] and stolen["extra"][1]["stolen"] == 4
    assert stolen["extra"][2] == [4, 4] and stolen["counters"]["fleet.rerouted"] == 4
    assert all(r[2] == "ok" and r[3] != fleet_mod.STOLEN_ERROR for r in stolen["results"])
    killed = kill_drains_with_zero_drops(PORT)
    assert killed["extra"][:3] == [True, [1], [0, 6]] and killed["extra"][3] is False
    assert killed["dispatched"][0] == [] and killed["counters"]["fleet.drains"] == 1
    assert all(r[2] == "ok" for r in killed["results"])
    nobody = no_alive_replicas(PORT)
    assert nobody["results"][0][2:4] == ("rejected", "no alive replicas")
    late = deadline_expires_while_rerouting(PORT)
    assert {r[2] for r in late["results"]} == {"deadline_exceeded"}
    hop = traceparent_hop_through_a_kill(PORT)
    assert hop["extra"] == [[True] * 6]
    slos = slo_fanout_and_aggregation(PORT)["slo"]
    assert len(slos["replicas"]) == 2
    assert [v["fast_events"] for v in slos["fleet"]] == [4, 4]


def test_aggregate_slo_verdicts_equals_jax():
    base = {"spec": "latency", "objective": "latency", "class": "all", "target": 0.99,
            "burn_threshold": 2.0, "threshold_ms": 100.0}
    hot = dict(base, fast_burn=4.0, slow_burn=4.0, fast_events=10, slow_events=10, alert=True)
    warm = dict(base, fast_burn=1.0, slow_burn=3.0, fast_events=30, slow_events=5, alert=False)
    idle = dict(base, fast_burn=0.0, slow_burn=0.0, fast_events=0, slow_events=0, alert=False)
    for lists in ([[hot], [idle]], [[hot], [warm]], [[idle], [idle]], [[hot, dict(
            warm, spec="errors")], [warm]]):
        assert slo.aggregate_slo_verdicts(lists) == jslo.aggregate_slo_verdicts(lists)
    assert slo.aggregate_slo_verdicts([[hot], [idle]])[0]["fast_burn"] == 4.0


# ------------------------------------------------------------ the lock rule


class _OwnedLock:
    """A router lock that knows which thread holds it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self.owner = None
        self._lock.release()


class _GuardedCondition:
    """A replica's scheduler lock that records every acquisition made while
    the same thread holds the router lock."""

    def __init__(self, cond, router, violations):
        self._cond, self._router, self._violations = cond, router, violations

    def __enter__(self):
        if self._router.owner == threading.get_ident():
            self._violations.append(threading.current_thread().name)
        return self._cond.__enter__()

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)

    def notify_all(self):
        self._cond.notify_all()

    def wait(self, timeout=None):
        return self._cond.wait(timeout)


def _guard(fl):
    violations: list = []
    fl._lock = _OwnedLock()
    for cell in fl.cells:
        cell.frontend._lock = _GuardedCondition(cell.frontend._lock, fl._lock, violations)
    return violations


def test_router_never_takes_a_replica_lock_under_its_own():
    fault = serve.FleetFaultPlan(replica=1, at_s=3.0)
    specs = [slo.SLOSpec(name="availability", objective="availability", target=0.9)]
    fl, engines, clock = _fleet(PORT, fault=fault, slo_specs=specs)
    violations = _guard(fl)
    orig = fl._pick_replica
    fl._pick_replica = lambda bucket, exclude: 0
    hs = [fl.submit(q) for q in _seqs(8)]
    fl._pick_replica = orig
    fl.pump_health()  # a steal: evictions re-route through the observers
    hs += [fl.submit(q) for q in _seqs(4, length=12)]
    clock.advance(4.0)
    fl.pump_health()  # the kill fault: a drain re-routes replica 1's queue
    _drain(fl, clock)
    fl.snapshot(), fl.slo_summary()
    fl.close()
    assert all(h.result(0).ok for h in hs)
    assert fl.stats()["fleet.steals"] >= 1 and fl.stats()["fleet.drains"] == 1
    assert violations == []
    # the control: the scheduler lock taken under the router lock is caught
    # (a replica submit there would deadlock as soon as its observer ran)
    with fl._lock:
        fl.cells[0].frontend.load_snapshot()
    assert violations == [threading.current_thread().name]


def test_lock_rule_holds_with_live_threads():
    """start=True: replica dispatcher threads resolve requests and the health
    pump steals and kills, while the guard watches every lock taken."""
    cfg = _cfg(PORT, dwell_ms=1.0)
    engines = [FakeEngine(PORT, cfg) for _ in range(2)]
    fl = fleet_mod.FleetFrontend(engines, start=False, tick_s=0.005,
                                 fault=serve.FleetFaultPlan(replica=0, at_s=0.02))
    violations = _guard(fl)
    for cell in fl.cells:
        cell.frontend.start()
    fl.start()
    hs = []
    for q in _seqs(40):
        hs.append(fl.submit(q))
        time.sleep(0.001)
    results = [h.result(30) for h in hs]
    fl.close()
    assert all(r.ok for r in results)
    assert fl.stats()["fleet.drains"] == 1 and fl.stats()["fleet.resolved"] == 40
    assert violations == []


def test_build_refuses_a_mesh():
    """No longer refused: FleetFrontend.build(..., mesh=) builds every
    replica on the mesh (a world-size-1 gloo mesh here; four ranks in
    test_torch_port_serve_mesh.py), sharing one module and the mesh's one
    session (its forward lock), and serves each request as one engine on
    that mesh does; the last engine on the mesh to close stops the
    followers (the world of one has none)."""
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.serve.engine import mesh_session

    cfg = _cfg(PORT, max_batch=1, dwell_ms=1.0)
    reqs = [serve.ServeRequest(q, seed=i) for i, q in enumerate(("ACDEFG", "MKVLITAAGH"))]
    with distributed.local_world("cpu"):
        mesh = sharding.make_mesh(1, 1)
        fl = fleet_mod.FleetFrontend.build(cfg, 2, device="cpu", mesh=mesh)
        e0, e1 = (c.engine for c in fl.cells)
        try:
            assert e1.model is e0.model and e0.mesh is e1.mesh is mesh
            session = mesh_session(mesh)
            assert e0._forward_lock is e1._forward_lock is session.lock
            assert session.open == 2
            results = [h.result(300) for h in [fl.submit(r) for r in reqs]]
        finally:
            fl.close()
        assert session.open == 0
        one = serve.ServeEngine(cfg, device="cpu", model=e0.model, mesh=mesh)
        ref = one.predict_many([serve.ServeRequest(r.seq, seed=r.seed) for r in reqs])
        one.close()
    assert all(r.ok for r in results)
    for got, want in zip(results, ref):
        np.testing.assert_array_equal(got.weights, want.weights)
        np.testing.assert_array_equal(got.atom14, want.atom14)


# ------------------------------------------------------ a real fleet, CPU


def test_port_fleet_on_the_cpu_shares_weights_and_equals_predict_many():
    cfg = _cfg(PORT, max_batch=1, dwell_ms=1.0)
    fl = fleet_mod.FleetFrontend.build(cfg, 2, device="cpu")
    try:
        e0, e1 = (c.engine for c in fl.cells)
        assert e1.model is e0.model
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
            e0.model.parameters(), e1.model.parameters()))
        reqs = [serve.ServeRequest(s, seed=i)
                for i, s in enumerate(("ACDEFG", "MKVLITAAGH", "WYTSRQ", "MKTAYIAKQRQL"))]
        handles = [fl.submit(r) for r in reqs]
        results = [h.result(300) for h in handles]
        ref = e0.predict_many([serve.ServeRequest(r.seq, seed=r.seed) for r in reqs])
    finally:
        fl.close()
        for cell in fl.cells:  # the fleet leaves its engines' pipelines open
            cell.engine.close()
    assert all(r.ok for r in results)
    stats = fl.stats()
    assert stats["fleet.replica0.routed"] >= 1 and stats["fleet.replica1.routed"] >= 1
    for got, want in zip(results, ref):
        assert got.atom14.tobytes() == want.atom14.tobytes()
        assert got.cost["flops_share"] > 0


# ------------------------------------------------------------ the counters


class _Yielding(int):
    """A count whose addition gives up the interpreter lock: the switch point
    an unlocked read-add-write of an attribute can lose an increment at.
    (CPython 3.12 does not switch threads inside ``fn.calls += 1`` on a plain
    int, so the plain case below passes with or without the lock.)"""

    def __add__(self, n):
        time.sleep(0)
        return _Yielding(int(self) + int(n))


@pytest.mark.parametrize("threads", [2, 4, 12])  # 12: more threads than the host's cores
@pytest.mark.parametrize("kind", ["int", "yielding"])
@pytest.mark.parametrize("which", ["fused_attention", "tied_row_attention"])
def test_plain_version_calls_stay_exact_under_threads(threads, kind, which):
    calls = 60
    if which == "fused_attention":
        fn = axial.fused_attention_reference
        q = torch.randn(1, 1, 2, 4)
        args = (q, q, q)
    else:
        fn = tied_row.tied_row_attention_reference
        q = torch.randn(1, 2, 2, 1, 4)
        args = (q, q, q)
    fn.calls = _Yielding(0) if kind == "yielding" else 0
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(calls):
            fn(*args)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert int(fn.calls) == threads * calls
    finally:
        sys.setswitchinterval(interval)
        fn.calls = 0


def test_count_adds_every_attribute_in_one_step():
    def fn():
        pass

    fn.launches = fn.sm90_launches = 0
    build.count(fn, launches=1, sm90_launches=True)
    build.count(fn, launches=1, sm90_launches=0)
    assert (fn.launches, fn.sm90_launches) == (2, 1)
