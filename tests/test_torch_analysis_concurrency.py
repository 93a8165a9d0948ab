"""``analysis/concurrency.py`` against the JAX package's auditor: the same
findings (rule, line, message) on the same fixture sources, the port's tree
clean against its committed contracts, and the port's two seeded gated
defects flagged when their variables are set."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from alphafold2_tpu.analysis import concurrency as jconc
from alphafold2_tpu_torch.analysis import concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXTURES = {
    "cycle": """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def fwd(self, b: "B"):
                with self._lock:
                    with b._lock:
                        pass

            def grab(self):
                with self._lock:
                    pass

        class B:
            def __init__(self):
                self._lock = threading.Lock()

            def rev(self, a: "A"):
                with self._lock:
                    a.grab()

        class A2(A):
            pass

        def grab_both(a: A, b: B):
            with a._lock:
                pass
    """,
    "self_deadlock_and_guards": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}
                self._other = threading.RLock()

            def put(self, k, v):
                with self._lock:
                    self._items[k] = v

            def put2(self, k, v):
                with self._lock:
                    self._items[k] = v
                    with self._lock:
                        pass

            def bad(self, k):
                self._items[k] = 0

            def mixed(self, k):
                with self._other:
                    self._items[k] = 1

            def walk(self):
                return [k for k in self._items]
    """,
    "lifecycle": """
        import collections
        import queue
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Condition()
                self._q = queue.Queue()
                self._d = collections.deque()
                self._observers = []
                self._t = threading.Thread(target=self.run)
                self._t.start()

            def run(self):
                with self._lock:
                    self._lock.wait()
                    for cb in self._observers:
                        cb()

        def spawn():
            t = threading.Thread(target=print)
            t.start()
            u = threading.Thread(target=print, daemon=True)
            u.start()
    """,
    "noqa": """
        import threading

        class D:
            def __init__(self):
                self._lock = threading.Lock()

            def a(self):
                with self._lock:
                    self.x = 1

            def b(self):
                with self._lock:
                    self.x = 2

            def c(self):
                self.x = 3  # af2: noqa[AF2C002] written before any thread starts
    """,
    "unparseable": "def broken(:\n",
}


def _findings(module, path):
    model = module.RepoModel().scan_paths([str(path)], gated="all")
    return [(f.rule, f.line, f.col, f.message) for f in model.findings()], model


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_findings_match_jax_on_the_same_fixture(name, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(FIXTURES[name]))
    (ours, model), (theirs, jmodel) = _findings(concurrency, path), _findings(jconc, path)
    assert ours == theirs
    assert model.edges == jmodel.edges and model.guards == jmodel.guards
    assert concurrency.RULES == jconc.RULES
    want = {"cycle": {"AF2C001"},
            "self_deadlock_and_guards": {"AF2C001", "AF2C002", "AF2C003", "AF2C004"},
            "lifecycle": {"AF2C005", "AF2C006", "AF2C007", "AF2C008"},
            "noqa": set(),  # the one unguarded write is suppressed
            "unparseable": {"AF2C000"}}[name]
    assert {r for r, *_ in ours} == want


def test_port_tree_is_clean_and_its_contracts_hold(capsys):
    model = concurrency.build_model(gated="none")
    assert model.findings() == []
    assert concurrency.DEFAULT_BASELINE == os.path.join(
        REPO, "alphafold2_tpu_torch", "analysis", "concurrency_contracts.json")
    verdict, lines = concurrency.check_against(concurrency.DEFAULT_BASELINE,
                                               concurrency.compute_contracts(model))
    assert (verdict, lines) == ("pass", [])
    # the engine, the scheduler, the pipeline and the fleet are under contract
    guards = json.load(open(concurrency.DEFAULT_BASELINE))["guards"]
    assert {"AsyncServeFrontend", "FleetFrontend", "DispatchHandle", "EventCounters"} <= set(
        guards)
    assert concurrency.main(["--check"]) == 0
    assert "verdict: pass" in capsys.readouterr().out


def test_contract_drift_is_named(tmp_path):
    current = concurrency.compute_contracts(concurrency.build_model(gated="none"))
    stale = json.loads(json.dumps(current))
    edge = next(iter(stale["lock_graph"]))
    del stale["lock_graph"][edge]
    stale["guards"]["FleetFrontend"]["_routed"] = "_other"
    path = tmp_path / "contracts.json"
    concurrency.write_contracts(str(path), stale)
    verdict, lines = concurrency.check_against(str(path), current)
    assert verdict == "drift"
    assert f"lock-graph edge added: {edge} ({current['lock_graph'][edge]})" in lines
    assert "guard changed: FleetFrontend._routed: FleetFrontend._other -> " \
           "FleetFrontend._lock" in lines
    stale["format"] = 0
    concurrency.write_contracts(str(path), stale)
    assert concurrency.check_against(str(path), current)[0] == "stale-baseline"
    assert concurrency.check_against(str(tmp_path / "none.json"), current)[0] == \
        "missing-baseline"


def test_gated_fixtures_are_flagged(monkeypatch):
    monkeypatch.setenv("AF2TPU_AUDIT_INVERT_LOCKS", "1")
    found = concurrency.build_model().findings()
    assert [f.rule for f in found] == ["AF2C001"]
    assert "AsyncServeFrontend._lock, PipelineBatch._lock" in found[0].message
    assert "_audit_invert_locks" in found[0].message
    monkeypatch.delenv("AF2TPU_AUDIT_INVERT_LOCKS")
    monkeypatch.setenv("AF2TPU_AUDIT_FLEET_LOCK", "1")
    model = concurrency.build_model()
    prov = model.edges[("FleetFrontend._lock", "AsyncServeFrontend._lock")][0]
    assert "_audit_fleet_hold_router_lock" in prov
    # contracts never hold a gated defect, whatever the environment
    assert "FleetFrontend._lock -> AsyncServeFrontend._lock" not in \
        concurrency.compute_contracts(model)["lock_graph"]


def test_cli_exit_codes_in_a_subprocess():
    env = dict(os.environ, AF2TPU_AUDIT_INVERT_LOCKS="1")
    env.pop("AF2TPU_AUDIT_FLEET_LOCK", None)
    bad = subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.analysis.concurrency"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "AF2C001" in bad.stdout
    env.pop("AF2TPU_AUDIT_INVERT_LOCKS")
    ok = subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.analysis.concurrency",
                         "--check"], cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0, ok.stdout
