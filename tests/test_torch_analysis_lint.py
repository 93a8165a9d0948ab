"""The port's AST linter (alphafold2_tpu_torch/analysis/lint.py), rule by
rule: each bad snippet gives exactly its finding and its noqa'd or fixed
twin is clean; the rules carried over unchanged from the JAX linter give
the same findings as it on the same source; the port and chip_smoke.py
lint clean."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from alphafold2_tpu.analysis import lint as jax_lint
from alphafold2_tpu_torch.analysis import lint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rules_of(src: str, path: str = "<string>") -> list:
    return [f.rule for f in lint.lint_source(textwrap.dedent(src), path)]


# ------------------------------------------------------------ AF2L002


def test_host_sync_in_forward_flagged_and_noqa_clean():
    bad = """
    import torch
    from torch import nn

    class M(nn.Module):
        def forward(self, x):
            scale = x.abs().max().item()
            return x / scale
    """
    assert rules_of(bad) == ["AF2L002"]
    assert rules_of(bad.replace(".item()", ".item()  # af2: noqa[AF2L002]")) == []
    assert rules_of(bad.replace(".item()", "")) == []


@pytest.mark.parametrize("call", ["x.tolist()", "x.cpu()", "x.numpy()",
                                  "torch.cuda.synchronize()", "float(x)", "bool(x.any())",
                                  "int(x.sum())"])
def test_each_host_sync_in_forward_flagged(call):
    src = f"""
    import torch
    from torch import nn

    class M(nn.Module):
        def forward(self, x):
            y = {call}
            return x
    """
    assert rules_of(src) == ["AF2L002"]


def test_host_sync_buried_in_autograd_function_backward():
    """The counterpart of the JAX auditor's callback inside a custom VJP's
    backward: the hot path includes the backward of a Function."""
    src = """
    import torch

    class F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            if bool(g.isfinite().all()):
                return g * 2
            return g
    """
    assert rules_of(src) == ["AF2L002"]


def test_tensor_metadata_is_not_a_sync():
    src = """
    import torch
    from torch import nn

    class M(nn.Module):
        def forward(self, x, scale: float = 1.0):
            n = int(x.shape[-1])
            d = float(x.dim()) + float(scale)
            return x * d / n
    """
    assert rules_of(src) == []


def test_ops_and_models_functions_are_hot_by_path():
    src = """
    import torch

    def attend(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
        return q * float(q.max()) * float(sm_scale)
    """
    assert rules_of(src, "pkg/ops/attention.py") == ["AF2L002"]
    assert rules_of(src, "pkg/models/trunk.py") == ["AF2L002"]
    # the training loop logs on the host on purpose: not a hot file
    assert rules_of(src, "pkg/train/loop.py") == []


def test_sync_outside_the_hot_path_is_fine():
    src = """
    import torch

    def report(x):
        return float(x.sum()), x.cpu().numpy()

    class Engine:
        def collect(self, out):
            return out.cpu()
    """
    assert rules_of(src) == []


# ------------------------------------------------------------ AF2L004


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)", "torch.randn(3)", "torch.rand((2, 2))", "torch.randint(0, 5, (3,))",
    "torch.randperm(4)", "torch.normal(0.0, 1.0, (2,))", "torch.bernoulli(p)",
    "w.normal_()", "np.random.rand(3)", "np.random.seed(0)", "random.random()",
    "torch.cuda.manual_seed(0)",
])
def test_global_rng_flagged(call):
    src = f"""
    import random
    import numpy as np
    import torch

    def init(p, w):
        return {call}
    """
    assert rules_of(src) == ["AF2L004"]


@pytest.mark.parametrize("call", [
    "torch.randn(3, generator=gen)", "torch.randint(0, 5, (3,), generator=gen)",
    "w.normal_(generator=gen)", "np.random.default_rng(0).random(3)",
    "np.random.Generator(np.random.PCG64(1))", "random.Random(0).random()",
])
def test_seeded_generators_are_clean(call):
    src = f"""
    import random
    import numpy as np
    import torch

    def init(w, gen):
        return {call}
    """
    assert rules_of(src) == []


# ------------------------------------------------------------ AF2L020 / AF2L021


@pytest.mark.parametrize("stmt", [
    "import jax", "import jax.numpy as jnp", "from flax import linen as nn", "import optax",
    "from jaxlib import xla_client", "from alphafold2_tpu.ops import sparse",
    "import alphafold2_tpu.analysis.lint",
])
def test_jax_package_imports_flagged(stmt):
    assert rules_of(stmt + "\n") == ["AF2L020"]


def test_torch_imports_and_relative_imports_are_clean():
    src = """
    import torch
    import numpy as np
    from alphafold2_tpu_torch.ops import sparse
    from . import jaxish
    """
    assert rules_of(src) == []


def test_is_available_device_choice_flagged_outside_device_py():
    src = """
    import torch

    def pick():
        return "cuda" if torch.cuda.is_available() else "cpu"
    """
    assert rules_of(src, "pkg/predict.py") == ["AF2L021"]
    assert rules_of(src, "alphafold2_tpu_torch/device.py") == []
    assert rules_of(src, "chip_smoke.py") == ["AF2L021"]
    assert rules_of(src.replace("def pick", "def main"), "chip_smoke.py") == []


# ------------------------------------------- generic rules, as in JAX


def test_mutable_default_and_bare_except():
    src = """
    def f(x, cache={}):
        try:
            return cache[x]
        except:
            return None
    """
    assert rules_of(src) == ["AF2L005", "AF2L006"]


def test_blanket_noqa_suppresses_all_rules():
    src = """
    import torch

    def f(x, cache=[]):  # af2: noqa
        return torch.randn(3)  # af2: noqa
    """
    assert rules_of(src) == []


BLOCKING = """
import threading
import time

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, x):
        with self._lock:
            self._items.append(x)
            time.sleep(0.1)
"""
CONDITION_WAIT = """
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()
        self._items = []

    def get(self):
        with self._cv:
            while not self._items:
                self._cv.wait()
            return self._items.pop()
"""
GUARDED = """
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, x):
        with self._lock:
            self._items.append(x)

    def drop(self):
        self._items.pop()
"""
LOCKED_SUFFIX = """
import threading
import time

class Q:
    def __init__(self):
        self._lock = threading.Lock()

    def _flush_locked(self):
        time.sleep(0.5)
"""
THREAD_BODY = """
import threading

class W:
    def start(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        return self.buf.item()
"""
GENERIC_FIXTURES = {
    "mutable_default_bare_except": "def f(x, cache={}):\n    try:\n        return cache[x]\n"
                                   "    except:\n        return None\n",
    "blocking": BLOCKING,
    "blocking_noqa": BLOCKING.replace("time.sleep(0.1)", "time.sleep(0.1)  # af2: noqa[AF2L010]"),
    "condition_wait": CONDITION_WAIT,
    "guarded": GUARDED,
    "guarded_locked_suffix": GUARDED.replace("def drop", "def drop_locked"),
    "locked_suffix": LOCKED_SUFFIX,
    "thread_body": THREAD_BODY,
    "thread_body_outside": THREAD_BODY.replace("target=self._run", "target=self._other"),
}
GENERIC_RULES = {"AF2L005", "AF2L006", "AF2L010", "AF2L011", "AF2L012"}


@pytest.mark.parametrize("name", sorted(GENERIC_FIXTURES))
def test_generic_rules_match_the_jax_linter(name):
    """The carried-over rules give the JAX linter's findings, line for
    line, on the same source."""
    src = GENERIC_FIXTURES[name]
    ours = [(f.rule, f.line, f.col) for f in lint.lint_source(src)
            if f.rule in GENERIC_RULES]
    theirs = [(f.rule, f.line, f.col) for f in jax_lint.lint_source(src)
              if f.rule in GENERIC_RULES]
    assert ours == theirs


def test_generic_fixtures_fire_what_they_claim():
    expect = {"mutable_default_bare_except": ["AF2L005", "AF2L006"], "blocking": ["AF2L010"],
              "blocking_noqa": [], "condition_wait": [], "guarded": ["AF2L011"],
              "guarded_locked_suffix": [], "locked_suffix": ["AF2L010"],
              "thread_body": ["AF2L012"], "thread_body_outside": []}
    assert {n: [f.rule for f in lint.lint_source(s)] for n, s in GENERIC_FIXTURES.items()} == expect


def test_torch_sync_in_thread_body_flagged():
    src = THREAD_BODY.replace("self.buf.item()", "self.buf.cpu()")
    assert rules_of(src) == ["AF2L012"]


# ------------------------------------------------------------ entry points


def test_syntax_error_is_a_finding_not_a_crash(tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert [f.rule for f in lint.lint_file(str(broken))] == ["AF2L000"]


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "alphafold2_tpu_torch.analysis.lint", *args],
                          capture_output=True, text=True, timeout=120, cwd=REPO)


def test_cli_exits_1_with_rule_and_location(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef init():\n    return torch.randn(3)\n")
    out_json = tmp_path / "findings.json"
    proc = _cli("--json", str(out_json), str(bad))
    assert proc.returncode == 1
    assert f"{bad}:4:" in proc.stdout and "AF2L004" in proc.stdout
    doc = json.loads(out_json.read_text())
    assert doc["counts"]["error"] == 1 and doc["findings"][0]["rule"] == "AF2L004"


def test_cli_exits_0_on_clean_file_and_2_on_usage_errors(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("import torch\n\ndef f(x):\n    return x + 1\n")
    assert _cli(str(good)).returncode == 0
    assert _cli(str(tmp_path / "missing.py")).returncode == 2
    assert _cli("--select", "AF2L999", str(good)).returncode == 2
    assert _cli().returncode == 2
    assert lint.main(["--list-rules"]) == 0


def test_importing_the_lint_imports_no_torch():
    code = ("import sys, alphafold2_tpu_torch.analysis.lint\n"
            "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.stdout.strip() == "False", proc.stderr


def test_port_lints_clean():
    """The acceptance bar: the port and chip_smoke.py have no findings."""
    findings = lint.lint_paths([os.path.join(REPO, "alphafold2_tpu_torch"),
                                os.path.join(REPO, "chip_smoke.py")])
    assert findings == [], "\n".join(f.format() for f in findings)
