"""AST linter for the PyTorch port (counterpart of
``alphafold2_tpu/analysis/lint.py``).

Purely syntactic rules over the port's source that flag, before a card
runs it, the hazards that carry over from the JAX package and the ones the
port adds. Pure stdlib, so it runs in milliseconds anywhere.

Rules (id, severity), with the JAX linter's ids where the hazard carries
over:

- ``AF2L002`` error — host sync in the hot path: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, or builtin
  ``float``/``int``/``bool`` of a tensor parameter (annotated as a tensor,
  or an unannotated argument of a ``forward``/``backward``), inside the
  ``forward`` of a module, inside an ``autograd.Function``, or in any
  function of the port's ``ops/`` and ``models/``. Reading a tensor's
  shape, dtype, device or strides is not a sync and is exempt.
- ``AF2L004`` error — global RNG anywhere: ``torch.manual_seed``, a
  ``torch.rand*``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` call or an in-place ``.normal_()``-style
  draw without ``generator=``, ``np.random.<fn>`` (constructing an explicit
  generator such as ``np.random.default_rng(seed)`` is fine), ``random.*``.
  Results must follow from explicit, seeded generators.
- ``AF2L005`` warning, ``AF2L006`` warning — as in JAX: mutable default
  argument, bare ``except:``.
- ``AF2L010`` error, ``AF2L011`` warning, ``AF2L012`` error — as in JAX:
  blocking call under a lock, lock-guarded state mutated outside the lock,
  host sync in a ``threading.Thread`` body (``.cpu()``, ``.numpy()`` and
  ``synchronize`` count as syncs too).
- ``AF2L020`` error — an import of ``jax``, ``jaxlib``, ``flax``, ``optax``
  or ``alphafold2_tpu``: the port and ``chip_smoke.py`` stand alone.
- ``AF2L021`` error — ``torch.cuda.is_available()`` outside ``device.py``
  and ``chip_smoke.py``'s ``main``: choosing the device by whether a card
  is present is a quiet CPU fallback; entry points go through
  ``device.resolve_device``, which raises without a card unless the caller
  asks for the CPU.

Not carried over: ``AF2L001`` (Python control flow on a traced value),
``AF2L003`` (wall clock under trace), ``AF2L007`` (traced parameter needing
``static_argnames``), ``AF2L008`` (``print`` under trace) and ``AF2L009``
(host side effects under trace) concern code that runs once while ``jit``
traces it. Eager PyTorch has no such trace: its Python runs on every call,
so those constructs are not hazards here.

Suppression: ``# af2: noqa[AF2L002]`` (comma-separated ids) or a blanket
``# af2: noqa`` on the finding's line, with the reason in the comment.

CLI::

    python -m alphafold2_tpu_torch.analysis.lint alphafold2_tpu_torch chip_smoke.py

Exit codes: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Iterable, Optional

SEVERITIES = ("error", "warning")

RULES = {
    "AF2L002": ("error", "host sync in a forward, autograd.Function or ops/models function"),
    "AF2L004": ("error", "global RNG"),
    "AF2L005": ("warning", "mutable default argument"),
    "AF2L006": ("warning", "bare except"),
    "AF2L010": ("error", "blocking call while holding a lock"),
    "AF2L011": ("warning", "lock-guarded state mutated outside its lock"),
    "AF2L012": ("error", "host sync in a thread body"),
    "AF2L020": ("error", "JAX-package import in the port"),
    "AF2L021": ("error", "device chosen by torch.cuda.is_available()"),
}

_NOQA_RE = re.compile(r"#\s*af2:\s*noqa(?:\[([A-Za-z0-9_,\s]+)\])?")

FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "optax", "alphafold2_tpu")
_HOT_DIRS = {"ops", "models"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# reading these from a tensor needs no device value
_META_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad", "size",
    "dim", "numel", "stride", "element_size", "data_ptr", "is_contiguous", "names",
}
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like",
    "normal", "bernoulli", "multinomial", "poisson",
}
_INPLACE_DRAWS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_", "geometric_",
    "cauchy_", "log_normal_",
}
_SEEDING = {"manual_seed", "manual_seed_all", "seed", "seed_all"}
# explicit generator objects: seeded where they are made
_NP_GENERATORS = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937",
}
_STDLIB_GENERATORS = {"Random", "SystemRandom"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}"
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _noqa_lines(source: str) -> dict:
    """line number -> set of suppressed rule ids (empty set = all rules)."""
    out: dict = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(text)
        if not m:
            continue
        ids = m.group(1)
        out[i] = (
            {s.strip().upper() for s in ids.split(",") if s.strip()}
            if ids else set()
        )
    return out


def _attr_chain(node: ast.AST) -> list:
    """``torch.cuda.synchronize`` -> ["torch", "cuda", "synchronize"]; []
    if not a pure chain."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _base_names(cls: ast.ClassDef) -> set:
    return {chain[-1] for chain in (_attr_chain(b) for b in cls.bases) if chain}


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    return node is not None and any(
        (isinstance(n, ast.Name) and n.id == "Tensor")
        or (isinstance(n, ast.Attribute) and n.attr == "Tensor")
        or (isinstance(n, ast.Constant) and isinstance(n.value, str) and "Tensor" in n.value)
        for n in ast.walk(node))


def _all_args(fn) -> list:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs + [x for x in (a.vararg, a.kwarg) if x]


def _in_package_dir(path: str, names: set) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(p in names for p in parts[:-1])


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.findings: list = []
        self.noqa = _noqa_lines(source)
        self.tree = ast.parse(source, filename=path)
        self.hot_file = _in_package_dir(path, _HOT_DIRS)
        base = os.path.basename(path)
        self.device_file = base == "device.py"
        self.smoke_file = base == "chip_smoke.py"
        # enclosing scopes, innermost last: ("class", ClassDef) or
        # ("def", name, tensor parameters if the function is hot else None)
        self._scopes: list = []

    def run(self) -> list:
        self.visit(self.tree)
        return self.findings

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        suppressed = self.noqa.get(line)
        if suppressed is not None and (not suppressed or rule in suppressed):
            return
        self.findings.append(Finding(rule, RULES[rule][0], self.path, line,
                                     getattr(node, "col_offset", 0), message))

    # --------------------------------------------------------- contexts

    def visit_ClassDef(self, node):
        self._scopes.append(("class", node))
        try:
            self.generic_visit(node)
        finally:
            self._scopes.pop()

    def _outer_hot(self) -> Optional[set]:
        """The nearest enclosing function's tensor parameters if it is
        hot, else None."""
        for scope in reversed(self._scopes):
            if scope[0] == "def":
                return scope[2]
        return None

    def _function_names(self) -> list:
        return [scope[1] for scope in self._scopes if scope[0] == "def"]

    def _hot_params(self, fn) -> Optional[set]:
        """The tensor parameters of ``fn`` if it opens a hot context: a
        function of ops/ or models/, a module's ``forward``, a method of an
        ``autograd.Function``, or a closure inside any of these."""
        cls = self._scopes[-1][1] if self._scopes and self._scopes[-1][0] == "class" else None
        outer = self._outer_hot()
        in_function_class = cls is not None and "Function" in _base_names(cls)
        forward = cls is not None and fn.name == "forward"
        if not (self.hot_file or outer is not None or in_function_class or forward):
            return None
        grad_method = cls is not None and fn.name in ("forward", "backward")
        params = set(outer or ())
        for a in _all_args(fn):
            if a.arg in ("self", "cls", "ctx"):
                continue
            if _is_tensor_annotation(a.annotation) or (grad_method and a.annotation is None):
                params.add(a.arg)
        return params

    def _visit_function(self, fn):
        self._check_mutable_defaults(fn)
        self._scopes.append(("def", fn.name, self._hot_params(fn)))
        try:
            self.generic_visit(fn)
        finally:
            self._scopes.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _in_hot(self) -> bool:
        return self._outer_hot() is not None

    # ------------------------------------------------------ always-on rules

    def _check_mutable_defaults(self, fn):
        for default in list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None
        ]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and _attr_chain(default.func) in (["list"], ["dict"], ["set"])
            )
            if mutable:
                self._emit(
                    "AF2L005", default,
                    f"mutable default argument in {fn.name}(): evaluated "
                    "once and shared across calls; default to None",
                )

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self._emit(
                "AF2L006", node,
                "bare except: catches KeyboardInterrupt/SystemExit and "
                "masks the errors the other rules exist to surface; name the exception class",
            )
        self.generic_visit(node)

    def _check_import(self, node, names):
        for name in names:
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN_IMPORTS):
                self._emit(
                    "AF2L020", node,
                    f"import of {name}: the port imports torch and numpy, never the JAX "
                    "package or its frameworks; keep a copy of what it needs",
                )

    def visit_Import(self, node):
        self._check_import(node, [a.name for a in node.names])

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module:
            self._check_import(node, [node.module])

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        self._check_rng(node, chain)
        if chain[-2:] == ["cuda", "is_available"] and not (
                self.device_file or (self.smoke_file and "main" in self._function_names())):
            self._emit(
                "AF2L021", node,
                "torch.cuda.is_available() choosing a device is a quiet CPU fallback: "
                "go through device.resolve_device, which raises without a card unless "
                "the caller asks for the CPU",
            )
        if self._in_hot():
            self._check_sync(node, chain)
        self.generic_visit(node)

    # ------------------------------------------------------------ AF2L004

    def _check_rng(self, node: ast.Call, chain: list):
        if len(chain) >= 2 and chain[0] == "torch" and chain[-1] in _SEEDING:
            self._emit("AF2L004", node,
                       f"{'.'.join(chain)}() seeds the global RNG: pass a seeded "
                       "torch.Generator to each draw instead")
        elif (len(chain) >= 2 and chain[0] == "torch" and chain[-1] in _TORCH_DRAWS
              and not _has_kwarg(node, "generator")):
            self._emit("AF2L004", node,
                       f"{'.'.join(chain)}() without generator= draws from the global "
                       "RNG; pass a seeded torch.Generator")
        elif (isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS
              and not _has_kwarg(node, "generator")):
            self._emit("AF2L004", node,
                       f".{node.func.attr}() without generator= draws from the global "
                       "RNG; pass a seeded torch.Generator")
        elif (len(chain) >= 3 and chain[0] in _NUMPY_ALIASES and chain[1] == "random"
              and chain[2] not in _NP_GENERATORS):
            self._emit("AF2L004", node,
                       f"{'.'.join(chain)}() draws from numpy's global RNG; use "
                       "np.random.default_rng(seed)")
        elif (len(chain) >= 2 and chain[0] == "random"
              and chain[1] not in _STDLIB_GENERATORS):
            self._emit("AF2L004", node,
                       f"stdlib {'.'.join(chain)}() draws from the global RNG; use "
                       "a seeded generator")

    # ------------------------------------------------------------ AF2L002

    def _tensor_names_in(self, node: ast.AST) -> set:
        """Tensor parameters whose values (not metadata) ``node`` reads."""
        params = self._outer_hot()
        found: set = set()

        def walk(n):
            if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS:
                return
            if isinstance(n, ast.Name) and n.id in params:
                found.add(n.id)
            for child in ast.iter_child_nodes(n):
                walk(child)

        walk(node)
        return found

    def _check_sync(self, node: ast.Call, chain: list):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
            self._emit(
                "AF2L002", node,
                f".{node.func.attr}() in the hot path copies a device value to the host "
                "and waits for the card; keep values on the device",
            )
        elif chain[-2:] == ["cuda", "synchronize"]:
            self._emit(
                "AF2L002", node,
                "torch.cuda.synchronize() in the hot path stalls the host until the "
                "card drains",
            )
        elif chain in (["float"], ["int"], ["bool"], ["complex"]) and node.args:
            names = self._tensor_names_in(node.args[0])
            if names:
                self._emit(
                    "AF2L002", node,
                    f"builtin {chain[0]}() of tensor {sorted(names)[0]!r} waits for the "
                    "card and copies its value to the host; keep it a tensor",
                )


# ------------------------------------------------- thread-safety rules

_LOCK_FACTORIES = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
}
# calls that block the calling thread (module.attr chains)
_BLOCKING_CHAIN_HEADS = {"socket", "subprocess", "requests", "urllib"}
_BLOCKING_CALLS = {
    ("time", "sleep"), ("os", "system"), ("os", "popen"),
}
# socket/file methods that block regardless of the receiver expression;
# .wait() is deliberately absent (Condition.wait releases the lock)
_BLOCKING_METHODS = {
    "recv", "recvfrom", "sendall", "sendto", "connect", "accept",
    "read_text", "write_text", "readline", "readlines",
}
_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popleft",
    "appendleft", "clear", "update", "setdefault", "add", "discard",
}
_HOST_SYNC_CALLS = {"device_get", "block_until_ready", "synchronize"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` -> "x" (None for anything else)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """One pass over a method body tracking ``with self.<lock>:`` depth;
    records self-attribute mutations (with lock state) and blocking calls
    made while a lock is held."""

    def __init__(self, lock_attrs: set, assume_held: bool = False):
        self.lock_attrs = lock_attrs
        # the *_locked naming convention documents "caller holds the lock"
        self.lock_depth = 1 if assume_held else 0
        self.mutations: list = []  # (attr, node, held: bool)
        self.blocking: list = []  # (node, description)

    def _is_lock_expr(self, node: ast.AST) -> bool:
        attr = _self_attr(node)
        return attr is not None and attr in self.lock_attrs

    def visit_With(self, node: ast.With):
        held = sum(
            1 for item in node.items if self._is_lock_expr(item.context_expr)
        )
        self.lock_depth += held
        try:
            self.generic_visit(node)
        finally:
            self.lock_depth -= held

    def _mutation(self, attr: Optional[str], node: ast.AST):
        if attr is not None:
            self.mutations.append((attr, node, self.lock_depth > 0))

    def _mutated_attr_of_target(self, target: ast.AST) -> Optional[str]:
        attr = _self_attr(target)
        if attr is not None:
            return attr
        if isinstance(target, ast.Subscript):
            return _self_attr(target.value)
        return None

    def visit_Assign(self, node: ast.Assign):
        for target in node.targets:
            elts = target.elts if isinstance(
                target, (ast.Tuple, ast.List)
            ) else [target]
            for t in elts:
                self._mutation(self._mutated_attr_of_target(t), node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._mutation(self._mutated_attr_of_target(node.target), node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for target in node.targets:
            self._mutation(self._mutated_attr_of_target(target), node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        # self.<attr>.<mutator>(...) counts as a mutation of self.<attr>
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATING_METHODS:
                self._mutation(_self_attr(node.func.value), node)
        if self.lock_depth > 0:
            desc = self._blocking_desc(node)
            if desc:
                self.blocking.append((node, desc))
        self.generic_visit(node)

    @staticmethod
    def _blocking_desc(node: ast.Call) -> Optional[str]:
        chain = _attr_chain(node.func)
        if not chain:
            return None
        if chain == ["open"]:
            return "open"
        if tuple(chain) in _BLOCKING_CALLS:
            return ".".join(chain)
        if len(chain) >= 2 and chain[0] in _BLOCKING_CHAIN_HEADS:
            return ".".join(chain)
        if len(chain) >= 2 and chain[-1] in _BLOCKING_METHODS:
            return ".".join(chain)
        return None


class _ThreadSafetyLinter:
    """AF2L010–012 over one parsed module, as in the JAX linter."""

    def __init__(self, path: str, tree: ast.Module, noqa: dict):
        self.path = path
        self.tree = tree
        self.noqa = noqa
        self.findings: list = []

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 0)
        suppressed = self.noqa.get(line)
        if suppressed is not None and (not suppressed or rule in suppressed):
            return
        self.findings.append(
            Finding(rule, RULES[rule][0], self.path, line,
                    getattr(node, "col_offset", 0), message)
        )

    def run(self) -> list:
        thread_targets = self._thread_target_names()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._lint_class(node)
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node.name in thread_targets:
                self._lint_thread_body(node)
        return self.findings

    def _thread_target_names(self) -> set:
        """Function/method names passed as ``threading.Thread(target=...)``
        anywhere in the module."""
        names: set = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain or chain[-1] != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                attr = _self_attr(kw.value)
                if attr is not None:
                    names.add(attr)
                elif isinstance(kw.value, ast.Name):
                    names.add(kw.value.id)
        return names

    @staticmethod
    def _lock_attrs_of(cls: ast.ClassDef) -> set:
        """Instance attrs assigned a ``threading.<Lock factory>()``."""
        locks: set = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            chain = _attr_chain(node.value.func)
            if (
                len(chain) == 2
                and chain[0] == "threading"
                and chain[1] in _LOCK_FACTORIES
            ):
                for target in node.targets:
                    attr = _self_attr(target)
                    if attr is not None:
                        locks.add(attr)
        return locks

    def _lint_class(self, cls: ast.ClassDef):
        lock_attrs = self._lock_attrs_of(cls)
        if not lock_attrs:
            return
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        scans = {}
        for method in methods:
            scan = _MethodScan(
                lock_attrs, assume_held=method.name.endswith("_locked")
            )
            scan.visit(method)
            scans[method.name] = scan
            for node, desc in scan.blocking:
                self._emit(
                    "AF2L010", node,
                    f"blocking call {desc}() in {cls.name}.{method.name} "
                    "while holding a lock: every thread contending for it "
                    "stalls behind the I/O; move it outside the critical "
                    "section",
                )
        guarded = {
            attr
            for scan in scans.values()
            for attr, _, held in scan.mutations
            if held
        } - lock_attrs
        for name, scan in scans.items():
            if name == "__init__":
                continue  # construction happens-before any other thread
            for attr, node, held in scan.mutations:
                if held or attr not in guarded:
                    continue
                self._emit(
                    "AF2L011", node,
                    f"self.{attr} is mutated under {cls.name}'s lock "
                    f"elsewhere but written in {name}() without it: either "
                    "take the lock here or document why this write cannot "
                    "race",
                )

    def _lint_thread_body(self, fn):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            desc = None
            if chain and chain[-1] in _HOST_SYNC_CALLS:
                desc = ".".join(chain)
            elif chain and len(chain) > 1 and chain[-1] in (
                "item", "tolist", "cpu", "numpy"
            ):
                desc = f".{chain[-1]}()"
            elif (
                len(chain) >= 2
                and chain[0] in _NUMPY_ALIASES
                and chain[1] in ("asarray", "array")
            ):
                desc = ".".join(chain)
            if desc:
                self._emit(
                    "AF2L012", node,
                    f"host sync {desc} inside thread body {fn.name}(): "
                    "this thread exists to keep the device pipeline full — "
                    "a sync here serializes it; hand results back instead",
                )


# ------------------------------------------------------------ entry points


def lint_source(source: str, path: str = "<string>") -> list:
    """Lint one source string; returns a list of :class:`Finding`."""
    linter = _Linter(path, source)
    findings = linter.run()
    findings += _ThreadSafetyLinter(path, linter.tree, linter.noqa).run()
    return sorted(findings, key=lambda f: (f.line, f.col, f.rule))


def lint_file(path: str) -> list:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        return lint_source(source, path)
    except SyntaxError as e:
        return [
            Finding(
                "AF2L000", "error", path, e.lineno or 0, e.offset or 0,
                f"syntax error: {e.msg}",
            )
        ]


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d for d in dirs
                if d not in ("__pycache__", ".git", ".venv", "node_modules")
            )
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(paths: Iterable[str], select: Optional[set] = None) -> list:
    """Lint files/directories; ``select`` restricts to those rule ids."""
    findings: list = []
    for path in iter_python_files(paths):
        for f in lint_file(path):
            if select is None or f.rule in select:
                findings.append(f)
    return findings


def findings_to_json(findings: list) -> str:
    return json.dumps(
        {
            "tool": "af2_lint_torch",
            "findings": [f.to_dict() for f in findings],
            "counts": {
                sev: sum(1 for f in findings if f.severity == sev)
                for sev in SEVERITIES
            },
        },
        indent=2,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m alphafold2_tpu_torch.analysis.lint",
        description="AST linter for the PyTorch port; exit 0 clean, 1 findings, 2 usage error",
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to report (default: all)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write the findings as JSON to this path")
    parser.add_argument("--list-rules", action="store_true", help="print the rule table")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    if args.list_rules:
        for rule, (severity, title) in sorted(RULES.items()):
            print(f"{rule}  {severity:7s}  {title}")
        return 0
    if not args.paths:
        print("no paths given", file=sys.stderr)
        return 2
    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path(s): {missing}", file=sys.stderr)
        return 2

    findings = lint_paths(args.paths, select=select)
    for f in findings:
        print(f.format())
    if args.json_path:
        with open(args.json_path, "w", encoding="utf-8") as fh:
            fh.write(findings_to_json(findings))
    n_err = sum(1 for f in findings if f.severity == "error")
    print(f"af2_lint_torch: {len(findings)} finding(s) ({n_err} error, "
          f"{len(findings) - n_err} warning)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
