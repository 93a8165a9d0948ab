"""Static concurrency auditor of the port: lock graph, guard contracts,
lifecycles.

Port of ``alphafold2_tpu/analysis/concurrency.py`` (the same AST model and
rules, pure standard library), pointed at the port: ``alphafold2_tpu_torch/``
and ``chip_smoke.py``. The port's serving stack runs more threads than any
other code in the repo (the fleet's router and health pump, each replica's
frontend dispatcher and pipeline stages, the exposition server, the
watchdog), sharing state behind a set of locks. The lint's AF2L010-012
catch three local patterns; this module proves the global ones:

1. **Lock-order graph** (AF2C001) — every ``threading.Lock`` / ``RLock``
   / ``Condition`` / ``Semaphore`` attribute of every class is a node
   ``Class.attr``; acquiring B while A is held (``with`` nesting,
   ``acquire``/``release`` pairs, the ``*_locked`` convention's entry
   assumption, and transitively through calls whose receiver type is
   statically known) adds the edge A -> B. A cycle is a lock-order
   inversion, printed edge by edge with the acquisition that witnesses it.
2. **Guarded-state inference** (AF2C002-004) — an attribute whose writes
   are mostly under one lock gets a guard contract; unguarded writes
   (AF2C002), writes under another lock (AF2C003) and unlocked iteration of
   a guarded container (AF2C004) are findings. ``__init__`` /
   ``__post_init__`` are exempt, ``*_locked`` bodies count as held, and a
   private helper called only with a lock held inherits it.
3. **Thread/queue lifecycle** (AF2C005-008) — threads with neither
   ``daemon=True`` nor a reachable ``join`` (AF2C005), unbounded
   ``queue.Queue()``/``deque()`` attributes of threaded classes (AF2C006),
   ``Condition.wait`` outside a predicate loop (AF2C007), and observer or
   callback collections called with a lock held (AF2C008).

The committed ``alphafold2_tpu_torch/analysis/concurrency_contracts.json``
(the port's own; the root ``concurrency_contracts.json`` is the JAX
package's) pins the lock graph's named edges and the guard map; ``--check``
diffs them exactly (``stale-baseline`` on a format change), ``--update``
re-records them.

Seeded negative controls: a function marked ``# af2: gated-defect[ENV]`` is
skipped unless ``$ENV`` is set. ``AF2TPU_AUDIT_INVERT_LOCKS=1`` activates
``serve/scheduler.py`` ``_audit_invert_locks``, and the audit must exit 1
naming the ``AsyncServeFrontend._lock`` <-> ``PipelineBatch._lock`` cycle;
``AF2TPU_AUDIT_FLEET_LOCK=1`` activates ``serve/fleet.py``
``_audit_fleet_hold_router_lock``, and ``--graph`` must show the forbidden
``FleetFrontend._lock -> AsyncServeFrontend._lock`` edge. No thread runs
either.

Suppress an intentional finding with ``# af2: noqa[AF2C00x]`` and a reason
in the comment, as in ``analysis/lint.py``. CLI::

    python -m alphafold2_tpu_torch.analysis.concurrency [--check|--update|--graph]
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from alphafold2_tpu_torch.analysis.lint import (
    Finding,
    _attr_chain,
    _noqa_lines,
    _self_attr,
    iter_python_files,
)

RULES = {
    "AF2C000": "concurrency scan failure (unparseable source) — never "
               "silent green",
    "AF2C001": "lock-order inversion: the whole-repo lock graph has a "
               "cycle (two threads taking the edges in opposite order "
               "deadlock)",
    "AF2C002": "write to a guard-contracted attribute with no lock held",
    "AF2C003": "mixed guards: attribute written under a different lock "
               "than its contract",
    "AF2C004": "unlocked iteration of a guard-contracted container "
               "(concurrent mutation tears the traversal)",
    "AF2C005": "thread created with neither daemon=True nor a reachable "
               "join (leaks past shutdown)",
    "AF2C006": "unbounded queue.Queue()/deque() attribute in a "
               "threaded class (producer can outrun every consumer)",
    "AF2C007": "Condition.wait outside a predicate loop (spurious "
               "wakeups and missed notifies)",
    "AF2C008": "observer/callback collection invoked while holding a "
               "lock (re-entrant or slow callbacks deadlock/stall the "
               "owner)",
    "AF2C009": "concurrency contract drift vs the committed baseline",
}

_SEVERITY = {
    "AF2C000": "error",
    "AF2C001": "error",
    "AF2C002": "error",
    "AF2C003": "error",
    "AF2C004": "warning",
    "AF2C005": "error",
    "AF2C006": "warning",
    "AF2C007": "error",
    "AF2C008": "error",
    "AF2C009": "error",
}

FORMAT_VERSION = 1
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_BASELINE = os.path.join(_REPO, "alphafold2_tpu_torch", "analysis",
                                "concurrency_contracts.json")

# functions carrying this marker (on the def line or the line above) hold
# seeded defects for the CI negative control: invisible to the audit and
# to contract computation unless the named env var is set truthy
_GATED_RE = re.compile(r"#\s*af2:\s*gated-defect\[([A-Z0-9_]+)\]")

_LOCK_FACTORIES = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
}
# lock kinds that re-enter safely: a self-edge (same lock taken while
# held) is only a deadlock for a plain Lock
_REENTRANT = {"RLock", "Condition", "Semaphore", "BoundedSemaphore"}

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popleft",
    "appendleft", "extendleft", "rotate", "clear", "update", "setdefault",
    "add", "discard", "popitem", "move_to_end",
}
# calls that traverse their container argument — the AF2C004 surface
_ITERATING_FUNCS = {
    "list", "tuple", "sorted", "set", "dict", "sum", "min", "max",
    "any", "all", "frozenset",
}
_ITERATING_METHODS = {"items", "keys", "values", "copy"}
_OBSERVER_ATTR_RE = re.compile(
    r"(observer|callback|hook|sink|listener|subscriber)s?$"
)


# --------------------------------------------------------------- collection


def _ann_name(node: Optional[ast.AST]) -> Optional[str]:
    """A class name out of an annotation: ``T``, ``mod.T``, ``"T"``,
    ``Optional[T]``. None for anything fancier."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.rsplit(".", 1)[-1] or None
    if isinstance(node, ast.Subscript):
        return _ann_name(node.slice)
    chain = _attr_chain(node)
    return chain[-1] if chain else None


def _call_class_name(node: ast.AST) -> Optional[str]:
    """``ClassName(...)`` / ``mod.ClassName(...)`` -> "ClassName"."""
    if not isinstance(node, ast.Call):
        return None
    chain = _attr_chain(node.func)
    return chain[-1] if chain else None


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)

    @property
    def sole_lock(self) -> Optional[str]:
        """The class's only lock attribute, if unambiguous — the
        ``*_locked`` convention's entry assumption."""
        if len(self.locks) == 1:
            return next(iter(self.locks))
        return None


def _collect_class(node: ast.ClassDef, path: str) -> ClassInfo:
    info = ClassInfo(name=node.name, path=path, node=node)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[item.name] = item
            params = {
                a.arg: _ann_name(a.annotation)
                for a in item.args.args + item.args.kwonlyargs
                if a.annotation is not None
            }
            for sub in ast.walk(item):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    attr = _self_attr(sub.targets[0])
                    if attr is None:
                        continue
                    chain = _attr_chain(sub.value)
                    if (
                        isinstance(sub.value, ast.Call)
                        and len(_attr_chain(sub.value.func)) >= 1
                        and _attr_chain(sub.value.func)[-1]
                        in _LOCK_FACTORIES
                        and _attr_chain(sub.value.func)[0]
                        in ("threading", "Lock", "RLock", "Condition",
                            "Semaphore", "BoundedSemaphore")
                    ):
                        info.locks[attr] = _attr_chain(sub.value.func)[-1]
                    elif (cls := _call_class_name(sub.value)) is not None:
                        info.attr_types.setdefault(attr, cls)
                    elif chain and len(chain) == 1 and chain[0] in params:
                        # self.batch = batch  (param annotated: PipelineBatch)
                        typ = params[chain[0]]
                        if typ:
                            info.attr_types.setdefault(attr, typ)
                elif isinstance(sub, ast.AnnAssign):
                    attr = _self_attr(sub.target)
                    if attr is None:
                        continue
                    typ = _ann_name(sub.annotation)
                    if typ and typ not in ("Optional", "dict", "list",
                                           "set", "tuple", "int", "float",
                                           "str", "bool"):
                        info.attr_types.setdefault(attr, typ)
        elif isinstance(item, ast.AnnAssign):
            attr = (
                item.target.id if isinstance(item.target, ast.Name) else None
            )
            typ = _ann_name(item.annotation)
            if attr and typ:
                info.attr_types.setdefault(attr, typ)
    return info


# ------------------------------------------------------- per-function scan


@dataclasses.dataclass
class FnScan:
    """Everything one pass extracts from one function/method body."""

    qual: str                       # "Class.method" or "module_fn"
    path: str
    node: ast.AST
    owner: Optional[ClassInfo]
    gated_env: Optional[str] = None
    # (labels held below, acquired label, own-attr if self lock, line)
    acquires: list = dataclasses.field(default_factory=list)
    # (held labels, own attrs held, (ClassName, method), line)
    calls: list = dataclasses.field(default_factory=list)
    # (attr, own lock attrs held, line, col)
    writes: list = dataclasses.field(default_factory=list)
    # (attr, own lock attrs held, line, col)
    iter_reads: list = dataclasses.field(default_factory=list)
    # (line, col, daemon_ok, self_attr or local name or None)
    threads: list = dataclasses.field(default_factory=list)
    joined: set = dataclasses.field(default_factory=set)  # names .join()ed
    # (attr, line, col, kind) unbounded queue/deque self attrs
    queues: list = dataclasses.field(default_factory=list)
    # (line, col, attr) Condition.wait outside a loop
    naked_waits: list = dataclasses.field(default_factory=list)
    # (line, col, attr, held label) observer collection called under lock
    observer_calls: list = dataclasses.field(default_factory=list)

    @property
    def entry_locked(self) -> bool:
        name = self.qual.rsplit(".", 1)[-1]
        return name.endswith("_locked")


class _FnVisitor(ast.NodeVisitor):
    """One pass over a function body with a held-lock stack."""

    def __init__(self, scan: FnScan, registry: Dict[str, ClassInfo]):
        self.scan = scan
        self.reg = registry
        self.owner = scan.owner
        # (label, own_attr or None, kind)
        self.held: List[Tuple[str, Optional[str], str]] = []
        self.loop_depth = 0
        self.types: Dict[str, str] = {}
        self._handled_calls: set = set()
        fn = scan.node
        for a in fn.args.args + fn.args.kwonlyargs:
            typ = _ann_name(a.annotation)
            if typ and typ in registry:
                self.types[a.arg] = typ

    # ----------------------------------------------------------- resolution

    def _held_labels(self) -> tuple:
        return tuple(label for label, _own, _k in self.held)

    def _held_own(self) -> frozenset:
        return frozenset(own for _l, own, _k in self.held if own)

    def _type_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.types.get(node.id)
        attr = _self_attr(node)
        if attr is not None and self.owner is not None:
            return self.owner.attr_types.get(attr)
        return None

    def _resolve_lock(self, node: ast.AST) -> Optional[tuple]:
        """A lock-valued expression -> (label, own_attr|None, kind)."""
        attr = _self_attr(node)
        if attr is not None and self.owner is not None:
            kind = self.owner.locks.get(attr)
            if kind:
                return f"{self.owner.name}.{attr}", attr, kind
            return None
        if isinstance(node, ast.Attribute):
            typ = self._type_of(node.value)
            if typ and typ in self.reg:
                kind = self.reg[typ].locks.get(node.attr)
                if kind:
                    return f"{typ}.{node.attr}", None, kind
        return None

    def _resolve_callee(self, func: ast.AST) -> Optional[tuple]:
        """``self.m`` / ``typed.m`` / ``self.attr.m`` -> (Class, m)."""
        if not isinstance(func, ast.Attribute):
            return None
        if (
            isinstance(func.value, ast.Name) and func.value.id == "self"
            and self.owner is not None
            and func.attr in self.owner.methods
        ):
            return self.owner.name, func.attr
        typ = self._type_of(func.value)
        if typ and typ in self.reg and func.attr in self.reg[typ].methods:
            return typ, func.attr
        return None

    def _push(self, lock: tuple, line: int) -> None:
        label, own, kind = lock
        self.scan.acquires.append(
            (self._held_labels(), label, own, kind, line)
        )
        self.held.append(lock)

    # ------------------------------------------------------------- visitors

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            lock = self._resolve_lock(item.context_expr)
            if lock is not None:
                self._push(lock, item.context_expr.lineno)
                pushed += 1
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_For(self, node: ast.For) -> None:
        self._note_iteration(node.iter)
        self._note_observer_loop(node)
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._note_iteration(node.iter)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.AST) -> None:
        # nested defs (thread targets, callbacks) run on another thread's
        # schedule — their bodies are scanned as their own functions by
        # the caller, not under this frame's held stack
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._note_write_target(target)
            if isinstance(target, ast.Name):
                if isinstance(node.value, ast.Call):
                    cls = _call_class_name(node.value)
                    if cls and cls in self.reg:
                        self.types[target.id] = cls
                if self._is_thread_call(node.value):
                    self._note_thread(node.value, target.id)
                    self._handled_calls.add(id(node.value))
            attr = _self_attr(target)
            if attr is not None:
                if self._is_thread_call(node.value):
                    self._note_thread(node.value, attr)
                    self._handled_calls.add(id(node.value))
                self._note_queue(attr, node.value)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            typ = _ann_name(node.annotation)
            if typ and typ in self.reg:
                self.types[node.target.id] = typ
        self._note_write_target(node.target)
        if node.value is not None:
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_write_target(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._note_write_target(target)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # lock acquire/release pairs (held to function end when the
            # release is on another path — conservative and correct for
            # edge extraction, which records at acquisition time)
            if func.attr == "acquire":
                lock = self._resolve_lock(func.value)
                if lock is not None:
                    self._push(lock, node.lineno)
                    self.generic_visit(node)
                    return
            elif func.attr == "release":
                lock = self._resolve_lock(func.value)
                if lock is not None:
                    for i in range(len(self.held) - 1, -1, -1):
                        if self.held[i][0] == lock[0]:
                            del self.held[i]
                            break
                    self.generic_visit(node)
                    return
            elif func.attr == "wait":
                lock = self._resolve_lock(func.value)
                if (
                    lock is not None and lock[2] == "Condition"
                    and self.loop_depth == 0
                ):
                    self.scan.naked_waits.append(
                        (node.lineno, node.col_offset, lock[0])
                    )
            elif func.attr == "join" and not node.args[:0]:
                attr = _self_attr(func.value)
                if attr is not None:
                    self.scan.joined.add(attr)
                elif isinstance(func.value, ast.Name):
                    self.scan.joined.add(func.value.id)
            # mutating method on a self attribute = a write
            if func.attr in _MUTATING_METHODS:
                attr = _self_attr(func.value)
                if attr is not None:
                    self.scan.writes.append((
                        attr, self._held_own(), node.lineno,
                        node.col_offset,
                    ))
            if func.attr in _ITERATING_METHODS:
                attr = _self_attr(func.value)
                if attr is not None:
                    self.scan.iter_reads.append((
                        attr, self._held_own(), node.lineno,
                        node.col_offset,
                    ))
        if isinstance(func, ast.Name) and func.id in _ITERATING_FUNCS:
            for arg in node.args:
                self._note_iteration(arg)
        if self._is_thread_call(node) and id(node) not in self._handled_calls:
            self._note_thread(node, None)
        callee = self._resolve_callee(func)
        if callee is not None:
            self.scan.calls.append((
                self._held_labels(), self._held_own(), callee, node.lineno,
            ))
        # observer collection invoked by subscript: self._cbs[0](...)
        if (
            isinstance(func, ast.Subscript)
            and (attr := _self_attr(func.value)) is not None
            and _OBSERVER_ATTR_RE.search(attr)
            and self.held
        ):
            self.scan.observer_calls.append(
                (node.lineno, node.col_offset, attr, self.held[-1][0])
            )
        self.generic_visit(node)

    # ---------------------------------------------------------------- notes

    def _note_write_target(self, target: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_write_target(elt)
            return
        attr = _self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
        if attr is not None:
            self.scan.writes.append((
                attr, self._held_own(), target.lineno, target.col_offset,
            ))

    def _note_iteration(self, node: ast.AST) -> None:
        attr = _self_attr(node)
        if attr is None and isinstance(node, ast.Call):
            # self.X.items()/values()/keys()/copy() — already recorded by
            # visit_Call when it gets there; record here too is harmless
            # but double-counts, so leave it to visit_Call
            return
        if attr is not None:
            self.scan.iter_reads.append((
                attr, self._held_own(), node.lineno, node.col_offset,
            ))

    def _note_observer_loop(self, node: ast.For) -> None:
        attr = _self_attr(node.iter)
        if attr is None or not _OBSERVER_ATTR_RE.search(attr):
            return
        if not self.held and not self.scan.entry_locked:
            return
        if not isinstance(node.target, ast.Name):
            return
        var = node.target.id
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == var
            ):
                held = (
                    self.held[-1][0] if self.held
                    else f"{self.owner.name}.{self.owner.sole_lock}"
                    if self.owner and self.owner.sole_lock else "a lock"
                )
                self.scan.observer_calls.append(
                    (sub.lineno, sub.col_offset, attr, held)
                )
                return

    def _is_thread_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        chain = _attr_chain(node.func)
        return chain[-1:] == ["Thread"] and (
            len(chain) == 1 or chain[0] == "threading"
        )

    def _note_thread(self, node: ast.Call, bound_to: Optional[str]) -> None:
        daemon_ok = any(
            kw.arg == "daemon"
            and isinstance(kw.value, ast.Constant) and kw.value.value is True
            for kw in node.keywords
        )
        self.scan.threads.append(
            (node.lineno, node.col_offset, daemon_ok, bound_to)
        )

    def _note_queue(self, attr: str, value: ast.AST) -> None:
        if not isinstance(value, ast.Call):
            return
        chain = _attr_chain(value.func)
        if chain[-1:] == ["Queue"] and (
            len(chain) == 1 or chain[0] in ("queue", "multiprocessing")
        ):
            bounded = bool(value.args) or any(
                kw.arg == "maxsize" for kw in value.keywords
            )
            if not bounded:
                self.scan.queues.append(
                    (attr, value.lineno, value.col_offset, "queue.Queue")
                )
        elif chain[-1:] == ["deque"] and (
            len(chain) == 1 or chain[0] == "collections"
        ):
            bounded = len(value.args) >= 2 or any(
                kw.arg == "maxlen"
                and not (isinstance(kw.value, ast.Constant)
                         and kw.value.value is None)
                for kw in value.keywords
            )
            if not bounded:
                self.scan.queues.append(
                    (attr, value.lineno, value.col_offset, "deque")
                )


# ------------------------------------------------------------- repo model


class RepoModel:
    """The whole-repo concurrency model: classes, scans, graph, guards."""

    def __init__(self) -> None:
        self.classes: Dict[str, ClassInfo] = {}
        self.scans: List[FnScan] = []
        self.methods: Dict[Tuple[str, str], FnScan] = {}
        self.noqa: Dict[str, dict] = {}        # path -> {line: rules}
        self.parse_failures: List[Finding] = []
        # edge -> (provenance string, path, line); edge = (from, to)
        self.edges: Dict[Tuple[str, str], Tuple[str, str, int]] = {}
        self.lock_kinds: Dict[str, str] = {}   # label -> factory kind
        # class -> attr -> guard lock attr
        self.guards: Dict[str, Dict[str, str]] = {}
        self._entry_held: Dict[Tuple[str, str], frozenset] = {}

    # ----------------------------------------------------------- building

    def scan_paths(
        self, paths: Iterable[str], gated: str = "env"
    ) -> "RepoModel":
        """``gated`` controls ``# af2: gated-defect[ENV]`` functions:
        "env" includes one when $ENV is set truthy (the audit path),
        "none" always excludes (contract computation), "all" always
        includes (tests)."""
        trees = []
        for path in iter_python_files(paths):
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
                tree = ast.parse(source)
            except (OSError, SyntaxError) as e:
                self.parse_failures.append(Finding(
                    "AF2C000", _SEVERITY["AF2C000"], path,
                    getattr(e, "lineno", 0) or 0, 0,
                    f"cannot scan: {type(e).__name__}: {e}",
                ))
                continue
            self.noqa[path] = _noqa_lines(source)
            gated_lines = self._gated_lines(source)
            trees.append((path, tree, gated_lines))
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    info = _collect_class(node, path)
                    self.classes[info.name] = info
                    for attr, kind in info.locks.items():
                        self.lock_kinds[f"{info.name}.{attr}"] = kind
        for path, tree, gated_lines in trees:
            self._scan_tree(path, tree, gated_lines, gated)
        self._infer_entry_held()
        self._build_edges()
        self._infer_guards()
        return self

    @staticmethod
    def _gated_lines(source: str) -> Dict[int, str]:
        out = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = _GATED_RE.search(text)
            if m:
                out[i] = m.group(1)
        return out

    def _gate_env_for(self, node: ast.AST, gated: Dict[int, str]):
        for line in range(node.lineno - 1, node.lineno + 2):
            if line in gated:
                return gated[line]
        return None

    def _scan_tree(
        self, path: str, tree: ast.Module, gated_lines: Dict[int, str],
        gated: str,
    ) -> None:
        def scan_fn(fn, owner: Optional[ClassInfo], qual: str) -> None:
            env = self._gate_env_for(fn, gated_lines)
            if env is not None and gated != "all":
                if gated == "none" or os.environ.get(env, "") in ("", "0"):
                    return
            scan = FnScan(
                qual=qual, path=path, node=fn, owner=owner, gated_env=env
            )
            visitor = _FnVisitor(scan, self.classes)
            for stmt in fn.body:
                visitor.visit(stmt)
            self.scans.append(scan)
            if owner is not None:
                self.methods[(owner.name, fn.name)] = scan

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_fn(node, None, node.name)
            elif isinstance(node, ast.ClassDef):
                owner = self.classes.get(node.name)
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        scan_fn(item, owner, f"{node.name}.{item.name}")

    # ------------------------------------------------- entry-held inference

    def _infer_entry_held(self) -> None:
        """Locks assumed held at entry: ``*_locked`` methods hold their
        class's sole lock; a private helper called ONLY with one own lock
        held inherits it (fixpoint over the in-class call graph)."""
        for scan in self.scans:
            if scan.owner is None:
                continue
            key = (scan.owner.name, scan.node.name)
            if scan.entry_locked and scan.owner.sole_lock:
                self._entry_held[key] = frozenset({scan.owner.sole_lock})
        for _ in range(4):  # bounded fixpoint (call chains are short)
            changed = False
            call_sites: Dict[Tuple[str, str], List[frozenset]] = {}
            for scan in self.scans:
                if scan.owner is None:
                    continue
                caller_key = (scan.owner.name, scan.node.name)
                extra = self._entry_held.get(caller_key, frozenset())
                for _held, own_held, callee, _line in scan.calls:
                    if callee[0] != scan.owner.name:
                        continue
                    call_sites.setdefault(callee, []).append(
                        own_held | extra
                    )
            for key, held_sets in call_sites.items():
                cls, meth = key
                if key in self._entry_held:
                    continue
                if not meth.startswith("_") or meth.startswith("__"):
                    continue
                common = frozenset.intersection(*held_sets)
                if len(common) == 1:
                    self._entry_held[key] = common
                    changed = True
            if not changed:
                break

    def entry_held_of(self, scan: FnScan) -> frozenset:
        if scan.owner is None:
            return frozenset()
        return self._entry_held.get(
            (scan.owner.name, scan.node.name), frozenset()
        )

    # ------------------------------------------------------------ the graph

    def _acq_closure(
        self, key: Tuple[str, str], memo: dict, stack: set
    ) -> set:
        """Every lock label a method may acquire, transitively through
        statically-resolved calls (cycle-guarded)."""
        if key in memo:
            return memo[key]
        if key in stack:
            return set()
        scan = self.methods.get(key)
        if scan is None:
            return set()
        stack.add(key)
        out = {label for _below, label, _own, _k, _l in scan.acquires}
        for _held, _own_held, callee, _line in scan.calls:
            out |= self._acq_closure(callee, memo, stack)
        stack.discard(key)
        memo[key] = out
        return out

    def _add_edge(self, src: str, dst: str, prov: str, path: str,
                  line: int) -> None:
        if (src, dst) not in self.edges:
            self.edges[(src, dst)] = (prov, path, line)

    def _prefix_labels(self, scan: FnScan) -> list:
        if scan.owner is None:
            return []
        return [
            f"{scan.owner.name}.{attr}"
            for attr in sorted(self.entry_held_of(scan))
        ]

    def _build_edges(self) -> None:
        memo: dict = {}
        self.self_deadlocks: List[Tuple[str, str, int, str]] = []
        for scan in self.scans:
            prefix = self._prefix_labels(scan)
            for below, label, _own, kind, line in scan.acquires:
                for h in prefix + list(below):
                    if h == label:
                        if kind == "Lock":
                            self.self_deadlocks.append(
                                (label, scan.path, line, scan.qual)
                            )
                        continue
                    self._add_edge(
                        h, label,
                        f"{os.path.relpath(scan.path, _REPO)}:{line} "
                        f"({scan.qual})",
                        scan.path, line,
                    )
            for held, _own_held, callee, line in scan.calls:
                acquired = self._acq_closure(callee, memo, set())
                for h in prefix + list(held):
                    for label in acquired:
                        if h == label:
                            if self.lock_kinds.get(label) == "Lock":
                                self.self_deadlocks.append(
                                    (label, scan.path, line, scan.qual)
                                )
                            continue
                        self._add_edge(
                            h, label,
                            f"{os.path.relpath(scan.path, _REPO)}:{line} "
                            f"({scan.qual} -> {callee[0]}.{callee[1]})",
                            scan.path, line,
                        )

    def cycles(self) -> List[List[Tuple[str, str]]]:
        """Elementary cycles in the lock graph (SCC-based; each SCC with
        a cycle yields one representative edge list)."""
        adj: Dict[str, set] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
            adj.setdefault(dst, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: set = set()
        stack: List[str] = []
        sccs: List[set] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # iterative Tarjan: the lock graph is small but recursion
            # limits are not worth risking in a CI gate
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = set()
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.add(w)
                        if w == node:
                            break
                    sccs.append(scc)

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        out = []
        for scc in sccs:
            cyclic = len(scc) > 1
            if not cyclic:
                continue
            edges = sorted(
                (s, d) for (s, d) in self.edges
                if s in scc and d in scc
            )
            out.append(edges)
        return out

    # --------------------------------------------------------------- guards

    def _infer_guards(self) -> None:
        """Majority-guard contracts per class attribute. ``__init__`` /
        ``__post_init__`` writes never count; ``*_locked`` (and inferred
        held-only helper) writes count as locked."""
        tallies: Dict[str, Dict[str, dict]] = {}
        for scan in self.scans:
            if scan.owner is None:
                continue
            name = scan.node.name
            if name in ("__init__", "__post_init__"):
                continue
            entry = self.entry_held_of(scan)
            cls = scan.owner.name
            for attr, own_held, _line, _col in scan.writes:
                held = own_held | entry
                slot = tallies.setdefault(cls, {}).setdefault(
                    attr, {"locked": {}, "unlocked": 0}
                )
                if held:
                    lock = sorted(held)[0]
                    slot["locked"][lock] = slot["locked"].get(lock, 0) + 1
                else:
                    slot["unlocked"] += 1
        for cls, attrs in tallies.items():
            for attr, slot in attrs.items():
                if attr in self.classes[cls].locks:
                    continue  # the lock itself is not guarded state
                locked_total = sum(slot["locked"].values())
                if not locked_total or locked_total < slot["unlocked"]:
                    continue
                lock, count = max(
                    slot["locked"].items(), key=lambda kv: (kv[1], kv[0])
                )
                if count * 2 >= locked_total:
                    self.guards.setdefault(cls, {})[attr] = lock

    # ------------------------------------------------------------- findings

    def _suppressed(self, path: str, line: int, rule: str) -> bool:
        rules = self.noqa.get(path, {}).get(line)
        if rules is None:
            return False
        return not rules or rule in rules

    def _finding(self, rule: str, path: str, line: int, col: int,
                 message: str, out: list) -> None:
        if not self._suppressed(path, line, rule):
            out.append(Finding(rule, _SEVERITY[rule], path, line, col,
                               message))

    def findings(self) -> List[Finding]:
        out: List[Finding] = list(self.parse_failures)
        # AF2C001 — lock-order cycles, each edge with its witness path
        for cycle_edges in self.cycles():
            witness = "; ".join(
                f"{src} -> {dst} (acquired at {self.edges[(src, dst)][0]})"
                for src, dst in cycle_edges
            )
            _prov, path, line = self.edges[cycle_edges[0]]
            nodes = sorted({n for e in cycle_edges for n in e})
            self._finding(
                "AF2C001", path, line, 0,
                f"lock-order inversion between {', '.join(nodes)}: "
                f"{witness} — two threads taking these edges in opposite "
                "order deadlock",
                out,
            )
        for label, path, line, qual in getattr(self, "self_deadlocks", []):
            self._finding(
                "AF2C001", path, line, 0,
                f"{label} (a non-reentrant Lock) acquired in {qual} while "
                "already held — self-deadlock",
                out,
            )
        # AF2C002/003 — guard-contract violations on writes
        for scan in self.scans:
            if scan.owner is None:
                continue
            name = scan.node.name
            if name in ("__init__", "__post_init__") or scan.entry_locked:
                continue
            cls = scan.owner.name
            contracts = self.guards.get(cls, {})
            entry = self.entry_held_of(scan)
            for attr, own_held, line, col in scan.writes:
                lock = contracts.get(attr)
                if lock is None:
                    continue
                held = own_held | entry
                if not held:
                    self._finding(
                        "AF2C002", scan.path, line, col,
                        f"{cls}.{attr} is guarded by {cls}.{lock} "
                        f"(majority of writes) but written here with no "
                        "lock held",
                        out,
                    )
                elif lock not in held:
                    self._finding(
                        "AF2C003", scan.path, line, col,
                        f"{cls}.{attr} is guarded by {cls}.{lock} but "
                        f"written under {', '.join(sorted(held))} — mixed "
                        "guards protect nothing",
                        out,
                    )
            # AF2C004 — unlocked iteration of guarded containers
            for attr, own_held, line, col in scan.iter_reads:
                lock = contracts.get(attr)
                if lock is None:
                    continue
                held = own_held | entry
                if lock not in held:
                    self._finding(
                        "AF2C004", scan.path, line, col,
                        f"iterating {cls}.{attr} (guarded by {cls}.{lock}) "
                        "without the lock — concurrent mutation tears the "
                        "traversal; snapshot under the lock first",
                        out,
                    )
        # AF2C005-008 — lifecycle rules
        for scan in self.scans:
            cls_joined: set = set()
            if scan.owner is not None:
                for m in self.scans:
                    if m.owner is scan.owner:
                        cls_joined |= m.joined
            for line, col, daemon_ok, bound in scan.threads:
                if daemon_ok:
                    continue
                joined = (
                    bound is not None
                    and (bound in scan.joined or bound in cls_joined)
                )
                if not joined:
                    self._finding(
                        "AF2C005", scan.path, line, col,
                        "thread created with neither daemon=True nor a "
                        "reachable join"
                        + (f" of {bound!r}" if bound else "")
                        + " — it outlives shutdown",
                        out,
                    )
            if scan.owner is not None and (
                scan.owner.locks
                or any(m.threads for m in self.scans
                       if m.owner is scan.owner)
            ):
                for attr, line, col, kind in scan.queues:
                    self._finding(
                        "AF2C006", scan.path, line, col,
                        f"{scan.owner.name}.{attr} is an unbounded {kind} "
                        "in a threaded class — a producer can outrun every "
                        "consumer; set maxsize/maxlen",
                        out,
                    )
            for line, col, label in scan.naked_waits:
                self._finding(
                    "AF2C007", scan.path, line, col,
                    f"{label}.wait() outside a predicate loop — spurious "
                    "wakeups and missed notifies slip through; use "
                    "`while not pred: cv.wait()` or wait_for",
                    out,
                )
            for line, col, attr, held in scan.observer_calls:
                self._finding(
                    "AF2C008", scan.path, line, col,
                    f"callbacks in self.{attr} invoked while holding "
                    f"{held} — a slow or re-entrant callback stalls or "
                    "deadlocks the owner; snapshot under the lock, call "
                    "outside",
                    out,
                )
        return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


# -------------------------------------------------------------- contracts


def default_paths() -> list:
    return [
        os.path.join(_REPO, "alphafold2_tpu_torch"),
        os.path.join(_REPO, "chip_smoke.py"),
    ]


def build_model(
    paths: Optional[Iterable[str]] = None, gated: str = "env"
) -> RepoModel:
    return RepoModel().scan_paths(
        paths if paths is not None else default_paths(), gated=gated
    )


def compute_contracts(
    model: Optional[RepoModel] = None,
    paths: Optional[Iterable[str]] = None,
) -> dict:
    """The committed shape: named lock-graph edges (with the witness
    acquisition site) + per-class guard map. Gated defects are never part
    of a contract regardless of environment (baseline stability)."""
    if model is None or any(s.gated_env for s in model.scans):
        model = build_model(paths, gated="none")
    return {
        "format": FORMAT_VERSION,
        "lock_graph": {
            f"{src} -> {dst}": prov
            for (src, dst), (prov, _p, _l) in sorted(model.edges.items())
        },
        "guards": {
            cls: dict(sorted(attrs.items()))
            for cls, attrs in sorted(model.guards.items())
        },
    }


def diff_contracts(baseline: dict, current: dict) -> List[str]:
    lines: List[str] = []
    old_edges = baseline.get("lock_graph", {})
    new_edges = current.get("lock_graph", {})
    for edge in sorted(set(new_edges) - set(old_edges)):
        lines.append(f"lock-graph edge added: {edge} ({new_edges[edge]})")
    for edge in sorted(set(old_edges) - set(new_edges)):
        lines.append(f"lock-graph edge removed: {edge}")
    old_guards = baseline.get("guards", {})
    new_guards = current.get("guards", {})
    for cls in sorted(set(new_guards) | set(old_guards)):
        o = old_guards.get(cls, {})
        n = new_guards.get(cls, {})
        for attr in sorted(set(n) - set(o)):
            lines.append(f"guard added: {cls}.{attr} -> {cls}.{n[attr]}")
        for attr in sorted(set(o) - set(n)):
            lines.append(
                f"guard removed: {cls}.{attr} (was {cls}.{o[attr]})"
            )
        for attr in sorted(set(o) & set(n)):
            if o[attr] != n[attr]:
                lines.append(
                    f"guard changed: {cls}.{attr}: {cls}.{o[attr]} -> "
                    f"{cls}.{n[attr]}"
                )
    return lines


def check_against(
    baseline_path: str, current: dict
) -> Tuple[str, List[str]]:
    """-> (verdict, detail lines); verdict in pass | drift |
    stale-baseline | missing-baseline, mirroring graph/hlo contracts."""
    if not os.path.exists(baseline_path):
        return "missing-baseline", [
            f"no baseline at {baseline_path}; record one with --update"
        ]
    with open(baseline_path) as fh:
        baseline = json.load(fh)
    if baseline.get("format") != current.get("format"):
        return "stale-baseline", [
            f"baseline format {baseline.get('format')} != current "
            f"{current.get('format')}; re-record with --update"
        ]
    lines = diff_contracts(baseline, current)
    return ("drift", lines) if lines else ("pass", [])


def write_contracts(path: str, contracts: dict) -> None:
    with open(path, "w") as fh:
        json.dump(contracts, fh, indent=2, sort_keys=True)
        fh.write("\n")


# --------------------------------------------------------------------- CLI


def findings_to_json(findings: List[Finding]) -> str:
    return json.dumps(
        {
            "tool": "af2_concurrency",
            "findings": [f.to_dict() for f in findings],
            "counts": {
                sev: sum(1 for f in findings if f.severity == sev)
                for sev in ("error", "warning")
            },
        },
        indent=2,
    )


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m alphafold2_tpu_torch.analysis.concurrency",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("paths", nargs="*", help="files/dirs to audit "
                        "(default: alphafold2_tpu_torch/, chip_smoke.py)")
    parser.add_argument("--select", help="comma-separated rule ids")
    parser.add_argument("--severity", choices=("error", "warning"))
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--graph", action="store_true",
                        help="print the lock-order graph and exit")
    parser.add_argument("--check", action="store_true",
                        help="diff contracts vs the committed baseline")
    parser.add_argument("--update", action="store_true",
                        help="re-record the baseline")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule} [{_SEVERITY[rule]}] {RULES[rule]}")
        return 0

    paths = args.paths or default_paths()
    model = build_model(paths)

    if args.graph:
        for (src, dst), (prov, _p, _l) in sorted(model.edges.items()):
            print(f"{src} -> {dst}    [{prov}]")
        print(f"{len(model.edges)} edges, "
              f"{len(model.lock_kinds)} lock attributes, "
              f"{sum(len(v) for v in model.guards.values())} guard "
              "contracts")
        return 0

    if args.update:
        contracts = compute_contracts(model, paths)
        verdict, lines = check_against(args.baseline, contracts)
        write_contracts(args.baseline, contracts)
        print(f"concurrency contracts written to {args.baseline} "
              f"({len(contracts['lock_graph'])} edges, "
              f"{sum(len(v) for v in contracts['guards'].values())} "
              "guards)")
        for line in lines:
            print(f"  {line}")
        return 0

    findings = model.findings()
    if args.select:
        wanted = {s.strip().upper() for s in args.select.split(",")}
        findings = [f for f in findings if f.rule in wanted]
    if args.severity:
        findings = [f for f in findings if f.severity == args.severity]

    rc = 0
    if args.json:
        print(findings_to_json(findings))
    else:
        for f in findings:
            print(f.format())
    if findings:
        rc = 1

    if args.check:
        contracts = compute_contracts(model, paths)
        verdict, lines = check_against(args.baseline, contracts)
        print(f"concurrency-contract verdict: {verdict}")
        for line in lines:
            print(f"  concurrency-contract {verdict.upper()}: {line}")
        if verdict == "drift":
            print("  (intentional change? re-record with --update and "
                  "put the diff above in the PR)")
            rc = 1
        elif verdict == "missing-baseline":
            rc = 2
    if not findings and not args.json and not args.check:
        print("concurrency audit clean "
              f"({len(model.edges)} lock-graph edges, "
              f"{sum(len(v) for v in model.guards.values())} guard "
              "contracts)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
