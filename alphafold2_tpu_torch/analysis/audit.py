"""Graph audit of the port (counterpart of
``alphafold2_tpu/analysis/jaxpr_audit.py``).

The linter (:mod:`lint`) sees source; this module sees what runs. It runs
each registered target (:mod:`targets`) under a
``torch.utils._python_dispatch.TorchDispatchMode`` that records every aten
op with its arguments' dtypes and devices, the backward included (the
autograd engine carries the mode to its device threads; each record names
the autograd node that ran it, so a backward that escaped the recorder
would show as missing ``...Backward`` nodes). On the card the wrappers'
CUDA branches run, which the CPU tests never reach; the kernels themselves
are ctypes calls, not aten ops, so the audit sees the tensor work around
them. Rules:

- ``AF2A100`` error — the target fails to build or run.
- ``AF2A101`` error — a float64 or complex128 tensor in or out of any op:
  the port computes in float32 and bfloat16.
- ``AF2A102`` error — a host sync in the hot path: ``aten._local_scalar_dense``
  (``.item()``, ``bool()``/``float()`` of a tensor), ``aten.is_nonzero``,
  ``aten.equal``, a copy from the card to the CPU, or an op whose output
  shape depends on the data (``nonzero``, ``masked_select``, ``unique``).
- ``AF2A103`` error — a tensor built from host data inside the target
  (``aten.lift_fresh``/``lift_fresh_copy``, a CPU-to-card copy) larger than
  the threshold (1 MiB): it belongs in the arguments, made once.
- ``AF2A105`` error — an op whose tensor inputs mix dtypes: bool or
  integer with floating point, or two floating widths (bfloat16 with
  float32). Python scalars and 0-d tensors of the same kind are exempt (JAX
  exempts weak types), as are masks, conditions and indices, and explicit
  conversions (``_to_copy``, ``copy_``).
- ``AF2A106`` error — the Hopper build gate's failures (:mod:`lowering`),
  folded in with ``--rules build``.
- ``AF2A110`` error — on the card, the device memory the target's run
  allocates (``torch.cuda.max_memory_allocated``, its arguments included)
  over the target's ``hbm_budget_bytes`` (:mod:`budgets`).

JAX's ``AF2A104`` (donation) has no PyTorch counterpart; ``AF2A107``–``109``
(the compiled-HLO collective census) wait for parallelism (ROADMAP).
Targets waive rules with a reason (``TraceTarget.allow``).

CLI::

    python -m alphafold2_tpu_torch.analysis.audit [--targets a,b] \\
        [--rules graph,build] [--device cpu|cuda] [--json out.json]

``--device`` defaults to the card, as every entry point of the port does;
without one it is a usage error unless ``--device cpu``. Exit codes: 0
clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

AUDIT_RULES = {
    "AF2A100": ("error", "target fails to run"),
    "AF2A101": ("error", "float64/complex128 tensor"),
    "AF2A102": ("error", "host sync in the hot path"),
    "AF2A103": ("error", "large tensor built from host data"),
    "AF2A105": ("error", "implicit dtype promotion"),
    "AF2A106": ("error", "Hopper build gate failure"),
    "AF2A110": ("error", "device memory over budget"),
}
RULE_SETS = ("graph", "build")
WIDE_DTYPES = (torch.float64, torch.complex128)
DEFAULT_CONST_THRESHOLD = 1 << 20  # 1 MiB of host data per call is a bug
_SYNC_OPS = {"_local_scalar_dense", "is_nonzero", "equal", "nonzero", "masked_select",
             "_unique", "_unique2", "unique_consecutive", "unique_dim"}
_HOST_DATA_OPS = {"lift_fresh", "lift_fresh_copy"}
_COPY_OPS = {"_to_copy", "copy_", "copy", "_copy_from", "_copy_from_and_resize"}
# arguments that select or index rather than take part in the arithmetic
_NON_DATA_ARGS = {"condition", "mask", "index", "indices", "target", "offsets", "repeats",
                  "per_sample_weights", "boundaries", "sorted_sequence"}


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    rule: str
    severity: str
    target: str
    message: str

    def format(self) -> str:
        return f"{self.target}: {self.rule} [{self.severity}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _finding(rule: str, target: str, message: str) -> AuditFinding:
    return AuditFinding(rule, AUDIT_RULES[rule][0], target, message)


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.dirname(os.path.abspath(__file__))


def _port_frame() -> str:
    """``file:line`` of the innermost frame in the port (outside this
    layer) on the current stack, or "" when there is none (a backward
    node run by the autograd engine)."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(_PACKAGE) and not path.startswith(_ANALYSIS):
            return f" at {os.path.relpath(path, os.path.dirname(_PACKAGE))}:{frame.lineno}"
    return ""


def _kind(dtype: torch.dtype) -> int:
    """0 bool, 1 integer, 2 floating, 3 complex."""
    if dtype == torch.bool:
        return 0
    if dtype.is_complex:
        return 3
    return 2 if dtype.is_floating_point else 1


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _data_tensors(func, args, kwargs) -> list:
    """(name, tensor) of the arguments that take part in the arithmetic."""
    out = []
    schema = func._schema.arguments
    named = list(zip((a.name for a in schema), args)) + list(kwargs.items())
    for name, value in named:
        if name in _NON_DATA_ARGS:
            continue
        out += [(name, t) for t in _tensors(value)]
    return out


def promotion_hit(func, args, kwargs) -> Optional[str]:
    """A description of the implicit promotion ``func`` does on these
    arguments, or None."""
    if func.__name__.split(".")[0] in _COPY_OPS:
        return None
    data = _data_tensors(func, args, kwargs)
    if func.__name__.startswith("_foreach_"):
        # element i of each list pairs with element i of the others
        lists = [v for v in list(args) + list(kwargs.values())
                 if isinstance(v, (list, tuple)) and v and isinstance(v[0], torch.Tensor)]
        groups = [[lst[i] for lst in lists if i < len(lst)] for i in range(len(lists[0]))] \
            if lists else []
    else:
        groups = [[t for _, t in data]]
    for group in groups:
        kinds = {_kind(t.dtype) for t in group}
        if 2 in kinds and kinds & {0, 1}:
            names = sorted({str(t.dtype).replace("torch.", "") for t in group})
            return f"{'/'.join(names)} operands (bool or integer with floating point)"
        widths = {t.dtype for t in group if t.dtype.is_floating_point and t.dim() > 0}
        if len(widths) > 1:
            names = sorted(str(d).replace("torch.", "") for d in widths)
            return f"{'/'.join(names)} operands (two floating widths)"
    return None


class OpRecorder(TorchDispatchMode):
    """Records every aten op it sees and the rule hits among them."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.nodes: set = set()  # autograd nodes whose ops were seen
        self.hits: dict = {}  # rule -> {description: count}

    def _hit(self, rule: str, what: str) -> None:
        what += _port_frame()
        counts = self.hits.setdefault(rule, {})
        counts[what] = counts.get(what, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        node = torch._C._current_autograd_node()
        where = ""
        if node is not None:
            self.nodes.add(type(node).__name__)
            where = f" in {type(node).__name__}"
        name = func.__name__.split(".")[0]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in ins + outs:
            if t.dtype in WIDE_DTYPES:
                self._hit("AF2A101", f"{func.__name__}{where} on {t.dtype}")
                break
        if name in _SYNC_OPS:
            self._hit("AF2A102", f"{func.__name__}{where}")
        elif any(t.device.type == "cuda" for t in ins) and any(
                t.device.type == "cpu" for t in outs):
            self._hit("AF2A102", f"{func.__name__}{where} copies from the card to the CPU")
        if name in _HOST_DATA_OPS or (name in _COPY_OPS and any(
                t.device.type == "cpu" for t in ins) and any(
                t.device.type == "cuda" for t in outs)):
            big = [t for t in ins if t.device.type == "cpu"
                   and t.numel() * t.element_size() > DEFAULT_CONST_THRESHOLD]
            if big:
                b = big[0]
                self._hit("AF2A103", f"{func.__name__}{where} of {b.numel() * b.element_size()} "
                                     f"bytes of host data ({str(b.dtype)[6:]}{list(b.shape)})")
        why = promotion_hit(func, args, kwargs)
        if why is not None:
            self._hit("AF2A105", f"{func.__name__}{where}: {why}")
        return out


_MESSAGES = {
    "AF2A101": "the port computes in float32/bfloat16: find the widening",
    "AF2A102": "each is a host round trip per call",
    "AF2A103": "make it once and pass it in",
    "AF2A105": "spell the cast",
}


@dataclasses.dataclass
class TargetReport:
    """What one target's run showed: findings (after waivers), the
    waived ones, the op count, the autograd nodes seen, and the memory
    verdict."""

    target: str
    device: str
    findings: list
    waived: list
    ops: int = 0
    nodes: tuple = ()
    budget: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["findings"] = [f.to_dict() for f in self.findings]
        d["waived"] = [f.to_dict() for f in self.waived]
        return d


def audit_target(target, device) -> TargetReport:
    """Build and run one target under the recorder; every rule, honouring
    its waivers."""
    from alphafold2_tpu_torch.analysis.budgets import check_budget

    device = torch.device(device)
    name = target.name
    on_card = device.type == "cuda"
    base = 0
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    try:
        fn, args = target.build(device)
    except Exception as e:  # noqa: BLE001 — an unbuildable target is a finding
        return TargetReport(name, str(device), [_finding(
            "AF2A100", name, f"target build failed: {type(e).__name__}: {str(e)[:300]}")], [])
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec = OpRecorder()
    findings = []
    try:
        with rec:
            fn(*args)
    except Exception as e:  # noqa: BLE001 — a target that fails to run is a finding
        findings.append(_finding("AF2A100", name,
                                 f"target failed: {type(e).__name__}: {str(e)[:300]}"))
    budget = None
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        budget = check_budget(peak, target.hbm_budget_bytes)
        if budget["verdict"] == "over-budget":
            findings.append(_finding(
                "AF2A110", name, f"the run allocates {peak} bytes of device memory, over its "
                                 f"budget of {target.hbm_budget_bytes}"))
    else:
        budget = check_budget(None, target.hbm_budget_bytes)
    for rule in sorted(rec.hits):
        for what, count in sorted(rec.hits[rule].items()):
            findings.append(_finding(rule, name, f"{what} ({count}x): {_MESSAGES[rule]}"))
    waived = [f for f in findings if f.rule in target.allow]
    kept = [f for f in findings if f.rule not in target.allow]
    return TargetReport(name, str(device), kept, waived, rec.ops, tuple(sorted(rec.nodes)),
                        budget)


def audit(targets=None, device="cpu") -> list:
    """A :class:`TargetReport` per target (default: every registered one)."""
    from alphafold2_tpu_torch.analysis.targets import default_targets

    targets = targets if targets is not None else default_targets()
    return [audit_target(t, device) for t in targets]


def build_findings(case_names=None) -> list:
    """Run the Hopper build gate (:mod:`lowering`) and turn its failures
    into AF2A106 findings: a failed case, a control that was not refused,
    or a gate that could not run at all (no nvcc). A refusal to certify
    never reads as clean."""
    from alphafold2_tpu_torch.analysis import lowering

    try:
        records, summary = lowering.run_gate(tuple(case_names or ()))
    except lowering.ToolMissing as e:
        return [_finding("AF2A106", "hopper_build", f"the gate cannot run: {e}")]
    findings = []
    for rec in records:
        if rec["status"] != "failed":
            continue
        problems = [p for launch in rec.get("launches", ()) for p in launch["problems"]]
        detail = "; ".join(problems[:3]) or rec.get("error", "?")
        findings.append(_finding("AF2A106", rec["case"], f"build gate: {detail[:300]}"))
    return findings


def findings_to_json(findings: list, reports: list) -> str:
    return json.dumps({
        "tool": "audit",
        "findings": [f.to_dict() for f in findings],
        "targets": [r.to_dict() for r in reports],
        "counts": {sev: sum(1 for f in findings if f.severity == sev)
                   for sev in ("error", "warning")},
    }, indent=2)


def main(argv=None) -> int:
    from alphafold2_tpu_torch.analysis.targets import default_targets, target_by_name
    from alphafold2_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m alphafold2_tpu_torch.analysis.audit",
        description="graph audit of the port; exit 0 clean, 1 findings, 2 usage error")
    parser.add_argument("--targets", default=None,
                        help="comma-separated target names (default: all registered)")
    parser.add_argument("--rules", default="graph",
                        help="comma-separated rule sets: graph, build (default: graph)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--json", dest="json_path", default=None)
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    rule_sets = {s.strip() for s in args.rules.split(",") if s.strip()}
    unknown = rule_sets - set(RULE_SETS)
    if unknown:
        print(f"unknown rule set(s): {sorted(unknown)}")
        return 2
    reports: list = []
    findings: list = []
    if "graph" in rule_sets:
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"audit: {e}")
            return 2
        try:
            targets = ([target_by_name(n.strip()) for n in args.targets.split(",") if n.strip()]
                       if args.targets else default_targets())
        except KeyError as e:
            print(str(e))
            return 2
        reports = audit(targets, device)
        for r in reports:
            findings.extend(r.findings)
            for w in r.waived:
                print(f"waived: {w.format()}")
    if "build" in rule_sets:
        findings.extend(build_findings())

    for f in findings:
        print(f.format())
    if args.json_path:
        with open(args.json_path, "w", encoding="utf-8") as fh:
            fh.write(findings_to_json(findings, reports))
    print(f"audit: {len(findings)} finding(s) over rule sets {sorted(rule_sets)}"
          + (f" on {reports[0].device}" if reports else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
