"""Graph contracts of the port: an exact op census of each audited target,
committed and diffed.

Counterpart of ``alphafold2_tpu/analysis/contracts.py``. JAX fingerprints
each registered executable's jaxpr; eager PyTorch has none, so the port's
fingerprint is what one run of the target dispatches: every aten op by
overload name with its count (through ``analysis/audit.py``'s
``OpRecorder``, the backward included; not ``UNCOUNTED_OPS``), the flat
input signature and the outputs' shapes and dtypes. Each target of
``analysis/targets.py`` runs on the CPU at the registry's tiny shapes (the
sharded ones on a world of one rank). The census is committed as
``alphafold2_tpu_torch/analysis/graph_contracts.json`` (the root
``graph_contracts.json`` is the JAX package's). Silent graph growth (a
pass run twice, a new copy, a dtype conversion) or a changed call
signature then fails ``--check`` with a per-op diff.

The census is exact, not thresholded: one torch version dispatches a run
the same way each time, so any drift is either intended (re-baseline with
``--update`` and show the diff in review) or a regression. Baselines are
keyed by ``torch.__version__``; another version reports ``stale-baseline``
(rc 0, loudly), as JAX's does for a jax version. CLI::

    python -m alphafold2_tpu_torch.analysis.contracts --check
    python -m alphafold2_tpu_torch.analysis.contracts --update

Exit codes for ``--check``: 0 the contracts hold (or the baseline is
stale), 1 drift, 2 a missing baseline.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

FORMAT_VERSION = 1

# a Python constant made a tensor counts once per cache fill, not once per
# run (the port caches such tensors a device): the census leaves these out,
# and the audit's AF2A103 holds their size
UNCOUNTED_OPS = ("lift_fresh.default", "lift_fresh_copy.default")

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "graph_contracts.json")


# ------------------------------------------------------------ fingerprints


def signature(x) -> list:
    """A flat description of a value's leaves: ``"float32[2, 16]"`` a
    tensor, the class name of a module (with its parameter count) or of
    any other object, the value of a number, string, bool or None;
    containers and dataclasses are walked in order (dict keys sorted)."""
    out: list = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}")
        elif isinstance(v, torch.nn.Module):
            out.append(f"{type(v).__name__}({sum(p.numel() for p in v.parameters())})")
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        elif v is None or isinstance(v, (bool, int, float, str)):
            out.append(repr(v))
        else:
            out.append(type(v).__name__)

    walk(x)
    return out


def fingerprint_target(target) -> dict:
    """One target's census: built and run once on the CPU under the op
    recorder."""
    from alphafold2_tpu_torch.analysis.audit import OpRecorder

    device = torch.device("cpu")
    with target.run_scope(device):
        fn, args = target.build(device)
        inputs = signature(args)
        rec = OpRecorder()
        with rec:
            out = fn(*args)
    ops = {k: v for k, v in sorted(rec.op_counts.items()) if k not in UNCOUNTED_OPS}
    return {
        "ops": ops,
        "n_ops": sum(ops.values()),
        "inputs": inputs,
        "outputs": signature(out),
    }


def compute_contracts(targets=None) -> dict:
    from alphafold2_tpu_torch.analysis.targets import default_targets

    targets = targets if targets is not None else default_targets()
    return {
        "format": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "targets": {t.name: fingerprint_target(t) for t in targets},
    }


# -------------------------------------------------------------------- diff


def _diff_ops(name: str, old: dict, new: dict) -> list:
    lines = []
    for op in sorted(set(old) | set(new)):
        a, b = old.get(op, 0), new.get(op, 0)
        if a != b:
            lines.append(f"{name}: op count drift: {op}: {a} -> {b} ({b - a:+d})")
    return lines


def diff_contracts(baseline: dict, current: dict) -> list:
    """Readable drift lines between two contract documents (empty: the
    contracts hold)."""
    lines: list = []
    base_t = baseline.get("targets", {})
    cur_t = current.get("targets", {})
    for name in sorted(set(base_t) - set(cur_t)):
        lines.append(f"{name}: target removed (was under contract)")
    for name in sorted(set(cur_t) - set(base_t)):
        lines.append(f"{name}: new target (no committed contract)")
    for name in sorted(set(base_t) & set(cur_t)):
        old, new = base_t[name], cur_t[name]
        if old.get("inputs") != new.get("inputs"):
            lines.append(f"{name}: input signature changed: {old.get('inputs')} -> "
                         f"{new.get('inputs')}")
        lines.extend(_diff_ops(name, old.get("ops", {}), new.get("ops", {})))
        for field in ("n_ops", "outputs"):
            if old.get(field) != new.get(field):
                lines.append(f"{name}: {field}: {old.get(field)} -> {new.get(field)}")
    return lines


def check_against(baseline_path: str = DEFAULT_BASELINE, targets=None) -> dict:
    """``{"verdict": "pass"|"drift"|"stale-baseline"|"missing-baseline",
    ...}``; a baseline of another torch version is stale before anything
    runs."""
    if not os.path.exists(baseline_path):
        return {"verdict": "missing-baseline", "baseline": baseline_path,
                "reason": "no committed graph_contracts.json; run --update"}
    with open(baseline_path, "r", encoding="utf-8") as fh:
        baseline = json.load(fh)
    out = {"baseline": baseline_path, "baseline_torch": baseline.get("torch_version"),
           "current_torch": torch.__version__}
    if baseline.get("torch_version") != torch.__version__:
        return {**out, "verdict": "stale-baseline",
                "reason": (f"baseline recorded under torch {baseline.get('torch_version')}, "
                           f"running {torch.__version__}; re-baseline with --update")}
    current = compute_contracts(targets)
    diffs = diff_contracts(baseline, current)
    return {**out, "verdict": "drift" if diffs else "pass", "diffs": diffs,
            "current": current}


def write_contracts(path: str, contracts: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(contracts, fh, indent=2, sort_keys=True)
        fh.write("\n")


# --------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m alphafold2_tpu_torch.analysis.contracts",
                                     description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true",
                      help="diff the current census against the committed baseline")
    mode.add_argument("--update", action="store_true",
                      help="recompute the census and rewrite the baseline")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the structured verdict (or contracts) to this path")
    args = parser.parse_args(argv)

    if args.update:
        contracts = compute_contracts()
        write_contracts(args.baseline, contracts)
        print(f"graph_contracts: baselined {len(contracts['targets'])} target(s) under "
              f"torch {contracts['torch_version']} -> {args.baseline}")
        if args.json_path:
            write_contracts(args.json_path, contracts)
        return 0

    result = check_against(args.baseline)
    if args.json_path:
        write_contracts(args.json_path, result)
    for line in result.get("diffs", []):
        print(f"graph-contract DRIFT: {line}")
    print(f"graph_contracts: verdict={result['verdict']}"
          + (f" ({result['reason']})" if result.get("reason") else ""))
    if result["verdict"] == "missing-baseline":
        return 2
    return 1 if result["verdict"] == "drift" else 0


if __name__ == "__main__":
    sys.exit(main())
