"""Collective audit: static comm and memory contracts of the sharded serving
targets.

Counterpart of ``alphafold2_tpu/analysis/hlo_audit.py``, under its name so a
reader finds it. JAX audits the optimized HLO that GSPMD partitioned, where
the collectives XLA inserted live. The port has no compiled program: it
runs eagerly on SPMD ranks, and every cross-rank step goes through
``parallel/sharding.py``'s wrappers, which record ``(op, mesh axis,
bytes)`` into a census. So the port audits the eager program's
collectives: each audited target of ``analysis/targets.py`` (JAX's
``hlo=True`` set: ``model_fwd``, ``serve_fwd``, ``serve_fwd_bf16``, and the
sharded ``serve_fwd_grid`` and ``serve_fwd_long``) runs once on every rank
of a process group, and rank 0's census becomes the target's record. On the
CPU the ranks are gloo processes this module spawns (``--world``, 4 by
default); on the card an NCCL world (one rank on a one-card machine, every
collective in place), or the ranks ``torchrun`` started.

Rules (JAX's ids):

- **AF2A107** — drift against the committed
  ``alphafold2_tpu_torch/analysis/hlo_contracts.json`` (the root
  ``hlo_contracts.json`` is the JAX package's): any collective appearing,
  disappearing or changing its count or bytes, the pair state or the budget
  verdict. The baseline is keyed by torch version, world size and platform;
  another key reports ``stale-baseline`` loudly with rc 0, a missing
  baseline rc 2, as ``analysis/contracts.py``.
- **AF2A108** — on a mesh of more than one sequence rank, a "sharded"
  target whose rank held the whole pair grid (``N^2``), that moved no
  collective at all, or whose single collective over the sequence axes
  moved at least the whole pair grid of its batch slice.
- **AF2A109** — a collective in a target declared single-device.
- **AF2A110** — a rank's peak device memory over the target's
  ``hbm_budget_bytes`` (``analysis/budgets.py check_budget``): measured on
  the card, "no-data" on the CPU. A sharded target's budget is JAX's, per
  device of its sharded layout (``budget_seq_ranks``); on fewer sequence
  ranks (the card's world of one) it is scaled by the missing shards, so
  the verdict is measured there too.

``AF2TPU_AUDIT_DROP_SHARD_PAIR`` set (``parallel/sharding.py``) replicates the
pair state at every layer boundary: ``--check`` must then fire AF2A107 and
AF2A108. CLI::

    python -m alphafold2_tpu_torch.analysis.hlo_audit --check --device cpu
    python -m alphafold2_tpu_torch.analysis.hlo_audit --update --device cpu
    python -m alphafold2_tpu_torch.analysis.hlo_audit --check            # the card

Exit codes: 0 clean (or a stale baseline, loudly), 1 findings or drift, 2 a
missing baseline or a usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import torch

from alphafold2_tpu_torch.analysis.audit import AuditFinding
from alphafold2_tpu_torch.analysis.budgets import check_rank_budget, format_budget

FORMAT_VERSION = 1
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "hlo_contracts.json")
AUDITED = ("model_fwd", "serve_fwd", "serve_fwd_bf16", "serve_fwd_grid", "serve_fwd_long")
SEQ_AXES = ("sp", "spr", "spc", "seq")
DEFAULT_BLOWUP_BYTES = 1 << 30  # no audit target moves a GiB in one collective
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _finding(rule: str, target: str, message: str) -> AuditFinding:
    return AuditFinding(rule, "error", target, message)


def audited_targets(names=None) -> list:
    from alphafold2_tpu_torch.analysis.targets import default_targets

    names = AUDITED if names is None else names
    return [t for t in default_targets() if t.name in names]


# ------------------------------------------------------------- recording


def target_record(target, device) -> dict:
    """Run one target on this rank under the census: its record (every rank
    of the group must call this together for a sharded target)."""
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import sharding

    device = torch.device(device)
    on_card = device.type == "cuda"
    fn, args = target.build(device)
    base = 0
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    sharding.reset_census()
    fn(*args)
    found = sharding.census()
    peak = None
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
    pair = found.pop("pair_state", None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh_desc = getattr(fn, "mesh_desc", None)
    seq_ranks = int(getattr(fn, "seq_ranks", 1)) if target.sharded else 1
    budget = check_rank_budget(peak, target.hbm_budget_bytes, seq_ranks,
                               target.budget_seq_ranks)
    return {
        "sharded": bool(target.sharded),
        "mesh": mesh_desc if target.sharded else None,
        "seq_ranks": seq_ranks,
        "world": world,
        "collectives": found,
        "collective_count": int(sum(v["count"] for v in found.values())),
        "comm_bytes": int(sum(v["bytes"] for v in found.values())),
        "pair_state": pair,
        "program_bytes": peak,
        "hbm_budget_bytes": target.hbm_budget_bytes,
        "budget": budget,
    }


def audit_record(name: str, rec: dict) -> list:
    """The baseline-free rules over one record: AF2A108, AF2A109, AF2A110."""
    findings = []
    kinds = ", ".join(f"{k} x{v['count']}" for k, v in rec.get("collectives", {}).items())
    if not rec.get("sharded") and rec.get("collective_count"):
        findings.append(_finding(
            "AF2A109", name, f"declared single-device but it ran "
                             f"{rec['collective_count']} collective(s): {kinds}"))
    pair = rec.get("pair_state") or {}
    whole = pair.get("whole_bytes") or 0
    if rec.get("sharded") and rec.get("seq_ranks", 1) > 1:
        if not rec.get("collective_count"):
            findings.append(_finding(
                "AF2A108", name, f"declared sharded over {rec['seq_ranks']} sequence ranks, "
                                 "yet it ran no collective: every rank holds the whole state"))
        if whole and pair.get("held_bytes", 0) >= whole:
            findings.append(_finding(
                "AF2A108", name, f"a rank held {pair['held_bytes']} bytes of pair state, the "
                                 f"whole N^2 grid ({whole} bytes): the pair state is replicated"))
        limit = min(whole or DEFAULT_BLOWUP_BYTES, rec.get("hbm_budget_bytes")
                    or DEFAULT_BLOWUP_BYTES)
        for key, v in rec.get("collectives", {}).items():
            if key.split("@")[-1] in SEQ_AXES and v.get("max_bytes", 0) >= limit:
                findings.append(_finding(
                    "AF2A108", name, f"one {key} moved {v['max_bytes']} bytes (>= {limit}, the "
                                     "whole pair grid): a replicated-operand blowup"))
    if rec.get("budget", {}).get("verdict") == "over-budget":
        findings.append(_finding("AF2A110", name, "per-rank peak over the declared budget: "
                                 + format_budget(name, rec["budget"])))
    return findings


def compute_doc(targets, device) -> Optional[dict]:
    """Every target's record on this rank of the initialised group; the
    document on rank 0, None on the others."""
    import torch.distributed as dist

    world = dist.get_world_size()
    doc = {
        "format": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "world": world,
        "platform": torch.device(device).type,
        "targets": {},
    }
    for target in targets:
        doc["targets"][target.name] = target_record(target, device)
    dist.barrier()
    return doc if dist.get_rank() == 0 else None


def _rank_main(args) -> int:
    """One spawned rank: join the group, compute, rank 0 writes the doc."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(args.rank % max(1, torch.cuda.device_count()))
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world)
    try:
        names = args.targets.split(",") if args.targets else None
        device = "cpu" if cpu else torch.device("cuda", torch.cuda.current_device())
        doc = compute_doc(audited_targets(names), device)
        if doc is not None:
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_doc(world: int, device: str, targets: Optional[str] = None,
              timeout: float = 600.0) -> dict:
    """Start ``world`` ranks of this module (gloo on the CPU, NCCL on the
    card), each running every audited target; returns rank 0's document.
    Raises with the failing rank's output if any rank fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "doc.json")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        cmd = [sys.executable, "-m", "alphafold2_tpu_torch.analysis.hlo_audit", "--_rank"]
        tail = ["--_world", str(world), "--_store", os.path.join(tmp, "store"), "--_out", out,
                "--device", device] + (["--targets", targets] if targets else [])
        procs = [subprocess.Popen(cmd + [str(r)] + tail, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log) for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        if bad:
            r, code, log = bad[0]
            raise RuntimeError(f"audit rank {r} exited {code}:\n{log[-3000:]}")
        with open(out, encoding="utf-8") as fh:
            return json.load(fh)


# ------------------------------------------------------------ contracts


_DRIFT_FIELDS = ("sharded", "mesh", "seq_ranks", "comm_bytes", "pair_state", "program_bytes")


def _diff_record(name: str, base: dict, cur: dict) -> list:
    lines = []
    bc, cc = base.get("collectives", {}), cur.get("collectives", {})
    zero = {"count": 0, "bytes": 0}
    for key in sorted(set(bc) | set(cc)):
        b, c = bc.get(key, zero), cc.get(key, zero)
        for field in ("count", "bytes"):
            if b[field] != c[field]:
                lines.append(f"{name}: {key} {field} drift: {b[field]} -> {c[field]} "
                             f"({c[field] - b[field]:+d})")
    for field in _DRIFT_FIELDS:
        if base.get(field) != cur.get(field):
            lines.append(f"{name}: {field} drift: {base.get(field)} -> {cur.get(field)}")
    bv = base.get("budget", {}).get("verdict")
    cv = cur.get("budget", {}).get("verdict")
    if bv != cv:
        lines.append(f"{name}: budget verdict drift: {bv} -> {cv}")
    return lines


def diff_docs(baseline: dict, current: dict, subset: bool = False) -> list:
    """Exact drift lines between two documents; ``subset`` restricts them to
    the targets ``current`` holds (a ``--targets`` run)."""
    bt, ct = baseline.get("targets", {}), current.get("targets", {})
    lines = []
    for name in sorted(set(ct) if subset else set(bt) | set(ct)):
        if name not in bt:
            lines.append(f"{name}: NEW TARGET (not in baseline) — re-baseline with --update "
                         "after review")
        elif name not in ct:
            lines.append(f"{name}: missing from the current audit")
        else:
            lines.extend(_diff_record(name, bt[name], ct[name]))
    return lines


def check_against(baseline_path: str, current: dict, subset: bool = False) -> dict:
    """``missing-baseline``, ``stale-baseline`` (format, torch version,
    world or platform changed: loud, not failing), ``drift`` or ``pass``."""
    if not os.path.exists(baseline_path):
        return {"verdict": "missing-baseline",
                "reason": f"no baseline at {baseline_path}; run --update"}
    with open(baseline_path, encoding="utf-8") as fh:
        baseline = json.load(fh)
    for key in ("format", "torch_version", "world", "platform"):
        if baseline.get(key) != current.get(key):
            return {"verdict": "stale-baseline",
                    "reason": f"RECOMPILE KEY {key}: baseline {baseline.get(key)!r} vs "
                              f"current {current.get(key)!r}; re-baseline with --update"}
    drift = diff_docs(baseline, current, subset=subset)
    return {"verdict": "drift" if drift else "pass", "drift": drift}


def findings_of(doc: dict) -> list:
    out = []
    for name, rec in doc["targets"].items():
        out.extend(audit_record(name, rec))
    return out


# --------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="audit and diff against the committed baseline")
    mode.add_argument("--update", action="store_true",
                      help="audit and rewrite the baseline (a reviewed re-baseline)")
    mode.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--_world", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--_store", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--_out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    parser.add_argument("--targets", default=None,
                        help=f"comma-separated subset of {','.join(AUDITED)}")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="cpu: gloo ranks; default: the card (NCCL)")
    parser.add_argument("--world", type=int, default=None,
                        help="ranks to spawn (default 4 on the CPU, 1 on the card)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the document, the check and the findings here")
    args = parser.parse_args(argv)
    if args._rank is not None:
        args.rank, args.world, args.store, args.out = (args._rank, args._world, args._store,
                                                       args._out)
        args.device = args.device or "cuda"
        return _rank_main(args)
    if not (args.check or args.update):
        parser.print_usage(sys.stderr)
        return 2
    device = args.device or "cuda"
    if device == "cuda":
        from alphafold2_tpu_torch.device import resolve_device

        try:
            resolve_device(None)
        except RuntimeError:
            print("no CUDA device: pass --device cpu for gloo ranks on the CPU",
                  file=sys.stderr)
            return 2
    subset = None
    if args.targets:
        subset = [s.strip() for s in args.targets.split(",") if s.strip()]
        unknown = set(subset) - set(AUDITED)
        if unknown:
            print(f"unknown target(s): {sorted(unknown)}; known: {list(AUDITED)}",
                  file=sys.stderr)
            return 2
    import torch.distributed as dist

    if dist.is_initialized():  # ranks torchrun started
        doc = compute_doc(audited_targets(subset), device)
        if doc is None:
            return 0
    else:
        world = args.world or (4 if device == "cpu" else 1)
        doc = spawn_doc(world, device, ",".join(subset) if subset else None)
    findings = findings_of(doc)
    check = None
    if args.update:
        if findings:
            print(f"hlo-contracts: REFUSING to baseline a surface with {len(findings)} "
                  "structural finding(s)")
        else:
            with open(args.baseline, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=2, sort_keys=True)
                fh.write("\n")
            print(f"hlo-contracts: wrote {args.baseline} ({len(doc['targets'])} targets, "
                  f"world={doc['world']})")
    else:
        check = check_against(args.baseline, doc, subset=subset is not None)
        for line in check.get("drift", []):
            print(f"hlo-contract DRIFT: {line}")
        if check["verdict"] == "drift":
            findings.append(_finding(
                "AF2A107", "hlo_contracts",
                f"{len(check['drift'])} contract drift line(s) vs "
                f"{os.path.basename(args.baseline)}; intended? re-baseline with --update"))
        elif check["verdict"] == "missing-baseline":
            findings.append(_finding("AF2A107", "hlo_gate", check["reason"]))
        elif check["verdict"] == "stale-baseline":
            print(f"hlo-contracts: STALE BASELINE — {check['reason']}")
    for f in findings:
        print(f.format())
    summary = {"gate": "hlo",
               "verdict": (check["verdict"] if check is not None
                           else ("fail" if findings else "updated")),
               "n_targets": len(doc["targets"]), "world": doc["world"],
               "findings": [f.to_dict() for f in findings]}
    print(json.dumps(summary))
    if args.json_path:
        with open(args.json_path, "w", encoding="utf-8") as fh:
            json.dump({"doc": doc, "check": check, "summary": summary}, fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
    if check is not None and check["verdict"] == "missing-baseline":
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
