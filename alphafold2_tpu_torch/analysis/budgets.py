"""Device-memory budgets and verdicts for the audited targets.

Counterpart of ``alphafold2_tpu/analysis/budgets.py`` (:37-101). Each
audited target (``analysis/targets.py``) may declare ``hbm_budget_bytes``;
the audit measures, on the card, the peak device memory the target's run
allocates (``torch.cuda.max_memory_allocated`` over the target, its
arguments included) and :func:`check_budget` turns the pair into a verdict:

- ``pass``        — measured and within budget (headroom reported);
- ``over-budget`` — measured and over: rule ``AF2A110`` fails the audit;
- ``no-data``     — no declared budget, or no device figure (the CPU): the
                    gate does not fail, but the verdict says it was not
                    measured rather than that it fits.

:func:`lattice_report` (JAX's :103-180) holds a live ``ServeEngine`` to the
same contract: every (bucket, batch) rung its ladder admits, at the padded
batch ``warmup`` uses, with the footprint its compile record carries (the
counted warm run's ``peak_bytes`` over its start, plus the engine's
parameters) gated against a fraction of the card's memory. A rung already
warmed is read from ``compile_records``, not run again. CLI::

    python -m alphafold2_tpu_torch.analysis.budgets [--device cpu] [section.field=value ...]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

# Published device memory of the card the port runs on; the card's own
# ``total_memory`` wins at run time.
DEVICE_HBM_BYTES = {
    "H100 80GB HBM3": 80 << 30,
}


# the share of the card's memory a serving lattice may plan to; the rest is
# the allocator's and the runtime's headroom (JAX's constant)
DEFAULT_HBM_FRACTION = 0.9


def device_hbm_bytes(device=None) -> Optional[int]:
    """Device memory of ``device`` (a CUDA device): the card's reported
    ``total_memory``, else the table by name; None on the CPU."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    if props.total_memory:
        return int(props.total_memory)
    return next((v for k, v in DEVICE_HBM_BYTES.items() if k in props.name), None)


def check_budget(program_bytes: Optional[int], budget_bytes: Optional[int]) -> dict:
    """Gate a measured footprint against a declared budget. Returns
    ``{"verdict", "program_bytes", "budget_bytes", ...}`` with
    ``headroom_frac`` (fraction of the budget still free; negative when
    over) on measured verdicts and a ``reason`` on no-data ones. Never
    raises: the verdict is the error channel."""
    rec = {
        "program_bytes": int(program_bytes) if program_bytes else None,
        "budget_bytes": int(budget_bytes) if budget_bytes else None,
    }
    if not budget_bytes:
        rec.update(verdict="no-data", reason="no declared memory budget")
        return rec
    if not program_bytes:
        rec.update(verdict="no-data", reason="no device memory figure (not run on a card)")
        return rec
    rec["headroom_frac"] = round(1.0 - program_bytes / budget_bytes, 4)
    rec["verdict"] = "pass" if program_bytes <= budget_bytes else "over-budget"
    return rec


def check_rank_budget(program_bytes: Optional[int], budget_bytes: Optional[int],
                      seq_ranks: int, budget_seq_ranks: int = 1) -> dict:
    """:func:`check_budget` for one rank of a target whose declared budget
    is per rank of a layout sharded over ``budget_seq_ranks`` sequence
    ranks (JAX's sharded targets: their CPU mesh's). On fewer sequence
    ranks a rank holds that many times more of the pair state, so the
    budget is scaled by the missing shards, ``budget_bytes *
    budget_seq_ranks / seq_ranks``; the record then keeps the declared
    figure as ``declared_budget_bytes``. On as many ranks or more the
    declared budget holds as it is."""
    scaled = budget_bytes
    if budget_bytes and seq_ranks < budget_seq_ranks:
        scaled = budget_bytes * budget_seq_ranks // max(seq_ranks, 1)
    rec = check_budget(program_bytes, scaled)
    if scaled != budget_bytes:
        rec.update(declared_budget_bytes=int(budget_bytes),
                   budget_seq_ranks=int(budget_seq_ranks), seq_ranks=int(seq_ranks))
    return rec


def format_budget(name: str, rec: dict) -> str:
    """One line a verdict (JAX's wording)."""
    pb, bb = rec.get("program_bytes"), rec.get("budget_bytes")
    if rec["verdict"] == "no-data":
        return f"{name}: no-data ({rec.get('reason', '?')})"
    frac = rec.get("headroom_frac", 0.0)
    return f"{name}: {rec['verdict']} — {pb} / {bb} bytes per device ({frac:+.1%} headroom)"


def _rung_record(engine, bucket: int, batch: int) -> dict:
    """The compile record of one rung, warming it first when the engine has
    not run it yet."""
    def find():
        return next((r for r in engine.compile_records
                     if r["bucket"] == bucket and r["batch"] == batch), None)

    rec = find()
    if rec is None:
        with engine._device_scope():
            engine._get_executable(bucket, batch)
        rec = find()
    return rec


def lattice_report(engine, hbm_bytes: Optional[int] = None,
                   hbm_fraction: float = DEFAULT_HBM_FRACTION) -> dict:
    """Gate every rung of a ``ServeEngine``'s ladder against
    ``hbm_fraction`` of the card's memory (or ``hbm_bytes``). Returns
    ``{"mesh", "hbm_budget_bytes", "rungs": [...], "verdict"}``; a rung
    holds its ``bucket``, ``batch`` (a long rung's ``serve.long_max_batch``,
    rounded up to the mesh's dp multiple), ``peak_bytes`` (the warm run's
    peak over its start on this rank, on the card), ``param_bytes``,
    ``flops``, ``collectives`` and ``comm_bytes``: the collectives this
    rank's warm run made (``parallel/sharding.py``'s census; none without a
    mesh) and their bytes, and its ``budget`` over ``program_bytes`` = peak
    + parameters, per rank. On a mesh only rank 0 holds the records the
    report reads. The overall verdict is over-budget if any rung is, pass
    if every rung passes, else no-data."""
    if hbm_bytes is None:
        raw = device_hbm_bytes(engine.device)
        hbm_bytes = int(raw * hbm_fraction) if raw else None
    param_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    rungs = []
    for bucket in engine.buckets:
        batch = engine._padded_batch(bucket, 1)  # warmup's geometry
        rec = _rung_record(engine, bucket, batch)
        peak = rec.get("peak_bytes")
        rungs.append({
            "bucket": int(bucket),
            "batch": int(batch),
            **({"peak_bytes": int(peak)} if peak is not None else {}),
            "param_bytes": int(param_bytes),
            "flops": rec.get("flops"),
            "collectives": dict(rec.get("collectives", {})),
            "comm_bytes": int(sum(v["bytes"] for v in rec.get("collectives", {}).values())),
            "budget": check_budget(peak + param_bytes if peak is not None else None, hbm_bytes),
        })
    verdicts = {r["budget"]["verdict"] for r in rungs}
    overall = ("over-budget" if "over-budget" in verdicts
               else "pass" if verdicts == {"pass"} else "no-data")
    return {"mesh": engine.mesh_desc, "hbm_budget_bytes": hbm_bytes, "rungs": rungs,
            "verdict": overall}


def main(argv=None) -> int:
    """Build a serving engine from ``section.field=value`` overrides, report
    its lattice; exit 1 when a rung is over budget."""
    from alphafold2_tpu_torch.config import Config, parse_cli
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    ap = argparse.ArgumentParser(prog="python -m alphafold2_tpu_torch.analysis.budgets",
                                 description="the serving lattice's memory verdicts")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("overrides", nargs="*", help="config overrides section.field=value")
    args = ap.parse_args(argv)
    engine = ServeEngine(parse_cli(args.overrides, Config()), device=args.device)
    try:
        report = lattice_report(engine)
    finally:
        engine.close()
    for rung in report["rungs"]:
        print(format_budget(f"bucket {rung['bucket']} x batch {rung['batch']}", rung["budget"]))
    print(f"lattice: {report['verdict']} (budget {report['hbm_budget_bytes']} bytes)")
    return 1 if report["verdict"] == "over-budget" else 0


if __name__ == "__main__":
    sys.exit(main())
