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
"""

from __future__ import annotations

from typing import Optional

import torch

# Published device memory of the card the port runs on; the card's own
# ``total_memory`` wins at run time.
DEVICE_HBM_BYTES = {
    "H100 80GB HBM3": 80 << 30,
}


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
