"""FLOPs and peak-memory accounting of a serving forward, and MFU.

The port's counterpart of ``alphafold2_tpu/observe/flops.py``. JAX reads
one number per compiled executable from XLA's ``cost_analysis()``; eager
PyTorch compiles nothing, so the port counts one run of the forward
(:func:`count_forward`) in two parts:

- ``torch.utils.flop_counter.FlopCounterMode`` counts every PyTorch op of
  the run (matmuls, convolutions; elementwise ops count zero, as XLA's
  matmul-dominated totals nearly do). Its dispatch mode belongs to the
  counting thread, so another replica's forward running at the same time
  on another thread is not counted.
- The hand-written kernels launch through ``ctypes`` and are invisible to
  that mode. Each K1/K2 wrapper adds its analytic count (Q·Kᵀ and P·V,
  ``ops.cuda.axial.attention_flops``, ``ops.cuda.tied_row.tied_row_flops``)
  to the thread's open ``ops.cuda.build.flop_tally`` where it launches.
  On the CPU the wrappers run their plain versions, which the mode counts
  instead, to the same total. The kernel policy's library routes
  (``ops/kernels.py``: ``stock``, ``on``, ``splash``) run PyTorch's
  ``scaled_dot_product_attention``, which the mode counts on the card
  (its CUDA attention ops carry formulas) and, through
  :data:`CPU_SDPA_FLOPS`, on the CPU; the plain routes are matmuls it
  counts. So every policy counts the same Q·Kᵀ and P·V work.

:func:`executable_costs` and :func:`executable_memory` read a counted run
as JAX's read a compiled executable: ``flops`` (``bytes_accessed`` has no
counterpart and is None), and the run's peak allocation over its start on
the card. :data:`PEAK_FLOPS` holds NVIDIA's published dense bf16 rates
without sparsity, keyed by ``torch.cuda.get_device_name()``; a card it
does not know (and the CPU) falls back to a measured matmul rate
(:func:`calibrated_peak_flops`), labelled as such by :func:`mesh_mfu`,
which divides by every rank's peak on a mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from alphafold2_tpu_torch.device import resolve_device

# published peak dense bf16 FLOPs/s a card (NVIDIA's data sheets, without
# sparsity), matched as a substring of torch.cuda.get_device_name()
PEAK_FLOPS = {
    "H100 80GB HBM3": 989.4e12,  # H100 SXM
    "H100 SXM": 989.4e12,
    "H100 PCIe": 756e12,
}

# no device sustains 2 PFLOP/s dense bf16 today: a measurement implying
# more is a broken clock on any device, known or not
SANITY_FLOPS_CEILING = 2e15


def _cpu_sdpa_flop(query_shape, key_shape, value_shape, *args, out_shape=None, **kwargs) -> int:
    from torch.utils.flop_counter import sdpa_flop_count

    return sdpa_flop_count(query_shape, key_shape, value_shape)


# FlopCounterMode has formulas for the CUDA attention ops of
# scaled_dot_product_attention, none for the CPU's: the same count (Q·Kᵀ
# and P·V, the K1 wrapper's analytic count) for the CPU op
CPU_SDPA_FLOPS = {torch.ops.aten._scaled_dot_product_flash_attention_for_cpu: _cpu_sdpa_flop}


@dataclasses.dataclass
class CountedRun:
    """One counted run of a forward: ``op_flops`` from ``FlopCounterMode``,
    ``kernel_flops`` the hand-written kernels' analytic tally by wrapper and
    ``peak_bytes`` the run's peak allocation over its start (None off the
    card)."""

    op_flops: float
    kernel_flops: dict
    peak_bytes: Optional[int]

    @property
    def flops(self) -> float:
        return self.op_flops + sum(self.kernel_flops.values())


def count_forward(fn, *args, device=None, **kwargs) -> CountedRun:
    """Run ``fn(*args, **kwargs)`` once under the counters. On a CUDA
    ``device`` the run's peak allocation over its start is read with
    ``reset_peak_memory_stats`` / ``max_memory_allocated``: the caching
    allocator keeps those on the host as the run allocates, so no
    synchronize is needed, and its peak is the process's (other threads'
    allocations during the run count in it)."""
    from torch.utils.flop_counter import FlopCounterMode

    from alphafold2_tpu_torch.ops.cuda import build

    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with build.flop_tally() as tally, FlopCounterMode(display=False,
                                                      custom_mapping=CPU_SDPA_FLOPS) as counter:
        fn(*args, **kwargs)
    peak = max(0, torch.cuda.max_memory_allocated(device) - start) if cuda else None
    return CountedRun(op_flops=float(counter.get_total_flops()), kernel_flops=dict(tally),
                      peak_bytes=peak)


def executable_costs(run: CountedRun) -> dict:
    """``{"flops": float|None, "bytes_accessed": None}`` of one counted run
    (JAX's keys; None where nothing was counted)."""
    flops = run.flops
    return {"flops": flops if flops > 0 else None, "bytes_accessed": None}


def executable_memory(run: CountedRun) -> dict:
    """``{"peak_bytes": ...}``: the counted run's peak allocation over its
    start; ``{}`` off the card."""
    return {"peak_bytes": int(run.peak_bytes)} if run.peak_bytes is not None else {}


def peak_flops_for_kind(kind: Optional[str]) -> Optional[float]:
    """The published peak of a device kind (``torch.cuda.get_device_name``);
    None for kinds the table does not know."""
    if not kind:
        return None
    return next((v for k, v in PEAK_FLOPS.items() if k.lower() in kind.lower()), None)


def device_kind(device=None) -> Optional[str]:
    """``torch.cuda.get_device_name`` of ``device`` (``resolve_device``'s:
    by default the current card, raising without one); None for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else None


def device_peak_flops(device=None) -> Optional[float]:
    """Published peak dense bf16 FLOPs/s of ``device`` (by default the
    current card); None for the CPU and for cards the table does not know."""
    return peak_flops_for_kind(device_kind(device))


def attention_flops_attribution(
    *,
    batch: int,
    pair_len: int,
    msa_depth: int,
    msa_len: int,
    depth: int,
    heads: int,
    dim_head: int,
    tie_rows: bool = False,
    total_flops: Optional[float] = None,
) -> dict:
    """Per-kernel attribution of one trunk forward's attention FLOPs.

    The analytical split (matmul FLOPs only, 2 flops per MAC, QK^T + AV
    per pass) over the trunk's attention families at the engine's static
    shapes:

    - ``axial``: the two axial passes per layer over the (pair_len,
      pair_len) pair grid — 2 * 4 * B * N^3 * inner per layer.
    - ``tied_row``: the MSA row pass when rows are tied (the tied-row
      kernel's shape) — 4 * B * M * Nm^2 * inner per layer; attributed to
      ``msa_axial_untied`` instead when ``tie_rows`` is False.
    - ``msa_axial_untied``: the remaining MSA axial work (column pass, and
      the row pass when untied).
    - ``other``: ``total_flops`` minus the attention families (cross-attn,
      feedforwards, embeddings, realization) when a total is given.

    ``pair_len`` is the elongated token length (3 * bucket), ``msa_len``
    the unelongated bucket (JAX's function, copied exactly)."""
    inner = heads * dim_head
    axial = depth * 2 * 4.0 * batch * float(pair_len) ** 3 * inner
    msa_row = depth * 4.0 * batch * msa_depth * float(msa_len) ** 2 * inner
    msa_col = depth * 4.0 * batch * msa_len * float(msa_depth) ** 2 * inner
    out = {
        "axial": axial,
        "tied_row": msa_row if tie_rows else 0.0,
        "msa_axial_untied": (0.0 if tie_rows else msa_row) + msa_col,
    }
    if total_flops:
        out["other"] = max(0.0, float(total_flops) - sum(out.values()))
    return out


# one measured-peak probe a process, keyed by device kind
_CALIBRATED: dict = {}


def calibrated_peak_flops(device=None, n: int = 1024, iters: int = 8) -> Optional[float]:
    """A measured dense-matmul rate, for devices the published table does
    not know (the CPU above all): times ``iters`` f32 ``n x n`` matmuls of
    known cost with torch on ``device`` (``resolve_device``'s: by default
    the card). Cached a device kind; None where it cannot be measured."""
    try:
        dev = resolve_device(device)
        kind = device_kind(dev) or "cpu"
        if kind in _CALIBRATED:
            return _CALIBRATED[kind]
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        x = torch.full((n, n), 1.0 / n, dtype=torch.float32, device=dev)
        y = x @ x  # warm the library handles outside the timing
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = y @ x
        sync()
        peak = iters * 2 * n**3 / max(time.perf_counter() - t0, 1e-9)
        _CALIBRATED[kind] = peak
        return peak
    except Exception:  # noqa: BLE001 — the accounting never breaks a measurement
        return None


def mesh_mfu(flops: Optional[float], seconds: float, mesh=None, device=None) -> dict:
    """MFU of a program (by default on the card; ``device="cpu"`` asks for
    the CPU): ``{"mfu": ..., "mfu_basis": "published-peak" |
    "calibrated-matmul"}`` (``{"mfu": None}`` without a count or a time).
    On a card with a published peak the denominator is that peak times the
    ranks of ``mesh`` (a ``parallel/`` DeviceMesh, one card a rank), and
    ``flops`` is then the whole program's, every rank's; elsewhere the
    measured matmul rate with no multiplier, as JAX's (``observe/flops.py
    :211-239``: CPU ranks share one machine's cores)."""
    if not flops or not seconds or seconds <= 0:
        return {"mfu": None}
    peak = device_peak_flops(device)
    if peak is not None:
        n_dev = int(mesh.size()) if mesh is not None else 1
        return {"mfu": flops / seconds / (peak * max(1, n_dev)),
                "mfu_basis": "published-peak"}
    peak = calibrated_peak_flops(device)
    if not peak:
        return {"mfu": None}
    return {"mfu": flops / seconds / peak, "mfu_basis": "calibrated-matmul"}
