"""Device memory telemetry from PyTorch's caching allocator.

Port of ``alphafold2_tpu/observe/memory.py``'s ``MemorySampler``: where
JAX reads ``device.memory_stats()``, the port reads
``torch.cuda.memory_allocated``, ``max_memory_allocated`` and the card's
total memory for each CUDA device it samples. A CPU device has no
allocator statistics, so it samples nothing, as JAX's sampler records
nothing on a backend without stats: serving calls it unconditionally.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class MemorySampler:
    """Samples device memory of ``devices`` (default: every CUDA device;
    none on a machine without one). ``sample()`` gives one record a
    device: ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``,
    JAX's keys; ``peak_bytes()`` the largest peak; ``log_to`` a summary
    through a MetricsLogger; ``counter_to`` one Chrome counter event a
    device through a Tracer, so traces show memory beside the spans."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = devices

    def _get_devices(self) -> list:
        if self._devices is None:  # no card: device_count() is 0
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [d for d in map(torch.device, self._devices) if d.type == "cuda"]

    def sample(self) -> list:
        records = []
        for d in self._get_devices():
            index = d.index if d.index is not None else torch.cuda.current_device()
            records.append({
                "device": str(index),
                "bytes_in_use": int(torch.cuda.memory_allocated(index)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
                "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
            })
        return records

    def peak_bytes(self) -> Optional[int]:
        peaks = [r["peak_bytes_in_use"] for r in self.sample()]
        return max(peaks) if peaks else None

    def log_to(self, logger, step: int = 0, per_device: bool = False) -> None:
        """One summary record (``hbm_peak_bytes``, ``hbm_in_use_bytes``,
        ``hbm_devices``, JAX's names); ``per_device`` adds
        ``hbm/device<N>/peak_bytes`` a device. Nothing without a device."""
        records = self.sample()
        if not records:
            return
        summary = {
            "hbm_peak_bytes": max(r["peak_bytes_in_use"] for r in records),
            "hbm_in_use_bytes": max(r["bytes_in_use"] for r in records),
            "hbm_devices": len(records),
        }
        if per_device:
            for r in records:
                summary[f"hbm/device{r['device']}/peak_bytes"] = r["peak_bytes_in_use"]
        logger.log(step, summary)

    def counter_to(self, tracer) -> None:
        for r in self.sample():
            tracer.counter(f"hbm.device{r['device']}", bytes_in_use=r["bytes_in_use"],
                           peak_bytes_in_use=r["peak_bytes_in_use"])
