"""Step metrics as JSONL and stdout, and event counters.

Port of ``MetricsLogger``, ``flatten_metrics`` and ``EventCounters`` of
``alphafold2_tpu/observe/metrics.py``. The port runs one process, so there
is no process-index probe: the logger is enabled unless told otherwise.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class MetricsLogger:
    """One JSON record a step appended to ``<directory>/<filename>`` (no
    file without a directory), echoed to stdout as ``[step i] k=v ...``
    unless ``echo=False``; ``enabled=False`` logs nothing."""

    def __init__(self, directory: Optional[str] = None, filename: str = "metrics.jsonl",
                 enabled: bool = True, echo: bool = True):
        self._echo = echo
        self._enabled = bool(enabled)
        self._path = None
        if directory and self._enabled:
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(directory, filename)

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def path(self) -> Optional[str]:
        return self._path

    def log(self, step: int, metrics: dict) -> None:
        if not self._enabled:
            return
        line = json.dumps({"step": step, "time": time.time(), **metrics})
        if self._echo:
            print(f"[step {step}] " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()), flush=True)
        if self._path:
            with open(self._path, "a") as f:
                f.write(line + "\n")


def flatten_metrics(metrics: dict, prefix: str = "", sep: str = "/") -> dict:
    """Nested metric dicts flattened to ``a/b/c`` keys. Leaves become
    ``float`` (which reads a device scalar), non-numeric leaves stay as
    they are."""
    out: dict = {}
    for k, v in metrics.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_metrics(v, prefix=key + sep, sep=sep))
            continue
        try:
            out[key] = float(v)
        except (TypeError, ValueError):
            out[key] = v
    return out


class EventCounters:
    """Named monotonic counters for events without a step axis (requests,
    batches, compiles, cache hits): ``bump`` from any thread, ``get`` one,
    ``snapshot`` them all, ``log_to`` a MetricsLogger. Thread-safe: the
    serving pipeline's stage workers and the frontend bump concurrently,
    and a lost update would break the ledgers the tests hold exact."""

    def __init__(self):
        self._counts: dict = {}
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def log_to(self, logger: MetricsLogger, step: int = 0) -> None:
        logger.log(step, self.snapshot())
