"""A profiler trace over a window of training steps.

Port of ``alphafold2_tpu/observe/profiler.py``: ``train.profile_dir`` and
``train.profile_steps`` select a window of steps ``(start, stop)``: the
trace starts before step ``start`` and stops after the first step at or
past ``stop``, as JAX's does. JAX writes an XProf trace with
``jax.profiler``; the port runs ``torch.profiler`` over the window (CPU
activity, and CUDA activity where the loop runs on the card) and writes its
Chrome trace into the directory, which Perfetto and ``chrome://tracing``
load.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch


class Profiler:
    """``maybe_start(step)`` before each step starts the trace at ``start``;
    ``maybe_stop(step)`` after each step stops it at the first step at or
    past ``stop``, synchronizes the device and writes
    ``<trace_dir>/trace_steps_<start>_<stop>.json`` (``path``). Without a
    directory it does nothing."""

    def __init__(self, trace_dir: Optional[str], steps: Tuple[int, int] = (10, 13),
                 device: Union[str, torch.device] = "cpu"):
        self._dir = trace_dir
        self._start, self._stop = steps
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None
        self.path: Optional[str] = None

    def maybe_start(self, step: int) -> None:
        if self._dir and step == self._start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self._stop:
            if self._cuda:
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self._dir, exist_ok=True)
            self.path = os.path.join(self._dir,
                                     f"trace_steps_{self._start}_{self._stop}.json")
            self._prof.export_chrome_trace(self.path)
            self._prof = None
