"""Checkpoints of a training run: ``torch.save`` in place of orbax.

Counterpart of ``alphafold2_tpu/train/checkpoint.py``. Each checkpoint is
one directory ``step_<n>`` under the manager's root, holding

- ``params.pt``: the model's ``state_dict``;
- ``train_state.pt``: the optimizer's state (``mu``, ``nu``, ``count``,
  ``mini_step``, ``acc``), ``step`` and ``skipped``.

Tensors are saved on the CPU. A checkpoint is written under a temporary
name, flushed to disk and then renamed, so a run killed while saving never
leaves a half-written checkpoint as the latest. :meth:`restore_params`
reads ``params.pt`` alone, so inference does not depend on the optimizer
of the run that wrote the checkpoint. The newest ``keep`` checkpoints are
kept; a writer's save first removes temporary directories that a killed
run left. Orbax checkpoints of the JAX package are not read (that would take
orbax); JAX parameters reach the port through ``convert.to_state_dict``.

On a device mesh (``distributed=True``, a process group of several ranks
whose state is replicated) rank 0 alone writes a checkpoint and every rank
waits for the write at a barrier before it goes on, so each rank's next
:meth:`CheckpointManager.latest_step` and restore read the same files.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional, Tuple

import torch
import torch.distributed as dist

PARAMS_FILE = "params.pt"
TRAIN_STATE_FILE = "train_state.pt"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp_step_"


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_cpu(v) for v in value]
    return value


def _save_synced(obj, path: str) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """``save(step, state)`` / ``maybe_restore(state) -> (state, step)`` /
    ``restore_params(model) -> (model, step)`` over one directory. Writes
    are synchronous, so :meth:`wait` and :meth:`close` have nothing to
    finish; they are kept so callers read like the JAX package's. With
    ``distributed`` every rank of the process group calls :meth:`save`,
    rank 0 writes and all meet at a barrier (module docstring)."""

    def __init__(self, directory: str, keep: int = 3, distributed: bool = False):
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.distributed = distributed and dist.is_initialized()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def steps(self) -> list:
        """Steps of the complete checkpoints, ascending."""
        if not os.path.isdir(self.directory):
            return []
        found = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, TRAIN_STATE_FILE)):
                found.append(int(m.group(1)))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write ``state`` (a ``TrainState``) as the checkpoint of ``step``,
        replacing one of the same step, then drop all but the newest
        ``keep``."""
        if self.distributed:
            if dist.get_rank() == 0:
                self._write(step, state)
            dist.barrier()
            return
        self._write(step, state)

    def _write(self, step: int, state) -> None:
        step = int(step)
        os.makedirs(self.directory, exist_ok=True)
        # a run killed while saving leaves its temporary directory behind
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        os.makedirs(tmp)
        _save_synced(_to_cpu(state.model.state_dict()), os.path.join(tmp, PARAMS_FILE))
        _save_synced({"optimizer": _to_cpu(state.optimizer.state_dict()),
                      "step": step,
                      "skipped": int(state.skipped) if state.skipped is not None else 0},
                     os.path.join(tmp, TRAIN_STATE_FILE))
        final = self._path(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def maybe_restore(self, state) -> Tuple[object, int]:
        """Load the latest checkpoint into ``state`` (its model, optimizer,
        ``step`` and ``skipped``, on the devices they live on); without one,
        return ``state`` unchanged and step 0."""
        latest = self.latest_step()
        if latest is None:
            return state, 0
        self.restore_params(state.model, latest)
        saved = torch.load(os.path.join(self._path(latest), TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        dev = state.skipped.device if state.skipped is not None else torch.device("cpu")
        state.skipped = torch.tensor(saved["skipped"], dtype=torch.int32, device=dev)
        return state, latest

    def restore_params(self, model: torch.nn.Module, step: Optional[int] = None):
        """Load only the parameters of checkpoint ``step`` (default: the
        latest) into ``model``; returns ``(model, step)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory!r}")
        params = torch.load(os.path.join(self._path(step), PARAMS_FILE),
                            map_location="cpu", weights_only=True)
        model.load_state_dict(params)
        return model, step

    def wait(self) -> None:
        """Nothing to wait for: :meth:`save` returns once the files are on disk."""

    def close(self) -> None:
        """Nothing to release."""
