"""Process bootstrap: the process group, pod meshes and each rank's batch.

Port of ``alphafold2_tpu/parallel/distributed.py``. JAX initialises one
controller process a host and addresses every device from it; the port
runs one process a device (``torchrun --nproc-per-node N``), so the
bootstrap is ``torch.distributed.init_process_group`` with the rank and the
world the launcher gives:

- :func:`initialize` reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, or JAX's
  ``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` and
  ``PROCESS_ID``. Without either it is a no-op returning False, as JAX's is
  for a single process. The backend is NCCL on the card and gloo when the
  caller asks for the CPU; on the card each rank takes ``cuda:LOCAL_RANK``.
- :func:`pod_mesh` is a ``(dp, sp)`` mesh over every rank with ``sp`` last,
  so the ring's hops stay between neighbouring ranks of one host.
- :func:`global_batch` gives each rank its ``dp`` slice of a batch every
  rank holds whole (the serving engine broadcasts it from rank 0).
- :func:`local_world` gives one process a group of its own for a block
  (world size 1) where none is initialised: the analysis layer's sharded
  targets run that way on one device, every collective in place.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Optional, Union

import torch
import torch.distributed as dist

from alphafold2_tpu_torch.parallel.sharding import (
    DATA_AXIS, SEQ_AXIS, axis_index, axis_size, build_mesh, require_process_group,
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None) -> bool:
    """Initialise the default process group from the arguments or the
    launcher's environment (module docstring); True if a group is up
    afterwards, False for a single process with nothing to initialise.
    ``device="cpu"`` asks for gloo; otherwise the group is NCCL on the
    card."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and env.get("NUM_PROCESSES"):
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and env.get("PROCESS_ID"):
        process_id = int(env["PROCESS_ID"])
    if addr is None and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env.get("RANK", "0"))
    if addr is None:
        return False  # one process: nothing to initialise
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs the number of processes and this "
                         "process's id (NUM_PROCESSES/PROCESS_ID or WORLD_SIZE/RANK)")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        from alphafold2_tpu_torch.device import resolve_device

        resolve_device("cuda")  # raises without a card: NCCL needs one
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)
    return True


def pod_mesh(n_data: int = -1, n_seq: int = 1):
    """A ``(dp, sp)`` mesh over every rank; ``n_data=-1`` fills ``dp``.
    Needs an initialised process group, as every mesh does."""
    require_process_group()
    total = dist.get_world_size()
    if n_data == -1:
        if total % n_seq:
            raise ValueError(f"{total} ranks do not divide by sp={n_seq}")
        n_data = total // n_seq
    if n_data * n_seq != total:
        raise ValueError(f"mesh {n_data}x{n_seq} != {total} ranks")
    return build_mesh((n_data, n_seq), (DATA_AXIS, SEQ_AXIS))


def global_batch(batch: dict, mesh) -> dict:
    """This rank's ``dp`` slice (along dim 0) of every array of ``batch``
    with a batch axis (``seq``, ``mask``, ``msa``, ``msa_mask``,
    ``coords``, ``labels``, ``embedds``, ``backbone``: every array whose
    leading axis is the batch ``seq`` has), which each rank holds whole;
    other entries pass as they are. The global batch must divide by
    ``dp``."""
    n_dp, i = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    lead = batch.get("seq")
    if lead is None:
        lead = next(v for v in batch.values() if getattr(v, "ndim", 0) > 0)
    b = lead.shape[0]
    if b % n_dp:
        raise ValueError(f"batch {b} does not divide by dp={n_dp}")
    step = b // n_dp
    return {key: value[i * step:(i + 1) * step]
            if getattr(value, "ndim", 0) > 0 and value.shape[0] == b else value
            for key, value in batch.items()}


@contextmanager
def local_world(device: Optional[Union[str, torch.device]] = None):
    """A process group of one rank for the block (gloo on the CPU, NCCL on
    the card, a file store in a temporary directory) when none is
    initialised, destroyed afterwards; the initialised group otherwise.
    Yields True when it made one."""
    if dist.is_initialized():
        yield False
        return
    from alphafold2_tpu_torch.parallel import sharding

    cpu = device is None or torch.device(device).type == "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo" if cpu else "nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield True
        finally:
            sharding._seq_groups.clear()
            dist.destroy_process_group()
