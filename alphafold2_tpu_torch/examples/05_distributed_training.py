"""Training on a (dp, sp) device mesh: one process a rank under torchrun.

The port's counterpart of ``examples/05_distributed_training.py``. JAX lays
one compiled step over a mesh; the port runs SPMD ranks on
``torch.distributed``: the batch sharded over ``dp``, the pair grid's rows
over ``sp`` (with ring context parallelism for the cross passes), every
collective explicit and differentiable. The mesh follows the JAX example:
sp 2 when the world has at least 4 ranks, dp the rest.

Run on the CPU (gloo), four ranks:
  torchrun --nproc_per_node 4 alphafold2_tpu_torch/examples/05_distributed_training.py --device cpu
or on the card (NCCL), one rank a card:
  torchrun --nproc_per_node 1 alphafold2_tpu_torch/examples/05_distributed_training.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch.distributed as dist

from alphafold2_tpu_torch.config import Config, DataConfig, MeshConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.parallel.distributed import initialize, pod_mesh
from alphafold2_tpu_torch.train.loop import (
    build_model, device_put_batch, init_state, make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args(argv).device
    dev = resolve_device(device)
    if not initialize(device=dev):
        raise SystemExit("run under torchrun: no process group to join")
    try:
        n_dev = dist.get_world_size()
        n_sp = 2 if n_dev >= 4 else 1
        n_dp = max(n_dev // n_sp, 1)
        mesh = pod_mesh(n_dp, n_sp)
        lead = dist.get_rank() == 0
        if lead:
            print(f"mesh: {n_dp} data-parallel x {n_sp} sequence-parallel "
                  f"({dist.get_backend()}, {dev.type})", flush=True)

        cfg = Config(
            model=ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64,
                              msa_tie_row_attn=True, remat=True, bfloat16=False,
                              context_parallel="ring" if n_sp > 1 else None),
            mesh=MeshConfig(data_parallel=n_dp, seq_parallel=n_sp),
            data=DataConfig(crop_len=16, msa_depth=2, msa_len=16, batch_size=n_dp),
            train=TrainConfig(gradient_accumulate_every=1, warmup_steps=2),
        )
        batch = next(iter(SyntheticDataset(cfg.data, seed=0)))
        state = init_state(cfg, build_model(cfg), device=dev)
        step = make_train_step(state.model, mesh)
        local = device_put_batch(batch, dev, mesh)  # this rank's dp slice
        for i in range(3):
            state, metrics = step(state, local)
            if lead:
                print(f"step {i}: loss={float(metrics['loss']):.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
        if lead:
            print("ok", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
