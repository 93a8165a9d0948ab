"""Distogram training, re-exported under the JAX package's names
(``alphafold2_tpu/train/__init__.py``); ``build_optimizer`` is
``train/optim.py``'s."""

from alphafold2_tpu_torch.train.loop import (
    TrainState,
    build_model,
    device_put_batch,
    distogram_cross_entropy,
    init_state,
    make_train_step,
    train,
)
from alphafold2_tpu_torch.train.optim import build_optimizer

__all__ = ["TrainState", "build_model", "build_optimizer", "device_put_batch",
           "distogram_cross_entropy", "init_state", "make_train_step", "train"]
