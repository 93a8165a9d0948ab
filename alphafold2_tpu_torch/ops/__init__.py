"""The attention modules, re-exported under the JAX package's names
(``alphafold2_tpu/ops/__init__.py``)."""

from alphafold2_tpu_torch.ops.attention import Attention, AxialAttention, FeedForward

__all__ = ["Attention", "AxialAttention", "FeedForward"]
