"""Block-sparse self-attention: the layout, its packing, and the module.

Port of ``alphafold2_tpu/ops/sparse.py``:

- :class:`BlockSparseConfig`: the same fields and defaults; ``layout`` runs
  the same numpy code with the same ``default_rng(seed)`` draws, so the
  layouts are identical bit for bit (local sliding window, dense global
  rows and columns, seeded random blocks per row).
- :func:`active_indices`: the layout as per-row lists, as in JAX.
- :func:`config_layout`: a config's layout at one length, packed for the
  kernels as a ``BlockLayout`` (row and column lists with their counts);
  built once per (config, length), its lists copied to each device once.
- :class:`SparseAttention`: the module, with the grid route
  (``grid_axial``) and the flat route, which pads to a block multiple,
  composes the padding with the caller's mask and slices it off. It runs
  ``ops/cuda/block_sparse.py block_sparse_attention``: K4 forward and
  K5a/K5b backward on the card, on the CPU their plain versions, of which
  the forward is JAX's gather-based ``block_sparse_attention`` (:119).

``BlockSparseConfig.backend`` names four implementations of one function in
the JAX package ("auto", "pallas", "jnp", "splash"); on the card every value
runs K4/K5, on the CPU every value runs the plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch.ops.attention import DropoutKey, dropout, grid_axial_project_attend
from alphafold2_tpu_torch.ops.cuda import block_sparse as kernels
from alphafold2_tpu_torch.ops.cuda.block_sparse import BlockLayout
from alphafold2_tpu_torch.ops.layers import Dense

BACKENDS = ("auto", "pallas", "jnp", "splash")


@dataclasses.dataclass(frozen=True)
class BlockSparseConfig:
    """Variable block-sparsity layout (bidirectional).

    block_size: attention block edge. num_local_blocks: sliding window width
    in blocks. num_global_blocks: leading blocks attending/attended densely.
    num_random_blocks: extra random blocks per query row; None -> the
    reference's default seq_len/block/4. backend: the JAX package's kernel
    choice, one of :data:`BACKENDS` (every value runs K4/K5 here).
    """

    block_size: int = 16
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    num_random_blocks: Optional[int] = None
    seed: int = 0
    backend: str = "auto"

    def resolve_random(self, seq_len: int) -> int:
        if self.num_random_blocks is not None:
            return self.num_random_blocks
        return max(seq_len // self.block_size // 4, 0)

    def layout(self, seq_len: int) -> np.ndarray:
        """(num_blocks, num_blocks) bool — True where a block attends."""
        if seq_len % self.block_size != 0:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block_size "
                f"{self.block_size}"
            )
        nb = seq_len // self.block_size
        lay = np.zeros((nb, nb), dtype=bool)
        # local sliding window
        half = self.num_local_blocks // 2
        for i in range(nb):
            lo = max(0, i - half)
            hi = min(nb, i + max(self.num_local_blocks - half, 1))
            lay[i, lo:hi] = True
        # global blocks: first G rows and columns fully dense
        g = min(self.num_global_blocks, nb)
        lay[:g, :] = True
        lay[:, :g] = True
        # seeded random blocks per row
        r = min(self.resolve_random(seq_len), nb)
        if r > 0:
            rng = np.random.default_rng(self.seed)
            for i in range(nb):
                lay[i, rng.choice(nb, size=r, replace=False)] = True
        return lay


def active_indices(layout: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack the layout into per-row active-block index lists.

    Returns (indices (nb, max_active) int32, valid (nb, max_active) bool,
    max_active). Rows with fewer active blocks are padded with index 0 and
    valid=False.
    """
    nb = layout.shape[0]
    counts = layout.sum(-1)
    max_active = int(counts.max()) if nb else 0
    idx = np.zeros((nb, max_active), dtype=np.int32)
    valid = np.zeros((nb, max_active), dtype=bool)
    for i in range(nb):
        a = np.nonzero(layout[i])[0]
        idx[i, : len(a)] = a
        valid[i, : len(a)] = True
    return idx, valid, max_active


def pack_layout(layout: np.ndarray, block_size: int) -> BlockLayout:
    """A (nb, nb) bool layout as the kernels take it: the row lists of
    :func:`active_indices` and those of the layout transposed."""
    layout = np.asarray(layout, dtype=bool)
    idx, valid, _ = active_indices(layout)
    idx_t, valid_t, _ = active_indices(layout.T)
    return BlockLayout(idx, valid.sum(-1), idx_t, valid_t.sum(-1), block_size)


@functools.lru_cache(maxsize=64)
def config_layout(config: BlockSparseConfig, seq_len: int) -> BlockLayout:
    """``config``'s layout at ``seq_len``, packed; one per (config, length)."""
    return pack_layout(config.layout(seq_len), config.block_size)


class SparseAttention(nn.Module):
    """Block-sparse multi-head self-attention (the flax module's parameters:
    ``to_q``, ``to_kv``, ``to_out``).

    The flat call pads the sequence to a block multiple (composing with,
    not clobbering, any caller mask) and slices the padding back off;
    ``grid_axial`` runs one axial pass over a block-aligned grid axis.
    ``seq_len`` bounds the allowed length. ``dropout`` drops the flat
    call's output after ``to_out``, on the padded output before the slice,
    as JAX's ``out_dropout`` (:371, :472-479); the kernels still run.
    Under active dropout ``AxialAttention`` takes the flat route."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, seq_len: Optional[int] = None,
                 config: BlockSparseConfig = BlockSparseConfig()):
        super().__init__()
        self.dropout = dropout
        if config.backend not in BACKENDS:
            raise ValueError(f"unknown sparse backend {config.backend!r}; have "
                             f"{list(BACKENDS)}")
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.seq_len, self.config = seq_len, config
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, inner * 2, bias=False)
        self.to_out = Dense(inner, dim)

    def _check_len(self, n: int, what: str) -> None:
        if self.seq_len is not None and n > self.seq_len:
            raise ValueError(f"{what} {n} exceeds max_seq_len {self.seq_len}")

    def _attend(self, q, k, v, kv_mask):
        """(B*, H, n, dh) q/k/v, n a block multiple; keys masked by kv_mask."""
        return kernels.block_sparse_attention(
            q, k, v, config_layout(self.config, q.shape[2]), kv_mask=kv_mask,
            sm_scale=self.dim_head**-0.5)

    def grid_axial(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                   attend_axis: int) -> torch.Tensor:
        """Block-sparse self-attention along one axis of a (B, Hg, Wg, D)
        grid (``ops/attention.py grid_axial_project_attend``); the attended
        axis must be a multiple of the block size. The (B, Hg, Wg) mask
        masks keys only."""
        n_att = x.shape[attend_axis]
        bs = self.config.block_size
        if n_att % bs != 0:
            raise ValueError(f"grid sparse attention needs the attended axis ({n_att}) "
                             f"to be a multiple of block_size ({bs})")
        self._check_len(n_att, "attended axis")
        return grid_axial_project_attend(
            self.to_q, self.to_kv, self.to_out, self.heads, self.dim_head, x, mask,
            attend_axis, self._attend)

    def forward(self, x, context=None, mask=None, context_mask=None,
                tie_dim: Optional[int] = None, key: Optional[DropoutKey] = None):
        if context is not None:
            raise ValueError("sparse attention is self-attention only")
        if tie_dim is not None:
            raise ValueError("sparse attention is not compatible with tying of row attention")
        b, n, _ = x.shape
        self._check_len(n, "sequence length")
        h, dh = self.heads, self.dim_head
        pad = (-n) % self.config.block_size
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            if mask is None:
                mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
            mask = torch.cat([mask, mask.new_zeros((b, pad))], dim=1)
        padded = n + pad
        q = self.to_q(x).view(b, padded, h, dh).transpose(1, 2)
        k, v = (t.view(b, padded, h, dh).transpose(1, 2) for t in self.to_kv(x).chunk(2, -1))
        out = self._attend(q, k, v, mask)  # (B, H, padded, dh)
        out = self.to_out(out.transpose(1, 2).reshape(b, padded, h * dh))
        return dropout(out, self.dropout, key)[:, :n]
