"""The trunk: a python loop of TrunkLayers over the pair and MSA streams.

Port of the default engine of ``alphafold2_tpu/models/trunk.py``
(``TrunkLayer`` :42-168 and the python-loop ``Trunk``). Streams stay grids:
pair (B, N, N, D), MSA (B, M, Nm, D). ``sparse_self_attn`` (a bool, or one
per layer) makes a layer's pair axial passes block-sparse (K4/K5), as in
JAX only the pair stream. The remat, reversible and scanned engines are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from alphafold2_tpu_torch.ops.attention import Attention, AxialAttention, FeedForward
from alphafold2_tpu_torch.ops.layers import LayerNorm


class TrunkLayer(nn.Module):
    """One depth step: axial self-attention on both streams, pair<->MSA
    cross-attention, then GEGLU feedforwards. All residual, all pre-LN."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 gelu_exact: bool = False, msa_tie_row_attn: bool = False,
                 sparse_attn: bool = False, seq_len: Optional[int] = None,
                 sparse_config=None):
        super().__init__()
        for name in ("pair_axial_norm", "msa_axial_norm", "pair_cross_norm",
                     "pair_cross_ctx_norm", "msa_cross_norm",
                     "msa_cross_ctx_norm", "pair_ff_norm", "msa_ff_norm"):
            self.add_module(name, LayerNorm(dim))
        self.pair_axial = AxialAttention(dim, heads, dim_head, sparse_attn=sparse_attn,
                                         seq_len=seq_len, sparse_config=sparse_config)
        self.msa_axial = AxialAttention(dim, heads, dim_head,
                                        tie_row_attn=msa_tie_row_attn)
        self.pair_from_msa = Attention(dim, heads, dim_head)
        self.msa_from_pair = Attention(dim, heads, dim_head)
        self.pair_ff = FeedForward(dim, gelu_exact=gelu_exact)
        self.msa_ff = FeedForward(dim, gelu_exact=gelu_exact)

    def forward(
        self,
        x: torch.Tensor,  # (B, N, N, D) pair grid
        m: Optional[torch.Tensor],  # (B, M, Nm, D) MSA grid or None
        pair_mask: Optional[torch.Tensor] = None,  # (B, N, N)
        msa_mask: Optional[torch.Tensor] = None,  # (B, M, Nm)
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x + self.pair_axial(self.pair_axial_norm(x), mask=pair_mask)
        if m is not None:
            m = m + self.msa_axial(self.msa_axial_norm(m), mask=msa_mask)
            b, n, n2, d = x.shape
            bm, mm, nm, _ = m.shape
            x_flat = x.reshape(b, n * n2, d)
            m_flat = m.reshape(bm, mm * nm, d)
            x_mask = pair_mask.reshape(b, n * n2) if pair_mask is not None else None
            m_mask = msa_mask.reshape(bm, mm * nm) if msa_mask is not None else None
            x_flat = x_flat + self.pair_from_msa(
                self.pair_cross_norm(x_flat),
                context=self.pair_cross_ctx_norm(m_flat),
                mask=x_mask, context_mask=m_mask,
            )
            m_flat = m_flat + self.msa_from_pair(
                self.msa_cross_norm(m_flat),
                context=self.msa_cross_ctx_norm(x_flat),
                mask=m_mask, context_mask=x_mask,
            )
            x = x_flat.reshape(b, n, n2, d)
            m = m_flat.reshape(bm, mm, nm, d)
        x = x + self.pair_ff(self.pair_ff_norm(x))
        if m is not None:
            m = m + self.msa_ff(self.msa_ff_norm(m))
        return x, m


class Trunk(nn.Module):
    """``depth`` TrunkLayers named ``layer_0`` ... (the flax names).
    ``sparse_self_attn`` is one bool for every layer or a tuple of one per
    layer; ``seq_len`` and ``sparse_config`` go to the sparse layers."""

    def __init__(self, dim: int, depth: int = 6, heads: int = 8,
                 dim_head: int = 64, gelu_exact: bool = False,
                 msa_tie_row_attn: bool = False, remat: bool = False,
                 reversible: bool = False, scan_layers: bool = False,
                 sparse_self_attn: Union[bool, Sequence[bool]] = False,
                 seq_len: Optional[int] = None, sparse_config=None):
        super().__init__()
        for flag, name in ((remat, "remat"), (reversible, "reversible"),
                           (scan_layers, "scan_layers")):
            if flag:
                raise NotImplementedError(f"trunk {name} is not ported yet")
        sparse = sparse_self_attn
        if not isinstance(sparse, (tuple, list)):
            sparse = (sparse,) * depth
        if len(sparse) != depth:
            raise ValueError(f"sparse_self_attn tuple has {len(sparse)} entries "
                             f"for depth {depth}")
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", TrunkLayer(
                dim, heads, dim_head, gelu_exact=gelu_exact,
                msa_tie_row_attn=msa_tie_row_attn, sparse_attn=bool(sparse[i]),
                seq_len=seq_len, sparse_config=sparse_config,
            ))

    def forward(self, x, m, pair_mask=None, msa_mask=None):
        for i in range(self.depth):
            x, m = getattr(self, f"layer_{i}")(x, m, pair_mask, msa_mask)
        return x, m
