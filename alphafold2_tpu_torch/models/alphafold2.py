"""The Alphafold2 distogram model: embeddings, MSA stream, trunk, head.

Port of ``alphafold2_tpu/models/alphafold2.py`` without templates and
without the ``embedds`` (PLM) input, which raise for now: the outer-sum
pair grid with axial positional embeddings and an AND-combined pair mask
(:187-201), the MSA stream with per-position and per-row embeddings
(:203-215), the trunk under any of its engines (``remat`` with
``remat_policy``, ``reversible``, ``scan_layers``; block-sparse pair
attention with ``sparse_self_attn``, ``sparse_config`` and
``seq_len=max_seq_len``, as :288-312 passes them), and the symmetrized
distogram head (:314-318), whose LayerNorm output is cast to the compute
dtype (the reversible engine returns float32 streams). ``dtype`` is the
compute dtype; parameters stay float32. ``attn_dropout`` and
``ff_dropout`` are active when the forward is given a ``dropout_key``
(``ops/attention.py``), as a training step gives one; the trunk draws
under ``trunk/...``. The numerics tags ``embed.pair``, ``embed.msa`` and
``distogram.logits`` sit where JAX's do (:197, :225, :318).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.models.trunk import Trunk
from alphafold2_tpu_torch.observe.numerics import tag
from alphafold2_tpu_torch.ops.attention import DropoutKey, child_key
from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm


class Alphafold2(nn.Module):
    def __init__(
        self,
        dim: int,
        max_seq_len: int = 2048,
        depth: int = 6,
        heads: int = 8,
        dim_head: int = 64,
        num_tokens: int = constants.NUM_AMINO_ACIDS,
        max_num_msas: int = constants.MAX_NUM_MSA,
        gelu_exact: bool = False,
        msa_tie_row_attn: bool = False,
        dtype: torch.dtype = torch.float32,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        sparse_self_attn: Union[bool, Sequence[bool]] = False,
        sparse_config=None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        reversible: bool = False,
        scan_layers: bool = False,
    ):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.max_num_msas = max_num_msas
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.pos_emb_ax = nn.Embedding(max_seq_len, dim)
        self.msa_pos_emb = nn.Embedding(max_seq_len, dim)
        self.msa_num_pos_emb = nn.Embedding(max_num_msas, dim)
        self.trunk = Trunk(dim, depth, heads, dim_head, gelu_exact=gelu_exact,
                           msa_tie_row_attn=msa_tie_row_attn,
                           sparse_self_attn=sparse_self_attn, seq_len=max_seq_len,
                           sparse_config=sparse_config, remat=remat,
                           remat_policy=remat_policy, reversible=reversible,
                           scan_layers=scan_layers, dtype=dtype,
                           attn_dropout=attn_dropout, ff_dropout=ff_dropout)
        self.distogram_norm = LayerNorm(dim)
        self.distogram_proj = Dense(dim, constants.DISTOGRAM_BUCKETS)

    def forward(
        self,
        seq: torch.Tensor,  # (B, N) int tokens
        msa: Optional[torch.Tensor] = None,  # (B, M, Nm) int tokens
        mask: Optional[torch.Tensor] = None,  # (B, N) bool
        msa_mask: Optional[torch.Tensor] = None,  # (B, M, Nm) bool
        templates_seq=None,
        embedds=None,
        dropout_key: Optional[DropoutKey] = None,
    ) -> torch.Tensor:
        if templates_seq is not None:
            raise NotImplementedError("templates are not ported yet")
        if embedds is not None:
            raise NotImplementedError("the embedds (PLM) path is not ported yet")
        b, n = seq.shape
        if n > self.max_seq_len:
            raise ValueError(
                f"sequence length {n} exceeds max_seq_len {self.max_seq_len}"
            )
        if msa is not None:
            if msa.shape[-1] > self.max_seq_len:
                raise ValueError(f"MSA length {msa.shape[-1]} exceeds "
                                 f"max_seq_len {self.max_seq_len}")
            if msa.shape[1] > self.max_num_msas:
                raise ValueError(f"MSA depth {msa.shape[1]} exceeds "
                                 f"max_num_msas {self.max_num_msas}")
        dt = self.dtype
        n_range = torch.arange(n, device=seq.device)

        e = self.token_emb(seq).to(dt)
        x = e[:, :, None, :] + e[:, None, :, :]
        x = (x + self.pos_emb(n_range).to(dt)[None, :, None, :]
             + self.pos_emb_ax(n_range).to(dt)[None, None, :, :])
        x = tag("embed.pair", x)
        pair_mask = mask[:, :, None] & mask[:, None, :] if mask is not None else None

        m = None
        if msa is not None:
            nm, mm = msa.shape[-1], msa.shape[1]
            m = self.token_emb(msa).to(dt)
            m = m + self.msa_pos_emb(torch.arange(nm, device=seq.device)).to(dt)[None, None]
            m = m + self.msa_num_pos_emb(
                torch.arange(mm, device=seq.device)).to(dt)[None, :, None]
            m = tag("embed.msa", m)

        x, m = self.trunk(x, m, pair_mask=pair_mask, msa_mask=msa_mask,
                          key=child_key(dropout_key, "trunk"))

        x = 0.5 * (x + x.transpose(1, 2))
        logits = self.distogram_proj(self.distogram_norm(x).to(dt))
        return tag("distogram.logits", logits.float())
