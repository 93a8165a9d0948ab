"""FeedForward (GEGLU), Attention and AxialAttention as torch modules.

Port of ``alphafold2_tpu/ops/attention.py``. Every attention runs through
the hand-written kernels: :func:`~alphafold2_tpu_torch.ops.cuda.axial.
fused_attention` (K1) for self/cross attention and the axial passes,
:func:`~alphafold2_tpu_torch.ops.cuda.tied_row.tied_row_attention` (K2) for
tied MSA rows, and, with ``AxialAttention(sparse_attn=True)``, the
block-sparse K4 of ``ops/sparse.py`` for both axial passes. Their wrappers
run the plain PyTorch versions on CPU tensors.

Parameter names mirror the flax modules (``to_q``, ``to_kv``, ``to_out``,
``wi``, ``wo``, ``attn_width``, ``attn_height``), so ``convert.py`` maps a
flax tree onto them by path. Masked query positions come out 0 here where
the JAX dense path gives them uniform attention; every consumer masks them,
so only valid positions are comparable.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch.ops.cuda.axial import fused_attention
from alphafold2_tpu_torch.ops.cuda.tied_row import tied_row_attention
from alphafold2_tpu_torch.ops.layers import Dense


def _no_dropout(rate: float, where: str) -> None:
    if rate:
        raise NotImplementedError(
            f"{where} dropout (rate {rate}) is not ported yet: the kernels have no "
            "in-kernel random bits, so training runs with dropout 0"
        )


def grid_axial_project_attend(to_q, to_kv, to_out, heads: int, dim_head: int,
                              x: torch.Tensor, mask: Optional[torch.Tensor],
                              attend_axis: int, attend) -> torch.Tensor:
    """One axial self-attention pass over a (B, Hg, Wg, D) grid, shared by
    ``Attention`` and ``SparseAttention`` as the JAX package shares it
    (``alphafold2_tpu/ops/attention.py:44``): pointwise q/kv projections on
    the grid, ``attend(q, k, v, m)`` on (B*rows, H, n, dh) views with the
    (B*rows, n) mask (or None), output projection. Axis 2 attends within
    rows (over columns), axis 1 within columns (over rows); the other axis
    folds into the batch."""
    b, gh, gw, _ = x.shape
    h, dh = heads, dim_head
    q = to_q(x).view(b, gh, gw, h, dh)
    k, v = (t.view(b, gh, gw, h, dh) for t in to_kv(x).chunk(2, -1))
    if attend_axis == 1:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        mask = mask.transpose(1, 2) if mask is not None else None
    elif attend_axis != 2:
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    rows, n = q.shape[1], q.shape[2]

    def flat(t):  # (B, rows, n, H, dh) -> (B*rows, H, n, dh) view
        return t.reshape(b * rows, n, h, dh).transpose(1, 2)

    m2 = mask.reshape(b * rows, n) if mask is not None else None
    out = attend(flat(q), flat(k), flat(v), m2)
    out = out.transpose(1, 2).reshape(b, rows, n, h * dh)
    if attend_axis == 1:
        out = out.transpose(1, 2)
    return to_out(out)


class FeedForward(nn.Module):
    """GEGLU: Dense(d -> 2*mult*d) -> h * gelu(gates) -> Dense(mult*d -> d).
    GELU is the tanh form unless ``gelu_exact`` (flax's default)."""

    def __init__(self, dim: int, mult: int = 4, gelu_exact: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        _no_dropout(dropout, "feedforward")
        inner = dim * mult
        self.wi = Dense(dim, inner * 2)
        self.wo = Dense(inner, dim)
        self.approximate = "none" if gelu_exact else "tanh"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gates = self.wi(x).chunk(2, dim=-1)
        return self.wo(h * F.gelu(gates, approximate=self.approximate))


class Attention(nn.Module):
    """Multi-head attention: self, cross (``context``), and tied rows
    (``tie_dim``) with abstention masking and the voting-row tie scale."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 compress_ratio: int = 1,
                 context_parallel: Optional[str] = None, dropout: float = 0.0):
        super().__init__()
        _no_dropout(dropout, "attention")
        if compress_ratio != 1:
            raise NotImplementedError("KV compression is not ported yet")
        if context_parallel is not None:
            raise NotImplementedError("context parallelism is not ported yet")
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, inner * 2, bias=False)
        self.to_out = Dense(inner, dim)

    def _project_out(self, out: torch.Tensor, lead: tuple) -> torch.Tensor:
        # out: (..., H, n, dh) kernel layout -> (*lead, n, H*dh)
        n = out.shape[-2]
        out = out.transpose(-3, -2).reshape(*lead, n, self.heads * self.dim_head)
        return self.to_out(out)

    def grid_axial(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                   attend_axis: int) -> torch.Tensor:
        """Self-attention along one axis of a (B, Hg, Wg, D) grid (see
        :func:`grid_axial_project_attend`), masking key and query validity
        with the (B, Hg, Wg) mask."""
        scale = self.dim_head**-0.5
        return grid_axial_project_attend(
            self.to_q, self.to_kv, self.to_out, self.heads, self.dim_head, x, mask,
            attend_axis, lambda q, k, v, m: fused_attention(
                q, k, v, q_mask=m, kv_mask=m, sm_scale=scale))

    def forward(self, x, context=None, mask=None, context_mask=None,
                tie_dim: Optional[int] = None):
        h, dh = self.heads, self.dim_head
        has_context = context is not None
        ctx = context if has_context else x
        lead, n = tuple(x.shape[:-2]), x.shape[-2]
        j = ctx.shape[-2]
        q = self.to_q(x).view(*lead, n, h, dh)
        k, v = (t.view(*ctx.shape[:-2], j, h, dh)
                for t in self.to_kv(ctx).chunk(2, -1))
        scale = dh**-0.5

        if tie_dim is None:
            kv_mask = context_mask
            if kv_mask is None and not has_context:
                kv_mask = mask
            out = fused_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                q_mask=mask, kv_mask=kv_mask, sm_scale=scale,
            )  # (B, H, n, dh)
            return self._project_out(out, lead)

        # (B*R, n, h, d) -> (B, R, n, h, d): one attention matrix per (B, h)
        r = tie_dim
        q, k, v = (t.reshape(-1, r, *t.shape[1:]) for t in (q, k, v))
        bt = q.shape[0]
        tie_scale = r**-0.5
        kv_side = context_mask if has_context else mask
        if mask is not None or kv_side is not None:
            # padded (row, position) entries abstain from the shared logits
            # and from the per-row output; the tie scale counts the rows
            # that vote (a valid query and a valid key position)
            ones = lambda m: torch.ones((bt, r, m), dtype=torch.bool,
                                        device=x.device)
            qr = mask.reshape(bt, r, n) if mask is not None else ones(n)
            kr = kv_side.reshape(bt, r, j) if kv_side is not None else ones(j)
            q = q * qr[..., None, None].to(q.dtype)
            k = k * kr[..., None, None].to(k.dtype)
            v = v * kr[..., None, None].to(v.dtype)
            n_rows = (qr.any(-1) & kr.any(-1)).sum(-1).clamp_min(1)
            tie_scale = n_rows.to(torch.float32) ** -0.5
            mask = qr.any(1)
            context_mask = kr.any(1) if has_context else None
        km = context_mask if has_context else mask
        out = tied_row_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), q_mask=mask,
            kv_mask=km, sm_scale=scale, tie_scale=tie_scale,
        )  # (B, R, n, h, dh)
        return self.to_out(out.reshape(bt * r, n, h * dh))


class AxialAttention(nn.Module):
    """Axial attention over a (B, Hg, Wg, D) grid: a column pass
    (``attn_width``, over axis 1) plus a row pass (``attn_height``, over
    axis 2), summed. Without a context and untied rows the passes run on
    the grid (the JAX package's meshless grid route); with a broadcast
    ``context`` (B, Nc, D) or ``tie_row_attn`` they run on the flat
    (B*, n, D) route, the row pass tied across the Hg rows.

    ``sparse_attn`` makes both passes block-sparse ``SparseAttention``
    (``ops/sparse.py``; ``seq_len`` bounds the attended length and
    ``sparse_config`` gives the layout, ``BlockSparseConfig()`` by default).
    They take the grid route when both grid axes are multiples of the block
    size and the flat route, which pads to one, otherwise, as
    ``alphafold2_tpu/ops/attention.py:516-550`` decides. The module names
    stay ``attn_width``/``attn_height``, so a flax tree maps unchanged."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 tie_row_attn: bool = False, sparse_attn: bool = False,
                 seq_len: Optional[int] = None, sparse_config=None):
        super().__init__()
        self.tie_row_attn = tie_row_attn
        self.block_size = None
        if sparse_attn:
            from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, SparseAttention

            config = sparse_config or BlockSparseConfig()
            self.block_size = config.block_size
            make = lambda: SparseAttention(dim, heads, dim_head, seq_len=seq_len,
                                           config=config)
        else:
            make = lambda: Attention(dim, heads, dim_head)
        self.attn_width = make()
        self.attn_height = make()

    def forward(self, x, mask=None, context=None, context_mask=None):
        b, height, w, d = x.shape
        grid = context is None and not self.tie_row_attn
        if grid and self.block_size is not None:
            grid = height % self.block_size == 0 and w % self.block_size == 0
        if grid:
            return (self.attn_width.grid_axial(x, mask, attend_axis=1)
                    + self.attn_height.grid_axial(x, mask, attend_axis=2))

        def broadcast_ctx(n_batch):
            if context is None:
                return {}
            nc = context.shape[1]
            c = context[:, None].expand(b, n_batch // b, nc, context.shape[-1])
            cm = None
            if context_mask is not None:
                cm = context_mask[:, None].expand(b, n_batch // b, nc)
                cm = cm.reshape(n_batch, nc)
            return {"context": c.reshape(n_batch, nc, -1), "context_mask": cm}

        # column pass: attend over the height axis within each column
        w_x = x.transpose(1, 2).reshape(b * w, height, d)
        w_mask = (mask.transpose(1, 2).reshape(b * w, height)
                  if mask is not None else None)
        w_out = self.attn_width(w_x, mask=w_mask, **broadcast_ctx(b * w))
        w_out = w_out.reshape(b, w, height, d).transpose(1, 2)

        # row pass: attend over the width axis within each row (maybe tied)
        h_x = x.reshape(b * height, w, d)
        h_mask = mask.reshape(b * height, w) if mask is not None else None
        tie = {"tie_dim": height} if self.tie_row_attn else {}
        h_out = self.attn_height(h_x, mask=h_mask, **broadcast_ctx(b * height),
                                 **tie)
        return w_out + h_out.reshape(b, height, w, d)
