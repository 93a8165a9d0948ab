"""SE(3)-equivariant refiner over atom point clouds (degrees 0 and 1).

Port of ``alphafold2_tpu/models/se3.py``: :func:`radial_basis`,
:class:`EquivariantLayer` (the dense path, :116-158),
:class:`SE3Transformer` and :class:`SE3Refiner`. Attention logits come
from scalars and RBF(distance) only, so the layer is equivariant by
construction. Past ``should_chunk`` (2**28 edge elements, the JAX
package's threshold) the JAX layer streams the edge attention
(:160-282); that path is not ported yet and the layer raises there.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm

MASK_VALUE = -1e9
CHUNK_THRESHOLD = 2**28  # alphafold2_tpu/ops/chunked.py CHUNK_THRESHOLD


def should_chunk(batch_heads: int, nq: int, nk: int) -> bool:
    return int(batch_heads) * int(nq) * int(nk) >= CHUNK_THRESHOLD


def _safe_norm(v: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim) + eps)


def radial_basis(dist: torch.Tensor, num_basis: int = 16, max_dist: float = 20.0):
    centers = torch.linspace(0.0, max_dist, num_basis, device=dist.device,
                             dtype=dist.dtype)
    width = max_dist / num_basis
    return torch.exp(-(((dist[..., None] - centers) / width) ** 2))


class EquivariantLayer(nn.Module):
    """Invariant attention + scalar/vector residual updates. Scalars s
    (B, N, ds), vectors v (B, N, dv, 3), coords (B, N, 3)."""

    def __init__(self, dim: int, vec_dim: int = 16, heads: int = 4,
                 num_basis: int = 16):
        super().__init__()
        self.dim, self.vec_dim, self.heads, self.num_basis = dim, vec_dim, heads, num_basis
        self.rbf_bias = Dense(num_basis, heads)
        self.edge_gate = Dense(num_basis, vec_dim)
        self.s_norm = LayerNorm(dim)
        self.q = Dense(dim, dim, bias=False)
        self.k = Dense(dim, dim, bias=False)
        self.val = Dense(dim, dim, bias=False)
        self.v_mix = Dense(vec_dim, vec_dim, bias=False)
        self.s_out = Dense(dim + vec_dim, dim)
        self.gates = Dense(dim, 3 * vec_dim)
        self.s_norm2 = LayerNorm(dim)

    def forward(self, s, v, coords, mask: Optional[torch.Tensor] = None):
        b, n, ds = s.shape
        h = self.heads
        dh = self.dim // h
        if should_chunk(b * self.num_basis, n, n):
            raise NotImplementedError(
                f"{b} x {n} atoms pass the streaming threshold: the streamed "
                "SE(3) edge attention (alphafold2_tpu/models/se3.py "
                "_streamed_attention) is not ported yet"
            )
        dt = s.dtype
        sn = self.s_norm(s)
        q = self.q(sn).view(b, n, h, dh)
        k = self.k(sn).view(b, n, h, dh)
        vals = self.val(sn).view(b, n, h, dh)
        v_mix = self.v_mix(v.transpose(-1, -2).to(dt)).transpose(-1, -2)  # (B, N, dv, 3)

        rel = coords[:, :, None, :] - coords[:, None, :, :]
        dist = _safe_norm(rel)
        unit = rel / dist[..., None]
        rbf = radial_basis(dist, self.num_basis).to(dt)

        logits = torch.einsum("bihd,bjhd->bhij", q, k) * dh**-0.5
        logits = logits + self.rbf_bias(rbf).permute(0, 3, 1, 2)
        if mask is not None:
            pair = mask[:, None, None, :] & mask[:, None, :, None]
            logits = logits.masked_fill(~pair, MASK_VALUE)
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        attn_mean = attn.mean(dim=1)

        s_agg = torch.einsum("bhij,bjhd->bihd", attn, vals).reshape(b, n, self.dim)
        v_nbr = torch.einsum("bij,bjcd->bicd", attn_mean, v_mix)
        v_rel = torch.einsum("bij,bijc,bijd->bicd", attn_mean,
                             self.edge_gate(rbf), unit.to(dt))

        v_norms = _safe_norm(v)
        s = s + self.s_out(torch.cat([s_agg, v_norms.to(dt)], dim=-1))
        g_self, g_nbr, g_rel = self.gates(self.s_norm2(s)).chunk(3, dim=-1)
        v = v + (g_self[..., None] * v_mix + g_nbr[..., None] * v_nbr
                 + g_rel[..., None] * v_rel).to(v.dtype)
        return s, v


class SE3Transformer(nn.Module):
    def __init__(self, dim: int, depth: int = 4, vec_dim: int = 16, heads: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", EquivariantLayer(dim, vec_dim, heads))

    def forward(self, s, v, coords, mask=None):
        for i in range(self.depth):
            s, v = getattr(self, f"layer_{i}")(s, v, coords, mask=mask)
        return s, v


class SE3Refiner(nn.Module):
    """tokens (B, N) and proto coords (B, N, 3) -> refined coords
    coords + equivariant delta (zero on masked atoms)."""

    def __init__(self, dim: int = 64, depth: int = 2, vec_dim: int = 8,
                 num_tokens: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vec_dim = vec_dim
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.net = SE3Transformer(dim, depth, vec_dim)
        self.to_delta = Dense(vec_dim, 1, bias=False)

    def forward(self, tokens, coords, mask=None):
        s = self.token_emb(tokens).to(self.dtype)
        v = torch.zeros((*coords.shape[:2], self.vec_dim, 3), dtype=coords.dtype,
                        device=coords.device)
        s, v = self.net(s, v, coords, mask=mask)
        delta = self.to_delta(v.transpose(-1, -2).to(self.dtype))[..., 0]
        if mask is not None:
            delta = torch.where(mask[..., None], delta, torch.zeros_like(delta))
        return coords + delta.to(coords.dtype)
