"""SE(3)-equivariant refiner over atom point clouds (degrees 0 and 1).

Port of ``alphafold2_tpu/models/se3.py``: :func:`radial_basis`,
:class:`EquivariantLayer` (the dense path, :116-158, and the streamed path,
:160-282), :class:`SE3Transformer`, :class:`SE3TemplateEmbedder` (:304,
the templates' sidechain coloring) and :class:`SE3Refiner`. Attention
logits come from scalars and RBF(distance) only, so the layer is
equivariant by construction. Past :func:`should_chunk` (``CHUNK_THRESHOLD``
edge elements, the JAX package's 2**28) the layer streams the edge
attention in (q block, kv chunk) tiles with an exact online softmax, as the
JAX layer does; both paths share one set of parameters. The edge attention
holds no TPU kernel (the JAX original is plain XLA), so both paths are
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm

MASK_VALUE = -1e9
CHUNK_THRESHOLD = 2**28  # alphafold2_tpu/ops/chunked.py CHUNK_THRESHOLD


def should_chunk(batch_heads: int, nq: int, nk: int) -> bool:
    """True when the dense (batch*heads, Nq, Nk) edge tensor is past the
    streaming threshold (a threshold of 0 or less never streams)."""
    if CHUNK_THRESHOLD <= 0:
        return False
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
    (B, N, ds), vectors v (B, N, dv, 3), coords (B, N, 3). ``edge_block``
    is the q-block and kv-chunk edge of the streamed path."""

    def __init__(self, dim: int, vec_dim: int = 16, heads: int = 4,
                 num_basis: int = 16, edge_block: int = 1024):
        super().__init__()
        self.dim, self.vec_dim, self.heads, self.num_basis = dim, vec_dim, heads, num_basis
        self.edge_block = edge_block
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
        dt = s.dtype
        sn = self.s_norm(s)
        q = self.q(sn).view(b, n, h, dh)
        k = self.k(sn).view(b, n, h, dh)
        vals = self.val(sn).view(b, n, h, dh)
        v_mix = self.v_mix(v.transpose(-1, -2).to(dt)).transpose(-1, -2)  # (B, N, dv, 3)

        if should_chunk(b * self.num_basis, n, n):
            s_agg, v_nbr, v_rel = self._streamed_attention(q, k, vals, v_mix, coords, mask)
        else:
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

    def _streamed_attention(self, q, k, vals, v_mix, coords, mask):
        """The edge attention in (q block, kv chunk) tiles of ``edge_block``
        edges, as ``_streamed_attention`` of the JAX layer computes it: n is
        zero-padded to a multiple of the block and padded atoms are masked
        keys; per tile the rel/dist/unit/RBF features, the ``rbf_bias`` and
        ``edge_gate`` layers and the pair mask; one running (max, sum) per
        (batch, head, query) shared by the scalar, neighbour-vector and
        gated-direction sums, all f32. Only one tile's edge tensors are live:
        the (B, blk, blk, num_basis) RBF tile is the largest.

        A query row with every pair masked averages uniformly over the n_p
        padded keys here (the dense path averages over n); callers mask
        such rows."""
        b, n, h, dh = q.shape
        dv = self.vec_dim
        dt = q.dtype
        f32 = torch.float32
        blk = min(self.edge_block, n)
        pad = (-n) % blk
        n_p = n + pad
        valid = mask if mask is not None else torch.ones((b, n), dtype=torch.bool,
                                                         device=q.device)

        def pad_n(t):  # zero rows past n; padded atoms are masked keys
            return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

        q, k, vals, v_mix, coords, valid = (pad_n(t) for t in (q, k, vals, v_mix, coords, valid))
        s_out = torch.empty((b, n_p, self.dim), dtype=dt, device=q.device)
        nbr_out = torch.empty((b, n_p, dv, 3), dtype=v_mix.dtype, device=q.device)
        rel_out = torch.empty_like(nbr_out)
        for i0 in range(0, n_p, blk):
            qi, ci, mi = q[:, i0:i0 + blk], coords[:, i0:i0 + blk], valid[:, i0:i0 + blk]
            m_run = torch.full((b, h, blk), float("-inf"), dtype=f32, device=q.device)
            l_run = torch.zeros((b, h, blk), dtype=f32, device=q.device)
            acc_s = torch.zeros((b, h, blk, dh), dtype=f32, device=q.device)
            acc_nbr = torch.zeros((b, h, blk, dv * 3), dtype=f32, device=q.device)
            acc_rel = torch.zeros((b, h, blk, dv, 3), dtype=f32, device=q.device)
            for j0 in range(0, n_p, blk):
                cj, mj = coords[:, j0:j0 + blk], valid[:, j0:j0 + blk]
                rel = ci[:, :, None, :] - cj[:, None, :, :]  # (B, blk_i, blk_j, 3)
                dist = _safe_norm(rel)
                unit = (rel / dist[..., None]).to(f32)
                rbf = radial_basis(dist, self.num_basis).to(dt)
                logits = torch.einsum("bihd,bjhd->bhij", qi, k[:, j0:j0 + blk]) * dh**-0.5
                logits = logits + self.rbf_bias(rbf).permute(0, 3, 1, 2)
                pair = mj[:, None, None, :] & mi[:, None, :, None]
                logits = logits.masked_fill(~pair, MASK_VALUE).to(f32)
                m_new = torch.maximum(m_run, logits.amax(dim=-1))
                p = torch.exp(logits - m_new[..., None])
                r = torch.exp(m_run - m_new)
                l_run = l_run * r + p.sum(dim=-1)
                m_run = m_new
                acc_s = acc_s * r[..., None] + torch.matmul(
                    p, vals[:, j0:j0 + blk].to(f32).transpose(1, 2))
                acc_nbr = acc_nbr * r[..., None] + torch.matmul(
                    p, v_mix[:, j0:j0 + blk].to(f32).reshape(b, 1, -1, dv * 3))
                # sum_j p[b,h,i,j] gate[b,i,j,c] unit[b,i,j,d], one d at a
                # time: a (B, blk, blk, dv) product, never (B, h, blk, blk, dv, 3)
                gate = self.edge_gate(rbf).to(f32)
                del rbf
                pt = p.permute(0, 2, 1, 3)  # (B, blk_i, h, blk_j)
                acc_rel = acc_rel * r[..., None, None] + torch.stack(
                    [torch.matmul(pt, gate * unit[..., d:d + 1]).transpose(1, 2)
                     for d in range(3)], dim=-1)
            inv_l = 1.0 / l_run.clamp_min(1e-30)
            s_out[:, i0:i0 + blk] = (acc_s * inv_l[..., None]).transpose(1, 2).reshape(
                b, blk, self.dim).to(dt)
            nbr_out[:, i0:i0 + blk] = (acc_nbr * inv_l[..., None]).mean(dim=1).view(
                b, blk, dv, 3).to(nbr_out.dtype)
            rel_out[:, i0:i0 + blk] = (acc_rel * inv_l[..., None, None]).mean(dim=1).to(
                rel_out.dtype)
        return s_out[:, :n], nbr_out[:, :n], rel_out[:, :n]


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


class SE3TemplateEmbedder(nn.Module):
    """Residue scalars s (B, N, dim) colored by one sidechain vector a
    residue (B, N, 3) at coords (B, N, 3): the sidechain lifts to
    ``vec_dim`` channels by the raw per-channel scales ``sidechain_proj``
    (flax's ``param``, drawn N(0, 1)), then ``net`` runs and only its
    scalars come back, (B, N, dim) in s's dtype. Its layers take the dense
    or the streamed edge attention as the refiner's do."""

    def __init__(self, dim: int, depth: int = 2, vec_dim: int = 8):
        super().__init__()
        self.sidechain_proj = nn.Parameter(torch.zeros(vec_dim))
        self.net = SE3Transformer(dim, depth, vec_dim)

    def forward(self, s, sidechain, coords, mask=None):
        v = sidechain[:, :, None, :] * self.sidechain_proj.to(sidechain.dtype)[None, None, :, None]
        s, _ = self.net(s, v, coords, mask=mask)
        return s


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
