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

Dropout (JAX :84-95, :118-129, :243-248, :374-411, :505-520) is active
where a module's rate is above 0 and its forward is given a
:class:`DropoutKey`: a training step passes one, and ``predict``, serving
and evaluation never do, as JAX passes ``deterministic=True`` there. The
key names the site by its flax path, so a mask is a pure function of
(seed, step, site): remat's recompute and the reversible backward's
re-evaluation draw the same masks, and a resumed run those of an
uninterrupted one. ``FeedForward`` drops its gated hidden. Under active
attention dropout ``Attention`` takes JAX's dense route, as JAX's
condition (``dropout == 0.0 or deterministic``) selects it there: masked
logits, an f32 softmax cast to the compute dtype, dropout, then P·V, with
one mask per (b, h, i, j) shared by all R tied rows. Those logits and P·V
are the matrix products JAX computes outside any Pallas kernel. Without
active attention dropout every path runs the kernels.

KV compression (``Attention(compress_ratio=r)``, r > 1, cross-attention
only, JAX :119-138 and :211-234): ``kv_compress`` is a grouped ``conv1d``
of kernel and stride r, one group a head, no padding, with bias, computing
in the input's dtype as flax's ``nn.Conv(dtype=...)`` does. One conv is
shared by k and v. Both are right-padded with zeros to a multiple of r
after ``to_kv``, then convolved; the context mask is padded with False and
pooled by "any valid", and without a context mask the padded tail alone is
masked (no mask at all where nothing is padded). The compressed k and v go
to K1 (K3a/K3b under autograd), or to the dense route under active
attention dropout, as JAX's ``fused_ok`` routes them.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch.ops.cuda.axial import fused_attention
from alphafold2_tpu_torch.ops.cuda.tied_row import tied_row_attention
from alphafold2_tpu_torch.ops.layers import Dense


MASK_VALUE = -1e9  # the masked logit of JAX's dense route
_M64 = (1 << 64) - 1


def _mix(*values: int) -> int:
    """A 64-bit hash of integers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = ((h ^ (v & _M64)) + 0x9E3779B97F4A7C15) & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Where a dropout site draws its mask: the step's ``seed``, the site's
    flax ``path`` (``trunk/layer_3/msa_ff``) and, in the stacked engines,
    the layer ``index`` (``trunk/scan/layer`` at layer 3). The counterpart
    of flax's dropout rng, folded by module path."""

    seed: int
    path: str = ""
    index: Optional[int] = None

    @classmethod
    def for_step(cls, seed: int, step: int) -> "DropoutKey":
        """Step ``step``'s key of a run seeded ``seed`` (the loops pass
        ``train.seed + 1``, as JAX splits ``key(seed + 1)`` a step)."""
        return cls(_mix(seed, step))

    def child(self, name: str) -> "DropoutKey":
        return dataclasses.replace(self, path=f"{self.path}/{name}" if self.path else name)

    def at(self, index: int) -> "DropoutKey":
        return dataclasses.replace(self, index=index)

    def generator(self, device: torch.device) -> torch.Generator:
        """A generator on ``device`` seeded from (seed, crc32(path), index)."""
        idx = -1 if self.index is None else self.index
        gen = torch.Generator(device=device)
        gen.manual_seed(_mix(self.seed, zlib.crc32(self.path.encode()), idx))
        return gen


def child_key(key: Optional[DropoutKey], name: str) -> Optional[DropoutKey]:
    return None if key is None else key.child(name)


def dropout(x: torch.Tensor, rate: float, key: Optional[DropoutKey]) -> torch.Tensor:
    """flax's ``nn.Dropout`` when active (``rate > 0`` and a key): keep
    each entry with probability 1 - rate and divide it by that in ``x``'s
    dtype, zeros at rate 1; ``x`` itself otherwise. The mask comes from
    ``key``'s generator on ``x``'s device, never the global RNG."""
    if rate == 0.0 or key is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=key.generator(x.device), device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


def _dense_attend(q, k, v, scale, pair: Optional[torch.Tensor], rate: float,
                  key: DropoutKey, tie_dim: Optional[int]) -> torch.Tensor:
    """JAX's dense route (``ops/attention.py:374-411``): q/k/v (B, n, H, d),
    or (B, R, n, H, d) with ``tie_dim``, ``scale`` a number or a (B,) tensor;
    ``pair`` (B, n, j) marks the valid (query, key) pairs. Logits masked to
    ``MASK_VALUE``, softmax in f32 cast to the compute dtype, dropout, P·V.
    Returns (B, n, H, d) or (B, R, n, H, d)."""
    if tie_dim is None:
        dots = torch.einsum("bihd,bjhd->bhij", q, k)
    else:
        dots = torch.einsum("brihd,brjhd->bhij", q, k)
    if isinstance(scale, torch.Tensor):
        scale = scale.to(dots.dtype)[:, None, None, None]
    dots = dots * scale
    if pair is not None:
        dots = dots.masked_fill(~pair[:, None], MASK_VALUE)
    attn = dropout(torch.softmax(dots.float(), dim=-1).to(q.dtype), rate, key)
    if tie_dim is None:
        return torch.einsum("bhij,bjhd->bihd", attn, v)
    return torch.einsum("bhij,brjhd->brihd", attn, v)


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
        self.dropout = dropout
        inner = dim * mult
        self.wi = Dense(dim, inner * 2)
        self.wo = Dense(inner, dim)
        self.approximate = "none" if gelu_exact else "tanh"

    def forward(self, x: torch.Tensor, key: Optional[DropoutKey] = None) -> torch.Tensor:
        h, gates = self.wi(x).chunk(2, dim=-1)
        h = dropout(h * F.gelu(gates, approximate=self.approximate), self.dropout, key)
        return self.wo(h)


def _pair_mask(q_mask, kv_mask, n: int, j: int) -> Optional[torch.Tensor]:
    """(B, n, j) valid (query, key) pairs, or None without masks."""
    if q_mask is None and kv_mask is None:
        return None
    qm = q_mask if q_mask is not None else kv_mask.new_ones((kv_mask.shape[0], n))
    km = kv_mask if kv_mask is not None else q_mask.new_ones((q_mask.shape[0], j))
    return qm[:, :, None] & km[:, None, :]


class Attention(nn.Module):
    """Multi-head attention: self, cross (``context``), and tied rows
    (``tie_dim``) with abstention masking and the voting-row tie scale.
    ``dropout`` is the attention-weight dropout rate; with a ``key`` the
    forward takes the dense route. ``compress_ratio`` above 1 compresses a
    cross-attention's keys and values (module docstring)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 compress_ratio: int = 1,
                 context_parallel: Optional[str] = None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        if context_parallel is not None:
            raise NotImplementedError("context parallelism is not ported yet")
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.compress_ratio = compress_ratio
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, inner * 2, bias=False)
        self.to_out = Dense(inner, dim)
        if compress_ratio > 1:
            self.kv_compress = nn.Conv1d(inner, inner, compress_ratio, stride=compress_ratio,
                                         groups=heads)

    def _compress(self, k, v, context_mask):
        """k, v (*lead, j, inner) -> (*lead, ceil(j/r), inner), and the
        pooled context mask (module docstring). The conv's kernel equals its
        stride, so it is one matmul per head over each block's r tokens:
        channels-last in and out, and under the matmul precision switch the
        Dense layers follow (cuDNN's convolutions would take TF32 for f32)."""
        r, h = self.compress_ratio, self.heads
        lead, j, inner = k.shape[:-2], k.shape[-2], k.shape[-1]
        pad = (-j) % r
        # (out, in/groups, r) -> (H, out/H, in/H, r): group h maps channels
        # h*dh.. of a block's r tokens onto output channels h*dh..
        w = self.kv_compress.weight.to(k.dtype).view(h, inner // h, inner // h, r)
        b = self.kv_compress.bias.to(k.dtype).view(h, inner // h)

        def conv(t):
            t = F.pad(t.reshape(-1, j, inner), (0, 0, 0, pad))
            blocks = t.view(t.shape[0], -1, r, h, inner // h)  # (N, j/r, r, H, dh)
            out = torch.einsum("ntshi,hois->ntho", blocks, w) + b
            return out.reshape(*lead, -1, inner)

        if context_mask is None and pad:
            context_mask = torch.ones((*lead, j), dtype=torch.bool, device=k.device)
        if context_mask is not None:
            cm = F.pad(context_mask, (0, pad), value=False)
            context_mask = cm.reshape(*cm.shape[:-1], -1, r).any(-1)
        return conv(k), conv(v), context_mask

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
                tie_dim: Optional[int] = None, key: Optional[DropoutKey] = None):
        h, dh = self.heads, self.dim_head
        has_context = context is not None
        ctx = context if has_context else x
        lead, n = tuple(x.shape[:-2]), x.shape[-2]
        j = ctx.shape[-2]
        q = self.to_q(x).view(*lead, n, h, dh)
        k, v = self.to_kv(ctx).chunk(2, -1)
        if self.compress_ratio > 1:
            if not has_context:
                raise ValueError("KV compression is for cross-attention only")
            k, v, context_mask = self._compress(k, v, context_mask)
            j = k.shape[-2]
        k, v = (t.view(*ctx.shape[:-2], j, h, dh) for t in (k, v))
        scale = dh**-0.5
        dense = self.dropout > 0.0 and key is not None  # JAX's fused_ok, negated

        if tie_dim is None:
            kv_mask = context_mask
            if kv_mask is None and not has_context:
                kv_mask = mask
            if dense:
                out = _dense_attend(q, k, v, scale, _pair_mask(mask, kv_mask, n, j),
                                    self.dropout, key, None)
                return self.to_out(out.reshape(*lead, n, h * dh))
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
        if dense:
            out = _dense_attend(q, k, v, scale * tie_scale, _pair_mask(mask, km, n, j),
                                self.dropout, key, r)
            return self.to_out(out.reshape(bt * r, n, h * dh))
        out = tied_row_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), q_mask=mask,
            kv_mask=km, sm_scale=scale, tie_scale=tie_scale,
        )  # (B, R, n, h, dh)
        return self.to_out(out.reshape(bt * r, n, h * dh))


class AxialAttention(nn.Module):
    """Axial attention over a (B, Hg, Wg, D) grid: a column pass
    (``attn_width``, over axis 1) plus a row pass (``attn_height``, over
    axis 2), summed. Without a context, untied rows and no active attention
    dropout the passes run on the grid (the JAX package's meshless grid
    route); with a broadcast ``context`` (B, Nc, D), ``tie_row_attn`` or
    ``dropout`` above 0 with a ``key`` they run on the flat (B*, n, D)
    route, the row pass tied across the Hg rows.

    ``sparse_attn`` makes both passes block-sparse ``SparseAttention``
    (``ops/sparse.py``; ``seq_len`` bounds the attended length and
    ``sparse_config`` gives the layout, ``BlockSparseConfig()`` by default).
    They take the grid route when it is open and both grid axes are
    multiples of the block size, and the flat route, which pads to one,
    otherwise, as ``alphafold2_tpu/ops/attention.py:505-550`` decides. The
    module names stay ``attn_width``/``attn_height``, so a flax tree maps
    unchanged."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 tie_row_attn: bool = False, sparse_attn: bool = False,
                 seq_len: Optional[int] = None, sparse_config=None, dropout: float = 0.0):
        super().__init__()
        self.tie_row_attn = tie_row_attn
        self.dropout = dropout
        self.block_size = None
        if sparse_attn:
            from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, SparseAttention

            config = sparse_config or BlockSparseConfig()
            self.block_size = config.block_size
            make = lambda: SparseAttention(dim, heads, dim_head, dropout=dropout,
                                           seq_len=seq_len, config=config)
        else:
            make = lambda: Attention(dim, heads, dim_head, dropout=dropout)
        self.attn_width = make()
        self.attn_height = make()

    def forward(self, x, mask=None, context=None, context_mask=None,
                key: Optional[DropoutKey] = None):
        b, height, w, d = x.shape
        grid = (context is None and not self.tie_row_attn
                and (self.dropout == 0.0 or key is None))
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
        w_out = self.attn_width(w_x, mask=w_mask, key=child_key(key, "attn_width"),
                                **broadcast_ctx(b * w))
        w_out = w_out.reshape(b, w, height, d).transpose(1, 2)

        # row pass: attend over the width axis within each row (maybe tied)
        h_x = x.reshape(b * height, w, d)
        h_mask = mask.reshape(b * height, w) if mask is not None else None
        tie = {"tie_dim": height} if self.tie_row_attn else {}
        h_out = self.attn_height(h_x, mask=h_mask, key=child_key(key, "attn_height"),
                                 **broadcast_ctx(b * height), **tie)
        return w_out + h_out.reshape(b, height, w, d)
