"""The reversible trunk: an inversion-based backward whose activation memory
does not grow with depth.

Port of ``alphafold2_tpu/models/reversible.py``: ``RevLayerPair`` (:63-194)
and ``ReversibleTrunk`` (:238-408), with JAX's ``custom_vjp`` scan
(:197-235) as the ``torch.autograd.Function`` :class:`ReversibleScan`. The
state is two copies of each stream, h = (x1, x2, m1, m2), and one depth
step is eight additive updates (:class:`RevLayerPair`, ``UPDATES``):

    self block:   x1 += f_s(x2);        x2 += g_s(x1)
                  m1 += j_s(m2);        m2 += k_s(m1)
    cross block:  x1 += f_c(x2, m2);    x2 += g_c(x1)
                  m1 += j_c(m2, x2);    m2 += k_c(m1)

Each update writes one stream from the others, so running the updates
backwards with subtraction inverts a step exactly. The forward runs every
layer under no gradient and keeps only the final state, the parameters and
the masks. The backward walks the layers, and each layer's updates, in
reverse: it evaluates each sub-function once, under ``torch.enable_grad`` on
detached inputs and detached parameter slices, and uses that output both to
undo the update and to pull the cotangent (``torch.autograd.grad``, the
cotangent cast to the output's dtype first), so every sub-function runs
twice a step in all, as in JAX and the reference.

The parameters are one RevLayerPair's with a leading depth axis
(``layers.<sub>.<...>``, flax's ``trunk/reversible/layers`` from
``self.param("layers", init_stack)``). The state is float32 under any
compute dtype: inversion computes (x + f) - f, and in bf16 that roundoff
would compound over 8 updates a layer. The sub-functions compute in
``dtype`` (their LayerNorms cast their output to it), and their outputs
promote to float32 on the add. ``use_custom_vjp=False`` runs the same
coupling under plain autograd: the oracle the tests hold the custom backward
to.

Under an active device mesh (``parallel/sharding.py use_mesh``; a ``(dp,
sp)`` mesh, JAX's ``RevLayerPair.__call__`` placing each update with
``shard_pair``/``shard_msa``, :167-185) the engine runs on this rank's
blocks as the loop trunk's layers do: the pair streams are the rank's
``(b, N/sp, N, D)`` block and the MSA streams its ``dp`` slice, whole.
``f_s`` takes the sharded pair axial pass (``pair_grid``), ``j_c``
(MSA<-pair) K1 with lse over the local pair keys merged across the ranks
(``Attention.forward_sharded_context``), and the other six run locally
(``f_c``'s keys, the MSA, are replicated). A grid mesh needs
``grid_parallel``, which the engine refuses, as JAX's does. The backward
re-enters the forward's mesh and kernel policy (it may run on autograd's
device thread), so every rank re-evaluates the same sub-functions in the
same order and reaches the collectives' transposes together; a replicated
stream's cotangent is held as partials, and the parameter gradients are
partials that ``train/loop.py reduce_gradients`` sums once.

Dropout: layer ``i``'s sub-function ``sub`` draws under the key
``trunk/reversible/layers/<sub>/...`` at index ``i``, whatever order the
sub-functions run in, so the forward, :meth:`RevLayerPair.invert` and the
backward's re-evaluation draw the same masks, as JAX's per-layer key does
(:305-340); the plain-autograd path uses the same keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from alphafold2_tpu_torch.models.trunk import depth_slice, stack_parameters
from alphafold2_tpu_torch.ops import kernels as kernel_policy
from alphafold2_tpu_torch.ops.attention import (
    Attention, AxialAttention, DropoutKey, FeedForward, child_key,
)
from alphafold2_tpu_torch.ops.layers import LayerNorm
from alphafold2_tpu_torch.parallel.sharding import active_mesh, use_mesh

# one depth step's updates in forward order: (stream written, sub-function,
# streams read), streams indexing h = (x1, x2, m1, m2)
UPDATES = (
    (0, "f_s", (1,)), (1, "g_s", (0,)), (2, "j_s", (3,)), (3, "k_s", (2,)),
    (0, "f_c", (1, 3)), (1, "g_c", (0,)), (2, "j_c", (3, 1)), (3, "k_c", (2,)),
)
# the submodules each sub-function reads
SUBMODULES = {
    "f_s": ("f_s_norm", "f_s"), "g_s": ("g_s_norm", "g_s"),
    "j_s": ("j_s_norm", "j_s"), "k_s": ("k_s_norm", "k_s"),
    "f_c": ("f_c_norm", "f_c_ctx_norm", "f_c"), "g_c": ("g_c_norm", "g_c"),
    "j_c": ("j_c_norm", "j_c_ctx_norm", "j_c"), "k_c": ("k_c_norm", "k_c"),
}


def _flat_mask(mask: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    return mask.reshape(b, -1) if mask is not None else None


class RevLayerPair(nn.Module):
    """One reversible depth step, [self-attention block, cross-attention
    block], over h = (x1, x2, m1, m2): ``forward`` is the coupling and
    :meth:`invert` its exact inverse. The submodules carry JAX's names."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 gelu_exact: bool = False, msa_tie_row_attn: bool = False,
                 sparse_attn: bool = False, seq_len: Optional[int] = None,
                 sparse_config=None, dtype: torch.dtype = torch.float32,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 cross_attn_compress_ratio: int = 1):
        super().__init__()
        self.dtype = dtype
        for names in SUBMODULES.values():
            for name in names[:-1]:
                self.add_module(name, LayerNorm(dim))
        ff = lambda: FeedForward(dim, gelu_exact=gelu_exact, dropout=ff_dropout)
        self.f_s = AxialAttention(dim, heads, dim_head, sparse_attn=sparse_attn,
                                  seq_len=seq_len, sparse_config=sparse_config,
                                  dropout=attn_dropout, pair_grid=True)
        self.g_s = ff()
        self.j_s = AxialAttention(dim, heads, dim_head, tie_row_attn=msa_tie_row_attn,
                                  dropout=attn_dropout)
        self.k_s = ff()
        # KV compression in f_c (pair <- MSA) only, as JAX builds it (:108)
        self.f_c = Attention(dim, heads, dim_head, dropout=attn_dropout,
                             compress_ratio=cross_attn_compress_ratio)
        self.g_c = ff()
        self.j_c = Attention(dim, heads, dim_head, dropout=attn_dropout)
        self.k_c = ff()

    def _norm(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(t).to(self.dtype)

    # --- the eight sub-functions: streams read, then (pair_mask, msa_mask),
    # then the sub-function's dropout key

    def _f_s(self, x2, pm, mm, key):
        return self.f_s(self._norm("f_s_norm", x2), mask=pm, key=key)

    def _g_s(self, x1, pm, mm, key):
        return self.g_s(self._norm("g_s_norm", x1), key=key)

    def _j_s(self, m2, pm, mm, key):
        return self.j_s(self._norm("j_s_norm", m2), mask=mm, key=key)

    def _k_s(self, m1, pm, mm, key):
        return self.k_s(self._norm("k_s_norm", m1), key=key)

    def _f_c(self, x2, m2, pm, mm, key):
        b, n, n2, d = x2.shape
        out = self.f_c(self._norm("f_c_norm", x2.reshape(b, n * n2, d)),
                       context=self._norm("f_c_ctx_norm", m2.reshape(b, -1, d)),
                       mask=_flat_mask(pm, b), context_mask=_flat_mask(mm, b), key=key)
        return out.reshape(x2.shape)

    def _g_c(self, x1, pm, mm, key):
        return self.g_c(self._norm("g_c_norm", x1), key=key)

    def _j_c(self, m2, x2, pm, mm, key):
        b, d = m2.shape[0], m2.shape[-1]
        q = self._norm("j_c_norm", m2.reshape(b, -1, d))
        ctx = self._norm("j_c_ctx_norm", x2.reshape(b, -1, d))
        mesh = active_mesh()
        if mesh is None:
            out = self.j_c(q, context=ctx, mask=_flat_mask(mm, b),
                           context_mask=_flat_mask(pm, b), key=key)
        else:  # the pair keys are this rank's block: K1 with lse, merged
            out = self.j_c.forward_sharded_context(q, ctx, mesh, mask=_flat_mask(mm, b),
                                                   context_mask=_flat_mask(pm, b))
        return out.reshape(m2.shape)

    def _k_c(self, m1, pm, mm, key):
        return self.k_c(self._norm("k_c_norm", m1), key=key)

    def forward(self, h: Sequence[torch.Tensor], pair_mask=None, msa_mask=None,
                sub: Optional[str] = None, key: Optional[DropoutKey] = None):
        """The coupling h -> h after the step's eight updates. With ``sub``
        (one of ``SUBMODULES``), that sub-function alone of the streams
        ``h`` it reads: the form ``torch.func.functional_call`` reaches.
        ``key`` is the layer's; each sub-function draws under its own name."""
        if sub is not None:
            return getattr(self, "_" + sub)(*h, pair_mask, msa_mask, child_key(key, sub))
        h = list(h)
        for t, name, reads in UPDATES:
            h[t] = h[t] + self(tuple(h[r] for r in reads), pair_mask, msa_mask, sub=name,
                               key=key)
        return tuple(h)

    def invert(self, h: Sequence[torch.Tensor], pair_mask=None, msa_mask=None,
               key: Optional[DropoutKey] = None):
        """The exact inverse of ``forward`` under the same ``key``: the
        updates in reverse order, with subtraction."""
        h = list(h)
        for t, name, reads in reversed(UPDATES):
            h[t] = h[t] - self(tuple(h[r] for r in reads), pair_mask, msa_mask, sub=name,
                               key=key)
        return tuple(h)


class ReversibleScan(torch.autograd.Function):
    """Every layer of a :class:`ReversibleTrunk` with the inversion-based
    backward: inputs ``(trunk, names, key, pair_mask, msa_mask, x1, x2, m1,
    m2, *stacked)``, ``stacked`` the depth-stacked parameters in ``names``'
    order, ``key`` the trunk's dropout key or None; outputs the final (x1,
    x2, m1, m2)."""

    @staticmethod
    def forward(ctx, trunk, names, key, pair_mask, msa_mask, *tensors):
        h, stacked = tensors[:4], tensors[4:]
        for i in range(trunk.depth):
            h = trunk.step(names, stacked, i, h, pair_mask, msa_mask, key)
        ctx.trunk, ctx.names, ctx.key = trunk, names, key
        ctx.mesh, ctx.policy = active_mesh(), kernel_policy.current_policy()
        # only the final state: activation memory independent of depth
        ctx.save_for_backward(pair_mask, msa_mask, *h, *stacked)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, *gh):
        pm, mm, *saved = ctx.saved_tensors
        h, stacked = list(saved[:4]), saved[4:]
        trunk, names = ctx.trunk, ctx.names
        gh = list(gh)
        grads = [torch.zeros_like(p) for p in stacked]
        owners = {sub: [k for k, n in enumerate(names) if n.split(".")[0] in mods]
                  for sub, mods in SUBMODULES.items()}
        for i in reversed(range(trunk.depth)):
            for t, sub, reads in reversed(UPDATES):
                own = owners[sub]
                leaves = [stacked[k][i].detach().requires_grad_() for k in own]
                inputs = [h[r].detach().requires_grad_() for r in reads]
                with (torch.enable_grad(), use_mesh(ctx.mesh),
                      kernel_policy.use_kernel_policy(ctx.policy)):
                    out = torch.func.functional_call(
                        trunk.layers, {names[k]: p for k, p in zip(own, leaves)},
                        (tuple(inputs), pm, mm),
                        {"sub": sub, "key": trunk.layer_key(ctx.key, i)})
                h[t] = h[t] - out.detach()
                pulled = torch.autograd.grad(out, leaves + inputs, gh[t].to(out.dtype),
                                             allow_unused=True)
                for k, g in zip(own, pulled):
                    if g is not None:
                        grads[k][i] += g
                for r, g in zip(reads, pulled[len(own):]):
                    if g is not None:
                        gh[r] = gh[r] + g
        return (None, None, None, None, None, *gh, *grads)


class ReversibleTrunk(nn.Module):
    """The reversible engine: ``depth`` coupled steps of one RevLayerPair
    with depth-stacked parameters (``layers``). Needs the MSA stream, as the
    reference does (its reversible.py:316). Returns float32 streams, the
    averages of each stream's two copies."""

    def __init__(self, dim: int, depth: int = 6, heads: int = 8, dim_head: int = 64,
                 gelu_exact: bool = False, msa_tie_row_attn: bool = False,
                 sparse_attn: bool = False, seq_len: Optional[int] = None,
                 sparse_config=None, use_custom_vjp: bool = True,
                 dtype: torch.dtype = torch.float32, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, cross_attn_compress_ratio: int = 1):
        super().__init__()
        self.depth, self.use_custom_vjp = depth, use_custom_vjp
        self.layers = stack_parameters(RevLayerPair(
            dim, heads, dim_head, gelu_exact=gelu_exact, msa_tie_row_attn=msa_tie_row_attn,
            sparse_attn=sparse_attn, seq_len=seq_len, sparse_config=sparse_config,
            dtype=dtype, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            cross_attn_compress_ratio=cross_attn_compress_ratio), depth)

    @staticmethod
    def layer_key(key: Optional[DropoutKey], i: int) -> Optional[DropoutKey]:
        """Layer ``i``'s dropout key under the trunk's (``reversible``)."""
        return None if key is None else key.child("layers").at(i)

    def step(self, names, stacked, i, h, pair_mask, msa_mask, key=None):
        """Depth step ``i`` of the coupling on h."""
        return torch.func.functional_call(self.layers, depth_slice(names, stacked, i),
                                          (h, pair_mask, msa_mask),
                                          {"key": self.layer_key(key, i)})

    def forward(self, x, m, pair_mask=None, msa_mask=None,
                key: Optional[DropoutKey] = None):
        if m is None:
            raise ValueError("ReversibleTrunk requires the MSA stream (reference "
                             "reversible.py:316); use Trunk(remat=True) without one")
        x, m = x.float(), m.float()
        names, stacked = zip(*self.layers.named_parameters())
        if self.use_custom_vjp:
            x1, x2, m1, m2 = ReversibleScan.apply(self, names, key, pair_mask, msa_mask,
                                                  x, x, m, m, *stacked)
        else:
            h = (x, x, m, m)
            for i in range(self.depth):
                h = self.step(names, stacked, i, h, pair_mask, msa_mask, key)
            x1, x2, m1, m2 = h
        return 0.5 * (x1 + x2), 0.5 * (m1 + m2)
