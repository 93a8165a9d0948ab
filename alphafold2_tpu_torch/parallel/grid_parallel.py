"""2D sharding of the pair grid: rows x columns, with all-to-all transposes.

Port of ``alphafold2_tpu/parallel/grid_parallel.py`` on explicit
collectives. The pair grid (B, N, N, D) rests as ``(B/dp, N/spr, N/spc)``
blocks; an axial pass needs the whole attended axis on one rank, so each
pass trades a factor of the other axis for it and back:

    at rest:   (b, N/spr, N/spc, ...)
    row pass:  all_to_all over spc ->  (b, N/(spr*spc), N, ...)   attend columns
    col pass:  all_to_all over spr ->  (b, N, N/(spr*spc), ...)   attend rows

Each transpose is one ``all_to_all_single`` over the attended axis's
sub-group (``parallel/sharding.py all_to_all``). Per-rank pair memory is
O(N^2 / (spr*spc)).

The 1D ``(dp, sp)`` mesh, which JAX's ``serve_fwd_long`` shards by GSPMD
from the ``P(dp, sp)`` constraint, runs the same code with ``sp`` as the
row axis and one column shard: the row pass needs no collective there, the
column pass one all_to_all over ``sp``.

``attn_fn`` is the per-rank kernel hook: it takes the gathered rows as
``(B*R, H, N, D)`` q/k/v and a ``(B*R, N)`` key mask (or None) and returns
the attended values in that layout, or None to decline. The model passes
K1 (``ops/cuda/axial.py fused_attention``) there on the card, K4 on the
sparse passes. Without a hook the pass is JAX's dense jnp formulation
(additive ``MASK_VALUE`` bias, f32 softmax).
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.parallel.sharding import (
    COL_AXIS, DATA_AXIS, ROW_AXIS, all_to_all, build_mesh, pair_layout,
)

MASK_VALUE = -1e9


def make_grid_mesh(n_data: int = 1, n_row: int = 1, n_col: int = 1):
    """A ``(dp, spr, spc)`` mesh over every rank of the process group; the
    ranks fill it row-major, so ``spc`` neighbours are neighbouring ranks."""
    return build_mesh((n_data, n_row, n_col), (DATA_AXIS, ROW_AXIS, COL_AXIS))


def grid_spec() -> tuple:
    """The at-rest layout of (B, H, W, ...) grid arrays on a grid mesh."""
    return (DATA_AXIS, ROW_AXIS, COL_AXIS)


def _attend_last_grid_axis(q, k, v, mask, attn_fn=None):
    """Attention over grid axis 2: q/k/v (B, R, N, H, D), mask (B, R, N)
    key validity or None; the R rows are independent problems."""
    b, r, n, h, d = q.shape
    if attn_fn is not None:
        accepts = getattr(attn_fn, "accepts", None)
        if accepts is None or accepts(b * r, h, n):
            def flat(t):  # (B, R, N, H, D) -> (B*R, H, N, D)
                return t.reshape(b * r, n, h, d).transpose(1, 2)

            m2 = mask.reshape(b * r, n) if mask is not None else None
            out = attn_fn(flat(q), flat(k), flat(v), m2)
            if out is not None:
                return out.transpose(1, 2).reshape(b, r, n, h, d)
    dots = torch.einsum("brihd,brjhd->brhij", q, k).float() * d**-0.5
    if mask is not None:
        bias = torch.where(mask, 0.0, MASK_VALUE)
        dots = dots + bias[:, :, None, None, :].float()
    attn = torch.softmax(dots, dim=-1).to(q.dtype)
    return torch.einsum("brhij,brjhd->brihd", attn, v)


def _sharded_pass(q, k, v, mask, mesh, attend_axis: int, attn_fn=None):
    """One pass on this rank's blocks q/k/v (b, hl, wl, H, D), mask
    (b, hl, wl) or None."""
    lay = pair_layout(mesh)
    if attend_axis == 2:
        axis, split = lay.col_axis, 1
    else:
        axis, split = lay.row_axis, 2

    def gather(t):  # trade the non-attended axis for the whole attended one
        return all_to_all(t, mesh, axis, split, attend_axis) if axis else t

    def scatter(t):
        return all_to_all(t, mesh, axis, attend_axis, split) if axis else t

    q, k, v = gather(q), gather(k), gather(v)
    if mask is not None:
        mask = gather(mask)
    if attend_axis == 1:  # the attended axis last for the shared pass
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        mask = mask.transpose(1, 2) if mask is not None else None
    out = _attend_last_grid_axis(q, k, v, mask, attn_fn=attn_fn)
    del q, k, v
    if attend_axis == 1:
        out = out.transpose(1, 2)
    return scatter(out)


def grid_axial_attention(
    q: torch.Tensor,  # (B, H, W, heads, dh): this rank's block under a mesh
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, H, W) bool key validity
    mesh=None,
    attend_axis: int = 2,
    attn_fn=None,
) -> torch.Tensor:
    """One axial attention pass over a pair grid: ``attend_axis=2`` within
    rows (over columns), ``1`` within columns (over rows). Without a mesh
    the arrays are the whole grid; with one they are this rank's block
    (``sharding.pair_layout``) and the attended axis is gathered by an
    all_to_all over its sub-group, attended with ``attn_fn`` and scattered
    back. The local axis the transpose splits must divide by that
    sub-group's size, as JAX requires."""
    if attend_axis not in (1, 2):
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    if mesh is None:
        if attend_axis == 1:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mt = mask.transpose(1, 2) if mask is not None else None
            out = _attend_last_grid_axis(qt, kt, vt, mt, attn_fn=attn_fn)
            return out.transpose(1, 2)
        return _attend_last_grid_axis(q, k, v, mask, attn_fn=attn_fn)
    lay = pair_layout(mesh)
    size, split = (lay.n_col, 1) if attend_axis == 2 else (lay.n_row, 2)
    name = lay.col_axis if attend_axis == 2 else lay.row_axis
    if q.shape[split] % size:
        raise ValueError(
            f"non-attended local axis {q.shape[split]} must divide by mesh axis "
            f"{name}={size} for the all-to-all transpose")
    return _sharded_pass(q, k, v, mask, mesh, attend_axis, attn_fn=attn_fn)
