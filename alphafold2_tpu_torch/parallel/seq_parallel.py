"""Sequence parallelism: ring attention, Ulysses, and merging partials.

Port of ``alphafold2_tpu/parallel/seq_parallel.py`` on explicit
collectives, for ranks that each hold a block of the sequence axis:

- :func:`ring_attention` passes each rank's key/value block one hop along
  the ``sp`` ring per step (``batch_isend_irecv``, ``sharding.ring_shift``)
  and folds each visiting block into a running max, sum and accumulator in
  f32, as JAX's ``:59-102`` does; each visit is one K1 call with its row
  logsumexp (``ops/cuda/axial.py fused_attention_lse``), so the per-block
  probabilities never leave the kernel. Exact attention, O(N/sp) keys a
  rank.
- :func:`ulysses_attention` re-shards sequence to heads with one
  all_to_all, runs K1 over the whole sequence for H/sp heads, and
  all_to_alls back; heads must divide by ``sp``.
- :func:`merge_partials` merges per-rank (output, logsumexp) pairs of one
  query set over disjoint key sets (one all_reduce of the max, one of the
  rescaled sums): exact, and what the MSA<-pair cross-attention uses, whose
  keys are the rank's block of the pair grid.

Each is differentiable: K1 with lse is (``FusedAttentionLse``: K3a/K3b run
with dsum less the lse's cotangent), and so is every collective
(``parallel/sharding.py``). The ring's backward passes the cotangents of
the visiting keys and values back along the ring, the way JAX
differentiates its ``scan`` over ``ppermute``; a merge's running max is a
stabiliser and carries no gradient.

- :func:`tied_row_attention_sharded` and :func:`tied_row_attention` are
  JAX's tied-row attention on MSA rows sharded over a mesh axis
  (``:133-191``): each rank contracts its own rows' logits and one
  all-reduce over the row axis completes them, where JAX's ``_tied_core``
  psums. The passes are K2's split route (``ops/cuda/tied_row.py``
  ``tied_split_*``: logits, softmax, products), and
  :class:`TiedRowsSharded` is differentiable over them: its backward
  all-reduces dP and dsum over the row axis, then runs the grad and
  product passes from the saved whole logits (so the backward repeats no
  logits over q and k and no second all-reduce of them). The model's tied
  MSA row pass runs it under ``msa_row_shard`` (``ops/attention.py``).
- :func:`merge_partials_rows` is :func:`merge_partials` for queries whose
  rows each rank holds a block of (the MSA<-pair pass under
  ``msa_row_shard``): the gathered queries' partials merged over the
  sequence axes, each rank keeping its own rows.

On the CPU every K1 call runs its plain version, as the wrappers always do
there; a kernel policy that routes the flat passes away from K1 (``flash``
``on`` or ``off``) runs K1's plain version with lse here, since SDPA
returns no logsumexp.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.parallel.sharding import (
    DATA_AXIS, SEQ_AXIS, _all_reduce, all_gather, all_reduce, all_to_all, axis_index, axis_names,
    axis_size, pair_layout, reduce_scatter, ring_shift,
)


def attend_lse(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
    """(out, lse) of one attention on K1 with lse (its plain version off
    the card or off the policy's K1 route); lse is -inf, not K1's +inf, on
    rows with no valid key, so such rows weigh nothing when merged."""
    from alphafold2_tpu_torch.ops import kernels
    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention_lse, fused_attention_lse_reference,
    )

    fn = (fused_attention_lse if kernels.resolve_flash() == "pallas"
          else fused_attention_lse_reference)
    out, lse = fn(q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=sm_scale)
    return out, lse.masked_fill(lse == float("inf"), float("-inf"))


def _fold(state, out, lse):
    """Fold one block's normalised ``out`` and its ``lse`` into the running
    (max, sum, accumulator), all f32."""
    m, l, acc = state
    m_new = torch.maximum(m, lse.detach())
    safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha, beta = torch.exp(m - safe), torch.exp(lse - safe)
    return m_new, l * alpha + beta, acc * alpha[..., None] + out.float() * beta[..., None]


def _finish(state, dtype):
    _, l, acc = state
    live = l > 0
    return torch.where(live[..., None], acc / torch.where(live, l, 1.0)[..., None],
                       0.0).to(dtype)


def ring_attention(q, k, v, kv_mask, mesh, axis: str = SEQ_AXIS,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's query block over every rank's keys:
    q/k/v (B, H, n, D) and ``kv_mask`` (B, n) bool (or None) are this
    rank's blocks of the ``axis``-sharded sequence."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    sp = axis_size(mesh, axis)
    b, h, n, _ = q.shape
    state = (torch.full((b, h, n), float("-inf"), device=q.device),
             torch.zeros((b, h, n), device=q.device),
             torch.zeros((*q.shape[:3], v.shape[-1]), device=q.device))
    mask = kv_mask.to(torch.uint8) if kv_mask is not None else None
    for step in range(sp):
        out, lse = attend_lse(q, k, v, kv_mask=mask.bool() if mask is not None else None,
                              sm_scale=scale)
        state = _fold(state, out, lse)
        if step + 1 < sp:
            moved = ring_shift([k, v] + ([mask] if mask is not None else []), mesh, axis)
            k, v = moved[0], moved[1]
            mask = moved[2] if mask is not None else None
    return _finish(state, q.dtype)


def ulysses_attention(q, k, v, kv_mask, mesh, axis: str = SEQ_AXIS,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all sequence parallelism: this rank's (B, H, n, D) blocks
    re-sharded to (B, H/sp, N, D), attended by K1 over the whole sequence,
    and re-sharded back."""
    from alphafold2_tpu_torch.ops import kernels
    from alphafold2_tpu_torch.ops.attention import attend

    sp = axis_size(mesh, axis)
    if q.shape[1] % sp:
        raise ValueError(f"heads {q.shape[1]} must divide by sp={sp} for ulysses")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    qh, kh, vh = (all_to_all(t, mesh, axis, 1, 2) for t in (q, k, v))
    full_mask = (all_gather(kv_mask.to(torch.uint8), mesh, axis, dim=1).bool()
                 if kv_mask is not None else None)
    out = attend(kernels.resolve_flash(), qh, kh, vh, kv_mask=full_mask, sm_scale=scale)
    return all_to_all(out, mesh, axis, 2, 1)


def sequence_parallel_attention(q, k, v, mask=None, mesh=None, impl: str = "ring",
                                axis: str = SEQ_AXIS,
                                sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence axis sharded across the mesh's ``axis``:
    ``impl`` "ring" or "ulysses". q/k/v (B, H, n, D) and the key mask
    (B, n) are this rank's blocks; without a mesh (or without ``axis``) they
    are the whole sequence and one K1 call attends them."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown context-parallel impl {impl!r}")
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        from alphafold2_tpu_torch.ops import kernels
        from alphafold2_tpu_torch.ops.attention import attend

        scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
        return attend(kernels.resolve_flash(), q, k, v, kv_mask=mask, sm_scale=scale)
    fn = ring_attention if impl == "ring" else ulysses_attention
    return fn(q, k, v, mask, mesh, axis=axis, sm_scale=sm_scale)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, mesh, axis: str = "seq"):
    """Merge each rank's (B, H, Nq, D) ``out`` and (B, H, Nq) ``lse`` of the
    same queries over disjoint key sets into the attention over their
    union: one all_reduce of the row max over ``axis``, one of the
    rescaled outputs and weights together (f32). Rows that no rank has a
    valid key for (lse -inf everywhere) come out 0."""
    m = all_reduce(lse, mesh, axis, op="max")
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - safe)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    total = all_reduce(packed, mesh, axis, op="sum")
    num, den = total[..., :-1], total[..., -1]
    live = den > 0
    return torch.where(live[..., None], num / torch.where(live, den, 1.0)[..., None],
                       0.0).to(out.dtype)


def merge_partials_rows(out: torch.Tensor, lse: torch.Tensor, mesh, row_axis: str):
    """:func:`merge_partials` of (B, H, Nq, D) partials whose query axis is
    every rank's row block of the ``row_axis`` in rank order (gathered over
    it), over the keys split across the sequence axes: one all_reduce of
    the row max over the sequence axes, the rescaled sums all_reduced over
    the column axis (a grid mesh's ``spc``) and reduce-scattered over
    ``row_axis``, so each rank keeps its own block's Nq / n_rows queries."""
    m = all_reduce(lse, mesh, "seq", op="max")
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - safe)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    col = pair_layout(mesh).col_axis
    if col is not None:
        packed = all_reduce(packed, mesh, col, op="sum")
    total = reduce_scatter(packed, mesh, row_axis, dim=2)
    num, den = total[..., :-1], total[..., -1]
    live = den > 0
    return torch.where(live[..., None], num / torch.where(live, den, 1.0)[..., None],
                       0.0).to(out.dtype)


# --------------------------------------------- tied rows sharded over rows


def _tied_forward(q, k, v, q_mask, kv_mask, sm_scale, tie, mesh, axis, plain):
    """The split route's forward: (out, whole logits, lse)."""
    from alphafold2_tpu_torch.ops.cuda import tied_row as k2

    logits, softmax, product = ((k2.tied_split_logits_reference, k2.tied_split_softmax_reference,
                                 k2.tied_split_product_reference) if plain else
                                (k2.tied_split_logits, k2.tied_split_softmax,
                                 k2.tied_split_product))
    nq, nk = q.shape[2], k.shape[2]
    s = _all_reduce(logits(q, k), mesh, axis, "sum")
    p, lse = softmax(s, nq, nk, q_mask, kv_mask, sm_scale, tie, q.dtype)
    return product(p, v, nq), s, lse


class TiedRowsSharded(torch.autograd.Function):
    """Tied-row attention of this rank's rows (B, R_local, N, H, D) over a
    row-sharded MSA: K2's split passes with one all-reduce of the logits
    over the mesh axis ``axis`` (the forward) and one of dP and dsum (the
    backward). ``tie`` (B,) f32 carries no gradient; ``plain`` runs the
    passes' plain versions (the ``tied_row=dense`` policy on the card).
    The backward's all-reduce is the SPMD transpose of the forward's: each
    rank's dS is the same whole one, and its rows' dq, dk and dv follow."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, sm_scale, tie, mesh, axis, plain):
        out, s, lse = _tied_forward(q, k, v, q_mask, kv_mask, sm_scale, tie, mesh, axis, plain)
        ctx.save_for_backward(q, k, v, out, s, lse, q_mask, kv_mask, tie)
        ctx.args = (sm_scale, mesh, axis, plain)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        from alphafold2_tpu_torch.ops.cuda import tied_row as k2

        q, k, v, out, s, lse, q_mask, kv_mask, tie = ctx.saved_tensors
        sm_scale, mesh, axis, plain = ctx.args
        logits, grad, product = ((k2.tied_split_logits_reference, k2.tied_split_grad_reference,
                                  k2.tied_split_product_reference) if plain else
                                 (k2.tied_split_logits, k2.tied_split_grad,
                                  k2.tied_split_product))
        dout = dout.contiguous()
        nq, nk = q.shape[2], k.shape[2]
        dp = logits(dout, v)
        dsum = k2.tied_row_dsum(out, dout)
        whole = _all_reduce(torch.cat([dp.reshape(-1), dsum.reshape(-1)]), mesh, axis, "sum")
        dp, dsum = whole[:dp.numel()].view(dp.shape), whole[dp.numel():].view(dsum.shape)
        ds, ds_t, p_t = grad(s, dp, lse, dsum, nq, nk, q_mask, kv_mask, sm_scale, tie, q.dtype)
        scale = (sm_scale, tie)
        return (product(ds, k, nq, scale), product(ds_t, q, nk, scale), product(p_t, dout, nk),
                None, None, None, None, None, None, None)


def sharded_tied_rows(q, k, v, mesh, axis: str, q_mask=None, kv_mask=None, sm_scale=1.0,
                      tie_scale=None, plain: bool = False) -> torch.Tensor:
    """Tied-row attention of this rank's rows of an MSA whose rows are
    sharded over mesh axis ``axis``: q/k/v (B, R_local, N, H, D) in K2's
    layout, the shared (B, N) masks and the tie scale (a number or (B,) f32)
    as :func:`~alphafold2_tpu_torch.ops.cuda.tied_row.tied_row_attention`
    takes them, global (every rank the same). Differentiable in q, k and v
    (:class:`TiedRowsSharded`)."""
    from alphafold2_tpu_torch.ops.cuda.tied_row import _check, _tie_vector

    _check(q, k, v, q_mask, kv_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tie = _tie_vector(1.0 if tie_scale is None else tie_scale, q.shape[0], 1, q.device).detach()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TiedRowsSharded.apply(q, k, v, q_mask, kv_mask, sm_scale, tie, mesh, axis, plain)
    return _tied_forward(q, k, v, q_mask, kv_mask, sm_scale, tie, mesh, axis, plain)[0]


def tied_row_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_rows_global: int, mesh, axis: str = SEQ_AXIS) -> torch.Tensor:
    """JAX's ``tied_row_attention_sharded``: tied-row (MSA-Transformer)
    attention of this rank's rows, q/k/v (B, R_local, H, N, D), of an MSA
    whose rows are sharded over mesh axis ``axis``, with the scale
    ``D**-0.5 * num_rows_global**-0.5``. Each rank contracts its own rows'
    logits, one all-reduce over ``axis`` completes them, and the shared
    softmax weighs the local rows' values (:func:`sharded_tied_rows`).
    Returns this rank's (B, R_local, H, N, D)."""
    d = q.shape[-1]
    to_k2 = lambda t: t.transpose(2, 3)  # noqa: E731 — (B, R, H, N, D) <-> (B, R, N, H, D)
    out = sharded_tied_rows(to_k2(q), to_k2(k), to_k2(v), mesh, axis, sm_scale=d**-0.5,
                            tie_scale=float(num_rows_global) ** -0.5)
    return to_k2(out)


def tied_row_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """JAX's host-level ``tied_row_attention``: q/k/v the global (B, R, H, N,
    D) arrays (the same on every rank); with a mesh, each rank takes its
    (``dp``, ``sp``) block, runs :func:`tied_row_attention_sharded` on its
    rows and the blocks are gathered back, so every rank returns the global
    result; without one (or without an ``sp`` axis) the dense contraction.
    Exact in both modes, as JAX's. Its gradient reaches each rank's block
    of q, k and v (the gathers' backward reduce-scatters the cotangents)."""
    b, r = q.shape[0], q.shape[1]
    if mesh is None or SEQ_AXIS not in axis_names(mesh):
        from alphafold2_tpu_torch.ops import kernels
        from alphafold2_tpu_torch.ops.cuda import tied_row as k2

        fn = (k2.tied_row_attention if kernels.resolve_tied_row() == "pallas"
              else k2.tied_row_attention_reference)
        to_k2 = lambda t: t.transpose(2, 3).contiguous()  # noqa: E731
        out = fn(to_k2(q), to_k2(k), to_k2(v), sm_scale=q.shape[-1] ** -0.5, tie_scale=r**-0.5)
        return out.transpose(2, 3)
    sp, dp = axis_size(mesh, SEQ_AXIS), axis_size(mesh, DATA_AXIS)
    if r % sp != 0:
        raise ValueError(f"MSA rows {r} must divide by sp={sp}")
    if b % dp != 0:
        raise ValueError(f"batch {b} must divide by dp={dp}")
    bi, ri = axis_index(mesh, DATA_AXIS), axis_index(mesh, SEQ_AXIS)
    rows, batch = slice(ri * (r // sp), (ri + 1) * (r // sp)), slice(bi * (b // dp),
                                                                     (bi + 1) * (b // dp))
    out = tied_row_attention_sharded(q[batch, rows], k[batch, rows], v[batch, rows], r, mesh)
    out = all_gather(out, mesh, SEQ_AXIS, dim=1)
    return all_gather(out, mesh, DATA_AXIS, dim=0)
