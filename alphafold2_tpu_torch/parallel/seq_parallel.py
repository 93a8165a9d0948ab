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

On the CPU every K1 call runs its plain version, as the wrappers always do
there; a kernel policy that routes the flat passes away from K1 (``flash``
``on`` or ``off``) runs K1's plain version with lse here, since SDPA
returns no logsumexp. JAX's ``tied_row_attention_sharded`` and the
``msa_row_shard`` layout are not ported yet (ROADMAP section 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.parallel.sharding import (
    SEQ_AXIS, all_gather, all_reduce, all_to_all, axis_size, ring_shift,
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
