"""K4 (block-sparse flash-attention forward) and K5a/K5b (its backward):
CUDA kernel wrappers, plain versions, and the autograd ``Function`` joining
them.

Port of ``alphafold2_tpu/ops/pallas/block_sparse.py``: the forward ``_run``
(K4, ``csrc/block_sparse_attention.cu``) and the custom-VJP backward
``_run_dq`` / ``_run_dkv`` (K5a/K5b, ``csrc/block_sparse_attention_bwd.cu``)
of ``block_sparse_attention_pallas`` (``alphafold2_tpu/ops/sparse.py:167``).
Each kernel has a plain PyTorch version here, gather-based as the JAX jnp
oracle (``ops/sparse.py:119``) is: every query block gathers the key blocks
of its row list, every key block (in the backward's dk/dv) the query blocks
of its column list. The wrappers run the plain versions only for tensors on
the CPU; for CUDA tensors they launch the kernel or raise.

The layout reaches the kernels as a :class:`BlockLayout`: the row lists
(active key blocks of each query block, ascending, padded to the longest)
with their counts, and the column lists (the layout transposed) with theirs;
and for the Hopper K4, K5a and K5b kernels, which own 64 rows a block, the
union of the lists of each 64-row tile packed as stages
(:func:`union_stages`). It copies them to a device once and keeps them
there, so a call does no host work for the layout.
:func:`fwd_union_reference`, :func:`dq_union_reference` and
:func:`dkv_union_reference` are the plain versions of that decomposition.

Contract (the JAX function's, with one sharpening, as K1's): q/k/v
(B, H, N, D), N a multiple of the block size (16, 32, 64 or 128), boolean
``kv_mask`` (B, N) shared by all heads and applied to keys only. Masked
keys are excluded exactly; query rows are not masked. A row whose active
blocks hold no valid key gives exactly 0 and lse +inf, and takes no part in
the backward (its gradients are 0); the TPU kernel gave it a finite average
of its padded slots. Masked keys get dk = dv = 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from alphafold2_tpu_torch.ops.cuda import build
from alphafold2_tpu_torch.ops.cuda.axial import (
    _DTYPES, _check as _check_attention, _check_grad_operands, _cuda_operands,
    _like_heads, _masked_softmax_weights, _ptr, _strides, attention_dsum)

BLOCK_SIZES = (16, 32, 64, 128)
TILE_ROWS = 64  # rows of a resident tile and of a streamed stage (wgmma's m64)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def union_stages(idx, cnt, num_blocks: int, block_size: int):
    """The lists of each 64-row tile as the Hopper K4 and K5 kernels stream
    them.

    ``idx`` (nb, A) / ``cnt`` (nb,): the per-block lists (row lists for K4
    and K5a, column lists for K5b). A tile's resident blocks are the 64 / bs
    blocks its rows cover at bs 16 or 32 (fewer where the axis ends), or the
    one block at bs 64 and 128 (two tiles a block at 128). Its stream is the
    ascending union of their lists, packed ``slots`` = 64 / min(bs, 64)
    blocks a stage. Returns int32 arrays:

    - ``blocks`` (tiles, S, slots): the listed block of each slot; a
      stage's empty slots repeat its last listed block;
    - ``bits`` (tiles, S): bit ``s * slots + r`` set when resident block
      ``r`` lists slot ``s``'s block; 0 for every empty slot;
    - ``counts`` (tiles,): each tile's stages (S = max(counts, 1)).
    """
    idx = np.asarray(idx)
    cnt = np.asarray(cnt)
    listed = np.zeros((num_blocks, num_blocks), dtype=bool)
    for i in range(num_blocks):
        listed[i, idx[i, :cnt[i]]] = True
    box = min(block_size, TILE_ROWS)
    slots = TILE_ROWS // box
    tiles = -(-num_blocks * block_size // TILE_ROWS)
    residents, streams = [], []
    for t in range(tiles):
        if block_size < TILE_ROWS:
            resident = [rb for rb in range(t * slots, (t + 1) * slots) if rb < num_blocks]
        else:
            resident = [t * TILE_ROWS // block_size]
        residents.append(resident)
        streams.append(np.flatnonzero(listed[resident].any(0)))
    counts = np.array([-(-len(u) // slots) for u in streams], dtype=np.int32)
    depth = max(int(counts.max()) if tiles else 0, 1)
    blocks = np.zeros((tiles, depth, slots), dtype=np.int32)
    bits = np.zeros((tiles, depth), dtype=np.int32)
    for t, (union, resident) in enumerate(zip(streams, residents)):
        for a in range(counts[t]):
            stage = union[a * slots:(a + 1) * slots]
            blocks[t, a, :len(stage)] = stage
            blocks[t, a, len(stage):] = stage[-1]
            bits[t, a] = sum(1 << (s * slots + r) for s, blk in enumerate(stage)
                             for r, rb in enumerate(resident) if listed[rb, blk])
    return blocks, bits, counts


class BlockLayout:
    """A block layout packed for the kernels.

    ``rows`` (nb, A) int32: the active key blocks of each query block in
    ascending order, padded with 0 past ``row_counts`` (nb,); ``cols``
    (nb, At) and ``col_counts``: the same for the layout transposed (the
    query blocks that attend each key block)."""

    def __init__(self, rows, row_counts, cols, col_counts, block_size: int):
        if block_size not in BLOCK_SIZES:
            raise ValueError(f"block size {block_size} not in {BLOCK_SIZES}")
        lists = [np.ascontiguousarray(a, dtype=np.int32)
                 for a in (rows, row_counts, cols, col_counts)]
        nb = lists[1].shape[0]
        for name, idx, cnt in (("rows", lists[0], lists[1]), ("cols", lists[2], lists[3])):
            if (idx.ndim != 2 or idx.shape[0] != nb or cnt.shape != (nb,)
                    or (cnt > idx.shape[1]).any() or (cnt < 0).any()
                    or (idx < 0).any() or (idx >= nb).any()):
                raise ValueError(f"malformed {name} lists {idx.shape} / counts {cnt.shape}")
        self.rows, self.row_counts, self.cols, self.col_counts = lists
        self.block_size = block_size
        self.num_blocks = nb
        # the Hopper kernels' streams: rows (K4, K5a) and columns (K5b)
        self.row_union = union_stages(self.rows, self.row_counts, nb, block_size)
        self.col_union = union_stages(self.cols, self.col_counts, nb, block_size)
        self._on: dict = {}

    @property
    def seq_len(self) -> int:
        return self.num_blocks * self.block_size

    def tensors(self, device: torch.device):
        """(rows, row_counts, cols, col_counts) as int32 tensors on
        ``device``, copied there on first use and kept."""
        key = str(device)
        found = self._on.get(key)
        if found is None:
            found = tuple(torch.from_numpy(a).to(device) for a in
                          (self.rows, self.row_counts, self.cols, self.col_counts))
            self._on[key] = found
        return found

    def union_tensors(self, device: torch.device):
        """(row blocks, row bits, row counts, column blocks, column bits,
        column counts) of :func:`union_stages` as int32 tensors on
        ``device``, copied there on first use and kept."""
        key = ("union", str(device))
        found = self._on.get(key)
        if found is None:
            found = tuple(torch.from_numpy(a).to(device)
                          for a in (*self.row_union, *self.col_union))
            self._on[key] = found
        return found

    def active_pairs(self) -> int:
        """(query block, key block) pairs the layout makes active."""
        return int(self.row_counts.sum())


# ---------------------------------------------------------------- plain versions


def _gather_blocks(t: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """(B, H, N, ...) -> (B, H, nb, A, bs, ...): for block i its listed
    blocks idx[i] (f32)."""
    b, h, n = t.shape[:3]
    return t.float().reshape(b, h, nb, n // nb, *t.shape[3:])[:, :, idx]


def _listed_keys(idx, cnt, kv_mask, nb, bs):
    """(B or 1, nb, A, bs) bool: which gathered positions are real (in a
    listed block, not a padding slot) and valid under ``kv_mask``."""
    a = idx.shape[1]
    slots = torch.arange(a, device=idx.device)[None, :] < cnt[:, None]  # (nb, A)
    slots = slots[None, :, :, None].expand(1, nb, a, bs)
    if kv_mask is None:
        return slots
    return slots & kv_mask.reshape(kv_mask.shape[0], nb, bs)[:, idx]


def _lists(layout: BlockLayout, device, transpose=False):
    rows, row_counts, cols, col_counts = layout.tensors(device)
    return (cols.long(), col_counts.long()) if transpose else (rows.long(), row_counts.long())


def _row_logits(q, k, layout, kv_mask, sm_scale):
    """Each query block against its gathered key blocks: logits
    (B, H, nb, bs, A*bs) f32 and their validity (B or 1, 1, nb, 1, A*bs)."""
    b, h, n, d = q.shape
    nb, bs = layout.num_blocks, layout.block_size
    idx, cnt = _lists(layout, q.device)
    kg = _gather_blocks(k, idx, nb).reshape(b, h, nb, -1, d)
    s = torch.einsum("bhiqd,bhikd->bhiqk", q.float().reshape(b, h, nb, bs, d), kg) * sm_scale
    valid = _listed_keys(idx, cnt, kv_mask, nb, bs).reshape(-1, 1, nb, 1, s.shape[-1])
    return s, valid, idx


def _forward(q, k, v, layout, kv_mask, sm_scale, with_lse):
    b, h, n, d = q.shape
    s, valid, idx = _row_logits(q, k, layout, kv_mask, sm_scale)
    p, l = _masked_softmax_weights(s, valid)
    vg = _gather_blocks(v, idx, layout.num_blocks).reshape(b, h, layout.num_blocks, -1, d)
    out = (torch.einsum("bhiqk,bhikd->bhiqd", p, vg) / l).reshape(b, h, n, d).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), dim=-1).reshape(b, h, n)
    return out, lse.masked_fill(lse == float("-inf"), float("inf"))


def block_sparse_attention_reference(q, k, v, layout, kv_mask=None, sm_scale=1.0):
    """The plain version of K4 (f32 arithmetic, gather-based)."""
    block_sparse_attention_reference.calls += 1
    return _forward(q, k, v, layout, kv_mask, sm_scale, with_lse=False)


block_sparse_attention_reference.calls = 0


def block_sparse_attention_lse_reference(q, k, v, layout, kv_mask=None, sm_scale=1.0):
    """The plain version of the training forward: (out, lse)."""
    block_sparse_attention_lse_reference.calls += 1
    return _forward(q, k, v, layout, kv_mask, sm_scale, with_lse=True)


block_sparse_attention_lse_reference.calls = 0


def _exp_live(s, lse, valid):
    """exp(s - lse), exactly 0 where ``valid`` is False or lse is +inf."""
    live = torch.isfinite(lse)
    return torch.where(valid & live, torch.exp(s - torch.where(live, lse, 0.0)), 0.0)


def block_sparse_attention_dq_reference(q, k, v, dout, lse, dsum, layout, kv_mask=None,
                                        sm_scale=1.0):
    """The plain version of K5a: dq = sm_scale * ds @ k over each query
    block's row list, ds rounded to the operand dtype first."""
    block_sparse_attention_dq_reference.calls += 1
    b, h, n, d = q.shape
    nb, bs = layout.num_blocks, layout.block_size
    s, valid, idx = _row_logits(q, k, layout, kv_mask, sm_scale)
    p = _exp_live(s, lse.reshape(b, h, nb, bs, 1), valid)
    vg = _gather_blocks(v, idx, nb).reshape(b, h, nb, -1, d)
    dp = torch.einsum("bhiqd,bhikd->bhiqk", dout.float().reshape(b, h, nb, bs, d), vg)
    ds = (p * (dp - dsum.reshape(b, h, nb, bs, 1))).to(q.dtype).float()
    kg = _gather_blocks(k, idx, nb).reshape(b, h, nb, -1, d)
    dq = sm_scale * torch.einsum("bhiqk,bhikd->bhiqd", ds, kg)
    return dq.reshape(b, h, n, d).to(q.dtype)


block_sparse_attention_dq_reference.calls = 0


def block_sparse_attention_dkv_reference(q, k, v, dout, lse, dsum, layout, kv_mask=None,
                                         sm_scale=1.0):
    """The plain version of K5b: (dk, dv) = (sm_scale * ds^T @ q, p^T @ dO)
    over each key block's column list, p and ds rounded to the operand dtype
    first."""
    block_sparse_attention_dkv_reference.calls += 1
    b, h, n, d = q.shape
    nb, bs = layout.num_blocks, layout.block_size
    idx, cnt = _lists(layout, q.device, transpose=True)
    qg = _gather_blocks(q, idx, nb).reshape(b, h, nb, -1, d)  # attending queries
    dog = _gather_blocks(dout, idx, nb).reshape(b, h, nb, -1, d)
    lse_g = _gather_blocks(lse, idx, nb).reshape(b, h, nb, 1, -1)
    dsum_g = _gather_blocks(dsum, idx, nb).reshape(b, h, nb, 1, -1)
    kb = k.float().reshape(b, h, nb, bs, d)
    s = torch.einsum("bhjkd,bhjqd->bhjkq", kb, qg) * sm_scale  # (B, H, nb, bs, At*bs)
    valid = _listed_keys(idx, cnt, None, nb, bs).reshape(1, 1, nb, 1, -1)
    if kv_mask is not None:
        valid = valid & kv_mask.reshape(b, 1, nb, bs, 1)
    p = _exp_live(s, lse_g, valid)
    dv = torch.einsum("bhjkq,bhjqd->bhjkd", p.to(q.dtype).float(), dog)
    dp = torch.einsum("bhjkd,bhjqd->bhjkq", v.float().reshape(b, h, nb, bs, d), dog)
    ds = (p * (dp - dsum_g)).to(q.dtype).float()
    dk = sm_scale * torch.einsum("bhjkq,bhjqd->bhjkd", ds, qg)
    return dk.reshape(b, h, n, d).to(k.dtype), dv.reshape(b, h, n, d).to(v.dtype)


block_sparse_attention_dkv_reference.calls = 0


def _union_walk(layout: BlockLayout, columns: bool):
    """The stages the Hopper K4 and K5 kernels stream, in their order: for
    each 64-row tile and each ring stage of its union lists, (tile, the stage's
    64 streamed tokens, ``allowed`` (64 resident rows, 64 streamed rows)
    bool from the layout bits, the stage's empty slots). ``columns``: K5b's
    column lists, else the row lists of K4 and K5a."""
    blocks, bits, counts = layout.col_union if columns else layout.row_union
    bs = layout.block_size
    box = min(bs, TILE_ROWS)
    slots = TILE_ROWS // box
    halves = max(bs // TILE_ROWS, 1)
    # the resident block of each tile row (the accumulator rows of its warp)
    # and the slot of each streamed row
    rb = torch.arange(TILE_ROWS) // box
    slot = torch.arange(TILE_ROWS) // box
    own = (1 << slots) - 1
    offsets = torch.arange(box)
    for t in range(len(counts)):
        for a in range(int(counts[t])):
            word = int(bits[t, a])
            groups = torch.tensor([(word >> (s * slots)) & own for s in range(slots)])
            allowed = ((groups[slot][None, :] >> rb[:, None]) & 1).bool()
            empty = [s for s in range(slots) if groups[s] == 0]
            for half in range(halves):
                tokens = torch.cat([int(blk) * bs + half * TILE_ROWS + offsets
                                    for blk in blocks[t, a]])
                yield t, tokens, allowed, empty


def _pad_rows(x, rows, value=0.0):
    """(B, H, N, ...) f32, padded along N to ``rows`` with ``value``."""
    x = x.float()
    extra = rows - x.shape[2]
    if extra == 0:
        return x
    return torch.cat([x, x.new_full((*x.shape[:2], extra, *x.shape[3:]), value)], dim=2)


def _staged(x, tokens, empty, box, pad):
    """A stage's rows of ``x`` (B, H, N, D); with ``pad`` "nan" the
    empty slots hold NaN instead of the repeated block."""
    st = x[:, :, tokens]
    for s in empty if pad == "nan" else ():
        st[:, :, s * box:(s + 1) * box] = float("nan")
    return st


def _slot_ranges(empty, box, pad):
    """The column ranges a stage adds, slot by slot (empty slots left out
    with ``pad`` "skip")."""
    return [slice(s * box, (s + 1) * box) for s in range(TILE_ROWS // box)
            if not (pad == "skip" and s in empty)]


_PADS = ("repeat", "nan", "skip")


def dq_union_reference(q, k, v, dout, lse, dsum, layout, kv_mask=None, sm_scale=1.0,
                       pad="repeat"):
    """The plain version of the Hopper K5a's decomposition: each 64-query
    tile walks the union of its blocks' row lists stage by stage (64 key
    rows, 64 / bs listed blocks); a (query, key) pair outside the query's
    block's list takes p = 0 by select; ds rounded to q's dtype; dq summed
    slot by slot. ``pad``: "repeat" fills a stage's empty slots as the
    kernel does (its last block, bits 0), "nan" with NaN, "skip" leaves
    them out of the sums."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    b, h, n, d = q.shape
    box = min(layout.block_size, TILE_ROWS)
    rows = len(layout.row_union[2]) * TILE_ROWS
    qf, dof = _pad_rows(q, rows), _pad_rows(dout, rows)
    lse_p, dsum_p = _pad_rows(lse, rows, float("inf")), _pad_rows(dsum, rows)
    kf, vf = k.float(), v.float()
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, n), dtype=torch.bool, device=q.device))
    dq = torch.zeros((b, h, rows, d), dtype=torch.float32, device=q.device)
    for t, tokens, allowed, empty in _union_walk(layout, columns=False):
        r = slice(t * TILE_ROWS, (t + 1) * TILE_ROWS)
        kst, vst = (_staged(x, tokens, empty, box, pad) for x in (kf, vf))
        s = qf[:, :, r] @ kst.transpose(-1, -2) * sm_scale
        valid = allowed.to(q.device)[None, None] & keys[:, None, None, tokens]
        p = _exp_live(s, lse_p[:, :, r, None], valid)
        dp = dof[:, :, r] @ vst.transpose(-1, -2)
        ds = (p * (dp - dsum_p[:, :, r, None])).to(q.dtype).float()
        for c in _slot_ranges(empty, box, pad):
            dq[:, :, r] += ds[..., c] @ kst[:, :, c]
    return (sm_scale * dq[:, :, :n]).to(q.dtype)


def dkv_union_reference(q, k, v, dout, lse, dsum, layout, kv_mask=None, sm_scale=1.0,
                        pad="repeat"):
    """The plain version of the Hopper K5b's decomposition: each 64-key
    tile walks the union of its blocks' column lists stage by stage (64
    query rows with their lse and dsum); a pair outside the key's block's
    list takes p = 0 by select; p and ds rounded to k's dtype; (dk, dv)
    summed slot by slot. ``pad`` as in :func:`dq_union_reference`."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    b, h, n, d = q.shape
    box = min(layout.block_size, TILE_ROWS)
    rows = len(layout.col_union[2]) * TILE_ROWS
    kf, vf = _pad_rows(k, rows), _pad_rows(v, rows)
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, n), dtype=torch.bool, device=q.device))
    keys = torch.cat([keys, keys.new_zeros((b, rows - n))], dim=1)
    qf, dof = q.float(), dout.float()
    dk = torch.zeros((b, h, rows, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for t, tokens, allowed, empty in _union_walk(layout, columns=True):
        r = slice(t * TILE_ROWS, (t + 1) * TILE_ROWS)
        qst, dost = (_staged(x, tokens, empty, box, pad) for x in (qf, dof))
        s = kf[:, :, r] @ qst.transpose(-1, -2) * sm_scale  # keys x queries
        valid = allowed.to(q.device)[None, None] & keys[:, None, r, None]
        p = _exp_live(s, lse[:, :, None, tokens], valid)
        dp = vf[:, :, r] @ dost.transpose(-1, -2)
        ds = (p * (dp - dsum[:, :, None, tokens])).to(k.dtype).float()
        pr = p.to(k.dtype).float()
        for c in _slot_ranges(empty, box, pad):
            dv[:, :, r] += pr[..., c] @ dost[:, :, c]
            dk[:, :, r] += ds[..., c] @ qst[:, :, c]
    return ((sm_scale * dk[:, :, :n]).to(k.dtype), dv[:, :, :n].to(v.dtype))


def fwd_union_reference(q, k, v, layout, kv_mask=None, sm_scale=1.0, pad="repeat"):
    """The plain version of the Hopper K4's decomposition: each 64-query
    tile walks the union of its blocks' row lists stage by stage (64 keys,
    64 / bs listed blocks); a (query, key) pair outside the query's block's
    list weighs 0 by select. The online softmax runs in log2 units in stage
    order, each row with its f32 max, sum and accumulator; a row with no
    valid key in a stage keeps all three (alpha 1, p 0), as a warp of the
    kernel does where another warp's rows need the stage. p is rounded to
    q's dtype before P V (the sum keeps it in f32), and P V is summed slot
    by slot; a stage with no valid listed key for any row is skipped, as the
    kernel never stages it. Returns (out, lse) as
    :func:`block_sparse_attention_lse`: a row
    with no valid key gives 0 and lse +inf. ``pad`` as in
    :func:`dq_union_reference`."""
    if pad not in _PADS:
        raise ValueError(f"pad must be one of {_PADS}, got {pad!r}")
    b, h, n, d = q.shape
    box = min(layout.block_size, TILE_ROWS)
    rows = len(layout.row_union[2]) * TILE_ROWS
    qf = _pad_rows(q, rows)
    kf, vf = k.float(), v.float()
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, n), dtype=torch.bool, device=q.device))
    scale2 = sm_scale * LOG2E
    m = torch.full((b, h, rows, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, rows, 1), device=q.device)
    acc = torch.zeros((b, h, rows, d), device=q.device)
    for t, tokens, allowed, empty in _union_walk(layout, columns=False):
        r = slice(t * TILE_ROWS, (t + 1) * TILE_ROWS)
        kst, vst = (_staged(x, tokens, empty, box, pad) for x in (kf, vf))
        x = qf[:, :, r] @ kst.transpose(-1, -2) * scale2
        valid = allowed.to(q.device)[None, None] & keys[:, None, None, tokens]
        if not valid.any():
            continue  # no valid listed key for any row: the kernel never stages it
        live = valid.any(-1, keepdim=True)
        ext = x.masked_fill(~valid, float("-inf")).amax(-1, keepdim=True)
        m_new = torch.where(live, torch.maximum(m[:, :, r], ext), m[:, :, r])
        alpha = torch.where(live, torch.exp2(m[:, :, r] - m_new), 1.0)
        p = torch.where(valid, torch.exp2(x - m_new), 0.0)
        l[:, :, r] = l[:, :, r] * alpha + p.sum(-1, keepdim=True)
        pr = p.to(q.dtype).float()
        acc[:, :, r] *= alpha
        for c in _slot_ranges(empty, box, pad):
            acc[:, :, r] += pr[..., c] @ vst[:, :, c]
        m[:, :, r] = m_new
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(torch.isneginf(m), float("inf"), m * LN2 + torch.log(l))
    return out[:, :, :n].to(q.dtype), lse[:, :, :n, 0]


# ---------------------------------------------------------------- kernels


def _check(q, k, v, layout, kv_mask):
    _check_attention(q, k, v, None, kv_mask)
    if k.shape != q.shape:
        raise ValueError(f"block-sparse attention is self-attention: k {tuple(k.shape)} "
                         f"!= q {tuple(q.shape)}")
    if not isinstance(layout, BlockLayout):
        raise TypeError(f"layout must be a BlockLayout, got {type(layout).__name__}")
    if q.shape[2] != layout.seq_len:
        raise ValueError(f"sequence length {q.shape[2]} != the layout's {layout.num_blocks} "
                         f"blocks of {layout.block_size}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block-sparse attention runs on cuda or cpu, not {q.device}")


def _check_grad(q, k, v, dout, lse, dsum):
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if any(t.device != q.device for t in (dout, lse, dsum)):
        raise ValueError("dout, lse and dsum must lie on q's device")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch_forward(q, k, v, layout, kv_mask, sm_scale, with_lse):
    """K4 on CUDA tensors: (out, the (B, H, N) f32 lse or None, 1 if the
    Hopper kernel ran else 0)."""
    _, km = _cuda_operands(q, k, v, None, kv_mask, "block_sparse_attention")
    b, h, n, d = q.shape
    out = _like_heads(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    if b * h == 0:
        return out, lse, 0
    rows, counts, _, _ = layout.tensors(q.device)
    blocks, bits, stages = layout.union_tensors(q.device)[:3]
    info = (ctypes.c_int * 1)()
    lib = build.library("block_sparse_attention")
    with torch.cuda.device(q.device):
        code = lib.af2_block_sparse_attention(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(km),
            _ptr(rows), _ptr(counts), rows.shape[1], _ptr(blocks), _ptr(bits), _ptr(stages),
            blocks.shape[1], _strides(q, k, v, out), b, h, n, d, layout.block_size,
            float(sm_scale), info, _stream())
    build.check(lib, code, "block_sparse_attention")
    return out, lse, info[0]


def block_sparse_attention_lse(q, k, v, layout, kv_mask=None, sm_scale=1.0):
    """K4's training forward: (out, lse), lse the (B, H, N) f32 logsumexp of
    each row's scaled logits over its active valid keys, +inf for a row with
    none. Not differentiable itself: :class:`BlockSparseAttention` wraps it."""
    _check(q, k, v, layout, kv_mask)
    if q.device.type == "cpu":
        return block_sparse_attention_lse_reference(q, k, v, layout, kv_mask, sm_scale)
    out, lse, sm90 = _launch_forward(q, k, v, layout, kv_mask, sm_scale, with_lse=True)
    block_sparse_attention_lse.sm90_launches += sm90
    block_sparse_attention_lse.launches += 1
    return out, lse


block_sparse_attention_lse.launches = 0
block_sparse_attention_lse.sm90_launches = 0  # of them, launches of sparse_fwd_kernel_sm90


def _launch_backward(symbol, outs, slots, lists, union, q, k, v, dout, lse, dsum, layout,
                     kv_mask, sm_scale):
    """Launch K5a or K5b writing ``outs``; ``slots`` gives the kernel the
    strides of its (dq, dk, dv) in that order (stand-ins for the ones it
    does not write); ``lists`` is (idx, counts), row or column lists, and
    ``union`` their (blocks, bits, counts) per 64-row tile. Returns 1 if the
    Hopper kernel ran, else 0."""
    _, km = _cuda_operands(q, k, v, None, kv_mask, symbol)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse, dsum = lse.contiguous(), dsum.contiguous()
    b, h, n, d = q.shape
    if b * h == 0:
        return 0
    idx, counts = lists
    blocks, bits, stages = union
    info = (ctypes.c_int * 1)()
    lib = build.library("block_sparse_attention_bwd")
    with torch.cuda.device(q.device):
        code = getattr(lib, symbol)(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum),
            *(_ptr(o) for o in outs), _ptr(km), _ptr(idx), _ptr(counts), idx.shape[1],
            _ptr(blocks), _ptr(bits), _ptr(stages), blocks.shape[1],
            _strides(q, k, v, dout, *slots), b, h, n, d, layout.block_size, float(sm_scale),
            info, _stream())
    build.check(lib, code, symbol)
    return info[0]


def block_sparse_attention_dq(q, k, v, dout, lse, dsum, layout, kv_mask=None, sm_scale=1.0):
    """K5a: dq (B, H, N, D) in q's dtype from the forward's ``lse`` and
    ``dsum = attention_dsum(out, dout)``, over each query block's row list."""
    _check(q, k, v, layout, kv_mask)
    _check_grad(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return block_sparse_attention_dq_reference(q, k, v, dout, lse, dsum, layout, kv_mask,
                                                   sm_scale)
    dq = _like_heads(q)
    rows, counts, _, _ = layout.tensors(q.device)
    union = layout.union_tensors(q.device)[:3]
    block_sparse_attention_dq.sm90_launches += _launch_backward(
        "af2_block_sparse_attention_bwd_dq", (dq,), (dq, k, v), (rows, counts), union,
        q, k, v, dout, lse, dsum, layout, kv_mask, sm_scale)
    block_sparse_attention_dq.launches += 1
    return dq


block_sparse_attention_dq.launches = 0
block_sparse_attention_dq.sm90_launches = 0  # of them, launches of sparse_dq_kernel_sm90


def block_sparse_attention_dkv(q, k, v, dout, lse, dsum, layout, kv_mask=None, sm_scale=1.0):
    """K5b: (dk, dv), each (B, H, N, D) in k's dtype, over each key block's
    column list (the query blocks that attend it)."""
    _check(q, k, v, layout, kv_mask)
    _check_grad(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return block_sparse_attention_dkv_reference(q, k, v, dout, lse, dsum, layout, kv_mask,
                                                    sm_scale)
    dk, dv = _like_heads(k), _like_heads(v)
    _, _, cols, counts = layout.tensors(q.device)
    union = layout.union_tensors(q.device)[3:]
    block_sparse_attention_dkv.sm90_launches += _launch_backward(
        "af2_block_sparse_attention_bwd_dkv", (dk, dv), (q, dk, dv), (cols, counts), union,
        q, k, v, dout, lse, dsum, layout, kv_mask, sm_scale)
    block_sparse_attention_dkv.launches += 1
    return dk, dv


block_sparse_attention_dkv.launches = 0
block_sparse_attention_dkv.sm90_launches = 0  # of them, launches of sparse_dkv_kernel_sm90


class BlockSparseAttention(torch.autograd.Function):
    """Forward K4 with the row logsumexp, backward K5a + K5b (or, on the
    CPU, their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, layout, kv_mask, sm_scale):
        out, lse = block_sparse_attention_lse(q, k, v, layout, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.layout, ctx.sm_scale = layout, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        args = (q, k, v, dout, lse, attention_dsum(out, dout), ctx.layout, kv_mask,
                ctx.sm_scale)
        return (block_sparse_attention_dq(*args), *block_sparse_attention_dkv(*args),
                None, None, None)


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    layout: BlockLayout,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Block-sparse self-attention over ``layout``; returns (B, H, N, D) in
    q's dtype, differentiable.

    CUDA tensors: q/k/v may be strided views with a contiguous head dim; the
    result is a (B, H, N, D) view of a (B, N, H, D) buffer, as K1's is."""
    _check(q, k, v, layout, kv_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return BlockSparseAttention.apply(q, k, v, layout, kv_mask, sm_scale)
    if q.device.type == "cpu":
        return block_sparse_attention_reference(q, k, v, layout, kv_mask, sm_scale)
    out, _, sm90 = _launch_forward(q, k, v, layout, kv_mask, sm_scale, with_lse=False)
    block_sparse_attention.sm90_launches += sm90
    block_sparse_attention.launches += 1
    return out


block_sparse_attention.launches = 0
block_sparse_attention.sm90_launches = 0  # of them, launches of sparse_fwd_kernel_sm90
