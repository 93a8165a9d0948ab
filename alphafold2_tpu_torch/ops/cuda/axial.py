"""K1 (fused flash-attention forward) and K3a/K3b (its backward): CUDA
kernel wrappers, plain versions, and the autograd ``Function`` joining them.

Port of ``alphafold2_tpu/ops/pallas/axial.py`` ``fused_attention``: the
forward ``_run`` / ``_fwd_core`` (K1, ``csrc/fused_attention.cu``) and the
custom-VJP backward ``_run_dq`` / ``_run_dkv`` (K3a/K3b,
``csrc/fused_attention_bwd.cu``). Each kernel has a plain PyTorch version
here: :func:`fused_attention_reference` (forward),
:func:`fused_attention_lse_reference` (forward with the row logsumexp),
:func:`fused_attention_dq_reference` and :func:`fused_attention_dkv_reference`
(the backward, one per kernel). The wrappers run the plain versions only for tensors on the CPU;
for CUDA tensors they launch the kernel or raise.

Head dims: the kernels are built for 16, 32, 64 and 128 (``HEAD_DIMS``)
and for any head dim past 128: where D is a multiple of 64 both directions
read the head dim as R = D/64 rows of 64 features (:func:`row_width`) and
run K2's kernels on it, K1's bf16 forward on the Hopper walk of
``csrc/tied_row_attention.cu`` (its strided entry, tie scale 1; the plain
version of that walk is ``tied_row.hopper_walk_reference`` on
:func:`head_rows` views) and K3a/K3b through
``csrc/tied_row_attention_bwd.cu`` (operands TMA cannot describe run their
chunked kernels there); otherwise (and in f32) K1 runs D-chunked through
``csrc/attention_tile.cuh``. A head dim below 128 that is not built runs
zero-padded up to the next built one (:func:`kernel_head_dim`,
:func:`at_kernel_head_dim`), which is exact: zero columns add nothing to
q.k, P.V, ds.k or ds^T.q, and ``sm_scale`` stays the caller's. So the card
takes every head dim JAX's ``fused_attention`` takes.

K1's bf16 forward at head dim 32, 64 or 128 runs one of two Hopper kernels.
Short problems (fewer than 64 queries and keys: the template axis, the MSA
column passes) run ``csrc/fused_attention_packed_sm90.cuh``: G consecutive
problems of one head packed into one 128 x 128 tile under a block-diagonal
mask, walked by persistent blocks (:func:`packed_plan`;
:func:`packed_walk_reference` is the plain version of that walk). Every
other shape runs
``csrc/fused_attention_sm90.cuh``. Where its grid leaves the card short of
two waves, or a block would stream more than MAX_SPLIT_TILES key tiles,
:func:`key_splits` cuts the key axis into ranges; each block then
writes f32 partials and K1's combine pass (:func:`fused_attention_combine`)
merges them. Their plain versions: :func:`attention_partials_reference` and
:func:`combine_partials_reference`.

K3a/K3b's bf16 backward at head dim 32, 64 or 128 runs the Hopper kernels of
``csrc/fused_attention_bwd_sm90.cuh``. Where a kernel's grid leaves the card
short of two waves, or a range would stream more than MAX_GRAD_SPLIT_TILES
tiles, :func:`grad_splits` cuts its long loop (keys for K3a, queries for
K3b) into ranges; each block then writes f32 partials and K3's
merge pass (:func:`fused_attention_bwd_merge`) adds them in split order.
Their plain versions: :func:`dq_partials_reference`,
:func:`dkv_partials_reference` and :func:`merge_grad_partials_reference`.

Where :func:`grad_route` says ``"onepass"`` (head dim 32 or 64, one
block of 128 keys or two over 3-4 query tiles), the backward is one kernel
instead, ``csrc/fused_attention_bwd_onepass_sm90.cuh``
(:func:`fused_attention_bwd`): each block owns 128 keys, passes once over
each (query tile, key tile) pair, and the key blocks of one (batch, head)
sum dq across a thread-block cluster in rank order. Its plain version is
:func:`fused_attention_bwd_reference`. rowsum(dO * O), which both routes
take, is a kernel too (:func:`attention_dsum`; plain version
:func:`attention_dsum_reference`).

:func:`fused_attention` is differentiable. When grad is enabled and an input
requires it, it runs :class:`FusedAttention`: on the card K1 with the
logsumexp forward and K3a + K3b backward, on the CPU the plain versions of
the same math (never autograd through an einsum). Otherwise it runs the
no-logsumexp forward, which is all serving launches.
:func:`fused_attention_lse` is differentiable in its lse too
(:class:`FusedAttentionLse`), as the sharded passes that merge partials by
their lse need it.

Contract (the JAX function's, with one sharpening): q (B, H, Nq, D),
k/v (B, H, Nk, D), boolean ``q_mask`` (B, Nq) and ``kv_mask`` (B, Nk)
shared by all heads. Masked keys are excluded exactly; masked queries give
0. A query row with no valid key gives exactly 0 (the TPU kernel gave a
finite average over its padded block there; every caller masks such rows).
In the backward, masked queries and query rows with no valid key get dq = 0
and add nothing to dk/dv; masked keys get dk = dv = 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from alphafold2_tpu_torch.ops.cuda import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the redesigned kernel's tiles (csrc/fused_attention_sm90.cuh kBlockM,
# kBlockN) and the card it fills
QUERY_TILE = 128
KEY_TILE = 128
SM_COUNT = 132  # streaming multiprocessors of one H100
MIN_SPLIT_TILES = 4  # key tiles a split keeps at least
# key tiles a split streams at most: the tensor cores' f32 accumulator of
# P V drifts over a split's key tiles, so the output's error grows with the
# stream while the lse (summed on the CUDA cores) stays exact (on the H100
# against the plain version, chip_smoke.py's long_mesh checks: 0.49%
# relative L2 after 9,216 tiles a split, 1.0% after 20,736, 0.16% after
# 1,024; 0.05-0.07% over the pair passes' 12-30 tiles)
MAX_SPLIT_TILES = 1024
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
# K3a/K3b's Hopper kernels (csrc/fused_attention_bwd_sm90.cuh): the rows of
# every tile, the head dims they are built for, the tiles a split keeps
GRAD_TILE = 64
GRAD_SM90_HEAD_DIMS = (32, 64, 128)
MIN_GRAD_SPLIT_TILES = 4
# 64-row tiles a K3a key range or a K3b query range streams at most: the
# tensor cores' f32 accumulators of dS K (K3a), dS^T Q and P^T dO (K3b)
# drift over a long stream, as K1's of P V does. On the H100 against the
# plain version, one split (chip_smoke.py phase_k3_streams): relative L2
# 6.5e-4 / 6.1e-4 (K3a / K3b) after 1,024 tiles, 9.5e-4 / 8.5e-4 after
# 2,048, 1.3e-3 / 1.3e-3 after 4,096, 2.0e-3 / 1.8e-3 after 9,216, all
# inside the bf16 bound of 4e-3 and growing about as the root of the
# stream; the cap is the longest stream measured
MAX_GRAD_SPLIT_TILES = 9216
# the one-pass backward (csrc/fused_attention_bwd_onepass_sm90.cuh kKeys,
# kMaxCluster, resident_tiles()), mirrored: head dim 32 or 64, 128 keys a
# block, the key blocks of a (batch, head) one cluster of 1 or 2 blocks,
# whose f32 dq of every 64-query tile stays resident in each block's shared
# memory until the cluster sums it: at most 15 query tiles at head dim 32,
# 4 at 64
ONEPASS_KEY_TILE = 128
ONEPASS_MAX_CLUSTER = 2
ONEPASS_RESIDENT_TILES = {32: 15, 64: 4}
# K1's packed kernel (csrc/fused_attention_packed_sm90.cuh kRows, kMaxN,
# kRingBytes, kSMs; PackedControl), mirrored: 128-row tiles of G problems,
# problems under 64 tokens, a 192 KB ring of whole stages, one persistent
# block an SM
PACKED_KERNEL = "attention_packed_kernel_sm90"
PACKED_TILE = 128
PACKED_MAX_N = 63
PACKED_RING_BYTES = 196_608
PACKED_MAX_STAGES = 8
PACKED_CONTROL_BYTES = 416  # 8 full and 8 empty barriers, 8 x 4 mask words, 8 tiles,
# and each warpgroup row's problem and token (64 bytes each)
PACKED_THREADS = 288  # two consumer warpgroups and one producer warp


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run head dim ``d`` at: ``d`` itself where a
    kernel is built for it (``HEAD_DIMS``, or past 128, D-chunked),
    otherwise the next of ``HEAD_DIMS`` up, to zero-pad to."""
    if d in HEAD_DIMS or d > HEAD_DIMS[-1]:
        return d
    return next(x for x in HEAD_DIMS if x > d)


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """(B, H, N, D) ``t`` zero-padded along D to ``dp``: a (B, H, N, dp) view
    of one new (B, N, H, dp) buffer, the layout the projections give."""
    b, h, n, d = t.shape
    out = t.new_zeros((b, n, h, dp)).permute(0, 2, 1, 3)
    out[..., :d] = t
    return out


def attention_flops(b: int, h: int, nq: int, nk: int, d: int) -> float:
    """One K1 call's matmul flops at the caller's head dim: Q·Kᵀ and P·V,
    4·B·H·Nq·Nk·D (2 a multiply-add), what ``FlopCounterMode`` counts of
    the plain version. The wrappers announce it where they launch the
    kernel (:func:`~alphafold2_tpu_torch.ops.cuda.build.tally_flops`)."""
    return 4.0 * b * h * nq * nk * d


def attention_grad_flops(b: int, h: int, nq: int, nk: int, d: int, which: str) -> float:
    """One K3a (``which`` "dq") or K3b ("dkv") call's matmul flops at the
    caller's head dim, what ``FlopCounterMode`` counts of its plain version:
    the recomputed S = Q·Kᵀ and dP = dO·Vᵀ, then dS·K (K3a, 6·B·H·Nq·Nk·D)
    or dSᵀ·Q and Pᵀ·dO (K3b, 8·B·H·Nq·Nk·D)."""
    return {"dq": 6.0, "dkv": 8.0}[which] * b * h * nq * nk * d


def attention_bwd_flops(b: int, h: int, nq: int, nk: int, d: int) -> float:
    """One one-pass backward's matmul flops at the caller's head dim, what
    ``FlopCounterMode`` counts of its plain version: S = Q·Kᵀ, dP = dO·Vᵀ,
    dV, dK and dQ once each, 10·B·H·Nq·Nk·D."""
    return 10.0 * b * h * nq * nk * d


def onepass_cluster(nq: int, nk: int, d: int) -> int:
    """The cluster the one-pass backward gives a problem of ``nq`` queries
    and ``nk`` keys at kernel head dim ``d``: ceil(nk/128) blocks, or 0
    where it does not take it (a head dim other than 32 or 64; more than
    ONEPASS_MAX_CLUSTER blocks; a cluster whose query tiles' dq does not fit
    resident, ONEPASS_RESIDENT_TILES). Mirrors ``onepass::cluster_of``."""
    if d not in ONEPASS_RESIDENT_TILES:
        return 0
    c = -(-nk // ONEPASS_KEY_TILE)
    if c > ONEPASS_MAX_CLUSTER or (c > 1 and -(-nq // GRAD_TILE) > ONEPASS_RESIDENT_TILES[d]):
        return 0
    return c


def grad_route(b: int, h: int, nq: int, nk: int, d: int) -> str:
    """Which backward K1's autograd Functions run at a shape: ``"onepass"``
    (:func:`fused_attention_bwd`, one kernel) where the kernel head dim
    (:func:`kernel_head_dim`) is 32 or 64 and :func:`onepass_cluster` gives
    one block, or a cluster of two over at least 3 query tiles (at most 4 at
    head dim 64 fit resident); else ``"split"`` (K3a and K3b; head dim 128
    too, whose dk, dv, S and dP do not fit the one-pass block's registers).
    The rule follows the H100's times against K3a + K3b (PERF.md §6, PR 27:
    one block wins at every shape measured; two at 256 queries and ties at
    64-128; clusters of four and eight lost by 2-2.6x, and
    :func:`onepass_cluster` gives none). A pure function of the shape,
    as :func:`grad_splits`: the Functions route with it on the card and on
    the CPU alike (the CPU runs the route's plain version), the build gate
    plans with it. On the card a bf16 problem whose operands TMA cannot
    describe, and f32, keep K3a/K3b whatever the route."""
    del b, h
    c = onepass_cluster(nq, nk, kernel_head_dim(d))
    return "onepass" if c == 1 or (c == 2 and -(-nq // GRAD_TILE) >= 3) else "split"


def at_kernel_head_dim(run, tensors):
    """``run(*tensors)`` at :func:`kernel_head_dim` of the tensors' head
    dim: where that differs, each (B, H, N, D) operand is zero-padded (one
    buffer each) and every 4-d result is sliced back to D; other results
    (lse) pass as they are. ``run`` returns a tensor or a tuple."""
    d = tensors[0].shape[-1]
    dp = kernel_head_dim(d)
    if dp == d:
        return run(*tensors)
    res = run(*(pad_head_dim(t, dp) for t in tensors))
    cut = lambda t: t[..., :d] if t is not None and t.dim() == 4 else t
    return tuple(cut(t) for t in res) if isinstance(res, tuple) else cut(res)


def key_splits(b: int, h: int, nq: int, nk: int, d: int) -> int:
    """How many contiguous key ranges K1 cuts the key axis into: enough
    that no range streams more than MAX_SPLIT_TILES 128-key tiles, and
    where its b*h*ceil(nq/128) blocks make less than two waves on the
    card's 132 SMs, at least enough for about two waves, each of at least
    MIN_SPLIT_TILES tiles. A pure function of the shape: the wrapper
    passes it to the kernel, the build gate plans with it. ``d`` does not
    change the count (every head dim uses 128-row, 128-key tiles)."""
    del d
    blocks = b * h * -(-nq // QUERY_TILE)
    if blocks == 0:
        return 1
    tiles = -(-nk // KEY_TILE)
    longest = -(-tiles // MAX_SPLIT_TILES)
    if blocks >= 2 * SM_COUNT:
        return longest
    return max(1, longest, min(-(-2 * SM_COUNT // blocks), tiles // MIN_SPLIT_TILES))


def grad_splits(b: int, h: int, nq: int, nk: int, d: int, which: str) -> int:
    """How many contiguous ranges K3a (``which`` "dq") cuts its key loop
    into, or K3b ("dkv") its query loop: enough that no range streams more
    than MAX_GRAD_SPLIT_TILES 64-row tiles, and where the kernel's
    b*h*ceil(rows/64) blocks (rows: queries for K3a, keys for K3b) make
    less than two waves on the card's 132 SMs, at least enough for about
    two waves, each of at least MIN_GRAD_SPLIT_TILES tiles. A pure function
    of the shape, as :func:`key_splits`: the wrapper passes it to the
    kernel, the build gate plans with it. ``d`` does not change the
    count."""
    del d
    if which not in ("dq", "dkv"):
        raise ValueError(f"which must be 'dq' or 'dkv', not {which!r}")
    rows, streamed = (nq, nk) if which == "dq" else (nk, nq)
    blocks = b * h * -(-rows // GRAD_TILE)
    if blocks == 0:
        return 1
    tiles = -(-streamed // GRAD_TILE)
    longest = -(-tiles // MAX_GRAD_SPLIT_TILES)
    if blocks >= 2 * SM_COUNT:
        return max(1, longest)
    return max(1, longest, min(-(-2 * SM_COUNT // blocks), tiles // MIN_GRAD_SPLIT_TILES))


def split_ranges(nk: int, splits: int, block: int = KEY_TILE) -> list:
    """The key range ``[lo, hi)`` of each split, cut as the kernel cuts
    them: whole ``block``-key tiles, split s taking tiles
    ``[s*T//S, (s+1)*T//S)`` of ``T = ceil(nk/block)``. A range may be
    empty."""
    tiles = -(-nk // block)
    return [(min(nk, s * tiles // splits * block), min(nk, (s + 1) * tiles // splits * block))
            for s in range(splits)]


def packed_group(nq: int, nk: int) -> int:
    """G, the problems one packed tile holds: Gh = 64 // nq in each
    consumer warpgroup's 64 query rows, G = min(2 Gh, 128 // nk) so that
    their keys fit one 128-key stage."""
    return min(2 * (PACKED_TILE // 2 // nq), PACKED_TILE // nk)


def packed_plan(b: int, h: int, nq: int, nk: int, d: int) -> Optional[dict]:
    """K1's packed kernel at a bf16 shape whose operands TMA can describe,
    or None where another kernel takes it (head dim outside 32/64/128, 64
    or more queries or keys). A pure function of the shape: G problems a
    tile (:func:`packed_group`), ``tiles`` = h * ceil(b / G) in the order
    (problem set, head), ``blocks`` a persistent grid of at most SM_COUNT,
    one an SM, each with as many whole stages as the ring's 192 KB hold.
    ``key_splits`` does not apply: one key tile covers a problem set."""
    if (d not in GRAD_SM90_HEAD_DIMS or not 1 <= nq <= PACKED_MAX_N
            or not 1 <= nk <= PACKED_MAX_N):
        return None
    g = packed_group(nq, nk)
    tiles = h * -(-b // g)
    stage = 2 * 64 * d * 2 + 2 * PACKED_TILE * d * 2  # q (two warpgroups), K and V
    stages = PACKED_RING_BYTES // stage
    return {"kernel": f"{PACKED_KERNEL}<{d}>", "group": g, "tiles": tiles,
            "blocks": min(tiles, SM_COUNT), "threads": PACKED_THREADS, "stages": stages,
            "dynamic_smem": 1024 + stages * stage + PACKED_CONTROL_BYTES}


def packed_walk_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0, group=None):
    """The plain version of K1's packed walk: the problems cut into tiles of
    G (:func:`packed_group` by default) consecutive problems of one head, as
    the kernel cuts them, each tile's G*nq x G*nk logits computed at once
    and scaled in f32 by sm_scale * log2 e; each row sees the keys of its
    own problem that kv_mask keeps (block-diagonal), its max and sum over
    them, p = 2^(x - max) rounded to q's dtype before P V (the sum keeps it
    in f32). Returns (out, lse) as :func:`fused_attention_lse`: masked
    queries and rows with no valid key give 0, such rows lse +inf (a masked
    query keeps its lse)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    g = packed_group(nq, nk) if group is None else group
    scale2 = sm_scale * LOG2E
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=q.device))
    out = torch.zeros((b, h, nq, d), device=q.device)
    lse = torch.full((b, h, nq), float("inf"), device=q.device)
    for b0 in range(0, b, g):
        sl = slice(b0, min(b0 + g, b))
        m = sl.stop - b0
        fold = lambda t, n: t[sl].float().permute(1, 0, 2, 3).reshape(h, m * n, d)
        x = fold(q, nq) @ fold(k, nk).transpose(-1, -2) * scale2  # (H, m*nq, m*nk)
        same = (torch.arange(m * nq, device=q.device)[:, None] // nq
                == torch.arange(m * nk, device=q.device)[None, :] // nk)
        valid = same & keys[sl].reshape(1, m * nk)
        mx = x.masked_fill(~valid, float("-inf")).amax(-1, keepdim=True)
        keyed = torch.isfinite(mx)
        p = torch.where(valid, torch.exp2(x - torch.where(keyed, mx, 0.0)), 0.0)
        l = p.sum(-1, keepdim=True)
        o = (p.to(q.dtype).float() @ fold(v, nk)) / l.clamp_min(1e-30)
        lt = torch.where(keyed, mx * LN2 + torch.log(l.clamp_min(1e-30)), float("inf"))
        out[sl] = o.reshape(h, m, nq, d).permute(1, 0, 2, 3)
        lse[sl] = lt[..., 0].reshape(h, m, nq).permute(1, 0, 2)
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    return out.to(q.dtype), lse


def _masked_softmax_weights(s: torch.Tensor, valid: Optional[torch.Tensor]):
    """Exact-exclusion softmax numerator and denominator over the last
    axis: masked entries weigh 0, a row with no valid entry sums to 0."""
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    if valid is not None:
        p = p * valid.to(p.dtype)
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _attend(q, k, v, q_mask, kv_mask, sm_scale, with_lse):
    """Plain attention in f32: out in q's dtype, and with ``with_lse`` the
    (B, H, Nq) f32 logsumexp of each row's scaled logits over its valid
    keys, +inf for a row with none."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    valid = kv_mask[:, None, None, :] if kv_mask is not None else None
    p, l = _masked_softmax_weights(s, valid)
    out = torch.einsum("bhij,bhjd->bhid", p, v.float()) / l
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    if not with_lse:
        return out.to(q.dtype)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return out.to(q.dtype), lse.masked_fill(lse == float("-inf"), float("inf"))


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (f32 arithmetic)."""
    build.count(fused_attention_reference, calls=1)
    return _attend(q, k, v, q_mask, kv_mask, sm_scale, with_lse=False)


fused_attention_reference.calls = 0


def fused_attention_lse_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
    """The plain version of the training forward: (out, lse)."""
    build.count(fused_attention_lse_reference, calls=1)
    return _attend(q, k, v, q_mask, kv_mask, sm_scale, with_lse=True)


fused_attention_lse_reference.calls = 0


def attention_partials_reference(q, k, v, kv_mask=None, sm_scale=1.0, splits=1,
                                 block=KEY_TILE):
    """The plain version of K1's split forward: per split s over its keys
    (:func:`split_ranges`), ``m`` (S, B, H, Nq) the largest scaled logit of
    a valid key (-inf where the range has none), ``l`` (S, B, H, Nq) the sum
    of exp(s - m) and ``acc`` (S, B, H, Nq, D) the sum of exp(s - m) v over
    the range's valid keys, all f32 (masked keys weigh 0)."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(k.shape[2], splits, block):
        part = s[..., lo:hi]
        m = (part.amax(dim=-1) if hi > lo
             else torch.full(part.shape[:-1], float("-inf"), dtype=s.dtype))
        p = torch.exp(part - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhij,bhjd->bhid", p, v[:, :, lo:hi].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials_reference(m, l, acc, q_mask=None, with_lse=False,
                               dtype=torch.float32):
    """The plain version of K1's combine pass: the partials of
    :func:`attention_partials_reference` merged into out (B, H, Nq, D) in
    ``dtype`` and, with ``with_lse``, the (B, H, Nq) f32 logsumexp (+inf
    for a row with no valid key). A masked query row and a row with no
    valid key give 0."""
    big = m.amax(dim=0)
    live = torch.isfinite(big)
    w = torch.exp(m - torch.where(live, big, 0.0))  # 0 for a range with no valid key
    total = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0) / total.clamp_min(1e-30)[..., None]
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    if not with_lse:
        return out.to(dtype)
    lse = torch.where(live, big + torch.log(torch.where(live, total, 1.0)), float("inf"))
    return out.to(dtype), lse


def recomputed_probabilities(s, lse, q_mask, kv_mask):
    """The backward's probabilities exp(s - lse) from the scaled (B, H, Nq,
    Nk) f32 logits ``s``, exactly 0 for masked keys, masked query rows and
    rows with lse = +inf."""
    live = torch.isfinite(lse)
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    valid = live[..., None]
    if kv_mask is not None:
        valid = valid & kv_mask[:, None, None, :]
    p = torch.exp(s - torch.where(live, lse, 0.0)[..., None])
    return torch.where(valid, p, 0.0)


def _probabilities(q, k, lse, q_mask, kv_mask, sm_scale):
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    return recomputed_probabilities(s, lse, q_mask, kv_mask)


def _ds(p, v, dout, dsum):
    dp = torch.einsum("bhid,bhjd->bhij", dout.float(), v.float())
    return p * (dp - dsum[..., None])


def fused_attention_dq_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                 sm_scale=1.0):
    """The plain version of K3a: dq = sm_scale * ds @ k, ds rounded to the
    operand dtype first (f32 arithmetic otherwise)."""
    build.count(fused_attention_dq_reference, calls=1)
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    return (sm_scale * torch.einsum("bhij,bhjd->bhid", ds, k.float())).to(q.dtype)


fused_attention_dq_reference.calls = 0


def fused_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                  sm_scale=1.0):
    """The plain version of K3b: (dk, dv) = (sm_scale * ds^T @ q, p^T @ dO),
    p and ds rounded to the operand dtype first."""
    build.count(fused_attention_dkv_reference, calls=1)
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    dv = torch.einsum("bhij,bhid->bhjd", p.to(q.dtype).float(), dout.float())
    dk = sm_scale * torch.einsum("bhij,bhid->bhjd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


fused_attention_dkv_reference.calls = 0


def dq_partials_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0,
                          splits=1, block=GRAD_TILE):
    """The plain version of K3a's split: per key range of
    :func:`split_ranges` (``block``-key tiles), ds @ k over the range's keys,
    unscaled, as (S, B, H, Nq, D) f32 (ds rounded to the operand dtype
    first, as in :func:`fused_attention_dq_reference`)."""
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    return torch.stack([torch.einsum("bhij,bhjd->bhid", ds[..., lo:hi], k[:, :, lo:hi].float())
                        for lo, hi in split_ranges(k.shape[2], splits, block)])


def dkv_partials_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0,
                           splits=1, block=GRAD_TILE):
    """The plain version of K3b's split: per query range of
    :func:`split_ranges`, (ds^T @ q unscaled, p^T @ dO) over the range's
    queries, each (S, B, H, Nk, D) f32 (p and ds rounded to the operand
    dtype first, as in :func:`fused_attention_dkv_reference`)."""
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    p = p.to(q.dtype).float()
    ranges = split_ranges(q.shape[2], splits, block)
    dk = [torch.einsum("bhij,bhid->bhjd", ds[:, :, lo:hi], q[:, :, lo:hi].float())
          for lo, hi in ranges]
    dv = [torch.einsum("bhij,bhid->bhjd", p[:, :, lo:hi], dout[:, :, lo:hi].float())
          for lo, hi in ranges]
    return torch.stack(dk), torch.stack(dv)


def fused_attention_bwd_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                  sm_scale=1.0):
    """The plain version of the one-pass backward: (dq, dk, dv) from one S
    and one dP, p and ds rounded to the operand dtype first; dv = p^T dO,
    dk = sm_scale * ds^T q, and dq summed over ONEPASS_KEY_TILE-key tiles in
    tile order (the kernel's cluster ranks), then times sm_scale."""
    build.count(fused_attention_bwd_reference, calls=1)
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dv = torch.einsum("bhij,bhid->bhjd", p, dout.float())
    dk = sm_scale * torch.einsum("bhij,bhid->bhjd", ds, q.float())
    dq = None
    tiles = max(1, -(-k.shape[2] // ONEPASS_KEY_TILE))
    for lo, hi in split_ranges(k.shape[2], tiles, ONEPASS_KEY_TILE):
        part = torch.einsum("bhij,bhjd->bhid", ds[..., lo:hi], k[:, :, lo:hi].float())
        dq = part if dq is None else dq + part
    return (sm_scale * dq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


fused_attention_bwd_reference.calls = 0


def merge_grad_partials_reference(part, scale=1.0, dtype=torch.float32):
    """The plain version of K3's merge pass: the (S, B, H, N, D) f32
    partials added in split order, times ``scale``, in ``dtype``."""
    acc = part[0].float()
    for s in range(1, part.shape[0]):
        acc = acc + part[s]
    return (acc * scale).to(dtype)


def attention_dsum_reference(out, dout, lse=None, dlse=None):
    """The plain version of the dsum pass: rowsum(dO * O) in f32, (B, H,
    Nq); with ``lse``, less ``dlse`` (the lse's cotangent, or nothing)
    where ``lse`` is finite, and 0 where it is +inf (a row with no valid
    key, whose O K1 writes as 0)."""
    dsum = (out.float() * dout.float()).sum(dim=-1)
    if lse is None:
        return dsum
    live = torch.isfinite(lse)
    if dlse is not None:
        dsum = dsum - torch.where(live, dlse.float(), 0.0)
    return torch.where(live, dsum, 0.0)


def attention_dsum(out, dout, lse=None, dlse=None):
    """rowsum(dO * O) (and the lse shift, :func:`attention_dsum_reference`)
    in f32, (B, H, Nq), which both backward routes read; JAX computes it
    outside its Pallas calls (``alphafold2_tpu/ops/pallas/axial.py:417``).
    On the card one pass of ``attention_dsum_kernel`` over O and dO through
    their strides (f32 or bf16); on the CPU the plain version."""
    if out.dim() != 4 or dout.shape != out.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be one "
                         f"(B, H, Nq, D) shape")
    b, h, nq, d = out.shape
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and tuple(t.shape) != (b, h, nq):
            raise ValueError(f"{name} must be ({b}, {h}, {nq}), got {tuple(t.shape)}")
    if dlse is not None and lse is None:
        raise ValueError("dlse needs lse")
    if out.device.type == "cpu":
        return attention_dsum_reference(out, dout, lse, dlse)
    if out.dtype not in _DTYPES or dout.dtype != out.dtype:
        raise TypeError(f"the dsum pass takes f32 or bf16 out and dout of one dtype, got "
                        f"{out.dtype}/{dout.dtype}")
    if any(t is not None and t.device != out.device for t in (dout, lse, dlse)):
        raise ValueError("attention_dsum operands must share one device")
    out, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (out, dout))
    lse, dlse = (t.float().contiguous() if t is not None else None for t in (lse, dlse))
    dsum = torch.empty((b, h, nq), dtype=torch.float32, device=out.device)
    if dsum.numel() == 0:
        return dsum
    lib = build.library("fused_attention_bwd")
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_attention_dsum(_DTYPES[out.dtype], _ptr(out), _ptr(dout), _ptr(lse),
                                      _ptr(dlse), _ptr(dsum), _strides(out, dout), b, h, nq, d,
                                      stream)
    build.check(lib, code, "attention_dsum")
    build.count(attention_dsum, launches=1)
    return dsum


attention_dsum.launches = 0


def _check(q, k, v, q_mask, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, N, D)")
    b, h, nq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q/k/v must share one dtype of {list(_DTYPES)}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    for name, m, n in (("q_mask", q_mask, nq), ("kv_mask", kv_mask, k.shape[2])):
        if m is not None and (m.dtype != torch.bool or tuple(m.shape) != (b, n)):
            raise ValueError(f"{name} must be bool ({b}, {n}), got "
                             f"{m.dtype} {tuple(m.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _cuda_operands(q, k, v, q_mask, kv_mask, what):
    """Checks the kernels share; returns the masks as contiguous tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    tensors = [t for t in (q, k, v, q_mask, kv_mask) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what} operands must share one device")
    if kernel_head_dim(q.shape[3]) != q.shape[3]:
        raise ValueError(f"head dim {q.shape[3]}: no kernel is built for it (pad it to "
                         f"{kernel_head_dim(q.shape[3])} first)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v head dim must be contiguous (stride 1)")
    if k.shape[2] == 0:
        raise ValueError(f"{what} needs at least one key")
    return [m.contiguous() if m is not None else None for m in (q_mask, kv_mask)]


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3])
    )


def _like_heads(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, N, D) view of a (B, N, H, D) buffer: folding
    heads back into channels (``t.transpose(1, 2).reshape(B, N, H * D)``)
    copies nothing."""
    b, h, n, d = x.shape
    return torch.empty((b, n, h, d), dtype=x.dtype, device=x.device).permute(0, 2, 1, 3)


def head_rows(t: torch.Tensor, row: int = 64) -> torch.Tensor:
    """A (B, H, N, R*row) tensor as the (B, R, N, H, row) view K2's kernels
    and plain versions take (R rows of ``row`` features, row stride
    ``row``): no copy."""
    b, h, n, d = t.shape
    return t.unflatten(-1, (d // row, row)).permute(0, 3, 2, 1, 4)


def _launch_rows_forward(q, k, v, out, lse, masks, sm_scale):
    """K1 past head dim 128 on the card, bf16 at a multiple of 64: the head
    dim read as R = D/64 rows of 64 features (:func:`head_rows`) and run on
    K2's kernels through their strided entry under tie scale 1. K2's plan
    picks the Hopper walk (R*D up to 512), the wide route (wider; its
    workspace allocated here from ``tied_row.wide_plan``) or, for operands
    TMA cannot describe, the chunked tile kernel K1 itself would run.
    Returns 1 if a Hopper kernel ran."""
    from alphafold2_tpu_torch.ops.cuda import tied_row  # it imports this module

    b, h, nq, d = q.shape
    nk, row = k.shape[2], row_width(d)
    plan = tied_row.wide_plan(b, d // row, h, nq, nk, row)
    work = (torch.empty(plan["workspace"], dtype=torch.uint8, device=q.device)
            if plan is not None else None)
    # (batch, head, token, row) element strides of the (B, R, N, H, row) views
    views = [head_rows(t, row) for t in (q, k, v, out)]
    strides = (ctypes.c_longlong * 16)(*(x for r in views
                                         for x in (r.stride(0), r.stride(3), r.stride(2),
                                                   r.stride(1))))
    lib = build.library("tied_row_attention")
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_tied_row_attention_strided(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(masks[0]),
            _ptr(masks[1]), None, strides, b, h, nq, nk, d, row, float(sm_scale), _ptr(work),
            work.numel() if work is not None else 0, info, stream)
    build.check(lib, code, "tied_row_attention_strided")
    return info[0]


def _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse):
    """K1 on CUDA tensors: out, and the (B, H, Nq) f32 lse when asked.
    Where the plan splits the key axis, the combine pass follows. A bf16
    head dim past 128 that is a multiple of 64 runs on K2's kernels
    (:func:`_launch_rows_forward`)."""
    masks = _cuda_operands(q, k, v, q_mask, kv_mask, "fused_attention")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = _like_heads(q)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if nq == 0 or b * h == 0:
        return out, lse
    if q.dtype == torch.bfloat16 and d > HEAD_DIMS[-1] and row_width(d) < d:
        hopper = _launch_rows_forward(q, k, v, out, lse, masks, sm_scale)
        build.count(fused_attention, launches=1, sm90_launches=hopper, row_launches=hopper)
        return out, lse
    lib = build.library("fused_attention")
    # only attention_kernel_sm90 (bf16, head dim 32, 64 or 128) splits the
    # key axis; at the packed kernel's shapes key_splits is 1
    hopper = q.dtype == torch.bfloat16 and d in HEAD_DIMS[1:]
    splits = key_splits(b, h, nq, nk, d) if hopper else 1
    part = (torch.empty(splits * b * h * nq * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
        tail = (_ptr(masks[0]), _ptr(masks[1]), _strides(q, k, v, out), b, h, nq, nk, d,
                float(sm_scale), splits, _ptr(part), info, stream)
        if with_lse:
            code = lib.af2_fused_attention_lse(_DTYPES[q.dtype], *ptrs, _ptr(lse), *tail)
        else:
            code = lib.af2_fused_attention(_DTYPES[q.dtype], *ptrs, *tail)
    build.check(lib, code, "fused_attention")
    build.count(fused_attention, launches=1, sm90_launches=info[0], packed_launches=info[2])
    if info[1] > 1:
        _launch_combine(part, out, lse, masks[0], info[1])
    return out, lse


def _launch_combine(part, out, lse, q_mask, splits):
    """K1's combine pass on the card: the packed partials ``part`` (m, l,
    acc, as the kernel writes them) into ``out`` and ``lse`` (or None)."""
    b, h, nq, d = out.shape
    lib = build.library("fused_attention")
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_fused_attention_combine(
            _ptr(part), _ptr(out), _ptr(lse), _ptr(q_mask), _strides(out), b, h, nq, d,
            splits, stream)
    build.check(lib, code, "fused_attention_combine")
    build.count(fused_attention_combine, launches=1)


def fused_attention_combine(m, l, acc, q_mask=None, with_lse=False):
    """K1's combine pass: partials (m, l, acc) as
    :func:`attention_partials_reference` gives them merged into a bf16
    (B, H, Nq, D) output and, with ``with_lse``, the f32 lse. On the card
    the kernel (which takes head dim 32, 64 or 128), on the CPU
    :func:`combine_partials_reference`."""
    splits, b, h, nq = m.shape
    d = acc.shape[-1]
    if l.shape != m.shape or acc.shape != (splits, b, h, nq, d):
        raise ValueError(f"partials m {tuple(m.shape)}, l {tuple(l.shape)}, acc "
                         f"{tuple(acc.shape)} do not match")
    if q_mask is not None and (q_mask.dtype != torch.bool or tuple(q_mask.shape) != (b, nq)):
        raise ValueError(f"q_mask must be bool ({b}, {nq}), got {q_mask.dtype} "
                         f"{tuple(q_mask.shape)}")
    if any(t.device != m.device for t in (l, acc, q_mask) if t is not None):
        raise ValueError("the partials and q_mask must share one device")
    if m.device.type == "cpu":
        return combine_partials_reference(m, l, acc, q_mask, with_lse, dtype=torch.bfloat16)
    if d not in (32, 64, 128):
        raise ValueError(f"the combine pass takes head dim 32, 64 or 128, not {d}")
    part = torch.cat([t.float().reshape(-1) for t in (m, l, acc)])
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=m.device).permute(0, 2, 1, 3)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=m.device)
           if with_lse else None)
    qm = q_mask.contiguous() if q_mask is not None else None
    _launch_combine(part, out, lse, qm, splits)
    return (out, lse) if with_lse else out


fused_attention_combine.launches = 0


def fused_attention_lse(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K1's training forward: (out, lse), lse the (B, H, Nq) f32 logsumexp
    of each row's scaled logits over its valid keys, +inf for a row with
    none. Where grad is enabled and an input requires it, it runs
    :class:`FusedAttentionLse`, differentiable in both outputs (the
    sharded passes merge partials by their lse)."""
    _check(q, k, v, q_mask, kv_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttentionLse.apply(q, k, v, q_mask, kv_mask, sm_scale)
    return _lse_forward(q, k, v, q_mask, kv_mask, sm_scale)


def _lse_forward(q, k, v, q_mask, kv_mask, sm_scale):
    if q.device.type == "cpu":
        return fused_attention_lse_reference(q, k, v, q_mask, kv_mask, sm_scale)
    build.tally_flops("fused_attention", attention_flops(*q.shape[:3], k.shape[2], q.shape[3]))
    return at_kernel_head_dim(
        lambda q, k, v: _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse=True),
        (q, k, v))


def _check_grad_operands(q, k, v, dout, lse, dsum):
    b, h, nq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != (b, h, nq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 ({b}, {h}, {nq})")


def launch_tied_backward(which, outs, q, k, v, dout, lse, dsum, masks, tie, strides, dims,
                         sm_scale) -> tuple:
    """The backward kernels of ``csrc/tied_row_attention_bwd.cu`` on CUDA
    tensors: ``which`` "dq" writes ``outs`` (dq,), "dkv" writes (dk, dv),
    "grads" writes (dq, dk, dv) (the wide route then computes S, dP, p and
    ds once for the three). ``strides``: 28 element strides, (batch, head,
    token, row group) of q, k, v, dout and the (dq, dk, dv) slots;
    ``dims``: (batch, heads, nq, nk, features, row width); ``tie``: a (B,)
    f32 tensor or None; ``masks``: contiguous (q_mask, kv_mask), each or
    None. The C plan picks the resident Hopper kernels (bf16 at row width
    32, 64 or 128, operands TMA can describe, the fused axis narrow enough),
    the wide route (the same, wider) or the chunked ones; where the wide
    route's plan (``tied_row.wide_bwd_plan``) takes the shape, its workspace
    is allocated here. Returns the entry's info: (a Hopper kernel ran, the
    wide route ran), for "grads" (dq on a Hopper kernel, dk/dv on one, the
    wide route ran)."""
    from alphafold2_tpu_torch.ops.cuda.tied_row import wide_bwd_plan  # it imports this module

    plan = wide_bwd_plan(*dims) if q.dtype == torch.bfloat16 else None
    work = (torch.empty(plan["workspace"], dtype=torch.uint8, device=q.device)
            if plan is not None else None)
    symbol = f"af2_tied_row_attention_bwd_{which}"
    lib = build.library("tied_row_attention_bwd")
    info = (ctypes.c_int * (3 if which == "grads" else 2))()
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = getattr(lib, symbol)(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum),
            *(_ptr(o) for o in outs), _ptr(masks[0]), _ptr(masks[1]), _ptr(tie),
            (ctypes.c_longlong * 28)(*strides), *dims, float(sm_scale), _ptr(work),
            work.numel() if work is not None else 0, info, stream)
    build.check(lib, code, symbol)
    return tuple(info)


def row_width(d: int) -> int:
    """The row width K1's forward and K3a/K3b's backward past head dim 128
    group a head dim ``d`` into: 64 where ``d`` is a multiple of 64 (R =
    d/64 rows of 64 features, which K2's Hopper kernels take,
    ``csrc/tied_row_attention_sm90.cuh`` forward and
    ``csrc/tied_row_attention_bwd_sm90.cuh`` backward), else ``d`` itself
    (one row, the chunked kernels)."""
    return 64 if d % 64 == 0 else d


def _launch_backward(which, outs, slots, q, k, v, dout, lse, dsum, q_mask, kv_mask,
                     sm_scale):
    """Launch K3a (``which`` "dq") or K3b ("dkv") writing ``outs``;
    ``slots`` gives the kernel the strides of its (dq, dk, dv) in that order
    (stand-ins for the ones it does not write). A head dim past 128 runs the
    kernels of ``csrc/tied_row_attention_bwd.cu`` on the head dim cut into
    rows (:func:`row_width`). Where the plan splits the long loop, the merge
    pass follows. Returns 1 if a Hopper kernel ran (past head dim 128,
    tied_dq_kernel_sm90 / tied_dkv_kernel_sm90), else 0."""
    symbol = f"af2_fused_attention_bwd_{which}"
    masks = _cuda_operands(q, k, v, q_mask, kv_mask, symbol)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse, dsum = lse.contiguous(), dsum.contiguous()
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if nq == 0 or b * h == 0:
        for o in outs:
            o.zero_()
        return 0
    if d > HEAD_DIMS[-1]:
        # R = d / row rows of `row` features each, row stride `row` (0: one row)
        row = row_width(d)
        strides = [x for t in (q, k, v, dout, *slots)
                   for x in (*t.stride()[:3], row if row < d else 0)]
        return launch_tied_backward(which, outs, q, k, v, dout, lse, dsum, masks, None,
                                    strides, (b, h, nq, nk, d, row), sm_scale)[0]
    lib = build.library("fused_attention_bwd")
    # only the Hopper kernels (bf16, GRAD_SM90_HEAD_DIMS) split their loop
    hopper = q.dtype == torch.bfloat16 and d in GRAD_SM90_HEAD_DIMS
    splits = grad_splits(b, h, nq, nk, d, which) if hopper else 1
    rows = nq if which == "dq" else nk
    part = (torch.empty(len(outs) * splits * b * h * rows * d, dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = getattr(lib, symbol)(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum),
            *(_ptr(o) for o in outs), _ptr(masks[0]), _ptr(masks[1]),
            _strides(q, k, v, dout, *slots), b, h, nq, nk, d, float(sm_scale), splits,
            _ptr(part), info, stream,
        )
        build.check(lib, code, symbol)
        if info[1] > 1:
            scales = (float(sm_scale),) if which == "dq" else (float(sm_scale), 1.0)
            _launch_merge(lib, stream, part, outs, scales, info[1])
    return info[0]


def _launch_merge(lib, stream, part, outs, scales, splits):
    """K3's merge pass on the card, on the current device and ``stream``:
    the packed f32 partials ``part`` (per output, per split, (B, H, N, D))
    into the bf16 ``outs`` (one or two (B, H, N, D) tensors), each times its
    scale."""
    b, h, n, d = outs[0].shape
    two = len(outs) == 2
    code = lib.af2_fused_attention_bwd_merge(
        _ptr(part), _ptr(outs[0]), _ptr(outs[1] if two else None), _strides(*outs),
        scales[0], scales[1] if two else 1.0, len(outs), b, h, n, d, splits, stream)
    build.check(lib, code, "fused_attention_bwd_merge")
    build.count(fused_attention_bwd_merge, launches=1)


def fused_attention_bwd_merge(part, scale=1.0):
    """K3's merge pass: f32 partials (S, B, H, N, D), as
    :func:`dq_partials_reference` and :func:`dkv_partials_reference` give
    them, added in split order, times ``scale``, as a bf16 (B, H, N, D)
    tensor. On the card the kernel (head dim 32, 64 or 128), on the CPU
    :func:`merge_grad_partials_reference`."""
    if part.dim() != 5 or part.shape[0] < 1:
        raise ValueError(f"partials must be (S, B, H, N, D) with S >= 1, got "
                         f"{tuple(part.shape)}")
    if part.device.type == "cpu":
        return merge_grad_partials_reference(part, scale, dtype=torch.bfloat16)
    splits, b, h, n, d = part.shape
    if d not in GRAD_SM90_HEAD_DIMS:
        raise ValueError(f"the merge pass takes head dim 32, 64 or 128, not {d}")
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=part.device).permute(0, 2, 1, 3)
    lib = build.library("fused_attention_bwd")
    with torch.cuda.device(part.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        _launch_merge(lib, stream, part.float().contiguous(), (out,), (float(scale),), splits)
    return out


fused_attention_bwd_merge.launches = 0


def fused_attention_dq(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3a: dq (B, H, Nq, D) in q's dtype from the forward's ``lse`` and
    ``dsum = attention_dsum(out, dout)``."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return fused_attention_dq_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                            sm_scale)
    build.tally_flops("fused_attention_dq",
                      attention_grad_flops(*q.shape[:3], k.shape[2], q.shape[3], "dq"))

    def run(q, k, v, dout):
        dq = _like_heads(q)
        hopper = _launch_backward(
            "dq", (dq,), (dq, k, v), q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
        build.count(fused_attention_dq, launches=1, sm90_launches=hopper)
        return dq

    return at_kernel_head_dim(run, (q, k, v, dout))


fused_attention_dq.launches = 0
# of them, launches of a Hopper kernel: dq_kernel_sm90, or past head dim 128
# tied_dq_kernel_sm90
fused_attention_dq.sm90_launches = 0


def fused_attention_dkv(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3b: (dk, dv), each (B, H, Nk, D) in k's dtype."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return fused_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                             sm_scale)
    build.tally_flops("fused_attention_dkv",
                      attention_grad_flops(*q.shape[:3], k.shape[2], q.shape[3], "dkv"))

    def run(q, k, v, dout):
        dk, dv = _like_heads(k), _like_heads(v)
        hopper = _launch_backward(
            "dkv", (dk, dv), (q, dk, dv), q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
        build.count(fused_attention_dkv, launches=1, sm90_launches=hopper)
        return dk, dv

    return at_kernel_head_dim(run, (q, k, v, dout))


fused_attention_dkv.launches = 0
# of them, launches of dkv_kernel_sm90, or past head dim 128 tied_dkv_kernel_sm90
fused_attention_dkv.sm90_launches = 0


def _tma_ok(t: torch.Tensor) -> bool:
    """Can TMA describe a (B, H, N, D) bf16 operand as the Hopper kernels
    read it: a 16-byte aligned base, the head dim contiguous, every other
    stride of an axis longer than 1 a positive multiple of 8 elements below
    2^39 (``sm90_ptx.cuh`` tma_operand)."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(n == 1 or (0 < s and s % 8 == 0 and s < 1 << 39)
                    for n, s in zip(t.shape[:3], t.stride()[:3])))


def fused_attention_bwd(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3's one-pass backward: (dq, dk, dv), each in its operand's dtype,
    from the forward's ``lse`` and ``dsum`` (:func:`attention_dsum`). On the
    card one launch of ``attention_bwd_kernel_sm90`` (bf16 operands TMA can
    describe, a shape :func:`onepass_cluster` takes; anything else raises),
    on the CPU :func:`fused_attention_bwd_reference`."""
    return _bwd_onepass(q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)


def _bwd_onepass(q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale, drop_rank=-1):
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                             sm_scale)
    if not onepass_cluster(nq, nk, kernel_head_dim(d)):
        raise ValueError(f"the one-pass backward does not take {(b, h, nq, nk, d)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the one-pass backward takes bf16, not {q.dtype}")
    build.tally_flops("fused_attention_bwd", attention_bwd_flops(b, h, nq, nk, d))

    def run(q, k, v, dout):
        masks = _cuda_operands(q, k, v, q_mask, kv_mask, "fused_attention_bwd")
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        outs = (_like_heads(q), _like_heads(k), _like_heads(v))
        if nq == 0 or b * h == 0:
            return outs[0], outs[1].zero_(), outs[2].zero_()
        if not all(_tma_ok(t) for t in (q, k, v, dout)):
            raise ValueError("the one-pass backward needs operands TMA can describe")
        _launch_onepass(outs, q, k, v, dout, lse.contiguous(), dsum.contiguous(), *masks,
                        sm_scale, drop_rank)
        build.count(fused_attention_bwd, launches=1, sm90_launches=1)
        return outs

    return at_kernel_head_dim(run, (q, k, v, dout))


def _launch_onepass(outs, q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale, drop_rank=-1):
    """One launch of attention_bwd_kernel_sm90 on CUDA tensors the
    wrapper checked, writing ``outs`` (dq, dk, dv); ``q_mask``/``kv_mask``
    contiguous or None."""
    b, h, nq, d = q.shape
    lib = build.library("fused_attention_bwd")
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_fused_attention_bwd(
            1, _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum), *map(_ptr, outs),
            _ptr(q_mask), _ptr(kv_mask), _strides(q, k, v, dout, *outs), b, h, nq, k.shape[2],
            d, float(sm_scale), int(drop_rank), stream)
    build.check(lib, code, "fused_attention_bwd")


fused_attention_bwd.launches = 0
fused_attention_bwd.sm90_launches = 0  # all of them: the kernel is Hopper's alone


def fused_attention_grads(q, k, v, out, lse, dout, dlse, q_mask, kv_mask, sm_scale):
    """K1's backward as both autograd Functions run it: dsum (the lse's
    cotangent ``dlse``, or None, folded in) by :func:`attention_dsum`, then
    (dq, dk, dv) by the route :func:`grad_route` names, the one-pass kernel
    (:func:`fused_attention_bwd`) or K3a and K3b. On the card a one-pass
    shape keeps K3a/K3b where the operands are not bf16 or TMA cannot
    describe them; on the CPU the route's plain versions run."""
    dout = dout.to(q.dtype)
    # without an lse cotangent no row needs the lse: a dead row's O is 0
    dsum = attention_dsum(out, dout, lse if dlse is not None else None, dlse)
    args = (q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
    b, h, nq, d = q.shape
    onepass = grad_route(b, h, nq, k.shape[2], d) == "onepass" and (
        q.device.type == "cpu" or (q.dtype == torch.bfloat16 and (
            kernel_head_dim(d) != d or all(_tma_ok(t) for t in (q, k, v, dout)))))
    if onepass:
        return fused_attention_bwd(*args)
    return (fused_attention_dq(*args), *fused_attention_dkv(*args))


class FusedAttention(torch.autograd.Function):
    """Forward with the row logsumexp, backward by :func:`fused_attention_grads`:
    the one-pass kernel or K3a/K3b as :func:`grad_route` says (on the CPU,
    their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, sm_scale):
        out, lse = _lse_forward(q, k, v, q_mask, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, q_mask, kv_mask)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, q_mask, kv_mask = ctx.saved_tensors
        grads = fused_attention_grads(q, k, v, out, lse, dout, None, q_mask, kv_mask,
                                      ctx.sm_scale)
        return (*grads, None, None, None)


class FusedAttentionLse(torch.autograd.Function):
    """K1 with lse as a second differentiable output, backward as
    :class:`FusedAttention`'s (their plain versions on the CPU). The lse's
    cotangent needs no kernel of its own: d lse_i / d s_ij is the
    probability p_ij, so it enters the logits' cotangent p_ij (dP_ij -
    dsum_i + dlse_i) as a shift of dsum, and the backward runs with dsum -
    dlse (0 on rows with no valid key), which the dsum pass writes."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, sm_scale):
        out, lse = _lse_forward(q, k, v, q_mask, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, q_mask, kv_mask)
        ctx.sm_scale = sm_scale
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, q_mask, kv_mask = ctx.saved_tensors
        grads = fused_attention_grads(q, k, v, out, lse, dout, dlse, q_mask, kv_mask,
                                      ctx.sm_scale)
        return (*grads, None, None, None)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Fused attention; returns (B, H, Nq, D) in q's dtype, differentiable.

    CUDA tensors: q/k/v may be strided views (any batch/head/token strides)
    as long as the head dim is contiguous; the result is a (B, H, Nq, D)
    view of a (B, Nq, H, D) buffer, so folding heads back into channels
    (``out.transpose(1, 2).reshape(B, Nq, H * D)``) copies nothing (at a
    zero-padded head dim it is a slice of one, and the fold copies)."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, q_mask, kv_mask, sm_scale)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, q_mask, kv_mask, sm_scale)
    build.tally_flops("fused_attention", attention_flops(*q.shape[:3], k.shape[2], q.shape[3]))
    return at_kernel_head_dim(
        lambda q, k, v: _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse=False)[0],
        (q, k, v))


fused_attention.launches = 0
# of them, launches of a Hopper kernel: attention_kernel_sm90, the packed
# kernel, or past head dim 128 K2's Hopper walk
fused_attention.sm90_launches = 0
fused_attention.packed_launches = 0  # of them, attention_packed_kernel_sm90's
fused_attention.row_launches = 0  # of them, K2's Hopper walk's (past head dim 128)
