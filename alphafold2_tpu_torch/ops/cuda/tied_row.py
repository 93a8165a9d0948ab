"""K2: tied-row MSA attention, with its training forward and its backward —
CUDA kernel wrappers, plain versions, and the autograd ``Function`` joining
them.

Port of ``alphafold2_tpu/ops/pallas/tied_row.py`` ``tied_row_attention``.
One attention matrix per (batch, head) is shared by all R MSA rows:

    logits[b, h, i, j] = sm_scale * tie_scale[b] * sum_r q[b, r, i, h] . k[b, r, j, h]
    out[b, r, i, h]    = sum_j softmax_j(logits) v[b, r, j, h]

The forward kernel is ``csrc/tied_row_attention.cu`` (K2; with the row
logsumexp, ``af2_tied_row_attention_lse``): in bf16 at head dim 32, 64 or
128 with R*D up to 512 (at head dim 64) the Hopper kernel of
``csrc/tied_row_attention_sm90.cuh``, which computes the shared logits once
per 64-key tile over the whole R*D axis for each group of 64 or 128 output
columns (:func:`hopper_plan`; :func:`hopper_walk_reference` is the plain
version of that walk). The backward kernels are
``csrc/tied_row_attention_bwd.cu``: what the TPU path runs under
``jax.grad`` as K3a/K3b (``_run_dq``/``_run_dkv``) at head dim R*D. In bf16
at head dim 32, 64 or 128 with R*D up to 448 (at head dim 64) those are the
Hopper kernels of ``csrc/tied_row_attention_bwd_sm90.cuh``, which compute S
and dO'V'^T once per 64-row tile pair over the whole R*D axis for each
group of 64 or 128 output columns (:func:`hopper_bwd_plan`;
:func:`hopper_bwd_walk_reference` is the plain version of that walk). Every wider bf16 problem at those head dims takes
the wide route of ``csrc/tied_row_wide_sm90.cuh``: the logits once over
R*D in feature splits into an f32 workspace, the splits summed in a fixed
order with the softmax (forward) or into p and ds (backward), then the
products by column group (:func:`wide_plan`, :func:`wide_bwd_plan`;
:func:`wide_walk_reference` and :func:`wide_bwd_walk_reference` are the
plain versions of those walks). All read the (B, R, N, H, D) layout in
place (no fold copy, unlike the TPU path). Plain PyTorch versions:
:func:`tied_row_attention_reference`, :func:`tied_row_attention_lse_reference`,
:func:`tied_row_attention_dq_reference` and
:func:`tied_row_attention_dkv_reference`; the wrappers run them only for
CPU tensors.

:func:`tied_row_attention` is differentiable: with grad enabled and an
input that requires it, it runs :class:`TiedRowAttention` (K2 with lse,
then the backward's dq, dk and dv in one call,
:func:`tied_row_attention_grads`; on the CPU the plain versions of the same
math). The tie scale is data (it counts the voting rows) and carries no
gradient; it scales the f32 logits, so dq and dk both carry it.

K2's split route (``csrc/tied_row_split.cuh``, :func:`tied_split_logits`,
:func:`tied_split_softmax`, :func:`tied_split_grad`,
:func:`tied_split_product` and their plain versions) runs the same
attention as passes on caller-owned planes, for MSA rows sharded over a
mesh (``parallel/seq_parallel.py`` ``TiedRowsSharded`` all-reduces the
logits, and in the backward dP and dsum, between them): the softmax and
grad passes on the wide route's kernels in any dtype; the logits and
products on the wide route's kernels in bf16 at head dim 32, 64 or 128,
on CUDA-core kernels of their own at any other dtype or head dim.

Callers pre-zero padded (row, position) entries of q/k/v (abstention), pass
the SHARED query/column masks (B, N) and the voting-row ``tie_scale``
(ops/attention.py). Masking follows ``axial.fused_attention``: masked keys
excluded, masked queries and key-less rows give 0; in the backward they get
dq = 0 and add nothing to dk/dv, and masked keys get dk = dv = 0.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from alphafold2_tpu_torch.ops.cuda import build
from alphafold2_tpu_torch.ops.cuda.axial import (
    _DTYPES,
    _masked_softmax_weights,
    _ptr,
    launch_tied_backward,
    recomputed_probabilities,
)


# The Hopper K2's plan (csrc/tied_row_attention_sm90.cuh plan_shape and
# plan_tied), mirrored: 64-query blocks of one consumer warpgroup and one
# producer warp, a ring of one or two 64-key stages, C = 64 or 128 output
# columns a block.
HOPPER_HEAD_DIMS = (32, 64, 128)
HOPPER_KERNEL = "tied_row_attention_kernel_sm90"
TILE = 64  # query rows a block, keys a stage
MAX_STAGES = 2
THREADS = 160
SMS = 132  # the H100 SXM's: a wave
SMEM_LIMIT = 232_448  # dynamic shared memory a block may take
SMEM_PER_SM = 233_472  # an SM's shared memory, 1 KB of it reserved a block
CONTROL_BYTES = 64  # the ring's barriers, mask words and tile starts
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def hopper_smem_bytes(features: int, columns: int, stages: int = MAX_STAGES) -> int:
    """A block's dynamic shared memory: the resident q tile and ``stages``
    stages of K (64 x R*D) and V (64 x C), bf16, after up to 1 KB of
    alignment."""
    return 1024 + 2 * TILE * (features + stages * (features + columns)) + CONTROL_BYTES


def hopper_plan(b: int, r: int, h: int, nq: int, d: int) -> Optional[dict]:
    """The Hopper K2's launch at a bf16 shape with 16-byte aligned operands,
    or None where attention_kernel_mma keeps it (head dim outside
    HOPPER_HEAD_DIMS, or R*D too wide for the q tile and two stages). A
    pure function of the shape: C = 128 columns a block where the grid then
    fills a wave of SMS and shared memory allows, else 64; G =
    ceil(R*D / C) column groups share each 64-query tile. Two stages, or one
    where the grid outgrows what two-stage blocks hold in one wave and one
    stage lets more blocks share an SM."""
    if d not in HOPPER_HEAD_DIMS:
        return None
    f = r * d
    tiles = b * h * -(-nq // TILE)
    if hopper_smem_bytes(f, 128) <= SMEM_LIMIT and tiles * -(-f // 128) >= SMS:
        columns = 128
    elif hopper_smem_bytes(f, 64) <= SMEM_LIMIT:
        columns = 64
    else:
        return None
    groups = -(-f // columns)
    two, one = (SMEM_PER_SM // (hopper_smem_bytes(f, columns, s) + 1024) for s in (2, 1))
    stages = 1 if tiles * groups > SMS * two and one > two else 2
    return {"kernel": f"{HOPPER_KERNEL}<{d},{columns}>", "columns": columns,
            "groups": groups, "stages": stages, "blocks": tiles * groups, "threads": THREADS,
            "dynamic_smem": hopper_smem_bytes(f, columns, stages)}


# The Hopper K2 backward's plan (csrc/tied_row_attention_bwd_sm90.cuh
# plan_shape and plan_tied_grad), mirrored: 64-row blocks of one consumer
# warpgroup and one producer warp, a resident tile pair and a ring of one or
# two streamed pairs, C = 64 or 128 output columns a block (dq), 64 (dk/dv).
HOPPER_BWD_KERNELS = {"dq": "tied_dq_kernel_sm90", "dkv": "tied_dkv_kernel_sm90"}
BWD_MAX_STAGES = 2
BWD_CONTROL_BYTES = 1152  # the ring's control block, rounded up


def hopper_bwd_smem_bytes(features: int, stages: int) -> int:
    """A backward block's dynamic shared memory: the resident tile pair and
    ``stages`` streamed pairs, each tile 64 rows x R*D bf16, after up to 1
    KB of alignment, then the control block."""
    return 1024 + 4 * TILE * features * (1 + stages) + BWD_CONTROL_BYTES


def hopper_bwd_plan(which: str, b: int, h: int, nq: int, nk: int, features: int,
                    row_width: int) -> Optional[dict]:
    """The Hopper K2 backward's launch for ``which`` ("dq" or "dkv") at a
    bf16 shape whose operands TMA can describe, or None where the chunked
    kernels keep it (row width outside HOPPER_HEAD_DIMS, a fused axis that
    is not whole rows, or one too wide for the resident tile pair and one
    streamed pair: R*D above 448 at row width 64). A pure function of the
    shape: as many stages as shared memory holds, up to BWD_MAX_STAGES;
    dk/dv C = 64 (four accumulators); dq C = 128 where the grid then fills a
    wave of SMS, else 64; G = ceil(R*D / C) column groups share each 64-row
    tile."""
    if which not in HOPPER_BWD_KERNELS:
        raise ValueError(f"which must be 'dq' or 'dkv', not {which!r}")
    if row_width not in HOPPER_HEAD_DIMS or features < row_width or features % row_width:
        return None
    stages = next((s for s in range(BWD_MAX_STAGES, 0, -1)
                   if hopper_bwd_smem_bytes(features, s) <= SMEM_LIMIT), 0)
    if stages == 0:
        return None
    tiles = b * h * -(-(nq if which == "dq" else nk) // TILE)
    wide = which == "dq" and features >= 128 and tiles * -(-features // 128) >= SMS
    columns = 128 if wide else 64
    groups = -(-features // columns)
    return {"kernel": f"{HOPPER_BWD_KERNELS[which]}<{row_width},{columns}>",
            "columns": columns, "groups": groups, "stages": stages,
            "blocks": tiles * groups, "threads": THREADS,
            "dynamic_smem": hopper_bwd_smem_bytes(features, stages)}


# The wide route's plan (csrc/tied_row_wide_sm90.cuh plan_wide, plan_pass
# and workspace_bytes), mirrored: the logits over R*D in feature splits of
# WIDE_STAGE_FEATURES-feature stages (a ring of WIDE_LOGIT_STAGES), the
# split count that fills the logits grid's waves best; the reduction; the
# products at C = 64 or 128 columns a block (a ring of WIDE_PRODUCT_STAGES).
WIDE_KERNELS = {"logits": "tied_wide_logits_kernel", "softmax": "tied_wide_softmax_kernel",
                "grad": "tied_wide_grad_kernel", "product": "tied_wide_product_kernel"}
WIDE_STAGE_FEATURES = 128
WIDE_LOGIT_STAGES = 3
WIDE_PRODUCT_STAGES = 4
WIDE_MAX_SPLITS = 8
WIDE_WORKSPACE_BUDGET = 64 << 20  # bytes of f32 partials with more than one split
WIDE_REDUCE_THREADS = 256
WIDE_CONTROL_BYTES = 128


def wide_logits_smem(ops: int) -> int:
    """A logits block's dynamic shared memory: WIDE_LOGIT_STAGES stages of
    ``ops`` operands (2 forward, 4 backward), each 64 tokens x
    WIDE_STAGE_FEATURES bf16, after up to 1 KB of alignment."""
    return 1024 + WIDE_LOGIT_STAGES * ops * TILE * WIDE_STAGE_FEATURES * 2 + WIDE_CONTROL_BYTES


def wide_product_smem(columns: int) -> int:
    """A product block's dynamic shared memory: WIDE_PRODUCT_STAGES stages
    of 64 tokens x ``columns`` bf16, after up to 1 KB of alignment."""
    return 1024 + WIDE_PRODUCT_STAGES * TILE * columns * 2 + WIDE_CONTROL_BYTES


def _round64(n: int) -> int:
    return -(-n // TILE) * TILE


def _wide_columns(b: int, h: int, m: int, features: int) -> int:
    """A product's columns a block: 128 where the grid then fills a wave of
    SMS, else 64."""
    return 128 if features >= 128 and b * h * -(-m // TILE) * -(-features // 128) >= SMS else 64


def _product_pass(b, h, m, features, row_width) -> dict:
    columns = _wide_columns(b, h, m, features)
    return {"kernel": f"{WIDE_KERNELS['product']}<{row_width},{columns}>", "columns": columns,
            "blocks": b * h * -(-m // TILE) * -(-features // columns), "threads": THREADS,
            "dynamic_smem": wide_product_smem(columns)}


@functools.lru_cache(maxsize=None)
def _wide(bwd: bool, b: int, h: int, nq: int, nk: int, features: int,
          row_width: int) -> Optional[dict]:
    """The wide route's plan (see :func:`wide_plan`), cached: a wrapper
    asks for it on every call, and callers only read it."""
    if (row_width not in HOPPER_HEAD_DIMS or features < row_width or features % row_width
            or nq < 1 or nk < 1):
        return None
    rows, per_stage = features // row_width, WIDE_STAGE_FEATURES // row_width
    if rows < per_stage:
        return None
    stages = -(-rows // per_stage)
    ops = 4 if bwd else 2
    tiles = b * h * -(-nq // TILE) * -(-nk // TILE)
    wave = SMS * (SMEM_PER_SM // (wide_logits_smem(ops) + 1024))
    plane = b * h * _round64(nq) * _round64(nk)
    best = None
    for s in range(1, min(WIDE_MAX_SPLITS, stages) + 1):
        if s > 1 and s * 4 * (ops // 2) * plane > WIDE_WORKSPACE_BUDGET:
            break
        per = -(-stages // s)
        splits = -(-stages // per)
        cost = -(-tiles * splits // wave) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    align = lambda n: -(-n // 256) * 256
    logits = {"kernel": f"{WIDE_KERNELS['logits']}<{row_width},{ops}>",
              "blocks": tiles * splits, "threads": THREADS,
              "dynamic_smem": wide_logits_smem(ops)}
    if bwd:
        reduce = {"kernel": f"{WIDE_KERNELS['grad']}<__nv_bfloat16>",
                  "blocks": b * h * (_round64(nq) // TILE) * (_round64(nk) // TILE)}
        products = [_product_pass(b, h, nq, features, row_width),
                    _product_pass(b, h, nk, features, row_width)]
    else:
        reduce = {"kernel": f"{WIDE_KERNELS['softmax']}<__nv_bfloat16>",
                  "blocks": b * h * _round64(nq) // (WIDE_REDUCE_THREADS // 32)}
        products = [_product_pass(b, h, nq, features, row_width)]
    reduce.update(threads=WIDE_REDUCE_THREADS, dynamic_smem=0)
    return {**logits, "splits": splits, "stages_per_split": per, "stages": stages,
            "columns": products[0]["columns"], "passes": [logits, reduce, *products],
            "workspace": align(4 * plane * splits * (2 if bwd else 1))
            + (3 if bwd else 1) * align(2 * plane)}


def wide_plan(b: int, r: int, h: int, nq: int, nk: int, d: int) -> Optional[dict]:
    """K2's wide route at a bf16 shape with 16-byte aligned operands, or
    None where another kernel takes it (head dim outside HOPPER_HEAD_DIMS,
    or a shape :func:`hopper_plan` takes). A pure function of the shape:
    ``splits`` feature splits of ``stages_per_split`` stages each (the count
    that fills the logits grid's waves best, at most WIDE_MAX_SPLITS, the
    partials within WIDE_WORKSPACE_BUDGET; the fewest among equals);
    ``passes`` the launches in order (logits, softmax, P V' at ``columns``
    columns a block); ``workspace`` the bytes the wrapper allocates. The
    top-level kernel, blocks, threads and shared memory are the logits
    pass's, which the C plan names for the route."""
    if d not in HOPPER_HEAD_DIMS or hopper_plan(b, r, h, nq, d) is not None:
        return None
    return _wide(False, b, h, nq, nk, r * d, d)


def wide_bwd_plan(b: int, h: int, nq: int, nk: int, features: int,
                  row_width: int) -> Optional[dict]:
    """K2's backward's wide route at a bf16 shape whose operands TMA can
    describe, or None where another kernel takes it (row width outside
    HOPPER_HEAD_DIMS, a fused axis that is not whole rows, or a shape
    :func:`hopper_bwd_plan` takes). As :func:`wide_plan`, with ``passes``
    (logits with dP, p and ds, the dq product, a dk or dv product) and
    ``columns`` the dq product's."""
    if hopper_bwd_plan("dq", b, h, nq, nk, features, row_width) is not None:
        return None
    return _wide(True, b, h, nq, nk, features, row_width)


def _tie_vector(tie_scale, b: int, r: int, device) -> torch.Tensor:
    """tie_scale (None -> R**-0.5, a float, or anything of B elements) as a
    (B,) f32 tensor on ``device``."""
    if tie_scale is None:
        tie_scale = r**-0.5
    if isinstance(tie_scale, torch.Tensor):
        t = tie_scale.to(device=device, dtype=torch.float32).reshape(-1)
        if t.numel() == 1:
            t = t.expand(b)
        if t.numel() != b:
            raise ValueError(f"tie_scale has {t.numel()} entries for batch {b}")
        return t.contiguous()
    return torch.full((b,), float(tie_scale), dtype=torch.float32, device=device)


def tied_row_flops(b: int, r: int, h: int, nq: int, nk: int, d: int) -> float:
    """One K2 call's matmul flops: the logits over R·D and every row's
    P·V, 4·B·H·Nq·Nk·R·D, what ``FlopCounterMode`` counts of the plain
    version (added to an open ``build.flop_tally`` where the kernel
    launches)."""
    return 4.0 * b * h * nq * nk * r * d


def _scale(q, sm_scale, tie_scale) -> torch.Tensor:
    """The (B,) f32 logit scale sm_scale * tie_scale."""
    b, r = q.shape[:2]
    return sm_scale * _tie_vector(tie_scale, b, r, q.device)


def _logits(q, k, scale):
    """The shared scaled logits (B, H, Nq, Nk), f32."""
    s = torch.einsum("brihd,brjhd->bhij", q.float(), k.float())
    return s * scale[:, None, None, None]


def _attend(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse):
    s = _logits(q, k, _scale(q, sm_scale, tie_scale))
    valid = kv_mask[:, None, None, :] if kv_mask is not None else None
    p, l = _masked_softmax_weights(s, valid)
    out = torch.einsum("bhij,brjhd->brihd", p / l, v.float())
    if q_mask is not None:
        out = out * q_mask[:, None, :, None, None].to(out.dtype)
    if not with_lse:
        return out.to(q.dtype)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return out.to(q.dtype), lse.masked_fill(lse == float("-inf"), float("inf"))


def tied_row_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
    tie_scale: Union[None, float, torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (f32 arithmetic)."""
    build.count(tied_row_attention_reference, calls=1)
    return _attend(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse=False)


tied_row_attention_reference.calls = 0


def tied_row_attention_lse_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0,
                                     tie_scale=None):
    """The plain version of the training forward: (out, lse), lse the
    (B, H, Nq) f32 logsumexp of each row's shared scaled logits over its
    valid keys, +inf for a row with none."""
    build.count(tied_row_attention_lse_reference, calls=1)
    return _attend(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse=True)


tied_row_attention_lse_reference.calls = 0


def hopper_walk_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0, tie_scale=None,
                          columns=128):
    """The plain version of the Hopper K2's decomposition: for each group of
    ``columns`` output columns of the fused (r, d) axis (a block's), the
    shared logits S of each 64-key tile computed once over the whole R*D
    axis and scaled in f32 by sm_scale * tie[b] * log2 e; the online
    softmax in log2 units, tile by tile in key order, each row with its f32
    max, sum and accumulator; p rounded to q's dtype once per tile before
    P V' (the sum keeps it in f32); a tile with no valid key of the batch
    row skipped, as the producer never stages it. Returns (out, lse) as
    :func:`tied_row_attention_lse`: masked queries and rows with no valid
    key give 0, and such rows lse +inf."""
    b, r, nq, h, d = q.shape
    nk, f = k.shape[2], r * d
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    scale2 = _scale(q, sm_scale, tie_scale) * LOG2E
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=q.device))
    out = torch.zeros((b, h, nq, f), device=q.device)
    lse = torch.full((b, h, nq), float("inf"), device=q.device)
    for bi in range(b):
        for c0 in range(0, f, columns):
            cols = slice(c0, min(c0 + columns, f))
            m = torch.full((h, nq, 1), float("-inf"), device=q.device)
            l = torch.zeros((h, nq, 1), device=q.device)
            acc = torch.zeros((h, nq, cols.stop - c0), device=q.device)
            for k0 in range(0, nk, TILE):
                tile = slice(k0, min(k0 + TILE, nk))
                valid = keys[bi, tile]
                if not valid.any():
                    continue
                x = qf[bi] @ kf[bi, :, tile].transpose(-1, -2) * scale2[bi]
                m_new = torch.maximum(m, x.masked_fill(~valid, float("-inf")).amax(
                    -1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.where(valid, torch.exp2(x - m_new), 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(q.dtype).float() @ vf[bi, :, tile, cols]
                m = m_new
            out[bi, :, :, cols] = acc / l.clamp_min(1e-30)
            if c0 == 0:
                lse[bi] = torch.where(torch.isneginf(m), float("inf"),
                                      m * LN2 + torch.log(l))[..., 0]
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    return _unfold(out, r, q.dtype), lse


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(B, R, N, H, D) -> (B, H, N, R*D), f32."""
    b, r, n, h, d = t.shape
    return t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d).float()


def _unfold(t: torch.Tensor, r: int, dtype) -> torch.Tensor:
    """(B, H, N, R*D) -> (B, R, N, H, D) in ``dtype``."""
    b, h, n, f = t.shape
    return t.reshape(b, h, n, r, f // r).permute(0, 3, 2, 1, 4).to(dtype)


def _split_sums(pairs, features: int, row_width: int, splits: int):
    """The logits pass's partial products summed in split order: for each
    (A, B) of ``pairs`` ((B, H, M, F) f32), the sum over the feature splits
    of A[..., split] B[..., split]^T, each split ``per`` stages of
    WIDE_STAGE_FEATURES features (whole rows), as the kernel cuts them."""
    rows, per_stage = features // row_width, WIDE_STAGE_FEATURES // row_width
    stages = -(-rows // per_stage)
    per = -(-stages // splits)
    out = [None] * len(pairs)
    for lo in range(0, stages * WIDE_STAGE_FEATURES, per * WIDE_STAGE_FEATURES):
        cut = slice(lo, min(lo + per * WIDE_STAGE_FEATURES, features))
        for i, (x, y) in enumerate(pairs):
            part = x[..., cut] @ y[..., cut].transpose(-1, -2)
            out[i] = part if out[i] is None else out[i] + part
    return out


def wide_walk_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0, tie_scale=None,
                        splits=None, columns=128):
    """The plain version of the wide K2's decomposition: the shared logits
    as ``splits`` partial products over feature splits of whole rows (the
    plan's count by default), summed in split order and scaled in f32 by
    sm_scale * tie[b] * log2 e; each row's max and sum over its valid keys,
    lse2 = max + log2(sum); P = 2^(x - lse2) rounded to q's dtype (0 for a
    masked key, a masked query and a row with no valid key); then out =
    P V' for each group of ``columns`` output columns, summed in f32.
    Returns (out, lse) as :func:`tied_row_attention_lse`. Only the tests
    call it."""
    b, r, nq, h, d = q.shape
    nk, f = k.shape[2], r * d
    if splits is None:
        plan = _wide(False, b, h, nq, nk, f, d)
        splits = plan["splits"] if plan is not None else 1
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    (s,) = _split_sums([(qf, kf)], f, d, splits)
    x = s * (_scale(q, sm_scale, tie_scale) * LOG2E)[:, None, None, None]
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=q.device))[:, None, None, :]
    m = x.masked_fill(~keys, float("-inf")).amax(-1, keepdim=True)
    keyed = torch.isfinite(m)
    l = torch.where(keys & keyed, torch.exp2(x - m), 0.0).sum(-1, keepdim=True)
    lse2 = torch.where(keyed, m + torch.log2(l.clamp_min(1e-30)), float("inf"))
    live = keys & keyed
    if q_mask is not None:
        live = live & q_mask[:, None, :, None]
    p = torch.where(live, torch.exp2(x - lse2), 0.0).to(q.dtype).float()
    out = torch.zeros((b, h, nq, f), device=q.device)
    for c0 in range(0, f, columns):
        out[..., c0:c0 + columns] = p @ vf[..., c0:c0 + columns]
    return _unfold(out, r, q.dtype), (lse2 * LN2)[..., 0]


def wide_bwd_walk_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0,
                            tie_scale=None, splits=None, columns=64):
    """The plain version of the wide K2 backward's decomposition, (dq, dk,
    dv): S and dO'V'^T as ``splits`` partial products over feature splits of
    whole rows (the plan's count by default), each summed in split order; p
    = 2^(S * s * log2 e - lse * log2 e) with s = sm_scale * tie[b] in f32
    (0 for a masked key and a dead query row), ds = p * (dP - dsum), both
    rounded to q's dtype; then by groups of ``columns`` output columns dq =
    ds K', dk = ds^T Q' (both times s) and dv = p^T dO', summed in f32.
    Only the tests call it."""
    b, r, nq, h, d = q.shape
    nk, f = k.shape[2], r * d
    if splits is None:
        plan = _wide(True, b, h, nq, nk, f, d)
        splits = plan["splits"] if plan is not None else 1
    qf, kf, vf, dof = _fold(q), _fold(k), _fold(v), _fold(dout)
    s, dp = _split_sums([(qf, kf), (dof, vf)], f, d, splits)
    scale = _scale(q, sm_scale, tie_scale)
    live = torch.isfinite(lse)
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=q.device))
    ok = live[..., None] & keys[:, None, None, :]
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E)[:, None, None, None]
                                   - torch.where(live, lse, 0.0)[..., None] * LOG2E), 0.0)
    ds = p * (dp - torch.where(live, dsum, 0.0)[..., None])
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.zeros((b, h, nq, f), device=q.device)
    dk, dv = (torch.zeros((b, h, nk, f), device=q.device) for _ in range(2))
    for c0 in range(0, f, columns):
        cols = slice(c0, c0 + columns)
        dq[..., cols] = ds @ kf[..., cols]
        dk[..., cols] = ds.transpose(-1, -2) @ qf[..., cols]
        dv[..., cols] = p.transpose(-1, -2) @ dof[..., cols]
    s4 = scale[:, None, None, None]
    return _unfold(dq * s4, r, q.dtype), _unfold(dk * s4, r, k.dtype), _unfold(dv, r, v.dtype)


def _p_ds(q, k, v, dout, lse, dsum, q_mask, kv_mask, scale):
    """Recomputed probabilities and ds = p * (dO'.V' - dsum), ds rounded to
    the operand dtype as the kernels round it."""
    p = recomputed_probabilities(_logits(q, k, scale), lse, q_mask, kv_mask)
    dp = torch.einsum("brihd,brjhd->bhij", dout.float(), v.float())
    return p, (p * (dp - dsum[..., None])).to(q.dtype).float()


def tied_row_attention_dq_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                    sm_scale=1.0, tie_scale=None):
    """The plain version of the dq kernel: dq = s * ds K' with s =
    sm_scale * tie_scale[b] (f32 arithmetic, ds rounded to the operand
    dtype first)."""
    build.count(tied_row_attention_dq_reference, calls=1)
    scale = _scale(q, sm_scale, tie_scale)
    _, ds = _p_ds(q, k, v, dout, lse, dsum, q_mask, kv_mask, scale)
    dq = torch.einsum("bhij,brjhd->brihd", ds, k.float())
    return (dq * scale[:, None, None, None, None]).to(q.dtype)


tied_row_attention_dq_reference.calls = 0


def tied_row_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                     sm_scale=1.0, tie_scale=None):
    """The plain version of the dk/dv kernel: (dk, dv) = (s * ds^T Q',
    p^T dO'), p and ds rounded to the operand dtype first."""
    build.count(tied_row_attention_dkv_reference, calls=1)
    scale = _scale(q, sm_scale, tie_scale)
    p, ds = _p_ds(q, k, v, dout, lse, dsum, q_mask, kv_mask, scale)
    dv = torch.einsum("bhij,brihd->brjhd", p.to(q.dtype).float(), dout.float())
    dk = torch.einsum("bhij,brihd->brjhd", ds, q.float()) * scale[:, None, None, None, None]
    return dk.to(k.dtype), dv.to(v.dtype)


tied_row_attention_dkv_reference.calls = 0


def hopper_bwd_walk_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                              sm_scale=1.0, tie_scale=None, columns=64):
    """The plain version of the Hopper K2 backward's decomposition, (dq,
    dk, dv): for each group of ``columns`` output columns of the fused
    (r, d) axis (a block's), tile by tile in order along the streamed axis,
    S and dO'V'^T of each 64 x 64 tile pair computed once over the whole
    R*D axis; p = 2^(S * s * log2 e - lse * log2 e) with s = sm_scale *
    tie[b] in f32 (0 for a masked key and a dead query row); ds = p * (dP -
    dsum); p and ds rounded to q's dtype before their products, which add
    into f32 sums. dq (a 64-query block with a live row): the key tiles with
    a valid key, dq[:, cols] += ds K[:, cols]. dk, dv (a 64-key block with a
    valid key): the query tiles with a live query, dv[:, cols] += p^T
    dO[:, cols] and dk[:, cols] += ds^T Q[:, cols]. dq and dk times s at
    the end; a block with nothing live stays 0. Only the tests call it."""
    b, r, nq, h, d = q.shape
    nk, f = k.shape[2], r * d
    qf, kf, vf, dof = _fold(q), _fold(k), _fold(v), _fold(dout)
    scale = _scale(q, sm_scale, tie_scale)
    live = torch.isfinite(lse)
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    lse2 = torch.where(live, lse * LOG2E, float("inf"))
    dsum = torch.where(live, dsum, 0.0)
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=q.device))
    rnd = lambda x: x.to(q.dtype).float()
    dq = torch.zeros((b, h, nq, f), device=q.device)
    dk, dv = (torch.zeros((b, h, nk, f), device=q.device) for _ in range(2))

    def tile_pair(bi, qt, kt):
        """p and ds (H, |qt|, |kt|) of one query tile and one key tile."""
        s2 = qf[bi, :, qt] @ kf[bi, :, kt].transpose(-1, -2) * (scale[bi] * LOG2E)
        p = torch.exp2(s2 - lse2[bi, :, qt, None])
        p = torch.where(keys[bi, None, None, kt] & live[bi, :, qt, None], p, 0.0)
        dp = dof[bi, :, qt] @ vf[bi, :, kt].transpose(-1, -2)
        return p, p * (dp - dsum[bi, :, qt, None])

    for bi in range(b):
        for c0 in range(0, f, columns):
            cols = slice(c0, min(c0 + columns, f))
            for q0 in range(0, nq, TILE):  # dq: a 64-query block
                qt = slice(q0, min(q0 + TILE, nq))
                if not live[bi, :, qt].any():
                    continue  # every row dead: zeros, no key read
                for k0 in range(0, nk, TILE):
                    kt = slice(k0, min(k0 + TILE, nk))
                    if keys[bi, kt].any():
                        _, ds = tile_pair(bi, qt, kt)
                        dq[bi, :, qt, cols] += rnd(ds) @ kf[bi, :, kt, cols]
            for k0 in range(0, nk, TILE):  # dk, dv: a 64-key block
                kt = slice(k0, min(k0 + TILE, nk))
                if not keys[bi, kt].any():
                    continue  # every key masked: zeros, no query read
                for q0 in range(0, nq, TILE):
                    qt = slice(q0, min(q0 + TILE, nq))
                    if live[bi, :, qt].any():
                        p, ds = tile_pair(bi, qt, kt)
                        dv[bi, :, kt, cols] += rnd(p).transpose(-1, -2) @ dof[bi, :, qt, cols]
                        dk[bi, :, kt, cols] += rnd(ds).transpose(-1, -2) @ qf[bi, :, qt, cols]

    s5 = scale[:, None, None, None]
    return _unfold(dq * s5, r, q.dtype), _unfold(dk * s5, r, k.dtype), _unfold(dv, r, v.dtype)


def tied_row_dsum(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dsum[b, h, i] = sum over the whole fused (r, d) axis of out * dO, in
    f32, (B, H, Nq): not per row, since the rows share one softmax."""
    return torch.einsum("brihd,brihd->bhi", out.float(), dout.float())


def _check(q, k, v, q_mask, kv_mask):
    if q.dim() != 5 or k.dim() != 5 or k.shape != v.shape:
        raise ValueError("q, k, v must be (B, R, N, H, D), k and v alike")
    b, r, nq, h, d = q.shape
    nk = k.shape[2]
    if k.shape[:2] != (b, r) or k.shape[3:] != (h, d):
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}")
    for name, m, n in (("q_mask", q_mask, nq), ("kv_mask", kv_mask, nk)):
        if m is not None and (m.dtype != torch.bool or tuple(m.shape) != (b, n)):
            raise ValueError(f"{name} must be bool ({b}, {n})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tied_row_attention runs on cuda or cpu, not {q.device}")


def _cuda_operands(q, k, v, q_mask, kv_mask, tie_scale, what):
    """Checks the CUDA routes share; returns (tie (B,) f32, contiguous
    masks)."""
    if any(t.device != q.device for t in (k, v) + tuple(
            m for m in (q_mask, kv_mask) if m is not None)):
        raise ValueError(f"{what} operands must share one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{what} needs contiguous (B, R, N, H, D) operands")
    if k.shape[2] == 0:
        raise ValueError(f"{what} needs at least one key")
    tie = _tie_vector(tie_scale, q.shape[0], q.shape[1], q.device)
    return tie, [m.contiguous() if m is not None else None for m in (q_mask, kv_mask)]


@functools.lru_cache(maxsize=None)
def _planned_kernel(lib, dtype: int, b: int, r: int, h: int, nq: int, nk: int, d: int,
                    aligned: int) -> str:
    """The instantiation K2's C plan names at a shape: what the launch takes."""
    plan = build.LaunchPlan()
    build.check(lib, lib.af2_tied_row_attention_plan(dtype, b, r, h, nq, nk, d, aligned,
                                                     ctypes.byref(plan)),
                "tied_row_attention plan")
    return plan.kernel.decode()


def _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse):
    """K2 on CUDA tensors: out, and the (B, H, Nq) f32 lse when asked."""
    tie, masks = _cuda_operands(q, k, v, q_mask, kv_mask, tie_scale, "tied_row_attention")
    b, r, nq, h, d = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib = build.library("tied_row_attention")
    # the wide route's workspace, where its plan takes the shape
    plan = wide_plan(b, r, h, nq, nk, d) if q.dtype == torch.bfloat16 else None
    work = (torch.empty(plan["workspace"], dtype=torch.uint8, device=q.device)
            if plan is not None else None)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        head = (_DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out))
        tail = (_ptr(masks[0]), _ptr(masks[1]), _ptr(tie), b, r, h, nq, nk, d,
                float(sm_scale), _ptr(work), work.numel() if work is not None else 0, stream)
        if with_lse:
            code = lib.af2_tied_row_attention_lse(*head, _ptr(lse), *tail)
        else:
            code = lib.af2_tied_row_attention(*head, *tail)
    build.check(lib, code, "tied_row_attention")
    aligned = int(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    kernel = _planned_kernel(lib, _DTYPES[q.dtype], b, r, h, nq, nk, d, aligned)
    wide = kernel.startswith(WIDE_KERNELS["logits"] + "<")
    build.count(tied_row_attention, launches=1,
                sm90_launches=int(wide or kernel.startswith(HOPPER_KERNEL + "<")),
                wide_launches=int(wide))
    return out, lse


def tied_row_attention_lse(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0,
                           tie_scale=None):
    """K2's training forward: (out, lse). Not differentiable itself:
    :class:`TiedRowAttention` wraps it."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type == "cpu":
        return tied_row_attention_lse_reference(q, k, v, q_mask, kv_mask, sm_scale, tie_scale)
    _tally(q, k)
    return _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse=True)


def _tally(q, k) -> None:
    b, r, nq, h, d = q.shape
    build.tally_flops("tied_row_attention", tied_row_flops(b, r, h, nq, k.shape[2], d))


def _launch_backward(which, outs, q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale,
                     tie_scale) -> tuple:
    """``which`` "dq", "dkv" or "grads" (dq, dk and dv in one call) into
    ``outs``; returns the C entry's info (launch_tied_backward)."""
    tie, masks = _cuda_operands(q, k, v, q_mask, kv_mask, tie_scale,
                                f"tied_row_attention_{which}")
    dout = dout.contiguous()
    b, r, nq, h, d = q.shape
    if b * r * nq * h * d == 0:
        for o in outs:
            o.zero_()
        return (0, 0, 0) if which == "grads" else (0, 0)
    slots = {"dq": (outs[0], k, v), "dkv": (q, *outs)}.get(which, outs)
    # (batch, head, token, row group) strides of (B, R, N, H, D) operands
    strides = [x for t in (q, k, v, dout, *slots)
               for x in (t.stride(0), t.stride(3), t.stride(2), t.stride(1))]
    return launch_tied_backward(which, outs, q, k, v, dout, lse.contiguous(),
                                dsum.contiguous(), masks, tie, strides,
                                (b, h, nq, k.shape[2], r * d, d), sm_scale)


def _check_grad_operands(q, dout, lse, dsum):
    b, r, nq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != (b, h, nq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be f32 ({b}, {h}, {nq}) on q's device")


def tied_row_attention_dq(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                          sm_scale=1.0, tie_scale=None):
    """K2's backward, dq (B, R, Nq, H, D) in q's dtype, from the forward's
    ``lse`` and ``dsum = tied_row_dsum(out, dout)``."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, dout, lse, dsum)
    if q.device.type == "cpu":
        return tied_row_attention_dq_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                               sm_scale, tie_scale)
    dq = torch.empty_like(q)
    hopper, wide = _launch_backward("dq", (dq,), q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                    sm_scale, tie_scale)
    build.count(tied_row_attention_dq, launches=1, sm90_launches=hopper, wide_launches=wide)
    return dq


tied_row_attention_dq.launches = 0
# of them, launches of tied_dq_kernel_sm90 or of the wide route
tied_row_attention_dq.sm90_launches = 0
tied_row_attention_dq.wide_launches = 0  # of them, the wide route's


def tied_row_attention_dkv(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                           sm_scale=1.0, tie_scale=None):
    """K2's backward, (dk, dv), each (B, R, Nk, H, D) in k's dtype."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, dout, lse, dsum)
    if q.device.type == "cpu":
        return tied_row_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                                sm_scale, tie_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    hopper, wide = _launch_backward("dkv", (dk, dv), q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                    sm_scale, tie_scale)
    build.count(tied_row_attention_dkv, launches=1, sm90_launches=hopper, wide_launches=wide)
    return dk, dv


tied_row_attention_dkv.launches = 0
# of them, launches of tied_dkv_kernel_sm90 or of the wide route
tied_row_attention_dkv.sm90_launches = 0
tied_row_attention_dkv.wide_launches = 0  # of them, the wide route's


def tied_row_attention_grads(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                             sm_scale=1.0, tie_scale=None):
    """K2's whole backward, (dq, dk, dv), as :func:`tied_row_attention_dq`
    and :func:`tied_row_attention_dkv` give them, in one C call: the wide
    route computes S, dP, p and ds once for the three products; every
    other route runs the two wrappers' launches in turn. Counts one launch
    on each of the two wrappers."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, dout, lse, dsum)
    if q.device.type == "cpu":
        args = (q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale, tie_scale)
        return (tied_row_attention_dq_reference(*args),
                *tied_row_attention_dkv_reference(*args))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hop_q, hop_kv, wide = _launch_backward("grads", (dq, dk, dv), q, k, v, dout, lse, dsum,
                                           q_mask, kv_mask, sm_scale, tie_scale)
    for fn, hopper in ((tied_row_attention_dq, hop_q), (tied_row_attention_dkv, hop_kv)):
        build.count(fn, launches=1, sm90_launches=hopper, wide_launches=wide)
    return dq, dk, dv


class TiedRowAttention(torch.autograd.Function):
    """K2 with the row logsumexp forward, K2's backward
    (:func:`tied_row_attention_grads`) backward (or, on the CPU, their
    plain versions). ``tie`` is a (B,) f32
    tensor that carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, sm_scale, tie):
        out, lse = tied_row_attention_lse(q, k, v, q_mask, kv_mask, sm_scale, tie)
        ctx.save_for_backward(q, k, v, out, lse, q_mask, kv_mask, tie)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, q_mask, kv_mask, tie = ctx.saved_tensors
        return (*tied_row_attention_grads(q, k, v, dout, lse, tied_row_dsum(out, dout), q_mask,
                                          kv_mask, ctx.sm_scale, tie), None, None, None, None)


def tied_row_attention(
    q: torch.Tensor,  # (B, R, Nq, H, D), padded entries pre-zeroed
    k: torch.Tensor,  # (B, R, Nk, H, D)
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,  # (B, Nq) shared query mask
    kv_mask: Optional[torch.Tensor] = None,  # (B, Nk) shared column mask
    sm_scale: float = 1.0,
    tie_scale: Union[None, float, torch.Tensor] = None,
) -> torch.Tensor:
    """Tied-row attention; returns (B, R, Nq, H, D) in q's dtype,
    differentiable in q, k and v. CUDA operands must be contiguous."""
    _check(q, k, v, q_mask, kv_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        tie = _tie_vector(tie_scale, q.shape[0], q.shape[1], q.device).detach()
        return TiedRowAttention.apply(q, k, v, q_mask, kv_mask, sm_scale, tie)
    if q.device.type == "cpu":
        return tied_row_attention_reference(q, k, v, q_mask, kv_mask, sm_scale, tie_scale)
    _tally(q, k)
    return _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, tie_scale, with_lse=False)[0]


tied_row_attention.launches = 0
# of them, launches of tied_row_attention_kernel_sm90 or of the wide route
tied_row_attention.sm90_launches = 0
tied_row_attention.wide_launches = 0  # of them, the wide route's


# ------------------------------------------------ the split route (a mesh)
#
# K2 on MSA rows sharded over a mesh axis (csrc/tied_row_split.cuh): the
# logits over a rank's rows, the softmax, the grad and the products as
# passes of their own, so that the caller (parallel/seq_parallel.py
# TiedRowsSharded) all-reduces the logits, dP and dsum over the row axis
# between them. On the card a plane is (B, H, Nq', Nk') f32 with the token
# counts rounded up to 64 (zero past them) and P, dS, dS^T and P^T are in the
# operand dtype at that padding; the plain versions, which the wrappers run
# for CPU tensors, give the same arrays unpadded.

def _row_strides(*tensors) -> list:
    """(batch, head, token, row group) element strides of (B, R, N, H, D)
    operands, in order."""
    return [x for t in tensors for x in (t.stride(0), t.stride(3), t.stride(2), t.stride(1))]


@functools.lru_cache(maxsize=None)
def split_plan(pass_: int, dtype: int, b: int, h: int, na: int, nb: int, features: int,
               row_width: int, hopper: bool) -> dict:
    """The C plan of one split pass (pass 0 the logits, 1 the splits' sum,
    2 the softmax, 3 the grad, 4 a product of ``na`` tokens over ``nb``):
    its instantiation, launch and, for the logits, feature splits and
    workspace bytes."""
    lib = build.library("tied_row_attention")
    plan, splits, work = build.LaunchPlan(), ctypes.c_int(0), ctypes.c_longlong(0)
    build.check(lib, lib.af2_tied_split_plan(pass_, dtype, b, h, na, nb, features, row_width,
                                             int(hopper), ctypes.byref(plan),
                                             ctypes.byref(splits), ctypes.byref(work)),
                "tied_split plan")
    return {"kernel": plan.kernel.decode(), "blocks": plan.blocks, "threads": plan.threads,
            "dynamic_smem": plan.dynamic_smem, "splits": splits.value,
            "work_bytes": work.value}


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def tied_split_logits_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the logits pass: (B, H, Na, Nb) f32, A B^T over
    the fused (r, d) axis of (B, R, Na, H, D) and (B, R, Nb, H, D)."""
    build.count(tied_split_logits_reference, calls=1)
    return torch.einsum("brihd,brjhd->bhij", a.float(), b.float())


tied_split_logits_reference.calls = 0


def tied_split_logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The split route's logits pass over this rank's rows: A B^T over the
    fused (r, d) axis, unscaled, f32 (B, H, Na', Nb') on the card (the
    token counts rounded up to 64, zero past them). The forward's S (a = q,
    b = k) and the backward's dP (a = dO, b = v)."""
    if a.device.type == "cpu":
        return tied_split_logits_reference(a, b)
    bs, r, na, h, d = a.shape
    nb = b.shape[2]
    dtype = _DTYPES[a.dtype]
    plane = torch.empty((bs, h, _padded(na), _padded(nb)), dtype=torch.float32, device=a.device)
    plan = split_plan(0, dtype, bs, h, na, nb, r * d, d, True)
    work = (torch.empty(plan["work_bytes"], dtype=torch.uint8, device=a.device)
            if plan["work_bytes"] else None)
    strides = (ctypes.c_longlong * 8)(*_row_strides(a, b))
    info = (ctypes.c_int * 2)()
    lib = build.library("tied_row_attention")
    with torch.cuda.device(a.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_tied_split_logits(
            dtype, _ptr(a), _ptr(b), _ptr(plane), strides, bs, h, na, nb, r * d, d, _ptr(work),
            work.numel() if work is not None else 0, info, stream)
    build.check(lib, code, "tied_split_logits")
    build.tally_flops("tied_split_logits", 2.0 * bs * h * na * nb * r * d)
    build.count(tied_split_logits, launches=1, sm90_launches=info[0])
    return plane


tied_split_logits.launches = 0
tied_split_logits.sm90_launches = 0  # of them, on the Hopper route


def _split_masks(*masks):
    return [m.contiguous() if m is not None else None for m in masks]


def tied_split_softmax_reference(s, nq, nk, q_mask=None, kv_mask=None, sm_scale=1.0,
                                 tie_scale=None, dtype=torch.float32):
    """The plain version of the softmax pass on the whole logits ``s``: P
    (B, H, Nq, Nk) in ``dtype`` (2^(x - lse2) with x = s * sm_scale *
    tie[b] * log2 e; 0 for a masked key, a masked query and a row with no
    valid key) and the lse (B, H, Nq) f32, +inf for a row with no valid
    key."""
    build.count(tied_split_softmax_reference, calls=1)
    b = s.shape[0]
    x = s[..., :nq, :nk].float() * (sm_scale * _tie_vector(tie_scale, b, 1, s.device)
                                    * LOG2E)[:, None, None, None]
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=s.device))[:, None, None, :]
    m = x.masked_fill(~keys, float("-inf")).amax(-1, keepdim=True)
    keyed = torch.isfinite(m)
    l = torch.where(keys & keyed, torch.exp2(x - torch.where(keyed, m, 0.0)), 0.0).sum(
        -1, keepdim=True)
    lse2 = torch.where(keyed, m + torch.log2(l.clamp_min(1e-30)), float("inf"))
    live = keys & keyed
    if q_mask is not None:
        live = live & q_mask[:, None, :, None]
    p = torch.where(live, torch.exp2(x - torch.where(keyed, lse2, 0.0)), 0.0).to(dtype)
    return p, (lse2 * LN2)[..., 0]


tied_split_softmax_reference.calls = 0


def tied_split_softmax(s, nq, nk, q_mask=None, kv_mask=None, sm_scale=1.0, tie_scale=None,
                       dtype=torch.float32):
    """The split route's softmax pass on the whole (all rows') logits ``s``
    (a :func:`tied_split_logits` plane after the all-reduce): (P, lse), P in
    ``dtype`` at the plane's padding on the card."""
    if s.device.type == "cpu":
        return tied_split_softmax_reference(s, nq, nk, q_mask, kv_mask, sm_scale, tie_scale,
                                            dtype)
    b, h = s.shape[:2]
    tie = _tie_vector(tie_scale, b, 1, s.device)
    qm, km = _split_masks(q_mask, kv_mask)
    prob = torch.empty(s.shape, dtype=dtype, device=s.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=s.device)
    lib = build.library("tied_row_attention")
    with torch.cuda.device(s.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_tied_split_softmax(_DTYPES[dtype], _ptr(s), _ptr(prob), _ptr(lse), _ptr(qm),
                                          _ptr(km), _ptr(tie), b, h, nq, nk, float(sm_scale),
                                          stream)
    build.check(lib, code, "tied_split_softmax")
    build.count(tied_split_softmax, launches=1)
    return prob, lse


tied_split_softmax.launches = 0


def tied_split_grad_reference(s, dp, lse, dsum, nq, nk, q_mask=None, kv_mask=None,
                              sm_scale=1.0, tie_scale=None, dtype=torch.float32):
    """The plain version of the grad pass, (dS, dS^T, P^T) in ``dtype``: p =
    2^(S * s * log2 e - lse * log2 e) with s = sm_scale * tie[b] (0 for a
    masked key and a dead query row), dS = p * (dP - dsum), from the whole
    logits, dP and dsum."""
    build.count(tied_split_grad_reference, calls=1)
    b = s.shape[0]
    scale = sm_scale * _tie_vector(tie_scale, b, 1, s.device)
    live = torch.isfinite(lse)
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    keys = (kv_mask if kv_mask is not None
            else torch.ones((b, nk), dtype=torch.bool, device=s.device))
    ok = live[..., None] & keys[:, None, None, :]
    x = s[..., :nq, :nk].float() * (scale * LOG2E)[:, None, None, None]
    p = torch.where(ok, torch.exp2(x - torch.where(live, lse, 0.0)[..., None] * LOG2E), 0.0)
    ds = p * (dp[..., :nq, :nk].float() - torch.where(live, dsum, 0.0)[..., None])
    p, ds = p.to(dtype), ds.to(dtype)
    return ds, ds.transpose(-1, -2), p.transpose(-1, -2)


tied_split_grad_reference.calls = 0


def tied_split_grad(s, dp, lse, dsum, nq, nk, q_mask=None, kv_mask=None, sm_scale=1.0,
                    tie_scale=None, dtype=torch.float32):
    """The split route's grad pass: (dS, dS^T, P^T) from the forward's whole
    logits ``s`` and ``lse`` and the whole (all-reduced) ``dp`` and
    ``dsum``; on the card at the planes' padding."""
    if s.device.type == "cpu":
        return tied_split_grad_reference(s, dp, lse, dsum, nq, nk, q_mask, kv_mask, sm_scale,
                                         tie_scale, dtype)
    b, h, nqp, nkp = s.shape
    tie = _tie_vector(tie_scale, b, 1, s.device)
    qm, km = _split_masks(q_mask, kv_mask)
    ds = torch.empty((b, h, nqp, nkp), dtype=dtype, device=s.device)
    ds_t, p_t = (torch.empty((b, h, nkp, nqp), dtype=dtype, device=s.device) for _ in range(2))
    lib = build.library("tied_row_attention")
    with torch.cuda.device(s.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_tied_split_grad(_DTYPES[dtype], _ptr(s), _ptr(dp.contiguous()),
                                       _ptr(lse.contiguous()), _ptr(dsum.contiguous()), _ptr(ds),
                                       _ptr(ds_t), _ptr(p_t), _ptr(qm), _ptr(km), _ptr(tie), b, h,
                                       nq, nk, float(sm_scale), stream)
    build.check(lib, code, "tied_split_grad")
    build.count(tied_split_grad, launches=1)
    return ds, ds_t, p_t


tied_split_grad.launches = 0


def tied_split_product_reference(a, x, m, scale=None):
    """The plain version of a product pass: (B, R, m, H, D) = A X over X's
    N tokens in f32, times sm_scale * tie[b] where ``scale`` is (sm_scale,
    tie), in X's dtype."""
    build.count(tied_split_product_reference, calls=1)
    n = x.shape[2]
    out = torch.einsum("bhij,brjhd->brihd", a[..., :m, :n].float(), x.float())
    if scale is not None:
        sm_scale, tie = scale
        out = out * (sm_scale * _tie_vector(tie, x.shape[0], 1, x.device))[:, None, None, None,
                                                                           None]
    return out.to(x.dtype)


tied_split_product_reference.calls = 0


def tied_split_product(a, x, m, scale=None):
    """The split route's product pass for this rank's rows: (B, R, m, H, D)
    = A X, A the softmax's P (out = P V'), dS (dq = s dS K'), dS^T (dk = s
    dS^T Q') or P^T (dv = P^T dO'); ``scale`` (sm_scale, tie) multiplies in
    s. X (B, R, N, H, D) is read through its strides."""
    if x.device.type == "cpu":
        return tied_split_product_reference(a, x, m, scale)
    b, r, n, h, d = x.shape
    out = torch.empty((b, r, m, h, d), dtype=x.dtype, device=x.device)
    sm_scale, tie = scale if scale is not None else (1.0, None)
    tie = _tie_vector(tie if tie is not None else 1.0, b, 1, x.device)
    strides = (ctypes.c_longlong * 8)(*_row_strides(x, out))
    info = (ctypes.c_int * 1)()
    lib = build.library("tied_row_attention")
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_tied_split_product(_DTYPES[x.dtype], _ptr(a.contiguous()), _ptr(x),
                                          _ptr(out), strides, _ptr(tie), b, h, m, n, r * d, d,
                                          float(sm_scale), int(scale is not None), info, stream)
    build.check(lib, code, "tied_split_product")
    build.tally_flops("tied_split_product", 2.0 * b * h * m * n * r * d)
    build.count(tied_split_product, launches=1, sm90_launches=info[0])
    return out


tied_split_product.launches = 0
tied_split_product.sm90_launches = 0  # of them, on the Hopper route

SPLIT_PASSES = (tied_split_logits, tied_split_softmax, tied_split_grad, tied_split_product)
SPLIT_PLAIN = (tied_split_logits_reference, tied_split_softmax_reference,
               tied_split_grad_reference, tied_split_product_reference)
