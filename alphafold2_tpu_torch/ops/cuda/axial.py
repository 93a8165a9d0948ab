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
and, D-chunked, for any head dim past 128 (K1 through
``csrc/attention_tile.cuh``, K3a/K3b through
``csrc/tied_row_attention_bwd.cu``). A head dim below 128 that is not
built runs zero-padded up to the next built one (:func:`kernel_head_dim`,
:func:`at_kernel_head_dim`), which is exact: zero columns add nothing to
q.k, P.V, ds.k or ds^T.q, and ``sm_scale`` stays the caller's. So the card
takes every head dim JAX's ``fused_attention`` takes.

K1's bf16 forward at head dim 32, 64 or 128 runs the Hopper kernel of
``csrc/fused_attention_sm90.cuh``. Where its grid leaves the card short of
two waves, :func:`key_splits` cuts the key axis into ranges; each block then
writes f32 partials and K1's combine pass (:func:`fused_attention_combine`)
merges them. Their plain versions: :func:`attention_partials_reference` and
:func:`combine_partials_reference`.

K3a/K3b's bf16 backward at head dim 32, 64 or 128 runs the Hopper kernels of
``csrc/fused_attention_bwd_sm90.cuh``. Where a kernel's grid leaves the card
short of two waves, :func:`grad_splits` cuts its long loop (keys for K3a,
queries for K3b) into ranges; each block then writes f32 partials and K3's
merge pass (:func:`fused_attention_bwd_merge`) adds them in split order.
Their plain versions: :func:`dq_partials_reference`,
:func:`dkv_partials_reference` and :func:`merge_grad_partials_reference`.

:func:`fused_attention` is differentiable. When grad is enabled and an input
requires it, it runs :class:`FusedAttention`: on the card K1 with the
logsumexp forward and K3a + K3b backward, on the CPU the plain versions of
the same math (never autograd through an einsum). Otherwise it runs the
no-logsumexp forward, which is all serving launches.

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
# K3a/K3b's Hopper kernels (csrc/fused_attention_bwd_sm90.cuh): the rows of
# every tile, the head dims they are built for, the tiles a split keeps
GRAD_TILE = 64
GRAD_SM90_HEAD_DIMS = (32, 64, 128)
MIN_GRAD_SPLIT_TILES = 4


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
    """How many contiguous key ranges K1 cuts the key axis into: 1 where
    its b*h*ceil(nq/128) blocks make two waves on the card's 132 SMs,
    otherwise enough ranges for about two waves, each of at least
    MIN_SPLIT_TILES 128-key tiles. A pure function of the shape: the
    wrapper passes it to the kernel, the build gate plans with it. ``d``
    does not change the count (every head dim uses 128-row, 128-key
    tiles)."""
    del d
    blocks = b * h * -(-nq // QUERY_TILE)
    if blocks == 0 or blocks >= 2 * SM_COUNT:
        return 1
    tiles = -(-nk // KEY_TILE)
    return max(1, min(-(-2 * SM_COUNT // blocks), tiles // MIN_SPLIT_TILES))


def grad_splits(b: int, h: int, nq: int, nk: int, d: int, which: str) -> int:
    """How many contiguous ranges K3a (``which`` "dq") cuts its key loop
    into, or K3b ("dkv") its query loop: 1 where the kernel's
    b*h*ceil(rows/64) blocks (rows: queries for K3a, keys for K3b) make two
    waves on the card's 132 SMs, otherwise enough ranges for about two
    waves, each of at least MIN_GRAD_SPLIT_TILES 64-row tiles. A pure
    function of the shape, as :func:`key_splits`: the wrapper passes it to
    the kernel, the build gate plans with it. ``d`` does not change the
    count."""
    del d
    if which not in ("dq", "dkv"):
        raise ValueError(f"which must be 'dq' or 'dkv', not {which!r}")
    rows, streamed = (nq, nk) if which == "dq" else (nk, nq)
    blocks = b * h * -(-rows // GRAD_TILE)
    if blocks == 0 or blocks >= 2 * SM_COUNT:
        return 1
    tiles = -(-streamed // GRAD_TILE)
    return max(1, min(-(-2 * SM_COUNT // blocks), tiles // MIN_GRAD_SPLIT_TILES))


def split_ranges(nk: int, splits: int, block: int = KEY_TILE) -> list:
    """The key range ``[lo, hi)`` of each split, cut as the kernel cuts
    them: whole ``block``-key tiles, split s taking tiles
    ``[s*T//S, (s+1)*T//S)`` of ``T = ceil(nk/block)``. A range may be
    empty."""
    tiles = -(-nk // block)
    return [(min(nk, s * tiles // splits * block), min(nk, (s + 1) * tiles // splits * block))
            for s in range(splits)]


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
    fused_attention_reference.calls += 1
    return _attend(q, k, v, q_mask, kv_mask, sm_scale, with_lse=False)


fused_attention_reference.calls = 0


def fused_attention_lse_reference(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
    """The plain version of the training forward: (out, lse)."""
    fused_attention_lse_reference.calls += 1
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
    fused_attention_dq_reference.calls += 1
    p = _probabilities(q, k, lse, q_mask, kv_mask, sm_scale)
    ds = _ds(p, v, dout, dsum).to(q.dtype).float()
    return (sm_scale * torch.einsum("bhij,bhjd->bhid", ds, k.float())).to(q.dtype)


fused_attention_dq_reference.calls = 0


def fused_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None,
                                  sm_scale=1.0):
    """The plain version of K3b: (dk, dv) = (sm_scale * ds^T @ q, p^T @ dO),
    p and ds rounded to the operand dtype first."""
    fused_attention_dkv_reference.calls += 1
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


def merge_grad_partials_reference(part, scale=1.0, dtype=torch.float32):
    """The plain version of K3's merge pass: the (S, B, H, N, D) f32
    partials added in split order, times ``scale``, in ``dtype``."""
    acc = part[0].float()
    for s in range(1, part.shape[0]):
        acc = acc + part[s]
    return (acc * scale).to(dtype)


def attention_dsum(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, (B, H, Nq): computed outside the kernels, as
    the JAX backward computes it outside its Pallas calls."""
    return (out.float() * dout.float()).sum(dim=-1)


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


def _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse):
    """K1 on CUDA tensors: out, and the (B, H, Nq) f32 lse when asked.
    Where the plan splits the key axis, the combine pass follows."""
    masks = _cuda_operands(q, k, v, q_mask, kv_mask, "fused_attention")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = _like_heads(q)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if nq == 0 or b * h == 0:
        return out, lse
    lib = build.library("fused_attention")
    # only the Hopper kernel (bf16, head dim 32, 64 or 128) splits the key axis
    hopper = q.dtype == torch.bfloat16 and d in HEAD_DIMS[1:]
    splits = key_splits(b, h, nq, nk, d) if hopper else 1
    part = (torch.empty(splits * b * h * nq * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    info = (ctypes.c_int * 2)()
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
    fused_attention.launches += 1
    fused_attention.sm90_launches += info[0]
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
    fused_attention_combine.launches += 1


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
    none. Not differentiable itself: :class:`FusedAttention` wraps it."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type == "cpu":
        return fused_attention_lse_reference(q, k, v, q_mask, kv_mask, sm_scale)
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


def launch_chunked_backward(which, outs, q, k, v, dout, lse, dsum, masks, tie, strides,
                            dims, sm_scale):
    """The D-chunked backward kernels of ``csrc/tied_row_attention_bwd.cu``
    on CUDA tensors: ``which`` "dq" writes ``outs`` (dq,), "dkv" writes
    (dk, dv). ``strides``: 28 element strides, (batch, head, token, row
    group) of q, k, v, dout and the (dq, dk, dv) slots; ``dims``: (batch,
    heads, nq, nk, features, row width); ``tie``: a (B,) f32 tensor or
    None; ``masks``: contiguous (q_mask, kv_mask), each or None."""
    symbol = f"af2_tied_row_attention_bwd_{which}"
    lib = build.library("tied_row_attention_bwd")
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = getattr(lib, symbol)(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum),
            *(_ptr(o) for o in outs), _ptr(masks[0]), _ptr(masks[1]), _ptr(tie),
            (ctypes.c_longlong * 28)(*strides), *dims, float(sm_scale), stream)
    build.check(lib, code, symbol)


def _launch_backward(which, outs, slots, q, k, v, dout, lse, dsum, q_mask, kv_mask,
                     sm_scale):
    """Launch K3a (``which`` "dq") or K3b ("dkv") writing ``outs``;
    ``slots`` gives the kernel the strides of its (dq, dk, dv) in that order
    (stand-ins for the ones it does not write). A head dim past 128 runs the
    D-chunked kernels (no row groups: row-group stride 0). Where the plan
    splits the long loop, the merge pass follows. Returns 1 if the Hopper
    kernel ran, else 0."""
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
        strides = [x for t in (q, k, v, dout, *slots) for x in (*t.stride()[:3], 0)]
        launch_chunked_backward(which, outs, q, k, v, dout, lse, dsum, masks, None, strides,
                                (b, h, nq, nk, d, d), sm_scale)
        return 0
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
    fused_attention_bwd_merge.launches += 1


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

    def run(q, k, v, dout):
        dq = _like_heads(q)
        fused_attention_dq.sm90_launches += _launch_backward(
            "dq", (dq,), (dq, k, v), q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
        fused_attention_dq.launches += 1
        return dq

    return at_kernel_head_dim(run, (q, k, v, dout))


fused_attention_dq.launches = 0
fused_attention_dq.sm90_launches = 0  # of them, launches of dq_kernel_sm90


def fused_attention_dkv(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3b: (dk, dv), each (B, H, Nk, D) in k's dtype."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return fused_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                             sm_scale)

    def run(q, k, v, dout):
        dk, dv = _like_heads(k), _like_heads(v)
        fused_attention_dkv.sm90_launches += _launch_backward(
            "dkv", (dk, dv), (q, dk, dv), q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
        fused_attention_dkv.launches += 1
        return dk, dv

    return at_kernel_head_dim(run, (q, k, v, dout))


fused_attention_dkv.launches = 0
fused_attention_dkv.sm90_launches = 0  # of them, launches of dkv_kernel_sm90


class FusedAttention(torch.autograd.Function):
    """Forward with the row logsumexp, backward by K3a/K3b (or, on the CPU,
    by their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, sm_scale):
        out, lse = fused_attention_lse(q, k, v, q_mask, kv_mask, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, q_mask, kv_mask)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, q_mask, kv_mask = ctx.saved_tensors
        args = (q, k, v, dout, lse, attention_dsum(out, dout), q_mask, kv_mask, ctx.sm_scale)
        return (fused_attention_dq(*args), *fused_attention_dkv(*args), None, None, None)


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
    return at_kernel_head_dim(
        lambda q, k, v: _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse=False)[0],
        (q, k, v))


fused_attention.launches = 0
fused_attention.sm90_launches = 0  # of them, launches of attention_kernel_sm90
