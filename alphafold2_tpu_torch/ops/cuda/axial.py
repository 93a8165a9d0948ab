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


def _probabilities(q, k, lse, q_mask, kv_mask, sm_scale):
    """The backward's recomputed probabilities exp(s - lse), exactly 0 for
    masked keys, masked query rows and rows with lse = +inf."""
    live = torch.isfinite(lse)
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    valid = live[..., None]
    if kv_mask is not None:
        valid = valid & kv_mask[:, None, None, :]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    p = torch.exp(s - torch.where(live, lse, 0.0)[..., None])
    return torch.where(valid, p, 0.0)


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
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS}")
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
    """K1 on CUDA tensors: out, and the (B, H, Nq) f32 lse when asked."""
    masks = _cuda_operands(q, k, v, q_mask, kv_mask, "fused_attention")
    b, h, nq, d = q.shape
    out = _like_heads(q)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if nq == 0 or b * h == 0:
        return out, lse
    lib = build.library("fused_attention")
    args = (b, h, nq, k.shape[2], d, float(sm_scale))
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
        tail = (_ptr(masks[0]), _ptr(masks[1]), _strides(q, k, v, out), *args, stream)
        if with_lse:
            code = lib.af2_fused_attention_lse(_DTYPES[q.dtype], *ptrs, _ptr(lse), *tail)
        else:
            code = lib.af2_fused_attention(_DTYPES[q.dtype], *ptrs, *tail)
    build.check(lib, code, "fused_attention")
    fused_attention.launches += 1
    return out, lse


def fused_attention_lse(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K1's training forward: (out, lse), lse the (B, H, Nq) f32 logsumexp
    of each row's scaled logits over its valid keys, +inf for a row with
    none. Not differentiable itself: :class:`FusedAttention` wraps it."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type == "cpu":
        return fused_attention_lse_reference(q, k, v, q_mask, kv_mask, sm_scale)
    return _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse=True)


def _check_grad_operands(q, k, v, dout, lse, dsum):
    b, h, nq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != (b, h, nq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 ({b}, {h}, {nq})")


def _launch_backward(symbol, outs, slots, q, k, v, dout, lse, dsum, q_mask, kv_mask,
                     sm_scale):
    """Launch K3a or K3b writing ``outs``; ``slots`` gives the kernel the
    strides of its (dq, dk, dv) in that order (stand-ins for the ones it
    does not write)."""
    masks = _cuda_operands(q, k, v, q_mask, kv_mask, symbol)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse, dsum = lse.contiguous(), dsum.contiguous()
    b, h, nq, d = q.shape
    if nq == 0 or b * h == 0:
        for o in outs:
            o.zero_()
        return
    lib = build.library("fused_attention_bwd")
    strides = _strides(q, k, v, dout, *slots)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = getattr(lib, symbol)(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(dsum),
            *(_ptr(o) for o in outs), _ptr(masks[0]), _ptr(masks[1]), strides,
            b, h, nq, k.shape[2], d, float(sm_scale), stream,
        )
    build.check(lib, code, symbol)


def fused_attention_dq(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3a: dq (B, H, Nq, D) in q's dtype from the forward's ``lse`` and
    ``dsum = attention_dsum(out, dout)``."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return fused_attention_dq_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                            sm_scale)
    dq = _like_heads(q)
    _launch_backward("af2_fused_attention_bwd_dq", (dq,), (dq, k, v), q, k, v, dout, lse,
                     dsum, q_mask, kv_mask, sm_scale)
    fused_attention_dq.launches += 1
    return dq


fused_attention_dq.launches = 0


def fused_attention_dkv(q, k, v, dout, lse, dsum, q_mask=None, kv_mask=None, sm_scale=1.0):
    """K3b: (dk, dv), each (B, H, Nk, D) in k's dtype."""
    _check(q, k, v, q_mask, kv_mask)
    _check_grad_operands(q, k, v, dout, lse, dsum)
    if q.device.type == "cpu":
        return fused_attention_dkv_reference(q, k, v, dout, lse, dsum, q_mask, kv_mask,
                                             sm_scale)
    dk, dv = _like_heads(k), _like_heads(v)
    _launch_backward("af2_fused_attention_bwd_dkv", (dk, dv), (q, dk, dv), q, k, v, dout,
                     lse, dsum, q_mask, kv_mask, sm_scale)
    fused_attention_dkv.launches += 1
    return dk, dv


fused_attention_dkv.launches = 0


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
    (``out.transpose(1, 2).reshape(B, Nq, H * D)``) copies nothing."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, q_mask, kv_mask, sm_scale)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, q_mask, kv_mask, sm_scale)
    return _launch_forward(q, k, v, q_mask, kv_mask, sm_scale, with_lse=False)[0]


fused_attention.launches = 0
