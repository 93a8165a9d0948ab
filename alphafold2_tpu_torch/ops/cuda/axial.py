"""K1: fused flash-attention forward — CUDA kernel wrapper and plain version.

Port of ``alphafold2_tpu/ops/pallas/axial.py`` ``fused_attention`` (the
forward, ``_run`` / ``_fwd_core``). The kernel is
``csrc/fused_attention.cu``; :func:`fused_attention_reference` is the same
function in plain PyTorch. :func:`fused_attention` runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.

Contract (the JAX function's, with one sharpening): q (B, H, Nq, D),
k/v (B, H, Nk, D), boolean ``q_mask`` (B, Nq) and ``kv_mask`` (B, Nk)
shared by all heads. Masked keys are excluded exactly; masked queries give
0. A query row with no valid key gives exactly 0 (the TPU kernel gave a
finite average over its padded block there; every caller masks such rows).
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
        p = p * valid
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


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
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    valid = kv_mask[:, None, None, :] if kv_mask is not None else None
    p, l = _masked_softmax_weights(s, valid)
    out = torch.einsum("bhij,bhjd->bhid", p, v.float()) / l
    if q_mask is not None:
        out = out * q_mask[:, None, :, None]
    return out.to(q.dtype)


fused_attention_reference.calls = 0


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


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Fused attention; returns (B, H, Nq, D) in q's dtype.

    CUDA tensors: q/k/v may be strided views (any batch/head/token strides)
    as long as the head dim is contiguous; the result is a (B, H, Nq, D)
    view of a (B, Nq, H, D) buffer, so folding heads back into channels
    (``out.transpose(1, 2).reshape(B, Nq, H * D)``) copies nothing."""
    _check(q, k, v, q_mask, kv_mask)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, q_mask, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    tensors = [t for t in (q, k, v, q_mask, kv_mask) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_attention operands must share one device")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v head dim must be contiguous (stride 1)")
    if nk == 0:
        raise ValueError("fused_attention needs at least one key")
    masks = [m.contiguous() if m is not None else None for m in (q_mask, kv_mask)]
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    if nq == 0 or b * h == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    lib = build.library("fused_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.af2_fused_attention(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _ptr(masks[0]), _ptr(masks[1]), strides,
            b, h, nq, nk, d, float(sm_scale), ctypes.c_void_p(stream),
        )
    build.check(lib, code, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
