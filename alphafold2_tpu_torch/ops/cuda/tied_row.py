"""K2: tied-row MSA attention — CUDA kernel wrapper and plain version.

Port of ``alphafold2_tpu/ops/pallas/tied_row.py`` ``tied_row_attention``.
One attention matrix per (batch, head) is shared by all R MSA rows:

    logits[b, h, i, j] = sm_scale * tie_scale[b] * sum_r q[b, r, i, h] . k[b, r, j, h]
    out[b, r, i, h]    = sum_j softmax_j(logits) v[b, r, j, h]

The kernel is ``csrc/tied_row_attention.cu``, which reads the (B, R, N, H, D)
layout in place and chunks the fused R*D feature axis (no fold copy, unlike
the TPU path). :func:`tied_row_attention_reference` is the same function in
plain PyTorch; :func:`tied_row_attention` runs it only for CPU tensors.

Callers pre-zero padded (row, position) entries of q/k/v (abstention), pass
the SHARED query/column masks (B, N) and the voting-row ``tie_scale``
(ops/attention.py). Masking follows ``axial.fused_attention``: masked keys
excluded, masked queries and key-less rows give 0.

K2 is a forward kernel only (the TPU path differentiates it through K1's
backward at head dim R*D; that backward is not ported for tied rows). On the
card :func:`tied_row_attention` raises when grad is enabled and an input
requires it, rather than return an output that carries no gradient; on the
CPU the plain version is differentiated by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from alphafold2_tpu_torch.ops.cuda import build
from alphafold2_tpu_torch.ops.cuda.axial import (
    _DTYPES,
    _masked_softmax_weights,
    _ptr,
)


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
    tied_row_attention_reference.calls += 1
    b, r = q.shape[:2]
    tie = _tie_vector(tie_scale, b, r, q.device)
    s = torch.einsum("brihd,brjhd->bhij", q.float(), k.float())
    s = s * (sm_scale * tie)[:, None, None, None]
    valid = kv_mask[:, None, None, :] if kv_mask is not None else None
    p, l = _masked_softmax_weights(s, valid)
    out = torch.einsum("bhij,brjhd->brihd", p / l, v.float())
    if q_mask is not None:
        out = out * q_mask[:, None, :, None, None]
    return out.to(q.dtype)


tied_row_attention_reference.calls = 0


def tied_row_attention(
    q: torch.Tensor,  # (B, R, Nq, H, D), padded entries pre-zeroed
    k: torch.Tensor,  # (B, R, Nk, H, D)
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,  # (B, Nq) shared query mask
    kv_mask: Optional[torch.Tensor] = None,  # (B, Nk) shared column mask
    sm_scale: float = 1.0,
    tie_scale: Union[None, float, torch.Tensor] = None,
) -> torch.Tensor:
    """Tied-row attention; returns (B, R, Nq, H, D) in q's dtype. CUDA
    operands must be contiguous."""
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
    if q.device.type == "cpu":
        return tied_row_attention_reference(
            q, k, v, q_mask, kv_mask, sm_scale, tie_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"tied_row_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "tied_row_attention has no backward kernel on the card yet: train "
            "with model.msa_tie_row_attn=False (the training default)"
        )
    if any(t.device != q.device for t in (k, v) + tuple(
            m for m in (q_mask, kv_mask) if m is not None)):
        raise ValueError("tied_row_attention operands must share one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("tied_row_attention needs contiguous (B, R, N, H, D) operands")
    if nk == 0:
        raise ValueError("tied_row_attention needs at least one key")
    tie = _tie_vector(tie_scale, b, r, q.device)
    masks = [m.contiguous() if m is not None else None for m in (q_mask, kv_mask)]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("tied_row_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.af2_tied_row_attention(
            _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _ptr(masks[0]), _ptr(masks[1]), _ptr(tie),
            b, r, h, nq, nk, d, float(sm_scale), ctypes.c_void_p(stream),
        )
    build.check(lib, code, "tied_row_attention")
    tied_row_attention.launches += 1
    return out


tied_row_attention.launches = 0
