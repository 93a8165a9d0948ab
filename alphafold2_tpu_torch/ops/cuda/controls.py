"""X's counterpart: ``o = 2 * x`` over a (rows, n) f32 array — CUDA kernel
wrapper and plain version.

Port of the TPU kernel ``alphafold2_tpu/analysis/lowering.py``
``case_negative_control`` (:257, pallas_call :267), the negative control of
the JAX package's pre-hardware lowering gate. Its Hopper counterparts are
two sources under ``csrc/controls/``:

- ``scale_rows.cu``, the valid form (one block per row, one thread per
  element), built and launched here: :func:`scale_rows`, with
  :func:`scale_rows_reference` its plain version;
- ``scale_rows_mistiled.cu``, which stages a (32, 512) f32 tile in static
  shared memory and which ptxas must refuse: the build gate's negative
  control (``analysis/lowering.py``), never built here.

The launch-level control is this same wrapper at (1, 2048): a block of 2048
threads, which the card refuses with ``cudaErrorInvalidConfiguration``
(:data:`INVALID_CONFIGURATION`); the wrapper raises it through
``build.check`` and catches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from alphafold2_tpu_torch.ops.cuda import build

INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration
X_SHAPE = (4, 512)  # the TPU control's array
LAUNCH_CONTROL_SHAPE = (1, 2048)  # one row of 2048 threads: over the 1024 a block may hold


def scale_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``2 * x`` (exact in f32)."""
    scale_rows_reference.calls += 1
    return 2 * x


scale_rows_reference.calls = 0


def scale_rows(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a (rows, n) f32 tensor. CPU tensors run the plain
    version; CUDA tensors launch ``af2_scale_rows`` with one block of ``n``
    threads per row (the card refuses ``n`` > 1024) or raise."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"scale_rows takes a (rows, n) float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return scale_rows_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"scale_rows runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build.library("scale_rows")
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = lib.af2_scale_rows(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                                  x.shape[0], x.shape[1], stream)
    build.check(lib, code, "scale_rows")
    scale_rows.launches += 1
    return out


scale_rows.launches = 0
