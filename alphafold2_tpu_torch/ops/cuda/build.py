"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each kernel source (``csrc/<name>.cu``, and X's valid counterpart
``csrc/controls/scale_rows.cu``) compiles on first use into its own shared
library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

and is loaded with ``ctypes``. The file name carries a hash of the sources,
so an edited kernel rebuilds and a built one is reused. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) goes to a ``.log``
beside each library; the Hopper build gate (``analysis/lowering.py``)
reads it. :func:`compile_source` builds one file and returns the
compiler's exit code and report instead of raising: the gate needs the text
of a refusal.

Every source also exports ``af2_<source>_plan``, the launch arithmetic its
launches use (:class:`LaunchPlan`), which touches no device.

Importing this module builds nothing: the CPU test suite imports every
module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BUILD_TIMEOUT_S = 600


class LaunchPlan(ctypes.Structure):
    """``Af2LaunchPlan`` of ``csrc/launch_plan.cuh``: a launch's grid,
    block, dynamic shared memory and kernel instantiation."""

    _fields_ = [("blocks", ctypes.c_longlong), ("threads", ctypes.c_int),
                ("dynamic_smem", ctypes.c_int), ("kernel", ctypes.c_char * 120)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PLAN = ctypes.POINTER(LaunchPlan)

# C entry points of each kernel source: {source: {symbol: argtypes}}
SIGNATURES = {
    "fused_attention": {
        # dtype, q, k, v, out, q_mask, kv_mask, strides, batch, heads, nq, nk,
        # head_dim, sm_scale, splits, partials, info (3 ints out: a Hopper
        # kernel ran, the splits run, the packed kernel ran), stream
        "af2_fused_attention": [_I] + [_P] * 7 + [_I] * 5 + [_F, _I, _P, _P, _P],
        # the training forward: one more pointer, the (B, H, Nq) f32 logsumexp
        "af2_fused_attention_lse": [_I] + [_P] * 8 + [_I] * 5 + [_F, _I, _P, _P, _P],
        # the combine pass: partials, out, lse, q_mask, out strides, batch,
        # heads, nq, head_dim, splits, stream
        "af2_fused_attention_combine": [_P] * 5 + [_I] * 5 + [_P],
        # dtype, batch, heads, nq, nk, head_dim, splits, aligned, plan
        "af2_fused_attention_plan": [_I] * 8 + [_PLAN],
        # batch, heads, nq, head_dim, plan
        "af2_fused_attention_combine_plan": [_I] * 4 + [_PLAN],
    },
    "fused_attention_bwd": {
        # dtype, q, k, v, dout, lse, dsum, outputs (dq | dk, dv), q_mask,
        # kv_mask, strides, batch, heads, nq, nk, head_dim, sm_scale, splits,
        # partials, info (2 ints out), stream
        "af2_fused_attention_bwd_dq": [_I] + [_P] * 10 + [_I] * 5 + [_F, _I, _P, _P, _P],
        "af2_fused_attention_bwd_dkv": [_I] + [_P] * 11 + [_I] * 5 + [_F, _I, _P, _P, _P],
        # the merge pass: partials, out0, out1, out strides, scale0, scale1,
        # outs, batch, heads, n, head_dim, splits, stream
        "af2_fused_attention_bwd_merge": [_P] * 4 + [_F, _F] + [_I] * 6 + [_P],
        # which (0 dq, 1 dkv), dtype, batch, heads, nq, nk, head_dim, splits,
        # aligned, plan
        "af2_fused_attention_bwd_plan": [_I] * 9 + [_PLAN],
        # outs, batch, heads, n, head_dim, plan
        "af2_fused_attention_bwd_merge_plan": [_I] * 5 + [_PLAN],
    },
    "tied_row_attention": {
        # dtype, q, k, v, out, q_mask, kv_mask, tie_scale, batch, rows, heads,
        # nq, nk, head_dim, sm_scale, workspace, its bytes, stream
        "af2_tied_row_attention": [_I] + [_P] * 7 + [_I] * 6 + [_F, _P, _L, _P],
        # the training forward: one more pointer after out, the (B, H, Nq) lse
        "af2_tied_row_attention_lse": [_I] + [_P] * 8 + [_I] * 6 + [_F, _P, _L, _P],
        # through element strides (K1 past head dim 128 as rows of 64): dtype,
        # q, k, v, out, lse (or null), q_mask, kv_mask, tie_scale (or null),
        # strides (16), batch, heads, nq, nk, features, row width, sm_scale,
        # workspace, its bytes, info (2 ints out: a Hopper kernel ran, the
        # wide route ran), stream
        "af2_tied_row_attention_strided": [_I] + [_P] * 9 + [_I] * 6 + [_F, _P, _L, _P, _P],
        # dtype, batch, rows, heads, nq, nk, head_dim, aligned, plan
        "af2_tied_row_attention_plan": [_I] * 8 + [_PLAN],
        # the wide route: dtype, batch, rows, heads, nq, nk, head_dim, aligned,
        # splits (1 int out), workspace bytes (1 long long out); the plan of
        # one of its passes: pass, dtype, batch, rows, heads, nq, nk,
        # head_dim, aligned, plan
        "af2_tied_row_attention_wide_route": [_I] * 8 + [_P, _P],
        "af2_tied_row_attention_wide_pass": [_I] * 9 + [_PLAN],
    },
    # dtype, q, k, v, dout, lse, dsum, outputs (dq | dk, dv | dq, dk, dv),
    # q_mask, kv_mask, tie_scale, strides (28), batch, heads, nq, nk,
    # features, row width, sm_scale, workspace, its bytes, info (ints out: 2
    # (a Hopper kernel ran, the wide route ran), 3 for the joint entry),
    # stream
    "tied_row_attention_bwd": {
        "af2_tied_row_attention_bwd_dq": [_I] + [_P] * 11 + [_I] * 6 + [_F, _P, _L, _P, _P],
        "af2_tied_row_attention_bwd_dkv": [_I] + [_P] * 12 + [_I] * 6 + [_F, _P, _L, _P, _P],
        "af2_tied_row_attention_bwd_grads": [_I] + [_P] * 13 + [_I] * 6 + [_F, _P, _L, _P, _P],
        # which (0 dq, 1 dkv), dtype, batch, heads, nq, nk, features, row
        # width, aligned, plan
        "af2_tied_row_attention_bwd_plan": [_I] * 9 + [_PLAN],
        # the wide route: dtype, batch, heads, nq, nk, features, row width,
        # aligned, splits (1 int out), workspace bytes (1 long long out);
        # the plan of one of its passes: pass, then those but the outs, plan
        "af2_tied_row_attention_bwd_wide_route": [_I] * 8 + [_P, _P],
        "af2_tied_row_attention_bwd_wide_pass": [_I] * 9 + [_PLAN],
    },
    # dtype, q, k, v, out, lse (or null), kv_mask, idx, cnt, max_active, the
    # union lists (blocks, bits, counts, max_stages), strides, batch, heads,
    # n, head_dim, block, sm_scale, info (1 int out), stream
    "block_sparse_attention": {
        "af2_block_sparse_attention":
            [_I] + [_P] * 8 + [_I] + [_P] * 3 + [_I, _P] + [_I] * 5 + [_F, _P, _P],
        # dtype, batch, heads, n, head_dim, block, aligned, plan
        "af2_block_sparse_attention_plan": [_I] * 7 + [_PLAN],
    },
    # dtype, q, k, v, dout, lse, dsum, outputs (dq | dk, dv), kv_mask, idx,
    # cnt, max_active, the union lists (blocks, bits, counts, max_stages),
    # strides, batch, heads, n, head_dim, block, sm_scale, info (1 int out),
    # stream
    "block_sparse_attention_bwd": {
        "af2_block_sparse_attention_bwd_dq":
            [_I] + [_P] * 10 + [_I] + [_P] * 3 + [_I, _P] + [_I] * 5 + [_F, _P, _P],
        "af2_block_sparse_attention_bwd_dkv":
            [_I] + [_P] * 11 + [_I] + [_P] * 3 + [_I, _P] + [_I] * 5 + [_F, _P, _P],
        # which (0 dq, 1 dkv), dtype, batch, heads, n, head_dim, block,
        # aligned, plan
        "af2_block_sparse_attention_bwd_plan": [_I] * 8 + [_PLAN],
    },
    # X's valid counterpart: x, out, rows, n, stream; plan: rows, n, plan
    "scale_rows": {
        "af2_scale_rows": [_P, _P, _I, _I, _P],
        "af2_scale_rows_plan": [_I, _I, _PLAN],
    },
}

# the negative control, built only by the gate (which requires it to fail)
CONTROLS = CSRC / "controls"
MISTILED = CONTROLS / "scale_rows_mistiled.cu"


def source(name: str) -> Path:
    """The ``.cu`` file of kernel ``name``: ``csrc/<name>.cu`` or, for X's
    counterpart, ``csrc/controls/<name>.cu``."""
    path = CSRC / f"{name}.cu"
    return path if path.exists() else CONTROLS / f"{name}.cu"


_lock = threading.Lock()
_libraries: dict = {}


def nvcc_path() -> Optional[str]:
    """The CUDA compiler on this machine, or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _nvcc() -> str:
    found = nvcc_path()
    if found is None:
        raise RuntimeError(
            "nvcc not found: the Hopper kernels compile with the CUDA toolkit "
            "on the machine that has the card"
        )
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [source(name)]:
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_source(path, out_dir, flags=ARCH_FLAGS, output: Optional[Path] = None,
                   timeout: float = BUILD_TIMEOUT_S) -> tuple:
    """Compile one ``.cu`` file into a shared library in ``out_dir``
    (``<stem>.so``, or ``output``) with ``-Xptxas -v``. Returns
    ``(returncode, log)``: nvcc's exit code and its whole output, or
    ``(None, log)`` if it ran past ``timeout`` seconds. Raises only if nvcc
    is not installed."""
    path = Path(path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = output if output is not None else out_dir / f"{path.stem}.so"
    cmd = [_nvcc(), *flags, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(out), str(path)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        log = e.stdout if isinstance(e.stdout, str) else (e.stdout or b"").decode()
        return None, f"{log}\nnvcc timed out after {timeout} s"
    return proc.returncode, proc.stdout


def _build_one(name: str) -> tuple:
    """(returncode, log, library path) of kernel ``name``, built unless its
    library exists (its log is then the one written when it was built)."""
    path = _library_path(name)
    log_path = path.with_suffix(".log")
    if path.exists():
        return 0, log_path.read_text() if log_path.exists() else "", path
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    code, log = compile_source(source(name), BUILD_DIR, output=tmp)
    log_path.write_text(log)
    if code == 0:
        os.replace(tmp, path)
    return code, log, path


def build_sources(names=None) -> dict:
    """Compile every named source (default: every kernel) that has no
    current library, one ``nvcc`` per source, all started together.
    Returns ``{name: (returncode, log, path)}`` and raises for nothing but
    a missing nvcc."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _nvcc()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = list(pool.map(_build_one, names))
    return dict(zip(names, results))


def build_all(names=None) -> dict:
    """As :func:`build_sources`, but returns ``{name: path}`` and raises
    with the compiler's output if any build fails."""
    results = build_sources(names)
    failures = [f"{name}: nvcc exit {code}\n{log}"
                for name, (code, log, _) in results.items() if code != 0]
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: path for name, (_, _, path) in results.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.af2_error_string.argtypes = [ctypes.c_int]
        lib.af2_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
        return lib


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error; ``code`` is the
    ``cudaError_t``."""

    def __init__(self, what: str, code: int, message: str):
        super().__init__(f"{what} launch failed: CUDA error {code} ({message})")
        self.code = code


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` if a kernel's C entry returned a
    CUDA error."""
    if code != 0:
        raise KernelLaunchError(what, code, lib.af2_error_string(code).decode())
