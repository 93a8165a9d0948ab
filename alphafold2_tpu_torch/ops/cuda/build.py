"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

and is loaded with ``ctypes``. The file name carries a hash of the sources,
so an edited kernel rebuilds and a built one is reused. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) goes to a ``.log``
beside each library.

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
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points of each kernel source: {source: {symbol: argtypes}}
SIGNATURES = {
    "fused_attention": {
        "af2_fused_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        # the training forward: one more pointer, the (B, H, Nq) f32 logsumexp
        "af2_fused_attention_lse": [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "fused_attention_bwd": {
        "af2_fused_attention_bwd_dq": [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "af2_fused_attention_bwd_dkv": [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "tied_row_attention": {
        "af2_tied_row_attention": [
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    # dtype, q, k, v, out, lse (or null), kv_mask, idx, cnt, max_active,
    # strides, batch, heads, n, head_dim, block, sm_scale, stream
    "block_sparse_attention": {
        "af2_block_sparse_attention": [_I] + [_P] * 8 + [_I, _P] + [_I] * 5 + [_F, _P],
    },
    # dtype, q, k, v, dout, lse, dsum, outputs (dq | dk, dv), kv_mask, idx,
    # cnt, max_active, strides, batch, heads, n, head_dim, block, sm_scale, stream
    "block_sparse_attention_bwd": {
        "af2_block_sparse_attention_bwd_dq": [_I] + [_P] * 10 + [_I, _P] + [_I] * 5 + [_F, _P],
        "af2_block_sparse_attention_bwd_dkv": [_I] + [_P] * 11 + [_I, _P] + [_I] * 5 + [_F, _P],
    },
}

_lock = threading.Lock()
_libraries: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the Hopper kernels compile with the CUDA toolkit "
        "on the machine that has the card"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=None) -> dict:
    """Compile every kernel source that has no current library, one
    ``nvcc`` per source, all started together. Returns ``{name: path}``;
    raises with the compiler's output if any build fails."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


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


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = lib.af2_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
