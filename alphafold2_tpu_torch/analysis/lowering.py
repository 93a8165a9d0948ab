"""The Hopper build gate: the port's pre-hardware rule set.

Counterpart of ``alphafold2_tpu/analysis/lowering.py``, the JAX package's
Mosaic lowering gate, which lowers every Pallas kernel for the TPU on a
CPU-only host and requires a deliberately mis-tiled kernel (X) to be
rejected. Here the kernels are CUDA C++ for ``sm_90a`` and the gate runs
wherever ``nvcc`` is, with or without a card. For each case it

(a) builds each kernel source the case launches, with ``ops/cuda/build.py``'s
    flags (and its cache: a built library's ``.log`` is its report);
(b) parses ``ptxas -v``'s report for every ``__global__`` instantiation
    (registers, barriers, static shared memory, stack frame, spill stores
    and loads), names demangled with the toolkit's ``cu++filt``;
(c) loads the library and calls the source's ``af2_<source>_plan`` entry at
    the case's shapes, in float32 and in bfloat16 (different
    instantiations): the arithmetic the launch itself uses, which touches
    no device;
(d) holds the plan and the planned instantiation's resources against
    sm_90's limits (:data:`SM90_LIMITS`). A planned instantiation missing
    from the report fails the case; it is never taken as clean. Spills are
    recorded with a warning and fail nothing.

The negative control, ``negative_control_rejects_bad_tiling``, compiles
``csrc/controls/scale_rows_mistiled.cu`` (X's function staging a 64 KiB
static shared tile) and requires ptxas to refuse it for exactly that:
:func:`_is_hopper_rejection` counts only a non-zero nvcc exit whose report
carries ptxas's shared-data error for the control's kernel. A missing
nvcc, a C++ error, a missing header or a timeout is not a rejection, and a
control that builds fails the gate.

CLI::

    python -m alphafold2_tpu_torch.analysis.lowering [case ...]

One JSON line per case, then ``{"gate": "hopper_build", "cases": n,
"failed": [...], "control_rejected": bool}``. Exit 0 only if every case
passes and the control is refused; 1 otherwise; 2 for an unknown case name
or when ``nvcc`` (or ``cu++filt``) is not installed, so the gate never
exits 0 without a build.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from alphafold2_tpu_torch.ops.cuda import build, tied_row
from alphafold2_tpu_torch.ops.cuda.axial import grad_route, grad_splits, key_splits, row_width

GATE = "hopper_build"
DTYPES = ("float32", "bfloat16")
_DTYPE_CODE = {"float32": 0, "bfloat16": 1}

# What one H100 (sm_90) allows a launch (CUDA C++ Programming Guide,
# compute capability 9.0; NVIDIA's Hopper tuning guide).
SM90_LIMITS = {
    "max_blocks": 2**31 - 1,  # gridDim.x
    "max_threads": 1024,  # per block
    "warp": 32,  # a block's threads come in whole warps
    "max_smem_bytes": 232_448,  # static + dynamic per block, 227 KiB with opt-in
    "max_static_smem_bytes": 49_152,  # 48 KiB declared statically
    "max_registers": 255,  # per thread
    "registers_per_sm": 65_536,  # registers x threads of one block must fit
    "max_cluster": 8,  # blocks a thread-block cluster, the portable size
}

CONTROL_CASE = "negative_control_rejects_bad_tiling"
CONTROL_KERNEL = "scale_rows_mistiled"


class ToolMissing(RuntimeError):
    """nvcc or cu++filt is not installed: the gate cannot build anything."""


# --------------------------------------------------------------- cases


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch a case plans: ``symbol`` of kernel source
    ``source`` called with ``args`` (``None`` marks the dtype code)."""

    role: str  # K1, K1c (K1's combine pass), K2, K2a/K2b (its backward; K2g the wide
    # route's p and ds pass), K2s (K2's split route on sharded rows), K3 (the
    # one-pass backward), K3a, K3b, K3m (K3's merge pass), K3d (the dsum
    # pass), ..., X
    source: str
    symbol: str
    args: tuple
    dtypes: tuple = DTYPES  # the dtypes that launch it
    tail: tuple = ()  # arguments after the plan's pointer (None: a null pointer)

    def plan_args(self, dtype: str) -> tuple:
        return tuple(_DTYPE_CODE[dtype] if a is None else a for a in self.args)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    launches: tuple = ()
    dtypes: tuple = DTYPES


def _k1(b, h, nq, nk, d):
    """K1 at one shape, with the split its wrapper passes and operands as
    TMA can describe them: bf16 under 64 queries and keys plans the packed
    kernel (attention_packed_kernel_sm90), other bf16 at head dim 32, 64 or
    128 attention_kernel_sm90 and, where the key axis is split, the combine
    pass too. Past head dim 128 at a multiple of 64 the
    wrapper sends bf16 to K2's plan, the head dim as rows of 64
    (tied_row_attention_kernel_sm90 through the strided entry), and f32 to
    fused_attention.cu's D-chunked kernel."""
    splits = key_splits(b, h, nq, nk, d)
    main = Launch("K1", "fused_attention", "af2_fused_attention_plan",
                  (None, b, h, nq, nk, d, splits, 1))
    if d > 128 and row_width(d) < d:
        rows = Launch("K1", "tied_row_attention", "af2_tied_row_attention_plan",
                      (None, b, d // row_width(d), h, nq, nk, row_width(d), 1),
                      dtypes=("bfloat16",))
        return (dataclasses.replace(main, dtypes=("float32",)), rows)
    if splits == 1:
        return (main,)
    return (main, Launch("K1c", "fused_attention", "af2_fused_attention_combine_plan",
                         (b, h, nq, d), dtypes=("bfloat16",)))


def _k3(b, h, nq, nk, d):
    """K1's backward as its autograd Functions launch it, with operands as
    TMA can describe them: where axial.grad_route says "onepass", bf16 the
    one-pass kernel (attention_bwd_kernel_sm90, K3, with its cluster) and
    f32 K3a and K3b; elsewhere K3a and K3b with the split of their long loop,
    each followed by K3's merge pass (bf16 only) where it splits; past head
    dim 128 the kernels of tied_row_attention_bwd.cu on the head dim cut into
    rows of axial.row_width(d) (bf16 at a multiple of 64: tied_dq_kernel_sm90
    / tied_dkv_kernel_sm90). Last, on every route, the dsum pass
    (attention_dsum_kernel, K3d)."""
    source = "fused_attention_bwd"
    dsum = Launch("K3d", source, "af2_attention_dsum_plan", (None, b, h, nq, d))
    if d > 128:
        tied = "tied_row_attention_bwd"
        return (*(Launch(role, tied, f"af2_{tied}_plan",
                         (which, None, b, h, nq, nk, d, row_width(d), 1))
                  for role, which in (("K3a", 0), ("K3b", 1))), dsum)
    if grad_route(b, h, nq, nk, d) == "onepass":
        return (Launch("K3", source, "af2_fused_attention_bwd_onepass_plan",
                       (None, b, h, nq, nk, d, 1), dtypes=("bfloat16",)),
                *(Launch(role, source, "af2_fused_attention_bwd_plan",
                         (which, None, b, h, nq, nk, d, 1, 1), dtypes=("float32",))
                  for role, which in (("K3a", 0), ("K3b", 1))), dsum)
    launches = []
    for role, which, name, outs, rows in (("K3a", 0, "dq", 1, nq), ("K3b", 1, "dkv", 2, nk)):
        splits = grad_splits(b, h, nq, nk, d, name)
        launches.append(Launch(role, source, "af2_fused_attention_bwd_plan",
                               (which, None, b, h, nq, nk, d, splits, 1)))
        if splits > 1:
            launches.append(Launch("K3m", source, "af2_fused_attention_bwd_merge_plan",
                                   (outs, b, h, rows, d), dtypes=("bfloat16",)))
    return (*launches, dsum)


def _k2(b, r, h, n, d):
    """K2 with operands TMA can describe: bf16 at head dim 32, 64 or 128
    with R*D up to 512 (at head dim 64) plans the Hopper kernel
    (tied_row_attention_kernel_sm90), a wider R*D at those head dims the
    wide route (its logits pass, then in bf16 its softmax and P V' passes,
    tied_row_wide_sm90.cuh), other head dims and f32 the older ones."""
    main = Launch("K2", "tied_row_attention", "af2_tied_row_attention_plan",
                  (None, b, r, h, n, n, d, 1))
    if tied_row.wide_plan(b, r, h, n, n, d) is None:
        return (main,)
    return (main, *(Launch("K2", "tied_row_attention", "af2_tied_row_attention_wide_pass",
                           (pass_, None, b, r, h, n, n, d, 1), dtypes=("bfloat16",))
                    for pass_ in (1, 2)))


def _k2_bwd(b, r, h, n, d):
    """K2's backward: dq (K2a) and dk/dv (K2b) at the fused axis F = R*D of
    rows of D, operands TMA can describe: bf16 at head dim 32, 64 or 128
    with R*D up to 448 (at head dim 64) plans the Hopper kernels
    (tied_dq_kernel_sm90, tied_dkv_kernel_sm90), a wider R*D at those head
    dims the wide route (its logits pass, then in bf16 p and ds, K2g, and
    the dq and dk/dv products), other head dims and f32 the chunked
    ones."""
    source = "tied_row_attention_bwd"
    main = tuple(Launch(role, source, f"af2_{source}_plan", (which, None, b, h, n, n, r * d, d, 1))
                 for role, which in (("K2a", 0), ("K2b", 1)))
    if tied_row.wide_bwd_plan(b, h, n, n, r * d, d) is None:
        return main
    return (*main, *(Launch(role, source, f"af2_{source}_wide_pass",
                            (pass_, None, b, h, n, n, r * d, d, 1), dtypes=("bfloat16",))
                     for role, pass_ in (("K2g", 1), ("K2a", 2), ("K2b", 3))))


def _k2_split(b, r, h, n, d):
    """K2's split route (``csrc/tied_row_split.cuh``), the tied pass on MSA
    rows sharded over a mesh, as ``ops/cuda/tied_row.py``'s ``tied_split_*``
    wrappers plan it (the Hopper route asked for, ``r`` this rank's rows):
    the logits over the fused R*D axis (bf16 at head dim 32, 64 or 128:
    tied_wide_logits_kernel<D,2> in feature splits, then split_sum_kernel;
    elsewhere split_logits_kernel), the softmax and the grad passes, and
    the product (tied_wide_product_kernel<D,C>, or split_product_kernel).
    Forward and backward launch the same instantiations at a square
    shape."""
    source, symbol, null = "tied_row_attention", "af2_tied_split_plan", (None, None)
    split = lambda pass_, dtypes=DTYPES: Launch(  # noqa: E731
        "K2s", source, symbol, (pass_, None, b, h, n, n, r * d, d, 1), dtypes, null)
    sums = () if tied_row.split_logits_splits(b, h, n, n, r * d, d) == 1 else (
        split(1, ("bfloat16",)),)
    return (split(0), *sums, split(2), split(3), split(4))


def _k4(b, h, n, d, block):
    """K4 with operands as TMA can describe them: bf16 at head dim 32, 64
    or 128 plans the Hopper kernel (sparse_fwd_kernel_sm90), f32 the older
    one."""
    return Launch("K4", "block_sparse_attention", "af2_block_sparse_attention_plan",
                  (None, b, h, n, d, block, 1))


def _k5(b, h, n, d, block):
    """K5a and K5b with operands as TMA can describe them: bf16 at head dim
    32, 64 or 128 plans the Hopper kernels (sparse_dq_kernel_sm90,
    sparse_dkv_kernel_sm90), f32 the older ones."""
    return tuple(Launch(role, "block_sparse_attention_bwd", "af2_block_sparse_attention_bwd_plan",
                        (which, None, b, h, n, d, block, 1))
                 for role, which in (("K5a", 0), ("K5b", 1)))


def _x(rows, n):
    return Launch("X", "scale_rows", "af2_scale_rows_plan", (rows, n))


# JAX's cases (alphafold2_tpu/analysis/lowering.py:322-338), one for one at
# the same shapes: block-sparse at block 128, 4 heads, head dim 64, batch 1;
# the stock flash kernel's cases run K1 (and K3), which takes its role here.
JAX_CASES = (
    Case("block_sparse_fwd_n512", (_k4(1, 4, 512, 64, 128),)),
    Case("block_sparse_fwd_nolse_n512", (_k4(1, 4, 512, 64, 128),)),
    Case("block_sparse_fwd_n1024", (_k4(1, 4, 1024, 64, 128),)),
    Case("block_sparse_bwd_n512", (_k4(1, 4, 512, 64, 128), *_k5(1, 4, 512, 64, 128))),
    Case("block_sparse_bwd_n1024", (_k4(1, 4, 1024, 64, 128), *_k5(1, 4, 1024, 64, 128))),
    Case("block_sparse_custom_vjp_n512", (_k4(1, 4, 512, 64, 128), *_k5(1, 4, 512, 64, 128))),
    Case("flash_axial_256", (*_k1(4, 8, 256, 256, 64),)),
    Case("flash_compressed_cross", (*_k1(1, 8, 4096, 128, 64),)),
    Case("flash_bwd_256", (*_k1(2, 8, 256, 256, 64), *_k3(2, 8, 256, 256, 64))),
    Case("fused_axial_fwd_256", (*_k1(2, 4, 256, 256, 64),)),
    Case("fused_axial_bwd_256", (*_k1(2, 4, 256, 256, 64), *_k3(2, 4, 256, 256, 64))),
    Case("tied_row_fwd_256", (*_k2(1, 8, 4, 256, 64),)),
    Case("tied_row_bwd_256", (*_k2(1, 8, 4, 256, 64), *_k2_bwd(1, 8, 4, 256, 64))),
)

# The shapes the port launches on the card (chip_smoke.py's serving,
# training and sparse cases): bucket 128 at batch 4 elongates to 384 tokens;
# training crops 128 with a 5 x 64 MSA (with tied rows: R 5, N 64, R*D 320);
# sparse training at block 16.
PORT_CASES = (
    Case("serve_pair_axial_384", (*_k1(1536, 8, 384, 384, 64),)),
    Case("serve_msa_column", (*_k1(512, 8, 5, 5, 64),)),
    Case("serve_cross_pair_from_msa", (*_k1(4, 8, 147456, 640, 64),)),
    Case("serve_cross_msa_from_pair", (*_k1(4, 8, 640, 147456, 64),)),
    Case("serve_tied_rows", (*_k2(4, 5, 8, 128, 64),)),
    Case("train_pair_axial_128", (*_k1(128, 8, 128, 128, 64), *_k3(128, 8, 128, 128, 64))),
    Case("train_msa_column", (*_k1(64, 8, 5, 5, 64), *_k3(64, 8, 5, 5, 64))),
    Case("train_msa_row", (*_k1(5, 8, 64, 64, 64), *_k3(5, 8, 64, 64, 64))),
    Case("train_cross_pair_from_msa", (*_k1(1, 8, 16384, 320, 64), *_k3(1, 8, 16384, 320, 64))),
    Case("train_cross_msa_from_pair", (*_k1(1, 8, 320, 16384, 64), *_k3(1, 8, 320, 16384, 64))),
    Case("train_tied_rows", (*_k2(1, 5, 8, 64, 64), *_k2_bwd(1, 5, 8, 64, 64))),
    Case("sparse_train_pair_128", (_k4(128, 8, 128, 64, 16), *_k5(128, 8, 128, 64, 16))),
    Case("sparse_pair_512", (_k4(512, 8, 512, 64, 16), *_k5(512, 8, 512, 64, 16))),
    # the largest instantiations chip_smoke.py checks: head dim 128 (K5b in
    # f32 plans 222,720 of the 232,448 bytes of shared memory), 20 tied rows
    Case("edge_dense_d128", (*_k1(1, 2, 130, 130, 128), *_k3(1, 2, 130, 130, 128))),
    Case("edge_sparse_block128_d128", (_k4(16, 4, 512, 128, 128), *_k5(16, 4, 512, 128, 128))),
    Case("edge_tied_rows_1280", (*_k2(1, 20, 2, 48, 64),)),
    # the wide route's other instantiations: head dims 32 and 128 at 64 and
    # 128 columns a product block
    Case("edge_tied_rows_wide_d32", (*_k2(1, 18, 2, 70, 32), *_k2_bwd(1, 18, 2, 70, 32),
                                     *_k2(4, 18, 8, 128, 32), *_k2_bwd(4, 18, 8, 128, 32))),
    Case("edge_tied_rows_wide_d128", (*_k2(1, 5, 2, 70, 128), *_k2_bwd(1, 5, 2, 70, 128),
                                      *_k2(4, 5, 8, 128, 128), *_k2_bwd(4, 5, 8, 128, 128))),
    # the PLM grid's tied rows (distogram R*D 8192, end to end 12288) and
    # config_4's (R*D 1024): the wide route forward and backward
    Case("plm_tied_rows_8192", (*_k2(1, 128, 8, 128, 64), *_k2_bwd(1, 128, 8, 128, 64))),
    Case("plm_e2e_tied_rows_12288", (*_k2(1, 192, 8, 192, 64), *_k2_bwd(1, 192, 8, 192, 64))),
    Case("config4_tied_rows_1024", (*_k2(1, 16, 8, 128, 64), *_k2_bwd(1, 16, 8, 128, 64))),
    # a head dim past 128: K1 (bf16) and K3a/K3b through K2's kernels as 4
    # rows of 64 (f32 K1 D-chunked); the pair axial pass at dim_head 256
    Case("edge_dense_d256", (*_k1(1, 2, 130, 130, 256), *_k3(1, 2, 130, 130, 256))),
    Case("pair_axial_d256", (*_k1(128, 8, 128, 128, 256), *_k3(128, 8, 128, 128, 256))),
    # K1's packed kernel: the template axis (crop 384, 4 templates), config_4's
    # MSA column pass (MSA 16), and its other instantiations (head dims 32, 128)
    Case("template_axis", (*_k1(384 * 384, 8, 5, 5, 64), *_k3(384 * 384, 8, 5, 5, 64))),
    Case("config4_msa_column", (*_k1(128, 8, 16, 16, 64), *_k3(128, 8, 16, 16, 64))),
    Case("edge_packed_d32", (*_k1(100, 4, 7, 7, 32), *_k3(100, 4, 7, 7, 32))),
    Case("edge_packed_d128", (*_k1(100, 4, 7, 7, 128), *_k3(100, 4, 7, 7, 128))),
    # K2's split route on MSA rows sharded over a mesh, at the shapes the
    # card trains: the MSA rows (R 5, R*D 320) and the PLM grid's (R*D 8192)
    Case("split_msa_rows_320", _k2_split(1, 5, 8, 64, 64)),
    Case("split_plm_rows_8192", _k2_split(1, 128, 8, 128, 64)),
    # the one-pass backward at the other cluster grad_route gives it: the
    # bench step's pair axial pass (crop 256, 2 blocks a cluster; crop 128's
    # passes take 1 above)
    Case("bench_pair_axial_256", (*_k1(256, 8, 256, 256, 64), *_k3(256, 8, 256, 256, 64))),
    # X's valid form at X's shape (f32 only, as X)
    Case("scale_rows_4x512", (_x(4, 512),), dtypes=("float32",)),
)

CASES = JAX_CASES + PORT_CASES + (Case(CONTROL_CASE),)


# --------------------------------------------------------------- ptxas report


@dataclasses.dataclass
class Resources:
    """ptxas's report of one ``__global__`` instantiation."""

    mangled: str
    demangled: str = ""
    registers: int = 0
    barriers: int = 0
    static_smem: int = 0
    stack_frame: int = 0
    spill_stores: int = 0
    spill_loads: int = 0


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPERTIES = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_BARRIERS = re.compile(r"used (\d+) barriers")
_SMEM = re.compile(r"(\d+) bytes smem")
# a C-style cast on a non-type template argument, as cu++filt prints them:
# attention_kernel_mma<(int)64>
_ARG_CAST = re.compile(r"\((?:unsigned |signed )?(?:int|long|long long|short|char|bool)\)")
_SHARED_DATA = re.compile(
    r"Entry function '([^']+)' uses too much shared data "
    r"\((0x[0-9a-fA-F]+) bytes, (0x[0-9a-fA-F]+) max\)")


def parse_ptxas(log: str) -> dict:
    """``{mangled name: Resources}`` for every entry function ptxas
    compiled, from nvcc's ``-Xptxas -v`` output."""
    entries: dict = {}
    frames: dict = {}
    current = pending = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = entries.setdefault(m.group(1), Resources(m.group(1)))
            continue
        m = _PROPERTIES.search(line)
        if m:
            pending = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and pending is not None:
            frames[pending] = tuple(int(g) for g in m.groups())
            pending = None
            continue
        m = _USED.search(line)
        if m and current is not None:
            current.registers = int(m.group(1))
            b = _BARRIERS.search(line)
            current.barriers = int(b.group(1)) if b else 0
            s = _SMEM.search(line)
            current.static_smem = int(s.group(1)) if s else 0
    for name, res in entries.items():
        if name in frames:
            res.stack_frame, res.spill_stores, res.spill_loads = frames[name]
    return entries


def kernel_key(demangled: str) -> str:
    """A demangled ``__global__`` name as the plans name it: no return
    type, namespace, argument list, casts on template arguments or spaces.
    ``void (anonymous namespace)::fwd_kernel<float, (int)16, (int)64>(Fwd,
    int)`` -> ``fwd_kernel<float,16,64>``."""
    s = _ARG_CAST.sub("", demangled.replace("(anonymous namespace)::", ""))
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    parts, depth, start = [], 0, 0  # the last top-level token, then its last scope
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == " " and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    name = s[start:] or (parts[-1] if parts else s)
    depth, start = 0, 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif name.startswith("::", i) and depth == 0:
            start = i + 2
    return name[start:].replace(" ", "")


def cufilt_path() -> Optional[str]:
    """The toolkit's demangler, beside nvcc or on the PATH, or None."""
    nvcc = build.nvcc_path()
    if nvcc is not None:
        beside = Path(nvcc).with_name("cu++filt")
        if beside.exists():
            return str(beside)
    return shutil.which("cu++filt")


def demangle_cufilt(names) -> dict:
    """``{mangled: demangled}`` through ``cu++filt``."""
    names = list(names)
    if not names:
        return {}
    tool = cufilt_path()
    if tool is None:
        raise ToolMissing("cu++filt not found: the gate names kernels with the CUDA toolkit's "
                          "demangler")
    out = subprocess.run([tool, *names], capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    if len(out) != len(names):
        raise RuntimeError(f"cu++filt gave {len(out)} names for {len(names)}")
    return dict(zip(names, out))


def report_by_kernel(log: str, demangle: Callable = demangle_cufilt) -> dict:
    """``{kernel key: Resources}`` of one source's build report."""
    entries = parse_ptxas(log)
    names = demangle(entries)
    for m, res in entries.items():
        res.demangled = names[m]
    return {kernel_key(names[m]): res for m, res in entries.items()}


# --------------------------------------------------------------- limits


def check_launch(plan: dict, resources: Optional[Resources],
                 limits: dict = SM90_LIMITS) -> list:
    """The ways a planned launch breaks sm_90's limits (empty when it
    fits). ``plan``: blocks, threads, dynamic_smem, kernel and, for a
    cluster launch, cluster (blocks a cluster); ``resources``:
    ptxas's report of the planned instantiation, None when the report does
    not list it."""
    problems = []
    blocks, threads = plan["blocks"], plan["threads"]
    if not 1 <= blocks <= limits["max_blocks"]:
        problems.append(f"{blocks} blocks, outside [1, {limits['max_blocks']}]")
    if not 1 <= threads <= limits["max_threads"] or threads % limits["warp"]:
        problems.append(f"{threads} threads a block: at most {limits['max_threads']}, "
                        f"a multiple of {limits['warp']}")
    cluster = plan.get("cluster", 0)
    if cluster > 1 and (cluster > limits["max_cluster"] or blocks % cluster):
        problems.append(f"a cluster of {cluster} blocks over {blocks} blocks: at most "
                        f"{limits['max_cluster']}, dividing the grid")
    if resources is None:
        problems.append(f"instantiation {plan['kernel']} is not in ptxas's report: "
                        "the plan names a kernel that was never built")
        return problems
    smem = resources.static_smem + plan["dynamic_smem"]
    if smem > limits["max_smem_bytes"]:
        problems.append(f"{resources.static_smem} static + {plan['dynamic_smem']} dynamic = "
                        f"{smem} bytes of shared memory > {limits['max_smem_bytes']}")
    if resources.static_smem > limits["max_static_smem_bytes"]:
        problems.append(f"{resources.static_smem} bytes of static shared memory > "
                        f"{limits['max_static_smem_bytes']}")
    if resources.registers > limits["max_registers"]:
        problems.append(f"{resources.registers} registers a thread > {limits['max_registers']}")
    if resources.registers * threads > limits["registers_per_sm"]:
        problems.append(f"{resources.registers} registers x {threads} threads = "
                        f"{resources.registers * threads} > {limits['registers_per_sm']}")
    return problems


def _is_hopper_rejection(returncode: Optional[int], log: str,
                         kernel: str = CONTROL_KERNEL) -> bool:
    """Did nvcc refuse the control for the reason it exists, ptxas's
    shared-data limit on ``kernel``? A timeout (``returncode`` None), a
    build that succeeded, or a failure of any other kind (no nvcc, a C++
    error, a missing header) is not a rejection."""
    if returncode is None or returncode == 0:
        return False
    for m in _SHARED_DATA.finditer(log):
        if kernel in m.group(1) and int(m.group(2), 16) > int(m.group(3), 16):
            return True
    return False


# --------------------------------------------------------------- gate


def _plan(lib, launch: Launch, dtype: str) -> tuple:
    plan = build.LaunchPlan()
    code = getattr(lib, launch.symbol)(*launch.plan_args(dtype), ctypes.byref(plan),
                                       *launch.tail)
    return code, {"blocks": plan.blocks, "threads": plan.threads,
                  "dynamic_smem": plan.dynamic_smem, "kernel": plan.kernel.decode(),
                  "cluster": plan.cluster}


def _launch_record(launch, dtype, built, reports, libs) -> dict:
    rec = {"role": launch.role, "source": launch.source, "dtype": dtype}
    code, log, _ = built[launch.source]
    if code != 0:
        tail = "\n".join(log.strip().splitlines()[-5:])
        rec["problems"] = [f"{launch.source} did not build (nvcc exit {code}): {tail}"]
        return rec
    code, plan = _plan(libs[launch.source], launch, dtype)
    rec.update(plan)
    if code != 0:
        rec["problems"] = [f"{launch.symbol} returned CUDA error {code}"]
        return rec
    report = reports[launch.source]
    res = report.get(plan["kernel"])
    if res is not None:
        rec.update(demangled=res.demangled, registers=res.registers, barriers=res.barriers,
                   static_smem=res.static_smem, stack_frame=res.stack_frame,
                   spill_stores=res.spill_stores, spill_loads=res.spill_loads)
    rec["problems"] = check_launch(plan, res)
    if res is None:
        base = plan["kernel"].split("<")[0]
        rec["problems"].append(f"the report lists {sorted(k for k in report if k.startswith(base))[:4]}")
    return rec


def run_control(out_dir: Optional[Path] = None) -> dict:
    """Compile the mis-tiled control; its record, ``ok`` when ptxas
    refused it for its shared data."""
    t0 = time.monotonic()
    out_dir = out_dir or build.BUILD_DIR.parent / "hopper_gate"
    code, log = build.compile_source(build.MISTILED, out_dir)
    rejected = _is_hopper_rejection(code, log)
    rec = {"case": CONTROL_CASE, "ok": rejected, "status": "ok" if rejected else "failed",
           "nvcc_exit": code, "rejected": rejected}
    m = _SHARED_DATA.search(log)
    if m:
        rec["refusal"] = m.group(0)
    if not rejected:
        rec["error"] = ("the mis-tiled control BUILT: the gate is not checking shared memory"
                        if code == 0 else
                        "nvcc failed for another reason than ptxas's shared-data limit: "
                        + "\n".join(log.strip().splitlines()[-5:]))
    rec["seconds"] = round(time.monotonic() - t0, 1)
    return rec


def run_gate(names=(), demangle: Callable = demangle_cufilt) -> tuple:
    """Run the named cases (all when empty). Returns (records, summary).
    Raises :class:`ToolMissing` when nvcc is not installed."""
    if build.nvcc_path() is None:
        raise ToolMissing("nvcc not found: the gate builds the kernels with the CUDA toolkit "
                          "and certifies nothing without a build")
    run = [c for c in CASES if not names or c.name in names]
    sources = sorted({launch.source for c in run for launch in c.launches})
    built = build.build_sources(sources) if sources else {}
    reports = {s: report_by_kernel(log, demangle)
               for s, (code, log, _) in built.items() if code == 0}
    libs = {s: build.library(s) for s in reports}
    records = []
    for case in run:
        if case.name == CONTROL_CASE:
            records.append(run_control())
            continue
        launches = [_launch_record(launch, dtype, built, reports, libs)
                    for dtype in case.dtypes for launch in case.launches
                    if dtype in launch.dtypes]
        ok = not any(rec["problems"] for rec in launches)
        warnings = [f"{r['role']} {r['dtype']} {r['kernel']}: {r['spill_stores']} bytes spill "
                    f"stores, {r['spill_loads']} bytes spill loads"
                    for r in launches if r.get("spill_stores") or r.get("spill_loads")]
        rec = {"case": case.name, "ok": ok, "status": "ok" if ok else "failed",
               "launches": launches}
        if warnings:
            rec["warning"] = warnings
        records.append(rec)
    summary = {
        "gate": GATE, "cases": len(records),
        "failed": [r["case"] for r in records if r["status"] == "failed"],
        "control_rejected": any(r["case"] == CONTROL_CASE and r["ok"] for r in records),
    }
    return records, summary


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv)
    unknown = sorted(set(names) - {c.name for c in CASES})
    if unknown:
        print(json.dumps({"gate": GATE, "error": f"unknown case name(s): {unknown}",
                          "known": [c.name for c in CASES]}), flush=True)
        return 2
    try:
        records, summary = run_gate(names)
    except ToolMissing as e:
        print(json.dumps({"gate": GATE, "error": str(e)}), flush=True)
        return 2
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps(summary), flush=True)
    control_ran = any(r["case"] == CONTROL_CASE for r in records)
    return 1 if summary["failed"] or (control_ran and not summary["control_rejected"]) else 0


if __name__ == "__main__":
    sys.exit(main())
