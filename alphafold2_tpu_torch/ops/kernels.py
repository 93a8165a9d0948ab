"""KernelPolicy: one switchboard for every attention route of the port.

Port of ``alphafold2_tpu/ops/kernels.py``: the same four fields with the
same choices, the same spec syntax, ``describe`` and errors, so a spec
written for the JAX package parses here. One policy object answers which
implementation serves each attention shape, selected per process
(``AF2TPU_KERNELS``), per engine (``ServeConfig.kernels``) or per call
(:func:`use_kernel_policy`, thread-local), and its description keys the
serving engine's executables and compile records, so ``observe/regress.py``
refuses to compare records across policies.

What each choice runs (every field defaults to ``"auto"``):

- ``axial`` (``Attention.grid_axial``: the pair axial passes): ``auto`` and
  ``pallas`` K1 (``ops/cuda/axial.py fused_attention``); ``stock``
  ``torch.nn.functional.scaled_dot_product_attention`` with the boolean
  mask; ``dense`` K1's plain version (``fused_attention_reference``).
- ``flash`` (the flat self and cross passes of ``Attention``): ``auto`` K1;
  ``on`` SDPA (JAX's "stock kernel" there is its library flash kernel);
  ``off`` the plain version. A module's explicit ``use_flash`` bool
  (``model.flash_attention``) wins, as JAX's does.
- ``tied_row`` (``Attention`` with ``tie_dim``): ``auto`` and ``pallas`` K2
  (``ops/cuda/tied_row.py tied_row_attention``); ``dense`` its plain version.
- ``block_sparse`` (``SparseAttention``): ``auto`` and ``pallas`` K4 with
  K5a/K5b (``ops/cuda/block_sparse.py``); ``jnp`` the plain gather version;
  ``splash`` SDPA with the layout's dense boolean mask. A non-``auto``
  ``BlockSparseConfig.backend`` wins.

``auto`` differs from JAX's in one place: JAX resolves ``axial=auto`` to
its stock kernel, the port to K1, which has stood in for JAX's stock flash
kernel since the port began. On the CPU the kernel routes (``auto``,
``pallas``) run the wrappers' plain versions, as always; ``stock``, ``on``
and ``splash`` run SDPA there too, so every route runs in the CPU tests.

Spec syntax::

    AF2TPU_KERNELS="tied_row=pallas,axial=pallas"
    AF2TPU_KERNELS="flash=off,block_sparse=jnp"

JAX consults the policy at trace time. The port is eager, so every
attention call reads it on the thread that launches: a serving engine
activates its own policy inside its forward, which runs on the pipeline's
device worker (``serve/engine.py``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from contextlib import contextmanager
from typing import Optional

_CHOICES = {
    "tied_row": ("auto", "pallas", "dense"),
    "axial": ("auto", "pallas", "stock", "dense"),
    "flash": ("auto", "on", "off"),
    "block_sparse": ("auto", "pallas", "jnp", "splash"),
}

ENV_VAR = "AF2TPU_KERNELS"


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which implementation serves each attention shape (module docstring)."""

    tied_row: str = "auto"
    axial: str = "auto"
    flash: str = "auto"
    block_sparse: str = "auto"

    def __post_init__(self):
        for field, choices in _CHOICES.items():
            value = getattr(self, field)
            if value not in choices:
                raise ValueError(f"kernel policy {field}={value!r}; choices: {choices}")

    def describe(self) -> str:
        """The non-default fields as ``field=value`` comma-joined, or
        ``"auto"`` when every field is: the identity records and keys carry."""
        parts = [f"{f}={getattr(self, f)}" for f in _CHOICES if getattr(self, f) != "auto"]
        return ",".join(parts) if parts else "auto"


def parse_policy(spec: Optional[str]) -> KernelPolicy:
    """``"tied_row=pallas,axial=dense"`` -> KernelPolicy; empty, None or
    ``"auto"`` -> the all-auto policy. An unknown field or value raises: a
    mistyped kernel selection must be loud, never a quiet fallback."""
    if not spec or spec.strip() == "auto":
        return KernelPolicy()
    fields: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, value = item.partition("=")
        if not sep or name not in _CHOICES:
            raise ValueError(f"bad kernel policy entry {item!r} in {spec!r}; known "
                             f"fields: {sorted(_CHOICES)}")
        fields[name] = value.strip()
    return KernelPolicy(**fields)


class _ThreadState(threading.local):
    policy: Optional[KernelPolicy] = None


_STATE = _ThreadState()
_ENV_CACHE: dict = {}


def policy_from_env() -> KernelPolicy:
    """The process-wide policy, ``$AF2TPU_KERNELS`` (all-auto when unset)."""
    spec = os.environ.get(ENV_VAR, "")
    hit = _ENV_CACHE.get(spec)
    if hit is None:
        hit = _ENV_CACHE[spec] = parse_policy(spec)
    return hit


def current_policy() -> KernelPolicy:
    """The policy active on this thread: a :func:`use_kernel_policy`
    context wins, else the process-wide ``AF2TPU_KERNELS`` policy."""
    pol = _STATE.policy
    return pol if pol is not None else policy_from_env()


@contextmanager
def use_kernel_policy(policy: Optional[KernelPolicy]):
    """Activate ``policy`` for the attention calls of this thread (None:
    nothing changes). Other threads keep theirs."""
    if policy is None:
        yield
        return
    prev = _STATE.policy
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


# ------------------------------------------------------------- resolution


def resolve_tied_row(policy: Optional[KernelPolicy] = None) -> str:
    """``"pallas"`` (K2) or ``"dense"`` (its plain version) for tied MSA
    rows; ``auto`` is K2."""
    choice = (policy or current_policy()).tied_row
    return "pallas" if choice == "auto" else choice


def resolve_axial(policy: Optional[KernelPolicy] = None) -> str:
    """``"pallas"`` (K1), ``"stock"`` (SDPA) or ``"dense"`` (K1's plain
    version) for the grid axial passes; ``auto`` is K1."""
    choice = (policy or current_policy()).axial
    return "pallas" if choice == "auto" else choice


def resolve_flash(policy: Optional[KernelPolicy] = None,
                  use_flash: Optional[bool] = None) -> str:
    """The route of the flat self and cross passes, as :func:`resolve_axial`
    names routes: ``flash=auto`` K1 (``"pallas"``), ``on`` SDPA
    (``"stock"``), ``off`` the plain version (``"dense"``). An explicit
    ``use_flash`` bool wins over the policy, as JAX's module field does.
    (JAX's function returns whether its stock kernel may run; the port has
    three routes where JAX has two.)"""
    if use_flash is not None:
        return "stock" if use_flash else "dense"
    choice = (policy or current_policy()).flash
    return {"auto": "pallas", "on": "stock", "off": "dense"}[choice]


def resolve_block_sparse(policy: Optional[KernelPolicy] = None) -> str:
    """``"pallas"`` (K4/K5), ``"jnp"`` (the plain gather version) or
    ``"splash"`` (SDPA with the layout mask) for ``SparseAttention``'s
    remaining auto case; ``auto`` is K4/K5."""
    choice = (policy or current_policy()).block_sparse
    return "pallas" if choice == "auto" else choice
