"""The port's kernel wrappers on CPU tensors, against the JAX kernels.

alphafold2_tpu_torch/ops/cuda/{axial,tied_row}.py run their plain PyTorch
versions for CPU tensors (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions). Here the plain
versions are held against the JAX package's Pallas kernels, run in
interpret mode on the CPU as tests/test_pallas_kernels.py runs them, on
that file's masked / padded / odd / rectangular / fully masked cases.
Tolerance 1e-5 on valid rows: both sides compute in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu.ops.pallas.tied_row import tied_row_attention as jax_tied
from alphafold2_tpu_torch.ops.cuda import axial, build, tied_row

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tail_mask(b, n, drop):
    m = np.ones((b, n), bool)
    m[:, max(1, n - drop):] = False
    return m


@pytest.mark.parametrize(
    "shape,q_drop,kv_drop,dead_batch",
    [
        ((2, 2, 128, 128, 32), 3, 7, False),  # one-block tiles, masked tails
        ((1, 2, 200, 200, 16), 3, 7, False),  # odd length: padded keys
        ((2, 1, 37, 91, 8), 3, 7, False),  # rectangular (cross-shaped)
        ((1, 2, 160, 160, 32), 0, 0, False),  # no masks at all
        ((2, 1, 64, 64, 8), 0, 0, True),  # one batch entry with every key masked
    ],
)
def test_fused_attention_plain_matches_jax(shape, q_drop, kv_drop, dead_batch):
    b, h, nq, nk, d = shape
    rng = np.random.default_rng(1)
    q, k, v = _np(rng, (b, h, nq, d)), _np(rng, (b, h, nk, d)), _np(rng, (b, h, nk, d))
    q_mask = _tail_mask(b, nq, q_drop) if q_drop else None
    kv_mask = _tail_mask(b, nk, kv_drop) if kv_drop else None
    if dead_batch:
        kv_mask = np.ones((b, nk), bool)
        kv_mask[0] = False
    ref = np.asarray(jax_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_mask=None if q_mask is None else jnp.asarray(q_mask),
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        sm_scale=d**-0.5,
    ))
    t = torch.from_numpy
    out = axial.fused_attention(
        t(q), t(k), t(v),
        q_mask=None if q_mask is None else t(q_mask),
        kv_mask=None if kv_mask is None else t(kv_mask),
        sm_scale=d**-0.5,
    ).numpy()
    assert out.shape == ref.shape
    valid = np.ones((b, nq), bool) if q_mask is None else q_mask.copy()
    if kv_mask is not None:
        valid &= kv_mask.any(-1)[:, None]
    err = np.abs(out - ref) * valid[:, None, :, None]
    assert err.max() < ATOL
    assert np.isfinite(out).all()
    # rows with no valid key are exactly 0 (the TPU kernel left a finite
    # average over its padded block there; every caller masks such rows)
    assert (out.transpose(0, 2, 1, 3)[~valid] == 0).all()


def _tied_inputs(shape, ragged, masked, seed=0):
    """tests/test_pallas_kernels.py tied_inputs, drawn with numpy."""
    b, r, n, h, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (_np(rng, shape) for _ in range(3))
    if not masked:
        return q, k, v, None, None, float(r) ** -0.5
    rows = np.ones((b, r, n), bool)
    rows[:, :, max(1, n - 5):] = False
    if ragged:
        rows[:, 1] = False
    q, k, v = (np.where(rows[..., None, None], t, 0).astype(np.float32) for t in (q, k, v))
    n_rows = np.maximum(rows.any(-1).sum(-1), 1)
    tie = (n_rows.astype(np.float32) ** -0.5)
    return q, k, v, rows.any(1), rows.any(1), tie


@pytest.mark.parametrize(
    "shape,ragged,masked",
    [
        ((2, 3, 24, 2, 16), False, True),  # column padding
        ((1, 5, 140, 2, 8), False, True),  # odd length, padded blocks
        ((2, 4, 33, 1, 8), True, True),  # a fully masked row abstains
        ((1, 4, 48, 2, 8), False, False),  # no masks at all
    ],
)
def test_tied_row_plain_matches_jax(shape, ragged, masked):
    q, k, v, qm, km, tie = _tied_inputs(shape, ragged, masked)
    d = shape[-1]
    j = lambda a: None if a is None else jnp.asarray(a)
    jax_tie = tie if np.isscalar(tie) else jnp.asarray(tie)[:, None, None, None]
    ref = np.asarray(jax_tied(j(q), j(k), j(v), q_mask=j(qm), kv_mask=j(km),
                              sm_scale=d**-0.5, tie_scale=jax_tie))
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    out = tied_row.tied_row_attention(
        t(q), t(k), t(v), q_mask=t(qm), kv_mask=t(km), sm_scale=d**-0.5,
        tie_scale=tie if np.isscalar(tie) else t(tie),
    ).numpy()
    valid = (np.ones(ref.shape, bool) if qm is None
             else np.broadcast_to(qm[:, None, :, None, None], ref.shape))
    assert np.abs(np.where(valid, out - ref, 0)).max() < ATOL


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    """CPU tensors run the plain versions; the kernel launch counts stay
    0 and no library is built or loaded."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_np(rng, (1, 2, 9, 16)))
    qt = torch.from_numpy(_np(rng, (1, 3, 9, 2, 16)))
    before = (axial.fused_attention_reference.calls,
              tied_row.tied_row_attention_reference.calls)
    launches = (axial.fused_attention.launches, tied_row.tied_row_attention.launches)
    axial.fused_attention(q, q, q, sm_scale=0.25)
    tied_row.tied_row_attention(qt, qt, qt, sm_scale=0.25)
    assert axial.fused_attention_reference.calls == before[0] + 1
    assert tied_row.tied_row_attention_reference.calls == before[1] + 1
    assert (axial.fused_attention.launches,
            tied_row.tied_row_attention.launches) == launches == (0, 0)
    assert build._libraries == {}


def test_wrappers_reject_bad_operands():
    q = torch.zeros((1, 2, 9, 16))
    with pytest.raises(ValueError):
        axial.fused_attention(q, q[:, :1], q)  # head count mismatch
    with pytest.raises(TypeError):
        axial.fused_attention(q, q, q.double())
    with pytest.raises(ValueError):
        axial.fused_attention(q, q, q, kv_mask=torch.ones((1, 9)))  # not bool
    meta = torch.zeros((1, 2, 9, 16), device="meta")
    with pytest.raises(ValueError):
        axial.fused_attention(meta, meta, meta)  # neither cuda nor cpu
    qt = torch.zeros((1, 3, 9, 2, 16))
    with pytest.raises(ValueError):
        tied_row.tied_row_attention(qt, qt[:, :2], qt[:, :2])
    with pytest.raises(ValueError):
        tied_row.tied_row_attention(qt, qt, qt, tie_scale=torch.ones(3))


def test_build_targets_hopper_and_hashes_sources():
    assert build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    # every kernel source, and X's valid counterpart; never the mis-tiled control
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")} | {"scale_rows"}
    assert build.MISTILED.stem not in build.SIGNATURES and build.MISTILED.exists()
    assert build.source("scale_rows") == build.CONTROLS / "scale_rows.cu"
    paths = {build._library_path(n) for n in build.SIGNATURES}
    # K1, K3a/K3b, K2, K2's backward, K4, K5a/K5b and X: seven sources, one
    # library each
    assert len(paths) == 7 and all(p.parent == build.BUILD_DIR for p in paths)
