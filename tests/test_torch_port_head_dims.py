"""Head dims the kernels are not built for, on the CPU: the route of
ops/cuda/axial.py (``kernel_head_dim``, ``pad_head_dim``,
``at_kernel_head_dim``) with the plain kernels injected, against JAX's
``fused_attention`` (Pallas, interpret mode, as tests/test_pallas_kernels.py
runs it) and its ``jax.grad``.

At head dim 48 the operands are zero-padded to 64 and the results sliced
back, with the caller's sm_scale (from 48); at 256 the D-chunked kernels
take the head dim as it is. Tolerance 1e-4, the bound
tests/test_pallas_kernels.py uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu_torch.ops.cuda import axial

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(d, seed=4):
    b, h, nq, nk = 2, 2, 19, 23
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    qm = np.ones((b, nq), bool)
    qm[1, 15:] = False
    km = np.ones((b, nk), bool)
    km[0, 20:] = False
    return q, k, v, do, qm, km


def test_kernel_head_dims():
    assert [axial.kernel_head_dim(d) for d in (8, 16, 24, 32, 48, 64, 96, 100, 128)] == [
        16, 16, 32, 32, 64, 64, 128, 128, 128]
    assert [axial.kernel_head_dim(d) for d in (129, 200, 256, 320)] == [129, 200, 256, 320]


def test_pad_head_dim_is_one_zero_buffer_in_the_projection_layout():
    t = torch.randn(2, 3, 5, 48)
    p = axial.pad_head_dim(t, 64)
    assert p.shape == (2, 3, 5, 64) and p.stride() == (5 * 3 * 64, 64, 3 * 64, 1)
    assert torch.equal(p[..., :48], t) and (p[..., 48:] == 0).all()


def _seen(fn, seen):
    def run(*tensors):
        seen.append(tensors[0].shape[-1])
        return fn(*tensors)
    return run


@pytest.mark.parametrize("d", [48, 256])
def test_forward_at_the_kernel_head_dim_matches_jax(d):
    q, k, v, _, qm, km = _problem(d)
    scale = d**-0.5
    ref = np.asarray(jax_fused(*(jnp.asarray(a) for a in (q, k, v)), q_mask=jnp.asarray(qm),
                               kv_mask=jnp.asarray(km), sm_scale=scale))
    t = torch.from_numpy
    seen = []
    out, lse = axial.at_kernel_head_dim(
        _seen(lambda q, k, v: axial.fused_attention_lse_reference(q, k, v, t(qm), t(km), scale),
              seen), (t(q), t(k), t(v)))
    assert seen == [axial.kernel_head_dim(d)] and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    _, lse_d = axial.fused_attention_lse_reference(t(q), t(k), t(v), t(qm), t(km), scale)
    torch.testing.assert_close(lse, lse_d, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [48, 256])
def test_backward_at_the_kernel_head_dim_matches_jax_grad(d):
    q, k, v, do, qm, km = _problem(d)
    scale = d**-0.5

    def loss(q, k, v):
        out = jax_fused(q, k, v, q_mask=jnp.asarray(qm), kv_mask=jnp.asarray(km),
                        sm_scale=scale)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    t = torch.from_numpy
    tq, tk, tv, tdo, tqm, tkm = (t(a) for a in (q, k, v, do, qm, km))
    out, lse = axial.fused_attention_lse_reference(tq, tk, tv, tqm, tkm, scale)
    dsum = axial.attention_dsum(out, tdo)
    seen = []
    dq = axial.at_kernel_head_dim(_seen(
        lambda q, k, v, do: axial.fused_attention_dq_reference(q, k, v, do, lse, dsum, tqm,
                                                               tkm, scale), seen),
        (tq, tk, tv, tdo))
    dk, dv = axial.at_kernel_head_dim(_seen(
        lambda q, k, v, do: axial.fused_attention_dkv_reference(q, k, v, do, lse, dsum, tqm,
                                                                tkm, scale), seen),
        (tq, tk, tv, tdo))
    assert seen == [axial.kernel_head_dim(d)] * 2
    for got, want in zip((dq, dk, dv), ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
