"""K3's one-pass backward and the dsum pass, on the CPU: the plain versions
``fused_attention_bwd_reference`` and ``attention_dsum_reference`` in
alphafold2_tpu_torch/ops/cuda/axial.py held against ``jax.grad`` of the JAX
package's ``fused_attention`` (run on the CPU as
tests/test_torch_port_k3_split.py runs it) and against JAX's rowsum at
alphafold2_tpu/ops/pallas/axial.py:417-418; ``grad_route``, the rule that
sends a shape to the one-pass kernel or to K3a/K3b; and the autograd
Functions, which on the CPU run the plain version of the route. Tolerance
1e-4 on valid rows: every side computes in f32. The card's kernels are held
against the same plain versions by chip_smoke.py."""

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


def _case(nk, seed, b=2, h=2, nq=37, d=16):
    """Operands, the cotangents of out (w) and of lse (u), and masks: the
    last 3 queries masked, batch 0's last 4 keys masked, batch 1 with no
    valid key (every query row of it dead)."""
    rng = np.random.default_rng(seed)
    q, w = (rng.standard_normal((b, h, nq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    u = rng.standard_normal((b, h, nq)).astype(np.float32)
    q_mask = np.ones((b, nq), bool)
    q_mask[:, nq - 3:] = False
    kv_mask = np.ones((b, nk), bool)
    kv_mask[0, max(1, nk - 4):] = False
    kv_mask[1] = False
    return q, k, v, w, u, q_mask, kv_mask


def _jax_grads(q, k, v, w, u, q_mask, kv_mask, scale):
    """dq, dk, dv of sum(fused_attention(q, k, v) * w) + sum(lse * u), the
    row logsumexp of the scaled logits over the valid keys written in jnp
    (JAX's fused_attention returns no lse); u is 0 on the rows the port
    leaves out (masked queries, rows with no valid key)."""
    qm, km = jnp.asarray(q_mask), jnp.asarray(kv_mask)

    def loss(q, k, v):
        o = jax_fused(q, k, v, q_mask=qm, kv_mask=km, sm_scale=scale)
        s = jnp.einsum("bhid,bhjd->bhij", q, k) * scale
        s = jnp.where(km[:, None, None, :], s, -1e30)
        lse = jax.scipy.special.logsumexp(s, axis=-1)
        return jnp.sum(o * w) + jnp.sum(lse * u)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("nk", [5, 128, 129, 300, 1024])
def test_onepass_reference_matches_jax_grad(nk, with_dlse):
    q, k, v, w, u, q_mask, kv_mask = _case(nk, seed=nk + with_dlse)
    live = q_mask & kv_mask.any(-1)[:, None]  # query rows the port attends
    u = u * live[:, None, :] if with_dlse else np.zeros_like(u)
    scale = q.shape[-1] ** -0.5
    jdq, jdk, jdv = _jax_grads(q, k, v, w, u, q_mask, kv_mask, scale)

    t = torch.from_numpy
    qm, km = t(q_mask), t(kv_mask)
    out, lse = axial.fused_attention_lse_reference(t(q), t(k), t(v), qm, km, scale)
    dsum = axial.attention_dsum_reference(out, t(w), lse, t(u) if with_dlse else None)
    args = (t(q), t(k), t(v), t(w), lse, dsum, qm, km, scale)
    calls = axial.fused_attention_bwd_reference.calls
    dq, dk, dv = (x.numpy() for x in axial.fused_attention_bwd_reference(*args))
    assert axial.fused_attention_bwd_reference.calls == calls + 1

    assert np.abs((dq - jdq) * live[:, None, :, None]).max() < ATOL
    keys = kv_mask & live.any(-1)[:, None]  # JAX lets a key-less row average its padded block
    for port, ref in ((dk, jdk), (dv, jdv)):
        assert np.abs((port - ref) * keys[:, None, :, None]).max() < ATOL
    # masked queries and key-less rows get dq = 0, masked keys dk = dv = 0, exactly
    assert (dq.transpose(0, 2, 1, 3)[~live] == 0).all()
    assert (dk.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()
    assert (dv.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()
    # the one pass equals the split route's plain versions on the same dsum
    whole_dq = axial.fused_attention_dq_reference(*args).numpy()
    whole_dk, whole_dv = (x.numpy() for x in axial.fused_attention_dkv_reference(*args))
    for one, whole in ((dq, whole_dq), (dk, whole_dk), (dv, whole_dv)):
        assert np.abs(one - whole).max() < 1e-5


def test_onepass_reference_sums_dq_by_key_tile_in_order():
    """dq is the sum of each 128-key tile's ds K in tile order (the kernel's
    cluster ranks), then times sm_scale."""
    q, k, v, w, _, q_mask, kv_mask = _case(300, seed=4)
    t = torch.from_numpy
    qm, km = t(q_mask), t(kv_mask)
    out, lse = axial.fused_attention_lse_reference(t(q), t(k), t(v), qm, km, 0.3)
    args = (t(q), t(k), t(v), t(w), lse, axial.attention_dsum_reference(out, t(w)), qm, km, 0.3)
    tiles = axial.dq_partials_reference(*args, splits=3, block=axial.ONEPASS_KEY_TILE)
    want = (0.3 * ((tiles[0] + tiles[1]) + tiles[2])).to(torch.float32)
    assert torch.equal(axial.fused_attention_bwd_reference(*args)[0], want)


def test_dsum_reference_matches_jax_rowsum_and_the_lse_shift():
    """rowsum(dO * O) as JAX computes it (axial.py:417-418), less dlse
    where lse is finite, 0 where it is +inf; bf16 operands sum in f32."""
    rng = np.random.default_rng(5)
    b, h, nq, d = 2, 3, 11, 16
    out, g = (rng.standard_normal((b, h, nq, d)).astype(np.float32) for _ in range(2))
    lse = rng.standard_normal((b, h, nq)).astype(np.float32)
    lse[0, 1, 3:] = np.inf
    dlse = rng.standard_normal((b, h, nq)).astype(np.float32)
    jax_dsum = np.asarray(jnp.sum(jnp.asarray(out).astype(jnp.float32)
                                  * jnp.asarray(g).astype(jnp.float32), axis=-1))
    t = torch.from_numpy
    plain = axial.attention_dsum_reference(t(out), t(g)).numpy()
    np.testing.assert_allclose(plain, jax_dsum, rtol=1e-6, atol=1e-6)
    shifted = axial.attention_dsum_reference(t(out), t(g), t(lse), t(dlse)).numpy()
    want = np.where(np.isfinite(lse), jax_dsum - dlse, 0.0)
    np.testing.assert_allclose(shifted, want, rtol=1e-6, atol=1e-6)
    assert (shifted[~np.isfinite(lse)] == 0).all()
    bf = axial.attention_dsum_reference(t(out).bfloat16(), t(g).bfloat16())
    assert bf.dtype == torch.float32
    # the wrapper on CPU tensors: the plain version, no launch
    launches = axial.attention_dsum.launches
    assert torch.equal(axial.attention_dsum(t(out), t(g), t(lse), t(dlse)), t(shifted))
    assert axial.attention_dsum.launches == launches
    with pytest.raises(ValueError):
        axial.attention_dsum(t(out), t(g), None, t(dlse))  # dlse without lse


# (b, h, nq, nk, d) of the bench step's passes, the template axis, config_3's
# compressed pass, crop 128's training passes and the edges of the rule, with
# the route and the cluster the kernel would take (0: it does not take it)
ROUTES = {
    "pair axial, crop 256": ((256, 8, 256, 256, 64), "onepass", 2),
    "MSA column, MSA 16": ((256, 8, 16, 16, 64), "onepass", 1),
    "pair<-MSA, crop 256": ((1, 8, 65536, 4096, 64), "split", 0),
    "MSA<-pair, crop 256": ((1, 8, 4096, 65536, 64), "split", 0),
    "template axis": ((384 * 384, 8, 5, 5, 64), "onepass", 1),
    "compressed pair<-MSA": ((1, 8, 512 * 512, 342, 64), "split", 0),
    "pair axial, crop 128": ((128, 8, 128, 128, 64), "onepass", 1),
    "MSA row, crop 128": ((5, 8, 64, 64, 64), "onepass", 1),
    "pair<-MSA, crop 128": ((1, 8, 16384, 320, 64), "split", 0),
    "MSA<-pair, crop 128": ((1, 8, 320, 16384, 64), "split", 0),
    "pair axial, crop 384": ((384, 8, 384, 384, 64), "split", 0),
    "2 blocks, 2 query tiles (a tie, measured)": ((256, 8, 128, 256, 64), "split", 2),
    "2 blocks, 3 query tiles": ((256, 8, 150, 256, 64), "onepass", 2),
    "257 keys, 3 blocks": ((64, 8, 256, 257, 64), "split", 0),
    "512 keys (a cluster of 4 lost 2x, measured)": ((64, 8, 256, 512, 64), "split", 0),
    "1,024 keys (a cluster of 8 lost 2.6x, measured)": ((32, 8, 256, 1024, 64), "split", 0),
    "head dim 32, 960 queries, 256 keys": ((2, 2, 960, 256, 32), "onepass", 2),
    "head dim 32, 961 queries, 256 keys": ((2, 2, 961, 256, 32), "split", 0),
    "head dim 128 (its registers do not fit)": ((1, 2, 1000, 128, 128), "split", 0),
    "head dim 128, 130 keys": ((1, 2, 130, 130, 128), "split", 0),
    "head dim 48 (padded to 64)": ((2, 2, 40, 40, 48), "onepass", 1),
    "head dim 16": ((2, 2, 40, 40, 16), "split", 0),
    "head dim 256": ((128, 8, 128, 128, 256), "split", 0),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_grad_route_on_the_main_path_and_its_edges(name):
    shape, route, cluster = ROUTES[name]
    assert axial.grad_route(*shape) == route
    b, h, nq, nk, d = shape
    d = axial.kernel_head_dim(d)
    assert axial.onepass_cluster(nq, nk, d) == cluster
    if cluster:
        # one block of 128 keys a key tile, at most 2; with 2, every query
        # tile's dq resident
        assert cluster <= axial.ONEPASS_MAX_CLUSTER == 2
        assert cluster * axial.ONEPASS_KEY_TILE >= nk > (cluster - 1) * axial.ONEPASS_KEY_TILE
        assert cluster == 1 or -(-nq // axial.GRAD_TILE) <= axial.ONEPASS_RESIDENT_TILES[d]
    if route == "onepass":  # one block, or two over 3-4 query tiles
        assert cluster == 1 or (cluster == 2 and -(-nq // axial.GRAD_TILE) >= 3)


@pytest.mark.parametrize("d,lse_out", [(32, False), (64, True), (16, False), (16, True)])
def test_cpu_autograd_takes_the_plain_version_of_the_route(d, lse_out):
    """The autograd Functions on the CPU run the route's plain versions: the
    one-pass backward where grad_route says so (head dim 32, 64), K3a and
    K3b elsewhere (head dim 16); the gradients equal the plain one-pass
    backward's on the same dsum, and no kernel launches."""
    rng = np.random.default_rng(d)
    b, h, nq, nk = 2, 2, 21, 120
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
               .requires_grad_() for n in (nq, nk, nk))
    w = torch.from_numpy(rng.standard_normal((b, h, nq, d)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((b, h, nq)).astype(np.float32))
    q_mask = torch.ones((b, nq), dtype=torch.bool)
    q_mask[1, -4:] = False
    kv_mask = torch.ones((b, nk), dtype=torch.bool)
    kv_mask[0, 100:] = False
    counts = lambda: (axial.fused_attention_bwd_reference.calls,  # noqa: E731
                      axial.fused_attention_dq_reference.calls,
                      axial.fused_attention_dkv_reference.calls,
                      axial.fused_attention_bwd.launches, axial.attention_dsum.launches)
    before = counts()
    if lse_out:
        out, lse = axial.fused_attention_lse(q, k, v, q_mask, kv_mask, 0.25)
        loss = (out * w).sum() + (torch.where(torch.isfinite(lse), lse, 0.0) * u).sum()
    else:
        out = axial.fused_attention(q, k, v, q_mask, kv_mask, 0.25)
        loss = (out * w).sum()
    loss.backward()
    onepass = axial.grad_route(b, h, nq, nk, d) == "onepass"
    assert onepass == (d != 16)
    assert counts() == tuple(c + n for c, n in zip(
        before, (1, 0, 0, 0, 0) if onepass else (0, 1, 1, 0, 0)))
    with torch.no_grad():
        o, lse = axial.fused_attention_lse_reference(q, k, v, q_mask, kv_mask, 0.25)
        dlse = torch.where(torch.isfinite(lse), u, 0.0) if lse_out else None
        dsum = axial.attention_dsum_reference(o, w, lse, dlse)
        want = axial.fused_attention_bwd_reference(q, k, v, w, lse, dsum, q_mask, kv_mask, 0.25)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.allclose(got, ref, atol=1e-5, rtol=0)


def test_cpu_onepass_wrapper_takes_its_plain_version():
    rng = np.random.default_rng(9)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 2, n, 32)).astype(np.float32))
                  for n in (9, 20, 20, 9))
    out, lse = axial.fused_attention_lse_reference(q, k, v, None, None, 0.5)
    args = (q, k, v, w, lse, axial.attention_dsum(out, w, lse), None, None, 0.5)
    launches = axial.fused_attention_bwd.launches
    got = axial.fused_attention_bwd(*args)
    ref = axial.fused_attention_bwd_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert axial.fused_attention_bwd.launches == launches
    assert axial.attention_bwd_flops(1, 2, 9, 20, 32) == 10.0 * 2 * 9 * 20 * 32
