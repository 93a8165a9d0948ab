"""K3's split over the long loop, on the CPU: the plain versions of the
per-split partials of K3a (dq over each key range) and K3b (dk, dv over each
query range) and of their merge in alphafold2_tpu_torch/ops/cuda/axial.py,
held against ``jax.grad`` of the JAX package's ``fused_attention`` (run on
the CPU as tests/test_torch_port_train.py runs it); ``grad_splits``, the rule
that decides where the card's kernels split; and the merge wrapper, which on
the CPU takes its plain version. Tolerance 1e-5 on valid rows: every side
computes in f32. The card's kernels are held against the same plain versions
by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu_torch.ops.cuda import axial

ATOL = 1e-5
BLOCK = 16  # rows per tile here, so a few dozen tokens make several splits


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _masks(b, nq, nk, case):
    """(q_mask, kv_mask) as numpy bool arrays for one named case."""
    q_mask = np.ones((b, nq), bool)
    q_mask[:, nq - 3:] = False
    kv_mask = np.ones((b, nk), bool)
    if case == "ragged tails":
        kv_mask[0, nk - 7:] = False
        kv_mask[1, nk - 1:] = False
        q_mask[1, nq - 5:] = False
    elif case == "splits with all keys or queries masked":
        # whole tiles: every S > 1 has a dead key split (K3a) and a dead
        # query split (K3b)
        kv_mask[:, BLOCK:4 * BLOCK] = False
        q_mask[:, BLOCK:4 * BLOCK] = False
    elif case == "fully masked batch row":
        kv_mask[0] = False  # every query row of batch 0 has no valid key
    return q_mask, kv_mask


CASES = {  # name: (b, h, nq, nk, d)
    "ragged tails": (2, 2, 37, 91, 16),
    "splits with all keys or queries masked": (2, 1, 96, 96, 8),
    "fully masked batch row": (2, 2, 33, 50, 8),
}


def _jax_grads(q, k, v, w, q_mask, kv_mask, scale):
    """dq, dk, dv of sum(fused_attention(q, k, v) * w): the cotangent dO is w."""

    def loss(q, k, v):
        o = jax_fused(q, k, v, q_mask=jnp.asarray(q_mask), kv_mask=jnp.asarray(kv_mask),
                      sm_scale=scale)
        return jnp.sum(o * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_split_then_merge_matches_jax_grad(case, splits):
    b, h, nq, nk, d = CASES[case]
    rng = np.random.default_rng(10 + splits)
    q, w = (rng.standard_normal((b, h, nq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    q_mask, kv_mask = _masks(b, nq, nk, case)
    scale = d**-0.5
    jdq, jdk, jdv = _jax_grads(q, k, v, w, q_mask, kv_mask, scale)

    t = torch.from_numpy
    qm, km = t(q_mask), t(kv_mask)
    out, lse = axial.fused_attention_lse_reference(t(q), t(k), t(v), qm, km, scale)
    args = (t(q), t(k), t(v), t(w), lse, axial.attention_dsum(out, t(w)), qm, km, scale)
    pq = axial.dq_partials_reference(*args, splits=splits, block=BLOCK)
    pk, pv = axial.dkv_partials_reference(*args, splits=splits, block=BLOCK)
    assert pq.shape == (splits, b, h, nq, d)
    assert pk.shape == pv.shape == (splits, b, h, nk, d)
    dq = axial.merge_grad_partials_reference(pq, scale).numpy()
    dk = axial.merge_grad_partials_reference(pk, scale).numpy()
    dv = axial.merge_grad_partials_reference(pv).numpy()

    live = q_mask & kv_mask.any(-1)[:, None]  # query rows the port attends
    assert np.abs((dq - jdq) * live[:, None, :, None]).max() < ATOL
    keys = kv_mask & live.any(-1)[:, None]  # JAX lets a key-less row average its padded block
    for port, ref in ((dk, jdk), (dv, jdv)):
        assert np.abs((port - ref) * keys[:, None, :, None]).max() < ATOL
    # masked queries get dq = 0, masked keys dk = dv = 0, exactly
    assert (dq.transpose(0, 2, 1, 3)[~live] == 0).all()
    assert (dk.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()
    assert (dv.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()
    # the merged split equals the whole plain backward
    whole_dq = axial.fused_attention_dq_reference(*args).numpy()
    whole_dk, whole_dv = (x.numpy() for x in axial.fused_attention_dkv_reference(*args))
    for merged, whole in ((dq, whole_dq), (dk, whole_dk), (dv, whole_dv)):
        assert np.abs(merged - whole).max() < ATOL


def test_a_dead_split_adds_exactly_zero():
    """With whole tiles of keys and queries masked, the ranges that hold
    only those tiles give partials that are exactly 0."""
    b, h, nq, nk, d = CASES["splits with all keys or queries masked"]
    rng = np.random.default_rng(0)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                  for n in (nq, nk, nk, nq))
    q_mask, kv_mask = (torch.from_numpy(m) for m in _masks(b, nq, nk, "splits with all keys "
                                                                      "or queries masked"))
    out, lse = axial.fused_attention_lse_reference(q, k, v, q_mask, kv_mask, 0.3)
    args = (q, k, v, w, lse, axial.attention_dsum(out, w), q_mask, kv_mask, 0.3)
    # 6 tiles of 16 over 3 splits: the second range (tiles 2, 3) is dead
    assert axial.split_ranges(96, 3, BLOCK)[1] == (32, 64)
    pq = axial.dq_partials_reference(*args, splits=3, block=BLOCK)
    pk, pv = axial.dkv_partials_reference(*args, splits=3, block=BLOCK)
    assert (pq[1] == 0).all() and (pk[1] == 0).all() and (pv[1] == 0).all()
    assert not (pq[0] == 0).all() and not (pk[2] == 0).all()


# (b, h, nq, nk, d) of K3's five training passes and of the gate's K3 cases,
# with the split counts (K3a, K3b)
SPLITS = {
    "train pair axial": ((128, 8, 128, 128, 64), (1, 1)),
    "train MSA column": ((64, 8, 5, 5, 64), (1, 1)),
    "train MSA row": ((5, 8, 64, 64, 64), (1, 1)),
    "train pair<-MSA": ((1, 8, 16384, 320, 64), (1, 7)),
    "train MSA<-pair": ((1, 8, 320, 16384, 64), (7, 1)),
    "gate flash_bwd_256": ((2, 8, 256, 256, 64), (1, 1)),
    "gate fused_axial_bwd_256": ((2, 4, 256, 256, 64), (1, 1)),
    "gate edge_dense_d128": ((1, 2, 130, 130, 128), (1, 1)),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_grad_splits_on_the_main_path_and_the_gate(name):
    shape, want = SPLITS[name]
    got = (axial.grad_splits(*shape, "dq"), axial.grad_splits(*shape, "dkv"))
    assert got == want
    b, h, nq, nk, _ = shape
    for which, s in zip(("dq", "dkv"), got):
        rows, streamed = (nq, nk) if which == "dq" else (nk, nq)
        blocks = b * h * -(-rows // axial.GRAD_TILE)
        if s > 1:
            # about two waves on the card, each split keeping several tiles
            assert blocks < 2 * axial.SM_COUNT <= blocks * s
            assert -(-streamed // axial.GRAD_TILE) // s >= axial.MIN_GRAD_SPLIT_TILES
    with pytest.raises(ValueError):
        axial.grad_splits(*shape, "dk")


def test_merge_on_the_cpu_takes_the_plain_version():
    """CPU partials run the plain merge (bf16 out, as the card's kernel
    writes, summed in split order) and launch nothing."""
    rng = np.random.default_rng(3)
    part = torch.from_numpy(rng.standard_normal((3, 1, 2, 9, 16)).astype(np.float32))
    launches = axial.fused_attention_bwd_merge.launches
    out = axial.fused_attention_bwd_merge(part, 0.25)
    ref = axial.merge_grad_partials_reference(part, 0.25, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 9, 16) and torch.equal(out, ref)
    in_order = ((part[0] + part[1]) + part[2]) * 0.25
    assert torch.equal(axial.merge_grad_partials_reference(part, 0.25), in_order)
    assert axial.fused_attention_bwd_merge.launches == launches
    with pytest.raises(ValueError):
        axial.fused_attention_bwd_merge(part[0])  # not (S, B, H, N, D)


# (b, h, nq, nk, d) of the long training passes: the merged MSA<-pair and the
# pair<-MSA backward at crop 768 with MSA 5 x 128 (rows the MSA's 640
# tokens, the stream the pair grid's 589,824), at batch 1 and 2, and past
# them at crop 1024 and batch 4, where the grid fills the card and one
# split would stream the whole pair grid
LONG_STREAMS = {
    "crop 768 MSA<-pair": (1, 8, 640, 768 * 768, 64),
    "crop 768 pair<-MSA": (1, 8, 768 * 768, 640, 64),
    "crop 768 MSA<-pair, batch 2": (2, 8, 640, 768 * 768, 64),
    "crop 1024 MSA<-pair, batch 4": (4, 8, 640, 1024 * 1024, 64),
    "crop 1024 pair<-MSA, batch 4": (4, 8, 1024 * 1024, 640, 64),
    "many blocks, long stream": (64, 8, 1024, 1000000, 64),
}


@pytest.mark.parametrize("name", list(LONG_STREAMS))
def test_no_grad_split_streams_more_than_max_grad_split_tiles(name):
    """K3's f32 accumulators drift over a long stream of tiles (K1's did,
    MAX_SPLIT_TILES), so no K3a key range and no K3b query range may stream
    more than MAX_GRAD_SPLIT_TILES, whatever the grid; the ranges still
    cover the stream once. The cap is the longest stream held against the
    plain version on the card (chip_smoke.py phase_k3_streams)."""
    b, h, nq, nk, d = LONG_STREAMS[name]
    assert axial.MAX_GRAD_SPLIT_TILES <= 9216
    for which in ("dq", "dkv"):
        streamed = nk if which == "dq" else nq
        s = axial.grad_splits(b, h, nq, nk, d, which)
        ranges = axial.split_ranges(streamed, s, axial.GRAD_TILE)
        assert max(hi - lo for lo, hi in ranges) <= axial.MAX_GRAD_SPLIT_TILES * axial.GRAD_TILE
        assert ranges[0][0] == 0 and ranges[-1][1] == streamed
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        assert s >= -(-(-(-streamed // axial.GRAD_TILE)) // axial.MAX_GRAD_SPLIT_TILES)
