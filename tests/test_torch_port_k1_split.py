"""K1's split over long key loops, on the CPU: the plain versions of the
per-split partials and of their merge (the combine pass) in
alphafold2_tpu_torch/ops/cuda/axial.py, held against the JAX package's
``fused_attention`` (run on the CPU as tests/test_torch_port_kernels.py runs
it) for the output and against the port's ``fused_attention_lse_reference``
for the lse (JAX's public function returns none); and ``key_splits``, the
rule that decides where the card's kernel splits. Tolerance 1e-5 on valid
rows: every side computes in f32. The card's kernels are held against the
same plain versions by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu_torch.ops.cuda import axial

ATOL = 1e-5
BLOCK = 16  # keys per tile here, so a few dozen keys make several splits


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _masks(b, nq, nk, case):
    """(q_mask, kv_mask) as numpy bool arrays for one named case."""
    q_mask = np.ones((b, nq), bool)
    q_mask[:, nq - 3:] = False
    kv_mask = np.ones((b, nk), bool)
    if case == "ragged key tails":
        kv_mask[0, nk - 7:] = False
        kv_mask[1, nk - 1:] = False
    elif case == "splits with all keys masked":
        kv_mask[:, BLOCK:4 * BLOCK] = False  # whole tiles: every S > 1 has a dead split
    elif case == "fully masked batch row":
        kv_mask[0] = False  # every query row of batch 0 has no valid key
    return q_mask, kv_mask


CASES = {  # name: (b, h, nq, nk, d)
    "ragged key tails": (2, 2, 37, 91, 16),
    "splits with all keys masked": (2, 1, 24, 96, 8),
    "fully masked batch row": (2, 2, 33, 50, 8),
}


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_split_then_merge_matches_jax(case, splits):
    b, h, nq, nk, d = CASES[case]
    rng = np.random.default_rng(splits)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (nq, nk, nk))
    q_mask, kv_mask = _masks(b, nq, nk, case)
    scale = d**-0.5
    ref = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_mask=jnp.asarray(q_mask), kv_mask=jnp.asarray(kv_mask),
                               sm_scale=scale))
    t = torch.from_numpy
    m, l, acc = axial.attention_partials_reference(t(q), t(k), t(v), t(kv_mask), scale,
                                                   splits, block=BLOCK)
    assert m.shape == l.shape == (splits, b, h, nq) and acc.shape == (splits, b, h, nq, d)
    out, lse = axial.combine_partials_reference(m, l, acc, t(q_mask), with_lse=True)
    out, lse = out.numpy(), lse.numpy()

    has_key = kv_mask.any(-1)[:, None] & np.ones((b, nq), bool)
    valid = q_mask & has_key
    err = np.abs(out - ref) * valid[:, None, :, None]
    assert err.max() < ATOL
    # a masked query row, and a row with no valid key, give exactly 0
    assert (out.transpose(0, 2, 1, 3)[~valid] == 0).all()

    _, ref_lse = axial.fused_attention_lse_reference(t(q), t(k), t(v), t(q_mask),
                                                     t(kv_mask), scale)
    ref_lse = ref_lse.numpy()
    dead = ~np.broadcast_to(has_key[:, None, :], lse.shape)
    assert np.isposinf(lse[dead]).all() and np.isposinf(ref_lse[dead]).all()
    # masked query rows keep a finite lse over their valid keys
    assert np.isfinite(lse[~dead]).all()
    assert np.abs(lse[~dead] - ref_lse[~dead]).max() < ATOL


@pytest.mark.parametrize("nk,splits,block", [(91, 1, 16), (91, 3, 16), (96, 7, 16),
                                             (5, 2, 128), (16384, 11, 128)])
def test_split_ranges_cover_the_keys_in_whole_tiles(nk, splits, block):
    ranges = axial.split_ranges(nk, splits, block)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == nk
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo <= hi == nxt and lo % block == 0
    # whole tiles, shared as evenly as they go (the last may be ragged)
    tiles = [-(-hi // block) - lo // block for lo, hi in ranges]
    assert sum(tiles) == -(-nk // block) and max(tiles) - min(tiles) <= 1


def test_partials_of_a_range_without_valid_keys():
    """A split whose keys are all masked, or that holds no key, gives
    m = -inf, l = 0 and acc = 0, and weighs nothing in the merge."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 4, 8)).astype(np.float32))
               for _ in range(3))
    kv_mask = torch.tensor([[True, True, False, False]])
    m, l, acc = axial.attention_partials_reference(q, k, v, kv_mask, 0.3, splits=3, block=2)
    # 2 tiles over 3 splits: the first range is empty, the last all masked
    assert axial.split_ranges(4, 3, 2) == [(0, 0), (0, 2), (2, 4)]
    assert torch.isneginf(m[0]).all() and torch.isneginf(m[2]).all()
    assert (l[0] == 0).all() and (l[2] == 0).all() and (acc[0] == 0).all() and (acc[2] == 0).all()
    whole = axial.fused_attention_reference(q, k, v, kv_mask=kv_mask, sm_scale=0.3)
    merged = axial.combine_partials_reference(m, l, acc)
    assert torch.allclose(merged, whole, atol=ATOL)


# (b, h, nq, nk, d) of the nine main-path passes and whether the kernel splits
MAIN_PATH = {
    "serve pair axial": ((1536, 8, 384, 384, 64), False),
    "serve MSA column": ((512, 8, 5, 5, 64), False),
    "serve pair<-MSA": ((4, 8, 147456, 640, 64), False),
    "serve MSA<-pair": ((4, 8, 640, 147456, 64), True),
    "train pair axial": ((128, 8, 128, 128, 64), False),
    "train MSA column": ((64, 8, 5, 5, 64), False),
    "train MSA row": ((5, 8, 64, 64, 64), False),
    "train pair<-MSA": ((1, 8, 16384, 320, 64), False),
    "train MSA<-pair": ((1, 8, 320, 16384, 64), True),
}


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_key_splits_on_the_main_path(name):
    shape, splits = MAIN_PATH[name]
    s = axial.key_splits(*shape)
    assert (s > 1) is splits
    b, h, nq, nk, _ = shape
    blocks = b * h * -(-nq // axial.QUERY_TILE)
    if splits:
        # about two waves on the card, each split keeping several key tiles
        assert blocks * s >= 2 * axial.SM_COUNT
        assert -(-nk // axial.KEY_TILE) // s >= axial.MIN_SPLIT_TILES
    assert axial.key_splits(*shape) == s  # a pure function of the shape


def test_combine_on_the_cpu_takes_the_plain_version():
    """CPU partials run the plain merge (bf16 out, as the card's kernel
    writes) and launch nothing."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
               for _ in range(3))
    m, l, acc = axial.attention_partials_reference(q, k, v, None, 0.25, splits=2, block=4)
    launches = axial.fused_attention_combine.launches
    out, lse = axial.fused_attention_combine(m, l, acc, with_lse=True)
    ref, ref_lse = axial.combine_partials_reference(m, l, acc, with_lse=True,
                                                    dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert axial.fused_attention_combine.launches == launches
    with pytest.raises(ValueError):
        axial.fused_attention_combine(m, l[:1], acc)
    with pytest.raises(ValueError):  # q_mask of the wrong shape
        axial.fused_attention_combine(m, l, acc, q_mask=torch.ones((1, 8), dtype=torch.bool))
