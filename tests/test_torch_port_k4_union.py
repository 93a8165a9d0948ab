"""K4's Hopper decomposition on the CPU: the plain version of its walk.

The Hopper K4 kernel owns 64 query rows a block and streams the union of
their blocks' key lists as stages of 64 keys with layout bits (the row
lists of ``ops/cuda/block_sparse.py union_stages``, which K5a streams too);
each consumer warp masks its 16 rows by its own block's bits, and the online
softmax runs in log2 units in stage order. Here ``fwd_union_reference``
(that walk, tile by stage, with the per-warp masks and the padding slots) is
held

- against JAX's ``pallas_block_sparse_attention`` in interpret mode, as
  tests/test_torch_port_k5_union.py runs JAX: out and lse in f32 at 1e-5 on
  rows with a valid key, in bf16 (p rounded before P V on both sides)
  within the card's bf16 bound of chip_smoke.py (2^-6 of max|JAX|,
  relative L2 4e-3), at blocks 16-128, the flat route's 112 tokens and
  disjoint lists, with the scale positive and negative (JAX's kernel takes
  d**-0.5, so the negative case hands it -q);
- equal to ``block_sparse_attention_lse_reference``, the list-by-list plain
  version the wrappers run on the CPU;
- where one warp's block lists nothing in a stage that another warp's block
  needs (its rows' running max still -inf): finite rows, equal to the
  result without padding slots;
- with NaN in the padding slots, which poison the output where the repeat
  rule gives exactly the result without them.

The wrappers on CPU tensors launch nothing. Inputs are drawn with numpy from
seeds and handed to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu.ops.pallas.block_sparse import pallas_block_sparse_attention
from alphafold2_tpu_torch.ops import sparse
from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa

ATOL = 1e-5
BF16_MAX_REL, BF16_L2_REL = 2**-6, 4e-3  # chip_smoke.py TOL["bfloat16"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _disjoint(nb):
    """Each query block lists itself and two blocks spread over the axis,
    so the blocks of one 64-row tile list mostly different blocks."""
    lay = np.zeros((nb, nb), dtype=bool)
    for i in range(nb):
        lay[i, [i, (5 * i + 3) % nb, (11 * i + 7) % nb]] = True
    return lay


def _late_lists():
    """8 blocks of 16: in each 64-row tile some blocks list nothing in the
    tile's first stage, which other blocks of the tile need, so their warps
    meet a stage with no key while their running max is still -inf."""
    lay = np.zeros((8, 8), dtype=bool)
    for i, listed in enumerate(([0, 1, 2, 3], [4], [5], [1, 6],
                                [4], [0, 7], [6], [2, 3, 5])):
        lay[i, listed] = True
    return lay


CASES = {  # (b, h, n, d, block, dense layout or config kwargs, valid keys per batch row)
    # tests/test_torch_port_k5_union.py's cases
    "ragged": (3, 2, 96, 16, 16, dict(num_random_blocks=1), [96, 70, 21]),
    "dead row": (3, 2, 64, 8, 16, dict(num_random_blocks=1), [0, 64, 40]),
    "block 32": (2, 2, 128, 16, 32, dict(num_random_blocks=1, seed=5), [128, 75]),
    "unmasked": (1, 2, 96, 8, 16, dict(num_random_blocks=2, num_global_blocks=0), None),
    "disjoint": (2, 2, 256, 8, 16, _disjoint(16), [256, 131]),
    "flat 112": (2, 1, 112, 8, 16, {}, [112, 100]),
    # one query block a tile (64), half of one (128: a block fills two stages)
    "block 64": (2, 1, 256, 8, 64, dict(num_random_blocks=1), [256, 150]),
    "block 128": (1, 2, 512, 8, 128, {}, [400]),
    "late lists": (2, 2, 128, 8, 16, _late_lists(), [128, 70]),
}


def _case(name, seed=0):
    b, h, n, d, block, lay, valid = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = None if valid is None else np.arange(n)[None, :] < np.asarray(valid)[:, None]
    if isinstance(lay, dict):
        lay = jsparse.BlockSparseConfig(block_size=block, **lay).layout(n)
    return q, k, v, mask, lay, block


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _live(mask, lay, block, b, n):
    """(B, N) query rows whose active blocks hold a valid key."""
    keys = np.ones((b, n), bool) if mask is None else mask
    reach = keys.reshape(b, -1, block).any(-1) @ lay.T.astype(int)  # (B, nb)
    return np.repeat(reach > 0, block, axis=1)


def _jax_forward(q, k, v, mask, lay, block, dtype, sign):
    """JAX's kernel at scale sign * d**-0.5 (it takes d**-0.5: the sign
    rides on q). (out, lse) as f32 numpy."""
    jq, jk, jv = (jnp.asarray(a, dtype=dtype) for a in (sign * q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = pallas_block_sparse_attention(jq, jk, jv, lay, block, mask=jm, interpret=True,
                                             return_lse=True)
    return np.asarray(out, dtype=np.float32), np.asarray(lse, dtype=np.float32)


def _union_forward(q, k, v, mask, lay, block, dtype, sign, pad="repeat"):
    layout = sparse.pack_layout(lay, block)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    scale = sign * q.shape[-1] ** -0.5
    out, lse = bsa.fwd_union_reference(tq, tk, tv, layout, tm, scale, pad=pad)
    return out.float().numpy(), lse.numpy(), (tq, tk, tv, layout, tm, scale)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["scale", "negative scale"])
@pytest.mark.parametrize("name", list(CASES))
def test_union_walk_matches_pallas_f32(name, sign):
    q, k, v, mask, lay, block = _case(name, seed=1)
    out_j, lse_j = _jax_forward(q, k, v, mask, lay, block, jnp.float32, sign)
    out, lse, _ = _union_forward(q, k, v, mask, lay, block, torch.float32, sign)
    live = _live(mask, lay, block, q.shape[0], q.shape[2])[:, None, :]  # (B, 1, N)
    live = np.broadcast_to(live, lse.shape)
    np.testing.assert_allclose(out[live], out_j[live], atol=ATOL)
    np.testing.assert_allclose(lse[live], lse_j[live], atol=ATOL)
    # rows without a valid key: exactly 0, lse +inf (JAX averages its padding)
    assert (out[~live] == 0).all() and np.isposinf(lse[~live]).all()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["scale", "negative scale"])
@pytest.mark.parametrize("name", ["ragged", "block 32", "disjoint", "flat 112", "block 128",
                                  "late lists"])
def test_union_walk_matches_pallas_bf16(name, sign):
    """bf16 operands: both sides round p to bf16 before P V and the output
    to bf16; the sums run in another order, so the output is held to the
    card's bf16 bound. The logits come from the same bf16 values in f32 on
    both sides, so the lse stays within 1e-4."""
    q, k, v, mask, lay, block = _case(name, seed=2)
    out_j, lse_j = _jax_forward(q, k, v, mask, lay, block, jnp.bfloat16, sign)
    out, lse, _ = _union_forward(q, k, v, mask, lay, block, torch.bfloat16, sign)
    live = np.broadcast_to(_live(mask, lay, block, q.shape[0], q.shape[2])[:, None, :],
                           lse.shape)
    rows = np.broadcast_to(live[..., None], out.shape)
    diff = out[rows] - out_j[rows]
    assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(out_j[rows]).max()
    assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(out_j[rows])
    np.testing.assert_allclose(lse[live], lse_j[live], atol=1e-4)


@pytest.mark.parametrize("name", ["disjoint", "flat 112", "ragged", "block 128"])
def test_union_walk_equals_the_list_reference(name):
    """The kernel's decomposition and the list-by-list plain version the
    wrappers run on the CPU compute one function."""
    q, k, v, mask, lay, block = _case(name, seed=3)
    for sign in (1.0, -1.0):
        out, lse, args = _union_forward(q, k, v, mask, lay, block, torch.float32, sign)
        ref_out, ref_lse = bsa.block_sparse_attention_lse_reference(*args)
        np.testing.assert_allclose(out, ref_out.numpy(), atol=ATOL)
        assert np.array_equal(np.isinf(lse), np.isinf(ref_lse.numpy()))
        finite = np.isfinite(lse)
        np.testing.assert_allclose(lse[finite], ref_lse.numpy()[finite], atol=ATOL)


def _empty_warp_stages(layout):
    """(tile, stage, resident block) where the block lists nothing in the
    stage while another resident block of the tile lists something, and
    the block has listed nothing in any earlier stage of the tile."""
    blocks, bits, counts = layout.row_union
    slots = blocks.shape[2]
    found = []
    for t in range(len(counts)):
        seen = set()
        for a in range(int(counts[t])):
            word = int(bits[t, a])
            listing = {r for r in range(slots) for s in range(slots)
                       if (word >> (s * slots + r)) & 1}
            found += [(t, a, r) for r in range(slots) if r not in listing | seen and listing]
            seen |= listing
    return found


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_warp_with_nothing_in_a_stage_stays_finite(dtype):
    """In the late-lists layout the first stage of each tile carries blocks
    that some resident blocks do not list: those warps' rows meet it with
    their max at -inf, where 2^(m - m_new) would be 2^(-inf + inf) = NaN.
    They keep max, sum and accumulator (alpha 1, p 0), so every row is
    finite and equals the result without the padding slots, bit for bit,
    and the list-by-list result in f32."""
    q, k, v, mask, lay, block = _case("late lists", seed=5)
    layout = sparse.pack_layout(lay, block)
    assert any(a == 0 for _, a, _ in _empty_warp_stages(layout))
    for sign in (1.0, -1.0):
        out, lse, args = _union_forward(q, k, v, mask, lay, block, dtype, sign)
        skip, skip_lse, _ = _union_forward(q, k, v, mask, lay, block, dtype, sign, pad="skip")
        assert np.isfinite(out).all() and not np.isnan(lse).any()
        assert np.array_equal(out, skip) and np.array_equal(lse, skip_lse)
        if dtype == torch.float32:
            np.testing.assert_allclose(out, bsa.block_sparse_attention_lse_reference(
                *args)[0].numpy(), atol=ATOL)


def _empty_slots(layout):
    _, bits, counts = layout.row_union
    slots = 64 // min(layout.block_size, 64)
    own = (1 << slots) - 1
    return sum(((int(bits[t, a]) >> (s * slots)) & own) == 0
               for t in range(len(counts)) for a in range(counts[t]) for s in range(slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["disjoint", "flat 112", "ragged"])
def test_padding_rule_gives_exactly_the_unpadded_result(name, dtype):
    """A stage's empty slots repeat its last block with bits 0: they weigh
    exactly 0, and out and lse equal bit for bit those that leave the slots
    out. Slots of NaN (what unwritten shared memory may hold) poison the
    output: p = 0 by select, but 0 * NaN in P V is NaN."""
    q, k, v, mask, lay, block = _case(name, seed=4)
    assert _empty_slots(sparse.pack_layout(lay, block))
    out, lse, _ = _union_forward(q, k, v, mask, lay, block, dtype, 1.0)
    skip, skip_lse, _ = _union_forward(q, k, v, mask, lay, block, dtype, 1.0, pad="skip")
    nan, _, _ = _union_forward(q, k, v, mask, lay, block, dtype, 1.0, pad="nan")
    assert np.array_equal(out, skip) and np.array_equal(lse, skip_lse)
    assert np.isfinite(out).all() and np.isnan(nan).any()


def test_union_reference_rejects_an_unknown_padding():
    q, k, v, mask, lay, block = _case("ragged")
    with pytest.raises(ValueError, match="pad"):
        _union_forward(q, k, v, mask, lay, block, torch.float32, 1.0, pad="zero")


def test_wrappers_on_cpu_tensors_launch_nothing():
    q, k, v, mask, lay, block = _case("disjoint")
    layout = sparse.pack_layout(lay, block)
    wrappers = (bsa.block_sparse_attention, bsa.block_sparse_attention_lse)
    before = [(f.launches, f.sm90_launches) for f in wrappers]
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    calls = (bsa.block_sparse_attention_reference.calls,
             bsa.block_sparse_attention_lse_reference.calls)
    out = bsa.block_sparse_attention(tq, tk, tv, layout, tm, 0.25)
    out_lse, lse = bsa.block_sparse_attention_lse(tq, tk, tv, layout, tm, 0.25)
    assert (bsa.block_sparse_attention_reference.calls,
            bsa.block_sparse_attention_lse_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert [(f.launches, f.sm90_launches) for f in wrappers] == before == [(0, 0), (0, 0)]
    assert out.dtype == out_lse.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, out_lse)
