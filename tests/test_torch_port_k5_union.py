"""K5a/K5b's Hopper decomposition on the CPU: the union lists and their
plain versions.

The Hopper K5 kernels own 64 rows a block and stream the union of their
resident blocks' lists as stages of 64 rows with layout bits
(``ops/cuda/block_sparse.py union_stages``). Here:

- the lists: every listed (resident block, streamed block) pair appears
  exactly once a tile with its bit set and no unlisted pair has its bit set;
  stages are packed 64 / bs blocks at a time in ascending order; empty
  slots repeat the stage's last block with bits 0; at block 16, 32, 64 and
  128, for N a multiple of 64 and not, rows and columns;
- ``dq_union_reference`` / ``dkv_union_reference`` (the kernels' walk, tile
  by stage, with the layout bits and the padding slots) against JAX's
  ``pallas_block_sparse_attention_bwd`` in interpret mode, as
  tests/test_torch_port_sparse.py runs it: f32 at 1e-5 on live rows and
  valid keys, bf16 (p and ds rounded on both sides) within the card's bf16
  bound of chip_smoke.py (2^-6 of max|JAX|, relative L2 4e-3);
- a padding slot of NaN poisons the sums where the repeat rule gives
  exactly the result without the padding slots;
- the wrappers on CPU tensors launch nothing.

Inputs are drawn with numpy from seeds and handed to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu.ops.pallas.block_sparse import (
    pallas_block_sparse_attention, pallas_block_sparse_attention_bwd)
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


def _config_layout(n, block, **kw):
    return sparse.BlockSparseConfig(block_size=block, **kw).layout(n)


LAYOUTS = {  # name: (n, block, dense (nb, nb) layout)
    "block 16, n 128": (128, 16, _config_layout(128, 16)),
    "block 16, n 512": (512, 16, _config_layout(512, 16)),
    "block 16, n 112": (112, 16, _config_layout(112, 16)),
    "block 16, disjoint": (256, 16, _disjoint(16)),
    "block 32, n 256": (256, 32, _config_layout(256, 32, num_random_blocks=1)),
    "block 32, n 96": (96, 32, _config_layout(96, 32, num_random_blocks=1, seed=3)),
    "block 64, n 512": (512, 64, _config_layout(512, 64)),
    "block 128, n 512": (512, 128, _config_layout(512, 128)),
}


@pytest.mark.parametrize("columns", [False, True], ids=["rows", "columns"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_union_lists_pack_every_listed_pair_once(name, columns):
    n, block, lay = LAYOUTS[name]
    lay = lay.T if columns else lay  # columns: the key blocks' lists
    layout = sparse.pack_layout(LAYOUTS[name][2], block)
    blocks, bits, counts = layout.col_union if columns else layout.row_union
    nb = n // block
    box = min(block, 64)
    slots = 64 // box
    tiles = -(-n // 64)
    assert blocks.shape[0] == bits.shape[0] == counts.shape[0] == tiles
    assert blocks.shape[1:] == (max(counts.max(), 1), slots)
    assert blocks.dtype == bits.dtype == counts.dtype == np.int32
    seen = np.zeros((nb, nb), dtype=int)
    for t in range(tiles):
        resident = ([t * slots + r for r in range(slots)] if block < 64
                    else [t * 64 // block])
        union = np.flatnonzero(lay[[r for r in resident if r < nb]].any(0))
        assert counts[t] == -(-len(union) // slots)
        streamed = []
        for a in range(counts[t]):
            word = int(bits[t, a])
            assert word >> (slots * slots) == 0
            stage = blocks[t, a]
            for s in range(slots):
                group = (word >> (s * slots)) & ((1 << slots) - 1)
                if group == 0:  # an empty slot: the stage's last block, bits 0
                    assert s > 0 and a == counts[t] - 1
                    assert stage[s] == stage[s - 1]
                    continue
                streamed.append(stage[s])
                for r, rb in enumerate(resident):
                    listed = rb < nb and lay[rb, stage[s]]
                    assert bool((group >> r) & 1) == listed
                    seen[rb if rb < nb else 0, stage[s]] += listed
        # ascending, packed: every stage but the last is full
        np.testing.assert_array_equal(streamed, union)
        assert (blocks[t, counts[t]:] == 0).all() and (bits[t, counts[t]:] == 0).all()
    # once per tile: at block 128 each block's two 64-row tiles stream its list
    np.testing.assert_array_equal(seen, lay.astype(int) * max(block // 64, 1))


def test_union_lists_stay_on_the_device_once():
    layout = sparse.config_layout(sparse.BlockSparseConfig(), 128)
    cpu = torch.device("cpu")
    first = layout.union_tensors(cpu)
    assert all(x is y for x, y in zip(first, layout.union_tensors(cpu)))
    want = (*layout.row_union, *layout.col_union)
    assert len(first) == 6
    for got, ref in zip(first, want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------------ plain versions


CASES = {  # (b, h, n, d, block, dense layout or config kwargs, valid keys per batch row)
    # tests/test_torch_port_sparse.py's cases
    "ragged": (3, 2, 96, 16, 16, dict(num_random_blocks=1), [96, 70, 21]),
    "dead row": (3, 2, 64, 8, 16, dict(num_random_blocks=1), [0, 64, 40]),
    "block 32": (2, 2, 128, 16, 32, dict(num_random_blocks=1, seed=5), [128, 75]),
    "unmasked": (1, 2, 96, 8, 16, dict(num_random_blocks=2, num_global_blocks=0), None),
    # wide unions with empty slots; one tile past N at 112
    "disjoint": (2, 2, 256, 8, 16, _disjoint(16), [256, 131]),
    "flat 112": (2, 1, 112, 8, 16, {}, [112, 100]),
}


def _case(name, seed=0):
    b, h, n, d, block, lay, valid = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    mask = None if valid is None else np.arange(n)[None, :] < np.asarray(valid)[:, None]
    if isinstance(lay, dict):
        lay = jsparse.BlockSparseConfig(block_size=block, **lay).layout(n)
    return q, k, v, g, mask, lay, block


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _live(mask, lay, block, b, n):
    """(B, N) query rows whose active blocks hold a valid key."""
    keys = np.ones((b, n), bool) if mask is None else mask
    reach = keys.reshape(b, -1, block).any(-1) @ lay.T.astype(int)  # (B, nb)
    return np.repeat(reach > 0, block, axis=1)


def _jax_grads(q, k, v, g, mask, lay, block, dtype):
    jq, jk, jv, jg = (jnp.asarray(a, dtype=dtype) for a in (q, k, v, g))
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = pallas_block_sparse_attention(jq, jk, jv, lay, block, mask=jm, interpret=True,
                                             return_lse=True)
    return [np.asarray(x, dtype=np.float32) for x in pallas_block_sparse_attention_bwd(
        jq, jk, jv, out, lse, jg, lay, block, mask=jm, interpret=True)]


def _union_grads(q, k, v, g, mask, lay, block, dtype, pad="repeat"):
    layout = sparse.pack_layout(lay, block)
    tq, tk, tv, tg = (_t(a, dtype) for a in (q, k, v, g))
    tm = None if mask is None else torch.from_numpy(mask)
    d = q.shape[-1]
    out, lse = bsa.block_sparse_attention_lse_reference(tq, tk, tv, layout, tm, d**-0.5)
    args = (tq, tk, tv, tg, lse, bsa.attention_dsum(out, tg), layout, tm, d**-0.5)
    dq = bsa.dq_union_reference(*args, pad=pad)
    dk, dv = bsa.dkv_union_reference(*args, pad=pad)
    return [x.float().numpy() for x in (dq, dk, dv)], args


def _masks(mask, lay, block, shape):
    b, _, n, _ = shape
    live = np.broadcast_to(_live(mask, lay, block, b, n)[:, None, :, None], shape)
    keys = np.broadcast_to((np.ones((b, n), bool) if mask is None else mask)
                           [:, None, :, None], shape)
    return live, keys


@pytest.mark.parametrize("name", list(CASES))
def test_union_walk_matches_pallas_f32(name):
    q, k, v, g, mask, lay, block = _case(name, seed=1)
    dq_j, dk_j, dv_j = _jax_grads(q, k, v, g, mask, lay, block, jnp.float32)
    (dq, dk, dv), _ = _union_grads(q, k, v, g, mask, lay, block, torch.float32)
    live, keys = _masks(mask, lay, block, q.shape)
    np.testing.assert_allclose(dq[live], dq_j[live], atol=ATOL)
    np.testing.assert_allclose(dk[keys], dk_j[keys], atol=ATOL)
    np.testing.assert_allclose(dv[keys], dv_j[keys], atol=ATOL)
    # rows without a valid key and masked keys: exactly 0
    assert (dq[~live] == 0).all() and (dk[~keys] == 0).all() and (dv[~keys] == 0).all()


@pytest.mark.parametrize("name", ["ragged", "block 32", "disjoint", "flat 112"])
def test_union_walk_matches_pallas_bf16(name):
    """bf16 operands: both sides round ds (for dq, dk) and p (for dv) to bf16
    before their products and the results to bf16; the sums run in another
    order, so each output is held to the card's bf16 bound."""
    q, k, v, g, mask, lay, block = _case(name, seed=2)
    want = _jax_grads(q, k, v, g, mask, lay, block, jnp.bfloat16)
    got, _ = _union_grads(q, k, v, g, mask, lay, block, torch.bfloat16)
    live, keys = _masks(mask, lay, block, q.shape)
    for x, ref, sel in zip(got, want, (live, keys, keys)):
        diff = x[sel] - ref[sel]
        assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(ref[sel]).max()
        assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(ref[sel])


@pytest.mark.parametrize("name", ["disjoint", "flat 112", "ragged"])
def test_union_walk_equals_the_older_plain_versions(name):
    """The kernels' decomposition and the list-by-list plain versions the
    wrappers run on the CPU compute one function."""
    q, k, v, g, mask, lay, block = _case(name, seed=3)
    (dq, dk, dv), args = _union_grads(q, k, v, g, mask, lay, block, torch.float32)
    np.testing.assert_allclose(dq, bsa.block_sparse_attention_dq_reference(*args).numpy(),
                               atol=ATOL)
    for x, ref in zip((dk, dv), bsa.block_sparse_attention_dkv_reference(*args)):
        np.testing.assert_allclose(x, ref.numpy(), atol=ATOL)


def _empty_slots(union, block):
    """The empty slots of a direction's streamed stages."""
    _, bits, counts = union
    slots = 64 // min(block, 64)
    own = (1 << slots) - 1
    return sum(((int(bits[t, a]) >> (s * slots)) & own) == 0
               for t in range(len(counts)) for a in range(counts[t]) for s in range(slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["disjoint", "flat 112", "ragged"])
def test_padding_rule_gives_exactly_the_unpadded_sums(name, dtype):
    """A stage's empty slots repeat its last block with bits 0: they add
    exactly 0, and the sums equal bit for bit those that leave the slots
    out. Slots of NaN (what unwritten shared memory may hold) poison them:
    p = 0 by select, but ds = 0 * (NaN - dsum) and 0 * NaN are NaN."""
    q, k, v, g, mask, lay, block = _case(name, seed=4)
    layout = sparse.pack_layout(lay, block)
    assert _empty_slots(layout.row_union, block) and _empty_slots(layout.col_union, block)
    repeat, _ = _union_grads(q, k, v, g, mask, lay, block, dtype)
    skip, _ = _union_grads(q, k, v, g, mask, lay, block, dtype, pad="skip")
    nan, _ = _union_grads(q, k, v, g, mask, lay, block, dtype, pad="nan")
    for r, s, x in zip(repeat, skip, nan):
        assert np.array_equal(r, s)
        assert np.isfinite(r).all() and np.isnan(x).any()


def test_union_references_reject_an_unknown_padding():
    q, k, v, g, mask, lay, block = _case("ragged")
    _, args = _union_grads(q, k, v, g, mask, lay, block, torch.float32)
    with pytest.raises(ValueError, match="pad"):
        bsa.dq_union_reference(*args, pad="zero")
    with pytest.raises(ValueError, match="pad"):
        bsa.dkv_union_reference(*args, pad="zero")


def test_wrappers_on_cpu_tensors_launch_nothing():
    q, k, v, g, mask, lay, block = _case("disjoint")
    layout = sparse.pack_layout(lay, block)
    wrappers = (bsa.block_sparse_attention_dq, bsa.block_sparse_attention_dkv)
    before = [(f.launches, f.sm90_launches) for f in wrappers]
    tq, tk, tv, tg = (_t(a, torch.bfloat16) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = bsa.block_sparse_attention_lse(tq, tk, tv, layout, tm, 0.25)
    args = (tq, tk, tv, tg, lse, bsa.attention_dsum(out, tg), layout, tm, 0.25)
    calls = bsa.block_sparse_attention_dq_reference.calls
    dq = bsa.block_sparse_attention_dq(*args)
    dk, dv = bsa.block_sparse_attention_dkv(*args)
    assert bsa.block_sparse_attention_dq_reference.calls == calls + 1
    assert [(f.launches, f.sm90_launches) for f in wrappers] == before == [(0, 0), (0, 0)]
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
