"""K2's Hopper decomposition on the CPU: the plain version of its walk.

The Hopper K2 (``csrc/tied_row_attention_sm90.cuh``) owns 64 query rows and
one group of 64 or 128 of the R*D output columns a block; for each 64-key
tile it computes the shared logits S once over the whole fused (r, d) axis,
scales them in f32 by sm_scale * tie[b], runs the online softmax in log2
units, rounds p to bf16 once per tile before P V', and never stages a tile
with no valid key. Here ``tied_row.hopper_walk_reference`` (that walk, group
by group and tile by tile) is held

- against JAX's ``tied_row_attention`` (``alphafold2_tpu/ops/pallas/
  tied_row.py``) in interpret mode: out in f32 at 1e-5 on rows with a valid
  key, in bf16 within chip_smoke.py's bf16 bound (2^-6 of max|JAX|,
  relative L2 4e-3), at R 1, 5 and 8, head dims 16, 32 and 64, N not a
  multiple of 64, prefix and ragged masks, a per-batch tie scale, a
  negative scale, and both column widths the plan chooses (so every group
  count G of these shapes);
- equal to ``tied_row_attention_lse_reference``, the plain version the
  wrappers run on the CPU, out and lse, including a first key tile with no
  valid key (where the walk's running max is still -inf) and a batch row
  with none at all (0 and +inf);

and ``tied_row.hopper_plan`` is held to the C plan's constants and to the
numbers the C plan gave on the card for the main-path and gate shapes. The
wrappers on CPU tensors launch nothing. Inputs are drawn with numpy from
seeds and handed to both frameworks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.tied_row import tied_row_attention as jax_tied
from alphafold2_tpu_torch.ops.cuda import tied_row

ATOL = 1e-5
BF16_MAX_REL, BF16_L2_REL = 2**-6, 4e-3  # chip_smoke.py TOL["bfloat16"]
COLUMNS = (64, 128)  # the plan's two widths
HEADER = (Path(tied_row.__file__).resolve().parents[2] / "csrc"
          / "tied_row_attention_sm90.cuh")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ragged(n, seed):
    """A column mask with holes: about a fifth of the keys masked."""
    return np.random.default_rng(seed).random(n) > 0.2


# (b, r, n, h, d), per-batch valid keys (a prefix length or a bool row),
# tie ("batch": the voting-row count per batch row, "float", or None for
# R**-0.5), the sign of sm_scale
CASES = {
    "R1 d16 prefix": ((2, 1, 70, 2, 16), [70, 45], "batch", 1.0),
    "R5 d32 ragged": ((2, 5, 100, 2, 32), [_ragged(100, 1), _ragged(100, 2)], "batch", 1.0),
    "R8 d64 prefix": ((1, 8, 130, 1, 64), [117], None, 1.0),
    "R5 d64 negative scale": ((2, 5, 75, 2, 64), [75, 30], "batch", -1.0),
    "R8 d16 ragged negative": ((2, 8, 90, 1, 16), [_ragged(90, 3), _ragged(90, 4)], "float",
                               -1.0),
    "R1 d32 unmasked": ((1, 1, 65, 2, 32), None, None, 1.0),
    "R5 d32 empty middle tile": ((1, 5, 150, 1, 32), [np.r_[np.ones(40), np.zeros(90),
                                                            np.ones(20)].astype(bool)],
                                 "batch", 1.0),
}


def _case(name, seed=0):
    """q, k, v (B, R, N, H, D) f32 numpy, the shared mask (B, N) or None,
    the tie scale, sm_scale. Masked columns of q, k, v are zeroed, as
    ops/attention.py pre-zeroes padded entries."""
    (b, r, n, h, d), valid, tie, sign = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, r, n, h, d)).astype(np.float32) for _ in range(3))
    mask = None
    if valid is not None:
        mask = np.stack([np.arange(n) < x if np.isscalar(x) else np.asarray(x, bool)
                         for x in valid])
        q, k, v = (t * mask[:, None, :, None, None] for t in (q, k, v))
    if tie == "batch":
        tie = (1.0 + np.arange(b, dtype=np.float32) * r) ** -0.5
    elif tie == "float":
        tie = 0.3
    return q, k, v, mask, tie, sign * d**-0.5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _torch_args(name, dtype, seed=0):
    q, k, v, mask, tie, scale = _case(name, seed)
    tm = None if mask is None else torch.from_numpy(mask)
    tt = torch.as_tensor(tie, dtype=torch.float32) if isinstance(tie, np.ndarray) else tie
    return (*(_t(a, dtype) for a in (q, k, v)), tm, tm, scale, tt)


_JAX = {}


def _jax(name, dtype, seed):
    """JAX's tied_row_attention in interpret mode, f32 numpy (cached: both
    column widths compare with one JAX run)."""
    key = (name, dtype, seed)
    if key not in _JAX:
        q, k, v, mask, tie, scale = _case(name, seed)
        jm = None if mask is None else jnp.asarray(mask)
        jt = jnp.asarray(tie) if isinstance(tie, np.ndarray) else tie
        out = jax_tied(*(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), q_mask=jm,
                       kv_mask=jm, sm_scale=scale, tie_scale=jt, interpret=True)
        _JAX[key] = np.asarray(out, dtype=np.float32)
    return _JAX[key]


def _keyed_rows(name, shape):
    """(B, R, N, H, D) bool: entries of query rows whose batch row has a
    valid key (JAX averages the padding where none is; the kernel gives 0)."""
    _, _, _, mask, _, _ = _case(name)
    b = shape[0]
    keyed = np.ones(b, bool) if mask is None else mask.any(-1)
    return np.broadcast_to(keyed[:, None, None, None, None], shape)


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_f32(name, columns):
    want = _jax(name, jnp.float32, seed=1)
    out, _ = tied_row.hopper_walk_reference(*_torch_args(name, torch.float32, seed=1),
                                            columns=columns)
    rows = _keyed_rows(name, want.shape)
    np.testing.assert_allclose(out.numpy()[rows], want[rows], atol=ATOL)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_bf16(name, columns):
    """bf16 operands: both round p to bf16 before P V and the output to
    bf16; JAX folds the tie scale into a bf16 copy of q where the walk
    scales the f32 logits, and the sums run in another order, so the output
    is held to the card's bf16 bound."""
    want = _jax(name, jnp.bfloat16, seed=2)
    out, _ = tied_row.hopper_walk_reference(*_torch_args(name, torch.bfloat16, seed=2),
                                            columns=columns)
    rows = _keyed_rows(name, want.shape)
    diff = out.float().numpy()[rows] - want[rows]
    assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(want[rows]).max()
    assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(want[rows])


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_the_plain_reference(name, columns):
    """The kernel's decomposition and the plain version the wrappers run on
    the CPU compute one function: out at 1e-5, lse at 1e-5 where finite and
    +inf on the same rows."""
    args = _torch_args(name, torch.float32, seed=3)
    out, lse = tied_row.hopper_walk_reference(*args, columns=columns)
    ref_out, ref_lse = tied_row.tied_row_attention_lse_reference(*args)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=ATOL)
    assert np.array_equal(np.isposinf(lse.numpy()), np.isposinf(ref_lse.numpy()))
    finite = np.isfinite(ref_lse.numpy())
    np.testing.assert_allclose(lse.numpy()[finite], ref_lse.numpy()[finite], atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_leading_tile_without_a_key_and_a_dead_row(dtype):
    """Keys 0-63 all masked in batch row 0 (the walk meets its first staged
    tile with its max at -inf only because the empty tile is skipped: were
    it processed, 2^(-inf + inf) would be NaN), and batch row 1 without any
    valid key: out finite, row 1 exactly 0 with lse +inf, row 0 equal to
    the plain version."""
    b, r, n, h, d = 2, 5, 140, 2, 32
    rng = np.random.default_rng(7)
    mask = np.zeros((b, n), bool)
    mask[0, 64:130] = True
    q, k, v = (_t(rng.standard_normal((b, r, n, h, d)) * mask[:, None, :, None, None], dtype)
               for _ in range(3))
    tm = torch.from_numpy(mask)
    args = (q, k, v, tm, tm, d**-0.5, torch.tensor([5.0**-0.5, 1.0]))
    for columns in COLUMNS:
        out, lse = tied_row.hopper_walk_reference(*args, columns=columns)
        assert torch.isfinite(out).all()
        assert (out[1] == 0).all() and torch.isposinf(lse[1]).all()
        ref_out, ref_lse = tied_row.tied_row_attention_lse_reference(*args)
        tol = ATOL if dtype == torch.float32 else 2**-6 * float(ref_out.float().abs().max())
        np.testing.assert_allclose(out[0].float().numpy(), ref_out[0].float().numpy(), atol=tol)
        np.testing.assert_allclose(lse[0].numpy(), ref_lse[0].numpy(), atol=1e-4)


def test_walk_computes_the_logits_once_per_key_tile_per_group():
    """Per column group and 64-key tile with a valid key, one product over
    the whole R*D axis: 3 groups of 128 x 2 tiles at R*D 320, N 128, and no
    product for a tile without a valid key."""
    b, r, n, h, d = 1, 5, 128, 1, 64
    q, k, v = (torch.randn((b, r, n, h, d)) for _ in range(3))
    mask = torch.ones((b, n), dtype=torch.bool)
    shapes = []
    real = torch.Tensor.__matmul__

    def spy(x, y):
        shapes.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    torch.Tensor.__matmul__ = spy
    try:
        tied_row.hopper_walk_reference(q, k, v, mask, mask, 0.125, 0.5, columns=128)
        logits = [s for s in shapes if s[0][-1] == 320]
        assert logits == [((1, 128, 320), (1, 320, 64))] * 6
        shapes.clear()
        mask[:, 64:] = False
        tied_row.hopper_walk_reference(q, k, v, mask, mask, 0.125, 0.5, columns=128)
        assert len([s for s in shapes if s[0][-1] == 320]) == 3
    finally:
        torch.Tensor.__matmul__ = real


# ------------------------------------------------------------------ plan


def _header_constant(name):
    match = re.search(rf"constexpr \w+ {name} = ([0-9.]+)", HEADER.read_text())
    assert match, name
    return float(match.group(1))


def test_plan_mirror_uses_the_kernel_constants():
    assert tied_row.TILE == _header_constant("kRows")
    assert tied_row.MAX_STAGES == _header_constant("kMaxStages")
    assert tied_row.SMS == _header_constant("kSMs")
    assert tied_row.SMEM_LIMIT == _header_constant("kSmemLimit")
    assert tied_row.SMEM_PER_SM == _header_constant("kSmemPerSM")
    assert tied_row.THREADS == 128 + 32
    # the ring's control block: 2 full, 2 empty and 1 q barrier (8 bytes
    # each), 2 x 2 mask words and 2 tile starts (4 bytes each)
    s = tied_row.MAX_STAGES
    assert tied_row.CONTROL_BYTES == (2 * s + 1) * 8 + 3 * s * 4


# (b, r, h, n, d) -> (kernel, columns, groups, stages, blocks, shared memory),
# as the C plan gave them on an H100 (chip_smoke.py check_k2_plans)
PLANS = {
    "serve": ((4, 5, 8, 128, 64), ("tied_row_attention_kernel_sm90<64,128>", 128, 3, 1, 192,
                                   99_392)),
    "train": ((1, 5, 8, 64, 64), ("tied_row_attention_kernel_sm90<64,64>", 64, 5, 2, 40,
                                  140_352)),
    "gate": ((1, 8, 4, 256, 64), ("tied_row_attention_kernel_sm90<64,64>", 64, 8, 2, 128,
                                  214_080)),
    "d32, 64 columns": ((3, 8, 2, 100, 32), ("tied_row_attention_kernel_sm90<32,64>", 64, 4, 2,
                                             48, 115_776)),
    "d32, 128 columns": ((16, 4, 8, 70, 32), ("tied_row_attention_kernel_sm90<32,128>", 128,
                                              1, 2, 256, 83_008)),
    "d128, 64 columns": ((2, 4, 2, 70, 128), ("tied_row_attention_kernel_sm90<128,64>", 64, 8,
                                              2, 64, 214_080)),
    "d128, 128 columns": ((8, 2, 8, 128, 128), ("tied_row_attention_kernel_sm90<128,128>",
                                                128, 2, 1, 256, 83_008)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_mirror_matches_the_card(name):
    shape, want = PLANS[name]
    plan = tied_row.hopper_plan(*shape)
    assert (plan["kernel"], plan["columns"], plan["groups"], plan["stages"], plan["blocks"],
            plan["dynamic_smem"]) == want
    assert plan["threads"] == 160 and plan["dynamic_smem"] <= tied_row.SMEM_LIMIT


@pytest.mark.parametrize("shape", [
    (1, 20, 2, 48, 64),  # R*D 1280: no room for the q tile and two stages
    (2, 5, 2, 33, 16),  # head dim 16
    (2, 3, 2, 33, 48),  # head dim 48
])
def test_plan_leaves_the_rest_to_attention_kernel_mma(shape):
    assert tied_row.hopper_plan(*shape) is None


def test_plan_fills_a_wave_where_it_can():
    """C = 128 only where the grid then fills the card's 132 SMs; the widest
    R*D the kernel takes at head dim 64 is 512 (C = 64 at 214,080 bytes,
    C = 128 at 230,464), and 576 needs more than 232,448."""
    assert tied_row.hopper_plan(4, 5, 8, 128, 64)["columns"] == 128  # 192 blocks
    assert tied_row.hopper_plan(2, 5, 8, 128, 64)["columns"] == 64  # 96 at 128 columns
    assert tied_row.hopper_smem_bytes(512, 128) == 230_464 <= tied_row.SMEM_LIMIT
    assert tied_row.hopper_plan(64, 8, 8, 128, 64)["columns"] == 128
    assert tied_row.hopper_smem_bytes(576, 64) > tied_row.SMEM_LIMIT
    assert tied_row.hopper_plan(1, 9, 8, 128, 64) is None


def test_plan_takes_one_stage_where_blocks_then_share_an_sm():
    """The serving pass's 192 blocks outgrow one wave of two-stage blocks
    (156,736 bytes, one an SM); at one stage (99,392 bytes) two share an SM
    and all 192 run at once. The training pass's 40 blocks fit one wave at
    two stages, and so does a grid whose two-stage blocks already pair up."""
    serve = tied_row.hopper_plan(4, 5, 8, 128, 64)
    assert tied_row.hopper_smem_bytes(320, 128, 2) == 156_736
    assert serve["stages"] == 1 and serve["dynamic_smem"] == 99_392
    assert 2 * (99_392 + 1024) <= tied_row.SMEM_PER_SM < 2 * (156_736 + 1024)
    assert tied_row.hopper_plan(1, 5, 8, 64, 64)["stages"] == 2
    assert tied_row.hopper_plan(16, 4, 8, 70, 32)["stages"] == 2  # 256 blocks, two an SM


# ------------------------------------------------------------------ wrappers


def test_wrappers_on_cpu_tensors_launch_nothing():
    args = _torch_args("R5 d64 negative scale", torch.bfloat16)
    fn = tied_row.tied_row_attention
    before = (fn.launches, fn.sm90_launches)
    calls = (tied_row.tied_row_attention_reference.calls,
             tied_row.tied_row_attention_lse_reference.calls)
    out = fn(*args[:3], q_mask=args[3], kv_mask=args[4], sm_scale=args[5], tie_scale=args[6])
    out_lse, lse = tied_row.tied_row_attention_lse(*args)
    assert (fn.launches, fn.sm90_launches) == before == (0, 0)
    assert (tied_row.tied_row_attention_reference.calls,
            tied_row.tied_row_attention_lse_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert out.dtype == out_lse.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, out_lse)
