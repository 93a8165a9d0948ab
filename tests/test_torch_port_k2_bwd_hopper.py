"""K2's Hopper backward on the CPU: the plain version of its walk.

The Hopper K2 backward (``csrc/tied_row_attention_bwd_sm90.cuh``) owns 64
rows (queries for dq, keys for dk/dv) and one group of 64 or 128 of the R*D
output columns a block; for each 64-row tile of the other side it computes
S and dO'V'^T once over the whole fused (r, d) axis, forms p and ds in f32
with the tie scale in the f32 scale, rounds them to bf16 before their
products, and never stages a tile with no valid key (no live query). Here
``tied_row.hopper_bwd_walk_reference`` (that walk, group by group and tile
by tile) is held

- against ``jax.grad`` of JAX's ``tied_row_attention``
  (``alphafold2_tpu/ops/pallas/tied_row.py``), whose custom VJP runs the
  Pallas ``_run_dq``/``_run_dkv`` at head dim R*D in interpret mode: raw dq,
  dk and dv in f32 at 1e-4 (the bound tests/test_torch_port_tied_row_grad.py
  uses), in bf16 within chip_smoke.py's bf16 bound (2^-6 of max|JAX|,
  relative L2 4e-3) of JAX's f32 gradient on the same bf16-rounded inputs,
  at R 1, 5 and 8, head dims 32 and 64, N not a multiple
  of 64, prefix and ragged masks, a per-batch tie, a negative scale, a
  first tile with no valid key, a batch row with none, and both column
  widths the dq plan chooses;
- equal to ``tied_row_attention_dq_reference`` and
  ``tied_row_attention_dkv_reference``, the plain versions the wrappers run
  on the CPU;
- at R = D/64 rows of 64 features (tie 1), equal to ``jax.grad`` of JAX's
  ``fused_attention`` at head dim 256: the route K3a/K3b take past head dim
  128;

and ``tied_row.hopper_bwd_plan`` is held to the header's constants and to
the plans the C code gave on the card. The wrappers on CPU tensors launch
nothing. Inputs are drawn with numpy from seeds and handed to both
frameworks.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu.ops.pallas.tied_row import tied_row_attention as jax_tied
from alphafold2_tpu_torch.ops.cuda import axial, tied_row

ATOL = 1e-4
BF16_MAX_REL, BF16_L2_REL = 2**-6, 4e-3  # chip_smoke.py TOL["bfloat16"]
COLUMNS = (64, 128)  # the dq plan's two widths (dk/dv: 64)
HEADER = (Path(tied_row.__file__).resolve().parents[2] / "csrc"
          / "tied_row_attention_bwd_sm90.cuh")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ragged(n, seed):
    """A column mask with holes: about a fifth of the keys masked."""
    return np.random.default_rng(seed).random(n) > 0.2


# (b, r, n, h, d), per-batch valid columns (a prefix length or a bool row),
# tie ("batch": the voting-row count per batch row, "float", or None for
# R**-0.5), the sign of sm_scale
CASES = {
    "R1 d32 prefix": ((2, 1, 70, 2, 32), [70, 45], "batch", 1.0),
    "R5 d32 ragged": ((2, 5, 100, 1, 32), [_ragged(100, 1), _ragged(100, 2)], "batch", 1.0),
    "R8 d64 prefix": ((1, 8, 80, 1, 64), [71], None, 1.0),
    "R5 d64 negative scale": ((2, 5, 75, 1, 64), [75, 30], "batch", -1.0),
    "R8 d32 ragged negative": ((1, 8, 90, 2, 32), [_ragged(90, 3)], "float", -1.0),
    "R5 d32 no key in the first tile": ((1, 5, 140, 1, 32),
                                        [np.r_[np.zeros(64), np.ones(66), np.zeros(10)]
                                         .astype(bool)], "batch", 1.0),
    "R5 d32 a batch row without a key": ((2, 5, 66, 1, 32), [66, 0], "batch", 1.0),
}


def _case(name, seed=0):
    """q, k, v, dO (B, R, N, H, D) f32 numpy, the shared mask (B, N) or None,
    the tie scale, sm_scale. Masked columns of q, k, v are zeroed, as
    ops/attention.py pre-zeroes padded entries."""
    (b, r, n, h, d), valid, tie, sign = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, r, n, h, d)).astype(np.float32) for _ in range(4))
    mask = None
    if valid is not None:
        mask = np.stack([np.arange(n) < x if np.isscalar(x) else np.asarray(x, bool)
                         for x in valid])
        q, k, v = (t * mask[:, None, :, None, None] for t in (q, k, v))
    if tie == "batch":
        tie = (1.0 + np.arange(b, dtype=np.float32) * r) ** -0.5
    elif tie == "float":
        tie = 0.3
    return q, k, v, do, mask, tie, sign * d**-0.5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _torch_args(name, dtype, seed=0):
    """The backward's arguments as the autograd Function gives them: lse
    from the plain training forward, dsum = tied_row_dsum(out, dO)."""
    q, k, v, do, mask, tie, scale = _case(name, seed)
    tm = None if mask is None else torch.from_numpy(mask)
    tt = torch.as_tensor(tie, dtype=torch.float32) if isinstance(tie, np.ndarray) else tie
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    out, lse = tied_row.tied_row_attention_lse_reference(tq, tk, tv, tm, tm, scale, tt)
    return (tq, tk, tv, tdo, lse, tied_row.tied_row_dsum(out, tdo), tm, tm, scale, tt)


_JAX = {}


def _jax_grads(name, seed, rounded=False):
    """jax.grad of JAX's tied_row_attention (interpret mode) in f32, as f32
    numpy; with ``rounded``, on the inputs rounded to bf16 first (the
    values the bf16 walk sees). Cached: both column widths compare with one
    JAX run."""
    key = (name, seed, rounded)
    if key not in _JAX:
        q, k, v, do, mask, tie, scale = _case(name, seed)
        if rounded:
            q, k, v, do = (_t(a, torch.bfloat16).float().numpy() for a in (q, k, v, do))
        jm = None if mask is None else jnp.asarray(mask)
        jt = jnp.asarray(tie) if isinstance(tie, np.ndarray) else tie

        def loss(q, k, v):
            out = jax_tied(q, k, v, q_mask=jm, kv_mask=jm, sm_scale=scale, tie_scale=jt,
                           interpret=True)
            return jnp.sum(out * jnp.asarray(do))

        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        _JAX[key] = [np.asarray(g, dtype=np.float32) for g in grads]
    return _JAX[key]


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_jax_grad_f32(name, columns):
    want = _jax_grads(name, seed=1)
    got = tied_row.hopper_bwd_walk_reference(*_torch_args(name, torch.float32, seed=1),
                                             columns=columns)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_jax_grad_bf16(name):
    """bf16 operands: the walk (p and ds rounded to bf16 before their
    products, lse and dsum from a bf16 forward, outputs rounded to bf16)
    held to the card's bf16 bound against jax.grad in f32 on the same
    rounded inputs. Not against JAX's own bf16 run: it folds the tie scale
    into a rounded copy of q and rounds dq twice (the settled difference of
    ROADMAP section 3), which puts it 4-5e-3 relative L2 from that exact
    gradient itself, so two bf16 runs would differ by both errors."""
    want = _jax_grads(name, seed=2, rounded=True)
    got = tied_row.hopper_bwd_walk_reference(*_torch_args(name, torch.bfloat16, seed=2))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        diff = g.float().numpy() - w
        assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(w).max()
        assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_the_plain_references(name, columns, dtype):
    """The kernels' decomposition and the plain versions the wrappers run
    on the CPU compute one function: f32 at 1e-4; bf16 within the card's
    bound (both round ds to bf16, from logits summed in another order)."""
    args = _torch_args(name, dtype, seed=3)
    got = tied_row.hopper_bwd_walk_reference(*args, columns=columns)
    ref = (tied_row.tied_row_attention_dq_reference(*args),
           *tied_row.tied_row_attention_dkv_reference(*args))
    for g, w in zip(got, ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)
        else:
            diff = (g.float() - w.float()).abs()
            assert float(diff.max()) <= BF16_MAX_REL * float(w.float().abs().max())


def test_a_batch_row_without_a_key_gets_zero_gradients():
    args = _torch_args("R5 d32 a batch row without a key", torch.float32, seed=4)
    assert torch.isposinf(args[4][1]).all()  # its lse
    for columns in COLUMNS:
        for g in tied_row.hopper_bwd_walk_reference(*args, columns=columns):
            assert torch.isfinite(g).all() and (g[1] == 0).all()


def test_walk_recomputes_the_products_once_per_tile_pair_per_group():
    """Per column group and (query tile, key tile) pair that is staged, one
    S and one dO'V'^T over the whole R*D axis in each pass: R*D 320, N 128
    (two tiles a side) at 64 columns, so 5 groups x 4 pairs x 2 products in
    each of dq and dk/dv; a key tile without a valid key (a query tile
    without a live query) is never staged."""
    b, r, n, h, d = 1, 5, 128, 1, 64
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn((b, r, n, h, d), generator=g) for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool)
    shapes = []
    real = torch.Tensor.__matmul__

    def spy(x, y):
        shapes.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    def products(mask):
        out, lse = tied_row.tied_row_attention_lse_reference(q, k, v, mask, mask, 0.125, 0.5)
        args = (q, k, v, do, lse, tied_row.tied_row_dsum(out, do), mask, mask, 0.125, 0.5)
        shapes.clear()
        torch.Tensor.__matmul__ = spy
        try:
            tied_row.hopper_bwd_walk_reference(*args, columns=64)
        finally:
            torch.Tensor.__matmul__ = real
        return [s for s in shapes if s[0][-1] == r * d]

    assert products(mask) == [((1, 64, 320), (1, 320, 64))] * (5 * 4 * 2 * 2)
    mask[:, 64:] = False
    assert len(products(mask)) == 5 * 1 * 2 * 2


# ------------------------------------------------------------------ K3 past 128


def test_walk_as_rows_of_64_matches_jax_grad_at_head_dim_256():
    """K3a/K3b past head dim 128: a (B, H, N, 256) view read as 4 rows of
    64 features with tie 1 is the same problem; the walk on it equals
    jax.grad of JAX's fused_attention at 1e-4 on every entry."""
    b, h, nq, nk, d = 2, 2, 19, 23, 256
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    qm = np.ones((b, nq), bool)
    qm[1, 15:] = False
    km = np.ones((b, nk), bool)
    km[0, 20:] = False
    scale = d**-0.5

    def loss(q, k, v):
        out = jax_fused(q, k, v, q_mask=jnp.asarray(qm), kv_mask=jnp.asarray(km),
                        sm_scale=scale, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tdo, tqm, tkm = (torch.from_numpy(a) for a in (q, k, v, do, qm, km))
    out, lse = axial.fused_attention_lse_reference(tq, tk, tv, tqm, tkm, scale)
    dsum = axial.attention_dsum(out, tdo)
    row = axial.row_width(d)

    def rows(t):  # (B, H, N, R*64) -> (B, R, N, H, 64), a view
        return t.reshape(b, h, t.shape[2], d // row, row).permute(0, 3, 2, 1, 4)

    got = tied_row.hopper_bwd_walk_reference(rows(tq), rows(tk), rows(tv), rows(tdo), lse,
                                             dsum, tqm, tkm, scale, 1.0)
    for g, w in zip(got, want):
        g = g.permute(0, 3, 2, 1, 4).reshape(b, h, -1, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_row_width_of_a_head_dim_past_128():
    assert [axial.row_width(d) for d in (192, 256, 320, 200, 160, 129)] == [
        64, 64, 64, 200, 160, 129]


# ------------------------------------------------------------------ plan


def _header_constant(name):
    match = re.search(rf"constexpr \w+ {name} = ([0-9.]+)", HEADER.read_text())
    assert match, name
    return float(match.group(1))


def test_plan_mirror_uses_the_kernel_constants():
    assert tied_row.TILE == _header_constant("kRows")
    assert tied_row.BWD_MAX_STAGES == _header_constant("kMaxStages")
    assert tied_row.SMS == _header_constant("kSMs")
    assert tied_row.SMEM_LIMIT == _header_constant("kSmemLimit")
    assert tied_row.BWD_CONTROL_BYTES == _header_constant("kControlBytes")
    assert tied_row.THREADS == 128 + 32
    # the control block: 2 full, 2 empty and 1 resident barrier (8 bytes
    # each, then 16-byte alignment), 2 x 64 lse and dsum floats, 2 x 2 mask
    # words and 2 tile starts, rounded to 16 bytes
    s = tied_row.BWD_MAX_STAGES
    control = -(-(2 * s + 1) * 8 // 16) * 16 + 2 * s * 64 * 4 + 3 * s * 4
    assert -(-control // 16) * 16 <= tied_row.BWD_CONTROL_BYTES


# (which, b, h, nq, nk, features, row width) -> (kernel, columns, groups,
# stages, blocks, shared memory), as the C plan gave them on an H100
# (chip_smoke.py check_k2_bwd_plans)
PLANS = {
    "train dq": (("dq", 1, 8, 64, 64, 320, 64), ("tied_dq_kernel_sm90<64,64>", 64, 5, 1, 40,
                                                 166_016)),
    "train dkv": (("dkv", 1, 8, 64, 64, 320, 64), ("tied_dkv_kernel_sm90<64,64>", 64, 5, 1,
                                                   40, 166_016)),
    "serve-size grid dq": (("dq", 4, 8, 128, 128, 320, 64), ("tied_dq_kernel_sm90<64,128>",
                                                             128, 3, 1, 192, 166_016)),
    "serve-size grid dkv": (("dkv", 4, 8, 128, 128, 320, 64), ("tied_dkv_kernel_sm90<64,64>",
                                                               64, 5, 1, 320, 166_016)),
    "K3 head dim 256 dq": (("dq", 2, 4, 200, 150, 256, 64), ("tied_dq_kernel_sm90<64,64>", 64,
                                                             4, 2, 128, 198_784)),
    "K3 head dim 256 dkv": (("dkv", 2, 4, 200, 150, 256, 64), ("tied_dkv_kernel_sm90<64,64>",
                                                               64, 4, 2, 96, 198_784)),
    "K3 head dim 192 dq": (("dq", 1, 2, 130, 130, 192, 64), ("tied_dq_kernel_sm90<64,64>", 64,
                                                             3, 2, 18, 149_632)),
    "d32 dq": (("dq", 3, 2, 100, 100, 256, 32), ("tied_dq_kernel_sm90<32,64>", 64, 4, 2, 48,
                                                 198_784)),
    "d32, 128 columns dq": (("dq", 16, 8, 70, 70, 128, 32), ("tied_dq_kernel_sm90<32,128>", 128,
                                                             1, 2, 256, 100_480)),
    "d32, 128 columns dkv": (("dkv", 16, 8, 70, 70, 128, 32), ("tied_dkv_kernel_sm90<32,64>",
                                                               64, 2, 2, 512, 100_480)),
    "d128 dq": (("dq", 2, 2, 70, 70, 256, 128), ("tied_dq_kernel_sm90<128,64>", 64, 4, 2, 32,
                                                 198_784)),
    "d128, 128 columns dq": (("dq", 8, 8, 128, 128, 256, 128), ("tied_dq_kernel_sm90<128,128>",
                                                                128, 2, 2, 256, 198_784)),
    "d128, 128 columns dkv": (("dkv", 8, 8, 128, 128, 256, 128),
                              ("tied_dkv_kernel_sm90<128,64>", 64, 4, 2, 512, 198_784)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_mirror_matches_the_card(name):
    args, want = PLANS[name]
    plan = tied_row.hopper_bwd_plan(*args)
    assert (plan["kernel"], plan["columns"], plan["groups"], plan["stages"], plan["blocks"],
            plan["dynamic_smem"]) == want
    assert plan["threads"] == 160 and plan["dynamic_smem"] <= tied_row.SMEM_LIMIT


@pytest.mark.parametrize("args", [
    ("dq", 1, 4, 256, 256, 512, 64),  # JAX's gate shape, R*D 512: no room for one stage
    ("dkv", 1, 4, 256, 256, 512, 64),
    ("dq", 1, 2, 130, 130, 200, 200),  # head dim 200: one row of 200
    ("dq", 2, 2, 33, 33, 80, 16),  # head dim 16
    ("dkv", 2, 2, 33, 33, 144, 48),  # head dim 48
])
def test_plan_leaves_the_rest_to_the_chunked_kernels(args):
    assert tied_row.hopper_bwd_plan(*args) is None


def test_plan_reach_and_stages():
    """One stage up to R*D 448 at row width 64 (231,552 of 232,448 bytes),
    two up to 256 (R*D 320: one); dk/dv never takes 128 columns."""
    assert tied_row.hopper_bwd_smem_bytes(448, 1) == 231_552 <= tied_row.SMEM_LIMIT
    assert tied_row.hopper_bwd_plan("dq", 1, 8, 64, 64, 448, 64)["stages"] == 1
    assert tied_row.hopper_bwd_smem_bytes(320, 2) > tied_row.SMEM_LIMIT
    assert tied_row.hopper_bwd_plan("dkv", 1, 8, 64, 64, 256, 64)["stages"] == 2
    assert tied_row.hopper_bwd_plan("dkv", 64, 8, 128, 128, 320, 64)["columns"] == 64
    assert tied_row.hopper_bwd_plan("dq", 64, 8, 128, 128, 320, 64)["columns"] == 128
    with pytest.raises(ValueError):
        tied_row.hopper_bwd_plan("dk", 1, 8, 64, 64, 320, 64)


# ------------------------------------------------------------------ wrappers


def test_wrappers_on_cpu_tensors_launch_nothing():
    args = _torch_args("R5 d64 negative scale", torch.bfloat16)
    fns = (tied_row.tied_row_attention_dq, tied_row.tied_row_attention_dkv)
    before = [(f.launches, f.sm90_launches) for f in fns]
    calls = (tied_row.tied_row_attention_dq_reference.calls,
             tied_row.tied_row_attention_dkv_reference.calls)
    dq = tied_row.tied_row_attention_dq(*args)
    dk, dv = tied_row.tied_row_attention_dkv(*args)
    assert [(f.launches, f.sm90_launches) for f in fns] == before == [(0, 0), (0, 0)]
    assert (tied_row.tied_row_attention_dq_reference.calls,
            tied_row.tied_row_attention_dkv_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
