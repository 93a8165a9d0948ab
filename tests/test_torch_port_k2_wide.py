"""K2 and its backward on the wide route, on the CPU: the plain versions of
their walks, and the plan's mirror.

At R*D past what the resident Hopper kernels hold (512 forward, 448
backward at head dim 64), K2 runs three passes
(``csrc/tied_row_wide_sm90.cuh``): the shared logits as partial products
over feature splits of whole rows, the splits summed in a fixed order with
the softmax (P rounded to bf16, the lse), then P V' by groups of 64 or 128
output columns; its backward the same with S and dO'V'^T, p and ds rounded
to bf16, then dq = s dS K', dk = s dS^T Q' and dv = P^T dO'. Here
``tied_row.wide_walk_reference`` and ``wide_bwd_walk_reference`` (those
walks) are held

- against JAX's ``tied_row_attention`` (``alphafold2_tpu/ops/pallas/
  tied_row.py``) in interpret mode and ``jax.grad`` of it: f32 at 1e-5, bf16
  within chip_smoke.py's bf16 bound (2^-6 of max|JAX|, relative L2 4e-3;
  the backward against JAX's f32 gradient on the same bf16-rounded inputs,
  as tests/test_torch_port_k2_bwd_hopper.py does), at R*D 576, 1280 and
  2048 at head dim 64 and 576 at head dim 32, N not a multiple of 64,
  prefix and ragged masks, a per-batch tie, a negative scale and a batch
  row without a valid key, at every split count the plan chooses on the
  port's shapes and both column widths;
- equal to the plain versions the wrappers run on the CPU
  (``tied_row_attention_lse_reference``, ``_dq_reference``,
  ``_dkv_reference``);

and ``tied_row.wide_plan`` / ``wide_bwd_plan`` are held to the header's
constants, to the routes (resident shapes stay resident) and to their
arithmetic at the port's wide shapes. ``tied_row_attention_grads`` on CPU
tensors launches nothing and equals the two wrappers. Inputs are drawn with
numpy from seeds and handed to both frameworks.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops.pallas.tied_row import tied_row_attention as jax_tied
from alphafold2_tpu_torch.ops.cuda import tied_row

ATOL = 1e-5  # f32, relative to the compared tensor's largest entry where that exceeds 1


def _f32_close(got, want):
    """f32 agreement at ATOL of max(1, max|want|): the logits sum R*D
    products in f32 in another order than JAX's, an error that grows with
    R*D and the logits' size (about 1e-5 of the output's scale at R*D 2048
    for each side against a float64 evaluation)."""
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())),
                               rtol=0)


BF16_MAX_REL, BF16_L2_REL = 2**-6, 4e-3  # chip_smoke.py TOL["bfloat16"]
COLUMNS = (64, 128)  # the products' two widths
HEADER = (Path(tied_row.__file__).resolve().parents[2] / "csrc" / "tied_row_wide_sm90.cuh")

# the port's wide shapes (b, r, h, n, d): the PLM grid's tied rows (distogram
# and end to end), config_4's MSA rows, JAX's gate shapes
PORT_SHAPES = {"plm": (1, 128, 8, 128, 64), "plm e2e": (1, 192, 8, 192, 64),
               "config_4": (1, 16, 8, 128, 64), "edge 1280": (1, 20, 2, 48, 64),
               "gate bwd 512": (1, 8, 4, 256, 64)}


def _port_splits():
    """Every split count the plans choose on PORT_SHAPES, forward and
    backward."""
    found = set()
    for b, r, h, n, d in PORT_SHAPES.values():
        for plan in (tied_row.wide_plan(b, r, h, n, n, d),
                     tied_row.wide_bwd_plan(b, h, n, n, r * d, d)):
            if plan is not None:
                found.add(plan["splits"])
    return sorted(found)


SPLITS = _port_splits()


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
    "R*D 576 d64 prefix": ((2, 9, 70, 1, 64), [70, 41], "batch", 1.0),
    "R*D 1280 d64 ragged negative": ((1, 20, 90, 2, 64), [_ragged(90, 1)], "batch", -1.0),
    "R*D 2048 d64 a row without a key": ((2, 32, 66, 1, 64), [66, 0], "batch", 1.0),
    "R*D 576 d32 ragged": ((2, 18, 75, 1, 32), [_ragged(75, 2), _ragged(75, 3)], "float", 1.0),
}


def _case(name, seed=0):
    """q, k, v, dO (B, R, N, H, D) f32 numpy, the shared mask (B, N), the tie
    scale, sm_scale. Masked columns of q, k, v are zeroed, as
    ops/attention.py pre-zeroes padded entries."""
    (b, r, n, h, d), valid, tie, sign = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, r, n, h, d)).astype(np.float32) for _ in range(4))
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


def _fwd_args(name, dtype, seed=0):
    q, k, v, _, mask, tie, scale = _case(name, seed)
    tm = torch.from_numpy(mask)
    tt = torch.as_tensor(tie, dtype=torch.float32) if isinstance(tie, np.ndarray) else tie
    return (*(_t(a, dtype) for a in (q, k, v)), tm, tm, scale, tt)


def _bwd_args(name, dtype, seed=0, exact_stats=False):
    """The backward's arguments as the autograd Function gives them: lse
    from the plain training forward, dsum = tied_row_dsum(out, dO). With
    ``exact_stats``, lse and dsum from the f32 forward of the same
    (rounded) inputs instead of the forward in ``dtype``."""
    q, k, v, do, mask, tie, scale = _case(name, seed)
    tm = torch.from_numpy(mask)
    tt = torch.as_tensor(tie, dtype=torch.float32) if isinstance(tie, np.ndarray) else tie
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    stats = [t.float() for t in (tq, tk, tv, tdo)] if exact_stats else (tq, tk, tv, tdo)
    out, lse = tied_row.tied_row_attention_lse_reference(*stats[:3], tm, tm, scale, tt)
    return (tq, tk, tv, tdo, lse, tied_row.tied_row_dsum(out, stats[3]), tm, tm, scale, tt)


def _stages(name):
    (_, r, _, _, d), *_ = CASES[name]
    return -(-r * d // tied_row.WIDE_STAGE_FEATURES)


def _split_counts(name):
    """The plan's split counts that this case's stages can take: each of
    SPLITS capped at the case's stage count, and 1."""
    return sorted({1, *(min(s, _stages(name)) for s in SPLITS)})


_JAX = {}


def _jax_out(name, dtype, seed):
    key = ("out", name, dtype, seed)
    if key not in _JAX:
        q, k, v, _, mask, tie, scale = _case(name, seed)
        jt = jnp.asarray(tie) if isinstance(tie, np.ndarray) else tie
        out = jax_tied(*(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), q_mask=jnp.asarray(mask),
                       kv_mask=jnp.asarray(mask), sm_scale=scale, tie_scale=jt, interpret=True)
        _JAX[key] = np.asarray(out, dtype=np.float32)
    return _JAX[key]


def _jax_grads(name, seed, rounded=False):
    """jax.grad of JAX's tied_row_attention (interpret mode) in f32; with
    ``rounded``, on the inputs rounded to bf16 first."""
    key = ("grad", name, seed, rounded)
    if key not in _JAX:
        q, k, v, do, mask, tie, scale = _case(name, seed)
        if rounded:
            q, k, v, do = (_t(a, torch.bfloat16).float().numpy() for a in (q, k, v, do))
        jm = jnp.asarray(mask)
        jt = jnp.asarray(tie) if isinstance(tie, np.ndarray) else tie

        def loss(q, k, v):
            out = jax_tied(q, k, v, q_mask=jm, kv_mask=jm, sm_scale=scale, tie_scale=jt,
                           interpret=True)
            return jnp.sum(out * jnp.asarray(do))

        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        _JAX[key] = [np.asarray(g, dtype=np.float32) for g in grads]
    return _JAX[key]


def _keyed_rows(name, shape):
    """(B, R, N, H, D) bool: entries of batch rows with a valid key (JAX
    averages the padding where none is; the kernels give 0)."""
    mask = _case(name)[4]
    return np.broadcast_to(mask.any(-1)[:, None, None, None, None], shape)


def _within_bf16_bound(got, want):
    diff = got - want
    assert np.abs(diff).max() <= BF16_MAX_REL * np.abs(want).max()
    assert np.linalg.norm(diff) <= BF16_L2_REL * np.linalg.norm(want)


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_f32(name):
    want = _jax_out(name, jnp.float32, seed=1)
    rows = _keyed_rows(name, want.shape)
    for splits in _split_counts(name):
        for columns in COLUMNS:
            out, _ = tied_row.wide_walk_reference(*_fwd_args(name, torch.float32, seed=1),
                                                  splits=splits, columns=columns)
            _f32_close(out.numpy()[rows], want[rows])
            assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_bf16(name, columns):
    """bf16 operands: P rounded to bf16 (normalized, where JAX rounds the
    running tile's p), the output to bf16; JAX folds the tie scale into a
    bf16 copy of q where the walk scales the f32 logits. Held to the card's
    bf16 bound."""
    want = _jax_out(name, jnp.bfloat16, seed=2)
    rows = _keyed_rows(name, want.shape)
    out, _ = tied_row.wide_walk_reference(*_fwd_args(name, torch.bfloat16, seed=2),
                                          columns=columns)
    assert out.dtype == torch.bfloat16
    _within_bf16_bound(out.float().numpy()[rows], want[rows])


@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_the_plain_reference(name):
    """The wide walk and the plain version the wrappers run on the CPU
    compute one function: out and lse in f32 at 1e-5, lse +inf on the same rows
    (a batch row without a valid key: out 0)."""
    args = _fwd_args(name, torch.float32, seed=3)
    ref_out, ref_lse = tied_row.tied_row_attention_lse_reference(*args)
    finite = np.isfinite(ref_lse.numpy())
    for splits in _split_counts(name):
        out, lse = tied_row.wide_walk_reference(*args, splits=splits)
        _f32_close(out.numpy(), ref_out.numpy())
        assert np.array_equal(np.isposinf(lse.numpy()), np.isposinf(ref_lse.numpy()))
        _f32_close(lse.numpy()[finite], ref_lse.numpy()[finite])
    keyless = ~args[4].any(-1)
    assert (out[keyless] == 0).all() and torch.isposinf(lse[keyless]).all()


def test_splits_cut_whole_stages_and_sum_in_order():
    """The partials: ``splits`` slices of whole 128-feature stages (the
    last one short at R*D 1280 / 7 splits of 2 stages: 10 stages make 5
    splits), summed in split order."""
    qf, kf = torch.randn(1, 1, 4, 1280), torch.randn(1, 1, 3, 1280)
    cuts = []
    real = torch.Tensor.__matmul__

    def spy(x, y):
        cuts.append(x.shape[-1])
        return real(x, y)

    torch.Tensor.__matmul__ = spy
    try:
        (s,) = tied_row._split_sums([(qf, kf)], 1280, 64, 7)
    finally:
        torch.Tensor.__matmul__ = real
    assert cuts == [256] * 5
    want = sum(qf[..., i:i + 256] @ kf[..., i:i + 256].transpose(-1, -2)
               for i in range(0, 1280, 256))
    assert torch.equal(s, want)


# ------------------------------------------------------------------ backward


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_walk_matches_jax_grad_f32(name):
    want = _jax_grads(name, seed=1)
    args = _bwd_args(name, torch.float32, seed=1)
    for splits in _split_counts(name):
        for columns in COLUMNS:
            got = tied_row.wide_bwd_walk_reference(*args, splits=splits, columns=columns)
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == torch.float32
                _f32_close(g.numpy(), w)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_walk_matches_jax_grad_bf16(name):
    """bf16 operands: the walk's own rounding (p and ds rounded to bf16
    before their products, outputs rounded to bf16) held to the card's bf16
    bound against jax.grad in f32 on the same rounded inputs, given the lse
    and dsum of those inputs' f32 forward (JAX's own bf16 run rounds the tie
    into q and dq twice: ROADMAP section 3). The dsum of a bf16 forward
    (from the bf16 output, as JAX's VJP also forms it) adds its own error,
    which grows with R*D (4.7e-3 relative L2 in dq and dk at R*D 2048, the
    plain versions alike): test_bwd_walk_equals_the_plain_references holds
    the walk there, both sides given that dsum."""
    want = _jax_grads(name, seed=2, rounded=True)
    got = tied_row.wide_bwd_walk_reference(*_bwd_args(name, torch.bfloat16, seed=2,
                                                      exact_stats=True))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _within_bf16_bound(g.float().numpy(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_walk_equals_the_plain_references(name, dtype):
    """The wide backward's walk and the plain versions the wrappers run on
    the CPU compute one function: f32 at 1e-5; bf16 within the card's bound
    (both round ds to bf16, from logits summed in another order)."""
    args = _bwd_args(name, dtype, seed=3)
    ref = (tied_row.tied_row_attention_dq_reference(*args),
           *tied_row.tied_row_attention_dkv_reference(*args))
    for splits in _split_counts(name):
        got = tied_row.wide_bwd_walk_reference(*args, splits=splits)
        for g, w in zip(got, ref):
            assert g.dtype == w.dtype and g.shape == w.shape
            if dtype == torch.float32:
                _f32_close(g.numpy(), w.numpy())
            else:
                diff = (g.float() - w.float()).abs()
                assert float(diff.max()) <= BF16_MAX_REL * float(w.float().abs().max())


def test_a_batch_row_without_a_key_gets_zero_gradients():
    args = _bwd_args("R*D 2048 d64 a row without a key", torch.float32, seed=4)
    assert torch.isposinf(args[4][1]).all()  # its lse
    for g in tied_row.wide_bwd_walk_reference(*args):
        assert torch.isfinite(g).all() and (g[1] == 0).all()


# ------------------------------------------------------------------ plan


def _header_constant(name):
    match = re.search(rf"constexpr [\w ]+ {name} = ([0-9.]+)(LL << (\d+))?;",
                      HEADER.read_text())
    assert match, name
    value = float(match.group(1))
    return value * 2 ** int(match.group(3)) if match.group(2) else value


def test_plan_mirror_uses_the_kernel_constants():
    assert tied_row.TILE == _header_constant("kRows")
    assert tied_row.WIDE_STAGE_FEATURES == _header_constant("kStageFeatures")
    assert tied_row.WIDE_LOGIT_STAGES == _header_constant("kLogitStages")
    assert tied_row.WIDE_PRODUCT_STAGES == _header_constant("kProductStages")
    assert tied_row.WIDE_MAX_SPLITS == _header_constant("kMaxSplits")
    assert tied_row.WIDE_WORKSPACE_BUDGET == _header_constant("kWorkspaceBudget")
    assert tied_row.WIDE_REDUCE_THREADS == _header_constant("kReduceThreads")
    assert tied_row.WIDE_CONTROL_BYTES == _header_constant("kControlBytes")
    assert tied_row.SMS == _header_constant("kSMs")
    assert tied_row.SMEM_LIMIT == _header_constant("kSmemLimit")
    assert tied_row.SMEM_PER_SM == _header_constant("kSmemPerSM")
    # the control block: full and empty barriers of the larger ring, 8 bytes each
    assert 2 * tied_row.WIDE_PRODUCT_STAGES * 8 <= tied_row.WIDE_CONTROL_BYTES
    for ops in (2, 4):
        assert tied_row.wide_logits_smem(ops) <= tied_row.SMEM_LIMIT
    assert tied_row.wide_product_smem(128) <= tied_row.SMEM_LIMIT


# (b, r, h, n, d) -> forward (splits, stages a split, logits blocks, columns,
# workspace bytes), backward the same
PLANS = {
    "plm": ((8, 8, 256, 128, 4_456_448), (4, 16, 128, 128, 4_980_736)),
    "plm e2e": ((7, 14, 504, 128, 8_847_360), (7, 14, 504, 128, 18_284_544)),
    "config_4": ((8, 1, 256, 64, 4_456_448), (4, 2, 128, 64, 4_980_736)),
    "edge 1280": ((5, 2, 10, 64, 180_224), (5, 2, 10, 64, 376_832)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_at_the_port_shapes(name):
    b, r, h, n, d = PORT_SHAPES[name]
    for plan, want in ((tied_row.wide_plan(b, r, h, n, n, d), PLANS[name][0]),
                       (tied_row.wide_bwd_plan(b, h, n, n, r * d, d), PLANS[name][1])):
        assert (plan["splits"], plan["stages_per_split"], plan["blocks"], plan["columns"],
                plan["workspace"]) == want
        assert plan["splits"] * plan["stages_per_split"] >= plan["stages"]
        assert (plan["splits"] - 1) * plan["stages_per_split"] < plan["stages"]
        for p in plan["passes"]:
            assert p["dynamic_smem"] <= tied_row.SMEM_LIMIT and p["threads"] % 32 == 0


def test_plan_names_each_pass():
    b, r, h, n, d = PORT_SHAPES["plm"]
    fwd = [p["kernel"] for p in tied_row.wide_plan(b, r, h, n, n, d)["passes"]]
    bwd = [p["kernel"] for p in tied_row.wide_bwd_plan(b, h, n, n, r * d, d)["passes"]]
    assert fwd == ["tied_wide_logits_kernel<64,2>", "tied_wide_softmax_kernel",
                   "tied_wide_product_kernel<64,128>"]
    assert bwd == ["tied_wide_logits_kernel<64,4>", "tied_wide_grad_kernel",
                   "tied_wide_product_kernel<64,128>", "tied_wide_product_kernel<64,128>"]
    assert tied_row.wide_plan(b, r, h, n, n, d)["kernel"] == fwd[0]


def test_routes_keep_the_resident_shapes_and_take_the_rest():
    """The resident kernels keep every shape they take (the main path's
    R*D 320, the gate's forward at 512); the wide route takes the wider
    ones at head dims 32, 64 and 128; other head dims and partial rows take
    neither."""
    for shape in ((4, 5, 8, 128, 64), (1, 5, 8, 64, 64), (1, 8, 4, 256, 64)):
        b, r, h, n, d = shape
        assert tied_row.hopper_plan(b, r, h, n, d) is not None
        assert tied_row.wide_plan(b, r, h, n, n, d) is None
    assert tied_row.hopper_bwd_plan("dq", 1, 8, 64, 64, 320, 64) is not None
    assert tied_row.wide_bwd_plan(1, 8, 64, 64, 320, 64) is None
    assert tied_row.wide_bwd_plan(1, 4, 256, 256, 512, 64) is not None  # the gate's backward
    for d, r in ((32, 18), (64, 9), (128, 5)):
        assert tied_row.hopper_plan(1, r, 2, 70, d) is None
        assert tied_row.wide_plan(1, r, 2, 70, 70, d)["kernel"] == \
            f"tied_wide_logits_kernel<{d},2>"
    assert tied_row.wide_plan(1, 20, 2, 70, 70, 48) is None
    assert tied_row.wide_bwd_plan(1, 2, 70, 70, 1000, 64) is None
    assert tied_row.wide_bwd_plan(1, 2, 70, 70, 960, 48) is None


def test_split_count_fills_the_waves_within_the_budget():
    """Forward blocks share an SM two at a time (99,456 bytes), backward
    blocks not (197,760): the PLM grid's 32 tile pairs take 8 splits (256
    blocks, one wave) forward and 4 (128) backward; a grid that already
    fills the card takes one split; the partials stay within the budget."""
    assert tied_row.wide_logits_smem(2) == 99_456
    assert tied_row.wide_logits_smem(4) == 197_760
    assert tied_row.wide_plan(64, 16, 8, 128, 128, 64)["splits"] == 1
    big = tied_row.wide_bwd_plan(4, 8, 512, 512, 8192, 64)
    plane = 4 * 8 * 512 * 512 * 4 * 2
    assert big["splits"] == 1 or big["splits"] * plane <= tied_row.WIDE_WORKSPACE_BUDGET


# ------------------------------------------------------------------ wrappers


def test_grads_on_cpu_tensors_launch_nothing_and_equal_the_wrappers():
    args = _bwd_args("R*D 576 d64 prefix", torch.bfloat16)
    fns = (tied_row.tied_row_attention_dq, tied_row.tied_row_attention_dkv)
    before = [(f.launches, f.sm90_launches, f.wide_launches) for f in fns]
    dq, dk, dv = tied_row.tied_row_attention_grads(*args)
    assert [(f.launches, f.sm90_launches, f.wide_launches) for f in fns] == before
    assert torch.equal(dq, tied_row.tied_row_attention_dq(*args))
    wk, wv = tied_row.tied_row_attention_dkv(*args)
    assert torch.equal(dk, wk) and torch.equal(dv, wv)


def test_autograd_backward_takes_the_joint_route():
    """TiedRowAttention's backward runs tied_row_attention_grads: on the
    CPU the plain dq and dk/dv versions once each."""
    q, k, v, _, mask, tie, scale = _case("R*D 576 d32 ragged", seed=5)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    calls = (tied_row.tied_row_attention_dq_reference.calls,
             tied_row.tied_row_attention_dkv_reference.calls)
    out = tied_row.tied_row_attention(*leaves, q_mask=tm, kv_mask=tm, sm_scale=scale,
                                      tie_scale=tie)
    out.sum().backward()
    assert (tied_row.tied_row_attention_dq_reference.calls,
            tied_row.tied_row_attention_dkv_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in leaves)
