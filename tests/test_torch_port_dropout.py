"""Dropout on the port (``ops/attention.py`` ``dropout``, ``DropoutKey`` and
JAX's dense route), on the CPU.

Random streams cannot match across frameworks, so the port is held to JAX
where dropout draws nothing (rates 0 with a key, or rates above 0 without
one, JAX's ``deterministic=True``), and to statistics where it draws:

- ``dropout``: the keep rate within a binomial 5-sigma bound, kept values
  scaled by 1/(1 - rate) in the input's dtype, zeros at rate 1, the input
  itself without a key or at rate 0; the mask a function of (seed, path,
  index);
- attention under dropout: the mean of 256 seeds' outputs within 5 standard
  errors of the output without dropout, entry by entry on valid rows;
- the route: active attention dropout never calls ``fused_attention`` or
  ``tied_row_attention`` (monkeypatched to raise, as JAX's
  ``tests/test_flash.py:33-57`` does), which run without a key; sparse
  attention still calls K4's wrapper and drops its padded output;
- the dense route with the dropout itself switched off equals JAX's dense
  ``Attention`` (flat, cross, tied) within 1e-5, on every row;
- the engines: remat bit-equal to the default engine under one key
  (forward and gradients); the scanned and loop trunks the same under the
  same key and different under another (JAX's
  ``test_scan_dropout_rng_plumbing``); the reversible custom backward
  within 1e-5 relative L2 of its plain-autograd oracle at rates 0.1 (JAX's
  ``test_grad_parity_with_dropout``);
- the loop: two 3-step runs with dropout bit-identical, and a run resumed
  from a checkpoint equal to an uninterrupted one.

Widths: dim 16, heads 2, dim_head 8, depth 2, N <= 16, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.ops import attention as jattn
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.models.reversible import ReversibleTrunk, RevLayerPair
from alphafold2_tpu_torch.models.trunk import Trunk
from alphafold2_tpu_torch.ops import attention as tattn
from alphafold2_tpu_torch.ops import sparse as tsparse
from alphafold2_tpu_torch.ops.attention import DropoutKey, dropout
from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig
from alphafold2_tpu_torch.predict import init_params
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

D, H, DH = 16, 2, 8
ATOL = 1e-5  # f32, module outputs and logits
REL_L2 = 1e-5  # gradient leaves
RATES = dict(attn_dropout=0.1, ff_dropout=0.1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tail_mask(b, n, keep):
    m = np.zeros((b, n), bool)
    for i, k in enumerate(keep):
        m[i, :k] = True
    return m


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ------------------------------------------------------------ the function


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_and_scaling(rate):
    n = 200_000
    x = torch.ones(n)
    y = dropout(x, rate, DropoutKey(3, "site"))
    kept = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) <= 5 * sigma
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1.0 / (1 - rate)))
    xb = torch.full((4096,), 1.5, dtype=torch.bfloat16)
    yb = dropout(xb, rate, DropoutKey(3, "site"))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], (xb / (1 - rate))[yb != 0])


def test_rate_one_zero_and_no_key():
    x = torch.randn(64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(dropout(x, 1.0, DropoutKey(0)), torch.zeros_like(x))
    assert dropout(x, 0.0, DropoutKey(0)) is x
    assert dropout(x, 0.5, None) is x


def test_masks_are_keyed_by_seed_path_and_index():
    x = torch.ones(4096)
    key = DropoutKey.for_step(1, 5).child("trunk").child("layer_0")
    mask = lambda k: dropout(x, 0.5, k) != 0
    assert torch.equal(mask(key), mask(DropoutKey.for_step(1, 5).child("trunk/layer_0")))
    others = [DropoutKey.for_step(1, 6).child("trunk/layer_0"),
              DropoutKey.for_step(2, 5).child("trunk/layer_0"), key.child("msa_ff"),
              key.at(0), key.at(1)]
    masks = [mask(key)] + [mask(k) for k in others]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j]), (i, j)


# -------------------------------------------------------------- attention


def _attention_inputs(kind):
    """(x, mask, context, context_mask, tie_dim) of one attention kind."""
    if kind == "flat":
        return _randn(0, 2, 12, D), _tail_mask(2, 12, (12, 9)), None, None, None
    if kind == "cross":
        return (_randn(1, 2, 10, D), _tail_mask(2, 10, (10, 7)), _randn(2, 2, 14, D),
                _tail_mask(2, 14, (11, 14)), None)
    # tied: B*R = 2*3 rows of 8 positions, the last two positions padded
    mask = np.ones((6, 8), bool)
    mask[:, 6:] = False
    return _randn(3, 6, 8, D), mask, None, None, 3


def _jax_and_port(kind, rate):
    x, mask, ctx, cmask, tie = _attention_inputs(kind)
    jmod = jattn.Attention(dim=D, heads=H, dim_head=DH, dropout=rate, use_flash=False)
    jkw = dict(mask=jnp.asarray(mask), tie_dim=tie,
               context=None if ctx is None else jnp.asarray(ctx),
               context_mask=None if cmask is None else jnp.asarray(cmask))
    params = jmod.init(jax.random.key(0), jnp.asarray(x), **jkw)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), **jkw))
    port = tattn.Attention(D, H, DH, dropout=rate)
    port.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), port))
    tkw = dict(mask=torch.from_numpy(mask), tie_dim=tie,
               context=None if ctx is None else torch.from_numpy(ctx),
               context_mask=None if cmask is None else torch.from_numpy(cmask))
    return ref, port, torch.from_numpy(x), tkw, mask


@pytest.mark.parametrize("kind", ["flat", "cross", "tied"])
def test_dense_route_with_the_drop_switched_off_equals_jax(monkeypatch, kind):
    """A key selects the dense route; with ``dropout`` an identity it is
    JAX's dense ``Attention`` (masked rows included: both give them
    uniform attention)."""
    ref, port, x, tkw, _ = _jax_and_port(kind, 0.1)
    calls = []
    monkeypatch.setattr(tattn, "dropout", lambda t, rate, key: calls.append(rate) or t)
    monkeypatch.setattr(tattn, "fused_attention", _boom)
    monkeypatch.setattr(tattn, "tied_row_attention", _boom)
    with torch.no_grad():
        out = port(x, key=DropoutKey(0), **tkw).numpy()
    assert calls == [0.1]
    assert np.abs(out - ref).max() <= ATOL


@pytest.mark.parametrize("kind", ["flat", "cross", "tied"])
def test_without_a_key_the_kernels_run_and_equal_jax(kind):
    """JAX's ``deterministic=True``: a rate above 0 with no key changes
    nothing; valid rows equal JAX's dense output."""
    ref, port, x, tkw, mask = _jax_and_port(kind, 0.1)
    with torch.no_grad():
        out = port(x, **tkw).numpy()
    valid = np.broadcast_to(mask[..., None], out.shape)
    assert np.abs(np.where(valid, out - ref, 0)).max() <= ATOL


def _boom(*a, **kw):
    raise AssertionError("a kernel ran under active attention dropout")


@pytest.mark.parametrize("tied", [False, True])
def test_active_attention_dropout_never_calls_the_kernels(monkeypatch, tied):
    torch.manual_seed(0)  # parameter init only
    axial = tattn.AxialAttention(D, H, DH, tie_row_attn=tied, dropout=0.1)
    x = torch.from_numpy(_randn(4, 1, 3, 8, D))
    mask = torch.ones(1, 3, 8, dtype=torch.bool)
    monkeypatch.setattr(tattn, "fused_attention", _boom)
    monkeypatch.setattr(tattn, "tied_row_attention", _boom)
    with torch.no_grad():
        out = axial(x, mask=mask, key=DropoutKey(1))
        assert torch.isfinite(out).all()
        with pytest.raises(AssertionError, match="a kernel ran"):
            axial(x, mask=mask)  # no key: the kernels' route
        ff_only = tattn.AxialAttention(D, H, DH, tie_row_attn=tied, dropout=0.0)
        with pytest.raises(AssertionError, match="a kernel ran"):
            ff_only(x, mask=mask, key=DropoutKey(1))  # rate 0: the kernels' route


def test_sparse_attention_keeps_k4_and_drops_its_padded_output(monkeypatch):
    """Under active dropout the sparse passes take the flat route (20 pads
    to 32 here), still through K4's wrapper, and drop the padded output of
    ``to_out`` before the slice, as JAX's ``out_dropout``."""
    torch.manual_seed(0)  # parameter init only
    config = BlockSparseConfig(block_size=16, num_random_blocks=0)
    axial = tattn.AxialAttention(D, H, DH, sparse_attn=True, seq_len=32,
                                 sparse_config=config, dropout=0.25)
    x = torch.from_numpy(_randn(5, 1, 20, 20, D))
    valid = _tail_mask(1, 20, (18,))
    mask = torch.from_numpy(valid[:, :, None] & valid[:, None])
    k4 = []
    real = bsa.block_sparse_attention
    monkeypatch.setattr(bsa, "block_sparse_attention",
                        lambda *a, **kw: k4.append(tuple(a[0].shape)) or real(*a, **kw))
    seen = []

    def fake(t, rate, key):
        seen.append((tuple(t.shape), rate, key is not None))
        return t if key is None else 2 * t

    monkeypatch.setattr(tsparse, "dropout", fake)
    with torch.no_grad():
        plain = axial(x, mask=mask)
        dropped = axial(x, mask=mask, key=DropoutKey(2))
    assert torch.allclose(dropped, 2 * plain, atol=1e-6)
    assert seen == [((20, 32, D), 0.25, False)] * 2 + [((20, 32, D), 0.25, True)] * 2
    assert k4 == [(20, H, 32, DH)] * 4


def test_tied_rows_share_one_mask():
    """One mask per (b, h, i, j), shared by the R rows: identical rows give
    identical outputs under dropout."""
    torch.manual_seed(0)
    attn = tattn.Attention(D, H, DH, dropout=0.5)
    row = torch.from_numpy(_randn(6, 1, 1, 8, D))
    x = row.expand(2, 3, 8, D).reshape(6, 8, D)
    with torch.no_grad():
        out = attn(x, tie_dim=3, key=DropoutKey(9)).reshape(2, 3, 8, D)
        plain = attn(x, tie_dim=3).reshape(2, 3, 8, D)
    assert torch.equal(out[:, 0], out[:, 1]) and torch.equal(out[:, 0], out[:, 2])
    assert not torch.allclose(out, plain)


def test_mean_over_seeds_approaches_the_output_without_dropout():
    torch.manual_seed(0)
    attn = tattn.Attention(D, H, DH, dropout=0.2)
    x = torch.from_numpy(_randn(7, 2, 12, D))
    mask = torch.from_numpy(_tail_mask(2, 12, (12, 9)))
    with torch.no_grad():
        ref = attn(x, mask=mask)
        outs = torch.stack([attn(x, mask=mask, key=DropoutKey(s)) for s in range(256)])
    mean, se = outs.mean(0), outs.std(0) / 16
    valid = mask[..., None].expand_as(ref)
    err = (mean - ref).abs()[valid]
    assert (err <= 5 * se[valid] + 1e-6).all(), float((err / (se[valid] + 1e-12)).max())
    assert float(se[valid].max()) > 0  # the outputs did vary


# ------------------------------------------------------------------ model


def _tokens(seed=0, b=1, n=10, m=3):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 21, (b, n)).astype(np.int32)
    msa = rng.integers(0, 21, (b, m, n)).astype(np.int32)
    mask = _tail_mask(b, n, (n - 2,))
    msa_mask = np.broadcast_to(mask[:, None], (b, m, n)).copy()
    return seq, msa, mask, msa_mask


@pytest.mark.parametrize("rates, keyed", [(0.0, True), (0.1, False)])
def test_model_without_drawn_masks_equals_jax(rates, keyed):
    seq, msa, mask, msa_mask = _tokens()
    kw = dict(dim=D, depth=2, heads=H, dim_head=DH, max_seq_len=16,
              attn_dropout=rates, ff_dropout=rates)
    jmod = JAlphafold2(**kw, use_flash=False)
    jin = [jnp.asarray(a) for a in (seq, msa)]
    params = jmod.init(jax.random.key(0), *jin, mask=jnp.asarray(mask),
                       msa_mask=jnp.asarray(msa_mask))
    ref = np.asarray(jmod.apply(params, *jin, mask=jnp.asarray(mask),
                                msa_mask=jnp.asarray(msa_mask), deterministic=not keyed,
                                rngs={"dropout": jax.random.key(1)}))
    port = Alphafold2(**kw)
    port.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), port))
    with torch.no_grad():
        out = port(torch.from_numpy(seq).long(), torch.from_numpy(msa).long(),
                   mask=torch.from_numpy(mask), msa_mask=torch.from_numpy(msa_mask),
                   dropout_key=DropoutKey(1) if keyed else None).numpy()
    pair = mask[:, :, None] & mask[:, None, :]
    assert np.abs(np.where(pair[..., None], out - ref, 0)).max() <= ATOL


# ---------------------------------------------------------------- engines


def _streams(seed=0, b=1, n=6, m=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, n, D)).astype(np.float32)
    ms = rng.standard_normal((b, m, n, D)).astype(np.float32)
    pm = np.ones((b, n, n), bool)
    pm[:, -1] = pm[:, :, -1] = False
    mm = np.ones((b, m, n), bool)
    mm[:, :, -1] = False
    wx = rng.standard_normal(x.shape).astype(np.float32) * pm[..., None]
    wm = rng.standard_normal(ms.shape).astype(np.float32) * mm[..., None]
    return [torch.from_numpy(a) for a in (x, ms, pm, mm, wx, wm)]


def _run_trunk(trunk, key, seed=0):
    """Outputs and gradients (parameters by name, then the streams)."""
    x, m, pm, mm, wx, wm = _streams(seed)
    x.requires_grad_()
    m.requires_grad_()
    xo, mo = trunk(x, m, pm, mm, key=key)
    loss = (torch.sin(xo) * wx).sum() + (torch.sin(mo) * wm).sum()
    trunk.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in trunk.named_parameters()}
    return (xo.detach(), mo.detach()), grads, (x.grad, m.grad)


def _trunk(**kw):
    torch.manual_seed(0)
    t = Trunk(D, depth=2, heads=H, dim_head=DH, **RATES, **kw)
    init_params(t, 0)
    return t


KEY = DropoutKey.for_step(1, 0).child("trunk")


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_equals_the_default_engine_bit_for_bit(policy):
    default = _trunk()
    remat = _trunk(remat=True, remat_policy=policy)
    remat.load_state_dict(default.state_dict())
    (xo, mo), grads, gin = _run_trunk(default, KEY)
    (rxo, rmo), rgrads, rgin = _run_trunk(remat, KEY)
    assert torch.equal(xo, rxo) and torch.equal(mo, rmo)
    assert all(torch.equal(grads[k], rgrads[k]) for k in grads)
    assert torch.equal(gin[0], rgin[0]) and torch.equal(gin[1], rgin[1])
    (pxo, _), _, _ = _run_trunk(default, None)
    assert not torch.allclose(xo, pxo)  # the key did drop


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_same_key_same_result_other_key_other_result(engine):
    trunk = _trunk(scan_layers=engine == "scan")
    with torch.no_grad():
        run = lambda key: trunk(*_streams()[:4], key=key)[0]
        a, b = run(KEY), run(KEY)
        other = run(DropoutKey.for_step(1, 1).child("trunk"))
        plain = run(None)
    assert torch.equal(a, b)
    assert not torch.allclose(a, other) and not torch.allclose(a, plain)


def test_reversible_custom_backward_matches_its_oracle_under_dropout():
    torch.manual_seed(0)
    custom = ReversibleTrunk(D, depth=2, heads=H, dim_head=DH, **RATES)
    init_params(custom, 0)
    oracle = ReversibleTrunk(D, depth=2, heads=H, dim_head=DH, use_custom_vjp=False, **RATES)
    oracle.load_state_dict(custom.state_dict())
    key = KEY.child("reversible")
    (xo, mo), grads, gin = _run_trunk(custom, key)
    (oxo, omo), ograds, ogin = _run_trunk(oracle, key)
    assert torch.allclose(xo, oxo, atol=ATOL) and torch.allclose(mo, omo, atol=ATOL)
    worst = max(_rel_l2(grads[k], ograds[k]) for k in grads)
    assert worst <= REL_L2, worst
    assert _rel_l2(gin[0], ogin[0]) <= REL_L2 and _rel_l2(gin[1], ogin[1]) <= REL_L2
    (pxo, _), _, _ = _run_trunk(custom, None)
    assert not torch.allclose(xo, pxo)


def test_reversible_inversion_under_one_key():
    """``invert`` under the forward's key undoes it: each sub-function
    draws from its own (layer, sub-function) key, not from call order."""
    torch.manual_seed(0)
    layer = RevLayerPair(D, H, DH, **RATES)
    init_params(layer, 0)
    x, m, pm, mm = _streams()[:4]
    h = (x, x + 1, m, m - 1)
    key = ReversibleTrunk.layer_key(KEY.child("reversible"), 0)
    with torch.no_grad():
        out = layer(h, pm, mm, key=key)
        back = layer.invert(out, pm, mm, key=key)
        wrong = layer.invert(out, pm, mm, key=ReversibleTrunk.layer_key(KEY, 1))
    for a, b in zip(back, h):
        assert torch.allclose(a, b, atol=1e-5)
    assert not all(torch.allclose(a, b, atol=1e-5) for a, b in zip(wrong, h))


# ------------------------------------------------------------------- loop


def _cfg(**train):
    cfg = Config(
        model=ModelConfig(dim=D, depth=2, heads=H, dim_head=DH, max_seq_len=32,
                          bfloat16=False, **RATES),
        data=DataConfig(crop_len=12, msa_depth=2, msa_len=12, batch_size=1, min_len_filter=8),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=10,
                          numerics="off"))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _train(cfg, num_steps):
    losses = []
    state = loop.train(cfg, num_steps=num_steps, device="cpu",
                       callbacks=[lambda i, s, m: losses.append((i, float(m["loss"])))])
    return state, losses


def test_two_runs_with_dropout_are_bit_identical():
    a, la = _train(_cfg(), 3)
    b, lb = _train(_cfg(), 3)
    assert la == lb
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    cfg = _cfg()
    cfg.model.attn_dropout = cfg.model.ff_dropout = 0.0
    _, l0 = _train(cfg, 3)
    assert l0[1:] != la[1:]  # the masks moved the run (step 0's loss is before an update)


def test_resume_with_dropout_equals_an_uninterrupted_run(tmp_path):
    whole, whole_losses = _train(_cfg(), 4)
    cfg = _cfg(checkpoint_dir=str(tmp_path), checkpoint_every=10)
    _, first = _train(cfg, 2)
    resumed, rest = _train(cfg, 4)
    assert first + rest == whole_losses
    sw, sr = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(sw[k], sr[k]) for k in sw)
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
