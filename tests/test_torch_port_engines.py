"""The trunk engines on the port against the JAX package, on the CPU.

- Remat (``Trunk(remat=True)``) under each policy, None, "nothing", "dots"
  and "dots_no_batch", against JAX's ``Trunk(remat=True, remat_policy=...)``
  on the same flax parameters through the converter, and against the port's
  default engine; the policy validation raises where JAX's does.
- The scanned trunk: JAX's scanned ``Alphafold2`` converted, logits and
  gradients; the port's scan against its own loop on stacked parameters;
  scan with remat; the heterogeneous-sparse refusal.
- The reversible engine: JAX's ``Trunk(reversible=True)`` converted, its
  forward and ``jax.grad``; the custom backward against the port's own
  plain-autograd path (f32, bf16 compute with its float32 carry, the
  block-sparse pair pass); ``RevLayerPair.invert``; the no-mask path; the
  refusals.
- Serving with ``model.remat=True`` (``predict``, ``ServeEngine``) equals
  ``remat=False`` bit for bit; it raised before the engines were ported.
- The converter maps JAX's stacked trees exactly once and refuses a depth
  mismatch; ``init_params`` gives each depth slice flax's scale.
- Both training loops run 2 steps under each engine.

Tolerances, all float32 unless said: trunk outputs and logits within 1e-5
absolute on valid positions (the port gives masked query rows 0 where JAX's
dense path gives them uniform attention, and the losses read valid
positions only); every gradient leaf within 1e-5 relative L2 of JAX's (and
of the port's plain path for the reversible backward, of the port's own
default engine for remat, where the forward must be bit-equal).
Inputs come from numpy seeds; JAX runs its dense path (``use_flash=False``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.models.trunk import Trunk as JTrunk
from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.models.reversible import ReversibleTrunk, RevLayerPair
from alphafold2_tpu_torch.models.trunk import Trunk, resolve_remat_policy
from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
from alphafold2_tpu_torch.ops.layers import Dense
from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig
from alphafold2_tpu_torch.predict import build_model, init_params, predict
from alphafold2_tpu_torch.serve.engine import ServeEngine
from alphafold2_tpu_torch.train import end2end, loop

ATOL = 1e-5  # outputs and logits, absolute
REL_L2 = 1e-5  # gradient leaves, relative L2
B, N, M, NM, D = 1, 6, 3, 6, 16
TRUNK = dict(dim=D, depth=2, heads=2, dim_head=8)
POLICIES = [None, "nothing", "dots", "dots_no_batch"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _streams(seed=0):
    """Pair and MSA grids, masks with the last row/column (pair) and last
    position (MSA) padded, and the loss weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, N, D)).astype(np.float32)
    m = rng.standard_normal((B, M, NM, D)).astype(np.float32)
    pm = np.ones((B, N, N), bool)
    pm[:, -1] = pm[:, :, -1] = False
    mm = np.ones((B, M, NM), bool)
    mm[:, :, -1] = False
    wx = rng.standard_normal(x.shape).astype(np.float32) * pm[..., None]
    wm = rng.standard_normal(m.shape).astype(np.float32) * mm[..., None]
    return x, m, pm, mm, wx, wm


def _jax_trunk_grads(module, params, x, m, pm, mm, wx, wm):
    """JAX's outputs and the gradient of the valid-position loss with
    respect to the parameters and both streams."""

    def loss(p, x, m):
        xo, mo = module.apply(p, x, m, pm, mm)
        return jnp.sum(jnp.sin(xo) * wx) + jnp.sum(jnp.sin(mo) * wm), (xo, mo)

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(m))
    return [np.asarray(o) for o in out], grads


def _flax_params(module, seed, *args, **kwargs):
    """A flax parameter tree for ``module`` from its shapes alone (no init
    compile), drawn with numpy: kernels N(0, 1/fan_in), LayerNorm scales
    near 1, biases and embeddings small and nonzero."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z * s.shape[-2] ** -0.5
        return 1.0 + 0.1 * z if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_trunk_grads(trunk, x, m, pm, mm, wx, wm):
    """The port's outputs and gradients (parameters by name, then streams)."""
    xt, mt = (torch.from_numpy(a).requires_grad_() for a in (x, m))
    xo, mo = trunk(xt, mt, torch.from_numpy(pm), torch.from_numpy(mm))
    loss = ((torch.sin(xo) * torch.from_numpy(wx)).sum()
            + (torch.sin(mo) * torch.from_numpy(wm)).sum())
    trunk.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in trunk.named_parameters()}
    return (xo.detach().numpy(), mo.detach().numpy()), grads, (xt.grad.numpy(), mt.grad.numpy())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_against_jax(port, jax_out, jax_grads, module, pm, mm):
    (xo, mo), grads, (gx, gm) = port
    assert np.abs((xo - jax_out[0]) * pm[..., None]).max() <= ATOL
    assert np.abs((mo - jax_out[1]) * mm[..., None]).max() <= ATOL
    jgp, jgx, jgm = jax_grads
    ref = convert.to_state_dict(jax.tree.map(np.asarray, jgp), module)
    assert set(ref) == set(grads)
    worst = max(_rel_l2(grads[k].numpy(), ref[k].numpy()) for k in ref)
    assert worst <= REL_L2, worst
    assert _rel_l2(gx, np.asarray(jgx)) <= REL_L2
    assert _rel_l2(gm, np.asarray(jgm)) <= REL_L2


# ------------------------------------------------------------------ remat


@pytest.fixture(scope="module")
def remat_case():
    """JAX's remat trunk under each policy, on one flax init."""
    x, m, pm, mm, wx, wm = _streams(1)
    params = _flax_params(JTrunk(**TRUNK), 3, x, m)
    ref = {policy: _jax_trunk_grads(JTrunk(**TRUNK, use_flash=False, remat=True,
                                           remat_policy=policy),
                                    params, x, m, pm, mm, wx, wm)
           for policy in POLICIES if policy != "nothing"}
    # JAX resolves "nothing" to None (models/trunk.py:184): one program
    ref["nothing"] = ref[None]
    return params, (x, m, pm, mm, wx, wm), ref


def _port_trunk(params, **kw):
    trunk = Trunk(**TRUNK, **kw)
    trunk.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), trunk))
    return trunk


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_under_each_policy(remat_case, policy):
    params, inputs, ref = remat_case
    trunk = _port_trunk(params, remat=True, remat_policy=policy)
    port = _port_trunk_grads(trunk, *inputs)
    _check_against_jax(port, *ref[policy], trunk, *inputs[2:4])


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_the_default_engine(remat_case, policy):
    """Same parameter tree (``layer_i``) as the default engine, the forward
    bit for bit, the gradients equal."""
    params, inputs, _ = remat_case
    plain = _port_trunk(params)
    remat = _port_trunk(params, remat=True, remat_policy=policy)
    assert list(remat.state_dict()) == list(plain.state_dict())
    (xo, mo), g_plain, gin_plain = _port_trunk_grads(plain, *inputs)
    (xr, mr), g_remat, gin_remat = _port_trunk_grads(remat, *inputs)
    assert np.array_equal(xo, xr) and np.array_equal(mo, mr)
    for k in g_plain:
        torch.testing.assert_close(g_remat[k], g_plain[k], rtol=0, atol=0)
    for a, b in zip(gin_plain, gin_remat):
        np.testing.assert_array_equal(a, b)


def test_remat_policy_validation_raises_as_jax_does():
    """An unknown name; a real policy with remat off or with the reversible
    engine; "nothing" and None always allowed. JAX raises the same."""
    x, m = jnp.zeros((1, 4, 4, D)), jnp.zeros((1, 2, 4, D))
    cases = [(dict(remat=True, remat_policy="bogus"), "unknown remat_policy"),
             (dict(remat=False, remat_policy="dots"), "has no effect"),
             (dict(remat=True, reversible=True, remat_policy="dots_no_batch"), "reversible")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            Trunk(**TRUNK, **kw)
        with pytest.raises(ValueError, match=match):
            JTrunk(**TRUNK, **kw).init(jax.random.key(0), x, m)
    for kw in (dict(remat_policy="nothing"), dict(remat=False, remat_policy=None),
               dict(reversible=True, remat_policy="nothing")):
        Trunk(**TRUNK, **kw)
    assert resolve_remat_policy(None) is None and resolve_remat_policy("nothing") is None


# ------------------------------------------------------------------ scan


SCAN_MODEL = dict(dim=32, depth=3, heads=2, dim_head=16, max_seq_len=16)


def _tokens(seed=0, n=8):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 21, (1, n)).astype(np.int32)
    msa = rng.integers(0, 21, (1, 2, n)).astype(np.int32)
    mask = np.ones((1, n), bool)
    mask[:, -2:] = False
    return seq, msa, mask, np.ones((1, 2, n), bool)


def _logit_loss(logits, pair_valid, w):
    return (torch.sin(logits) * w * pair_valid[..., None]).sum()


def test_scan_matches_jax_scanned_alphafold2():
    seq, msa, mask, msa_mask = _tokens()
    jmodel = JAlphafold2(**SCAN_MODEL, scan_layers=True, use_flash=False)
    model = Alphafold2(**SCAN_MODEL, scan_layers=True)
    params = _flax_params(jmodel, 5, seq, msa, mask=mask, msa_mask=msa_mask)
    model.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), model))
    valid = mask[:, :, None] & mask[:, None, :]
    w = np.random.default_rng(6).standard_normal((1, 8, 8, 37)).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply(p, seq, msa, mask=mask, msa_mask=msa_mask)
        return jnp.sum(jnp.sin(logits) * w * valid[..., None]), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    t = lambda a: torch.from_numpy(a)
    logits = model(t(seq).long(), t(msa).long(), mask=t(mask), msa_mask=t(msa_mask))
    assert np.abs((logits.detach().numpy() - np.asarray(jlogits)) * valid[..., None]).max() <= ATOL
    _logit_loss(logits, t(valid), t(w)).backward()
    ref = convert.to_state_dict(jax.tree.map(np.asarray, jgrads), model)
    for name, p in model.named_parameters():
        assert _rel_l2(p.grad.numpy(), ref[name].numpy()) <= REL_L2, name


def _loop_to_scan(loop_model, scan_model):
    """The loop's ``trunk.layer_i`` parameters stacked into the scan's
    ``trunk.scan.layer`` (everything else shared)."""
    sd = loop_model.state_dict()
    out = {}
    for key in scan_model.state_dict():
        if key.startswith("trunk.scan.layer."):
            leaf = key[len("trunk.scan.layer."):]
            out[key] = torch.stack([sd[f"trunk.layer_{i}.{leaf}"]
                                    for i in range(SCAN_MODEL["depth"])])
        else:
            out[key] = sd[key]
    return out


def test_scan_equals_loop_with_stacked_params():
    seq, msa, mask, msa_mask = (torch.from_numpy(a) for a in _tokens(1))
    loop_model = init_params(Alphafold2(**SCAN_MODEL), seed=3)
    scan_model = Alphafold2(**SCAN_MODEL, scan_layers=True)
    scan_model.load_state_dict(_loop_to_scan(loop_model, scan_model))
    args = (seq.long(), msa.long())
    out_loop = loop_model(*args, mask=mask, msa_mask=msa_mask)
    out_scan = scan_model(*args, mask=mask, msa_mask=msa_mask)
    torch.testing.assert_close(out_scan, out_loop, rtol=0, atol=ATOL)
    count = lambda mod: sum(p.numel() for p in mod.parameters())
    assert count(loop_model) == count(scan_model)


def test_scan_with_remat_checkpoints_each_step_and_keeps_grads(monkeypatch):
    from alphafold2_tpu_torch.models import trunk as trunk_module

    seq, msa, mask, msa_mask = (torch.from_numpy(a) for a in _tokens(2))
    base = init_params(Alphafold2(**SCAN_MODEL, scan_layers=True), seed=4)
    remat = Alphafold2(**SCAN_MODEL, scan_layers=True, remat=True, remat_policy="dots")
    remat.load_state_dict(base.state_dict())
    policies = []
    checkpoint = trunk_module.checkpoint

    def counting(*args, **kwargs):
        policies.append(kwargs.get("context_fn"))
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(trunk_module, "checkpoint", counting)
    grads = []
    for model in (base, remat):
        logits = model(seq.long(), msa.long(), mask=mask, msa_mask=msa_mask)
        (logits**2).sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert len(policies) == SCAN_MODEL["depth"] and all(p is not None for p in policies)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def test_scan_rejects_heterogeneous_sparse():
    with pytest.raises(ValueError, match="homogeneous"):
        Alphafold2(**SCAN_MODEL, scan_layers=True, sparse_self_attn=(True, False, True))


# ------------------------------------------------------------------ reversible


@pytest.fixture(scope="module")
def reversible_case():
    """JAX's reversible trunk (custom vjp): its init, outputs and grads."""
    x, m, pm, mm, wx, wm = _streams(2)
    jtrunk = JTrunk(**TRUNK, use_flash=False, reversible=True)
    params = _flax_params(jtrunk, 4, x, m, pm, mm)
    return params, (x, m, pm, mm, wx, wm), _jax_trunk_grads(jtrunk, params, x, m, pm, mm, wx, wm)


def test_reversible_matches_jax(reversible_case):
    params, inputs, ref = reversible_case
    trunk = _port_trunk(params, reversible=True)
    assert all(k.startswith("reversible.layers.") for k in trunk.state_dict())
    _check_against_jax(_port_trunk_grads(trunk, *inputs), *ref, trunk, *inputs[2:4])


def test_reversible_custom_backward_matches_plain_autograd(reversible_case):
    params, inputs, _ = reversible_case
    trunk = _port_trunk(params, reversible=True)
    (xo, mo), g_custom, gin_custom = _port_trunk_grads(trunk, *inputs)
    trunk.reversible.use_custom_vjp = False
    (xp, mp), g_plain, gin_plain = _port_trunk_grads(trunk, *inputs)
    assert np.abs(xo - xp).max() <= ATOL and np.abs(mo - mp).max() <= ATOL
    for k in g_plain:
        assert _rel_l2(g_custom[k], g_plain[k]) <= REL_L2, k
    for a, b in zip(gin_custom, gin_plain):
        assert _rel_l2(a, b) <= REL_L2


def test_layer_inversion_reconstructs_the_inputs():
    x, m, pm, mm, _, _ = _streams(3)
    layer = init_params(RevLayerPair(D, heads=2, dim_head=8, msa_tie_row_attn=True), seed=5)
    h = tuple(torch.from_numpy(a) for a in (x, 0.5 * x, m, 0.5 * m))
    masks = (torch.from_numpy(pm), torch.from_numpy(mm))
    with torch.no_grad():
        back = layer.invert(layer(h, *masks), *masks)
    for a, b in zip(h, back):
        torch.testing.assert_close(b, a, rtol=0, atol=ATOL)


def test_bf16_compute_keeps_f32_carry_and_grad_parity():
    """JAX's bound (tests/test_reversible.py): per-leaf relative L2 below
    2e-2 and every element within 0.1 of the leaf's scale, custom against
    plain autograd, under bf16 compute."""
    x, m, pm, mm, wx, wm = _streams(4)
    trunk = init_params(ReversibleTrunk(**dict(TRUNK, depth=2), dtype=torch.bfloat16), seed=6)
    (xo, mo), g_custom, _ = _port_trunk_grads(trunk, x, m, pm, mm, wx, wm)
    assert xo.dtype == np.float32 and mo.dtype == np.float32
    trunk.use_custom_vjp = False
    _, g_plain, _ = _port_trunk_grads(trunk, x, m, pm, mm, wx, wm)
    for k, b in g_plain.items():
        a, b = g_custom[k].float().numpy(), b.float().numpy()
        scale = max(np.abs(b).max(), 1.0)
        assert _rel_l2(a, b) < 2e-2, k
        np.testing.assert_allclose(a, b, atol=0.1 * scale, rtol=0)


def test_no_masks_path():
    x, m, *_ = _streams(5)
    trunk = init_params(Trunk(**TRUNK, reversible=True, msa_tie_row_attn=True), seed=7)
    xo, mo = trunk(torch.from_numpy(x), torch.from_numpy(m))
    assert xo.shape == x.shape and mo.shape == m.shape
    assert torch.isfinite(xo).all() and torch.isfinite(mo).all()
    (xo.sum() + mo.sum()).backward()
    assert all(torch.isfinite(p.grad).all() for p in trunk.parameters())


def test_reversible_refusals():
    x = torch.zeros((1, 4, 4, D))
    with pytest.raises(ValueError, match="requires the MSA stream"):
        Trunk(**TRUNK, reversible=True)(x, None)
    for kw, match in ((dict(grid_parallel=True), "grid_parallel"),
                      (dict(msa_row_shard=True), "msa_row_shard"),
                      (dict(context_parallel="ring"), "context_parallel"),
                      (dict(sparse_self_attn=(True, False)), "per-layer")):
        with pytest.raises(ValueError, match=match):
            Trunk(**TRUNK, reversible=True, **kw)
    # precedence: reversible over remat and scan_layers
    trunk = Trunk(**TRUNK, reversible=True, remat=True, scan_layers=True)
    assert trunk.engine == "reversible" and not hasattr(trunk, "scan")


def test_reversible_with_sparse_attention_runs_k4_k5_plain_versions():
    """The block-sparse pair pass (K4/K5's plain versions here) inside the
    custom backward: values and gradients as the plain-autograd path's."""
    _, m, _, mm, _, _ = _streams(6)
    rng = np.random.default_rng(7)
    # the grid route needs block multiples: 32 x 32 at the smallest block, 16
    x = rng.standard_normal((B, 32, 32, D)).astype(np.float32)
    pm = np.ones((B, 32, 32), bool)
    pm[:, -3:] = pm[:, :, -3:] = False
    wx = rng.standard_normal(x.shape).astype(np.float32) * pm[..., None]
    wm = rng.standard_normal(m.shape).astype(np.float32) * mm[..., None]
    m = np.concatenate([m] * 6, axis=2)[:, :, :32]
    mm = np.concatenate([mm] * 6, axis=2)[:, :, :32]
    wm = np.concatenate([wm] * 6, axis=2)[:, :, :32]
    trunk = init_params(ReversibleTrunk(
        **TRUNK, sparse_attn=True, seq_len=32,
        sparse_config=BlockSparseConfig(block_size=16, num_random_blocks=0)), seed=8)
    calls = (bsa.block_sparse_attention_reference.calls,
             bsa.block_sparse_attention_lse_reference.calls,
             bsa.block_sparse_attention_dq_reference.calls)
    (xo, mo), g_custom, _ = _port_trunk_grads(trunk, x, m, pm, mm, wx, wm)
    assert bsa.block_sparse_attention_reference.calls > calls[0]  # the no-grad forward
    assert bsa.block_sparse_attention_lse_reference.calls > calls[1]  # the re-evaluation
    assert bsa.block_sparse_attention_dq_reference.calls > calls[2]
    trunk.use_custom_vjp = False
    (xp, mp), g_plain, _ = _port_trunk_grads(trunk, x, m, pm, mm, wx, wm)
    assert np.abs(xo - xp).max() <= ATOL and np.abs(mo - mp).max() <= ATOL
    for k in g_plain:
        assert _rel_l2(g_custom[k], g_plain[k]) <= REL_L2, k


# ------------------------------------------------------------------ serving


SERVE_MODEL = dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=48, bfloat16=False,
                   msa_tie_row_attn=True)


def _serve_config(**model):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **SERVE_MODEL, **model)
    cfg.data.msa_depth = 3
    cfg.serve = dataclasses.replace(cfg.serve, buckets=(8, 16), max_batch=2, mds_iters=5,
                                    msa_depth=3)
    return cfg


def test_serving_with_remat_equals_serving_without():
    """``model.remat=True`` builds (it raised before the engines were ported)
    and serves the same atom14, bit for bit; serving passes only ``remat``,
    as JAX's ``predict`` and ``ServeEngine`` do, so a reversible or scanned
    config serves the default trunk."""
    plain, remat = _serve_config(), _serve_config(remat=True, remat_policy="dots")
    assert build_model(remat).af2.trunk.remat
    for flag in ("reversible", "scan_layers"):
        assert build_model(_serve_config(**{flag: True})).af2.trunk.engine == "loop"
    a = predict(plain, "ACDEFGHIK", msa_depth=3, seed=1, device="cpu")
    b = predict(remat, "ACDEFGHIK", msa_depth=3, seed=1, device="cpu")
    np.testing.assert_array_equal(a.atom14, b.atom14)
    reqs = ["MKVLAAGIHK", "ACDEFG", "PQRSTVWYAC"]
    ra = ServeEngine(plain, device="cpu").predict_many(reqs)
    rb = ServeEngine(remat, device="cpu").predict_many(reqs)
    for x, y in zip(ra, rb):
        assert x.ok and y.ok
        np.testing.assert_array_equal(x.atom14, y.atom14)


# ------------------------------------------------------------------ converter, init


def _flax_tree(module, *args, **kwargs):
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("engine", ["scan_layers", "reversible"])
def test_converter_maps_stacked_trees_exactly_once(engine, depth):
    kw = dict(dim=16, depth=depth, heads=2, dim_head=8, max_seq_len=24)
    tokens = (jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 2, 4), jnp.int32))
    masks = dict(mask=jnp.ones((1, 4), bool), msa_mask=jnp.ones((1, 2, 4), bool))
    if engine == "scan_layers":
        tree = _flax_tree(JAlphafold2(**kw, scan_layers=True), *tokens, **masks)
        model = Alphafold2(**kw, scan_layers=True)
        stacked = "trunk.scan.layer."
    else:
        tree = _flax_tree(JEnd2End(**kw, reversible=True), *tokens, **masks)
        model = end2end.End2EndModel(**kw, reversible=True)
        stacked = "af2.trunk.reversible.layers."
    sd = convert.to_state_dict(tree, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())
    model.load_state_dict(sd)
    assert all(v.shape[0] == depth for k, v in sd.items() if k.startswith(stacked))
    # a stacked kernel (depth, in, out) -> (depth, out, in)
    ff = "pair_ff" if engine == "scan_layers" else "g_s"
    assert tuple(sd[f"{stacked}{ff}.wi.weight"].shape) == (depth, 8 * 16, 16)
    # a tree of another depth does not fill the model
    other = (Alphafold2(**dict(kw, depth=depth + 1), scan_layers=True)
             if engine == "scan_layers"
             else end2end.End2EndModel(**dict(kw, depth=depth + 1), reversible=True))
    with pytest.raises(ValueError, match="shape"):
        convert.to_state_dict(tree, other)


def test_init_params_gives_each_depth_slice_flax_scale():
    model = init_params(Alphafold2(dim=32, depth=3, heads=2, dim_head=16, max_seq_len=16,
                                   scan_layers=True), seed=0)
    checked = 0
    for name, mod in model.trunk.scan.layer.named_modules():
        if isinstance(mod, Dense):
            assert mod.weight.shape[0] == 3
            for i in range(3):
                std = float(mod.weight[i].detach().std())
                assert abs(std / mod.in_features**-0.5 - 1) < 0.1, (name, i, std)
            checked += 1
    assert checked == 22  # 6 an axial attention, 3 a cross-attention, 2 a feedforward


# ------------------------------------------------------------------ training


def _train_config(e2e, **model):
    return Config(
        model=ModelConfig(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=48,
                          bfloat16=False, **model),
        data=DataConfig(crop_len=8 if e2e else 12, msa_depth=2, msa_len=8 if e2e else 12,
                        batch_size=2, min_len_filter=6),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          numerics="off"))


ENGINES = {"remat": dict(remat=True), "remat_dots": dict(remat=True, remat_policy="dots"),
           "scan": dict(scan_layers=True), "scan_remat": dict(scan_layers=True, remat=True),
           "reversible": dict(reversible=True)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_distogram_training_runs_under_each_engine(engine):
    seen = []
    state = loop.train(_train_config(False, **ENGINES[engine]), num_steps=2, device="cpu",
                       callbacks=[lambda i, s, m: seen.append(
                           (float(m["loss"]), bool(m["grads_ok"])))])
    assert len(seen) == 2 and all(np.isfinite(l) and ok for l, ok in seen)
    assert int(state.skipped) == 0


@pytest.mark.parametrize("engine", ["remat", "reversible"])
def test_end2end_training_runs_under_each_engine(engine):
    seen = []
    cfg = _train_config(True, **ENGINES[engine])
    state = end2end.train_end2end(cfg, num_steps=2, device="cpu", callbacks=[
        lambda i, s, m: seen.append((float(m["loss"]), bool(m["grads_ok"])))])
    assert len(seen) == 2 and all(np.isfinite(l) and ok for l, ok in seen)
    assert int(state.skipped) == 0
    assert state.model.af2.trunk.engine == ("reversible" if engine == "reversible" else "loop")
