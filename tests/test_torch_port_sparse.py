"""Block-sparse attention on the port against the JAX package, on the CPU.

- ``BlockSparseConfig.layout`` and ``active_indices`` are equal to JAX's.
- The plain versions of K4 (out, lse), K5a (dq) and K5b (dk, dv) in
  ``ops/cuda/block_sparse.py`` against the JAX Pallas kernels in interpret
  mode, as tests/test_sparse.py runs them, on live rows and valid keys at
  1e-5 (both sides compute in f32). Rows whose active blocks hold no valid
  key give exactly 0 and lse +inf here, and zero gradients.
- Autograd through ``BlockSparseAttention`` against ``jax.grad`` of
  ``block_sparse_attention_pallas``, everywhere, at 1e-5.
- ``SparseAttention``'s grid and flat routes against the flax module with
  converted weights at 1e-5 on valid positions.
- The tiny sparse ``Alphafold2``: logits, one train step's loss (1e-5) and
  every gradient leaf (relative L2 1e-4, zeros exact) against JAX
  ``build_model`` with sparse attention on (the jnp oracle on the CPU),
  with a block-aligned crop (grid route) and, per layer, an unaligned crop
  (flat route).
- Serving ignores ``gelu_exact`` and ``sparse_self_attn`` as JAX's predict
  and ServeEngine do.

Inputs are drawn with numpy from seeds and handed to both frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.ops import sparse as jsparse
from alphafold2_tpu.ops.pallas.block_sparse import (
    pallas_block_sparse_attention, pallas_block_sparse_attention_bwd)
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.ops import sparse
from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
from alphafold2_tpu_torch.predict import build_model as serve_model
from alphafold2_tpu_torch.serve.engine import ServeEngine
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.train_pre import main as train_pre_main

ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("n,block,local,glob,rand,seed", [
    (128, 16, 4, 1, None, 0),  # the training pass: nb 8, 2 random blocks per row
    (512, 16, 4, 1, None, 0),
    (1024, 16, 4, 1, None, 3),
    (256, 32, 3, 2, 1, 7),
    (96, 16, 2, 0, 0, 0),  # local only
    (64, 16, 6, 1, 9, 1),  # more random blocks than blocks: capped
    (256, 128, 4, 1, None, 0),
])
def test_layout_and_active_indices_match_jax(n, block, local, glob, rand, seed):
    kw = dict(block_size=block, num_local_blocks=local, num_global_blocks=glob,
              num_random_blocks=rand, seed=seed)
    lay = sparse.BlockSparseConfig(**kw).layout(n)
    ref = jsparse.BlockSparseConfig(**kw).layout(n)
    assert lay.dtype == ref.dtype and np.array_equal(lay, ref)
    for a, b in ((lay, ref), (lay.T, ref.T)):
        got, want = sparse.active_indices(a), jsparse.active_indices(b)
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    packed = sparse.pack_layout(lay, block)
    assert packed.seq_len == n and packed.active_pairs() == int(lay.sum())
    np.testing.assert_array_equal(packed.row_counts, lay.sum(1))
    np.testing.assert_array_equal(packed.col_counts, lay.sum(0))
    for i in range(n // block):
        np.testing.assert_array_equal(packed.rows[i, :packed.row_counts[i]],
                                      np.nonzero(lay[i])[0])
        np.testing.assert_array_equal(packed.cols[i, :packed.col_counts[i]],
                                      np.nonzero(lay[:, i])[0])


def test_config_layout_is_built_once_and_copied_once():
    cfg = sparse.BlockSparseConfig(num_random_blocks=1)
    a = sparse.config_layout(cfg, 64)
    assert sparse.config_layout(sparse.BlockSparseConfig(num_random_blocks=1), 64) is a
    cpu = torch.device("cpu")
    assert all(x is y for x, y in zip(a.tensors(cpu), a.tensors(cpu)))
    assert sparse.config_layout(cfg, 96) is not a


# ------------------------------------------------------------------ kernels


CASES = {  # (b, h, n, d, block, config kwargs, valid keys per batch row)
    "ragged": (3, 2, 96, 16, 16, dict(num_random_blocks=1), [96, 70, 21]),
    "dead row": (3, 2, 64, 8, 16, dict(num_random_blocks=1), [0, 64, 40]),
    "block 32": (2, 2, 128, 16, 32, dict(num_random_blocks=1, seed=5), [128, 75]),
    "unmasked": (1, 2, 96, 8, 16, dict(num_random_blocks=2, num_global_blocks=0), None),
}


def _case(name, seed=0):
    b, h, n, d, block, kw, valid = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (_np(rng, (b, h, n, d)) for _ in range(4))
    mask = None
    if valid is not None:
        mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    lay = jsparse.BlockSparseConfig(block_size=block, **kw).layout(n)
    return q, k, v, g, mask, lay, block


def _jmask(mask):
    return None if mask is None else jnp.asarray(mask)


def _tmask(mask):
    return None if mask is None else _t(mask)


def _live(mask, b, n):
    """(B, N) rows with a valid key (every row in this file attends the
    global block 0, so a batch row is live iff any key is valid)."""
    if mask is None:
        return np.ones((b, n), bool)
    return np.broadcast_to(mask.any(-1, keepdims=True), (b, n))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_matches_pallas(name):
    q, k, v, _, mask, lay, block = _case(name)
    b, h, n, d = q.shape
    out_j, lse_j = pallas_block_sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v)), lay, block, mask=_jmask(mask),
        interpret=True, return_lse=True)
    layout = sparse.pack_layout(lay, block)
    out, lse = bsa.block_sparse_attention_lse_reference(
        _t(q), _t(k), _t(v), layout, _tmask(mask), d**-0.5)
    out_n = bsa.block_sparse_attention_reference(_t(q), _t(k), _t(v), layout, _tmask(mask),
                                                 d**-0.5)
    assert torch.equal(out, out_n)
    live = _live(mask, b, n)[:, None, :]
    live_o = np.broadcast_to(live[..., None], out.shape)
    np.testing.assert_allclose(out.numpy()[live_o], np.asarray(out_j)[live_o], atol=ATOL)
    live_l = np.broadcast_to(live, lse.shape)
    np.testing.assert_allclose(lse.numpy()[live_l], np.asarray(lse_j)[live_l], atol=ATOL)
    # dead rows: exactly 0 and lse +inf
    assert (out.numpy()[~live_o] == 0).all()
    assert np.isposinf(lse.numpy()[~live_l]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_pallas(name):
    q, k, v, g, mask, lay, block = _case(name, seed=1)
    b, h, n, d = q.shape
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out_j, lse_j = pallas_block_sparse_attention(jq, jk, jv, lay, block, mask=_jmask(mask),
                                                 interpret=True, return_lse=True)
    dq_j, dk_j, dv_j = pallas_block_sparse_attention_bwd(
        jq, jk, jv, out_j, lse_j, jg, lay, block, mask=_jmask(mask), interpret=True)
    layout = sparse.pack_layout(lay, block)
    out, lse = bsa.block_sparse_attention_lse_reference(_t(q), _t(k), _t(v), layout,
                                                        _tmask(mask), d**-0.5)
    args = (_t(q), _t(k), _t(v), _t(g), lse, bsa.attention_dsum(out, _t(g)), layout,
            _tmask(mask), d**-0.5)
    dq = bsa.block_sparse_attention_dq_reference(*args).numpy()
    dk, dv = (t.numpy() for t in bsa.block_sparse_attention_dkv_reference(*args))
    live = np.broadcast_to(_live(mask, b, n)[:, None, :, None], q.shape)
    keys = np.broadcast_to((mask if mask is not None else np.ones((b, n), bool))
                           [:, None, :, None], q.shape)
    np.testing.assert_allclose(dq[live], np.asarray(dq_j)[live], atol=ATOL)
    # dead rows and masked keys: zero here (the TPU kernel's dead rows gave
    # masked keys gradients of their padded average)
    assert (dq[~live] == 0).all() and (dk[~keys] == 0).all() and (dv[~keys] == 0).all()
    # masked keys get contributions only from dead rows in JAX; compare valid keys
    np.testing.assert_allclose(dk[keys], np.asarray(dk_j)[keys], atol=ATOL)
    np.testing.assert_allclose(dv[keys], np.asarray(dv_j)[keys], atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_matches_jax_grad(name):
    """Gradients through BlockSparseAttention (plain forward with lse, plain
    K5a/K5b) against jax.grad of block_sparse_attention_pallas. The loss
    weighs live rows only, as the model's loss does, so every gradient
    element compares, masked keys and dead rows included."""
    q, k, v, w, mask, lay, block = _case(name, seed=2)
    b, h, n, d = q.shape
    live = _live(mask, b, n)[:, None, :, None].astype(np.float32)

    def jloss(q, k, v):
        out = jsparse.block_sparse_attention_pallas(q, k, v, lay, block, mask=_jmask(mask),
                                                    interpret=True)
        return jnp.sum(jnp.sin(out) * w * live)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    layout = sparse.pack_layout(lay, block)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    calls = bsa.block_sparse_attention_dq_reference.calls
    out = bsa.block_sparse_attention(*leaves, layout, _tmask(mask), sm_scale=d**-0.5)
    assert out.grad_fn is not None
    (torch.sin(out) * _t(w) * _t(live)).sum().backward()
    assert bsa.block_sparse_attention_dq_reference.calls == calls + 1
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_tensors_launch_nothing():
    q, k, v, g, mask, lay, block = _case("ragged")
    layout = sparse.pack_layout(lay, block)
    kernels = (bsa.block_sparse_attention, bsa.block_sparse_attention_lse,
               bsa.block_sparse_attention_dq, bsa.block_sparse_attention_dkv)
    before = [f.launches for f in kernels]
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    bsa.block_sparse_attention(*leaves, layout, _tmask(mask), 0.25).sum().backward()
    with torch.no_grad():
        bsa.block_sparse_attention(_t(q), _t(k), _t(v), layout, _tmask(mask), 0.25)
    assert [f.launches for f in kernels] == before == [0, 0, 0, 0]


def test_wrappers_reject_bad_operands():
    q, k, v, g, mask, lay, block = _case("ragged")
    layout = sparse.pack_layout(lay, block)
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    with pytest.raises(ValueError, match="block size"):
        sparse.pack_layout(lay, 8)
    with pytest.raises(ValueError, match="malformed"):
        bsa.BlockLayout(layout.rows, layout.row_counts + 9, layout.cols, layout.col_counts, 16)
    with pytest.raises(TypeError, match="BlockLayout"):
        bsa.block_sparse_attention(tq, tk, tv, lay, tm)
    with pytest.raises(ValueError, match="sequence length"):
        bsa.block_sparse_attention(tq[:, :, :80], tk[:, :, :80], tv[:, :, :80], layout)
    with pytest.raises(ValueError, match="self-attention"):
        bsa.block_sparse_attention(tq, tk[:, :, :80], tv[:, :, :80], layout)
    with pytest.raises(TypeError):
        bsa.block_sparse_attention(tq.double(), tk.double(), tv.double(), layout)
    with pytest.raises(ValueError, match="kv_mask"):
        bsa.block_sparse_attention(tq, tk, tv, layout, tm.float())
    out, lse = bsa.block_sparse_attention_lse(tq, tk, tv, layout, tm)
    dsum = bsa.attention_dsum(out, _t(g))
    with pytest.raises(ValueError, match="dout"):
        bsa.block_sparse_attention_dq(tq, tk, tv, _t(g)[:, :1], lse, dsum, layout, tm)
    with pytest.raises(ValueError, match="lse"):
        bsa.block_sparse_attention_dkv(tq, tk, tv, _t(g), lse.double(), dsum, layout, tm)


# ------------------------------------------------------------------ modules


def _module_pair(config_kw, seq_len=None):
    dim, heads, dim_head = 16, 2, 8
    jm = jsparse.SparseAttention(dim=dim, heads=heads, dim_head=dim_head, seq_len=seq_len,
                                 config=jsparse.BlockSparseConfig(**config_kw))
    tm = sparse.SparseAttention(dim, heads, dim_head, seq_len=seq_len,
                                config=sparse.BlockSparseConfig(**config_kw))
    return jm, tm, dim


@pytest.mark.parametrize("attend_axis", [1, 2])
def test_sparse_attention_grid_route_matches_flax(attend_axis):
    jm, tm, dim = _module_pair(dict(num_random_blocks=1), seq_len=64)
    rng = np.random.default_rng(4)
    b, n = 2, 64
    x = _np(rng, (b, n, n, dim))
    res = np.arange(n)[None, :] < np.array([[n], [45]])
    mask = res[:, :, None] & res[:, None, :]
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask), attend_axis,
                     method=jm.grid_axial)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), attend_axis,
                   method=jm.grid_axial)
    tm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tm))
    with torch.no_grad():
        out = tm.grid_axial(_t(x), _t(mask), attend_axis).numpy()
    np.testing.assert_allclose(out[mask], np.asarray(ref)[mask], atol=ATOL)
    with pytest.raises(ValueError, match="multiple of block_size"):
        tm.grid_axial(_t(x[:, :40, :40]), None, attend_axis)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.grid_axial(torch.zeros((1, 8, 80, dim)), None, 2)


@pytest.mark.parametrize("n,valid", [(40, [40, 29]), (64, [64, 50]), (37, None)])
def test_sparse_attention_flat_route_matches_flax(n, valid):
    jm, tm, dim = _module_pair(dict(num_random_blocks=1), seq_len=64)
    rng = np.random.default_rng(5)
    x = _np(rng, (2, n, dim))
    mask = None if valid is None else np.arange(n)[None, :] < np.asarray(valid)[:, None]
    jmask = None if mask is None else jnp.asarray(mask)
    params = jm.init(jax.random.key(1), jnp.asarray(x), mask=jmask)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), mask=jmask))
    tm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tm))
    with torch.no_grad():
        out = tm(_t(x), mask=_tmask(mask)).numpy()
    assert out.shape == (2, n, dim)
    np.testing.assert_allclose(out, ref, atol=ATOL)  # every row attends block 0
    with pytest.raises(ValueError, match="self-attention"):
        tm(_t(x), context=_t(x))
    with pytest.raises(ValueError, match="tying"):
        tm(_t(x), tie_dim=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm(torch.zeros((1, 65, dim)))
    with pytest.raises(ValueError, match="backend"):
        sparse.SparseAttention(dim, config=sparse.BlockSparseConfig(backend="triton"))


def test_axial_attention_routes_and_flax_names():
    from alphafold2_tpu_torch.ops.attention import AxialAttention

    ax = AxialAttention(16, 2, 8, sparse_attn=True, seq_len=64)
    assert isinstance(ax.attn_width, sparse.SparseAttention)
    assert sorted(n for n, _ in ax.named_children()) == ["attn_height", "attn_width"]
    calls = []
    for name in ("attn_width", "attn_height"):
        mod = getattr(ax, name)
        mod.grid_axial = lambda *a, _n=name, **k: calls.append(_n) or torch.zeros(())
    with torch.no_grad():
        ax(torch.zeros((1, 32, 48, 16)))  # both axes block multiples: grid route
        assert calls == ["attn_width", "attn_height"]
        out = ax(torch.zeros((1, 32, 40, 16)))  # 40 is not: the flat route
    assert calls == ["attn_width", "attn_height"] and out.shape == (1, 32, 40, 16)
    with pytest.raises(ValueError, match="tying"):
        AxialAttention(16, 2, 8, tie_row_attn=True, sparse_attn=True)(
            torch.zeros((1, 4, 16, 16)))


# ------------------------------------------------------------------ the model


def _tiny(port: bool, sparse_flags, crop: int):
    mod = tconfig if port else __import__("alphafold2_tpu.config", fromlist=["Config"])
    depth = len(sparse_flags) if isinstance(sparse_flags, tuple) else 1
    return mod.Config(
        model=mod.ModelConfig(dim=16, depth=depth, heads=2, dim_head=8, max_seq_len=128,
                              bfloat16=False, sparse_self_attn=sparse_flags),
        data=mod.DataConfig(crop_len=crop, msa_depth=2, msa_len=16, batch_size=2,
                            min_len_filter=8),
        train=mod.TrainConfig(gradient_accumulate_every=1, warmup_steps=2),
    )


MODEL_CASES = {
    # crop 96: nb 6, one random block per row; both axes block multiples
    # (depth 1)
    "aligned": (True, 96),
    # crop 40 pads to 48 on the flat route; the second layer stays dense
    "per-layer unaligned": ((True, False), 40),
}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_run(request):
    """JAX: the initial params, the logits, and one step's loss and gradients."""
    flags, crop = MODEL_CASES[request.param]
    cfg = _tiny(False, flags, crop)
    batch = next(iter(JSyntheticDataset(cfg.data, seed=0)))
    # padding on both batch rows: dead pair rows in every layer
    batch["mask"][:, crop - 9:] = False
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(0), dev["seq"], dev["msa"], mask=dev["mask"],
                                 msa_mask=dev["msa_mask"])

    def loss_fn(p):
        logits = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                             msa_mask=dev["msa_mask"])
        labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
        return jloop.distogram_cross_entropy(logits, labels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"name": request.param, "flags": flags, "crop": crop, "batch": batch,
            "params": jax.tree.map(np.asarray, params), "loss": float(loss),
            "logits": np.asarray(logits), "grads": jax.tree.map(np.asarray, grads)}


def test_sparse_model_and_train_step_match_jax(model_run):
    cfg = _tiny(True, model_run["flags"], model_run["crop"])
    state = loop.init_state(cfg, loop.build_model(cfg), flax_params=model_run["params"],
                            device="cpu")
    trunk = state.model.trunk
    sparse_layers = [isinstance(getattr(trunk, f"layer_{i}").pair_axial.attn_width,
                                sparse.SparseAttention) for i in range(trunk.depth)]
    flags = model_run["flags"]
    assert sparse_layers == (list(flags) if isinstance(flags, tuple) else [flags])
    batch = loop.batch_to_device(model_run["batch"], torch.device("cpu"))
    mask = model_run["batch"]["mask"]
    pv = (mask[:, :, None] & mask[:, None, :])[..., None]
    calls = bsa.block_sparse_attention_reference.calls
    with torch.no_grad():
        logits = state.model(batch["seq"], batch["msa"], mask=batch["mask"],
                             msa_mask=batch["msa_mask"]).numpy()
    assert bsa.block_sparse_attention_reference.calls > calls
    assert np.abs((logits - model_run["logits"]) * pv).max() <= 1e-4
    calls = (bsa.block_sparse_attention_lse_reference.calls,
             bsa.block_sparse_attention_dkv_reference.calls)
    state, metrics = loop.make_train_step(state.model)(state, batch)
    assert bsa.block_sparse_attention_lse_reference.calls > calls[0]
    assert bsa.block_sparse_attention_dkv_reference.calls > calls[1]
    assert abs(float(metrics["loss"]) - model_run["loss"]) <= 1e-5
    assert bool(metrics["grads_ok"])
    ref = convert.to_state_dict(model_run["grads"], state.model)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in state.model.named_parameters()}
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        g = got[name]
        assert float((g - g_ref).norm()) <= GRAD_REL * float(g_ref.norm()) + 1e-12, name
        assert (g[g_ref == 0] == 0).all(), name


def test_converter_maps_a_sparse_tree():
    """The flax tree of a sparse model onto the port's, every leaf exactly
    once: the sparse passes keep the names attn_width/attn_height."""
    cfg = _tiny(False, True, 32)
    shapes = jax.eval_shape(
        jloop.build_model(cfg).init, jax.random.key(0), jnp.zeros((1, 32), jnp.int32),
        jnp.zeros((1, 2, 16), jnp.int32), mask=jnp.ones((1, 32), bool),
        msa_mask=jnp.ones((1, 2, 16), bool))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert "attn_width" in tree["params"]["trunk"]["layer_0"]["pair_axial"]
    model = loop.build_model(_tiny(True, True, 32))
    sd = convert.to_state_dict(tree, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())


def test_trunk_checks_the_per_layer_flags():
    from alphafold2_tpu_torch.models.trunk import Trunk

    with pytest.raises(ValueError, match="2 entries for depth 3"):
        Trunk(16, depth=3, heads=2, dim_head=8, sparse_self_attn=(True, False))
    with pytest.raises(ValueError, match="per-layer"):
        Trunk(16, depth=2, heads=2, dim_head=8, sparse_self_attn=(True, False),
              reversible=True)


def test_train_pre_cli_takes_the_sparse_override(capsys):
    calls = bsa.block_sparse_attention_lse_reference.calls
    train_pre_main(["train.num_steps=1", "train.log_every=1", "data.crop_len=32",
                    "data.msa_len=12", "data.min_len_filter=8", "model.dim=16",
                    "model.heads=2", "model.dim_head=8", "model.max_seq_len=64",
                    "model.sparse_self_attn=true", "--device=cpu"])
    out = capsys.readouterr().out
    assert '"sparse_self_attn": true' in out and "[step 0]" in out
    assert bsa.block_sparse_attention_lse_reference.calls > calls


# ------------------------------------------------------------------ serving


def test_serving_ignores_training_only_flags():
    """JAX's predict/ServeEngine build End2EndModel without gelu_exact or
    sparse attention, so they serve dense with tanh GELU whatever the
    config says; the port's serving model must give the same distogram."""
    cfg = tconfig.Config()
    cfg.model.dim, cfg.model.depth, cfg.model.heads, cfg.model.dim_head = 16, 1, 2, 8
    cfg.model.max_seq_len = 48
    cfg.model.gelu_exact = cfg.model.sparse_self_attn = True
    cfg.model.bfloat16 = False
    cfg.serve.mds_iters = 10
    rng = np.random.default_rng(0)
    b, l, m = 2, 8, 3
    seq = rng.integers(0, 20, (b, l)).astype(np.int32)
    msa = rng.integers(0, 20, (b, m, l)).astype(np.int32)
    mask = np.ones((b, l), bool)
    mask[1, 6:] = False
    msa_mask = np.broadcast_to(mask[:, None], (b, m, l)).copy()
    jm = JEnd2End(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, mds_iters=10,
                  mds_per_position_init=True)
    # weights drawn with numpy on the parameter tree's shapes: flax's init of
    # the end-to-end model compiles for seconds, and any weights will do here
    shapes = jax.eval_shape(jm.init, jax.random.key(0), seq, msa, mask=mask,
                            msa_mask=msa_mask)
    params = jax.tree.map(lambda x: 0.2 * rng.standard_normal(x.shape).astype(np.float32),
                          shapes)
    ref = np.asarray(jax.jit(lambda p: jm.apply(p, seq, msa, mask=mask, msa_mask=msa_mask))(
        params)["distogram"])
    tm = serve_model(cfg, mds_iters=10)
    assert not any(isinstance(x, sparse.SparseAttention) for x in tm.modules())
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params), tm)
    tm.load_state_dict(sd)
    calls = (bsa.block_sparse_attention_reference.calls,
             bsa.block_sparse_attention_lse_reference.calls)
    with torch.no_grad():
        out = tm.eval()(_t(seq).long(), _t(msa).long(), mask=_t(mask),
                        msa_mask=_t(msa_mask))["distogram"].numpy()
    m3 = np.repeat(mask, 3, axis=1)
    pv = (m3[:, :, None] & m3[:, None, :])[..., None]
    assert np.abs((out - ref) * pv).max() < 1e-4
    engine = ServeEngine(dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, buckets=(8,), max_batch=1)), state_dict=sd, device="cpu")
    result = engine.predict_many(["ACDEFGH"])[0]
    assert result.ok and np.isfinite(result.atom14).all()
    assert (bsa.block_sparse_attention_reference.calls,
            bsa.block_sparse_attention_lse_reference.calls) == calls
