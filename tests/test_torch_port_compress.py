"""KV compression (``model.cross_attn_compress_ratio > 1``) on the port
against the JAX package, on the CPU.

- ``Attention(compress_ratio=r)``: JAX's ``Attention`` (its dense path,
  ``use_flash=False``) and the port's on the same flax parameters through
  the converter, forward and ``jax.grad`` (every parameter leaf,
  ``kv_compress`` among them, and both inputs), at a ratio that pads the
  30 context tokens (4) and one that does not (3), with and without masks.
  With masks a context's last tokens are padding, so a compressed key
  block is masked only where all of its tokens were; one batch element's
  context is all padding, which makes its rows rows without a valid key
  (the port's kernels give them exactly 0) and leaves them out of the
  comparison with the masked query rows. Self-attention with compression
  raises as JAX's does; under active attention dropout the compressed pass
  takes the dense route, no kernel.
- The converter maps flax's ``kv_compress`` Conv kernel (ratio, in/groups,
  out) onto the grouped ``conv1d`` weight (out, in/groups, ratio), plain
  and stacked (scanned, reversible), each leaf exactly once.
- ``Alphafold2`` with compression: logits and every gradient leaf.
- The distogram loop: 2 steps of ``train.loop.make_train_step`` against
  JAX's on the same batches under each engine (default, remat, scan,
  reversible): both losses and the parameters after them; and
  ``train_pre``'s CLI with the flag.

In a model, a compressed key block that straddles MSA padding mixes the
padded tokens' features into its k and v. Those features come from masked
query rows, which differ by path (the port's kernels give them 0, JAX's
dense path a uniform average: a settled difference, ROADMAP §3), so the
model-level inputs put MSA padding on whole blocks (a fully masked MSA row,
row length a multiple of the ratio, or no MSA padding); the pair stream
keeps its padding. The Attention-level cases hold partly padded blocks,
whose inputs are identical in both packages.

Tolerances (f32): outputs and logits within 1e-5 relative L2 on valid
rows; the Attention's gradient leaves within 1e-5 relative L2, a whole
model's within 1e-4 (as tests/test_torch_port_train.py holds the train
step's); losses 1e-5 absolute; parameters after two steps 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.ops.attention import Attention as JAttention
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.ops import attention as tattention
from alphafold2_tpu_torch.ops.attention import Attention, DropoutKey
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.train_pre import main as train_pre_main

REL = 1e-5
MODEL_GRAD_REL = 1e-4  # a whole model's gradient leaves, as tests/test_torch_port_train.py
D, HEADS, DH = 16, 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flax_params(module, seed, *args, **kwargs):
    """A flax tree of ``module``'s shapes drawn with numpy: kernels
    N(0, 1/fan_in), LayerNorm scales near 1, biases and embeddings small
    and nonzero (so the conv's bias counts)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z * s.shape[-2] ** -0.5
        return 1.0 + 0.1 * z if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------------ Attention


def _attention_inputs(j, masked, seed=0):
    rng = np.random.default_rng(seed)
    b, n = 3, 12
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    ctx = rng.standard_normal((b, j, D)).astype(np.float32)
    w = rng.standard_normal((b, n, D)).astype(np.float32)
    mask = cm = None
    valid = np.ones((b, n), bool)
    if masked:
        mask = np.ones((b, n), bool)
        mask[:, -2:] = False
        cm = np.ones((b, j), bool)
        cm[0, -5:] = False  # a partly padded last block
        cm[1, -1:] = False
        cm[2] = False  # no valid key: rows the kernels give exactly 0
        valid = mask.copy()
        valid[2] = False
    return x, ctx, w, mask, cm, valid


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "masked"])
@pytest.mark.parametrize("ratio", [4, 3], ids=["pads", "no_pad"])
def test_compressed_attention_matches_jax(ratio, masked):
    x, ctx, w, mask, cm, valid = _attention_inputs(30, masked)
    jmod = JAttention(dim=D, heads=HEADS, dim_head=DH, compress_ratio=ratio, use_flash=False)
    params = _flax_params(jmod, 1, x, context=ctx, mask=mask, context_mask=cm)
    wv = w * valid[..., None]

    def jloss(p, x, ctx):
        out = jmod.apply(p, x, context=ctx, mask=mask, context_mask=cm)
        return jnp.sum(jnp.sin(out) * wv), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(ctx))

    mod = Attention(D, HEADS, DH, compress_ratio=ratio)
    mod.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), mod))
    assert tuple(mod.kv_compress.weight.shape) == (HEADS * DH, DH, ratio)
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    opt = lambda a: None if a is None else torch.from_numpy(a)
    out = mod(xt, context=ct, mask=opt(mask), context_mask=opt(cm))
    (torch.sin(out) * torch.from_numpy(wv)).sum().backward()
    got = out.detach().numpy()
    assert _rel_l2(got[valid], np.asarray(jout)[valid]) <= REL
    if masked:
        assert (got[2] == mod.to_out.bias.detach().numpy()).all()  # rows without a key
    ref = convert.to_state_dict(jax.tree.map(np.asarray, jgrads[0]), mod)
    for name, p in mod.named_parameters():
        assert _rel_l2(p.grad.numpy(), ref[name].numpy()) <= REL, name
    assert _rel_l2(xt.grad.numpy(), np.asarray(jgrads[1])) <= REL
    assert _rel_l2(ct.grad.numpy(), np.asarray(jgrads[2])) <= REL


def test_pooled_mask_is_any_valid_and_none_without_padding():
    mod = Attention(D, HEADS, DH, compress_ratio=4)
    k = torch.zeros((1, 30, HEADS * DH))
    cm = torch.zeros((1, 30), dtype=torch.bool)
    cm[0, 25] = True  # the last full block's second token
    _, _, pooled = mod._compress(k, k, cm)
    assert pooled.tolist() == [[False] * 6 + [True, False]]
    _, _, pooled = mod._compress(k, k, None)
    assert pooled.tolist() == [[True] * 7 + [True]]  # tokens 28-29 are valid
    _, _, pooled = mod._compress(k[:, :28], k[:, :28], None)
    assert pooled is None


def test_self_attention_with_compression_raises():
    mod = Attention(D, HEADS, DH, compress_ratio=2)
    with pytest.raises(ValueError, match="cross-attention only"):
        mod(torch.zeros((1, 4, D)))


def test_dropout_takes_the_dense_route_on_the_compressed_keys(monkeypatch):
    x, ctx, _, mask, cm, valid = _attention_inputs(30, True)
    mod = Attention(D, HEADS, DH, compress_ratio=4, dropout=0.5)

    def no_kernel(*a, **k):
        raise AssertionError("the dense route ran a kernel")

    monkeypatch.setattr(tattention, "fused_attention", no_kernel)
    out = mod(torch.from_numpy(x), context=torch.from_numpy(ctx),
              mask=torch.from_numpy(mask), context_mask=torch.from_numpy(cm),
              key=DropoutKey(0, "pair_from_msa"))
    assert out.shape == (3, 12, D) and torch.isfinite(out).all()


# ------------------------------------------------------------ converter


def _tokens(b=1, n=6, m=2):
    rng = np.random.default_rng(4)
    seq = rng.integers(0, 20, (b, n)).astype(np.int32)
    msa = rng.integers(0, 20, (b, m, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    mask[:, -1] = False
    msa_mask = np.ones((b, m, n), bool)
    msa_mask[:, :, -1] = False
    return seq, msa, mask, msa_mask


MODEL = dict(dim=D, depth=2, heads=HEADS, dim_head=DH, max_seq_len=24)


@pytest.mark.parametrize("engine", ["loop", "scan_layers", "reversible"])
def test_converter_maps_the_conv_kernel(engine):
    seq, msa, mask, msa_mask = _tokens()
    flags = {} if engine == "loop" else {engine: True}
    jmod = JAlphafold2(**MODEL, cross_attn_compress_ratio=3, **flags)
    tree = jax.tree.map(np.asarray, _flax_params(jmod, 2, seq, msa, mask=mask,
                                                 msa_mask=msa_mask))
    model = Alphafold2(**MODEL, cross_attn_compress_ratio=3, **flags)
    sd = convert.to_state_dict(tree, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())
    model.load_state_dict(sd)
    if engine == "loop":
        kernel = tree["params"]["trunk"]["layer_1"]["pair_from_msa"]["kv_compress"]["kernel"]
        weight = sd["trunk.layer_1.pair_from_msa.kv_compress.weight"]
        assert "trunk.layer_1.msa_from_pair.kv_compress.weight" not in sd
    elif engine == "scan_layers":
        kernel = tree["params"]["trunk"]["scan"]["layer"]["pair_from_msa"]["kv_compress"][
            "kernel"]
        weight = sd["trunk.scan.layer.pair_from_msa.kv_compress.weight"]
    else:
        kernel = tree["params"]["trunk"]["reversible"]["layers"]["f_c"]["kv_compress"][
            "kernel"]
        weight = sd["trunk.reversible.layers.f_c.kv_compress.weight"]
        assert not any("j_c.kv_compress" in k for k in sd)
    stacked = engine != "loop"
    assert kernel.shape == (2,) * stacked + (3, DH, HEADS * DH)
    assert tuple(weight.shape) == (2,) * stacked + (HEADS * DH, DH, 3)
    # flax kernel[..., s, i, o] is the conv weight[..., o, i, s]
    np.testing.assert_array_equal(weight.numpy(), np.swapaxes(kernel, -1, -3))


# ------------------------------------------------------------ the model


def test_alphafold2_with_compression_matches_jax():
    seq, msa, mask, msa_mask = _tokens(b=2, n=8, m=3)
    # MSA padding on whole compressed blocks (module docstring): a masked row
    msa_mask[:] = True
    msa_mask[1, 2] = False
    jmod = JAlphafold2(**MODEL, cross_attn_compress_ratio=2, use_flash=False)
    params = _flax_params(jmod, 5, seq, msa, mask=mask, msa_mask=msa_mask)
    pair = mask[:, :, None] & mask[:, None, :]
    w = np.random.default_rng(6).standard_normal(pair.shape + (37,)).astype(np.float32)
    w *= pair[..., None]

    def jloss(p):
        logits = jmod.apply(p, seq, msa, mask=mask, msa_mask=msa_mask)
        return jnp.sum(jnp.sin(logits) * w), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = Alphafold2(**MODEL, cross_attn_compress_ratio=2)
    model.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), model))
    t = [torch.from_numpy(a) for a in (seq, msa, mask, msa_mask)]
    logits = model(t[0].long(), t[1].long(), mask=t[2], msa_mask=t[3])
    (torch.sin(logits) * torch.from_numpy(w)).sum().backward()
    assert _rel_l2(logits.detach().numpy()[pair], np.asarray(jlogits)[pair]) <= REL
    ref = convert.to_state_dict(jax.tree.map(np.asarray, jgrads), model)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel_l2(g.numpy(), ref[name].numpy()) <= MODEL_GRAD_REL, name


# ------------------------------------------------------------ the loop

ENGINES = {"default": {}, "remat": dict(remat=True), "scan": dict(scan_layers=True),
           "reversible": dict(reversible=True)}


def _configs(engine):
    kw = dict(dim=D, depth=2, heads=HEADS, dim_head=DH, max_seq_len=32, bfloat16=False,
              cross_attn_compress_ratio=3, **ENGINES[engine])
    # chains of 10-12 residues: padded pairs, an MSA without padding
    data = dict(crop_len=12, msa_depth=2, msa_len=10, batch_size=2, min_len_filter=10)
    train = dict(gradient_accumulate_every=1, warmup_steps=1, numerics="off")
    return (JConfig(model=JModelConfig(**kw), data=JDataConfig(**data),
                    train=JTrainConfig(**train)),
            tconfig.Config(model=tconfig.ModelConfig(**kw), data=tconfig.DataConfig(**data),
                           train=tconfig.TrainConfig(**train)))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_distogram_loop_two_steps_match_jax(engine):
    jcfg, cfg = _configs(engine)
    stream = iter(JSyntheticDataset(jcfg.data, seed=0))
    batches = [next(stream) for _ in range(2)]
    model = jloop.build_model(jcfg)
    dev = [jloop.device_put_batch(b) for b in batches]
    params = _flax_params(model, 7, dev[0]["seq"], dev[0]["msa"], mask=dev[0]["mask"],
                          msa_mask=dev[0]["msa_mask"])
    state = jloop.TrainState.create(
        apply_fn=model.apply, params=params, tx=jloop.build_optimizer(jcfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(model)
    jlosses = []
    for i, b in enumerate(dev):
        state, metrics = step(state, b, jax.random.key(i))
        jlosses.append(float(metrics["loss"]))

    port = loop.init_state(cfg, loop.build_model(cfg),
                           flax_params=jax.tree.map(np.asarray, params), device="cpu")
    pstep = loop.make_train_step(port.model)
    for i, b in enumerate(batches):
        port, m = pstep(port, loop.batch_to_device(b, torch.device("cpu")))
        assert abs(float(m["loss"]) - jlosses[i]) <= 1e-5, (i, float(m["loss"]), jlosses[i])
        assert bool(m["grads_ok"])
    ref = convert.to_state_dict(jax.tree.map(np.asarray, state.params), port.model)
    worst = max(float((p.detach() - ref[n]).abs().max())
                for n, p in port.model.named_parameters())
    assert worst <= 1e-5, worst
    assert any("kv_compress" in n for n, _ in port.model.named_parameters())


def test_train_pre_cli_with_compression(capsys):
    train_pre_main(["train.num_steps=2", "train.log_every=1", "data.crop_len=12",
                    "data.msa_len=10", "data.min_len_filter=8", "model.dim=16",
                    "model.heads=2", "model.dim_head=8", "model.max_seq_len=32",
                    "model.cross_attn_compress_ratio=4", "--device=cpu"])
    out = capsys.readouterr().out
    assert '"cross_attn_compress_ratio": 4' in out and "[step 1]" in out
