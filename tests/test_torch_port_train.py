"""Distogram pretraining on the port against the JAX package, on the CPU.

- The differentiable fused attention (``ops/cuda/axial.py``
  ``FusedAttention``): on CPU tensors its forward and backward are the plain
  versions of K1-with-logsumexp and K3a/K3b. Their gradients are held
  against ``jax.grad`` of the JAX Pallas kernel (interpret mode, as
  tests/test_pallas_kernels.py runs it) on valid positions at 1e-4, and
  against autograd through the port's dense einsum.
- The synthetic batches are byte-identical; the bucketed labels and the
  cross-entropy are equal.
- The optimizer against optax (MultiSteps(clip + AdamW)) at 1e-6 relative.
- The whole train step against ``alphafold2_tpu.train.loop.make_train_step``
  on tests/test_train.py's tiny config, weights carried by
  ``convert.to_state_dict``: loss, every gradient leaf, exact zeros, and the
  parameters after three steps.

Inputs are drawn with numpy from seeds and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig
from alphafold2_tpu.config import DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig
from alphafold2_tpu.config import TrainConfig as JTrainConfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.ops.pallas.axial import fused_attention as jax_fused
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.data.pipeline import make_dataset
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.ops.cuda import axial
from alphafold2_tpu_torch.train import loop, optim
from alphafold2_tpu_torch.train_pre import main as train_pre_main
from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------ the attention backward


def _attention_case(b, h, nq, nk, d, q_drop, kv_drop, dead, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = _np(rng, (b, h, nq, d)), _np(rng, (b, h, nk, d)), _np(rng, (b, h, nk, d))
    w = _np(rng, (b, h, nq, d))  # cotangent weights of the loss
    q_mask = np.ones((b, nq), bool)
    q_mask[:, nq - q_drop:] = False
    kv_mask = np.ones((b, nk), bool)
    kv_mask[:, max(1, nk - kv_drop):] = False
    if dead:
        kv_mask[0] = False
    return q, k, v, w, q_mask, kv_mask


def _port_grads(q, k, v, w, q_mask, kv_mask, scale):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = axial.fused_attention(*t, q_mask=torch.from_numpy(q_mask),
                                kv_mask=torch.from_numpy(kv_mask), sm_scale=scale)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


@pytest.mark.parametrize(
    "shape,q_drop,kv_drop,dead",
    [
        ((1, 2, 200, 200, 16), 3, 20, False),  # odd length: padded keys
        ((2, 1, 37, 91, 8), 3, 7, False),  # rectangular (cross-shaped)
        ((2, 1, 64, 64, 8), 0, 0, True),  # one batch entry with every key masked
    ],
)
def test_fused_attention_grads_match_jax(shape, q_drop, kv_drop, dead):
    b, h, nq, nk, d = shape
    q, k, v, w, q_mask, kv_mask = _attention_case(b, h, nq, nk, d, q_drop, kv_drop, dead)
    scale = d**-0.5
    calls = (axial.fused_attention_lse_reference.calls,
             axial.fused_attention_dq_reference.calls,
             axial.fused_attention_dkv_reference.calls)
    out, grads = _port_grads(q, k, v, w, q_mask, kv_mask, scale)
    # the Function ran the port's own plain forward-with-lse and backward
    assert (axial.fused_attention_lse_reference.calls,
            axial.fused_attention_dq_reference.calls,
            axial.fused_attention_dkv_reference.calls) == tuple(c + 1 for c in calls)

    def jloss(q, k, v):
        o = jax_fused(q, k, v, q_mask=jnp.asarray(q_mask), kv_mask=jnp.asarray(kv_mask),
                      sm_scale=scale)
        return jnp.sum(jnp.sin(o) * w), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    live = q_mask & kv_mask.any(-1)[:, None]  # query rows the port attends
    assert np.abs((out - np.asarray(jout)) * live[:, None, :, None]).max() < ATOL
    dq, dk, dv = grads
    assert np.abs((dq - np.asarray(jgrads[0])) * live[:, None, :, None]).max() < ATOL
    for port, ref in ((dk, jgrads[1]), (dv, jgrads[2])):
        keys = kv_mask[:, None, :, None]
        if dead:  # JAX lets a key-less row average its padded block: skip it
            keys = keys & live.any(-1)[:, None, None, None]
        assert np.abs((port - np.asarray(ref)) * keys).max() < ATOL
    # masked queries get dq = 0, masked keys dk = dv = 0, exactly
    assert (dq.transpose(0, 2, 1, 3)[~live] == 0).all()
    assert (dk.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()
    assert (dv.transpose(0, 2, 1, 3)[~kv_mask] == 0).all()


def test_fused_attention_grads_match_autograd_through_einsum():
    q, k, v, w, q_mask, kv_mask = _attention_case(2, 2, 33, 21, 16, 4, 5, False, seed=4)
    scale = 0.3
    out, grads = _port_grads(q, k, v, w, q_mask, kv_mask, scale)
    t = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    s = torch.einsum("bhid,bhjd->bhij", t[0], t[1]) * scale
    s = s.masked_fill(~torch.from_numpy(kv_mask)[:, None, None, :], float("-inf"))
    dense = torch.einsum("bhij,bhjd->bhid", torch.softmax(s, -1), t[2])
    dense = dense * torch.from_numpy(q_mask)[:, None, :, None]
    (torch.sin(dense) * torch.from_numpy(w).double()).sum().backward()
    np.testing.assert_allclose(out, dense.detach().numpy(), atol=1e-5)
    for port, ref in zip(grads, t):
        np.testing.assert_allclose(port, ref.grad.numpy(), atol=1e-5)


def test_rows_without_a_valid_key_give_zero_grads():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_np(rng, (2, 2, 16, 8))).requires_grad_() for _ in range(3))
    none = torch.zeros((2, 16), dtype=torch.bool)
    none[1, :5] = True  # batch entry 0 has no valid key at all
    out = axial.fused_attention(q, k, v, kv_mask=none, sm_scale=0.5)
    out.sum().backward()
    assert (out[0] == 0).all()
    for g in (q.grad, k.grad, v.grad):
        assert torch.isfinite(g).all() and (g[0] == 0).all()
    assert (k.grad[1, :, 5:] == 0).all() and (v.grad[1, :, 5:] == 0).all()
    _, lse = axial.fused_attention_lse_reference(q, k, v, kv_mask=none, sm_scale=0.5)
    assert torch.isinf(lse[0]).all() and torch.isfinite(lse[1]).all()


def test_no_grad_runs_the_plain_forward_without_lse():
    q = torch.zeros((1, 1, 4, 8), requires_grad=True)
    before = (axial.fused_attention_reference.calls, axial.fused_attention_lse_reference.calls)
    with torch.no_grad():
        axial.fused_attention(q, q, q)
    axial.fused_attention(q.detach(), q.detach(), q.detach())
    assert (axial.fused_attention_reference.calls,
            axial.fused_attention_lse_reference.calls) == (before[0] + 2, before[1])


# ------------------------------------------------------- data and loss


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [(16, 2, 16, 2, 8), (40, 5, 24, 1, 16)])
def test_synthetic_batches_are_byte_identical(seed, shape):
    crop, depth, msa_len, batch, min_len = shape
    kw = dict(crop_len=crop, msa_depth=depth, msa_len=msa_len, batch_size=batch,
              min_len_filter=min_len)
    ref = iter(JSyntheticDataset(JDataConfig(**kw), seed=seed))
    out = iter(make_dataset(tconfig.DataConfig(**kw), seed=seed))
    for _ in range(2):
        a, b = next(ref), next(out)
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


def test_bucketed_labels_and_cross_entropy_match_jax():
    rng = np.random.default_rng(6)
    coords = (_np(rng, (2, 24, 3)) * 6).astype(np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 17:] = False
    ref = np.asarray(jstructure.get_bucketed_distance_matrix(jnp.asarray(coords),
                                                             jnp.asarray(mask)))
    out = get_bucketed_distance_matrix(torch.from_numpy(coords), torch.from_numpy(mask))
    assert np.array_equal(out.numpy(), ref)
    assert (ref == -100).any() and len(np.unique(ref)) > 10
    logits = _np(rng, (2, 24, 24, 37)) * 2
    jce = float(jloop.distogram_cross_entropy(jnp.asarray(logits), jnp.asarray(ref)))
    tce = float(loop.distogram_cross_entropy(torch.from_numpy(logits), out))
    assert abs(tce - jce) <= 1e-6 * abs(jce)
    ignored = torch.full((2, 24, 24), -100)
    assert float(loop.distogram_cross_entropy(torch.from_numpy(logits), ignored)) == 0.0


# ---------------------------------------------------------- optimizer


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax(weight_decay):
    """4 updates of MultiSteps(k=2) from identical gradients, one micro-step
    zeroed; gradient norms on both sides of the clip."""
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [_np(rng, s) for s in shapes]
    cfg = JConfig(train=JTrainConfig(gradient_accumulate_every=2, warmup_steps=2,
                                     num_steps=10, weight_decay=weight_decay))
    tx = jloop.build_optimizer(cfg)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tcfg = tconfig.Config(train=tconfig.TrainConfig(
        gradient_accumulate_every=2, warmup_steps=2, num_steps=10, weight_decay=weight_decay))
    opt = optim.build_optimizer(tcfg, tparams)
    for i in range(8):
        scale = 0.05 if i < 4 else 3.0  # first two updates unclipped, then clipped
        grads = [_np(rng, s) * scale for s in shapes]
        if i == 2:
            grads = [np.zeros_like(g) for g in grads]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([torch.from_numpy(g) for g in grads])
        assert applied == (i % 2 == 1)
        for a, b in zip(tparams, jparams):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max(), (i, weight_decay)
    # the first update ran at schedule(0) = 0: nothing moved then
    assert opt.count == 4


def test_schedule_matches_optax():
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 1000, 100000, 3e-5)
    out = optim.warmup_cosine_decay_schedule(0.0, 3e-4, 1000, 100000, 3e-5)
    for c in (0, 1, 999, 1000, 1001, 50000, 99999, 100000, 200000):
        assert abs(out(c) - float(ref(c))) <= 1e-6 * 3e-4, c


# ------------------------------------------------------- the train step


def _tiny(port: bool):
    """tests/test_train.py's tiny config, in either package."""
    mod = tconfig if port else __import__("alphafold2_tpu.config", fromlist=["Config"])
    return mod.Config(
        model=mod.ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64,
                              bfloat16=False),
        data=mod.DataConfig(crop_len=16, msa_depth=2, msa_len=16, batch_size=2,
                            min_len_filter=8),
        train=mod.TrainConfig(gradient_accumulate_every=1, warmup_steps=2),
    )


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step on the tiny config: initial params, the first step's
    loss and gradients, and the params after three steps."""
    cfg = _tiny(port=False)
    batch = next(iter(JSyntheticDataset(cfg.data, seed=0)))
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(batch)
    # init_state's state, with the init jitted (flax's eager init is slow)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                 mask=dev["mask"], msa_mask=dev["msa_mask"])
    state = jloop.TrainState.create(
        apply_fn=model.apply, params=params, tx=jloop.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    params0 = jax.tree.map(np.asarray, state.params)

    def loss_fn(p):
        logits = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                             msa_mask=dev["msa_mask"])
        labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
        return jloop.distogram_cross_entropy(logits, labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    step = jloop.make_train_step(model)
    losses = []
    for i in range(3):
        state, metrics = step(state, dev, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"batch": batch, "params0": params0, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "losses": losses,
            "params3": jax.tree.map(np.asarray, state.params)}


def _port_state(params0):
    cfg = _tiny(port=True)
    return cfg, loop.init_state(cfg, loop.build_model(cfg), flax_params=params0, device="cpu")


def test_train_step_matches_jax(jax_run):
    cfg, state = _port_state(jax_run["params0"])
    batch = loop.batch_to_device(jax_run["batch"], torch.device("cpu"))
    step = loop.make_train_step(state.model)
    state, metrics = step(state, batch)
    assert abs(float(metrics["loss"]) - jax_run["loss"]) <= 1e-5
    assert bool(metrics["grads_ok"]) and int(metrics["skipped"]) == 0
    # the gradients went through the state's optimizer untouched: compare them
    # leaf by leaf, mapped like the weights
    ref = convert.to_state_dict(jax_run["grads"], state.model)
    # the last layer's MSA update never reaches the loss: autograd leaves
    # those gradients None, where JAX gives exact zeros
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in state.model.named_parameters()}
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        g = got[name]
        norm = float(g_ref.norm())
        assert float((g - g_ref).norm()) <= 1e-4 * norm + 1e-12, name
        # Adam turns a 1e-12 gradient into a full step: zeros must stay zeros
        assert (g[g_ref == 0] == 0).all(), name
    for _ in range(2):
        state, metrics = step(state, batch)
    ref3 = convert.to_state_dict(jax_run["params3"], state.model)
    worst = max(float((p.detach() - ref3[n]).abs().max())
                for n, p in state.model.named_parameters())
    # lr 0, 1.5e-4, 3e-4 over the three steps: parameters agree far inside one lr step
    assert worst <= 1e-5, worst
    assert abs(float(metrics["loss"]) - jax_run["losses"][2]) <= 1e-5


def test_nonfinite_gradients_are_zeroed_and_still_applied(jax_run):
    """tests/test_train.py::test_train_step_skips_nonfinite on the port: the
    step is counted as skipped, the parameters do not move, Adam's count does."""
    cfg, state = _port_state(jax_run["params0"])
    first = next(state.model.parameters())
    with torch.no_grad():
        first.view(-1)[0] = float("nan")
    before = [p.detach().clone() for p in state.model.parameters()]
    step = loop.make_train_step(state.model, numerics_mode="norms")
    state, metrics = step(state, loop.batch_to_device(jax_run["batch"], torch.device("cpu")))
    assert not bool(metrics["grads_ok"]) and int(state.skipped) == 1
    for a, b in zip(before, state.model.parameters()):
        assert torch.allclose(a, b.detach(), equal_nan=True)
    assert state.optimizer.count == 1
    assert all(float(m.abs().sum()) == 0 for m in state.optimizer.mu)
    assert "grad_norm/trunk" in metrics and "update_norm/token_emb" in metrics


def test_converter_maps_a_bare_alphafold2_tree():
    """The tree JAX build_model gives (no af2/ prefix) onto the port's
    Alphafold2, every leaf exactly once."""
    cfg = _tiny(port=False)
    shapes = jax.eval_shape(
        jloop.build_model(cfg).init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 2, 4), jnp.int32), mask=jnp.ones((1, 4), bool),
        msa_mask=jnp.ones((1, 2, 4), bool))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = loop.build_model(_tiny(port=True))
    sd = convert.to_state_dict(tree, model)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())
    model.load_state_dict(sd)
    assert isinstance(model, Alphafold2)


# ----------------------------------------------------- entry points, options


def _cpu_cfg(**train):
    cfg = _tiny(port=True)
    cfg.train.log_every = 2
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def test_train_runs_on_the_cpu_and_needs_the_card_otherwise(monkeypatch, capsys):
    cfg = _cpu_cfg(gradient_accumulate_every=2)
    seen = []
    launches = axial.fused_attention.launches
    state = loop.train(cfg, num_steps=4, device="cpu",
                       callbacks=[lambda i, s, m: seen.append(float(m["loss"]))])
    assert len(seen) == 4 and np.isfinite(seen).all()
    assert state.step == 4 and state.optimizer.count == 2 and int(state.skipped) == 0
    assert axial.fused_attention.launches == launches == 0
    assert "first_step_s" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, num_steps=1)


def test_triage_logs_that_the_rerun_did_not_run(capsys):
    """Once the rerun was not ported and the loop logged only that it did
    not run; now each skipped step's fully tagged rerun runs one step late
    and names the first tensor the poisoned weight reaches: token 0's
    embedding row, which the MSA holds and the sequence does not."""
    def poison(i, state, metrics):
        if i == 0:
            with torch.no_grad():
                next(state.model.parameters()).view(-1)[0] = float("nan")

    cfg = _cpu_cfg(numerics="triage")
    state = loop.train(cfg, num_steps=3, device="cpu", callbacks=[poison])
    assert int(state.skipped) == 2  # steps 1 and 2 saw the poisoned weight
    notes = [l for l in capsys.readouterr().out.splitlines() if "nan_triage" in l]
    assert [n.split("]")[0] for n in notes] == ["[step 1", "[step 2"]
    assert all("first_nonfinite=embed.msa" in n and "ran=0" not in n for n in notes)


def test_train_pre_cli_on_the_cpu(capsys):
    train_pre_main(["train.num_steps=2", "train.log_every=1", "data.crop_len=12",
                    "data.msa_len=12", "data.min_len_filter=8", "model.dim=16",
                    "model.heads=2", "model.dim_head=8", "model.max_seq_len=32",
                    "--device=cpu"])
    out = capsys.readouterr().out
    assert '"dim": 16' in out and "[step 1]" in out


def test_config_matches_the_jax_config_and_parses_overrides():
    import dataclasses

    for name in ("ModelConfig", "MeshConfig", "DataConfig", "TrainConfig"):
        ref = __import__("alphafold2_tpu.config", fromlist=[name])
        assert ([(f.name, f.default) for f in dataclasses.fields(getattr(ref, name))]
                == [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, name))])
    base = tconfig.Config()
    cfg = tconfig.parse_cli(["model.depth=2", "--train.learning_rate=1e-4", "model.remat=true",
                             "serve.buckets=64,128", "positional"], base)
    assert (cfg.model.depth, cfg.train.learning_rate, cfg.model.remat) == (2, 1e-4, True)
    assert cfg.serve.buckets == (64, 128) and base.model.depth == 6
    with pytest.raises(KeyError):
        base.apply_overrides(["train.nope=1"])


@pytest.mark.parametrize("change", [
    ("mesh", "grid_cols", 2), ("data", "source", "sidechainnet"),
    ("mesh", "seq_parallel", 2), ("mesh", "grid_rows", 2), ("mesh", "data_parallel", 2),
])
def test_unported_options_raise(change):
    cfg = _cpu_cfg()
    section, field, value = change
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError):
        loop.train(cfg, num_steps=1, device="cpu")


@pytest.mark.parametrize("change", [
    ("data", "source", "npz"), ("model", "cross_attn_compress_ratio", 2),
    ("data", "source", "native"),
])
def test_ported_options_train(change, tmp_path):
    """The options test_unported_options_raise held before they were
    ported: one finite, unskipped step each (npz on two shards written
    here; native on its synthetic stream)."""
    cfg = _cpu_cfg()
    section, field, value = change
    setattr(getattr(cfg, section), field, value)
    if value == "npz":
        rng = np.random.default_rng(0)
        for i, n in enumerate((14, 20)):
            np.savez(tmp_path / f"c{i}.npz", seq=rng.integers(0, 20, n),
                     coords=np.cumsum(rng.standard_normal((n, 3)) * 2.2, axis=0))
        cfg.data.data_dir = str(tmp_path)
    seen = []
    state = loop.train(cfg, num_steps=1, device="cpu", callbacks=[
        lambda i, s, m: seen.append((float(m["loss"]), bool(m["grads_ok"])))])
    assert state.step == 1 and len(seen) == 1
    assert np.isfinite(seen[0][0]) and seen[0][1]
