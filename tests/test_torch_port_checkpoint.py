"""Checkpoints, resume, ``predict`` from a checkpoint, ``init_scheme="torch"``
and the end-to-end training loop and CLI, on the CPU at a tiny size.

- ``CheckpointManager``: a save/restore round trip of the parameters, the
  optimizer's state, ``step`` and ``skipped``; keep-N pruning; a killed
  save's temporary directory is never the latest.
- Resume, in both training loops: 4 steps equal 2 steps, then a restore,
  then 2 more, bit for bit (losses and parameters).
- ``restore_params`` reads the parameters alone, whatever the optimizer of
  the run that wrote them; ``predict(checkpoint_dir=)`` equals
  ``predict(state_dict=)``.
- SIGTERM during a run: the step in flight finishes, is checkpointed, the
  run stops and the previous handler comes back.
- ``torch_match_reinit``: each Dense weight and bias under U(+-1/sqrt(fan_in))
  with fan_in as JAX's rule counts it from the flax kernel, embeddings
  N(0, 1), LayerNorm kept, as JAX's ``torch_match_reinit`` draws them; the
  scanned and reversible trunks refused.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.init import torch_match_reinit as jax_reinit
from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.models.init import torch_match_reinit
from alphafold2_tpu_torch.ops.layers import Dense, LayerNorm
from alphafold2_tpu_torch.predict import predict
from alphafold2_tpu_torch.train import end2end, loop
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager
from alphafold2_tpu_torch.train_end2end import main as train_end2end_main

KW = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(end2end_model=False, **train):
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(**KW, bfloat16=False),
        data=tconfig.DataConfig(crop_len=8 if end2end_model else 12, msa_depth=2,
                                msa_len=8 if end2end_model else 12, batch_size=2,
                                min_len_filter=6),
        train=tconfig.TrainConfig(gradient_accumulate_every=1, warmup_steps=1,
                                  log_every=1, numerics="off"))
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _losses():
    seen = []
    return seen, (lambda i, state, metrics: seen.append((i, float(metrics["loss"]))))


# ------------------------------------------------------------ the manager


def _stepped_state(every_k=2):
    cfg = _cfg(gradient_accumulate_every=every_k)
    state = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
    step = loop.make_train_step(state.model)
    batch = loop.batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=0))),
                                 torch.device("cpu"))
    for _ in range(3):
        state, _ = step(state, batch)
    state.skipped = state.skipped + 2  # as if two steps had been skipped
    return cfg, state


def test_save_and_restore_round_trip(tmp_path):
    cfg, state = _stepped_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    mgr.save(3, state)
    fresh = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
    fresh, step = mgr.maybe_restore(fresh)
    assert step == 3 and fresh.step == 3 and int(fresh.skipped) == 2
    assert fresh.skipped.dtype == torch.int32
    for k, v in _params(state.model).items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) == (1, 1)
    for key in ("mu", "nu", "acc"):
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key
    # a run without accumulation cannot take this optimizer state
    other = loop.init_state(_cfg(), loop.build_model(_cfg()), device="cpu")
    with pytest.raises(ValueError, match="accumulation"):
        mgr.maybe_restore(other)


def test_keep_prunes_the_oldest_and_ignores_a_killed_save(tmp_path):
    _, state = _stepped_state(every_k=1)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    assert mgr.steps() == [3, 4]
    # a save killed before its rename leaves a temporary directory holding
    # a complete-looking step: never the latest, removed by the next save
    os.makedirs(tmp_path / ".tmp_step_9")
    mgr2 = CheckpointManager(str(tmp_path), keep=2)
    torch.save({}, str(tmp_path / ".tmp_step_9" / "train_state.pt"))
    assert mgr2.latest_step() == 4
    mgr2.save(5, state)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)


def test_restore_params_ignores_the_optimizer(tmp_path):
    """Parameters saved by a run with gradient accumulation (an
    accumulator in its optimizer state) load into a bare model."""
    cfg, state = _stepped_state(every_k=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    model = loop.build_model(cfg)
    model, step = mgr.restore_params(model)
    assert step == 3
    for k, v in _params(state.model).items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_params(model)
    assert not os.path.exists(tmp_path / "empty")  # reading creates nothing


# ------------------------------------------------------------ the loops


def _run(train_fn, cfg, num_steps):
    seen, cb = _losses()
    state = train_fn(cfg, num_steps=num_steps, device="cpu", callbacks=[cb])
    return state, seen


LOOPS = {"distogram": (loop.train, False), "end2end": (end2end.train_end2end, True)}


@pytest.mark.parametrize("name", list(LOOPS))
def test_resume_equals_an_uninterrupted_run(tmp_path, name):
    train_fn, e2e = LOOPS[name]
    whole, whole_losses = _run(train_fn, _cfg(e2e), 4)
    cfg = _cfg(e2e, checkpoint_dir=str(tmp_path), checkpoint_every=10)
    first, first_losses = _run(train_fn, cfg, 2)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2  # the final save
    resumed, resumed_losses = _run(train_fn, cfg, 4)
    assert [i for i, _ in resumed_losses] == [2, 3]
    assert first_losses + resumed_losses == whole_losses
    assert resumed.step == 4 and resumed.optimizer.count == whole.optimizer.count
    for k, v in _params(whole.model).items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert CheckpointManager(str(tmp_path)).latest_step() == 4


def test_checkpoint_cadence(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path), checkpoint_every=2, keep_checkpoints=5)
    loop.train(cfg, num_steps=5, device="cpu")
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4, 5]


def test_sigterm_checkpoints_the_finished_step(tmp_path, capsys):
    def term(i, state, metrics):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    cfg = _cfg(True, checkpoint_dir=str(tmp_path), checkpoint_every=100)
    state = end2end.train_end2end(cfg, num_steps=5, device="cpu", callbacks=[term])
    assert state.step == 2
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    assert "preempted=1" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before
    resumed, seen = _run(end2end.train_end2end, cfg, 3)
    assert [i for i, _ in seen] == [2] and resumed.step == 3


def test_predict_from_a_checkpoint(tmp_path):
    cfg = _cfg(True, checkpoint_dir=str(tmp_path), gradient_accumulate_every=2)
    trained = end2end.train_end2end(cfg, num_steps=2, device="cpu")
    seq = "MKTAYIAK"
    a = predict(cfg, seq, checkpoint_dir=str(tmp_path), device="cpu")
    b = predict(cfg, seq, state_dict=trained.model.state_dict(), device="cpu")
    assert np.isfinite(a.atom14).all() and a.atom14.shape == (len(seq), 14, 3)
    assert np.array_equal(a.atom14, b.atom14)
    with pytest.raises(ValueError, match="not both"):
        predict(cfg, seq, state_dict=trained.model.state_dict(),
                checkpoint_dir=str(tmp_path), device="cpu")


def test_train_end2end_and_its_cli_on_the_cpu(monkeypatch, capsys):
    cfg = _cfg(True, numerics="triage")
    state, seen = _run(end2end.train_end2end, cfg, 2)
    assert state.step == 2 and int(state.skipped) == 0 and len(seen) == 2
    assert all(np.isfinite(x) for _, x in seen)
    out = capsys.readouterr().out
    assert "first_step_s" in out and "steps_per_sec" in out and "rmsd=" in out
    train_end2end_main(["train.num_steps=2", "data.crop_len=8", "data.msa_len=8",
                        "model.dim=16", "model.max_seq_len=48", "train.log_every=1",
                        "--device=cpu"])
    out = capsys.readouterr().out
    assert '"dim": 16' in out and "[step 1]" in out
    bad = _cfg(True)
    bad.model.max_seq_len = 3 * bad.data.crop_len - 1
    with pytest.raises(ValueError, match="3\\*data.crop_len"):
        end2end.train_end2end(bad, num_steps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        end2end.train_end2end(cfg, num_steps=1)


@pytest.mark.parametrize("change", [
    ("mesh", "seq_parallel", 2), ("mesh", "data_parallel", 2),
    ("data", "source", "sidechainnet"),
])
def test_end2end_unported_options_raise(change):
    cfg = _cfg(True)
    section, field, value = change
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError):
        end2end.train_end2end(cfg, num_steps=1, device="cpu")


# ------------------------------------------------------------ init_scheme="torch"


@pytest.fixture(scope="module")
def reinit_pair():
    """JAX's torch_match_reinit of an End2EndModel tree (converted) and the
    port's on the same architecture."""
    shapes = jax.eval_shape(
        JEnd2End(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48, mds_iters=1).init,
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 2, 4), jnp.int32),
        mask=jnp.ones((1, 4), bool), msa_mask=jnp.ones((1, 2, 4), bool))

    def leaf(path, shape):  # flax's LayerNorm scales are ones, the rest is redrawn
        fill = jnp.ones if str(path[-1].key) == "scale" else jnp.zeros
        return fill(shape.shape, shape.dtype)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    ref = end2end.End2EndModel(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48)
    jax_sd = convert.to_state_dict(
        jax.tree.map(np.asarray, jax_reinit(tree, jax.random.key(0))), ref)
    port = torch_match_reinit(
        end2end.End2EndModel(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48), seed=0)
    return jax_sd, port


def test_reinit_draws_each_leaf_under_jax_rule(reinit_pair):
    jax_sd, port = reinit_pair
    port_sd = port.state_dict()
    checked = 0
    for name, mod in port.named_modules():
        if isinstance(mod, Dense):
            bound = 1.0 / np.sqrt(mod.in_features)
            for leaf in ("weight", "bias"):
                key = f"{name}.{leaf}"
                if key not in port_sd:
                    continue
                for sd in (jax_sd, port_sd):
                    v = sd[key].numpy()
                    assert np.abs(v).max() <= bound * (1 + 1e-6), key
                    assert np.abs(v).sum() > 0, key
                    if v.size >= 256:  # U(-b, b): std b/sqrt(3), mean 0
                        assert abs(v.std() - bound / np.sqrt(3)) < 0.1 * bound, key
                        assert abs(v.mean()) < 0.1 * bound, key
                checked += 1
        elif isinstance(mod, torch.nn.Embedding):
            for sd in (jax_sd, port_sd):
                v = sd[f"{name}.weight"].numpy()
                assert abs(v.std() - 1.0) < 0.1 and abs(v.mean()) < 0.1, name
        elif isinstance(mod, LayerNorm):
            assert torch.equal(port_sd[f"{name}.weight"], torch.ones_like(mod.weight))
            assert torch.equal(port_sd[f"{name}.bias"], torch.zeros_like(mod.bias))
            assert torch.equal(jax_sd[f"{name}.weight"], port_sd[f"{name}.weight"])
    assert checked > 40
    # all embedding draws together: N(0, 1) within sampling error
    embs = np.concatenate([v.numpy().ravel() for k, v in port_sd.items()
                           if isinstance(port.get_submodule(k.rsplit(".", 1)[0]),
                                         torch.nn.Embedding)])
    assert 0.97 < embs.std() < 1.03 and abs(embs.mean()) < 0.02


def test_reinit_is_keyed_by_seed_and_path():
    sa, sb, sc = (torch_match_reinit(end2end.End2EndModel(**KW), seed).state_dict()
                  for seed in (0, 0, 1))
    dense = "af2.distogram_proj.weight"
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa[dense], sc[dense])
    # two layers of one shape get different draws
    assert not torch.equal(sa["refiner.net.layer_0.q.weight"], sa["refiner.net.layer_1.q.weight"])


@pytest.mark.parametrize("engine", ["scan_layers", "reversible"])
def test_torch_init_refuses_stacked_trunks(engine):
    cfg = _cfg()
    cfg.model.init_scheme = "torch"
    setattr(cfg.model, engine, True)
    with pytest.raises(ValueError, match="incompatible"):
        loop.init_state(cfg, end2end.End2EndModel(**KW), device="cpu")
    cfg.model.init_scheme = "lecun"
    with pytest.raises(ValueError, match="unknown init_scheme"):
        loop.init_state(cfg, end2end.End2EndModel(**KW), device="cpu")


@pytest.mark.parametrize("name", list(LOOPS))
def test_torch_init_scheme_in_both_loops(name):
    train_fn, e2e = LOOPS[name]
    cfg = _cfg(e2e)
    cfg.model.init_scheme = "torch"
    state, seen = _run(train_fn, cfg, 1)
    emb = state.model.get_parameter(
        ("af2." if e2e else "") + "token_emb.weight")
    assert abs(float(emb.std()) - 1.0) < 0.2  # N(0, 1), not flax's N(0, 1/dim)
    assert np.isfinite(seen[0][1]) and int(state.skipped) == 0
