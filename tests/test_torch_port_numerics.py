"""Numerics telemetry on the port (``observe/numerics.py``, the model's tags,
``make_train_step(numerics_mode="full")``, ``make_triage_step`` and the
loop's NaN triage) against the JAX package, on the CPU.

- ``tensor_stats``, ``tree_stats``, ``flatten_stats``, ``triage_report``
  and ``first_nonfinite`` give JAX's values on the same arrays, NaN and Inf
  included (stats within 1e-6 relative, counts and names exact);
- ``tag`` without a collector returns its input and records nothing;
  repeated names dedupe as ``name#2`` in tag order;
- a ``full`` step's tags, by engine (default, remat, scan, reversible),
  have JAX's names in JAX's order (its ``loss_fn`` aux under
  ``numerics.collect``) and stats within 1e-5 relative on converted
  weights, on a batch without padding (the port's masked query rows are 0
  where JAX's are uniform); remat is held to JAX's default engine, whose
  tags and values JAX's remat shares (the tags sit outside ``nn.remat``);
- triage names the poisoned ``trunk.layer_1.pair``, with JAX's order of
  tags, loss and gradient groups (JAX's ``test_triage_names_poisoned_
  trunk_layer``);
- the loop: a poisoned restored checkpoint gives ``metrics.jsonl`` with a
  ``nan_triage`` naming ``trunk.layer_0`` first and
  ``numerics/trunk.layer_0.pair/nan_count`` > 0 (JAX's
  ``test_train_loop_triage_and_first_step_metrics``, without ``compile_s``
  and ``step_flops``, which come from XLA).

Widths: dim 16, depth 2, heads 2, dim_head 8, crop 12, float32.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jconfig
from alphafold2_tpu.observe import numerics as jnum
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.observe import numerics
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager

REL = 1e-5  # activation stats, full step, relative
ENGINES = {"default": {}, "remat": {"remat": True}, "scan": {"scan_layers": True},
           "reversible": {"reversible": True}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


ARRAYS = {
    "mixed": np.array([[1.0, -2.0, np.nan], [np.inf, 3.0, 0.5]], np.float32),
    "clean": np.linspace(-3, 2, 12, dtype=np.float32).reshape(3, 4),
    "neg_inf": np.array([-np.inf, -1.0, np.nan, np.nan], np.float32),
    "empty": np.zeros((0, 3), np.float32),
}


def _host(stats):
    return {k: float(v) for k, v in stats.items()}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_tensor_stats_match_jax(name):
    a = ARRAYS[name]
    ours = _host(numerics.tensor_stats(torch.from_numpy(a)))
    theirs = _host(jnum.tensor_stats(jnp.asarray(a)))
    assert ours.keys() == theirs.keys() == set(numerics.STAT_KEYS)
    for k in numerics.STAT_KEYS:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-6), k


def test_tree_stats_and_host_helpers_match_jax():
    arrays = list(ARRAYS.values())
    ours = _host(numerics.tree_stats([torch.from_numpy(a) for a in arrays]))
    theirs = _host(jnum.tree_stats({str(i): jnp.asarray(a) for i, a in enumerate(arrays)}))
    assert ours == pytest.approx(theirs, rel=1e-6)
    assert _host(numerics.tree_stats([])) == _host(jnum.tree_stats({}))

    def collected(mod, conv):
        with mod.collect() as col:
            for name in ("good", "bad", "good", "worse"):
                a = ARRAYS["clean"] if name == "good" else ARRAYS[
                    "mixed" if name == "bad" else "neg_inf"]
                mod.tag(name, conv(a))
        return col.stats()

    ours = collected(numerics, torch.from_numpy)
    theirs = collected(jnum, jnp.asarray)
    assert list(ours) == list(theirs) == ["good", "bad", "good#2", "worse"]
    assert numerics.flatten_stats(ours) == pytest.approx(jnum.flatten_stats(theirs), rel=1e-6)
    assert numerics.first_nonfinite(ours) == jnum.first_nonfinite(theirs) == "bad"
    r_ours, r_theirs = numerics.triage_report(ours, step=3), jnum.triage_report(theirs, step=3)
    assert {k: v for k, v in r_ours.items() if k != "tensors"} == {
        k: v for k, v in r_theirs.items() if k != "tensors"}
    assert r_ours["nonfinite"] == ["bad", "worse"]
    for name, s in r_theirs["tensors"].items():
        assert r_ours["tensors"][name] == pytest.approx(s, rel=1e-6)


def test_tag_without_a_collector_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert numerics.tag("t", x) is x
    with numerics.collect(enabled=False) as col:
        assert numerics.tag("x", x) is x
    assert col.stats() == {}
    with numerics.collect() as outer:
        with numerics.collect(enabled=False):
            numerics.tag("inner", x)  # the active collector is the outer one
        with numerics.collect() as inner:
            numerics.tag("nested", x)
        numerics.tag("after", x)
    assert list(outer.stats()) == ["inner", "after"] and list(inner.stats()) == ["nested"]


# ------------------------------------------------------------- the steps


def _cfgs(**model):
    kw = dict(model=dict(dim=16, depth=2, heads=2, dim_head=8, max_seq_len=32,
                         bfloat16=False, **model),
              data=dict(crop_len=12, msa_depth=2, msa_len=12, batch_size=1, min_len_filter=12),
              train=dict(gradient_accumulate_every=1, warmup_steps=1))
    return tuple(mod.Config(model=mod.ModelConfig(**kw["model"]),
                            data=mod.DataConfig(**kw["data"]),
                            train=mod.TrainConfig(**kw["train"]))
                 for mod in (jconfig, tconfig))


def _jax_setup(jcfg, batch):
    model = jloop.build_model(jcfg)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(0), dev["seq"], dev["msa"], mask=dev["mask"],
                                 msa_mask=dev["msa_mask"])
    return model, dev, params


def _jax_full_stats(model, dev, params):
    """What JAX's full step carries as ``metrics["numerics"]``: its
    ``loss_fn`` aux under ``numerics.collect``."""

    def fwd(p):
        with jnum.collect() as col:
            logits = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                                 msa_mask=dev["msa_mask"], deterministic=False,
                                 rngs={"dropout": jax.random.key(0)})
            labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
            jloop.distogram_cross_entropy(logits, labels)
        return col.stats()

    return jax.device_get(jax.jit(fwd)(params))


def _ordered_names(stats):
    return [n for n, _ in numerics._ordered(stats)]


@functools.lru_cache(maxsize=None)
def _jax_reference(engine):
    jcfg, cfg = _cfgs(**ENGINES[engine])
    batch = next(iter(SyntheticDataset(cfg.data, seed=0)))
    jmodel, dev, params = _jax_setup(jcfg, batch)
    return batch, params, _jax_full_stats(jmodel, dev, params)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_full_step_tags_match_jax(engine):
    _, cfg = _cfgs(**ENGINES[engine])
    batch, params, ref = _jax_reference("default" if engine == "remat" else engine)
    assert batch["mask"].all() and batch["msa_mask"].all()
    state = loop.init_state(cfg, loop.build_model(cfg), flax_params=params, device="cpu")
    step = loop.make_train_step(state.model, numerics_mode="full")
    _, metrics = step(state, loop.batch_to_device(batch, torch.device("cpu")))
    stats = metrics["numerics"]
    assert _ordered_names(stats) == _ordered_names(ref)
    layers = [f"trunk.layer_{i}.{s}" for i in range(2) for s in ("pair", "msa")]
    body = ["trunk.out.pair", "trunk.out.msa"] if engine in ("scan", "reversible") else layers
    assert _ordered_names(stats) == ["embed.pair", "embed.msa", *body, "distogram.logits",
                                     "loss.distogram_nll"]
    for name, s in ref.items():
        for k in numerics.STAT_KEYS:
            assert float(stats[name][k]) == pytest.approx(float(s[k]), rel=REL), (name, k)
    assert any(k.startswith("update_norm/") for k in metrics)  # "full" keeps the norms


def _poisoned(params, key_name):
    """NaN every leaf of a flax tree under the module ``key_name``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = [np.full_like(v, np.nan) if any(getattr(k, "key", None) == key_name for k in path)
              else np.asarray(v) for path, v in flat]
    return jax.tree.unflatten(treedef, leaves)


def test_triage_names_the_poisoned_trunk_layer_as_jax_does():
    jcfg, cfg = _cfgs()
    batch, params, _ = _jax_reference("default")
    poisoned = _poisoned(params, "layer_1")
    ref = jax.device_get(jloop.make_triage_step(jloop.build_model(jcfg))(
        poisoned, jloop.device_put_batch(batch), jax.random.key(1)))
    state = loop.init_state(cfg, loop.build_model(cfg), flax_params=poisoned, device="cpu")
    triage = loop.make_triage_step(state.model)
    tbatch = loop.batch_to_device(batch, torch.device("cpu"))
    stats = triage(tbatch)
    report = numerics.triage_report(stats)
    assert report["first_nonfinite"] == "trunk.layer_1.pair"
    assert report["nonfinite"] == jnum.triage_report(ref)["nonfinite"]
    assert _ordered_names(stats) == _ordered_names(ref)
    assert float(stats["trunk.layer_0.pair"]["nan_count"]) == 0
    assert "grad/trunk" in stats
    assert all(p.grad is None for p in state.model.parameters())  # no state change
    clean = loop.init_state(cfg, loop.build_model(cfg), flax_params=params, device="cpu")
    assert numerics.first_nonfinite(loop.make_triage_step(clean.model)(tbatch)) is None


def test_train_loop_triage_and_first_step_metrics(tmp_path):
    """A poisoned restored checkpoint skips every step; each skip is rerun
    one step late and logged with the first non-finite tensor."""
    _, cfg = _cfgs()
    cfg.train.num_steps, cfg.train.log_every = 3, 1
    cfg.train.checkpoint_dir, cfg.train.checkpoint_every = str(tmp_path), 1000
    cfg.train.numerics = "triage"
    state = loop.init_state(cfg, loop.build_model(cfg), device="cpu")
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if ".pair_ff." in name:
                p.fill_(float("nan"))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state)
    mgr.wait()
    mgr.close()

    final = loop.train(cfg, device="cpu")  # restores step 1, runs steps 1 and 2
    assert int(final.skipped) == 2

    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert any("first_step_s" in r for r in records)
    assert not any(r.get("steps_per_sec") == 0.0 for r in records)
    assert any("grad_norm/trunk" in r for r in records if "loss" in r)
    triages = [r for r in records if r.get("event") == "nan_triage"]
    assert [r["step"] for r in triages] == [1, 2]
    assert triages[0]["first_nonfinite"].startswith("trunk.layer_0")
    assert triages[0]["numerics/trunk.layer_0.pair/nan_count"] > 0


def test_full_mode_in_the_loop_logs_the_stats(tmp_path, monkeypatch):
    """``AF2TPU_NUMERICS=full`` overrides ``train.numerics`` for one run;
    every logged step carries ``numerics/<tag>/<stat>``."""
    _, cfg = _cfgs()
    cfg.train.log_every, cfg.train.checkpoint_dir, cfg.train.numerics = 1, str(tmp_path), "off"
    monkeypatch.setenv("AF2TPU_NUMERICS", "full")
    loop.train(cfg, num_steps=2, device="cpu")
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    steps = [r for r in records if "loss" in r]
    assert len(steps) == 2
    assert all(r["numerics/trunk.layer_1.msa/nan_count"] == 0 for r in steps)
    assert all(r["numerics/embed.pair/l2"] > 0 for r in steps)
    monkeypatch.setenv("AF2TPU_NUMERICS", "everything")
    with pytest.raises(ValueError, match="train.numerics"):
        loop.train(cfg, num_steps=1, device="cpu")
