"""Four model flags that JAX's ``predict``, serving and end-to-end training run:
``cross_attn_compress_ratio``, ``msa_row_shard``, ``grid_parallel`` and
``context_parallel``. JAX's ``End2EndModel`` has no compression field, and
without a device mesh the other three change nothing
(``alphafold2_tpu/ops/attention.py:262-281`` needs an active mesh), so JAX
gives the plain config's results bit for bit. The port refused all four
with ``NotImplementedError`` in ``predict.build_model``, and with it in
``ServeEngine`` and ``train_end2end``; it now runs the plain model, as JAX
does on one device. The distogram loop takes the three mesh flags (JAX's
``train`` is bit-equal with and without each, 2 steps on the CPU), and it
builds KV compression in every layer's pair<-MSA pass, as JAX's distogram
model does (held against JAX in tests/test_torch_port_compress.py), where
``predict`` builds none. The reversible engine refuses the three mesh
flags, as JAX's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from alphafold2_tpu_torch.predict import build_model, predict
from alphafold2_tpu_torch.serve.engine import ServeEngine
from alphafold2_tpu_torch.train import end2end, loop

FLAGS = {
    "cross_attn_compress_ratio": 2,
    "msa_row_shard": True,
    "grid_parallel": True,
    "context_parallel": "ring",
}
MESH_FLAGS = ("msa_row_shard", "grid_parallel", "context_parallel")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _serve_config(**model):
    cfg = Config()
    cfg.model = dataclasses.replace(
        cfg.model, dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False,
        msa_tie_row_attn=True, **model)
    cfg.data.msa_depth = 3
    cfg.serve = dataclasses.replace(cfg.serve, buckets=(8, 16), max_batch=2, mds_iters=5,
                                    msa_depth=3)
    return cfg


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_predict_and_serving_take_the_flag_bit_equal(flag):
    plain, flagged = _serve_config(), _serve_config(**{flag: FLAGS[flag]})
    a = predict(plain, "ACDEFGHIK", msa_depth=3, seed=1, device="cpu")
    b = predict(flagged, "ACDEFGHIK", msa_depth=3, seed=1, device="cpu")
    np.testing.assert_array_equal(a.atom14, b.atom14)
    np.testing.assert_array_equal(a.distogram, b.distogram)
    reqs = ["MKVLAAGIHK", "ACDEFG", "PQRSTVWYAC"]
    ra = ServeEngine(plain, device="cpu").predict_many(reqs)
    rb = ServeEngine(flagged, device="cpu").predict_many(reqs)
    for x, y in zip(ra, rb):
        assert x.ok and y.ok
        np.testing.assert_array_equal(x.atom14, y.atom14)


def _e2e_cfg(**model):
    model = {"max_seq_len": 48, **model}
    cfg = Config(
        model=ModelConfig(dim=16, depth=1, heads=2, dim_head=8, bfloat16=False, **model),
        data=DataConfig(crop_len=8, msa_depth=2, msa_len=8, batch_size=2, min_len_filter=6),
        train=TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                          numerics="off"))
    return cfg


def _run(train_fn, cfg):
    losses = []
    state = train_fn(cfg, num_steps=2, device="cpu",
                     callbacks=[lambda i, s, m: losses.append(float(m["loss"]))])
    return losses, state.model.state_dict()


def _assert_same_run(a, b):
    assert a[0] == b[0] and len(a[0]) == 2 and np.isfinite(a[0]).all()
    assert a[1].keys() == b[1].keys()
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_train_end2end_with_compression_is_bit_equal():
    _assert_same_run(_run(end2end.train_end2end, _e2e_cfg()),
                     _run(end2end.train_end2end, _e2e_cfg(cross_attn_compress_ratio=2)))


@pytest.mark.parametrize("flag", MESH_FLAGS)
def test_train_end2end_with_a_mesh_flag_is_bit_equal(flag):
    _assert_same_run(_run(end2end.train_end2end, _e2e_cfg()),
                     _run(end2end.train_end2end, _e2e_cfg(**{flag: FLAGS[flag]})))


def _pre_cfg(**model):
    cfg = _e2e_cfg(max_seq_len=32, **model)
    cfg.data = DataConfig(crop_len=12, msa_depth=2, msa_len=12, batch_size=1,
                          min_len_filter=8)
    return cfg


@pytest.mark.parametrize("flag", MESH_FLAGS)
def test_distogram_loop_takes_the_mesh_flags_bit_equal(flag):
    _assert_same_run(_run(loop.train, _pre_cfg()),
                     _run(loop.train, _pre_cfg(**{flag: FLAGS[flag]})))


def test_distogram_loop_still_refuses_kv_compression():
    # the distogram loop refused KV compression until it was ported: it now
    # builds it in the pair<-MSA pass only, and predict's model still none
    cfg = _pre_cfg(cross_attn_compress_ratio=2)
    names = [n for n, _ in loop.build_model(cfg).named_parameters() if "kv_compress" in n]
    assert names and all(".pair_from_msa.kv_compress." in n for n in names)
    assert not any("kv_compress" in n for n, _ in build_model(cfg).named_parameters())


@pytest.mark.parametrize("flag", MESH_FLAGS)
def test_the_reversible_engine_refuses_the_mesh_flags_as_jax(flag):
    cfg = _e2e_cfg(reversible=True, **{flag: FLAGS[flag]})
    with pytest.raises(ValueError, match=flag):
        end2end.build_end2end_model(cfg)
    with pytest.raises(ValueError, match=flag):
        loop.build_model(cfg)
    # serving passes no reversible, as JAX's predict and ServeEngine do
    assert build_model(cfg).af2.trunk.engine == "loop"
