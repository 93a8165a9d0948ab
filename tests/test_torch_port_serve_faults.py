"""Three serving behaviours the port holds to the JAX package, on the CPU:

- ``predict``'s ``seed`` keys the MDS start, as JAX's ``predict`` passes
  ``mds_key=jax.random.key(seed)`` (``alphafold2_tpu/predict.py:176``): the
  port's ``predict(seed=s)`` equals the model's forward started from
  ``position_keyed_init(3L, s)``, so two seeds start MDS from two points
  (the draws themselves are a settled difference: numpy here, threefry
  there).
- ``ServeEngine.predict_many`` turns every ``Exception`` of a dispatch into
  per-request ``status="error"`` results, as JAX's engine does
  (``alphafold2_tpu/serve/engine.py:983``): a model that raises
  ``TypeError`` on one bucket fails that chunk and serves the other, with
  every result in input order.
- ``ServeResult.latency_s`` is queue wait plus dispatch, the wait counted
  from the start of ``predict_many``, in both engines (JAX's synchronous
  dispatch): on two buckets the first waits less than it runs and the
  second waits at least as long as the first ran.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, ServeConfig as JServeConfig
from alphafold2_tpu.serve import ServeEngine as JServeEngine
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.predict import (
    build_model, encode_sequence, init_params, predict, synthesize_msa)
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
from alphafold2_tpu_torch.utils.mds import position_keyed_init

MODEL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False,
             msa_tie_row_attn=True)
# the synchronous dispatch (JAX's serve/engine.py:911-996) in both engines;
# the pipelined path is held in tests/test_torch_port_serve_pipeline.py
SERVE = dict(buckets=(8, 16), max_batch=2, mds_iters=5, msa_depth=3, pipeline_depth=0)
# input order: bucket 16, bucket 8, bucket 16
REQUESTS = ["MKVLAAGIHK", "ACDEFG", "PQRSTVWYAC"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _config():
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **MODEL)
    cfg.data.msa_depth = 3
    cfg.serve = dataclasses.replace(cfg.serve, **SERVE)
    return cfg


# ------------------------------------------------------------- predict's seed


def _forward_from(cfg, seq, seed, depth=3):
    """The model's forward on ``seq`` with the MSA ``predict`` synthesizes
    from ``seed`` and the MDS start drawn from ``seed``."""
    model = init_params(build_model(cfg), cfg.train.seed).eval()
    tokens = encode_sequence(seq)
    msa = synthesize_msa(tokens, depth, seed=seed)
    n = len(seq)
    with torch.inference_mode():
        out = model(torch.from_numpy(tokens).long(), torch.from_numpy(msa).long(),
                    mask=torch.ones((1, n), dtype=torch.bool),
                    msa_mask=torch.ones((1, depth, n), dtype=torch.bool),
                    coords0=torch.from_numpy(position_keyed_init(3 * n, seed)))
    return out["refined"][0].float().numpy()


@pytest.mark.parametrize("seed", [1, 2])
def test_predict_seed_keys_the_mds_start(seed):
    cfg = _config()
    seq = "ACDEFGHIK"
    pred = predict(cfg, seq, msa_depth=3, seed=seed, device="cpu")
    np.testing.assert_allclose(pred.atom14, _forward_from(cfg, seq, seed), atol=1e-6, rtol=0)
    # the engine's start (train.seed) is another point
    assert not np.array_equal(position_keyed_init(3 * len(seq), seed),
                              position_keyed_init(3 * len(seq), cfg.train.seed))


def test_build_model_keys_the_start_by_train_seed_by_default():
    cfg = _config()
    cfg.train.seed = 7
    assert build_model(cfg).mds_seed == 7
    assert build_model(cfg, mds_seed=3).mds_seed == 3


# ------------------------------------------------------------- errors


def test_any_dispatch_exception_becomes_per_request_errors():
    engine = ServeEngine(_config(), device="cpu")
    forward = engine.model.forward

    def poisoned(seq, *args, **kwargs):
        if seq.shape[1] == 8:  # bucket 8's dispatch
            raise TypeError("poison pill")
        return forward(seq, *args, **kwargs)

    engine.model.forward = poisoned
    results = engine.predict_many(REQUESTS)
    assert [r.seq for r in results] == REQUESTS
    assert [r.status for r in results] == ["ok", "error", "ok"]
    assert [r.bucket for r in results] == [16, 8, 16]
    assert results[1].error == "TypeError: poison pill" and results[1].atom14 is None
    for r in (results[0], results[2]):
        assert r.atom14.shape == (len(r.seq), 14, 3) and np.isfinite(r.atom14).all()
    bad = results[1]
    assert bad.latency_s == bad.queue_wait_s + bad.dispatch_s and bad.dispatch_s > 0


# ------------------------------------------------------------- latency


def _check_latency(results):
    """Results of REQUESTS: bucket 8's dispatch runs first, bucket 16's
    second."""
    for r in results:
        assert r.ok
        assert r.latency_s == r.queue_wait_s + r.dispatch_s
        assert r.queue_wait_s >= 0 and r.dispatch_s > 0
    first, second = results[1], results[0]
    assert first.queue_wait_s < first.dispatch_s
    assert second.queue_wait_s >= first.dispatch_s
    assert results[2].queue_wait_s == second.queue_wait_s  # one dispatch
    assert second.latency_s > first.latency_s


def test_latency_is_queue_wait_plus_dispatch_in_the_port():
    _check_latency(ServeEngine(_config(), device="cpu").predict_many(REQUESTS))


def test_latency_is_queue_wait_plus_dispatch_in_jax():
    """JAX's synchronous dispatch (pipeline_depth 0), as the port's above."""
    cfg = JConfig(model=JModelConfig(**MODEL), data=JDataConfig(msa_depth=3),
                  serve=JServeConfig(**SERVE))
    _check_latency(JServeEngine(cfg).predict_many(REQUESTS))


def test_a_lone_request_waits_less_than_it_runs():
    (r,) = ServeEngine(_config(), device="cpu").predict_many([ServeRequest("ACDEFG", seed=4)])
    assert r.ok and r.latency_s == r.queue_wait_s + r.dispatch_s
    assert 0 <= r.queue_wait_s < r.dispatch_s
