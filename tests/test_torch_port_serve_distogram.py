"""``serve.return_distogram`` in the port's ServeEngine against the JAX
package's: the (3L, 3L, K) distogram logits per request, sliced from the
batch as JAX slices them, on a tiny model with converted weights; ``None``
when the field is off. Logits come before MDS, so they compare at f32
tolerance (1e-4, the module-parity bound)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, ServeConfig as JServeConfig
from alphafold2_tpu.serve import ServeEngine as JServeEngine
from alphafold2_tpu.serve import ServeRequest as JServeRequest
from alphafold2_tpu_torch import constants, convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.predict import build_model
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

ATOL = 1e-4
MODEL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False,
             msa_tie_row_attn=True)
SERVE = dict(buckets=(8, 16), max_batch=2, mds_iters=5, msa_depth=3)
REQUESTS = [("ACDEFG", 0), ("MKVLAAGHW", 1), ("PQRSTVWYAC", 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_results():
    cfg = JConfig(model=JModelConfig(**MODEL), data=JDataConfig(msa_depth=3),
                  serve=JServeConfig(**SERVE, return_distogram=True))
    engine = JServeEngine(cfg)
    results = engine.predict_many([JServeRequest(seq=s, seed=i) for s, i in REQUESTS])
    return jax.tree.map(np.asarray, engine.params), results


def _port_engine(params, return_distogram):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **MODEL)
    cfg.data.msa_depth = 3
    cfg.serve = dataclasses.replace(cfg.serve, **SERVE, return_distogram=return_distogram)
    sd = convert.to_state_dict(params, build_model(cfg))
    return ServeEngine(cfg, state_dict=sd, device="cpu")


def test_return_distogram_matches_jax(jax_results):
    params, ref = jax_results
    out = _port_engine(params, True).predict_many(
        [ServeRequest(seq=s, seed=i) for s, i in REQUESTS])
    for r, o in zip(ref, out):
        n = 3 * len(o.seq)
        assert o.ok and o.bucket == r.bucket
        assert o.distogram.shape == (n, n, constants.DISTOGRAM_BUCKETS)
        assert o.distogram.shape == r.distogram.shape
        np.testing.assert_allclose(o.distogram, r.distogram, atol=ATOL, rtol=0)


def test_distogram_is_none_when_the_field_is_off(jax_results):
    params, _ = jax_results
    out = _port_engine(params, False).predict_many([ServeRequest(seq="ACDEFG")])
    assert out[0].ok and out[0].distogram is None and out[0].weights.shape == (18, 18)
