"""bf16 serving and serving a checkpoint on the port, against the JAX
package, on the CPU.

- ``serve.dtype="bfloat16"``: ``ServeEngine`` casts every parameter to
  bf16, and its LayerNorms compute in f32 with the weights cast back up
  (flax's numerics), returning bf16. Held to ``tests/test_precision.py``'s
  bounds: on its tiny tied trunk, every tagged tensor's L2 norm within 1%
  of the f32 run's and the distogram logits within 5% relative L2 of JAX's
  f32 logits (and not equal to them: the cast happened); end to end, the
  bf16 engine on JAX's converted weights serves test_precision's two
  requests with finite atom14, and its distogram logits are within 5% of
  JAX's f32 engine's and of JAX's own bf16 engine's. The
  ``serve.dtype`` validation raises as JAX's does.
- ``ServeEngine(checkpoint_dir=...)`` restores the latest checkpoint's
  parameters (before the bf16 cast, as JAX's ``_init_params``): on a
  request whose length is its bucket, alone in its batch, with one MSA row
  (where ``featurize_bucketed`` and ``synthesize_msa`` draw the same row),
  ``predict``'s 200 MDS iterations and its seed equal to the engine's MDS
  seed, its atom14 equal
  ``predict(checkpoint_dir=...)``'s bit for bit; ``state_dict`` and
  ``checkpoint_dir`` together raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig, DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig, ServeConfig as JServeConfig
from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.serve import ServeEngine as JServeEngine
from alphafold2_tpu.serve import ServeRequest as JServeRequest
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.observe import numerics
from alphafold2_tpu_torch.predict import build_model, predict
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
from alphafold2_tpu_torch.train import end2end

# tests/test_precision.py's stated bounds
PER_LAYER_L2_DRIFT_BOUND = 0.01
LOGITS_REL_ERR_BOUND = 0.05
# tests/test_precision.py::test_bf16_serve_engine_end_to_end's config
MODEL = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48, bfloat16=False,
             msa_tie_row_attn=True)
SERVE = dict(buckets=(8, 16), max_batch=2, mds_iters=8)
REQUESTS = ["ACDEFGH", "MKVLAWGACDEF"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


# ------------------------------------------------------------ the trunk


def _inputs():
    """tests/test_precision.py's inputs: positions 20-23 padded."""
    rng = np.random.default_rng(0)
    b, n, m, nm = 1, 24, 4, 24
    seq = rng.integers(0, 20, (b, n)).astype(np.int32)
    msa = rng.integers(0, 20, (b, m, nm)).astype(np.int32)
    mask = np.ones((b, n), bool)
    mask[:, 20:] = False
    msa_mask = np.ones((b, m, nm), bool)
    msa_mask[:, :, 20:] = False
    return seq, msa, mask, msa_mask


def _trunk_kwargs():
    return dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=64,
                msa_tie_row_attn=True)


@pytest.fixture(scope="module")
def drift():
    seq, msa, mask, msa_mask = _inputs()
    jmodel = JAlphafold2(**_trunk_kwargs(), dtype=jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.key(0), seq, msa, mask=mask, msa_mask=msa_mask)
    jax_logits = np.asarray(jmodel.apply(params, seq, msa, mask=mask, msa_mask=msa_mask),
                            np.float32)
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params),
                               Alphafold2(**_trunk_kwargs()))
    t = [torch.from_numpy(a) for a in (seq, msa, mask, msa_mask)]
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = Alphafold2(**_trunk_kwargs(), dtype=dtype)
        model.load_state_dict(sd)
        model = model.to(dtype).eval()  # the serving cast: every parameter
        with torch.inference_mode(), numerics.collect() as col:
            logits = model(t[0].long(), t[1].long(), mask=t[2], msa_mask=t[3])
        runs[name] = (logits.float().numpy(),
                      {k: {s: float(v[s]) for s in numerics.STAT_KEYS}
                       for k, v in col.stats().items()})
    return jax_logits, runs


def test_bf16_per_layer_drift_inside_bounds(drift):
    _, runs = drift
    stats_f, stats_b = runs["f32"][1], runs["bf16"][1]
    assert set(stats_f) == set(stats_b)
    assert any(name.startswith("trunk.layer_") for name in stats_f)
    for name in sorted(stats_f):
        a, b = stats_f[name], stats_b[name]
        assert b["nan_count"] == 0 and b["inf_count"] == 0, name
        rel = abs(b["l2"] - a["l2"]) / max(a["l2"], 1e-9)
        assert rel <= PER_LAYER_L2_DRIFT_BOUND, (name, rel)


def test_bf16_logits_error_inside_bounds(drift):
    jax_logits, runs = drift
    valid = _inputs()[2][0]
    pair = valid[:, None] & valid[None, :]
    f32, bf16 = runs["f32"][0][0][pair], runs["bf16"][0][0][pair]
    ref = jax_logits[0][pair]
    assert _rel_l2(f32, ref) <= 1e-5
    rel = _rel_l2(bf16, ref)
    assert 0 < rel <= LOGITS_REL_ERR_BOUND, rel


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def jax_engines():
    """JAX's f32 and bf16 engines on one set of parameters, with their
    distogram logits."""
    out = {}
    params = None
    for dtype in ("float32", "bfloat16"):
        cfg = JConfig(model=JModelConfig(**MODEL), data=JDataConfig(msa_depth=2),
                      serve=JServeConfig(**SERVE, dtype=dtype, return_distogram=True))
        engine = JServeEngine(cfg)
        if params is None:
            params = jax.tree.map(np.asarray, engine.params)
        out[dtype] = engine.predict_many([JServeRequest(seq=s) for s in REQUESTS])
    return params, out


def _port_config(**serve):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, **MODEL)
    cfg.data.msa_depth = 2
    cfg.serve = dataclasses.replace(cfg.serve, **{**SERVE, **serve})
    return cfg


def test_bf16_serve_engine_end_to_end(jax_engines):
    params, ref = jax_engines
    cfg = _port_config(dtype="bfloat16", return_distogram=True)
    sd = convert.to_state_dict(params, build_model(cfg))
    engine = ServeEngine(cfg, state_dict=sd, device="cpu")
    leaves = list(engine.model.parameters())
    assert leaves and all(p.dtype == torch.bfloat16 for p in leaves)
    results = engine.predict_many([ServeRequest(seq=s) for s in REQUESTS])
    f32 = ServeEngine(_port_config(return_distogram=True), state_dict=sd,
                      device="cpu").predict_many([ServeRequest(seq=s) for s in REQUESTS])
    for r, o, jf, jb in zip(results, f32, ref["float32"], ref["bfloat16"]):
        assert r.ok, r.error
        assert r.atom14.shape == (len(r.seq), 14, 3) and np.isfinite(r.atom14).all()
        assert _rel_l2(o.distogram, jf.distogram) <= 1e-5
        for other in (jf.distogram, jb.distogram):
            assert 0 < _rel_l2(r.distogram, other) <= LOGITS_REL_ERR_BOUND


def test_serve_dtype_validation():
    cfg = Config()
    cfg.serve = dataclasses.replace(cfg.serve, buckets=(8,), dtype="float16")
    with pytest.raises(ValueError, match="serve.dtype"):
        ServeEngine(cfg, device="cpu")


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step end-to-end run that checkpoints into a directory."""
    from alphafold2_tpu_torch.config import DataConfig, TrainConfig

    root = tmp_path_factory.mktemp("ckpt")
    # predict realizes with 200 Guttman iterations
    cfg = _port_config(buckets=(8,), max_batch=1, msa_depth=1, mds_iters=200)
    cfg.data = DataConfig(crop_len=8, msa_depth=2, msa_len=8, batch_size=2, min_len_filter=6)
    cfg.train = TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                            numerics="off", checkpoint_dir=str(root))
    state = end2end.train_end2end(cfg, num_steps=2, device="cpu")
    return cfg, str(root), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_engine_equals_predict(trained, dtype):
    cfg, root, state = trained
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, dtype=dtype))
    engine = ServeEngine(cfg, checkpoint_dir=root, device="cpu")
    # restored before the cast: the trained parameters, rounded once
    for name, p in engine.model.named_parameters():
        want = state.model.state_dict()[name].to(p.dtype)
        assert torch.equal(p, want), name
    seq = "MKVLAWGA"  # its bucket's length
    (got,) = engine.predict_many([ServeRequest(seq=seq, seed=cfg.train.seed)])
    assert got.ok and got.atom14.shape == (8, 14, 3) and np.isfinite(got.atom14).all()
    if dtype == "float32":
        want = predict(cfg, seq, msa_depth=1, seed=cfg.train.seed, checkpoint_dir=root,
                       device="cpu")
        assert np.array_equal(got.atom14, want.atom14)
        assert np.array_equal(got.weights, want.weights)


def test_state_dict_and_checkpoint_dir_not_both(trained):
    cfg, root, state = trained
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(cfg, state_dict=state.model.state_dict(), checkpoint_dir=root,
                    device="cpu")
