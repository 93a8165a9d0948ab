"""The streamed SE(3) edge attention of the port (models/se3.py
``EquivariantLayer._streamed_attention``) against the JAX layer's streamed
path, and against the port's own dense path, in float32.

Both packages stream past a module constant: JAX reads
``alphafold2_tpu.ops.chunked.CHUNK_THRESHOLD`` when the layer is called,
the port ``alphafold2_tpu_torch.models.se3.CHUNK_THRESHOLD``; the tests
lower both. A small ``edge_block`` (8) with an atom count that is not a
multiple of it exercises the padding. Streamed against streamed holds on
every row (a row with no valid pair averages over the padded keys in both);
streamed against dense holds on valid rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.se3 import EquivariantLayer as JEquivariantLayer
from alphafold2_tpu.ops import chunked as jchunked
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.models import se3
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

ATOL = 1e-5
DIM, VEC, HEADS, BLOCK = 16, 4, 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, b, n, keep):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, DIM)).astype(np.float32)
    v = rng.standard_normal((b, n, VEC, 3)).astype(np.float32)
    coords = (rng.standard_normal((b, n, 3)) * 4).astype(np.float32)
    mask = np.zeros((b, n), bool)
    for i, k in enumerate(keep):
        mask[i, :k] = True
    mask[0, 3] = False  # a masked atom inside the valid run
    return s, v, coords, mask


def _layers(s, v, coords, mask):
    jmod = JEquivariantLayer(dim=DIM, vec_dim=VEC, heads=HEADS, edge_block=BLOCK)
    params = jmod.init(jax.random.key(1), jnp.asarray(s), jnp.asarray(v),
                       jnp.asarray(coords), mask=jnp.asarray(mask))
    tmod = se3.EquivariantLayer(DIM, VEC, HEADS, edge_block=BLOCK)
    tmod.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tmod))
    return jmod, params, tmod


def _run_port(tmod, s, v, coords, mask):
    with torch.no_grad():
        out = tmod(*(torch.from_numpy(a) for a in (s, v, coords)),
                   mask=torch.from_numpy(mask))
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("b,n,keep", [(2, 21, (21, 13)), (1, 16, (16,)), (3, 19, (19, 0, 5))])
def test_streamed_matches_jax_streamed_on_every_row(monkeypatch, b, n, keep):
    s, v, coords, mask = _inputs(n, b, n, keep)
    jmod, params, tmod = _layers(s, v, coords, mask)
    monkeypatch.setattr(jchunked, "CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 1)
    assert se3.should_chunk(b * tmod.num_basis, n, n)
    ref = jmod.apply(params, *(jnp.asarray(a) for a in (s, v, coords)),
                     mask=jnp.asarray(mask))
    out = _run_port(tmod, s, v, coords, mask)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r), atol=ATOL, rtol=0)


def test_streamed_matches_the_dense_path_on_valid_rows(monkeypatch):
    b, n = 2, 21
    s, v, coords, mask = _inputs(7, b, n, (21, 13))
    _, _, tmod = _layers(s, v, coords, mask)
    dense = _run_port(tmod, s, v, coords, mask)
    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 1)
    streamed = _run_port(tmod, s, v, coords, mask)
    for o, r in zip(streamed, dense):
        np.testing.assert_allclose(o[mask], r[mask], atol=ATOL, rtol=0)


def test_a_threshold_of_zero_never_streams(monkeypatch):
    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 0)
    assert not se3.should_chunk(10**6, 10**4, 10**4)
    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 100)
    assert se3.should_chunk(1, 10, 10) and not se3.should_chunk(1, 9, 11)


def _serve_config():
    cfg = Config()
    cfg.model.dim, cfg.model.depth, cfg.model.heads, cfg.model.dim_head = 16, 1, 2, 8
    cfg.model.max_seq_len = 64
    cfg.model.bfloat16 = False
    cfg.model.msa_tie_row_attn = True
    cfg.serve.buckets = (8, 16)
    cfg.serve.max_batch = 2
    cfg.serve.msa_depth = 3
    cfg.serve.mds_iters = 5
    return cfg


def test_serve_warmup_crosses_the_streaming_threshold(monkeypatch):
    """Bucket 8 (2 x 16 x 112^2 edge elements) stays dense, bucket 16
    (2 x 16 x 224^2) streams; the warm-up runs both, and a request of the
    streamed bucket agrees with the dense engine's answer."""
    cfg = _serve_config()
    req = ServeRequest(seq="ACDEFGHIKLMNP", seed=2)
    dense = ServeEngine(cfg, device="cpu").predict_many([req])[0]
    calls = []
    original = se3.EquivariantLayer._streamed_attention

    def spy(self, *args):
        calls.append(args[0].shape[1])
        return original(self, *args)

    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 10**6)
    monkeypatch.setattr(se3.EquivariantLayer, "_streamed_attention", spy)
    engine = ServeEngine(cfg, device="cpu")
    engine.warmup()
    assert calls and set(calls) == {16 * 14}  # both refiner layers, bucket 16 only
    out = engine.predict_many([req])[0]
    assert out.ok and dense.ok and out.bucket == 16
    assert out.atom14.shape == (13, 14, 3) and np.isfinite(out.atom14).all()
    np.testing.assert_allclose(out.atom14, dense.atom14, atol=1e-4, rtol=0)
