"""The port's End2EndModel end to end against the JAX package's, plus the
port's serving entry points on the CPU.

Tie rows on and off, float32, converted weights, numpy inputs. The tensors
before MDS (distogram logits, distances, confidence weights) compare at
1e-4 on valid positions. MDS amplifies tiny differences (CHANGES, PR 6), so
the port starts from the JAX start coordinates (threefry cannot be
reproduced in torch) and the refined atom14 coordinates compare by
Kabsch-aligned RMSD, at most 1e-3 A. bf16 compute is held to the bounds of
tests/test_precision.py: per-layer relative L2 drift <= 1%, distogram logits
relative error <= 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.ops.cuda import axial, tied_row
from alphafold2_tpu_torch.predict import predict
from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
from alphafold2_tpu_torch.train.end2end import End2EndModel
from alphafold2_tpu_torch.utils.metrics import kabsch

KW = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, mds_iters=30)
B, L, M = 2, 8, 3
RMSD_BOUND = 1e-3  # Angstrom, Kabsch-aligned, valid atoms


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 20, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    mask[1, 6:] = False
    msa = rng.integers(0, 20, (B, M, L)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], (B, M, L)).copy()
    return seq, msa, mask, msa_mask


def _jax_start(n):
    draw = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), i), (3,), jnp.float32))(jnp.arange(n))
    return torch.from_numpy(np.array(2.0 * draw - 1.0))


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def pair(request):
    """(jax outputs, port model with the same weights, inputs)."""
    tie = request.param
    seq, msa, mask, msa_mask = _inputs()
    jm = JEnd2End(**KW, msa_tie_row_attn=tie, mds_per_position_init=True)
    params = jm.init(jax.random.key(0), seq, msa, mask=mask, msa_mask=msa_mask)
    ref = jax.jit(lambda p: jm.apply(p, seq, msa, mask=mask, msa_mask=msa_mask))(params)
    tm = End2EndModel(**KW, msa_tie_row_attn=tie)
    tm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tm))
    return jax.tree.map(np.asarray, ref), tm.eval(), (seq, msa, mask, msa_mask)


def _run(model, inputs, coords0=None):
    seq, msa, mask, msa_mask = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        out = model(seq.long(), msa.long(), mask=mask, msa_mask=msa_mask, coords0=coords0)
    return {k: v.float().numpy() for k, v in out.items()}


def test_end2end_matches_jax(pair):
    ref, model, inputs = pair
    mask = inputs[2]
    out = _run(model, inputs, coords0=_jax_start(3 * L))
    m3 = np.repeat(mask, 3, axis=1)
    pv = m3[:, :, None] & m3[:, None, :]
    assert np.abs((out["distogram"] - ref["distogram"]) * pv[..., None]).max() < 1e-4
    for key in ("distances", "weights"):
        assert np.abs((out[key] - ref[key]) * pv).max() < 1e-4, key
    for b in range(B):
        n = int(mask[b].sum())
        x = torch.from_numpy(out["refined"][b, :n].reshape(-1, 3).T[None].astype(np.float64))
        y = torch.from_numpy(ref["refined"][b, :n].reshape(-1, 3).T[None].astype(np.float64))
        xa, yc = kabsch(x, y)
        rmsd = float(torch.sqrt(((xa - yc) ** 2).sum(1).mean()))
        assert rmsd < RMSD_BOUND, (b, rmsd)
    # the port's own position-keyed start gives a finite structure too
    own = _run(model, inputs)
    assert np.isfinite(own["refined"]).all()


def test_bf16_drift_within_precision_bounds(pair):
    _, model, inputs = pair
    seq, msa, mask, msa_mask = (torch.from_numpy(a) for a in inputs)
    seq3, mask3 = seq.long().repeat_interleave(3, 1), mask.repeat_interleave(3, 1)
    af2 = model.af2
    layers = [getattr(af2.trunk, f"layer_{i}") for i in range(af2.trunk.depth)]

    def trace(dtype):
        seen = []
        hooks = [l.register_forward_hook(lambda m, a, o: seen.append(o[0].float()))
                 for l in layers]
        af2.dtype = dtype
        try:
            with torch.no_grad():
                logits = af2(seq3, msa.long(), mask=mask3, msa_mask=msa_mask)
        finally:
            af2.dtype = torch.float32
            for h in hooks:
                h.remove()
        return seen, logits

    f32_layers, f32_logits = trace(torch.float32)
    bf_layers, bf_logits = trace(torch.bfloat16)
    pv = (mask3[:, :, None] & mask3[:, None, :])[..., None]
    for a, b in zip(f32_layers, bf_layers):
        assert float(((b - a) * pv).norm() / (a * pv).norm()) <= 0.01
    rel = float(((bf_logits - f32_logits) * pv).norm() / (f32_logits * pv).norm())
    assert rel <= 0.05


def _tiny_config():
    cfg = Config()
    cfg.model.dim, cfg.model.depth, cfg.model.heads, cfg.model.dim_head = 16, 1, 2, 8
    cfg.model.max_seq_len = 64
    cfg.model.msa_tie_row_attn = True
    cfg.serve.buckets = (8, 16)
    cfg.serve.max_batch = 2
    cfg.serve.mds_iters = 20
    return cfg


def test_serve_engine_on_cpu_batches_without_changing_results():
    cfg = _tiny_config()
    engine = ServeEngine(cfg, device="cpu")
    engine.warmup()
    launches = (axial.fused_attention.launches, tied_row.tied_row_attention.launches)
    reqs = [ServeRequest("ACDEFG", seed=1), "MKVLAAGIHK", ServeRequest("ACDEFGHIKLM", 2)]
    results = engine.predict_many(reqs)
    assert [r.bucket for r in results] == [8, 16, 16]
    for r in results:
        assert r.ok and r.atom14.shape == (len(r.seq), 14, 3)
        assert np.isfinite(r.atom14).all()
        assert r.weights.shape == (3 * len(r.seq), 3 * len(r.seq))
    alone = engine.predict_many(["MKVLAAGIHK"])[0]
    np.testing.assert_allclose(alone.atom14, results[1].atom14, atol=1e-5)
    assert engine.counters.get("serve.padded_slots") == 2  # bucket 8 (1 of 2), solo rerun
    # CPU tensors never launch a kernel
    assert (axial.fused_attention.launches,
            tied_row.tied_row_attention.launches) == launches == (0, 0)


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict(cfg, "ACDEF")
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, device="cuda")
    pred = predict(cfg, "ACDEFGH", device="cpu", msa_depth=3)
    assert pred.atom14.shape == (7, 14, 3) and np.isfinite(pred.atom14).all()
    assert pred.to_pdb("ACDEFGH").coords.shape == (21, 3)


def test_unported_options_raise():
    # context parallelism needs a mesh to change anything: it serves as the
    # plain config does (tests/test_torch_port_model_flags.py)
    cfg = _tiny_config()
    cfg.model.context_parallel = "ring"
    ServeEngine(cfg, device="cpu")
    cfg = _tiny_config()
    cfg.serve.long_buckets = (512,)
    with pytest.raises(ValueError, match="require a device mesh"):
        ServeEngine(cfg, device="cpu")
