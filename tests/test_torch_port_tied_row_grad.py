"""Tied-row attention under grad on the port, against the JAX package, on
the CPU.

- K2's backward (``ops/cuda/tied_row.py``): the plain versions of the dq and
  dk/dv kernels (from the plain training forward's logsumexp and
  ``tied_row_dsum``) and the autograd ``TiedRowAttention`` (its CPU route)
  against ``jax.grad`` of JAX ``tied_row_attention``, whose custom VJP runs
  the Pallas ``_run_dq``/``_run_dkv`` at head dim R*D in interpret mode, as
  tests/test_pallas_kernels.py runs them. Raw gradients compare on every
  entry at 1e-4: ragged rows (their entries pre-zeroed by the caller, yet
  with nonzero raw dq in both), masked columns, a batch entry with no valid
  position, per-batch tie scales.
- The kernels' own plain versions at one row are K3's: the D-chunked
  backward that K3a/K3b take past head dim 128 is the same function.
- The whole train step with ``model.msa_tie_row_attn=True`` against
  ``alphafold2_tpu.train.loop`` on tests/test_train.py's tiny config: loss
  at 1e-5, every gradient leaf as tests/test_torch_port_train.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig
from alphafold2_tpu.config import DataConfig as JDataConfig
from alphafold2_tpu.config import ModelConfig as JModelConfig
from alphafold2_tpu.config import TrainConfig as JTrainConfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.ops.pallas.tied_row import tied_row_attention as jax_tied
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.ops.cuda import axial, tied_row
from alphafold2_tpu_torch.train import loop

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(shape, ragged, masked_cols, dead, per_batch, seed=5):
    """q, k, v, dO (B, R, N, H, D) and the shared masks and tie scale as
    ops/attention.py builds them: padded (row, position) entries zeroed,
    the tie scale counting the rows that vote."""
    b, r, n, h, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    rows = np.ones((b, r, n), bool)
    if masked_cols:
        rows[:, :, n - 3:] = False
    if ragged:
        rows[:, 1, n // 2:] = False  # one row shorter than the others
        rows[-1, r - 1] = False  # a whole row absent
    if dead:
        rows[0] = False
    q, k, v = (np.where(rows[..., None, None], t, 0).astype(np.float32) for t in (q, k, v))
    mask = rows.any(1)
    voting = np.maximum(rows.any(-1).sum(-1), 1).astype(np.float32)
    tie = voting**-0.5 if per_batch else np.float32(r**-0.5)
    return q, k, v, do, mask, tie


CASES = {
    "ragged rows, masked columns, per-batch tie": ((2, 4, 20, 2, 8), True, True, False, True),
    "dead batch entry": ((2, 3, 16, 2, 8), False, True, True, True),
    "unmasked, scalar tie (R*D 40)": ((1, 5, 12, 2, 8), False, False, False, False),
    "R*D 96, odd length": ((2, 3, 23, 1, 32), True, True, False, True),
}


def _jax_grads(q, k, v, do, mask, tie, scale):
    jt = tie if np.ndim(tie) == 0 else jnp.asarray(tie)
    m = jnp.asarray(mask)

    def loss(q, k, v):
        out = jax_tied(q, k, v, q_mask=m, kv_mask=m, sm_scale=scale, tie_scale=jt)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_matches_jax_grad(case):
    shape, *flags = CASES[case]
    q, k, v, do, mask, tie = _case(shape, *flags)
    scale = shape[-1] ** -0.5
    ref = _jax_grads(q, k, v, do, mask, tie, scale)
    t = torch.from_numpy
    tq, tk, tv, tdo, tm = (t(np.asarray(a)) for a in (q, k, v, do, mask))
    tt = float(tie) if np.ndim(tie) == 0 else t(tie)
    out, lse = tied_row.tied_row_attention_lse_reference(tq, tk, tv, tm, tm, scale, tt)
    dsum = tied_row.tied_row_dsum(out, tdo)
    args = (tq, tk, tv, tdo, lse, dsum, tm, tm, scale, tt)
    dq = tied_row.tied_row_attention_dq(*args)
    dk, dv = tied_row.tied_row_attention_dkv(*args)
    for got, want in zip((dq, dk, dv), ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.isfinite(lse[torch.isfinite(lse)].numpy()).all()


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_autograd_function_matches_jax_grad(case):
    shape, *flags = CASES[case]
    q, k, v, do, mask, tie = _case(shape, *flags)
    scale = shape[-1] ** -0.5
    ref = _jax_grads(q, k, v, do, mask, tie, scale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    tt = float(tie) if np.ndim(tie) == 0 else torch.from_numpy(tie)
    calls = tied_row.tied_row_attention_dq_reference.calls
    out = tied_row.tied_row_attention(*leaves, q_mask=tm, kv_mask=tm, sm_scale=scale,
                                      tie_scale=tt)
    assert out.grad_fn is not None and "TiedRowAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(do)).sum().backward()
    assert tied_row.tied_row_attention_dq_reference.calls == calls + 1
    for leaf, want in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=ATOL, rtol=0)


def test_lse_is_the_shared_logsumexp():
    q, k, v, _, mask, tie = _case((2, 3, 10, 2, 8), True, True, True, True)
    t = torch.from_numpy
    out, lse = tied_row.tied_row_attention_lse_reference(t(q), t(k), t(v), t(mask), t(mask),
                                                         0.3, t(tie))
    s = np.einsum("brihd,brjhd->bhij", q, k) * (0.3 * tie)[:, None, None, None]
    s = np.where(mask[:, None, None, :], s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    live = mask[:, None, :].repeat(2, 1) & mask.any(-1)[:, None, None]
    np.testing.assert_allclose(lse.numpy()[live], want[live], atol=1e-5, rtol=0)
    assert (lse[0] == float("inf")).all()  # the dead batch entry: no valid key
    ref = tied_row.tied_row_attention_reference(t(q), t(k), t(v), t(mask), t(mask), 0.3, t(tie))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_row_is_the_fused_backward(dtype):
    """At R = 1 with tie 1 the tied plain versions are K3a/K3b's: the
    D-chunked kernels that take head dims past 128 compute both."""
    rng = np.random.default_rng(9)
    b, h, n, d = 2, 3, 17, 24
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[1, 11:] = False
    out, lse = axial.fused_attention_lse_reference(q, k, v, mask, mask, 0.2)
    dsum = axial.attention_dsum(out, do)
    args = (q, k, v, do, lse, dsum, mask, mask, 0.2)
    rows = lambda t: t.permute(0, 2, 1, 3).unsqueeze(1)  # (B, H, N, D) -> (B, 1, N, H, D)
    targs = (*(rows(t) for t in (q, k, v, do)), lse, dsum, mask, mask, 0.2, 1.0)
    assert torch.equal(rows(axial.fused_attention_dq_reference(*args)),
                       tied_row.tied_row_attention_dq_reference(*targs))
    for a, b_ in zip(axial.fused_attention_dkv_reference(*args),
                     tied_row.tied_row_attention_dkv_reference(*targs)):
        torch.testing.assert_close(rows(a), b_, atol=0, rtol=0)


# ------------------------------------------------ the tied train step


def _tiny(port: bool):
    """tests/test_train.py's tiny config with tied MSA rows, in either
    package."""
    kw = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64, bfloat16=False,
              msa_tie_row_attn=True)
    data = dict(crop_len=16, msa_depth=2, msa_len=16, batch_size=2, min_len_filter=8)
    train = dict(gradient_accumulate_every=1, warmup_steps=2)
    if port:
        return tconfig.Config(model=tconfig.ModelConfig(**kw), data=tconfig.DataConfig(**data),
                              train=tconfig.TrainConfig(**train))
    return JConfig(model=JModelConfig(**kw), data=JDataConfig(**data),
                   train=JTrainConfig(**train))


@pytest.fixture(scope="module")
def jax_tied_run():
    """The JAX loss and gradients of the first step on the tied tiny
    config, and its initial parameters."""
    cfg = _tiny(port=False)
    batch = next(iter(JSyntheticDataset(cfg.data, seed=0)))
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                 mask=dev["mask"], msa_mask=dev["msa_mask"])

    def loss_fn(p):
        logits = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                             msa_mask=dev["msa_mask"])
        labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
        return jloop.distogram_cross_entropy(logits, labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return {"batch": batch, "params0": jax.tree.map(np.asarray, params),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


def test_tied_train_step_matches_jax(jax_tied_run):
    cfg = _tiny(port=True)
    state = loop.init_state(cfg, loop.build_model(cfg), flax_params=jax_tied_run["params0"],
                            device="cpu")
    batch = loop.batch_to_device(jax_tied_run["batch"], torch.device("cpu"))
    calls = tied_row.tied_row_attention_dkv_reference.calls
    state, metrics = loop.make_train_step(state.model)(state, batch)
    assert tied_row.tied_row_attention_dkv_reference.calls > calls  # the tied backward ran
    assert abs(float(metrics["loss"]) - jax_tied_run["loss"]) <= 1e-5
    assert bool(metrics["grads_ok"]) and int(metrics["skipped"]) == 0
    ref = convert.to_state_dict(jax_tied_run["grads"], state.model)
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in state.model.named_parameters()}
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        g = got[name]
        assert float((g - g_ref).norm()) <= 1e-4 * float(g_ref.norm()) + 1e-12, name
        assert (g[g_ref == 0] == 0).all(), name
