"""The PLM ``embedds`` input and the ``plm`` feature stream against the JAX
package, on the CPU in float32 at a tiny size.

- ``data/plm.py``: the hash provider bit-equal to JAX's; the precomputed
  provider's ``.npz`` round trip; ``wrap_with_embeddings`` dropping the
  MSA; ``make_provider("esm")`` raising as JAX's does here (no cached
  checkpoint, no download).
- ``Alphafold2`` with ``embedds`` (untied and tied rows: the (N, N) grid's
  N rows tie at R*D = N*dim_head) against flax, valid rows to 1e-5.
- One distogram train step on a ``plm`` batch against JAX's: the two
  streams equal, the loss, every gradient leaf (relative L2 1e-4) and the
  parameters after three steps.
- ``End2EndModel`` with ``embedds``: the tensors before MDS (distogram,
  distances, weights) to 1e-5; MDS from JAX's start, the refined atoms by
  Kabsch-aligned RMSD.
- ``train_end2end`` and ``train`` with ``data.features="plm"``; the width
  of ``embedd_project`` from a precomputed ``.npz`` of width 48.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jconfig
from alphafold2_tpu.data import plm as jplm
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.train import end2end as jend2end
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import constants, convert
from alphafold2_tpu_torch.data import plm
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.train import end2end, loop
from alphafold2_tpu_torch.utils.metrics import kabsch

LOGITS_TOL = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tokens(seed, b, n):
    return np.random.default_rng(seed).integers(0, 21, (b, n)).astype(np.int32)


# ------------------------------------------------------------------ providers


@pytest.mark.parametrize("dim,seed", [(1280, 0), (48, 3), (33, 7)])
def test_hash_provider_is_bit_equal_to_jax(dim, seed):
    seq = _tokens(1, 2, 17)
    ref = jplm.HashProjectionProvider(dim=dim, seed=seed)(seq)
    out = plm.HashProjectionProvider(dim=dim, seed=seed)(seq)
    assert out.dtype == np.float32 and out.shape == (2, 17, dim)
    np.testing.assert_array_equal(out, ref)


def test_precomputed_provider_round_trip(tmp_path):
    seq = _tokens(2, 3, 9)
    seq[1, 6:] = constants.AA_PAD_INDEX  # padding reads as "X"
    emb = plm.HashProjectionProvider(dim=24, seed=1)(seq)
    keys = ["".join(constants.AA_ALPHABET[t] if t < 20 else "X" for t in row) for row in seq]
    assert keys[1].endswith("XXX")
    np.savez(tmp_path / "emb.npz", **dict(zip(keys, emb)))
    out = plm.make_provider("precomputed", path=str(tmp_path / "emb.npz"))(seq)
    np.testing.assert_array_equal(out, emb)
    ref = jplm.PrecomputedProvider(str(tmp_path / "emb.npz"))(seq)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(KeyError):
        plm.PrecomputedProvider(str(tmp_path / "emb.npz"))(_tokens(9, 1, 9))
    with pytest.raises(ValueError, match="plm_path"):
        plm.make_provider("precomputed")
    with pytest.raises(ValueError, match="unknown plm provider"):
        plm.make_provider("nope")


def test_wrap_with_embeddings_drops_the_msa():
    cfg = tconfig.DataConfig(crop_len=10, msa_depth=2, msa_len=10, min_len_filter=6)
    batches = plm.wrap_with_embeddings(iter(SyntheticDataset(cfg, seed=0)),
                                       plm.HashProjectionProvider(dim=16))
    batch = next(batches)
    assert "msa" not in batch and "msa_mask" not in batch
    assert batch["embedds"].shape == (1, 10, 16)
    np.testing.assert_array_equal(batch["embedds"],
                                  plm.HashProjectionProvider(dim=16)(batch["seq"]))


def test_esm_provider_raises_as_jax_does():
    """Here either ``transformers`` is missing (ImportError) or the
    checkpoint is not cached (RuntimeError); both packages raise the same."""
    with pytest.raises((ImportError, RuntimeError)) as jax_err:
        jplm.make_provider("esm")
    with pytest.raises(jax_err.type):
        plm.make_provider("esm")


# ------------------------------------------------------------ embedds forward


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_alphafold2_with_embedds_matches_flax(tie):
    rng = np.random.default_rng(4)
    b, n, width = 2, 10, 24
    seq = _tokens(5, b, n)
    embedds = rng.standard_normal((b, n, width)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 7:] = False
    kw = dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=32, msa_tie_row_attn=tie)
    jm = JAlphafold2(**kw)
    args = dict(mask=jnp.asarray(mask), embedds=jnp.asarray(embedds))
    params = jm.init(jax.random.key(0), jnp.asarray(seq), **args)
    ref = np.asarray(jm.apply(params, jnp.asarray(seq), **args))
    pm = Alphafold2(**kw, num_embedds=width)
    pm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pm))
    assert pm.embedd_project.weight.shape == (32, width)
    with torch.no_grad():
        out = pm(torch.from_numpy(seq), mask=torch.from_numpy(mask),
                 embedds=torch.from_numpy(embedds)).numpy()
    valid = mask[:, :, None] & mask[:, None, :]
    np.testing.assert_allclose(out[valid], ref[valid], atol=LOGITS_TOL, rtol=LOGITS_TOL)


# ------------------------------------------------------- the distogram step


def _tiny(mod):
    return mod.Config(
        model=mod.ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64,
                              bfloat16=False),
        data=mod.DataConfig(crop_len=16, msa_depth=2, msa_len=16, batch_size=2,
                            min_len_filter=8, features="plm"),
        train=mod.TrainConfig(gradient_accumulate_every=1, warmup_steps=2),
    )


@pytest.fixture(scope="module")
def jax_plm_run():
    """JAX's plm stream's first batch, the init, the first step's loss and
    gradients, and the parameters after three steps."""
    cfg = _tiny(jconfig)
    batch = next(jloop.apply_features(iter(JSyntheticDataset(cfg.data, seed=0)), cfg))
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], None,
                                 mask=dev["mask"], embedds=dev["embedds"])
    state = jloop.TrainState.create(
        apply_fn=model.apply, params=params, tx=jloop.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    params0 = jax.tree.map(np.asarray, params)

    def loss_fn(p):
        logits = model.apply(p, dev["seq"], None, mask=dev["mask"], embedds=dev["embedds"])
        labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
        return jloop.distogram_cross_entropy(logits, labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    step = jloop.make_train_step(model)
    losses = []
    for i in range(3):
        state, metrics = step(state, dev, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"batch": batch, "params0": params0, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "losses": losses,
            "params3": jax.tree.map(np.asarray, state.params)}


def test_distogram_step_on_a_plm_batch_matches_jax(jax_plm_run):
    ref = jax_plm_run
    cfg = _tiny(tconfig)
    batch = next(loop.apply_features(iter(SyntheticDataset(cfg.data, seed=0)), cfg))
    assert batch.keys() == ref["batch"].keys() and "msa" not in batch
    for k in batch:
        np.testing.assert_array_equal(batch[k], ref["batch"][k], err_msg=k)
    model = loop.build_model(cfg, num_embedds=loop.embedds_width(batch))
    assert model.embedd_project.in_features == constants.NUM_EMBEDDS_TR
    state = loop.init_state(cfg, model, flax_params=ref["params0"], device="cpu")
    tb = loop.batch_to_device(batch, torch.device("cpu"))
    step = loop.make_train_step(state.model)
    state, metrics = step(state, tb)
    assert abs(float(metrics["loss"]) - ref["loss"]) <= 1e-5
    assert bool(metrics["grads_ok"]) and int(metrics["skipped"]) == 0
    g_ref = convert.to_state_dict(ref["grads"], state.model)
    named = dict(state.model.named_parameters())
    assert set(g_ref) == set(named)
    assert float(named["embedd_project.weight"].grad.norm()) > 0
    for name, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        norm = float(g_ref[name].norm())
        assert float((g - g_ref[name]).norm()) <= GRAD_REL_L2 * norm + 1e-12, name
        assert (g[g_ref[name] == 0] == 0).all(), name
    for _ in range(2):
        state, metrics = step(state, tb)
    p3 = convert.to_state_dict(ref["params3"], state.model)
    worst = max(float((p.detach() - p3[n]).abs().max()) for n, p in named.items())
    assert worst <= 1e-5, worst
    assert abs(float(metrics["loss"]) - ref["losses"][2]) <= 1e-5


# ---------------------------------------------------------- end to end


def test_end2end_model_with_embedds_matches_jax():
    kw = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, mds_iters=10)
    rng = np.random.default_rng(6)
    b, l, width = 2, 7, 20
    seq = _tokens(7, b, l)
    mask = np.ones((b, l), bool)
    embedds = rng.standard_normal((b, l, width)).astype(np.float32)
    jm = jend2end.End2EndModel(**kw)
    key = jax.random.key(3)
    jargs = dict(mask=jnp.asarray(mask), embedds=jnp.asarray(embedds))
    params = jm.init(jax.random.key(0), jnp.asarray(seq), **jargs)
    ref = jax.tree.map(np.asarray, jm.apply(params, jnp.asarray(seq), **jargs, mds_key=key))
    coords0 = np.asarray(2.0 * jax.random.uniform(key, (b, 3 * l, 3), jnp.float32) - 1.0)
    pm = end2end.End2EndModel(**kw, num_embedds=width)
    pm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pm))
    with torch.no_grad():
        out = pm(torch.from_numpy(seq), mask=torch.from_numpy(mask),
                 embedds=torch.from_numpy(embedds), coords0=torch.from_numpy(coords0))
    for k in ("distogram", "distances", "weights"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=LOGITS_TOL, rtol=LOGITS_TOL,
                                   err_msg=k)
    # the structure after MDS and the refiner: Kabsch-aligned, atom14
    pred = torch.from_numpy(out["refined"].numpy().reshape(b, -1, 3)).transpose(-1, -2)
    true = torch.from_numpy(ref["refined"].reshape(b, -1, 3)).transpose(-1, -2)
    aligned, centered = kabsch(pred.double(), true.double())
    rmsd = ((aligned - centered) ** 2).sum(-2).mean(-1).sqrt()
    assert float(rmsd.max()) <= 1e-3, rmsd


def _e2e_cfg(tmp, **data):
    return tconfig.Config(
        model=tconfig.ModelConfig(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48,
                                  bfloat16=False, msa_tie_row_attn=True),
        data=tconfig.DataConfig(crop_len=8, msa_depth=2, msa_len=8, batch_size=2,
                                min_len_filter=6, features="plm", **data),
        train=tconfig.TrainConfig(gradient_accumulate_every=1, warmup_steps=1, log_every=1,
                                  numerics="off", checkpoint_dir=str(tmp / "ck")))


def test_train_end2end_with_the_plm_stream_is_finite(tmp_path):
    metrics = []
    state = end2end.train_end2end(_e2e_cfg(tmp_path), num_steps=2, device="cpu",
                                  callbacks=[lambda i, s, m: metrics.append(m)])
    assert len(metrics) == 2
    assert all(bool(m["grads_ok"]) and np.isfinite(float(m["loss"])) for m in metrics)
    assert state.model.af2.embedd_project.in_features == constants.NUM_EMBEDDS_TR
    assert float(state.model.af2.embedd_project.weight.grad.norm()) > 0


def test_embedd_project_takes_the_width_of_a_precomputed_npz(tmp_path):
    cfg = _tiny(tconfig)
    cfg.data.batch_size = 1
    it = iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))
    rows = [next(it)["seq"][0] for _ in range(2)]
    store = {"".join(constants.AA_ALPHABET[t] if t < 20 else "X" for t in r):
             np.random.default_rng(i).standard_normal((len(r), 48)).astype(np.float32)
             for i, r in enumerate(rows)}
    np.savez(tmp_path / "emb48.npz", **store)
    cfg.data.plm_provider = "precomputed"
    cfg.data.plm_path = str(tmp_path / "emb48.npz")
    losses = []
    state = loop.train(cfg, num_steps=2, device="cpu",
                       callbacks=[lambda i, s, m: losses.append(float(m["loss"]))])
    assert state.model.embedd_project.weight.shape == (32, 48)
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_pre_cli_takes_the_plm_stream(capsys):
    from alphafold2_tpu_torch.train_pre import main as train_pre_main

    train_pre_main(["train.num_steps=2", "train.log_every=1", "data.crop_len=12",
                    "data.min_len_filter=8", "model.dim=16", "model.heads=2",
                    "model.dim_head=8", "model.max_seq_len=32", "data.features=plm",
                    "data.plm_provider=hash", "train.numerics=off", "--device=cpu"])
    out = capsys.readouterr().out
    assert '"features": "plm"' in out and "[step 1] loss=" in out
