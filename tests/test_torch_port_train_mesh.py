"""Training on a device mesh (``alphafold2_tpu_torch/parallel``,
``train/loop.py``, ``train/end2end.py``) against the JAX package.

Ranks are gloo process groups of 2 and 4 processes
(``torch_mesh_ranks.py``, many checks a spawn); shapes are tiny (dim 32,
depth 1, heads 2, dim_head 16, crop 16, f32):

- every differentiable collective (``all_to_all``, ``all_gather``,
  ``reduce_scatter``, ``all_reduce``, ``ring_shift``, ``transpose_pair``,
  ``gather_pair``) against the gradient of the same composed function
  without a mesh, and the census of a backward;
- ``grid_axial_attention``'s gradients, JAX's dense pass and the K1 hook,
  both axes, masked, against ``jax.grad`` at 2e-5 (JAX's
  ``test_grads_match_dense``); ring and Ulysses against ``jax.grad`` of
  JAX's on its CPU mesh; the merged MSA<-pair pass and the sharded sparse
  grid pass against the meshless port;
- the distogram step on ``2x1``, ``1x2``, ``1x1x2``, ``2x2``, ``1x4``,
  ``1x2x2`` (also sparse with tied rows), ring and Ulysses meshes, with
  remat, the scanned and the reversible engine, against JAX's meshless ``make_train_step``
  from the same parameters and batch: every loss within 1e-4 relative and
  the parameters after three steps within 1e-4 (JAX's own bounds), every
  first-step gradient close and nonzero where JAX's is, the parameters the
  same on every rank after every step; the triage step on a mesh;
- the end-to-end step on ``2x1`` and ``1x2`` against JAX's (an unpadded
  batch), every rank's backward reaching the logits' gather; the reversible
  engine's end-to-end step on ``2x1`` against the port's meshless one;
- both loops through their entry points on a mesh, checkpointed at step 2
  and resumed, equal to an uninterrupted run;
- JAX's configuration refusals, the reversible engine's (a grid mesh)
  and dropout's; the reversible step on a (1, 1) mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jconfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.parallel import grid_parallel as jgrid
from alphafold2_tpu.parallel import seq_parallel as jseq
from alphafold2_tpu.parallel.sharding import make_mesh as jmake_mesh
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.config import Config
from alphafold2_tpu_torch.train import end2end, loop
from test_torch_port_end2end import GRAD_REL_L2, KW, MDS_ITERS, _check_leaf, _jax_step
from torch_mesh_ranks import TRAIN_MESHES, run_ranks

ATOL = 1e-5
GRID_GRAD_ATOL = 2e-5  # JAX's test_grads_match_dense
LOSS_RTOL = 1e-4  # JAX's test_grid_train_step_matches_single_device
PARAM_ATOL = 1e-4
GRAD_LEAF_REL = 1e-3  # a leaf's first-step gradient, relative L2 (floor below)
GRAD_FLOOR = 1e-6  # of the total gradient norm, for a leaf that is itself that small
STEPS = 3
WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------- collectives and passes


def _grads_payload():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    m = np.ones((2, 8), bool)
    m[1, 6:] = False
    pm = m[:, :, None] & m[:, None, :]
    grid = {"q": f(2, 8, 8, 2, 4), "k": f(2, 8, 8, 2, 4), "v": f(2, 8, 8, 2, 4),
            "mask": pm, "valid": pm, "w": f(2, 8, 8, 2, 4)}
    seq_mask = np.ones((2, 16), bool)
    seq_mask[0, 7:] = False
    seq = {"q": f(2, 4, 16, 8), "k": f(2, 4, 16, 8), "v": f(2, 4, 16, 8), "mask": seq_mask}
    x_mask = np.ones((2, 6), bool)
    x_mask[1, 4:] = False
    ctx_mask = np.ones((2, 16), bool)
    ctx_mask[1, 5:] = False
    cross = {"x": f(2, 6, 16), "ctx": f(2, 16, 16), "mask": x_mask, "ctx_mask": ctx_mask,
             "w": f(2, 6, 16)}
    sm = np.ones((1, 64), bool)
    sm[:, 57:] = False
    sparse = {"x": f(1, 64, 64, 16), "mask": sm[:, :, None] & sm[:, None, :],
              "w": f(1, 64, 64, 16)}
    coll = {"x": f(8, 8), "w": f(8, 8), "pair": f(1, 8, 8, 3), "pair_w": f(1, 8, 8, 3)}
    return {"coll": coll, "grid": grid, "seq": seq, "cross": cross, "sparse": sparse}


GRADS = _grads_payload()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def grad_ranks(request, tmp_path_factory):
    world = request.param
    return world, run_ranks("mesh_grads", world, tmp_path_factory.mktemp(f"g{world}"), GRADS)


def _collective_want(name, rank, world):
    c = GRADS["coll"]
    x, w = c["x"].astype(np.float64), c["w"].astype(np.float64)
    n = x.shape[0]
    rows = slice(rank * n // world, (rank + 1) * n // world)
    if name in ("all_to_all", "all_gather"):  # a block in, the whole cotangent of it out
        return 2 * w[rows] * x[rows]
    if name in ("reduce_scatter", "all_reduce"):  # partials in: the whole cotangent each
        return 2 * w * x
    nxt = (rank + 1) % world  # ring_shift: my rows land on the next rank
    return 2 * w[nxt * n // world:(nxt + 1) * n // world] * x[rows]


@pytest.mark.parametrize("name", ("all_to_all", "all_gather", "reduce_scatter", "all_reduce",
                                  "ring_shift"))
def test_each_collective_differentiates_as_its_transpose(grad_ranks, name):
    world, got = grad_ranks
    for rank in range(world):
        np.testing.assert_allclose(got[(name, rank)], _collective_want(name, rank, world),
                                   atol=ATOL, rtol=1e-5)


def test_transpose_and_gather_pair_differentiate(grad_ranks):
    """``transpose_pair`` is its own adjoint and ``gather_pair`` reduces its
    cotangent's partials; the census holds the backward's transpose too."""
    world, got = grad_ranks
    c = GRADS["coll"]
    x, w = c["pair"].astype(np.float64), c["pair_w"].astype(np.float64)
    np.testing.assert_allclose(got["transpose_pair"], 2 * w.transpose(0, 2, 1, 3) * x,
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got["gather_pair"], 2 * w * x, atol=ATOL, rtol=1e-5)
    assert got["census_transpose"]["all_to_all@seq"]["count"] == 2  # forward and backward


def _jax_grid_grads(axis):
    g = GRADS["grid"]
    valid = g["valid"][..., None, None]

    def f(q, k, v):
        out = jgrid.grid_axial_attention(q, k, v, g["mask"], mesh=None, attend_axis=axis)
        return jnp.sum(jnp.where(valid, out * g["w"], 0.0))

    return [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(g["q"], g["k"], g["v"])]


@pytest.mark.parametrize("label", ("grid", "line"))
@pytest.mark.parametrize("axis", (1, 2))
@pytest.mark.parametrize("fn", ("dense", "hook"))
def test_grid_axial_attention_grads_match_jax(grad_ranks, label, axis, fn):
    _, got = grad_ranks
    for a, b in zip(got[("grid_axial", label, axis, fn)], _jax_grid_grads(axis)):
        np.testing.assert_allclose(a, b, atol=GRID_GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_sequence_parallel_grads_match_jax(grad_ranks, impl):
    world, got = grad_ranks
    s = GRADS["seq"]
    mesh = jmake_mesh(1, world, devices=jax.devices()[:world])

    def f(q, k, v):
        return jnp.sum(jseq.sequence_parallel_attention(q, k, v, mask=s["mask"], mesh=mesh,
                                                        impl=impl) ** 2)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(s["q"], s["k"], s["v"])
    for a, b in zip(got[impl], want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_merged_msa_from_pair_pass_grads_equal_meshless(grad_ranks):
    """The queries replicated, the keys split over the ranks: the queries'
    and the parameters' gradients are partials summed over the ranks, the
    keys' whole; every one equals the meshless pass's."""
    _, got = grad_ranks
    assert set(got["cross"]) == set(got["cross_meshless"])
    for name, want in got["cross_meshless"].items():
        np.testing.assert_allclose(got["cross"][name], want, atol=ATOL, rtol=1e-5, err_msg=name)


def test_sharded_sparse_grid_pass_grads_equal_meshless(grad_ranks):
    _, got = grad_ranks
    assert set(got["sparse"]) == set(got["sparse_meshless"])
    for name, want in got["sparse_meshless"].items():
        np.testing.assert_allclose(got["sparse"][name], want, atol=ATOL, rtol=1e-5,
                                   err_msg=name)


# ----------------------------------------------------------- the train step


SPEC = {"model": dict(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=64, bfloat16=False),
        "data": dict(crop_len=16, msa_depth=2, msa_len=16, batch_size=2, min_len_filter=8),
        "train": dict(gradient_accumulate_every=1, warmup_steps=2)}


RUN_FLAGS = {"dense": {}, "sparse tied": dict(sparse_self_attn=True, msa_tie_row_attn=True),
             "reversible": dict(reversible=True)}


def _jax_run(run: str):
    """JAX's meshless step from its init (``RUN_FLAGS[run]``): the
    parameters before, each step's loss, the first step's gradients and the
    parameters after STEPS steps."""
    flags = RUN_FLAGS[run]
    cfg = jconfig.Config(model=jconfig.ModelConfig(**SPEC["model"], **flags),
                         data=jconfig.DataConfig(**SPEC["data"]),
                         train=jconfig.TrainConfig(**SPEC["train"]))
    batch = next(iter(JSyntheticDataset(cfg.data, seed=0)))
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                 mask=dev["mask"], msa_mask=dev["msa_mask"])
    state = jloop.TrainState.create(
        apply_fn=model.apply, params=params, tx=jloop.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    params0 = jax.tree.map(np.asarray, params)

    def loss_fn(p):
        logits = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                             msa_mask=dev["msa_mask"])
        labels = jstructure.get_bucketed_distance_matrix(dev["coords"], dev["mask"])
        return jloop.distogram_cross_entropy(logits, labels)

    grads = jax.jit(jax.grad(loss_fn))(params)
    step = jloop.make_train_step(model)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, dev, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"batch": batch, "params0": params0, "losses": losses,
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, state.params)}


def _port_cfg(**fields) -> Config:
    cfg = Config()
    for section in ("model", "data", "train"):
        for k, v in SPEC[section].items():
            setattr(getattr(cfg, section), k, v)
    for k, v in fields.items():
        setattr(cfg.model, k, v)
    return cfg


def _as_scan(sd: dict) -> dict:
    """A depth-1 loop engine's parameters as the scanned engine's: the same
    network, each leaf with its depth axis of one."""
    return {(k.replace("trunk.layer_0.", "trunk.scan.layer.") if "trunk.layer_0." in k else k):
            (v[None] if "trunk.layer_0." in k else v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_runs():
    return {run: _jax_run(run) for run in RUN_FLAGS}


@pytest.fixture(scope="module")
def state_dicts(jax_runs):
    out = {}
    for key, ref in jax_runs.items():
        model = loop.build_model(_port_cfg(**RUN_FLAGS[key]))
        out[key] = convert.to_state_dict(ref["params0"], model)
        out[key + " grads"] = convert.to_state_dict(ref["grads"], model)
        out[key + " params"] = convert.to_state_dict(ref["params"], model)
    out["dense scan"] = _as_scan(out["dense"])
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def train_ranks(request, tmp_path_factory, jax_runs, state_dicts):
    world = request.param
    payload = {"spec": SPEC, "steps": STEPS, "batch": jax_runs["dense"]["batch"],
               "state_dicts": {k: v for k, v in state_dicts.items()
                               if k in ("dense", "sparse tied", "dense scan", "reversible")}}
    return world, run_ranks("train_mesh", world, tmp_path_factory.mktemp(f"t{world}"), payload)


def _reference(label, jax_runs, state_dicts):
    key = next((k for k in ("sparse tied", "reversible") if k.split()[0] in label), "dense")
    grads, params = state_dicts[key + " grads"], state_dicts[key + " params"]
    if label.startswith("scan"):
        grads, params = _as_scan(grads), _as_scan(params)
    return jax_runs[key]["losses"], grads, params


@pytest.mark.parametrize("label", list(TRAIN_MESHES))
def test_distogram_step_on_a_mesh_matches_jax(train_ranks, jax_runs, state_dicts, label):
    world, got = train_ranks
    if TRAIN_MESHES[label][0] != world:
        assert label not in got
        return
    rec = got[label]
    losses, grads, params = _reference(label, jax_runs, state_dicts)
    np.testing.assert_allclose(rec["losses"], losses, rtol=LOSS_RTOL, atol=0)
    assert rec["grads_ok"] and rec["skipped"] == 0
    assert all(rec["same"]), "the ranks' parameters parted"
    assert set(rec["grads"]) == set(grads)
    total = float(np.sqrt(sum(float(g.norm()) ** 2 for g in grads.values())))
    for name, want in grads.items():
        g, want = rec["grads"][name], want.numpy()
        norm = np.linalg.norm(want)
        if norm > 0:  # no gradient silently dropped on the mesh
            assert np.linalg.norm(g) > 0, name
        else:
            assert not g.any(), name
        err = np.linalg.norm(g.astype(np.float64) - want)
        assert err <= max(GRAD_LEAF_REL * norm, GRAD_FLOOR * total), (name, err, norm)
    worst = max(float(np.abs(rec["params"][n] - p.numpy()).max()) for n, p in params.items())
    assert worst <= PARAM_ATOL, worst


def test_triage_step_on_a_mesh(train_ranks, jax_runs):
    _, got = train_ranks
    stats = got["triage"]
    assert abs(float(stats["loss"]["l2"]) - jax_runs["dense"]["losses"][0]) <= (
        LOSS_RTOL * jax_runs["dense"]["losses"][0])
    groups = [k for k in stats if k.startswith("grad/")]
    assert {"grad/trunk", "grad/token_emb"} <= set(groups)
    assert all(int(stats[k]["nan_count"]) == 0 and float(stats[k]["l2"]) > 0 for k in groups)


# ------------------------------------------------------------ end to end


@pytest.fixture(scope="module")
def e2e_ranks(tmp_path_factory):
    ref = _jax_step(False, min_len=8)
    assert ref["batch"]["mask"].all()  # unpadded: JAX's padded step gives NaN gradients
    model = end2end.End2EndModel(**KW, mds_iters=MDS_ITERS)
    payload = {"spec": {"model": dict(KW, bfloat16=False),
                        "data": dict(crop_len=8, msa_depth=3, msa_len=8, batch_size=2,
                                     min_len_filter=8),
                        "train": dict(gradient_accumulate_every=1, warmup_steps=0)},
               "kw": KW, "mds_iters": MDS_ITERS, "batch": ref["batch"],
               "coords0": ref["coords0"],
               "state_dict": convert.to_state_dict(ref["params0"], model)}
    got = run_ranks("e2e_mesh", 2, tmp_path_factory.mktemp("e2e"), payload)
    return ref, model, got


@pytest.mark.parametrize("mesh", ("2x1", "1x2"))
def test_end2end_step_on_a_mesh_matches_jax(e2e_ranks, mesh):
    """Rank 0 realizes the structure; rank 1's loss is the gathered logits
    times 0, so its backward reaches the gather (the spawn finishing is the
    proof) and hands its trunk its block of the cotangent."""
    ref, model, got = e2e_ranks
    rec = got[mesh]
    for k in ("loss", "grad_norm", "rmsd", "dispersion"):
        assert abs(rec["metrics"][k] - ref["metrics"][k]) <= 1e-4 * abs(ref["metrics"][k]), k
    assert rec["same"] and rec["skipped"] == 0 and rec["metrics"]["grads_ok"] == 1.0
    g_ref = convert.to_state_dict(ref["grads"], model)
    total = float(np.sqrt(sum(float(v.norm()) ** 2 for v in g_ref.values())))
    assert set(g_ref) == set(rec["grads"])
    for name, want in g_ref.items():
        _check_leaf(name, torch.from_numpy(rec["grads"][name]), want, total, GRAD_REL_L2)
    p1 = convert.to_state_dict(ref["params1"], model)
    worst = max(float(np.abs(rec["params"][n] - p.numpy()).max()) for n, p in p1.items())
    assert worst <= PARAM_ATOL, worst


def test_reversible_end2end_step_on_a_mesh_matches_meshless(e2e_ranks):
    """``make_end2end_step(mesh=)`` with ``model.reversible``: the step on a
    (2, 1) mesh against the port's meshless step from the same seeded
    parameters, batch and MDS start."""
    _, _, got = e2e_ranks
    ref, rec = got["reversible"]["meshless"], got["reversible"]["2x1"]
    assert rec["grads_ok"] and rec["skipped"] == 0 and all(rec["same"])
    np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
    total = float(np.sqrt(sum(float(np.linalg.norm(g)) ** 2 for g in ref["grads"].values())))
    assert set(rec["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        _check_leaf(name, torch.from_numpy(rec["grads"][name]), torch.from_numpy(want), total,
                    GRAD_REL_L2)
    worst = max(float(np.abs(rec["params"][n] - p).max()) for n, p in ref["params"].items())
    assert worst <= PARAM_ATOL, worst


# --------------------------------------------------- entry points, resume


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    return run_ranks("resume", 2, tmp, {"spec": SPEC, "dir": str(tmp / "ck")})


@pytest.mark.parametrize("which", ("distogram", "end2end"))
def test_checkpoint_then_resume_on_a_mesh_equals_an_uninterrupted_run(resumed, which):
    runs = resumed[which]
    whole, again = runs["whole"], runs["resumed"]
    assert whole["step"] == again["step"] == 4
    assert [i for i, _ in again["losses"]] == [0, 1, 2, 3]
    assert again["losses"] == whole["losses"]
    assert all(np.array_equal(whole["params"][n], again["params"][n]) for n in whole["params"])
    assert all(np.isfinite(loss) for _, loss in whole["losses"])


# -------------------------------------------------------------- refusals


def _cpu_cfg(**mesh):
    cfg = _port_cfg()
    for k, v in mesh.items():
        setattr(cfg.mesh, k, v)
    return cfg


@pytest.mark.parametrize("fields,match", [
    ({"grid_rows": 2}, "requires model.grid_parallel=true"),
    ({"grid_cols": 2, "seq_parallel": 2}, "cannot be combined"),
])
def test_jax_config_refusals(fields, match):
    """JAX's two ValueErrors, raised before any process group is needed."""
    cfg = _cpu_cfg(**fields)
    if "seq_parallel" in fields:
        cfg.model.grid_parallel = True
    with pytest.raises(ValueError, match=match):
        loop.train(cfg, num_steps=1, device="cpu")
    jcfg = jconfig.Config()
    for k, v in fields.items():
        setattr(jcfg.mesh, k, v)
    jcfg.model.grid_parallel = cfg.model.grid_parallel
    with pytest.raises(ValueError, match=match):
        jloop.train(jcfg, num_steps=1)


def test_reversible_engine_and_dropout_refuse_a_mesh():
    """The reversible engine trains on a (dp, sp) mesh, as JAX's does (a
    (1, 1) mesh here; 2x1 and 1x2 against JAX in
    ``test_distogram_step_on_a_mesh_matches_jax``), and refuses
    ``grid_parallel``, so a grid mesh, as JAX's does; dropout refuses a
    mesh (a settled difference)."""
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh

    batch = next(iter(JSyntheticDataset(jconfig.DataConfig(**SPEC["data"]), seed=0)))
    with distributed.local_world("cpu"):
        line = sharding.make_mesh(1, 1)
        cfg = _port_cfg(reversible=True)
        model = loop.build_model(cfg)
        state = loop.init_state(cfg, model, device="cpu")
        state, metrics = loop.make_train_step(model, line)(
            state, loop.device_put_batch(batch, "cpu", line))
        assert np.isfinite(float(metrics["loss"])) and bool(metrics["grads_ok"])
        with pytest.raises(ValueError, match="grid_parallel is not supported by the reversible"):
            loop.build_model(_port_cfg(reversible=True, grid_parallel=True))
        mesh = make_grid_mesh(1, 1, 1)
        with pytest.raises(ValueError, match="dropout has no sharded route"):
            loop.make_train_step(loop.build_model(_port_cfg(ff_dropout=0.1)), mesh)


# ------------------------------------------- remat's recompute (a repair)


def test_remat_recompute_replays_the_forward_policy_and_mesh():
    """remat's recompute runs where autograd runs the backward: on the
    card's own thread, and after the step's ``use_mesh`` and any
    ``use_kernel_policy`` context has closed. It must replay the forward's
    route and collectives: a forward under the stock-attention policy
    whose backward runs outside it gives the gradients of the same
    policy without remat (before, the recompute took the default route and
    saved other tensors)."""
    from alphafold2_tpu_torch.ops.kernels import parse_policy, use_kernel_policy

    batch = loop.batch_to_device(
        next(iter(JSyntheticDataset(jconfig.DataConfig(**SPEC["data"]), seed=0))),
        torch.device("cpu"))
    policy = parse_policy("axial=stock,flash=on")
    grads = {}
    for remat in (False, True):
        cfg = _port_cfg(remat=remat)
        model = loop.build_model(cfg)
        loop.init_state(cfg, model, device="cpu")
        with use_kernel_policy(policy):
            _, loss = loop._forward_loss(model, batch, None)
        loss.backward()  # outside the policy's context
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
    assert set(grads[True]) == set(grads[False])
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=1e-5, atol=1e-6, msg=name)
