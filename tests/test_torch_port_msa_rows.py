"""MSA rows sharded over a device mesh (``model.msa_row_shard``) against the
JAX package, on gloo ranks of 2 and 4 (``torch_mesh_ranks.py``, one spawn a
world size) at the mesh training tests' tiny shapes (dim 32, heads 2,
dim_head 16, crop 16, f32) and depth 2:

- K2's split passes (``ops/cuda/tied_row.py`` ``tied_split_*``), their plain
  versions composed, against ``tied_row_attention_reference`` and its
  backward references, with 1, 3 and 8 rows, masked and not;
- ``parallel/seq_parallel.py tied_row_attention`` on a (1, world) mesh
  against JAX's on its CPU mesh: values within 1e-5, the q-gradient within
  1e-4 (JAX's ``test_tied_row_attention_sharded_matches_dense``);
- the distogram step under ``msa_row_shard`` on 1x2, 1x4 (8 rows over 4),
  2x2 and 1x2x2 (rows over spr), dense and tied, with remat and the scanned
  engine, and with uneven rows (MSA 5 over 2, padded), against JAX's
  meshless ``make_train_step`` from the same parameters and batches: each
  loss within 1e-4 relative, the parameters after the steps within 1e-4
  (JAX's ``test_msa_row_shard_tied_step_matches_single_device``), the
  parameters the same on every rank, the
  logits' all_reduce over the row axis in the census (the MSA's global row
  indices, ``msa_num_pos_emb``, are in the step: a rank's rows embedded at
  local indices would move the loss);
- the PLM grid's rows on a (1, world) mesh and the end-to-end step on a
  (1, 2) mesh (MSA 5, padded), tied, each against JAX's meshless step from
  the same parameters and batches (loss 1e-4 relative, parameters 1e-4)
  and, gradient leaf by gradient leaf, against the port's meshless step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jconfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.parallel import seq_parallel as jseq
from alphafold2_tpu.parallel.sharding import make_mesh as jmake_mesh
from alphafold2_tpu.train import end2end as jend2end
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.ops.cuda import tied_row as k2
from alphafold2_tpu_torch.train import end2end, loop
from test_torch_port_train_mesh import _port_cfg
from torch_mesh_ranks import MSA_ROWS_MESHES, run_ranks

LOSS_RTOL = 1e-4  # JAX's test_msa_row_shard_tied_step_matches_single_device
PARAM_ATOL = 1e-4
GRAD_LEAF_REL = 1e-3  # the PLM and end-to-end gradients, as test_torch_port_train_mesh.py
GRAD_FLOOR = 1e-6
STEPS = 2
WORLDS = (2, 4)
# depth 2, where JAX's own test has 1: the first layer's MSA<-pair pass and
# MSA feedforward reach the loss only through a second layer
SPEC = {"model": dict(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=64, bfloat16=False),
        "data": dict(crop_len=16, msa_depth=8, msa_len=16, batch_size=2, min_len_filter=8),
        "train": dict(gradient_accumulate_every=1, warmup_steps=2)}
RUNS = {"tied8": (True, 8), "dense8": (False, 8), "tied5": (True, 5)}
# the end-to-end step at test_torch_port_end2end.py's size, MSA 5
E2E = {"model": dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, bfloat16=False),
       "data": dict(crop_len=8, msa_depth=5, msa_len=8, batch_size=2, min_len_filter=8),
       "train": dict(gradient_accumulate_every=1, warmup_steps=0),
       "kw": dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48, mds_iters=10)}
_RNG = np.random.default_rng(7)
TIED = {n: _RNG.standard_normal((2, 8, 2, 16, 8)).astype(np.float32) for n in "qkv"}
EMBEDDS = _RNG.standard_normal((2, 16, 24)).astype(np.float32)


def _as_scan(sd: dict) -> dict:
    """The loop engine's parameters as the scanned engine's: the same
    network, each layer's leaf stacked along a leading depth axis."""
    depth = SPEC["model"]["depth"]
    out = {k: v for k, v in sd.items() if not k.startswith("trunk.layer_")}
    for name in {k.split(".", 2)[2] for k in sd if k.startswith("trunk.layer_0.")}:
        out[f"trunk.scan.layer.{name}"] = torch.stack(
            [torch.as_tensor(sd[f"trunk.layer_{i}.{name}"]) for i in range(depth)])
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------ the split passes


def _split_operands(rows, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((2, rows, 24, 2, 8), generator=g) for _ in range(4))
    q_mask = kv_mask = None
    if masked:
        q_mask = torch.ones((2, 24), dtype=torch.bool)
        q_mask[1, 17:] = False
        kv_mask = q_mask.clone()
        kv_mask[0, 3] = False
    tie = torch.tensor([0.5, 0.8])
    return q, k, v, do, q_mask, kv_mask, tie


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("rows", (1, 3, 8))
def test_split_passes_compose_to_the_tied_reference(rows, masked):
    """logits -> softmax -> P V' is K2's plain forward, with its lse; dP and
    dsum -> grad -> the three products its plain dq, dk and dv."""
    q, k, v, do, qm, km, tie = _split_operands(rows, masked, seed=rows)
    scale = 8**-0.5
    s = k2.tied_split_logits(q, k)
    p, lse = k2.tied_split_softmax(s, 24, 24, qm, km, scale, tie)
    out = k2.tied_split_product(p, v, 24)
    ref, ref_lse = k2.tied_row_attention_lse_reference(q, k, v, qm, km, scale, tie)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    live = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-5, rtol=1e-5)
    dsum = k2.tied_row_dsum(out, do)
    ds, ds_t, p_t = k2.tied_split_grad(s, k2.tied_split_logits(do, v), lse, dsum, 24, 24, qm, km,
                                       scale, tie)
    got = (k2.tied_split_product(ds, k, 24, (scale, tie)),
           k2.tied_split_product(ds_t, q, 24, (scale, tie)), k2.tied_split_product(p_t, do, 24))
    args = (q, k, v, do, ref_lse, k2.tied_row_dsum(ref, do), qm, km, scale, tie)
    want = (k2.tied_row_attention_dq_reference(*args), *k2.tied_row_attention_dkv_reference(*args))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def _fake_mesh(shape, names, index):
    """What msa_row_block and shard_msa read of a mesh: axis names, sizes
    and this rank's coordinate on each."""
    return type("M", (), {"mesh_dim_names": names, "shape": shape,
                          "get_local_rank": lambda self, name: index[names.index(name)]})()


@pytest.mark.parametrize("shape,names,index,want", [
    ((1, 2), ("dp", "sp"), (0, 1), ("sp", 3, 3, 2, 1)),  # MSA 5 over 2: the tail padded
    ((1, 4), ("dp", "sp"), (0, 3), ("sp", 2, 6, 0, 3)),  # a rank of padding only
    ((2, 2, 2), ("dp", "spr", "spc"), (1, 1, 0), ("spr", 3, 3, 2, 1)),  # rows over spr
])
def test_row_block_and_the_msa_boundary_check(shape, names, index, want):
    """A rank's rows of an MSA of 5 (``msa_row_block``): its axis, count,
    global offset, real rows and the axis's padding; ``take`` pads with the
    fill; ``shard_msa(rows=)`` refuses a block of any other row count."""
    from alphafold2_tpu_torch.parallel.sharding import msa_row_block, shard_msa

    mesh = _fake_mesh(shape, names, index)
    rows = msa_row_block(5, mesh)
    assert (rows.axis, rows.per, rows.offset, rows.valid, rows.pad) == want
    got = rows.take(torch.arange(5)[None], fill=-1)[0].tolist()
    assert got == [i if i < 5 else -1 for i in range(rows.offset, rows.offset + rows.per)]
    m = torch.zeros((1, rows.per, 4, 8))
    assert shard_msa(m, 1, mesh=mesh, rows=rows) is m
    with pytest.raises(ValueError, match=f"this rank's {rows.per} of 5 rows"):
        shard_msa(torch.zeros((1, 5, 4, 8)), 1, mesh=mesh, rows=rows)


# ---------------------------------------------------- the rank spawns


def _jax_state(model, params, cfg):
    return jloop.TrainState.create(
        apply_fn=model.apply, params=params, tx=jloop.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))


def _jax_init(tied: bool, depth: int, params=None):
    """JAX's model, initial state and batches at MSA depth ``depth``, from
    ``params`` or JAX's init (tied rows and the MSA depth change no
    parameter, so one init serves every run)."""
    cfg = jconfig.Config(model=jconfig.ModelConfig(**SPEC["model"], msa_tie_row_attn=tied),
                         data=jconfig.DataConfig(**dict(SPEC["data"], msa_depth=depth)),
                         train=jconfig.TrainConfig(**SPEC["train"]))
    it = iter(JSyntheticDataset(cfg.data, seed=depth))
    batches = [next(it) for _ in range(STEPS)]
    model = jloop.build_model(cfg)
    if params is None:
        dev = jloop.device_put_batch(batches[0])
        params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                     mask=dev["mask"], msa_mask=dev["msa_mask"])
    return {"model": model, "state": _jax_state(model, params, cfg), "batches": batches,
            "params0": jax.tree.map(np.asarray, params)}


def _jax_plm_init(batch):
    """JAX's tied model on the PLM grid: ``batch`` with EMBEDDS in place of
    its MSA, twice, and JAX's init from it (``embedd_project`` included)."""
    cfg = jconfig.Config(model=jconfig.ModelConfig(**SPEC["model"], msa_tie_row_attn=True),
                         data=jconfig.DataConfig(**SPEC["data"]),
                         train=jconfig.TrainConfig(**SPEC["train"]))
    plm = dict({k: v for k, v in batch.items() if k not in ("msa", "msa_mask")}, embedds=EMBEDDS)
    model = jloop.build_model(cfg)
    dev = jloop.device_put_batch(plm)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], None,
                                 mask=dev["mask"], embedds=dev["embedds"])
    return {"model": model, "state": _jax_state(model, params, cfg), "batches": [plm, plm],
            "params0": jax.tree.map(np.asarray, params)}


def _jax_steps(init):
    """JAX's meshless step from ``init``: each step's loss and the
    parameters after its batches."""
    step = jloop.make_train_step(init["model"])
    state, losses = init["state"], []
    for i, batch in enumerate(init["batches"]):
        state, metrics = step(state, jloop.device_put_batch(batch), jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


def _jax_e2e_init():
    """JAX's tied End2EndModel at the end-to-end tests' size with an MSA of
    5 (3 rows a rank over 2, one of them padding), its init, a batch, and
    the MDS start its step's key draws."""
    cfg = jconfig.Config(model=jconfig.ModelConfig(**E2E["model"], msa_tie_row_attn=True),
                         data=jconfig.DataConfig(**E2E["data"]),
                         train=jconfig.TrainConfig(**E2E["train"]))
    batch = next(iter(JSyntheticDataset(cfg.data, seed=3)))
    assert batch["mask"].all()  # unpadded: JAX's padded step gives NaN gradients
    model = jend2end.End2EndModel(**E2E["kw"], msa_tie_row_attn=True)
    dev = jloop.device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                 mask=dev["mask"], msa_mask=dev["msa_mask"])
    state = jend2end.TrainState.create(
        apply_fn=model.apply, params=params, tx=jend2end.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    rng = jax.random.key(5)
    _, mds_rng = jax.random.split(rng)  # as make_end2end_step splits it
    coords0 = 2.0 * jax.random.uniform(mds_rng, (2, 3 * cfg.data.crop_len, 3), jnp.float32) - 1.0
    return {"model": model, "state": state, "batch": batch, "rng": rng,
            "coords0": np.array(coords0), "params0": jax.tree.map(np.asarray, params)}


def _jax_e2e_step(init):
    new, metrics = jend2end.make_end2end_step(init["model"])(
        init["state"], jloop.device_put_batch(init["batch"]), init["rng"])
    return {"losses": [float(metrics["loss"])], "params": jax.tree.map(np.asarray, new.params)}


def _to_port(tree, key):
    if key == "e2e":
        model = end2end.End2EndModel(**E2E["kw"], msa_tie_row_attn=True)
    else:
        model = loop.build_model(_port_cfg(msa_tie_row_attn=RUNS.get(key, (True,))[0],
                                           depth=SPEC["model"]["depth"]),
                                 num_embedds=EMBEDDS.shape[-1] if key == "plm" else None)
    return convert.to_state_dict(tree, model)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """JAX's initial states first, then both worlds' rank spawns in threads
    while JAX takes its steps in this process (they need only the initial
    states and batches): ``(jax_runs, state_dicts, {world: result})``."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    # the three inits in threads: their compiles overlap in part
    with ThreadPoolExecutor(2) as pool:
        e2e = pool.submit(_jax_e2e_init)
        inits = {"tied8": _jax_init(*RUNS["tied8"])}
        plm = pool.submit(_jax_plm_init, inits["tied8"]["batches"][0])
        for key, flags in list(RUNS.items())[1:]:
            inits[key] = _jax_init(*flags, params=inits["tied8"]["state"].params)
        inits["plm"], inits["e2e"] = plm.result(), e2e.result()
    state_dicts = {(key, "params0"): _to_port(init["params0"], key)
                   for key, init in inits.items()}
    got, errors = {}, []
    # made here: tmp_path_factory is not safe to call from two threads
    dirs = {world: tmp_path_factory.mktemp(f"rows{world}") for world in WORLDS}

    def spawn(world):
        try:
            got[world] = run_ranks("msa_rows", world, dirs[world],
                                   _payload(world, inits, state_dicts))
        except Exception as e:  # noqa: BLE001 — raised in the fixture below
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    jax_runs = {}
    for key, init in inits.items():
        jax_runs[key] = _jax_e2e_step(init) if key == "e2e" else _jax_steps(init)
        state_dicts[(key, "params")] = _to_port(jax_runs[key]["params"], key)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return jax_runs, state_dicts, got


@pytest.fixture(scope="module")
def jax_runs(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def state_dicts(spawned):
    return spawned[1]


def _payload(world, inits, state_dicts):
    sds = {key: state_dicts[(key, "params0")] for key in inits}
    sds["tied8 scan"] = _as_scan(sds["tied8"])
    payload = {"spec": SPEC, "state_dicts": sds,
               "batches": {key: inits[key]["batches"] for key in RUNS},
               "tied": TIED, "plm": inits["plm"]["batches"]}
    if world == 2:
        payload["e2e"] = dict(E2E, batch=inits["e2e"]["batch"], coords0=inits["e2e"]["coords0"])
    return payload


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def rows_ranks(request, spawned):
    return request.param, spawned[2][request.param]


@pytest.fixture(scope="module")
def jax_tied():
    """JAX's tied_row_attention on its CPU mesh, 8 rows over sp=4, and the
    q-gradient of sum(out^2)."""
    mesh = jmake_mesh(1, 4, devices=jax.devices()[:4])
    def loss(q, k, v):
        out = jseq.tied_row_attention(q, k, v, mesh=mesh)
        return jnp.sum(out**2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(*TIED.values())
    return np.asarray(out), np.asarray(g)


def test_tied_row_attention_on_a_mesh_matches_jax(rows_ranks, jax_tied):
    """JAX's test_tied_row_attention_sharded_matches_dense: 8 rows over the
    sequence axis, values and the q-gradient of sum(out^2)."""
    _, got = rows_ranks
    out, g = got["tied_row_attention"]
    np.testing.assert_allclose(out, jax_tied[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g, jax_tied[1], atol=1e-4, rtol=0)


def test_tied_row_attention_refusals():
    """JAX's messages, before any collective."""
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.parallel.seq_parallel import tied_row_attention

    x = torch.zeros((3, 5, 1, 4, 2))
    with distributed.local_world("cpu"):
        mesh = sharding.make_mesh(1, 1)
        out = tied_row_attention(x, x, x, mesh)  # sp 1: every count divides
        assert out.shape == x.shape
    # the refusals read only the mesh's axis sizes
    fake = type("M", (), {"mesh_dim_names": ("dp", "sp"), "shape": (2, 2),
                          "get_local_rank": lambda self, name: 0})()
    with pytest.raises(ValueError, match="MSA rows 5 must divide by sp=2"):
        tied_row_attention(x, x, x, fake)
    with pytest.raises(ValueError, match="batch 3 must divide by dp=2"):
        tied_row_attention(x[:, :4], x[:, :4], x[:, :4], fake)


@pytest.mark.parametrize("label", list(MSA_ROWS_MESHES))
def test_distogram_step_with_msa_rows_sharded_matches_jax(rows_ranks, jax_runs, state_dicts,
                                                          label):
    world, got = rows_ranks
    w, _, fields, ref = MSA_ROWS_MESHES[label]
    if w != world:
        assert label not in got
        return
    rec = got[label]
    np.testing.assert_allclose(rec["losses"], jax_runs[ref]["losses"], rtol=LOSS_RTOL, atol=0)
    assert rec["grads_ok"] and rec["skipped"] == 0
    assert all(rec["same"]), "the ranks' parameters parted"
    params = state_dicts[(ref, "params")]
    if fields.get("scan_layers"):
        params = _as_scan(params)
    worst = max(float(np.abs(rec["params"][n] - p.numpy()).max()) for n, p in params.items())
    assert worst <= PARAM_ATOL, worst
    row_axis = "spr" if label.endswith("1x2x2") else "sp"
    # the row axis carries the logits' all_reduce (tied) or the column pass's
    # all_to_all and the cross passes' gathers (both)
    assert rec["census"].get(f"all_gather@{row_axis}", 0) > 0
    if fields.get("msa_tie_row_attn"):
        assert rec["census"].get(f"all_reduce@{row_axis}", 0) >= 2  # forward and backward


@pytest.mark.parametrize("what", ("plm", "e2e"))
def test_plm_rows_and_end_to_end_on_a_mesh_equal_meshless(rows_ranks, jax_runs, state_dicts,
                                                         what):
    """The PLM grid's rows on a (1, world) mesh (two steps) and the
    end-to-end step on a (1, 2) mesh (one), both tied under
    ``msa_row_shard``, against JAX's meshless step from the same parameters
    and batches: each loss within 1e-4 relative, the parameters after within
    1e-4; and against the port's own meshless step: every gradient leaf."""
    world, got = rows_ranks
    if what == "e2e" and world != 2:
        assert "e2e" not in got
        return
    rec, ref = got[what]["mesh"], got[what]["meshless"]
    np.testing.assert_allclose(rec["losses"], jax_runs[what]["losses"], rtol=LOSS_RTOL, atol=0)
    worst = max(float(np.abs(rec["params"][n] - p.numpy()).max())
                for n, p in state_dicts[(what, "params")].items())
    assert worst <= PARAM_ATOL, worst
    assert all(rec["same"]) and rec["skipped"] == 0 == ref["skipped"]
    total = float(np.sqrt(sum(float(np.linalg.norm(g)) ** 2 for g in ref["grads"].values())))
    for name, want in ref["grads"].items():
        err = np.linalg.norm(rec["grads"][name].astype(np.float64) - want)
        assert err <= max(GRAD_LEAF_REL * np.linalg.norm(want), GRAD_FLOOR * total), (name, err)
