"""End-to-end structure training on the port against the JAX package, on
the CPU in float32 at a tiny size.

- The MDS gradient: the port's ``cdist`` gates its square root as JAX's
  does, so self-distances carry a zero gradient; before, the diagonal's
  sqrt at 0 met MDS's zero gradient there and gave 0/0, and every entry of
  the MDS gradient was NaN. Held to ``jax.grad`` of JAX's ``mds`` (JAX's
  start injected, a ``tol`` that freezes no element) at relative L2 1e-4.
- The other places the end-to-end step first runs backward:
  ``sidechain_container``, ``_flip_mirrors``, ``kabsch`` (SVD detached)
  and the refiner's dense path, each against ``jax.grad``.
- ``structure_loss`` against JAX's on identical inputs, its gradients
  with respect to the refined coordinates and the weights within 1e-5.
- One ``make_end2end_step`` against JAX's, tied and untied rows, converted
  weights and JAX's MDS start: loss and metrics within 1e-4 relative, every
  gradient leaf within relative L2 1e-3 (MDS amplifies deltas), zeros where
  JAX gives zeros, and the parameters after one update within 1e-4. XLA on
  the CPU flushes denormals to zero, so these tests do too: an RBF basis
  far from every distance is a denormal in PyTorch and 0 in XLA. A leaf
  whose exact gradient is 0 by symmetry (the refiner's ``rbf_bias.bias``,
  constant along the softmax axis it is added on) holds only roundoff in
  both; only a leaf whose reference norm is itself at most 1e-6 of the
  total gradient norm is held absolutely, within that same 1e-6; every
  other leaf is held to the relative bound.
- On a batch with padded residues JAX's step gets NaN gradients (the
  padded atoms sit at the origin and ``jnp.linalg.norm``'s gradient at 0
  is NaN in ``get_dihedral`` and ``nerf``), so JAX skips the step; the
  port's gradients are finite, the loss equals JAX's, and the gradient
  agrees with a central difference of the port's own loss.
- The streamed refiner's gradients against the dense path's on valid atoms.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jconfig
from alphafold2_tpu.data.pipeline import SyntheticDataset as JSyntheticDataset
from alphafold2_tpu.models.se3 import SE3Refiner as JSE3Refiner
from alphafold2_tpu.train import end2end as jend2end
from alphafold2_tpu.train.loop import device_put_batch
from alphafold2_tpu.utils import metrics as jmetrics
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
from alphafold2_tpu_torch.models import se3
from alphafold2_tpu_torch.predict import init_params
from alphafold2_tpu_torch.ops.cuda import axial, tied_row
from alphafold2_tpu_torch.train import end2end, loop
from alphafold2_tpu_torch.utils import metrics, structure

jmds = importlib.import_module("alphafold2_tpu.utils.mds")
tmds = importlib.import_module("alphafold2_tpu_torch.utils.mds")

KW = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=48)
MDS_ITERS = 10
GRAD_REL_L2 = 1e-3
ZERO_GRAD_ATOL = 1e-6  # of the total gradient norm, for leaves that are 0 by symmetry


@pytest.fixture(autouse=True)
def _one_thread_no_denormals():
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_start(n):
    """tests/test_torch_port_e2e.py's start: JAX's position-keyed draw."""
    draw = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), i), (3,), jnp.float32))(jnp.arange(n))
    return np.array(2.0 * draw - 1.0)


# ------------------------------------------------------------ the repair


def test_cdist_gradient_is_zero_at_self_distances():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(2, 20, 3)).astype(np.float32)
    yt = torch.tensor(y, requires_grad=True)
    structure.cdist(yt, yt).sum().backward()
    ref = jax.grad(lambda a: jstructure.cdist(a, a).sum())(jnp.asarray(y))
    assert torch.isfinite(yt.grad).all()
    assert _rel(yt.grad, ref) <= 1e-5
    # forward values unchanged: the clamped square root
    x = torch.tensor(rng.normal(size=(3, 7, 3)).astype(np.float32))
    sq = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    assert torch.allclose(structure.cdist(x, x), sq.clamp_min(0).sqrt(), atol=1e-5)
    assert (structure.cdist(x, x).diagonal(dim1=-2, dim2=-1) == 0).all()


def _mds_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, 3)) * 3
    d = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1)) + 0.1 * rng.random((2, n, n))
    d = 0.5 * (d + d.transpose(0, 2, 1))
    d[:, np.arange(n), np.arange(n)] = 0
    w = rng.uniform(0.2, 1.0, (2, n, n))
    w = 0.5 * (w + w.transpose(0, 2, 1))
    cot = rng.normal(size=(2, 3, n))
    return d.astype(np.float32), w.astype(np.float32), cot.astype(np.float32)


@pytest.mark.parametrize("n, iters", [(24, 10), (32, 4)])
def test_mds_gradient_matches_jax(n, iters):
    """The port's MDS gradient with respect to the target distances and the
    weights is finite and equals jax.grad of JAX's mds (NaN everywhere
    before the cdist repair)."""
    pre, w, cot = _mds_problem(n)
    tol = -1e30  # no element freezes: both take the same branch of `done`

    def jax_loss(p, ww):
        c, _ = jmds.mds(p, weights=ww, iters=iters, tol=tol, key=jax.random.key(0),
                        per_position_init=True)
        return (c * cot).sum()

    g_pre, g_w = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(pre), jnp.asarray(w))
    pt = torch.tensor(pre, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    c, _ = tmds.mds(pt, torch.from_numpy(_jax_start(n)), weights=wt, iters=iters, tol=tol)
    (c * torch.from_numpy(cot)).sum().backward()
    for got, ref in ((pt.grad, g_pre), (wt.grad, g_w)):
        assert torch.isfinite(got).all()
        assert _rel(got, ref) <= 1e-4


def test_flip_mirrors_gradient_matches_jax():
    rng = np.random.default_rng(1)
    preds = rng.normal(size=(3, 3, 12)).astype(np.float32)
    ratios = np.array([0.2, 0.7, 0.5], np.float32)
    cot = rng.normal(size=preds.shape).astype(np.float32)
    ref = jax.grad(lambda p: (jmds._flip_mirrors(p, jnp.asarray(ratios)) * cot).sum())(
        jnp.asarray(preds))
    pt = torch.tensor(preds, requires_grad=True)
    (tmds._flip_mirrors(pt, torch.from_numpy(ratios)) * torch.from_numpy(cot)).sum().backward()
    assert np.array_equal(pt.grad.numpy(), np.asarray(ref))


def test_sidechain_container_gradient_matches_jax():
    rng = np.random.default_rng(2)
    bb = (rng.normal(size=(2, 18, 3)) * 2).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    cot = rng.normal(size=(2, 6, 14, 3)).astype(np.float32)
    ref = jax.grad(lambda x: (jstructure.sidechain_container(
        x, place_oxygen=True, mask=jnp.asarray(mask)) * cot).sum())(jnp.asarray(bb))
    bt = torch.tensor(bb, requires_grad=True)
    out = structure.sidechain_container(bt, place_oxygen=True, mask=torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    assert torch.isfinite(bt.grad).all()
    assert _rel(bt.grad, ref) <= 1e-5


def test_kabsch_gradient_matches_jax():
    """The rotation comes from a detached SVD in both packages."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 15)).astype(np.float32)
    y = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jax_loss(a, b):
        al, ce = jmetrics.kabsch(a, b)
        return (al * cot).sum() + (ce * cot).sum()

    gx, gy = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    al, ce = metrics.kabsch(xt, yt)
    ((al * torch.from_numpy(cot)).sum() + (ce * torch.from_numpy(cot)).sum()).backward()
    assert _rel(xt.grad, gx) <= 1e-5 and _rel(yt.grad, gy) <= 1e-5


def test_refiner_dense_gradient_matches_jax():
    rng = np.random.default_rng(4)
    b, n = 2, 28
    tokens = np.tile(np.arange(14), (b, n // 14)).astype(np.int32)
    coords = (rng.normal(size=(b, n, 3)) * 3).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 14:] = False
    cot = rng.normal(size=(b, n, 3)).astype(np.float32) * mask[..., None]
    jm = JSE3Refiner(dim=16, depth=2, num_tokens=14)
    params = jm.init(jax.random.key(0), tokens, coords, mask=mask)

    def jax_loss(p, c):
        return (jm.apply(p, tokens, c, mask=mask) * cot).sum()

    gp, gc = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(coords))
    tm = se3.SE3Refiner(dim=16, depth=2, num_tokens=14)
    tm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tm))
    ct = torch.tensor(coords, requires_grad=True)
    (tm(torch.from_numpy(tokens).long(), ct, mask=torch.from_numpy(mask))
     * torch.from_numpy(cot)).sum().backward()
    assert _rel(ct.grad, gc) <= 1e-4
    ref = convert.to_state_dict(jax.tree.map(np.asarray, gp), tm)
    total = float(np.sqrt(sum(float(v.norm()) ** 2 for v in ref.values())))
    for name, p in tm.named_parameters():
        _check_leaf(name, p.grad, ref[name], total, 1e-4)


def _check_leaf(name, got, ref, total, rel):
    got = got if got is not None else torch.zeros_like(ref)
    assert torch.isfinite(got).all(), name
    err, norm = float((got - ref).norm()), float(ref.norm())
    # the absolute bound only for a leaf whose reference is itself below
    # it (0 by symmetry up to roundoff); every other leaf is held relatively
    symmetric = norm <= ZERO_GRAD_ATOL * total
    bound = ZERO_GRAD_ATOL * total if symmetric else rel * norm
    assert err <= bound, (name, err, norm, symmetric)
    # Adam turns a tiny gradient into a full step: zeros must stay zeros
    assert (got[ref == 0] == 0).all(), name


# ------------------------------------------------------------ structure_loss


def _loss_inputs(seed=5, b=2, length=6):
    rng = np.random.default_rng(seed)
    refined = (rng.normal(size=(b, length, 14, 3)) * 3).astype(np.float32)
    bb = (rng.normal(size=(b, 3 * length, 3)) * 3).astype(np.float32)
    w = rng.uniform(0, 1, (b, 3 * length, 3 * length)).astype(np.float32)
    w[w < 0.2] = 0.0
    mask = np.ones((b, length), bool)
    mask[1, 4:] = False
    return refined, bb, w, mask


def test_structure_loss_matches_jax():
    refined, bb, w, mask = _loss_inputs()

    def jax_loss(r, ww):
        return jend2end.structure_loss({"refined": r, "weights": ww}, jnp.asarray(bb),
                                       jnp.asarray(mask))

    (jl, jaux), (gr, gw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(refined), jnp.asarray(w))
    rt = torch.tensor(refined, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss, aux = end2end.structure_loss({"refined": rt, "weights": wt},
                                       torch.from_numpy(bb), torch.from_numpy(mask))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("rmsd", "dispersion"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
    assert np.abs(rt.grad.numpy() - np.asarray(gr)).max() <= 1e-5
    assert np.abs(wt.grad.numpy() - np.asarray(gw)).max() <= 1e-5


def test_structure_loss_zero_for_perfect_prediction():
    """tests/test_end2end.py::test_structure_loss_zero_for_perfect_prediction
    on the port."""
    rng = np.random.default_rng(0)
    L = 6
    bb_true = rng.normal(scale=5.0, size=(1, 3 * L, 3)).astype(np.float32)
    refined = np.tile(bb_true.reshape(1, L, 3, 3)[:, :, 1:2], (1, 1, 14, 1))
    refined[:, :, :3] = bb_true.reshape(1, L, 3, 3)
    out = {"refined": torch.from_numpy(refined.astype(np.float32)),
           "weights": torch.ones((1, 3 * L, 3 * L))}
    _, aux = end2end.structure_loss(out, torch.from_numpy(bb_true), torch.ones((1, L), dtype=torch.bool))
    assert float(aux["rmsd"]) < 1e-3
    assert float(aux["dispersion"]) < 1e-6


# ------------------------------------------------------------ the step


def _cfg(mod, tie, min_len=8, bfloat16=False):
    return mod.Config(
        model=mod.ModelConfig(**KW, bfloat16=bfloat16, msa_tie_row_attn=tie),
        data=mod.DataConfig(crop_len=8, msa_depth=3, msa_len=8, batch_size=2,
                            min_len_filter=min_len),
        train=mod.TrainConfig(gradient_accumulate_every=1, warmup_steps=0))


def _jax_step(tie, min_len):
    """JAX's step on one synthetic batch: its parameters before, the MDS
    start its key draws, its loss and gradients, its metrics and the
    parameters after the update."""
    cfg = _cfg(jconfig, tie, min_len)
    batch = next(iter(JSyntheticDataset(cfg.data, seed=1)))
    model = jend2end.End2EndModel(**KW, mds_iters=MDS_ITERS, msa_tie_row_attn=tie)
    dev = device_put_batch(batch)
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed), dev["seq"], dev["msa"],
                                 mask=dev["mask"], msa_mask=dev["msa_mask"])
    state = jend2end.TrainState.create(
        apply_fn=model.apply, params=params, tx=jend2end.build_optimizer(cfg),
        skipped=jnp.zeros((), jnp.int32)).replace(step=jnp.zeros((), jnp.int32))
    params0 = jax.tree.map(np.asarray, params)
    rng = jax.random.key(5)
    _, mds_rng = jax.random.split(rng)  # as make_end2end_step splits it
    n = 3 * cfg.data.crop_len
    coords0 = np.array(2.0 * jax.random.uniform(mds_rng, (2, n, 3), jnp.float32) - 1.0)

    def loss_fn(p):
        out = model.apply(p, dev["seq"], dev["msa"], mask=dev["mask"],
                          msa_mask=dev["msa_mask"], mds_key=mds_rng)
        return jend2end.structure_loss(out, dev["backbone"], dev["mask"])[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    new, met = jend2end.make_end2end_step(model)(state, dev, rng)
    return {"batch": batch, "params0": params0, "coords0": coords0,
            "grads": jax.tree.map(np.asarray, grads),
            "metrics": {k: float(v) for k, v in met.items()},
            "params1": jax.tree.map(np.asarray, new.params)}


def _port_step(ref, tie):
    cfg = _cfg(tconfig, tie)
    model = end2end.End2EndModel(**KW, mds_iters=MDS_ITERS, msa_tie_row_attn=tie)
    state = loop.init_state(cfg, model, flax_params=ref["params0"], device="cpu")
    batch = loop.batch_to_device(ref["batch"], torch.device("cpu"))
    state, met = end2end.make_end2end_step(state.model)(
        state, batch, torch.from_numpy(ref["coords0"]))
    return state, met


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def jax_step(request):
    return request.param, _jax_step(request.param, min_len=8)


def test_end2end_step_matches_jax(jax_step):
    tie, ref = jax_step
    launches = (axial.fused_attention.launches, tied_row.tied_row_attention.launches)
    state, met = _port_step(ref, tie)  # the raw gradients stay in .grad
    for k in ("loss", "grad_norm", "rmsd", "dispersion"):
        assert abs(float(met[k]) - ref["metrics"][k]) <= 1e-4 * abs(ref["metrics"][k]), k
    assert bool(met["grads_ok"]) and int(state.skipped) == 0 and state.step == 1
    g_ref = convert.to_state_dict(ref["grads"], state.model)
    total = float(np.sqrt(sum(float(v.norm()) ** 2 for v in g_ref.values())))
    named = dict(state.model.named_parameters())
    assert set(g_ref) == set(named)
    for name, p in named.items():
        _check_leaf(name, p.grad, g_ref[name], total, GRAD_REL_L2)
    # the last layer's MSA<-pair update and MSA feedforward reach no output
    dead = [n for n, v in g_ref.items() if float(v.norm()) == 0]
    assert dead and all(".layer_0." in n for n in dead)
    p1 = convert.to_state_dict(ref["params1"], state.model)
    worst = max(float((p.detach() - p1[n]).abs().max()) for n, p in named.items())
    assert worst <= 1e-4, worst
    # the CPU runs the plain versions: no kernel launched
    assert (axial.fused_attention.launches, tied_row.tied_row_attention.launches) == launches


def test_padded_batch_gradients_are_finite_where_jax_gives_nan():
    ref = _jax_step(False, min_len=5)
    assert not ref["batch"]["mask"].all()
    state, met = _port_step(ref, False)
    assert bool(met["grads_ok"]) and int(state.skipped) == 0
    assert ref["metrics"]["grads_ok"] == 0.0  # JAX's step skips this batch
    for k in ("loss", "rmsd", "dispersion"):
        assert abs(float(met[k]) - ref["metrics"][k]) <= 1e-4 * abs(ref["metrics"][k]), k
    # the port's gradient against a central difference of its own loss,
    # along the gradient (parameters as the step found them)
    model = end2end.End2EndModel(**KW, mds_iters=MDS_ITERS)
    model.load_state_dict(convert.to_state_dict(ref["params0"], model))
    batch = loop.batch_to_device(ref["batch"], torch.device("cpu"))
    coords0 = torch.from_numpy(ref["coords0"])

    def loss():
        out = model(batch["seq"], batch["msa"], mask=batch["mask"],
                    msa_mask=batch["msa_mask"], coords0=coords0)
        return end2end.structure_loss(out, batch["backbone"], batch["mask"])[0]

    loss().backward()
    params = list(model.parameters())
    g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    norm = float(torch.sqrt(sum((x * x).sum() for x in g)))
    eps = 1e-3
    with torch.no_grad():
        for p, x in zip(params, g):
            p.add_(eps / norm * x)
        up = float(loss())
        for p, x in zip(params, g):
            p.sub_(2 * eps / norm * x)
        down = float(loss())
    assert abs((up - down) / (2 * eps) - norm) <= 1e-2 * norm


def test_bf16_step_is_finite():
    cfg = _cfg(tconfig, True, min_len=5, bfloat16=True)
    model = end2end.End2EndModel(**KW, mds_iters=MDS_ITERS, msa_tie_row_attn=True,
                                 dtype=torch.bfloat16)
    state = loop.init_state(cfg, model, device="cpu")
    batch = loop.batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=2))),
                                 torch.device("cpu"))
    for i in range(2):
        state, met = end2end.make_end2end_step(state.model)(
            state, batch, end2end.mds_start(1, i, 2, 24))
        assert bool(met["grads_ok"]) and np.isfinite(float(met["loss"]))
    assert float(met["grad_norm"]) > 0 and int(state.skipped) == 0


def test_mds_start_is_keyed_by_seed_and_step():
    a = end2end.mds_start(1, 3, 2, 12)
    assert a.shape == (2, 12, 3) and a.dtype == torch.float32
    assert float(a.min()) >= -1 and float(a.max()) < 1
    assert torch.equal(a, end2end.mds_start(1, 3, 2, 12))
    assert not torch.equal(a, end2end.mds_start(1, 4, 2, 12))
    assert not torch.equal(a, end2end.mds_start(2, 3, 2, 12))


# ------------------------------------------------------------ the streamed refiner


def test_streamed_refiner_gradients_match_the_dense_path(monkeypatch):
    """Past CHUNK_THRESHOLD the refiner streams its edge attention; its
    gradients with respect to the coordinates and every parameter equal
    the dense path's on a loss over valid atoms."""
    rng = np.random.default_rng(6)
    b, n = 2, 42
    tokens = torch.from_numpy(np.tile(np.arange(14), (b, n // 14))).long()
    coords = torch.from_numpy((rng.normal(size=(b, n, 3)) * 3).astype(np.float32))
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[1, 28:] = False
    cot = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)) * mask[..., None]
    model = init_params(se3.SE3Refiner(dim=16, depth=2, num_tokens=14), seed=0)
    for layer in (model.net.layer_0, model.net.layer_1):
        layer.edge_block = 16  # 42 atoms: 3 x 3 tiles, the last padded

    def grads():
        c = coords.clone().requires_grad_(True)
        model.zero_grad()
        (model(tokens, c, mask=mask) * cot).sum().backward()
        return c.grad, {k: p.grad.clone() for k, p in model.named_parameters()}

    dense_c, dense_p = grads()
    monkeypatch.setattr(se3, "CHUNK_THRESHOLD", 1)
    assert se3.should_chunk(b * 16, n, n)
    streamed_c, streamed_p = grads()
    valid = mask[..., None].expand_as(dense_c)
    # f32: relative L2 1e-5 on the valid atoms' coordinates and on every
    # parameter leaf (the rbf_bias bias, 0 by symmetry, held absolutely)
    assert _rel(streamed_c[valid], dense_c[valid]) <= 1e-5
    total = float(np.sqrt(sum(float(g.norm()) ** 2 for g in dense_p.values())))
    for k, g in dense_p.items():
        _check_leaf(k, streamed_p[k], g, total, 1e-5)
