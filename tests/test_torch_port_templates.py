"""Template conditioning against the JAX package: ``TemplateBlock``,
``Alphafold2`` with templates (auto-bucketed, explicit ``templates_dist``,
sidechains through the ``SE3TemplateEmbedder``), every gradient leaf
against ``jax.grad``, the model on 2 gloo ranks' (2, 1) and (1, 2) meshes
(``torch_mesh_ranks.py``), the embedder's rotation invariance, the guards, and
the converter on trees with and without the template modules.

Inputs come from numpy seeds and go to both frameworks; weights come from
the flax init through ``convert.to_state_dict``. JAX runs its dense CPU
path, the port its kernels' plain versions. Masked query rows differ by
path (the port's kernels give 0, JAX's dense route a uniform average), so
outputs compare on valid rows. Tolerances: f32 logits ``atol=rtol=1e-5``,
gradients ``1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.models.alphafold2 import TemplateBlock as JTemplateBlock
from alphafold2_tpu.models.se3 import SE3TemplateEmbedder as JSE3TemplateEmbedder
from alphafold2_tpu.utils.structure import get_bucketed_distance_matrix as jbucketed
from alphafold2_tpu_torch import constants, convert
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2, TemplateBlock
from alphafold2_tpu_torch.models.init import torch_match_reinit
from alphafold2_tpu_torch.models.se3 import SE3TemplateEmbedder
from alphafold2_tpu_torch.predict import init_params

DIM, HEADS, DH, N, T, M = 32, 2, 16, 12, 2, 2
KW = dict(dim=DIM, depth=1, heads=HEADS, dim_head=DH, max_seq_len=32, template_attn_depth=1)
LOGITS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed=0, masked=True, sidechains=False):
    rng = np.random.default_rng(seed)
    t_mask = np.ones((1, T, N), bool)
    if masked:
        t_mask[0, 1, 8:] = False  # the second template misses its last four residues
        t_mask[0, 0, 3] = False
    out = {
        "seq": rng.integers(0, 21, (1, N)),
        "msa": rng.integers(0, 21, (1, M, N)),
        "mask": np.ones((1, N), bool),
        "msa_mask": np.ones((1, M, N), bool),
        "templates_seq": rng.integers(0, 21, (1, T, N)),
        "templates_coors": (rng.standard_normal((1, T, N, 3)) * 5).astype(np.float32),
        "templates_mask": t_mask,
    }
    if sidechains:
        out["templates_sidechains"] = rng.standard_normal((1, T, N, 3)).astype(np.float32)
    return out


def _jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _torch(inputs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def _split(inputs):
    rest = dict(inputs)
    return rest.pop("seq"), rest.pop("msa"), rest


def _models(se3):
    jm = JAlphafold2(**KW, use_se3_template_embedder=se3)
    pm = Alphafold2(**KW, max_num_templates=constants.MAX_NUM_TEMPLATES,
                    use_se3_template_embedder=se3)
    return jm, pm


def _load(jm, pm, inputs):
    seq, msa, rest = _split(_jax(inputs))
    params = jm.init(jax.random.key(0), seq, msa, **rest)
    pm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pm))
    return params


# ------------------------------------------------------------------ TemplateBlock


def test_template_block_matches_flax_with_masked_template_residues():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, N, N, DIM)).astype(np.float32)
    t = rng.standard_normal((1, T, N, N, DIM)).astype(np.float32)
    mask = np.ones((1, N), bool)
    mask[0, -1] = False
    pair_mask = mask[:, :, None] & mask[:, None, :]
    t_res = _inputs(2)["templates_mask"]
    t_mask = t_res[..., :, None] & t_res[..., None, :]
    jb = JTemplateBlock(dim=DIM, heads=HEADS, dim_head=DH)
    args = [jnp.asarray(a) for a in (x, t, pair_mask, t_mask)]
    params = jb.init(jax.random.key(0), *args)
    jx, jt = jax.tree.map(np.asarray, jb.apply(params, *args))
    pb = TemplateBlock(DIM, HEADS, DH)
    pb.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pb))
    with torch.no_grad():
        px, pt = (a.numpy() for a in pb(*(torch.from_numpy(a) for a in (x, t, pair_mask,
                                                                          t_mask))))
    # x at valid pairs; t where the template pair is valid and the pair too
    valid_x = np.broadcast_to(pair_mask[..., None], jx.shape)
    valid_t = np.broadcast_to((t_mask & pair_mask[:, None])[..., None], jt.shape)
    np.testing.assert_allclose(px[valid_x], jx[valid_x], atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(pt[valid_t], jt[valid_t], atol=LOGITS_TOL, rtol=LOGITS_TOL)


# --------------------------------------------------------------- Alphafold2 forward


@pytest.mark.parametrize("variant", ["auto_bucketed", "explicit_dist", "se3_sidechains"])
def test_alphafold2_with_templates_matches_flax(variant):
    se3 = variant == "se3_sidechains"
    inputs = _inputs(3, sidechains=se3)
    jm, pm = _models(se3)
    params = _load(jm, pm, inputs)
    seq, msa, rest = _split(_jax(inputs))
    ref = np.asarray(jm.apply(params, seq, msa, **rest))
    call = _torch(inputs)
    if variant == "explicit_dist":
        # JAX tests/test_model.py:168: pre-bucketed distances, clamped to 0
        dist = np.maximum(np.asarray(jbucketed(rest["templates_coors"],
                                               rest["templates_mask"])), 0)
        call["templates_dist"] = torch.from_numpy(dist)
    seq_t, msa_t, rest_t = _split(call)
    with torch.no_grad():
        out = pm(seq_t, msa_t, **rest_t).numpy()
    assert out.shape == (1, N, N, constants.DISTOGRAM_BUCKETS)
    np.testing.assert_allclose(out, ref, atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_templates_change_the_logits():
    """The template stream reaches the distogram: the same weights without
    templates give other logits."""
    inputs = _inputs(4)
    _, pm = _models(False)
    init_params(pm, 0)
    seq, msa, rest = _split(_torch(inputs))
    with torch.no_grad():
        with_t = pm(seq, msa, **rest)
        without = pm(seq, msa, mask=rest["mask"], msa_mask=rest["msa_mask"])
    assert not torch.allclose(with_t, without, atol=1e-3)


# ----------------------------------------------------------------------- gradients


def test_every_gradient_leaf_matches_jax_grad():
    """With sidechains through the SE(3) embedder: every template module,
    ``sidechain_proj`` and the trunk's leaves."""
    inputs = _inputs(5, sidechains=True)
    jm, pm = _models(True)
    params = _load(jm, pm, inputs)
    w = np.random.default_rng(6).standard_normal(
        (1, N, N, constants.DISTOGRAM_BUCKETS)).astype(np.float32)
    seq, msa, rest = _split(_jax(inputs))
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply(p, seq, msa, **rest) * w))(params)
    seq_t, msa_t, rest_t = _split(_torch(inputs))
    (pm(seq_t, msa_t, **rest_t) * torch.from_numpy(w)).sum().backward()
    expected = convert.to_state_dict(jax.tree.map(np.asarray, jgrads), pm)
    got = dict(pm.named_parameters())
    assert set(expected) == set(got)
    reached = [k for k in expected if "template" in k and np.abs(expected[k].numpy()).max() > 0]
    assert any("template_block_0" in k for k in reached)
    assert "template_sidechain_emb.sidechain_proj" in reached
    for k, g in expected.items():
        p = got[k].grad if got[k].grad is not None else torch.zeros_like(got[k])
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def templates_on_a_mesh(tmp_path_factory):
    """JAX's meshless model with templates on a batch of 2 (the second
    template of each partly masked), its logits and its gradients of
    sum(logits * w); the port's on 2 gloo ranks from the same parameters."""
    from torch_mesh_ranks import run_ranks

    one, two = _inputs(7), _inputs(8)
    inputs = {k: np.concatenate([one[k], two[k]]) for k in one}
    jm, pm = _models(False)
    seq, msa, rest = _split(_jax(inputs))
    params = jax.jit(lambda key: jm.init(key, seq, msa, **rest))(jax.random.key(0))
    pm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pm))
    w = np.random.default_rng(9).standard_normal(
        (2, N, N, constants.DISTOGRAM_BUCKETS)).astype(np.float32)

    def loss(p):
        out = jm.apply(p, seq, msa, **rest)
        return jnp.sum(out * w), out

    jgrads, logits = jax.jit(jax.grad(loss, has_aux=True))(params)
    logits = np.asarray(logits)
    payload = {"kw": dict(KW, max_num_templates=constants.MAX_NUM_TEMPLATES,
                          use_se3_template_embedder=False),
               "state_dict": pm.state_dict(), "inputs": inputs, "w": w}
    got = run_ranks("templates_mesh", 2, tmp_path_factory.mktemp("templates"), payload)
    return logits, convert.to_state_dict(jax.tree.map(np.asarray, jgrads), pm), got


@pytest.mark.parametrize("mesh", ("2x1", "1x2"))
def test_templates_on_a_mesh_match_jax(templates_on_a_mesh, mesh):
    """The template stream on each rank's batch slice of the whole pair
    grid, its block to the trunk: the gathered logits and the gradients
    summed over the ranks (the template parameters' partials included)
    equal JAX's meshless model's."""
    logits, grads, got = templates_on_a_mesh
    rec = got[mesh]
    np.testing.assert_allclose(rec["logits"], logits, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert set(rec["grads"]) == set(grads)
    assert any("template_block_0" in k and np.abs(rec["grads"][k]).max() > 0 for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(rec["grads"][k], g.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=k)


# -------------------------------------------------------------------- the embedder


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return (q if np.linalg.det(q) > 0 else -q).astype(np.float32)


def test_se3_template_embedder_is_invariant_under_rotation():
    """JAX tests/test_se3.py:64: rotating the sidechains and the coords
    together leaves the colored scalars unchanged."""
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    side = torch.from_numpy(rng.standard_normal((1, 8, 3)).astype(np.float32))
    coords = torch.from_numpy((rng.standard_normal((1, 8, 3)) * 4).astype(np.float32))
    emb = init_params(SE3TemplateEmbedder(16, depth=2), 1)
    rot = torch.from_numpy(_rotation(8))
    with torch.no_grad():
        a = emb(s, side, coords)
        b = emb(s, side @ rot.T, coords @ rot.T + torch.tensor([0.5, 1.5, -0.5]))
    assert torch.allclose(a, b, atol=2e-4), (a - b).abs().max()


def test_se3_template_embedder_matches_flax():
    rng = np.random.default_rng(9)
    s, side = (rng.standard_normal((2, 6, 16)).astype(np.float32),
               rng.standard_normal((2, 6, 3)).astype(np.float32))
    coords = (rng.standard_normal((2, 6, 3)) * 4).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    jm = JSE3TemplateEmbedder(dim=16)
    args = [jnp.asarray(a) for a in (s, side, coords)]
    params = jm.init(jax.random.key(0), *args, mask=jnp.asarray(mask))
    ref = np.asarray(jm.apply(params, *args, mask=jnp.asarray(mask)))
    pm = SE3TemplateEmbedder(16)
    pm.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), pm))
    with torch.no_grad():
        out = pm(*(torch.from_numpy(a) for a in (s, side, coords)),
                 mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[mask], ref[mask], atol=LOGITS_TOL, rtol=LOGITS_TOL)


# --------------------------------------------------------------------------- guards


def test_guards_and_inputs_whose_modules_were_not_built():
    inputs = _inputs(10)
    seq, msa, rest = _split(_torch(inputs))
    pm = init_params(Alphafold2(**KW, max_num_templates=1,
                                use_se3_template_embedder=False), 0)
    with pytest.raises(ValueError, match="exceed max_num_templates 1"):
        pm(seq, msa, **rest)
    pm = init_params(Alphafold2(**KW, max_num_templates=4, use_se3_template_embedder=False), 0)
    with pytest.raises(ValueError, match="templates_coors"):
        pm(seq, msa, **{k: v for k, v in rest.items() if k != "templates_coors"})
    plain = init_params(Alphafold2(**KW), 0)
    assert not any("template" in k or "embedd" in k for k in plain.state_dict())
    with pytest.raises(ValueError, match="max_num_templates=0"):
        plain(seq, msa, **rest)
    with pytest.raises(ValueError, match="num_embedds=None"):
        plain(seq, embedds=torch.zeros((1, N, 8)))
    # an MSA wins over embedds, as JAX's elif decides: no embedd_project needed
    with torch.no_grad():
        a = plain(seq, msa, embedds=torch.zeros((1, N, 8)))
        b = plain(seq, msa)
    assert torch.equal(a, b)
    # embedd_project stands in for the MSA tables, as JAX's init builds one
    # set or the other
    plm = init_params(Alphafold2(**KW, num_embedds=8), 0)
    assert not any(k.startswith("msa_") for k in plm.state_dict())
    with pytest.raises(ValueError, match="built for embedds"):
        plm(seq, msa)


# -------------------------------------------------------------- converter and init


def _flax_tree(module, inputs):
    seq, msa, rest = _split(_jax(inputs))
    shapes = jax.eval_shape(module.init, jax.random.key(0), seq, msa, **rest)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def test_converter_maps_template_and_plain_trees_strictly():
    full = _inputs(11, sidechains=True)
    no_side = {k: v for k, v in full.items() if k != "templates_sidechains"}
    plain = {k: full[k] for k in ("seq", "msa", "mask", "msa_mask")}
    cases = [  # (flax init inputs, port constructor, strict match)
        (full, dict(max_num_templates=10), True),
        (no_side, dict(max_num_templates=10, use_se3_template_embedder=False), True),
        (no_side, dict(max_num_templates=10), False),  # no template_sidechain_emb leaves
        (plain, {}, True),
        (plain, dict(max_num_templates=10, use_se3_template_embedder=False), False),
        (full, {}, False),  # template leaves with no target
    ]
    for inputs, ctor, ok in cases:
        tree = _flax_tree(JAlphafold2(**KW), inputs)
        model = Alphafold2(**KW, **ctor)
        if not ok:
            with pytest.raises(ValueError):
                convert.to_state_dict(tree, model)
            continue
        sd = convert.to_state_dict(tree, model)
        assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(model.state_dict())
        model.load_state_dict(sd)
    tree = _flax_tree(JAlphafold2(**KW), full)
    assert tree["params"]["template_sidechain_emb"]["sidechain_proj"].shape == (8,)


def test_init_covers_the_template_parameters():
    """``init_params`` draws ``sidechain_proj`` N(0, 1) as flax does;
    ``torch_match_reinit`` redraws every template Dense and embedding by its
    flax path and keeps ``sidechain_proj`` and the LayerNorms, as JAX's
    ``torch_match_reinit`` leaves a raw leaf."""
    model = init_params(Alphafold2(**KW, max_num_templates=10), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert before["template_sidechain_emb.sidechain_proj"].abs().sum() > 0
    torch_match_reinit(model, 3)
    after = model.state_dict()
    for k in before:
        if "template" not in k:
            continue
        same = torch.equal(before[k], after[k])
        kept = "sidechain_proj" in k or "norm" in k
        assert same == kept, k
    bound = 1.0 / np.sqrt(DIM)
    w = after["template_block_0.template_axis_attn.to_q.weight"]
    assert w.abs().max() <= bound and w.std() > 0.4 * bound
