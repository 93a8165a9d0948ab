"""Module-level parity: the port's modules on converted weights vs the JAX
package's flax modules (its dense CPU path), in float32.

Inputs are drawn with numpy from a seed and handed to both frameworks. The
port gives masked query positions 0 where the JAX dense path gives them
uniform attention, so outputs compare on valid positions only, to 1e-4.
Structure math, MDS (from the JAX start coordinates), the SE(3) refiner,
featurization, PDB export and the weight converter are held here too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.data.pipeline import featurize_bucketed as jax_featurize
from alphafold2_tpu.models.alphafold2 import Alphafold2 as JAlphafold2
from alphafold2_tpu.models.se3 import SE3Refiner as JSE3Refiner
from alphafold2_tpu.models.trunk import TrunkLayer as JTrunkLayer
from alphafold2_tpu.ops import attention as jattn
from alphafold2_tpu.train.end2end import End2EndModel as JEnd2End
from alphafold2_tpu.utils.mds import mdscaling_backbone as jax_mdscaling_backbone
from alphafold2_tpu.utils import metrics as jmetrics
from alphafold2_tpu.utils import pdb as jpdb
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import convert
from alphafold2_tpu_torch.data.pipeline import featurize_bucketed
from alphafold2_tpu_torch.models.alphafold2 import Alphafold2
from alphafold2_tpu_torch.models.se3 import SE3Refiner
from alphafold2_tpu_torch.models.trunk import TrunkLayer
from alphafold2_tpu_torch.ops import attention as tattn
from alphafold2_tpu_torch.train.end2end import End2EndModel
from alphafold2_tpu_torch.utils import metrics as tmetrics
from alphafold2_tpu_torch.utils import pdb as tpdb
from alphafold2_tpu_torch.utils import structure as tstructure

# the package exports the function ``mds`` under its module's name, as JAX's does
tmds = importlib.import_module("alphafold2_tpu_torch.utils.mds")

ATOL = 1e-4
DIM, HEADS, DH = 16, 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(jax_module, torch_module, *args, **kwargs):
    """Init ``jax_module`` on the numpy inputs, load its weights into
    ``torch_module`` and return (jax output, port output) as numpy."""
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    jkw = {k: jnp.asarray(v) if v is not None else None for k, v in kwargs.items()
           if not isinstance(v, int) or isinstance(v, bool)}
    ints = {k: v for k, v in kwargs.items() if isinstance(v, int) and not isinstance(v, bool)}
    params = jax_module.init(jax.random.key(0), *jargs, **jkw, **ints)
    ref = jax_module.apply(params, *jargs, **jkw, **ints)
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params), torch_module)
    torch_module.load_state_dict(sd)
    targs = [torch.from_numpy(a) if a is not None else None for a in args]
    tkw = {k: torch.from_numpy(np.asarray(v)) if v is not None else None
           for k, v in kwargs.items() if k not in ints}
    with torch.no_grad():
        out = torch_module(*targs, **tkw, **ints)
    return jax.tree.map(np.asarray, ref), jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, out)


def _assert_valid_close(ref, out, valid):
    valid = np.broadcast_to(valid, ref.shape)
    assert out.shape == ref.shape
    assert np.abs(np.where(valid, out - ref, 0)).max() < ATOL


def _tail(b, n, keep):
    m = np.zeros((b, n), bool)
    for i, k in enumerate(keep):
        m[i, :k] = True
    return m


# ------------------------------------------------------------ attention


def test_feedforward_matches_flax():
    x = _randn(0, 2, 5, DIM)
    ref, out = _port(jattn.FeedForward(dim=DIM), tattn.FeedForward(DIM), x)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("kind", ["self", "cross", "tied"])
def test_attention_matches_flax(kind):
    jmod = jattn.Attention(dim=DIM, heads=HEADS, dim_head=DH)
    tmod = tattn.Attention(DIM, HEADS, DH)
    if kind == "self":
        x, mask = _randn(1, 2, 9, DIM), _tail(2, 9, [9, 6])
        ref, out = _port(jmod, tmod, x, mask=mask)
        valid = mask[..., None]
    elif kind == "cross":
        x, ctx = _randn(2, 2, 7, DIM), _randn(3, 2, 11, DIM)
        mask, cmask = _tail(2, 7, [7, 4]), _tail(2, 11, [8, 11])
        ref, out = _port(jmod, tmod, x, context=ctx, mask=mask, context_mask=cmask)
        valid = mask[..., None]
    else:
        # (B*R, n, d) with R = 3: column padding plus one fully masked row
        x = _randn(4, 6, 10, DIM)
        mask = _tail(6, 10, [8, 8, 8, 7, 0, 7])
        ref, out = _port(jmod, tmod, x, mask=mask, tie_dim=3)
        valid = mask[..., None]
    _assert_valid_close(ref, out, valid)


@pytest.mark.parametrize("route", ["grid", "flat_context", "flat_tied"])
def test_axial_attention_matches_flax(route):
    b, h, w = 2, 6, 7
    x = _randn(5, b, h, w, DIM)
    rows, cols = _tail(b, h, [6, 4]), _tail(b, w, [7, 5])
    mask = rows[:, :, None] & cols[:, None, :]
    tie = route == "flat_tied"
    jmod = jattn.AxialAttention(dim=DIM, heads=HEADS, dim_head=DH, tie_row_attn=tie)
    tmod = tattn.AxialAttention(DIM, HEADS, DH, tie_row_attn=tie)
    if route == "flat_context":
        ctx, cmask = _randn(6, b, 5, DIM), _tail(b, 5, [5, 3])
        ref, out = _port(jmod, tmod, x, mask=mask, context=ctx, context_mask=cmask)
    else:
        ref, out = _port(jmod, tmod, x, mask=mask)
    _assert_valid_close(ref, out, mask[..., None])


def test_trunk_layer_matches_flax():
    x, m = _randn(7, 1, 6, 6, DIM), _randn(8, 1, 3, 5, DIM)
    res = _tail(1, 6, [5])
    pair_mask = res[:, :, None] & res[:, None, :]
    msa_mask = np.broadcast_to(_tail(1, 5, [4])[:, None], (1, 3, 5)).copy()
    jmod = JTrunkLayer(dim=DIM, heads=HEADS, dim_head=DH, msa_tie_row_attn=True)
    tmod = TrunkLayer(DIM, HEADS, DH, msa_tie_row_attn=True)
    (rx, rm), (ox, om) = _port(jmod, tmod, x, m, pair_mask=pair_mask, msa_mask=msa_mask)
    _assert_valid_close(rx, ox, pair_mask[..., None])
    _assert_valid_close(rm, om, msa_mask[..., None])


def test_alphafold2_distogram_logits_match_flax():
    rng = np.random.default_rng(9)
    b, n, msa_n, rows = 2, 9, 9, 3
    seq = rng.integers(0, 20, (b, n)).astype(np.int32)
    msa = rng.integers(0, 20, (b, rows, msa_n)).astype(np.int32)
    mask = _tail(b, n, [9, 6])
    msa_mask = np.broadcast_to(mask[:, None], (b, rows, msa_n)).copy()
    jmod = JAlphafold2(dim=DIM, depth=1, heads=HEADS, dim_head=DH, max_seq_len=32,
                       msa_tie_row_attn=True)
    tmod = Alphafold2(DIM, max_seq_len=32, depth=1, heads=HEADS, dim_head=DH,
                      msa_tie_row_attn=True)
    jargs = (jnp.asarray(seq), jnp.asarray(msa))
    jkw = dict(mask=jnp.asarray(mask), msa_mask=jnp.asarray(msa_mask))
    params = jmod.init(jax.random.key(1), *jargs, **jkw)
    ref = np.asarray(jmod.apply(params, *jargs, **jkw))
    tmod.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tmod))
    with torch.no_grad():
        out = tmod(torch.from_numpy(seq).long(), torch.from_numpy(msa).long(),
                   mask=torch.from_numpy(mask), msa_mask=torch.from_numpy(msa_mask)).numpy()
    _assert_valid_close(ref, out, (mask[:, :, None] & mask[:, None, :])[..., None])


# ------------------------------------------------------- structure math


def test_center_distogram_and_sidechain_container_match():
    logits = _randn(10, 2, 12, 12, 37) * 3
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jd, jw = jstructure.center_distogram(jnp.asarray(probs))
    td, tw = tstructure.center_distogram(torch.from_numpy(probs))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)

    bb = _randn(11, 2, 15, 3) * 3  # (B, 3L, 3), L = 5
    mask = _tail(2, 5, [5, 3])
    ref = jstructure.sidechain_container(jnp.asarray(bb), place_oxygen=True,
                                         mask=jnp.asarray(mask))
    out = tstructure.sidechain_container(torch.from_numpy(bb), place_oxygen=True,
                                         mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_kabsch_and_rmsd_match():
    x, y = _randn(12, 3, 3, 20), _randn(13, 3, 3, 20)
    jx, jy = jmetrics.kabsch(jnp.asarray(x), jnp.asarray(y))
    tx, ty = tmetrics.kabsch(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tmetrics.rmsd(tx, ty).numpy(),
                               np.asarray(jmetrics.rmsd(jx, jy)), atol=1e-5)


def _jax_position_start(n, key=0):
    """utils/mds.py's per_position_init draw, computed with jax."""
    draw = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.key(key), i), (3,), jnp.float32))(jnp.arange(n))
    return np.array(2.0 * draw - 1.0)


def test_mds_from_the_jax_start_matches():
    """Identical distances, weights and start coordinates: the Guttman
    iterations, n_eff divisor, done flags and mirror fix agree."""
    rng = np.random.default_rng(14)
    pts = rng.standard_normal((2, 18, 3)).astype(np.float32) * 4
    dist = np.linalg.norm(pts[:, :, None] - pts[:, None], axis=-1).astype(np.float32)
    res = _tail(2, 6, [6, 4])
    atoms = np.repeat(res, 3, axis=1)
    weights = (rng.random((2, 18, 18)).astype(np.float32) + 0.5) * (
        atoms[:, :, None] & atoms[:, None, :])
    ref, _ = jax_mdscaling_backbone(
        jnp.asarray(dist), weights=jnp.asarray(weights), iters=30,
        key=jax.random.key(3), residue_mask=jnp.asarray(res), per_position_init=True,
    )
    coords0 = torch.from_numpy(_jax_position_start(18, key=3))
    out, _ = tmds.mdscaling_backbone(
        torch.from_numpy(dist), coords0, weights=torch.from_numpy(weights), iters=30,
        residue_mask=torch.from_numpy(res),
    )
    np.testing.assert_allclose(out.numpy() * atoms[:, None], np.asarray(ref) * atoms[:, None],
                               atol=1e-3)


def test_position_keyed_start_is_independent_of_length():
    short, long = tmds.position_keyed_init(30, seed=5), tmds.position_keyed_init(90, seed=5)
    assert np.array_equal(short, long[:30])
    assert short.min() >= -1 and short.max() < 1
    assert not np.array_equal(short, tmds.position_keyed_init(30, seed=6))


def test_se3_refiner_from_the_same_proto_matches():
    rng = np.random.default_rng(15)
    b, n = 2, 28
    tokens = np.tile(np.arange(14), (b, 2)).astype(np.int32)
    coords = (rng.standard_normal((b, n, 3)) * 3).astype(np.float32)
    mask = _tail(b, n, [28, 14])
    coords[~mask] = 0.0
    jmod = JSE3Refiner(dim=16, depth=2, vec_dim=4, num_tokens=14)
    tmod = SE3Refiner(dim=16, depth=2, vec_dim=4, num_tokens=14)
    params = jmod.init(jax.random.key(2), jnp.asarray(tokens), jnp.asarray(coords),
                       mask=jnp.asarray(mask))
    ref = np.asarray(jmod.apply(params, jnp.asarray(tokens), jnp.asarray(coords),
                                mask=jnp.asarray(mask)))
    tmod.load_state_dict(convert.to_state_dict(jax.tree.map(np.asarray, params), tmod))
    with torch.no_grad():
        out = tmod(torch.from_numpy(tokens).long(), torch.from_numpy(coords),
                   mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


# ------------------------------------------------ data, export, weights


@pytest.mark.parametrize("length,bucket,seed", [(5, 8, 0), (64, 64, 3), (70, 96, 11)])
def test_featurization_is_byte_identical(length, bucket, seed):
    tokens = np.random.default_rng(seed).integers(0, 20, length).astype(np.int32)
    ref = jax_featurize(tokens, bucket, 5, seed=seed)
    out = featurize_bucketed(tokens, bucket, 5, seed=seed)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].tobytes() == ref[k].tobytes()


def test_backbone_pdb_export_is_identical():
    bb = _randn(16, 7, 3, 3) * 5
    seq = "ACDWXYK"
    ref = jpdb.to_pdb_string(jpdb.backbone_to_pdb(seq, bb))
    assert tpdb.to_pdb_string(tpdb.backbone_to_pdb(seq, bb)) == ref


def _flax_end2end_tree(depth=2, dim=32, tie=True):
    """A flax End2EndModel parameter tree of numpy zeros, from shapes alone
    (eval_shape: no init compile)."""
    model = JEnd2End(dim=dim, depth=depth, heads=2, dim_head=16, max_seq_len=64,
                     msa_tie_row_attn=tie)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 2, 4), jnp.int32), mask=jnp.ones((1, 4), bool),
        msa_mask=jnp.ones((1, 2, 4), bool),
    )
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def test_converter_maps_every_leaf_exactly_once():
    tree = _flax_end2end_tree()
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == 139
    model = End2EndModel(dim=32, depth=2, heads=2, dim_head=16, max_seq_len=64,
                         msa_tie_row_attn=True)
    sd = convert.to_state_dict(tree, model)
    assert len(sd) == len(leaves) == len(model.state_dict())
    model.load_state_dict(sd)  # strict: every parameter filled
    # Dense kernels transpose, everything else keeps its shape
    k = tree["params"]["af2"]["distogram_proj"]["kernel"]
    assert tuple(sd["af2.distogram_proj.weight"].shape) == k.shape[::-1]

    extra = jax.tree.map(lambda a: a, tree)
    extra["params"]["af2"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no target"):
        convert.to_state_dict(extra, model)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["params"]["refiner"]["to_delta"]
    with pytest.raises(ValueError, match="no flax leaf fills"):
        convert.to_state_dict(missing, model)
    odd = jax.tree.map(lambda a: a, tree)
    odd["params"]["af2"]["token_emb"]["weird"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        convert.to_state_dict(odd, model)
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["params"]["af2"]["distogram_proj"]["kernel"] = np.zeros((3, 37), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.to_state_dict(wrong, model)
