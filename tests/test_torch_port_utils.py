"""The port's structure utilities against the JAX package's, on the CPU:
``utils/structure.py`` (``scn_cloud_mask``, ``scn_backbone_mask``),
``utils/metrics.py`` (``calc_phis``, ``gdt``, ``tmscore``, ``lddt``,
``distogram_lddt`` and the ``Kabsch``/``RMSD``/``GDT``/``TMscore``
wrappers: numpy in, numpy out; tensors in, tensors out), ``utils/mds.py``
(``mdscaling``, ``MDScaling`` from identical distances and start
coordinates), ``utils/pdb.py`` (parse, write, select, traces, clean,
replace, custom2pdb: the text round trip equal to JAX's) and
``utils/relax.py`` (``backbone_energy`` and ``fast_relax``: coordinates
after 10 iterations within 1e-4 relative of JAX's optax Adam, the
200-iteration energy within 1e-2 relative and falling, the mask, the chunked
clash rows, chain breaks, a finite gradient through the relaxation).

Inputs come from numpy seeds. Metrics and masks within 1e-5; MDS
coordinates within 1e-4 (ten Guttman iterations, f32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.utils import metrics as jmetrics
from alphafold2_tpu.utils import pdb as jpdb
from alphafold2_tpu.utils import relax as jrelax
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import utils as tutils
from alphafold2_tpu_torch.utils import metrics, pdb, relax, structure

# the packages export the function ``mds`` under the module's name
jmds = importlib.import_module("alphafold2_tpu.utils.mds")
mds = importlib.import_module("alphafold2_tpu_torch.utils.mds")

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ masks


def test_scn_masks_match_jax():
    seq = np.random.default_rng(0).integers(0, 21, (2, 9)).astype(np.int32)
    assert np.array_equal(structure.scn_cloud_mask(_t(seq)).numpy(),
                          np.asarray(jstructure.scn_cloud_mask(seq)))
    assert np.array_equal(structure.scn_cloud_mask(_t(seq), boolean=False).numpy(),
                          np.asarray(jstructure.scn_cloud_mask(seq, boolean=False)))
    for boolean in (True, False):
        for l_aa in (3, 14):
            got = structure.scn_backbone_mask(_t(seq), boolean=boolean, l_aa=l_aa)
            want = jstructure.scn_backbone_mask(seq, boolean=boolean, l_aa=l_aa)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ metrics


def _structures(seed=1, b=2, n=24):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.standard_normal((b, 3, n)) * 2.0, axis=-1).astype(np.float32)
    x = (y + rng.standard_normal((b, 3, n)) * 1.5).astype(np.float32)
    return x, y


def test_gdt_and_tmscore_match_jax():
    x, y = _structures()
    for cutoffs, weights in ((metrics.GDT_TS_CUTOFFS, None),
                             (metrics.GDT_HA_CUTOFFS, (0.4, 0.3, 0.2, 0.1))):
        _close(metrics.gdt(_t(x), _t(y), cutoffs, weights),
               jmetrics.gdt(x, y, cutoffs, weights))
    _close(metrics.tmscore(_t(x), _t(y)), jmetrics.tmscore(x, y))
    _close(metrics.tmscore(_t(x[..., :10]), _t(y[..., :10])),
           jmetrics.tmscore(x[..., :10], y[..., :10]))  # L - 15 < 0


def test_lddt_and_distogram_lddt_match_jax():
    x, y = _structures(2)
    pred, true = np.swapaxes(x, -1, -2), np.swapaxes(y, -1, -2)
    mask = np.ones(pred.shape[:2], bool)
    mask[1, -5:] = False
    for m in (None, mask):
        for excl in (0, 2):
            _close(metrics.lddt(_t(pred), _t(true), None if m is None else _t(m),
                                exclude_neighbors=excl),
                   jmetrics.lddt(pred, true, m, exclude_neighbors=excl))
    logits = np.random.default_rng(3).standard_normal((2, 24, 24, 37)).astype(np.float32) * 3
    _close(metrics.distogram_lddt(_t(logits), _t(true), _t(mask)),
           jmetrics.distogram_lddt(logits, true, mask))


def test_calc_phis_matches_jax():
    x, _ = _structures(4, n=30)  # 10 residues of (N, CA, C)
    n_mask, ca_mask = (np.arange(30) % 3 == 0), (np.arange(30) % 3 == 1)
    for prop in (True, False):
        _close(metrics.calc_phis(_t(x), _t(n_mask), _t(ca_mask), prop=prop),
               jmetrics.calc_phis(x, n_mask, ca_mask, prop=prop))
    c_mask = np.arange(30) % 3 == 2
    _close(metrics.calc_phis(_t(x), n_mask, ca_mask, c_mask, prop=False),
           jmetrics.calc_phis(x, n_mask, ca_mask, c_mask, prop=False))


def test_wrappers_match_jax_and_keep_the_input_kind():
    x, y = _structures(5, b=1)
    for name in ("RMSD", "GDT", "TMscore"):
        got = getattr(metrics, name)(x[0], y[0])
        assert isinstance(got, np.ndarray)
        _close(got, getattr(jmetrics, name)(x[0], y[0]))
        assert isinstance(getattr(metrics, name)(_t(x), _t(y)), torch.Tensor)
    _close(metrics.GDT(x, y, mode="HA"), jmetrics.GDT(x, y, mode="HA"))
    a, t = metrics.Kabsch(x[0], y[0])
    ja, jt = jmetrics.Kabsch(x[0], y[0])
    assert isinstance(a, np.ndarray) and a.shape == (3, 24)
    _close(a, ja, 1e-4)
    _close(t, jt)
    a2, _ = metrics.Kabsch(_t(np.concatenate([x, x])), _t(np.concatenate([y, y])))
    assert isinstance(a2, torch.Tensor) and a2.shape == (2, 3, 24)
    with pytest.raises(ValueError, match="must match"):
        metrics.RMSD(x[0], y)
    assert tutils.Kabsch is metrics.Kabsch and tutils.mdscaling is mds.mdscaling


# ------------------------------------------------------------ MDS


def _backbone_distances(seed=6, b=2, residues=8):
    rng = np.random.default_rng(seed)
    ca = np.cumsum(rng.standard_normal((b, residues * 3, 3)) * 1.5, axis=1)
    d = np.linalg.norm(ca[:, :, None] - ca[:, None], axis=-1).astype(np.float32)
    return d


def test_mdscaling_matches_jax_from_the_same_start():
    d = _backbone_distances()
    b, n = d.shape[:2]
    key = jax.random.key(3)
    coords0 = np.asarray(2.0 * jax.random.uniform(key, (b, n, 3), jnp.float32) - 1.0)
    n_mask, ca_mask = structure.scn_backbone_mask(torch.zeros(n // 3), l_aa=3)
    w = np.ones_like(d)
    w[1, -3:] = w[1, :, -3:] = 0.0
    for weights in (None, w):
        want, wstress = jmds.mdscaling(d, weights=weights, iters=10, N_mask=n_mask.numpy(),
                                       CA_mask=ca_mask.numpy(), key=key)
        got, stress = mds.mdscaling(_t(d), _t(coords0),
                                    weights=None if weights is None else _t(weights),
                                    iters=10, N_mask=n_mask, CA_mask=ca_mask)
        _close(got, want, 1e-4)
        _close(stress, wstress, 1e-4)
    jc, _ = jmds.MDScaling(d[0], iters=5, fix_mirror=False, key=key)
    tc, _ = mds.MDScaling(d[0], iters=5, fix_mirror=False, coords0=_t(coords0[:1]))
    assert isinstance(tc, np.ndarray) and tc.shape == (1, 3, n)
    _close(tc, jc, 1e-4)


# ------------------------------------------------------------ PDB

PDB_TEXT = """HEADER    TEST
ATOM      1  N   MET A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA  MET A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  C   MET A   1      10.519   5.994  -4.104  1.00  0.00           C
ATOM      4  CB AMET A   1      12.581   7.239  -4.848  1.00  0.00           C
ATOM      5  CB BMET A   1      12.111   7.239  -4.848  1.00  0.00           C
ATOM      6  N   GLY A   2       9.303   6.255  -4.533  1.00  0.00           N
ATOM      7  CA  GLY A   2       8.164   6.300  -3.617  1.00  0.00           C
ATOM      8  C   GLY A   2       7.018   5.399  -4.056  1.00  0.00           C
ATOM      9  N   ALA A   2A      6.121   5.014  -3.150  1.00  0.00           N
ATOM     10  CA  ALA A   2A      5.008   4.115  -3.512  1.00  0.00           C
ATOM     11  C   ALA A   2A      3.722   4.901  -3.744  1.00  0.00           C
HETATM   12  O   HOH A 101       1.000   2.000   3.000  1.00  0.00           O
ATOM     13  N   LYS B   1      -1.104   6.134  -6.504  1.00  0.00           N
ATOM     14  CA  LYS B   1      -1.639   6.071  -5.147  1.00  0.00           C
ATOM     15  C   LYS B   1      -0.519   5.994  -4.104  1.00  0.00           C
ATOM     16  CA  UNK B   2      -2.639   6.071  -5.147  1.00  0.00           C
ENDMDL
ATOM     17  N   LYS B   1      -9.104   6.134  -6.504  1.00  0.00           N
END
"""


def _same(s, js):
    for field in ("serial", "name", "resname", "chain", "resseq", "coords", "element",
                  "hetero", "icode"):
        assert np.array_equal(getattr(s, field), getattr(js, field)), field


def test_parse_and_write_equal_jax(tmp_path):
    s, js = pdb.parse_pdb(PDB_TEXT), jpdb.parse_pdb(PDB_TEXT)
    _same(s, js)
    assert len(s) == 15 and s.chains() == js.chains() == ["A", "B"]
    text = pdb.to_pdb_string(s)
    assert text == jpdb.to_pdb_string(js)
    assert pdb.to_pdb_string(pdb.parse_pdb(text)) == text  # round trip
    path = pdb.save_pdb(s, str(tmp_path / "x.pdb"))
    _same(pdb.load_pdb(path), js)
    for got, want in zip(s.ca_trace(), js.ca_trace()):
        assert np.array_equal(got, want)
    for got, want in zip(s.backbone_trace(return_indices=True),
                         js.backbone_trace(return_indices=True)):
        assert np.array_equal(got, want)
    assert s.backbone_trace()[0] == "MGAK"
    sel = s.chain == "B"
    _same(s.select(sel), js.select(sel))
    bb = np.random.default_rng(7).standard_normal((3, 3, 3)).astype(np.float32)
    assert (pdb.to_pdb_string(pdb.backbone_to_pdb("AGW", bb))
            == jpdb.to_pdb_string(jpdb.backbone_to_pdb("AGW", bb)))


def test_clean_replace_and_custom2pdb_equal_jax(tmp_path):
    (tmp_path / "in.pdb").write_text(PDB_TEXT)
    for kw in ({}, {"chain_id": "B"}, {"chain_num": 0}):
        out_t, out_j = tmp_path / "t.pdb", tmp_path / "j.pdb"
        pdb.clean_pdb(str(tmp_path / "in.pdb"), str(out_t), **kw)
        jpdb.clean_pdb(str(tmp_path / "in.pdb"), str(out_j), **kw)
        assert out_t.read_text() == out_j.read_text()
    s = pdb.parse_pdb(PDB_TEXT)
    coords = np.random.default_rng(8).standard_normal((3, len(s))).astype(np.float32)
    _same(pdb.replace_coords(s, coords), jpdb.replace_coords(jpdb.parse_pdb(PDB_TEXT), coords))
    with pytest.raises(ValueError, match="coords shape"):
        pdb.replace_coords(s, coords[:, :5])
    scaffold = str(tmp_path / "in.pdb")
    got = pdb.custom2pdb(coords.T, "1#1abc_0_A", str(tmp_path / "ct.pdb"), scaffold)
    jpdb.custom2pdb(coords.T, "1#1abc_0_A", str(tmp_path / "cj.pdb"), scaffold)
    assert got == (scaffold, str(tmp_path / "ct.pdb"))
    assert (tmp_path / "ct.pdb").read_text() == (tmp_path / "cj.pdb").read_text()


def test_download_raises_without_touching_the_network(tmp_path):
    with pytest.raises(RuntimeError, match="cannot download"):
        pdb.download_pdb("1abc", str(tmp_path / "x.pdb"))
    with pytest.raises(RuntimeError, match="cannot download"):
        pdb.custom2pdb(np.zeros((4, 3)), "1#1abc_0_A", str(tmp_path / "y.pdb"))
    assert not (tmp_path / "x.pdb").exists()


# ------------------------------------------------------------ relax


def _noisy_backbone(seed, residues=8, noise=0.3, copies=1):
    steps = np.tile(np.array(relax.IDEAL_BONDS), residues)[: residues * 3 - 1]
    x = np.concatenate([[0.0], np.cumsum(steps)])
    base = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    rng = np.random.default_rng(seed)
    out = base[None] + noise * rng.standard_normal((copies, residues * 3, 3))
    return out.astype(np.float32)


def test_relax_matches_optax_adam_after_ten_iterations():
    bb = _noisy_backbone(0, copies=2)
    mask = np.ones(bb.shape[:2], bool)
    mask[1, -4:] = False
    for m in (None, mask):
        want = jrelax.fast_relax(bb, mask=m, iters=10)
        got = relax.fast_relax(_t(bb), mask=None if m is None else _t(m), iters=10)
        _close(got.coords, want.coords, 1e-4)
        _close(got.energy_history, want.energy_history, 1e-4)
        _close(got.energy, want.energy, 1e-4)
    assert torch.equal(got.coords[1, -4:], _t(bb)[1, -4:])  # masked atoms stay


def test_relax_energy_falls_over_200_iterations():
    bb = _noisy_backbone(1)
    got = relax.fast_relax(_t(bb), iters=200)
    want = jrelax.fast_relax(bb, iters=200)
    assert got.energy_history.shape == (200, 1)
    e0, e1 = float(got.energy_history[0, 0]), float(got.energy[0])
    assert e1 < 0.5 * e0, (e0, e1)
    _close(got.energy, want.energy, 1e-2)


def test_energy_terms_match_jax_and_the_chunked_clash_rows():
    bb = _noisy_backbone(2, residues=20)
    ref = _noisy_backbone(3, residues=20)
    mask = np.ones(bb.shape[:2], bool)
    mask[0, :5] = False
    _close(relax.backbone_energy(_t(bb), _t(ref), _t(mask)),
           jrelax.backbone_energy(bb, ref, mask), 1e-5)
    big = np.concatenate([bb + 500.0 * i for i in range(30)], axis=1)  # 1800 atoms
    assert big.shape[1] > relax.DENSE_CLASH_ATOMS
    collapsed = np.zeros_like(big[:, :1600])  # every pair clashes
    _close(relax.backbone_energy(_t(collapsed), _t(collapsed)),
           jrelax.backbone_energy(collapsed, collapsed), 1e-5)
    np.testing.assert_allclose(float(relax.backbone_energy(_t(big), _t(big))[0]),
                               30 * float(relax.backbone_energy(_t(bb), _t(bb))[0]),
                               rtol=3e-4)


def test_relax_keeps_chain_breaks_and_is_differentiable():
    two = np.concatenate([_noisy_backbone(4, 3, 0.0),
                          _noisy_backbone(5, 3, 0.0) + np.array([40.0, 0, 0], np.float32)],
                         axis=1)
    res = relax.fast_relax(_t(two), iters=100)
    assert float((res.coords[0, 9] - res.coords[0, 8]).norm()) > 20.0
    bb = _t(_noisy_backbone(6, residues=4)).requires_grad_()
    (relax.fast_relax(bb, iters=5).coords ** 2).sum().backward()
    assert torch.isfinite(bb.grad).all() and float(bb.grad.abs().sum()) > 0
    want = jax.grad(lambda c: jnp.sum(jrelax.fast_relax(c, iters=5).coords ** 2))(
        bb.detach().numpy())
    _close(bb.grad, want, 1e-3)
