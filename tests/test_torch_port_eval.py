"""The port's data and evaluation entry points against the JAX package's
scripts, on the CPU, end to end: PDB files (written with the port's
``save_pdb``) -> ``import_pdbs`` -> 2 distogram steps on the ``.npz``
shards with a checkpoint -> ``evaluate --checkpoint ... --realize`` ->
``refinement --native``.

- ``import_pdbs``: the shards equal those of JAX's ``scripts/import_pdbs.py``
  on the same directory (a ``.ent`` file, a second chain, a structure too
  short to keep), and ``convert_structure`` equals JAX's.
- ``evaluate``: its JSON metrics against JAX's ``scripts/evaluate.py``
  forward (the same code, inlined) on the checkpoint's weights carried
  into a flax tree, over the same batches (``NpzShardDataset`` is
  bit-equal): cross-entropy 1e-4, distogram lDDT 1e-4, bin accuracy within
  one flipped bin in 100; the realized structure's metrics finite and in
  range (MDS starts differ: a settled difference).
- ``refinement``: ``--native`` relaxes the backbone of a PDB and keeps the
  other atoms; the coordinates equal JAX's ``fast_relax`` at the file's
  precision; without ``--native`` it raises ``NotImplementedError`` after
  loading its configuration, JAX's stub contract.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.config import Config as JConfig
from alphafold2_tpu.config import DataConfig as JDataConfig, ModelConfig as JModelConfig
from alphafold2_tpu.data.pipeline import NpzShardDataset as JNpzShardDataset
from alphafold2_tpu.train import loop as jloop
from alphafold2_tpu.utils import metrics as jmetrics
from alphafold2_tpu.utils import relax as jrelax
from alphafold2_tpu.utils import structure as jstructure
from alphafold2_tpu_torch import config as tconfig
from alphafold2_tpu_torch import convert, evaluate, import_pdbs, refinement
from alphafold2_tpu_torch.data.pipeline import _smooth_walk, _synthesize_backbone
from alphafold2_tpu_torch.train import loop
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager
from alphafold2_tpu_torch.utils import pdb as pdbio

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=64, bfloat16=False)
DATA = dict(crop_len=24, msa_depth=2, msa_len=16, batch_size=2, min_len_filter=8,
            source="npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_pdbs(root: Path):
    """Five synthetic backbones as PDB files (one .ent, one with a second
    chain) and one of 3 residues, which import_pdbs skips."""
    rng = np.random.default_rng(0)
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    root.mkdir()
    for i, n in enumerate((20, 28, 35, 41, 30, 3)):
        ca = _smooth_walk(rng, n)
        bb = _synthesize_backbone(rng, ca).reshape(n, 3, 3)
        seq = "".join(rng.choice(list(alphabet), n))
        s = pdbio.backbone_to_pdb(seq, bb)
        if i == 1:  # a second chain
            other = pdbio.backbone_to_pdb(seq[:6], bb[:6] + 30.0, chain="B")
            s = pdbio.PDBStructure(*(np.concatenate([getattr(s, f), getattr(other, f)])
                                     for f in ("serial", "name", "resname", "chain",
                                               "resseq", "coords", "element", "hetero",
                                               "icode")))
        pdbio.save_pdb(s, str(root / (f"s{i}.ent" if i == 2 else f"s{i}.pdb")))
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """import_pdbs -> 2 npz steps with a checkpoint -> evaluate."""
    root = tmp_path_factory.mktemp("eval")
    pdbs = _write_pdbs(root / "pdbs")
    shards = root / "shards"
    assert import_pdbs.main([str(pdbs), str(shards)]) == 0
    cfg = tconfig.Config(model=tconfig.ModelConfig(**MODEL),
                         data=tconfig.DataConfig(**DATA, data_dir=str(shards)),
                         train=tconfig.TrainConfig(gradient_accumulate_every=1,
                                                   warmup_steps=1, numerics="off",
                                                   log_every=1,
                                                   checkpoint_dir=str(root / "ckpt")))
    state = loop.train(cfg, num_steps=2, device="cpu")
    assert state.step == 2 and int(state.skipped) == 0
    overrides = ([f"model.{k}={v}" for k, v in MODEL.items()]
                 + [f"data.{k}={v}" for k, v in DATA.items()]
                 + [f"data.data_dir={shards}"])
    return root, pdbs, shards, cfg, overrides


def test_import_pdbs_equals_jax(run, tmp_path, monkeypatch, capsys):
    root, pdbs, shards, _, _ = run
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import import_pdbs as jimport
    finally:
        sys.path.remove(str(REPO / "scripts"))
    monkeypatch.setattr(sys, "argv", ["import_pdbs.py", str(pdbs), str(tmp_path / "j")])
    assert jimport.main() == 0
    ours, theirs = sorted(os.listdir(shards)), sorted(os.listdir(tmp_path / "j"))
    assert ours == theirs and len(ours) == 5 and "s2_ent.npz" in ours
    for name in ours:
        with np.load(shards / name) as a, np.load(tmp_path / "j" / name) as b:
            assert set(a.files) == set(b.files) == {"seq", "coords"}
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    s = pdbio.load_pdb(str(pdbs / "s1.pdb"))
    for chain in (None, "B"):
        got = import_pdbs.convert_structure(s, chain)
        want = jimport.convert_structure(jimport.pdbio.load_pdb(str(pdbs / "s1.pdb")), chain)
        if chain == "B":
            assert want is not None and got[0].shape == (6,)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert import_pdbs.main([str(tmp_path / "empty"), str(tmp_path / "out")]) == 1
    assert "no .pdb files" in capsys.readouterr().err


def _to_flax(sd, module, *args, **kwargs):
    """The port's state_dict as the flax tree ``convert.to_state_dict``
    maps onto it (each leaf's inverse transpose)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)

    def leaf(path, s):
        keys = [p.key for p in path][1:]  # under "params"
        arr = sd[".".join(keys[:-1] + [convert._LEAF_NAMES[keys[-1]]])].numpy()
        if keys[-1] == "kernel":
            arr = arr.swapaxes(-1, -3) if keys[-2] == "kv_compress" else arr.swapaxes(-1, -2)
        assert arr.shape == s.shape, keys
        return arr

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_evaluate_matches_jax_forward_on_the_checkpoint(run, capsys):
    root, _, shards, cfg, overrides = run
    capsys.readouterr()
    assert evaluate.main(["--checkpoint", str(root / "ckpt"), "--batches", "2", "--realize",
                          "--device=cpu", *overrides]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    got = json.loads(out.strip().splitlines()[-1])
    assert got["batches"] == 2
    for key in ("rmsd", "tm", "lddt"):
        assert np.isfinite(got[f"structure_{key}"])
    assert got["structure_rmsd"] >= 0 and 0 <= got["structure_tm"] <= 1
    assert 0 <= got["structure_lddt"] <= 1

    jcfg = JConfig(model=JModelConfig(**MODEL),
                   data=JDataConfig(**DATA, data_dir=str(shards)))
    model = jloop.build_model(jcfg)
    stream = iter(JNpzShardDataset(jcfg.data, seed=1234))
    batches = [jloop.device_put_batch(next(stream)) for _ in range(2)]
    b0 = batches[0]
    port_model = loop.build_model(cfg)
    CheckpointManager(str(root / "ckpt")).restore_params(port_model)
    sd = port_model.state_dict()
    params = _to_flax(sd, model, b0["seq"], b0["msa"], mask=b0["mask"],
                      msa_mask=b0["msa_mask"])
    back = convert.to_state_dict(params, port_model)
    assert all(torch.equal(back[k], sd[k]) for k in sd)

    @jax.jit
    def forward(params, batch):  # scripts/evaluate.py's forward
        logits = model.apply(params, batch["seq"], batch.get("msa"), mask=batch["mask"],
                             msa_mask=batch.get("msa_mask"))
        labels = jstructure.get_bucketed_distance_matrix(batch["coords"], batch["mask"])
        ce = jloop.distogram_cross_entropy(logits, labels)
        valid = labels != -100
        acc = jnp.sum((jnp.argmax(logits, -1) == labels) & valid) / jnp.maximum(
            jnp.sum(valid), 1)
        dl = jmetrics.distogram_lddt(logits, batch["coords"], mask=batch["mask"])
        return ce, acc, jnp.mean(dl)

    ref = np.mean([[float(x) for x in forward(params, b)] for b in batches], axis=0)
    assert abs(got["distogram_ce"] - ref[0]) <= 1e-4
    assert abs(got["distogram_bin_accuracy"] - ref[1]) <= 1e-2
    assert abs(got["distogram_lddt"] - ref[2]) <= 1e-4


def test_refinement_native_relaxes_the_backbone(run, tmp_path, capsys):
    _, pdbs, _, _, _ = run
    src = str(pdbs / "s1.pdb")
    out = str(tmp_path / "relaxed.pdb")
    assert refinement.main([src, out, "--native", "--iters", "30", "--device=cpu"]) == 0
    assert "native relax: energy" in capsys.readouterr().out
    before, after = pdbio.load_pdb(src), pdbio.load_pdb(out)
    for field in ("serial", "name", "resname", "chain", "resseq"):
        assert np.array_equal(getattr(before, field), getattr(after, field))
    seq, bb, rows = before.backbone_trace(return_indices=True)
    want = np.asarray(jrelax.fast_relax(bb.reshape(1, -1, 3), iters=30).coords[0])
    # the file keeps 3 decimals
    np.testing.assert_allclose(after.coords[rows.reshape(-1)], want, atol=2e-3, rtol=0)
    assert not np.allclose(after.coords, before.coords)


def test_refinement_stub_contract(tmp_path):
    cfg = tmp_path / "relax.json"
    cfg.write_text(json.dumps({"max_iter": 7}))
    with pytest.raises(NotImplementedError, match="'max_iter': 7"):
        refinement.run_fast_relax("x.pdb", "y.pdb", str(cfg))
    with pytest.raises(NotImplementedError):
        refinement.main(["x.pdb", "y.pdb"])
    with pytest.raises(SystemExit):
        refinement.main(["x.pdb", "y.pdb", "--native", "--config", str(cfg)])
